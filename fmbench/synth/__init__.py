"""The benchmark's broadcast station, synthesised from a seed.

A frozen rewrite of the port's test-signal generator (`io/synth.py`,
`rds/encode.py` and the `synth` subcommand): a stereo multiplex (left and
right tones, the 19 kHz pilot, the 38 kHz L-R subcarrier and 57 kHz BPSK
RDS carrying 0A and 2A groups) FM-modulated to 2.304 MS/s and quantised to
the int16 wire.  It differs from that generator in three ways, all for the
benchmark's sake: it runs in torch on any device, so that a recording is
made on the card in a few large calls; it makes a stream segment by
segment with its phases carried, so that a live stream of any length has
the same form; and the tones, the pilot and the subcarriers are evaluated
at the wire rate directly, with only the RDS baseband made at 192 kS/s and
interpolated.  The seed draws the phases, the start of the RDS group
rotation and the receiver noise; every seed gives the same amount of air.

`StationsSynth` puts several stations into one capture, each at its own
carrier offset: their float64 IQ is summed, one receiver noise is added
and the sum is quantised once.  `StationSynth` is its one-station case.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .rds import group_rotation

WIRE_RATE = 2_304_000
MPX_RATE = 192_000
UP = WIRE_RATE // MPX_RATE
PILOT_HZ = 19_000.0
RDS_SYMBOL_RATE = 2375            # biphase half-symbols a second (2 x 1187.5)
RRC_TAPS = 161                    # the RDS pulse shaper at 192 kS/s
SEGMENT = 1 << 22                 # wire frames made at once (bounds memory)


@dataclass(frozen=True)
class StationParams:
    """One station's multiplex.  The defaults are the single-station
    capture the port's checks use (stereo 1 kHz / 440 Hz, PI 0x10F0, PS
    "TPU FM", RT "VERIFY RUN")."""
    left_hz: float = 1000.0
    right_hz: float = 440.0
    tone_amp: float = 0.6
    audio_level: float = 0.9
    pilot_level: float = 0.1
    rds_level: float = 0.06
    deviation_hz: float = 75_000.0
    amplitude: float = 0.7         # carrier amplitude of the int16 full scale
    noise_std: float = 0.01        # complex Gaussian noise, of full scale
    pi: int = 0x10F0
    pty: int = 10
    ps: str = "TPU FM"
    rt: str = "VERIFY RUN"
    carrier_hz: float = 0.0        # offset from the capture's centre

    @classmethod
    def from_dict(cls, d: dict) -> "StationParams":
        d = dict(d)
        if isinstance(d.get("pi"), str):
            d["pi"] = int(d["pi"], 0)
        return cls(**d)


def _rrc(alpha: float = 1.0) -> np.ndarray:
    """The 100 % roll-off root-raised-cosine the port's synthesiser shapes
    the half-symbols with (GnuRadio's taps, the alpha = 1 case), scaled so
    that a run of alternating half-symbols (a biphase stream of equal
    symbols) peaks at 1."""
    spb = MPX_RATE / RDS_SYMBOL_RATE
    taps = np.zeros(RRC_TAPS)
    for i in range(RRC_TAPS):
        x = i - RRC_TAPS // 2
        x1 = math.pi * x / spb
        x2 = 4.0 * alpha * x / spb
        x3 = x2 * x2 - 1.0
        if abs(x3) >= 1e-6:
            if x != 0:
                num = (math.cos((1 + alpha) * x1)
                       + math.sin((1 - alpha) * x1) / (4 * alpha * x / spb))
            else:
                num = math.cos((1 + alpha) * x1) \
                    + (1 - alpha) * math.pi / (4 * alpha)
            taps[i] = 4 * alpha * num / (x3 * math.pi)
        else:
            taps[i] = -1.0
    train = np.zeros(int(40 * spb) + RRC_TAPS)
    train[np.round(np.arange(40) * spb).astype(int)] = (-1.0) ** np.arange(40)
    return taps / np.abs(np.convolve(train, taps)).max()


SCAN_ROW = 4096                   # samples a row of the card's phase scan


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """The running sum of a float64 stream, the same on every call.  On
    the card torch's one-dimensional scan sums in an order that varies
    from call to call (and its deterministic route takes seconds), and a
    last-bit difference in the FM phase can turn a rounded int16 sample;
    so the card scans rows of SCAN_ROW samples, each in a fixed order, and
    adds the rows' offsets summed on the host."""
    if x.device.type != "cuda":
        return torch.cumsum(x, dim=0)
    n = x.shape[0]
    rows = torch.nn.functional.pad(x, (0, -n % SCAN_ROW)).view(
        -1, SCAN_ROW).cumsum(dim=1)
    ends = rows[:-1, -1].cpu()
    off = torch.cat([ends.new_zeros(1), torch.cumsum(ends, dim=0)])
    return (rows + off.to(x.device)[:, None]).view(-1)[:n]


class _Station:
    """One station's float64 IQ at its carrier, made in order; its phases
    and the start of its group rotation drawn from `rng`."""

    def __init__(self, p: StationParams, rng, total_frames: int, device):
        self.p, self.device = p, device
        self.pilot_phase = float(rng.uniform(0, 2 * math.pi))
        self.left_phase = float(rng.uniform(0, 2 * math.pi))
        self.right_phase = float(rng.uniform(0, 2 * math.pi))
        data = group_rotation(p.pi, p.pty, p.ps, p.rt)
        start = int(rng.integers(0, len(data)))
        nsym = total_frames // (WIRE_RATE // RDS_SYMBOL_RATE) + 64
        nbits = nsym // 2 + 2
        bits = np.resize(np.roll(data, -start), nbits)
        # differential encoding s[k] = b[k] xor s[k-1]; biphase halves +a, -a
        s = np.cumsum(bits.astype(np.int64)) & 1
        a = 2.0 * s - 1.0
        halves = np.empty(2 * nbits)
        halves[0::2], halves[1::2] = a, -a
        self.halves = torch.as_tensor(halves, device=device)
        self.rrc = torch.as_tensor(_rrc(), device=device)
        self.fm_phase = 0.0

    def _rds_mpx(self, m0: int, m1: int) -> torch.Tensor:
        """The RDS baseband at 192 kS/s samples m0..m1 (inclusive): the
        half-symbol impulses at round(j * 192000 / 2375) through the RRC."""
        h = RRC_TAPS // 2
        lo, hi = m0 - h, m1 + h
        j0 = max(0, (lo * RDS_SYMBOL_RATE) // MPX_RATE - 1)
        j1 = (hi * RDS_SYMBOL_RATE) // MPX_RATE + 2
        j = torch.arange(j0, j1, device=self.device)
        pos = (j * (2 * MPX_RATE) + RDS_SYMBOL_RATE) // (2 * RDS_SYMBOL_RATE)
        keep = (pos >= lo) & (pos <= hi)
        train = torch.zeros(hi - lo + 1, dtype=torch.float64,
                            device=self.device)
        train[(pos - lo)[keep]] = self.halves[j[keep]]
        return torch.nn.functional.conv1d(
            train[None, None], self.rrc.flip(0)[None, None])[0, 0]

    def iq(self, n0: int, N: int) -> torch.Tensor:
        """Frames n0..n0+N-1 as float64 [N, 2] of full scale."""
        p, dev = self.p, self.device
        n = torch.arange(n0, n0 + N, dtype=torch.float64, device=dev)
        w = 2.0 * math.pi / WIRE_RATE
        theta = (w * PILOT_HZ) * n + self.pilot_phase
        left = p.tone_amp * torch.sin((w * p.left_hz) * n + self.left_phase)
        right = p.tone_amp * torch.sin((w * p.right_hz) * n
                                       + self.right_phase)
        mpx = p.audio_level * (0.5 * (left + right)
                               + torch.sin(2.0 * theta) * 0.5 * (left - right))
        mpx += p.pilot_level * torch.sin(theta)
        # RDS: the 192 kS/s baseband interpolated linearly to the wire rate
        m0 = n0 // UP
        bb = self._rds_mpx(m0, (n0 + N - 1) // UP + 1)
        k = (n - m0 * UP)
        i0 = torch.div(k, UP, rounding_mode="floor").to(torch.int64)
        frac = (k - i0 * UP) / UP
        rds = bb[i0] * (1.0 - frac) + bb[i0 + 1] * frac
        mpx += p.rds_level * rds * torch.cos(3.0 * theta)
        phase = self.fm_phase + _cumsum((w * p.deviation_hz) * mpx)
        self.fm_phase = float(phase[-1]) % (2.0 * math.pi)
        if p.carrier_hz:
            # the carrier's phase from (f n) mod rate, exact in float64 for
            # a whole f and any n a run reaches
            phase = phase + w * torch.remainder(n * p.carrier_hz, WIRE_RATE)
        return torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1) \
            * p.amplitude


class StationsSynth:
    """The wire stream of several stations in one capture, made in order:
    `next(n)` returns the next n frames as an int16 [n, 2] tensor on
    `device`.  Each station sits at its `carrier_hz`; their IQ is summed,
    complex Gaussian noise of `noise_std` of full scale is added once (the
    stations' own `noise_std` is not used) and the sum is quantised.

    `total_frames` bounds the stream (the RDS bits are drawn for it up
    front).  The seed draws each station's phases and group start in turn,
    then the noise.  The same seed, device and call sizes give the same
    bytes."""

    def __init__(self, stations, seed: int, total_frames: int,
                 device="cpu", noise_std: float = 0.01):
        self.device = torch.device(device)
        self.total = int(total_frames)
        self.noise_std = float(noise_std)
        rng = np.random.default_rng(seed)
        self.stations = [_Station(p, rng, self.total, self.device)
                         for p in stations]
        self.noise = torch.Generator(device=self.device)
        self.noise.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
        self.n = 0                  # next wire frame

    def _segment(self, N: int) -> torch.Tensor:
        iq = self.stations[0].iq(self.n, N)
        for st in self.stations[1:]:
            iq += st.iq(self.n, N)
        if self.noise_std > 0:
            iq += torch.randn(iq.shape, dtype=torch.float64,
                              device=self.device, generator=self.noise) \
                * (self.noise_std / math.sqrt(2.0))
        self.n += N
        return torch.round(iq * 32768.0).clamp_(-32768, 32767).to(
            torch.int16)

    def next(self, n_frames: int) -> torch.Tensor:
        if self.n + n_frames > self.total:
            raise ValueError(f"stream of {self.total} frames: asked for "
                             f"{n_frames} more at {self.n}")
        parts = []
        left = int(n_frames)
        while left > 0:
            N = min(left, SEGMENT)
            parts.append(self._segment(N))
            left -= N
        return parts[0] if len(parts) == 1 else torch.cat(parts)


class StationSynth(StationsSynth):
    """The wire stream of one station (at its `carrier_hz`, 0 Hz by
    default) with its own `noise_std`."""

    def __init__(self, params: StationParams, seed: int, total_frames: int,
                 device="cpu"):
        super().__init__([params], seed, total_frames, device,
                         params.noise_std)
