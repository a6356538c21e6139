"""The plain reference of sdr-j-fm's weak-station receive mode: the chain
of `reference/receiver.py` with the three stages a fringe-area listener
turns on added where the published engine runs them
(fm-processor.cpp:469-470, :499-510, rds-decoder-2.cpp):

- the strong input filter: between the LO mix and the ÷12, an overlap-save
  filter of 65,536 points (hop 49,152) whose response is a degree-251
  windowed-sinc lowpass at half the FM bandwidth (0.95 x 192 kHz / 2 =
  91.2 kHz, fm-processor.cpp:77,147-149);
- the noise squelch (squelchClass.cpp:9-78), on the demodulated stream
  before the pilot: a Chebyshev type-I high pass at 69.9 kHz and low pass
  at 70 kHz (1 dB ripple, the "order 20" pair, each ten poles as scipy's
  cheby1 designs it), decaying averages of each band's magnitude with
  weight 100 / 192,000, and at the end of each 8,192-sample hold period a
  decision with hysteresis: open where high < low x thr - 0.001, closed
  where high >= low x thr + 0.001, kept otherwise, forced closed where
  thr < 0.001, thr = 1 - level / 100; a closed period is zeroed;
- RDS decoder 2 (rds-decoder-2.cpp:101-157) in place of the block bit
  recovery, on the same 24 kS/s stream: the 45-tap root-raised-cosine
  matched filter (`design.rrc`), then, one sample at a time over float32
  scalars on the host, an AGC (gain += 0.002 (0.38 - |out|), from 9), a
  Mueller & Mueller timing error on rail decisions over a three-sample
  window (mu += samples a bit + 0.01 error; the next symbol floor(mu)
  samples on, the first after 3), a Costas loop on each symbol (alpha 1,
  beta 0.02, its frequency reset where it leaves +-10 Hz), the BPSK slice
  of the symbol's real part and the differential decode against the
  previous symbol's slice.

The band filters run as second-order sections, each a three-tap FIR
(`receiver.Fir`) and its two-pole recursion as chunks of a block-Toeplitz
matrix product over the section's two-sample state and the same
recursion over the chunk ends (`Recurrence`), as `receiver.one_pole` runs
a one-pole: products, so the card's TF32 routes reach them in the
control; the averages are `receiver.ema`.

Departures from the published engine, each the geometry the program
under test was given: a hold period of 8,192 samples where squelchClass
holds fmRate/20 = 9,600 (so that periods tile a power-of-two block), the
decision at a period's end gating that whole period, the decisions taken
on a lattice aligned to the block, and the squelch level a constructor
argument (`squelch_level`, 0 by default: rx's `--squelch-level 0`).

Only the weak-signal options are implemented: `input_filter=True`,
`squelch="nsq"`, `rds="scan2"` are required and every other key is held
to what `reference/receiver.py` accepts.  `step` returns, besides the
base's outputs, each hold period's decision (`squelch`, True where
closed) and the smallest distance of a period's high-band average to the
nearer decision boundary, over that average (`squelch_margin`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import design as D
from . import receiver as R

Tensor = torch.Tensor

INPUT_FFT, INPUT_HOP, INPUT_DEGREE = 65536, 49152, 251
FM_BANDWIDTH = 0.95 * D.FM_RATE
SQUELCH_KEY = 70000
SQUELCH_POLES = 10
SQUELCH_RIPPLE_DB = 1.0
HOLD = 8192
HYSTERESIS = 0.001
MF_TAPS = 45
REQUIRED = {"input_filter": True, "squelch": "nsq", "rds": "scan2"}


class Recurrence:
    """s[n] = M s[n-1] + e[n] for a d-dimensional state, over e [T, d]:
    chunks of CHUNK steps as one matrix product with the block-Toeplitz
    matrix of M's powers, the state entering each chunk carried by M^(i+1),
    and the chunk ends' own recurrence (M^CHUNK) solved the same way.  The
    powers are formed in float64 and rounded once."""

    CHUNK = 64

    def __init__(self, M: np.ndarray, device):
        C = self.CHUNK
        M = np.asarray(M, np.float64)
        d = M.shape[0]
        pows = np.empty((C + 1, d, d))
        pows[0] = np.eye(d)
        for k in range(1, C + 1):
            pows[k] = M @ pows[k - 1]
        lag = np.arange(C)[:, None] - np.arange(C)[None, :]
        K = np.where((lag >= 0)[..., None, None],
                     pows[np.clip(lag, 0, C)], 0.0)       # [i, j, a, b]
        self.K = torch.as_tensor(K.transpose(0, 2, 1, 3).reshape(C * d, C * d)
                                 .astype(np.float32), device=device)
        self.P = torch.as_tensor(pows[1:].astype(np.float32), device=device)
        self.M_chunk = pows[C]
        self.d, self.device, self._next = d, device, None

    def __call__(self, e: Tensor, s0: Tensor) -> Tensor:
        C, d = self.CHUNK, self.d
        T = e.shape[0]
        n = -(-T // C)
        ep = F.pad(e, (0, 0, 0, n * C - T)).reshape(n, C * d)
        local = (ep @ self.K.t()).view(n, C, d)
        if n == 1:
            s_in = s0[None]
        else:
            if self._next is None:
                self._next = Recurrence(self.M_chunk, self.device)
            ends = self._next(local[:, -1, :].contiguous(), s0)
            s_in = torch.cat([s0[None], ends[:-1]])
        s = local + torch.einsum("iab,nb->nia", self.P, s_in)
        return s.reshape(-1, d)[:T]


class Section:
    """One second-order section b / a: its three-tap FIR, then y[n] = u[n]
    - a1 y[n-1] - a2 y[n-2] on the state (y[n-1], y[n-2])."""

    def __init__(self, sos_row, device):
        b, a = np.asarray(sos_row[:3]), np.asarray(sos_row[3:])
        b, a = b / a[0], a / a[0]
        self.fir = R.Fir(b, 1, device)
        self.rec = Recurrence(np.array([[-a[1], -a[2]], [1.0, 0.0]]), device)

    def __call__(self, x: Tensor, state):
        fir, ys = state
        u, fir = self.fir(x, fir)
        e = torch.stack([u, torch.zeros_like(u)], -1)
        s = self.rec(e, ys)
        return s[:, 0], (fir, s[-1])


def band(kind: str, fc: float, device):
    """The squelch's Chebyshev band filter (`kind` "highpass" or "lowpass"
    at fc Hz) as its second-order sections, designed by scipy."""
    from scipy import signal
    sos = signal.cheby1(SQUELCH_POLES, SQUELCH_RIPPLE_DB, fc, btype=kind,
                        fs=D.FM_RATE, output="sos")
    return [Section(row, device) for row in sos]


class PlainReceiver(R.PlainReceiver):
    """`reference/receiver.py`'s receiver with the strong input filter,
    the noise squelch and RDS decoder 2 (see the module's docstring);
    `step(state, wire) -> (state, out)` as there, `out["bits"]` and
    `out["iq"]` decoder 2's bits and the symbols they were sliced from."""

    def __init__(self, receiver: dict, device="cpu", tune_hz: int = 0,
                 squelch_level: float = 0.0):
        cfg = dict(receiver)
        for k, v in REQUIRED.items():
            if cfg.pop(k, None) != v:
                raise NotImplementedError(f"weak_signal reference: {k}={v!r}"
                                          f" only")
        super().__init__({**cfg, "rds": "block"}, device, tune_hz)
        if self.T % INPUT_HOP or self.block_fm % HOLD:
            raise NotImplementedError("weak_signal reference: a block of "
                                      "whole input hops and hold periods")
        k_in = D.lowpass(INPUT_DEGREE, FM_BANDWIDTH / 2, D.INPUT_RATE)
        self.H_in = torch.as_tensor(D.response(k_in, INPUT_FFT)
                                    .astype(np.complex64), device=self.device)
        self.high = band("highpass", SQUELCH_KEY - 100, self.device)
        self.low = band("lowpass", min(SQUELCH_KEY, int(0.49 * D.FM_RATE)),
                        self.device)
        self.sq_w = 1.0 / (D.FM_RATE / 100.0)
        self.thr = 1.0 - float(squelch_level) / 100.0
        self.mf2 = R.Fir(D.rrc(D.RDS_RATE, 2 * D.RDS_BITCLK_HZ, MF_TAPS), 1,
                         device)

    def init_state(self) -> dict:
        s = super().init_state()
        dev = self.device
        z = lambda n: torch.zeros(n, dtype=torch.float32,  # noqa: E731
                                  device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        s.update(
            input_filt=torch.zeros(INPUT_FFT - INPUT_HOP,
                                   dtype=torch.complex64, device=dev),
            sq_bands=[[(z(2), z(2)) for _ in self.high],
                      [(z(2), z(2)) for _ in self.low]],
            sq_avg=(zero, zero), sq_closed=False,
            mf2=torch.zeros(MF_TAPS - 1, dtype=torch.complex64, device=dev),
            # gain, Costas freq and phase, the window s0..s2 (re, im),
            # samples since the last symbol, skip, mu, the last slice
            dec2=dict(gain=np.float32(9.0), freq=np.float32(0.0),
                      phase=np.float32(0.0), win=[np.float32(0.0)] * 6,
                      count=0, skip=3, mu=np.float32(0.0), prev=False))
        return s

    # -- the input filter ---------------------------------------------------
    def _front_end(self, s, wire):
        x = wire.to(torch.float32) * R._WIRE[self.fmt]
        x = torch.complex(x[:, 0], x[:, 1])
        lim = D.RF_DC_LIMIT
        corr = torch.complex(s["rf_dc"].real.clamp(-lim, lim),
                             s["rf_dc"].imag.clamp(-lim, lim))
        sub = x[::64].mean()
        x = x - corr
        q = D.INPUT_RATE
        if self.tune:
            n = (s["n_mod"] + torch.arange(self.T, dtype=torch.int64,
                                           device=x.device)) % q
            th = (self.tune * n % q).to(torch.float64) * (2.0 * math.pi / q)
            x = x * torch.polar(torch.ones_like(th), -th).to(torch.complex64)
        x, input_filt = R.fft_filter(x, self.H_in, INPUT_HOP,
                                     s["input_filt"])
        v, fe = self.fe(x, s["fe"])
        rf_dc = self.g_dc * s["rf_dc"] + (1.0 - self.g_dc) * sub
        return v, dict(rf_dc=rf_dc, fe=fe, n_mod=(s["n_mod"] + self.T) % q,
                       input_filt=input_filt)

    # -- the noise squelch ---------------------------------------------------
    def _squelch(self, s, demod: Tensor):
        """(demod gated a hold period at a time, each period's decision,
        the smallest relative margin of its averages to a boundary, new
        state)."""
        bands, outs = [], []
        for secs, states in ((self.high, s["sq_bands"][0]),
                             (self.low, s["sq_bands"][1])):
            v, new = demod, []
            for sec, st in zip(secs, states):
                v, st = sec(v, st)
                new.append(st)
            bands.append(new)
            outs.append(torch.abs(v))
        ah, ah_last = R.ema(outs[0], self.sq_w, s["sq_avg"][0])
        al, al_last = R.ema(outs[1], self.sq_w, s["sq_avg"][1])
        nper = demod.shape[0] // HOLD
        hi = ah.view(nper, HOLD)[:, -1].tolist()
        lo = al.view(nper, HOLD)[:, -1].tolist()
        thr, closed, decisions, margin = self.thr, s["sq_closed"], [], math.inf
        for a_h, a_l in zip(hi, lo):
            if thr < HYSTERESIS:
                closed = True
            elif a_h < a_l * thr - HYSTERESIS:
                closed = False
            elif a_h >= a_l * thr + HYSTERESIS:
                closed = True
            decisions.append(closed)
            if thr >= HYSTERESIS and a_h > 0:
                margin = min(margin, abs(a_h - (a_l * thr - HYSTERESIS)) / a_h,
                             abs(a_h - (a_l * thr + HYSTERESIS)) / a_h)
        shut = torch.tensor(decisions, device=demod.device)
        gated = torch.where(shut[:, None], 0.0, demod.view(nper, HOLD))
        return gated.reshape(-1), shut, margin, dict(
            sq_bands=bands, sq_avg=(ah_last, al_last), sq_closed=closed)

    # -- RDS decoder 2 -------------------------------------------------------
    def _decoder2(self, s, z: Tensor):
        """(bits int8, the sliced symbols complex64, new state) of the
        24 kS/s stream z."""
        y, mf2 = self.mf2(z, s["mf2"])
        yr = y.real.cpu().numpy().astype(np.float32)
        yi = y.imag.cpu().numpy().astype(np.float32)
        st = dict(s["dec2"])
        f32 = np.float32
        gain, freq, phase, mu = st["gain"], st["freq"], st["phase"], st["mu"]
        s0r, s0i, s1r, s1i, s2r, s2i = st["win"]
        count, skip, prev = st["count"], st["skip"], st["prev"]
        sps, g_mm = f32(D.RDS_RATE / D.RDS_BITCLK_HZ), f32(0.01)
        g_agc, ref_agc, beta = f32(2e-3), f32(0.38), f32(0.02)
        limit = f32(2 * math.pi * 10.0 / D.RDS_RATE)
        two_pi, one = f32(2.0 * math.pi), f32(1.0)
        bits, sre, sim = [], [], []

        def rail(v):
            return one if v > 0 else -one

        for n in range(len(yr)):
            outr, outi = yr[n] * gain, yi[n] * gain
            gain = gain + g_agc * (ref_agc - np.hypot(outr, outi))
            s0r, s0i, s1r, s1i, s2r, s2i = s1r, s1i, s2r, s2i, outr, outi
            count += 1
            if count < skip:
                continue
            err_x = (rail(s2r) - rail(s0r)) * s1r \
                + (rail(s2i) - rail(s0i)) * s1i
            err_y = (s2r - s0r) * rail(s1r) + (s2i - s0i) * rail(s1i)
            mu = mu + sps + g_mm * (err_y - err_x)
            skip = int(np.floor(mu))
            mu = mu - f32(skip)
            c, sn = np.cos(phase), np.sin(phase)
            a = s2r * c + s2i * sn
            b = s2i * c - s2r * sn
            e = a * b
            freq = freq + beta * e
            if abs(freq) > limit:
                freq = f32(0.0)
            phase = phase + freq + e
            phase = phase - two_pi * np.round(phase / two_pi)
            cur = bool(a >= 0)
            bits.append(cur != prev)
            prev, count = cur, 0
            sre.append(a)
            sim.append(b)
        dev = z.device
        sym = torch.complex(torch.tensor(np.asarray(sre, np.float32)),
                            torch.tensor(np.asarray(sim, np.float32))).to(dev)
        new = dict(mf2=mf2, dec2=dict(
            gain=gain, freq=freq, phase=phase, mu=mu,
            win=[s0r, s0i, s1r, s1i, s2r, s2i], count=count, skip=skip,
            prev=prev))
        return torch.tensor(bits, dtype=torch.int8, device=dev), sym, new

    # -- the block ---------------------------------------------------------
    def step(self, s: dict, wire: Tensor):
        if tuple(wire.shape) != (self.T, 2):
            raise ValueError(f"reference: block of shape {tuple(wire.shape)}"
                             f", want {(self.T, 2)}")
        s = dict(s)
        v, upd = self._front_end(s, wire)
        s.update(upd)
        # the discriminator, as reference/receiver.py forms it
        mag = torch.abs(v)
        small = mag <= 1e-3
        safe = torch.where(small, 1.0, mag)
        zn = torch.complex(torch.where(small, 1e-3, v.real / safe),
                           torch.where(small, 1e-3, v.imag / safe))
        p1 = torch.cat([s["prev"].reshape(1), zn[:-1]])
        d = zn * torch.conj(p1)
        res = torch.atan2(d.imag, d.real)
        afc, s["afc"] = R.ema(res, D.FM_DC_ALPHA, s["afc"])
        s["prev"] = zn[-1]
        demod = D.DEMOD_GAIN * (res - afc) / D.k_fm()
        demod, shut, margin, upd = self._squelch(s, demod)
        s.update(upd)
        # pilot, PSS, stereo, the RDS band: reference/receiver.py's
        p, tail = R.fft_filter(demod, self.H_pilot, D.FM_HOP, s["demod_tail"])
        rds57, _ = R.fft_filter(demod, self.H_rds, D.FM_HOP, s["demod_tail"])
        s["demod_tail"] = tail
        w19 = 2.0 * math.pi * D.PILOT_HZ / D.FM_RATE
        phase = torch.angle(p) + (w19 * self.pilot_delay + math.pi)
        strength, s["lock_metric"] = R.ema(torch.abs(p), D.PILOT_LOCK_ALPHA,
                                           s["lock_metric"])
        run, s["lock_run"] = R.run_length(strength > D.PILOT_LOCK_THRESHOLD,
                                          s["lock_run"])
        locked = run > int(D.PILOT_LOCK_STABLE_S * D.FM_RATE)
        base = 2.0 * (phase + math.pi / 4.0)
        off, upd = self._pss(s, demod, base, locked)
        s.update(upd)
        diff = torch.where(locked, 2.0 * torch.cos(base - off) * demod, 0.0)
        audio = torch.complex(demod + diff, demod - diff)
        out = dict(locked=bool(locked[-1]), squelch=shut,
                   squelch_margin=margin)
        ph = torch.cat([s["phase_delay"], phase])
        s["phase_delay"] = ph[-self.rds_delay:]
        th = 3.0 * ph[:self.block_fm]
        bb = rds57 * torch.complex(torch.cos(th), -torch.sin(th))
        z24, s["rds_decim"] = self.rds_fir(bb, s["rds_decim"])
        out["bits"], out["iq"], upd = self._decoder2(s, z24)
        s.update(upd)
        # the audio lowpass, ÷4 and the start-up ramp
        audio, s["audio_filt"] = R.fft_filter(audio, self.H_audio, D.FM_HOP,
                                              s["audio_filt"])
        pcm, s["audio_decim"] = self.audio_fir(audio, s["audio_decim"])
        Tw = pcm.shape[0]
        ramp_max = D.WORKING_RATE // 2
        gain = torch.clamp((ramp_max - s["ramp"] + torch.arange(
            Tw, dtype=torch.float32, device=pcm.device)) / ramp_max, 0.0, 1.0)
        pcm = pcm * gain
        s["ramp"] = max(s["ramp"] - Tw, 0)
        out["audio"] = torch.stack([pcm.real, pcm.imag], -1)
        return s, out
