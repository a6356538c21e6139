"""The plain reference of the receive chain: one station of 2.304 MS/s
integer IQ in, 48 kHz stereo audio and the RDS bits and symbols out, block
by block with the streams carried between blocks.

It is written in plain torch operations on float32 data (the precision the
configurations state), from the designs in `design.py`: no kernel, graph or
batching, and nothing of the program under test.  The chain is the one the
port's main path computes, stage for stage: the DC servo and the ÷12
lowpass; the normalised phase-difference discriminator with its AFC; the
pilot's analytic bandpass, its phase and its lock; the pilot-phase stereo
separation (PSS) adaptation; the stereo matrix; the 57 kHz RDS band, mixed
down with the delayed pilot phase and taken to 24 kS/s; BPSK bit recovery
with its matched filter, squared-BPSK carrier phase and energy bit timing;
the 15 kHz audio lowpass with the deemphasis folded in; ÷4 to 48 kHz and
the start-up ramp.  A receiver tuned `tune_hz` off the capture's centre
mixes the DC-corrected wire by e^{-j 2 pi f n / 2,304,000}, n the sample's
index from the start of the input, its phase formed exactly in integers.
The FIR filters run as block Toeplitz matrix products
and the one-pole trackers as chunked ones, so that the card's lower-precision (TF32)
routes reach every stage when `precision="tf32"` asks for them.  (cuDNN
runs these one-dimensional convolutions as direct kernels that never take
the TF32 route, so the filters here are matrix products too.)

Only the options the benchmark's configurations set are implemented; any
other value is refused.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import design as D

Tensor = torch.Tensor

# the keys a configuration may set, with the one value each must have
# unless the chain below implements more
_FIXED = dict(input_rate=D.INPUT_RATE, fm_rate=D.FM_RATE,
              working_rate=D.WORKING_RATE, audio_rate=D.WORKING_RATE,
              rds_rate=D.RDS_RATE, native_rate=0,
              decoder="complex_baseband", mode="stereo", sound="stereo",
              panorama=1.0, pss_active=True, auto_mono=True,
              deemphasis_us=50.0, input_filter=False, squelch="off",
              dc_remove=True, frontend="flat", fm_fft=D.FM_FFT,
              fm_hop=D.FM_HOP, test_tone=False, emit_taps=False,
              emit_input_tap=False, emit_audio_i16=False)
_WIRE = {"i16": 1.0 / 32768.0, "i8": 1.0 / 128.0}


@contextlib.contextmanager
def precision(mode: str):
    """float32 matrix products and convolutions ("f32": TF32 off) or the
    card's TF32 routes ("tf32"); the flags are put back afterwards."""
    if mode not in ("f32", "tf32"):
        raise ValueError(f"precision {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# plain operations
# ---------------------------------------------------------------------------

class Fir:
    """A causal FIR, decimating by `stride` (output m is the filter at
    input m*stride + stride-1), carrying its last K-1 inputs, computed as
    matrix products: the stream cut into blocks of B samples (B >= K-1, the
    stride times a power of two), each block's outputs the lower-triangular
    Toeplitz matrix of the taps times the block plus the upper one times
    the block before it."""

    def __init__(self, taps, stride: int, device):
        h = np.asarray(taps, np.float32)
        K = len(h)
        B = stride
        while B < max(64, K - 1):
            B *= 2
        lag = np.arange(B)[:, None] - np.arange(B)[None, :]
        pick = lambda d: np.where((d >= 0) & (d < K),  # noqa: E731
                                  h[np.clip(d, 0, K - 1)], 0.0)
        rows = slice(stride - 1, None, stride)
        self.H0 = torch.as_tensor(pick(lag)[rows].astype(np.float32),
                                  device=device)
        self.H1 = torch.as_tensor(pick(lag + B)[rows].astype(np.float32),
                                  device=device)
        self.K, self.B = K, B

    def __call__(self, x: Tensor, carry: Tensor):
        K, B = self.K, self.B
        xp = torch.cat([carry.to(x.dtype), x])
        new = xp[-(K - 1):]
        blocks = torch.cat([F.pad(carry.to(x.dtype), (B - (K - 1), 0)), x]
                           ).view(-1, B)
        planes = [blocks.real, blocks.imag] if x.is_complex() else [blocks]
        cur = torch.cat([p[1:] for p in planes]).t()
        prev = torch.cat([p[:-1] for p in planes]).t()
        y = (self.H0 @ cur + self.H1 @ prev).t()       # [planes x n, B/s]
        y = y.reshape(len(planes), -1)
        return (torch.complex(y[0], y[1]) if x.is_complex() else y[0]), new


def fft_filter(x: Tensor, H: Tensor, hop: int, carry: Tensor):
    """Overlap-save filter of a complex stream x [T] by the response H
    [Fs], carrying the last Fs-hop inputs."""
    Fs = H.shape[0]
    xp = torch.cat([carry, x.to(torch.complex64)])
    frames = xp.unfold(0, Fs, hop)
    y = torch.fft.ifft(torch.fft.fft(frames) * H)[:, Fs - hop:]
    return y.reshape(-1), xp[-(Fs - hop):]


CHUNK = 128


def one_pole(drive: Tensor, g: float, y0: Tensor):
    """y[n] = g y[n-1] + drive[n], as chunks of a lower-triangular g^(i-j)
    product and the same recurrence over the chunk ends."""
    T = drive.shape[0]
    n = -(-T // CHUNK)
    gd = float(np.float32(g))
    i = np.arange(CHUNK)
    e = i[:, None] - i[None, :]
    with np.errstate(under="ignore"):
        L = np.where(e >= 0, gd ** np.maximum(e, 0), 0.0).astype(np.float32)
        pw = (gd ** (i + 1)).astype(np.float32)
    L = torch.as_tensor(L, device=drive.device)
    pw = torch.as_tensor(pw, device=drive.device)
    dp = F.pad(drive.to(torch.float32), (0, n * CHUNK - T)).view(n, CHUNK)
    local = dp @ L.t()
    if n == 1:
        c_in = y0.reshape(1).to(torch.float32)
    else:
        ends, _ = one_pole(local[:, -1].contiguous(), gd ** CHUNK, y0)
        c_in = torch.cat([y0.reshape(1).to(torch.float32), ends[:-1]])
    y = (local + c_in[:, None] * pw[None, :]).reshape(-1)[:T]
    return y, y[-1]


def ema(x: Tensor, alpha: float, y0: Tensor):
    return one_pole(alpha * x, 1.0 - alpha, y0)


def run_length(flags: Tensor, r0: Tensor):
    """Consecutive-true run length ending at each sample, from r0."""
    T = flags.shape[0]
    idx = torch.arange(T, device=flags.device)
    last_false = torch.cummax(torch.where(flags, -1, idx), 0).values
    rl = torch.where(last_false >= 0, idx - last_false, idx + 1 + r0)
    rl = torch.where(flags, rl, 0)
    return rl, rl[-1]


# ---------------------------------------------------------------------------
# the receiver
# ---------------------------------------------------------------------------

class PlainReceiver:
    """`step(state, wire) -> (state, out)`: wire one block of int16 (or
    int8) [T, 2] frames on `device`; out holds `audio` [T/48, 2] float32,
    `bits` int8 and `iq` complex64 (the RDS bits and their symbols, count
    long; with `rds="block"` only) and `locked` (the pilot lock at the
    block's end).  `tune_hz`: the station's offset from the capture's
    centre, a whole number of Hz."""

    def __init__(self, receiver: dict, device="cpu", tune_hz: int = 0):
        cfg = dict(receiver)
        for k, v in cfg.items():
            if k in _FIXED and v != _FIXED[k]:
                raise NotImplementedError(f"reference: {k}={v!r}")
            if k not in _FIXED and k not in ("block_fm", "rds",
                                             "audio_filter_hz", "iq_format"):
                raise NotImplementedError(f"reference: no option {k!r}")
        self.block_fm = int(cfg.get("block_fm", 131072))
        self.rds = cfg.get("rds", "block")
        self.fmt = cfg.get("iq_format", "c64")
        if self.rds not in ("block", "off") or self.fmt not in _WIRE:
            raise NotImplementedError(f"reference: rds={self.rds!r}, "
                                      f"iq_format={self.fmt!r}")
        audio_hz = int(cfg.get("audio_filter_hz", 0))
        if audio_hz <= 0:
            raise NotImplementedError("reference: audio_filter_hz > 0 only")
        self.device = torch.device(device)
        self.T = self.block_fm * 12
        if int(tune_hz) != tune_hz:
            raise NotImplementedError("reference: tune_hz a whole number")
        self.tune = int(tune_hz) % D.INPUT_RATE
        f32 = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=self.device)
        c64 = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.complex64), device=self.device)
        # the composite ÷12 kernel: a 127-tap lowpass at 2.304 MS/s and a
        # 31-tap one at 384 kS/s (both 110 kHz), the second upsampled by 6
        k1 = D.lowpass(127, 110000.0, D.INPUT_RATE).astype(np.float32)
        k2 = D.lowpass(31, 110000.0, D.INPUT_RATE / 6).astype(np.float32)
        up = np.zeros(6 * 30 + 1)
        up[::6] = k2
        self.fe = Fir(np.convolve(k1.astype(np.float64), up), 12, device)
        self.g_dc = float((1.0 - D.RF_DC_ALPHA) ** self.T)
        pilot = D.bandpass_complex(D.PILOT_BP_TAPS, D.PILOT_HZ - 500.0,
                                   D.PILOT_HZ + 500.0, D.FM_RATE)
        self.H_pilot = c64(5.0 * D.response(pilot, D.FM_FFT)
                           .astype(np.complex64))
        self.pilot_delay = (D.PILOT_BP_TAPS - 1) // 2
        self.pss_fir = Fir(D.lowpass(D.PSS_TAPS, 15000.0, D.FM_RATE), 1,
                           device)
        self.pss_sub = min(4096, self.block_fm)
        lam = 1.0 / D.FM_RATE
        m = np.arange(self.pss_sub)
        self.pss_w = f32(lam * (1.0 - lam) ** (self.pss_sub - 1 - m))
        self.pss_decay = float(np.float32((1.0 - lam) ** self.pss_sub))
        rds = D.bandpass_complex(769, D.RDS_HZ - D.RDS_WIDTH / 2,
                                 D.RDS_HZ + D.RDS_WIDTH / 2, D.FM_RATE)
        self.H_rds = c64(D.response(rds, D.FM_FFT))
        self.rds_delay = 384
        self.rds_fir = Fir(D.lowpass(D.RDS_DECIM_TAPS, D.RDS_RATE / 2,
                                     D.FM_RATE), 8, device)
        self.mf = Fir(D.rrc(D.RDS_RATE, 2 * D.RDS_BITCLK_HZ, 45), 1, device)
        self.block_rds = self.block_fm // 8
        self.phase_sub = min(2048, self.block_rds)
        # the audio lowpass with the deemphasis one-pole folded in
        a = D.deemphasis_alpha(50.0)
        k_af = D.lowpass(D.AUDIO_FILTER_TAPS, audio_hz, D.FM_RATE)
        max_deg = D.FM_FFT - D.FM_HOP + 1 - len(k_af)
        L = min(max_deg, int(np.ceil(-104.0 / np.log2(1.0 - a))))
        if L > max_deg:
            raise NotImplementedError("reference: deemphasis as a scan")
        k_af = np.convolve(k_af, a * (1.0 - a) ** np.arange(L))
        self.H_audio = c64(D.response(k_af, D.FM_FFT))
        self.audio_fir = Fir(D.lowpass(4 * 32 + 1, 0.9 * 0.5 / 4, 1.0), 4,
                             device)

    def init_state(self) -> dict:
        dev = self.device
        c = lambda n: torch.zeros(n, dtype=torch.complex64,  # noqa: E731
                                  device=dev)
        z = lambda dt=torch.float32: torch.zeros(  # noqa: E731
            (), dtype=dt, device=dev)
        z01 = torch.tensor(0.01 + 0.01j, dtype=torch.complex64, device=dev)
        return dict(n_mod=0, rf_dc=z(torch.complex64), fe=c(306),
                    prev=z01, afc=z(),
                    demod_tail=c(D.FM_FFT - D.FM_HOP), lock_metric=z(),
                    lock_run=z(torch.int64),
                    pss=(z(), z(), z(torch.bool), z(torch.int64),
                         z(torch.int64)),
                    pss_tail=c(D.PSS_TAPS - 1),
                    phase_delay=torch.zeros(self.rds_delay, device=dev),
                    rds_decim=c(D.RDS_DECIM_TAPS - 1),
                    mf=c(44), psi=z(), tau=z(), prev_sym=z(torch.bool),
                    timing_locked=False,
                    audio_filt=c(D.FM_FFT - D.FM_HOP),
                    audio_decim=c(4 * 32),
                    ramp=D.WORKING_RATE // 2)

    # -- stages ------------------------------------------------------------
    def _front_end(self, s, wire):
        x = wire.to(torch.float32) * _WIRE[self.fmt]
        x = torch.complex(x[:, 0], x[:, 1])
        lim = D.RF_DC_LIMIT
        corr = torch.complex(s["rf_dc"].real.clamp(-lim, lim),
                             s["rf_dc"].imag.clamp(-lim, lim))
        sub = x[::64].mean()
        x = x - corr
        q = D.INPUT_RATE
        if self.tune:
            # the phase of sample n is 2 pi ((f mod q)(n mod q) mod q) / q
            n = (s["n_mod"] + torch.arange(self.T, dtype=torch.int64,
                                           device=x.device)) % q
            th = (self.tune * n % q).to(torch.float64) * (2.0 * math.pi / q)
            x = x * torch.polar(torch.ones_like(th), -th).to(torch.complex64)
        # (at 0 Hz the exact mix is the identity)
        v, fe = self.fe(x, s["fe"])
        rf_dc = self.g_dc * s["rf_dc"] + (1.0 - self.g_dc) * sub
        return v, dict(rf_dc=rf_dc, fe=fe, n_mod=(s["n_mod"] + self.T) % q)

    def _pss(self, s, demod, base, locked):
        S = self.pss_sub
        alpha = float(np.float32(D.PSS_ALPHA))
        hold = int(D.PSS_LOCK_STABLE_S * D.FM_RATE)
        u = torch.complex(torch.cos(base), torch.sin(base)) * demod
        Fb, tail = self.pss_fir(u, s["pss_tail"])
        G = (Fb * Fb).view(-1, S)
        Sk, Wk = G.sum(-1), (G * self.pss_w).sum(-1)
        sub_locked = locked.view(-1, S)[:, 0]
        acc, me, minimized, lock_run, unlock_run = s["pss"]
        accs = []
        for k in range(Sk.shape[0]):
            lk = sub_locked[k]
            boost = torch.where(minimized, 1.0, D.PSS_ERROR_BOOST)
            c, sn = torch.cos(-2.0 * acc), torch.sin(-2.0 * acc)
            err = 0.5 * (c * Sk[k].imag + sn * Sk[k].real) * boost
            acc_n = torch.clamp(acc + alpha * err, -D.PSS_CLAMP, D.PSS_CLAMP)
            me_n = self.pss_decay * me + 0.5 * boost * (c * Wk[k].imag
                                                        + sn * Wk[k].real)
            below = torch.abs(me_n) < D.PSS_LOCK_THRESHOLD
            lock_n = torch.where(below, lock_run + S, 0)
            unlock_n = torch.where(below, 0, unlock_run + S)
            min_n = torch.where(below, minimized | (lock_n > hold),
                                minimized & ~(unlock_n > hold))
            accs.append(torch.where(lk, acc, 0.0))
            acc = torch.where(lk, acc_n, 0.0)
            me = torch.where(lk, me_n, 0.0)
            minimized = lk & min_n
            lock_run = torch.where(lk, lock_n, 0)
            unlock_run = torch.where(lk, unlock_n, 0)
        off = torch.stack(accs)[:, None].expand(-1, S).reshape(-1)
        return off, dict(pss=(acc, me, minimized, lock_run, unlock_run),
                         pss_tail=tail)

    def _bits(self, s, z):
        """BPSK bit recovery at 24 kS/s: matched filter, carrier phase per
        sub-block (squared-BPSK estimate, unwrapped), energy bit timing
        over 64 offsets, the bit grid by linear interpolation,
        differential decoding."""
        T, dev = z.shape[0], z.device
        sps = 384.0 / 19.0
        y, mf = self.mf(z, s["mf"])
        P = self.phase_sub
        raw = 0.5 * torch.angle((y * y).view(-1, P).mean(-1))
        psi, psis = s["psi"], []
        for r in raw:
            psi = r + torch.round((psi - r) / math.pi) * math.pi
            psis.append(psi)
        ph = torch.stack(psis)[:, None].expand(-1, P).reshape(-1)
        yr = y * torch.complex(torch.cos(ph), -torch.sin(ph))

        def interp(pos):
            i0 = torch.floor(pos).to(torch.int64)
            fr = pos - i0.to(torch.float32)
            return yr[i0] + (yr[i0 + 1] - yr[i0]) * fr

        nprobe = int(T // sps) - 1
        offs = torch.arange(64, dtype=torch.float32, device=dev) / 64 * sps
        pos = offs[:, None] + torch.arange(nprobe, dtype=torch.float32,
                                           device=dev)[None, :] * sps
        energy = (torch.abs(interp(pos)) ** 2).sum(-1)
        tau_best = offs[torch.argmax(energy)]
        if s["timing_locked"]:
            dt = tau_best - torch.remainder(s["tau"], sps)
            dt = dt - sps * torch.round(dt / sps)
            step = (sps / 64) * min(1.0, nprobe / 190.0)
            tau0 = s["tau"] + torch.clamp(dt, -step, step)
        else:
            tau0 = tau_best
        cap = int(np.ceil(T / sps)) + 2
        bit_pos = tau0 + torch.arange(cap, dtype=torch.float32,
                                      device=dev) * sps
        count = int((bit_pos <= T - 2).sum())
        sym = interp(torch.clamp(bit_pos, 0.0, T - 2))[:count]
        hard = sym.real >= 0.0
        prev = torch.cat([s["prev_sym"].reshape(1), hard[:-1]])
        bits = (hard ^ prev).to(torch.int8)
        tau = tau0 + torch.tensor(float(count), device=dev) * sps - T
        new = dict(mf=mf, psi=psi, tau=tau,
                   prev_sym=hard[-1] if count else s["prev_sym"],
                   timing_locked=True)
        return bits, sym * 4.0, new

    # -- the block ---------------------------------------------------------
    def step(self, s: dict, wire: Tensor):
        if tuple(wire.shape) != (self.T, 2):
            raise ValueError(f"reference: block of shape {tuple(wire.shape)}"
                             f", want {(self.T, 2)}")
        s = dict(s)
        v, upd = self._front_end(s, wire)
        s.update(upd)
        # discriminator: arg(z conj(z[-1])) of the normalised stream, less
        # the AFC's one-pole average, scaled 20/K_FM
        mag = torch.abs(v)
        small = mag <= 1e-3
        safe = torch.where(small, 1.0, mag)
        zn = torch.complex(torch.where(small, 1e-3, v.real / safe),
                           torch.where(small, 1e-3, v.imag / safe))
        p1 = torch.cat([s["prev"].reshape(1), zn[:-1]])
        d = zn * torch.conj(p1)
        res = torch.atan2(d.imag, d.real)
        afc, s["afc"] = ema(res, D.FM_DC_ALPHA, s["afc"])
        s["prev"] = zn[-1]
        demod = D.DEMOD_GAIN * (res - afc) / D.k_fm()
        # pilot: analytic bandpass, phase, lock metric and 500 ms hold
        # (the 57 kHz RDS band is filtered from the same demod history)
        p, tail = fft_filter(demod, self.H_pilot, D.FM_HOP, s["demod_tail"])
        rds57, _ = fft_filter(demod, self.H_rds, D.FM_HOP, s["demod_tail"])
        s["demod_tail"] = tail
        w19 = 2.0 * math.pi * D.PILOT_HZ / D.FM_RATE
        phase = torch.angle(p) + (w19 * self.pilot_delay + math.pi)
        strength, s["lock_metric"] = ema(torch.abs(p), D.PILOT_LOCK_ALPHA,
                                         s["lock_metric"])
        run, s["lock_run"] = run_length(strength > D.PILOT_LOCK_THRESHOLD,
                                        s["lock_run"])
        locked = run > int(D.PILOT_LOCK_STABLE_S * D.FM_RATE)
        base = 2.0 * (phase + math.pi / 4.0)
        off, upd = self._pss(s, demod, base, locked)
        s.update(upd)
        diff = torch.where(locked, 2.0 * torch.cos(base - off) * demod, 0.0)
        audio = torch.complex(demod + diff, demod - diff)
        out = dict(locked=bool(locked[-1]))
        if self.rds == "block":
            ph = torch.cat([s["phase_delay"], phase])
            s["phase_delay"] = ph[-self.rds_delay:]
            th = 3.0 * ph[:self.block_fm]
            bb = rds57 * torch.complex(torch.cos(th), -torch.sin(th))
            z24, s["rds_decim"] = self.rds_fir(bb, s["rds_decim"])
            out["bits"], out["iq"], upd = self._bits(s, z24)
            s.update(upd)
        audio, s["audio_filt"] = fft_filter(audio, self.H_audio, D.FM_HOP,
                                            s["audio_filt"])
        pcm, s["audio_decim"] = self.audio_fir(audio, s["audio_decim"])
        Tw = pcm.shape[0]
        ramp_max = D.WORKING_RATE // 2
        pos = ramp_max - s["ramp"]
        gain = torch.clamp((pos + torch.arange(Tw, dtype=torch.float32,
                                               device=pcm.device))
                           / ramp_max, 0.0, 1.0)
        pcm = pcm * gain
        s["ramp"] = max(s["ramp"] - Tw, 0)
        out["audio"] = torch.stack([pcm.real, pcm.imag], -1)
        return s, out
