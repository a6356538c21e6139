"""Core block-processing primitives, in torch (port of sdrjfm_tpu.ops.blockops).

Every primitive maps a whole time block `[T]` at once and threads an
explicit carry, so consecutive blocks stitch exactly to one long-array
computation (the tests hold split blocks against the whole array).  A
block may carry leading rows, `[..., T]` with carries `[..., K]`: each
row is its own stream (a station), every row goes through the same ops
(conv1d's batch, the FFTs' batch, one scan or pole-bank launch), and the
result is the port's counterpart of `jax.vmap` over the rows:

- FIR / decimating FIR  -> strided `conv1d` over `concat(carry, x)` on split
                           real/imag planes (carry = last taps-1 inputs)
- overlap-save filter   -> batched `torch.fft` convolution (carry = last
                           F-hop inputs), zero block latency
- polyphase interpolation -> one `conv1d` with a channel per phase
- one-pole trackers     -> the first-order recurrence scan kernel
                           (`kernels/linrec.py`), carry = last output
- biquad cascades       -> `IIRSpec`: a short FIR numerator, then a bank of
                           complex one-pole recurrences summed with their
                           residues, in one call of the pole-bank kernel
- lock counters         -> run length of true via `torch.cummax`
- LO mix                -> exact integer NCO phase, base-512 int32 digits
- rate conversion       -> linear interpolation at exact rational positions

Nothing here synchronises with the host: scalars that vary at run time are
0-dim device tensors, and constants are Python numbers passed to the ops.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.linrec import (PoleBank, fold_bank, linrec, pole_bank,
                              pole_bank_constants)
from ..kernels.loops import runlength

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# FIR convolution with explicit left context
# ---------------------------------------------------------------------------


def _lead(x: Tensor) -> Tuple[int, ...]:
    """The leading (row) dimensions of a [..., T] block."""
    return tuple(x.shape[:-1])


def _conv_complex(xp: Tensor, kernel: Tensor, stride: int) -> Tensor:
    """Strided VALID causal conv of complex xp [..., L] with a real or
    complex kernel: y[..., n] = sum_k kernel[k] * xp[..., n*stride + K-1 -
    k].  The rows' real and imaginary planes are conv1d's batch."""
    k = kernel.flip(0)
    if k.is_complex():
        w = torch.stack([k.real, k.imag])[:, None, :]       # [2, 1, K]
    else:
        w = k.to(torch.float32)[None, None, :]              # [1, 1, K]
    inp = torch.stack([xp.real, xp.imag]).reshape(-1, 1, xp.shape[-1])
    out = F.conv1d(inp, w, stride=stride)                   # [2N, C, T]
    out = out.view(2, -1, out.shape[1], out.shape[2])       # [2, N, C, T]
    if k.is_complex():
        y = torch.complex(out[0, :, 0] - out[1, :, 1],
                          out[1, :, 0] + out[0, :, 1])
    else:
        y = torch.complex(out[0, :, 0], out[1, :, 0])
    return y.reshape(_lead(xp) + (y.shape[-1],))


def _conv_valid_real(xp: Tensor, kernel: Tensor, stride: int = 1) -> Tensor:
    w = kernel.flip(0).to(xp.dtype)[None, None, :]
    y = F.conv1d(xp.reshape(-1, 1, xp.shape[-1]), w, stride=stride)[:, 0]
    return y.reshape(_lead(xp) + (y.shape[-1],))


def fir_apply(x: Tensor, kernel: Tensor, carry: Tensor
              ) -> Tuple[Tensor, Tensor]:
    """Causal FIR over a block.  kernel[0] multiplies the newest sample;
    carry holds the previous K-1 inputs.  x [..., T] with carry [..., K-1]
    (each row its own stream).  Returns (y [..., T], new_carry)."""
    K = kernel.shape[0]
    xp = torch.cat([carry.to(x.dtype), x], dim=-1)
    new_carry = xp[..., -(K - 1):] if K > 1 else carry
    if xp.is_complex() or kernel.is_complex():
        y = _conv_complex(xp.to(torch.complex64), kernel, stride=1)
    else:
        y = _conv_valid_real(xp, kernel)
    return y, new_carry


def fir_decimate(x: Tensor, kernel: Tensor, factor: int, carry: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """Decimating causal FIR: output m is the filter at input sample
    m*factor + factor - 1 of the stream (the reference's decimation
    counter).  x [..., T] with T % factor == 0.  Returns (y [...,
    T/factor], new_carry [..., K-1])."""
    T = x.shape[-1]
    assert T % factor == 0, (T, factor)
    K = kernel.shape[0]
    xp = torch.cat([carry.to(x.dtype), x], dim=-1)
    new_carry = xp[..., -(K - 1):]
    xp = xp[..., factor - 1:]
    if xp.is_complex() or kernel.is_complex():
        y = _conv_complex(xp, kernel, stride=factor)
    else:
        y = _conv_valid_real(xp, kernel, stride=factor)
    return y, new_carry


def fir_interpolate(x: Tensor, kernel: Tensor, factor: int, carry: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Polyphase interpolation by `factor` (zero-stuff + lowpass, gain
    compensated): y[m*factor + p] = factor * sum_j kernel[p + j*factor]
    x[m - j].  carry holds the last ceil(K/factor) - 1 inputs.  x [..., T]
    -> (y [..., T*factor], new_carry)."""
    K = kernel.shape[0]
    phases = (K + factor - 1) // factor
    xp = torch.cat([carry.to(x.dtype), x], dim=-1)
    new_carry = xp[..., -(phases - 1):] if phases > 1 else carry
    k_pad = F.pad(kernel.to(torch.float32), (0, phases * factor - K))
    # channel p holds branch p's taps, newest input last (a correlation)
    w = k_pad.view(phases, factor).t().flip(1)[:, None, :].contiguous()
    L = xp.shape[-1]
    out_len = _lead(x) + (x.shape[-1] * factor,)
    if xp.is_complex():
        inp = torch.stack([xp.real, xp.imag]).reshape(-1, 1, L)
        out = F.conv1d(inp, w)                              # [2N, factor, T]
        y = out.transpose(1, 2).reshape(2, -1)
        y = torch.complex(y[0], y[1]).reshape(out_len)
    else:
        out = F.conv1d(xp.reshape(-1, 1, L), w)             # [N, factor, T]
        y = out.transpose(1, 2).reshape(out_len)
    return y * factor, new_carry


def fir_zero_state(kernel_len: int, device=None,
                   dtype=torch.complex64) -> Tensor:
    return torch.zeros(kernel_len - 1, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Overlap-save FFT fast convolution
# ---------------------------------------------------------------------------


def fft_filter_apply(x: Tensor, response: Tensor, hop: int, carry: Tensor
                     ) -> Tuple[Tensor, Tensor]:
    """Overlap-save convolution of a block with a frozen kernel.
    response [F] complex; x [..., T] with carry [..., F-hop] trailing
    inputs.  Returns (y [..., T] causal filtered block, real when x is
    real; new_carry)."""
    Fs = response.shape[0]
    halo = Fs - hop
    T = x.shape[-1]
    assert T % hop == 0, (T, hop, Fs)
    xp = torch.cat([carry, x.to(carry.dtype)], dim=-1)
    new_carry = xp[..., -halo:]
    frames = xp.unfold(-1, Fs, hop)                         # [..., T/hop, F]
    out = torch.fft.ifft(torch.fft.fft(frames.to(torch.complex64))
                         * response)
    y = out[..., halo:].reshape(_lead(x) + (T,))
    if not x.is_complex():
        y = y.real
    return y, new_carry


def _frames_rfft(xp: Tensor, Fs: int, hop: int, n: int) -> Tensor:
    """rfft of the first n frames (length Fs, step hop) of each row of the
    real stream xp.real ([R, L] complex storage): [R, n, Fs/2+1].  The rows
    are laid end to end (each padded to a multiple of hop) and framed as
    ONE strided stream, the layout a single row's frames have, so that
    every frame's transform is the one-row call's bit for bit; the frames
    that straddle two rows are computed and dropped."""
    R, L = xp.shape
    m = -(-L // hop)                          # frame starts a padded row
    flat = F.pad(xp, (0, m * hop - L)).reshape(-1)
    flat = F.pad(flat, (0, Fs - hop))
    spec = torch.fft.rfft(flat.unfold(0, Fs, hop).real)      # [R*m, F/2+1]
    return spec.view(R, m, -1)[:, :n]


def fft_filter_apply_multi(x: Tensor, responses: Tensor, hop: int,
                           carry: Tensor) -> Tuple[Tensor, Tensor]:
    """M overlap-save convolutions of ONE block sharing one forward FFT;
    for a real input the forward runs as an rfft with the negative half
    mirrored by conjugate symmetry.  responses [M, F]; x [..., T] with
    carry [..., F-hop] (complex storage, zero imaginary part for a real
    stream).  Returns (ys [M, ..., T] complex, new_carry)."""
    M, Fs = responses.shape
    halo = Fs - hop
    T = x.shape[-1]
    lead = _lead(x)
    assert T % hop == 0, (T, hop, Fs)
    xp = torch.cat([carry.to(torch.complex64), x.to(torch.complex64)],
                   dim=-1)
    new_carry = xp[..., -halo:]
    if x.is_complex():
        spec = torch.fft.fft(xp.unfold(-1, Fs, hop))
    else:
        if lead:
            r = _frames_rfft(xp.reshape(-1, xp.shape[-1]), Fs, hop,
                             T // hop).reshape(lead + (T // hop, -1))
        else:
            r = torch.fft.rfft(xp.unfold(0, Fs, hop).real)
        spec = torch.cat([r, r[..., 1:Fs // 2].flip(-1).conj()], dim=-1)
    resp = responses.reshape((M,) + (1,) * (len(lead) + 1) + (Fs,))
    out = torch.fft.ifft(spec[None] * resp)                # [M, ..., nf, F]
    ys = out[..., halo:].reshape((M,) + lead + (T,))
    return ys, new_carry


def fft_filter_zero_state(fft_size: int, hop: int, device=None,
                          dtype=torch.complex64) -> Tensor:
    return torch.zeros(fft_size - hop, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Integer sample delay with carry
# ---------------------------------------------------------------------------


def delay_apply(x: Tensor, carry: Tensor) -> Tuple[Tensor, Tensor]:
    """Delay a stream by len(carry) samples (x [..., T], carry [..., D]).
    Returns (delayed, new carry)."""
    if carry.shape[-1] == 0:
        return x, carry
    T = x.shape[-1]
    xp = torch.cat([carry, x], dim=-1)
    return xp[..., :T], xp[..., T:]


# ---------------------------------------------------------------------------
# First-order linear recurrences (one-pole trackers) — the scan kernel
# ---------------------------------------------------------------------------


def linrec_apply(drive: Tensor, g: float, y0: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """y[n] = g*y[n-1] + drive[n] for a real [..., T] block with a constant
    decay g and initial state y0 [...] (y[-1]), every row in ONE launch of
    the scan kernel.  Returns (y [..., T], y[..., T-1])."""
    T = drive.shape[-1]
    d = drive.to(torch.float32).reshape(-1, T).contiguous()
    y, last = linrec(d, [g] * d.shape[0], y0.to(torch.float32).reshape(-1))
    return y.view(drive.shape), last.view(_lead(drive))


def ema_apply(x: Tensor, alpha: float, y0: Tensor) -> Tuple[Tensor, Tensor]:
    """Exponential moving average y[n] = (1-alpha)*y[n-1] + alpha*x[n]."""
    return linrec_apply(alpha * x, 1.0 - alpha, y0)


def ema_apply_complex(x: Tensor, alpha: float, y0: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """ema_apply over a complex stream with a real decay: the real and
    imaginary parts as rows of ONE scan launch.  Returns (y [..., T]
    complex64, y[..., T-1]).  alpha = 1 (deemphasis off) is the identity,
    with no launch (the scan kernel takes decays in (0, 1])."""
    if alpha >= 1.0:
        x = x.to(torch.complex64)
        return x, x[..., -1]
    (yr, lr), (yi, li) = ema_apply_rows([x.real, x.imag], [alpha] * 2,
                                        [y0.real, y0.imag])
    return torch.complex(yr, yi), torch.complex(lr, li)


def ema_apply_rows(xs: Sequence[Tensor], alphas: Sequence[float],
                   y0s: Sequence[Tensor]):
    """Several independent EMAs over equal-shape blocks [..., T] (states
    [...]) in ONE scan launch of len(xs) x rows rows.  Returns [(y_i,
    last_i)] in input order."""
    drive = torch.stack([a * x.to(torch.float32)
                         for a, x in zip(alphas, xs)])
    y0 = torch.stack([v.to(torch.float32) for v in y0s])
    n = drive[0].numel() // drive.shape[-1]
    y, last = linrec(drive.reshape(-1, drive.shape[-1]),
                     [1.0 - a for a in alphas for _ in range(n)],
                     y0.reshape(-1))
    y, last = y.view(drive.shape), last.view(y0.shape)
    return [(y[i], last[i]) for i in range(len(xs))]


# ---------------------------------------------------------------------------
# Biquad cascades as complex first-order recurrences
# ---------------------------------------------------------------------------
class IIRSpec:
    """Frozen pole/zero form of a biquad cascade (host-side construction,
    the JAX package's IIRSpec array for array): a real FIR numerator `num`
    and complex one-pole recurrences `poles` whose outputs are summed with
    the `residues` of 1/prod(1 - p_i z^-1)."""

    def __init__(self, sos: np.ndarray):
        from scipy import signal
        sos = np.asarray(sos, dtype=np.float64)
        z, p, k = signal.sos2zpk(sos)
        # SOS padding introduces matched zero/pole pairs at the origin
        # ((z-0)/(z-0) == 1); cancel them before partial fractions.
        z = np.asarray(z, dtype=np.complex128)
        p = np.asarray(p, dtype=np.complex128)
        z0 = np.abs(z) < 1e-12
        p0 = np.abs(p) < 1e-12
        ncancel = min(z0.sum(), p0.sum())
        if ncancel:
            z = np.concatenate([z[~z0], z[z0][: z0.sum() - ncancel]])
            p = np.concatenate([p[~p0], p[p0][: p0.sum() - ncancel]])
        if np.any(np.abs(p) < 1e-12):
            raise ValueError("IIRSpec: unmatched pole at the origin")
        b = np.real(np.poly(z)) * k
        self.num = b.astype(np.float32)          # [nz+1]
        # perturb (near-)repeated poles so partial fractions stay finite
        for i in range(len(p)):
            for j in range(i):
                if abs(p[i] - p[j]) < 1e-9:
                    p[i] += 1e-6 * (1 + 1j)
        self.poles = p.astype(np.complex64)      # [np]
        res = []
        for i, pi in enumerate(p):
            others = np.prod([1.0 - (pj / pi)
                              for j, pj in enumerate(p) if j != i])
            res.append(1.0 / others)
        self.residues = np.asarray(res, dtype=np.complex64)

    def zero_state(self, device=None):
        return (torch.zeros(len(self.poles), dtype=torch.complex64,
                            device=device),
                torch.zeros(max(len(self.num) - 1, 0), dtype=torch.float32,
                            device=device))


class IIRBank:
    """Device copies of several cascades' constants, for iir_apply_many:
    each cascade's numerator taps `nums` and the pole-bank kernel's
    constants `poles`, with their n-row copies (`folded`) made so far."""

    def __init__(self, nums: Tuple[Tensor, ...], poles: PoleBank):
        self.nums, self.poles = nums, poles
        self._folds = {1: poles}

    def folded(self, n: int) -> PoleBank:
        """The pole bank repeated for n rows (`fold_bank`), built on the
        device at its first use for each n, so a block loop copies
        nothing from the host."""
        got = self._folds.get(n)
        if got is None:
            got = self._folds[n] = fold_bank(self.poles, n)
        return got


def iir_bank(specs: Sequence[IIRSpec], device) -> IIRBank:
    """An IIRBank on `device`.  Build it once per design: a fresh
    host-to-device copy per block would synchronise."""
    return IIRBank(tuple(torch.as_tensor(s.num, device=device)
                         for s in specs),
                   pole_bank_constants(specs, device))


def bank_rows(drives: Sequence[Tensor], bank: IIRBank, w0s):
    """The pole-bank kernel's operands for several cascades over [..., T]
    rows: drive [N*B, T] (row s*B + b: cascade b of row s), the pole bank
    folded N times and the entry states [N*B, P] (each cascade's [..., P_b]
    padded to P)."""
    P = bank.poles.poles.shape[1]
    T = drives[0].shape[-1]
    n = drives[0].numel() // T
    drive = torch.stack(drives, dim=-2).reshape(-1, T)
    w0 = torch.stack([w if w.shape[-1] == P else F.pad(w, (0, P - w.shape[-1]))
                      for w in w0s], dim=-2).reshape(-1, P)
    return drive, bank.folded(n), w0


def bank_unrows(y: Tensor, wT: Tensor, bank: PoleBank, lead) -> list:
    """Invert `bank_rows` on the kernel's outputs: [(y_b [..., T], wT_b
    [..., P_b])] per cascade."""
    y = y.view(tuple(lead) + (len(bank.sizes), y.shape[-1]))
    wT = wT.view(tuple(lead) + (len(bank.sizes), wT.shape[-1]))
    return [(y[..., b, :], wT[..., b, :n]) for b, n in enumerate(bank.sizes)]


def iir_apply_many(xs: Sequence[Tensor], bank: IIRBank, states) -> list:
    """Several biquad cascades over equal-shape real blocks [..., T] (each
    row its own stream), every row's pole banks in ONE call of the
    pole-bank kernel.  Each numerator FIR is a conv1d (the JAX package runs
    it as an XLA conv too).  Returns [(y [..., T] f32, (pole states [...,
    P] c64, numerator history [..., nz]))]."""
    drives, carries = [], []
    for x, num, (_, fir_carry) in zip(xs, bank.nums, states):
        if num.shape[0] > 1:
            xb, fir_carry = fir_apply(x.to(torch.float32), num, fir_carry)
        else:
            xb = x.to(torch.float32) * num[0]
        drives.append(xb)
        carries.append(fir_carry)
    drive, folded, w0 = bank_rows(drives, bank, [w0 for w0, _ in states])
    ys, wT = pole_bank(drive, folded, w0)
    outs = bank_unrows(ys, wT, bank.poles, _lead(drives[0]))
    return [(y, (w, c)) for (y, w), c in zip(outs, carries)]


def iir_apply(x: Tensor, spec: IIRSpec, state) -> Tuple[Tensor, tuple]:
    """Apply a biquad cascade to a real block.  state = (pole states [P]
    complex64, numerator input history [nz] f32).  Returns (y [T] f32, new
    state); algebraically scipy's sosfilt of the same design.  Copies the
    design to x's device on every call; a block loop builds an iir_bank
    once and calls iir_apply_many."""
    return tuple(iir_apply_many([x], iir_bank([spec], x.device), [state])[0])


# ---------------------------------------------------------------------------
# Run-length / lock-counter logic
# ---------------------------------------------------------------------------


def runlength_true(flags: Tensor, r0: Tensor) -> Tuple[Tensor, Tensor]:
    """Consecutive-true run length ending at each sample, with carry-in r0
    (the reference's SampleLockStableCnt pattern).  flags [..., T], r0
    [...], each row its own run: kernels.loops.runlength, one launch on
    the card (JAX: an associative scan of max)."""
    return runlength(flags, r0)


# ---------------------------------------------------------------------------
# Phase helpers
# ---------------------------------------------------------------------------

_NCO_BASE = 512  # digit base for int32-safe modular products (base*rate < 2^31)


def _digits3(v: Tensor, base: int):
    return v % base, (v // base) % base, v // (base * base)


def oscillator_phases(freq_hz: Tensor, rate: int, n0_mod: Tensor,
                      count: int) -> Tensor:
    """Exact integer NCO phase ramp 2*pi*((f*(n0+i)) mod rate)/rate in f32.

    freq_hz, n0_mod: int32 tensors [...] (freq may be negative; torch's %
    and // floor like jnp's); the ramp is [..., count].  All products stay
    below 2^31 through the base-512 digit split, so the ramp is exact for
    unbounded streams."""
    q = int(rate)
    assert q * _NCO_BASE < 2 ** 31
    dev = freq_hz.device
    f = freq_hz.to(torch.int32)[..., None] % q
    c0 = f
    c1 = (c0 * _NCO_BASE) % q
    c2 = (c1 * _NCO_BASE) % q
    a0, a1, a2 = _digits3(n0_mod.to(torch.int32)[..., None] % q, _NCO_BASE)
    start = ((a0 * c0) % q + (a1 * c1) % q) % q
    start = (start + (a2 * c2) % q) % q
    i = torch.arange(count, dtype=torch.int32, device=dev)
    d0, d1, d2 = _digits3(i, _NCO_BASE)
    t = ((d0 * c0) % q + (d1 * c1) % q) % q
    t = (t + (d2 * c2) % q) % q
    t = (t + start) % q
    return t.to(torch.float32) * (2.0 * math.pi / q)


def mix_lo(x: Tensor, freq_hz: Tensor, rate: int, n0_mod: Tensor) -> Tensor:
    """Multiply a block by e^{-j 2 pi f n / rate} from global index n0 (a
    station at +f Hz offset lands at baseband); x [..., T], freq_hz and
    n0_mod [...]."""
    ph = oscillator_phases(freq_hz, rate, n0_mod, x.shape[-1])
    return x * torch.complex(torch.cos(ph), -torch.sin(ph))



def wrap_pi(x: Tensor) -> Tensor:
    """Wrap angles to (-pi, pi] (the PI_Constrain equivalent)."""
    return x - 2.0 * math.pi * torch.round(x / (2.0 * math.pi))


def rate_map_linear(x: Tensor, num: int, den: int, n_out: int,
                    carry: Tensor) -> Tuple[Tensor, Tensor]:
    """Linear-interpolation rate conversion: n_out outputs spanning
    n_out*num/den inputs (the device zoo's mapTable converter).  out[j]
    lerps between input samples at the exact rational position j*num/den
    (integer positions, no phase drift); `carry` is the previous block's
    last input sample, so consecutive blocks stitch exactly.  At num/den =
    1/1 this is the stream delayed by one sample.  x [..., T_in], carry
    [...].  Returns (out [..., n_out], new carry = x[..., -1])."""
    T_in = x.shape[-1]
    if n_out * num != T_in * den:
        raise ValueError(f"rate_map_linear: {n_out} * {num} != {T_in} * "
                         f"{den}")
    if n_out * num >= 2 ** 31:
        raise ValueError("rate_map_linear: positions overflow int32")
    j = torch.arange(n_out, dtype=torch.int64, device=x.device)
    pos_num = j * num
    base = pos_num // den
    frac = (pos_num - base * den).to(torch.float32) / den
    xx = torch.cat([carry[..., None].to(x.dtype), x], dim=-1)
    a = xx[..., base]
    b = xx[..., base + 1]
    return a + (b - a) * frac, x[..., -1]
