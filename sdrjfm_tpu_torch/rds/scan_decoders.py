"""Per-sample RDS bit decoders 1, 2 and 3 (port of
sdrjfm_tpu.rds.scan_decoders), each a hand-written CUDA kernel with a plain
version beside it.

  decoder 1 (cuteSDR): shared Costas -> 21-tap lowpass -> bi-phase matched
      filter -> squared signal through a Butterworth bandpass at the 1187.5
      Hz bit clock -> sample at the clock's peak -> differential decode.
  decoder 2 (M&M): complex RRC matched filter -> AGC -> Mueller & Muller
      timing on rail decisions -> own Costas -> BPSK slice -> differential.
  decoder 3 (clock correlation): shared Costas -> 21-tap lowpass -> bit
      clock phase search by half-cycle correlation (at a resync only) ->
      integrate-and-dump on the clock's rising edge -> differential.

The JAX package runs each as a `lax.scan` over the 24 kS/s samples (16,384
steps a block at block_fm=131072); PyTorch has no scan, so each decoder is
CUDA kernels (`csrc/rds_scan.cu`), and `decoder1_scan` / `decoder2_scan` /
`decoder3_scan` are their wrappers.  Each decoder runs in stages: the
feedback recursions on one thread each, the FIRs, which feed nothing back,
as a parallel pre-pass between them (STAGES names them in launch order);
decoder 3 runs decoder 1's Costas stage with its data-free clock phase
chain (and the clock, sinf of it) on a warp beside the Costas thread, then
a parallel clock stage that computes only the lowpass outputs it reads and
the integrate-and-dump one segment (bit) a thread.  The
wrapper places every history and state run in the packed state
(`state_offsets`) and owns the scratch between the stages.  On a CPU
tensor a wrapper runs the plain version: the linear stages (FIRs, the
bit-clock bandpass, the emit and differential logic, decoder 3's
segmented integrate-and-dump) in torch ops, and only the per-sample
feedback recursion (Costas, AGC and M&M timing, the clock phase) as a host
loop over float32 scalars, one rounding per operation as in the kernels
(built without FMA contraction).  The plain versions sum their FIRs in the
kernels' order (`fir_in_order`), so their FIR outputs equal the kernels'
bit for bit.

Unlike the JAX functions, which return per-sample bits and an emit mask for
the receiver to compact with `jnp.nonzero`, every decoder here writes its
bits compacted from inside the loop (no host sync): it returns (bits [cap]
int8, count int32 — the number of emits, which may exceed cap —, the
constellation points iq [cap] complex64, zero past count, the per-sample
24 kHz iq stream [T] or None, new state).  The new state is written out of
place.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..kernels import build
from ..ops import design
from ..ops.blockops import IIRSpec
from ..kernels.linrec import pole_bank_plain
from .bitrecovery import bit_capacity

Tensor = torch.Tensor
SOURCE = "rds_scan.cu"

SPS = C.RDS_RATE / C.RDS_BITCLK_HZ            # ~20.21 samples/bit
_F = np.float32
TWO_PI = _F(2.0 * math.pi)
COSTAS_LIMIT = _F(2 * math.pi * 10.0 / C.RDS_RATE)
OMEGA = _F(2.0 * math.pi * C.RDS_BITCLK_HZ / C.RDS_RATE)

# csrc/rds_scan.cu's compile-time sizes (checked against the library)
MAX_TAPS = 64
STAGE_CHUNK = 1024        # samples a sequential stage stages at a time
FIR_TILE = 256            # outputs a block of the FIR pre-pass
POLES = 8                 # decoder 1's bandpass poles (a template parameter)
CLOCK_CHUNK = 4096        # samples a pass of decoder 3's clock stage


# --------------------------------------------------------------------------
# configs and states (field for field the JAX package's)
# --------------------------------------------------------------------------


class CostasState(NamedTuple):
    freq: Tensor
    phase: Tensor


def costas_zero_state(device=None) -> CostasState:
    z = lambda: torch.zeros((), dtype=torch.float32, device=device)  # noqa: E731
    return CostasState(z(), z())


class Decoder1Config(NamedTuple):
    lp21: np.ndarray          # 21-tap RDS_WIDTH lowpass
    match: np.ndarray         # bi-phase matched kernel
    sharp: IIRSpec            # bit-clock bandpass


def make_decoder1_config(rate: int = C.RDS_RATE) -> Decoder1Config:
    lp = design.lowpass_sinc(21, C.RDS_WIDTH, rate).astype(np.float32)
    match = design.biphase_matched_kernel(rate).astype(np.float32)
    sharp = IIRSpec(design.bandpass_butter_sos(
        4, C.RDS_BITCLK_HZ - 6.0, C.RDS_BITCLK_HZ + 6.0, rate))
    return Decoder1Config(lp, match, sharp)


class Decoder1State(NamedTuple):
    costas: CostasState
    lp_buf: Tensor            # [20]
    match_buf: Tensor         # [len(match)-1]
    sharp_w: Tensor           # complex pole states
    sharp_fir: Tensor
    last_sync: Tensor
    last_sync_slope: Tensor
    last_data: Tensor
    prev_bit: Tensor


def decoder1_zero_state(cfg: Decoder1Config, device=None) -> Decoder1State:
    f = lambda n=(): torch.zeros(n, dtype=torch.float32, device=device)  # noqa: E731
    wz, fz = cfg.sharp.zero_state(device)
    return Decoder1State(costas_zero_state(device), f(len(cfg.lp21) - 1),
                         f(len(cfg.match) - 1), wz, fz, f(), f(), f(),
                         torch.zeros((), dtype=torch.bool, device=device))


class Decoder2Config(NamedTuple):
    rrc: np.ndarray


def make_decoder2_config(rate: int = C.RDS_RATE) -> Decoder2Config:
    taps = design.root_raised_cosine(1.0, rate, 2 * C.RDS_BITCLK_HZ, 1.0, 45)
    return Decoder2Config(taps.astype(np.float32))


class Decoder2State(NamedTuple):
    mf_buf: Tensor            # [44] complex
    agc_gain: Tensor
    costas: CostasState
    s0: Tensor                # 3-sample window (complex)
    s1: Tensor
    s2: Tensor
    count: Tensor
    skip: Tensor
    mu: Tensor
    prev_bit: Tensor
    last_iq: Tensor           # held post-Costas symbol


def decoder2_zero_state(cfg: Decoder2Config, device=None) -> Decoder2State:
    c = lambda n=(): torch.zeros(n, dtype=torch.complex64, device=device)  # noqa: E731
    # fills, not host copies: a retune's reset builds these between
    # replays without waiting for the card
    f = lambda v: torch.full((), v, dtype=torch.float32, device=device)  # noqa: E731
    i = lambda v: torch.full((), v, dtype=torch.int32, device=device)  # noqa: E731
    return Decoder2State(c(len(cfg.rrc) - 1), f(9.0), costas_zero_state(device),
                         c(), c(), c(), i(0), i(3), f(0.0),
                         torch.zeros((), dtype=torch.bool, device=device), c())


class Decoder3Config(NamedTuple):
    lp21: np.ndarray
    symbol_ceiling: int


def make_decoder3_config(rate: int = C.RDS_RATE) -> Decoder3Config:
    lp = design.lowpass_sinc(21, C.RDS_WIDTH, rate).astype(np.float32)
    return Decoder3Config(lp, int(np.ceil(rate / C.RDS_BITCLK_HZ)))


class Decoder3State(NamedTuple):
    costas: CostasState
    lp_buf: Tensor
    sync_buf: Tensor          # [symbol_ceiling] recent filtered samples
    p: Tensor
    bit_integrator: Tensor
    bit_clk_phase: Tensor
    prev_clk: Tensor
    prev_bit: Tensor
    need_resync: Tensor


def decoder3_zero_state(cfg: Decoder3Config, device=None) -> Decoder3State:
    f = lambda n=(): torch.zeros(n, dtype=torch.float32, device=device)  # noqa: E731
    b = lambda v: torch.full((), v, dtype=torch.bool, device=device)  # noqa: E731
    return Decoder3State(costas_zero_state(device), f(len(cfg.lp21) - 1),
                         f(cfg.symbol_ceiling),
                         torch.zeros((), dtype=torch.int32, device=device),
                         f(), f(), f(), b(False), b(True))


def _fold_index(n: int) -> np.ndarray:
    """k of synchronizeOnBitClk's half-cycle fold (rds-decoder-3.cpp:119-
    154): the index since the last sign change of sin(i*omega/2), in the
    JAX package's float32 arithmetic.  A constant of the config."""
    i = np.arange(n)
    phase = np.mod(i.astype(np.float32) * _F(float(OMEGA) / 2.0), TWO_PI)
    sign = np.sin(phase) > 0
    flip = np.concatenate([[True], sign[1:] != sign[:-1]])
    start = np.maximum.accumulate(np.where(flip, i, 0))
    return i - start


def sync_bit_clock(sync_buf: Tensor, first: Tensor, cfg: Decoder3Config
                   ) -> Tensor:
    """synchronizeOnBitClk in torch ops: fold the last symbol's samples
    into clock half-cycles, find the rising edge, return the clock phase
    (JAX `_sync_bit_clock`, scan_decoders.py:280-310)."""
    n = cfg.symbol_ceiling
    dev = sync_buf.device
    k = torch.as_tensor(_fold_index(n), device=dev)
    i = torch.arange(n, device=dev)
    vals = sync_buf[(first.to(torch.int64) + i) % n]
    corr = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
        0, k, vals)
    fl = int(np.floor(C.RDS_RATE / C.RDS_BITCLK_HZ))
    c = corr[:fl]
    idx = torch.arange(fl, device=dev)
    big = torch.full_like(idx, fl)
    pos1 = torch.min(torch.where(c <= 0, idx, big))
    pos2 = torch.min(torch.where((c >= 0) & (idx > pos1), idx, big))
    i_min = torch.where(pos1 >= fl, big[0], torch.clamp(pos2 + 1, max=fl))
    x = -OMEGA * (i_min.to(torch.float32) - 1.0)
    return _mod_2pi(x)


def _mod_2pi(x):
    """jnp.mod(x, 2*pi) in float32: fmod, plus 2*pi where the sign differs."""
    r = torch.fmod(x, float(TWO_PI))
    return torch.where((r != 0) & (r < 0), r + float(TWO_PI), r)


# --------------------------------------------------------------------------
# the FIR stages
# --------------------------------------------------------------------------


def fir_in_order(hist: Tensor, x: Tensor, taps: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """A FIR stage over its input stream, the carried history (the last K-1
    inputs, oldest first) followed by the block x: y[n] = sum_k taps[k] *
    in[n-k], accumulated from 0 for k = 0..K-1 with one rounding per
    multiply and per add — the order in which csrc/rds_scan.cu's fir_kernel
    (and the sequential ring it replaced) sums each output, so the two
    agree bit for bit.  Returns (y [T] float32, the new history: the last
    K-1 values of the stream, some of the old history when T < K-1)."""
    K, T = taps.shape[0], x.shape[0]
    if hist.shape[0] != K - 1:
        raise ValueError(f"fir_in_order: {hist.shape[0]} history values "
                         f"for {K} taps")
    w = torch.cat([hist.to(torch.float32), x.to(torch.float32)])
    acc = torch.zeros(T, dtype=torch.float32, device=x.device)
    for k in range(K):
        acc = acc + taps[k] * w[K - 1 - k:K - 1 - k + T]
    return acc, w[T:]


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _costas(zr: np.ndarray, zi: np.ndarray, freq, phase, alpha, beta,
            gate: Optional[np.ndarray] = None):
    """The shared Costas loop (rds-decoder.cpp:79-82) over float32 scalars,
    one rounding per operation.  Returns (re, im of r [T], freq, phase)."""
    T = len(zr)
    rr = np.empty(T, _F)
    ri = np.empty(T, _F)
    alpha, beta = _F(alpha), _F(beta)
    freq, phase = _F(freq), _F(phase)
    for n in range(T):
        c, s = np.cos(phase), np.sin(phase)
        a = zr[n] * c + zi[n] * s
        b = zi[n] * c - zr[n] * s
        rr[n], ri[n] = a, b
        err = a * b
        freq = freq + beta * err
        if abs(freq) > COSTAS_LIMIT:
            freq = _F(0.0)
        phase = phase + freq + alpha * err
        phase = phase - TWO_PI * np.round(phase / TWO_PI)
    return rr, ri, freq, phase


def _host(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _scalar(v, like: Tensor, dtype=torch.float32) -> Tensor:
    return torch.tensor(v, dtype=dtype, device=like.device)


def _emit_bits(emit: Tensor, the_bit: Tensor, prev_bit0: Tensor):
    """Differential decode with the held previous bit: bit[n] = the_bit[n]
    XOR the_bit at the last emit before n (prev_bit0 if none).  Returns
    (bit [T] bool, prev_bit after the block)."""
    T = emit.shape[0]
    idx = torch.arange(T, device=emit.device)
    last = torch.cummax(torch.where(emit, idx, -1), dim=0).values
    before = torch.cat([last.new_full((1,), -1), last[:-1]])
    held = torch.where(before >= 0, the_bit[before.clamp(min=0)], prev_bit0)
    after = torch.where(last[-1] >= 0, the_bit[last[-1].clamp(min=0)],
                        prev_bit0)
    return the_bit ^ held, after


def _compact(bits: Tensor, emit: Tensor, iq: Tensor, cap: int):
    """The kernels' output contract from per-sample arrays (host-side
    compaction: the plain version may synchronise)."""
    pos = torch.nonzero(emit).reshape(-1)
    count = pos.shape[0]
    out_bits = torch.zeros(cap, dtype=torch.int8, device=bits.device)
    out_iq = torch.zeros(cap, dtype=torch.complex64, device=bits.device)
    m = min(count, cap)
    out_bits[:m] = bits[pos[:m]].to(torch.int8)
    out_iq[:m] = iq[pos[:m]]
    return out_bits, _scalar(count, bits, torch.int32), out_iq


def decoder1_plain(z: Tensor, cfg: Decoder1Config, state: Decoder1State,
                   cap: int, want_iq: bool = False):
    """decoder1_block in torch ops around a host Costas loop."""
    dev = z.device
    rr, ri, freq, phase = _costas(_host(z.real), _host(z.imag),
                                  _host(state.costas.freq),
                                  _host(state.costas.phase),
                                  1.0 / 16.0, 0.02 / 16.0)
    r = torch.complex(torch.from_numpy(rr), torch.from_numpy(ri)).to(dev)
    v = r.real * 4.0
    v1, lp_buf = fir_in_order(state.lp_buf, v,
                              torch.as_tensor(cfg.lp21, device=dev))
    v2, match_buf = fir_in_order(state.match_buf, v1,
                                 torch.as_tensor(cfg.match, device=dev))
    xb, sharp_fir = fir_in_order(state.sharp_fir, v2 * v2,
                                 torch.as_tensor(cfg.sharp.num, device=dev))
    mag, wT = pole_bank_plain(
        xb[None], torch.as_tensor(cfg.sharp.poles, device=dev)[None],
        torch.as_tensor(cfg.sharp.residues, device=dev)[None],
        state.sharp_w[None])
    mag = mag[0]
    slope = mag - torch.cat([state.last_sync[None], mag[:-1]])
    slope_prev = torch.cat([state.last_sync_slope[None], slope[:-1]])
    emit = (slope < 0.0) & (slope_prev >= 0.0)
    the_bit = torch.cat([state.last_data[None], v2[:-1]]) >= 0.0
    bit, prev_bit = _emit_bits(emit, the_bit, state.prev_bit)
    iq = r * 4.0
    new = Decoder1State(CostasState(_scalar(freq, z), _scalar(phase, z)),
                        lp_buf, match_buf, wT[0], sharp_fir, mag[-1],
                        slope[-1], v2[-1], prev_bit)
    return (*_compact(bit, emit, iq, cap), iq if want_iq else None, new)


def decoder2_plain(z: Tensor, cfg: Decoder2Config, state: Decoder2State,
                   cap: int, want_iq: bool = False):
    """decoder2_block: the RRC matched filter in torch, then the AGC, M&M
    timing and Costas recursion as a host loop."""
    dev = z.device
    rrc = torch.as_tensor(cfg.rrc, device=dev)
    z = z.to(torch.complex64)
    # re and im summed apart, as the kernel's pre-pass sums them
    vr, hr = fir_in_order(state.mf_buf.real, z.real, rrc)
    vi, hi = fir_in_order(state.mf_buf.imag, z.imag, rrc)
    mf_buf = torch.complex(hr, hi)
    vr, vi = _host(vr), _host(vi)
    T = len(vr)
    gain = _F(_host(state.agc_gain))
    freq, phase = _F(_host(state.costas.freq)), _F(_host(state.costas.phase))
    s = [complex(_host(t)) for t in (state.s0, state.s1, state.s2)]
    s0r, s0i = _F(s[0].real), _F(s[0].imag)
    s1r, s1i = _F(s[1].real), _F(s[1].imag)
    s2r, s2i = _F(s[2].real), _F(s[2].imag)
    count, skip = int(_host(state.count)), int(_host(state.skip))
    mu = _F(_host(state.mu))
    prev_bit = bool(_host(state.prev_bit))
    liq = complex(_host(state.last_iq))
    lr, li = _F(liq.real), _F(liq.imag)
    sps, mm_alpha = _F(SPS), _F(0.01)
    g1, g2, g3 = _F(2e-3), _F(0.38), _F(0.02)
    one = _F(1.0)
    emit = np.zeros(T, bool)
    bits = np.zeros(T, bool)
    iq_r = np.empty(T, _F)
    iq_i = np.empty(T, _F)
    rail = lambda x: one if x > 0 else -one  # noqa: E731
    for n in range(T):
        outr, outi = vr[n] * gain, vi[n] * gain
        gain = gain + g1 * (g2 - np.hypot(outr, outi))
        s0r, s0i, s1r, s1i, s2r, s2i = s1r, s1i, s2r, s2i, outr, outi
        count += 1
        if count >= skip:
            x = ((rail(s2r) - rail(s0r)) * s1r
                 + (rail(s2i) - rail(s0i)) * s1i)
            y = (s2r - s0r) * rail(s1r) + (s2i - s0i) * rail(s1i)
            mu = mu + sps + mm_alpha * (y - x)
            skip = int(np.floor(mu))
            mu = mu - _F(skip)
            c, sn = np.cos(phase), np.sin(phase)
            a = s2r * c + s2i * sn
            b = s2i * c - s2r * sn
            err = a * b
            freq = freq + g3 * err
            if abs(freq) > COSTAS_LIMIT:
                freq = _F(0.0)
            phase = phase + freq + one * err
            phase = phase - TWO_PI * np.round(phase / TWO_PI)
            the_bit = bool(a >= 0)
            bits[n] = the_bit ^ prev_bit
            prev_bit = the_bit
            lr, li = a, b
            emit[n] = True
            count = 0
        iq_r[n], iq_i[n] = lr, li
    iq = torch.complex(torch.from_numpy(iq_r), torch.from_numpy(iq_i)).to(dev)
    cz = lambda re, im: torch.tensor(complex(re, im), dtype=torch.complex64,  # noqa: E731
                                     device=dev)
    new = Decoder2State(mf_buf, _scalar(gain, z),
                        CostasState(_scalar(freq, z), _scalar(phase, z)),
                        cz(s0r, s0i), cz(s1r, s1i), cz(s2r, s2i),
                        _scalar(count, z, torch.int32),
                        _scalar(skip, z, torch.int32), _scalar(mu, z),
                        _scalar(prev_bit, z, torch.bool), cz(lr, li))
    emit_t = torch.from_numpy(emit).to(dev)
    bits_t = torch.from_numpy(bits).to(dev)
    return (*_compact(bits_t, emit_t, iq, cap), iq if want_iq else None, new)


def lowpass_outputs(hist: Tensor, v: Tensor, taps: Tensor, n: int
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Decoder 3's lowpass where the function reads it: filt[0] (the clock
    search at a resync sees it through sync_buf), the last min(T, n)
    outputs (the new sync_buf) and the new history (the last K-1 inputs),
    each output summed as fir_in_order sums it.  Returns (filt[0],
    filt[T-min(T, n):], new history)."""
    K, T = taps.shape[0], v.shape[0]
    w = torch.cat([hist.to(torch.float32), v.to(torch.float32)])
    f0, _ = fir_in_order(hist, v[:1], taps)
    m = min(T, n)
    last, _ = fir_in_order(w[T - m:T - m + K - 1], v[T - m:], taps)
    return f0[0], last, w[T:]


def wrap_step(x):
    """One step of the clock phase's wrap, x = ph + OMEGA: x - 2 pi where x
    >= 2 pi.  Exact (Sterbenz's lemma) and equal to np.fmod(x, TWO_PI) bit
    for bit for 0 <= x < 4 pi, which holds after the first step."""
    return x - TWO_PI if x >= TWO_PI else x


def clock_phases(ph0, T: int) -> np.ndarray:
    """The bit clock's phase before each of T samples and after the last
    ([T + 1] float32): ph[n+1] = mod(ph[n] + OMEGA, 2 pi) (jnp.mod), as
    the clock stage runs the chain: the first step in general, each later
    one, from a phase in [0, 2 pi], by wrap_step."""
    out = np.empty(T + 1, _F)
    p = _F(ph0)
    out[0] = p
    x = p + OMEGA
    p = (wrap_step(x) if _F(0) <= x < _F(2) * TWO_PI
         else _F(_mod_2pi(torch.tensor(x))))
    for n in range(1, T + 1):
        out[n] = p
        if n < T:
            p = wrap_step(p + OMEGA)
    return out


def integrate_and_dump(clk: Tensor, v: Tensor, integ0: Tensor,
                       prev_clk: Tensor, prev_bit: Tensor):
    """Decoder 3's integrate-and-dump, segmented: the emits are the clock's
    rising edges (clk[n-1] <= 0 < clk[n], clk[-1] = prev_clk), known before
    any sum; each segment ends at an emit and sums integ = integ + clk * v
    in sample order (from integ0 in the first, from 0 after an emit), one
    rounding per operation, vectorised across segments.  The bit at an emit
    is (integ >= 0) XOR that of the emit before (prev_bit for the first).
    Returns (emit [T], bit [T] bool, the tail's integrator, prev_bit)."""
    T = clk.shape[0]
    dev = clk.device
    before = torch.cat([prev_clk.reshape(1).to(torch.float32), clk[:-1]])
    emit = (before <= 0.0) & (clk > 0.0)
    pos = torch.nonzero(emit).reshape(-1)
    starts = torch.cat([pos.new_zeros(1), pos + 1])
    lens = torch.cat([pos, pos.new_full((1,), T - 1)]) - starts + 1
    acc = torch.zeros(starts.shape[0], dtype=torch.float32, device=dev)
    acc[0] = integ0
    for o in range(int(lens.max())):
        idx = (starts + o).clamp(max=T - 1)
        acc = torch.where(lens > o, acc + clk[idx] * v[idx], acc)
    the_bit = acc[:-1] >= 0.0
    held = torch.cat([prev_bit.reshape(1).to(torch.bool), the_bit[:-1]])
    bit = torch.zeros(T, dtype=torch.bool, device=dev)
    bit[pos] = the_bit ^ held
    after = the_bit[-1] if pos.numel() else prev_bit.to(torch.bool)
    return emit, bit, acc[-1], after


def decoder3_plain(z: Tensor, cfg: Decoder3Config, state: Decoder3State,
                   cap: int, want_iq: bool = False):
    """decoder3_block: Costas as a host loop, the lowpass outputs it reads
    in torch, the clock search at a resync in torch, the clock phase chain
    as a host loop, the integrate-and-dump segmented in torch."""
    dev = z.device
    n = cfg.symbol_ceiling
    rr, ri, freq, phase = _costas(_host(z.real), _host(z.imag),
                                  _host(state.costas.freq),
                                  _host(state.costas.phase),
                                  1.0 / 16.0, 0.02 / 16.0)
    r = torch.complex(torch.from_numpy(rr), torch.from_numpy(ri)).to(dev)
    v = r.real * 4.0
    T = v.shape[0]
    f0, last, lp_buf = lowpass_outputs(state.lp_buf, v,
                                       torch.as_tensor(cfg.lp21, device=dev),
                                       n)
    # the ring of the last n filtered samples, as the scan leaves it
    buf0 = state.sync_buf.clone()
    p0 = state.p.to(torch.int64)
    buf0[p0] = f0
    ph0 = _host(state.bit_clk_phase)
    if bool(_host(state.need_resync)):
        ph0 = _host(sync_bit_clock(buf0, (p0 + 1) % n, cfg))
    m = min(T, n)
    sync_buf = state.sync_buf.clone()
    sync_buf[(p0 + torch.arange(T - m, T, device=dev)) % n] = last
    ph = clock_phases(ph0, T)
    clk = torch.from_numpy(np.sin(ph[:T])).to(dev)
    emit, bits, integ, prev_bit = integrate_and_dump(
        clk, v, state.bit_integrator, state.prev_clk, state.prev_bit)
    iq = r * 4.0
    new = Decoder3State(CostasState(_scalar(freq, z), _scalar(phase, z)),
                        lp_buf, sync_buf,
                        ((p0 + T) % n).to(torch.int32),
                        integ, _scalar(ph[T], z), clk[-1], prev_bit,
                        _scalar(False, z, torch.bool))
    return (*_compact(bits, emit, iq, cap), iq if want_iq else None, new)


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------


def _flat(t: Tensor) -> Tensor:
    """A state leaf as float32 values (complex as re, im pairs)."""
    if t.is_complex():
        return torch.view_as_real(t.reshape(-1).to(torch.complex64)).reshape(-1)
    return t.reshape(-1).to(torch.float32)


def _leaves(state):
    for v in state:
        if isinstance(v, tuple):
            yield from _leaves(v)
        else:
            yield v


def pack_state(state) -> Tensor:
    """The state as one float32 vector, leaves in field order (the layout
    csrc/rds_scan.cu reads and writes)."""
    return torch.cat([_flat(v) for v in _leaves(state)])


def unpack_state(vec: Tensor, like):
    """The inverse of pack_state, shaped and typed like `like`."""
    off = 0

    def build(tpl):
        nonlocal off
        vals = []
        for v in tpl:
            if isinstance(v, tuple):
                vals.append(build(v))
                continue
            n = v.numel() * (2 if v.is_complex() else 1)
            seg = vec[off:off + n]
            off += n
            if v.is_complex():
                seg = torch.view_as_complex(seg.reshape(-1, 2).clone())
            vals.append(seg.reshape(v.shape).to(v.dtype))
        return type(tpl)(*vals)
    out = build(like)
    if off != vec.numel():
        raise ValueError(f"unpack_state: {vec.numel()} values for {off}")
    return out


def state_offsets(state) -> Dict[str, Tuple[int, int]]:
    """Where each leaf of `state` sits in pack_state's vector: its field name
    ('costas.freq' for a nested one) -> (offset, number of floats)."""
    out: Dict[str, Tuple[int, int]] = {}
    off = 0

    def walk(tpl, prefix):
        nonlocal off
        for name, v in zip(tpl._fields, tpl):
            if isinstance(v, tuple):
                walk(v, f"{prefix}{name}.")
                continue
            n = v.numel() * (2 if v.is_complex() else 1)
            out[prefix + name] = (off, n)
            off += n
    walk(state, "")
    return out


# the runs of state fields that a stage's kernel reads and writes as one
# array, in the order it takes them (csrc/rds_scan.cu)
COSTAS_RUN = ("costas.freq", "costas.phase")
EMIT1_RUN = ("last_sync", "last_sync_slope", "last_data", "prev_bit")
CLOCK3_RUN = ("lp_buf", "sync_buf", "p", "bit_integrator", "bit_clk_phase",
              "prev_clk", "prev_bit", "need_resync")
CORE2_RUN = ("agc_gain", "costas.freq", "costas.phase", "s0", "s1", "s2",
             "count", "skip", "mu", "prev_bit", "last_iq")


def run_offset(offsets: Dict[str, Tuple[int, int]], run: Tuple[str, ...]
               ) -> Tuple[int, int]:
    """(offset, floats) of a run of fields that must lie back to back in
    the packed state in the run's order; raises if they do not."""
    first = at = offsets[run[0]][0]
    for name in run:
        off, n = offsets[name]
        if off != at:
            raise ValueError(f"rds_scan: state field {name} sits at {off}, "
                             f"the kernel reads it at {at}")
        at += n
    return first, at - first


def _const_parts(which: int, cfg) -> List[Tuple[str, np.ndarray]]:
    """The constant block the kernels read, part by part: the loops'
    float32 scalars (alpha, beta, limit, 2 pi, omega, sps, M&M gain, AGC
    rate, AGC reference), then the decoder's sizes, taps and poles."""
    alpha, beta = (1.0, 0.02) if which == 2 else (1.0 / 16.0, 0.02 / 16.0)
    head = [alpha, beta, COSTAS_LIMIT, TWO_PI, OMEGA, SPS, 0.01, 2e-3, 0.38]
    if which == 1:
        sh = cfg.sharp
        body = [("sizes", [len(cfg.lp21), len(cfg.match), len(sh.num),
                           len(sh.poles)]),
                ("lp21", cfg.lp21), ("match", cfg.match), ("num", sh.num),
                ("poles", sh.poles.view(np.float32)),
                ("residues", sh.residues.view(np.float32))]
    elif which == 2:
        body = [("sizes", [len(cfg.rrc)]), ("rrc", cfg.rrc)]
    else:
        fl = int(np.floor(C.RDS_RATE / C.RDS_BITCLK_HZ))
        body = [("sizes", [len(cfg.lp21), cfg.symbol_ceiling, fl]),
                ("lp21", cfg.lp21),
                ("fold", _fold_index(cfg.symbol_ceiling))]
    return [(name, np.asarray(a, np.float32).reshape(-1))
            for name, a in [("head", head)] + body]


def _const_block(which: int, cfg) -> np.ndarray:
    return np.concatenate([a for _, a in _const_parts(which, cfg)])


def const_offsets(which: int, cfg) -> Dict[str, int]:
    """Where each part of decoder `which`'s constant block starts (floats)."""
    out, off = {}, 0
    for name, a in _const_parts(which, cfg):
        out[name] = off
        off += a.size
    return out


def _sizes_ok(which: int, cfg) -> bool:
    if which == 1:
        taps = (len(cfg.lp21), len(cfg.match), len(cfg.sharp.num))
        return (2 <= min(taps) and max(taps) <= MAX_TAPS
                and len(cfg.sharp.poles) == POLES)
    if which == 2:
        return 2 <= len(cfg.rrc) <= MAX_TAPS
    return (2 <= len(cfg.lp21) <= MAX_TAPS
            and 1 <= cfg.symbol_ceiling <= MAX_TAPS)


def kernel_constants(kind: str, cfg, device) -> Tensor:
    """Decoder `kind`'s constant block on `device`, as its kernels read it.
    Build it once per config: a fresh host-to-device copy per block would
    synchronise."""
    which = int(kind[-1])
    if not _sizes_ok(which, cfg):
        raise ValueError("rds_scan: a filter does not fit the kernels' sizes")
    return torch.as_tensor(_const_block(which, cfg), device=device)


def stage_chunks(T: int) -> List[Tuple[int, int]]:
    """The chunks in which a sequential stage stages its input in shared
    memory, in order: (first sample, length), covering [0, T).  The kernel
    takes their count and cuts them the same way."""
    if T < 1:
        raise ValueError(f"stage_chunks: T={T}")
    return [(b, min(STAGE_CHUNK, T - b)) for b in range(0, T, STAGE_CHUNK)]


def fir_tiles(T: int) -> int:
    """Blocks of a FIR stage over T outputs, FIR_TILE outputs each."""
    return -(-T // FIR_TILE)


_PLAIN = {1: decoder1_plain, 2: decoder2_plain, 3: decoder3_plain}

# each decoder's kernels, in launch order
STAGES = {1: ("costas", "fir_lp21", "fir_match", "fir_sharp_num",
              "poles_emit"),
          2: ("fir_rrc", "mm_core"),
          3: ("costas", "clock")}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {
    "sdr_rds_costas": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "sdr_rds_fir": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P, _I, _I, _P],
    "sdr_rds_poles_emit": [_P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                           _P, _I, _P],
    "sdr_rds_mm_core": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P],
    "sdr_rds_clock": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P],
}


class StagePlan(NamedTuple):
    """One decoder call on the card, allocated but not launched: `stages`,
    (name, launch) in launch order, each launch() running one kernel; the
    call's outputs; the packed new state; and `work`, every buffer the
    launches read or write (the inputs and the scratch between stages),
    held here so that they live as long as the plan."""
    stages: Tuple[Tuple[str, Callable[[], None]], ...]
    bits: Tensor
    count: Tensor
    biq: Tensor
    iq: Optional[Tensor]
    st_out: Tensor
    work: Dict[str, Tensor]


class RdsScanKernel:
    """Wrapper of one decoder's kernels with launch counters: `launches`
    counts decoder calls on the card, `stage_launches` each stage's kernel
    launches, both eager or recorded into a CUDA graph being captured (a
    graph's replays do not pass through here and are not counted; CPU calls
    of the plain version count in neither).

    Safe to replay from a CUDA graph as it stands: `plan` allocates every
    buffer per call and no launch argument is a host counter.

    __call__(z [T] complex64, cfg, state, cap, want_iq, consts) -> (bits
    [cap] int8, count int32, iq [cap] complex64, iq stream [T] or None, new
    state).  consts: kernel_constants(kind, cfg, z.device); without it the
    call copies them to the device itself."""

    def __init__(self, which: int):
        self.which = which
        self.launches = 0
        self.stage_launches = dict.fromkeys(STAGES[which], 0)
        self._lib = None

    def _library(self):
        if self._lib is None:
            lib = build.load(SOURCE)
            for name, args in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            sizes = (lib.sdr_rds_max_taps(), lib.sdr_rds_stage_chunk(),
                     lib.sdr_rds_fir_tile(), lib.sdr_rds_clock_chunk())
            if sizes != (MAX_TAPS, STAGE_CHUNK, FIR_TILE, CLOCK_CHUNK):
                raise RuntimeError(f"rds_scan: csrc sizes {sizes} != the "
                                   f"wrapper's")
            self._lib = lib
        return self._lib

    def _stage(self, dev, name: str, fn, args):
        def launch():
            with torch.cuda.device(dev):
                rc = fn(*args)
            if rc != 0:
                raise RuntimeError(f"rds_scan decoder {self.which} stage "
                                   f"{name}: launch failed, CUDA error {rc}")
            self.stage_launches[name] += 1
        return name, launch

    def plan(self, z: Tensor, cfg, state, cap: int, want_iq: bool = False,
             consts: Optional[Tensor] = None) -> StagePlan:
        """Check the arguments and allocate one call on z's CUDA device;
        launches nothing."""
        dev = z.device
        if dev.type != "cuda":
            raise ValueError(f"rds_scan: unsupported device {dev}")
        if z.dtype != torch.complex64 or z.dim() != 1 or not z.is_contiguous():
            raise TypeError("rds_scan: z must be a contiguous [T] complex64 "
                            "tensor")
        T = z.shape[0]
        if not (1 <= T < 2 ** 31 and 1 <= cap < 2 ** 31):
            raise ValueError(f"rds_scan: T={T}, cap={cap} out of range")
        if consts is None:
            consts = kernel_constants(f"scan{self.which}", cfg, dev)
        if consts.device != dev:
            raise ValueError("rds_scan: constants are not on z's device")
        st_in = pack_state(state)
        if st_in.device != dev:
            raise ValueError("rds_scan: state is not on z's device")
        lib = self._library()
        st_out = torch.empty_like(st_in)
        bits = torch.empty(cap, dtype=torch.int8, device=dev)
        biq = torch.empty(cap, dtype=torch.complex64, device=dev)
        count = torch.empty((), dtype=torch.int32, device=dev)
        iq = (torch.empty(T, dtype=torch.complex64, device=dev) if want_iq
              else None)
        work = {"z": z, "consts": consts, "st_in": st_in}
        stream = torch.cuda.current_stream(dev).cuda_stream
        so = state_offsets(state)
        co = const_offsets(self.which, cfg)
        si, sO, c0 = st_in.data_ptr(), st_out.data_ptr(), consts.data_ptr()
        nch, tiles = len(stage_chunks(T)), fir_tiles(T)
        outs = (bits.data_ptr(), biq.data_ptr(), count.data_ptr(), cap)
        iqp = None if iq is None else iq.data_ptr()

        def field(name, floats):
            off, n = so[name]
            if n != floats:
                raise ValueError(f"rds_scan: state field {name} holds {n} "
                                 f"floats, the kernel takes {floats}")
            return si + 4 * off, sO + 4 * off

        def run(names, floats):
            off, n = run_offset(so, names)
            if n != floats:
                raise ValueError(f"rds_scan: {names} hold {n} floats, the "
                                 f"kernel takes {floats}")
            return si + 4 * off, sO + 4 * off

        def taps(part):
            return c0 + 4 * co[part]

        if self.which == 1:
            fir = lib.sdr_rds_fir
            Ll, Lm, Ln = len(cfg.lp21), len(cfg.match), len(cfg.sharp.num)
            iq4 = iq if iq is not None else torch.empty_like(z)
            v1 = torch.empty(T, dtype=torch.float32, device=dev)
            xv = torch.empty(T, 2, dtype=torch.float32, device=dev)  # xb, v2
            x_b, v_2 = xv.data_ptr(), xv.data_ptr() + 4
            work.update(iq4=iq4, v1=v1, xv=xv)
            stages = (
                self._stage(dev, "costas", lib.sdr_rds_costas,
                            (z.data_ptr(), T, nch, c0, *run(COSTAS_RUN, 2),
                             iq4.data_ptr(), None, None, stream)),
                self._stage(dev, "fir_lp21", fir,
                            (*field("lp_buf", Ll - 1), iq4.data_ptr(), 2, T,
                             taps("lp21"), Ll, 1, 0, v1.data_ptr(), 1, tiles,
                             stream)),
                self._stage(dev, "fir_match", fir,
                            (*field("match_buf", Lm - 1), v1.data_ptr(), 1,
                             T, taps("match"), Lm, 1, 0, v_2, 2, tiles,
                             stream)),
                self._stage(dev, "fir_sharp_num", fir,
                            (*field("sharp_fir", Ln - 1), v_2, 2, T,
                             taps("num"), Ln, 1, 1, x_b, 2, tiles, stream)),
                self._stage(dev, "poles_emit", lib.sdr_rds_poles_emit,
                            (x_b, iq4.data_ptr(), T, nch, taps("poles"),
                             POLES, *field("sharp_w", 2 * POLES),
                             *run(EMIT1_RUN, 4), *outs, stream)))
        elif self.which == 2:
            K = len(cfg.rrc)
            v = torch.empty_like(z)
            work.update(v=v)
            stages = (
                self._stage(dev, "fir_rrc", lib.sdr_rds_fir,
                            (*field("mf_buf", 2 * (K - 1)), z.data_ptr(), 2,
                             T, taps("rrc"), K, 2, 0, v.data_ptr(), 2, tiles,
                             stream)),
                self._stage(dev, "mm_core", lib.sdr_rds_mm_core,
                            (v.data_ptr(), T, nch, c0, *run(CORE2_RUN, 15),
                             *outs, iqp, stream)))
        else:
            K, N = len(cfg.lp21), cfg.symbol_ceiling
            iq4 = iq if iq is not None else torch.empty_like(z)
            # the clock phases [T + 1], then the clock [T]
            ph = torch.empty(2 * T + 1, dtype=torch.float32, device=dev)
            work.update(iq4=iq4, ph=ph)
            clk_in, clk_out = run(CLOCK3_RUN, K - 1 + N + 6)
            stages = (
                self._stage(dev, "costas", lib.sdr_rds_costas,
                            (z.data_ptr(), T, nch, c0, *run(COSTAS_RUN, 2),
                             iq4.data_ptr(), clk_in, ph.data_ptr(), stream)),
                self._stage(dev, "clock", lib.sdr_rds_clock,
                            (iq4.data_ptr(), ph.data_ptr(), T, c0, clk_in,
                             clk_out, *outs, stream)))
        return StagePlan(stages, bits, count, biq, iq, st_out, work)

    def __call__(self, z: Tensor, cfg, state, cap: int,
                 want_iq: bool = False, consts: Optional[Tensor] = None):
        if z.device.type == "cpu":
            return _PLAIN[self.which](z, cfg, state, cap, want_iq)
        p = self.plan(z, cfg, state, cap, want_iq, consts)
        for _, launch in p.stages:
            launch()
        self.launches += 1
        return p.bits, p.count, p.biq, p.iq, unpack_state(p.st_out, state)


decoder1_scan = RdsScanKernel(1)
decoder2_scan = RdsScanKernel(2)
decoder3_scan = RdsScanKernel(3)

DECODERS = {"scan1": (make_decoder1_config, decoder1_zero_state, decoder1_scan),
            "scan2": (make_decoder2_config, decoder2_zero_state, decoder2_scan),
            "scan3": (make_decoder3_config, decoder3_zero_state, decoder3_scan)}


def decoder_block(kind: str, z: Tensor, cfg, state, want_iq: bool = False,
                  consts: Optional[Tensor] = None):
    """One block through decoder `kind` ("scan1" | "scan2" | "scan3") with
    the receiver's bit capacity; consts as the wrappers take them.  Returns
    (bits, count, iq [cap], iq stream or None, new state)."""
    return DECODERS[kind][2](z.to(torch.complex64).contiguous(), cfg, state,
                             bit_capacity(z.shape[0]), want_iq, consts)
