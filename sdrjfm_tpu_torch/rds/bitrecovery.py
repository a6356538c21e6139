"""RDS BPSK bit recovery — block demodulator (port of
sdrjfm_tpu.rds.bitrecovery).

  matched filter : decoder-2's complex RRC, 45 taps, as a batched conv
  carrier phase  : per-sub-block squared-BPSK estimate psi = angle(mean(y^2))/2
                   with a continuity unwrap against the carried estimate,
                   fused with the derotation (kernels.loops.psi_recover: one
                   launch on the card that reads y once, torch reductions and
                   a loop over the sub-blocks on the CPU)
  bit timing     : the bit clock is exactly 384/19 samples at 24 kHz; a
                   per-block energy maximisation over 64 fractional offsets,
                   the bit grid sampled by linear-interpolation gather
  differential   : b[k] = s[k] XOR s[k-1]

Gathers use int64 indices; torch.round and jnp.round both round half to
even.  Nothing here synchronises with the host.  A block may carry leading
station rows ([..., T], states [...]): every gather then runs per row and
the bits come out [..., capacity] with a count [...], as JAX's vmap gives.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import constants as C
from ..kernels.loops import psi_recover
from ..ops import design
from ..ops.blockops import fir_apply

Tensor = torch.Tensor

SPS_NUM = 384                 # samples per bit = 384/19 at 24 kHz
SPS_DEN = 19
SPS = SPS_NUM / SPS_DEN
PHASE_SUB = 2048              # default carrier-phase sub-block (~101 bits)
PHASE_SUB_MIN = 512           # low-latency floor (~25 bits)
TIMING_GRID = 64              # fractional-offset candidates over one bit


class BitRecoveryConfig(NamedTuple):
    mf_taps: Tensor           # [45] float32 RRC matched filter
    rate: int
    phase_sub: int = PHASE_SUB


def make_bitrecovery_config(rate: int = C.RDS_RATE,
                            phase_sub: int = PHASE_SUB,
                            device=None) -> BitRecoveryConfig:
    assert phase_sub >= PHASE_SUB_MIN and phase_sub % 2 == 0, phase_sub
    taps = design.root_raised_cosine(1.0, rate, 2 * C.RDS_BITCLK_HZ, 1.0, 45)
    return BitRecoveryConfig(
        mf_taps=torch.as_tensor(taps.astype(np.float32), device=device),
        rate=rate, phase_sub=phase_sub)


class BitRecoveryState(NamedTuple):
    mf_carry: Tensor          # [44] complex matched-filter history
    psi: Tensor               # carrier phase estimate (continuity anchor)
    tau: Tensor               # fractional position of the next bit centre
    prev_sym: Tensor          # last hard symbol (for differential decode)
    timing_locked: Tensor     # False until the first block-level acquisition
    last_iq: Tensor           # last emitted constellation point


def bitrecovery_zero_state(cfg: BitRecoveryConfig,
                           device=None) -> BitRecoveryState:
    f32 = lambda: torch.zeros((), dtype=torch.float32, device=device)  # noqa: E731
    b = lambda: torch.zeros((), dtype=torch.bool, device=device)  # noqa: E731
    return BitRecoveryState(
        mf_carry=torch.zeros(cfg.mf_taps.shape[0] - 1,
                             dtype=torch.complex64, device=device),
        psi=f32(), tau=f32(), prev_sym=b(), timing_locked=b(),
        last_iq=torch.zeros((), dtype=torch.complex64, device=device),
    )


class BitBlock(NamedTuple):
    bits: Tensor              # [capacity] int8 differential-decoded bits
    valid: Tensor             # [capacity] bool
    count: Tensor             # number of valid bits
    iq: Tensor                # [capacity] complex constellation samples


def bit_capacity(block_len: int) -> int:
    return int(np.ceil(block_len / SPS)) + 2


def _take(y: Tensor, idx: Tensor) -> Tensor:
    """Row by row y[..., idx]: y [..., T], idx [..., *shape] (the rows'
    leading dims first) -> [..., *shape] (int64 gather)."""
    lead = y.shape[:-1]
    flat = idx.reshape(lead + (-1,)).to(torch.int64)
    return torch.gather(y, -1, flat).reshape(idx.shape)


def _interp_linear(y: Tensor, pos: Tensor) -> Tensor:
    i0 = torch.floor(pos).to(torch.int64)
    frac = pos - i0.to(torch.float32)
    a = _take(y, i0)
    b = _take(y, i0 + 1)
    return a + (b - a) * frac


def recover_bits(z: Tensor, cfg: BitRecoveryConfig,
                 state: BitRecoveryState
                 ) -> Tuple[BitBlock, Tensor, BitRecoveryState]:
    """Demodulate one block of RDS baseband (24 kS/s complex) into bits.
    Returns (BitBlock, demod24, new_state); demod24 holds, at each sample,
    the most recently emitted constellation point (the RDS_DEMOD view)."""
    T = z.shape[-1]
    lead = z.shape[:-1]
    dev = z.device
    phase_sub = cfg.phase_sub
    assert T % phase_sub == 0, (T, phase_sub)
    y, mf_carry = fir_apply(z, cfg.mf_taps, state.mf_carry)

    # --- carrier phase: squared-BPSK estimate per sub-block, unwrapped ----
    yr, psi_last = psi_recover(y, state.psi, phase_sub)

    # --- bit timing: energy over candidate fractional offsets ---------------
    nbits_probe = int(T // SPS) - 1
    k = torch.arange(nbits_probe, dtype=torch.float32, device=dev)
    offs = (torch.arange(TIMING_GRID, dtype=torch.float32, device=dev)
            / TIMING_GRID) * SPS
    pos = offs[:, None] + k[None, :] * SPS                # [G, nbits]
    e = torch.abs(_interp_linear(yr, pos.expand(lead + pos.shape))) ** 2
    energy = e.sum(dim=-1)
    tau_best = torch.take(offs, torch.argmax(energy, dim=-1))
    dt = tau_best - torch.remainder(state.tau, SPS)
    dt = dt - SPS * torch.round(dt / SPS)                 # wrap to ±SPS/2
    max_step = (SPS / TIMING_GRID) * min(1.0, nbits_probe / 190.0)
    tracked = state.tau + torch.clamp(dt, -max_step, max_step)
    tau0 = torch.where(state.timing_locked, tracked, tau_best)

    # --- sample the bit grid -------------------------------------------------
    capacity = bit_capacity(T)
    bk = torch.arange(capacity, dtype=torch.float32, device=dev)
    bit_pos = tau0[..., None] + bk * SPS
    valid = bit_pos <= (T - 2)
    sym = _interp_linear(yr, torch.clamp(bit_pos, 0.0, T - 2))
    hard = sym.real >= 0.0
    prev = torch.cat([state.prev_sym[..., None], hard[..., :-1]], dim=-1)
    bits = (hard ^ prev).to(torch.int8)

    count = valid.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    # hard[count - 1], wrapping to the last entry at count == 0 as jnp does
    prev_sym_last = _take(hard, torch.remainder(count - 1, capacity))
    tau_next = tau0 + count.to(torch.float32) * SPS - T

    # --- RDS_DEMOD view: sample-hold of the last emitted point ---------------
    sym4 = sym * 4.0
    t = torch.arange(T, dtype=torch.float32, device=dev)
    j = torch.floor((t - tau0[..., None]) / SPS).to(torch.int32)
    j = torch.minimum(j, count[..., None] - 1)
    held = _take(sym4, torch.clamp(j, 0, capacity - 1))
    demod24 = torch.where(j < 0, state.last_iq[..., None], held)
    last_iq = torch.where(count > 0,
                          _take(sym4, torch.clamp(count - 1, 0, capacity - 1)),
                          state.last_iq)

    new = BitRecoveryState(mf_carry=mf_carry, psi=psi_last, tau=tau_next,
                           prev_sym=prev_sym_last,
                           timing_locked=torch.ones(lead, dtype=torch.bool,
                                                    device=dev),
                           last_iq=last_iq)
    blk = BitBlock(bits=bits, valid=valid, count=count, iq=sym4)
    return blk, demod24, new
