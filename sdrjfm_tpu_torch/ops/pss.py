"""Perfect Stereo Separation (PSS) — batched conv + scalar sub-block scan
(port of sdrjfm_tpu.ops.pss).

The offset `acc` is held constant over a sub-block; with
F = lowpass(e^{j base} * demod) computed once for the whole block, the
Costas error under the rotation e^{-j acc} is Im(e^{-2j acc} F^2)/2, so the
per-sub-block sums of F^2 are formed in one vectorised pass and only a
scalar recurrence over the sub-blocks remains.  JAX runs that recurrence as
a `lax.scan`; here it is a Python loop over 0-dim device tensors (32 steps
per 131072-sample block), with `torch.where` in place of the pilot-unlock
reset.  It never synchronises with the host.  A block may carry leading
station rows ([..., T], states [...]): the recurrence then runs on [...]
vectors, one station's op count for every row.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import constants as C
from . import design
from .blockops import fir_apply

Tensor = torch.Tensor

SUBBLOCK = 4096


class PSSConfig(NamedTuple):
    kernel: Tensor            # [295] float32 15 kHz lowpass
    ema_weights: Tensor       # [SUBBLOCK] lockAlpha*(1-lockAlpha)^(S-1-n)
    ema_decay: float          # (1-lockAlpha)^SUBBLOCK
    rate: int
    subblock: int


def make_pss_config(rate: int = C.FM_RATE, subblock: int = SUBBLOCK,
                    device=None) -> PSSConfig:
    k = design.lowpass_sinc(C.PSS_FILTER_DEGREE, 15000.0, rate
                            ).astype(np.float32)
    lam = 1.0 / rate
    n = np.arange(subblock)
    w = lam * (1.0 - lam) ** (subblock - 1 - n)
    return PSSConfig(kernel=torch.as_tensor(k, device=device),
                     ema_weights=torch.as_tensor(w.astype(np.float32),
                                                 device=device),
                     ema_decay=float((1.0 - lam) ** subblock),
                     rate=rate, subblock=subblock)


class PSSState(NamedTuple):
    acc: Tensor               # accPhaseShift
    tail: Tensor              # [294] complex u = e^{j base} demod history
    mean_error: Tensor
    minimized: Tensor         # bool: error_minimized
    lock_run: Tensor          # samples below threshold (consecutive)
    unlock_run: Tensor


def pss_zero_state(cfg: PSSConfig, device=None) -> PSSState:
    f32 = lambda: torch.zeros((), dtype=torch.float32, device=device)  # noqa: E731
    i32 = lambda: torch.zeros((), dtype=torch.int32, device=device)  # noqa: E731
    return PSSState(
        acc=f32(),
        tail=torch.zeros(cfg.kernel.shape[0] - 1, dtype=torch.complex64,
                         device=device),
        mean_error=f32(),
        minimized=torch.zeros((), dtype=torch.bool, device=device),
        lock_run=i32(),
        unlock_run=i32(),
    )


def pss_adapt(demod: Tensor, base_phase: Tensor, locked: Tensor,
              cfg: PSSConfig, state: PSSState,
              active: bool = True, axis=None) -> Tuple[Tensor, PSSState]:
    """Adapt the PSS phase offset over one block.

    demod [T] MPX at fmRate; base_phase [T] = 2*(pilot_phase + pi/4);
    locked [T] pilot lock flags (while unlocked the PSS is held reset).
    Returns (per-sample offset [T], new state).

    With `axis` (a TimeAxis, the inputs this rank's slice) the L-R lowpass
    takes a ring halo, the per-sub-block sums S_k, W_k and lock flags of
    every rank arrive in ONE packed gather, the scalar scan runs over the
    whole block on every rank alike, and each rank keeps its own
    sub-blocks' offsets; the returned tail is this rank's candidate."""
    if not active:
        return torch.zeros_like(demod), state
    T = demod.shape[-1]
    lead = demod.shape[:-1]
    S = cfg.subblock
    assert T % S == 0
    nsub = T // S
    alpha = float(np.float32(C.PSS_ALPHA))
    decay = float(np.float32(cfg.ema_decay))
    hold = int(C.PSS_LOCK_STABLE_S * cfg.rate)

    u = torch.complex(torch.cos(base_phase), torch.sin(base_phase)) \
        * demod.to(torch.float32)
    if axis is None:
        F, tail = fir_apply(u, cfg.kernel, state.tail)
    else:
        from ..parallel.distributed import dist_fir
        F, tail = dist_fir(u, cfg.kernel, state.tail, axis)
    G = (F * F).reshape(lead + (nsub, S))
    S_k = G.sum(dim=-1)
    W_k = (G * cfg.ema_weights).sum(dim=-1)
    Sr, Si, Wr, Wi = S_k.real, S_k.imag, W_k.real, W_k.imag
    sub_locked = locked.reshape(lead + (nsub, S))[..., 0]
    if axis is not None:
        # one packed gather (f32, lossless); the scan below then sees the
        # whole block's sub-block sums, in rank order
        g = axis.all_gather(torch.stack([Sr, Si, Wr, Wi,
                                         sub_locked.to(torch.float32)]))
        g = g.movedim(0, -2)                      # [5, ..., P, nsub]
        Sr, Si, Wr, Wi, lk = g.reshape(g.shape[:-2] + (-1,))
        sub_locked = lk > 0.5

    acc, me = state.acc, state.mean_error
    minimized, lock_run, unlock_run = (state.minimized, state.lock_run,
                                       state.unlock_run)
    accs = []
    for k in range(sub_locked.shape[-1]):
        lk = sub_locked[..., k]
        boost = torch.where(minimized, 1.0, C.PSS_ERROR_BOOST)
        c, s = torch.cos(-2.0 * acc), torch.sin(-2.0 * acc)
        # Im(e^{-2j acc} * S_k), Im(e^{-2j acc} * W_k)
        err_sum = 0.5 * (c * Si[..., k] + s * Sr[..., k]) * boost
        acc_n = torch.clamp(acc + alpha * err_sum, -C.PSS_CLAMP, C.PSS_CLAMP)
        me_n = decay * me + 0.5 * boost * (c * Wi[..., k] + s * Wr[..., k])
        below = torch.abs(me_n) < C.PSS_LOCK_THRESHOLD
        lock_n = torch.where(below, lock_run + S, 0)
        unlock_n = torch.where(below, 0, unlock_run + S)
        min_n = torch.where(below, minimized | (lock_n > hold),
                            minimized & ~(unlock_n > hold))
        accs.append(torch.where(lk, acc, 0.0))
        # pilot unlock resets the analyzer (fm-processor.cpp:698-701)
        acc = torch.where(lk, acc_n, 0.0)
        me = torch.where(lk, me_n, 0.0)
        minimized = lk & min_n
        lock_run = torch.where(lk, lock_n, 0)
        unlock_run = torch.where(lk, unlock_n, 0)
    new_state = PSSState(acc=acc, tail=tail, mean_error=me,
                         minimized=minimized, lock_run=lock_run,
                         unlock_run=unlock_run)
    if axis is not None:
        accs = accs[axis.index * nsub:(axis.index + 1) * nsub]
    offsets = torch.stack(accs, dim=-1)[..., None].expand(
        lead + (nsub, S)).reshape(lead + (T,))
    return offsets, new_state
