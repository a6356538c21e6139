"""Perfect Stereo Separation (PSS) — batched conv + scalar sub-block scan
(port of sdrjfm_tpu.ops.pss).

The offset `acc` is held constant over a sub-block; with
F = lowpass(e^{j base} * demod) computed once for the whole block, the
Costas error under the rotation e^{-j acc} is Im(e^{-2j acc} F^2)/2, so the
per-sub-block sums of F^2 are formed in one vectorised pass and only a
scalar recurrence over the sub-blocks remains.  JAX forms the sums as XLA
reductions, runs the recurrence as a `lax.scan` and repeats each offset
over its sub-block; here the three are `kernels.loops.pss_adapt` (32 steps
per 131072-sample block): one launch of a hand kernel on the card that
reads F once and writes every sample's offset, its plain version (torch
sums, a Python loop over 0-dim device tensors, the expand) on the CPU.
The time-sharded path gathers the sums across ranks before the recurrence,
so it forms them in torch and runs `kernels.loops.pss_scan`.  Neither
synchronises with the host.  A block may carry leading station rows
([..., T], states [...]): every row then runs in the same launch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import constants as C
from . import design
from ..kernels import loops as L
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
    S = cfg.subblock
    assert demod.shape[-1] % S == 0
    alpha = float(np.float32(C.PSS_ALPHA))
    decay = float(np.float32(cfg.ema_decay))
    hold = int(C.PSS_LOCK_STABLE_S * cfg.rate)

    u = torch.complex(torch.cos(base_phase), torch.sin(base_phase)) \
        * demod.to(torch.float32)
    scan_state = (state.acc, state.mean_error, state.minimized,
                  state.lock_run, state.unlock_run)
    if axis is None:
        F, tail = fir_apply(u, cfg.kernel, state.tail)
        offsets, scanned = L.pss_adapt(F, locked, cfg.ema_weights,
                                       scan_state, S, hold, alpha, decay)
    else:
        from ..parallel.distributed import dist_fir
        F, tail = dist_fir(u, cfg.kernel, state.tail, axis)
        S_k, W_k, sub_locked = L.pss_sums(F, locked, cfg.ema_weights, S)
        # one packed gather (f32, lossless); the scan below then sees the
        # whole block's sub-block sums, in rank order
        g = axis.all_gather(torch.stack([S_k.real, S_k.imag, W_k.real,
                                         W_k.imag,
                                         sub_locked.to(torch.float32)]))
        g = g.movedim(0, -2)                      # [5, ..., P, nsub]
        Sr, Si, Wr, Wi, lk = g.reshape(g.shape[:-2] + (-1,))
        accs, scanned = L.pss_scan(torch.complex(Sr, Si),
                                   torch.complex(Wr, Wi), lk > 0.5,
                                   scan_state, S, hold, alpha, decay)
        nsub = F.shape[-1] // S                   # this rank's
        offsets = L.pss_offsets(
            accs[..., axis.index * nsub:(axis.index + 1) * nsub], S)
    acc, me, minimized, lock_run, unlock_run = scanned
    new_state = PSSState(acc=acc, tail=tail, mean_error=me,
                         minimized=minimized, lock_run=lock_run,
                         unlock_run=unlock_run)
    return offsets, new_state
