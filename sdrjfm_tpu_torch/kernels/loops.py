"""The fm chain's last sequential device loops as hand kernels
(`csrc/loops.cu`), each beside its plain torch version.

The JAX package runs these as `lax.scan` / `associative_scan` on the
device; the port ran them as Python loops of 0-dim (or [S]) tensor ops,
and the run length as `torch.cummax`:

- `pss_adapt`: the PSS adaptation of a block from its lowpassed L-R band
  F: the sub-block sums of F^2 and of EMA-weighted F^2 (JAX
  sdrjfm_tpu/ops/pss.py:121-124), the sub-block recurrence (:164), 32
  steps a 131072-sample block, and the offset of every sample (:170); called
  by ops/pss.py `pss_adapt`.
- `pss_scan`: the recurrence alone, on sums formed outside; called by
  ops/pss.py `pss_adapt` on the time-sharded path, which gathers the sums
  across ranks between the sums and the steps.
- `psi_recover`: the RDS carrier phase of a block: the squared-BPSK
  estimate a sub-block (JAX sdrjfm_tpu/rds/bitrecovery.py:120-121), the
  unwrap (:128) and the derotation it feeds; called by rds/bitrecovery.py
  `recover_bits`.
- `psi_unwrap`: the unwrap and derotation on estimates formed outside.
- `runlength`: the consecutive-true run length (JAX
  sdrjfm_tpu/ops/blockops.py:391-405 `runlength_true`), the pilot lock
  counter; called by ops/blockops.py `runlength_true`.
- `squelch_gate`: the noise squelch after its band filters, the two
  decaying averages of |band| (JAX sdrjfm_tpu/ops/squelch.py:94-95), their
  period ends (:104-105), the decision lattice (:120) and the gate (:124),
  the full-rate averages never formed; or the level squelch's lattice
  (:208) and gate (:212); called by ops/squelch.py `noise_squelch` and
  `level_squelch`.
- `squelch_decide`: the noise and level squelch decision lattices alone, on
  period ends formed outside; called by ops/squelch.py on the time-sharded
  path, which gathers the period ends across ranks before the lattice.

Each takes R independent rows: leading dims [...] of its inputs, one row
for one station, S for the n-station step.  A wrapper runs its plain
version on a CPU tensor, and on a CUDA tensor launches its kernel (built
with nvcc at the first launch, never at import) or raises; `launches`
counts the launches, eager or recorded into a CUDA graph being captured
(a graph's replays are not counted), never the plain version's calls.  No
kernel keeps scratch between calls and no launch argument changes from
call to call at one shape, so each is safe to capture in a CUDA graph.
The plain versions are the torch code the callers ran before, moved here
as it was: the CPU path is unchanged bit for bit, and on the card they
are the kernels' references.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from . import build
from .linrec import linrec_plain

Tensor = torch.Tensor

SOURCE = "loops.cu"
PSS_SUBBLOCKS = (1024, 2048, 4096)  # the sub-blocks pss_adapt's kernel takes
PSI_MAXSUB = 1024          # sub-blocks a row of psi_unwrap (csrc PSI_MAXSUB)
PSI_MINSUB = 512           # samples a sub-block of psi_recover (csrc
PSI_SPAN = 16384           # PR_MINSUB .. PR_SPAN)
RL_SPAN = 131072           # samples a runlength cluster step (csrc RL_SPAN)
HYSTERESIS_NSQ = 0.001     # the noise squelch's decision band
SQ_QUANT = 2048            # squelch_gate's hold periods are multiples of
                           # this, for nsq at most 8 of it (csrc SG_QUANT)
SQ_SPAN = 131072           # samples a squelch_gate cluster step (SG_SPAN)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def pss_scan_plain(S_k: Tensor, W_k: Tensor, sub_locked: Tensor, state,
                   subblock: int, hold: int, alpha: float, decay: float
                   ) -> Tuple[Tensor, tuple]:
    """The PSS offset recurrence over the sub-blocks.  S_k, W_k [..., n]
    complex64 (the sums of F^2 and of EMA-weighted F^2 a sub-block);
    sub_locked [..., n] bool; state = (acc, mean_error, minimized,
    lock_run, unlock_run), [...] each.  Returns (accs [..., n], the offset
    held over each sub-block, and the new state tuple)."""
    S = subblock
    Sr, Si, Wr, Wi = S_k.real, S_k.imag, W_k.real, W_k.imag
    acc, me, minimized, lock_run, unlock_run = state
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
    return torch.stack(accs, dim=-1), (acc, me, minimized, lock_run,
                                       unlock_run)


def pss_sums(F: Tensor, locked: Tensor, weights: Tensor, subblock: int
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """The PSS scan's inputs from the lowpassed L-R band F [..., T]
    complex64: S_k and W_k [..., n] complex64, the sums of F^2 and of
    EMA-weighted (weights [subblock]) F^2 over each sub-block, and the lock
    flag at each sub-block's first sample, from locked [..., T] bool."""
    lead, T = F.shape[:-1], F.shape[-1]
    nsub = T // subblock
    G = (F * F).reshape(lead + (nsub, subblock))
    S_k = G.sum(dim=-1)
    W_k = (G * weights).sum(dim=-1)
    sub_locked = locked.reshape(lead + (nsub, subblock))[..., 0]
    return S_k, W_k, sub_locked


def pss_offsets(accs: Tensor, subblock: int) -> Tensor:
    """The offset of every sample: accs [..., n] held over each sub-block,
    [..., n subblock]."""
    lead, nsub = accs.shape[:-1], accs.shape[-1]
    return accs[..., None].expand(lead + (nsub, subblock)).reshape(
        lead + (nsub * subblock,))


def pss_adapt_plain(F: Tensor, locked: Tensor, weights: Tensor, state,
                    subblock: int, hold: int, alpha: float, decay: float
                    ) -> Tuple[Tensor, tuple]:
    """The PSS adaptation of a block from its lowpassed L-R band F [..., T]
    complex64 (T a multiple of subblock) and the pilot's lock flags locked
    [..., T] bool: the sub-block sums (pss_sums), the recurrence
    (pss_scan_plain) and the offset of every sample.  Returns (offsets
    [..., T] float32, the new state tuple)."""
    S_k, W_k, sub_locked = pss_sums(F, locked, weights, subblock)
    accs, new = pss_scan_plain(S_k, W_k, sub_locked, state, subblock, hold,
                               alpha, decay)
    return pss_offsets(accs, subblock), new


def psi_unwrap_plain(raw: Tensor, psi0: Tensor, y: Tensor
                     ) -> Tuple[Tensor, Tensor]:
    """The carrier-phase unwrap psi = r + round((psi - r) / pi) pi over the
    sub-blocks' estimates raw [..., nsub] from psi0 [...], then y [..., T]
    complex64 derotated by each sub-block's psi.  Returns (y e^{-j psi}
    [..., T], the last psi [...])."""
    T = y.shape[-1]
    lead = y.shape[:-1]
    nsub = raw.shape[-1]
    phase_sub = T // nsub
    psi = psi0
    psi_seq = []
    for k in range(nsub):
        r = raw[..., k]
        psi = r + torch.round((psi - r) / math.pi) * math.pi
        psi_seq.append(psi)
    psi_last = psi
    psi_full = torch.stack(psi_seq, dim=-1)[..., None].expand(
        lead + (nsub, phase_sub)).reshape(lead + (T,))
    yr = y * torch.complex(torch.cos(psi_full), -torch.sin(psi_full))
    return yr, psi_last


def psi_estimate(y: Tensor, phase_sub: int) -> Tensor:
    """Each sub-block's squared-BPSK carrier estimate psi mod pi =
    angle(mean(y^2)) / 2: y [..., T] complex64 -> [..., T / phase_sub]."""
    lead, T = y.shape[:-1], y.shape[-1]
    y2 = (y * y).reshape(lead + (T // phase_sub, phase_sub))
    return 0.5 * torch.angle(y2.mean(dim=-1))


def psi_recover_plain(y: Tensor, psi0: Tensor, phase_sub: int
                      ) -> Tuple[Tensor, Tensor]:
    """The RDS carrier phase of a block y [..., T] complex64 (the matched
    filter's output, T a multiple of phase_sub): each sub-block's estimate
    (psi_estimate), unwrapped from psi0 [...], and y derotated by it
    (psi_unwrap_plain).  Returns (y e^{-j psi} [..., T], the last psi
    [...])."""
    return psi_unwrap_plain(psi_estimate(y, phase_sub), psi0, y)


def runlength_plain(flags: Tensor, r0: Tensor) -> Tuple[Tensor, Tensor]:
    """Consecutive-true run length ending at each sample, with carry-in r0
    (the reference's SampleLockStableCnt pattern).  flags [..., T], r0
    [...], each row its own run."""
    T = flags.shape[-1]
    idx = torch.arange(T, dtype=torch.int32, device=flags.device)
    last_false = torch.cummax(torch.where(flags, -1, idx), dim=-1).values
    rl = torch.where(last_false >= 0, idx - last_false,
                     idx + 1 + r0.to(torch.int32)[..., None])
    rl = torch.where(flags, rl, 0).to(torch.int32)
    return rl, rl[..., -1]


def squelch_decide_plain(mode: str, a: Tensor, b: Optional[Tensor],
                         thr: Tensor, sup0: Tensor) -> Tuple[Tensor, Tensor]:
    """The squelch's latched decision at each period end.  mode "nsq": a,
    b = the high and low band averages [..., n], open where a < b thr -
    HYSTERESIS_NSQ, close where a >= b thr + HYSTERESIS_NSQ, forced shut
    when thr < HYSTERESIS_NSQ; mode "level": a = the carrier level [..., n]
    (b unused, None), closed below thr, open at or above it.  thr [...], sup0
    [...] bool.  Returns (the decisions [..., n] bool, the last [...])."""
    sup = sup0
    sups = []
    if mode == "nsq":
        for k in range(a.shape[-1]):
            open_ = a[..., k] < b[..., k] * thr - HYSTERESIS_NSQ
            close = a[..., k] >= b[..., k] * thr + HYSTERESIS_NSQ
            sup = torch.where(thr < HYSTERESIS_NSQ, True,
                              torch.where(open_, False,
                                          torch.where(close, True, sup)))
            sups.append(sup)
    elif mode == "level":
        for k in range(a.shape[-1]):
            sup = torch.where(a[..., k] < thr, True,
                              torch.where(a[..., k] >= thr, False, sup))
            sups.append(sup)
    else:
        raise ValueError(f"squelch_decide: mode {mode!r}")
    return torch.stack(sups, dim=-1), sup


def gate_periods(x: Tensor, sups: Tensor, H: int) -> Tensor:
    """x [..., T] with each hold period of H samples zeroed where its
    decision (sups [..., T / H] bool) suppresses."""
    keep = (~sups).to(x.dtype)                              # [..., nper]
    return (x.reshape(x.shape[:-1] + (sups.shape[-1], H))
            * keep[..., None]).reshape(x.shape)


def squelch_gate_plain(mode: str, a: Tensor, b: Optional[Tensor], x: Tensor,
                       thr: Tensor, avg0, sup0: Tensor, hold: int,
                       alpha: float):
    """The squelch of a demod block x [..., T] (T a multiple of hold).
    mode "nsq": a, b the high and low bands' filter outputs [..., T], avg0
    = (avg_high, avg_low) [...]: the decaying averages of |a| and |b| with
    weight alpha (one scan of both, linrec_plain), their values at each
    period's end, and the noise lattice on them (squelch_decide_plain);
    mode "level": a the tracked carrier [..., T], read at the period ends,
    b and avg0 None.  thr [...]: the threshold; sup0 [...] the latched
    decision.  Returns (x gated per period (gate_periods), the decisions
    [..., T / hold] bool, the last [...], the averages at the block's end
    (avg_high, avg_low), None in level mode)."""
    lead, T = x.shape[:-1], x.shape[-1]
    per = lead + (T // hold, hold)
    if mode == "nsq":
        drive = torch.stack([alpha * torch.abs(v).to(torch.float32)
                             for v in (a, b)])
        y0 = torch.stack([v.to(torch.float32) for v in avg0])
        n = drive[0].numel() // T
        y, last = linrec_plain(drive.reshape(-1, T), [1.0 - alpha] * (2 * n),
                               y0.reshape(-1))
        ah, al = y.view(drive.shape)
        carry = tuple(last.view(y0.shape))
        sups, sup = squelch_decide_plain("nsq", ah.reshape(per)[..., -1],
                                         al.reshape(per)[..., -1], thr, sup0)
    elif mode == "level":
        carry = None
        sups, sup = squelch_decide_plain(
            "level", a.reshape(a.shape[:-1] + per[-2:])[..., -1], None, thr,
            sup0)
    else:
        raise ValueError(f"squelch_gate: mode {mode!r}")
    return gate_periods(x, sups, hold), sups, sup, carry


def squelch_gate_table(alpha: float, hold: int) -> Tuple[np.ndarray, float]:
    """squelch_gate's powers of g = f32(1 - alpha) (the plain version's
    decay, rounded as linrec_plain rounds it): g^(hold-1-j) at sample j of
    a period, [hold] float32, and g^hold, each computed in float64 and
    rounded once."""
    g = float(np.float32(1.0 - alpha))
    with np.errstate(under="ignore"):
        w = g ** np.arange(hold - 1, -1, -1, dtype=np.float64)
        return w.astype(np.float32), float(np.float32(g ** hold))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _rows(x: Tensor, R: int, n: int):
    """x [..., n] as an [R, n] view (a copy only where no view exists) and
    its two strides in elements."""
    x2 = x.reshape(R, n)
    return x2, x2.stride(0), x2.stride(1)


def _aligned(x: Tensor) -> Tensor:
    """x contiguous with a 16-byte aligned start (a copy where it is not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _aligned_rows(x: Tensor, R: int, T: int):
    """x [..., T] as an [R, T] view whose rows start 16-byte aligned (a
    copy where the view does not), and its row stride in elements."""
    x2 = x.reshape(R, T)
    if x2.stride(1) != 1 or x2.stride(0) % 4 or x2.data_ptr() % 16:
        x2 = _aligned(x2)
    return x2, x2.stride(0)


def _vec(x: Tensor, lead, dtype) -> Tensor:
    """x broadcast over the rows `lead`, as a contiguous [R] tensor."""
    if x.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {x.dtype}")
    return x.expand(lead).reshape(-1).contiguous()


class _LoopKernel:
    """A kernel of csrc/loops.cu: its C entry `sdr_<name>` and a launch
    counter."""

    name = ""
    argtypes: list = []

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = build.load(SOURCE)
            geom = (lib.sdr_psi_maxsub(), lib.sdr_psi_span(),
                    lib.sdr_rl_span(), lib.sdr_squelch_quant(),
                    lib.sdr_squelch_span())
            if geom != (PSI_MAXSUB, PSI_SPAN, RL_SPAN, SQ_QUANT, SQ_SPAN):
                raise RuntimeError(f"{SOURCE}: csrc geometry {geom} != the "
                                   f"wrapper's")
            fn = getattr(lib, f"sdr_{self.name}")
            fn.argtypes = self.argtypes + [_P]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _on_card(self, dev: torch.device) -> bool:
        """False for the CPU (run the plain version); True for a card;
        raises for any other device."""
        if dev.type == "cpu":
            return False
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {dev}")
        return True

    def _launch(self, dev: torch.device, *args) -> None:
        with torch.cuda.device(dev):
            rc = self._entry()(*args,
                               torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {rc}")
        self.launches += 1


_PSS_STATE = (torch.float32, torch.float32, torch.bool, torch.int32,
              torch.int32)


class PssAdaptKernel(_LoopKernel):
    """__call__(F, locked, weights, state, subblock, hold, alpha, decay) as
    pss_adapt_plain; a cluster of 8 blocks a row."""

    name = "pss_adapt"
    argtypes = [_P, _P, _LL, _LL] + [_P] * 12 + [_I, _I, _I] + [_F] * 5 \
        + [_I]

    def __call__(self, F, locked, weights, state, subblock: int, hold: int,
                 alpha: float, decay: float):
        lead, T = F.shape[:-1], F.shape[-1]
        if (F.dtype != torch.complex64 or locked.dtype != torch.bool
                or locked.shape != F.shape or weights.dtype != torch.float32
                or weights.shape != (subblock,)):
            raise TypeError("pss_adapt: F [..., T] complex64, locked [..., "
                            "T] bool and weights [subblock] float32")
        if T < subblock or T % subblock:
            raise ValueError(f"pss_adapt: {T} samples are not whole "
                             f"sub-blocks of {subblock}")
        dev = F.device
        if not self._on_card(dev):
            return pss_adapt_plain(F, locked, weights, state, subblock, hold,
                                   alpha, decay)
        R, n = math.prod(lead), T // subblock
        if subblock not in PSS_SUBBLOCKS or R > 65535:
            raise ValueError(f"pss_adapt: {R} rows of {n} sub-blocks of "
                             f"{subblock} (the kernel takes {PSS_SUBBLOCKS})")
        F2 = _aligned(F.reshape(R, T))
        lk, lk_r, lk_c = _rows(locked, R, T)
        w = _aligned(weights)
        ins = [_vec(v, lead, dt) for v, dt in zip(state, _PSS_STATE)]
        off = torch.empty(R, T, dtype=torch.float32, device=dev)
        outs = [torch.empty(R, dtype=v.dtype, device=dev) for v in ins]
        self._launch(dev, F2.data_ptr(), lk.data_ptr(), lk_r, lk_c,
                     w.data_ptr(), *(v.data_ptr() for v in ins),
                     off.data_ptr(), *(v.data_ptr() for v in outs), R, n,
                     int(subblock), float(alpha), float(decay),
                     float(C.PSS_ERROR_BOOST), float(C.PSS_CLAMP),
                     float(C.PSS_LOCK_THRESHOLD), int(hold))
        return off.reshape(lead + (T,)), tuple(v.reshape(lead) for v in outs)


class PssScanKernel(_LoopKernel):
    """__call__(S_k, W_k, sub_locked, state, subblock, hold, alpha, decay)
    as pss_scan_plain; one thread a row."""

    name = "pss_scan"
    argtypes = [_P, _P, _P, _LL, _LL] + [_P] * 11 + [_I, _I] + [_F] * 5 \
        + [_I, _I]

    def __call__(self, S_k, W_k, sub_locked, state, subblock: int, hold: int,
                 alpha: float, decay: float):
        dev = S_k.device
        if not self._on_card(dev):
            return pss_scan_plain(S_k, W_k, sub_locked, state, subblock,
                                  hold, alpha, decay)
        lead, n = S_k.shape[:-1], S_k.shape[-1]
        R = math.prod(lead)
        if (S_k.dtype != torch.complex64 or W_k.dtype != torch.complex64
                or W_k.shape != S_k.shape or sub_locked.dtype != torch.bool
                or sub_locked.shape != S_k.shape):
            raise TypeError("pss_scan: S_k, W_k [..., n] complex64 and "
                            "sub_locked [..., n] bool")
        S2 = S_k.reshape(R, n).contiguous()
        W2 = W_k.reshape(R, n).contiguous()
        lk, lk_r, lk_c = _rows(sub_locked, R, n)
        ins = [_vec(v, lead, dt) for v, dt in zip(state, _PSS_STATE)]
        accs = torch.empty(R, n, dtype=torch.float32, device=dev)
        outs = [torch.empty(R, dtype=v.dtype, device=dev) for v in ins]
        self._launch(dev, S2.data_ptr(), W2.data_ptr(), lk.data_ptr(), lk_r,
                     lk_c, *(v.data_ptr() for v in ins), accs.data_ptr(),
                     *(v.data_ptr() for v in outs), R, n, float(alpha),
                     float(decay), float(C.PSS_ERROR_BOOST),
                     float(C.PSS_CLAMP), float(C.PSS_LOCK_THRESHOLD),
                     int(subblock), int(hold))
        return accs.reshape(lead + (n,)), tuple(v.reshape(lead) for v in outs)


class PsiUnwrapKernel(_LoopKernel):
    """__call__(raw, psi0, y) as psi_unwrap_plain; grid (chunks of 2048
    samples, rows)."""

    name = "psi_unwrap"
    argtypes = [_P] * 5 + [_I] * 3 + [_F, _F]

    def __call__(self, raw, psi0, y):
        dev = y.device
        if not self._on_card(dev):
            return psi_unwrap_plain(raw, psi0, y)
        lead, T = y.shape[:-1], y.shape[-1]
        nsub = raw.shape[-1]
        R = math.prod(lead)
        if (y.dtype != torch.complex64 or raw.dtype != torch.float32
                or raw.shape[:-1] != lead):
            raise TypeError("psi_unwrap: y [..., T] complex64, raw [..., "
                            "nsub] float32")
        if not (1 <= nsub <= PSI_MAXSUB and T % nsub == 0 and R <= 65535):
            raise ValueError(f"psi_unwrap: {nsub} sub-blocks of {T} "
                             f"samples, {R} rows")
        y2 = y.reshape(R, T).contiguous()
        raw2 = raw.reshape(R, nsub).contiguous()
        p0 = _vec(psi0, lead, torch.float32)
        yr = torch.empty_like(y2)
        last = torch.empty(R, dtype=torch.float32, device=dev)
        # torch on the card divides by a scalar as a multiply by its f32
        # reciprocal
        inv_pi = float(np.float32(1.0) / np.float32(math.pi))
        self._launch(dev, raw2.data_ptr(), p0.data_ptr(), y2.data_ptr(),
                     yr.data_ptr(), last.data_ptr(), R, T, nsub, inv_pi,
                     float(np.float32(math.pi)))
        return yr.reshape(lead + (T,)), last.reshape(lead)


class PsiRecoverKernel(_LoopKernel):
    """__call__(y, psi0, phase_sub) as psi_recover_plain; a cluster of 8
    blocks a row."""

    name = "psi_recover"
    argtypes = [_P] * 4 + [_I] * 3 + [_F] * 3

    def __call__(self, y, psi0, phase_sub: int):
        lead, T = y.shape[:-1], y.shape[-1]
        if y.dtype != torch.complex64 or psi0.dtype != torch.float32:
            raise TypeError("psi_recover: y [..., T] complex64, psi0 [...] "
                            "float32")
        if T < phase_sub or T % phase_sub:
            raise ValueError(f"psi_recover: {T} samples are not whole "
                             f"sub-blocks of {phase_sub}")
        dev = y.device
        if not self._on_card(dev):
            return psi_recover_plain(y, psi0, phase_sub)
        R = math.prod(lead)
        if not (PSI_MINSUB <= phase_sub <= PSI_SPAN and phase_sub % 2 == 0
                and R <= 65535):
            raise ValueError(f"psi_recover: {R} rows, sub-blocks of "
                             f"{phase_sub} samples (the kernel takes an even "
                             f"{PSI_MINSUB} .. {PSI_SPAN})")
        y2 = _aligned(y.reshape(R, T))
        p0 = _vec(psi0, lead, torch.float32)
        yr = torch.empty_like(y2)
        last = torch.empty(R, dtype=torch.float32, device=dev)
        # torch's mean scales its sum by fl(1 / n); on the card torch
        # divides by a scalar as a multiply by its f32 reciprocal
        f32 = np.float32
        self._launch(dev, y2.data_ptr(), p0.data_ptr(), yr.data_ptr(),
                     last.data_ptr(), R, T, int(phase_sub),
                     float(f32(1.0) / f32(phase_sub)),
                     float(f32(1.0) / f32(math.pi)), float(f32(math.pi)))
        return yr.reshape(lead + (T,)), last.reshape(lead)


class RunlengthKernel(_LoopKernel):
    """__call__(flags, r0) as runlength_plain; a cluster of 8 blocks a
    row."""

    name = "runlength"
    argtypes = [_P] * 4 + [_I, _I]

    def __call__(self, flags, r0):
        dev = flags.device
        if not self._on_card(dev):
            return runlength_plain(flags, r0)
        lead, T = flags.shape[:-1], flags.shape[-1]
        R = math.prod(lead)
        if flags.dtype != torch.bool:
            raise TypeError("runlength: flags must be bool")
        if not (1 <= T < 2 ** 31 - RL_SPAN and R <= 65535):
            raise ValueError(f"runlength: {R} rows of {T} samples")
        f2 = flags.reshape(R, T).contiguous()
        r = _vec(r0.to(torch.int32), lead, torch.int32)
        rl = torch.empty(R, T, dtype=torch.int32, device=dev)
        last = torch.empty(R, dtype=torch.int32, device=dev)
        self._launch(dev, f2.data_ptr(), r.data_ptr(), rl.data_ptr(),
                     last.data_ptr(), R, T)
        return rl.reshape(lead + (T,)), last.reshape(lead)


class SquelchDecideKernel(_LoopKernel):
    """__call__(mode, a, b, thr, sup0) as squelch_decide_plain; one thread
    a row."""

    name = "squelch_decide"
    argtypes = [_I, _P, _LL, _LL, _P, _LL, _LL] + [_P] * 4 + [_I, _I, _F]

    def __call__(self, mode: str, a, b, thr, sup0):
        dev = a.device
        if not self._on_card(dev):
            return squelch_decide_plain(mode, a, b, thr, sup0)
        if mode not in ("nsq", "level"):
            raise ValueError(f"squelch_decide: mode {mode!r}")
        b = a if mode == "level" else b
        lead, n = a.shape[:-1], a.shape[-1]
        R = math.prod(lead)
        if (a.dtype != torch.float32 or b.dtype != torch.float32
                or b.shape != a.shape):
            raise TypeError("squelch_decide: a, b [..., n] float32")
        a2, a_r, a_c = _rows(a, R, n)
        b2, b_r, b_c = _rows(b, R, n)
        t = _vec(thr, lead, torch.float32)
        s0 = _vec(sup0, lead, torch.bool)
        sups = torch.empty(R, n, dtype=torch.bool, device=dev)
        last = torch.empty(R, dtype=torch.bool, device=dev)
        self._launch(dev, 0 if mode == "nsq" else 1, a2.data_ptr(), a_r, a_c,
                     b2.data_ptr(), b_r, b_c, t.data_ptr(), s0.data_ptr(),
                     sups.data_ptr(), last.data_ptr(), R, n,
                     float(HYSTERESIS_NSQ))
        return sups.reshape(lead + (n,)), last.reshape(lead)


class SquelchGateKernel(_LoopKernel):
    """__call__(mode, a, b, x, thr, avg0, sup0, hold, alpha) as
    squelch_gate_plain; nsq: a cluster of 8 blocks a row, level: grid
    (chunks of 16384 samples, rows).  The powers of g live on the device,
    built once per (alpha, hold, device)."""

    name = "squelch_gate"
    argtypes = [_I, _P, _LL, _P, _LL, _P, _LL] + [_P] * 10 + [_I] * 3 \
        + [_F] * 3

    def __init__(self):
        super().__init__()
        self._tables = {}

    def _table(self, alpha: float, hold: int, dev):
        """(the [hold] powers on `dev`, g^hold, f32(alpha)), cached: a fresh
        copy per call would synchronise with the host."""
        key = (alpha, hold, dev)
        t = self._tables.get(key)
        if t is None:
            w, gH = squelch_gate_table(alpha, hold)
            t = (torch.from_numpy(w).to(dev), gH, float(np.float32(alpha)))
            self._tables[key] = t
        return t

    def __call__(self, mode: str, a, b, x, thr, avg0, sup0, hold: int,
                 alpha: float):
        if mode not in ("nsq", "level"):
            raise ValueError(f"squelch_gate: mode {mode!r}")
        nsq = mode == "nsq"
        lead, T = x.shape[:-1], x.shape[-1]
        ins = (a, b) if nsq else (a,)
        if (x.dtype != torch.float32
                or any(v is None or v.dtype != torch.float32
                       or v.shape != x.shape for v in ins)
                or (nsq and (avg0 is None or len(avg0) != 2))):
            raise TypeError("squelch_gate: a (and b for nsq), x [..., T] "
                            "float32, and avg0 = (avg_high, avg_low) for nsq")
        if T < hold or T % hold:
            raise ValueError(f"squelch_gate: {T} samples are not whole hold "
                             f"periods of {hold}")
        dev = x.device
        if not self._on_card(dev):
            return squelch_gate_plain(mode, a, b, x, thr, avg0, sup0, hold,
                                      alpha)
        R, nper = math.prod(lead), T // hold
        if (hold % SQ_QUANT or (nsq and hold > 8 * SQ_QUANT) or R > 65535
                or T > 2 ** 31 - 1 - SQ_SPAN):
            raise ValueError(f"squelch_gate: {R} rows of {nper} hold periods "
                             f"of {hold} (the kernel takes multiples of "
                             f"{SQ_QUANT}, for nsq up to {8 * SQ_QUANT})")
        if any(v.device != dev for v in ins):
            raise ValueError("squelch_gate: a, b and x on different devices")
        x2, x_r = _aligned_rows(x, R, T)
        if nsq:
            a2, a_r = _aligned_rows(a, R, T)
            b2, b_r = _aligned_rows(b, R, T)
            wt, gH, alpha32 = self._table(alpha, hold, dev)
            h0, l0 = (_vec(v, lead, torch.float32) for v in avg0)
        else:
            # the carrier, read at the period ends only; b, the table and
            # the averages are not read in level mode
            a2 = a.reshape(R, T)
            a2 = a2 if a2.stride(1) == 1 else a2.contiguous()
            a_r = a2.stride(0)
            b2, b_r, wt, gH, alpha32, h0, l0 = a2, a_r, x2, 0.0, 0.0, x2, x2
        t = _vec(thr, lead, torch.float32)
        s0 = _vec(sup0, lead, torch.bool)
        y = torch.empty(R, T, dtype=torch.float32, device=dev)
        sups = torch.empty(R, nper, dtype=torch.bool, device=dev)
        last = torch.empty(R, dtype=torch.bool, device=dev)
        carry = torch.empty(2, R, dtype=torch.float32, device=dev)
        self._launch(dev, 0 if nsq else 1, a2.data_ptr(), a_r, b2.data_ptr(),
                     b_r, x2.data_ptr(), x_r, y.data_ptr(), wt.data_ptr(),
                     t.data_ptr(), h0.data_ptr(), l0.data_ptr(),
                     s0.data_ptr(), sups.data_ptr(), last.data_ptr(),
                     carry[0].data_ptr(), carry[1].data_ptr(), R, T, hold,
                     alpha32, gH, HYSTERESIS_NSQ)
        return (y.reshape(lead + (T,)), sups.reshape(lead + (nper,)),
                last.reshape(lead),
                tuple(v.reshape(lead) for v in carry) if nsq else None)


pss_adapt = PssAdaptKernel()
pss_scan = PssScanKernel()
psi_recover = PsiRecoverKernel()
psi_unwrap = PsiUnwrapKernel()
runlength = RunlengthKernel()
squelch_decide = SquelchDecideKernel()
squelch_gate = SquelchGateKernel()
