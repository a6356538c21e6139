"""First-order linear-recurrence scans, row by row: y[n] = g*y[n-1] + d[n].

The JAX package gets these from `lax.associative_scan` with the combine
`_first_order_combine` (sdrjfm_tpu/ops/blockops.py:277-294); PyTorch has no
such primitive, so the port carries hand-written CUDA kernels in
`csrc/linrec.cu`.  Neither has a Pallas counterpart.

- `linrec`: real decays in (0, 1], a single-pass scan with decoupled
  look-back over chunks of 2048 samples.  On the main path it runs the
  AM-carrier and AFC trackers of the discriminator (two rows, one launch)
  and the pilot lock metric (one row), 2S and S rows for S stations; off
  it, the deemphasis scan (two rows) and the `pll` discriminator's
  one-pole.
- `pole_bank`: COMPLEX decays, the biquad cascades of `IIRSpec` factored
  into one-pole recurrences (JAX `jax.vmap(linrec_apply)` over the poles,
  blockops.py:378-382), with the residue-weighted sum y = Re sum_i r_i w_i
  fused so the [P, T] pole states never reach device memory.  A call is
  one launch: a single pass with a decoupled look-back that carries the P
  complex states between chunks of 2048 samples, each chunk summing every
  predecessor's aggregate in a fixed order (deterministic).  The states come and go
  as one [B, P] tensor; S stations' banks are one launch of the bank's
  constants folded S times (`fold_bank`, built once per S).

Each wrapper launches its kernel on a CUDA tensor (built with nvcc at the
first launch, never at import) and runs its plain version on a CPU tensor;
the plain versions, chunked scans in torch ops, are also the kernels'
references on the card.

Both kernels are safe to capture in a CUDA graph: the look-back scratch is
allocated per call (from the graph's pool while a graph captures) and
zeroed by a memset queued before the kernel, so every launch argument is
the same on each replay and no buffer a graph holds is ever freed.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import build

SOURCE = "linrec.cu"
CHUNK = 128               # plain version: in-chunk matrix size
KERNEL_CHUNK = 2048       # samples per thread block (csrc CHUNK)


def linrec_plain(drive: torch.Tensor, g: Sequence,
                 y0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan in torch ops: inside each CHUNK a lower-triangular
    g^(i-j) matmul, between chunks the same recurrence one level up (with
    g^CHUNK), applied recursively.  Only powers of |g| <= 1 appear, so
    nothing overflows (the cumsum(d*g^-n)*g^n shortcut would: g^-131072 ~
    e^131 for g = 1 - 1e-3).  drive [R, T] f32 with R real decays, or
    complex64 with R complex decays; y0 [R] -> (y, y[:, -1])."""
    R, T = drive.shape
    dev = drive.device
    n = -(-T // CHUNK)
    # g rounds to f32 (c64) first, as jnp.asarray(g, drive.dtype) does
    if drive.is_complex():
        gd = np.asarray(g, np.complex64).astype(np.complex128)[:, None]
        f32 = np.complex64
    else:
        gd = np.asarray(g, np.float32).astype(np.float64)[:, None]
        f32 = np.float32
    i = np.arange(CHUNK)
    e = i[:, None] - i[None, :]
    with np.errstate(under="ignore"):
        L = np.where(e[None] >= 0, gd[:, :, None] ** np.maximum(e, 0)[None],
                     0.0)
        pw = gd ** (i + 1)[None, :]                       # g^(i+1)
        gC = (gd[:, 0] ** CHUNK).astype(f32)
    L = torch.as_tensor(L.astype(f32), device=dev)
    pw = torch.as_tensor(pw.astype(f32), device=dev)
    dp = torch.nn.functional.pad(drive, (0, n * CHUNK - T)).view(R, n, CHUNK)
    local = torch.matmul(dp, L.transpose(1, 2))           # zero carry-in
    y0 = y0.to(drive.dtype)
    if n == 1:
        c_in = y0[:, None]
    else:
        ends, _ = linrec_plain(local[:, :, -1].contiguous(), list(gC), y0)
        c_in = torch.cat([y0[:, None], ends[:, :-1]], dim=1)
    y = (local + c_in[:, :, None] * pw[:, None, :]).reshape(R, n * CHUNK)
    y = y[:, :T]
    return y, y[:, -1]


class LinrecKernel:
    """Callable wrapper with a launch counter.  `launches` counts the calls
    that launched the kernel eagerly or recorded it into a CUDA graph being
    captured; a graph's replays launch it again without passing through
    here, so they are not counted.  CPU calls of the plain version do not
    count."""

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._g: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _entry(self):
        if self._fn is None:
            lib = build.load(SOURCE)
            fn = lib.sdr_linrec
            fn.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            if lib.sdr_linrec_chunk() != KERNEL_CHUNK:
                raise RuntimeError("linrec: csrc CHUNK != wrapper CHUNK")
            self._fn = fn
        return self._fn

    def _g_tensors(self, g: Sequence[float], dev):
        """(g, log2 g) per row as f32 device tensors, cached: a fresh H2D
        copy per call would synchronise with the host."""
        key = (tuple(float(np.float32(v)) for v in g), str(dev))
        t = self._g.get(key)
        if t is None:
            l2g = np.log2(np.asarray(key[0], np.float64))
            t = (torch.tensor(key[0], dtype=torch.float32, device=dev),
                 torch.tensor(l2g, dtype=torch.float32, device=dev))
            self._g[key] = t
        return t

    def __call__(self, drive: torch.Tensor, g: Sequence[float],
                 y0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if drive.device.type == "cpu":
            return linrec_plain(drive, g, y0)
        if drive.device.type != "cuda":
            raise ValueError(f"linrec: unsupported device {drive.device}")
        if drive.dtype != torch.float32 or drive.dim() != 2:
            raise TypeError("linrec: drive must be a [R, T] float32 tensor")
        if not drive.is_contiguous():
            raise ValueError("linrec: drive must be contiguous")
        R, T = drive.shape
        if not (1 <= R <= 65535 and 1 <= T < 2 ** 31 - KERNEL_CHUNK):
            raise ValueError(f"linrec: shape {(R, T)} out of range")
        if len(g) != R:
            raise ValueError(f"linrec: {len(g)} decays for {R} rows")
        if not all(0.0 < float(v) <= 1.0 for v in g):
            raise ValueError(f"linrec: decays must lie in (0, 1], got {g}")
        if (y0.device != drive.device or y0.dtype != torch.float32
                or tuple(y0.shape) != (R,)):
            raise ValueError("linrec: y0 must be an [R] float32 tensor on "
                             "the drive's device")
        y0 = y0.contiguous()
        dev = drive.device
        fn = self._entry()
        g_t, l2g_t = self._g_tensors(g, dev)
        # the look-back words of this launch (the entry point zeroes them)
        status = torch.empty(R * -(-T // KERNEL_CHUNK), dtype=torch.int64,
                             device=dev)
        y = torch.empty_like(drive)
        last = torch.empty(R, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = fn(drive.data_ptr(), g_t.data_ptr(), l2g_t.data_ptr(),
                    y0.data_ptr(), y.data_ptr(), last.data_ptr(), R, T,
                    status.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"linrec kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return y, last


linrec = LinrecKernel()


# ---------------------------------------------------------------------------
# Complex pole bank (kernel A)
# ---------------------------------------------------------------------------

POLE_SEG = 8                         # samples a thread (csrc poles::SEG)
POLE_CHUNK = 2048                    # samples a thread block (poles::CHUNK)
POLE_MAXP = 16                       # poles a bank (poles::MAXP)
POLE_LOOK = 64                       # predecessors a look-back step
                                     # (poles::LOOK, two a lane)
# the per-pole table the kernel reads (csrc poles::T_*), complex64 each
POLE_TABLE = (("g", 1), ("r", 1), ("rg", POLE_SEG), ("gi", POLE_SEG),
              ("gs", 5), ("gl", 32), ("gw", 1), ("gc", POLE_LOOK + 1))
POLE_NTAB = sum(n for _, n in POLE_TABLE)


def pole_bank_plain(drive: torch.Tensor, poles: torch.Tensor,
                    residues: torch.Tensor, w0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banks of complex one-pole recurrences over a shared real drive:
    w[b, p, n] = poles[b, p] * w[b, p, n-1] + drive[b, n], w[b, p, -1] =
    w0[b, p]; y[b, n] = Re sum_p residues[b, p] * w[b, p, n].  drive [B, T]
    f32; poles, residues, w0 [B, P] complex64.  Returns (y [B, T] f32, wT
    [B, P] complex64), as the JAX package's iir_apply sums its vmapped
    scans."""
    B, T = drive.shape
    P = poles.shape[1]
    d = drive.to(torch.complex64)[:, None, :].expand(B, P, T).reshape(B * P, T)
    g = poles.detach().cpu().numpy().reshape(-1)
    w, wT = linrec_plain(d.contiguous(), list(g), w0.reshape(-1))
    y = torch.sum(residues.reshape(B, P, 1) * w.view(B, P, T), dim=1).real
    return y, wT.view(B, P)


def pole_table_offsets() -> Dict[str, int]:
    """Where each part of a pole's table starts (complex64 entries)."""
    out, off = {}, 0
    for name, n in POLE_TABLE:
        out[name] = off
        off += n
    return out


def pole_table(poles: np.ndarray, residues: np.ndarray) -> np.ndarray:
    """The kernel's table for each pole ([..., POLE_NTAB] complex64), each
    entry computed in float64 from the complex64 pole and residue and
    rounded once: g, r; the correction's r g^(i+1) and the end state's
    g^(i+1) for i < SEG; the warp scan's g^(SEG 2^k), k < 5; g^(SEG l), l
    < 32 (a lane's offset in its warp); g^(SEG 32) (a warp's span); the
    look-back's g^(CHUNK m), m <= LOOK.  A power formed in f32 as exp(n
    log g) would lose ~n * 1e-7 rad."""
    g = np.asarray(poles, np.complex64).astype(np.complex128)[..., None]
    r = np.asarray(residues, np.complex64).astype(np.complex128)[..., None]
    i1 = np.arange(1, POLE_SEG + 1)
    with np.errstate(under="ignore"):
        parts = {"g": g, "r": r, "rg": r * g ** i1, "gi": g ** i1,
                 "gs": g ** (POLE_SEG * 2 ** np.arange(5)),
                 "gl": g ** (POLE_SEG * np.arange(32)),
                 "gw": g ** (POLE_SEG * 32),
                 "gc": g ** (POLE_CHUNK * np.arange(POLE_LOOK + 1))}
        return np.concatenate([parts[name] for name, _ in POLE_TABLE],
                              axis=-1).astype(np.complex64)


def pole_grid(B: int, T: int) -> Tuple[int, int]:
    """(chunks a row, thread blocks = tickets a launch) of kernel A."""
    if B < 1 or T < 1:
        raise ValueError(f"pole_bank: shape {(B, T)}")
    nch = -(-T // POLE_CHUNK)
    return nch, B * nch


class PoleBank(NamedTuple):
    """The kernel's device constants for B banks: poles, residues [B, P]
    and the per-pole table [B, P, POLE_NTAB] complex64 (banks with fewer
    poles padded with zero poles of zero residue, which add nothing), each
    bank's own pole count."""
    poles: torch.Tensor
    residues: torch.Tensor
    table: torch.Tensor
    sizes: Tuple[int, ...]


def pole_bank_constants(specs, device) -> PoleBank:
    """A PoleBank on `device` from B objects with .poles/.residues
    complex64 arrays.  Build it once and pass it to every call: a fresh
    host-to-device copy per call would synchronise."""
    P = max(len(s.poles) for s in specs)
    if not 1 <= P <= POLE_MAXP:
        raise ValueError(f"pole_bank: {P} poles, at most {POLE_MAXP}")
    pol = np.zeros((len(specs), P), np.complex64)
    res = np.zeros((len(specs), P), np.complex64)
    for b, s in enumerate(specs):
        pol[b, :len(s.poles)] = s.poles
        res[b, :len(s.residues)] = s.residues
    if np.any(np.abs(pol) > 1.0):
        raise ValueError("pole_bank: a pole lies outside the unit circle")
    return PoleBank(*(torch.as_tensor(a, device=device)
                      for a in (pol, res, pole_table(pol, res))),
                    sizes=tuple(len(s.poles) for s in specs))


def fold_bank(bank: PoleBank, n: int) -> PoleBank:
    """The B banks of `bank` repeated n times (bank s*B + b is bank b): the
    constants of n rows of every bank in one launch, copied on the device
    (blockops.IIRBank keeps each n's copy for its block loop)."""
    if n == 1:
        return bank
    return PoleBank(bank.poles.repeat(n, 1), bank.residues.repeat(n, 1),
                    bank.table.repeat(n, 1, 1), bank.sizes * n)


class PoleBankKernel:
    """Callable wrapper of kernel A with a launch counter (`launches`
    counts eager launches and captures into a CUDA graph, not a graph's
    replays; CPU calls do not count).

    __call__(drive [B, T] f32, bank: PoleBank of B banks, w0 [B, P]
    complex64, each bank's state padded to the bank's P) -> (y [B, T] f32,
    wT [B, P] complex64; entries past a bank's own pole count are
    padding)."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = build.load(SOURCE)
            fn = lib.sdr_pole_bank
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p] * 3)
            fn.restype = ctypes.c_int
            geom = (lib.sdr_pole_chunk(), lib.sdr_pole_seg(),
                    lib.sdr_pole_maxp(), lib.sdr_pole_look(),
                    lib.sdr_pole_ntab())
            if geom != (POLE_CHUNK, POLE_SEG, POLE_MAXP, POLE_LOOK,
                        POLE_NTAB):
                raise RuntimeError(f"pole_bank: csrc geometry {geom} != the "
                                   f"wrapper's")
            self._fn = fn
        return self._fn

    def __call__(self, drive: torch.Tensor, bank: PoleBank,
                 w0: torch.Tensor):
        dev = drive.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"pole_bank: unsupported device {dev}")
        if drive.dtype != torch.float32 or drive.dim() != 2:
            raise TypeError("pole_bank: drive must be a [B, T] float32 tensor")
        B, T = drive.shape
        pol, res, tab = bank.poles, bank.residues, bank.table
        P = pol.shape[1]
        if len(bank.sizes) != B:
            raise ValueError(f"pole_bank: {B} rows, {len(bank.sizes)} banks")
        if pol.device != dev:
            raise ValueError("pole_bank: constants are not on the drive's "
                             "device")
        if (not isinstance(w0, torch.Tensor) or w0.dtype != torch.complex64
                or w0.device != dev or tuple(w0.shape) != (B, P)):
            raise ValueError(f"pole_bank: the states must be a [{B}, {P}] "
                             f"complex64 tensor on the drive's device")
        if dev.type == "cpu":
            y, wT = pole_bank_plain(drive, pol, res, w0)
        else:
            if not (drive.is_contiguous() and w0.is_contiguous()):
                raise ValueError("pole_bank: drive and states must be "
                                 "contiguous")
            if not (1 <= T < 2 ** 31 - POLE_CHUNK):
                raise ValueError(f"pole_bank: shape {(B, T)} out of range")
            nch, blocks = pole_grid(B, T)
            if blocks >= 2 ** 31:
                raise ValueError(f"pole_bank: shape {(B, T)} out of range")
            # this launch's look-back scratch: the flags and, last, the
            # ticket counter (the entry point zeroes both), and the
            # aggregate payloads, P complex values a chunk
            flags = torch.empty(blocks + 1, dtype=torch.int32, device=dev)
            agg = torch.empty(blocks * P, dtype=torch.complex64, device=dev)
            y = torch.empty_like(drive)
            wT = torch.empty(B, P, dtype=torch.complex64, device=dev)
            with torch.cuda.device(dev):
                rc = self._entry()(
                    drive.data_ptr(), tab.data_ptr(), w0.data_ptr(),
                    y.data_ptr(), wT.data_ptr(), B, P, T, flags.data_ptr(),
                    agg.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"pole_bank kernel launch failed: CUDA "
                                   f"error {rc}")
            self.launches += 1
        return y, wT


pole_bank = PoleBankKernel()
