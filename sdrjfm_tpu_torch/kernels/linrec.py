"""First-order linear-recurrence scan: y[n] = g*y[n-1] + d[n], row by row.

The JAX package gets this from `lax.associative_scan` with the combine
`_first_order_combine` (sdrjfm_tpu/ops/blockops.py:277-294); PyTorch has no
such primitive, so the port carries a hand-written Triton kernel.  It has no
Pallas counterpart.  On the main path it runs the AM-carrier and AFC
trackers of the discriminator (two rows, one launch) and the pilot lock
metric (one row, one launch) over each block.

`linrec` is the wrapper: on a CUDA tensor it launches the Triton kernel
(imported and compiled at the first launch, never at import), on a CPU
tensor it runs `linrec_plain`, a chunked scan in torch ops that is also the
reference for the kernel on the card.

Kernel design: one program per row walks its row in chunks of ROWS x COLS
samples, carrying the chunk's last output into the next chunk.  A chunk is
viewed as ROWS sub-rows of COLS samples: `tl.associative_scan` runs the
combine (g1*g2, v1*g2 + v2) along each sub-row with zero carry-in, and the
sub-rows are joined with exact decay powers g^n = exp2(n * log2 g), log2 g
taken on the host in float64.  Why two levels: with Triton's scan along
one 4096-sample axis the decay products lose accuracy (on an H100 the
pilot-lock row came out 4.3e-5 of its scale off the plain version), while
128-sample sub-rows joined by exact powers stay within ~1e-6 of the scale
of a float64 recurrence (chip_smoke.py checks both).  What bounds it on an
H100: the work is tiny (3
rows x 131072 samples read and written, ~3 MB, ~1 us at 3.35 TB/s), but
one program per row serialises each row's 32 chunks on one SM, so a launch
is latency-bound, not bandwidth-bound.  Splitting each row over several
programs (a three-phase scan) is the next step if a trace shows it matters.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .build import BUILD_DIR

CHUNK = 128               # plain version: in-chunk matrix size
ROWS, COLS = 32, 128      # Triton kernel: a 4096-sample chunk as 32 x 128
NUM_WARPS = 8

_linrec_combine = None    # Triton functions, defined at the first launch
_linrec_kernel = None
tl = None


def _define_triton():
    """Import Triton and define the kernel (first launch only).  The
    functions are bound as module globals so that Triton resolves
    `_linrec_combine` and `tl` inside the kernel body."""
    global _linrec_combine, _linrec_kernel, tl
    if _linrec_kernel is not None:
        return _linrec_kernel
    # keep Triton's compile cache inside the checkout, beside the nvcc builds
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def _linrec_combine(g1, v1, g2, v2):
        return g1 * g2, v1 * g2 + v2

    @triton.jit
    def _linrec_kernel(d_ptr, g_ptr, l2g_ptr, y0_ptr, y_ptr, last_ptr, T,
                       ROWS: tl.constexpr, COLS: tl.constexpr):
        row = tl.program_id(0)
        g = tl.load(g_ptr + row)
        l2g = tl.load(l2g_ptr + row)                    # log2(g)
        carry = tl.load(y0_ptr + row)
        base = row.to(tl.int64) * T
        r = tl.arange(0, ROWS)[:, None]
        k = tl.arange(0, ROWS)[None, :]
        c = tl.arange(0, COLS)[None, :]
        # g^(c+1) along a sub-row, g^(r*COLS) per sub-row, and the strictly
        # lower-triangular g^((r-1-k)*COLS) that joins the sub-rows
        pw = tl.exp2((c + 1).to(tl.float32) * l2g)
        pr = tl.exp2((tl.arange(0, ROWS) * COLS).to(tl.float32) * l2g)
        join = tl.where(k < r, tl.exp2(((r - 1 - k) * COLS).to(tl.float32)
                                       * l2g), 0.0)
        for start in range(0, T, ROWS * COLS):
            offs = start + r * COLS + c
            mask = offs < T
            d = tl.load(d_ptr + base + offs, mask=mask, other=0.0)
            gv = tl.where(mask, g, 1.0)
            _, v = tl.associative_scan((gv, d), 1, _linrec_combine)
            ends = tl.sum(tl.where(c == COLS - 1, v, 0.0), axis=1)
            c_in = tl.sum(join * ends[None, :], axis=1) + pr * carry
            y = v + pw * c_in[:, None]
            tl.store(y_ptr + base + offs, y, mask=mask)
            last = tl.minimum(start + ROWS * COLS, T) - 1
            carry = tl.sum(tl.sum(tl.where(offs == last, y, 0.0), axis=1),
                           axis=0)
        tl.store(last_ptr + row, carry)

    return _linrec_kernel


def linrec_plain(drive: torch.Tensor, g: Sequence[float],
                 y0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan in torch ops: inside each CHUNK a lower-triangular
    g^(i-j) matmul, between chunks the same recurrence one level up (with
    g^CHUNK), applied recursively.  Only powers of g < 1 appear, so nothing
    overflows (the cumsum(d*g^-n)*g^n shortcut would: g^-131072 ~ e^131 for
    g = 1 - 1e-3).  drive [R, T] f32, g R floats, y0 [R] -> (y, y[:, -1])."""
    R, T = drive.shape
    dev = drive.device
    n = -(-T // CHUNK)
    # g rounds to f32 first, as jnp.asarray(g, float32) does in JAX
    gd = np.asarray(g, np.float32).astype(np.float64)[:, None]
    i = np.arange(CHUNK)
    e = i[:, None] - i[None, :]
    with np.errstate(under="ignore"):
        L = np.where(e[None] >= 0, gd[:, :, None] ** np.maximum(e, 0)[None],
                     0.0)
        pw = gd ** (i + 1)[None, :]                       # g^(i+1)
        gC = (gd[:, 0] ** CHUNK).astype(np.float32)
    L = torch.as_tensor(L.astype(np.float32), device=dev)
    pw = torch.as_tensor(pw.astype(np.float32), device=dev)
    dp = torch.nn.functional.pad(drive, (0, n * CHUNK - T)).view(R, n, CHUNK)
    local = torch.matmul(dp, L.transpose(1, 2))           # zero carry-in
    y0 = y0.to(drive.dtype)
    if n == 1:
        c_in = y0[:, None]
    else:
        ends, _ = linrec_plain(local[:, :, -1].contiguous(),
                               [float(v) for v in gC], y0)
        c_in = torch.cat([y0[:, None], ends[:, :-1]], dim=1)
    y = (local + c_in[:, :, None] * pw[:, None, :]).reshape(R, n * CHUNK)
    y = y[:, :T]
    return y, y[:, -1]


class LinrecKernel:
    """Callable wrapper with a launch counter (`launches` counts Triton
    launches only; CPU calls of the plain version do not count)."""

    def __init__(self):
        self.launches = 0
        self._g: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

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
        if len(g) != R:
            raise ValueError(f"linrec: {len(g)} decays for {R} rows")
        if not all(0.0 < float(v) <= 1.0 for v in g):
            raise ValueError(f"linrec: decays must lie in (0, 1], got {g}")
        if (y0.device != drive.device or y0.dtype != torch.float32
                or tuple(y0.shape) != (R,) or not y0.is_contiguous()):
            raise ValueError("linrec: y0 must be a contiguous [R] float32 "
                             "tensor on the drive's device")
        kernel = _define_triton()
        g_t, l2g_t = self._g_tensors(g, drive.device)
        y = torch.empty_like(drive)
        last = torch.empty(R, dtype=torch.float32, device=drive.device)
        with torch.cuda.device(drive.device):
            kernel[(R,)](drive, g_t, l2g_t, y0, y, last, T, ROWS=ROWS,
                         COLS=COLS, num_warps=NUM_WARPS)
        self.launches += 1
        return y, last


linrec = LinrecKernel()
