"""First-order linear-recurrence scan: y[n] = g*y[n-1] + d[n], row by row.

The JAX package gets this from `lax.associative_scan` with the combine
`_first_order_combine` (sdrjfm_tpu/ops/blockops.py:277-294); PyTorch has no
such primitive, so the port carries a hand-written CUDA kernel,
`csrc/linrec.cu`: a single-pass scan with decoupled look-back over chunks
of 2048 samples (its note says why).  It has no Pallas counterpart.  On the
main path it runs the AM-carrier and AFC trackers of the discriminator (two
rows, one launch) and the pilot lock metric (one row, one launch) over each
block.

`linrec` is the wrapper: on a CUDA tensor it launches the kernel (built
with nvcc at the first launch, never at import), on a CPU tensor it runs
`linrec_plain`, a chunked scan in torch ops that is also the reference for
the kernel on the card.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import build

SOURCE = "linrec.cu"
CHUNK = 128               # plain version: in-chunk matrix size
KERNEL_CHUNK = 2048       # samples per thread block (csrc CHUNK)
EPOCHS = 2 ** 30          # the kernel's epoch field is 30 bits


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
    """Callable wrapper with a launch counter (`launches` counts kernel
    launches only; CPU calls of the plain version do not count)."""

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._g: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._status: Dict[torch.device, torch.Tensor] = {}
        self._epoch = 0

    def _entry(self):
        if self._fn is None:
            lib = build.load(SOURCE)
            fn = lib.sdr_linrec
            fn.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint,
                ctypes.c_void_p]
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

    def _status_words(self, n: int, dev) -> torch.Tensor:
        """The look-back words, zeroed once per device and grown on demand;
        the epoch tells one launch's words from the last's."""
        st = self._status.get(dev)
        if st is None or st.numel() < n:
            st = torch.zeros(max(n, 1024), dtype=torch.int64, device=dev)
            self._status[dev] = st
        return st

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
                or tuple(y0.shape) != (R,) or not y0.is_contiguous()):
            raise ValueError("linrec: y0 must be a contiguous [R] float32 "
                             "tensor on the drive's device")
        dev = drive.device
        fn = self._entry()
        g_t, l2g_t = self._g_tensors(g, dev)
        status = self._status_words(R * -(-T // KERNEL_CHUNK), dev)
        self._epoch = self._epoch % (EPOCHS - 1) + 1
        y = torch.empty_like(drive)
        last = torch.empty(R, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = fn(drive.data_ptr(), g_t.data_ptr(), l2g_t.data_ptr(),
                    y0.data_ptr(), y.data_ptr(), last.data_ptr(), R, T,
                    status.data_ptr(), self._epoch,
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"linrec kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return y, last


linrec = LinrecKernel()
