"""Fused front end: wire decode, gains, DC, exact-NCO mix and composite ÷12.

`frontend` is the wrapper the receiver calls.  On a CUDA tensor it launches
the hand-written kernel of `csrc/frontend.cu` (the port of the TPU kernel
`sdrjfm_tpu/ops/pallas_frontend.py::_kernel`); on a CPU tensor it runs
`frontend_plain`, the same function in torch ops, which is also the
reference the kernel is held against on the card.  There is no fallback:
on a CUDA tensor the kernel launches or the call raises.

One launch per block: the kernel also finishes the DC servo's subsample
mean.  `frontend_rows` runs R rows in one launch (the counterpart of the
Pallas call under `jax.vmap`: stations over one shared block, the band
scan's offsets x blocks), each row on a wire block of its choosing with its
own LO, gains, DC state and carry; `frontend` is its R = 1 case, so there
is one kernel and one entry.  `nco_index_steps` mirrors the kernel's NCO
stepping, so that the CPU tests reach it.

A time-sharded front end (`Receiver.front_end(axis=)`) runs the same
kernel on each rank's slice.  Its halo is the left neighbour's last
HALO_WIRE wire samples run through the kernel once more with the
neighbour's NCO phase: a sample's mix depends only on its wire value, the
gains, the DC correction and its global index, so the halo's new carry is
bit for bit the neighbour's mixed tail.  With `partials=True` a call
returns the DC subsample's partial sums instead of its mean (on the card
the per-tile sums the kernel reduces, on the CPU the raw subsample);
`dc_mean_of_tiles` reduces every rank's tile sums as one launch on the
whole block would, in the kernel's own summation order.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..ops import blockops as B
from . import build

SOURCE = "frontend.cu"
DECIM = 12
NTAPS = 307
HALO = NTAPS - 1
DC_SUBSAMPLE = 64
LEAD = NTAPS - DECIM              # window samples before a tile's own range
TILE = 512                        # outputs per thread block (csrc TILE)
THREADS = 384                     # threads per block (csrc THREADS)
MAX_TILES = 65535                 # tiles are the grid's y axis
MAX_T = DECIM * TILE * MAX_TILES  # samples a block
# the wire samples a sharded rank sends its right neighbour: at least HALO
# mixed samples, a multiple of DECIM (a kernel block) and of DC_SUBSAMPLE
# (so the plain version's vector lanes line up with the whole block's)
HALO_WIRE = 384

WIRE_FORMATS = {"c64": (0, torch.complex64), "i16": (1, torch.int16),
                "u8": (2, torch.uint8), "i8": (3, torch.int8)}


def decode_wire(iq: torch.Tensor, fmt: str) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(re, im) f32 planes of a wire block (receiver.py:560-574): iq [...,
    T] c64 or [..., T, 2] -> two [..., T]."""
    if fmt == "c64":
        return iq.real, iq.imag
    x = iq.to(torch.float32)
    if fmt == "i16":
        return x[..., 0] * (1.0 / 32768.0), x[..., 1] * (1.0 / 32768.0)
    if fmt == "u8":
        return ((x[..., 0] - 127.0) * (1.0 / 128.0),
                (x[..., 1] - 127.0) * (1.0 / 128.0))
    if fmt == "i8":
        return x[..., 0] * (1.0 / 128.0), x[..., 1] * (1.0 / 128.0)
    raise ValueError(f"unknown iq_format {fmt!r}")


def nco_index_steps(f: int, n0: int, q: int, n_first: int, count: int,
                    stride: int = THREADS) -> np.ndarray:
    """The NCO indices one kernel thread steps through: samples
    n_first + stride*v for v < count (a thread's window positions).  The
    first index is the exact (f * (n0 + n)) mod q in 64-bit floor-mod
    arithmetic; every later one is one 32-bit add of (f * stride) mod q and
    one conditional subtract, as in csrc/frontend.cu.  Returns int64
    [count]."""
    fq = f % q
    idx = (fq * ((n0 + n_first) % q)) % q
    step = (fq * (stride % q)) % q
    out = np.empty(count, np.int64)
    for v in range(count):
        out[v] = idx
        idx += step
        assert idx < 2 ** 32
        idx = idx - q if idx >= q else idx
    return out


def frontend_plain(iq, fmt, carry, taps, lgain, rgain, rf_dc, lo_freq,
                   n0_mod, dc_remove: bool, rate: int = C.INPUT_RATE,
                   partials: bool = False):
    """The front end in torch ops: gains, DC subsample mean, DC correction,
    mix_lo, fir_decimate ÷12.  Returns (v [T/12] complex64, new_carry
    [306] complex64, mean of the x[::64] subsample after the gains — the
    subsample itself with `partials`, None when dc_remove is off).  Every
    argument may carry leading rows (iq [..., T(, 2)], carry [..., 306],
    the scalars [...]), each row its own block and station."""
    re, im = decode_wire(iq, fmt)
    x = torch.complex(re * lgain[..., None], im * rgain[..., None])
    dc_mean = None
    if dc_remove:
        lim = C.RF_DC_LIMIT
        corr = torch.complex(rf_dc.real.clamp(-lim, lim),
                             rf_dc.imag.clamp(-lim, lim))
        dc_mean = (x[..., ::DC_SUBSAMPLE].contiguous() if partials
                   else x[..., ::DC_SUBSAMPLE].mean(-1))
        x = x - corr[..., None]
    x = B.mix_lo(x, lo_freq, rate, n0_mod)
    v, new_carry = B.fir_decimate(x, taps, DECIM, carry)
    return v, new_carry, dc_mean


# input samples a pass of frontend_rows_plain (at least one row): bounds its
# intermediates (a band scan's 76 rows of a 1.5 M-sample block would hold
# ~1 GB in each)
PLAIN_ROW_SAMPLES = 1 << 23


def frontend_rows_plain(wire, fmt, block_index, carry, taps, lgain, rgain,
                        rf_dc, lo_freq, n0_mod, dc_remove: bool,
                        rate: int = C.INPUT_RATE, partials: bool = False):
    """`frontend_plain` over R rows, a pass for each run of rows of at most
    PLAIN_ROW_SAMPLES input samples: row r on wire block block_index[r]
    with its own carry[r], gains, rf_dc, lo_freq and n0_mod.  Returns (v
    [R, T/12], new_carry [R, 306], dc_mean [R] or None; with `partials`
    each row's raw subsample [R, n] in place of dc_mean).  Each row is
    `frontend_plain` on that row bit for bit."""
    k = max(1, PLAIN_ROW_SAMPLES // wire.shape[1])
    outs = []
    for lo in range(0, block_index.shape[0], k):
        r = slice(lo, lo + k)
        outs.append(frontend_plain(
            wire.index_select(0, block_index[r]), fmt, carry[r], taps,
            lgain[r], rgain[r], rf_dc[r], lo_freq[r], n0_mod[r], dc_remove,
            rate, partials))
    v, new_carry, dc = zip(*outs)
    return (torch.cat(v), torch.cat(new_carry),
            torch.cat(dc) if dc_remove else None)


def dc_mean_of_tiles(sums: torch.Tensor, n_sub: int) -> torch.Tensor:
    """The kernel's last-ticket reduction in torch ops: lane l of one warp
    adds the tile sums l, l+32, ... in order, a xor butterfly adds the 32
    lanes, and the sum divides by the n_sub subsample points.  sums [n, 2]
    f32 (the tiles of a block, in order).  Every add and the division are
    single IEEE operations, so the mean is the kernel's bit for bit.
    sums may carry leading rows ([..., n, 2], each row its own block).
    Returns the mean as a complex64 [...]."""
    lead, n = sums.shape[:-2], sums.shape[-2]
    lanes = torch.zeros(lead + ((-(-n // 32)) * 32, 2), dtype=torch.float32,
                        device=sums.device)
    lanes[..., :n, :] = sums
    lanes = lanes.view(lead + (-1, 32, 2))
    s = torch.zeros(lead + (32, 2), dtype=torch.float32, device=sums.device)
    for r in range(lanes.shape[-3]):
        s = s + lanes[..., r, :, :]
    lane = torch.arange(32, device=sums.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ off, :]
    m = s[..., 0, :] / torch.full_like(s[..., 0, :], float(n_sub))
    return torch.complex(m[..., 0], m[..., 1])


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"frontend: {name} is on {t.device}, iq on {device}")
    if t.dtype != dtype:
        raise TypeError(f"frontend: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"frontend: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"frontend: {name} must be contiguous")


class FrontendKernel:
    """Callable wrapper with a launch counter.  `launches` counts eager
    launches and captures into a CUDA graph, not a graph's replays; CPU
    calls of the plain version do not count.  `frontend(...)` is one
    station on one block; `frontend.rows(...)` is R rows in one launch.

    Safe to replay from a CUDA graph as it stands: the outputs and the DC
    partial sums are allocated per call, and the DC tickets are persistent
    but each row's last tile leaves its ticket at 0, so no launch argument
    changes between replays and no buffer a graph holds is freed (ticket
    words outgrown by a larger R are kept, not freed)."""

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._tickets = {}        # device -> the DC reduction's tickets
        self._outgrown = []       # earlier tickets a graph may still hold
        self._zero_index = {}     # (device, n) -> int32 [n] zeros

    def _entry(self):
        if self._fn is None:
            lib = build.load(SOURCE)
            fn = lib.sdr_frontend_rows
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                            ctypes.c_int, ctypes.c_int]
                           + [ctypes.c_void_p] * 8
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                           + [ctypes.c_void_p] * 6)
            fn.restype = ctypes.c_int
            if lib.sdr_frontend_tile() != TILE:
                raise RuntimeError("frontend: csrc TILE != wrapper TILE")
            self._fn = fn
        return self._fn

    def _ticket_words(self, dev, rows: int) -> torch.Tensor:
        t = self._tickets.get(dev)
        if t is None or t.numel() < rows:
            if t is not None:
                self._outgrown.append(t)
            # zeroed once; each row's last tile leaves its word at 0
            t = torch.zeros(max(rows, 64), dtype=torch.int32, device=dev)
            self._tickets[dev] = t
        return t

    def __call__(self, iq: torch.Tensor, fmt: str, carry: torch.Tensor,
                 taps: torch.Tensor, lgain: torch.Tensor, rgain: torch.Tensor,
                 rf_dc: torch.Tensor, lo_freq: torch.Tensor,
                 n0_mod: torch.Tensor, dc_remove: bool,
                 rate: int = C.INPUT_RATE, partials: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
        """One station on one block: iq [T] c64 or [T, 2], 0-dim gains,
        rf_dc, lo_freq and n0_mod, carry [306].  Returns (v [T/12],
        new_carry [306], dc_mean or None); with `partials` the third is
        the DC partials for `dc_mean` (the per-tile sums [tiles, 2] f32 on
        the card, the raw subsample on the CPU)."""
        if iq.device.type == "cpu":
            return frontend_plain(iq, fmt, carry, taps, lgain, rgain, rf_dc,
                                  lo_freq, n0_mod, dc_remove, rate, partials)
        one = lambda t: t.reshape(1) if t.dim() == 0 else t  # noqa: E731
        y, nc, dm = self.rows(iq.unsqueeze(0), fmt,
                              self.zero_index(1, iq.device),
                              carry.reshape(1, -1), taps, one(lgain),
                              one(rgain), one(rf_dc), one(lo_freq),
                              one(n0_mod), dc_remove, rate, partials)
        return y[0], nc[0], None if dm is None else dm[0]

    def zero_index(self, n: int, device) -> torch.Tensor:
        """The block index of n rows on one shared block: int32 [n] zeros,
        made once per (device, n) and kept, so a step fills nothing."""
        key = (torch.device(device), n)
        idx = self._zero_index.get(key)
        if idx is None:
            idx = torch.zeros(n, dtype=torch.int32, device=device)
            self._zero_index[key] = idx
        return idx

    def rows(self, wire: torch.Tensor, fmt: str, block_index: torch.Tensor,
             carry: torch.Tensor, taps: torch.Tensor, lgain: torch.Tensor,
             rgain: torch.Tensor, rf_dc: torch.Tensor, lo_freq: torch.Tensor,
             n0_mod: torch.Tensor, dc_remove: bool, rate: int = C.INPUT_RATE,
             partials: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """R rows in one launch: wire [NB, T] c64 or [NB, T, 2], block_index
        int32 [R] (row r reads wire block block_index[r]; on the card an
        index outside [0, NB) gives that row NaN outputs, on the CPU it
        raises), carry [R, 306], lgain, rgain, rf_dc, lo_freq, n0_mod [R].
        Returns (v [R, T/12], new_carry [R, 306], dc_mean [R] or None;
        with `partials` the DC partials in place of dc_mean: the per-tile
        sums [R, tiles, 2] f32 on the card, each row's raw subsample [R, n]
        on the CPU)."""
        if wire.device.type == "cpu":
            return frontend_rows_plain(wire, fmt, block_index, carry, taps,
                                       lgain, rgain, rf_dc, lo_freq, n0_mod,
                                       dc_remove, rate, partials)
        if wire.device.type != "cuda":
            raise ValueError(f"frontend: unsupported device {wire.device}")
        if fmt not in WIRE_FORMATS:
            raise ValueError(f"unknown iq_format {fmt!r}")
        code, dtype = WIRE_FORMATS[fmt]
        if wire.dim() != (2 if fmt == "c64" else 3):
            raise ValueError(f"frontend: wire must be [blocks, T"
                             f"{'' if fmt == 'c64' else ', 2'}], got "
                             f"{tuple(wire.shape)}")
        NB, T = wire.shape[0], wire.shape[1]
        R = block_index.shape[0] if block_index.dim() == 1 else -1
        dev = wire.device
        _check(wire, "iq", dtype, (NB, T) if fmt == "c64" else (NB, T, 2),
               dev)
        if T % DECIM or not HALO <= T <= MAX_T:
            raise ValueError(f"frontend: block length {T} must be a multiple "
                             f"of {DECIM} in [{HALO}, {MAX_T}]")
        if not 1 <= R < 2 ** 31 or not 1 <= NB < 2 ** 31:
            raise ValueError(f"frontend: {R} rows on {NB} blocks")
        if wire.data_ptr() % (8 if fmt == "c64" else 4 if fmt == "i16"
                              else 2):
            raise ValueError("frontend: iq is not aligned to its sample size")
        if not 0 < rate < 2 ** 31 // 512:
            raise ValueError(f"frontend: rate {rate} out of range")
        _check(block_index, "block_index", torch.int32, (R,), dev)
        _check(carry, "carry", torch.complex64, (R, HALO), dev)
        _check(taps, "taps", torch.float32, (NTAPS,), dev)
        _check(lgain, "lgain", torch.float32, (R,), dev)
        _check(rgain, "rgain", torch.float32, (R,), dev)
        _check(rf_dc, "rf_dc", torch.complex64, (R,), dev)
        _check(lo_freq, "lo_freq", torch.int32, (R,), dev)
        _check(n0_mod, "n0_mod", torch.int32, (R,), dev)
        M = T // DECIM
        y = torch.empty((R, M), dtype=torch.complex64, device=dev)
        new_carry = torch.empty((R, HALO), dtype=torch.complex64, device=dev)
        part = ticket = dc_mean = None
        if dc_remove:
            part = torch.empty((R, (M + TILE - 1) // TILE, 2),
                               dtype=torch.float32, device=dev)
            dc_mean = torch.empty(R, dtype=torch.complex64, device=dev)
            ticket = self._ticket_words(dev, R)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        w_rad = float(np.float32(2.0 * np.pi / rate))
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = self._entry()(
                wire.data_ptr(), code, T, NB, R, block_index.data_ptr(),
                carry.data_ptr(), taps.data_ptr(), lgain.data_ptr(),
                rgain.data_ptr(), rf_dc.data_ptr(), lo_freq.data_ptr(),
                n0_mod.data_ptr(), int(dc_remove), int(rate), w_rad,
                y.data_ptr(), new_carry.data_ptr(), ptr(part), ptr(ticket),
                ptr(dc_mean), stream)
        if rc != 0:
            raise RuntimeError(f"frontend kernel launch failed: CUDA error "
                               f"{rc}")
        self.launches += 1
        return y, new_carry, part if partials else dc_mean


frontend = FrontendKernel()
frontend_rows = frontend.rows
