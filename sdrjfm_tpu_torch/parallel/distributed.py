"""The time axis and the distributed building blocks of the sharded chain
(port of sdrjfm_tpu.parallel.distributed).

JAX shards a block with `shard_map` over a mesh axis, one controller for
every device.  PyTorch runs one process per rank, so the port's axis is a
process group: `TimeAxis` holds the group, this rank's `index` in it, its
`size` and the rank's device, and offers the two collectives the chain
needs:

  left_halo   : the ring-neighbour exchange of JAX's `ppermute` — rank d
                receives the tail of rank d-1, rank 0 keeps its carry
  all_gather  : one tensor from every rank, rows in rank order

Transport, chosen where the group is made (`init_time_axis`):

  nccl  — each rank on a card of its own: device tensors directly
  gloo  — on the CPU: host tensors directly
  gloo  — ranks that SHARE one card (NCCL refuses two ranks on a device,
          and gloo's CUDA support covers only a few collectives): every
          collective's tensor is copied to the host, exchanged, and copied
          back.  The copies are counted (`counts['host_copy']`) and the
          mode is named by `transport`.  It is never chosen where every
          rank has a card of its own.

Each tensor travels as its bytes, so any dtype crosses any backend.

The helpers below are the per-rank halves of the JAX helpers, called by
every rank of the axis with its own slice:

  dist_fir / dist_fir_decimate / dist_fft_filter(_multi) /
  dist_fir_interpolate : the single-device primitive on [halo, slice]
  dist_linrec / dist_ema : y[n] = g*y[n-1] + d[n] across ranks — the local
                free response (the scan kernel from a zero entry state),
                the gathered last free samples folded in rank order into
                this rank's entry state (the same scalar loop on every
                rank), plus g^(n+1) times that state
  dist_linrec2 / dist_ema2 : two of those sharing one gather
  dist_linrec_multi / dist_iir(_many) : complex pole banks (kernel A) the
                same way; the entry-state term is a second launch of the
                pole bank on a zero drive from the folded states
  dist_runlength : consecutive-true run length across ranks
  pack_f32 / unpack_rows / fused_gather : many small tensors in ONE gather

Every collective that fails raises; a step never continues on a partial
result.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.linrec import pole_bank, pole_bank_constants
from ..ops import blockops as B

Tensor = torch.Tensor

COUNTED = ("gather", "halo", "host_copy")


def rank_device(rank: int, device=None) -> torch.device:
    """The device of global rank `rank`: `device` when given ("cpu", or a
    CUDA device), else the CUDA card rank % device_count.  Raises when CUDA
    is asked for and there is no card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: CUDA is not available; pass "
                           f"device='cpu' to run the ranks on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(world: int, device) -> str:
    """nccl when every one of `world` ranks has a card of its own, else
    gloo (on the CPU, or ranks sharing cards through host-staged
    collectives)."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def init_time_axis(rank: int, world: int, store, device=None) -> "TimeAxis":
    """Join the world group (rank `rank` of `world`, rendezvous through
    `store`: a FileStore, TCPStore or an `init_method` URL string) and
    return its TimeAxis, over the backend `backend_for` picks; rank 0 says
    on stderr when the ranks share cards (host-staged collectives)."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend_for(world, dev), rank=rank, world_size=world)
    if isinstance(store, str):
        kw["init_method"] = store
    else:
        kw["store"] = store
    dist.init_process_group(**kw)
    axis = TimeAxis(device=dev)
    if axis.host_staged and rank == 0:
        print(f"time axis: {world} ranks on {torch.cuda.device_count()} "
              f"card(s), {axis.transport}", file=sys.stderr, flush=True)
    return axis


def _bytes(t: Tensor) -> Tensor:
    t = t.contiguous().reshape(-1)
    if t.numel() and t.stride(0) != 1:
        # a one-element view (one station's last sample) keeps its
        # parent's stride, which a byte view refuses
        t = t.clone(memory_format=torch.contiguous_format)
    return t.view(torch.uint8)


class TimeAxis:
    """One time axis: the ranks of `group` (None: the world), rank `index`
    holding the index-th contiguous slice of each block on `device`.

    `counts` counts this rank's collectives ('gather', 'halo') and the
    host copies of the shared-card mode ('host_copy'); `seconds` is the
    host time spent inside collectives (with the staged copies' device
    synchronisation).  Both accumulate until `reset_counts`."""

    def __init__(self, group=None, device=None):
        if not dist.is_initialized():
            raise RuntimeError("TimeAxis: torch.distributed is not "
                               "initialised (see init_time_axis)")
        self.group = group
        self.index = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group)).lower()
        self.device = rank_device(dist.get_rank(), device)
        if self.device.type == "cpu":
            if self.backend != "gloo":
                raise ValueError(f"TimeAxis: CPU ranks need gloo, the group "
                                 f"uses {self.backend}")
            self.host_staged = False
        elif self.backend == "nccl":
            self.host_staged = False
        elif self.backend == "gloo":
            self.host_staged = True
        else:
            raise ValueError(f"TimeAxis: unsupported backend {self.backend}")
        self.transport = ("gloo, host-staged CUDA tensors" if self.host_staged
                          else self.backend)
        self._global = [i if group is None else dist.get_global_rank(group, i)
                        for i in range(self.size)]
        self._cache: Dict[object, object] = {}
        self.reset_counts()

    def reset_counts(self) -> None:
        self.counts = dict.fromkeys(COUNTED, 0)
        self.seconds = 0.0

    def cached(self, key, build: Callable[[], object]):
        """A device constant of this rank, built at its first use."""
        v = self._cache.get(key)
        if v is None:
            v = build()
            self._cache[key] = v
        return v

    # -- transport ---------------------------------------------------------
    def _out(self, t: Tensor) -> Tensor:
        if self.host_staged:
            self.counts["host_copy"] += 1
            return t.cpu()
        return t

    def _in(self, t: Tensor) -> Tensor:
        if self.host_staged:
            self.counts["host_copy"] += 1
            return t.to(self.device)
        return t

    def from_left(self, tail: Tensor) -> Optional[Tensor]:
        """Send `tail` to the right neighbour and receive the left one's
        (every rank passes a tail of the same shape and dtype).  Returns
        the received tensor on the axis's device, None on rank 0."""
        t0 = time.perf_counter()
        d, P = self.index, self.size
        send = self._out(_bytes(tail)) if d < P - 1 else None
        recv = (torch.empty(tail.numel() * tail.element_size(),
                            dtype=torch.uint8,
                            device="cpu" if self.host_staged else self.device)
                if d > 0 else None)
        if self.backend == "nccl":
            ops = []
            if send is not None:
                ops.append(dist.P2POp(dist.isend, send, self._global[d + 1],
                                      self.group))
            if recv is not None:
                ops.append(dist.P2POp(dist.irecv, recv, self._global[d - 1],
                                      self.group))
            reqs = dist.batch_isend_irecv(ops) if ops else []
        else:
            reqs = []
            if send is not None:
                reqs.append(dist.isend(send, self._global[d + 1],
                                       group=self.group))
            if recv is not None:
                reqs.append(dist.irecv(recv, self._global[d - 1],
                                       group=self.group))
        for r in reqs:
            r.wait()
        self.counts["halo"] += 1
        out = None
        if recv is not None:
            out = self._in(recv).view(tail.dtype).reshape(tail.shape)
        self.seconds += time.perf_counter() - t0
        return out

    def left_halo(self, tail: Tensor, first_carry: Tensor) -> Tensor:
        """The left neighbour's `tail`; rank 0 takes `first_carry`.  The
        received tail is cast to the carry's dtype, so a real stream with a
        complex carry gives a halo of one dtype on every rank."""
        left = self.from_left(tail)
        return first_carry if left is None else left.to(first_carry.dtype)

    def all_gather(self, x: Tensor) -> Tensor:
        """[size, *x.shape]: row k is rank k's x."""
        t0 = time.perf_counter()
        b = self._out(_bytes(x))
        if self.backend == "nccl":
            out = torch.empty(self.size * b.numel(), dtype=torch.uint8,
                              device=b.device)
            dist.all_gather_into_tensor(out, b, group=self.group)
        else:
            parts = [torch.empty_like(b) for _ in range(self.size)]
            dist.all_gather(parts, b, group=self.group)
            out = torch.cat(parts)
        self.counts["gather"] += 1
        out = self._in(out).view(x.dtype).reshape((self.size,)
                                                  + tuple(x.shape))
        self.seconds += time.perf_counter() - t0
        return out


# ---------------------------------------------------------------------------
# Convolutions with a ring-neighbour halo
# ---------------------------------------------------------------------------


def left_halo(x_local: Tensor, halo_len: int, first_carry: Tensor,
              axis: TimeAxis) -> Tensor:
    """Tail of the left ring neighbour's slice ([..., halo_len] of every
    row of x_local [..., T] in one exchange); rank 0 takes
    `first_carry`."""
    return axis.left_halo(x_local[..., -halo_len:], first_carry)


def dist_fir(x_local: Tensor, kernel: Tensor, stream_carry: Tensor,
             axis: TimeAxis) -> Tuple[Tensor, Tensor]:
    """Sharded causal FIR; returns (y_local, candidate tail).  The stream
    carry for the next block is the last rank's tail: the caller gathers
    the candidates."""
    halo = left_halo(x_local, kernel.shape[0] - 1, stream_carry, axis)
    return B.fir_apply(x_local, kernel, halo)


def dist_fir_decimate(x_local: Tensor, kernel: Tensor, factor: int,
                      stream_carry: Tensor, axis: TimeAxis
                      ) -> Tuple[Tensor, Tensor]:
    halo = left_halo(x_local, kernel.shape[0] - 1, stream_carry, axis)
    return B.fir_decimate(x_local, kernel, factor, halo)


def dist_fft_filter(x_local: Tensor, response: Tensor, hop: int,
                    stream_carry: Tensor, axis: TimeAxis
                    ) -> Tuple[Tensor, Tensor]:
    halo = left_halo(x_local, response.shape[0] - hop, stream_carry, axis)
    return B.fft_filter_apply(x_local, response, hop, halo)


def dist_fft_filter_multi(x_local: Tensor, responses: Tensor, hop: int,
                          stream_carry: Tensor, axis: TimeAxis
                          ) -> Tuple[Tensor, Tensor]:
    """Sharded shared-forward-FFT filter bank: one halo of the shared input
    serves every response; returns (ys_local [M, T_local], candidate
    tail)."""
    halo = left_halo(x_local, responses.shape[1] - hop, stream_carry, axis)
    return B.fft_filter_apply_multi(x_local, responses, hop, halo)


def dist_fir_interpolate(x_local: Tensor, kernel: Tensor, factor: int,
                         stream_carry: Tensor, axis: TimeAxis
                         ) -> Tuple[Tensor, Tensor]:
    """Sharded polyphase interpolation: each rank emits factor*T_local
    outputs, so the ranks' outputs in order are the global stream.
    Returns (y_local, candidate tail)."""
    phases = (kernel.shape[0] + factor - 1) // factor
    halo = (left_halo(x_local, phases - 1, stream_carry, axis)
            if phases > 1 else stream_carry)
    return B.fir_interpolate(x_local, kernel, factor, halo)


# ---------------------------------------------------------------------------
# First-order recurrences: local free response + folded entry state
# ---------------------------------------------------------------------------


def _scalar(v, dtype, device) -> Tensor:
    if isinstance(v, Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def _fold(c: Tensor, G, lasts: Tensor, upto: int) -> Tensor:
    """c <- c*G + lasts[k] for k < upto: the state entering rank `upto`
    (the same loop, in rank order, on every rank)."""
    for k in range(upto):
        c = c * G + lasts[k]
    return c


def _linrec_finish(y_free: Tensor, g: float, y0, lasts: Tensor,
                   axis: TimeAxis) -> Tuple[Tensor, Tensor]:
    """Entry-state fold shared by dist_linrec and dist_linrec2: given the
    local free response [..., T] and the gathered last free samples [P,
    ...], return (y_local, y_final [...]).  G = g^T rounds once from
    float64; the decay g^(n+1) is an f32 power with an f32 exponent, as
    the JAX helper forms it."""
    T = y_free.shape[-1]
    gf = float(np.float32(g))
    G = float(np.float32(np.float64(gf) ** T))
    c0 = _scalar(y0, y_free.dtype, y_free.device)
    c_d = _fold(c0, G, lasts, axis.index)
    decay = torch.pow(gf, torch.arange(1, T + 1, dtype=torch.float32,
                                       device=y_free.device))
    return y_free + decay * c_d[..., None], _fold(c0, G, lasts, axis.size)


def dist_linrec(drive_local: Tensor, g: float, y0, axis: TimeAxis
                ) -> Tuple[Tensor, Tensor]:
    """y[n] = g*y[n-1] + drive[n] over the concatenated stream (real f32,
    [..., T_local], each row its own stream); y0 [...] enters rank 0.
    Returns (y_local, y_final), y_final the same on every rank.  With the local free response f (the scan kernel from a
    zero entry state) and G = g^T_local, rank d's entry state is
        c_d = G^d y0 + sum_{k<d} G^(d-1-k) f_k[-1],
    and y_local = f + g^(n+1) c_d."""
    zero = torch.zeros(drive_local.shape[:-1], dtype=torch.float32,
                       device=drive_local.device)
    y_free, _ = B.linrec_apply(drive_local, g, zero)
    lasts = axis.all_gather(y_free[..., -1].contiguous())    # [P, ...]
    return _linrec_finish(y_free, g, y0, lasts, axis)


def dist_ema(x_local: Tensor, alpha: float, y0, axis: TimeAxis):
    return dist_linrec(alpha * x_local, 1.0 - alpha, y0, axis)


def dist_linrec2(d1: Tensor, g1: float, y01, d2: Tensor, g2: float, y02,
                 axis: TimeAxis):
    """TWO independent first-order recurrences sharing ONE gather: both
    free responses in one launch of the scan kernel (two rows a stream
    row), both last samples in one [P, 2, ...] gather.  Equal to
    (dist_linrec(d1, g1, y01), dist_linrec(d2, g2, y02)).  Returns ((y1,
    f1), (y2, f2))."""
    from ..kernels.linrec import linrec
    drive = torch.stack([d1.to(torch.float32), d2.to(torch.float32)])
    T = drive.shape[-1]
    n = drive[0].numel() // T
    y_free, _ = linrec(drive.reshape(-1, T).contiguous(), [g1] * n + [g2] * n,
                       torch.zeros(2 * n, dtype=torch.float32,
                                   device=drive.device))
    y_free = y_free.view(drive.shape)
    lasts = axis.all_gather(y_free[..., -1].contiguous())   # [P, 2, ...]
    return (_linrec_finish(y_free[0], g1, y01, lasts[:, 0], axis),
            _linrec_finish(y_free[1], g2, y02, lasts[:, 1], axis))


def dist_ema2(x1: Tensor, a1: float, y01, x2: Tensor, a2: float, y02,
              axis: TimeAxis):
    """Two independent EMAs sharing one gather (see dist_linrec2)."""
    return dist_linrec2(a1 * x1, 1.0 - a1, y01, a2 * x2, 1.0 - a2, y02,
                        axis)


# ---------------------------------------------------------------------------
# Complex pole banks (kernel A) across ranks
# ---------------------------------------------------------------------------


class _Bank(NamedTuple):
    poles: np.ndarray
    residues: np.ndarray


def _powers(poles: Tensor, T: int) -> Tensor:
    """g^T of each pole ([B, P] complex64 on the poles' device), each
    rounded once from float64."""
    g = poles.cpu().numpy().astype(np.complex128)
    with np.errstate(under="ignore"):
        G = (g ** T).astype(np.complex64)
    return torch.as_tensor(G, device=poles.device)


def _bank_across(drives: Tensor, bank, w0: Tensor, axis: TimeAxis,
                 extra: Sequence[Tensor] = ()):
    """The pole bank over drives [B, T_local] f32 across the axis, bank b
    entering rank 0 from w0[b] ([B, P] complex64, padded).  One launch
    from a zero entry state gives the free responses and their end states;
    ONE gather carries the end states (and the `extra` tensors); the entry
    states are folded in rank order; a second launch on a zero drive from
    those states adds the entry-state term Re sum_p r_p g_p^(n+1) c_p.
    Returns (y [B, T_local], final states [B, P], gathered rows of
    `extra`)."""
    T = drives.shape[1]
    y_free, w_free = pole_bank(drives, bank, torch.zeros_like(w0))
    rows = fused_gather([w_free] + list(extra), axis)
    lasts = rows[0]                                         # [D, B, P]
    G = axis.cached(("pole powers", id(bank), T),
                    lambda: (bank, _powers(bank.poles, T)))[1]
    c_d = _fold(w0, G, lasts, axis.index)
    c_f = _fold(w0, G, lasts, axis.size)
    y_in, _ = pole_bank(torch.zeros_like(drives), bank, c_d.contiguous())
    return y_free + y_in, c_f, rows[1:]


def dist_linrec_multi(drive_local: Tensor, gs, y0s: Tensor,
                      axis: TimeAxis) -> Tuple[Tensor, Tensor]:
    """P first-order recurrences with complex decays sharing one real
    drive, across the axis: y_p[n] = gs[p] y_p[n-1] + drive[n], y0s [P]
    entering rank 0.  Returns (y_local [P, T_local] complex64, y_final [P],
    the same on every rank).  Each pole runs as two one-pole banks of the
    pole-bank kernel, residues 1 and -j, whose outputs are its real and
    imaginary parts."""
    dev = drive_local.device
    g = np.asarray(gs, np.complex64).reshape(-1)
    n = g.shape[0]
    bank = axis.cached(
        ("linrec_multi", g.tobytes(), str(dev)),
        lambda: pole_bank_constants(
            [_Bank(np.asarray([p]), np.asarray([r], np.complex64))
             for p in g for r in (1.0, -1j)], dev))
    drives = drive_local.to(torch.float32)[None].expand(2 * n, -1)
    y0 = y0s.to(torch.complex64).reshape(-1).repeat_interleave(2)[:, None]
    y, wf, _ = _bank_across(drives.contiguous(), bank, y0.contiguous(),
                            axis)
    return torch.complex(y[0::2], y[1::2]), wf[0::2, 0]


def dist_iir_many(xs: Sequence[Tensor], bank: B.IIRBank, states,
                  axis: TimeAxis) -> List[tuple]:
    """Several biquad cascades (blockops.iir_apply_many) across the axis:
    the numerator FIRs on a ring halo (one exchange when every cascade
    filters the same input), the pole banks through `_bank_across` in one
    gather with the numerators' candidate tails.  Returned states are the
    same on every rank (pole states by the fold, FIR history the last
    rank's tail), so they thread as the next block's carry.  The blocks
    may carry leading rows ([..., T_local], each row its own stream; every
    row's banks in the same launches and gather).  Returns [(y [...,
    T_local] f32, (pole states, numerator history))]."""
    shared = all(x is xs[0] for x in xs)
    ks = [num.shape[0] for num in bank.nums]
    left = None
    if shared and max(ks) > 1:
        left = axis.from_left(xs[0].to(torch.float32)[..., -(max(ks) - 1):])
    drives, tails = [], []
    for x, num, (_, fir_carry) in zip(xs, bank.nums, states):
        x = x.to(torch.float32)
        K = num.shape[0]
        if K > 1:
            if shared:
                halo = fir_carry if left is None else left[..., -(K - 1):]
            else:
                halo = left_halo(x, K - 1, fir_carry, axis)
            xb, tail = B.fir_apply(x, num, halo)
        else:
            xb, tail = x * num[0], fir_carry
        drives.append(xb)
        tails.append(tail)
    fir = [i for i, k in enumerate(ks) if k > 1]
    drive, folded, w0 = B.bank_rows(drives, bank, [w0 for w0, _ in states])
    y, wf, rows = _bank_across(drive, folded, w0, axis,
                               extra=[tails[i] for i in fir])
    for i, r in zip(fir, rows):
        tails[i] = r[-1]
    outs = B.bank_unrows(y, wf, bank.poles, drives[0].shape[:-1])
    return [(y_i, (w_i, tails[i])) for i, (y_i, w_i) in enumerate(outs)]


def dist_iir(x_local: Tensor, spec: B.IIRSpec, state, axis: TimeAxis):
    """Sharded biquad cascade (blockops.iir_apply across the axis); the
    design's device constants are built once per rank."""
    bank = axis.cached(("iir", id(spec), str(x_local.device)),
                       lambda: (spec, B.iir_bank([spec], x_local.device)))[1]
    return dist_iir_many([x_local], bank, [state], axis)[0]


# ---------------------------------------------------------------------------
# Packed gathers and the run length
# ---------------------------------------------------------------------------


def pack_f32(arrays: Sequence[Tensor]):
    """Flatten float32/complex64/bool/int tensors into one f32 vector.
    Returns (packed [total], specs) for `unpack_rows`.  Complex is stored as
    real and imaginary runs (lossless); bool and int32 are value-cast
    (exact for the small counters packed here).  Used to fuse many small
    per-rank collectives into ONE gather."""
    flats, specs = [], []
    for a in arrays:
        if a.is_complex():
            flats += [a.real.reshape(-1), a.imag.reshape(-1)]
        else:
            flats.append(a.to(torch.float32).reshape(-1))
        specs.append((tuple(a.shape), a.dtype, a.numel()))
    return torch.cat(flats), specs


def unpack_rows(g: Tensor, specs) -> List[Tensor]:
    """Invert `pack_f32` on a gathered [n_ranks, total] matrix: a list of
    [n_ranks, *shape] tensors in the original dtypes; row d holds rank d's
    values, so `rows[-1]` is the stream tail."""
    out, off = [], 0
    n = g.shape[0]
    for shape, dtype, size in specs:
        if dtype.is_complex:
            out.append(torch.complex(g[:, off:off + size],
                                     g[:, off + size:off + 2 * size])
                       .reshape((n,) + shape))
            off += 2 * size
        else:
            out.append(g[:, off:off + size].to(dtype).reshape((n,) + shape))
            off += size
    return out


def fused_gather(arrays: Sequence[Tensor], axis: TimeAxis) -> List[Tensor]:
    """ONE gather for a list of small per-rank tensors: the list of
    [n_ranks, *shape] rows (see unpack_rows), bit-identical to a gather
    per tensor."""
    packed, specs = pack_f32(arrays)
    return unpack_rows(axis.all_gather(packed), specs)


def dist_runlength(flags_local: Tensor, r0, axis: TimeAxis
                   ) -> Tuple[Tensor, Tensor]:
    """Consecutive-true run length across the axis (flags [..., T_local],
    each row its own run); r0 [...] enters rank 0.  Returns (rl_local
    int32, r_final int32, the same on every rank)."""
    T = flags_local.shape[-1]
    dev = flags_local.device
    rl_zero, _ = B.runlength_true(flags_local,
                                  torch.zeros(flags_local.shape[:-1],
                                              dtype=torch.int32, device=dev))
    pairs = axis.all_gather(torch.stack([
        flags_local.all(dim=-1).to(torch.int32),
        rl_zero[..., -1].to(torch.int32)]))

    def fold(upto):
        c = _scalar(r0, torch.int32, dev)
        for k in range(upto):
            c = torch.where(pairs[k, 0] == 1, c + T, pairs[k, 1])
        return c

    r_in = fold(axis.index)
    # the leading run of trues extends the incoming run
    lead = torch.cumsum(flags_local.to(torch.int32), -1) == torch.arange(
        1, T + 1, dtype=torch.int32, device=dev)
    rl = torch.where(flags_local & lead, rl_zero + r_in[..., None], rl_zero)
    return rl.to(torch.int32), fold(axis.size)
