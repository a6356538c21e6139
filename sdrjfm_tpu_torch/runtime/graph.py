"""`Receiver.step` captured as a CUDA graph: what `Receiver.jit_step()`
returns (and, for the n-station step of `models.multistation`, what
`MultiStationReceiver.jit_step()` replays).

This module has no counterpart module in the JAX package.  There, the
runners step `jax.jit(rx.step)` (`Receiver.jit_step`) or a `lax.scan` over
it, and XLA dispatches the compiled step as one program.  PyTorch dispatches
each of a step's ~1,700-2,000 device operations from Python, so the port
records the step once into a `torch.cuda.CUDAGraph` and replays it a block
at a time.

The tree helpers at the top (`tree_leaves`, `tree_rebuild`, `tree_index`,
`tree_stack`, `tree_broadcast`) are what the station axis is written with:
a state or controls tree with a leading [n] axis on every leaf.

`StepGraph` holds static device buffers for the wire block, the
`ReceiverState` leaves, the `Controls` leaves and the `Output` leaves.  A
call `step(state, controls, iq)`:

- copies a state leaf into its buffer unless the caller passed that buffer
  (as the previous call returned it), and a controls leaf unless the caller
  passed the buffer or the same tensor as in the previous call.  That is
  how `request_rds_resync`, `retune_reset` and a hook's new `Controls` take
  effect between replays.  Leaves are told apart by identity: replace a
  leaf (`_replace`), never write into a passed tensor in place;
- copies `iq` into the wire buffer unless `iq` is that buffer;
- replays the graph: the step, ending with the copy of the new state into
  the state buffers, so that one replay carries a block and leaves the
  state ready for the next;
- returns `(state, out)`, the state buffers and the output buffers.  Both
  are views that the next call overwrites: copy what you keep first.

On CUDA the first call warms the step up on a side stream (three steps on a
zero block fill cuFFT's plan cache, cuDNN's choice of `conv1d` algorithm and
every wrapper's cached constants), restores the state buffers, then
captures.  A failed capture raises: nothing falls back to eager steps.  On
the CPU the same body runs eagerly with the same buffers and copies: that
is the device the caller asked for, and it is how the CPU tests check the
plumbing.

`ScanGraph` (`StepGraph.scan(K)`) is the form the scan runners replay: one
graph that reads block `slot` of a [K, ...] chunk of wire blocks with
`index_select`, runs the step, writes the outputs into [K, ...] chunk
buffers with `index_copy_` and advances `slot`, an int64 counter on the
device.  A chunk is staged a range of blocks at a time (`stage_ranges`:
the most blocks that fit `STAGE_RANGE_BYTES`, at least one): the host
copies a range into its rows of one pinned buffer (with non-temporal
stores: `sdr_stream_copy` in `runtime/native/ingest.cc`), queues the
range's host-to-device copy and then its replays (`steps`), and goes on to
the next range while the card uploads and steps this one.  Then one `replay()`
a block is the only host call per block, and one fetch of each output
ends the chunk: on CUDA one DMA copy an output into pinned host memory
that the caller then owns (`fetch`).  Every range has rows of its own and
the fetch waits for the stream, so no pinned row is written while a copy
reads it; each range's upload is queued ahead of its replays on the one
stream, so a replay always reads a block that has arrived.  Small blocks
make one range of a whole chunk.  It shares the state and controls buffers with
its `StepGraph`, so the state threads through both.  Its warm-up steps set
the slot back to 0 after each step, so that a chunk of fewer blocks than
warm-up steps never indexes past its buffers.  A `StepGraph` keeps one
`ScanGraph`, the latest asked for.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.frontend import WIRE_FORMATS
from . import native_source, spans

Tensor = torch.Tensor

WARMUP_STEPS = 3
# The wire bytes of one staging range: about half a millisecond of the
# host's copy into pinned memory, so that the card starts on a chunk soon
# after the host does.
STAGE_RANGE_BYTES = 4 << 20


def tree_leaves(tree) -> List[Tensor]:
    """The tensors of a tree of (named) tuples, lists and dicts, in order;
    None and other constants have none."""
    out: List[Tensor] = []

    def walk(x):
        if isinstance(x, Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
    walk(tree)
    return out


def tree_rebuild(template, leaves):
    """`template` with its tensors replaced, in order, by `leaves`."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, Tensor):
            return next(it)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(build(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(build(v) for v in x)
        if isinstance(x, dict):
            return {k: build(v) for k, v in x.items()}
        return x
    return build(template)


def tree_clone(tree):
    """A copy of `tree` with every tensor cloned."""
    return tree_rebuild(tree, [t.clone() for t in tree_leaves(tree)])


def tree_index(tree, i: int):
    """`tree` with every tensor replaced by its row i (a view)."""
    return tree_rebuild(tree, [t[i] for t in tree_leaves(tree)])


def tree_stack(trees):
    """One tree of the same structure as each of `trees`, every tensor
    stacked along a new leading axis (the trees' None leaves stay None)."""
    cols = zip(*(tree_leaves(t) for t in trees))
    return tree_rebuild(trees[0], [torch.stack(c) for c in cols])


def tree_broadcast(tree, n: int):
    """`tree` with every tensor repeated along a new leading [n] axis (a
    contiguous copy, so each row can be written on its own)."""
    return tree_rebuild(tree, [t.unsqueeze(0).expand(n, *t.shape).clone()
                               for t in tree_leaves(tree)])


def upload(value, dtype: torch.dtype, device) -> Tensor:
    """A new tensor of host `value` on `device`, queued without waiting
    for the card: on CUDA from pinned memory with non_blocking=True (a
    plain `torch.tensor(..., device=)` copies from pageable memory and
    waits).  For the leaves that the host hands a captured step between
    replays (controls, state resets)."""
    t = torch.tensor(value, dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def wire_shape(cfg):
    T = cfg.wire_len
    return (T,) if cfg.iq_format == "c64" else (T, 2)


def wire_dtype(cfg) -> torch.dtype:
    return WIRE_FORMATS[cfg.iq_format][1]


def stage_ranges(block_bytes: int, k: int) -> List[Tuple[int, int]]:
    """The ranges (first block, blocks) in which `ScanGraph` stages a chunk
    of k blocks of `block_bytes` wire bytes each: in order, covering [0, k)
    with no gap or overlap, each the most blocks that fit
    STAGE_RANGE_BYTES and at least one."""
    per = max(1, STAGE_RANGE_BYTES // max(1, int(block_bytes)))
    return [(a, min(per, k - a)) for a in range(0, k, per)]


def _matches(bufs: List[Tensor], leaves: List[Tensor], what: str) -> None:
    if len(bufs) != len(leaves):
        raise ValueError(f"jit_step: the {what} has {len(leaves)} tensors, "
                         f"the receiver's has {len(bufs)}")


def _copy_leaf(buf: Tensor, v: Tensor, what: str) -> None:
    if v.shape != buf.shape or v.dtype != buf.dtype:
        raise ValueError(f"jit_step: a {what} leaf is {v.dtype} "
                         f"{tuple(v.shape)}, its buffer {buf.dtype} "
                         f"{tuple(buf.shape)}")
    buf.copy_(v)


class StepGraph:
    """`Receiver.step` with static buffers, replayed from a CUDA graph on
    the card and run eagerly on the CPU (see the module docstring).

    `rx` is any stepper with `cfg` (its wire block's shape and format),
    `device`, `init_state()`, `initial_controls()` and `step(state,
    controls, iq)`: a `Receiver`, or the n-station step of
    `models.multistation`."""

    def __init__(self, rx):
        self.rx = rx
        self.device = rx.device
        self.captures = self.device.type == "cuda"
        self.state = rx.init_state()
        self.controls = rx.initial_controls()
        self.iq = torch.zeros(wire_shape(rx.cfg), dtype=wire_dtype(rx.cfg),
                              device=self.device)
        self._state_bufs = tree_leaves(self.state)
        self._ctl_bufs = tree_leaves(self.controls)
        self._ctl_src = list(self._ctl_bufs)
        self._storages = {b.untyped_storage().data_ptr()
                          for b in self._state_bufs}
        self.out = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._scan: Optional["ScanGraph"] = None
        self.capture_s: Optional[float] = None

    # -- buffers --------------------------------------------------------
    def load(self, state=None, controls=None) -> None:
        """Copy the leaves of `state` and `controls` that are not already
        in the buffers (see the module docstring)."""
        if state is not None:
            leaves = tree_leaves(state)
            _matches(self._state_bufs, leaves, "state")
            for buf, v in zip(self._state_bufs, leaves):
                if v is not buf:
                    _copy_leaf(buf, v, "state")
        if controls is not None:
            leaves = tree_leaves(controls)
            _matches(self._ctl_bufs, leaves, "controls")
            for i, (buf, v) in enumerate(zip(self._ctl_bufs, leaves)):
                if v is not buf and v is not self._ctl_src[i]:
                    _copy_leaf(buf, v, "controls")
                    self._ctl_src[i] = v

    def _store_state(self, new_state) -> None:
        """The new state into the state buffers.  A new leaf that is a view
        of another state buffer is cloned first, so that no copy reads a
        buffer already overwritten."""
        new = tree_leaves(new_state)
        _matches(self._state_bufs, new, "new state")
        new = [n.clone() if n is not b and n.numel()
               and n.untyped_storage().data_ptr() in self._storages else n
               for b, n in zip(self._state_bufs, new)]
        for buf, n in zip(self._state_bufs, new):
            if n is not buf:
                buf.copy_(n)

    def step_body(self, iq: Tensor):
        """One step from the buffers on `iq`, the new state stored back;
        returns the step's Output."""
        new_state, out = self.rx.step(self.state, self.controls, iq)
        self._store_state(new_state)
        return out

    # -- capture --------------------------------------------------------
    def warm_up(self, body, reset=None) -> None:
        """Run `body` WARMUP_STEPS times (on a side stream on CUDA), calling
        `reset` after each run, then restore the state buffers.  `reset`
        puts back what the body advances besides the state (the chunk
        graph's slot), so that every warm-up run sees what the first replay
        will see."""
        dev = self.device
        saved = [b.clone() for b in self._state_bufs]
        side = torch.cuda.Stream(dev) if self.captures else None
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(dev))
        with (torch.cuda.stream(side) if side is not None
              else contextlib.nullcontext()):
            for _ in range(WARMUP_STEPS):
                body()
                if reset is not None:
                    reset()
        if side is not None:
            torch.cuda.current_stream(dev).wait_stream(side)
        for buf, s in zip(self._state_bufs, saved):
            buf.copy_(s)

    def capture(self, body, warm_reset=None):
        """Warm `body` up (`warm_up`), then capture it: the span
        `setup.capture`, counted in `graph.captures` (`runtime.spans`).
        Returns (graph, what the captured body returned, the span's
        seconds: warm-up, capture and instantiation)."""
        dev = self.device
        with spans.span("setup.capture") as sp:
            self.warm_up(body, warm_reset)
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            # A graph freed during a capture invalidates the capture: a dead
            # cycle that holds an earlier receiver's graph (a Receiver and
            # its StepGraph refer to each other) is freed by whichever
            # collector pass the capture's own allocations trigger, and
            # torch no longer collects before capturing.  So collect first,
            # and hold the collector off until the capture ends.
            gc.collect()
            was_enabled = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    ret = body()
            finally:
                if was_enabled:
                    gc.enable()
            torch.cuda.synchronize(dev)
        spans.count("graph.captures")
        return graph, ret, sp.seconds

    def prepare(self) -> None:
        """Capture the per-block graph now (on CUDA; nothing on the CPU),
        so that the first block does not pay for it."""
        if self.captures and self._graph is None:
            self.iq.zero_()               # the warm-up steps' zero block
            self._graph, self.out, self.capture_s = self.capture(
                lambda: self.step_body(self.iq))

    # -- the per-block step ---------------------------------------------
    def __call__(self, state, controls, iq: Tensor):
        self.prepare()
        self.load(state, controls)
        if iq is not self.iq:
            if iq.shape != self.iq.shape or iq.dtype != self.iq.dtype:
                raise ValueError(f"jit_step: iq block is {iq.dtype} "
                                 f"{tuple(iq.shape)}, want {self.iq.dtype} "
                                 f"{tuple(self.iq.shape)}")
            self.iq.copy_(iq, non_blocking=True)
        if self.captures:
            self._graph.replay()
        else:
            out = self.step_body(self.iq)
            if self.out is None:
                self.out = tree_clone(out)
            else:
                for buf, v in zip(tree_leaves(self.out), tree_leaves(out)):
                    buf.copy_(v)
        return self.state, self.out

    def scan(self, chunk_blocks: int, taps: bool = False) -> "ScanGraph":
        """The chunk graph for `chunk_blocks` blocks.  Only the latest one
        is kept: a call with another chunk size or `taps` drops the one
        before (after the device has finished with it) and captures anew.
        What stays on the device between calls is one chunk graph: its
        [chunk_blocks, wire] input (with a pinned host copy of the same
        size), its [chunk_blocks, ...] outputs and its graph's pool."""
        key = (int(chunk_blocks), bool(taps))
        sc = self._scan
        if sc is not None and (sc.K, sc.taps) == key:
            return sc
        if sc is not None and self.captures:
            torch.cuda.synchronize(self.device)
        self._scan = None             # freed before the new one allocates
        self._scan = ScanGraph(self, *key)
        return self._scan


def collected_outputs(out, taps: bool) -> Dict[str, Tensor]:
    """The Output leaves a scan runner collects, by name: the audio (and
    its PCM16 form), `meta_vec`, the RDS bits, counts and points, and the
    taps when asked for (`tap:<name>`)."""
    d = {"audio": out.audio, "meta_vec": out.meta_vec}
    if out.audio_i16 is not None:
        d["audio_i16"] = out.audio_i16
    if out.rds is not None:
        d.update(rds_bits=out.rds.bits, rds_count=out.rds.count,
                 rds_iq=out.rds.iq)
    if taps and out.taps:
        d.update({f"tap:{k}": v for k, v in out.taps.items()})
    return d


class ScanGraph:
    """One captured step that reads its block from a chunk buffer and
    writes its outputs into chunk buffers at a device-side slot counter,
    its chunk staged a range at a time (see the module docstring)."""

    def __init__(self, sg: StepGraph, chunk_blocks: int, taps: bool):
        if chunk_blocks < 1:
            raise ValueError(f"chunk_blocks must be >= 1, got {chunk_blocks}")
        self.sg = sg
        self.K = chunk_blocks
        self.taps = taps
        dev = sg.device
        self.inp = torch.zeros((chunk_blocks,) + tuple(sg.iq.shape),
                               dtype=sg.iq.dtype, device=dev)
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.outs: Optional[Dict[str, Tensor]] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._staging: Optional[Tensor] = None
        # recorded after each range's replays: still pending when the next
        # range's staging begins means the card had work the whole time
        self._queued = torch.cuda.Event() if sg.captures else None
        self.capture_s: Optional[float] = None

    def _body(self) -> None:
        iq = self.inp.index_select(0, self.slot).view(self.sg.iq.shape)
        got = collected_outputs(self.sg.step_body(iq), self.taps)
        if self.outs is None:
            self.outs = {k: torch.zeros((self.K,) + tuple(v.shape),
                                        dtype=v.dtype, device=v.device)
                         for k, v in got.items()}
        for k, v in got.items():
            self.outs[k].index_copy_(0, self.slot, v.unsqueeze(0))
        self.slot.add_(1)

    def load_blocks(self, blocks: np.ndarray, at: int = 0) -> None:
        """Stage k wire blocks ([k, ...] host array) as rows at..at+k-1 of
        the chunk, at + k <= K, and set the slot to 0 when `at` is 0: on
        CUDA through the same rows of a pinned host buffer (the native
        non-temporal copy, built at first use), the upload queued.  Span
        `scan.stage` (count k); counter `scan.stage_ranges`, and
        `scan.stage_overlapped` when a range after the first finds the card
        still on the previous range's replays."""
        k = blocks.shape[0]
        if not (0 <= at and 1 <= k <= self.K - at) \
                or blocks.shape[1:] != self.inp.shape[1:]:
            raise ValueError(f"scan graph: blocks of shape {blocks.shape} "
                             f"at chunk row {at}, want at most "
                             f"{tuple(self.inp.shape)}")
        with spans.span("scan.stage", count=k):
            rows = slice(at, at + k)
            if self.sg.captures:
                if at and not self._queued.query():
                    spans.count("scan.stage_overlapped")
                if self._staging is None:
                    self._staging = torch.empty(self.inp.shape,
                                                dtype=self.inp.dtype,
                                                pin_memory=True)
                dst = self._staging[rows].numpy()
                src = np.ascontiguousarray(blocks, dtype=dst.dtype)
                native_source.load_library().sdr_stream_copy(
                    dst.ctypes.data, src.ctypes.data, src.nbytes)
                self.inp[rows].copy_(self._staging[rows], non_blocking=True)
            else:
                self.inp[rows].numpy()[...] = blocks
            if at == 0:
                self.slot.zero_()
        spans.count("scan.stage_ranges")

    def prepare(self) -> None:
        """Capture the chunk graph (on CUDA; on the CPU the first step
        allocates the chunk outputs).  Its warm-up runs on the zero chunk
        it starts with, so call this before the first `load_blocks`."""
        if self.sg.captures and self._graph is None:
            self._graph, _, self.capture_s = self.sg.capture(
                self._body, warm_reset=self.slot.zero_)

    def step(self) -> None:
        """One block: the graph's replay on CUDA, the body on the CPU."""
        if self._graph is not None:
            self._graph.replay()
        else:
            self._body()

    def steps(self, n: int) -> None:
        """n blocks, the range just staged (span `scan.replays`, count n)."""
        with spans.span("scan.replays", count=n):
            for _ in range(n):
                self.step()
            if self._queued is not None:
                self._queued.record()

    def fetch(self, k: int) -> Dict[str, np.ndarray]:
        """The first k blocks of every chunk output, one transfer each:
        the wait for the chunk's replays (span `scan.fetch_wait`), then the
        copies down (span `scan.fetch_copy`, count the bytes).

        The arrays belong to the caller: no later fetch, staging or replay
        writes into them.  On CUDA each output comes down in one DMA copy
        into page-locked memory taken from torch's caching host allocator,
        and the array is a view of it: fetched arrays live in pinned memory
        until the caller drops them, and the allocator hands a dropped
        block to a later fetch, so that passes in a loop allocate nothing
        new once warm.  Counters `scan.fetch_pinned` (fetches into pinned
        memory) and `scan.fetch_host_allocs` (pinned blocks the allocator
        had to make for them).  On the CPU each output is copied once."""
        with spans.span("scan.fetch_wait"):
            if self.sg.captures:
                torch.cuda.current_stream(self.sg.device).synchronize()
        with spans.span("scan.fetch_copy",
                        count=sum(v[:k].nbytes for v in self.outs.values())):
            if not self.sg.captures:
                return {name: v[:k].cpu().numpy().copy()
                        for name, v in self.outs.items()}
            made = _host_allocs()
            got = {}
            for name, v in self.outs.items():
                got[name] = torch.empty(v[:k].shape, dtype=v.dtype,
                                        pin_memory=True)
                got[name].copy_(v[:k], non_blocking=True)
            copied = torch.cuda.Event()         # one wait for every copy
            copied.record(torch.cuda.current_stream(self.sg.device))
            copied.synchronize()
            spans.count("scan.fetch_pinned")
            spans.count("scan.fetch_host_allocs", _host_allocs() - made)
            return {name: t.numpy() for name, t in got.items()}


def _host_allocs() -> int:
    """The pinned blocks torch's caching host allocator has made (each a
    cudaHostAlloc; a block it hands out again does not count)."""
    return int(torch.cuda.host_memory_stats()["num_host_alloc"])
