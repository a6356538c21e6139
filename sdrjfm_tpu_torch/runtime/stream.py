"""Offline, streaming and live drivers for the block receiver (port of
sdrjfm_tpu.runtime.stream).

- `run_offline` feeds the capture through `Receiver.jit_step()` block by
  block, with the host hooks between blocks.  Per block it fetches one
  packed vector from the device (`Output.meta_vec`: the metadata scalars
  and the RDS bit count); the audio and the RDS bits stay on the device
  until the run ends and come back in one transfer each.
- `run_offline_scan` / `run_offline_scanned`, the throughput path: chunks of
  blocks staged on the device once, the captured step replayed once a block
  (`runtime.graph.ScanGraph`), every output fetched once a chunk, all
  through `runtime.graph.drive_chunks`.  The JAX runners dispatch one
  `lax.scan` a chunk instead.
- `run_streaming`, per-block callbacks through `Receiver.jit_step()` with
  block k+1's upload overlapping block k's compute, or chunks of the scan
  machinery with the callbacks fired a block at a time.
- `run_live`, the same step over a streaming source's ring
  (runtime.native_source), delivering block k before it waits for k+1.

Every runner steps through `Receiver.jit_step()` (the scan runners through
its chunk form), whose outputs are views that the next call overwrites:
they copy what they keep.  On a CPU receiver the same code runs with the
step's eager body.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.receiver import (BitBlock, Controls, Meta, Output, Receiver,
                               meta_dict_from_vec)
from . import spans
from .graph import (drive_chunks, tree_clone, wire_blocks, wire_dtype,
                    wire_np_dtype, wire_shape)


def _nblocks(iq, cfg) -> int:
    n = len(iq) // cfg.wire_len
    if n <= 0:
        raise ValueError(f"need at least {cfg.wire_len} samples, got "
                         f"{len(iq)}")
    return n


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t` that no later step overwrites."""
    return t.detach().to("cpu", copy=True).numpy()


@dataclass
class StreamResult:
    audio: np.ndarray                 # [n, 2] float32 at working rate
    meta: List[dict] = field(default_factory=list)
    rds_bits: Optional[np.ndarray] = None
    rds_iq: Optional[np.ndarray] = None
    taps: dict = field(default_factory=dict)
    final_state: object = None
    dropped_total: int = 0            # ingest overrun drops (live sources)
    arrival_timed: int = 0            # live blocks whose latency_ms starts
                                      # at the ring's arrival stamp


# ---------------------------------------------------------------------------
# Host <-> device staging
# ---------------------------------------------------------------------------

class _Uploader:
    """Wire blocks to the device through two pinned host buffers and two
    device buffers, on a side stream: an upload waits for the compute
    stream to be done with its device buffer (`release`), and the compute
    stream waits for the upload (`take`).  On the CPU a block is a tensor
    copy of the host array."""

    def __init__(self, cfg, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.np_dtype = wire_np_dtype(cfg)
        self.i = 0
        if self.cuda:
            shape, dt = wire_shape(cfg), wire_dtype(cfg)
            self.host = [torch.empty(shape, dtype=dt, pin_memory=True)
                         for _ in range(2)]
            self.dev = [torch.empty(shape, dtype=dt, device=device)
                        for _ in range(2)]
            self.stream = torch.cuda.Stream(device)
            self.copied = [None, None]
            self.used = [None, None]

    def put(self, blk: np.ndarray):
        """Start the upload of one block; returns its token."""
        blk = np.asarray(blk, self.np_dtype)
        if not self.cuda:
            return torch.from_numpy(blk.copy())
        i, self.i = self.i, self.i ^ 1
        if self.copied[i] is not None:
            self.copied[i].synchronize()          # its pinned buffer is free
        self.host[i].numpy()[...] = blk
        with torch.cuda.stream(self.stream):
            if self.used[i] is not None:
                self.stream.wait_event(self.used[i])
            self.dev[i].copy_(self.host[i], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.copied[i] = ev
        return i

    def take(self, tok) -> torch.Tensor:
        """The uploaded block, ordered after its upload on the current
        stream."""
        if not self.cuda:
            return tok
        torch.cuda.current_stream(self.device).wait_event(self.copied[tok])
        return self.dev[tok]

    def release(self, tok) -> None:
        """The current stream has queued its last read of the block."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.used[tok] = ev


class _Fetch:
    """Device-to-host copies of a block's outputs, started as soon as they
    are queued (into pinned buffers, reused block after block) and waited
    for when the host reads them."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.pinned: Dict[str, torch.Tensor] = {}
        self.pending: Dict[str, torch.Tensor] = {}
        self.event = None

    def start(self, tensors: Dict[str, torch.Tensor]) -> None:
        self.pending = {}
        for k, t in tensors.items():
            if not self.cuda:
                self.pending[k] = t
                continue
            buf = self.pinned.get(k)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self.pinned[k] = buf
            buf.copy_(t, non_blocking=True)
            self.pending[k] = buf
        if self.cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> Dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return {k: t.numpy().copy() for k, t in self.pending.items()}


def _block_outputs(out: Output, want_meta: bool, keep_iq: bool):
    """What a per-block runner fetches of one block's Output, under
    `Output.for_host`'s names: the PCM16 audio in place of the float audio
    where the step makes it, `meta_vec` when wanted or with RDS (it holds
    the bits' count), the bits, and their points when kept."""
    d = out.for_host()
    d.pop("rds_count", None)
    if "audio_i16" in d:
        del d["audio"]
    if not (want_meta or "rds_bits" in d):
        del d["meta_vec"]
    if not keep_iq:
        d.pop("rds_iq", None)
    return d


def _audio(got: dict, pcm: bool) -> np.ndarray:
    """The audio of fetched outputs: `audio_i16` where asked for and made,
    else `audio`."""
    return got["audio_i16"] if pcm and "audio_i16" in got else got["audio"]


def _result(audio_acc, metas, bits_acc, biq_acc, state, taps=None
            ) -> StreamResult:
    res = StreamResult(
        audio=(np.concatenate(audio_acc, axis=0) if audio_acc
               else np.zeros((0, 2), np.float32)),
        meta=metas, final_state=state)
    if bits_acc:
        res.rds_bits = np.concatenate(bits_acc)
        res.rds_iq = np.concatenate(biq_acc)
    if taps:
        res.taps = {k: np.concatenate(v) for k, v in taps.items()}
    return res


# ---------------------------------------------------------------------------
# Scan runners
# ---------------------------------------------------------------------------

_passes = itertools.count()       # the id of each scan runner's pass


def _scan_chunks(rx: Receiver, iq: np.ndarray, controls, init_state,
                 chunk_blocks: Optional[int], taps: bool):
    """The capture through the receiver's chunk graph: span `scan.load`
    (the chunk graph, the initial state and controls), then the chunks of
    `graph.drive_chunks` as (first block, {output: [k, ...] host array}),
    k <= chunk_blocks blocks (all blocks in one chunk when chunk_blocks is
    None), with their spans.  rx.jit_step().state holds the final state
    once the last chunk has been read."""
    with spans.span("scan.load"):
        nblocks = _nblocks(iq, rx.cfg)
        K = nblocks if chunk_blocks is None else int(chunk_blocks)
        wire = wire_blocks(iq, rx.cfg, nblocks)
        sg = rx.jit_step()
        sc = sg.scan(min(K, nblocks), taps)
        sc.prepare()
        sg.load(init_state if init_state is not None else rx.init_state(),
                controls if controls is not None else rx.initial_controls())
    return ((lo, got) for lo, (got,) in drive_chunks([sc], wire))


def _blocks_of(chunks, drop_blocks: int, pcm: bool):
    """Each block of fetched chunks from block drop_blocks on, in order:
    (audio (`_audio`), meta_vec, the RDS bits and their points up to the
    block's count or None and None without RDS, {tap: samples})."""
    for lo, got in chunks:
        audio = _audio(got, pcm)
        taps = {k[4:]: v for k, v in got.items() if k.startswith("tap:")}
        for j in range(max(0, drop_blocks - lo), audio.shape[0]):
            bits = biq = None
            if "rds_bits" in got:
                n = int(got["rds_count"][j])
                bits, biq = got["rds_bits"][j, :n], got["rds_iq"][j, :n]
            yield (audio[j], got["meta_vec"][j], bits, biq,
                   {k: v[j].reshape(-1) for k, v in taps.items()})


def run_offline_scan(rx: Receiver, iq: np.ndarray,
                     controls: Optional[Controls] = None,
                     init_state=None):
    """The whole capture as one chunk of the captured step (the port's
    counterpart of JAX's single `lax.scan` dispatch): one upload, one
    replay a block, one fetch of each output.  Returns (final_state, the
    stacked Output): every field with a leading block axis, as CPU
    tensors fetched once (Meta from the meta_vec columns; the taps when
    cfg.emit_taps).  The pass is a span `scan.pass`, its host outputs'
    assembly `scan.assemble`."""
    with spans.span("scan.pass", id=next(_passes),
                    count=len(iq) // rx.cfg.wire_len):
        (_, got), = _scan_chunks(rx, iq, controls, init_state, None,
                                 rx.cfg.emit_taps)
        with spans.span("scan.assemble"):
            final = tree_clone(rx.jit_step().state)
            t = {k: torch.from_numpy(v) for k, v in got.items()}
            mv = t["meta_vec"]
            meta = Meta(*(mv[:, i].to(torch.bool)
                          if name in ("pilot_locked", "pss_established")
                          else mv[:, i]
                          for i, name in enumerate(Meta._fields)))
            rds = None
            if "rds_bits" in t:
                cap = t["rds_bits"].shape[1]
                rds = BitBlock(bits=t["rds_bits"],
                               valid=torch.arange(cap)[None, :]
                               < t["rds_count"][:, None],
                               count=t["rds_count"], iq=t["rds_iq"])
            taps = {k[4:]: v for k, v in t.items()
                    if k.startswith("tap:")} or None
            return final, Output(audio=t["audio"], meta=meta, rds=rds,
                                 taps=taps, meta_vec=mv,
                                 audio_i16=t.get("audio_i16"))


def run_offline_scanned(rx: Receiver, iq: np.ndarray,
                        controls: Optional[Controls] = None,
                        drop_blocks: int = 0,
                        collect_taps: bool = False,
                        init_state=None,
                        chunk_blocks: Optional[int] = None) -> StreamResult:
    """`run_offline`'s result, computed by the chunk graph: the throughput
    path for long captures, with no per-block upload, fetch or host hook
    between the replays.

    chunk_blocks: stage and fetch the capture in chunks of this many blocks
    (device memory bounded by one chunk of input and output); the state
    threads between chunks and a trailing partial chunk replays fewer
    times, so a run splits bit for bit (on the CPU; on the card a
    look-back scan's last bits may vary from run to run).  None: one chunk.
    No host feedback runs inside a chunk (decoder 3's resync, AFC and
    control take the per-block runners), as in JAX.

    The pass is a span `scan.pass` (`runtime.spans`; id the pass, count
    the blocks) around `_scan_chunks`'s spans and `scan.assemble`: the
    result's host assembly once every chunk has arrived.
    """
    with spans.span("scan.pass", id=next(_passes),
                    count=len(iq) // rx.cfg.wire_len):
        chunks = list(_scan_chunks(rx, iq, controls, init_state,
                                   chunk_blocks, collect_taps))
        with spans.span("scan.assemble"):
            audio, metas, bits, biq, tap_acc = [], [], [], [], {}
            for a, mv, b, q, taps in _blocks_of(chunks, drop_blocks, False):
                audio.append(a)
                metas.append(meta_dict_from_vec(mv)[0])
                if b is not None:
                    bits.append(b)
                    biq.append(q)
                for k, v in taps.items():
                    tap_acc.setdefault(k, []).append(v)
            return _result(audio, metas, bits, biq,
                           tree_clone(rx.jit_step().state), tap_acc)


# ---------------------------------------------------------------------------
# Streaming runner
# ---------------------------------------------------------------------------

def run_streaming(rx: Receiver, iq: np.ndarray,
                  controls: Optional[Controls] = None,
                  init_state=None,
                  on_audio=None, on_meta=None, on_rds_bits=None,
                  drop_blocks: int = 0,
                  keep_outputs: bool = True,
                  collect_taps: bool = False,
                  collect_meta: bool = True,
                  chunk_blocks: int = 1,
                  rds_feedback=None,
                  controls_update=None,
                  command_hook=None,
                  on_state=None) -> StreamResult:
    """Streaming block driver: per-block callbacks, double-buffered input.

    Each block runs through `Receiver.jit_step()`.  Block k+1's upload
    (pinned host buffer -> device, on a side stream behind an event) is
    queued right after block k's replay, and block k's outputs start their
    copies to pinned host buffers as compute drains, so both overlap the
    device's work.  Callbacks fire as each block's outputs arrive:

        on_audio(frames)   : [block_audio, 2] float32 (int16 with
                             cfg.emit_audio_i16) — feed a live sink
        on_meta(dict)      : per-block metadata
        on_rds_bits(bits)  : the block's decoded RDS bits (np.int8)

    keep_outputs=False keeps no outputs (long captures; the result then
    carries the meta and the final state).  collect_meta=False fetches no
    metadata unless on_meta or a hook needs it.

    chunk_blocks > 1 is the throughput mode: chunks of the scan runner's
    graph, each output fetched once a chunk, the callbacks fired per block
    a chunk at a time (bit-equal to `run_offline_scanned`).  Taps and the
    host feedback hooks need the per-block path (asserted).

    rds_feedback(bits) -> bool (True arms Receiver.request_rds_resync),
    controls_update(controls, meta) -> Controls|None, command_hook(state,
    controls, meta) -> (state, controls, stop) and on_state(blocks_done,
    state) close the per-block host loops in that order, after the
    callbacks, as in run_offline.  The state they see is the step's buffer
    view: copy it to keep it.  Dropped blocks (drop_blocks) run no
    callbacks and no hooks.
    """
    if chunk_blocks > 1:
        assert not collect_taps, "taps need the per-block path"
        assert rds_feedback is None and controls_update is None \
            and on_state is None and command_hook is None, \
            "per-block host feedback needs chunk_blocks=1"
        return _run_streaming_chunked(rx, iq, controls, init_state,
                                      on_audio, on_meta, on_rds_bits,
                                      drop_blocks, keep_outputs,
                                      collect_meta, chunk_blocks)
    cfg = rx.cfg
    controls = controls if controls is not None else rx.initial_controls()
    nblocks = _nblocks(iq, cfg)
    wire = wire_blocks(iq, cfg, nblocks)
    step = rx.jit_step()
    state = init_state if init_state is not None else rx.init_state()
    up, fetch = _Uploader(cfg, rx.device), _Fetch(rx.device)
    want_meta = (collect_meta or on_meta is not None
                 or controls_update is not None or command_hook is not None)
    audio_acc, metas, bits_acc, biq_acc = [], [], [], []
    tap_acc: dict = {}
    tok = up.put(wire[0])
    for b in range(nblocks):
        state, out = step(state, controls, up.take(tok))
        up.release(tok)
        if b >= drop_blocks:
            fetch.start(_block_outputs(out, want_meta, keep_outputs))
        if b + 1 < nblocks:
            tok = up.put(wire[b + 1])       # stage the next block meanwhile
        if b < drop_blocks:
            continue
        if collect_taps and out.taps:
            for k, v in out.taps.items():
                tap_acc.setdefault(k, []).append(_host(v))
        host = fetch.wait()
        frames = _audio(host, True)
        meta = n = None
        if "meta_vec" in host:
            m, n = meta_dict_from_vec(host["meta_vec"])
            if want_meta:
                meta = m
        blk_bits = host["rds_bits"][:n] if "rds_bits" in host else None
        if on_audio is not None:
            on_audio(frames)
        if on_meta is not None:
            on_meta(meta)
        if blk_bits is not None:
            if on_rds_bits is not None:
                on_rds_bits(blk_bits)
            if rds_feedback is not None and rds_feedback(blk_bits):
                state = rx.request_rds_resync(state)
        if controls_update is not None:
            controls = controls_update(controls, meta) or controls
        stop = False
        if command_hook is not None:
            state, controls, stop = command_hook(state, controls, meta)
        if on_state is not None:
            on_state(b + 1, state)
        if meta is not None:
            metas.append(meta)
        if keep_outputs:
            audio_acc.append(frames)
            if blk_bits is not None:
                bits_acc.append(blk_bits)
                biq_acc.append(host["rds_iq"][:n])
        if stop:
            break
    return _result(audio_acc, metas, bits_acc, biq_acc, tree_clone(state),
                   tap_acc)


def _run_streaming_chunked(rx: Receiver, iq: np.ndarray, controls,
                           init_state, on_audio, on_meta, on_rds_bits,
                           drop_blocks: int, keep_outputs: bool,
                           collect_meta: bool, chunk_blocks: int
                           ) -> StreamResult:
    """run_streaming's throughput mode: the scan runner's chunks, the
    callbacks fired per block once a chunk has arrived.  Bit-equal to
    `run_offline_scanned` with the same chunk_blocks."""
    want_meta = collect_meta or on_meta is not None
    audio_acc, metas, bits_acc, biq_acc = [], [], [], []
    chunks = _scan_chunks(rx, iq, controls, init_state, chunk_blocks, False)
    for frames, mv, blk_bits, blk_iq, _ in _blocks_of(chunks, drop_blocks,
                                                       True):
        if on_audio is not None:
            on_audio(frames)
        if want_meta:
            meta = meta_dict_from_vec(mv)[0]
            if on_meta is not None:
                on_meta(meta)
            if collect_meta:
                metas.append(meta)
        if on_rds_bits is not None and blk_bits is not None:
            on_rds_bits(blk_bits)
        if keep_outputs:
            audio_acc.append(frames)
            if blk_bits is not None:
                bits_acc.append(blk_bits)
                biq_acc.append(blk_iq)
    return _result(audio_acc, metas, bits_acc, biq_acc,
                   tree_clone(rx.jit_step().state))


# ---------------------------------------------------------------------------
# Live runner
# ---------------------------------------------------------------------------

def run_live(rx: Receiver, source,
             controls: Optional[Controls] = None,
             init_state=None,
             max_blocks: Optional[int] = None,
             on_audio=None, on_meta=None, on_rds_bits=None,
             keep_outputs: bool = True,
             rds_feedback=None,
             controls_update=None,
             command_hook=None,
             on_state=None,
             on_taps=None,
             timeout_ms: int = 30_000) -> StreamResult:
    """Live block driver: pull blocks from a streaming source's ring
    (runtime.native_source.NativeWavSource / NativeRawSource /
    NativePipeSource: a C++ producer thread feeding a lock-free SPSC ring)
    and step each through `Receiver.jit_step()`.  Block k is stepped, its
    outputs copy back to pinned host buffers, it is delivered and its hooks
    run; only then does the runner wait on the ring for block k+1 and start
    its upload.  A live block k+1 is still on the air while block k
    computes, so reading it first would only hold block k back a block
    period.  Runs until EOF, `max_blocks`, a command_hook's stop (no block
    is read after the last one stepped), or a read timeout (a stalled
    producer).  The source's wire format must match rx.cfg.iq_format
    (NativeWavSource -> 'c64', NativeRawSource -> its fmt).

    meta gains 'ingest_dropped' (overrun drops since the last block) and
    'latency_ms': from the block's last frame's arrival in the source's
    ring (the source's `last_arrival_ns`, CLOCK_MONOTONIC) to the return
    of its `on_audio`, or from `read_block`'s return where the source
    reports no arrival (StreamResult.arrival_timed counts the blocks timed
    from the arrival).  Both leave out the one-block accumulation.  The
    total drops are in StreamResult.dropped_total.  on_taps(taps) gets
    each block's taps as device tensors, views that the next block
    overwrites.  The hooks run after the callbacks in run_offline's order;
    on_state sees the step's state buffer view.

    Each block is a span `live.block` (`runtime.spans`; id the block) of
    `live.step` (the step's call, its output copies queued),
    `live.fetch_wait`, `live.deliver` (on_audio), `live.hooks` (the meta
    and the hooks), then the next block's `source.read` and `live.upload`.
    The counter `live.backlog` counts the blocks whose successor was
    already whole in the ring when they were delivered (the source's
    `available()`; none counted where it has none): the runner behind the
    air.
    """
    cfg = rx.cfg
    controls = controls if controls is not None else rx.initial_controls()
    T = cfg.wire_len
    step = rx.jit_step()
    state = init_state if init_state is not None else rx.init_state()
    up, fetch = _Uploader(cfg, rx.device), _Fetch(rx.device)
    available = getattr(source, "available", None)
    audio_acc, metas, bits_acc, biq_acc = [], [], [], []
    dropped_last = source.dropped
    b = timed = 0

    def read_next():
        """The next block from the ring, its upload started: (its token,
        None at the end; (ready ns, from the arrival))."""
        blk = source.read_block(T, timeout_ms)
        ready = _ready_ns(source)
        with spans.span("live.upload"):
            return (up.put(blk) if len(blk) == T else None), ready

    tok = None
    if max_blocks is None or max_blocks > 0:
        tok, t_ready = read_next()
    while tok is not None:
        with spans.span("live.block", id=b):
            with spans.span("live.step"):
                state, out = step(state, controls, up.take(tok))
                up.release(tok)
                fetch.start(_block_outputs(out, True, keep_outputs))
            with spans.span("live.fetch_wait"):
                host = fetch.wait()
            frames = _audio(host, True)
            with spans.span("live.deliver") as delivered:
                if on_audio is not None:
                    on_audio(frames)
            with spans.span("live.hooks"):
                if available is not None and available() >= T:
                    spans.count("live.backlog")
                drops_total = source.dropped
                meta, n = meta_dict_from_vec(host["meta_vec"])
                meta["ingest_dropped"] = int(drops_total - dropped_last)
                dropped_last = drops_total
                meta["latency_ms"] = (delivered.t1 - t_ready[0]) * 1e-6
                timed += t_ready[1]
                blk_bits = (host["rds_bits"][:n] if "rds_bits" in host
                            else None)
                if on_taps is not None and out.taps:
                    on_taps(dict(out.taps))
                if on_meta is not None:
                    on_meta(meta)
                if blk_bits is not None:
                    if on_rds_bits is not None:
                        on_rds_bits(blk_bits)
                    if rds_feedback is not None and rds_feedback(blk_bits):
                        state = rx.request_rds_resync(state)
                if controls_update is not None:
                    controls = controls_update(controls, meta) or controls
                stop = False
                if command_hook is not None:
                    state, controls, stop = command_hook(state, controls,
                                                         meta)
                if on_state is not None:
                    on_state(b + 1, state)
                metas.append(meta)
                if keep_outputs:
                    audio_acc.append(frames)
                    if blk_bits is not None:
                        bits_acc.append(blk_bits)
                        biq_acc.append(host["rds_iq"][:n])
            b += 1
            tok = None
            if not stop and (max_blocks is None or b < max_blocks):
                tok, t_ready = read_next()
    res = _result(audio_acc, metas, bits_acc, biq_acc, tree_clone(state))
    res.dropped_total = int(source.dropped)
    res.arrival_timed = timed
    return res


def _ready_ns(source):
    """(ns, from the arrival): when the block just read became ready, on
    CLOCK_MONOTONIC: the ring's arrival stamp (the source's
    `last_arrival_ns`) where it has one, else now, the read's return."""
    t = getattr(source, "last_arrival_ns", -1)
    return (t, True) if t >= 0 else (time.monotonic_ns(), False)


# ---------------------------------------------------------------------------
# Offline runner
# ---------------------------------------------------------------------------

def run_offline(rx: Receiver, iq: np.ndarray,
                controls: Optional[Controls] = None,
                drop_blocks: int = 0,
                collect_taps: bool = False,
                init_state=None,
                rds_feedback=None,
                controls_update=None,
                command_hook=None,
                on_state=None) -> StreamResult:
    """Process a full IQ array (wire format: complex64 [T], or [T,2] int16 /
    uint8 / int8 per rx.cfg.iq_format) through the receiver.

    drop_blocks: leading blocks left out of the result (filter warm-up),
    while the state still advances through them (the hooks run on them
    too).  collect_taps: gather the debug taps (cfg.emit_taps) per name.
    init_state: a ReceiverState to start from (for example one carried
    across with convert.state_from_numpy).  Each block runs through
    `rx.jit_step()`, as in JAX: a captured graph on the card, the same body
    eagerly on the CPU.  Its outputs are views that the next block
    overwrites, so what the run keeps is copied first (on the device; it
    comes back in one transfer at the end).

    After each block, in this order:
    - rds_feedback(bits) -> bool, the block synchronizer's feedback into
      the bit decoder, called with each block's bits in block order.  With
      decoder 3 (cfg.rds == "scan3") it runs after every block, and True
      arms Receiver.request_rds_resync before the next one: one extra bit
      fetch a block.  So it does with a command_hook, whose commands may
      reset the host decoder between blocks (a retune's `on_retune`).
      Otherwise the other decoders take no resync request, so the calls
      wait until the run has ended (the bits come back in one transfer)
      and the return value is ignored;
    - controls_update(controls, meta) -> Controls|None: a returned Controls
      replaces the controls from the next block on (AFC's loop);
    - command_hook(state, controls, meta) -> (state, controls, stop): the
      control channel's commands between blocks; stop ends the run after
      this block;
    - on_state(blocks_done, state): the carry the next block will consume
      (the checkpoint hook; resuming with init_state=a copy of it on the
      remaining blocks gives the same result).  It is the step's buffer
      view, which the next block overwrites: copy it to keep it.
    The meta dict the hooks see is fetched every block anyway (`meta_vec`,
    one transfer), so they add no sync of their own."""
    cfg = rx.cfg
    controls = controls if controls is not None else rx.initial_controls()
    nblocks = _nblocks(iq, cfg)
    state = init_state if init_state is not None else rx.init_state()
    wire = wire_blocks(iq, cfg, nblocks)
    if not wire.flags.writeable:      # a wav read straight from its buffer
        wire = wire.copy()
    wire_t = torch.from_numpy(wire)
    per_block_feedback = rds_feedback is not None and (
        cfg.rds == "scan3" or command_hook is not None)
    step = rx.jit_step()

    audio, metas, bits, biq = [], [], [], []
    fed, counts = [], []              # deferred feedback: every block's bits
    taps: dict = {}
    for b in range(nblocks):
        state, out = step(state, controls, wire_t[b])
        # the one device->host transfer per block
        meta, n = meta_dict_from_vec(out.meta_vec.cpu().numpy())
        if per_block_feedback and out.rds is not None:
            if rds_feedback(out.rds.bits[:n].cpu().numpy()):
                state = rx.request_rds_resync(state)
        elif rds_feedback is not None and out.rds is not None:
            fed.append(out.rds.bits[:n].clone())
            counts.append(n)
        if controls_update is not None:
            controls = controls_update(controls, meta) or controls
        stop = False
        if command_hook is not None:
            state, controls, stop = command_hook(state, controls, meta)
        if on_state is not None:
            on_state(b + 1, state)
        if b >= drop_blocks:
            audio.append(out.audio.clone())
            metas.append(meta)
            if out.rds is not None:
                bits.append(out.rds.bits[:n].clone())
                biq.append(out.rds.iq[:n].clone())
            if collect_taps and out.taps:
                for k, v in out.taps.items():
                    taps.setdefault(k, []).append(v.clone())
        if stop:
            break

    res = StreamResult(audio=(torch.cat(audio).cpu().numpy() if audio
                              else np.zeros((0, 2), np.float32)),
                       meta=metas, final_state=tree_clone(state))
    if taps:
        res.taps = {k: torch.cat(v).cpu().numpy() for k, v in taps.items()}
    if bits:
        res.rds_bits = torch.cat(bits).cpu().numpy()
        res.rds_iq = torch.cat(biq).cpu().numpy()
    if fed:
        all_bits = torch.cat(fed).cpu().numpy()
        edges = np.cumsum([0] + counts)
        for i in range(len(counts)):
            rds_feedback(all_bits[edges[i]:edges[i + 1]])
    return res
