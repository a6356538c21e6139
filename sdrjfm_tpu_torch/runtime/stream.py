"""Offline, streaming and live drivers for the block receiver (port of
sdrjfm_tpu.runtime.stream).

- `run_offline` feeds the capture through `Receiver.jit_step()` block by
  block, with the host hooks between blocks.  Per block it fetches one
  packed vector from the device (`Output.meta_vec`: the metadata scalars
  and the RDS bit count); the audio and the RDS bits stay on the device
  until the run ends and come back in one transfer each.
- `run_offline_scan` / `run_offline_scanned`, the throughput path: chunks of
  blocks staged on the device once, the captured step replayed once a block
  (`runtime.graph.ScanGraph`), every output fetched once a chunk.  The JAX
  runners dispatch one `lax.scan` a chunk instead.
- `run_streaming`, per-block callbacks through `Receiver.jit_step()` with
  block k+1's upload overlapping block k's compute, or chunks of the scan
  machinery with the callbacks fired a block at a time.
- `run_live`, the same step over a streaming source's ring
  (runtime.native_source), reading block k+1 while block k computes.

Every runner steps through `Receiver.jit_step()` (the scan runners through
its chunk form), whose outputs are views that the next call overwrites:
they copy what they keep.  On a CPU receiver the same code runs with the
step's eager body.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.receiver import (BitBlock, Controls, Meta, Output, Receiver,
                               meta_dict_from_vec)
from .graph import tree_clone, wire_dtype, wire_shape

_WIRE_DTYPES = {"c64": np.complex64, "i16": np.int16, "i8": np.int8,
                "u8": np.uint8}


def _wire_blocks(iq: np.ndarray, cfg, nblocks: int) -> np.ndarray:
    """The capture as [nblocks, *wire block shape] in its wire dtype."""
    x = np.ascontiguousarray(iq[: nblocks * cfg.wire_len],
                             _WIRE_DTYPES[cfg.iq_format])
    return x.reshape((nblocks,) + wire_shape(cfg))


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
        self.np_dtype = _WIRE_DTYPES[cfg.iq_format]
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

    def put(self, blk: np.ndarray, wait: bool = False):
        """Start the upload of one block; returns its token.  wait=True
        returns only when the block is on the device."""
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
        if wait:
            ev.synchronize()
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


def _block_outputs(out, want_meta: bool, keep_iq: bool):
    """What a per-block runner reads of one block's Output."""
    d = {"audio": out.audio_i16 if out.audio_i16 is not None else out.audio}
    if want_meta or out.rds is not None:
        d["meta_vec"] = out.meta_vec
    if out.rds is not None:
        d["bits"] = out.rds.bits
        if keep_iq:
            d["biq"] = out.rds.iq
    return d


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

def _scan_chunks(rx: Receiver, iq: np.ndarray, controls, init_state,
                 chunk_blocks: Optional[int], taps: bool):
    """The capture through the chunk graph: yields (first block, {output:
    [k, ...] host array}) per chunk of k <= chunk_blocks blocks (all blocks
    in one chunk when chunk_blocks is None).  The state threads from chunk
    to chunk in the step's buffers; rx.jit_step().state holds the final one
    when the generator ends."""
    cfg = rx.cfg
    nblocks = _nblocks(iq, cfg)
    K = nblocks if chunk_blocks is None else int(chunk_blocks)
    wire = _wire_blocks(iq, cfg, nblocks)
    sg = rx.jit_step()
    sc = sg.scan(min(K, nblocks), taps)
    sc.prepare()
    sg.load(init_state if init_state is not None else rx.init_state(),
            controls if controls is not None else rx.initial_controls())
    for lo in range(0, nblocks, sc.K):
        k = min(sc.K, nblocks - lo)
        sc.load_blocks(wire[lo:lo + k])
        for _ in range(k):
            sc.step()
        yield lo, sc.fetch(k)


def run_offline_scan(rx: Receiver, iq: np.ndarray,
                     controls: Optional[Controls] = None,
                     init_state=None):
    """The whole capture as one chunk of the captured step (the port's
    counterpart of JAX's single `lax.scan` dispatch): one upload, one
    replay a block, one fetch of each output.  Returns (final_state, the
    stacked Output): every field with a leading block axis, as CPU
    tensors fetched once (Meta from the meta_vec columns; the taps when
    cfg.emit_taps)."""
    (_, got), = _scan_chunks(rx, iq, controls, init_state, None,
                             rx.cfg.emit_taps)
    final = tree_clone(rx.jit_step().state)
    t = {k: torch.from_numpy(v) for k, v in got.items()}
    mv = t["meta_vec"]
    meta = Meta(*(mv[:, i].to(torch.bool)
                  if name in ("pilot_locked", "pss_established")
                  else mv[:, i] for i, name in enumerate(Meta._fields)))
    rds = None
    if "rds_bits" in t:
        cap = t["rds_bits"].shape[1]
        rds = BitBlock(bits=t["rds_bits"],
                       valid=torch.arange(cap)[None, :]
                       < t["rds_count"][:, None],
                       count=t["rds_count"], iq=t["rds_iq"])
    taps = {k[4:]: v for k, v in t.items() if k.startswith("tap:")} or None
    return final, Output(audio=t["audio"], meta=meta, rds=rds, taps=taps,
                         meta_vec=mv, audio_i16=t.get("audio_i16"))


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
    """
    audio, mvs, bits, biq, tap_acc = [], [], [], [], {}
    for lo, got in _scan_chunks(rx, iq, controls, init_state, chunk_blocks,
                                collect_taps):
        for j in range(got["audio"].shape[0]):
            if lo + j < drop_blocks:
                continue
            audio.append(got["audio"][j])
            mvs.append(got["meta_vec"][j])
            if "rds_bits" in got:
                n = int(got["rds_count"][j])
                bits.append(got["rds_bits"][j, :n])
                biq.append(got["rds_iq"][j, :n])
            for k, v in got.items():
                if k.startswith("tap:"):
                    tap_acc.setdefault(k[4:], []).append(v[j].reshape(-1))
    metas = [meta_dict_from_vec(mv)[0] for mv in mvs]
    return _result(audio, metas, bits, biq, tree_clone(rx.jit_step().state),
                   tap_acc)


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
                  on_state=None,
                  double_buffer: bool = True) -> StreamResult:
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
    metadata unless on_meta or a hook needs it.  double_buffer=False
    uploads block k and waits for it before the step (the control for
    measuring the overlap).

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
    wire = _wire_blocks(iq, cfg, nblocks)
    step = rx.jit_step()
    state = init_state if init_state is not None else rx.init_state()
    up, fetch = _Uploader(cfg, rx.device), _Fetch(rx.device)
    want_meta = (collect_meta or on_meta is not None
                 or controls_update is not None or command_hook is not None)
    audio_acc, metas, bits_acc, biq_acc = [], [], [], []
    tap_acc: dict = {}
    tok = up.put(wire[0]) if double_buffer else None
    for b in range(nblocks):
        if not double_buffer:
            tok = up.put(wire[b], wait=True)
        state, out = step(state, controls, up.take(tok))
        up.release(tok)
        if b < drop_blocks:
            if double_buffer and b + 1 < nblocks:
                tok = up.put(wire[b + 1])
            continue
        fetch.start(_block_outputs(out, want_meta, keep_outputs))
        if double_buffer and b + 1 < nblocks:
            tok = up.put(wire[b + 1])       # stage the next block meanwhile
        if collect_taps and out.taps:
            for k, v in out.taps.items():
                tap_acc.setdefault(k, []).append(_host(v))
        host = fetch.wait()
        frames = host["audio"]
        meta = n = None
        if "meta_vec" in host:
            m, n = meta_dict_from_vec(host["meta_vec"])
            if want_meta:
                meta = m
        blk_bits = host["bits"][:n] if "bits" in host else None
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
                biq_acc.append(host["biq"][:n])
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
    for lo, got in _scan_chunks(rx, iq, controls, init_state, chunk_blocks,
                                False):
        audio = got.get("audio_i16", got["audio"])
        for j in range(audio.shape[0]):
            if lo + j < drop_blocks:
                continue
            frames = audio[j]
            if on_audio is not None:
                on_audio(frames)
            if want_meta:
                meta, _ = meta_dict_from_vec(got["meta_vec"][j])
                if on_meta is not None:
                    on_meta(meta)
                if collect_meta:
                    metas.append(meta)
            blk_bits = None
            if "rds_bits" in got:
                n = int(got["rds_count"][j])
                blk_bits = got["rds_bits"][j, :n]
            if on_rds_bits is not None and blk_bits is not None:
                on_rds_bits(blk_bits)
            if keep_outputs:
                audio_acc.append(frames)
                if blk_bits is not None:
                    bits_acc.append(blk_bits)
                    biq_acc.append(got["rds_iq"][j, :n])
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
    and step each through `Receiver.jit_step()`.  While block k computes,
    the host pre-reads block k+1 from the ring and starts its upload, and
    block k's outputs copy back to pinned host buffers.  Runs until EOF,
    `max_blocks`, or a read timeout (a stalled producer).  The source's
    wire format must match rx.cfg.iq_format (NativeWavSource -> 'c64',
    NativeRawSource -> its fmt).

    meta gains 'ingest_dropped' (overrun drops since the last block) and
    'latency_ms' (block ready -> audio delivered); the total drops are in
    StreamResult.dropped_total.  on_taps(taps) gets each block's taps as
    device tensors, views that the next block overwrites.  The hooks run
    after the callbacks in run_offline's order; on_state sees the step's
    state buffer view.
    """
    cfg = rx.cfg
    controls = controls if controls is not None else rx.initial_controls()
    T = cfg.wire_len
    step = rx.jit_step()
    state = init_state if init_state is not None else rx.init_state()
    up, fetch = _Uploader(cfg, rx.device), _Fetch(rx.device)
    audio_acc, metas, bits_acc, biq_acc = [], [], [], []
    dropped_last = source.dropped
    b = 0
    blk = source.read_block(T, timeout_ms)
    # read_block returns when the block's last sample is available, so
    # (audio delivered - block ready) is the processing and delivery
    # latency on top of the one-block accumulation
    t_ready = time.perf_counter()
    tok = up.put(blk) if len(blk) == T else None
    while tok is not None and (max_blocks is None or b < max_blocks):
        state, out = step(state, controls, up.take(tok))
        up.release(tok)
        fetch.start(_block_outputs(out, True, keep_outputs))
        # the next block from the ring, uploaded while this one computes
        blk = source.read_block(T, timeout_ms)
        t_next_ready = time.perf_counter()
        tok = up.put(blk) if len(blk) == T else None
        host = fetch.wait()
        frames = host["audio"]
        drops_total = source.dropped
        meta, n = meta_dict_from_vec(host["meta_vec"])
        meta["ingest_dropped"] = int(drops_total - dropped_last)
        dropped_last = drops_total
        blk_bits = host["bits"][:n] if "bits" in host else None
        if on_audio is not None:
            on_audio(frames)
        meta["latency_ms"] = (time.perf_counter() - t_ready) * 1e3
        t_ready = t_next_ready
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
            state, controls, stop = command_hook(state, controls, meta)
        if on_state is not None:
            on_state(b + 1, state)
        metas.append(meta)
        if keep_outputs:
            audio_acc.append(frames)
            if blk_bits is not None:
                bits_acc.append(blk_bits)
                biq_acc.append(host["biq"][:n])
        b += 1
        if stop:
            break
    res = _result(audio_acc, metas, bits_acc, biq_acc, tree_clone(state))
    res.dropped_total = int(source.dropped)
    return res


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
      fetch a block.  The other decoders take no resync request, so for
      them the calls wait until the run has ended (the bits come back in
      one transfer) and the return value is ignored;
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
    T = cfg.wire_len
    nblocks = _nblocks(iq, cfg)
    state = init_state if init_state is not None else rx.init_state()
    wire = np.ascontiguousarray(iq[: nblocks * T], _WIRE_DTYPES[cfg.iq_format])
    if not wire.flags.writeable:      # a wav read straight from its buffer
        wire = wire.copy()
    wire_t = torch.from_numpy(wire)
    per_block_feedback = rds_feedback is not None and cfg.rds == "scan3"
    step = rx.jit_step()

    audio, metas, bits, biq = [], [], [], []
    fed, counts = [], []              # deferred feedback: every block's bits
    taps: dict = {}
    for b in range(nblocks):
        state, out = step(state, controls, wire_t[b * T:(b + 1) * T])
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
