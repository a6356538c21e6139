"""The port's tracer (`runtime/spans.py`) on the CPU: the scan runner's
and the live runner's spans, nested and counted as the per-layer metrics
read them; the profiler's ranges only while a profiler records; outputs
bit for bit the same with the record on or off; the ring bounded; the
ingest ring's arrival stamps on the spans' clock; one graph capture for
repeated passes of one receiver."""

import contextlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from sdrjfm_tpu_torch.io import synth
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu_torch.runtime import graph as G
from sdrjfm_tpu_torch.runtime import native_source as N
from sdrjfm_tpu_torch.runtime import spans
from sdrjfm_tpu_torch.runtime import stream as TS

import torch_parity as P

torch.set_num_threads(2)

BLOCK_FM = 4096
NBLOCKS = 3
SCAN_PARTS = ["scan.load", "scan.stage", "scan.replays", "scan.fetch_wait",
              "scan.fetch_copy", "scan.assemble"]
FETCH = ["scan.fetch_wait", "scan.fetch_copy"]
RANGED_PARTS = {      # a staging range of one block
    None: ["scan.load"] + ["scan.stage", "scan.replays"] * 3 + FETCH
    + ["scan.assemble"],
    2: ["scan.load"] + ["scan.stage", "scan.replays"] * 2 + FETCH
    + ["scan.stage", "scan.replays"] + FETCH + ["scan.assemble"]}
LIVE_PARTS = ["live.step", "source.read", "live.upload", "live.fetch_wait",
              "live.deliver", "live.hooks"]


@pytest.fixture(scope="module")
def capture():
    iq = P.station_iq(NBLOCKS * BLOCK_FM / 192_000.0 + 0.001, seed=3)
    return synth.iq_to_u8(iq[:NBLOCKS * BLOCK_FM * 12])


@pytest.fixture(scope="module")
def rx():
    return Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                                   iq_format="u8"), device="cpu")


def _after(seq0):
    return [r for r in spans.records() if r.seq >= seq0]


def _next_seq():
    with spans.span("mark") as m:
        pass
    return m.seq + 1


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.seq]


def test_scan_pass_and_its_six_children(rx, capture):
    seq0 = _next_seq()
    for _ in range(2):
        TS.run_offline_scanned(rx, capture)
    recs = _after(seq0)
    passes = [r for r in recs if r.name == "scan.pass"]
    assert len(passes) == 2 and passes[1].id == passes[0].id + 1
    for p in passes:
        assert p.parent == -1 and p.count == NBLOCKS and not p.profiled
        kids = _children(recs, p)
        assert [k.name for k in kids] == SCAN_PARTS
        for k in kids:
            assert k.id == p.id and p.t0 <= k.t0 <= k.t1 <= p.t1
        assert kids[1].count == kids[2].count == NBLOCKS
        assert kids[4].count == sum(v.nbytes for v in
                                    rx.jit_step()._scan.outs.values())
        # the children cover the pass but for its own bookkeeping
        assert sum(k.ns for k in kids) >= 0.95 * p.ns


def _ranges_counted():
    return (spans.counters["scan.stage_ranges"],
            spans.counters["scan.stage_overlapped"])


@pytest.mark.parametrize("chunk_blocks", [None, 2])
def test_a_range_a_block_stages_and_replays_each_block(rx, capture,
                                                       monkeypatch,
                                                       chunk_blocks):
    """With a staging range of one block's bytes, each block of the pass
    is its own `scan.stage` and `scan.replays` (count 1), and the output
    is bit for bit the one-range pass's."""
    chunks = -(-NBLOCKS // (chunk_blocks or NBLOCKS))
    r0, o0 = _ranges_counted()
    one = TS.run_offline_scanned(rx, capture, chunk_blocks=chunk_blocks)
    assert _ranges_counted() == (r0 + chunks, o0)      # a range a chunk
    monkeypatch.setattr(G, "STAGE_RANGE_BYTES", rx.cfg.wire_len * 2)
    rx.jit_step()._scan.inp.zero_()      # no block left from the last pass
    seq0 = _next_seq()
    got = TS.run_offline_scanned(rx, capture, chunk_blocks=chunk_blocks)
    recs = _after(seq0)
    p, = [r for r in recs if r.name == "scan.pass"]
    kids = _children(recs, p)
    assert [k.name for k in kids] == RANGED_PARTS[chunk_blocks]
    assert [k.count for k in kids
            if k.name in ("scan.stage", "scan.replays")] == [1] * 2 * NBLOCKS
    assert all(p.t0 <= k.t0 <= k.t1 <= p.t1 for k in kids)
    # never overlapped on the CPU
    assert _ranges_counted() == (r0 + chunks + NBLOCKS, o0)
    assert len(one.rds_bits) > 0
    np.testing.assert_array_equal(got.audio, one.audio)
    np.testing.assert_array_equal(got.rds_bits, one.rds_bits)
    np.testing.assert_array_equal(got.rds_iq, one.rds_iq)
    assert got.meta == one.meta


def test_profiler_ranges_only_while_a_profiler_records(rx, capture,
                                                       monkeypatch,
                                                       tmp_path):
    from torch.profiler import ProfilerActivity, profile
    TS.run_offline_scanned(rx, capture)         # nothing left to set up
    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __init__(self, name, *a, **k):
            entered.append(name)
            super().__init__(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    seq0 = _next_seq()
    TS.run_offline_scanned(rx, capture)
    assert entered == []
    assert not any(r.profiled for r in _after(seq0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        seq1 = _next_seq()
        TS.run_offline_scanned(rx, capture)
    names = ["scan.pass"] + SCAN_PARTS
    assert sorted(set(entered)) == sorted(names + ["mark"])
    recs = [r for r in _after(seq1) if r.name in names]
    assert len(recs) == 7 and all(r.profiled for r in recs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(names) <= ranges


def test_output_bit_identical_with_the_record_on_or_off(rx, capture,
                                                        monkeypatch):
    on = TS.run_offline_scanned(rx, capture)
    spans.clear()
    emptied = TS.run_offline_scanned(rx, capture)

    class Off:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass
    monkeypatch.setattr(spans, "span", Off)
    spans.clear()
    off = TS.run_offline_scanned(rx, capture)
    assert spans.records() == []
    for r in (emptied, off):
        np.testing.assert_array_equal(r.audio, on.audio)
        np.testing.assert_array_equal(r.rds_bits, on.rds_bits)
        assert r.meta == on.meta


def test_fetch_counts_its_bytes_and_the_pinned_counters_stay_0(rx, capture,
                                                            tmp_path):
    """`scan.fetch_copy` counts the bytes of every output fetched; the
    pinned fetch's counters are in the counter set, and a pass on the CPU,
    where a fetch copies into plain memory, adds 0 to them (only the
    stand-ins of the capture path below count there)."""
    pinned = ("scan.fetch_pinned", "scan.fetch_host_allocs")
    before = [spans.counters[name] for name in pinned]
    seq0 = _next_seq()
    TS.run_offline_scanned(rx, capture, chunk_blocks=2)
    outs = rx.jit_step()._scan.outs
    copies = [r for r in _after(seq0) if r.name == "scan.fetch_copy"]
    assert [r.count for r in copies] == [
        sum(v[:k].nbytes for v in outs.values()) for k in (2, 1)]
    assert [spans.counters[name] for name in pinned] == before
    doc = json.loads(open(spans.write_json(str(tmp_path / "s.json"))).read())
    assert {"scan.fetch_pinned", "scan.fetch_host_allocs"} \
        <= set(doc["counters"])


def test_the_ring_is_bounded(tmp_path):
    ring = spans._ring
    seq0 = _next_seq()
    for i in range(spans.CAPACITY + 100):
        with spans.span("fill", id=i):
            pass
    recs = spans.records()
    assert spans._ring is ring and len(ring) == spans.CAPACITY
    assert len(recs) == spans.CAPACITY
    assert recs[0].seq == seq0 + 100 and recs[-1].id == spans.CAPACITY + 99
    assert [r.seq for r in recs] == list(range(recs[0].seq,
                                               recs[0].seq + len(recs)))
    doc = json.loads(open(spans.write_json(str(tmp_path / "s.json"))).read())
    assert doc["clock"] == "CLOCK_MONOTONIC" and doc["pid"] == os.getpid()
    assert len(doc["spans"]) == spans.CAPACITY
    assert set(doc["counters"]) >= {"kernel.builds", "graph.captures"}
    assert doc["spans"][-1]["name"] == "fill"


def test_ingest_clock_is_monotonic_ns():
    """steady_clock in the ingest library reads time.monotonic_ns()'s
    clock."""
    lib = N.load_library()
    for _ in range(20):
        a = time.monotonic_ns()
        t = lib.sdr_steady_now_ns()
        b = time.monotonic_ns()
        assert a <= t <= b


def test_run_live_spans_and_arrival_stamps(tmp_path, rx, capture):
    """run_live over a pipe: a live.block of its six parts a block; each
    block's arrival in the ring lies after the writer began its last write
    and before source.read returned; latency_ms starts there."""
    T = rx.cfg.wire_len
    blocks = [capture[b * T:(b + 1) * T].tobytes() for b in range(NBLOCKS)]
    fifo = str(tmp_path / "iq.fifo")
    os.mkfifo(fifo)
    last_write = []

    def write():
        with open(fifo, "wb", buffering=0) as f:
            for blk in blocks:
                half = len(blk) // 2
                f.write(blk[:half])
                time.sleep(0.02)
                last_write.append(time.monotonic_ns())
                f.write(blk[half:])
                time.sleep(0.05)

    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    seq0 = _next_seq()
    with N.NativePipeSource(fifo, fmt="u8") as src:
        res = TS.run_live(rx, src)
    writer.join(timeout=60)
    assert not writer.is_alive()
    assert len(res.meta) == NBLOCKS and res.arrival_timed == NBLOCKS
    recs = _after(seq0)
    reads = [r for r in recs if r.name == "source.read"]
    arrivals = [r for r in recs if r.name == "source.arrival"]
    assert len(reads) == NBLOCKS + 1            # the last finds the end
    assert len(arrivals) == NBLOCKS
    by_seq = {r.seq: r for r in recs}
    for b, a in enumerate(arrivals):
        read = by_seq[a.parent]
        assert read.name == "source.read" and read.count == T
        assert last_write[b] <= a.t0 <= read.t1
    blocks_ = [r for r in recs if r.name == "live.block"]
    assert [r.id for r in blocks_] == list(range(NBLOCKS))
    for blk, meta in zip(blocks_, res.meta):
        kids = _children(recs, blk)
        assert [k.name for k in kids] == LIVE_PARTS
        assert all(k.id == blk.id for k in kids)
        # block b's arrival: the read before the loop's, then block b-1's
        assert meta["latency_ms"] == pytest.approx(
            (kids[4].t1 - arrivals[blk.id].t0) * 1e-6)


@contextlib.contextmanager
def _cuda_stand_in(monkeypatch):
    """torch.cuda's stream, graph and pinned-memory calls as CPU stand-ins,
    so that StepGraph's capture path runs on the CPU (a 'replay' does
    nothing; each pinned allocation counts in the host allocator's
    `num_host_alloc`)."""
    class Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

        def wait_event(self, ev):
            pass

        def synchronize(self):
            pass

    class Graph:
        def replay(self):
            pass

    class Event:
        pending = False         # query(): the card still on the work

        def record(self, *a):
            pass

        def query(self):
            return not Event.pending

        def synchronize(self):
            pass

    empty = torch.empty
    pinned = [0]

    def empty_unpinned(*a, pin_memory=False, **k):
        pinned[0] += bool(pin_memory)
        return empty(*a, **k)
    for name, v in (("Stream", Stream), ("CUDAGraph", Graph),
                    ("Event", Event),
                    ("stream", lambda s: contextlib.nullcontext()),
                    ("graph", lambda g: contextlib.nullcontext()),
                    ("current_stream", lambda *a: Stream()),
                    ("synchronize", lambda *a: None),
                    ("host_memory_stats",
                     lambda: {"num_host_alloc": pinned[0]})):
        monkeypatch.setattr(torch.cuda, name, v)
    monkeypatch.setattr(torch, "empty", empty_unpinned)
    yield Event


def test_one_capture_for_repeated_passes(capture, monkeypatch):
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                                 iq_format="u8"), device="cpu")
    with _cuda_stand_in(monkeypatch):
        rx.jit_step().captures = True
        n0 = spans.counters["graph.captures"]
        f0 = spans.counters["scan.fetch_pinned"]
        seq0 = _next_seq()
        TS.run_offline_scanned(rx, capture)
        n1 = spans.counters["graph.captures"]
        for _ in range(2):
            TS.run_offline_scanned(rx, capture)
        assert n1 == n0 + 1
        assert spans.counters["graph.captures"] == n1
        assert spans.counters["scan.fetch_pinned"] == f0 + 3
        caps = [r for r in _after(seq0) if r.name == "setup.capture"]
        assert len(caps) == 1
        sc = rx.jit_step()._scan
        assert sc.capture_s == pytest.approx(caps[0].ns * 1e-9)
        load = [r for r in _after(seq0) if r.seq == caps[0].parent]
        assert load and load[0].name == "scan.load"


def test_stage_overlapped_counts_the_ranges_that_find_the_card_busy(
        capture, monkeypatch):
    """On the capture path a range after a chunk's first counts in
    `scan.stage_overlapped` when the event recorded after the previous
    range's replays is still pending; the ranges, copied through the
    staging buffer, fill the chunk with the capture."""
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                                 iq_format="u8"), device="cpu")
    with _cuda_stand_in(monkeypatch) as event:
        rx.jit_step().captures = True
        monkeypatch.setattr(G, "STAGE_RANGE_BYTES", rx.cfg.wire_len * 2)
        for pending, overlapped in ((False, 0), (True, NBLOCKS - 1)):
            event.pending = pending
            r0, o0 = _ranges_counted()
            TS.run_offline_scanned(rx, capture)
            assert _ranges_counted() == (r0 + NBLOCKS, o0 + overlapped)
            sc = rx.jit_step()._scan
            np.testing.assert_array_equal(
                sc.inp.numpy().reshape(-1),
                capture[:NBLOCKS * rx.cfg.wire_len].reshape(-1))
            sc.inp.zero_()


def test_pinned_fetch_counts_each_fetch_and_its_allocations(capture,
                                                          monkeypatch):
    """On the capture path every fetch counts in `scan.fetch_pinned`, and
    each pinned block it takes (the stand-in allocator keeps none for
    reuse: one an output) in `scan.fetch_host_allocs`; the arrays hold the
    chunk outputs' rows and share no memory with them."""
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                                 iq_format="u8"), device="cpu")
    with _cuda_stand_in(monkeypatch):
        sg = rx.jit_step()
        sg.captures = True
        sc = sg.scan(2)
        sc.prepare()
        sg.load(rx.init_state(), rx.initial_controls())
        sc.load_blocks(capture[:2 * rx.cfg.wire_len].reshape(
            (2,) + G.wire_shape(rx.cfg)))
        sc.steps(2)
        for k in (2, 1):
            f0 = spans.counters["scan.fetch_pinned"]
            a0 = spans.counters["scan.fetch_host_allocs"]
            got = sc.fetch(k)
            assert spans.counters["scan.fetch_pinned"] == f0 + 1
            assert spans.counters["scan.fetch_host_allocs"] \
                == a0 + len(sc.outs)
            assert set(got) == set(sc.outs)
            for name, v in sc.outs.items():
                np.testing.assert_array_equal(got[name], v[:k].numpy())
                assert not np.shares_memory(got[name], v.numpy())


def test_receiver_construction_is_a_span():
    seq0 = _next_seq()
    Receiver(ReceiverConfig(block_fm=BLOCK_FM), device="cpu")
    recs = [r for r in _after(seq0) if r.name == "setup.receiver"]
    assert len(recs) == 1 and recs[0].ns > 0 and recs[0].parent == -1
