"""The step object of `Receiver.jit_step()` (runtime/graph.py) on the CPU:
the same body, buffers and leaf copies as on the card, without capture.

- it gives the eager step's outputs and states bit for bit;
- its state, controls, wire and output buffers are static: every call
  returns the same tensors, and the next call overwrites the views;
- it copies a state or controls leaf only where the caller passed another
  tensor: request_rds_resync between two calls arms decoder 3 as in the
  eager step, and a new volume applies from the next call;
- the chunk form (ScanGraph): the device slot counter, index_select of the
  block and index_copy_ of the outputs, a trailing partial chunk; a chunk
  staged a range of rows at a time, the ranges split from the blocks'
  bytes (`stage_ranges`);
- a fetch's arrays belong to the caller: a later chunk's fetch writes
  into none of them, so a run of several chunks equals the one-chunk run.
"""

import numpy as np
import pytest
import torch

from sdrjfm_tpu_torch.io import synth
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu_torch.runtime import graph as G
from sdrjfm_tpu_torch.runtime import stream as TS
from sdrjfm_tpu_torch.runtime.graph import tree_clone, tree_leaves

import torch_parity as P

torch.set_num_threads(2)

BLOCK_FM = 16384
NBLK = 4


@pytest.fixture(scope="module")
def wire():
    iq = P.station_iq(NBLK * BLOCK_FM / 192_000.0 + 0.01, seed=3)
    w = synth.iq_to_i16(iq)
    T = BLOCK_FM * 12
    return [torch.from_numpy(np.ascontiguousarray(w[b * T:(b + 1) * T]))
            for b in range(NBLK)]


def _rx(**kw):
    base = dict(block_fm=BLOCK_FM, rds="block", audio_filter_hz=15000,
                iq_format="i16")
    base.update(kw)
    return Receiver(ReceiverConfig(**base), device="cpu")


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


def test_jit_step_is_memoized_and_eager_on_the_cpu():
    rx = _rx()
    step = rx.jit_step()
    assert rx.jit_step() is step
    assert isinstance(step, G.StepGraph) and not step.captures


def test_equals_the_eager_step_bit_for_bit(wire):
    rx = _rx()
    step = rx.jit_step()
    es, ctl = rx.init_state(), rx.initial_controls()
    gs = rx.init_state()
    for blk in wire:
        es, eo = rx.step(es, ctl, blk)
        gs, go = step(gs, ctl, blk)
        assert _equal(es, gs)
        assert _equal(eo, go)


def test_buffers_are_static_and_views_are_overwritten(wire):
    rx = _rx()
    step = rx.jit_step()
    ctl = rx.initial_controls()
    st, out = step(rx.init_state(), ctl, wire[0])
    state_bufs, out_bufs = tree_leaves(st), tree_leaves(out)
    first_audio = out.audio.clone()
    view = out.audio
    st2, out2 = step(st, ctl, wire[1])
    assert st2 is step.state and out2 is step.out
    assert all(a is b for a, b in zip(tree_leaves(st2), state_bufs))
    assert all(a is b for a, b in zip(tree_leaves(out2), out_bufs))
    # the view kept from the first call now holds the second block's audio
    assert view is out2.audio and not torch.equal(view, first_audio)
    # the wire buffer: a block passed as the buffer itself is not copied
    before = tree_clone(st2)        # st2 is the buffers: the call moves it
    step.iq.copy_(wire[2])
    st3, out3 = step(st2, ctl, step.iq)
    ref_st, ref_out = rx.step(before, ctl, wire[2])
    assert _equal(out3, ref_out) and _equal(st3, ref_st)


def test_copies_only_the_leaves_the_caller_replaced(wire, monkeypatch):
    rx = _rx()
    step = rx.jit_step()
    copies = []
    real = G._copy_leaf
    monkeypatch.setattr(G, "_copy_leaf",
                        lambda buf, v, what: (copies.append(what),
                                              real(buf, v, what)))
    ctl = rx.initial_controls()
    st, _ = step(rx.init_state(), ctl, wire[0])
    n_state = len(tree_leaves(st))
    assert copies.count("state") == n_state
    assert copies.count("controls") == len(tree_leaves(ctl))
    copies.clear()
    st, _ = step(st, ctl, wire[1])               # the buffers, same controls
    assert copies == []
    louder = ctl._replace(volume=torch.tensor(2.0))
    st, out = step(st, louder, wire[2])          # one new controls leaf
    assert copies == ["controls"]
    assert float(step.controls.volume) == 2.0
    copies.clear()
    st, out = step(st, louder, wire[3])
    assert copies == []


def test_mismatched_leaves_raise(wire):
    rx = _rx()
    step = rx.jit_step()
    st = rx.init_state()
    with pytest.raises(ValueError, match="iq block"):
        step(st, rx.initial_controls(), wire[0][:-12])
    bad = st._replace(band2=torch.zeros(3, dtype=torch.complex64))
    with pytest.raises(ValueError, match="state leaf"):
        step(bad, rx.initial_controls(), wire[0])
    with pytest.raises(ValueError, match="tensors"):
        step(_rx(rds="off").init_state(), rx.initial_controls(), wire[0])


def test_request_rds_resync_between_calls_arms_decoder3(wire):
    """The resync request is one new leaf of the state the step returned:
    the step copies it in, decoder 3 resyncs in the next block exactly as
    in the eager step, and the flag is consumed."""
    rx = _rx(rds="scan3")
    step = rx.jit_step()
    ctl = rx.initial_controls()
    es, gs = rx.init_state(), rx.init_state()
    for blk in wire[:2]:
        es, _ = rx.step(es, ctl, blk)
        gs, _ = step(gs, ctl, blk)
    es, gs = rx.request_rds_resync(es), rx.request_rds_resync(gs)
    assert gs.bitrec.need_resync is not step.state.bitrec.need_resync
    assert not bool(step.state.bitrec.need_resync)
    step.load(gs)                         # what the next call does first
    assert bool(step.state.bitrec.need_resync)
    es, eo = rx.step(es, ctl, wire[2])
    gs, go = step(gs, ctl, wire[2])
    assert _equal(es, gs) and _equal(eo, go)
    assert not bool(gs.bitrec.need_resync)


@pytest.mark.parametrize("K", [NBLK, 3])
def test_scan_graph_slot_and_chunk_buffers(wire, K):
    """K blocks a chunk; with K=3 the second chunk is a partial one (one
    block).  Each chunk row equals the per-block step's output."""
    rx = _rx()
    ref_st, ctl = rx.init_state(), rx.initial_controls()
    refs = []
    for blk in wire:
        ref_st, out = rx.step(ref_st, ctl, blk)
        refs.append(G.collected_outputs(out, False))
    sg = rx.jit_step()
    sc = sg.scan(K)
    assert sg.scan(K) is sc
    sg.load(rx.init_state(), ctl)
    blocks = torch.stack(wire).numpy()
    got = []
    for lo in range(0, NBLK, K):
        k = min(K, NBLK - lo)
        sc.load_blocks(blocks[lo:lo + k])
        assert int(sc.slot) == 0
        for j in range(k):
            sc.step()
            assert int(sc.slot) == j + 1
        f = sc.fetch(k)
        assert all(v.shape[0] == k for v in f.values())
        got += [{n: v[j] for n, v in f.items()} for j in range(k)]
    assert set(got[0]) == {"audio", "meta_vec", "rds_bits", "rds_count",
                           "rds_iq"}
    for g, r in zip(got, refs):
        for name, v in r.items():
            np.testing.assert_array_equal(g[name], v.numpy(), err_msg=name)
    assert _equal(sg.state, ref_st)
    with pytest.raises(ValueError, match="chunk"):
        sc.load_blocks(np.concatenate([blocks] * 2)[:K + 1])


@pytest.mark.parametrize("block_fm, fmt, k, block_bytes, per", [
    (131072, "i16", 32, 6_291_456, 1),    # stereo_rds: a block a range
    (16384, "i16", 32, 786_432, 5),       # stereo_live's geometry
    (4096, "u8", 3, 98_304, 3),           # the CPU tests' capture: one range
])
def test_stage_ranges_cover_the_chunk_in_order(block_fm, fmt, k,
                                               block_bytes, per):
    cfg = ReceiverConfig(block_fm=block_fm, iq_format=fmt)
    assert int(np.prod(G.wire_shape(cfg))) \
        * G.wire_dtype(cfg).itemsize == block_bytes
    ranges = G.stage_ranges(block_bytes, k)
    end = 0
    for a, s in ranges:
        assert a == end and 1 <= s <= per
        assert s * block_bytes <= G.STAGE_RANGE_BYTES or s == 1
        end = a + s
    assert end == k
    assert all(s == per for _, s in ranges[:-1])
    assert len(ranges) == -(-k // per)


@pytest.mark.parametrize("n, src_off, dst_off", [
    (0, 0, 0), (1, 3, 5), (63, 1, 1), (4 * 4096, 0, 0),
    (3 * 4 * 4096 + 100, 7, 13), (786_432, 2, 0)])
def test_stream_copy_copies_every_byte_and_no_more(n, src_off, dst_off):
    """The staging copy (`sdr_stream_copy`): head, four-page body and
    tail, from and to any alignment."""
    from sdrjfm_tpu_torch.runtime import native_source
    copy = native_source.load_library().sdr_stream_copy
    src = np.random.default_rng(n).integers(0, 256, n + 64, dtype=np.uint8)
    dst = np.zeros(n + 128, np.uint8)
    copy(dst.ctypes.data + dst_off, src.ctypes.data + src_off, n)
    np.testing.assert_array_equal(dst[dst_off:dst_off + n],
                                  src[src_off:src_off + n])
    assert not dst[:dst_off].any() and not dst[dst_off + n:].any()


def test_load_blocks_at_a_row_stages_those_rows_only(wire):
    """`load_blocks(blocks, at)` writes rows at.. and leaves the slot where
    the replays put it unless `at` is 0; the ranges staged and stepped in
    turn give the one-range chunk's outputs bit for bit."""
    blocks = torch.stack(wire).numpy()
    got = []
    for ranges in ([(0, NBLK)], [(0, 1), (1, 2), (3, 1)]):
        rx = _rx()
        sg = rx.jit_step()
        sc = sg.scan(NBLK)
        sg.load(rx.init_state(), rx.initial_controls())
        for a, s in ranges:
            sc.load_blocks(blocks[a:a + s], a)
            assert int(sc.slot) == a
            assert np.array_equal(sc.inp[a:a + s].numpy(), blocks[a:a + s])
            sc.steps(s)
            assert int(sc.slot) == a + s
        assert np.array_equal(sc.inp.numpy(), blocks)
        got.append(sc.fetch(NBLK))
    for name, v in got[0].items():
        np.testing.assert_array_equal(got[1][name], v, err_msg=name)
    sc.inp.zero_()
    sc.load_blocks(blocks[2:3], 3)
    assert int(sc.slot) == NBLK and not sc.inp[:3].any()
    sc.load_blocks(blocks[:1])
    assert int(sc.slot) == 0
    with pytest.raises(ValueError, match="chunk row 3"):
        sc.load_blocks(blocks[:2], 3)
    with pytest.raises(ValueError, match="chunk row -1"):
        sc.load_blocks(blocks[:1], -1)


@pytest.mark.parametrize("K", [1, 2])
def test_warm_up_of_a_short_chunk_stays_in_its_buffers(wire, K):
    """A chunk of fewer blocks than warm-up steps: each warm-up step reads
    and writes block 0 (the slot is reset after each), and the state
    buffers are restored afterwards, as before a capture."""
    rx = _rx()
    sg = rx.jit_step()
    sc = sg.scan(K)
    sg.load(rx.init_state(), rx.initial_controls())
    sc.load_blocks(torch.stack(wire[:K]).numpy())
    before = tree_clone(sg.state)
    sg.warm_up(sc._body, sc.slot.zero_)
    assert int(sc.slot) == 0
    assert _equal(sg.state, before)
    # the last warm-up step ran block 0 from a state that had already
    # stepped it twice; the first replay starts from `before` again
    assert all(v.shape[0] == K for v in sc.outs.values())
    st, out = rx.step(before, rx.initial_controls(), wire[0])
    sc.step()
    np.testing.assert_array_equal(sc.fetch(1)["audio"][0], out.audio.numpy())
    assert _equal(sg.state, st)


def test_only_the_latest_chunk_graph_is_kept():
    rx = _rx()
    sg = rx.jit_step()
    two = sg.scan(2)
    assert sg.scan(2) is two
    three = sg.scan(3)
    assert three is not two and sg._scan is three
    assert sg.scan(2) is not two and sg._scan.K == 2
    assert sg.scan(2, taps=True) is not sg.scan(2)


def test_fetched_arrays_belong_to_the_caller(wire):
    """Two chunks fetched through one chunk graph: the first fetch's arrays
    share no memory with the second's or with the chunk buffers, and still
    hold what they held before the second fetch."""
    rx = _rx()
    sg = rx.jit_step()
    sc = sg.scan(2)
    sg.load(rx.init_state(), rx.initial_controls())
    blocks = torch.stack(wire).numpy()
    sc.load_blocks(blocks[:2])
    sc.steps(2)
    first = sc.fetch(2)
    kept = {name: v.copy() for name, v in first.items()}
    sc.load_blocks(blocks[2:4])
    sc.steps(2)
    second = sc.fetch(2)
    assert set(second) == set(first)
    assert not np.array_equal(first["audio"], second["audio"])
    for name, v in first.items():
        assert not np.shares_memory(v, second[name]), name
        assert not np.shares_memory(v, sc.outs[name].numpy()), name
        np.testing.assert_array_equal(v, kept[name], err_msg=name)


def test_chunks_of_two_over_five_blocks_equal_one_chunk():
    """`run_offline_scanned(chunk_blocks=2)` collects three fetches (the
    last a partial chunk) before it assembles: bit for bit the one-chunk
    run."""
    rx = _rx(block_fm=4096)
    iq = P.station_iq(5 * 4096 / 192_000.0 + 0.01, seed=5)
    capture = synth.iq_to_i16(iq)[:5 * 4096 * 12]
    one = TS.run_offline_scanned(rx, capture)
    got = TS.run_offline_scanned(rx, capture, chunk_blocks=2)
    assert got.audio.shape == one.audio.shape == (5 * 1024, 2)
    np.testing.assert_array_equal(got.audio, one.audio)
    np.testing.assert_array_equal(got.rds_bits, one.rds_bits)
    np.testing.assert_array_equal(got.rds_iq, one.rds_iq)
    assert got.meta == one.meta
    assert _equal(got.final_state, one.final_state)
