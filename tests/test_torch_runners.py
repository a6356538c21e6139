"""The port's runners against the JAX package's, on the CPU.

A JAX receiver runs ~1 s into a synth capture (pilot locked) and its state
is handed to the port with convert.state_from_numpy; then both packages'
runners start from that state on the next blocks.  Tolerances, as in
test_torch_receiver.py: audio within 2e-4 (f32 chains through FFT filters,
atan2 and the trackers in two libraries; the audio is O(0.5)), meta within
1e-3 except the boolean slots (exact), RDS bits exactly.

- run_offline's hooks (controls_update, command_hook, on_state): the order
  and arguments of the calls, a volume change at block K, a stop at block
  K, and on_state's state resumed into a second run, bit for bit the whole
  run;
- run_offline_scan / run_offline_scanned (one chunk, and chunks of 2 over 3
  blocks) and run_streaming (chunk 1 and 2; keep_outputs, collect_meta)
  against the JAX runners of the same name;
- the port's runners, chunked or not, against its eager rx.step loop, bit
  for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu.models.receiver import Receiver as JReceiver
from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig
from sdrjfm_tpu.runtime import stream as JS
from sdrjfm_tpu_torch import convert
from sdrjfm_tpu_torch.models.receiver import (Meta, Receiver, ReceiverConfig,
                                              meta_dict_from_vec)
from sdrjfm_tpu_torch.runtime import stream as TS
from sdrjfm_tpu_torch.runtime.graph import tree_clone, tree_leaves

import torch_parity as P

torch.set_num_threads(2)

BLOCK_FM = 16384
WARM = 12                     # JAX blocks before the hand-over (~1.02 s)
RUN = 3                       # blocks the runners compare
K = 1                         # the block a hook acts on
AUDIO_ATOL = 2e-4
META_ATOL = 1e-3
KW = dict(block_fm=BLOCK_FM, rds="block", audio_filter_hz=15000,
          iq_format="i16")


@pytest.fixture(scope="module")
def setup():
    """(JAX receiver, port receiver, JAX state and port state after WARM
    blocks, the RUN blocks' i16 wire, controls)."""
    iq = P.station_iq((WARM + RUN) * BLOCK_FM / 192_000.0 + 0.01)
    jrx = JReceiver(JConfig(**KW))
    trx = Receiver(ReceiverConfig(**KW), device="cpu")
    wire = P.wire_blocks(iq, jrx.cfg, "i16")
    jctl = jrx.initial_controls()._replace(
        lo_freq_hz=jnp.asarray(-50_000, jnp.int32))
    tctl = trx.initial_controls()._replace(
        lo_freq_hz=torch.tensor(-50_000, dtype=torch.int32))
    step = jrx.jit_step()
    js = jrx.init_state()
    for blk in wire[:WARM]:
        js, out = step(js, jctl, jnp.asarray(blk))
    assert bool(out.meta.pilot_locked)
    ts = convert.state_from_numpy(P.tree_np(js), "cpu")
    return jrx, trx, js, ts, np.concatenate(wire[WARM:WARM + RUN]), jctl, \
        tctl


def _close(tres, jres, meta=True):
    np.testing.assert_allclose(tres.audio, np.asarray(jres.audio), rtol=0,
                               atol=AUDIO_ATOL)
    np.testing.assert_array_equal(tres.rds_bits, jres.rds_bits)
    if meta:
        assert len(tres.meta) == len(jres.meta)
        for mt, mj in zip(tres.meta, jres.meta):
            _meta_close(mt, mj)


def _meta_close(mt, mj):
    assert set(mt) == set(mj)
    for k in mt:
        if isinstance(mj[k], bool):
            assert mt[k] == mj[k], k
        else:
            assert mt[k] == pytest.approx(mj[k], rel=1e-4, abs=META_ATOL), k


def _hooks(log, stop_at=None, volume_at=None, as_controls=None):
    """controls_update, command_hook and on_state that log their calls;
    controls_update sets the volume to 0.5 after block `volume_at`,
    command_hook stops after block `stop_at`."""
    n = {"cu": 0, "ch": 0}

    def controls_update(ctl, meta):
        log.append(("controls_update", n["cu"], dict(meta)))
        n["cu"] += 1
        if volume_at is not None and n["cu"] == volume_at + 1:
            return ctl._replace(volume=as_controls(0.5))
        return None

    def command_hook(state, ctl, meta):
        log.append(("command_hook", n["ch"], float(ctl.volume)))
        n["ch"] += 1
        return state, ctl, stop_at is not None and n["ch"] == stop_at + 1

    def on_state(blocks_done, state):
        log.append(("on_state", blocks_done, type(state).__name__))

    return dict(controls_update=controls_update, command_hook=command_hook,
                on_state=on_state)


def test_run_offline_hooks_order_and_arguments(setup):
    jrx, trx, js, ts, wire, jctl, tctl = setup
    jlog, tlog = [], []
    jres = JS.run_offline(jrx, wire, jctl, init_state=js, **_hooks(jlog))
    tres = TS.run_offline(trx, wire, tctl, init_state=ts, **_hooks(tlog))
    _close(tres, jres)
    assert [e[:2] for e in tlog] == [e[:2] for e in jlog]
    assert [e[:2] for e in tlog[:3]] == [("controls_update", 0),
                                        ("command_hook", 0), ("on_state", 1)]
    for et, ej in zip(tlog, jlog):
        if et[0] == "controls_update":
            _meta_close(et[2], ej[2])
        else:
            assert et[2] == ej[2]


@pytest.mark.parametrize("drop", [0, 1])
def test_controls_update_changes_volume_at_block(setup, drop):
    """A Controls returned after block K applies from block K+1 on; the
    hooks also run on dropped blocks."""
    jrx, trx, js, ts, wire, jctl, tctl = setup
    jlog, tlog = [], []
    jres = JS.run_offline(jrx, wire, jctl, init_state=js, drop_blocks=drop,
                          **_hooks(jlog, volume_at=K,
                                   as_controls=lambda v: jnp.asarray(
                                       v, jnp.float32)))
    tres = TS.run_offline(trx, wire, tctl, init_state=ts, drop_blocks=drop,
                          **_hooks(tlog, volume_at=K,
                                   as_controls=lambda v: torch.tensor(
                                       v, dtype=torch.float32)))
    _close(tres, jres)
    # command_hook runs after controls_update: it sees the new volume
    # from block K on, the audio changes from block K+1
    vols = [e[2] for e in tlog if e[0] == "command_hook"]
    assert vols == [1.0] * K + [0.5] * (RUN - K)
    assert vols == [e[2] for e in jlog if e[0] == "command_hook"]
    base = TS.run_offline(trx, wire, tctl, init_state=ts, drop_blocks=drop)
    n = len(base.audio) // (RUN - drop)
    np.testing.assert_array_equal(tres.audio[:(K + 1 - drop) * n],
                                  base.audio[:(K + 1 - drop) * n])
    # past the filters' memory of the old volume: half the amplitude
    r = np.abs(tres.audio[-n // 2:]).max() / np.abs(base.audio[-n // 2:]).max()
    assert 0.49 < r < 0.51


def test_command_hook_stops_after_block(setup):
    jrx, trx, js, ts, wire, jctl, tctl = setup
    jlog, tlog = [], []
    jres = JS.run_offline(jrx, wire, jctl, init_state=js,
                          **_hooks(jlog, stop_at=K))
    tres = TS.run_offline(trx, wire, tctl, init_state=ts,
                          **_hooks(tlog, stop_at=K))
    assert len(tres.meta) == len(jres.meta) == K + 1
    _close(tres, jres)
    assert [e[:2] for e in tlog] == [e[:2] for e in jlog]
    assert tlog[-1] == ("on_state", K + 1, "ReceiverState")


@pytest.mark.parametrize("fresh", [False, True],
                         ids=["same_receiver", "new_receiver"])
def test_on_state_resume_is_bit_for_bit(setup, fresh):
    """The state on_state sees after block K, copied and resumed on the
    remaining blocks (by the same receiver, or by a new one with its own
    step object), gives the whole run bit for bit."""
    _, trx, _, ts, wire, _, tctl = setup
    T = trx.cfg.wire_len
    saved = {}

    def on_state(blocks_done, state):
        if blocks_done == K + 1:
            saved["state"] = tree_clone(state)

    whole = TS.run_offline(trx, wire, tctl, init_state=ts, on_state=on_state)
    rx2 = Receiver(ReceiverConfig(**KW), device="cpu") if fresh else trx
    rest = TS.run_offline(rx2, wire[(K + 1) * T:], tctl,
                          init_state=saved["state"])
    n = len(whole.audio) // RUN
    np.testing.assert_array_equal(rest.audio, whole.audio[(K + 1) * n:])
    assert rest.meta == whole.meta[K + 1:]


@pytest.mark.parametrize("chunk", [None, 2], ids=["one_chunk", "chunk2"])
def test_run_offline_scanned_matches_jax(setup, chunk):
    jrx, trx, js, ts, wire, jctl, tctl = setup
    jres = JS.run_offline_scanned(jrx, wire, jctl, init_state=js,
                                  chunk_blocks=chunk)
    tres = TS.run_offline_scanned(trx, wire, tctl, init_state=ts,
                                  chunk_blocks=chunk)
    _close(tres, jres)
    # constellation points O(1-3) after the matched filter and the carrier
    # loop in f32 in two libraries
    np.testing.assert_allclose(tres.rds_iq, np.asarray(jres.rds_iq),
                               rtol=0, atol=2e-3)
    # the final states agree as well: the scalar trackers and a filter tail
    jf, tf = P.tree_np(jres.final_state), convert.state_to_numpy(
        tres.final_state)
    assert int(tf.n0_mod) == int(jf.n0_mod)
    # the audio filter's carry: the pre-decimation stereo pair, O(3)
    np.testing.assert_allclose(tf.audio_filt, jf.audio_filt, atol=1e-3)


def test_run_offline_scan_stacked_output(setup):
    jrx, trx, js, ts, wire, jctl, tctl = setup
    jst, jout = JS.run_offline_scan(jrx, wire, jctl, init_state=js)
    tst, tout = TS.run_offline_scan(trx, wire, tctl, init_state=ts)
    assert tout.audio.shape == jout.audio.shape
    np.testing.assert_allclose(tout.audio.numpy(), np.asarray(jout.audio),
                               atol=AUDIO_ATOL)
    np.testing.assert_array_equal(tout.rds.count.numpy(),
                                  np.asarray(jout.rds.count))
    np.testing.assert_array_equal(tout.rds.valid.numpy(),
                                  np.asarray(jout.rds.valid))
    for name in ("pilot_locked", "pss_established"):
        i = Meta._fields.index(name)
        np.testing.assert_array_equal(getattr(tout.meta, name).numpy(),
                                      np.asarray(jout.meta_vec)[:, i] > 0)
    np.testing.assert_allclose(tout.meta_vec.numpy(),
                               np.asarray(jout.meta_vec), rtol=1e-4,
                               atol=META_ATOL)


@pytest.mark.parametrize("chunk,keep,collect_meta", [
    (1, True, True), (1, False, False), (2, True, True), (2, False, True)])
def test_run_streaming_matches_jax(setup, chunk, keep, collect_meta):
    jrx, trx, js, ts, wire, jctl, tctl = setup
    cb = {"j": {"audio": [], "meta": [], "bits": []},
          "t": {"audio": [], "meta": [], "bits": []}}

    def kw(who):
        d = cb[who]
        return dict(on_audio=d["audio"].append, on_meta=d["meta"].append,
                    on_rds_bits=d["bits"].append, keep_outputs=keep,
                    collect_meta=collect_meta, chunk_blocks=chunk)

    jres = JS.run_streaming(jrx, wire, jctl, init_state=js, **kw("j"))
    tres = TS.run_streaming(trx, wire, tctl, init_state=ts, **kw("t"))
    j, t = cb["j"], cb["t"]
    assert len(t["audio"]) == len(j["audio"]) == RUN
    for a, b in zip(t["audio"], j["audio"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=AUDIO_ATOL)
    for a, b in zip(t["bits"], j["bits"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t["meta"], j["meta"]):
        _meta_close(a, b)
    assert len(tres.meta) == len(jres.meta)
    if keep:
        _close(tres, jres)
    else:
        assert len(tres.audio) == len(jres.audio) == 0
        assert tres.rds_bits is None and jres.rds_bits is None


def _eager_run(rx, wire, controls, state):
    """The capture through rx.step itself, block by block: audio, RDS bits
    and points, meta dicts and the final state."""
    T = rx.cfg.wire_len
    audio, bits, biq, metas = [], [], [], []
    for b in range(len(wire) // T):
        state, out = rx.step(state, controls,
                             torch.from_numpy(wire[b * T:(b + 1) * T]))
        meta, n = meta_dict_from_vec(out.meta_vec.numpy())
        audio.append(out.audio.numpy())
        bits.append(out.rds.bits[:n].numpy())
        biq.append(out.rds.iq[:n].numpy())
        metas.append(meta)
    return TS.StreamResult(audio=np.concatenate(audio), meta=metas,
                           rds_bits=np.concatenate(bits),
                           rds_iq=np.concatenate(biq), final_state=state)


def test_chunked_runs_equal_unchunked_bit_for_bit(setup):
    """Every runner, chunked or not, equals the eager rx.step loop bit for
    bit on the CPU."""
    _, trx, _, ts, wire, _, tctl = setup
    eager = _eager_run(trx, wire, tctl, ts)
    runs = [TS.run_offline_scanned(trx, wire, tctl, init_state=ts),
            TS.run_offline_scanned(trx, wire, tctl, init_state=ts,
                                   chunk_blocks=2),
            TS.run_streaming(trx, wire, tctl, init_state=ts),
            TS.run_streaming(trx, wire, tctl, init_state=ts, chunk_blocks=2),
            TS.run_offline(trx, wire, tctl, init_state=ts)]
    for r in runs:
        np.testing.assert_array_equal(r.audio, eager.audio)
        np.testing.assert_array_equal(r.rds_bits, eager.rds_bits)
        np.testing.assert_array_equal(r.rds_iq, eager.rds_iq)
        assert r.meta == eager.meta
        for a, b in zip(tree_leaves(r.final_state),
                        tree_leaves(eager.final_state)):
            assert torch.equal(a, b)


def test_drop_blocks_scanned(setup):
    _, trx, _, ts, wire, _, tctl = setup
    full = TS.run_offline_scanned(trx, wire, tctl, init_state=ts)
    dropped = TS.run_offline_scanned(trx, wire, tctl, init_state=ts,
                                     drop_blocks=1, chunk_blocks=2)
    n = len(full.audio) // RUN
    np.testing.assert_array_equal(dropped.audio, full.audio[n:])
    assert dropped.meta == full.meta[1:]


def test_runners_refuse_short_captures(setup):
    _, trx, _, _, wire, _, _ = setup
    short = wire[: trx.cfg.wire_len - 1]
    for run in (TS.run_offline, TS.run_offline_scanned, TS.run_streaming):
        with pytest.raises(ValueError, match="need at least"):
            run(trx, short)
    with pytest.raises(AssertionError):
        TS.run_streaming(trx, wire, chunk_blocks=2, on_state=print)
