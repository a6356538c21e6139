"""The port's checkpoints (runtime/checkpoint.py) against the JAX package's,
on the CPU.

`config_fingerprint` and FORMAT_VERSION are equal across the packages, so
an npz written by either loads into the other: every leaf equal (random
contents of each leaf's shape and dtype, for each state layout).
`CheckpointManager` keeps the same steps as JAX's.  A port resume is bit
for bit the uninterrupted run on the CPU, and a checkpoint that JAX wrote
mid-run, resumed by the port, continues JAX's run within 2e-4 (the audio
tolerance of the option tests).  The errors carry JAX's messages; the orbax
backend is refused naming ROADMAP.md.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sdrjfm_tpu.models.receiver import Receiver as JReceiver
from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig
from sdrjfm_tpu.runtime import checkpoint as jck
from sdrjfm_tpu.runtime.stream import run_offline as jrun_offline
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu_torch.runtime import checkpoint as tck
from sdrjfm_tpu_torch.runtime.graph import tree_leaves
from sdrjfm_tpu_torch.runtime.stream import run_offline

from torch_parity import station_iq

torch.set_num_threads(2)

AUDIO_ATOL = 2e-4
BASE = dict(block_fm=4096, rds="block", audio_filter_hz=15000)

# every option set of test_torch_receiver_options.py, and the decoders,
# squelches and the 192 kHz / test-tone / taps outputs
OPTION_SETS = {
    "block": {}, "rds_off": dict(rds="off"),
    "scan1": dict(rds="scan1"), "scan2": dict(rds="scan2"),
    "scan3": dict(rds="scan3"), "nsq": dict(squelch="nsq", block_fm=8192),
    "lsq": dict(squelch="lsq", block_fm=8192), "input_filter": dict(input_filter=True),
    "input_filter_150k": dict(input_filter=True, fm_bandwidth_hz=150e3),
    "reference": dict(frontend="reference"),
    "reference_i16": dict(frontend="reference", iq_format="i16"),
    "dc_off_i8": dict(dc_remove=False, iq_format="i8"),
    "native_2400k_u8": dict(native_rate=2_400_000, iq_format="u8"),
    "native_2500k_i16": dict(native_rate=2_500_000, block_fm=12288,
                             iq_format="i16"),
    "audio_192k_tone": dict(rds="off", audio_rate=192000, test_tone=True),
    "taps": dict(emit_taps=True, emit_input_tap=True),
}

# the state layouts the checkpoints cross between the packages
LAYOUTS = ("block", "scan1", "scan2", "scan3", "nsq", "lsq", "input_filter",
           "native_2400k_u8", "audio_192k_tone")


def _cfgs(name):
    kw = dict(BASE, **OPTION_SETS[name])
    return JConfig(**kw), ReceiverConfig(**kw)


@pytest.mark.parametrize("name", list(OPTION_SETS))
def test_fingerprint_matches_jax(name):
    jc, tc = _cfgs(name)
    assert tck.config_fingerprint(tc) == jck.config_fingerprint(jc)
    assert tck.FORMAT_VERSION == jck.FORMAT_VERSION == 2


def _random_leaves(template, seed):
    rng = np.random.default_rng(seed)
    out = []
    for t in tree_leaves(template):
        shape, dt = tuple(t.shape), t.dtype
        if dt == torch.bool:
            v = rng.integers(0, 2, shape).astype(bool)
        elif dt in (torch.int32, torch.int64):
            v = rng.integers(-1000, 1000, shape)
        elif dt == torch.complex64:
            v = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape)
        out.append(np.asarray(v).astype(
            torch.empty((), dtype=dt).numpy().dtype))
    return out


@pytest.mark.parametrize("name", LAYOUTS)
def test_checkpoints_cross_both_ways(name, tmp_path):
    jc, tc = _cfgs(name)
    jrx, trx = JReceiver(jc), Receiver(tc, device="cpu")
    jtemplate, ttemplate = jrx.init_state(), trx.init_state()
    flat_j = jax.tree_util.tree_leaves(jtemplate)
    assert len(flat_j) == len(tree_leaves(ttemplate))
    # port -> JAX
    leaves = _random_leaves(ttemplate, seed=1)
    tstate = tck.tree_rebuild(ttemplate,
                              [torch.from_numpy(v) for v in leaves])
    tck.save_state(str(tmp_path / "port.npz"), tstate, {"blocks": 7}, cfg=tc)
    jstate, extra = jck.load_state(str(tmp_path / "port.npz"), jtemplate,
                                   cfg=jc)
    assert extra == {"blocks": 7}
    for a, b in zip(jax.tree_util.tree_leaves(jstate), leaves):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    # JAX -> port
    leaves = _random_leaves(ttemplate, seed=2)
    jstate = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jtemplate),
        [jnp.asarray(v) for v in leaves])
    jck.save_state(str(tmp_path / "jax.npz"), jstate, {"blocks": 9}, cfg=jc)
    tstate, extra = tck.load_state(str(tmp_path / "jax.npz"), ttemplate,
                                   cfg=tc)
    assert extra == {"blocks": 9}
    assert type(tstate) is type(ttemplate)
    for a, t, b in zip(tree_leaves(tstate), tree_leaves(ttemplate), leaves):
        assert a.dtype == t.dtype and a.device == t.device
        np.testing.assert_array_equal(a.numpy(), b)


def test_host_leaves_is_one_copy_of_every_leaf():
    _, tc = _cfgs("scan3")
    t = Receiver(tc, device="cpu").init_state()
    leaves = _random_leaves(t, seed=3)
    state = tck.tree_rebuild(t, [torch.from_numpy(v) for v in leaves])
    got = tck.host_leaves(state)
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(a, b)
    assert tck.host_leaves(got) is got           # host leaves pass through


def _managers(tmp_path, **kw):
    _, tc = _cfgs("block")
    return (jck.CheckpointManager(str(tmp_path / "jax"), **kw),
            tck.CheckpointManager(str(tmp_path / "port"), cfg=tc, **kw))


@pytest.mark.parametrize("kw", [dict(max_to_keep=3),
                                dict(max_to_keep=2, keep_period=3),
                                dict(max_to_keep=1, keep_period=4,
                                     async_write=False)],
                         ids=["keep3", "keep2_period3", "keep1_period4_sync"])
def test_manager_retention_matches_jax(tmp_path, kw):
    jm, tm = _managers(tmp_path, **kw)
    jstate = {"a": jnp.arange(3, dtype=jnp.float32)}
    tstate = (torch.arange(3, dtype=torch.float32),)
    for step in range(1, 11):
        jm.save(step, jstate)
        tm.save(step, tstate)
        jm.wait_until_finished()
        tm.wait_until_finished()
        assert tm.all_steps() == jm.all_steps(), step
    assert tm.latest_step() == jm.latest_step() == 10
    state, extra = tm.restore(tstate)
    assert extra == {"step": 10}
    np.testing.assert_array_equal(state[0].numpy(), [0, 1, 2])
    jm.close()
    tm.close()


def test_manager_restore_without_checkpoints_raises(tmp_path):
    _, tm = _managers(tmp_path)
    with pytest.raises(tck.CheckpointError, match="no checkpoints"):
        tm.restore((torch.zeros(1),))
    tm.close()


@pytest.fixture(scope="module")
def capture():
    return station_iq(0.25)          # 12 blocks of block_fm 4096


def _audio(res):
    return np.asarray(res.audio)


def test_port_resume_is_bit_exact(capture, tmp_path):
    _, tc = _cfgs("block")
    rx = Receiver(tc, device="cpu")
    T = tc.wire_len
    mgr = tck.CheckpointManager(str(tmp_path), cfg=tc, max_to_keep=2)
    full = run_offline(rx, capture, on_state=lambda b, s: mgr.save(b, s)
                       if b % 4 == 0 else None)
    mgr.close()
    assert mgr.all_steps() == [4, 8]
    assert full.rds_bits is not None
    rx2 = Receiver(tc, device="cpu")
    state, extra = tck.load_state(str(tmp_path), rx2.init_state(), cfg=tc)
    assert extra == {"step": 8}
    rest = run_offline(rx2, capture[8 * T:], init_state=state)
    assert len(rest.rds_bits) > 0
    a = _audio(full)[8 * tc.block_audio:]
    np.testing.assert_array_equal(_audio(rest), a)
    np.testing.assert_array_equal(rest.rds_bits,
                                  full.rds_bits[-len(rest.rds_bits):])


def test_jax_checkpoint_resumed_by_port_matches_jax_run(capture, tmp_path):
    jc, tc = _cfgs("block")
    jrx = JReceiver(jc)
    T = jc.wire_len
    jm = jck.CheckpointManager(str(tmp_path), cfg=jc, max_to_keep=1)
    jfull = jrun_offline(jrx, capture,
                         on_state=lambda b, s: jm.save(b, s)
                         if b == 6 else None)
    jm.close()
    trx = Receiver(tc, device="cpu")
    state, _ = tck.load_state(str(tmp_path), trx.init_state(), cfg=tc)
    rest = run_offline(trx, capture[6 * T:], init_state=state)
    np.testing.assert_allclose(_audio(rest),
                               _audio(jfull)[6 * tc.block_audio:],
                               rtol=0, atol=AUDIO_ATOL)


def _error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def test_load_errors_carry_jax_messages(tmp_path):
    jc, tc = _cfgs("block")
    trx = Receiver(tc, device="cpu")
    jrx = JReceiver(jc)
    path = str(tmp_path / "s.npz")
    tck.save_state(path, trx.init_state(), cfg=tc)
    # another configuration: the fingerprint
    jc2, tc2 = _cfgs("scan2")
    for cfg_pair in ((jc2, tc2),):
        ej = _error(lambda: jck.load_state(path, jrx.init_state(),
                                           cfg=cfg_pair[0]))
        et = _error(lambda: tck.load_state(path, trx.init_state(),
                                           cfg=cfg_pair[1]))
        assert et == ej and "different receiver configuration" in et[1]
    # another layout without a fingerprint: the leaf count
    tck.save_state(path, trx.init_state())
    jrx2, trx2 = JReceiver(jc2), Receiver(tc2, device="cpu")
    ej = _error(lambda: jck.load_state(path, jrx2.init_state()))
    et = _error(lambda: tck.load_state(path, trx2.init_state()))
    assert et == ej and "state leaves" in et[1]
    # a leaf of another shape
    leaves = [v.numpy() for v in tree_leaves(trx.init_state())]
    leaves[3] = np.zeros(leaves[3].size + 1, leaves[3].dtype)
    tck.save_state(path, leaves)
    ej = _error(lambda: jck.load_state(path, jrx.init_state()))
    et = _error(lambda: tck.load_state(path, trx.init_state()))
    assert et == ej and "state leaf 3" in et[1]
    # a newer format
    import json
    data = dict(np.load(path))
    data["__meta__"] = np.frombuffer(json.dumps(
        {"format_version": 3, "n_leaves": len(leaves)}).encode(), np.uint8)
    np.savez(path, **data)
    ej = _error(lambda: jck.load_state(path, jrx.init_state()))
    et = _error(lambda: tck.load_state(path, trx.init_state()))
    assert et == ej and "format v3" in et[1]


def test_orbax_backend_is_refused_naming_roadmap(tmp_path):
    with pytest.raises(tck.CheckpointError, match="ROADMAP"):
        tck.CheckpointManager(str(tmp_path / "m"), backend="orbax")
    os.makedirs(tmp_path / "orbax_ckpt")
    (tmp_path / "orbax_ckpt" / "checkpoint").write_text("{}")
    _, tc = _cfgs("block")
    with pytest.raises(tck.CheckpointError, match="ROADMAP"):
        tck.load_state(str(tmp_path / "orbax_ckpt"),
                       Receiver(tc, device="cpu").init_state())
