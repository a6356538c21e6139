"""The port's multi-station receiver (models/multistation.py) and the row
form of the front end (Receiver.front_end_rows) against the JAX package, on
the CPU.

- front_end_rows == JAX's vmap(front_end) over stations on one shared block
  and over the band scan's offsets x blocks, and == front_end row by row
  on every split path (input filter, reference cascade, input tap, native
  rate), bit for bit;
- MultiStationReceiver.step == JAX's on a two-station capture: both
  packages run ~1 s (pilot locked) from the JAX state handed over with
  convert.state_from_numpy, then compare three blocks: audio within 2e-4
  (as test_torch_runners.py: f32 chains through FFT filters, atan2 and the
  trackers in two libraries), meta within 1e-3 (the boolean slots exactly),
  RDS bits equal;
- each station of demodulate_stations == the port's own single-station
  run_offline, bit for bit; scan=True == scan=False; the captured step of
  jit_step() == the eager step, captured anew when n changes;
- controls_for and init_states == JAX's leaves; mesh= and the sharded
  class raise naming ROADMAP queue 1 #24.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.models.multistation import \
    MultiStationReceiver as JMultiStation
from sdrjfm_tpu.models.receiver import Receiver as JReceiver
from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig
from sdrjfm_tpu_torch import convert
from sdrjfm_tpu_torch.models import multistation as MS
from sdrjfm_tpu_torch.models.receiver import (Meta, Receiver, ReceiverConfig,
                                              meta_dict_from_vec)
from sdrjfm_tpu_torch.runtime.graph import (tree_broadcast, tree_index,
                                            tree_leaves, tree_stack)
from sdrjfm_tpu_torch.runtime.stream import run_offline

import torch_parity as P

torch.set_num_threads(2)

BLOCK_FM = 16384
WARM = 12                     # JAX blocks before the hand-over (~1.02 s)
RUN = 3                       # blocks compared after it
AUDIO_ATOL = 2e-4
META_ATOL = 1e-3
KW = dict(block_fm=BLOCK_FM, rds="block", audio_filter_hz=15000)
STATIONS = ((-500_000, 0x1111, "STATION1", 700.0),
            (400_000, 0x2222, "STATION2", 1300.0))
OFFSETS = [s[0] for s in STATIONS]


def two_stations(seconds: float) -> np.ndarray:
    return P.stations_iq(STATIONS, seconds)


@pytest.fixture(scope="module")
def handed_over():
    """JAX's multi-station receiver run WARM blocks, its stacked state
    handed to the port, and both run over RUN more blocks: (JAX outputs,
    port outputs, JAX states, port states)."""
    T = 12 * BLOCK_FM
    iq = two_stations((WARM + RUN) * BLOCK_FM / JC.FM_RATE + 0.01)
    jmsr = JMultiStation(JReceiver(JConfig(**KW)))
    tmsr = MS.MultiStationReceiver(Receiver(ReceiverConfig(**KW),
                                            device="cpu"))
    js, jc = jmsr.init_states(2), jmsr.controls_for(OFFSETS)
    for b in range(WARM):
        js, out = jmsr.step(js, jc, jnp.asarray(iq[b * T:(b + 1) * T]))
    assert bool(np.asarray(out.meta.pilot_locked).all())
    jnp_states = P.tree_np(js)
    ts = tree_stack([convert.state_from_numpy(
        jax.tree.map(lambda x, s=s: x[s], jnp_states), "cpu")
        for s in range(2)])
    tc = tmsr.controls_for(OFFSETS)
    jouts, touts = [], []
    for b in range(WARM, WARM + RUN):
        blk = iq[b * T:(b + 1) * T]
        js, oj = jmsr.step(js, jc, jnp.asarray(blk))
        ts, ot = tmsr.step(ts, tc, torch.from_numpy(blk.copy()))
        jouts.append(oj)
        touts.append(ot)
    return jouts, touts, js, ts


def test_audio_matches_jax(handed_over):
    jouts, touts, _, _ = handed_over
    for oj, ot in zip(jouts, touts):
        assert ot.audio.shape == (2, BLOCK_FM // 4, 2)
        np.testing.assert_allclose(ot.audio.numpy(), np.asarray(oj.audio),
                                   rtol=0, atol=AUDIO_ATOL)


def test_meta_matches_jax(handed_over):
    jouts, touts, _, _ = handed_over
    for oj, ot in zip(jouts, touts):
        for name in Meta._fields:
            t = getattr(ot.meta, name).numpy()
            j = np.asarray(getattr(oj.meta, name))
            assert t.shape == j.shape == (2,), name
            if name in ("pilot_locked", "pss_established"):
                np.testing.assert_array_equal(t.astype(bool), j, name)
            else:
                np.testing.assert_allclose(t, j, rtol=0, atol=META_ATOL,
                                           err_msg=name)
        # the packed vector the runners fetch carries the same per station
        for s in range(2):
            d, n = meta_dict_from_vec(ot.meta_vec[s].numpy())
            assert n == int(ot.rds.count[s])
            assert d["pilot_locked"] == bool(oj.meta.pilot_locked[s])


def test_rds_bits_match_jax(handed_over):
    jouts, touts, _, _ = handed_over
    total = 0
    for oj, ot in zip(jouts, touts):
        for s in range(2):
            n = int(oj.rds.count[s])
            assert int(ot.rds.count[s]) == n
            np.testing.assert_array_equal(ot.rds.bits[s, :n].numpy(),
                                          np.asarray(oj.rds.bits[s, :n]))
            total += n
    assert total > 0


def test_front_end_state_matches_jax(handed_over):
    """The stacked state after the run: the front end's leaves (NCO phase,
    DC servo, FIR carry) and the pilot state, per station."""
    _, _, js, ts = handed_over
    np.testing.assert_array_equal(ts.n0_mod.numpy(), np.asarray(js.n0_mod))
    np.testing.assert_allclose(ts.rf_dc.numpy(), np.asarray(js.rf_dc),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.band1.numpy(), np.asarray(js.band1),
                               rtol=0, atol=1e-5)
    assert ts.pilot.filt.shape[0] == 2


# ---------------------------------------------------------------------------
# The row form of the front end
# ---------------------------------------------------------------------------

FE_BLOCK_FM = 4096
FE_ATOL = 1e-5                # as test_torch_frontend.py: f32 sums of 307
                              # taps in another order, sin/cos ulps


def _rows_inputs(trx, jrx, R, seed=3):
    """Port and JAX states and controls with R rows of distinct LO, NCO
    phase, DC state, gains and carry."""
    rng = np.random.default_rng(seed)
    st = trx.init_state()
    ts = tree_broadcast(st, R)
    carry = 0.1 * (rng.standard_normal((R, ts.band1.shape[1]))
                   + 1j * rng.standard_normal((R, ts.band1.shape[1])))
    ts = ts._replace(
        band1=torch.from_numpy(carry.astype(np.complex64)),
        rf_dc=torch.from_numpy((0.005 * (rng.standard_normal(R) + 1j))
                               .astype(np.complex64)),
        n0_mod=torch.from_numpy(rng.integers(0, JC.INPUT_RATE, R)
                                .astype(np.int32)))
    tc = tree_broadcast(trx.initial_controls(), R)._replace(
        lo_freq_hz=torch.from_numpy(rng.integers(-900_000, 900_001, R)
                                    .astype(np.int32)),
        input_lgain=torch.from_numpy(rng.uniform(0.5, 1.5, R)
                                     .astype(np.float32)),
        input_rgain=torch.from_numpy(rng.uniform(0.5, 1.5, R)
                                     .astype(np.float32)))
    jst = jrx.init_state()
    js = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (R,) + x.shape),
                      jst)
    js = js._replace(band1=jnp.asarray(ts.band1.numpy()),
                     rf_dc=jnp.asarray(ts.rf_dc.numpy()),
                     n0_mod=jnp.asarray(ts.n0_mod.numpy()))
    jc = jrx.initial_controls()
    jc = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (R,) + x.shape),
                      jc)
    jc = jc._replace(lo_freq_hz=jnp.asarray(tc.lo_freq_hz.numpy()),
                     input_lgain=jnp.asarray(tc.input_lgain.numpy()),
                     input_rgain=jnp.asarray(tc.input_rgain.numpy()))
    return ts, tc, js, jc


@pytest.mark.parametrize("layout", ["stations", "offsets_x_blocks"])
def test_front_end_rows_matches_jax_vmap(layout):
    """One shared block (vmap with the block broadcast) and the band scan's
    rows (offset i on block b, vmap over gathered blocks), i16 wire."""
    kw = dict(block_fm=FE_BLOCK_FM, rds="off", iq_format="i16")
    jrx = JReceiver(JConfig(**kw))
    trx = Receiver(ReceiverConfig(**kw), device="cpu")
    T = trx.cfg.block_in
    rng = np.random.default_rng(5)
    nb = 1 if layout == "stations" else 3
    wire = rng.integers(-20000, 20000, (nb, T, 2)).astype(np.int16)
    R = 4 if layout == "stations" else 2 * nb
    bidx = np.zeros(R, np.int32) if nb == 1 else np.tile(np.arange(nb), 2
                                                         ).astype(np.int32)
    ts, tc, js, jc = _rows_inputs(trx, jrx, R)
    v, fe = trx.front_end_rows(ts, tc, torch.from_numpy(wire),
                               torch.from_numpy(bidx))
    vj, (dcj, _, t1j, _, _, _) = jax.vmap(
        jrx.front_end, in_axes=(0, 0, 0))(js, jc, jnp.asarray(wire[bidx]))
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0,
                               atol=FE_ATOL)
    np.testing.assert_allclose(fe["band1"].numpy(), np.asarray(t1j), rtol=0,
                               atol=FE_ATOL)
    np.testing.assert_allclose(fe["rf_dc"].numpy(), np.asarray(dcj), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(
        fe["n0_mod"].numpy(),
        (ts.n0_mod.numpy().astype(np.int64) + T) % JC.INPUT_RATE)


@pytest.mark.parametrize("opts", [
    dict(), dict(input_filter=True), dict(frontend="reference"),
    dict(emit_taps=True, emit_input_tap=True),
    dict(native_rate=2_400_000, iq_format="i16"), dict(dc_remove=False)],
    ids=["fused", "input_filter", "reference", "input_tap", "native_rate",
         "dc_off"])
def test_front_end_rows_equals_front_end_per_row(opts):
    """Every path: row r of front_end_rows == front_end on row r's state,
    controls and block, bit for bit (the fused path's plain version is the
    same arithmetic row by row; the split paths loop over the rows)."""
    kw = dict(block_fm=FE_BLOCK_FM, rds="off", **opts)
    trx = Receiver(ReceiverConfig(**kw), device="cpu")
    jrx = JReceiver(JConfig(**kw))
    rng = np.random.default_rng(9)
    nb, R = 2, 3
    shape = (nb, trx.cfg.wire_len) + ((2,) if trx.cfg.iq_format != "c64"
                                      else ())
    if trx.cfg.iq_format == "c64":
        wire = (0.3 * (rng.standard_normal(shape)
                       + 1j * rng.standard_normal(shape))).astype(
            np.complex64)
    else:
        wire = rng.integers(-20000, 20000, shape).astype(np.int16)
    ts, tc, _, _ = _rows_inputs(trx, jrx, R)
    bidx = torch.tensor([1, 0, 1], dtype=torch.int32)
    v, fe = trx.front_end_rows(ts, tc, torch.from_numpy(wire), bidx)
    assert v.shape == (R, FE_BLOCK_FM)
    for r in range(R):
        vr, (dc, itail, t1, t2, itap, rc) = trx.front_end(
            tree_index(ts, r), tree_index(tc, r),
            torch.from_numpy(wire[int(bidx[r])]))
        assert torch.equal(v[r], vr)
        for name, got in (("rf_dc", dc), ("band1", t1), ("band2", t2),
                          ("input_filt", itail if kw.get("input_filter")
                           else None),
                          ("input_tap", itap), ("rate_carry", rc)):
            if got is None:
                assert fe[name] is None, name
            else:
                assert torch.equal(fe[name][r], got), name


def test_front_end_rows_plain_raises_on_a_bad_block_index():
    trx = Receiver(ReceiverConfig(block_fm=FE_BLOCK_FM, rds="off"),
                   device="cpu")
    ts = tree_broadcast(trx.init_state(), 1)
    tc = tree_broadcast(trx.initial_controls(), 1)
    wire = torch.zeros((1, trx.cfg.block_in), dtype=torch.complex64)
    with pytest.raises(IndexError):
        trx.front_end_rows(ts, tc, wire, torch.tensor([1], dtype=torch.int32))


# ---------------------------------------------------------------------------
# The port's own multi-station paths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capture():
    return two_stations(1.0)


@pytest.fixture(scope="module")
def port_rx():
    return Receiver(ReceiverConfig(**KW), device="cpu")


@pytest.fixture(scope="module")
def demodulated(capture, port_rx):
    return MS.demodulate_stations(port_rx, capture, OFFSETS)


@pytest.mark.parametrize("s", range(len(STATIONS)))
def test_each_station_equals_its_single_station_run(capture, port_rx,
                                                    demodulated, s):
    single = run_offline(port_rx, capture, port_rx.initial_controls()._replace(
        lo_freq_hz=torch.tensor(OFFSETS[s], dtype=torch.int32)))
    got = demodulated[s]
    assert got["offset_hz"] == OFFSETS[s]
    np.testing.assert_array_equal(got["audio"], single.audio)
    np.testing.assert_array_equal(got["rds_bits"], single.rds_bits)
    assert got["meta"] == single.meta[-1]


def test_scan_true_and_false_agree(capture, port_rx, demodulated):
    loop = MS.demodulate_stations(port_rx, capture, OFFSETS, scan=False)
    for a, b in zip(demodulated, loop):
        np.testing.assert_array_equal(a["audio"], b["audio"])
        np.testing.assert_array_equal(a["rds_bits"], b["rds_bits"])
        assert a["meta"] == b["meta"]


def test_rds_off_gives_no_bits(capture):
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="off"), device="cpu")
    res = MS.demodulate_stations(rx, capture[: 2 * 12 * BLOCK_FM], OFFSETS)
    assert [r["rds_bits"] for r in res] == [None, None]
    assert res[0]["audio"].shape == (2 * BLOCK_FM // 4, 2)


def test_jit_step_equals_the_eager_step_and_recaptures_on_new_n(capture,
                                                                port_rx):
    msr = MS.MultiStationReceiver(port_rx)
    T = port_rx.cfg.block_in
    blk = torch.from_numpy(capture[:T].copy())
    step = msr.jit_step()
    for n in (2, 3):
        offs = OFFSETS + [0] * (n - 2)
        st, out = step(msr.init_states(n), msr.controls_for(offs), blk)
        assert step.graph.rx.n == n
        st_e, out_e = msr.step(msr.init_states(n), msr.controls_for(offs),
                               blk)
        for a, b in zip(tree_leaves((st, out)), tree_leaves((st_e, out_e))):
            assert torch.equal(a, b)
    assert msr.jit_step() is step
    assert port_rx.stations() is port_rx.stations()


def test_controls_for_and_init_states_match_jax():
    kw = dict(block_fm=BLOCK_FM, rds="off", sound="left", panorama=0.5)
    jmsr = JMultiStation(JReceiver(JConfig(**kw)))
    tmsr = MS.MultiStationReceiver(Receiver(ReceiverConfig(**kw),
                                            device="cpu"))
    offs = [-300_000, 0, 250_000]
    jc, tc = jmsr.controls_for(offs), tmsr.controls_for(offs)
    for name in jc._fields:
        j, t = np.asarray(getattr(jc, name)), getattr(tc, name).numpy()
        assert t.shape == j.shape and t.dtype == j.dtype, name
        np.testing.assert_array_equal(t, j, name)
    assert tc.sound_mix.shape == (3, 2, 2)
    js, ts = jmsr.init_states(3), tmsr.init_states(3)
    one = tmsr.rx.init_state()
    for a, b in zip(tree_leaves(ts), tree_leaves(one)):
        assert a.shape == (3,) + b.shape and torch.equal(a[2], b)
    assert ts.band1.shape == tuple(np.asarray(js.band1).shape)


def test_scan_rds_decoders_are_refused():
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="scan1"),
                  device="cpu")
    with pytest.raises(AssertionError):
        MS.MultiStationReceiver(rx)


def test_mesh_and_the_sharded_receiver_raise_naming_24(capture, port_rx):
    with pytest.raises(NotImplementedError, match="#24"):
        MS.demodulate_stations(port_rx, capture, OFFSETS, mesh=object())
    with pytest.raises(NotImplementedError, match="#24"):
        MS.ShardedMultiStationReceiver(port_rx)
