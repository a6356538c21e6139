"""The port's tuner (models/tuner.py) against the JAX package's, on the
CPU: AFCTracker's sequences equal to JAX's (host arithmetic, exactly); the
RadioController's retune window, its retune reset, its AFC pull-in on a
1500 Hz residual offset (the LO corrections within 0.5 Hz of JAX's — each
block's demod DC is an f32 estimate in two libraries — and both within the
pull-in bound of tests/test_tuner_scan.py), a retuned station's audio
within 2e-4 of JAX's, and its scan's hits equal to JAX's (one front-end
call for every offset in the port, one jitted call an offset in JAX)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.io import synth as jsynth
from sdrjfm_tpu.models import tuner as JT
from sdrjfm_tpu.models.receiver import Receiver as JReceiver
from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig
from sdrjfm_tpu_torch.models import tuner as TT
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig

torch.set_num_threads(2)

BLOCK_FM = 32768
AFC_OFFSET = 1500.0


def make_offset_iq(seconds, offset_hz, tone=1000.0, noise=0.0):
    n = int(seconds * JC.FM_RATE)
    t = np.arange(n) / JC.FM_RATE
    lr = 0.6 * np.sin(2 * np.pi * tone * t)
    mpx = jsynth.synth_mpx(lr, lr, jsynth.MPXParams())
    return jsynth.fm_modulate(mpx, JC.FM_RATE, carrier_offset_hz=offset_hz,
                              noise_std=noise)


def pair(**kw):
    cfg = dict(block_fm=BLOCK_FM, rds="off", **kw)
    return JReceiver(JConfig(**cfg)), Receiver(ReceiverConfig(**cfg),
                                               device="cpu")


@pytest.mark.parametrize("dcs", [
    [0.5, 0.2, 0.05, 0.01, 0.003, 1e-4, -1e-4, 0.0],
    [-0.3, -0.3, -0.02, 0.02, 5e-4, -5e-4],
    list(np.random.default_rng(2).normal(0, 0.05, 40))])
def test_afc_tracker_sequences_equal_jax(dcs):
    a, b = JT.AFCTracker(), TT.AFCTracker()
    for dc in dcs:
        assert a.update(dc) == b.update(dc)
    a.reset(), b.reset()
    assert a.offset == b.offset == 0.0


def test_window_and_retune_reset_as_jax():
    jrx, trx = pair()
    jc, tc = JT.RadioController(jrx), TT.RadioController(trx)
    assert jc.max_offset == tc.max_offset == 960_000
    for rc in (jc, tc):
        with pytest.raises(ValueError):
            rc.set_tuner(rc.max_offset + 1000)
    # a >= 100 kHz step resets the ramp; a small one leaves it
    jc.state = jc.state._replace(ramp_remaining=jnp.asarray(0, jnp.int32))
    tc.state = tc.state._replace(ramp_remaining=torch.tensor(
        0, dtype=torch.int32))
    jc.set_tuner(50_000)
    tc.set_tuner(50_000)
    assert int(tc.state.ramp_remaining) == int(jc.state.ramp_remaining) == 0
    jc.set_tuner(300_000)
    tc.set_tuner(300_000)
    assert int(tc.state.ramp_remaining) == int(jc.state.ramp_remaining) \
        == JC.WORKING_RATE // 2
    assert int(tc.controls.lo_freq_hz) == int(jc.controls.lo_freq_hz) \
        == 300_000


def test_retuned_station_audio_matches_jax():
    offset = 300_000
    iq = make_offset_iq(0.6, offset)
    jrx, trx = pair(mode="mono", audio_filter_hz=15000)
    jc, tc = JT.RadioController(jrx), TT.RadioController(trx)
    jc.set_tuner(offset)
    tc.set_tuner(offset)
    T = trx.cfg.block_in
    for i in range(len(iq) // T):
        oj = jc.process_block(iq[i * T:(i + 1) * T])
        ot = tc.process_block(iq[i * T:(i + 1) * T])
        np.testing.assert_allclose(ot.audio.numpy(), np.asarray(oj.audio),
                                   rtol=0, atol=2e-4)


def test_process_block_returns_a_copy():
    _, trx = pair()
    tc = TT.RadioController(trx)
    iq = make_offset_iq(0.4, 0.0)
    T = trx.cfg.block_in
    a = tc.process_block(iq[:T])
    keep = a.audio.clone()
    tc.process_block(iq[T:2 * T])
    assert torch.equal(a.audio, keep)


def test_afc_pulls_in_as_jax():
    iq = make_offset_iq(2.0, AFC_OFFSET)
    jrx, trx = pair(mode="mono")
    jc = JT.RadioController(jrx, afc_active=True)
    tc = TT.RadioController(trx, afc_active=True)
    T = trx.cfg.block_in
    for i in range(len(iq) // T):
        jc.process_block(iq[i * T:(i + 1) * T])
        tc.process_block(iq[i * T:(i + 1) * T])
        assert abs(tc._afc.offset - jc._afc.offset) < 0.5, i
        assert int(tc.controls.lo_freq_hz) == int(jc.controls.lo_freq_hz)
    for rc in (jc, tc):
        assert abs(rc._afc.offset - AFC_OFFSET) < 400.0, rc._afc.offset
        assert abs(rc._afc.offset - AFC_OFFSET) < 0.5 * AFC_OFFSET


@pytest.mark.parametrize("offset", [400_000, -700_000])
def test_scan_hits_equal_jax(offset):
    iq = make_offset_iq(0.25, offset, noise=0.02)
    jrx, trx = pair()
    T = trx.cfg.block_in
    jc, tc = JT.RadioController(jrx), TT.RadioController(trx)
    got = tc.scan(iq[:T], grid_hz=100_000)
    assert got == jc.scan(iq[:T], grid_hz=100_000)
    assert offset in got and all(abs(f - offset) <= 200_000 for f in got)
