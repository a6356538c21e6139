"""Receiver.step of the port against the JAX package for the fm-chain
options, after a JAX -> port state hand-over mid-stream (CPU).

Same protocol and tolerances as test_torch_receiver_options.py: audio within
2e-4 of the O(0.5) audio, meta_vec within 1e-3, RDS bits equal.  The squelch
runs at block_fm=8192 (its hold period), everything else at 4096.  The PCM16
audio is the host quantizer of the port's own audio bit for bit, and within
one LSB of JAX's (an f32 difference of 1e-6 may cross a truncation step).
"""

import numpy as np
import pytest
import torch

from sdrjfm_tpu_torch import convert
from sdrjfm_tpu_torch.io.pcmout import quantize_pcm16
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig

from test_torch_receiver_options import BASE, _run  # noqa: F401
from torch_parity import Pair, station_iq, tree_np

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def capture():
    return station_iq(0.25)


@pytest.mark.parametrize("kw,controls", [
    (dict(decoder="pll"), None), (dict(decoder="am"), None),
    (dict(decoder="real_baseband"), None), (dict(decoder="difference"), None),
    (dict(audio_filter_hz=0), None),
    (dict(audio_filter_hz=0, deemphasis_us=0.0), None),
    (dict(deemphasis_us=75.0), None),
    (dict(test_tone=True), dict(tone_gate=1.0)),
    (dict(test_tone=True), dict(tone_gate=0.0)),
    (dict(audio_rate=192_000), None),
    (dict(sound="left_minus_right_test"), None),
    (dict(mode="stereo_pano", panorama=1.5, sound="left_plus_right"),
     dict(volume=0.7, left_gain=0.8)),
    (dict(squelch="nsq", block_fm=8192), dict(squelch_level=30.0)),
    (dict(squelch="lsq", block_fm=8192), dict(squelch_level=40.0)),
    (dict(rds="scan1"), None), (dict(rds="scan2"), None),
    (dict(rds="scan3"), None)],
    ids=["pll", "am", "real_baseband", "difference", "deemph_scan",
         "deemph_off", "deemph_us", "tone_on", "tone_off", "up192k",
         "lmr_test", "pano", "nsq", "lsq", "scan1", "scan2", "scan3"])
def test_chain_option_matches_jax(capture, kw, controls):
    p, outs = _run(capture, controls=controls, **kw)
    if kw.get("audio_rate"):
        assert outs[0][1].audio.shape == (4 * p.trx.cfg.block_working, 2)
    # the deemphasis runs as the scan exactly when the audio filter is off
    assert p.trx.deemph_folded == (p.trx.cfg.audio_filter_hz > 0)


def test_audio_i16_is_the_host_quantizer(capture):
    p, outs = _run(capture, emit_audio_i16=True, cmp=1)
    oj, ot = outs[0]
    np.testing.assert_array_equal(ot.audio_i16.numpy(),
                                  quantize_pcm16(ot.audio.numpy()))
    assert np.abs(ot.audio_i16.numpy().astype(int)
                  - np.asarray(oj.audio_i16).astype(int)).max() <= 1
    edge = torch.tensor([[-1.5, 1.5], [-1.0, 1.0], [0.99999, -0.99999],
                         [1e-6, -1e-6]], dtype=torch.float32)
    from sdrjfm_tpu_torch.models.receiver import quantize_i16
    np.testing.assert_array_equal(quantize_i16(edge).numpy(),
                                  quantize_pcm16(edge.numpy()))


def test_run_offline_drop_blocks_taps_and_feedback_match_jax(capture):
    """runtime.stream.run_offline against the JAX runner: 4 blocks after a
    state handed across from 4 JAX blocks, the first 2 dropped from the
    result (the state still advances through them), the taps collected,
    and decoder 3 fed back per block through each package's
    LiveRDSDecoder."""
    from sdrjfm_tpu.rds.live import LiveRDSDecoder as JLive
    from sdrjfm_tpu.runtime.stream import run_offline as j_run
    from sdrjfm_tpu_torch.rds.live import LiveRDSDecoder as TLive
    from sdrjfm_tpu_torch.runtime.stream import run_offline as t_run
    p = Pair(**dict(BASE, rds="scan3", emit_taps=True))
    T = p.trx.cfg.wire_len
    warm = j_run(p.jrx, capture[:4 * T], p.jctl)
    ts = convert.state_from_numpy(tree_np(warm.final_state), "cpu")
    iq = capture[4 * T:8 * T]
    jlive, tlive = JLive(), TLive()
    rj = j_run(p.jrx, iq, p.jctl, drop_blocks=2, collect_taps=True,
               init_state=warm.final_state, rds_feedback=jlive.feed)
    rt = t_run(p.trx, iq, p.tctl, drop_blocks=2, collect_taps=True,
               init_state=ts, rds_feedback=tlive.feed)
    assert rt.audio.shape == rj.audio.shape == (2 * p.trx.cfg.block_working,
                                                2)
    np.testing.assert_allclose(rt.audio, rj.audio, rtol=0, atol=2e-4)
    assert len(rt.meta) == len(rj.meta) == 2
    for mt, mj in zip(rt.meta, rj.meta):
        assert mt.keys() == mj.keys()
        np.testing.assert_allclose([float(mt[k]) for k in mj],
                                   [float(mj[k]) for k in mj],
                                   rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(rt.rds_bits, rj.rds_bits)
    assert rt.taps.keys() == rj.taps.keys() and rt.taps
    for k, v in rj.taps.items():
        assert rt.taps[k].shape == v.shape, k
        np.testing.assert_allclose(rt.taps[k], v, rtol=0,
                                   atol=2e-4 * max(1.0, np.abs(v).max()),
                                   err_msg=k)
    assert tlive.resyncs_requested == jlive.resyncs_requested
    assert tlive.sync.groups_decoded == jlive.sync.groups_decoded


def test_shard_axis_is_the_only_unported_path():
    rx = Receiver(ReceiverConfig(**BASE), device="cpu")
    st, ctl = rx.init_state(), rx.initial_controls()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rx.front_end(st, ctl, torch.zeros(rx.cfg.wire_len,
                                          dtype=torch.complex64),
                     shard_axis="time")
