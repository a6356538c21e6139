"""Receiver.step of the port against the JAX package for the front-end
options, after a JAX -> port state hand-over mid-stream (CPU, block_fm=4096).

The JAX receiver runs 4 blocks, its state goes across with
convert.state_from_numpy, and both run 2 more.  Audio within 2e-4 (f32
chains through FFT filters, atan2 and the trackers in two libraries; the
audio is O(0.5)), the RDS bits equal, every carried state within 1e-4 of
its scale.  Also: the native-rate repair, and convert's round trip of
every state type.
"""

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from sdrjfm_tpu_torch import convert
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig

from torch_parity import Pair, rds_bits, station_iq, wire_blocks

torch.set_num_threads(2)

BASE = dict(block_fm=4096, rds="block", audio_filter_hz=15000,
            iq_format="c64")


@pytest.fixture(scope="module")
def capture():
    return station_iq(0.25)


def _run(capture, warm=4, cmp=2, controls=None, **kw):
    cfg = dict(BASE, **kw)
    p = Pair(controls=controls, **cfg)
    src = capture
    num, den = p.trx.cfg.rate_ratio if cfg.get("native_rate") else (1, 1)
    if (num, den) != (1, 1):
        src = resample_poly(capture, num, den).astype(np.complex64)
    blks = wire_blocks(src, p.trx.cfg, cfg["iq_format"])
    js, ts = p.warm(blks[:warm])
    outs = []
    for blk in blks[warm:warm + cmp]:
        js, ts, oj, ot = p.step(js, ts, blk)
        np.testing.assert_allclose(ot.audio.numpy(), np.asarray(oj.audio),
                                   rtol=0, atol=2e-4)
        np.testing.assert_allclose(ot.meta_vec.numpy(),
                                   np.asarray(oj.meta_vec), rtol=1e-4,
                                   atol=1e-3)
        if oj.rds is not None:
            np.testing.assert_array_equal(rds_bits(ot), rds_bits(oj))
        outs.append((oj, ot))
    back = convert.state_to_numpy(ts)
    for name in ("n0_mod", "rf_dc", "band1", "band2", "input_filt",
                 "rate_carry"):
        a, b = getattr(back, name), np.asarray(getattr(js, name))
        if getattr(js, name) is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(b).max()),
                                   err_msg=name)
    return p, outs


@pytest.mark.parametrize("kw", [
    dict(input_filter=True), dict(input_filter=True, fm_bandwidth_hz=150e3),
    dict(frontend="reference"), dict(frontend="reference", iq_format="i16"),
    dict(dc_remove=False, iq_format="i8"),
    dict(native_rate=2_400_000, iq_format="u8"),
    dict(native_rate=2_500_000, block_fm=12288, iq_format="i16")],
    ids=["input_filter", "input_filter_150k", "reference", "reference_i16",
         "dc_off_i8", "native_2400k_u8", "native_2500k_i16"])
def test_front_end_option_matches_jax(capture, kw):
    p, _ = _run(capture, **kw)
    assert p.trx.fused_frontend == (not kw.get("input_filter")
                                    and kw.get("frontend", "flat") == "flat")


def test_input_tap_matches_jax(capture):
    """emit_input_tap with the taps: the 2.304 MS/s stream after DC removal,
    and every other tap of the chain."""
    p, outs = _run(capture, emit_taps=True, emit_input_tap=True)
    assert not p.trx.fused_frontend
    for oj, ot in outs:
        assert set(ot.taps) == set(oj.taps)
        for k, v in oj.taps.items():
            v = np.asarray(v)
            np.testing.assert_allclose(ot.taps[k].numpy(), v, rtol=0,
                                       atol=2e-4 * max(1.0, np.abs(v).max()),
                                       err_msg=k)


def test_native_rate_equal_to_input_rate_is_a_one_sample_delay(capture):
    """ReceiverConfig(native_rate=2_304_000): the JAX receiver runs the
    rate map at 1/1, which delays the stream by one sample (rate_carry).
    The port used to drop the map at this rate; it now agrees with JAX, and
    the output differs from native_rate=0's."""
    p, outs = _run(capture, native_rate=2_304_000)
    assert p.trx.cfg.wire_len == p.trx.cfg.block_in
    q = Pair(**BASE)
    blks = wire_blocks(capture, q.trx.cfg, "c64")
    js, ts = q.warm(blks[:4])
    _, _, _, ot0 = q.step(js, ts, blks[4])
    assert np.abs(ot0.audio.numpy() - outs[0][1].audio.numpy()).max() > 1e-4


def test_wire_len_raises_with_the_jax_message():
    cfg = ReceiverConfig(native_rate=2_500_000)         # block_fm=131072
    with pytest.raises(ValueError, match="must divide by 576"):
        cfg.wire_len
    with pytest.raises(ValueError, match="must divide by 576"):
        Receiver(cfg, device="cpu")
    assert ReceiverConfig(native_rate=2_400_000).wire_len == 1_638_400


@pytest.mark.parametrize("kw", [
    dict(squelch="nsq", block_fm=8192), dict(rds="scan1"), dict(rds="scan2"),
    dict(rds="scan3"), dict(input_filter=True, native_rate=2_400_000,
                            audio_rate=192_000)],
    ids=["squelch", "scan1", "scan2", "scan3", "input_native_up"])
def test_convert_round_trip(kw):
    """state_to_numpy -> state_from_numpy is lossless for every state type
    (squelch pairs, scan-decoder states with Costas, input_filt, audio_up,
    rate_carry)."""
    rx = Receiver(ReceiverConfig(**dict(BASE, **kw)), device="cpu")
    st = rx.init_state()
    # make every leaf non-trivial
    rng = np.random.default_rng(31)

    def fill(v):
        if v.dtype == torch.bool:
            return ~v
        if v.is_complex():
            return v + torch.from_numpy(np.asarray(
                rng.standard_normal(v.shape) + 1j, np.complex64))
        return v + torch.from_numpy(np.asarray(
            rng.integers(1, 9, v.shape), np.float32)).to(v.dtype)

    def walk(t):
        if isinstance(t, tuple):
            return type(t)(*(walk(x) for x in t)) if hasattr(t, "_fields") \
                else tuple(walk(x) for x in t)
        return None if t is None else fill(t)
    st = walk(st)
    back = convert.state_from_numpy(convert.state_to_numpy(st), "cpu")

    def same(a, b, path):
        if a is None:
            assert b is None, path
        elif isinstance(a, tuple):
            assert type(a) is type(b) and len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}.{i}")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert torch.equal(a, b), path
    same(st, back, "state")
