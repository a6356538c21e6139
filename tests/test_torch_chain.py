"""The port's 192 kS/s and 24 kS/s stages == the JAX package's, on the CPU,
each over several blocks with both packages carrying their own state.

Inputs: a stereo+RDS multiplex from the synth module, FM-modulated straight
at 192 kS/s (the discriminator's input rate), and a biphase RDS baseband at
24 kS/s, all from numpy seeds.  Stage outputs of the JAX side feed the next
stage of both sides, so each test isolates one module.  Tolerances are
stated per test; the RDS bits must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.io import synth
from sdrjfm_tpu.ops import demod as JD
from sdrjfm_tpu.ops import pilot as JP
from sdrjfm_tpu.ops import pss as JS
from sdrjfm_tpu.rds import bitrecovery as JR
from sdrjfm_tpu.rds import encode
from sdrjfm_tpu_torch.ops import demod as TD
from sdrjfm_tpu_torch.ops import pilot as TP
from sdrjfm_tpu_torch.ops import pss as TS
from sdrjfm_tpu_torch.rds import bitrecovery as TR

torch.set_num_threads(2)

BLOCK = 16384
NBLK = 12                          # ~1.02 s: the pilot lock (0.5 s hold) sets


def _t(a):
    return torch.from_numpy(np.array(a))


_jdemod = jax.jit(JD.demodulate_block, static_argnames=("decoder",))


@pytest.fixture(scope="module")
def if_blocks():
    """FM baseband at 192 kS/s with pilot, stereo and RDS, plus noise."""
    n = NBLK * BLOCK
    t = np.arange(n) / JC.FM_RATE
    left = 0.6 * np.sin(2 * np.pi * 1000 * t)
    right = 0.6 * np.sin(2 * np.pi * 440 * t)
    syms = encode.differential_encode(encode.make_bitstream(
        pi=0x10F0, pty=10, station="TPU FM", radiotext="CHAIN\r", repeats=2))
    mpx = synth.synth_mpx(left, right, synth.MPXParams(rds_level=0.07),
                          rds_bits=syms)
    z = synth.fm_modulate(mpx, JC.FM_RATE, out_rate=JC.FM_RATE,
                          amplitude=0.7, noise_std=0.02, seed=1)
    return [z[b * BLOCK:(b + 1) * BLOCK] for b in range(NBLK)]


@pytest.fixture(scope="module")
def demod_blocks(if_blocks):
    st = JD.demod_zero_state()
    out = []
    for z in if_blocks:
        d, st, _ = _jdemod(jnp.asarray(z), st, decoder="complex_baseband")
        out.append(np.asarray(d))
    return out


@pytest.mark.parametrize("decoder", ["complex_baseband", "mixed"])
def test_demodulate_block_matches_jax(if_blocks, decoder):
    """atol 2e-4 on demod of amplitude ~1.5: atan2 of f32 products, and
    AFC scans that may differ by 5e-5 of their scale (the scan bound of
    test_torch_blockops)."""
    js, ts = JD.demod_zero_state(), TD.demod_zero_state("cpu")
    for z in if_blocks[:4]:
        dj, js, aj = _jdemod(jnp.asarray(z), js, decoder=decoder)
        dt, ts, at = TD.demodulate_block(_t(z), ts, decoder)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                                   atol=2e-4)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0,
                                   atol=1e-5)
    for f in ("prev1", "prev2"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), atol=1e-6)
    # tracker ends: the scans' f32 association error, as above
    assert abs(float(ts.am_carr) - float(js.am_carr)) <= 1e-5
    assert abs(float(ts.fm_afc) - float(js.fm_afc)) <= 1e-5


def test_other_discriminators_raise(if_blocks):
    """All six discriminators are ported now (test_torch_demod.py holds
    each to JAX); only a name the JAX package does not know raises."""
    with pytest.raises(ValueError, match="unknown decoder"):
        TD.demodulate_block(_t(if_blocks[0]), TD.demod_zero_state("cpu"),
                            "fm2")
    y, _, _ = TD.demodulate_block(_t(if_blocks[0]),
                                  TD.demod_zero_state("cpu"), "pll")
    assert torch.isfinite(y).all()


def test_recover_pilot_matches_jax(demod_blocks):
    """Phase within 2e-4 rad where the pilot is strong; strength within
    1e-5; the lock flags and run length exactly (the strength sits far from
    the 0.07 threshold once locked)."""
    jcfg = JP.make_pilot_config(JC.FM_RATE, 8192, hop=4096)
    tcfg = TP.make_pilot_config(JC.FM_RATE, 8192, hop=4096)
    np.testing.assert_array_equal(tcfg.response, jcfg.response)
    js, ts = JP.pilot_zero_state(jcfg), TP.pilot_zero_state(tcfg, "cpu")
    jpilot = jax.jit(lambda d, s: JP.recover_pilot(d, jcfg, s))
    locked_seen = False
    for d in demod_blocks:
        pj, js = jpilot(jnp.asarray(d), js)
        pt, ts = TP.recover_pilot(_t(d), tcfg, ts)
        dphi = np.angle(np.exp(1j * (pt.phase.numpy()
                                     - np.asarray(pj.phase))))
        strong = np.asarray(pj.strength) > 0.1
        assert np.abs(dphi[strong]).max(initial=0.0) <= 2e-4
        np.testing.assert_allclose(pt.strength.numpy(),
                                   np.asarray(pj.strength), atol=1e-5)
        np.testing.assert_array_equal(pt.locked.numpy(), np.asarray(pj.locked))
        locked_seen |= bool(np.asarray(pj.locked)[-1])
    assert locked_seen
    assert int(ts.lock_run) == int(js.lock_run)


def test_pss_adapt_matches_jax(demod_blocks):
    """Offsets and acc within 1e-5 rad over 4 locked blocks (32 scalar
    steps per block of f32 arithmetic on sums of 4096 products); the
    integer run counters and flags exactly."""
    jcfg = JS.make_pss_config(JC.FM_RATE, 4096)
    tcfg = TS.make_pss_config(JC.FM_RATE, 4096, device="cpu")
    np.testing.assert_array_equal(tcfg.kernel.numpy(), jcfg.kernel)
    np.testing.assert_array_equal(tcfg.ema_weights.numpy(), jcfg.ema_weights)
    js, ts = JS.pss_zero_state(jcfg), TS.pss_zero_state(tcfg, "cpu")
    jpss = jax.jit(lambda d, bp, lk, s: JS.pss_adapt(d, bp, lk, jcfg, s))
    rng = np.random.default_rng(3)
    base = 2.0 * (np.cumsum(np.full(4 * BLOCK, 2 * np.pi * 19000 / 192000))
                  + 0.3) + 0.05 * rng.standard_normal(4 * BLOCK)
    base = base.astype(np.float32)
    locked = np.ones(BLOCK, bool)
    locked[:5000] = False                       # exercise the reset
    for b, d in enumerate(demod_blocks[-4:]):
        lk = locked if b == 0 else np.ones(BLOCK, bool)
        bp = base[b * BLOCK:(b + 1) * BLOCK]
        oj, js = jpss(jnp.asarray(d), jnp.asarray(bp), jnp.asarray(lk), js)
        ot, ts = TS.pss_adapt(_t(d), _t(bp), _t(lk), tcfg, ts)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                                   atol=1e-5)
    assert abs(float(ts.acc) - float(js.acc)) <= 1e-5
    assert abs(float(ts.mean_error) - float(js.mean_error)) <= 1e-6
    for f in ("minimized", "lock_run", "unlock_run"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    np.testing.assert_allclose(ts.tail.numpy(), np.asarray(js.tail),
                               atol=1e-5)


def test_recover_bits_matches_jax():
    """Bits, valid mask, count and timing state exactly; constellation
    points within 1e-4 over 4 blocks of 2048 samples at 24 kS/s."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, 2000).astype(np.int8)
    n = 4 * 2048
    bb = synth.rds_baseband(bits, n + 200, JC.RDS_RATE)[37:37 + n]
    z = (0.3 * bb * np.exp(1j * 0.7)
         + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    jcfg = JR.make_bitrecovery_config(JC.RDS_RATE, phase_sub=2048)
    tcfg = TR.make_bitrecovery_config(JC.RDS_RATE, phase_sub=2048,
                                      device="cpu")
    np.testing.assert_array_equal(tcfg.mf_taps.numpy(), jcfg.mf_taps)
    js, ts = JR.bitrecovery_zero_state(jcfg), TR.bitrecovery_zero_state(
        tcfg, "cpu")
    jbits = jax.jit(lambda z, s: JR.recover_bits(z, jcfg, s))
    for b in range(4):
        blk = z[b * 2048:(b + 1) * 2048]
        bj, dj, js = jbits(jnp.asarray(blk), js)
        bt, dt, ts = TR.recover_bits(_t(blk), tcfg, ts)
        assert int(bt.count) == int(bj.count)
        np.testing.assert_array_equal(bt.valid.numpy(), np.asarray(bj.valid))
        np.testing.assert_array_equal(bt.bits.numpy(), np.asarray(bj.bits))
        np.testing.assert_allclose(bt.iq.numpy(), np.asarray(bj.iq),
                                   atol=1e-4)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4)
    assert abs(float(ts.tau) - float(js.tau)) <= 1e-4
    assert abs(float(ts.psi) - float(js.psi)) <= 1e-4
    assert bool(ts.prev_sym) == bool(js.prev_sym)
    assert bool(ts.timing_locked) and bool(js.timing_locked)
