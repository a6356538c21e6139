"""sdrjfm_tpu_torch.ops.squelch and the biquad cascades (IIRSpec / iir_apply
on the pole-bank kernel's plain version) against the JAX package and scipy,
on the CPU.

Tolerances: the cascades' residues are large (up to ~170 for the order-10
Chebyshev highpass, ~2e9 for decoder 1's bandpass) and their terms cancel,
so f32 outputs are held relative to max|y| of the float64 sosfilt: within
1e-4 of it (the JAX package itself sits at ~4e-5 on the lowpass), and port
vs JAX within 1e-4 of it.  The squelch's open/close decisions must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.ops import blockops as JB
from sdrjfm_tpu.ops import squelch as JS
from sdrjfm_tpu.rds import scan_decoders as JSD
from sdrjfm_tpu_torch.ops import blockops as TB
from sdrjfm_tpu_torch.ops import squelch as TS
from sdrjfm_tpu_torch.rds import scan_decoders as TSD

torch.set_num_threads(2)

_j_iir = jax.jit(JB.iir_apply, static_argnums=1)
_j_nsq = jax.jit(JS.noise_squelch, static_argnums=2)


def _specs():
    jq, tq = JS.make_squelch_config(), TS.make_squelch_config()
    j1, t1 = JSD.make_decoder1_config(), TSD.make_decoder1_config()
    return [("hp", jq.hp, tq.hp), ("lp", jq.lp, tq.lp),
            ("decoder1_sharp", j1.sharp, t1.sharp)]


@pytest.mark.parametrize("which", ["hp", "lp", "decoder1_sharp"])
def test_iirspec_arrays_equal(which):
    _, js, ts = next(s for s in _specs() if s[0] == which)
    for name in ("num", "poles", "residues"):
        a, b = getattr(ts, name), getattr(js, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("which", ["hp", "lp"])
def test_iir_apply_vs_jax_and_sosfilt(which):
    _, js, ts = next(s for s in _specs() if s[0] == which)
    from sdrjfm_tpu.ops import design
    sos = (design.cheby1_sos(10, 69900, JC.FM_RATE, "highpass") if which == "hp"
           else design.cheby1_sos(10, 70000, JC.FM_RATE, "lowpass"))
    rng = np.random.default_rng(21)
    x = rng.standard_normal(3 * 4096).astype(np.float32)
    jst, tst = js.zero_state(), ts.zero_state()
    yj, yt = [], []
    for b in range(3):
        blk = x[b * 4096:(b + 1) * 4096]
        a, jst = _j_iir(jnp.asarray(blk), js, jst)
        t, tst = TB.iir_apply(torch.from_numpy(blk), ts, tst)
        yj.append(np.asarray(a))
        yt.append(t.numpy())
    yj, yt = np.concatenate(yj), np.concatenate(yt)
    ref = signal.sosfilt(sos, x.astype(np.float64))
    scale = np.abs(ref).max()
    assert np.abs(yt - ref).max() <= 1e-4 * scale
    assert np.abs(yt - yj).max() <= 1e-4 * scale
    np.testing.assert_allclose(tst[0].numpy(), np.asarray(jst[0]),
                               rtol=1e-3, atol=1e-4 * scale)
    np.testing.assert_array_equal(tst[1].numpy(), np.asarray(jst[1]))


def _demod_capture(hold=8192, seed=22):
    """station (tones under 60 kHz) -> noise (high-band weighted, as an FM
    discriminator's output on no carrier) -> station, 4 hold periods each,
    with the carrier amplitude track the level squelch reads."""
    rng = np.random.default_rng(seed)
    n = 4 * hold
    t = np.arange(n) / JC.FM_RATE
    station = (0.5 * np.sin(2 * np.pi * 1000 * t)
               + 0.1 * np.sin(2 * np.pi * 19000 * t)
               + 0.2 * np.sin(2 * np.pi * 38000 * t)
               + 0.01 * rng.standard_normal(n))
    noise = np.diff(rng.standard_normal(n + 1)) * 1.5
    x = np.concatenate([station, noise, station]).astype(np.float32)
    carrier = np.concatenate([np.full(n, 1.0), np.full(n, 0.01),
                              np.full(n, 1.0)]).astype(np.float32)
    return x, carrier


@pytest.mark.parametrize("kind", ["nsq", "lsq"])
def test_gate_decisions_equal_station_noise_station(kind):
    x, carrier = _demod_capture()
    jcfg, tcfg = JS.make_squelch_config(), TS.make_squelch_config()
    jst, tst = JS.squelch_zero_state(jcfg), TS.squelch_zero_state(tcfg)
    level = 50.0
    B = 2 * jcfg.hold_period
    gj, gt = [], []
    for b in range(len(x) // B):
        xb, cb = x[b * B:(b + 1) * B], carrier[b * B:(b + 1) * B]
        lvl_j, lvl_t = jnp.asarray(level, jnp.float32), torch.tensor(level)
        if kind == "nsq":
            yj, jst = _j_nsq(jnp.asarray(xb), lvl_j, jcfg, jst)
            yt, tst = TS.noise_squelch(torch.from_numpy(xb), lvl_t, tcfg, tst)
        else:
            yj, jst = JS.level_squelch(jnp.asarray(xb), jnp.asarray(cb),
                                       lvl_j, jcfg, jst)
            yt, tst = TS.level_squelch(torch.from_numpy(xb),
                                       torch.from_numpy(cb), lvl_t, tcfg, tst)
        H = jcfg.hold_period
        gj += list((np.asarray(yj).reshape(-1, H) != 0).any(1))
        gt += list((yt.numpy().reshape(-1, H) != 0).any(1))
        np.testing.assert_array_equal(yt.numpy() == 0, np.asarray(yj) == 0)
        assert bool(tst.suppress) == bool(jst.suppress)
    assert gt == gj
    # open on the station, closed on the noise, open again
    assert all(gt[1:4]) and not any(gt[5:8]) and all(gt[9:])


@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_auto_level_matches_jax(fmt):
    from sdrjfm_tpu.io import synth as jsynth
    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from torch_parity import station_iq
    iq = station_iq(0.1, carrier_offset=0.0)
    wire = {"c64": iq, "i16": jsynth.iq_to_i16(iq),
            "u8": jsynth.iq_to_u8(iq)}[fmt]
    dj = JS.host_demod_profile(wire, fmt, 0)
    dt = TS.host_demod_profile(wire, fmt, 0)
    np.testing.assert_array_equal(dt, dj)
    assert TS.auto_squelch_level(dt) == JS.auto_squelch_level(dj)
    assert 0.0 < TS.auto_squelch_level(dt) < 100.0


def test_host_profile_i8_is_signed_over_128():
    """The port's own decision for the i8 wire (the JAX package has no i8
    branch): signed bytes / 128, the receiver's i8 decode, so an i8 capture
    profiles as its decoded complex64 stream does."""
    rng = np.random.default_rng(23)
    w = rng.integers(-128, 128, (24000, 2)).astype(np.int8)
    c = ((w[:, 0].astype(np.float32) + 1j * w[:, 1].astype(np.float32))
         / 128.0).astype(np.complex64)
    np.testing.assert_array_equal(TS.host_demod_profile(w, "i8", 1000),
                                  TS.host_demod_profile(c, "c64", 1000))
