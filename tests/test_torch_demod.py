"""sdrjfm_tpu_torch.ops.demod == sdrjfm_tpu.ops.demod on the CPU, for all six
discriminators, over split blocks with their carries.

The input is a numpy-seeded FM-modulated tone with noise (a few samples
below the small-signal clamp included).  Tolerance: the outputs are atan2 /
asin / ratio discriminators scaled by 20/K_FM followed by f32 one-pole
trackers in two libraries (the port's chunked scan against JAX's
associative scan): within 2e-5 of the O(0.1-1) output, carries within 1e-5.
`real_baseband` takes asin(2u - 1), whose slope 1/sqrt(1 - x^2) is
unbounded at the clamp edge: there one f32 ulp of u moves the output by up
to sqrt(2 * 2^-23) ~ 5e-4 rad, so its outputs are held within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.ops import demod as JD
from sdrjfm_tpu_torch.ops import demod as TD

torch.set_num_threads(2)

_j_demod = jax.jit(JD.demodulate_block, static_argnums=(2, 3))


def _signal(n=6144, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / JC.FM_RATE
    phase = 2 * np.pi * 75e3 / JC.FM_RATE * np.cumsum(
        0.5 * np.sin(2 * np.pi * 1000 * t) + 0.2 * np.sin(2 * np.pi * 19e3 * t))
    amp = 0.8 + 0.1 * np.sin(2 * np.pi * 300 * t)
    z = amp * np.exp(1j * phase) + 0.02 * (rng.standard_normal(n)
                                           + 1j * rng.standard_normal(n))
    z[100:104] = 1e-4                       # below the small-signal clamp
    return z.astype(np.complex64)


def _tstate(js):
    return TD.DemodState(*(torch.from_numpy(np.array(v)) for v in js))


@pytest.mark.parametrize("decoder", TD.DECODERS)
def test_discriminator_matches_jax_over_split_blocks(decoder):
    assert TD.DECODERS == JD.DECODERS
    z = _signal()
    js = JD.demod_zero_state()
    ts = TD.demod_zero_state()
    for lo, hi in ((0, 2048), (2048, 4096), (4096, 6144)):
        blk = z[lo:hi]
        yj, js, cj = _j_demod(jnp.asarray(blk), js, decoder, JC.FM_RATE)
        yt, ts, ct = TD.demodulate_block(torch.from_numpy(blk), ts, decoder,
                                         JC.FM_RATE)
        np.testing.assert_allclose(
            yt.numpy(), np.asarray(yj), rtol=0,
            atol=1e-3 if decoder == "real_baseband" else 2e-5)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                                   atol=1e-6)
        for name in TD.DemodState._fields:
            np.testing.assert_allclose(np.asarray(getattr(ts, name)),
                                       np.asarray(getattr(js, name)),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    if decoder == "pll":
        assert float(ts.pll_incr) != 0.0          # the estimate is carried


def test_unknown_decoder_raises():
    with pytest.raises(ValueError):
        TD.demodulate_block(torch.zeros(8, dtype=torch.complex64),
                            TD.demod_zero_state(), "fm2")
