"""The port's scopes (models/scopes.py) against the JAX package's, on the
CPU, on the same numpy inputs: spectrum (both windows, with and without the
running average), spectrum_db, map_spectrum (full and half display, zooms
up to and past the available factor: the clamp), lf_spectrum (axis,
amplitudes, effective zoom), waterfall and iq_constellation.  Tolerance:
1e-5 relative to the largest value of each output (f32 FFTs of 2048
points in two libraries), the dB outputs 1e-3 dB, host outputs exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu.models import scopes as JS
from sdrjfm_tpu_torch.models import scopes as TS

RTOL_OF_MAX = 1e-5


def _x(n=5000, cplx=True, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.7 * np.exp(2j * np.pi * 0.11 * t) + 0.05 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (x if cplx else x.real).astype(np.complex64 if cplx
                                          else np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL_OF_MAX * np.abs(want).max())


@pytest.mark.parametrize("window", ["hann", "blackman"])
@pytest.mark.parametrize("cplx", [True, False])
def test_spectrum_matches_jax(window, cplx):
    x = _x(cplx=cplx)
    _close(TS.spectrum(torch.from_numpy(x), 256, window=window).numpy(),
           JS.spectrum(jnp.asarray(x), 256, window=window))


def test_spectrum_running_average_matches_jax():
    x, prev = _x(seed=1), np.abs(_x(1024, seed=2)[:512]).astype(np.float32)
    _close(TS.spectrum(torch.from_numpy(x), 512, average=0.3,
                       prev=torch.from_numpy(prev)).numpy(),
           JS.spectrum(jnp.asarray(x), 512, average=0.3,
                       prev=jnp.asarray(prev)))


def test_spectrum_db_matches_jax():
    x = _x(10000, seed=3)
    np.testing.assert_allclose(
        TS.spectrum_db(torch.from_numpy(x)).numpy(),
        np.asarray(JS.spectrum_db(jnp.asarray(x))), rtol=0, atol=1e-3)


@pytest.mark.parametrize("show_full", [True, False])
@pytest.mark.parametrize("zoom", [1, 2, 3, 4, 8, 64])
def test_map_spectrum_matches_jax(show_full, zoom):
    bins = _x(4096, seed=4)
    got, ez = TS.map_spectrum(torch.from_numpy(bins), 256, zoom, show_full)
    want, ezj = JS.map_spectrum(jnp.asarray(bins), 256, zoom, show_full)
    assert ez == ezj
    _close(got.numpy(), want)


@pytest.mark.parametrize("show_full", [True, False])
@pytest.mark.parametrize("zoom", [1, 2, 5])
@pytest.mark.parametrize("cplx", [True, False])
def test_lf_spectrum_matches_jax(show_full, zoom, cplx):
    x = _x(16384, cplx=cplx, seed=5)
    xa, amp, ez = TS.lf_spectrum(torch.from_numpy(x), 192_000,
                                 zoom_factor=zoom, show_full=show_full)
    xj, aj, ezj = JS.lf_spectrum(jnp.asarray(x), 192_000, zoom_factor=zoom,
                                 show_full=show_full)
    assert ez == ezj
    np.testing.assert_array_equal(xa, np.asarray(xj))
    _close(amp.numpy(), aj)


def test_waterfall_matches_jax():
    rows = [np.arange(8, dtype=np.float32) * k for k in range(5)]
    np.testing.assert_array_equal(TS.waterfall(rows), JS.waterfall(rows))


@pytest.mark.parametrize("extent,grid", [(2.0, 101), (0.5, 33)])
def test_iq_constellation_matches_jax(extent, grid):
    pts = _x(3000, seed=6) * 2.5
    np.testing.assert_array_equal(TS.iq_constellation(pts, extent, grid),
                                  JS.iq_constellation(pts, extent, grid))
