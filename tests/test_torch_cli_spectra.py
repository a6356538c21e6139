"""The port's `rx --spectra` (the scopes) against the JAX CLI's npz, on the
CPU: one run of each package per `--lf-plot` tap that an `--rds` config
emits (and a zoomed one) on a 1 s synth capture at block_fm 16384; the
npz keys equal, the HF spectrum within 1e-3 dB, the LF waterfall's
amplitudes (10^(dB/20)) within 5e-4 of each row's peak (the taps agree to
~2e-4 of O(1) between the packages: f32 chains in two libraries; a dB
reading in the noise floor would magnify that), its axis exactly, the RDS
constellation's histogram within 8 of its points.  Under `--follow` the
port writes the same LF waterfall and constellation as offline, and its HF
spectrum from the first block's input tap."""

import numpy as np
import pytest
import torch

from sdrjfm_tpu import app as japp
from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.io.wavio import write_iq_wav
from sdrjfm_tpu_torch import app

import torch_parity as P

torch.set_num_threads(2)

BLOCK_FM = 16384
TAPS = ["if_filtered", "demod", "af_sum", "af_diff", "af_left_filtered",
        "af_right_filtered", "af_mono_filtered", "rds_input", "rds_baseband",
        "rds_demod"]
LF_ATOL_OF_PEAK = 5e-4


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = tmp_path_factory.mktemp("spectra")
    wav = d / "iq.wav"
    write_iq_wav(str(wav), P.station_iq(1.0), JC.INPUT_RATE, float32=False)
    return d, wav


def _spectra(fn, d, wav, name, *flags):
    npz = d / f"{name}.npz"
    assert fn(["rx", "--iq", str(wav), "--rds", "--block-fm", str(BLOCK_FM),
               "--spectra", str(npz), "--report", str(d / f"{name}.json"),
               *flags]) == 0
    return dict(np.load(npz))


def _compare(t, j):
    assert sorted(t) == sorted(j)
    np.testing.assert_allclose(t["hf_spectrum_db"], j["hf_spectrum_db"],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(t["hf_rate"], j["hf_rate"])
    np.testing.assert_array_equal(t["lf_x_axis_khz"], j["lf_x_axis_khz"])
    wt, wj = t["lf_waterfall_db"], j["lf_waterfall_db"]
    assert wt.shape == wj.shape and wt.shape[1] == 512
    at, aj = 10.0 ** (wt / 20.0), 10.0 ** (wj / 20.0)
    assert (np.abs(at - aj) <= LF_ATOL_OF_PEAK
            * aj.max(axis=1, keepdims=True)).all()
    ct, cj = t["rds_constellation"], j["rds_constellation"]
    assert ct.shape == cj.shape == (101, 101) and ct.sum() == cj.sum()
    assert np.abs(ct - cj).sum() <= 8


@pytest.mark.parametrize("tap,zoom", [(t, "1") for t in TAPS]
                         + [("demod", "3")],
                         ids=TAPS + ["demod_zoom3"])
def test_spectra_match_the_jax_cli(capture, tap, zoom):
    d, wav = capture
    flags = ["--lf-plot", tap, "--lf-zoom", zoom]
    t = _spectra(app.main, d, wav, f"t_{tap}_{zoom}", *flags, "--device",
                 "cpu")
    j = _spectra(japp.main, d, wav, f"j_{tap}_{zoom}", *flags)
    _compare(t, j)


def test_lf_spectrum_shorter_than_a_segment_is_nan_as_jax():
    from sdrjfm_tpu.models import scopes as JS
    from sdrjfm_tpu_torch.models import scopes as TS
    import jax.numpy as jnp
    x = np.ones(1000, np.complex64)
    _, amp, _ = TS.lf_spectrum(torch.from_numpy(x), 24000)
    _, amp_j, _ = JS.lf_spectrum(jnp.asarray(x), 24000)
    assert np.isnan(amp.numpy()).all() and np.isnan(np.asarray(amp_j)).all()


def test_spectra_under_follow(capture):
    d, wav = capture
    off = _spectra(app.main, d, wav, "offline", "--device", "cpu")
    fol = _spectra(app.main, d, wav, "follow", "--follow", "--no-pace",
                   "--device", "cpu")
    assert sorted(fol) == ["hf_spectrum_db", "lf_waterfall_db",
                           "lf_x_axis_khz", "rds_constellation"]
    for k in ("lf_waterfall_db", "lf_x_axis_khz", "rds_constellation"):
        np.testing.assert_array_equal(fol[k], off[k])
    assert fol["hf_spectrum_db"].shape == (512,)
    assert np.isfinite(fol["hf_spectrum_db"]).all()
