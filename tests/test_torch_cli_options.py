"""The port's `rx` flags against the JAX CLI's, on the CPU.

Each case runs both CLIs on the same synth capture (2 s, block_fm=16384)
with the same flags and compares their reports: block and sample counts
equal, the last block's metadata within 1e-3 (booleans equal), the RDS
report (PI, PS, RT, groups, BER) equal -- with decoders 1 and 2, whose
start-up from the zero state is not reproducible across libraries (see
test_torch_scan_decoders.py), PI and BER equal and the group counts within
2 --; the audio wavs within 2e-4, the
dumps within 2e-4 of their scale.  Every flag still listed in
UNPORTED_RX_FLAGS is refused with exit 2.
"""

import json

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

import jax  # noqa: F401  (JAX on the CPU, as conftest sets)
from sdrjfm_tpu import app as japp
from sdrjfm_tpu.io import synth as jsynth
from sdrjfm_tpu.io.wavio import read_wav
from sdrjfm_tpu_torch import app

from torch_parity import station_iq

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    iq = station_iq(2.0, carrier_offset=0.0)
    from sdrjfm_tpu.io.wavio import write_iq_wav
    wav = d / "iq.wav"
    write_iq_wav(str(wav), iq, 2_304_000, float32=False)
    # an rtl-sdr style raw u8 capture at 2.4 MS/s
    raw = d / "iq_2400k.u8"
    jsynth.iq_to_u8(resample_poly(iq, 25, 24).astype(np.complex64)).tofile(
        str(raw))
    return d, wav, raw


CASES = {
    "scan2_pll_pano": ["--rds", "--rds-decoder", "scan2", "--decoder", "pll",
                       "--mode", "stereo_pano", "--panorama", "0.5",
                       "--sound", "left_plus_right", "--deemphasis", "us",
                       "--volume-db", "-3", "--balance", "20",
                       "--pty-locale", "1", "--float32"],
    "nsq_auto_filter_ref_192k_tone": [
        "--rds", "--squelch", "nsq", "--squelch-level", "auto",
        "--fm-bandwidth", "200", "--dc-remove", "off", "--frontend",
        "reference", "--audio-192k", "--test-tone"],
    "lsq_scan3_dumps": ["--rds", "--rds-decoder", "scan3", "--squelch", "lsq",
                        "--squelch-level", "20", "--audio-filter", "0",
                        "--taps", "--dump-input", "{d}/in_{who}.wav",
                        "--dump-if", "{d}/if_{who}.wav",
                        "--dump-mpx", "{d}/mpx_{who}.wav"],
    "raw_u8_2400k_scan1": ["--rds", "--rds-decoder", "scan1",
                           "--iq-format", "u8", "--input-rate", "2400000",
                           "--input-filter", "--sound", "stereo_swapped"],
}


def _run(main, who, d, src, flags, extra=()):
    flags = [f.format(d=d, who=who) for f in flags]
    rep, audio = d / f"rep_{who}.json", d / f"audio_{who}.wav"
    rc = main(["rx", "--iq", str(src), "--audio", str(audio), "--report",
               str(rep), "--block-fm", "16384", *flags, *extra])
    assert rc == 0, who
    return json.loads(rep.read_text()), read_wav(str(audio))


@pytest.mark.parametrize("case", list(CASES))
def test_rx_flags_report_matches_jax_cli(captures, case):
    d, wav, raw = captures
    src = raw if "--input-rate" in CASES[case] else wav
    rj, (aj, ij) = _run(japp.main, "jax", d, src, CASES[case])
    rt, (at, it) = _run(app.main, "torch", d, src, CASES[case],
                        ("--device", "cpu"))
    assert rt["blocks"] == rj["blocks"] and rt["input_samples"] == \
        rj["input_samples"]
    for k, v in rj["meta_last"].items():
        if isinstance(v, bool):
            assert rt["meta_last"][k] == v, k
        else:
            assert abs(rt["meta_last"][k] - v) <= 1e-3 * max(1, abs(v)), k
    startup = any(f in CASES[case] for f in ("scan1", "scan2"))
    for k in ("pi_code", "bit_error_rate") if startup else (
            "pi_code", "station_label", "radio_text", "groups_decoded",
            "bit_error_rate"):
        assert rt["rds"][k] == rj["rds"][k], k
    assert abs(rt["rds"]["groups_decoded"] - rj["rds"]["groups_decoded"]) <= 2
    assert rt["rds"]["pi_code"] == "0x10F0"
    assert it.rate == ij.rate and at.dtype == aj.dtype
    np.testing.assert_allclose(at, aj, rtol=0, atol=2e-4)
    if "--dump-if" in CASES[case]:
        for name in ("in", "if", "mpx"):
            xt, _ = read_wav(str(d / f"{name}_torch.wav"))
            xj, _ = read_wav(str(d / f"{name}_jax.wav"))
            assert xt.shape == xj.shape
            np.testing.assert_allclose(
                xt, xj, rtol=0, atol=2e-4 * max(1.0, np.abs(xj).max()))


def test_input_rate_that_does_not_tile_a_block_exits_2(captures, capsys):
    d, wav, _ = captures
    assert app.main(["rx", "--iq", str(wav), "--input-rate", "2500000",
                     "--device", "cpu"]) == 2
    assert "must divide by 576" in capsys.readouterr().err


@pytest.mark.parametrize("flag", app.UNPORTED_RX_FLAGS)
def test_unported_flag_is_refused(flag, capsys):
    assert app.main(["rx", "--iq", "x.wav", flag, "1", "--device",
                     "cpu"]) == 2
    assert "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("src", ["rtl_tcp://localhost:1234", "rtlsdr",
                                 "airspy", "-"])
def test_live_sources_are_refused(src, capsys):
    assert app.main(["rx", "--iq", src, "--device", "cpu"]) == 2
    assert "ROADMAP" in capsys.readouterr().err
