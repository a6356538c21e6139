"""The port's `rx` flags against the JAX CLI's, on the CPU.

Each case runs both CLIs on the same synth capture (2 s, block_fm=16384)
with the same flags and compares their reports: block and sample counts
equal, the last block's metadata within 1e-3 (booleans equal), the RDS
report (PI, PS, RT, groups, BER) equal -- with decoders 1 and 2, whose
start-up from the zero state is not reproducible across libraries (see
test_torch_scan_decoders.py), PI and BER equal and the group counts within
2 --; the audio wavs within 2e-4, the
dumps within 2e-4 of their scale.  Each rx flag of the device, control,
checkpoint and profile surface runs on a short capture (or fails for want
of its device) as it does in the JAX CLI: the same exit code and message,
the same report, and the same checkpoint steps, saved states (every leaf
within 1e-3 of its scale) and settings files.  A live source without its
device exits 2 as in the JAX CLI; `--ckpt-backend orbax` is refused naming
ROADMAP.md.
"""

import json
import os

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


@pytest.fixture(scope="module")
def short(tmp_path_factory):
    """0.1 s (four blocks of block_fm 4096) and a state the port saved
    after them."""
    from sdrjfm_tpu.io.wavio import write_iq_wav
    d = tmp_path_factory.mktemp("short")
    wav = d / "short.wav"
    write_iq_wav(str(wav), station_iq(0.1, carrier_offset=0.0), 2_304_000,
                 float32=False)
    state = d / "state.npz"
    assert app.main(["rx", "--iq", str(wav), "--block-fm", "4096",
                     "--save-state", str(state), "--device", "cpu"]) == 0
    return wav, state


# flag -> (the flag's arguments, stdin for --control -, what else to hold
# equal).  The device settings without their device exit 2 with the JAX
# CLI's message; the rest run the short capture.
FLAG_CASES = {
    "--tune-hz": (["--iq", "rtl_tcp://127.0.0.1:1", "--tune-hz",
                   "94300000"], None, None),
    "--save-state": (["--save-state", "{d}/s_{who}.npz"], None, "state"),
    "--ckpt-backend": (["--ckpt-backend", "bogus"], None, None),
    "--load-state": (["--load-state", "{state}"], None, None),
    "--ckpt-dir": (["--ckpt-dir", "{d}/ck_{who}", "--ckpt-every", "1"], None,
                   "ckpt"),
    "--ckpt-every": (["--ckpt-dir", "{d}/ck_{who}", "--ckpt-every", "2"],
                     None, "ckpt"),
    "--ckpt-keep": (["--ckpt-dir", "{d}/ck_{who}", "--ckpt-every", "1",
                     "--ckpt-keep", "1"], None, "ckpt"),
    "--ckpt-keep-period": (["--ckpt-dir", "{d}/ck_{who}", "--ckpt-every",
                            "1", "--ckpt-keep", "1", "--ckpt-keep-period",
                            "2"], None, "ckpt"),
    "--profile": (["--profile", "{d}/prof_{who}"], None, "profile"),
    "--control": (["--control", "-"], "volume -6\nbalance 20\nstatus\n",
                  None),
    "--gain": (["--gain", "297"], None, None),
    "--agc": (["--agc"], None, None),
    "--ppm": (["--ppm", "5"], None, None),
    "--linearity": (["--linearity", "12"], None, None),
    "--sensitivity": (["--sensitivity", "7"], None, None),
    "--grdb": (["--grdb", "40"], None, None),
    "--lna-state": (["--lna-state", "3"], None, None),
    "--lna-gain": (["--lna-gain", "24"], None, None),
    "--vga-gain": (["--vga-gain", "30"], None, None),
    "--amp": (["--amp"], None, None),
    "--reconnect-timeout": (["--reconnect-timeout", "5"], None, None),
    "--stations": (["--stations", "{d}/st_{who}.json", "--control", "-"],
                   "save Here\nstations\n", "stations"),
    "--meter": (["--follow", "--no-pace", "--meter"], None, "meter"),
    "--config": (["--config", "{d}/c_{who}.json", "--volume-db", "-2"],
                 None, "config"),
}


def _flag_run(main, who, d, wav, state, flags, stdin, extra, monkeypatch,
              capsys):
    import io
    import sys
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    argv = ["rx", "--iq", str(wav), "--block-fm", "4096", "--report",
            str(d / f"r_{who}.json")]
    argv += [f.format(d=d, who=who, state=state) for f in flags]
    try:
        rc = main(argv + list(extra))
    except SystemExit as e:               # argparse's own exit
        rc = ("exit", e.code)
    err = capsys.readouterr().err
    rep = (json.loads((d / f"r_{who}.json").read_text()) if rc == 0
           else None)
    return rc, rep, err


@pytest.mark.parametrize("flag", list(FLAG_CASES))
def test_rx_flag_matches_jax_cli(flag, short, tmp_path, monkeypatch,
                                 capsys):
    wav, state = short
    flags, stdin, also = FLAG_CASES[flag]
    got = {}
    for who, main, extra in (("jax", japp.main, ()),
                             ("port", app.main, ("--device", "cpu"))):
        got[who] = _flag_run(main, who, tmp_path, wav, state, flags, stdin,
                             extra, monkeypatch, capsys)
    (rcj, rj, ej), (rct, rt, et) = got["jax"], got["port"]
    assert rct == rcj
    if rct != 0:
        # the device settings without their device, a bad choice (argparse
        # prefixes its program name)
        last = lambda e: e.strip().splitlines()[-1].split(" rx: ")[-1]  # noqa: E731
        assert last(et) == last(ej)
        return
    assert rt["blocks"] == rj["blocks"] == 4
    for k, v in rj["meta_last"].items():
        if isinstance(v, bool):
            assert rt["meta_last"][k] == v, k
        elif k != "latency_ms":
            assert abs(rt["meta_last"][k] - v) <= 1e-3 * max(1, abs(v)), k
    assert rt.get("control") == rj.get("control")
    d = tmp_path
    if also == "state":
        from sdrjfm_tpu_torch.runtime.checkpoint import FORMAT_VERSION
        a, b = np.load(d / "s_port.npz"), np.load(d / "s_jax.npz")
        assert sorted(a.files) == sorted(b.files)
        meta = json.loads(a["__meta__"].tobytes())
        assert meta == json.loads(b["__meta__"].tobytes())
        assert meta["format_version"] == FORMAT_VERSION
        for k in a.files:
            x, y = a[k], b[k]
            assert x.shape == y.shape and x.dtype == y.dtype, k
            if x.dtype.kind in "fc" and k != "__meta__":
                np.testing.assert_allclose(
                    x, y, rtol=0, atol=1e-3 * max(1.0, np.abs(y).max()),
                    err_msg=k)
    elif also == "ckpt":
        assert sorted(os.listdir(d / "ck_port")) == \
            sorted(os.listdir(d / "ck_jax"))
    elif also == "profile":
        assert any((d / "prof_jax").iterdir())
        assert list((d / "prof_port").glob("trace_*.json"))
    elif also == "stations":
        assert json.loads((d / "st_port.json").read_text()) == \
            json.loads((d / "st_jax.json").read_text())
    elif also == "meter":
        assert "pilot=" in et and "pilot=" in ej
    elif also == "config":
        assert json.loads((d / "c_port.json").read_text()) == \
            json.loads((d / "c_jax.json").read_text())


def test_orbax_backend_is_refused_naming_roadmap(short, tmp_path, capsys):
    wav, _ = short
    assert app.main(["rx", "--iq", str(wav), "--block-fm", "4096",
                     "--ckpt-backend", "orbax", "--save-state",
                     str(tmp_path / "s"), "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "orbax" in err and "ROADMAP" in err
    assert not (tmp_path / "s").exists()


@pytest.mark.parametrize("src", ["rtl_tcp://localhost:1234", "rtlsdr",
                                 "airspy", "-"])
def test_live_sources_are_refused(src, capsys, monkeypatch, tmp_path):
    """Without a server or a library both CLIs exit 2 with "loading device
    failed"; stdin, headerless, without its wire format."""
    for env in ("RTLSDR", "AIRSPY"):
        monkeypatch.setenv(f"SDRJFM_LIB{env}", str(tmp_path / "none.so"))
    assert japp.main(["rx", "--iq", src, "--block-fm", "12288"]) == 2
    jerr = capsys.readouterr().err.strip().splitlines()[-1]
    assert app.main(["rx", "--iq", src, "--block-fm", "12288", "--device",
                     "cpu"]) == 2
    terr = capsys.readouterr().err.strip().splitlines()[-1]
    assert terr == jerr
    assert ("--iq-format" if src == "-" else "loading device failed") in terr
