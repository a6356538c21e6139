"""The port's in-process USB devices (librtlsdr, libairspy, libhackrf,
libsdrplay_api through dlopen) against the JAX package's, on the CPU, with
the in-tree fake vendor libraries (tests/fake_lib*.c, compiled with cc).

Each fake streams a planted station once (1.6 s, the whole capture inside
the ring, so no run drops a frame) in its device's wire format: rtlsdr u8,
hackrf i8, sdrplay i16 at 2.304 MS/s, airspy i16 at its negotiated 2.5
MS/s (block_fm 12288, whose blocks that rate tiles).  `rx --iq <device>`
gives the JAX CLI's report: the blocks, the RDS (PI/PS at BER 0), the last
block's metadata within 1e-3; the settings reach the fake as JAX's do.  A
missing library, or no device, exits 2 with "loading device failed" as in
the JAX CLI, and so does `scan` over a missing one.  `scan --iq rtlsdr`
sweeps the fake dongle across the band as the JAX CLI does.
"""

import ctypes
import json

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

import jax  # noqa: F401  (JAX on the CPU, as conftest sets)
from sdrjfm_tpu import app as japp
from sdrjfm_tpu.io import synth as jsynth
from sdrjfm_tpu_torch import app

from torch_parity import build_fake_lib, named_station_iq

torch.set_num_threads(2)

# device -> (fake library, env prefix, --iq, wire writer, flags, block_fm)
DEVICES = {
    "rtlsdr": ("rtlsdr", "RTLSDR", "rtlsdr:0",
               lambda iq: jsynth.iq_to_u8(iq),
               ["--tune-hz", "94300000", "--gain", "297", "--ppm", "5"],
               16384),
    "hackrf": ("hackrf", "HACKRF", "hackrf",
               lambda iq: jsynth.iq_to_i8(iq * 0.95),
               ["--tune-hz", "94300000", "--lna-gain", "24", "--vga-gain",
                "30", "--amp"], 16384),
    "sdrplay": ("sdrplay", "SDRPLAY", "sdrplay",
                lambda iq: _i16(iq, 4095),
                ["--tune-hz", "94300000", "--grdb", "40", "--lna-state",
                 "3", "--agc", "--ppm", "2"], 16384),
    "airspy": ("airspy", "AIRSPY", "airspy",
               lambda iq: _i16(resample_poly(iq, 625, 576), 2047),
               ["--tune-hz", "94300000", "--linearity", "12",
                "--sensitivity", "7"], 12288),
}


def _i16(iq, scale):
    out = np.empty((len(iq), 2), np.int16)
    out[:, 0] = np.round(iq.real * scale)
    out[:, 1] = np.round(iq.imag * scale)
    return out


@pytest.fixture(scope="module")
def station():
    return named_station_iq(1.6, 0xDAB5, "DLOPENRX", (700.0, 300.0))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fakelibs")
    return {name: build_fake_lib(name, d) for name in DEVICES}


def _env(monkeypatch, name, lib, capture, fps="50000000"):
    _, env, *_ = DEVICES[name]
    monkeypatch.setenv(f"SDRJFM_LIB{env}", lib)
    monkeypatch.setenv(f"FAKE_{env}_IQ", capture)
    monkeypatch.setenv(f"FAKE_{env}_FPS", fps)
    monkeypatch.setenv(f"FAKE_{env}_LOOP", "0")
    monkeypatch.delenv(f"FAKE_{env}_IQ_DIR", raising=False)


@pytest.mark.parametrize("name", list(DEVICES))
def test_rx_from_fake_device_matches_jax_cli(name, libs, station, tmp_path,
                                             monkeypatch):
    lib_name, env, iq_arg, wire, flags, block_fm = DEVICES[name]
    capture = tmp_path / "capture.raw"
    wire(station).tofile(capture)
    _env(monkeypatch, name, libs[name], str(capture))
    reps, settings = {}, {}
    # held open across both runs, so that a device's close (dlclose) does
    # not unload the fake and lose what it recorded
    fake = ctypes.CDLL(libs[name])
    for who, main, extra in (("jax", japp.main, []),
                             ("port", app.main, ["--device", "cpu"])):
        rep = tmp_path / f"{who}.json"
        assert main(["rx", "--iq", iq_arg, "--rds", "--report", str(rep),
                     "--block-fm", str(block_fm), *flags, *extra]) == 0
        reps[who] = json.loads(rep.read_text())
        settings[who] = _fake_settings(fake, name)
    rj, rt = reps["jax"], reps["port"]
    assert settings["port"] == settings["jax"]
    assert rt["blocks"] == rj["blocks"] > 0
    assert rt["input_samples"] == rj["input_samples"]
    assert rt["ingest_dropped"] == rj["ingest_dropped"] == 0
    for k in ("pi_code", "station_label", "bit_error_rate"):
        assert rt["rds"][k] == rj["rds"][k], k
    assert rt["rds"]["pi_code"] == "0xDAB5"
    assert rt["rds"]["station_label"] == "DLOPENRX"
    assert rt["rds"]["bit_error_rate"] == 0.0
    for k, v in rj["meta_last"].items():
        if k in ("latency_ms", "ingest_dropped"):
            continue
        if isinstance(v, bool):
            assert rt["meta_last"][k] == v, k
        else:
            assert abs(rt["meta_last"][k] - v) <= 1e-3 * max(1, abs(v)), k
    assert rt["meta_last"]["pilot_locked"]


def _fake_settings(fake, name):
    """What the fake library last saw, where it reports it."""
    if name == "airspy":
        return (fake.fake_airspy_last_rate(), fake.fake_airspy_last_freq(),
                fake.fake_airspy_last_linearity(),
                fake.fake_airspy_last_sensitivity())
    if name == "hackrf":
        fake.fake_hackrf_last_rate.restype = ctypes.c_double
        fake.fake_hackrf_last_freq.restype = ctypes.c_uint64
        return (fake.fake_hackrf_last_rate(), fake.fake_hackrf_last_freq(),
                fake.fake_hackrf_last_lna())
    return None


@pytest.mark.parametrize("name", list(DEVICES))
def test_missing_library_exits_2_as_jax_cli(name, tmp_path, capsys,
                                            monkeypatch):
    _, env, iq_arg, *_ = DEVICES[name]
    monkeypatch.setenv(f"SDRJFM_LIB{env}", str(tmp_path / "no_such.so"))
    assert japp.main(["rx", "--iq", iq_arg, "--rds", "--block-fm",
                      "12288"]) == 2
    jerr = capsys.readouterr().err.strip().splitlines()[-1]
    assert app.main(["rx", "--iq", iq_arg, "--rds", "--block-fm", "12288",
                     "--device", "cpu"]) == 2
    terr = capsys.readouterr().err.strip().splitlines()[-1]
    assert terr == jerr and terr.startswith(f"loading device failed: "
                                            f"{iq_arg}")


@pytest.mark.parametrize("name", ["airspy", "hackrf", "sdrplay"])
def test_no_device_plugged_in_exits_2_as_jax_cli(name, libs, capsys,
                                                 monkeypatch):
    _, env, iq_arg, *_ = DEVICES[name]
    monkeypatch.setenv(f"SDRJFM_LIB{env}", libs[name])
    monkeypatch.setenv(f"FAKE_{env}_PRESENT", "0")
    assert japp.main(["rx", "--iq", iq_arg, "--block-fm", "12288"]) == 2
    jerr = capsys.readouterr().err.strip().splitlines()[-1]
    assert app.main(["rx", "--iq", iq_arg, "--block-fm", "12288",
                     "--device", "cpu"]) == 2
    terr = capsys.readouterr().err.strip().splitlines()[-1]
    assert terr == jerr and "loading device failed" in terr


def test_airspy_rate_that_does_not_tile_the_block_exits_2(libs, station,
                                                          tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """2.5 MS/s does not tile block_fm 131072: the port exits 2 naming the
    tiling (JAX's wire_len asserts; ROADMAP queue 3, standing decisions)
    and releases the device."""
    capture = tmp_path / "a.raw"
    DEVICES["airspy"][3](station[:100_000]).tofile(capture)
    _env(monkeypatch, "airspy", libs["airspy"], str(capture))
    assert app.main(["rx", "--iq", "airspy", "--device", "cpu"]) == 2
    assert "must divide by 576" in capsys.readouterr().err


def test_scan_sweeps_the_fake_dongle_as_jax_cli(libs, tmp_path, monkeypatch,
                                                capsys):
    """`scan --iq rtlsdr:0` over the frequency-aware fake (one capture per
    tuned centre): the JAX CLI's hits, the planted station among them."""
    from test_rtlsdr_dlopen import _sweep_centers
    from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig

    d = tmp_path / "centers"
    d.mkdir()
    rng = np.random.default_rng(1)
    n = 1_200_000
    planted = named_station_iq(n / 2_304_000 + 0.01, 0x4D4D, "DLSWEEP ")
    t = np.arange(n) / 2_304_000
    cfg = JConfig(block_fm=32768, rds="off")
    for center in _sweep_centers(cfg, 88_000_000, 90_000_000, 100_000):
        iq = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        off = 88_400_000 - center
        if abs(off) <= 1_000_000:
            iq = iq + 0.7 * planted[:n] * np.exp(2j * np.pi * off * t)
        jsynth.iq_to_u8(iq.astype(np.complex64)).tofile(d / f"{center}.u8")
    monkeypatch.setenv("SDRJFM_LIBRTLSDR", libs["rtlsdr"])
    monkeypatch.delenv("FAKE_RTLSDR_IQ", raising=False)
    monkeypatch.setenv("FAKE_RTLSDR_IQ_DIR", str(d))
    monkeypatch.setenv("FAKE_RTLSDR_FPS", "20000000")
    argv = ["scan", "--iq", "rtlsdr:0", "--band-start", "88", "--band-stop",
            "90", "--scan-blocks", "2", "--settle-ms", "100",
            "--stations", str(tmp_path / "{who}.json")]
    hits = {}
    for who, main, extra in (("jax", japp.main, []),
                             ("port", app.main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main([a.format(who=who) for a in argv] + extra) == 0
        hits[who] = json.loads(capsys.readouterr().out)["hits"]
    freqs = [h["freq_hz"] for h in hits["port"]]
    assert freqs == [h["freq_hz"] for h in hits["jax"]]
    assert 88_400_000 in freqs


@pytest.mark.parametrize("src", ["rtlsdr:1", "hackrf"])
def test_scan_without_device_exits_2_as_jax_cli(src, tmp_path, capsys,
                                               monkeypatch):
    for env in ("RTLSDR", "HACKRF"):
        monkeypatch.setenv(f"SDRJFM_LIB{env}", str(tmp_path / "none.so"))
    assert japp.main(["scan", "--iq", src]) == 2
    jerr = capsys.readouterr().err.strip().splitlines()[-1]
    assert app.main(["scan", "--iq", src, "--device", "cpu"]) == 2
    terr = capsys.readouterr().err.strip().splitlines()[-1]
    assert terr == jerr and terr.startswith("loading device failed")
