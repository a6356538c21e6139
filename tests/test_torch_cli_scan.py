"""The port's `scan` subcommand and `rx --afc` on the CPU (`--device cpu`).

- `scan --identify --stations` on a two-station capture names both
  stations and writes them to the station list (JSON, or the reference's
  XML), and its hits equal the JAX CLI's (contrast within 1e-3 dB: f32 FFTs
  in two libraries); raw u8/i8/i16 captures give the wav's hits; the
  hardware sweep (`rtl_tcp://`, `rtlsdr`, `hackrf`) without its device
  exits 2 with the JAX CLI's "loading device failed"; a raw capture
  without its format exits 2, a short one 1;
- `rx --afc` on a capture with a 1500 Hz residual carrier offset against
  the JAX CLI: the logged demod DC within 1e-5 a block, the AFC offsets
  replayed from it within 0.5 Hz, audio within 2e-4 (as the other CLI
  tests); `--pcm-out` and `--follow` close the same loop (the same log, bit
  for bit on the CPU); `--runner scan` refuses it with JAX's message.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from sdrjfm_tpu import app as japp
from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.io import synth as jsynth
from sdrjfm_tpu.io.wavio import write_iq_wav
from sdrjfm_tpu.models.tuner import AFCTracker
from sdrjfm_tpu_torch import app
from sdrjfm_tpu_torch.io.wavio import read_wav

import torch_parity as P

torch.set_num_threads(2)

BLOCK_FM = 32768
STATIONS = ((-500_000, 0x1111, "STATION1", 700.0),
            (400_000, 0x2222, "STATION2", 1300.0))


def _json_out(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, (json.loads(buf.getvalue()) if rc == 0 else None)


@pytest.fixture(scope="module")
def band(tmp_path_factory):
    d = tmp_path_factory.mktemp("band")
    iq = P.stations_iq(STATIONS, 1.6)
    wav = d / "band.wav"
    write_iq_wav(str(wav), iq, JC.INPUT_RATE, float32=False)
    return d, wav, iq


@pytest.fixture(scope="module")
def identified(band):
    d, wav, _ = band
    stations = d / "stations.json"
    rc, out = _json_out(app.main, ["scan", "--iq", str(wav), "--identify",
                                   "--stations", str(stations), "--block-fm",
                                   str(BLOCK_FM), "--device", "cpu"])
    assert rc == 0
    return out["hits"], json.loads(stations.read_text())


def test_scan_identify_names_both_stations(identified):
    hits, _ = identified
    by_pi = {h.get("pi_code"): h for h in hits}
    assert sorted(h["offset_hz"] for h in hits) == [-500_000, 400_000]
    assert by_pi["0x1111"]["station"] == "STATION1"
    assert by_pi["0x2222"]["station"] == "STATION2"
    assert all(h["pilot_locked"] and h["ber"] == 0.0 for h in hits)


def test_scan_writes_the_station_list(identified):
    _, listed = identified
    assert {(e["name"], e["frequency_hz"], e["pi_code"])
            for e in listed["stations"]} == {("STATION1", -500_000, 0x1111),
                                             ("STATION2", 400_000, 0x2222)}


def test_scan_hits_equal_the_jax_cli(band, identified):
    _, wav, _ = band
    rc, out = _json_out(japp.main, ["scan", "--iq", str(wav), "--block-fm",
                                    str(BLOCK_FM)])
    assert rc == 0
    hits, _ = identified
    assert [h["offset_hz"] for h in hits] \
        == [h["offset_hz"] for h in out["hits"]]
    for a, b in zip(hits, out["hits"]):
        assert abs(a["contrast_db"] - b["contrast_db"]) <= 1e-3


@pytest.mark.parametrize("fmt", ["u8", "i8", "i16"])
def test_scan_raw_captures(band, identified, fmt):
    d, _, iq = band
    raw = d / f"band.{fmt}"
    conv = {"u8": jsynth.iq_to_u8, "i8": jsynth.iq_to_i8,
            "i16": jsynth.iq_to_i16}[fmt]
    conv(iq).tofile(str(raw))
    rc, out = _json_out(app.main, ["scan", "--iq", str(raw), "--iq-format",
                                   fmt, "--block-fm", str(BLOCK_FM),
                                   "--device", "cpu"])
    assert rc == 0
    assert [h["offset_hz"] for h in out["hits"]] \
        == [h["offset_hz"] for h in identified[0]]


def test_scan_xml_station_list(band, tmp_path):
    _, wav, _ = band
    xml = tmp_path / "programs.xml"
    rc, _ = _json_out(app.main, ["scan", "--iq", str(wav), "--identify",
                                 "--seconds", "1.6", "--stations", str(xml),
                                 "--block-fm", str(BLOCK_FM), "--device",
                                 "cpu"])
    assert rc == 0 and xml.read_text().startswith("<fmList>")
    assert "STATION1" in xml.read_text() and "STATION2" in xml.read_text()


@pytest.mark.parametrize("src", ["rtl_tcp://localhost:1234",
                                 "rtltcp://127.0.0.1:1", "rtlsdr",
                                 "rtlsdr:1", "hackrf"])
def test_scan_hardware_sweep_without_device_exits_2_as_jax_cli(
        src, capsys, monkeypatch, tmp_path):
    """The hardware sweep opens its device as the JAX CLI does: with no
    rtl_tcp server and no vendor library, exit 2 with "loading device
    failed" (the sweep itself: tests/test_torch_hw_usb.py)."""
    from sdrjfm_tpu import app as japp
    for env in ("RTLSDR", "HACKRF"):
        monkeypatch.setenv(f"SDRJFM_LIB{env}", str(tmp_path / "none.so"))
    assert japp.main(["scan", "--iq", src]) == 2
    jerr = capsys.readouterr().err.strip().splitlines()[-1]
    assert app.main(["scan", "--iq", src, "--device", "cpu"]) == 2
    terr = capsys.readouterr().err.strip().splitlines()[-1]
    assert terr == jerr and terr.startswith("loading device failed")


def test_scan_bad_inputs(tmp_path, capsys):
    raw = tmp_path / "x.raw"
    np.zeros(1000, np.uint8).tofile(str(raw))
    assert app.main(["scan", "--iq", str(raw), "--device", "cpu"]) == 2
    assert "--iq-format" in capsys.readouterr().err
    assert app.main(["scan", "--iq", str(raw), "--iq-format", "u8",
                     "--device", "cpu"]) == 1
    assert "too short" in capsys.readouterr().err
    assert app.main(["scan", "--iq", str(tmp_path / "missing.wav"),
                     "--device", "cpu"]) == 2


# ---------------------------------------------------------------------------
# rx --afc
# ---------------------------------------------------------------------------

AFC_BLOCK_FM = 16384
AFC_OFFSET = 1500.0


@pytest.fixture(scope="module")
def afc_runs(tmp_path_factory):
    """The 1500 Hz capture through the port's and the JAX CLI's `rx --afc`
    (the loop runner): (dir, {package: (audio, per-block log)})."""
    d = tmp_path_factory.mktemp("afc")
    wav = d / "afc.wav"
    assert app.main(["synth", "--out", str(wav), "--seconds", "1.2",
                     "--carrier-offset", str(AFC_OFFSET), "--int16"]) == 0
    runs = {}
    for name, fn, extra in (("port", app.main, ["--device", "cpu"]),
                            ("jax", japp.main, [])):
        log, audio = d / f"{name}.jsonl", d / f"{name}.wav"
        assert fn(["rx", "--iq", str(wav), "--afc", "--mode", "mono",
                   "--block-fm", str(AFC_BLOCK_FM), "--log-meta", str(log),
                   "--audio", str(audio), "--report", str(d / f"{name}.json"),
                   *extra]) == 0
        runs[name] = (read_wav(str(audio))[0],
                      [json.loads(ln) for ln in log.read_text().splitlines()])
    return d, wav, runs


def _afc_offsets(log):
    afc = AFCTracker()
    return [afc.update(rec["dc_if"]) for rec in log]


def test_rx_afc_matches_the_jax_cli(afc_runs):
    _, _, runs = afc_runs
    (at, lt), (aj, lj) = runs["port"], runs["jax"]
    assert len(lt) == len(lj) >= 10
    np.testing.assert_allclose([r["dc_if"] for r in lt],
                               [r["dc_if"] for r in lj], rtol=0, atol=1e-5)
    np.testing.assert_allclose(_afc_offsets(lt), _afc_offsets(lj), rtol=0,
                               atol=0.5)
    assert at.shape == aj.shape
    np.testing.assert_allclose(at, aj, rtol=0, atol=2e-4)


def test_rx_afc_pulls_in(afc_runs):
    _, _, runs = afc_runs
    offs = _afc_offsets(runs["port"][1])
    assert abs(offs[-1] - AFC_OFFSET) < min(400.0, 0.5 * AFC_OFFSET), offs
    assert abs(offs[0]) > 0.5 * AFC_OFFSET     # the first block's big step


@pytest.mark.parametrize("flags", [["--pcm-out", "{d}/pcm.raw"],
                                   ["--follow", "--no-pace"]],
                         ids=["pcm_out", "follow"])
def test_rx_afc_streaming_runners_close_the_same_loop(afc_runs, flags):
    d, wav, runs = afc_runs
    log = d / "streaming.jsonl"
    assert app.main(["rx", "--iq", str(wav), "--afc", "--mode", "mono",
                     "--block-fm", str(AFC_BLOCK_FM), "--log-meta", str(log),
                     "--report", str(d / "streaming.json"), "--device",
                     "cpu", *[f.format(d=d) for f in flags]]) == 0
    got = [json.loads(ln)["dc_if"] for ln in log.read_text().splitlines()]
    assert got == [r["dc_if"] for r in runs["port"][1]]


def test_rx_afc_with_the_scan_runner_exits_2(afc_runs, capsys):
    _, wav, _ = afc_runs
    assert app.main(["rx", "--iq", str(wav), "--afc", "--runner", "scan",
                     "--device", "cpu"]) == 2
    assert "--afc closes a per-block host loop" in capsys.readouterr().err
