"""The port's `rx` control-surface flags against the JAX CLI, on the CPU:
`--config` (its keys as the flag defaults, and the settings saved back on
a clean exit), `--control` with `--stations` (`tune <name>`, `save
<name>`), `--meter`'s status line, `--profile` (a torch.profiler trace
written into the directory), and the checks that refuse these flags on the
wrong runner, each with the JAX CLI's message.  Reports, saved files and
audio (within 2e-4) equal the JAX CLI's on a 0.3 s capture.
"""

import io
import json
import shutil
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as conftest sets)
from sdrjfm_tpu import app as japp
from sdrjfm_tpu.io.wavio import read_wav, write_iq_wav
from sdrjfm_tpu_torch import app
from sdrjfm_tpu_torch.io.stations import StationList

from torch_parity import station_iq

torch.set_num_threads(2)

AUDIO_ATOL = 2e-4
BLOCK = ["--block-fm", "4096"]


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli_control") / "iq.wav"
    write_iq_wav(str(p), station_iq(0.3, carrier_offset=0.0), 2_304_000,
                 float32=False)
    return p


MAINS = (("jax", japp.main, []), ("port", app.main, ["--device", "cpu"]))


def _both(tmp_path, argv, stdin=None, monkeypatch=None, capsys=None):
    """Run both CLIs with `argv` ({who} and {d} filled in); returns
    {who: (rc, report or None, stderr)}."""
    out = {}
    for who, main, extra in MAINS:
        if stdin is not None:
            monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        a = [s.format(who=who, d=tmp_path) for s in argv]
        rc = main(a + extra)
        err = capsys.readouterr().err if capsys is not None else ""
        rep = None
        if rc == 0 and "--report" in a:
            rep = json.loads(open(a[a.index("--report") + 1]).read())
        out[who] = (rc, rep, err)
    return out


def _same_report(rt, rj):
    assert rt["blocks"] == rj["blocks"]
    for k, v in rj["meta_last"].items():
        if isinstance(v, bool):
            assert rt["meta_last"][k] == v, k
        elif k != "latency_ms":
            assert abs(rt["meta_last"][k] - v) <= 1e-3 * max(1, abs(v)), k
    if "control" in rj:
        assert rt["control"] == rj["control"]


def _same_audio(tmp_path):
    at, _ = read_wav(str(tmp_path / "a_port.wav"))
    aj, _ = read_wav(str(tmp_path / "a_jax.wav"))
    np.testing.assert_allclose(at, aj, rtol=0, atol=AUDIO_ATOL)


def test_config_defaults_and_save_back_match_jax(wav, tmp_path, monkeypatch,
                                                 capsys):
    profile = {"volume_db": -6.0, "balance": 20, "squelch": "lsq",
               "squelch_level": "30", "rds": True, "block_fm": 8192,
               "sound": "left_plus_right", "unknown_key": 1}
    for who in ("jax", "port"):
        (tmp_path / f"c_{who}.json").write_text(json.dumps(profile))
    argv = ["rx", "--iq", str(wav), "--config", "{d}/c_{who}.json",
            "--audio", "{d}/a_{who}.wav", "--report", "{d}/r_{who}.json",
            "--control", "-", "--panorama", "0.5"]
    res = _both(tmp_path, argv, "balance -10\npano 150\nvolume -3\n",
                monkeypatch, capsys)
    (rj_rc, rj, _), (rt_rc, rt, _) = res["jax"], res["port"]
    assert rj_rc == rt_rc == 0
    _same_report(rt, rj)
    _same_audio(tmp_path)
    saved = {who: json.loads((tmp_path / f"c_{who}.json").read_text())
             for who in ("jax", "port")}
    assert saved["port"] == saved["jax"]
    assert saved["port"]["balance"] == -10 and \
        saved["port"]["panorama"] == 1.5
    assert saved["port"]["volume_db"] == -3.0 and \
        saved["port"]["squelch"] == "lsq"


def test_config_without_a_file_writes_one_and_a_bad_one_exits_2(
        wav, tmp_path, monkeypatch, capsys):
    argv = ["rx", "--iq", str(wav), *BLOCK, "--config", "{d}/n_{who}.json",
            "--report", "{d}/r_{who}.json", "--freq-offset", "1000"]
    res = _both(tmp_path, argv, capsys=capsys)
    assert res["port"][0] == res["jax"][0] == 0
    assert json.loads((tmp_path / "n_port.json").read_text()) == \
        json.loads((tmp_path / "n_jax.json").read_text())
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    res = _both(tmp_path, ["rx", "--iq", str(wav), "--config", str(bad)],
                capsys=capsys)
    assert res["port"][0] == res["jax"][0] == 2
    assert res["port"][2] == res["jax"][2]


def test_stations_on_rx_match_jax(wav, tmp_path, monkeypatch, capsys):
    for who in ("jax", "port"):
        sl = StationList()
        sl.add("Near", 100_000)
        sl.add("Home", 0)
        sl.save(str(tmp_path / f"s_{who}.json"))
    argv = ["rx", "--iq", str(wav), *BLOCK, "--rds", "--stations",
            "{d}/s_{who}.json", "--control", "-", "--audio",
            "{d}/a_{who}.wav", "--report", "{d}/r_{who}.json"]
    res = _both(tmp_path, argv,
                "tune Near\nsave Mine\ntune home\nstations\nstatus\n",
                monkeypatch, capsys)
    (_, rj, ej), (_, rt, et) = res["jax"], res["port"]
    _same_report(rt, rj)
    assert rt["control"]["retunes"] == 2
    _same_audio(tmp_path)
    assert json.loads((tmp_path / "s_port.json").read_text()) == \
        json.loads((tmp_path / "s_jax.json").read_text())
    # the responses (stderr for a stdin channel): the same lines
    jl = [json.loads(x) for x in ej.splitlines() if x.startswith("{")]
    tl = [json.loads(x) for x in et.splitlines() if x.startswith("{")]
    assert len(tl) == len(jl) == 5
    for a, b in zip(tl[:4], jl[:4]):
        a.pop("path", None)
        b.pop("path", None)
        assert a == b


def test_meter_line_matches_jax(wav, tmp_path, capsys):
    argv = ["rx", "--iq", str(wav), *BLOCK, "--rds", "--pcm-out",
            "{d}/p_{who}.raw", "--meter", "--report", "{d}/r_{who}.json"]
    res = _both(tmp_path, argv, capsys=capsys)
    lines = {}
    for who in ("jax", "port"):
        assert res[who][0] == 0
        lines[who] = [ln.rstrip() for ln in res[who][2].split("\r")
                      if ln.startswith("[")]
    # how many lines depends on the wall clock (a repaint at most every
    # 0.25 s, and every 8th block); the first block's always prints.  The
    # levels are "%+5.1f": above -10 dB the field pads before its sign
    import re
    fmt = re.compile(r"\[ *\d+\.\ds\] pilot=(LOCK|----) \d+\.\d\d "
                     r"L= *[+-] *\d+\.\ddB R= *[+-] *\d+\.\ddB")
    for who in ("jax", "port"):
        assert lines[who] and all(fmt.match(ln) for ln in lines[who]), who
    a, b = lines["port"][0], lines["jax"][0]
    assert a.split(" pilot=")[0] == b.split(" pilot=")[0]   # the time
    assert a.split(" ")[1][:10] == b.split(" ")[1][:10]    # the lock
    pt = np.fromfile(tmp_path / "p_port.raw", np.int16)
    pj = np.fromfile(tmp_path / "p_jax.raw", np.int16)
    assert pt.shape == pj.shape and np.abs(pt - pj.astype(int)).max() <= 8


def test_profile_writes_a_trace(wav, tmp_path, capsys):
    argv = ["rx", "--iq", str(wav), *BLOCK, "--profile", "{d}/prof_{who}",
            "--report", "{d}/r_{who}.json"]
    res = _both(tmp_path, argv, capsys=capsys)
    assert res["port"][0] == res["jax"][0] == 0
    _same_report(res["port"][1], res["jax"][1])
    assert any((tmp_path / "prof_jax").rglob("*"))
    traces = list((tmp_path / "prof_port").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert len(events) > 100 and any("conv1d" in str(n) for n in names)
    assert "wrote profiler trace to" in res["port"][2]
    # beside it, the program's own record of its spans and counters
    rec, = (tmp_path / "prof_port").glob("spans_*.json")
    doc = json.loads(rec.read_text())
    assert doc["clock"] == "CLOCK_MONOTONIC"
    assert "setup.receiver" in {s["name"] for s in doc["spans"]}
    assert set(doc["counters"]) >= {"kernel.builds", "graph.captures"}
    shutil.rmtree(tmp_path / "prof_jax", ignore_errors=True)


@pytest.mark.parametrize("flags", [
    ["--meter"], ["--runner", "scan", "--control", "-"],
    ["--runner", "scan", "--afc"]],
    ids=["meter_loop", "control_scan", "afc_scan"])
def test_runner_checks_match_jax(wav, tmp_path, capsys, flags):
    res = _both(tmp_path, ["rx", "--iq", str(wav), *BLOCK, *flags],
                capsys=capsys)
    assert res["port"][0] == res["jax"][0] == 2
    assert res["port"][2].strip() == res["jax"][2].strip()


def test_ckpt_dir_on_the_scan_runner_exits_as_jax(wav, tmp_path):
    msgs = []
    for _, main, extra in MAINS:
        with pytest.raises(SystemExit) as e:
            main(["rx", "--iq", str(wav), *BLOCK, "--runner", "scan",
                  "--ckpt-dir", str(tmp_path / "ck")] + extra)
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and "per-block host loop" in msgs[0]
