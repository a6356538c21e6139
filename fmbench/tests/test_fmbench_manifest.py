"""BENCHMARK.json against the benchmark's contract, and the harness
finding each configuration, traffic kind and metric by its name."""

import json
import re
import textwrap
from pathlib import Path

import pytest

from fmbench.harness import ROOT, Bench

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_paths():
    assert set(SPEC) == TOP
    assert SPEC["command"] == ["python3", "fmbench/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells has to fit its 43200 s
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = SPEC[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert _line(e[k]), (e["name"], k)


def test_cells_and_metrics():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    configs = {c["name"] for c in SPEC["configs"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= set(cells)
    fours = sum(w["chips"] == 4 for w in cells.values())
    assert fours <= max(1, len(cells) // 4)
    for w in cells.values():
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        reports = [m for m in e2e.values()
                   if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reports]
        assert len(reports) >= 2, w["name"]
        assert any(w["name"] in m.get("workloads", cells)
                   for m in SPEC["per_layer"]), w["name"]
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        # every cell the metric lists reports the end-to-end metric it moves
        for c in m.get("workloads", cells):
            assert c in e2e[m["moves"]].get("workloads", cells), (m, c)
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(_line(k) for k in layers)


def test_configs_files():
    bench = Bench()
    for c in SPEC["configs"]:
        assert c["file"].startswith("fmbench/")
        cfg = bench.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        want = {"audio_err"} | ({"rds_bit_errors"}
                                if cfg["receiver"].get("rds", "off") != "off"
                                else set())
        assert set(cfg["checks"]) >= want
        from sdrjfm_tpu_torch.models.receiver import ReceiverConfig
        ReceiverConfig(**cfg["receiver"])


def test_every_name_finds_its_file():
    bench = Bench()
    for w in SPEC["workloads"]:
        traffic = bench.traffic(w["traffic"])
        kind = bench.kind(traffic["kind"])
        assert callable(kind.run) and callable(kind.input_blocks)
    for m in SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]).read)


def test_a_new_metric_is_found_by_name(tmp_path):
    """A later metric needs only its file and its entry."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "blocks_traced.air.py").write_text(
        textwrap.dedent('''
        def read(view):
            return view.trace_blocks or None
        '''))
    spec = dict(SPEC)
    spec["per_layer"] = SPEC["per_layer"] + [
        {"name": "blocks_traced.air", "unit": "blocks", "better": "higher",
         "source": "device_trace", "layer": "device", "moves": "air_x",
         "workloads": ["stereo_rds.file_1"]}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    bench = Bench(path, base=tmp_path)
    names = [m["name"] for m in bench.per_layer("stereo_rds.file_1")]
    assert "blocks_traced.air" in names
    from fmbench.harness import View
    view = View({}, None, None, 0, 128, {})
    assert bench.reader("blocks_traced.air").read(view) == 128
    assert Bench().reader("copy_ms.air").read(view) is None
