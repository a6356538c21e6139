"""The benchmark's general part: it finds a cell's configuration, traffic
kind and per-layer metrics by their names in BENCHMARK.json, runs the cell
once through its traffic kind, reads the memory peak, frees the program,
runs the plain reference over the same input, judges `correct`, and
builds the result line.

A traffic kind (`traffic/<kind>.py`, named by the traffic file's "kind")
has `run(ctx) -> Run`: it makes its input from the seed, sets the program
up, measures the window and, with tracing, profiles a steady stretch and
the attribution pass.  A per-layer metric (`metrics/<name>.py`) has
`read(view) -> float | None`.

A configuration file may name its own plain reference, `"reference":
"<module>"`: the file `reference/<module>.py`, which exposes a
`PlainReceiver(receiver, device, tune_hz)` as `reference/receiver.py`
does; without the key the harness takes `reference/receiver.py`.  A kind
may also have `control_input(ctx, nblocks) -> (wire, [(station, tune_hz),
...])`, the input and the receivers `calibrate.py` puts the control on;
without it, the control takes the traffic's one station at 0 Hz.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from .compare import numbers

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sdrjfm_tpu")


def log(msg: str) -> None:
    print(f"fmbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is one the benchmark must
    never load (compared whole: `sdrjfm_tpu_torch` is not `sdrjfm_tpu`)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------

class Bench:
    """BENCHMARK.json and the files it names."""

    def __init__(self, path: Path = ROOT / "BENCHMARK.json",
                 base: Path = HERE):
        self.spec = load_json(path)
        self.base = base

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(ROOT / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.base / "traffic" / f"{name}.json")

    def kind(self, kind: str):
        return load_module(self.base / "traffic" / f"{kind}.py",
                           f"fmbench_traffic_{kind}")

    @staticmethod
    def _listed(metric: dict, cell: str) -> bool:
        return cell in metric.get("workloads", [cell])

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"] if self._listed(m, cell)]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.spec["per_layer"] if self._listed(m, cell)]

    def reader(self, metric: str):
        return load_module(self.base / "metrics" / f"{metric}.py",
                           "fmbench_metric_" + metric.replace(".", "_"))

    @staticmethod
    def reference(config: dict):
        """The plain reference module a configuration names (its
        `"reference"` key: `reference/<module>.py`), `reference/receiver.py`
        without one."""
        name = config.get("reference", "receiver")
        return importlib.import_module(f"fmbench.reference.{name}")


# ---------------------------------------------------------------------------
# what a traffic kind hands back
# ---------------------------------------------------------------------------

@dataclass
class Context:
    receiver: dict            # ReceiverConfig keyword arguments
    traffic: dict             # the traffic file's parameters
    seed: int
    seconds: float
    trace: bool
    device: object            # torch.device
    t_start: float            # time.monotonic() at process start
    config: dict              # the configuration file


@dataclass
class ProgramRun:
    """The timed path's output for blocks 0..nblocks-1 of its input, from
    the receiver's initial state: the audio and the RDS bits laid end to
    end, and what the program's own RDS decoder made of the bits; with
    the receiver it ran, the station it was tuned to, its input and the
    receiver's offset from the input's centre (whole Hz), so that the
    harness runs one reference for each receiver, tuning and input."""
    nblocks: int
    audio: np.ndarray
    bits: np.ndarray
    rds: Optional[dict]       # pi, ps, rt, crc_errors; None where the
                              # timed path runs no RDS decoder
    receiver: dict            # ReceiverConfig keyword arguments
    station: object           # synth.StationParams: the truth it decodes
    wire_block: Callable[[int], np.ndarray]   # input block i (host)
    tune_hz: int = 0


@dataclass
class Run:
    metrics: Dict[str, float]             # end-to-end, by name
    attempted: int
    failed: int
    runs: List[ProgramRun]
    free: Callable[[], None]              # drops the program's state
    trace: object = None                  # trace.Trace of the stretch
    attribution: Optional[Dict[str, float]] = None   # kernel us by range
    attribution_blocks: int = 0
    trace_blocks: int = 0                 # blocks in the traced stretch
    stamps: Dict[str, np.ndarray] = field(default_factory=dict)
    notes: Dict[str, object] = field(default_factory=dict)


@dataclass
class View:
    """What a per-layer metric reads."""
    receiver: dict
    trace: object
    attribution: Optional[Dict[str, float]]
    attribution_blocks: int
    trace_blocks: int
    stamps: Dict[str, np.ndarray]


def rds_report(dec) -> dict:
    r = dec.result
    return {"pi": r.pi_code, "ps": r.station_label.strip(),
            "rt": r.radio_text, "crc_errors": dec.sync.num_crc_errors}


# ---------------------------------------------------------------------------
# correct
# ---------------------------------------------------------------------------

def reference_outputs(receiver: dict, wire_block, nblocks: int, device,
                      mode: str = "f32", tune_hz: int = 0,
                      module=None) -> List[dict]:
    """The plain reference (`module`'s, `reference/receiver.py`'s without
    one) tuned to `tune_hz` over input blocks 0..nblocks-1."""
    import torch
    from . import reference
    from .reference import precision
    ref = (module or reference).PlainReceiver(receiver, device, tune_hz)
    s = ref.init_state()
    outs = []
    with torch.no_grad(), precision(mode):
        for b in range(nblocks):
            s, o = ref.step(s, torch.as_tensor(wire_block(b)).to(device))
            outs.append({k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                             else v) for k, v in o.items()})
    return outs


def reference_run(outs: List[dict], receiver: dict, station,
                  wire_block, tune_hz: int = 0) -> ProgramRun:
    """The reference's outputs in a program run's form, its bits decoded
    by the reference's decoder (the control puts them in the program's
    place)."""
    from .reference import decode_rds
    bits = np.concatenate([o.get("bits", np.zeros(0, np.int8))
                           for o in outs])
    d = decode_rds(bits)
    return ProgramRun(len(outs), np.concatenate([o["audio"] for o in outs]),
                      bits, {"pi": d["pi"], "ps": d["ps"], "rt": d["rt"],
                             "crc_errors": d["crc_errors"]},
                      receiver, station, wire_block, tune_hz)


def judge(runs: List[ProgramRun], device, module=None) -> Dict[str, float]:
    """The numbers `correct` compares, with one run of the reference
    (`module`'s) for each distinct receiver, tuning and input, over the
    most blocks a run of it covers."""
    groups: Dict[tuple, List[ProgramRun]] = {}
    for r in runs:
        key = (json.dumps(r.receiver, sort_keys=True), r.tune_hz,
               id(r.wire_block))
        groups.setdefault(key, []).append(r)
    judged = []
    for rs in groups.values():
        ref = reference_outputs(rs[0].receiver, rs[0].wire_block,
                                max(r.nblocks for r in rs), device,
                                tune_hz=rs[0].tune_hz, module=module)
        judged += [(r, ref) for r in rs]
    return numbers(judged)


# ---------------------------------------------------------------------------
# one run of a cell
# ---------------------------------------------------------------------------

def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None,
             receiver_overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None) -> dict:
    """One run of a cell; returns the result line as a dict (its "checks"
    last).  The overrides shrink a cell for the CPU tests."""
    import torch
    t_start = time.monotonic() if t_start is None else t_start
    w = bench.workload(workload)
    config = bench.config(w["config"])
    traffic = {**bench.traffic(w["traffic"]), **(traffic_overrides or {})}
    receiver = {**config["receiver"], **(receiver_overrides or {})}
    dev = torch.device(device)
    ctx = Context(receiver, traffic, int(seed), float(seconds), bool(trace),
                  dev, t_start, config)
    run = bench.kind(traffic["kind"]).run(ctx)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    run.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    got = judge(run.runs, dev, bench.reference(config))
    crc = [r.rds["crc_errors"] for r in run.runs if r.rds is not None]
    reference_s = time.monotonic() - t0
    limits = config["checks"]
    checks = {k: {"value": got.get(k, math.inf), "limit": v}
              for k, v in limits.items()}
    correct = run.failed == 0 and all(v["value"] <= v["limit"]
                                      for v in checks.values())
    if trace:
        view = View(receiver, run.trace, run.attribution,
                    run.attribution_blocks, run.trace_blocks, run.stamps)
        metrics = {}
        for m in bench.per_layer(workload):
            v = bench.reader(m["name"]).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(run.metrics[m["name"]]),
                               "unit": m["unit"]}
                   for m in bench.end_to_end(workload)}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": devinfo}
    if trace and run.trace is not None:
        devinfo["busy_s"] = run.trace.busy_s()
        devinfo["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["notes"] = {**run.notes, "reference_s": reference_s,
                    "rds_crc_errors": crc}
    out["checks"] = checks
    return out
