"""Profiler windows and what the per-layer metrics read from them.

`Profiler` runs a stretch of the cell under `torch.profiler` (CPU and
CUDA activity) and turns its Chrome trace into a `Trace`: the device's
kernels, copies and fills, the host's runtime calls and the harness's own
`record_function` ranges, all on one microsecond timeline.  A trace that
holds no device event at all recorded nothing (the profiler's collection
can drop a window); the caller profiles its next stretch instead.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

class Trace:
    """The events of one profiled stretch, by kind: each a list of dicts
    with name, ts, dur (microseconds) and, for kernels and launches, the
    correlation id that ties a device event to the host call that queued
    it."""

    def __init__(self, events: List[dict], window: Tuple[float, float]):
        by = defaultdict(list)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            by[e.get("cat", "")].append(e)
        self.kernels = by["kernel"]
        self.memcpy = by["gpu_memcpy"]
        self.memset = by["gpu_memset"]
        self.launches = by["cuda_runtime"] + by["cuda_driver"]
        self.ranges = by["user_annotation"]
        self.host = (by["cpu_op"] + self.launches + self.ranges
                     + by["python_function"])
        self.t0, self.t1 = window

    @property
    def device(self) -> List[dict]:
        return self.kernels + self.memcpy + self.memset

    def in_window(self, evs: List[dict]) -> List[dict]:
        return [e for e in evs if self.t0 <= e["ts"] < self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's kernel, copy and fill intervals,
        clipped to the window."""
        iv = sorted((max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                    for e in self.device)
        out: List[List[float]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernels_by_range(self) -> Dict[str, float]:
        """Kernel microseconds by the innermost harness range that was open
        when the host queued the kernel (matched by correlation id)."""
        when = {e["args"]["correlation"]: e["ts"] for e in self.launches
                if "correlation" in e.get("args", {})}
        ranges = sorted(self.ranges, key=lambda r: r["ts"])
        out: Dict[str, float] = defaultdict(float)
        for k in self.kernels:
            t = when.get(k.get("args", {}).get("correlation"))
            if t is None:
                continue
            inner = None
            for r in ranges:
                if r["ts"] > t:
                    break
                if t <= r["ts"] + r["dur"] and (
                        inner is None or r["dur"] <= inner["dur"]):
                    inner = r
            if inner is not None:
                out[inner["name"]] += k["dur"]
        return dict(out)

    def top_device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for e in self.in_window(self.device):
            tot[e["name"]] += e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time in the window, by the innermost host call
        that was running at each gap's middle (the gaps' seconds summed by
        that call's name)."""
        busy = self.busy_intervals()
        gaps, last = [], self.t0
        for a, b in busy:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if self.t1 > last:
            gaps.append((last, self.t1))
        host = sorted(self.host, key=lambda e: e["ts"])
        tot: Dict[str, float] = defaultdict(float)
        open_: list = []              # (duration, end, name) of started calls
        i = 0
        for a, b in gaps:             # in time order
            mid = 0.5 * (a + b)
            while i < len(host) and host[i]["ts"] <= mid:
                e = host[i]
                heapq.heappush(open_, (e["dur"], e["ts"] + e["dur"],
                                       e["name"]))
                i += 1
            # the shortest call still running at mid; calls that ended
            # before mid are dropped as they surface (they end before every
            # later gap too)
            while open_ and open_[0][1] < mid:
                heapq.heappop(open_)
            name = open_[0][2] if open_ else "no traced host call"
            tot[name] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]


class Profiler:
    """`torch.profiler` (CPU and CUDA activity) over a stretch that starts
    and stops where the cell's loop says: `start()`, then `stop()` returns
    the stretch's `Trace`, or None when it holds no device event.  The
    window runs from the `window_start` mark to the `window_end` mark."""

    def __init__(self, device_type: str):
        self.cuda = device_type == "cuda"
        self.prof = None

    def _mark(self, name: str) -> None:
        from torch.profiler import record_function
        with record_function(name):
            pass

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._mark("window_start")

    def stop(self) -> Optional[Trace]:
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self._mark("window_end")
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        marks = {e["name"]: e["ts"] for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") in ("window_start", "window_end")}
        tr = Trace(events, (marks.get("window_start", 0.0),
                            marks.get("window_end", 0.0)))
        return tr if (tr.device or not self.cuda) else None


def warm_up(device) -> None:
    """Start and stop the profiler once on a trivial op: a process's first
    profile pays seconds of set-up (CUPTI's), which belong to set-up and
    not to the stretch a cell profiles."""
    import torch
    p = Profiler(torch.device(device).type)
    p.start()
    torch.ones(1, device=device).add_(1)
    p.stop()
