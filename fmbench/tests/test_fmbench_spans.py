"""The per-layer metrics that read the program's own spans, on a
synthetic record: each reads what its docstring says, skips what a
profiler recorded, and is left out where the program has no tracer."""

import builtins

import pytest

from fmbench.harness import Bench, View
from sdrjfm_tpu_torch.runtime import spans
from sdrjfm_tpu_torch.runtime.spans import Span

MS = 1_000_000
VIEW = View({}, None, None, 0, 0, {})


class Rec:
    """Builds a record: spans nest under the one passed as parent."""

    def __init__(self):
        self.recs = []

    def add(self, name, t0_ms, t1_ms, parent=None, id=-1, count=-1,
            profiled=False):
        r = Span(len(self.recs), name, int(t0_ms * MS), int(t1_ms * MS),
                 parent.seq if parent is not None else -1, id, count,
                 profiled)
        self.recs.append(r)
        return r


def _file_record():
    """Three passes of 32 blocks, the middle one profiled."""
    rec = Rec()
    for i, (wait, copy, asm, prof) in enumerate(
            [(16.0, 3.2, 1.6, False), (99.0, 99.0, 99.0, True),
             (24.0, 6.4, 4.8, False)]):
        t = 100.0 * i
        p = rec.add("scan.pass", t, t + 90.0, id=i, count=32, profiled=prof)
        rec.add("scan.load", t, t + 1.0, p)
        rec.add("scan.stage", t + 1.0, t + 25.0, p, count=32)
        rec.add("scan.replays", t + 25.0, t + 27.0, p, count=32)
        rec.add("scan.fetch_wait", t + 27.0, t + 27.0 + wait, p)
        rec.add("scan.fetch_copy", t + 27.0 + wait, t + 27.0 + wait + copy,
                p)
        rec.add("scan.assemble", t + 80.0, t + 80.0 + asm, p)
    return rec.recs


def _live_record():
    """Three blocks, the last profiled; each reads the next block."""
    rec = Rec()
    for b, (part, lag, prof) in enumerate([(0.1, 0.3, False),
                                           (0.2, 0.5, False),
                                           (9.0, 9.0, True)]):
        t = 100.0 * b
        blk = rec.add("live.block", t, t + 90.0, id=b, profiled=prof)
        rec.add("live.step", t, t + part, blk)
        read = rec.add("source.read", t + 1.0, t + 86.0, blk, count=16384,
                       profiled=prof)
        rec.add("source.arrival", t + 86.0 - lag, t + 86.0 - lag, read)
        for k, name in enumerate(["live.upload", "live.fetch_wait",
                                  "live.deliver", "live.hooks"]):
            rec.add(name, t + 86.0 + k, t + 86.0 + k + part, blk)
    return rec.recs


def _setup_record():
    rec = Rec()
    rec.add("setup.receiver", 0.0, 2000.0)
    rec.add("setup.kernel_load", 2000.0, 2100.0)
    cap = rec.add("setup.capture", 3000.0, 3800.0)
    rec.add("setup.kernel_load", 3100.0, 3400.0, cap)
    cap2 = rec.add("setup.capture", 5000.0, 5400.0)
    rec.add("scan.pass", 4000.0, 4100.0)
    return rec.recs + [Span(99, "setup.capture", 0, 0, cap2.seq, -1, -1,
                            False)]


def _read(monkeypatch, recs, metric):
    monkeypatch.setattr(spans, "records", lambda: recs)
    return Bench().reader(metric).read(VIEW)


@pytest.mark.parametrize("metric, want", [
    ("fetch_wait_ms.air", (16.0 / 32 + 24.0 / 32) / 2),
    ("fetch_copy_ms.air", (3.2 / 32 + 6.4 / 32) / 2),
    ("assemble_ms.air", (1.6 / 32 + 4.8 / 32) / 2)])
def test_per_pass_metrics(monkeypatch, metric, want):
    assert _read(monkeypatch, _file_record(), metric) == pytest.approx(want)


def test_runner_work(monkeypatch):
    got = _read(monkeypatch, _live_record(), "runner_work_ms.live")
    assert got == pytest.approx((5 * 0.1 + 5 * 0.2) / 2)


def test_ring_wait(monkeypatch):
    got = _read(monkeypatch, _live_record(), "ring_wait_ms.live")
    assert got == pytest.approx((0.3 + 0.5) / 2)


@pytest.mark.parametrize("metric, want", [
    ("setup_kernels_s", 0.1 + 0.3), ("setup_receiver_s", 2.0),
    ("setup_capture_s", 0.8 - 0.3 + 0.4)])
def test_setup_self_time(monkeypatch, metric, want):
    assert _read(monkeypatch, _setup_record(), metric) == pytest.approx(want)


METRICS = ["fetch_wait_ms.air", "fetch_copy_ms.air", "assemble_ms.air",
           "runner_work_ms.live", "ring_wait_ms.live", "setup_kernels_s",
           "setup_receiver_s", "setup_capture_s"]


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_to_read(monkeypatch, metric):
    """An empty record, a record of another cell's spans, and a program
    without the tracer module read nothing and raise nothing."""
    assert _read(monkeypatch, [], metric) is None
    other = _setup_record() if "setup" not in metric else _live_record()
    assert _read(monkeypatch, other, metric) is None
    own = (_setup_record() if "setup" in metric else _live_record()
           if metric.endswith(".live") else _file_record())
    assert _read(monkeypatch, own, metric) is not None
    real = builtins.__import__

    def no_tracer(name, *a, **k):
        if name.startswith("sdrjfm_tpu_torch.runtime") and (
                "spans" in name or "spans" in (a[2] or ())):
            raise ModuleNotFoundError(name)
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_tracer)
    assert Bench().reader(metric).read(VIEW) is None
