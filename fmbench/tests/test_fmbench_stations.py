"""The band monitor's cell, `stations_19.file_19`, on the CPU at a small
size past the harness's look for a card: a sound run is `correct` with
every receiver-block attempted and none failed, judged against one
reference a station tuning; a receiver's block cut short, or a station
receiver's audio altered, makes it false.  The cell's readers of the
n-station spans, the attribution and the trace read nothing where those
are missing and a number where they are there; the TF32 control takes
its input and tunings from the kind."""

import types

import numpy as np
import pytest
import torch

from fmbench import harness
from fmbench.harness import Bench, View, run_cell
from sdrjfm_tpu_torch.models.receiver import Receiver
from sdrjfm_tpu_torch.runtime import spans
from sdrjfm_tpu_torch.runtime.spans import Span

CELL = "stations_19.file_19"
SMALL = {"block_fm": 16384}
BLOCKS = 12
TRAFFIC = {"blocks": BLOCKS, "warmup_passes": 2, "kept_passes": 2}
STATION_OFFSETS = [-600_000, -200_000, 300_000, 700_000]
RECEIVERS = 19


def _run(trace=False, seconds=0.1):
    torch.set_num_threads(4)
    return run_cell(Bench(), CELL, 2 ** 31 + 22, seconds, trace, "cpu",
                    None, SMALL, TRAFFIC)


def test_sound_run_is_correct_with_a_reference_a_tuning(monkeypatch):
    tunings = []
    real = harness.reference_outputs

    def counted(*a, **k):
        tunings.append(k["tune_hz"])
        return real(*a, **k)
    monkeypatch.setattr(harness, "reference_outputs", counted)
    out = _run()
    assert out["correct"], out["checks"]
    passes = out["notes"]["passes"]
    assert passes >= 1 and out["notes"]["receivers"] == RECEIVERS
    assert out["attempted"] == passes * BLOCKS * RECEIVERS
    assert out["failed"] == 0
    assert sorted(tunings) == STATION_OFFSETS
    assert set(out["metrics"]) == {"air_x", "setup_s"}
    assert out["checks"]["rds_bit_errors"]["value"] == 0


def _cut_short(monkeypatch, offset):
    """The receiver at `offset`'s audio a few samples short of its last
    block, as the n-station path hands it back."""
    import sdrjfm_tpu_torch.models.multistation as ms
    real = ms.demodulate_stations

    def cut(*a, **k):
        res = real(*a, **k)
        for r in res:
            if r["offset_hz"] == offset:
                r["audio"] = r["audio"][:-10]
        return res
    monkeypatch.setattr(ms, "demodulate_stations", cut)


def _station_audio_altered(monkeypatch):
    """One sample of the first station's row altered where the fm chain
    produces it (row 3 of the 19: -600 kHz)."""
    chain = Receiver.fm_chain

    def altered(self, *a, **k):
        state, out = chain(self, *a, **k)
        if out.audio.dim() == 3 and out.audio.shape[0] == RECEIVERS:
            audio = out.audio.clone()
            audio[3, 0, 0] += 0.01
            out = out._replace(audio=audio)
        return state, out
    monkeypatch.setattr(Receiver, "fm_chain", altered)


def test_a_non_station_receiver_cut_short_fails(monkeypatch):
    _cut_short(monkeypatch, 0)
    out = _run()
    assert out["failed"] >= out["notes"]["passes"]
    assert not out["correct"]


def test_a_station_receiver_altered_is_not_correct(monkeypatch):
    _station_audio_altered(monkeypatch)
    out = _run()
    assert out["failed"] == 0
    assert not out["correct"], out["checks"]
    assert out["checks"]["audio_err"]["value"] > 1e-3


def test_failed_blocks_counts_what_a_receiver_lacks():
    kind = Bench().kind("stations")
    Tb, nb = 100, 5

    def res(n):
        return {"offset_hz": 1, "audio": np.zeros((n, 2), np.float32)}
    assert kind.failed_blocks([res(nb * Tb)], [1], nb, Tb) == 0
    assert kind.failed_blocks([res(nb * Tb - 1)], [1], nb, Tb) == 1
    assert kind.failed_blocks([res(2 * Tb)], [1], nb, Tb) == 3
    assert kind.failed_blocks([res(nb * Tb + 1)], [1], nb, Tb) == 1
    assert kind.failed_blocks([res(nb * Tb)], [1, 2], nb, Tb) == nb


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

SPAN_METRICS = {"stations_stage_ms.stations": "scan.stage",
                "stations_fetch_copy_ms.stations": "scan.fetch_copy",
                "stations_assemble_ms.stations": "stations.assemble"}
MS = 1_000_000


def _stations_record():
    """Three calls of 32 blocks, the middle one profiled; each child of
    stations.pass 1 ms long in call 0 and 3 ms in call 2."""
    recs = []

    def add(name, t0, t1, parent=-1, count=-1, profiled=False):
        recs.append(Span(len(recs), name, int(t0 * MS), int(t1 * MS), parent,
                         -1, count, profiled))
        return recs[-1].seq
    for i, (d, prof) in enumerate([(1.0, False), (99.0, True),
                                   (3.0, False)]):
        t = 1000.0 * i
        p = add("stations.pass", t, t + 900.0, count=32, profiled=prof)
        for k, name in enumerate(["stations.load", "scan.stage",
                                  "stations.replays", "scan.fetch_wait",
                                  "scan.fetch_copy", "stations.assemble"]):
            add(name, t + 100.0 * k, t + 100.0 * k + d, p)
    return recs


def _scan_pass_record():
    """A record of the scan runner's passes alone (another cell's)."""
    recs = [Span(0, "scan.pass", 0, 90 * MS, -1, 0, 32, False)]
    for k, name in enumerate(["scan.stage", "scan.fetch_copy",
                              "scan.assemble"]):
        recs.append(Span(k + 1, name, k * MS, (k + 1) * MS, 0, 0, -1, False))
    return recs


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_readers(monkeypatch, metric):
    read = Bench().reader(metric).read
    view = View({}, None, None, 0, 0, {})
    monkeypatch.setattr(spans, "records", lambda: [])
    assert read(view) is None
    monkeypatch.setattr(spans, "records", _scan_pass_record)
    assert read(view) is None
    monkeypatch.setattr(spans, "records", _stations_record)
    assert read(view) == pytest.approx((1.0 / 32 + 3.0 / 32) / 2)


class _Trace:
    window_s = 2.0

    def busy_s(self):
        return 0.5


@pytest.mark.parametrize("metric, view, want", [
    ("stations_chain_device_ms.stations",
     View(SMALL, None, {"fm_chain": 8 * 4780.0, "front_end": 1.0}, 8, 0, {}),
     4.78),
    ("front_end_rows_roofline_pct.stations",
     View({"block_fm": 131072}, None, {"front_end": 8 * 205.85}, 8, 0,
          {"front_end_rows": np.asarray([19])}),
     100 * 0.05010471737313432 / 0.20585),
    ("device_idle_pct.stations", View(SMALL, _Trace(), None, 0, 64, {}),
     75.0)])
def test_device_readers(metric, view, want):
    read = Bench().reader(metric).read
    assert read(view) == pytest.approx(want)
    assert read(View(SMALL, None, None, 0, 0, {})) is None
    assert read(View(SMALL, None, {}, 8, 0, {})) is None


def test_roofline_needs_its_rows():
    read = Bench().reader("front_end_rows_roofline_pct.stations").read
    assert read(View({"block_fm": 131072}, None, {"front_end": 1.0}, 8, 0,
                     {})) is None
    # one row is the one-station front end's bound
    from fmbench.peaks import front_end_bound_ms
    one = read(View({"block_fm": 131072}, None, {"front_end": 8 * 20.0}, 8,
                    0, {"front_end_rows": np.asarray([1])}))
    assert one == pytest.approx(100 * front_end_bound_ms(131072) / 0.020)


def test_traced_run_reads_the_program_spans():
    """A traced run on the CPU: the span readers read the calls of the
    window; the kernels' metrics have no kernel to read there."""
    out = _run(trace=True, seconds=1.0)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for metric in SPAN_METRICS:
        assert got[metric]["value"] > 0, metric
    assert "front_end_rows_roofline_pct.stations" not in got


def test_control_takes_the_kinds_input_and_tunings():
    """`calibrate.py` puts the control on the four station receivers of
    the kind's capture; on the CPU (no TF32) it equals the reference."""
    from fmbench.calibrate import control
    torch.set_num_threads(4)
    got = control(Bench(), CELL, 5, 1.0, "cpu", SMALL, {"blocks": 4})
    assert sorted(int(t) for t in got["by_tune_hz"]) == STATION_OFFSETS
    assert got["control"]["audio_err"] == 0 and got["fails"] == []


def test_a_station_without_its_receiver_is_refused():
    kind = Bench().kind("stations")
    bench = Bench()
    ctx = types.SimpleNamespace(
        receiver={**bench.config("stations_19")["receiver"], **SMALL},
        traffic={**bench.traffic("file_19"), "blocks": 1},
        config={"receivers_hz": [0]}, seed=1, seconds=0.1, trace=False,
        device=torch.device("cpu"), t_start=0.0)
    with pytest.raises(ValueError, match="every station needs"):
        kind.run(ctx)
