"""The n-station path as a band monitor runs it, on the CPU at a small
size: a four-station capture (`fmbench.synth.StationsSynth`) through
`demodulate_stations` over the 19 receivers of the 100 kHz raster across
+-900 kHz.

- The four station receivers agree with the benchmark's plain reference
  (`fmbench.reference.receiver.PlainReceiver`, plain torch in float32)
  tuned to each station: audio within AUDIO_ATOL, no RDS bit error
  (`fmbench.compare.numbers`).
- One call is one `stations.pass` span whose direct children are the
  path's parts (`stations.load`, the chunk drive's staging ranges,
  replays and fetches on every device, `stations.assemble`), and the
  counters `stations.rows` and `stations.dummy_rows` grow by its rows.
- Staged a block a range, each block is its own `scan.stage` and
  `scan.replays` on every device, and the outputs do not change.
- Every receiver's outputs hash to the bytes pinned before the path had
  spans (SHA-256 of offset, audio, RDS bits and the last metadata, the
  same seed), on the scan path, the block-by-block path and a two-device
  CPU mesh (whose padding row counts in `stations.dummy_rows`).

It imports no JAX."""

import hashlib
import json

import numpy as np
import pytest
import torch

from fmbench.compare import numbers
from fmbench.harness import ProgramRun, reference_outputs
from fmbench.synth import StationParams, StationsSynth
from sdrjfm_tpu_torch.models.multistation import demodulate_stations
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu_torch.parallel.sharding import make_mesh
from sdrjfm_tpu_torch.runtime import graph as G
from sdrjfm_tpu_torch.runtime import spans

# the benchmark's four stations (offset Hz, PI, PS, left Hz, right Hz),
# each at 0.22 of full scale with RDS at 8 %
STATIONS = ((-600_000, 0x1111, "STATION1", 700.0, 1100.0),
            (-200_000, 0x2222, "STATION2", 1300.0, 500.0),
            (300_000, 0x3333, "STATION3", 900.0, 1700.0),
            (700_000, 0x4444, "STATION4", 1900.0, 400.0))
OFFSETS = [s[0] for s in STATIONS]
RASTER_19 = list(range(-900_000, 900_001, 100_000))
PARAMS = [StationParams(left_hz=fl, right_hz=fr, rds_level=0.08,
                        amplitude=0.22, pi=pi, ps=ps, rt="RT " + ps,
                        carrier_hz=float(off))
          for off, pi, ps, fl, fr in STATIONS]

BLOCK_FM = 16384
CFG = {"block_fm": BLOCK_FM, "rds": "block", "audio_filter_hz": 15000,
       "iq_format": "i16"}
T = 12 * BLOCK_FM
NB = 40                       # 3.4 s of air: a whole RDS rotation and more
SEED = 2 ** 31 + 3
AUDIO_ATOL = 2e-5             # the port's float32 chain against the
                              # reference's on the CPU
# every receiver's outputs at SEED before the path had spans
PINNED = "d51d763bb3fa1b1335cf3b0ed00cda3da0c86b43038a970ad1503d2d710336f6"
RANGES = 8                    # 5 blocks of 786,432 B a 4 MiB staging range
FETCH = ["scan.fetch_wait", "scan.fetch_copy"]
RANGE = ["scan.stage", "scan.replays"]
CHILDREN = {
    "scan": ["stations.load"] + RANGE * RANGES + FETCH
    + ["stations.assemble"],
    "loop": ["stations.load"] + (RANGE + FETCH) * NB          # chunks of 1
    + ["stations.assemble"],
    "mesh": ["stations.load"] + (["scan.stage"] * 2 + ["scan.replays"] * 2)
    * RANGES + FETCH * 2 + ["stations.assemble"]}
DRIVES = {"scan": 1, "loop": 1, "mesh": 2}
PATHS = sorted(CHILDREN)


def _block(wire):
    return lambda b: wire[b * T:(b + 1) * T]


@pytest.fixture(scope="module")
def capture():
    torch.set_num_threads(4)
    return StationsSynth(PARAMS, SEED, NB * T).next(NB * T).numpy()


@pytest.fixture(scope="module")
def calls(capture):
    """One call on each path, with the spans it recorded and the counters'
    growth."""
    rx = Receiver(ReceiverConfig(**CFG), device="cpu")
    kw = {"scan": {}, "loop": {"scan": False},
          "mesh": {"mesh": make_mesh(2, axis="stations", device="cpu")}}
    out = {}
    for path in PATHS:
        rows = spans.counters.get("stations.rows", 0)
        dummy = spans.counters.get("stations.dummy_rows", 0)
        last = max((r.seq for r in spans.records()), default=-1)
        res = demodulate_stations(rx, capture, RASTER_19, **kw[path])
        recs = [r for r in spans.records() if r.seq > last]
        out[path] = {"results": res, "records": recs,
                     "rows": spans.counters["stations.rows"] - rows,
                     "dummy_rows": (spans.counters["stations.dummy_rows"]
                                    - dummy)}
    return out


@pytest.mark.parametrize("k", range(len(STATIONS)))
def test_station_receivers_agree_with_the_reference(capture, calls, k):
    off = OFFSETS[k]
    got = {r["offset_hz"]: r for r in calls["scan"]["results"]}[off]
    ref = reference_outputs(CFG, _block(capture), NB, torch.device("cpu"),
                            tune_hz=off)
    run = ProgramRun(NB, got["audio"], got["rds_bits"], None, CFG,
                     PARAMS[k], _block(capture), off)
    n = numbers([(run, ref)])
    assert n["audio_err"] < AUDIO_ATOL, n
    assert n["rds_bit_errors"] == 0, n
    assert len(got["rds_bits"]) > 1000 and got["meta"]["pilot_locked"]


@pytest.mark.parametrize("path", PATHS)
def test_one_call_is_one_pass_of_spans(calls, path):
    c = calls[path]
    passes = [r for r in c["records"] if r.name == "stations.pass"]
    assert len(passes) == 1
    p = passes[0]
    assert p.count == NB and p.parent == -1 and not p.profiled
    kids = [r for r in c["records"] if r.parent == p.seq]
    assert [r.name for r in kids] == CHILDREN[path]
    assert all(p.t0 <= r.t0 <= r.t1 <= p.t1 for r in kids)
    for name in RANGE:
        assert sum(r.count for r in kids if r.name == name) \
            == DRIVES[path] * NB
    assert all(r.count > 0 for r in kids if r.name == "scan.fetch_copy")
    assert c["rows"] == len(RASTER_19) * NB
    # 19 stations over two devices: one padding row
    assert c["dummy_rows"] == (DRIVES[path] - 1) * NB


def _digest(res) -> str:
    assert [r["offset_hz"] for r in res] == RASTER_19
    h = hashlib.sha256()
    for r in res:
        h.update(np.int64(r["offset_hz"]).tobytes())
        h.update(np.ascontiguousarray(r["audio"]).tobytes())
        h.update(np.ascontiguousarray(r["rds_bits"]).tobytes())
        h.update(json.dumps(r["meta"], sort_keys=True).encode())
    return h.hexdigest()


@pytest.mark.parametrize("path", PATHS)
def test_outputs_unchanged_by_the_spans(calls, path):
    assert _digest(calls[path]["results"]) == PINNED


@pytest.mark.parametrize("devices", [1, 2])
def test_a_range_a_block_stages_and_replays_each_block(capture, monkeypatch,
                                                       devices):
    """With a staging range of one block's bytes, each block is its own
    `scan.stage` and `scan.replays` (count 1) on every device's part,
    `scan.stage_ranges` grows by the blocks times the parts, and every
    receiver's outputs still hash to PINNED."""
    rx = Receiver(ReceiverConfig(**CFG), device="cpu")
    kw = ({} if devices == 1
          else {"mesh": make_mesh(2, axis="stations", device="cpu")})
    monkeypatch.setattr(G, "STAGE_RANGE_BYTES", T * 2 * 2)     # i16 pairs
    ranges = spans.counters["scan.stage_ranges"]
    last = max((r.seq for r in spans.records()), default=-1)
    res = demodulate_stations(rx, capture, RASTER_19, **kw)
    recs = [r for r in spans.records() if r.seq > last]
    p, = [r for r in recs if r.name == "stations.pass"]
    kids = [r for r in recs if r.parent == p.seq]
    assert [r.name for r in kids] == (
        ["stations.load"]
        + (["scan.stage"] * devices + ["scan.replays"] * devices) * NB
        + FETCH * devices + ["stations.assemble"])
    assert all(r.count == 1 for r in kids if r.name in RANGE)
    assert spans.counters["scan.stage_ranges"] - ranges == NB * devices
    assert _digest(res) == PINNED
