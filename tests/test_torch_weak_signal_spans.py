"""The receiver's spans for its optional stages, and the weak-signal cell
(`weak_signal.file_1`) with its timed path broken, on the CPU at a small
size.

- Stepped block by block, a receiver opens `rx.input_filter` (count: the
  block's input frames), `rx.squelch` (its hold periods) and `rx.rds_scan`
  (its 24 kS/s samples) once a block, each under its own option and only
  there; under `stereo_rds`'s configuration none opens.
- Every output of `stereo_rds`'s and the weak-signal configuration is the
  same, byte for byte (SHA-256 of `Output.for_host()`), with the spans as
  with `spans.span` replaced by a context that records nothing.
- A whole run of the cell through the harness is `correct`; with the input
  filter left out, one hold period's squelch decision flipped, or one
  decoder-2 bit flipped, it is not.

It imports no JAX."""

import contextlib
import hashlib
import json

import numpy as np
import pytest
import torch

from fmbench.harness import ROOT, Bench, run_cell
from fmbench.synth import StationParams, StationSynth
from sdrjfm_tpu_torch.kernels import loops as L
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu_torch.ops import blockops as B
from sdrjfm_tpu_torch.runtime import spans

BLOCK_FM = 16384
T = 12 * BLOCK_FM
NB = 3
BASE = {"block_fm": BLOCK_FM, "audio_filter_hz": 15000, "iq_format": "i16"}
STEREO_RDS = {**BASE, "rds": "block"}
WEAK = {**BASE, "rds": "scan2", "squelch": "nsq", "input_filter": True}
NAMES = ("rx.input_filter", "rx.squelch", "rx.rds_scan")
# each option alone, then all three: the spans it opens with their counts
OPTIONS = {
    "input_filter": ({"input_filter": True}, {"rx.input_filter": T}),
    "nsq": ({"squelch": "nsq"}, {"rx.squelch": BLOCK_FM // 8192}),
    "lsq": ({"squelch": "lsq"}, {"rx.squelch": BLOCK_FM // 8192}),
    "scan1": ({"rds": "scan1"}, {"rx.rds_scan": BLOCK_FM // 8}),
    "scan2": ({"rds": "scan2"}, {"rx.rds_scan": BLOCK_FM // 8}),
    "scan3": ({"rds": "scan3"}, {"rx.rds_scan": BLOCK_FM // 8}),
    "weak_signal": (WEAK, {"rx.input_filter": T,
                           "rx.squelch": BLOCK_FM // 8192,
                           "rx.rds_scan": BLOCK_FM // 8}),
    "stereo_rds": (STEREO_RDS, {})}


@pytest.fixture(scope="module")
def wire():
    torch.set_num_threads(4)
    return StationSynth(StationParams(amplitude=0.05), 2 ** 31 + 5,
                        NB * T).next(NB * T)


def _steps(cfg, wire):
    """NB eager steps: (the digest of their outputs, the spans they
    recorded)."""
    rx = Receiver(ReceiverConfig(**cfg), device="cpu")
    st, ctl = rx.init_state(), rx.initial_controls()
    last = max((r.seq for r in spans.records()), default=-1)
    h = hashlib.sha256()
    for b in range(NB):
        st, out = rx.step(st, ctl, wire[b * T:(b + 1) * T])
        for k, v in sorted(out.for_host().items()):
            h.update(k.encode())
            h.update(np.ascontiguousarray(v.numpy()).tobytes())
    return h.hexdigest(), [r for r in spans.records() if r.seq > last]


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_a_stage_is_one_span_a_block_under_its_option(wire, option):
    change, want = OPTIONS[option]
    _, recs = _steps({**STEREO_RDS, **change}, wire)
    for name in NAMES:
        got = [r for r in recs if r.name == name]
        if name in want:
            assert len(got) == NB, (name, len(got))
            assert all(r.count == want[name] and r.t1 >= r.t0
                       and not r.profiled for r in got)
        else:
            assert not got, name


@pytest.mark.parametrize("config", ["stereo_rds", "weak_signal"])
def test_outputs_unchanged_by_the_spans(wire, config, monkeypatch):
    digest, recs = _steps(OPTIONS[config][0], wire)
    monkeypatch.setattr(spans, "span",
                        lambda *a, **k: contextlib.nullcontext())
    bare, bare_recs = _steps(OPTIONS[config][0], wire)
    assert digest == bare
    assert not any(r.name in NAMES for r in bare_recs)
    assert any(r.name in NAMES for r in recs) == (config == "weak_signal")


# ---------------------------------------------------------------------------
# the cell with its timed path broken
# ---------------------------------------------------------------------------

CELL = "weak_signal.file_1"
TRAFFIC = {"blocks": 10, "warmup_passes": 1, "kept_passes": 1}


def _filter_left_out(monkeypatch):
    """The strong input filter hands its input on unfiltered."""
    real = B.fft_filter_apply

    def skipped(x, response, hop, carry):
        if response.shape[-1] == 65536:
            return x, carry
        return real(x, response, hop, carry)
    monkeypatch.setattr(B, "fft_filter_apply", skipped)


def _decision_flipped(monkeypatch):
    """The noise squelch's second hold period of every block gated with
    its decision flipped."""
    real = L.squelch_gate

    def flipped(mode, a, b, x, thr, avg0, sup0, hold, alpha):
        y, sups, sup, avgs = real(mode, a, b, x, thr, avg0, sup0, hold,
                                  alpha)
        sups = sups.clone()
        sups[..., 1] = ~sups[..., 1]
        return L.gate_periods(x, sups, hold), sups, sup, avgs
    monkeypatch.setattr(L, "squelch_gate", flipped)


def _bit_flipped(monkeypatch):
    """One decoder-2 bit of every block flipped where the chain hands it
    out."""
    chain = Receiver.fm_chain

    def altered(self, *a, **k):
        state, out = chain(self, *a, **k)
        bits = out.rds.bits.clone()
        bits[5] ^= 1
        return state, out._replace(rds=out.rds._replace(bits=bits))
    monkeypatch.setattr(Receiver, "fm_chain", altered)


FAULTS = {"input_filter_left_out": _filter_left_out,
          "squelch_decision_flipped": _decision_flipped,
          "decoder2_bit_flipped": _bit_flipped}


def _run():
    torch.set_num_threads(4)
    return run_cell(Bench(), CELL, 2 ** 31 + 126, 0.1, False, "cpu", None,
                    {"block_fm": BLOCK_FM}, TRAFFIC)


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 10
    assert set(out["metrics"]) == {"air_x", "setup_s"}
    config = json.loads((ROOT / "fmbench/configs/weak_signal.json")
                        .read_text())
    assert set(out["checks"]) == set(config["checks"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run()
    assert not out["correct"], out["checks"]
