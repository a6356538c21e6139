"""A whole run of each cell on the CPU at a small size, past the
harness's look for a card: sound, `correct` comes out true; with the
timed path broken underneath, false.  The faults a cell of this receiver
can have: a step that returns its state unchanged, an answer altered
where it is produced (the audio, an RDS bit, the decoded text), and an
RDS bit timing that slips a bit or samples a quarter bit off the
symbols' peaks.  Besides the benchmark's cells, a live cell that decodes
RDS is added by a configuration file and a BENCHMARK.json entry alone, as
a later change would add it."""

import json

import pytest
import torch

from fmbench.harness import ROOT, Bench, run_cell
from sdrjfm_tpu_torch.models.receiver import Receiver

SMALL = {"block_fm": 16384}
TRAFFIC = {"stereo_rds.file_1": ({"blocks": 40, "warmup_passes": 1,
                                  "kept_passes": 2}, 0.1),
           "stereo_live.live_1x": ({}, 2.0),
           "stereo_rds_live.live_1x": ({}, 2.0)}
RDS_CELLS = ("stereo_rds.file_1", "stereo_rds_live.live_1x")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The benchmark with a live cell that decodes RDS added by files."""
    tmp = tmp_path_factory.mktemp("bench")
    cfg = json.loads((ROOT / "fmbench/configs/stereo_live.json").read_text())
    cfg["receiver"]["rds"] = "block"
    cfg["checks"] = {"audio_err": 1e-4, "rds_bit_errors": 0,
                     "rds_decode_errors": 0}
    (tmp / "stereo_rds_live.json").write_text(json.dumps(cfg))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "stereo_rds_live",
                            "source": cfg["source"],
                            "file": str(tmp / "stereo_rds_live.json"),
                            "reduced": [], "why": "RDS decoded live"})
    spec["workloads"].append({"name": "stereo_rds_live.live_1x",
                              "config": "stereo_rds_live",
                              "traffic": "live_1x", "chips": 1,
                              "why": "RDS decoded live"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "stereo_live.live_1x" in m.get("workloads", []):
            m["workloads"].append("stereo_rds_live.live_1x")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(tmp / "BENCHMARK.json")


def _state_unchanged(monkeypatch):
    step = Receiver.step

    def stuck(self, state, controls, iq):
        _, out = step(self, state, controls, iq)
        return state, out
    monkeypatch.setattr(Receiver, "step", stuck)


def _altered(monkeypatch, what):
    chain = Receiver.fm_chain

    def altered(self, *a, **k):
        state, out = chain(self, *a, **k)
        if what == "audio":
            audio = out.audio.clone()
            audio[0, 0] += 0.01
            return state, out._replace(audio=audio)
        bits = out.rds.bits.clone()
        bits[5] ^= 1
        return state, out._replace(rds=out.rds._replace(bits=bits))
    monkeypatch.setattr(Receiver, "fm_chain", altered)


def _text_altered(monkeypatch):
    """The RDS decoder's answer altered where it is produced (the live
    cell's timed path runs the decoder)."""
    from sdrjfm_tpu_torch.rds.groups import GroupDecoder
    decode = GroupDecoder.decode

    def altered(self, grp):
        decode(self, grp)
        self.result.station_label = "XPU FM  "
    monkeypatch.setattr(GroupDecoder, "decode", altered)


def _timing(monkeypatch, what):
    """The bit recovery's timing broken: every 20th block's grid a whole
    bit late (a bit slipped), or every block's bits read from a grid a
    quarter bit off the tracker's (between the halves of a biphase
    symbol) while the tracker runs on as it would."""
    import sdrjfm_tpu_torch.models.receiver as receiver
    from sdrjfm_tpu_torch.rds.bitrecovery import SPS
    recover = receiver.recover_bits
    calls = [0]

    def broken(z, cfg, state):
        calls[0] += 1
        if what == "slip":
            if calls[0] % 20 == 12:
                state = state._replace(tau=state.tau + SPS)
            return recover(z, cfg, state)
        _, demod, new = recover(z, cfg, state)
        blk, _, _ = recover(z, cfg, state._replace(tau=state.tau + SPS / 4))
        return blk, demod, new
    monkeypatch.setattr(receiver, "recover_bits", broken)


FAULTS = {"state_unchanged": _state_unchanged,
          "audio_altered": lambda m: _altered(m, "audio"),
          "rds_bit_altered": lambda m: _altered(m, "bits"),
          "rds_bit_slipped": lambda m: _timing(m, "slip"),
          "rds_timing_quarter_bit": lambda m: _timing(m, "quarter")}


RDS_FAULTS = {"rds_bit_altered", "rds_bit_slipped", "rds_timing_quarter_bit"}
CASES = [(c, f) for c in sorted(TRAFFIC) for f in sorted(FAULTS)
         if c in RDS_CELLS or f not in RDS_FAULTS]


def _run(bench, cell):
    torch.set_num_threads(4)
    traffic, seconds = TRAFFIC[cell]
    return run_cell(bench, cell, 2 ** 31 + 11, seconds, False, "cpu",
                    None, SMALL, traffic)


@pytest.mark.parametrize("cell", sorted(TRAFFIC))
def test_sound_run_is_correct(bench, cell):
    out = _run(bench, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    names = {m for m in out["metrics"]}
    assert "setup_s" in names and len(names) == 2


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_path_is_not_correct(bench, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(bench, cell)
    assert not out["correct"], out["checks"]


def test_live_decoder_answer_altered_is_not_correct(bench, monkeypatch):
    _text_altered(monkeypatch)
    out = _run(bench, "stereo_rds_live.live_1x")
    assert not out["correct"]
    assert out["checks"]["rds_decode_errors"]["value"] > 0
