"""The plain reference: it decodes the station's planted RDS from a short
capture, agrees with the program on the CPU, and imports nothing it must
not."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from fmbench.compare import numbers
from fmbench.harness import (HERE, forbidden_modules, reference_outputs,
                             reference_run)
from fmbench.reference import decode_rds
from fmbench.synth import StationParams, StationSynth

BLOCK_FM = 16384
CFG = {"block_fm": BLOCK_FM, "rds": "block", "audio_filter_hz": 15000,
       "iq_format": "i16"}
T = BLOCK_FM * 12
NB = 40                       # 3.4 s of air: a whole RDS rotation and more


@pytest.fixture(scope="module")
def capture():
    torch.set_num_threads(4)
    return StationSynth(StationParams(), 2 ** 31 + 3, NB * T).next(
        NB * T).numpy()


@pytest.fixture(scope="module")
def ref_out(capture):
    return reference_outputs(CFG, lambda b: capture[b * T:(b + 1) * T], NB,
                             torch.device("cpu"))


def test_reference_decodes_the_planted_rds(ref_out):
    d = decode_rds(np.concatenate([o["bits"] for o in ref_out]))
    p = StationParams()
    assert d["pi"] == p.pi and d["ps"] == p.ps and d["rt"] == p.rt
    assert d["crc_errors"] == 0 and d["groups"] >= 20
    assert ref_out[-1]["locked"]
    rms = np.sqrt(np.mean(ref_out[-1]["audio"].astype(np.float64) ** 2))
    assert 0.2 < rms < 1.0


def test_reference_agrees_with_the_program(capture, ref_out):
    from fmbench.harness import ProgramRun, rds_report
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu_torch.rds.live import LiveRDSDecoder
    rx = Receiver(ReceiverConfig(**CFG), device="cpu")
    s, c = rx.init_state(), rx.initial_controls()
    audio, bits = [], []
    for b in range(NB):
        s, o = rx.step(s, c, torch.from_numpy(capture[b * T:(b + 1) * T]))
        n = int(o.rds.count)
        audio.append(o.audio.numpy())
        bits.append(o.rds.bits[:n].numpy())
    bits = np.concatenate(bits)
    dec = LiveRDSDecoder()
    dec.feed(bits)
    p = StationParams()
    run = ProgramRun(NB, np.concatenate(audio), bits, rds_report(dec), CFG,
                     p, None)
    got = numbers([(run, ref_out)])
    assert got["audio_err"] < 2e-5
    assert got["rds_bit_errors"] == 0 and got["rds_decode_errors"] == 0
    # the reference in the program's place reads 0 on the CPU (no TF32)
    assert numbers([(reference_run(ref_out, CFG, p, None),
                     ref_out)])["audio_err"] == 0


FORBIDDEN = {"jax", "jaxlib", "flax", "sdrjfm_tpu"}


def _imports(path: Path):
    """(top-level name, relative level) of each import in a file; a
    relative import's name is its module's within the package ('' for
    `from . import x`)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def _bad_imports(path: Path, reference: bool):
    """What a file under fmbench must not import: JAX or the JAX package;
    and in a reference module, besides, the program, the rest of the
    benchmark, or anything above `reference/` by a relative import."""
    bad = set()
    for top, level in _imports(path):
        if level == 0 and top in FORBIDDEN:
            bad.add(top)
        if reference and (level > 1 or level == 0 and top in (
                "sdrjfm_tpu_torch", "fmbench")):
            bad.add("." * level + top)
    return bad


def test_import_guard():
    """Nothing under fmbench imports JAX or the JAX package, and no file
    under reference/, whatever a configuration names, imports anything of
    the program or of the benchmark outside reference/ (top-level names
    compared whole: sdrjfm_tpu_torch begins with sdrjfm_tpu)."""
    refs = sorted((HERE / "reference").rglob("*.py"))
    assert {p.name for p in refs} >= {"receiver.py", "rds.py", "design.py"}
    for path in HERE.rglob("*.py"):
        ref = path in refs
        assert not _bad_imports(path, ref), (path, _bad_imports(path, ref))


@pytest.mark.parametrize("line,bad", [
    ("import sdrjfm_tpu_torch.ops.blockops", "sdrjfm_tpu_torch"),
    ("from jax import numpy", "jax"),
    ("import sdrjfm_tpu", "sdrjfm_tpu"),
    ("from fmbench.synth import StationSynth", "fmbench"),
    ("from ..harness import judge", "..harness"),
    ("from . import design", None)])
def test_import_guard_holds_a_new_reference_module(tmp_path, line, bad):
    path = tmp_path / "tuned.py"
    path.write_text(line + "\n")
    assert _bad_imports(path, True) == ({bad} if bad else set())


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "sdrjfm_tpu_torch_probe",
                        types.ModuleType("sdrjfm_tpu_torch_probe"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sdrjfm_tpu.ops",
                        types.ModuleType("sdrjfm_tpu.ops"))
    assert forbidden_modules() == ["sdrjfm_tpu.ops"]


def test_rds_bits_compared_as_one_stream(capture, ref_out, monkeypatch):
    """A run whose first bit timing took the other half-symbol peak frames
    the same bits into other blocks: compared as one stream, it matches.
    A flipped bit counts one; a slipped bit and a burst count every bit
    they turn."""
    from fmbench.harness import ProgramRun
    real = torch.argmax
    calls = []

    def other_peak(x, *a, **k):
        calls.append(1)
        r = real(x, *a, **k)
        return (r + 32) % 64 if len(calls) == 1 else r
    monkeypatch.setattr(torch, "argmax", other_peak)
    alt = reference_outputs(CFG, lambda b: capture[b * T:(b + 1) * T], NB,
                            torch.device("cpu"))
    monkeypatch.setattr(torch, "argmax", real)
    assert any(len(a["bits"]) != len(b["bits"])
               for a, b in zip(alt, ref_out))
    p = StationParams()
    run = reference_run(alt, CFG, p, None)

    def errors(bits):
        return numbers([(ProgramRun(NB, run.audio, bits, None, CFG, p, None),
                         ref_out)])["rds_bit_errors"]
    assert errors(run.bits) == 0
    bits = run.bits.copy()
    bits[-300] ^= 1
    assert errors(bits) == 1
    assert errors(np.delete(run.bits, len(run.bits) // 2)) > 100
    bits = run.bits.copy()
    bits[-400:-360] ^= 1
    assert errors(bits) == 40
