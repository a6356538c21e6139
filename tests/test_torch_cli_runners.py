"""The port's `rx` runners and streaming inputs through the CLI, on the CPU
(`--device cpu`): each decodes the synth capture's PI/PS/RT at BER 0 with
the pilot locked, and gives the loop runner's audio bit for bit (the CPU
runs one eager body for every runner; the streaming sinks' PCM16 comes
from the on-device quantizer, which equals the host's).  The flags of the
control and checkpoint surface run on the head of the capture as in the
JAX CLI (the same exit code and report), and the live sources without
their device exit 2 with the JAX CLI's "loading device failed".
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from sdrjfm_tpu_torch import app
from sdrjfm_tpu_torch import constants as C
from sdrjfm_tpu_torch.io.pcmout import quantize_pcm16
from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw, read_wav

ROOT = Path(__file__).resolve().parent.parent
BLOCK_FM = 16384


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_runners")
    wav = d / "iq.wav"
    assert app.main(["synth", "--out", str(wav), "--seconds", "2",
                     "--station", "TPU FM", "--radiotext", "VERIFY RUN",
                     "--pi", "0x10F0", "--pty", "10", "--int16"]) == 0
    loop = _rx(d, "loop", wav)
    return d, wav, loop


def _rx(d, name, iq, *flags):
    audio, rep = d / f"{name}.wav", d / f"{name}.json"
    assert app.main(["rx", "--iq", str(iq), "--audio", str(audio), "--rds",
                     "--report", str(rep), "--block-fm", str(BLOCK_FM),
                     "--device", "cpu", *flags]) == 0
    x, info = read_wav(str(audio))
    assert info.rate == 48_000
    return x, json.loads(rep.read_text())


def _decoded(rep):
    rds = rep["rds"]
    assert rds["pi_code"] == "0x10F0"
    assert rds["station_label"].strip() == "TPU FM"
    assert rds["radio_text"] == "VERIFY RUN"
    assert rds["bit_error_rate"] == 0.0
    assert rep["meta_last"]["pilot_locked"]


@pytest.mark.parametrize("flags", [["--runner", "scan"],
                                   ["--runner", "scan", "--chunk-blocks",
                                    "5"]], ids=["scan", "scan_chunk5"])
def test_scan_runner(capture, flags):
    d, wav, (x_loop, rep_loop) = capture
    _decoded(rep_loop)
    x, rep = _rx(d, "scan", wav, *flags)
    _decoded(rep)
    assert rep["blocks"] == rep_loop["blocks"]
    np.testing.assert_array_equal(x, x_loop)


def test_pcm_out_and_log_meta(capture):
    d, wav, (x_loop, rep_loop) = capture
    pcm, log = d / "out.pcm", d / "meta.jsonl"
    x, rep = _rx(d, "pcm", wav, "--pcm-out", str(pcm), "--log-meta",
                 str(log))
    _decoded(rep)
    np.testing.assert_array_equal(x, x_loop)
    raw = np.fromfile(str(pcm), "<i2").reshape(-1, 2)
    np.testing.assert_array_equal(raw, quantize_pcm16(x_loop))
    recs = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert len(recs) == rep["blocks"]
    blk_s = BLOCK_FM / C.FM_RATE
    assert [r["block"] for r in recs] == list(range(len(recs)))
    assert recs[-1]["t_s"] == pytest.approx(len(recs) * blk_s)
    assert recs[-1]["pilot_locked"] == rep["meta_last"]["pilot_locked"]


def test_follow_no_pace(capture):
    d, wav, (x_loop, rep_loop) = capture
    x, rep = _rx(d, "follow", wav, "--follow", "--no-pace")
    _decoded(rep)
    assert rep["ingest_dropped"] == 0
    assert rep["blocks"] == rep_loop["blocks"]
    assert 0 < rep["latency_ms"]["p50"] <= rep["latency_ms"]["max"]
    np.testing.assert_array_equal(x, x_loop)


@pytest.mark.parametrize("flags, names", [
    (["--runner", "scan"], {"scan.pass", "scan.stage", "scan.replays",
                            "scan.fetch_wait", "scan.fetch_copy",
                            "scan.assemble", "scan.load"}),
    (["--follow", "--no-pace"], {"live.block", "live.step", "source.read",
                                 "live.upload", "live.fetch_wait",
                                 "live.deliver", "live.hooks"})],
    ids=["scan", "follow"])
def test_profile_holds_the_runners_spans(capture, flags, names):
    """`--profile DIR`: the runner's spans as ranges of the Chrome trace
    and in the program's record beside it."""
    d, wav, (x_loop, _) = capture
    prof = d / f"prof_{flags[-1]}"
    x, rep = _rx(d, f"prof{flags[-1]}", wav, *flags, "--profile", str(prof))
    _decoded(rep)
    np.testing.assert_array_equal(x, x_loop)
    trace, = prof.glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert names <= {e["name"] for e in events
                     if e.get("cat") == "user_annotation"}
    rec, = prof.glob("spans_*.json")
    # (the process's earlier runs are in the record too)
    assert names <= {s["name"] for s in json.loads(rec.read_text())["spans"]
                     if s["profiled"]}


def test_follow_loop_seconds(capture):
    d, wav, _ = capture
    _, rep = _rx(d, "loop3", wav, "--follow", "--no-pace",
                 "--loop-seconds", "3")
    assert rep["blocks"] == int(3 * C.INPUT_RATE) // (BLOCK_FM * 12)
    assert rep["rds"]["pi_code"] == "0x10F0"


def test_follow_dumps_equal_offline_dumps(capture):
    d, wav, _ = capture
    dumps = {}
    for mode, extra in (("off", []), ("live", ["--follow", "--no-pace"])):
        dumps[mode] = [d / f"{mode}_{k}.wav" for k in ("if", "mpx")]
        _rx(d, f"dumps_{mode}", wav, "--dump-if", str(dumps[mode][0]),
            "--dump-mpx", str(dumps[mode][1]), *extra)
    for a, b in zip(dumps["off"], dumps["live"]):
        assert a.read_bytes() == b.read_bytes()


def test_stdin_pipe(capture):
    """`--iq -`: the u8 frames on stdin through NativePipeSource, in a
    child process (stdin is the pipe)."""
    d, wav, _ = capture
    i16, _ = read_iq_wav_raw(str(wav))
    u8 = np.clip(np.round(i16.astype(np.float32) / 256.0 + 127.0), 0, 255
                 ).astype(np.uint8)
    raw = d / "cap.u8"
    u8.tofile(str(raw))
    rep = d / "stdin.json"
    with open(raw, "rb") as f:
        r = subprocess.run(
            [sys.executable, "-m", "sdrjfm_tpu_torch.app", "rx", "--iq", "-",
             "--iq-format", "u8", "--rds", "--report", str(rep),
             "--block-fm", str(BLOCK_FM), "--device", "cpu"],
            stdin=f, cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(rep.read_text())
    assert out["ingest_dropped"] == 0
    assert out["blocks"] == len(u8) // (BLOCK_FM * 12)
    _decoded(out)


def test_fifo_input(capture, tmp_path):
    d, wav, (x_loop, _) = capture
    i16, _ = read_iq_wav_raw(str(wav))
    fifo = str(tmp_path / "iq.fifo")
    os.mkfifo(fifo)

    def write():
        with open(fifo, "wb") as f:
            f.write(i16.tobytes())

    t = threading.Thread(target=write, daemon=True)
    t.start()
    x, rep = _rx(d, "fifo", fifo, "--iq-format", "i16")
    t.join()
    _decoded(rep)
    np.testing.assert_array_equal(x, x_loop)


@pytest.fixture(scope="module")
def head(capture):
    """The first four blocks of the capture."""
    d, wav, _ = capture
    from sdrjfm_tpu_torch.io.wavio import write_iq_wav
    i16, rate = read_iq_wav_raw(str(wav))
    x = np.asarray(i16[: 4 * BLOCK_FM * 12], np.float32) / 32768.0
    out = d / "head.wav"
    write_iq_wav(str(out), (x[:, 0] + 1j * x[:, 1]).astype(np.complex64),
                 rate, float32=False)
    return out


@pytest.mark.parametrize("argv", [
    ["--stations", "s.json"], ["--control", "-"], ["--gain", "10"],
    ["--config", "c.json"], ["--save-state", "s.npz"], ["--meter"]])
def test_rx_flags_run_as_in_jax_cli(head, tmp_path, capsys, monkeypatch,
                                    argv):
    """Each flag on the loop runner: the JAX CLI's exit code, report and
    control section, and the files it writes (an empty control channel
    handles no command; --gain without an rtl device and --meter without a
    streaming runner exit 2 with JAX's message)."""
    import io
    from sdrjfm_tpu import app as japp
    out = {}
    for who, main, extra in (("jax", japp.main, []),
                             ("port", app.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO(""))
        d = tmp_path / who
        d.mkdir()
        rep = d / "r.json"
        a = [str(d / x) if "." in x else x for x in argv]
        rc = main(["rx", "--iq", str(head), "--rds", "--block-fm",
                   str(BLOCK_FM), "--report", str(rep), *a, *extra])
        err = capsys.readouterr().err.strip().splitlines()[-1]
        out[who] = (rc, json.loads(rep.read_text()) if rc == 0 else err, d)
    (rcj, rj, dj), (rct, rt, dt) = out["jax"], out["port"]
    assert rct == rcj
    if rct != 0:
        assert rt == rj
        return
    assert rt["blocks"] == rj["blocks"] == 4
    assert rt.get("control") == rj.get("control")
    assert rt["rds"]["bit_error_rate"] == rj["rds"]["bit_error_rate"]
    for name in ("c.json", "s.npz"):
        if name in argv:
            assert (dt / name).exists() and (dj / name).exists()
    if "c.json" in argv:
        assert json.loads((dt / "c.json").read_text()) == \
            json.loads((dj / "c.json").read_text())


@pytest.mark.parametrize("iq", ["rtl_tcp://localhost:1234", "rtlsdr",
                                "airspy", "hackrf", "sdrplay"])
def test_sources_without_device_exit_2_as_jax_cli(capsys, monkeypatch,
                                                  tmp_path, iq):
    from sdrjfm_tpu import app as japp
    for env in ("RTLSDR", "AIRSPY", "HACKRF", "SDRPLAY"):
        monkeypatch.setenv(f"SDRJFM_LIB{env}", str(tmp_path / "none.so"))
    assert japp.main(["rx", "--iq", iq, "--block-fm", "12288"]) == 2
    jerr = capsys.readouterr().err.strip().splitlines()[-1]
    assert app.main(["rx", "--iq", iq, "--block-fm", "12288", "--device",
                     "cpu"]) == 2
    terr = capsys.readouterr().err.strip().splitlines()[-1]
    assert terr == jerr and terr.startswith("loading device failed")


def test_bad_runner_arguments_exit_2(capture, capsys):
    d, wav, _ = capture
    assert app.main(["rx", "--iq", str(wav), "--runner", "scan",
                     "--chunk-blocks", "0", "--device", "cpu"]) == 2
    assert app.main(["rx", "--iq", "-", "--device", "cpu"]) == 2
    assert "--iq-format" in capsys.readouterr().err
