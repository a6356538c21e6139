"""The port's rtl_tcp source against the JAX package's, on the CPU, over an
in-repo rtl_tcp server (tests/torch_parity.py MockRtlTcpServer).

Both packages' RtlTcpSource read the same header and frames and put the
same command bytes on the wire; with --reconnect-timeout a dropped session
is reopened and the settings replayed; `open_source('rtltcp://...')` is the
JAX adapter; `rx --iq rtl_tcp://...` gives the JAX CLI's report (blocks,
RDS, the last block's metadata within 1e-3, the device identity) and the
same commands on the wire; `rx --follow --control` retunes the device
outside the capture window and back; without a server both CLIs exit 2
with "loading device failed".
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as conftest sets)
from sdrjfm_tpu import app as japp
from sdrjfm_tpu.io import source as jsource
from sdrjfm_tpu.io import synth as jsynth
from sdrjfm_tpu.runtime import native_source as JN
from sdrjfm_tpu_torch import app
from sdrjfm_tpu_torch.io import source as tsource
from sdrjfm_tpu_torch.runtime import native_source as TN

from torch_parity import MockRtlTcpServer, named_station_iq

torch.set_num_threads(2)

INPUT_RATE = 2_304_000


@pytest.fixture(scope="module")
def u8_capture():
    """1.6 s of a station (PI 0x7E57, PS "RTLTCP  ") as u8 frames: the
    whole capture fits the 4 Mi-frame ring, so a run drops nothing however
    fast the server sends."""
    return jsynth.iq_to_u8(named_station_iq(1.6, 0x7E57, "RTLTCP  "))


def _commands_of(mod, frames, **kw):
    srv = MockRtlTcpServer(frames[:40_000], loop=True)
    try:
        with mod.RtlTcpSource("127.0.0.1", srv.port, rate=INPUT_RATE,
                              **kw) as src:
            ident = (src.tuner_type, src.tuner_gain_count, src.rate)
            src.set_frequency(94_300_000)
            src.set_gain_mode(True)
            src.set_gain(297)
            src.set_agc(False)
            src.set_freq_correction(-7)
            src.set_sample_rate(INPUT_RATE)
            got = src.read_block(30_000, timeout_ms=10_000)
            src.flush()
            dropped, eof, conn = src.dropped, src.eof, src.connected
            time.sleep(0.3)                   # the server reads the rest
    finally:
        srv.close()
    return ident, got, srv.commands, (dropped, eof, conn)


def test_rtltcp_puts_the_same_bytes_on_the_wire(u8_capture):
    j = _commands_of(JN, u8_capture)
    t = _commands_of(TN, u8_capture)
    assert t[0] == j[0] == (5, 29, INPUT_RATE)
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[1], u8_capture[:30_000])
    assert t[2] == j[2]
    assert t[2] == [(2, INPUT_RATE), (1, 94_300_000), (3, 1), (4, 297),
                    (8, 0), (5, 0xFFFFFFF9), (2, INPUT_RATE)]
    assert t[3] == j[3] == (0, False, True)


@pytest.mark.parametrize("mod", [JN, TN], ids=["jax", "port"])
def test_reconnect_replays_the_settings(mod, u8_capture):
    srv = MockRtlTcpServer(u8_capture[:200_000], sessions=2,
                           cut_frames=60_000, loop=True)
    try:
        with mod.RtlTcpSource("127.0.0.1", srv.port, rate=INPUT_RATE,
                              reconnect_timeout_ms=10_000) as src:
            src.set_frequency(94_300_000)
            src.set_gain(297)
            assert len(src.read_block(50_000, timeout_ms=10_000)) == 50_000
            b = src.read_block(100_000, timeout_ms=30_000)
            assert len(b) == 100_000
            assert src.reconnects == 1 and src.dropped > 0 and src.connected
            time.sleep(0.3)
    finally:
        srv.close()
    assert len(srv.sessions) == 2
    s2 = dict(srv.sessions[1])
    assert s2.get(0x02) == INPUT_RATE and s2.get(0x01) == 94_300_000
    assert s2.get(0x04) == 297


def test_no_reconnect_without_the_option(u8_capture):
    srv = MockRtlTcpServer(u8_capture[:200_000], sessions=2,
                           cut_frames=60_000)
    try:
        with TN.RtlTcpSource("127.0.0.1", srv.port) as src:
            assert len(src.read_block(60_000, timeout_ms=10_000)) == 60_000
            assert len(src.read_block(100_000, timeout_ms=5_000)) < 100_000
            assert src.eof and src.reconnects == 0
    finally:
        srv.close()


def test_open_source_adapter_matches_jax(u8_capture):
    out = []
    for mod in (jsource, tsource):
        srv = MockRtlTcpServer(u8_capture[:50_000], loop=True)
        try:
            dev = mod.open_source(f"rtltcp://127.0.0.1:{srv.port}")
            ident = (dev.get_rate(), dev.bit_depth(),
                     dev.legal_frequency(94_300_000))
            dev.set_vfo_frequency(101_700_000)
            x = dev.get_samples(30_000)
            vfo = dev.get_vfo_frequency()
            dev.stop_reader()
            time.sleep(0.3)
        finally:
            srv.close()
        out.append((ident, x, vfo, srv.commands))
    (ji, jx, jv, jc), (ti, tx, tv, tc) = out
    assert ti == ji == (INPUT_RATE, 8, True)
    assert tx.dtype == np.complex64 and len(tx) == 30_000
    np.testing.assert_array_equal(tx, jx)
    assert tv == jv == 101_700_000 and tc == jc
    assert (0x01, 101_700_000) in tc


def _cli(main, who, tmp_path, frames, extra, device=()):
    srv = MockRtlTcpServer(frames)
    rep = tmp_path / f"rep_{who}.json"
    try:
        rc = main(["rx", "--iq", f"rtl_tcp://127.0.0.1:{srv.port}",
                   "--tune-hz", "98000000", "--block-fm", "16384", "--rds",
                   "--report", str(rep), *extra, *device])
        time.sleep(0.3)
    finally:
        srv.close()
    assert rc == 0, who
    return json.loads(rep.read_text()), srv.commands


def test_cli_rtltcp_report_matches_jax(u8_capture, tmp_path, capsys):
    flags = ["--gain", "300", "--ppm", "5", "--meter", "--reconnect-timeout",
             "2"]
    rj, cj = _cli(japp.main, "jax", tmp_path, u8_capture, flags)
    jerr = capsys.readouterr().err
    rt, ct = _cli(app.main, "port", tmp_path, u8_capture, flags,
                  ("--device", "cpu"))
    terr = capsys.readouterr().err
    assert ct == cj
    assert ct[:5] == [(2, INPUT_RATE), (5, 5), (3, 1), (4, 300),
                      (1, 98_000_000)]
    assert rt["blocks"] == rj["blocks"] == len(u8_capture) // (16384 * 12)
    assert rt["ingest_dropped"] == rj["ingest_dropped"] == 0
    assert rt["device"] == rj["device"] == {"tuner_type": 5,
                                            "tuner_gain_count": 29,
                                            "reconnects": 0}
    for k in ("pi_code", "station_label", "bit_error_rate"):
        assert rt["rds"][k] == rj["rds"][k], k
    assert rt["rds"]["pi_code"] == "0x7E57" and \
        rt["rds"]["station_label"] == "RTLTCP  "
    assert rt["rds"]["bit_error_rate"] == 0.0
    for k, v in rj["meta_last"].items():
        if k in ("latency_ms", "ingest_dropped"):
            continue
        if isinstance(v, bool):
            assert rt["meta_last"][k] == v, k
        else:
            assert abs(rt["meta_last"][k] - v) <= 1e-3 * max(1, abs(v)), k
    assert "latency_ms" in rt
    # --meter: the same one-line status, numbers aside
    meter = [ln for ln in terr.split("\r") if ln.startswith("[")]
    jmeter = [ln for ln in jerr.split("\r") if ln.startswith("[")]
    assert meter and jmeter
    strip = lambda s: "".join(c for c in s.split("lat=")[0]  # noqa: E731
                              if not c.isdigit())
    assert strip(meter[-1]) == strip(jmeter[-1])
    assert "pilot=LOCK" in meter[-1] and "PI=0x7E57" in meter[-1]


def test_cli_follow_control_retunes_the_device(u8_capture, tmp_path):
    """`tune` outside the +-960 kHz window and back: two frequency commands
    on the wire, two hardware retunes in the report, the LO rebased."""
    ctl = str(tmp_path / "ctl.sock")
    rep = tmp_path / "rep.json"
    srv = MockRtlTcpServer(u8_capture, loop=True)
    box = {}

    def run():
        box["rc"] = app.main([
            "rx", "--iq", f"rtl_tcp://127.0.0.1:{srv.port}", "--tune-hz",
            "98000000", "--block-fm", "16384", "--loop-seconds", "3",
            "--control", ctl, "--report", str(rep), "--device", "cpu"])

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        deadline = time.time() + 60
        while not os.path.exists(ctl) and time.time() < deadline:
            time.sleep(0.05)
        cli = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        cli.connect(ctl)
        cli.settimeout(60)
        buf = b""
        got = []
        for line in ("tune 99500000", "tune 98000000", "status"):
            cli.sendall(line.encode() + b"\n")
            while b"\n" not in buf:
                buf += cli.recv(65536)
            out, buf = buf.split(b"\n", 1)
            got.append(json.loads(out))
        cli.close()
        th.join(120)
    finally:
        srv.close()
    assert box.get("rc") == 0
    assert got[0]["center_hz"] == 99_500_000 and got[0]["lo_hz"] == 0
    assert got[1]["center_hz"] == 98_000_000
    assert got[2]["hw_retunes"] == 2 and got[2]["device"]["tuner_type"] == 5
    freqs = [p for c, p in srv.commands if c == 0x01]
    assert freqs == [98_000_000, 99_500_000, 98_000_000]
    r = json.loads(rep.read_text())
    assert r["control"]["hw_retunes"] == 2
    assert r["control"]["tuned_hz"] == 98_000_000


@pytest.mark.parametrize("src", ["rtl_tcp://127.0.0.1:1",
                                 "rtltcp://127.0.0.1:9"])
def test_no_server_exits_2_as_jax_cli(src, capsys):
    assert japp.main(["rx", "--iq", src, "--block-fm", "16384"]) == 2
    jerr = capsys.readouterr().err.strip().splitlines()[-1]
    assert app.main(["rx", "--iq", src, "--block-fm", "16384", "--device",
                     "cpu"]) == 2
    terr = capsys.readouterr().err.strip().splitlines()[-1]
    assert terr == jerr and terr.startswith("loading device failed")
