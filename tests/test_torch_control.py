"""The port's control channel (runtime/control.py) against the JAX
package's, on the CPU.

One command script goes through both packages' CommandProcessor: every
response, every Controls leaf after each call and the state after each
call (the retune resets and the unmute ramp) equal.  Then the transports
(socket, FIFO, stdin) of both channels, `_parse_hz`, pause/resume, tone,
dump, log, step, the hardware retune and AFC through a retunable source,
the station list (`tune <name>`, `save <name>`), and a retune across two
stations in a run: the port's audio within 2e-4 of JAX's and the PI flipping
from one station to the other.  An idle `apply` replaces nothing; a dirty
one replaces leaves and writes into none.
"""

import io
import json
import os
import socket
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sdrjfm_tpu import app as japp
from sdrjfm_tpu.io.stations import StationList as JStationList
from sdrjfm_tpu.models.receiver import Receiver as JReceiver
from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig
from sdrjfm_tpu.rds.live import LiveRDSDecoder as JLive
from sdrjfm_tpu.runtime import control as jctl
from sdrjfm_tpu.runtime.stream import run_offline as jrun_offline
from sdrjfm_tpu_torch import app
from sdrjfm_tpu_torch.io.stations import StationList
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu_torch.rds.live import LiveRDSDecoder
from sdrjfm_tpu_torch.runtime import control as tctl
from sdrjfm_tpu_torch.runtime.graph import tree_leaves
from sdrjfm_tpu_torch.runtime.stream import run_offline

from torch_parity import ScriptChannel, named_station_iq

torch.set_num_threads(2)

AUDIO_ATOL = 2e-4
BLOCK_FM = 16384


def _pair(**kw):
    kw = dict(dict(block_fm=4096, rds="block", test_tone=True), **kw)
    return JReceiver(JConfig(**kw)), Receiver(ReceiverConfig(**kw),
                                              device="cpu")


def _same_tree(jtree, ttree, what):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = tree_leaves(ttree)
    assert len(jl) == len(tl), what
    for i, (a, b) in enumerate(zip(jl, tl)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=f"{what} leaf {i}")


def _norm(responses, path):
    """The responses with a station-list path written as P."""
    return [json.loads(json.dumps(r).replace(str(path), "P"))
            for r in responses]


class _Tunable:
    """A retunable source: records set_frequency, flush and pause."""

    def __init__(self):
        self.calls = []

    def set_frequency(self, hz):
        self.calls.append(("freq", int(hz)))

    def flush(self):
        self.calls.append(("flush",))

    def pause(self, on):
        self.calls.append(("pause", bool(on)))

    def set_gain_mode(self, manual):
        self.calls.append(("gain_mode", bool(manual)))

    def set_gain(self, g):
        self.calls.append(("gain", int(g)))

    def set_agc(self, on):
        self.calls.append(("agc", bool(on)))

    def set_freq_correction(self, ppm):
        self.calls.append(("ppm", int(ppm)))


SCRIPT = [
    ["volume -6", "balance 30"], ["mute on"], ["mute off", "status"],
    ["sound swapped", "pano 150"], ["mono on"], ["mono off", "iqbalance 20"],
    ["squelch 40", "tone off"], ["tune 300000"], ["step -100k"],
    ["tune 250000"], ["afc on"], [], ["sound bogus", "balance x", "frob"],
    ["stations", "save HERE", "tune HERE"], ["gain 297", "agc on", "ppm -7"],
    ["tune 5M"], ["afc off", "status"], ["quit"]]


@pytest.mark.parametrize("hw", [False, True], ids=["file", "hardware"])
def test_command_script_matches_jax(hw, tmp_path):
    jrx, trx = _pair()
    srcs = (_Tunable(), _Tunable()) if hw else (None, None)
    center = 98_000_000 if hw else None
    jc = ScriptChannel(SCRIPT)
    tc = ScriptChannel(SCRIPT)
    jp = jctl.CommandProcessor(
        jrx, jc, lo_hz=-200_000, center_hz=center, source=srcs[0],
        stations=JStationList(), stations_path=str(tmp_path / "j.json"))
    tp = tctl.CommandProcessor(
        trx, tc, lo_hz=-200_000, center_hz=center, source=srcs[1],
        stations=StationList(), stations_path=str(tmp_path / "t.json"))
    jctlr = jrx.initial_controls()._replace(
        lo_freq_hz=jnp.asarray(-200_000, jnp.int32))
    tctlr = trx.initial_controls()._replace(
        lo_freq_hz=torch.tensor(-200_000, dtype=torch.int32))
    jp.seed_from(jctlr)
    tp.seed_from(tctlr)
    js, ts = jrx.init_state(), trx.init_state()
    for i in range(len(SCRIPT)):
        meta = {"pilot_locked": True, "dc_if": 0.01 * (i % 5 - 2)}
        js, jctlr, jstop = jp.apply(js, jctlr, meta)
        ts, tctlr, tstop = tp.apply(ts, tctlr, meta)
        assert tstop == jstop, i
        assert _norm(tc.responses, tmp_path / "t.json") == \
            _norm(jc.responses, tmp_path / "j.json"), i
        _same_tree(jctlr, tctlr, f"controls after call {i}")
        _same_tree(js, ts, f"state after call {i}")
    assert tstop and tp.commands_handled == jp.commands_handled
    assert (tp.retunes, tp.hw_retunes, tp.lo_hz, tp.center_hz) == \
        (jp.retunes, jp.hw_retunes, jp.lo_hz, jp.center_hz)
    if hw:
        assert srcs[1].calls == srcs[0].calls and tp.hw_retunes >= 1
    assert json.load(open(tmp_path / "t.json")) == \
        json.load(open(tmp_path / "j.json"))


def test_idle_apply_replaces_nothing_and_dirty_apply_writes_nothing():
    _, trx = _pair()
    chan = ScriptChannel([[], ["volume -3", "tune 150000"]])
    p = tctl.CommandProcessor(trx, chan)
    state, controls = trx.init_state(), trx.initial_controls()
    s1, c1, stop = p.apply(state, controls, {"dc_if": 0.0})
    assert s1 is state and c1 is controls and not stop
    before = [t.clone() for t in tree_leaves(controls)]
    sb = [t.clone() for t in tree_leaves(state)]
    s2, c2, _ = p.apply(state, controls, {"dc_if": 0.0})
    assert c2.volume is not controls.volume
    assert c2.lo_freq_hz is not controls.lo_freq_hz
    assert s2.ramp_remaining is not state.ramp_remaining
    for a, b in zip(tree_leaves(controls), before):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(state), sb):
        assert torch.equal(a, b)
    assert int(c2.lo_freq_hz) == 150_000


@pytest.mark.parametrize("mod", [jctl, tctl], ids=["jax", "port"])
def test_socket_channel_roundtrip(mod, tmp_path):
    path = str(tmp_path / "ctl.sock")
    chan = mod.ControlChannel(path)
    try:
        assert chan.mode == "socket"
        cli = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        cli.connect(path)
        cli.sendall(b"volume -6\nstatus\n")
        lines = _drain(chan, 2)
        assert lines == ["volume -6", "status"]
        chan.respond({"ok": True})
        cli.settimeout(5)
        assert json.loads(cli.recv(4096).decode()) == {"ok": True}
        cli.close()
    finally:
        chan.close()
    assert not os.path.exists(path)


def _drain(chan, n):
    deadline = time.time() + 5
    lines = []
    while len(lines) < n and time.time() < deadline:
        lines += chan.poll()
        time.sleep(0.02)
    return lines


@pytest.mark.parametrize("mod", [jctl, tctl], ids=["jax", "port"])
def test_fifo_channel(mod, tmp_path):
    path = str(tmp_path / "ctl.fifo")
    os.mkfifo(path)
    chan = mod.ControlChannel(path)
    try:
        assert chan.mode == "fifo"
        with open(path, "w") as f:
            f.write("tune 94.3M\nmute on\n")
        with open(path, "w") as f:               # a second writer
            f.write("status\n")
        assert _drain(chan, 3) == ["tune 94.3M", "mute on", "status"]
    finally:
        chan.close()


@pytest.mark.parametrize("mod", [jctl, tctl], ids=["jax", "port"])
def test_stdin_channel(mod, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("volume -3\n\nquit\n"))
    chan = mod.ControlChannel("-")
    try:
        assert chan.mode == "stdin"
        assert _drain(chan, 2) == ["volume -3", "quit"]
        chan.respond({"ok": "x"})              # no client: to stderr
        assert json.loads(capsys.readouterr().err) == {"ok": "x"}
    finally:
        chan.close()


def test_socket_channel_refuses_a_regular_file(tmp_path):
    path = tmp_path / "plain"
    path.write_text("x")
    with pytest.raises(ValueError, match="not a FIFO or socket"):
        tctl.ControlChannel(str(path))


@pytest.mark.parametrize("tok", ["94300000", "94.3M", "94.3e6", "200k",
                                 "-0.5M", "1e3K", "87.5m"])
def test_parse_hz_matches_jax(tok):
    assert tctl.CommandProcessor._parse_hz(tok) == \
        jctl.CommandProcessor._parse_hz(tok)


def test_parse_hz_rejects_what_jax_rejects():
    for tok in ("abc", "M", ""):
        with pytest.raises(ValueError):
            jctl.CommandProcessor._parse_hz(tok)
        with pytest.raises(ValueError):
            tctl.CommandProcessor._parse_hz(tok)


def test_pause_holds_until_resume_and_pauses_the_source():
    jrx, trx = _pair()
    out = []
    for mod, rx in ((jctl, jrx), (tctl, trx)):
        src = _Tunable()
        chan = ScriptChannel([["pause"], [], ["status"], ["resume"],
                              ["pause on"], ["pause off", "resume"]])
        p = mod.CommandProcessor(rx, chan, source=src)
        st, ctl = rx.init_state(), rx.initial_controls()
        _, _, stop = p.apply(st, ctl, {})
        assert not stop and not p.paused
        _, _, stop = p.apply(st, ctl, {})
        out.append((src.calls, chan.responses, stop))
    assert out[0][0] == [("pause", True), ("pause", False)] * 2
    assert out[1][0] == out[0][0]
    assert out[1][1] == out[0][1]
    assert [r for r in out[1][1] if "paused" in r][-1]["paused"] is False


def test_tone_needs_the_stage(tmp_path):
    jrx, trx = _pair(test_tone=False)
    for mod, rx in ((jctl, jrx), (tctl, trx)):
        resp = mod.CommandProcessor(rx)._dispatch("tone on",
                                                  rx.init_state())
        assert "not compiled in" in resp["error"]


@pytest.mark.parametrize("taps", [False, True], ids=["no_taps", "taps"])
def test_dump_buttons_match_jax(taps, tmp_path):
    """`dump` through both CLIs' follow-mode writers (_FollowDumps): the
    same responses; audio dumps always, the taps' only when emitted."""
    resp = {}
    for who, mod, appm, (rx_cls, cfg_cls) in (
            ("jax", jctl, japp, (JReceiver, JConfig)),
            ("port", tctl, app, (Receiver, ReceiverConfig))):
        cfg = cfg_cls(block_fm=4096, emit_taps=taps, emit_input_tap=taps)
        args = app._build_rx_parser(
            __import__("argparse").ArgumentParser().add_subparsers()
        ).parse_args(["--iq", "x"])
        d = tmp_path / who
        d.mkdir()
        dumps = (appm._FollowDumps(args, cfg) if who == "jax"
                 else appm._FollowDumps(args, cfg, "cpu"))
        chan = ScriptChannel([[f"dump audio {d}/a.wav", f"dump if {d}/i.wav",
                               "status", "dump audio off", "dump mpx off",
                               "dump xyz p", "dump audio"]])
        rx = rx_cls(cfg) if who == "jax" else rx_cls(cfg, device="cpu")
        p = mod.CommandProcessor(rx, chan, dumps=dumps)
        p.apply(rx.init_state(), rx.initial_controls(), {})
        resp[who] = [json.loads(json.dumps(r).replace(str(d), "D"))
                     for r in chan.responses]
        assert (d / "a.wav").exists() and (d / "i.wav").exists() == taps
        dumps.finish(type("R", (), {"rds_iq": None})())
    assert resp["port"] == resp["jax"]
    no_dumps = tctl.CommandProcessor(_pair()[1])._dispatch("dump audio x",
                                                           None)
    assert "need a live run" in no_dumps["error"]


def test_log_command_writes_what_jax_writes(tmp_path):
    jrx, trx = _pair()
    files = {}
    for who, mod, rx in (("jax", jctl, jrx), ("port", tctl, trx)):
        logp = str(tmp_path / f"{who}.jsonl")
        chan = ScriptChannel([[f"log {logp}"], [], [], ["log off"], []])
        p = mod.CommandProcessor(rx, chan)
        st, ctl = rx.init_state(), rx.initial_controls()
        for b in range(5):
            p.apply(st, ctl, {"block": b, "pilot_locked": b > 1,
                              "dc_if": 0.5 * b})
        files[who] = open(logp).read()
        assert chan.responses[-1] == {"ok": "log", "active": False}
    assert files["port"] == files["jax"] and files["port"].count("\n") == 3


def test_station_list_tune_and_save_match_jax(tmp_path):
    jrx, trx = _pair()
    responses = {}
    for who, mod, rx, sl_cls in (("jax", jctl, jrx, JStationList),
                                 ("port", tctl, trx, StationList)):
        sl = sl_cls()
        sl.add("Station One", 200_000)
        sl.add("Two", -300_000)
        path = str(tmp_path / f"{who}.json")
        chan = ScriptChannel([["tune station one", "tune Two",
                               "tune Nowhere", "save Mine", "stations"]])
        p = mod.CommandProcessor(rx, chan, stations=sl, stations_path=path)
        p.apply(rx.init_state(), rx.initial_controls(), {})
        responses[who] = [json.loads(json.dumps(r).replace(path, "P"))
                          for r in chan.responses]
        assert p.lo_hz == -300_000
    assert responses["port"] == responses["jax"]
    assert json.load(open(tmp_path / "port.json")) == \
        json.load(open(tmp_path / "jax.json"))


def test_afc_drives_the_hardware_like_jax():
    """An AFC correction that leaves the window steps the device and
    rebases the LO (radio.cpp:1786-1809 -> :1040-1075)."""
    jrx, trx = _pair()
    calls = []
    for mod, rx in ((jctl, jrx), (tctl, trx)):
        src = _Tunable()
        p = mod.CommandProcessor(rx, None, lo_hz=p_lo(rx), source=src,
                                 center_hz=98_000_000, afc_active=True)
        st, ctl = rx.init_state(), rx.initial_controls()
        los = []
        for _ in range(6):
            st, ctl, _ = p.apply(st, ctl, {"dc_if": 0.2})
            los.append((int(np.asarray(ctl.lo_freq_hz)), p.lo_hz,
                        p.center_hz, round(p.afc.offset, 6)))
        calls.append((src.calls, los, p.hw_retunes))
    assert calls[1] == calls[0] and calls[0][2] >= 1


def p_lo(rx):
    """An LO just inside the window's edge."""
    return rx.cfg.input_rate // 2 - rx.cfg.fm_rate - 2_000


# ---------------------------------------------------------------------------
# A retune across two stations in a run
# ---------------------------------------------------------------------------

PI_A, PI_B = 0x1111, 0x2222


@pytest.fixture(scope="module")
def two_stations():
    a = named_station_iq(1.6, PI_A, "AAAAAAAA", (800.0, 500.0))
    b = named_station_iq(1.6, PI_B, "BBBBBBBB", (900.0, 600.0))
    t = np.arange(len(a)) / 2_304_000
    return (0.5 * a * np.exp(-2j * np.pi * 200_000 * t)
            + 0.5 * b * np.exp(2j * np.pi * 200_000 * t)
            ).astype(np.complex64)


def test_retune_in_a_run_matches_jax(two_stations):
    """tune from the -200 kHz station to the +200 kHz one after block 8:
    retune_reset fires, the PI flips, and the port's audio stays within
    2e-4 of JAX's through the reset."""
    kw = dict(block_fm=BLOCK_FM, rds="block", audio_filter_hz=15000)
    script = {8: ["status", "tune 200000"]}
    runs = {}
    for who, mod, rx, live, run, lo in (
            ("jax", jctl, JReceiver(JConfig(**kw)), JLive(), jrun_offline,
             jnp.asarray(-200_000, jnp.int32)),
            ("port", tctl, Receiver(ReceiverConfig(**kw), device="cpu"),
             LiveRDSDecoder(), run_offline,
             torch.tensor(-200_000, dtype=torch.int32))):
        seen = {}

        def on_retune(live=live, seen=seen):
            seen["pi"] = live.result.pi_code
            live.reset()
        chan = ScriptChannel([script.get(b, []) for b in range(20)])
        p = mod.CommandProcessor(rx, chan, lo_hz=-200_000,
                                 on_retune=on_retune)
        ctl = rx.initial_controls()._replace(lo_freq_hz=lo)
        res = run(rx, two_stations, ctl, rds_feedback=live.feed,
                  command_hook=p.apply)
        runs[who] = (np.asarray(res.audio), seen["pi"], live.result.pi_code,
                     chan.responses, live.sync.bit_error_rate)
    ja, jpi0, jpi1, jresp, _ = runs["jax"]
    ta, tpi0, tpi1, tresp, tber = runs["port"]
    assert (tpi0, tpi1) == (jpi0, jpi1) == (PI_A, PI_B)
    assert tber == 0.0
    assert tresp[1] == jresp[1] == {"lo_hz": 200_000, "retune_reset": True}
    np.testing.assert_allclose(ta, ja, rtol=0, atol=AUDIO_ATOL)
    blk = BLOCK_FM // 4
    rms = lambda x: float(np.sqrt(np.mean(np.square(x))))   # noqa: E731
    assert rms(ta[9 * blk:10 * blk]) < 0.2 * rms(ta[7 * blk:8 * blk])
