"""Runtime control channel: interactive control of a running receiver
(port of sdrjfm_tpu.runtime.control).

The reference is an interactive radio: ~70 GUI slots retune, change
volume/balance/squelch, toggle AFC and scan while the engine thread keeps
processing (radio.cpp:1040-1075 setTuner, :1366+ localConnects;
fm-processor.cpp:849-855 retune resets).  This module is that control
surface for the block pipeline: a line-oriented command endpoint (stdin, a
FIFO, or a unix socket) serviced between blocks through the runners'
`command_hook`, so a live `rx --follow` can be driven while receiving.
Nothing is captured anew: every control lands in a `Controls` leaf or in a
state reset, which the captured step (`runtime.graph.StepGraph`) copies
into its buffers before its next replay.

Wire protocol (one command per line; responses are JSON lines):

    tune <hz>        retune.  With a hardware source <hz> is the absolute
                     station frequency: inside the current capture window
                     it becomes an LO offset; outside, the device is
                     retuned (setVFOFrequency) and the LO rebased, as
                     radio.cpp:1040-1075.  With a file capture <hz> is the
                     LO offset inside the window.  `tune <name>` tunes a
                     station of the --stations list.
    volume <db>      gain in dB (setVolume)
    balance <n>      -100..100 (setSoundBalance)
    mute on|off      mute/unmute (mute ramp on unmute)
    sound <sel>      output mix: stereo|swapped|left|right|sum|diff
                     (setSoundMode, fm-processor.cpp:273-275)
    pano <0..200>    stereo panorama slider: 0 mono, 100 stereo, 200
                     widened (setStereoPanorama, fm-processor.cpp:277-279)
    mono on|off      runtime mono (pano 0 / restore the previous)
    iqbalance <n>    -100..100 input attenuation pair (setIQBalance,
                     radio.cpp:982-996 -> setAttenuation)
    tone on|off      test-tone gate (handle_cbTestTone, radio.cpp:243; the
                     stage must be built in with --test-tone)
    step <+/-hz>     relative retune, e.g. 'step +100k' (the f+/f- buttons,
                     radio.cpp:220-226)
    log <path|off>   start/stop per-block metadata JSONL (radio.cpp:232-233;
                     the records of --log-meta)
    pause / resume   stop/restart the reader, keeping the session
                     (handle_pauseButton, radio.cpp:1871-1893; also
                     'pause on|off').  A file source holds its position; a
                     live source counts the paused-over samples as drops.
                     While paused only the channel is serviced.
    squelch <n>      squelch slider 0..100 (setSquelchValue)
    dump <kind> <path|off>
                     start/stop a wav dump while receiving (radio.cpp:
                     208-209).  kind: audio (always there under --follow)
                     or input|if|mpx (need --taps or a --dump-* flag)
    afc on|off       per-block AFC loop (radio.cpp:1786-1809)
    gain <tenth_db>  tuner gain (implies manual gain mode)
    agc on|off       tuner AGC
    ppm <n>          frequency correction
    save <name>      record the current tuning in the station list
    stations         list the station list
    status           the current tuning/controls/meta/RDS state
    quit             stop the run cleanly

Commands change three things, as the reference's control paths do: the
`Controls` leaves (LO/volume/balance/squelch/...; setTuner inside the
window, radio.cpp:1056-1066), state resets through Receiver.retune_reset
(triggerFrequencyChange, fm-processor.cpp:849-855), and the hardware
control plane of a live source (rtlsdr-handler.cpp:102-116).

On the card: the reader thread touches no tensor.  `apply` rebuilds the
Controls only when a command changed one of them (the JAX module's rule),
each new leaf uploaded from pinned memory without waiting for the card, so
an idle `apply` costs no device operation and no synchronisation; a leaf is
replaced with `_replace`, never written in place (the captured step tells
leaves apart by identity).
"""

from __future__ import annotations

import json
import os
import queue
import socket
import stat
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models.tuner import AFCTracker
from .graph import upload


class ControlChannel:
    """Line source and response sink over stdin ('-'), a FIFO, or a unix
    socket path (created; one client at a time, several in sequence).

    A reader thread feeds complete lines into a queue; `poll()` drains it
    without blocking between blocks (the engine-thread analogue of Qt's
    queued control signals, fm-processor.cpp:397-413).  Responses go back to
    the connected socket client, or to stderr for stdin and FIFO channels
    (stdout may carry PCM or the report).
    """

    def __init__(self, path: str):
        self.path = path
        self._q: "queue.Queue[str]" = queue.Queue()
        self._stop = threading.Event()
        self._conn = None           # current socket client (socket mode)
        self._conn_lock = threading.Lock()
        self._srv = None
        self._fifo = None
        if path == "-":
            self.mode = "stdin"
            self._thread = threading.Thread(target=self._read_stdin,
                                            daemon=True)
        elif os.path.exists(path) and stat.S_ISFIFO(os.stat(path).st_mode):
            self.mode = "fifo"
            # O_RDWR keeps a writer open, so reads never see EOF between
            # successive `echo cmd > fifo` writers; a raw fd and select, so
            # close() never contends a buffered reader's lock with the
            # blocked reader thread
            self._fifo = os.open(path, os.O_RDWR)
            self._thread = threading.Thread(target=self._read_fifo,
                                            daemon=True)
        else:
            self.mode = "socket"
            if os.path.exists(path):
                if not stat.S_ISSOCK(os.stat(path).st_mode):
                    raise ValueError(f"--control {path}: exists and is not "
                                     "a FIFO or socket")
                os.unlink(path)
            self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._srv.bind(path)
            self._srv.listen(1)
            self._srv.settimeout(0.25)
            self._thread = threading.Thread(target=self._serve_socket,
                                            daemon=True)
        self._thread.start()

    # -- readers --------------------------------------------------------
    def _read_stdin(self):
        for line in sys.stdin:
            if self._stop.is_set():
                return
            line = line.strip()
            if line:
                self._q.put(line)

    def _read_fifo(self):
        import select
        fd = self._fifo                       # close() nulls the attribute
        buf = b""
        while not self._stop.is_set():
            try:
                r, _, _ = select.select([fd], [], [], 0.25)
            except (OSError, ValueError):     # fd closed by close()
                return
            if not r:
                continue
            try:
                data = os.read(fd, 4096)
            except OSError:
                return
            if not data:
                return
            buf += data
            while b"\n" in buf:
                raw, buf = buf.split(b"\n", 1)
                line = raw.decode("utf-8", "replace").strip()
                if line:
                    self._q.put(line)

    def _serve_socket(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._conn_lock:
                self._conn = conn
            buf = b""
            conn.settimeout(0.25)
            while not self._stop.is_set():
                try:
                    data = conn.recv(4096)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break
                buf += data
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    line = line.decode("utf-8", "replace").strip()
                    if line:
                        self._q.put(line)
            with self._conn_lock:
                if self._conn is conn:
                    self._conn = None
            try:
                conn.close()
            except OSError:
                pass

    # -- API ------------------------------------------------------------
    def poll(self) -> list:
        """Drain the pending command lines (non-blocking)."""
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def respond(self, obj) -> None:
        """One JSON line back to the client (socket) or to stderr."""
        line = (json.dumps(obj) + "\n").encode()
        with self._conn_lock:
            conn = self._conn
        if conn is not None:
            try:
                conn.sendall(line)
                return
            except OSError:
                pass
        sys.stderr.write(line.decode())
        sys.stderr.flush()

    def close(self) -> None:
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
            if os.path.exists(self.path):
                try:
                    os.unlink(self.path)
                except OSError:
                    pass
        if self._fifo is not None:
            try:
                os.close(self._fifo)
            except OSError:
                pass
            self._fifo = None
        with self._conn_lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None


_ON = ("on", "1", "true")


class CommandProcessor:
    """Applies control-channel commands between blocks.

    Install `apply` as the runners' `command_hook`: it drains the channel,
    updates the Controls / the state / the hardware, runs the AFC tick, and
    returns (state, controls, stop).

    Tuning model (radio.cpp:1040-1075): `center_hz` is the hardware VFO
    (None for file captures), `lo_hz` the digital LO offset; the capture
    window is |lo| <= input_rate/2 - fm_rate.  `tune` inside the window
    moves only the LO; outside it, a retunable source gets a
    setVFOFrequency and the LO rebases to 0.  Any >= 100 kHz effective step
    fires Receiver.retune_reset (mute ramp, PSS and RDS resets,
    fm-processor.cpp:849-855) and resets the host RDS stack via
    `on_retune`.  After the hardware retune the source's ring is flushed.
    run_live reads block k+1 only after block k's hook has run, so the
    next block is read after the flush, at the new frequency.  The JAX
    runner reads block k+1 before the hook and demodulates one block of
    the old frequency first (ROADMAP.md, queue 3: standing decisions).

    The AFC loop (radio.cpp:1786-1809) accumulates into the LO, and when
    the corrected offset leaves the window on a retunable source the
    hardware is stepped and the LO rebased.
    """

    def __init__(self, rx, channel: Optional[ControlChannel] = None, *,
                 lo_hz: int = 0, center_hz: Optional[int] = None,
                 source=None, afc_active: bool = False,
                 on_retune: Optional[Callable[[], None]] = None,
                 meta_provider: Optional[Callable[[], dict]] = None,
                 stations=None, stations_path: Optional[str] = None,
                 dumps=None):
        self.rx = rx
        self.channel = channel
        # station-list tuning (the reference's programList, radio.cpp:
        # 1366+): `tune <name>`, `save <name>`, `stations`
        self.stations = stations
        self.stations_path = stations_path
        self.lo_hz = int(lo_hz)
        self.center_hz = int(center_hz) if center_hz is not None else None
        self.source = source
        self.on_retune = on_retune
        self.meta_provider = meta_provider
        self.afc = AFCTracker(rx.cfg.fm_rate)
        self.afc_active = bool(afc_active)
        self.volume_db = 0.0
        self.balance = 0
        self.muted = False
        self.squelch_level = None     # None = leave the CLI value alone
        self.pano = None              # None = leave the seeded value alone
        self.sound = None             # None = leave the seeded mix alone
        self._pano_before_mono = None
        self._seed_pano = 1.0         # adopted by seed_from()
        self.iqbalance = None         # None = leave the CLI gains alone
        self.tone = None              # None = leave the seeded gate alone
        self.paused = False
        self._log_f = None            # runtime meta JSONL (log command)
        # runtime dump buttons (app._FollowDumps: start/stop/active); None
        # = not available on this runner
        self.dumps = dumps
        self.commands_handled = 0
        self.retunes = 0
        self.hw_retunes = 0
        self._last_meta: dict = {}

    # window rule: radio.cpp:1048
    @property
    def max_offset(self) -> int:
        return self.rx.cfg.input_rate // 2 - self.rx.cfg.fm_rate

    # -- controls assembly ---------------------------------------------
    def _controls(self, controls):
        dev = self.rx.device
        f32 = lambda v: upload(v, torch.float32, dev)  # noqa: E731
        vol = 0.0 if self.muted else 10.0 ** (self.volume_db / 20.0)
        b = self.balance
        lg = (100 - b) / 100.0 if b > 0 else 1.0
        rg = (100 + b) / 100.0 if b < 0 else 1.0
        lo = int(round(self.lo_hz + self.afc.offset))
        controls = controls._replace(
            lo_freq_hz=upload(lo, torch.int32, dev),
            volume=f32(vol), left_gain=f32(lg), right_gain=f32(rg))
        if self.squelch_level is not None:
            controls = controls._replace(squelch_level=f32(self.squelch_level))
        if self.pano is not None:
            controls = controls._replace(pano=f32(self.pano))
        if self.iqbalance is not None:
            controls = controls._replace(
                input_lgain=f32((100 - self.iqbalance) / 100.0),
                input_rgain=f32((100 + self.iqbalance) / 100.0))
        if self.tone is not None:
            controls = controls._replace(
                tone_gate=f32(1.0 if self.tone else 0.0))
        if self.sound is not None:
            from ..models.receiver import SOUND_MATRICES
            controls = controls._replace(
                sound_mix=f32(SOUND_MATRICES[self.sound]))
        return controls

    def seed_from(self, controls) -> None:
        """Adopt the CLI's starting volume/balance/panorama, so that
        `status` and later relative edits start from what the run started
        with (reads the leaves once, at set-up)."""
        v = float(controls.volume)
        self.volume_db = -120.0 if v <= 0 else 20.0 * float(np.log10(v))
        lg = float(controls.left_gain)
        rg = float(controls.right_gain)
        if lg < 1.0:
            self.balance = int(round(100 - lg * 100))
        elif rg < 1.0:
            self.balance = -int(round(100 - rg * 100))
        self._seed_pano = float(controls.pano)

    # -- tuning ----------------------------------------------------------
    @staticmethod
    def _tuner_of(source):
        """The hardware tuning entry of either source contract:
        `set_frequency` (runtime.native_source) or `set_vfo_frequency`
        (the io.source deviceHandler protocol)."""
        if source is None:
            return None
        return (getattr(source, "set_frequency", None)
                or getattr(source, "set_vfo_frequency", None))

    def _retune_hw(self, new_center: int):
        self._tuner_of(self.source)(int(new_center))
        self.center_hz = int(new_center)
        self.hw_retunes += 1
        flush = getattr(self.source, "flush", None)
        if flush is not None:
            flush()                  # drop stale pre-retune ring content

    def _reset(self, state):
        state = self.rx.retune_reset(state)
        if self.on_retune is not None:
            self.on_retune()
        return state

    def tune(self, hz: int, state):
        """setTuner semantics; returns (state, response dict)."""
        hz = int(hz)
        if self.center_hz is None and abs(hz) > self.max_offset and \
                self._tuner_of(self.source) is not None:
            # a retunable source whose center was never declared (rx
            # without --tune-hz): an absolute-frequency tune adopts the
            # hardware center
            self._retune_hw(hz)
            self.lo_hz = 0
            self.afc.reset()
            self.retunes += 1
            return self._reset(state), {"tuned_hz": hz, "center_hz": hz,
                                        "lo_hz": 0, "retune_reset": True}
        if self.center_hz is not None:
            prev_eff = self.center_hz + self.lo_hz
            off = hz - self.center_hz
            if abs(off) > self.max_offset:
                if self._tuner_of(self.source) is None:
                    return state, {"error": f"offset {off} outside window "
                                            f"±{self.max_offset} and "
                                            "source is not retunable"}
                self._retune_hw(hz)
                self.lo_hz = 0
            else:
                self.lo_hz = off
            big = abs(hz - prev_eff) >= 100_000
            tuned = {"tuned_hz": hz, "center_hz": self.center_hz,
                     "lo_hz": self.lo_hz}
        else:
            if abs(hz) > self.max_offset:
                return state, {"error": f"offset {hz} outside capture "
                                        f"window ±{self.max_offset}"}
            big = abs(hz - self.lo_hz) >= 100_000
            self.lo_hz = hz
            tuned = {"lo_hz": self.lo_hz}
        self.afc.reset()
        self.retunes += 1
        if big:
            state = self._reset(state)
            tuned["retune_reset"] = True
        return state, tuned

    # -- the hook ---------------------------------------------------------
    def _drain_commands(self, state, stop=False):
        for line in (self.channel.poll() if self.channel else []):
            self.commands_handled += 1
            resp = self._dispatch(line, state)
            if isinstance(resp, tuple):       # (state, resp) from tune/mute
                state, resp = resp
            if resp is STOP:
                stop = True
                resp = {"ok": "stopping"}
            if self.channel is not None and resp is not None:
                self.channel.respond(resp)
        return state, stop

    def apply(self, state, controls, meta):
        """Runner hook: service the commands and the AFC; returns (state,
        controls, stop).

        The pause hold below polls the command queue at 20 Hz until resume
        or quit, so the channel must be fed from another thread than the
        one calling apply() (ControlChannel's reader thread)."""
        if meta:
            self._last_meta = meta
            if self._log_f is not None:
                self._log_f.write(json.dumps(meta, default=float) + "\n")
        # dirty iff a command changed a control: read-only commands
        # (status/stations/gain/agc/ppm) rebuild nothing
        sig0 = self._ctl_sig()
        state, stop = self._drain_commands(state)
        # paused: hold the pipeline between blocks, servicing only the
        # channel, until resume/quit (handle_pauseButton, radio.cpp:
        # 1871-1893; the reader is stopped too, via source.pause)
        while self.paused and not stop:
            time.sleep(0.05)
            state, stop = self._drain_commands(state, stop)
        dirty = self._ctl_sig() != sig0
        if self.afc_active and meta and "dc_if" in meta:
            before = self.afc.offset
            self.afc.update(meta["dc_if"])
            if self.afc.offset != before:
                dirty = True
            # AFC drives the hardware: when the corrected offset leaves the
            # window, step the front end and rebase (radio.cpp:1786-1809
            # -> :1040-1075)
            if self.center_hz is not None and \
                    self._tuner_of(self.source) is not None:
                eff = self.lo_hz + self.afc.offset
                if abs(eff) > self.max_offset:
                    try:
                        self._retune_hw(int(round(self.center_hz + eff)))
                        self.lo_hz = 0
                        self.afc.reset()
                    except OSError as e:      # hardware gone mid-loop: the
                        if self.channel:      # read path surfaces EOF/drops
                            self.channel.respond(
                                {"error": f"AFC hardware retune failed: {e}"})
        if dirty:
            controls = self._controls(controls)
        if stop and self._log_f is not None:
            self._log_f.close()
            self._log_f = None
        return state, controls, stop

    def _ctl_sig(self):
        return (self.lo_hz, self.volume_db, self.balance, self.muted,
                self.squelch_level, self.pano, self.sound, self.iqbalance,
                self.tone)

    def _set_paused(self, want: bool):
        """handle_pauseButton (radio.cpp:1871-1893): stop/restart the
        reader; apply() holds the pipeline while paused."""
        if want == self.paused:
            return {"ok": "pause", "paused": self.paused}
        self.paused = want
        p = getattr(self.source, "pause", None)
        if p is not None:
            try:
                p(want)
            except OSError as e:
                return {"ok": "pause", "paused": want,
                        "warning": f"source pause failed: {e}"}
        return {"ok": "pause", "paused": self.paused}

    # -- dispatch ---------------------------------------------------------
    def _dispatch(self, line: str, state):
        parts = line.split()
        cmd, args = parts[0].lower(), parts[1:]
        try:
            if cmd == "tune" and args:
                hz = None
                if len(args) == 1:
                    try:
                        hz = self._parse_hz(args[0])
                    except ValueError:
                        pass
                if hz is None:          # by station name (programList slot)
                    name = " ".join(args)
                    hit = next((s for s in (self.stations.stations
                                            if self.stations else [])
                                if s.name.strip().lower()
                                == name.strip().lower()), None)
                    if hit is None:
                        return {"error": f"unknown station {name!r}"}
                    hz = hit.frequency_hz
                return self.tune(hz, state)
            if cmd == "stations":
                from dataclasses import asdict
                return {"stations": [asdict(s) for s in
                                     (self.stations.stations
                                      if self.stations else [])]}
            if cmd == "save" and args:
                return self._save_station(" ".join(args))
            if cmd == "volume" and len(args) == 1:
                self.volume_db = float(args[0])
                return {"ok": "volume", "db": self.volume_db}
            if cmd == "balance" and len(args) == 1:
                self.balance = max(-100, min(100, int(args[0])))
                return {"ok": "balance", "balance": self.balance}
            if cmd == "mute" and len(args) == 1:
                want = args[0].lower() in _ON
                unmuting = self.muted and not want
                self.muted = want
                resp = {"ok": "mute", "muted": self.muted}
                if unmuting:
                    # click-free unmute: restart the audio ramp
                    # (fm-processor.cpp:130-131)
                    state = state._replace(ramp_remaining=upload(
                        self.rx.cfg.working_rate // 2, torch.int32,
                        self.rx.device))
                    resp["ramp"] = True
                return state, resp
            if cmd == "sound" and len(args) == 1:
                sel = {"swapped": "stereo_swapped",
                       "sum": "left_plus_right",
                       "diff": "left_minus_right"}.get(args[0].lower(),
                                                       args[0].lower())
                from ..models.receiver import SOUND_MATRICES
                if sel not in SOUND_MATRICES:
                    return {"error": f"unknown sound selector {args[0]!r} "
                                     "(stereo|swapped|left|right|sum|diff)"}
                self.sound = sel
                return {"ok": "sound", "sound": sel}
            if cmd == "pano" and len(args) == 1:
                # slider 0..200 -> factor /100 (radio.cpp:1490-1492 ->
                # fm-processor.cpp:277-279)
                n = max(0.0, min(200.0, float(args[0])))
                self.pano = n / 100.0
                self._pano_before_mono = None
                return {"ok": "pano", "pano": self.pano}
            if cmd == "mono" and len(args) == 1:
                want = args[0].lower() in _ON
                if want and self.pano != 0.0:
                    # a None stash means "what the run was seeded with";
                    # mono off restores exactly that
                    self._pano_before_mono = self.pano
                    self.pano = 0.0
                elif not want and self.pano == 0.0:
                    self.pano = (self._pano_before_mono
                                 if self._pano_before_mono is not None
                                 else self._seed_pano)
                    self._pano_before_mono = None
                return {"ok": "mono", "mono": self.pano == 0.0}
            if cmd == "dump" and len(args) >= 2:
                # the GUI dump buttons (radio.cpp:208-209;
                # fm-processor.cpp:338-349, 448-455, audiosink.cpp:268-274)
                kind = args[0].lower()
                if kind not in ("input", "if", "mpx", "audio"):
                    return {"error": f"unknown dump kind {kind!r} "
                                     "(input|if|mpx|audio)"}
                if self.dumps is None:
                    return {"error": "runtime dumps need a live run "
                                     "(rx --follow --control ...)"}
                path = " ".join(args[1:])    # paths may contain spaces
                if path.lower() == "off":
                    stopped = self.dumps.stop(kind)
                    return {"ok": "dump", "kind": kind, "stopped": stopped}
                err = self.dumps.start(kind, path)
                if err:
                    return {"error": err}
                return {"ok": "dump", "kind": kind, "path": path}
            if cmd == "step" and len(args) == 1:
                # relative tuning step (radio.cpp:220-226)
                tok = args[0]
                sign = -1 if tok.startswith("-") else 1
                delta = sign * self._parse_hz(tok.lstrip("+-"))
                cur = (self.center_hz + self.lo_hz
                       if self.center_hz is not None else self.lo_hz)
                return self.tune(cur + delta, state)
            if cmd == "log" and len(args) >= 1:
                # runtime per-block meta log (radio.cpp:232-233): JSONL,
                # the records of --log-meta
                path = " ".join(args)
                if path.lower() == "off":
                    if self._log_f is not None:
                        self._log_f.close()
                        self._log_f = None
                    return {"ok": "log", "active": False}
                try:
                    f = open(path, "w")
                except OSError as e:
                    return {"error": f"log {path!r}: {e}"}
                if self._log_f is not None:
                    self._log_f.close()
                self._log_f = f
                return {"ok": "log", "path": path}
            if cmd == "tone" and len(args) == 1:
                # test-tone checkbox (handle_cbTestTone, radio.cpp:243)
                if not self.rx.cfg.test_tone:
                    return {"error": "the test-tone stage is not compiled "
                                     "in; start with --test-tone"}
                self.tone = args[0].lower() in _ON
                return {"ok": "tone", "on": self.tone}
            if cmd == "iqbalance" and len(args) == 1:
                # setIQBalance (radio.cpp:982-996): attL=(100-n)/100,
                # attR=(100+n)/100 via setAttenuation
                self.iqbalance = int(max(-100, min(100, int(args[0]))))
                return {"ok": "iqbalance", "n": self.iqbalance}
            if cmd in ("pause", "resume"):
                want = (cmd == "pause") if not args else \
                    args[0].lower() in _ON
                return self._set_paused(want)
            if cmd == "squelch" and len(args) == 1:
                self.squelch_level = max(0.0, min(100.0, float(args[0])))
                return {"ok": "squelch", "level": self.squelch_level}
            if cmd == "afc" and len(args) == 1:
                self.afc_active = args[0].lower() in _ON
                if not self.afc_active:
                    self.afc.reset()
                return {"ok": "afc", "active": self.afc_active}
            if cmd in ("gain", "agc", "ppm"):
                return self._hw_command(cmd, args)
            if cmd == "status":
                return self.status()
            if cmd in ("quit", "stop", "exit"):
                return STOP
        except (ValueError, IndexError) as e:
            return {"error": f"{line!r}: {e}"}
        except OSError as e:
            # a dead hardware control plane must not end the run: the read
            # path surfaces the outage as EOF/drops/reconnects
            return {"error": f"{line!r}: hardware command failed: {e}"}
        return {"error": f"unknown command {line!r}"}

    @staticmethod
    def _parse_hz(tok: str) -> int:
        """'94300000', '94.3e6' or '94.3M' (and 'k')."""
        tok = tok.strip().lower()
        mult = 1
        if tok.endswith("m"):
            tok, mult = tok[:-1], 1_000_000
        elif tok.endswith("k"):
            tok, mult = tok[:-1], 1_000
        return int(round(float(tok) * mult))

    def _save_station(self, name: str) -> dict:
        """Record the current tuning in the station list and persist it
        (programList add, program-list.cpp:33-60)."""
        if self.stations is None:
            from ..io.stations import StationList
            self.stations = StationList()
        hz = (self.center_hz + self.lo_hz if self.center_hz is not None
              else self.lo_hz)
        self.stations.add(name, hz)
        if self.stations_path:
            self.stations.save(self.stations_path)
        return {"ok": "save", "name": name, "frequency_hz": hz,
                **({"path": self.stations_path} if self.stations_path
                   else {})}

    def _hw_command(self, cmd, args):
        src = self.source
        if src is None:
            return {"error": f"{cmd}: no hardware source"}
        if cmd == "gain":
            src.set_gain_mode(True)
            src.set_gain(int(args[0]))
            return {"ok": "gain", "tenth_db": int(args[0])}
        if cmd == "agc":
            on = args[0].lower() in _ON
            src.set_agc(on)
            src.set_gain_mode(not on)
            return {"ok": "agc", "active": on}
        src.set_freq_correction(int(args[0]))
        return {"ok": "ppm", "ppm": int(args[0])}

    def status(self) -> dict:
        s = {"lo_hz": self.lo_hz,
             "afc": {"active": self.afc_active,
                     "offset_hz": round(self.afc.offset, 2)},
             "volume_db": self.volume_db, "muted": self.muted,
             "balance": self.balance,
             "retunes": self.retunes, "hw_retunes": self.hw_retunes,
             "meta": self._last_meta}
        if self.center_hz is not None:
            s["center_hz"] = self.center_hz
            s["tuned_hz"] = self.center_hz + self.lo_hz
        if self.squelch_level is not None:
            s["squelch_level"] = self.squelch_level
        if self.pano is not None:
            s["pano"] = self.pano
        if self.sound is not None:
            s["sound"] = self.sound
        if self.iqbalance is not None:
            s["iqbalance"] = self.iqbalance
        if self.paused:
            s["paused"] = True
        if self.dumps is not None:
            act = self.dumps.active()
            if act:
                s["dumps"] = act
        src = self.source
        if src is not None:
            dev = {}
            for attr in ("dropped", "reconnects", "connected",
                         "tuner_type", "tuner_gain_count"):
                v = getattr(src, attr, None)
                if v is not None:
                    dev[attr] = v
            if dev:
                s["device"] = dev
        if self.meta_provider is not None:
            s.update(self.meta_provider())
        return s


class _Stop:
    pass


STOP = _Stop()
