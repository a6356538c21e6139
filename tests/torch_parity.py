"""Shared helpers of the port's option tests (tests/test_torch_*.py): run the
JAX receiver into a capture, hand its state across to the port with
convert.state_from_numpy, and step both packages over the same blocks."""

from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.io import synth as jsynth
from sdrjfm_tpu.models.receiver import Receiver as JReceiver
from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig
from sdrjfm_tpu.rds import encode as jencode
from sdrjfm_tpu_torch import convert
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig


@contextmanager
def one_thread():
    """Run torch's CPU ops on one thread.  MKL transforms a lone FFT on
    several threads but a batch of them one transform a thread, and the two
    round differently; on one thread a row of a batch equals the call on
    that row alone bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def station_iq(seconds: float, seed: int = 0, noise: float = 0.01,
               carrier_offset: float = 50_000.0) -> np.ndarray:
    """Complex64 2.304 MS/s capture of a stereo+RDS station (1 kHz left,
    440 Hz right, PI 0x10F0, "TPU FM")."""
    n = int(seconds * JC.FM_RATE)
    t = np.arange(n) / JC.FM_RATE
    syms = jencode.differential_encode(jencode.make_bitstream(
        pi=0x10F0, pty=10, station="TPU FM", radiotext="PARITY\r",
        repeats=2))
    mpx = jsynth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000 * t),
                           0.6 * np.sin(2 * np.pi * 440 * t),
                           jsynth.MPXParams(rds_level=0.07), rds_bits=syms)
    rng = np.random.default_rng(seed)
    iq = jsynth.fm_modulate(mpx, JC.FM_RATE,
                            carrier_offset_hz=carrier_offset, noise_std=0.0)
    iq = iq + noise * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))
    return iq.astype(np.complex64)


def stations_iq(stations, seconds: float, noise: float = 0.01,
                seed: int = 0) -> np.ndarray:
    """Complex64 2.304 MS/s capture of several stereo+RDS stations, each
    (offset_hz, pi, 8-char name, tone) with its PI and name in group 0A and
    its tone on the left, 1.5 x the tone on the right."""
    n = int(seconds * JC.FM_RATE)
    t = np.arange(n) / JC.FM_RATE
    total = None
    for off, pi, name, tone in stations:
        bits = []
        for _ in range(int(seconds * 3) + 2):
            for seg in range(4):
                bits.extend(jencode.group_0a(pi, 10, seg,
                                             name[2 * seg:2 * seg + 2]))
        syms = jencode.differential_encode(np.asarray(bits, np.int8))
        mpx = jsynth.synth_mpx(0.6 * np.sin(2 * np.pi * tone * t),
                               0.6 * np.sin(2 * np.pi * tone * 1.5 * t),
                               jsynth.MPXParams(rds_level=0.08),
                               rds_bits=syms)
        iq = jsynth.fm_modulate(mpx, JC.FM_RATE, carrier_offset_hz=off)
        total = iq if total is None else total + iq
    rng = np.random.default_rng(seed)
    total = total + noise * (rng.standard_normal(len(total))
                             + 1j * rng.standard_normal(len(total)))
    return total.astype(np.complex64)


def wire_blocks(iq: np.ndarray, cfg, fmt: str):
    """The capture in wire format, cut into cfg.wire_len blocks."""
    if fmt == "i16":
        w = jsynth.iq_to_i16(iq)
    elif fmt == "u8":
        w = jsynth.iq_to_u8(iq)
    elif fmt == "i8":
        w = jsynth.iq_to_i8(iq)
    else:
        w = iq
    T = cfg.wire_len
    return [np.ascontiguousarray(w[b * T:(b + 1) * T])
            for b in range(len(w) // T)]


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


class Pair:
    """The JAX receiver and the port's on the CPU, one config and the
    same controls."""

    def __init__(self, lo_hz: int = -50_000, controls=None, **kw):
        self.jrx = JReceiver(JConfig(**kw))
        self.trx = Receiver(ReceiverConfig(**kw), device="cpu")
        jc = self.jrx.initial_controls()._replace(
            lo_freq_hz=jnp.asarray(lo_hz, jnp.int32))
        tc = self.trx.initial_controls()._replace(
            lo_freq_hz=torch.tensor(lo_hz, dtype=torch.int32))
        for name, v in (controls or {}).items():
            jc = jc._replace(**{name: jnp.asarray(v, jnp.float32)})
            tc = tc._replace(**{name: torch.tensor(v, dtype=torch.float32)})
        self.jctl, self.tctl = jc, tc
        self.jstep = jax.jit(self.jrx.step)

    def warm(self, blocks):
        """JAX over `blocks`, then hand the state to the port."""
        js = self.jrx.init_state()
        for blk in blocks:
            js, _ = self.jstep(js, self.jctl, jnp.asarray(blk))
        ts = convert.state_from_numpy(tree_np(js), "cpu")
        return js, ts

    def step(self, js, ts, blk):
        js, oj = self.jstep(js, self.jctl, jnp.asarray(blk))
        ts, ot = self.trx.step(ts, self.tctl, torch.from_numpy(blk.copy()))
        return js, ts, oj, ot


def rds_bits(out) -> np.ndarray:
    n = int(out.rds.count)
    return np.asarray(out.rds.bits)[:n]


# ---------------------------------------------------------------------------
# Live sources: an rtl_tcp server, the fake vendor libraries, a name-dense
# RDS capture
# ---------------------------------------------------------------------------

class MockRtlTcpServer:
    """rtl_tcp server on 127.0.0.1 for one client per session: the 12-byte
    header ("RTL0", tuner type, gain count), the u8 frames, and a record of
    every 5-byte command.  sessions=2 drops the first connection hard after
    `cut_frames` frames and serves the rest to a second one (the reconnect
    fixture); loop=True streams the frames endlessly."""

    def __init__(self, frames: np.ndarray, tuner_type: int = 5,
                 gain_count: int = 29, loop: bool = False,
                 sessions: int = 1, cut_frames: int = 60_000):
        import socket
        import threading
        assert frames.dtype == np.uint8 and frames.ndim == 2
        self.payload = frames.tobytes()
        self.header = b"RTL0" + tuner_type.to_bytes(4, "big") \
            + gain_count.to_bytes(4, "big")
        self.loop, self.n_sessions, self.cut = loop, sessions, cut_frames * 2
        self.sessions = []            # [[(cmd, param), ...] per session]
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @property
    def commands(self):
        return [c for s in self.sessions for c in s]

    def _read_commands(self, conn, sink):
        buf = b""
        try:
            while not self._stop.is_set():
                data = conn.recv(256)
                if not data:
                    return
                buf += data
                while len(buf) >= 5:
                    sink.append((buf[0], int.from_bytes(buf[1:5], "big")))
                    buf = buf[5:]
        except OSError:
            pass

    def _serve(self):
        import socket
        import threading
        import time
        self._srv.settimeout(30.0)
        for session in range(self.n_sessions):
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            cmds = []
            self.sessions.append(cmds)
            threading.Thread(target=self._read_commands, args=(conn, cmds),
                             daemon=True).start()
            last = session == self.n_sessions - 1
            pos = 0 if session == 0 else self.cut
            end = len(self.payload) if last else self.cut
            try:
                conn.sendall(self.header)
                while not self._stop.is_set():
                    if pos >= end:
                        if not (last and self.loop):
                            break
                        pos = 0
                    part = self.payload[pos:min(end, pos + 65536)]
                    conn.sendall(part)
                    pos += len(part)
                if not last:
                    time.sleep(0.1)
                    # shutdown, not close: the reader thread's recv holds
                    # the socket open
                    conn.shutdown(socket.SHUT_RDWR)
                    conn.close()
                    continue
                conn.shutdown(socket.SHUT_WR)
                time.sleep(0.5)       # the client drains and sends commands
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass


def build_fake_lib(name: str, outdir) -> str:
    """tests/fake_lib<name>.c compiled with cc into `outdir`."""
    import subprocess
    from pathlib import Path
    so = Path(outdir) / f"libfake{name}.so"
    src = Path(__file__).parent / f"fake_lib{name}.c"
    # the sdrplay fake includes the port's copy of the service ABI header
    native = (Path(__file__).parent.parent / "sdrjfm_tpu_torch" / "runtime"
              / "native")
    subprocess.run(["cc", "-shared", "-fPIC", "-O2", f"-I{native}", "-o",
                    str(so), str(src), "-lpthread"], check=True)
    return str(so)


def named_station_iq(seconds: float, pi: int, name: str,
                     tones=(900.0, 400.0)) -> np.ndarray:
    """Complex64 2.304 MS/s station whose RDS is group 0A only (PI `pi`,
    8-char PS `name`), so its PS decodes within a second."""
    n = int(seconds * JC.FM_RATE)
    t = np.arange(n) / JC.FM_RATE
    raw = []
    for _ in range(int(seconds * 3) + 2):
        for seg in range(4):
            raw.extend(jencode.group_0a(pi, 3, seg, name[2 * seg:2 * seg + 2]))
    syms = jencode.differential_encode(np.asarray(raw, np.int8))
    mpx = jsynth.synth_mpx(0.5 * np.sin(2 * np.pi * tones[0] * t),
                           0.5 * np.sin(2 * np.pi * tones[1] * t),
                           jsynth.MPXParams(rds_level=0.08), rds_bits=syms)
    return jsynth.fm_modulate(mpx, JC.FM_RATE).astype(np.complex64)


class ScriptChannel:
    """A ControlChannel stand-in: `poll` hands out the lines queued for
    each call in turn, `respond` records the responses."""

    def __init__(self, script):
        self.script = [list(s) for s in script]
        self.responses = []

    def poll(self):
        return self.script.pop(0) if self.script else []

    def respond(self, obj):
        self.responses.append(obj)
