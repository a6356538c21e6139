"""ctypes bindings of the native ingest runtime (port of
sdrjfm_tpu.runtime.native_source, for the file and pipe producers).

`runtime/native/` holds the port's copy of the C++ ingest sources: producer
threads feeding a lock-free SPSC ring, the deviceHandler-shaped interface of
the reference (devices/device-handler.h:60-85).  `load_library` compiles
them with `g++` at first use into `kernels/_build/` (gitignored), under a
name that hashes the sources and the flags, and loads that library: it
builds and loads nothing outside this package.  Without a compiler it
raises NativeUnavailable.

Sources: `NativeWavSource` (a wav as complex64 blocks), `NativeRawSource`
(a PCM16 wav or a headerless u8/i8/i16 capture as integer [n, 2] blocks),
`NativePipeSource` (stdin or a FIFO), and the live hardware: `RtlTcpSource`
(the rtl_tcp network protocol, u8), and the in-process dlopen devices
`RtlSdrUsbSource` (librtlsdr, u8), `AirspyUsbSource` (libairspy, i16 at its
negotiated native rate), `SdrplayUsbSource` (libsdrplay_api, i16) and
`HackRfUsbSource` (libhackrf, i8).  A vendor library is loaded at run time
from `libname`, else from $SDRJFM_LIBRTLSDR / $SDRJFM_LIBAIRSPY /
$SDRJFM_LIBSDRPLAY / $SDRJFM_LIBHACKRF, else by its usual name; its absence
raises IOError (the CLI's "loading device failed").  Every source has the
same consumer surface (rate, start, pause, stop, available, dropped, eof,
read_block, close), so the runners and the control channel take any of
them.  Each `read_block` is a span `source.read` (`runtime.spans`) and
sets `last_arrival_ns`: when the ring received the block's last frame, by
the producer's log of its puts (`native/ringbuffer.h`), on the clock of
`time.monotonic_ns()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from . import spans

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "kernels" / "_build"
SOURCES = ("ingest.cc", "ringbuffer.h", "sdrplay_abi.h")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]


class NativeUnavailable(RuntimeError):
    pass


_lib = None
_LOCK = threading.Lock()
_P, _SZ, _I, _U32, _I64 = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                           ctypes.c_uint32, ctypes.c_int64)
# (name, restype, argtypes) of every entry point bound here
_ENTRIES = (
    ("sdr_steady_now_ns", _I64, []),
    *((f"sdr_{d}_last_arrival_ns", _I64, [_P])
      for d in ("source", "raw", "rtltcp", "rtlsdr", "airspy", "hackrf",
                "sdrplay")),
    ("sdr_wav_source_open", _P, [ctypes.c_char_p, _SZ, _I, _I]),
    ("sdr_source_rate", _U32, [_P]),
    ("sdr_source_start", None, [_P]),
    ("sdr_source_stop", None, [_P]),
    ("sdr_source_pause", None, [_P, _I]),
    ("sdr_source_close", None, [_P]),
    ("sdr_source_read_blocking", _SZ,
     [_P, ctypes.POINTER(ctypes.c_float), _SZ, ctypes.c_long]),
    ("sdr_source_available", _SZ, [_P]),
    ("sdr_source_dropped", ctypes.c_uint64, [_P]),
    ("sdr_source_eof", _I, [_P]),
    ("sdr_raw_wav_open", _P, [ctypes.c_char_p, _SZ, _I, _I]),
    ("sdr_raw_file_open", _P, [ctypes.c_char_p, _SZ, _I, _I, _I, _U32]),
    ("sdr_raw_pipe_open", _P, [ctypes.c_char_p, _SZ, _I, _U32, _I]),
    ("sdr_raw_rate", _U32, [_P]),
    ("sdr_raw_frame_bytes", _I, [_P]),
    ("sdr_raw_start", None, [_P]),
    ("sdr_raw_stop", None, [_P]),
    ("sdr_raw_pause", None, [_P, _I]),
    ("sdr_raw_close", None, [_P]),
    ("sdr_raw_read_blocking", _SZ,
     [_P, ctypes.POINTER(ctypes.c_uint8), _SZ, ctypes.c_long]),
    ("sdr_raw_available", _SZ, [_P]),
    ("sdr_raw_dropped", ctypes.c_uint64, [_P]),
    ("sdr_raw_eof", _I, [_P]),
    # rtl_tcp network source
    ("sdr_rtltcp_open2", _P, [ctypes.c_char_p, _I, _SZ, ctypes.c_long]),
    ("sdr_rtltcp_reconnects", _U32, [_P]),
    ("sdr_rtltcp_connected", _I, [_P]),
    ("sdr_rtltcp_flush", None, [_P]),
    ("sdr_rtltcp_tuner_type", _U32, [_P]),
    ("sdr_rtltcp_gain_count", _U32, [_P]),
    ("sdr_rtltcp_command", _I, [_P, ctypes.c_uint8, _U32]),
    # in-process dlopen(librtlsdr) device
    ("sdr_rtlsdr_open", _P, [ctypes.c_char_p, _U32, _SZ, _U32]),
    ("sdr_rtlsdr_set_freq", _I, [_P, _U32]),
    ("sdr_rtlsdr_get_freq", _U32, [_P]),
    *((f"sdr_rtlsdr_{f}", _I, [_P, _I])
      for f in ("set_gain_mode", "set_gain", "set_agc", "set_ppm")),
    # in-process dlopen(libairspy) device
    ("sdr_airspy_open", _P, [ctypes.c_char_p, _SZ]),
    ("sdr_airspy_rate", _U32, [_P]),
    ("sdr_airspy_set_freq", _I, [_P, _U32]),
    *((f"sdr_airspy_{f}", _I, [_P, _I])
      for f in ("set_linearity", "set_sensitivity", "set_lna", "set_vga",
                "set_mixer", "set_lna_agc", "set_mixer_agc")),
    # in-process dlopen(libhackrf) device
    ("sdr_hackrf_open", _P, [ctypes.c_char_p, _SZ, _U32]),
    ("sdr_hackrf_set_freq", _I, [_P, ctypes.c_uint64]),
    *((f"sdr_hackrf_{f}", _I, [_P, _I])
      for f in ("set_lna", "set_vga", "set_amp", "set_antenna")),
    # in-process dlopen(libsdrplay_api) device
    ("sdr_sdrplay_open", _P, [ctypes.c_char_p, _SZ, _U32]),
    ("sdr_sdrplay_hw_ver", ctypes.c_char, [_P]),
    ("sdr_sdrplay_set_freq", _I, [_P, ctypes.c_uint64]),
    *((f"sdr_sdrplay_{f}", _I, [_P, _I])
      for f in ("set_grdb", "set_lna_state", "set_agc")),
    ("sdr_sdrplay_set_ppm", _I, [_P, ctypes.c_double]),
    # the consumer side every live device shares (one ring kind each)
    *((f"sdr_{d}_{name}", res, args)
      for d in ("rtltcp", "rtlsdr", "airspy", "hackrf", "sdrplay")
      for name, res, args in (
          ("start", _I if d in ("airspy", "hackrf", "sdrplay") else None,
           [_P]),
          ("pause", None, [_P, _I]),
          ("stop", None, [_P]),
          ("close", None, [_P]),
          ("read_blocking", _SZ,
           [_P, ctypes.POINTER(ctypes.c_uint8), _SZ, ctypes.c_long]),
          ("available", _SZ, [_P]),
          ("dropped", ctypes.c_uint64, [_P]),
          ("eof", _I, [_P]))),
    *((f"sdr_{d}_flush", None, [_P])
      for d in ("rtlsdr", "airspy", "hackrf", "sdrplay")),
    *((f"sdr_{d}_last_error", ctypes.c_char_p, [])
      for d in ("rtlsdr", "airspy", "hackrf", "sdrplay")),
)


def library_path() -> Path:
    """Where the ingest sources build to."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsdrjfm_ingest_{h.hexdigest()[:16]}.so"


def load_library(build: bool = True):
    """The loaded ingest library, compiled first if it is not built (span
    `setup.kernel_load`; a g++ run counts in `kernel.builds`)."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        with spans.span("setup.kernel_load"):
            _lib = _build_and_load(build)
        return _lib


def _build_and_load(build: bool):
    path = library_path()
    if not path.exists():
        if not build:
            raise NativeUnavailable(f"{path.name} is not built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
               str(NATIVE_DIR / "ingest.cc"), "-ldl"]
        spans.count("kernel.builds")
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise NativeUnavailable(f"cannot build native ingest: {e}")
        if proc.returncode != 0:
            raise NativeUnavailable(f"cannot build native ingest "
                                    f"(exit {proc.returncode}):\n"
                                    f"{proc.stderr[-2000:]}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, res, args in _ENTRIES:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _arrived(arrival_ns, h, got: int, want: int) -> int:
    """The ring's arrival time of a full block's last frame (ns,
    CLOCK_MONOTONIC), stamped `source.arrival` under `source.read`; -1
    for a short read or where the ring's log has moved past it."""
    t = int(arrival_ns(h)) if got == want else -1
    if t >= 0:
        spans.stamp("source.arrival", t)
    return t


class NativeWavSource:
    """Streaming IQ source: C++ producer thread -> lock-free ring -> blocks.

    pace=True emulates a live 2.304 MS/s front end (real-time emission,
    drops on overrun — the live-SDR failure mode); pace=False streams at
    full speed for offline runs.  loop=True restarts at EOF.
    """

    last_arrival_ns = -1

    def __init__(self, path: str, ring_frames: int = 1 << 22,
                 pace: bool = False, loop: bool = False):
        self._lib = load_library()
        self._h = self._lib.sdr_wav_source_open(
            str(path).encode(), ring_frames, int(pace), int(loop))
        if not self._h:
            raise IOError(f"cannot open wav source {path}")

    @property
    def rate(self) -> int:
        return int(self._lib.sdr_source_rate(self._h))

    def start(self):
        self._lib.sdr_source_start(self._h)

    def pause(self, on: bool) -> None:
        """stopReader/restartReader while running (handle_pauseButton,
        radio.cpp:1871-1893): a file source holds its position."""
        self._lib.sdr_source_pause(self._h, 1 if on else 0)

    def stop(self):
        self._lib.sdr_source_stop(self._h)

    def available(self) -> int:
        return int(self._lib.sdr_source_available(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.sdr_source_dropped(self._h))

    @property
    def eof(self) -> bool:
        return bool(self._lib.sdr_source_eof(self._h))

    def read_block(self, n_frames: int, timeout_ms: int = 10_000):
        """Blocking read of one block; returns complex64 [got].  Sets
        `last_arrival_ns` (see `_arrived`)."""
        buf = np.empty(2 * n_frames, dtype=np.float32)
        with spans.span("source.read") as sp:
            got = sp.count = self._lib.sdr_source_read_blocking(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                n_frames, timeout_ms)
            self.last_arrival_ns = _arrived(
                self._lib.sdr_source_last_arrival_ns, self._h, got, n_frames)
        iq = buf[: 2 * got].reshape(-1, 2)
        return (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)

    def close(self):
        if self._h:
            self._lib.sdr_source_close(self._h)
            self._h = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


class _RawRing:
    """The consumer side shared by the raw file and pipe sources (one C
    object kind): integer [n, 2] frames in the wire format."""

    fmt: str
    last_arrival_ns = -1

    def _open(self, handle, fmt: str, what: str, path) -> None:
        if not handle:
            raise IOError(f"cannot open {what} source {path}")
        self._h = handle
        self.fmt = fmt
        self._dtype = {"u8": np.uint8, "i8": np.int8, "i16": np.int16}[fmt]

    def _require_open(self):
        if not self._h:
            raise RuntimeError("source is closed")

    @property
    def rate(self) -> int:
        self._require_open()
        return int(self._lib.sdr_raw_rate(self._h))

    def start(self):
        self._require_open()
        self._lib.sdr_raw_start(self._h)

    def pause(self, on: bool) -> None:
        """Backpressure pipes stop pulling (the writer blocks); drop-on-full
        pipes and paced files keep going and lose the frames."""
        self._require_open()
        self._lib.sdr_raw_pause(self._h, 1 if on else 0)

    def stop(self):
        self._require_open()
        self._lib.sdr_raw_stop(self._h)

    def available(self) -> int:
        self._require_open()
        return int(self._lib.sdr_raw_available(self._h))

    @property
    def dropped(self) -> int:
        self._require_open()
        return int(self._lib.sdr_raw_dropped(self._h))

    @property
    def eof(self) -> bool:
        self._require_open()
        return bool(self._lib.sdr_raw_eof(self._h))

    def read_block(self, n_frames: int, timeout_ms: int = 10_000):
        """Blocking read; returns [got, 2] u8/i8/i16 (the iq_format
        layout).  Sets `last_arrival_ns` (see `_arrived`)."""
        self._require_open()
        fb = int(self._lib.sdr_raw_frame_bytes(self._h))
        buf = np.empty(n_frames * fb, dtype=np.uint8)
        with spans.span("source.read") as sp:
            got = sp.count = self._lib.sdr_raw_read_blocking(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                n_frames, timeout_ms)
            self.last_arrival_ns = _arrived(
                self._lib.sdr_raw_last_arrival_ns, self._h, got, n_frames)
        return buf[: got * fb].view(self._dtype).reshape(-1, 2)

    def close(self):
        if self._h:
            self._lib.sdr_raw_close(self._h)
            self._h = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


class NativeRawSource(_RawRing):
    """Raw-passthrough streaming source: the ring carries native-width
    integer IQ frames (i16 from PCM16 wavs, u8/i8/i16 from headerless
    rtl_sdr / hackrf captures), which feed ReceiverConfig.iq_format
    'i16'/'u8'/'i8' directly, so the int -> float conversion happens on
    the device.

    A path whose file starts with RIFF must be a PCM16 stereo wav.
    Otherwise it is a raw file: pass fmt and the rate (no header).
    """

    def __init__(self, path: str, fmt: str = None, rate: int = 2_304_000,
                 ring_frames: int = 1 << 22, pace: bool = False,
                 loop: bool = False):
        self._lib = load_library()
        self._h = None
        with open(path, "rb") as f:
            riff = f.read(4) == b"RIFF"
        if riff:
            h = self._lib.sdr_raw_wav_open(str(path).encode(), ring_frames,
                                           int(pace), int(loop))
            fmt = "i16"
        else:
            if fmt not in ("u8", "i8", "i16"):
                raise ValueError("raw capture needs fmt='u8', 'i8' or 'i16'")
            h = self._lib.sdr_raw_file_open(
                str(path).encode(), ring_frames, int(pace), int(loop),
                2 if fmt == "i16" else 1, rate)
        self._open(h, fmt, "raw", path)


class NativePipeSource(_RawRing):
    """Unseekable headerless IQ stream: stdin (path '-'), a FIFO or any
    pipe, so that any external SDR tool feeds the receiver live (`rtl_sdr
    -f 95M - | rx --iq - --iq-format u8`).  The frames land in the raw
    integer ring untouched.  No pacing (the writer paces);
    drop_on_full=False applies backpressure through the OS pipe, True drops
    frames like a live source and counts them.
    """

    def __init__(self, path: str, fmt: str, rate: int = 2_304_000,
                 ring_frames: int = 1 << 22, drop_on_full: bool = False):
        self._lib = load_library()
        self._h = None
        if fmt not in ("u8", "i8", "i16"):
            raise ValueError("pipe stream needs fmt='u8', 'i8' or 'i16'")
        h = self._lib.sdr_raw_pipe_open(
            str(path).encode(), ring_frames, 2 if fmt == "i16" else 1,
            rate, int(drop_on_full))
        self._open(h, fmt, "pipe", path)


class _DeviceRing:
    """The consumer side of a live device's ring (the `sdr_<kind>_*`
    entries): integer [n, 2] frames in the device's wire format `fmt`."""

    fmt: str
    _kind: str
    last_arrival_ns = -1
    _dtype = {"u8": np.uint8, "i8": np.int8, "i16": np.int16}

    def _fn(self, name: str):
        return getattr(self._lib, f"sdr_{self._kind}_{name}")

    def _last_error(self) -> str:
        return self._fn("last_error")().decode()

    def _ck(self, rc: int, what: str) -> None:
        if rc != 0:
            raise IOError(f"{self._kind} {what} failed ({rc})")

    @property
    def rate(self) -> int:
        return self._rate

    def start(self):
        if self._fn("start")(self._h):          # the vendor start's status
            raise IOError(self._last_error())

    def pause(self, on: bool) -> None:
        """stopReader semantics for a live stream: the device keeps
        streaming, the paused-over samples count as drops."""
        self._fn("pause")(self._h, 1 if on else 0)

    def stop(self):
        self._fn("stop")(self._h)

    def flush(self) -> None:
        """resetBuffer (device-handler.h:75): discard the buffered frames,
        e.g. right after a retune so the next block is post-retune
        signal."""
        self._fn("flush")(self._h)

    def available(self) -> int:
        return int(self._fn("available")(self._h))

    @property
    def dropped(self) -> int:
        return int(self._fn("dropped")(self._h))

    @property
    def eof(self) -> bool:
        return bool(self._fn("eof")(self._h))

    def read_block(self, n_frames: int, timeout_ms: int = 10_000):
        """Blocking read; returns [got, 2] frames in the wire format.  Sets
        `last_arrival_ns` (see `_arrived`)."""
        buf = np.empty(n_frames * 2, dtype=self._dtype[self.fmt])
        with spans.span("source.read") as sp:
            got = sp.count = self._fn("read_blocking")(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                n_frames, timeout_ms)
            self.last_arrival_ns = _arrived(self._fn("last_arrival_ns"),
                                            self._h, got, n_frames)
        return buf[: got * 2].reshape(-1, 2)

    def close(self):
        if self._h:
            self._fn("close")(self._h)
            self._h = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


def _libname(libname, env: str):
    if libname is None:
        libname = os.environ.get(env)
    return libname.encode() if libname else None


class RtlTcpSource(_DeviceRing):
    """Network SDR source: a client of the standard rtl_tcp protocol (the
    live-device twin of the reference's rtlsdr-handler: the same dongle,
    u8 stream and control surface over TCP).  The u8 frames land in the
    native ring untouched; ReceiverConfig.iq_format='u8' converts them on
    the device (rtlsdr-handler.cpp:285-294).

    Commands are rtl_tcp's 5-byte frames: set_frequency (0x01),
    set_sample_rate (0x02, sent at connect), gain mode (0x03), tuner gain
    (0x04), ppm correction (0x05), AGC (0x08).  reconnect_timeout_ms > 0:
    if the server drops mid-run the reader retries with backoff for up to
    that long, replays the settings, counts the outage as drops and
    resumes (`reconnects`)."""

    CMD_SET_FREQ = 0x01
    CMD_SET_SAMPLE_RATE = 0x02
    CMD_SET_GAIN_MODE = 0x03
    CMD_SET_GAIN = 0x04
    CMD_SET_FREQ_CORRECTION = 0x05
    CMD_SET_AGC_MODE = 0x08

    fmt = "u8"
    _kind = "rtltcp"

    def __init__(self, host: str, port: int = 1234,
                 rate: int = 2_304_000, ring_frames: int = 1 << 22,
                 reconnect_timeout_ms: int = 0):
        self._lib = load_library()
        self._h = self._lib.sdr_rtltcp_open2(host.encode(), int(port),
                                             ring_frames,
                                             int(reconnect_timeout_ms))
        if not self._h:
            raise IOError(f"cannot connect to rtl_tcp at {host}:{port}")
        self._rate = int(rate)
        self.tuner_type = int(self._lib.sdr_rtltcp_tuner_type(self._h))
        self.tuner_gain_count = int(self._lib.sdr_rtltcp_gain_count(self._h))
        self.set_sample_rate(rate)

    def start(self):
        self._lib.sdr_rtltcp_start(self._h)

    def command(self, cmd: int, param: int) -> None:
        if self._lib.sdr_rtltcp_command(self._h, cmd,
                                        int(param) & 0xFFFFFFFF) != 0:
            raise IOError("rtl_tcp command send failed")

    def set_frequency(self, hz: int) -> None:
        self.command(self.CMD_SET_FREQ, hz)

    def set_sample_rate(self, rate: int) -> None:
        self._rate = int(rate)
        self.command(self.CMD_SET_SAMPLE_RATE, rate)

    def set_gain_mode(self, manual: bool) -> None:
        self.command(self.CMD_SET_GAIN_MODE, 1 if manual else 0)

    def set_gain(self, tenths_db: int) -> None:
        self.command(self.CMD_SET_GAIN, tenths_db)

    def set_agc(self, on: bool) -> None:
        self.command(self.CMD_SET_AGC_MODE, 1 if on else 0)

    def set_freq_correction(self, ppm: int) -> None:
        self.command(self.CMD_SET_FREQ_CORRECTION, ppm)

    @property
    def reconnects(self) -> int:
        return int(self._lib.sdr_rtltcp_reconnects(self._h))

    @property
    def connected(self) -> bool:
        return bool(self._lib.sdr_rtltcp_connected(self._h))


class RtlSdrUsbSource(_DeviceRing):
    """In-process RTL-SDR dongle through dlopen(librtlsdr), the reference's
    rtlsdr-handler (rtlsdr-handler.cpp): the vendor library loads at run
    time (:102-116; absent, it raises), librtlsdr's async callback thread
    feeds the u8 ring, and the u8 -> float conversion (:285-294) runs on
    the device.  The control surface is RtlTcpSource's, so the control
    channel's gain/agc/ppm/retune commands apply unchanged."""

    fmt = "u8"
    _kind = "rtlsdr"

    def __init__(self, device_index: int = 0, rate: int = 2_304_000,
                 ring_frames: int = 1 << 22, libname: str = None):
        self._lib = load_library()
        self._h = self._lib.sdr_rtlsdr_open(
            _libname(libname, "SDRJFM_LIBRTLSDR"), int(device_index),
            ring_frames, int(rate))
        if not self._h:
            raise IOError(f"rtlsdr device {device_index}: "
                          f"{self._last_error()}")
        self._rate = int(rate)

    def start(self):
        self._lib.sdr_rtlsdr_start(self._h)

    def set_frequency(self, hz: int) -> None:
        self._ck(self._lib.sdr_rtlsdr_set_freq(self._h, int(hz)),
                 "set_center_freq")

    def get_frequency(self) -> int:
        return int(self._lib.sdr_rtlsdr_get_freq(self._h))

    def set_gain_mode(self, manual: bool) -> None:
        self._ck(self._lib.sdr_rtlsdr_set_gain_mode(
            self._h, 1 if manual else 0), "set_tuner_gain_mode")

    def set_gain(self, tenths_db: int) -> None:
        self._ck(self._lib.sdr_rtlsdr_set_gain(self._h, int(tenths_db)),
                 "set_tuner_gain")

    def set_agc(self, on: bool) -> None:
        self._ck(self._lib.sdr_rtlsdr_set_agc(self._h, 1 if on else 0),
                 "set_agc_mode")

    def set_freq_correction(self, ppm: int) -> None:
        self._ck(self._lib.sdr_rtlsdr_set_ppm(self._h, int(ppm)),
                 "set_freq_correction")


class AirspyUsbSource(_DeviceRing):
    """In-process Airspy through dlopen(libairspy), the reference's
    airspy-handler (airspy-handler.cpp): INT16_IQ samples (:102), the
    supported rate closest to 2 MS/s negotiated (:103-116), streaming at
    that NATIVE rate, converted to 2.304 MS/s on the device by the
    receiver's rate adapter (ReceiverConfig(native_rate=src.rate,
    iq_format='i16'), the handler's mapTable, :118-127), and the
    linearity/sensitivity/raw gain surface (:330-408).

    Airspy's 12-bit samples (+-2048 on the i16 wire) divided by 32768 leave
    a constant 24 dB level offset that the discriminator's unit-circle
    normalisation cancels (fm-demodulator.cpp:119-126)."""

    fmt = "i16"
    _kind = "airspy"

    def __init__(self, ring_frames: int = 1 << 22, libname: str = None):
        self._lib = load_library()
        self._h = self._lib.sdr_airspy_open(
            _libname(libname, "SDRJFM_LIBAIRSPY"), ring_frames)
        if not self._h:
            raise IOError(f"airspy device: {self._last_error()}")
        self._rate = int(self._lib.sdr_airspy_rate(self._h))

    @property
    def rate(self) -> int:
        """The NEGOTIATED native rate (e.g. 2_500_000), not 2.304 MS/s."""
        return self._rate

    def set_frequency(self, hz: int) -> None:
        self._ck(self._lib.sdr_airspy_set_freq(self._h, int(hz)),
                 "set_freq")

    def set_linearity(self, gain: int) -> None:
        self._ck(self._lib.sdr_airspy_set_linearity(self._h, int(gain)),
                 "set_linearity_gain")

    def set_sensitivity(self, gain: int) -> None:
        self._ck(self._lib.sdr_airspy_set_sensitivity(self._h, int(gain)),
                 "set_sensitivity_gain")

    def set_lna_gain(self, gain: int) -> None:
        self._ck(self._lib.sdr_airspy_set_lna(self._h, int(gain)),
                 "set_lna_gain")

    def set_vga_gain(self, gain: int) -> None:
        self._ck(self._lib.sdr_airspy_set_vga(self._h, int(gain)),
                 "set_vga_gain")

    def set_mixer_gain(self, gain: int) -> None:
        self._ck(self._lib.sdr_airspy_set_mixer(self._h, int(gain)),
                 "set_mixer_gain")

    def set_lna_agc(self, on: bool) -> None:
        self._ck(self._lib.sdr_airspy_set_lna_agc(self._h, 1 if on else 0),
                 "set_lna_agc")

    def set_mixer_agc(self, on: bool) -> None:
        self._ck(self._lib.sdr_airspy_set_mixer_agc(
            self._h, 1 if on else 0), "set_mixer_agc")


class SdrplayUsbSource(_DeviceRing):
    """In-process SDRplay RSP through dlopen(libsdrplay_api), the
    reference's service-API pattern (sdrplay-handler-v3/): the device
    parameter tree edited in place and committed with Update reason masks,
    Init/Uninit around streaming, planar shorts interleaved into the i16
    ring.  The device samples at the chain rate (2.304 MHz, above the RSP's
    2 MHz ADC floor, Rsp-device.cpp:71).  RSP ADCs are 12/14-bit: the
    constant level offset against /32768 cancels in the discriminator."""

    fmt = "i16"
    _kind = "sdrplay"

    def __init__(self, rate: int = 2_304_000, ring_frames: int = 1 << 22,
                 libname: str = None):
        self._lib = load_library()
        self._h = self._lib.sdr_sdrplay_open(
            _libname(libname, "SDRJFM_LIBSDRPLAY"), ring_frames, int(rate))
        if not self._h:
            raise IOError(f"sdrplay device: {self._last_error()}")
        self._rate = int(rate)

    @property
    def hw_ver(self) -> int:
        """RSP model id (SDRPLAY_RSP1A_ID=255, ... sdrplay_api.h:33-37)."""
        return ord(self._lib.sdr_sdrplay_hw_ver(self._h))

    def set_frequency(self, hz: int) -> None:
        self._ck(self._lib.sdr_sdrplay_set_freq(self._h, int(hz)),
                 "set_freq")

    def set_grdb(self, grdb: int) -> None:
        """IF gain reduction dB 20..59 (Rsp-device.cpp:174-182)."""
        self._ck(self._lib.sdr_sdrplay_set_grdb(self._h, int(grdb)),
                 "set_grdb")

    def set_lna_state(self, state: int) -> None:
        self._ck(self._lib.sdr_sdrplay_set_lna_state(self._h, int(state)),
                 "set_lna_state")

    def set_agc(self, on: bool) -> None:
        self._ck(self._lib.sdr_sdrplay_set_agc(self._h, 1 if on else 0),
                 "set_agc")

    def set_freq_correction(self, ppm: float) -> None:
        self._ck(self._lib.sdr_sdrplay_set_ppm(self._h, float(ppm)),
                 "set_ppm")


class HackRfUsbSource(_DeviceRing):
    """In-process HackRF through dlopen(libhackrf) (hackrf-handler.cpp):
    the device samples at exactly 2.304 MS/s (set_sample_rate takes any
    double, :112; no rate adapter), the callback delivers SIGNED 8-bit IQ
    (:357-368, iq_format='i8' converts on the device), the baseband filter
    from compute_baseband_filter_bw (:124-126), lna/vga gains and the
    amp/antenna enables (:256-315)."""

    fmt = "i8"
    _kind = "hackrf"

    def __init__(self, rate: int = 2_304_000, ring_frames: int = 1 << 22,
                 libname: str = None):
        self._lib = load_library()
        self._h = self._lib.sdr_hackrf_open(
            _libname(libname, "SDRJFM_LIBHACKRF"), ring_frames, int(rate))
        if not self._h:
            raise IOError(f"hackrf device: {self._last_error()}")
        self._rate = int(rate)

    def set_frequency(self, hz: int) -> None:
        self._ck(self._lib.sdr_hackrf_set_freq(self._h, int(hz)),
                 "set_freq")

    def set_lna_gain(self, db: int) -> None:
        self._ck(self._lib.sdr_hackrf_set_lna(self._h, int(db)),
                 "set_lna_gain")

    def set_vga_gain(self, db: int) -> None:
        self._ck(self._lib.sdr_hackrf_set_vga(self._h, int(db)),
                 "set_vga_gain")

    def set_amp(self, on: bool) -> None:
        self._ck(self._lib.sdr_hackrf_set_amp(self._h, 1 if on else 0),
                 "set_amp_enable")

    def set_antenna(self, on: bool) -> None:
        self._ck(self._lib.sdr_hackrf_set_antenna(self._h, 1 if on else 0),
                 "set_antenna_enable")
