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
(a PCM16 wav or a headerless u8/i8/i16 capture as integer [n, 2] blocks)
and `NativePipeSource` (stdin or a FIFO).  The rtl_tcp and USB producers of
the JAX module are compiled into the library but not bound yet (ROADMAP.md,
queue 1).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "kernels" / "_build"
SOURCES = ("ingest.cc", "ringbuffer.h", "sdrplay_abi.h")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]


class NativeUnavailable(RuntimeError):
    pass


_lib = None
_LOCK = threading.Lock()
_P, _SZ, _I, _U32 = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                     ctypes.c_uint32)
# (name, restype, argtypes) of every entry point bound here
_ENTRIES = (
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
)


def library_path() -> Path:
    """Where the ingest sources build to."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsdrjfm_ingest_{h.hexdigest()[:16]}.so"


def load_library(build: bool = True):
    """The loaded ingest library, compiled first if it is not built."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            if not build:
                raise NativeUnavailable(f"{path.name} is not built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                   str(NATIVE_DIR / "ingest.cc"), "-ldl"]
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
        _lib = lib
        return lib


class NativeWavSource:
    """Streaming IQ source: C++ producer thread -> lock-free ring -> blocks.

    pace=True emulates a live 2.304 MS/s front end (real-time emission,
    drops on overrun — the live-SDR failure mode); pace=False streams at
    full speed for offline runs.  loop=True restarts at EOF.
    """

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
        """Blocking read of one block; returns complex64 [got]."""
        buf = np.empty(2 * n_frames, dtype=np.float32)
        got = self._lib.sdr_source_read_blocking(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_frames, timeout_ms)
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
        layout)."""
        self._require_open()
        fb = int(self._lib.sdr_raw_frame_bytes(self._h))
        buf = np.empty(n_frames * fb, dtype=np.uint8)
        got = self._lib.sdr_raw_read_blocking(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_frames, timeout_ms)
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
