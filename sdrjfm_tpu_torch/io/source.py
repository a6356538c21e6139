"""Input source abstraction (port of sdrjfm_tpu.io.source): the
deviceHandler interface.

The reference defines an abstract device (devices/device-handler.h:60-85:
getRate / set+getVFOFrequency / legalFrequency / restartReader / stopReader /
getSamples / Samples / resetBuffer / bitDepth) with ~12 hardware backends
feeding a ring buffer from an acquisition thread (SURVEY.md §2.5).  The
protocol below carries the same contract.

Implementations here (numpy only):
  WavFileSource    — whole-capture wav replay (devices/filereader semantics)
  SynthSource      — procedurally generated stereo+RDS broadcast signal
  open_source      — the factory; 'native:' and 'pipe:' wrap the C++ ring
                     sources of runtime/native_source
"""

from __future__ import annotations

from typing import Iterator, Optional, Protocol

import numpy as np

from .. import constants as C


class Source(Protocol):
    """Contract mirrored from deviceHandler (device-handler.h:60-85)."""

    def get_rate(self) -> int: ...
    def set_vfo_frequency(self, hz: int) -> None: ...
    def get_vfo_frequency(self) -> int: ...
    def legal_frequency(self, hz: int) -> bool: ...
    def restart_reader(self) -> bool: ...
    def stop_reader(self) -> None: ...
    def get_samples(self, n: int) -> np.ndarray: ...
    def samples(self) -> int: ...
    def reset_buffer(self) -> None: ...
    def bit_depth(self) -> int: ...


FM_BAND_LOW = 87_500_000
FM_BAND_HIGH = 108_000_000


class _BaseSource:
    def __init__(self, rate: int = C.INPUT_RATE):
        self._rate = rate
        self._vfo = 94_000_000
        self._running = False

    def get_rate(self) -> int:
        return self._rate

    def set_vfo_frequency(self, hz: int) -> None:
        self._vfo = int(hz)

    def get_vfo_frequency(self) -> int:
        return self._vfo

    def legal_frequency(self, hz: int) -> bool:
        return FM_BAND_LOW <= hz <= FM_BAND_HIGH

    def restart_reader(self) -> bool:
        self._running = True
        return True

    def stop_reader(self) -> None:
        self._running = False

    def bit_depth(self) -> int:
        return 32


class WavFileSource(_BaseSource):
    """Whole-capture wav IQ source (deterministic replay)."""

    def __init__(self, path: str, loop: bool = False):
        from .wavio import read_iq_wav
        self.iq, rate = read_iq_wav(path)
        super().__init__(rate)
        self.loop = loop
        self._pos = 0

    def samples(self) -> int:
        if self.loop:
            return 1 << 62
        return len(self.iq) - self._pos

    def get_samples(self, n: int) -> np.ndarray:
        out = np.empty(n, np.complex64)
        got = 0
        while got < n:
            avail = len(self.iq) - self._pos
            if avail == 0:
                if not self.loop:
                    break
                self._pos = 0
                avail = len(self.iq)
            take = min(n - got, avail)
            out[got : got + take] = self.iq[self._pos : self._pos + take]
            self._pos += take
            got += take
        return out[:got]

    def reset_buffer(self) -> None:
        self._pos = 0

    def blocks(self, block_len: int) -> Iterator[np.ndarray]:
        while self.samples() >= block_len:
            yield self.get_samples(block_len)


class SynthSource(_BaseSource):
    """Procedural broadcast-FM signal generator (infinite stream)."""

    def __init__(self, seconds_per_chunk: float = 1.0, seed: int = 0,
                 station: str = "TPU FM  ", pi: int = 0x10F0,
                 noise_std: float = 0.0):
        super().__init__(C.INPUT_RATE)
        from . import synth
        from ..rds import encode
        self._synth = synth
        n = int(seconds_per_chunk * C.FM_RATE)
        t = np.arange(n) / C.FM_RATE
        bits = encode.make_bitstream(pi=pi, station=station)
        syms = encode.differential_encode(bits)
        mpx = synth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000 * t),
                              0.6 * np.sin(2 * np.pi * 440 * t),
                              synth.MPXParams(rds_level=0.06), rds_bits=syms)
        self._chunk = synth.fm_modulate(mpx, C.FM_RATE, noise_std=noise_std,
                                        seed=seed)
        self._pos = 0

    def samples(self) -> int:
        return 1 << 62

    def get_samples(self, n: int) -> np.ndarray:
        out = np.empty(n, np.complex64)
        got = 0
        while got < n:
            avail = len(self._chunk) - self._pos
            if avail == 0:
                self._pos = 0
                avail = len(self._chunk)
            take = min(n - got, avail)
            out[got : got + take] = self._chunk[self._pos : self._pos + take]
            self._pos += take
            got += take
        return out

    def reset_buffer(self) -> None:
        self._pos = 0


def open_source(spec: str, **kw) -> Source:
    """Source factory: 'file:path.wav', 'native:path.wav', 'synth',
    'pipe:-'/'pipe:fifo' (headerless stream from any SDR tool; kw:
    fmt='u8'|'i8'|'i16').  'rtltcp://host:port' is refused (not ported
    yet)."""
    if spec.startswith(("rtltcp:", "rtl_tcp:")):
        raise ValueError(f"{spec}: the rtl_tcp source is not ported to "
                         "sdrjfm_tpu_torch yet (ROADMAP.md, queue 1)")
    if spec.startswith("pipe:"):
        from ..runtime.native_source import NativePipeSource

        class _PipeAdapter(_BaseSource):
            """deviceHandler-shaped wrapper over an stdin/FIFO stream
            (open_source('pipe:-', fmt='u8')); get_samples converts the
            integer frames host-side for protocol users — the rx CLI
            instead feeds them to the device untouched."""

            def __init__(self, path):
                self._src = NativePipeSource(path, **kw)
                super().__init__(self._src.rate)
                self._src.start()

            def bit_depth(self) -> int:
                return 16 if self._src.fmt == "i16" else 8

            def samples(self) -> int:
                return self._src.available()

            def get_samples(self, n: int) -> np.ndarray:
                raw = self._src.read_block(n)
                if self._src.fmt == "u8":
                    f = (raw.astype(np.float32) - 127.0) / 128.0
                elif self._src.fmt == "i8":        # the receiver's i8 decode
                    f = raw.astype(np.float32) / 128.0
                else:
                    f = raw.astype(np.float32) / 32768.0
                return (f[:, 0] + 1j * f[:, 1]).astype(np.complex64)

            def reset_buffer(self) -> None:
                pass

            def stop_reader(self) -> None:
                self._src.stop()

        return _PipeAdapter(spec[5:])
    if spec.startswith("native:"):
        from ..runtime.native_source import NativeWavSource

        class _NativeAdapter(_BaseSource):
            def __init__(self, path):
                self._src = NativeWavSource(path, **kw)
                super().__init__(self._src.rate)
                self._src.start()

            def samples(self):
                return self._src.available()

            def get_samples(self, n):
                return self._src.read_block(n)

            def reset_buffer(self):
                pass

            def stop_reader(self):
                self._src.stop()

        return _NativeAdapter(spec[7:])
    if spec.startswith("file:"):
        return WavFileSource(spec[5:], **kw)
    if spec == "synth":
        return SynthSource(**kw)
    return WavFileSource(spec, **kw)
