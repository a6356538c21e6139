"""Minimal RIFF/WAVE codec (numpy, no external deps).

Plays the role of libsndfile in the reference (devices/filereader/filehulp.cpp
reads 2-channel IQ wav at 2.304 MS/s; src/output/audiosink.cpp:268-274 dumps
audio wav).  Supports PCM 8/16/24/32-bit and IEEE float32, mono or stereo.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["WavInfo", "read_wav", "write_wav", "read_iq_wav", "write_iq_wav"]


@dataclass
class WavInfo:
    rate: int
    channels: int
    sampwidth: int            # bytes per sample
    fmt: int                  # 1 = PCM, 3 = IEEE float


def _parse_chunks(buf: bytes):
    if not (buf[:4] == b"RIFF" and buf[8:12] == b"WAVE"):
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    while pos + 8 <= len(buf):
        cid = buf[pos : pos + 4]
        size = struct.unpack("<I", buf[pos + 4 : pos + 8])[0]
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)


def _parse_fmt_and_data(buf: bytes):
    """Returns (WavInfo, data bytes) from a RIFF buffer."""
    fmt = None
    data = None
    for cid, off, size in _parse_chunks(buf):
        if cid == b"fmt ":
            a_fmt, ch, rate, _, _, bits = struct.unpack(
                "<HHIIHH", buf[off : off + 16])
            if a_fmt == 0xFFFE and size >= 40:   # WAVE_FORMAT_EXTENSIBLE
                a_fmt = struct.unpack("<H", buf[off + 24 : off + 26])[0]
            fmt = WavInfo(rate=rate, channels=ch, sampwidth=bits // 8,
                          fmt=a_fmt)
        elif cid == b"data":
            data = buf[off : off + size]
    if fmt is None or data is None:
        raise ValueError("missing fmt/data chunk")
    return fmt, data


def read_wav(path: str):
    """Returns (data [n, channels] float32 in [-1, 1), WavInfo)."""
    fmt, data = _parse_fmt_and_data(open(path, "rb").read())

    if fmt.fmt == 3:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif fmt.fmt == 1 and fmt.sampwidth == 2:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif fmt.fmt == 1 and fmt.sampwidth == 4:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif fmt.fmt == 1 and fmt.sampwidth == 1:
        x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif fmt.fmt == 1 and fmt.sampwidth == 3:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        v = (raw[:, 0].astype(np.int32)
             | (raw[:, 1].astype(np.int32) << 8)
             | (raw[:, 2].astype(np.int32) << 16))
        v = np.where(v & 0x800000, v - (1 << 24), v)
        x = v.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported wav format {fmt}")
    n = (len(x) // fmt.channels) * fmt.channels
    return x[:n].reshape(-1, fmt.channels), fmt


def write_wav(path: str, data: np.ndarray, rate: int, float32: bool = True):
    """Write [n] or [n, channels] samples; float32 or PCM16.  int16 input
    (already-quantized PCM, e.g. the receiver's emit_audio_i16 wire form)
    is written through exactly in PCM16 mode, rescaled in float mode."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    ch = data.shape[1]
    if float32:
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        payload = data.astype("<f4").tobytes()
        fmt_tag, bits = 3, 32
    elif data.dtype == np.int16:
        payload = data.astype("<i2", copy=False).tobytes()
        fmt_tag, bits = 1, 16
    else:
        payload = (np.clip(data, -1.0, 1.0 - 1.0 / 32768)
                   * 32768.0).astype("<i2").tobytes()
        fmt_tag, bits = 1, 16
    block = ch * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt_tag, ch, rate,
                                 rate * block, block, bits)
    hdr += b"data" + struct.pack("<I", len(payload))
    with open(path, "wb") as f:
        f.write(hdr + payload)


def read_iq_wav(path: str):
    """Read a 2-channel IQ capture as complex64 (I=left, Q=right; the
    reference filereader convention, filehulp.cpp:126-147 — mono files get a
    zero Q channel).  Returns (iq [n] complex64, rate)."""
    x, info = read_wav(path)
    if info.channels == 1:
        iq = x[:, 0].astype(np.complex64)
    else:
        iq = (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)
    return iq, info.rate


def read_iq_wav_raw(path: str):
    """Read a 16-bit PCM IQ capture WITHOUT converting to float.

    Returns (iq [n, 2] int16, rate).  Feeding this to a receiver configured
    with iq_format='i16' is bit-identical to the complex64 path (the
    on-device conversion is the same /32768 scaling read_wav applies) while
    halving host→device bytes and the device's input-read traffic — the
    chain's throughput ceiling (see ReceiverConfig.iq_format).
    """
    fmt, data = _parse_fmt_and_data(open(path, "rb").read())
    if not (fmt.fmt == 1 and fmt.sampwidth == 2 and fmt.channels == 2):
        raise ValueError(
            f"raw i16 read needs 16-bit PCM stereo, got {fmt}")
    x = np.frombuffer(data, dtype="<i2")
    n = (len(x) // 2) * 2
    return x[:n].reshape(-1, 2), fmt.rate


def is_riff(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == b"RIFF"


def probe_wav(path: str) -> WavInfo:
    """Header-only format probe (no data load — for streaming sources that
    must not pull the whole capture into memory)."""
    with open(path, "rb") as f:
        buf = f.read(4096)
    if not (buf[:4] == b"RIFF" and buf[8:12] == b"WAVE"):
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    while pos + 8 <= len(buf):
        cid = buf[pos : pos + 4]
        size = struct.unpack("<I", buf[pos + 4 : pos + 8])[0]
        if cid == b"fmt ":
            off = pos + 8
            a_fmt, ch, rate, _, _, bits = struct.unpack(
                "<HHIIHH", buf[off : off + 16])
            if a_fmt == 0xFFFE and size >= 40:
                a_fmt = struct.unpack("<H", buf[off + 24 : off + 26])[0]
            return WavInfo(rate=rate, channels=ch, sampwidth=bits // 8,
                           fmt=a_fmt)
        pos += 8 + size + (size & 1)
    raise ValueError("missing fmt chunk")


def read_iq_raw(path: str, fmt: str):
    """Read a headerless interleaved-IQ capture (the rtl_sdr/hackrf_transfer
    file convention — raw u8 or i16 pairs, no container).

    fmt: 'u8' (rtl_sdr), 'i8' (hackrf_transfer — SIGNED bytes,
    hackrf-handler.cpp:360-365) or 'i16' (e.g. airspy/sdr# raw dumps).
    Returns iq [n, 2] in the native dtype, ready for the matching
    ReceiverConfig.iq_format.
    """
    dt = {"u8": np.uint8, "i8": np.int8, "i16": "<i2"}[fmt]
    x = np.fromfile(path, dtype=dt)
    n = (len(x) // 2) * 2
    return x[:n].reshape(-1, 2)


def write_iq_wav(path: str, iq: np.ndarray, rate: int, float32: bool = True):
    write_wav(path, np.stack([iq.real, iq.imag], axis=1), rate,
              float32=float32)


class StreamingWavWriter:
    """Incremental wav writer for live runs.

    The reference dumps input IQ and audio to wav *while receiving*
    (fm-processor.cpp:338-349,448-455; audiosink.cpp:268-274 via libsndfile).
    This is the block-pipeline equivalent: open once, append per block,
    patch the RIFF/data sizes on close — the finished file is byte-identical
    to a one-shot `write_wav` of the concatenated blocks (the live-vs-
    offline dump identity the tests assert).
    """

    def __init__(self, path: str, rate: int, channels: int,
                 float32: bool = True):
        self.path = path
        self.channels = channels
        self.float32 = float32
        bits = 32 if float32 else 16
        block = channels * bits // 8
        hdr = b"RIFF" + struct.pack("<I", 36) + b"WAVE"
        hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 3 if float32 else 1,
                                     channels, rate, rate * block, block,
                                     bits)
        hdr += b"data" + struct.pack("<I", 0)
        self._f = open(path, "wb")
        self._f.write(hdr)
        self._nbytes = 0

    def write(self, data: np.ndarray) -> None:
        """Append [n] or [n, channels] samples (write_wav encoding rules:
        float32 mode rescales int16; PCM16 mode passes int16 through and
        quantizes float)."""
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[:, None]
        assert data.shape[1] == self.channels
        if self.float32:
            if data.dtype == np.int16:
                data = data.astype(np.float32) / 32768.0
            payload = data.astype("<f4").tobytes()
        elif data.dtype == np.int16:
            payload = data.astype("<i2", copy=False).tobytes()
        else:
            payload = (np.clip(data, -1.0, 1.0 - 1.0 / 32768)
                       * 32768.0).astype("<i2").tobytes()
        self._f.write(payload)
        self._nbytes += len(payload)

    def write_iq(self, iq: np.ndarray) -> None:
        iq = np.asarray(iq)
        self.write(np.stack([iq.real, iq.imag], axis=1))

    def close(self) -> None:
        if self._f is None:
            return
        self._f.seek(4)
        self._f.write(struct.pack("<I", 36 + self._nbytes))
        self._f.seek(40)
        self._f.write(struct.pack("<I", self._nbytes))
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
