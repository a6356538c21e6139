"""Live PCM audio sink (port of sdrjfm_tpu.io.pcmout): the audioSink
equivalent for a headless box.

The reference plays audio through portaudio (src/output/audiosink.cpp:29-56:
stream open, callback drains an SPSC ring, zero-filling underruns).  In this
environment there is no audio device, so the sink writes raw interleaved
s16le PCM to a file, FIFO, or stdout (`rx --pcm-out`), playable with
`aplay -f S16_LE -r 48000 -c 2`.  A FIFO gives the same
decoupled producer/consumer shape as the reference's ring buffer: the pipe
buffer is the ring, the reading player is the callback thread.

Optional real-time pacing throttles writes to the sample rate (the
filereader device paces its producer the same way, filehulp.cpp:159-202) so
an unbounded consumer (a file on disk) doesn't race ahead of a live tuner.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def quantize_pcm16(frames: np.ndarray) -> np.ndarray:
    """Float audio in [-1, 1] to s16le: clip to [-1, 1 - 2^-15], scale by
    32768, truncate toward zero.  The receiver's on-device emit_audio_i16
    (models.receiver.quantize_i16) is held to this bit for bit."""
    return (np.clip(np.asarray(frames).astype(np.float32), -1.0,
                    1.0 - 1.0 / 32768) * 32768.0).astype("<i2")


class PCMSink:
    """Writes float audio frames as interleaved s16le PCM.

    path     : output file path, or '-' for stdout
    rate     : sample rate (pacing only; the byte stream is unannotated)
    channels : interleaved channel count
    pace     : if True, throttle to real time
    """

    def __init__(self, path: str, rate: int, channels: int = 2,
                 pace: bool = False):
        self.rate = int(rate)
        self.channels = channels
        self.pace = pace
        self._t0 = None
        self._frames_written = 0
        if path == "-":
            self._fh = sys.stdout.buffer
            self._own = False
        else:
            self._fh = open(path, "wb")
            self._own = True

    def write(self, frames: np.ndarray) -> None:
        """frames: [n, channels] (or [n] mono) float in [-1, 1], or int16
        already quantized (the receiver's on-device emit_audio_i16 wire
        form — passed straight through)."""
        x = np.asarray(frames)
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[1] != self.channels:
            raise ValueError(f"PCMSink: {x.shape[1]} channels, want "
                             f"{self.channels}")
        if x.dtype == np.int16:
            pcm = x.astype("<i2", copy=False)
        else:
            # same quantizer as io.wavio.write_wav PCM16
            pcm = quantize_pcm16(x)
        if self.pace:
            if self._t0 is None:
                self._t0 = time.time()
            due = self._t0 + self._frames_written / self.rate
            delay = due - time.time()
            if delay > 0:
                time.sleep(delay)
        self._fh.write(pcm.tobytes())
        self._fh.flush()
        self._frames_written += x.shape[0]

    def close(self) -> None:
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
