"""The traffic: the station made from its seed, and the live generator's
schedule."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fmbench.harness import HERE, Bench
from fmbench.synth import StationParams, StationSynth, WIRE_RATE
from fmbench.synth.rds import checkword, group_rotation

T = 16384 * 12


@pytest.mark.parametrize("traffic", ["file_1", "live_1x"])
def test_input_deterministic_from_the_seed(traffic):
    """The same seed gives the same bytes, another seed other bytes of the
    same size (the seed changes the content, never the work)."""
    bench = Bench()
    params = StationParams.from_dict(bench.traffic(traffic)["station"])
    big = 2 ** 31 + 987654321
    a = StationSynth(params, big, 3 * T).next(3 * T)
    b = StationSynth(params, big, 3 * T).next(3 * T)
    c = StationSynth(params, big + 1, 3 * T).next(3 * T)
    assert a.dtype == torch.int16 and a.shape == (3 * T, 2)
    assert torch.equal(a, b)
    assert c.shape == a.shape and not torch.equal(a, c)


def test_stream_in_pieces():
    """A stream made in pieces has the one form: its envelope is the
    carrier's and its FM phase runs on across the pieces."""
    p = StationParams(noise_std=0.0)
    s = StationSynth(p, 5, 4 * T)
    x = torch.cat([s.next(T), s.next(2 * T), s.next(T)]).double()
    z = torch.complex(x[:, 0], x[:, 1]) / 32768.0
    assert torch.allclose(z.abs(), torch.full_like(z.abs(), p.amplitude),
                          atol=1e-4)
    # the phase step never exceeds the deviation's (75 kHz) plus quantisation
    step = torch.angle(z[1:] * z[:-1].conj()).abs().max()
    assert step < 2 * np.pi * 75_000 / WIRE_RATE * 1.05 + 1e-3


def test_live_window_length():
    kind = Bench().kind("live_paced")
    traffic = Bench().traffic("live_1x")
    n = kind.input_blocks(traffic, T, 30.0)
    assert n == traffic["warmup_blocks"] + 351 + traffic["tail_blocks"]


def test_rds_checkwords_match_the_program():
    from sdrjfm_tpu_torch.rds import crc
    for info in (0x10F0, 0x0000, 0xFFFF, 0x2345):
        for ours, theirs in (("A", "A"), ("B", "B"), ("C", "C1"),
                             ("C'", "C2"), ("D", "D")):
            want = crc.encode_block(info, theirs)
            assert ((info << 10) | checkword(info, ours)) == want
    bits = group_rotation(0x10F0, 10, "TPU FM", "VERIFY RUN")
    assert bits.shape == (20 * 104,) and set(np.unique(bits)) <= {0, 1}


def _pace(chunks: int, chunk_bytes: int, period: float):
    r, w = os.pipe()
    proc = subprocess.Popen([sys.executable, str(HERE / "pacer.py")],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            pass_fds=(w,))
    os.close(w)
    data = np.arange(chunks * chunk_bytes, dtype=np.uint8).tobytes()
    proc.stdin.write(json.dumps({"fd": w, "chunk_bytes": chunk_bytes,
                                 "period_s": period,
                                 "total_bytes": len(data)}).encode() + b"\n")
    proc.stdin.write(data)
    proc.stdin.flush()
    assert proc.stdout.readline().strip() == b"ready"
    t0 = time.monotonic() + 0.05
    proc.stdin.write(f"go {t0!r}\n".encode())
    proc.stdin.close()
    got, when = b"", []
    with os.fdopen(r, "rb", buffering=0) as f:
        while True:
            b = f.read(chunk_bytes - len(got) % chunk_bytes)
            if not b:
                break
            got += b
            if len(got) % chunk_bytes == 0:
                when.append(time.monotonic())
    stats = json.loads(proc.stdout.read().decode().splitlines()[-1])
    proc.wait(timeout=10)
    return t0, data, got, np.array(when), stats


def test_generator_schedule():
    """Chunk i arrives whole, in order, not before t0 + (i+1) * period, and
    the generator reports how late it wrote."""
    period, chunks, size = 0.02, 20, 4 * 1024
    t0, data, got, when, stats = _pace(chunks, size, period)
    assert got == data
    due = t0 + (np.arange(chunks) + 1) * period
    assert len(when) == chunks
    assert (when >= due - 1e-4).all()
    assert stats["chunks"] == chunks
    assert 0 <= stats["late_ms_p50"] < 50
    # each chunk offered to the pipe at or after its due time, and read
    # after it was offered
    offered = np.array(stats["offered"])
    assert len(offered) == chunks and (offered >= due).all()
    assert (when >= offered).all()
    # the writer keeps its schedule: the last chunk is not later than the
    # schedule plus the generator's own reported worst lateness and slack
    assert when[-1] - due[-1] < stats["late_ms_max"] / 1e3 + 0.05


@pytest.mark.card
def test_card_stream_reproducible():
    """On the card one seed gives one stream, call after call: the FM
    phase's scan sums in a fixed order (SHA-256 of this stream taken on an
    NVIDIA H100 80GB HBM3)."""
    import hashlib
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    params = StationParams.from_dict(Bench().traffic("live_1x")["station"])
    n = 6 * 131072 * 12
    xs = [StationSynth(params, 2 ** 31 + 2101, n, "cuda").next(n).cpu()
          for _ in range(4)]
    assert all(torch.equal(xs[0], x) for x in xs[1:])
    assert hashlib.sha256(xs[0].numpy().tobytes()).hexdigest() == (
        "542ce49ea2ddefa336651f782677fced3135c5ce4ddcde35b8c9ec7e8a242c5a")
