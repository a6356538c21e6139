"""Traffic kind `live_paced`: live listening to a station at its broadcast
rate, open loop.

A generator process (`fmbench/pacer.py`), separate from the receiver,
writes the station's int16 stream into a pipe `chunk_frames` frames at a
time, each chunk when its last frame is due at the wire rate, on a
schedule that does not slow when the receiver does.  The stream is made
from the seed in set-up and handed to the generator before it starts.  The
receiver reads the pipe through `NativePipeSource(drop_on_full=True)` into
`run_live`, as `rx --follow` on a pipe does, with the program's RDS
decoder fed every block where the receiver recovers RDS bits.

The first `warmup_blocks` blocks are set-up; the window holds the next
floor(seconds / block air) blocks, and `tail_blocks` more follow so that
the window's last block is read ahead of as every other.  A block's
latency runs from the due time of its last frame to the `on_audio`
callback that hands its audio over; a block not delivered, or whose frames
were dropped or shifted by a drop, is failed and its latency infinite.
The generator reports when it offered each chunk to the pipe, and how
late against the schedule: the live source's lag is taken from then.
`latency_p95_ms` is the nearest-rank 95th percentile over the window's
blocks.  With tracing, `trace_seconds` of blocks from the window's middle
are profiled (again from the next block, up to three times, until a trace
holds device events).
"""

from __future__ import annotations

import fcntl
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from fmbench.harness import ProgramRun, Run, rds_report
from fmbench.synth import StationParams, StationSynth
from fmbench.trace import Profiler, warm_up

PACER = Path(__file__).resolve().parent.parent / "pacer.py"
F_SETPIPE_SZ = 1031
PIPE_BYTES = 1 << 20
SYNTH_BLOCKS = 16             # blocks made and handed over at once
GO_LEAD_S = 0.05              # from "go" to the first chunk's start


def nearest_rank(values: np.ndarray, q: float) -> float:
    v = np.sort(values)
    return float(v[max(0, math.ceil(q * len(v)) - 1)])


class Stamped:
    """The source as run_live sees it, stamping each read's return (and,
    under the profiler, naming the wait `read_block`)."""

    def __init__(self, src, stamps: np.ndarray):
        self.src, self.stamps, self.i = src, stamps, 0

    @property
    def dropped(self) -> int:
        return self.src.dropped

    def read_block(self, n: int, timeout_ms: int = 10_000):
        with record_function("read_block"):
            blk = self.src.read_block(n, timeout_ms)
        if self.i < len(self.stamps):
            self.stamps[self.i] = time.monotonic()
        self.i += 1
        return blk


def input_blocks(traffic: dict, wire_len: int, seconds: float,
                 rate: int = 2_304_000) -> int:
    """Receiver blocks the stream holds: the warm-up, the window's and the
    tail's."""
    return (int(traffic["warmup_blocks"]) + int(seconds / (wire_len / rate))
            + int(traffic["tail_blocks"]))


def run(ctx) -> Run:
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu_torch.rds.live import LiveRDSDecoder
    from sdrjfm_tpu_torch.runtime.native_source import NativePipeSource
    from sdrjfm_tpu_torch.runtime.stream import run_live

    p = ctx.traffic
    cfg = ReceiverConfig(**ctx.receiver)
    T, rate = cfg.wire_len, cfg.wire_rate
    chunk = int(p["chunk_frames"])
    if T % chunk:
        raise ValueError(f"chunk_frames {chunk} does not tile a block of {T}")
    block_s = T / rate
    W, tail = int(p["warmup_blocks"]), int(p["tail_blocks"])
    total = input_blocks(p, T, ctx.seconds, rate)
    n_win = total - W - tail
    r, w = os.pipe()
    try:
        fcntl.fcntl(w, F_SETPIPE_SZ, PIPE_BYTES)
    except OSError:
        pass                          # the default pipe size then
    pacer = subprocess.Popen([sys.executable, str(PACER)],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             pass_fds=(w,))
    os.close(w)
    src = None
    try:
        pacer.stdin.write(json.dumps(
            {"fd": w, "chunk_bytes": chunk * 4, "period_s": chunk / rate,
             "total_bytes": total * T * 4}).encode() + b"\n")
        station = StationParams.from_dict(p.get("station", {}))
        syn = StationSynth(station, ctx.seed, total * T, ctx.device)
        wire = np.empty((total * T, 2), np.int16)
        for lo in range(0, total, SYNTH_BLOCKS):
            n = min(SYNTH_BLOCKS, total - lo)
            x = syn.next(n * T).cpu().numpy()
            wire[lo * T:(lo + n) * T] = x
            pacer.stdin.write(memoryview(x).cast("B"))
        pacer.stdin.flush()
        rx = Receiver(cfg, device=ctx.device)
        # capture the step before the stream starts, as rx --follow does
        rx.jit_step().prepare()
        if ctx.trace:
            warm_up(ctx.device)
        src = NativePipeSource(f"/dev/fd/{r}", cfg.iq_format, rate=rate,
                               ring_frames=int(p["ring_frames"]),
                               drop_on_full=True)
        os.close(r)
        r = None
        src.start()
        if pacer.stdout.readline().strip() != b"ready":
            raise RuntimeError("the pacer did not take the stream")
        t0 = time.monotonic() + GO_LEAD_S
        pacer.stdin.write(f"go {t0!r}\n".encode())
        pacer.stdin.close()
        due = t0 + (np.arange(total) + 1) * block_s
        setup_s = t0 + W * block_s - ctx.t_start

        read_t = np.full(total, np.nan)
        audio_t = np.full(total, np.nan)
        n_prof = max(1, round(float(p.get("trace_seconds", 0)) / block_s))
        tr = {"start": W + n_win // 2, "prof": None, "trace": None,
              "tries": 0, "first": None, "n": 0}
        k = [0]

        def on_audio(frames):
            audio_t[k[0]] = time.monotonic()
            k[0] += 1
            if not ctx.trace or tr["trace"] is not None:
                return
            if tr["prof"] is None and k[0] == tr["start"] \
                    and tr["tries"] < 3:
                tr["prof"], tr["first"] = Profiler(ctx.device.type), k[0]
                tr["prof"].start()
                tr["tries"] += 1
            elif tr["prof"] is not None and k[0] == tr["first"] + n_prof:
                tr["trace"], tr["prof"] = tr["prof"].stop(), None
                tr["n"], tr["start"] = n_prof, k[0] + 1

        live_rds = LiveRDSDecoder() if cfg.rds != "off" else None
        res = run_live(rx, Stamped(src, read_t), max_blocks=total,
                       on_audio=on_audio,
                       rds_feedback=live_rds.feed if live_rds else None,
                       keep_outputs=True)
        if tr["prof"] is not None:
            tr["trace"] = tr["prof"].stop()
            tr["n"] = k[0] - tr["first"]
        src.close()
        src = None
        pacer_out = pacer.stdout.read()
        pacer.wait(timeout=30)
    finally:
        if src is not None:
            src.close()
        if r is not None:
            os.close(r)
        if pacer.poll() is None:
            pacer.kill()
            pacer.wait()

    delivered = len(res.meta)
    drops = np.array([m.get("ingest_dropped", 0) for m in res.meta] + [0])
    first_drop = int(np.argmax(drops > 0)) if (drops > 0).any() else total
    win = np.arange(W, W + n_win)
    bad = (win >= delivered) | (win >= first_drop)
    lat = (audio_t[win] - due[win]) * 1e3
    lat[bad | np.isnan(lat)] = math.inf
    state = {"rx": rx}

    def free():
        state.clear()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    try:
        gen = json.loads(pacer_out.decode().strip().splitlines()[-1])
        offered = np.asarray(gen.pop("offered"))[T // chunk - 1::T // chunk]
    except (ValueError, IndexError, KeyError):
        gen, offered = None, np.full(total, np.nan)

    def block(b):
        return wire[b * T:(b + 1) * T]
    return Run(metrics={"latency_p95_ms": nearest_rank(lat, 0.95),
                        "setup_s": setup_s},
               attempted=n_win, failed=int(bad.sum()),
               runs=[ProgramRun(delivered, res.audio, res.rds_bits,
                                rds_report(live_rds) if live_rds else None,
                                ctx.receiver,
                                station, block)],
               free=free, trace=tr["trace"], trace_blocks=tr["n"],
               stamps={"due": due[win], "offered": offered[win],
                       "read": read_t[win], "audio": audio_t[win]},
               notes={"blocks": total, "dropped": int(res.dropped_total),
                      "generator": gen,
                      "latency_p50_ms": nearest_rank(lat, 0.5)})
