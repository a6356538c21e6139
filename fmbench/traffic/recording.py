"""Traffic kind `recording`: offline demodulation of a recording, closed
loop.

Set-up makes one recording of `blocks` receiver blocks of the station from
the seed (on the card, in a few large calls) and demodulates it
`warmup_passes` times.  The window then demodulates it again and again,
each pass from a fresh state through `run_offline_scanned(rx, recording)`
(the path of `rx --runner scan`), until `seconds` have passed; the window
ends with the pass that crosses that mark.  `air_x` is the air of every
pass over the window's wall time.

A sample of `kept_passes` passes, drawn from the seed over the whole
window, is kept for the check: their audio and RDS bits, what
`run_offline_scanned` hands its caller (`rx --runner scan` decodes the
bits after the run, outside this path).  With tracing, passes from the
window's third on are profiled `trace_passes` at a time until a trace
holds device events; the host time of each graph replay, staging and
fetch outside the profiled passes is stamped (`HostClock`: the
profiler's own activity tracing would inflate them); after the window `attribution_blocks` blocks
are stepped eagerly through `Receiver.front_end` and `Receiver.fm_chain`
under the ranges `front_end` and `fm_chain`.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from fmbench.harness import ProgramRun, Run
from fmbench.synth import StationParams, StationSynth
from fmbench.trace import Profiler, warm_up

MAX_TRACE_TRIES = 3


def eager_step(rx, state, controls, block):
    """`Receiver.step` as its two calls, each in its own profiler range
    (the front end's updates handed to the fm chain as `step` hands
    them)."""
    from torch.profiler import record_function
    cfg = rx.cfg
    with record_function("front_end"):
        v, (dc, itail, t1, t2, itap, rc) = rx.front_end(state, controls,
                                                        block)
    upd = dict(n0_mod=(state.n0_mod + cfg.block_in) % cfg.input_rate,
               rf_dc=dc, input_filt=itail if cfg.input_filter else None,
               band1=t1, band2=t2, input_tap=itap, rate_carry=rc)
    with record_function("fm_chain"):
        return rx.fm_chain(state, controls, v, upd)


def attribution(rx, wire_dev, nblocks: int, device_type: str):
    """Kernel microseconds by range over nblocks eager steps."""
    T = rx.cfg.wire_len
    st, ctl = rx.init_state(), rx.initial_controls()
    st, _ = eager_step(rx, st, ctl, wire_dev[:T])        # warm
    for _ in range(MAX_TRACE_TRIES):
        p = Profiler(device_type)
        p.start()
        s = st
        for b in range(nblocks):
            s, _ = eager_step(rx, s, ctl, wire_dev[b * T:(b + 1) * T])
        tr = p.stop()
        if tr is not None:
            return tr.kernels_by_range()
    return None


class HostClock:
    """Stamps the host time of calls into the runner's parts while it is
    on: each graph replay (`torch.cuda.CUDAGraph.replay`, one
    cudaGraphLaunch), in microseconds, and each chunk's staging
    (`ScanGraph.load_blocks`: the copy into pinned memory and the queued
    upload) and fetch (`ScanGraph.fetch`: the wait for the chunk's
    replays and the copies down), in milliseconds a block."""

    def __init__(self):
        self.got = {"replay_us": [], "stage_ms": [], "fetch_ms": []}
        self.on = False

    def _wrap(self, cls, name, key, blocks):
        fn = getattr(cls, name)
        clock = self

        def stamped(obj, *a, **k):
            if not clock.on:
                return fn(obj, *a, **k)
            t = time.perf_counter_ns()
            out = fn(obj, *a, **k)
            clock.got[key].append((time.perf_counter_ns() - t) * 1e-3
                                  / blocks(a))
            return out
        setattr(cls, name, stamped)
        return cls, name, fn

    @contextlib.contextmanager
    def installed(self):
        from sdrjfm_tpu_torch.runtime.graph import ScanGraph
        saved = [self._wrap(torch.cuda.CUDAGraph, "replay", "replay_us",
                            lambda a: 1),
                 self._wrap(ScanGraph, "load_blocks", "stage_ms",
                            lambda a: 1e3 * a[0].shape[0]),
                 self._wrap(ScanGraph, "fetch", "fetch_ms",
                            lambda a: 1e3 * a[0])]
        try:
            yield self
        finally:
            for cls, name, fn in saved:
                setattr(cls, name, fn)


class Reservoir:
    """A uniform sample of k items from a stream, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.items = k, []
        self.rng = np.random.default_rng(seed)

    def offer(self, i: int, item) -> None:
        if i < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.items[j] = item


def input_blocks(traffic: dict, wire_len: int, seconds: float) -> int:
    """Receiver blocks of input a run makes: one recording."""
    return int(traffic["blocks"])


def run(ctx) -> Run:
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu_torch.runtime.stream import run_offline_scanned
    from torch.profiler import record_function

    p = ctx.traffic
    cfg = ReceiverConfig(**ctx.receiver)
    T = cfg.wire_len
    nb = input_blocks(p, T, ctx.seconds)
    cuda = ctx.device.type == "cuda"
    station = StationParams.from_dict(p.get("station", {}))
    syn = StationSynth(station, ctx.seed, T * nb, ctx.device)
    wire_dev = syn.next(T * nb)
    wire = wire_dev.cpu().numpy()
    rx = Receiver(cfg, device=ctx.device)
    for _ in range(int(p["warmup_passes"])):
        run_offline_scanned(rx, wire)
    if ctx.trace:
        warm_up(ctx.device)
    setup_s = time.monotonic() - ctx.t_start

    kept = Reservoir(int(p["kept_passes"]), ctx.seed)
    prof, trace, tries = None, None, 0
    trace_from, trace_n = 2, int(p.get("trace_passes", 0))
    passes, ends = 0, []
    clock = HostClock()
    with (clock.installed() if ctx.trace and cuda
          else contextlib.nullcontext()):
        t0 = time.monotonic()
        while True:
            if ctx.trace and trace is None and passes == trace_from \
                    and tries < MAX_TRACE_TRIES:
                prof = Profiler(ctx.device.type)
                prof.start()
                tries += 1
            clock.on = prof is None
            with (record_function("run_offline_scanned") if prof is not None
                  else contextlib.nullcontext()):
                res = run_offline_scanned(rx, wire)
            kept.offer(passes, res)
            passes += 1
            ends.append(time.monotonic())
            if prof is not None and passes == trace_from + trace_n:
                trace, prof = prof.stop(), None
                trace_from = passes
            if time.monotonic() - t0 >= ctx.seconds:
                break
        window_s = time.monotonic() - t0
    if prof is not None:
        trace = prof.stop()
        trace_n = passes - trace_from
    air_s = passes * nb * T / cfg.wire_rate
    attr = (attribution(rx, wire_dev, int(p["attribution_blocks"]),
                        ctx.device.type) if ctx.trace else None)

    def block(b):
        return wire[b * T:(b + 1) * T]
    runs = [ProgramRun(nb, r.audio, r.rds_bits, None, ctx.receiver, station,
                       block) for r in kept.items]
    state = {"rx": rx, "wire_dev": wire_dev}

    def free():
        state.clear()
        if cuda:
            torch.cuda.synchronize()

    return Run(metrics={"air_x": air_s / window_s, "setup_s": setup_s},
               attempted=passes * nb, failed=0, runs=runs,
               free=free, trace=trace, attribution=attr,
               attribution_blocks=int(p["attribution_blocks"]),
               trace_blocks=trace_n * nb,
               stamps={k: np.asarray(v) for k, v in clock.got.items()},
               notes={"passes": passes, "window_s": window_s,
                      **({"fetch_ms": float(np.mean(clock.got["fetch_ms"]))}
                         if clock.got["fetch_ms"] else {}),
                      "pass_ms_p10_p50_p90_max": [
                          float(v) for v in np.percentile(
                              np.diff([t0] + ends) * 1e3, [10, 50, 90, 100])]})
