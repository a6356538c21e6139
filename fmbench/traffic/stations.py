"""Traffic kind `stations`: a band monitor's closed loop, every receiver of
the configuration's raster demodulated at once from one capture.

Set-up makes one capture of `blocks` receiver blocks from the seed: the
traffic's `stations`, each at its `carrier_hz`, summed under one receiver
noise of `noise_std` and quantised once (`StationsSynth`, on the card).
The configuration's `receivers_hz` are the receivers' offsets from the
capture's centre.  The capture goes through `demodulate_stations(rx,
capture, receivers_hz, scan=True)` (the path of `rx scan --identify`)
`warmup_passes` times; the window then demodulates it again and again,
each pass from a fresh state, until `seconds` have passed, and ends with
the pass that crosses that mark.  A pass counts once, when every
receiver's audio and RDS bits have reached the host: `air_x` is the
capture's air of every pass over the window's wall time.

`attempted` counts receiver-blocks (passes x blocks x receivers); a
receiver whose audio is missing or of another length than its blocks'
fails the blocks it lacks, at least one.  A sample of `kept_passes`
passes, drawn from the seed over the window, is kept for the check: of
each, the receivers tuned to a station, each a run at its `tune_hz`
(the other receivers sit on noise or on a neighbour's skirt, and are not
judged).  With tracing, `trace_passes` passes from the window's third on
are profiled (again from the next pass, up to three times, until a trace
holds device events); after the window `attribution_blocks` blocks are
stepped eagerly on every receiver's row through
`Receiver.front_end_rows` and `Receiver.fm_chain`, under the ranges
`front_end` and `fm_chain`.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from fmbench.harness import ProgramRun, Run
from fmbench.synth import StationParams, StationsSynth
from fmbench.trace import Profiler, warm_up
from fmbench.traffic.recording import MAX_TRACE_TRIES, Reservoir


def input_blocks(traffic: dict, wire_len: int, seconds: float) -> int:
    """Receiver blocks of input a run makes: one capture."""
    return int(traffic["blocks"])


def _stations(traffic: dict):
    return [StationParams.from_dict(d) for d in traffic["stations"]]


def _capture(ctx, stations, nblocks: int) -> torch.Tensor:
    """The capture on ctx.device, int16 [nblocks x wire_len, 2]."""
    n = 12 * int(ctx.receiver["block_fm"]) * nblocks
    return StationsSynth(stations, ctx.seed, n, ctx.device,
                         float(ctx.traffic["noise_std"])).next(n)


def control_input(ctx, nblocks: int):
    """The capture and its station receivers (station, tune_hz), for the
    control of `calibrate.py`."""
    stations = _stations(ctx.traffic)
    wire = _capture(ctx, stations, nblocks).cpu().numpy()
    return wire, [(p, int(p.carrier_hz)) for p in stations]


def failed_blocks(results, offsets, nblocks: int, block_audio: int) -> int:
    """The receiver-blocks of one pass whose audio is missing or of the
    wrong length: a receiver with no result fails every block, one whose
    audio is not [nblocks x block_audio, 2] the blocks it lacks, at least
    one."""
    by_offset = {r["offset_hz"]: r for r in results}
    failed = 0
    for off in offsets:
        r = by_offset.get(off)
        audio = None if r is None else r.get("audio")
        if audio is None:
            failed += nblocks
        elif audio.shape != (nblocks * block_audio, 2):
            failed += max(1, nblocks - len(audio) // block_audio)
    return failed


def attribution(rx, offsets, wire_dev, nblocks: int, device_type: str):
    """Kernel microseconds by range over nblocks eager n-station steps."""
    from torch.profiler import record_function
    T = rx.cfg.wire_len
    msr = rx.stations()
    ctl = msr.controls_for(offsets)

    def step(s, b):
        block = wire_dev[b * T:(b + 1) * T]
        with record_function("front_end"):
            v, fe = rx.front_end_rows(s, ctl, block)
        with record_function("fm_chain"):
            return rx.fm_chain(s, ctl, v, fe)

    st, _ = step(msr.init_states(len(offsets)), 0)         # warm
    for _ in range(MAX_TRACE_TRIES):
        p = Profiler(device_type)
        p.start()
        s = st
        for b in range(nblocks):
            s, _ = step(s, b)
        tr = p.stop()
        if tr is not None:
            return tr.kernels_by_range()
    return None


def run(ctx) -> Run:
    from sdrjfm_tpu_torch.models.multistation import demodulate_stations
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    from torch.profiler import record_function

    p = ctx.traffic
    cfg = ReceiverConfig(**ctx.receiver)
    T = cfg.wire_len
    nb = input_blocks(p, T, ctx.seconds)
    cuda = ctx.device.type == "cuda"
    offsets = [int(f) for f in ctx.config["receivers_hz"]]
    stations = {int(s.carrier_hz): s for s in _stations(p)}
    if not set(stations) <= set(offsets):
        raise ValueError(f"stations at {sorted(stations)} Hz, receivers at "
                         f"{offsets}: every station needs its receiver")
    wire_dev = _capture(ctx, list(stations.values()), nb)
    wire = wire_dev.cpu().numpy()
    rx = Receiver(cfg, device=ctx.device)
    for _ in range(int(p["warmup_passes"])):
        demodulate_stations(rx, wire, offsets, scan=True)
    if ctx.trace:
        warm_up(ctx.device)
    setup_s = time.monotonic() - ctx.t_start

    kept = Reservoir(int(p["kept_passes"]), ctx.seed)
    prof, trace, tries = None, None, 0
    trace_from, trace_n = 2, int(p.get("trace_passes", 0))
    passes, failed, ends = 0, 0, []
    t0 = time.monotonic()
    while True:
        if ctx.trace and trace is None and passes == trace_from \
                and tries < MAX_TRACE_TRIES:
            prof = Profiler(ctx.device.type)
            prof.start()
            tries += 1
        with (record_function("demodulate_stations") if prof is not None
              else contextlib.nullcontext()):
            res = demodulate_stations(rx, wire, offsets, scan=True)
        failed += failed_blocks(res, offsets, nb, cfg.block_audio)
        kept.offer(passes, [r for r in res if r["offset_hz"] in stations])
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
    air_x = passes * nb * T / cfg.wire_rate / window_s
    attr = (attribution(rx, offsets, wire_dev, int(p["attribution_blocks"]),
                        ctx.device.type) if ctx.trace else None)

    def block(b):
        return wire[b * T:(b + 1) * T]
    runs = [ProgramRun(nb, r["audio"], r["rds_bits"], None, ctx.receiver,
                       stations[r["offset_hz"]], block, r["offset_hz"])
            for kept_pass in kept.items for r in kept_pass]
    state = {"rx": rx, "wire_dev": wire_dev}

    def free():
        state.clear()
        if cuda:
            torch.cuda.synchronize()

    return Run(metrics={"air_x": air_x, "setup_s": setup_s},
               attempted=passes * nb * len(offsets), failed=failed,
               runs=runs, free=free, trace=trace, attribution=attr,
               attribution_blocks=int(p["attribution_blocks"]),
               trace_blocks=trace_n * nb,
               stamps={"front_end_rows": np.asarray([len(offsets)])},
               notes={"passes": passes, "window_s": window_s,
                      "receivers": len(offsets),
                      "station_seconds_per_s": len(offsets) * air_x,
                      "pass_ms_p10_p50_p90_max": [
                          float(v) for v in np.percentile(
                              np.diff([t0] + ends) * 1e3, [10, 50, 90, 100])]})
