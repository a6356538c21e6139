#!/usr/bin/env python3
"""Smoke test of the PyTorch port (sdrjfm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi), torch's CUDA
             version, nvcc's version.  No CUDA: exit 1.
2. build   — builds every kernel of the main path from the sources in this
             checkout (one nvcc per CUDA source, all in parallel), prints
             the build seconds and each kernel's -Xptxas -v lines.
3. kernels — each kernel against its plain torch version on the card, at the
             main path's shapes, with the tolerance stated: the front end
             and the real scan; the complex pole bank (kernel A) also
             against the float64 recurrence, at the squelch's shapes and on
             ragged rows (T = 1, a last chunk of one sample, more than 32
             chunks a row, two calls back to back on the same look-back
             words); the RDS decoders 1-3 (kernels B1-B3) on chained
             segments of a clean baseband from a warmed-up state (B3's first
             with a resync), the FIR pre-pass stages of B1 and B2 and B3's
             lowpass outputs, history and clock phase chain bit for bit
             against their host functions.  The front end's row form (R
             rows in one launch) against frontend_rows_plain: 4 stations on
             one int16 block, 19 on one complex64 block, the band scan's
             19 x 4 rows on 4 blocks; each row of the 4-station launch and
             an R = 1 launch bit for bit equal to the one-station entry; an
             out-of-range block index gives that row NaN; one device kernel
             per call.
3b. graph  — the look-back kernels under CUDA-graph replay: two real-scan
             calls (R=2, R=1), one pole-bank call at the squelch's shapes
             and a 4-row front-end launch captured in one graph, replayed
             three times on new inputs, each replay against the plain
             versions.
4. main    — synthesises an 8 s stereo+RDS capture and drives it through
             `python -m sdrjfm_tpu_torch.app rx` (in process) on cuda at
             block_fm=131072 with the int16 wire: PI/PS/RT back at BER 0,
             pilot and PSS locked, 48 kHz stereo audio.  rx steps through
             the captured graph (Receiver.jit_step): the wrappers' launch
             counts over the run are the warm-up steps' and the capture's,
             and the device launches in a profiler trace of a second run
             are the warm-up steps' and one replay's a block.
5. reference — the same capture through the port on the CPU (the kernels'
             plain versions): audio, metadata and RDS bits agree.
5a. runners — every runner on the card against the eager rx.step loop on
             that capture: run_offline, run_offline_scanned (one chunk,
             chunks of 4, 2 and 1, and a 2-block capture), run_streaming
             (per block, chunks of 4), run_live over an unpaced
             NativeRawSource, and the scan runner with RDS decoders 1-3
             (audio within 1e-5, RDS bits equal, PI/PS/RT at BER 0); the
             launches under the graphs counted by kernel name from a
             profiler trace (the front end once a block, the real scan
             twice); then `rx` with --runner scan --chunk-blocks 4,
             --pcm-out and --follow --no-pace against phase main's CLI run,
             and that run against the eager loop.
5b. options — `rx` on cuda at block_fm=131072 once per receiver option
             (scan decoders 1-3, squelch nsq/lsq on the station and on a
             noise-only capture, the other discriminators, the deemphasis
             scan, the input filter, the reference front end, 192 kHz audio,
             the test tone, the taps and dumps, a raw u8 capture at 2.4
             MS/s, and 2.5 MS/s refused with exit 2): each run's checks,
             each kernel's launch count over the run (counts set to 0 just
             before it; a decoder call launches each of its stages once)
             and its device launches from a profiler trace, as in main,
             and its first two blocks of audio against the same
             run on the CPU; emit_audio_i16 against the host quantizer;
             `rx --afc` on a capture with a 1500 Hz residual offset pulls
             in (the offsets replayed from its --log-meta); `rx --spectra`
             offline (two taps) and under --follow writes its keys.
5c. multistation — an 8 s capture of four stations (-600/-200/+300/+700
             kHz, each its own PI, PS and tones) through
             demodulate_stations (the n-station step: one front-end launch
             and one batched fm chain for every station, as a CUDA graph
             replayed over the capture): each station within 1e-5 of its
             own single-station run_offline on the card, RDS bits equal,
             PI/PS at BER 0, pilot locked; scan=False against scan=True;
             the wrappers' counts over the run and, under the graph
             (profiler), one front-end and two scan launches a block for
             all the stations; the nsq config (one pole-bank launch a
             block) and the input filter (the split front end's rows) at
             n = 4 against their single-station runs the same way; the
             same capture with the station axis on a mesh (every card, or
             one card named twice) against the unsharded run; then for n
             = 1, 4 and 19 (every raster channel of the +-900 kHz window)
             device ms per step, device events per step (n = 19 within 10
             % of n = 1), wall ms per block (median and spread of 7), host
             us per replay(), capture seconds and station-seconds of air
             per second.
5d. scan   — `python -m sdrjfm_tpu_torch.app scan --identify --stations`
             on that capture on the card: exactly the four offsets, each
             named, the station list written, the hits equal to the CPU
             run's; BandScanner.decide's device time at 19 x 4 rows beside
             76 one-row scans.
5e. sources — every live hardware source through `rx` on the card at
             block_fm=131072 (airspy at 147456, the width nearest it that
             2.5 MS/s tiles and the RDS block decoder's phase sub-block
             divides), each streaming the 8 s capture once at 8x real
             time: rtl_tcp over an in-script server (header, u8
             frames, a record of every command) with --tune-hz --gain
             --ppm --meter, and rtlsdr (u8), hackrf (i8), sdrplay (i16) and
             airspy (i16 at 2.5 MS/s) on the fake vendor libraries
             (tests/fake_lib*.c built with cc).  Each decodes PI/PS/RT at
             BER 0 with no drop; the wrappers count the warm-up steps and
             the capture; a profiler trace of each run holds one front-end
             launch a block (airspy's after the rate map); the server saw
             the rate, ppm, gain mode, gain and frequency commands.
5f. control — a command script (tune from the -600 kHz station to the
             +300 kHz one, volume, mute and unmute, sound, squelch, status,
             iqbalance, quit) through CommandProcessor.apply as run_live's
             hook over the four-station capture, on the card and on the
             CPU: audio within 1e-3, the same responses, the PI flipping
             at BER 0, retune_reset fired once; the host us of an idle, a
             dirty and a retuning apply (CUDA's sync debug mode raising);
             then `rx --follow --control <socket>` over the rtl_tcp server,
             `tune` outside the window and back: two frequency commands,
             control.hw_retunes 2.
5g. checkpoint — `rx --ckpt-dir --ckpt-every 4 --ckpt-keep 2` leaves steps
             4 and 8; `rx --load-state` on the capture from block 8 on
             within 1e-5 of the uninterrupted run (RDS bits equal through
             the runners), the card's checkpoint resumed on the CPU within
             1e-3, another config's load exits 2 with the fingerprint
             message, `rx --profile` writes a trace with one front-end
             launch a block; the ms of a save and the loop runner's ms per
             block with and without a save every block.
5h. sharded — the sharded receivers with ranks on the card(s), each rank a
             spawned process (gloo with host-staged collectives when ranks
             share a card, NCCL with a card a rank): ShardedReceiver at 2
             ranks (its front end and DC servo bit for bit the
             single-device front end's, its audio within 1e-5 of the eager
             step), FullyShardedReceiver at 2 and 4 ranks (2e-4) and on
             the heavy config at 2 (5e-4), StationTimeShardedReceiver 2 x 2
             on the four stations of the four-station capture, two a group
             as one batched step (5e-4; 5 gathers and 8 halos a step); the
             RDS
             bit counts equal, the bits equal from the second block on,
             PI/PS(/RT) at BER 0, at most 5 gathers and 8 halos a step on
             the main config, every rank's device kernels of a step by
             name from a profiler trace; NCCL where there are as many
             cards as ranks, else a line saying why not; then
             multihost_worker, two processes against one of two ranks.
             Each line names the transport, the cards and the ranks a
             card; its step and collective ms are not scaling figures
             when ranks share a card.
6. times   — per-block step time and real-time factor (the main path, the
             heaviest option config: input filter + nsq + scan2, and the
             main path with RDS decoder 3); each
             kernel's
             device time (its calls queued behind a device sleep, so the
             host cannot set the pace) and host time per wrapper call, its
             plain version's time, a one-call library yardstick where one
             exists (timed the same way), and the bound from bytes and
             operations; each decoder's stages one line each, kernel A's
             launch on its own; the latencies of dependent f32 add,
             multiply, IEEE division, sincosf, hypotf and decoder 3's clock
             phase step on one thread (a microkernel timed by clock64), and
             from them, on a line of its own, each sequential stage's
             latency floor beside its time.
7. profile — torch.profiler over 5 steady steps: the device's busy share
             of the wall time, device ops per step, the top ops by device
             time; for the main path, for the heaviest option config and
             for the main path with RDS decoder 3 (each after its step
             time).
8. scanned — for the same three configs, run_offline_scanned over the
             capture, 7 passes after the capturing one: wall ms per block
             (median, spread), its real-time factor, the same for
             run_offline (rx's default loop runner), the host's time per
             replay(), capture and instantiate seconds, device time per
             step and busy share (profiler), beside the eager step time.
   The row form's times at R = 4, 19 and 76 (and 76 one-row launches)
             follow phase times; its line in the kernels JSON is
             `frontend_rows`, its launches from the multistation run.

Then one line {"kernels": [...]}, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}.  Outputs go to
chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# NVIDIA H100 SXM data sheet: HBM rate and the
# FP32 rate outside the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

BLOCK_FM = 131072
SOURCES = ("frontend.cu", "linrec.cu", "rds_scan.cu")   # every kernel
FE_ATOL, FE_RTOL = 2e-5, 1e-5      # f32 FIR of 307 taps summed in another
                                   # order + sincosf vs torch sin/cos ulps
SCAN_RTOL = 1e-5                   # of max|y|: two f32 scans over 131072
                                   # steps, associated differently, each
                                   # ~1e-6 of the scale off float64
SCAN_F64_RTOL = 2e-6               # of max|y|: the kernel vs the float64
                                   # recurrence on the host
POLE_RTOL = 1e-6                   # of max_n sum_p |r_p||w_p[n]| (the sum's
                                   # terms cancel: the residues reach ~170),
                                   # kernel vs plain and vs float64; both sit
                                   # near 1e-7 of it
RDS_IQ_ATOL = 1e-4                 # constellation points O(1-10) after f32
                                   # Costas loops whose sin/cos come from two
                                   # libraries; bits and emit counts must be
                                   # equal
OPT_AUDIO_ATOL = 1e-3              # cuda vs cpu audio of an option run (as
                                   # phase reference; the wav is PCM16)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def need(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


PROFILE_TRIES = 3                  # traces of one call before an empty one
                                   # fails the run


def _traced(fn):
    """(fn(), wall seconds of the traced call, the device events of its
    torch.profiler trace).  A trace holding no device event at all recorded
    nothing: the profiler's collection dropped the window (seen on an H100
    for a one-launch window after an earlier trace in the process), not a
    call that launched nothing.  Such a call is traced again, PROFILE_TRIES
    times at most, and the run fails if every trace comes back empty; the
    checks read the first trace that holds device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            ret = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count > 0]
        if ev:
            return ret, wall, ev
        print("chip_smoke: a profiler trace came back with no device "
              "event; tracing the call again", file=sys.stderr, flush=True)
    need(False, f"{PROFILE_TRIES} profiler traces in a row held no device "
         f"event")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def paced_ms(fn, reps: int = 5, iters: int = 20) -> float:
    """Median over `reps` of the mean time of `iters` back-to-back calls
    between CUDA events.  The host sets the pace when a call costs it more
    than the card: use only for functions that synchronise with the host
    (the plain versions copy constants from it)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


_SLEEP_CYCLES_PER_MS = None
SLEEP_RETRIES = 4                  # reps a device_ms call may run again


def _sleep_cycles_per_ms() -> float:
    """Rate of torch.cuda._sleep on this card, from one timed sleep."""
    global _SLEEP_CYCLES_PER_MS
    if _SLEEP_CYCLES_PER_MS is None:
        cycles = 20_000_000
        torch.cuda._sleep(cycles // 10)                    # warm up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS = cycles / a.elapsed_time(b)
    return _SLEEP_CYCLES_PER_MS


def device_ms(fn, what: str, reps: int = 5, iters: int = 20):
    """(device ms per call, host us per call) of `fn`, which must not
    synchronise with the host.

    Each rep enqueues a device-side sleep and then `iters` calls; CUDA
    events around the calls time the card alone, because the host has
    queued every call before the sleep ends.  A rep whose enqueue took the
    host longer than the sleep lasted (measured from before the sleep was
    enqueued, so the bound is strict) is dropped and run again with a sleep
    twice as long; the run fails after SLEEP_RETRIES such reps."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int((3.0 * host_ms + 1.0) * _sleep_cycles_per_ms())
    dev, host, retries = [], [], 0
    while len(dev) < reps:
        s = torch.cuda.Event(enable_timing=True)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        h1 = time.perf_counter()
        for _ in range(iters):
            fn()
        h2 = time.perf_counter()
        b.record()
        torch.cuda.synchronize()
        window = s.elapsed_time(a)
        if (h2 - h0) * 1e3 >= window:
            retries += 1
            need(retries <= SLEEP_RETRIES,
                 f"{what}: host enqueue {(h2 - h0) * 1e3:.3f} ms outlasted "
                 f"the {window:.3f} ms device sleep it must hide behind")
            cycles *= 2
            continue
        dev.append(a.elapsed_time(b) / iters)
        host.append((h2 - h1) / iters * 1e6)
    return statistics.median(dev), statistics.median(host)


def phase_device():
    from sdrjfm_tpu_torch.kernels.build import nvcc_path

    line = card_line()
    print(line, flush=True)
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True).stdout
    rel = [ln for ln in nvcc.splitlines() if "release" in ln]
    emit({"phase": "device", "card": line,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda,
          "nvcc": rel[0].strip() if rel else None})
    return line


def phase_build():
    """nvcc for every kernel source, all started together; prints each
    kernel's registers, shared memory and spills (-Xptxas -v)."""
    from sdrjfm_tpu_torch.kernels import build

    def timed(src):
        t0 = time.perf_counter()
        build.build(src)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        secs = dict(zip(SOURCES, ex.map(timed, SOURCES)))
    wall = time.perf_counter() - t0
    for src in SOURCES:
        for ln in build.ptxas_report(src).splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print(f"ptxas {src}: {ln.strip()}", flush=True)
    emit({"phase": "build", "nvcc_s": secs, "wall_s": wall})


def _fe_inputs(rng, fmt: str, T: int, dev):
    if fmt == "c64":
        x = (0.3 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
             ).astype(np.complex64)
    elif fmt == "i16":
        x = rng.integers(-20000, 20000, (T, 2)).astype(np.int16)
    elif fmt == "u8":
        x = rng.integers(0, 256, (T, 2)).astype(np.uint8)
    else:
        x = rng.integers(-128, 128, (T, 2)).astype(np.int8)
    return torch.from_numpy(x).to(dev)


def phase_kernels(rx):
    """Each kernel against its plain version at the main path's shapes."""
    from scipy.signal import lfilter
    from sdrjfm_tpu_torch import constants as C
    from sdrjfm_tpu_torch.kernels.frontend import frontend, frontend_plain
    from sdrjfm_tpu_torch.kernels.linrec import (KERNEL_CHUNK, linrec,
                                                 linrec_plain)

    dev = rx.device
    rng = np.random.default_rng(7)
    T = rx.cfg.block_in
    s = lambda v, dt: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
    fe_err = 0.0
    fe_rows = []

    def fe_blocks(fmt, lo, T, n0, dc_remove, offset=0, nblk=2):
        """`nblk` consecutive blocks, carries chained, kernel vs plain.
        `offset` > 0 hands the kernel a wire view that starts that many
        samples into its buffer (not 16-byte aligned)."""
        nonlocal fe_err
        carry = torch.zeros(306, dtype=torch.complex64, device=dev)
        carry_p = carry.clone()
        for blk in range(nblk):
            x = _fe_inputs(rng, fmt, T + offset, dev)[offset:]
            args = (s(0.9, torch.float32), s(1.1, torch.float32),
                    s(0.003 - 0.02j, torch.complex64), s(lo, torch.int32),
                    s(n0, torch.int32), dc_remove)
            y, nc, dm = frontend(x, fmt, carry, rx.k_decim12, *args)
            yp, ncp, dmp = frontend_plain(x, fmt, carry_p, rx.k_decim12,
                                          *args)
            torch.cuda.synchronize()
            err = (y - yp).abs()
            ok = bool((err <= FE_ATOL + FE_RTOL * yp.abs()).all())
            cerr = float((nc - ncp).abs().max())
            derr = float((dm - dmp).abs()) if dc_remove else None
            fe_err = max(fe_err, float(err.max()), cerr)
            fe_rows.append({"fmt": fmt, "lo": lo, "T": T, "block": blk,
                            "dc_remove": dc_remove, "offset": offset,
                            "max_abs_err": float(err.max()),
                            "max_rel_err": float((err / yp.abs().clamp(
                                min=1e-6)).max()),
                            "carry_err": cerr, "dc_err": derr})
            dc_ok = (derr <= 1e-6 if dc_remove
                     else dm is None and dmp is None)
            need(ok and cerr <= FE_ATOL and dc_ok,
                 f"frontend: {fe_rows[-1]}")
            carry, carry_p = nc, ncp
            n0 = (n0 + T) % C.INPUT_RATE

    # every wire format and both LO signs, two blocks each, the second
    # crossing the rate modulus; the DC mean finished in the kernel
    for fmt in ("c64", "i16", "u8", "i8"):
        for lo in (137_000, -250_000):
            fe_blocks(fmt, lo, T, C.INPUT_RATE - 1000, True)
    # the servo switched off: no DC correction, no subsample sums
    fe_blocks("i16", 137_000, T, 5, False, nblk=1)
    # a ragged last tile (1000 outputs = 512 + 488), with wire views that
    # start off the 16-byte grid
    fe_blocks("i16", -250_000, 12 * 1000, 12345, True, offset=1)
    fe_blocks("u8", 137_000, 12 * 1000, C.INPUT_RATE - 300, True, offset=3)
    fe_blocks("c64", 137_000, 12 * 1000, 0, True)
    # one launch per block: no reduction or division kernels beside it
    x = _fe_inputs(rng, "i16", T, dev)
    args = (s(0.9, torch.float32), s(1.1, torch.float32),
            s(0.003 - 0.02j, torch.complex64), s(137_000, torch.int32),
            s(5, torch.int32), True)
    z = torch.zeros(306, dtype=torch.complex64, device=dev)
    _, _, ev = _traced(lambda: frontend(x, "i16", z, rx.k_decim12, *args))
    fe_kernels = [e.key for e in ev]
    emit({"phase": "kernels", "kernel": "frontend", "atol": FE_ATOL,
          "rtol": FE_RTOL, "max_abs_err": fe_err,
          "device_kernels_per_call": fe_kernels, "cases": fe_rows})
    need(len(fe_kernels) == 1 and "frontend_kernel" in fe_kernels[0],
         f"frontend: one kernel per call, got {fe_kernels}")

    # scan: path-like drives (alpha x tracker input) for the three trackers
    n = rx.cfg.block_fm
    mag = 1.0 + 0.1 * rng.standard_normal(n)
    res = 0.3 * rng.standard_normal(n)
    pmag = 0.4 + 0.05 * rng.standard_normal(n)
    alphas = (C.CARRIER_ALPHA, C.FM_DC_ALPHA, C.PILOT_LOCK_ALPHA)
    drive = torch.from_numpy(np.stack([alphas[0] * mag, alphas[1] * res,
                                       alphas[2] * pmag]
                                      ).astype(np.float32)).to(dev)
    g = [1.0 - a for a in alphas]
    y0 = torch.tensor([0.9, -0.01, 0.3], dtype=torch.float32, device=dev)
    sc_err, sc_rows = 0.0, []

    def rand(R, T, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal((R, T))).astype(
            np.float32)).to(dev)

    # R=3, the path's R=2 and R=1, ragged and short rows, one chunk's
    # worth less one, four blocks' worth, and g = 1 (a plain sum)
    cases = [(drive[list(rows)].contiguous(), [g[r] for r in rows],
              y0[list(rows)].contiguous()) for rows in ((0, 1, 2), (0, 1), (2,))]
    cases += [(rand(2, 10_000), [0.9, 0.5], y0[:2].contiguous()),
              (rand(3, 1), g, y0),
              (rand(2, KERNEL_CHUNK * 2 - 1, 1e-2), g[1:], y0[1:].contiguous()),
              (rand(1, 4 * n, 1e-3), g[2:], y0[2:].contiguous()),
              (rand(3, n, 1e-3), [1.0, g[1], 0.5], y0)]
    # the n-station step's launches at S = 4 and 19: the demod pair as one
    # launch of R = 2S rows (S carrier rows, then S DC rows) and the pilot
    # metric as one of R = S rows, each row its own station's drive and
    # entry state
    for S in (4, 19):
        pair = np.concatenate([
            alphas[0] * (1.0 + 0.1 * rng.standard_normal((S, n))),
            alphas[1] * 0.3 * rng.standard_normal((S, n))])
        pilot = alphas[2] * (0.4 + 0.05 * rng.standard_normal((S, n)))
        for d, gg in ((pair, [g[0]] * S + [g[1]] * S), (pilot, [g[2]] * S)):
            cases.append((torch.from_numpy(d.astype(np.float32)).to(dev), gg,
                          torch.from_numpy(rng.uniform(-1.0, 1.0, len(gg))
                                           .astype(np.float32)).to(dev)))
    runs = [(d, gg, y00, *linrec(d, gg, y00)) for d, gg, y00 in cases]
    # two launches back to back on the same look-back words (no sync
    # between): the second must not read the first's published prefixes
    d_a, d_b = rand(2, n, 1e-2), rand(2, n, 1e-2)
    runs += [(d, g[:2], y0[:2].contiguous(), *linrec(d, g[:2],
                                                     y0[:2].contiguous()))
             for d in (d_a, d_b)]
    for d, gg, y00, y, last in runs:
        yp, lastp = linrec_plain(d, gg, y00)
        torch.cuda.synchronize()
        err = float(torch.maximum((y - yp).abs().max(),
                                  (last - lastp).abs().max()))
        scale = float(yp.abs().max())
        sc_err = max(sc_err, err)
        # both against the float64 recurrence on the host
        exact = np.stack([lfilter([1.0], [1.0, -np.float64(np.float32(gr))],
                                  dr, zi=[np.float64(np.float32(gr)) * v])[0]
                          for gr, dr, v in zip(
                              gg, d.cpu().double().numpy(),
                              y00.cpu().double().numpy())])
        k64 = float(np.abs(y.cpu().double().numpy() - exact).max())
        sc_rows.append({"rows": d.shape[0], "T": d.shape[1], "g": gg,
                        "chunks_per_row": -(-d.shape[1] // KERNEL_CHUNK),
                        "max_abs_err": err,
                        "max_rel_err": err / scale,
                        "kernel_vs_f64": k64,
                        "kernel_vs_f64_of_max": k64 / scale,
                        "plain_vs_f64": float(np.abs(
                            yp.cpu().double().numpy() - exact).max())})
        need(err <= SCAN_RTOL * scale and k64 <= SCAN_F64_RTOL * scale,
             f"linrec: {sc_rows[-1]}")
    need(-(-n // KERNEL_CHUNK) >= 16, "linrec: under 16 blocks per row")
    emit({"phase": "kernels", "kernel": "linrec", "rtol_of_max": SCAN_RTOL,
          "max_abs_err": sc_err, "cases": sc_rows})
    return fe_err, sc_err


# the row form of the front end at block_fm=131072: (what, wire format,
# offsets, blocks); row i * blocks + b runs offset i on block b
ROW_CASES = (("4 stations on one int16 block", "i16", 4, 1),
             ("19 stations on one complex64 block", "c64", 19, 1),
             ("19 offsets x 4 complex64 blocks (the band scan)", "c64", 19,
              4))


def _row_params(rng, R: int, dev):
    """Per-row carry, gains, DC state, LO and NCO phase of a row launch."""
    from sdrjfm_tpu_torch import constants as C
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa: E731
        dev, dt)
    carry = 0.3 * (rng.standard_normal((R, 306))
                   + 1j * rng.standard_normal((R, 306)))
    dc = 0.02 * (rng.standard_normal(R) + 1j * rng.standard_normal(R))
    return (t(carry.astype(np.complex64), torch.complex64),
            t(rng.uniform(0.5, 1.5, R).astype(np.float32), torch.float32),
            t(rng.uniform(0.5, 1.5, R).astype(np.float32), torch.float32),
            t(dc.astype(np.complex64), torch.complex64),
            t(rng.integers(-900_000, 900_001, R).astype(np.int32),
              torch.int32),
            t(rng.integers(0, C.INPUT_RATE, R).astype(np.int32),
              torch.int32))


def _rows_case(rng, fmt, n_off, nb, T, dev):
    """(wire [nb, ...], block_index, row parameters) of a row launch."""
    wire = torch.stack([_fe_inputs(rng, fmt, T, dev) for _ in range(nb)])
    bidx = torch.arange(nb, dtype=torch.int32, device=dev).repeat(n_off)
    return wire, bidx, _row_params(rng, n_off * nb, dev)


def phase_row_kernels(rx):
    """The front end over R rows in one launch against frontend_rows_plain
    (row by row) at block_fm=131072, within FE_ATOL / FE_RTOL: ROW_CASES;
    every row of the 4-station launch bit for bit equal to the one-station
    entry on that row's inputs; R = 1 bit for bit equal to the one-station
    entry; a row whose block index is out of range comes back NaN; one
    device kernel per call (profiler)."""
    from sdrjfm_tpu_torch.kernels.frontend import (frontend, frontend_rows,
                                                   frontend_rows_plain)
    dev = rx.device
    T = rx.cfg.block_in
    rng = np.random.default_rng(21)
    taps = rx.k_decim12
    rows, err_max = [], 0.0
    for what, fmt, n_off, nb in ROW_CASES:
        wire, bidx, p = _rows_case(rng, fmt, n_off, nb, T, dev)
        y, nc, dm = frontend_rows(wire, fmt, bidx, p[0], taps, *p[1:], True)
        yp, ncp, dmp = frontend_rows_plain(wire, fmt, bidx, p[0], taps,
                                           *p[1:], True)
        torch.cuda.synchronize()
        err = (y - yp).abs()
        cerr = float((nc - ncp).abs().max())
        derr = float((dm - dmp).abs().max())
        ok = bool((err <= FE_ATOL + FE_RTOL * yp.abs()).all())
        err_max = max(err_max, float(err.max()), cerr)
        row = {"case": what, "rows": n_off * nb, "blocks": nb, "fmt": fmt,
               "max_abs_err": float(err.max()), "carry_err": cerr,
               "dc_err": derr}
        if n_off == 4:
            # each row == the one-station entry on that row's inputs
            same = True
            for r in range(n_off * nb):
                ys, cs, ds = frontend(wire[int(bidx[r])], fmt, p[0][r], taps,
                                      *(q[r] for q in p[1:]), True)
                same &= bool(torch.equal(ys, y[r]) and torch.equal(cs, nc[r])
                             and torch.equal(ds, dm[r]))
            row["rows_equal_one_station_bit_for_bit"] = same
            ok &= same
        rows.append(row)
        need(ok and cerr <= FE_ATOL and derr <= 1e-6,
             f"frontend rows: {row}")
    # R = 1 through the row entry == the one-station entry, bit for bit
    wire, bidx, p = _rows_case(rng, "i16", 1, 1, T, dev)
    y1, c1, d1 = frontend_rows(wire, "i16", bidx, p[0], taps, *p[1:], True)
    ys, cs, ds = frontend(wire[0], "i16", p[0][0], taps,
                          *(q[0] for q in p[1:]), True)
    r1 = bool(torch.equal(y1[0], ys) and torch.equal(c1[0], cs)
              and torch.equal(d1[0], ds))
    # a block index past the wire: that row NaN, the others untouched
    bad = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    p2 = tuple(q[:1].repeat(2, *([1] * (q.dim() - 1))).contiguous()
               for q in p)
    yb, cb, db = frontend_rows(wire, "i16", bad, p2[0], taps, *p2[1:], True)
    nan_ok = bool(torch.isnan(yb[1]).all() and torch.isnan(cb[1]).all()
                  and torch.isnan(db[1]) and torch.equal(yb[0], ys))
    # one device kernel for the 76-row call
    wire, bidx, p = _rows_case(rng, "c64", 19, 4, T, dev)
    _, _, ev = _traced(lambda: frontend_rows(wire, "c64", bidx, p[0], taps,
                                             *p[1:], True))
    ks = [e.key for e in ev]
    emit({"phase": "kernels", "kernel": "frontend_rows", "atol": FE_ATOL,
          "rtol": FE_RTOL, "max_abs_err": err_max, "cases": rows,
          "r1_equals_one_station_bit_for_bit": r1,
          "out_of_range_row_nan": nan_ok,
          "device_kernels_per_76_row_call": ks})
    need(r1, "frontend rows: R = 1 differs from the one-station entry")
    need(nan_ok, "frontend rows: an out-of-range block index")
    need(len(ks) == 1 and "frontend_kernel" in ks[0],
         f"frontend rows: one kernel per call, got {ks}")
    return err_max


def phase_main():
    from sdrjfm_tpu_torch import app
    from sdrjfm_tpu_torch.io.wavio import read_wav
    from sdrjfm_tpu_torch.kernels.frontend import frontend
    from sdrjfm_tpu_torch.kernels.linrec import linrec

    OUT.mkdir(parents=True, exist_ok=True)
    wav, audio, report = OUT / "iq.wav", OUT / "audio.wav", OUT / "report.json"
    t0 = time.perf_counter()
    rc = app.main(["synth", "--out", str(wav), "--seconds", "8",
                   "--station", "TPU FM", "--radiotext", "VERIFY RUN",
                   "--pi", "0x10F0", "--pty", "10", "--int16"])
    need(rc == 0, "synth")
    synth_s = time.perf_counter() - t0
    from sdrjfm_tpu_torch.runtime.graph import WARMUP_STEPS
    frontend.launches = 0
    linrec.launches = 0
    argv = ["rx", "--iq", str(wav), "--audio", str(audio), "--rds",
            "--report", str(report), "--block-fm", str(BLOCK_FM),
            "--iq-format", "i16", "--device", "cuda"]
    t0 = time.perf_counter()
    rc = app.main(argv)
    rx_s = time.perf_counter() - t0
    launches = {"frontend": frontend.launches, "linrec": linrec.launches}
    need(rc == 0, f"rx exited {rc}")
    # the same run again under the profiler, for the device's launches
    rc, device = _device_launches(lambda: app.main(argv))
    need(rc == 0, f"rx (profiled) exited {rc}")
    rep = json.loads(report.read_text())
    blocks = rep["blocks"]
    rds, meta = rep["rds"], rep["meta_last"]
    x, info = read_wav(str(audio))
    rms = float(np.sqrt(np.mean(np.asarray(x, np.float64) ** 2)))
    result = {"phase": "main", "blocks": blocks, "launches": launches,
              "device_launches": device, "warmup_steps": WARMUP_STEPS,
              "synth_s": synth_s, "rx_s": rx_s,
              "throughput_x_realtime": rep["throughput_x_realtime"],
              "pi": rds["pi_code"], "ps": rds["station_label"],
              "rt": rds["radio_text"], "ber": rds["bit_error_rate"],
              "groups": rds["groups_decoded"],
              "pilot_locked": meta["pilot_locked"],
              "pss_established": meta["pss_established"],
              "audio_shape": list(x.shape), "audio_rate": info.rate,
              "audio_rms": rms}
    emit(result)
    # rx steps through the captured graph: the wrappers count the warm-up
    # steps' launches and the capture; the profiler sees the warm-up
    # launches and every replay's
    steps = WARMUP_STEPS + 1
    need(blocks > 0 and launches == {"frontend": steps, "linrec": 2 * steps},
         f"wrapper launches {launches}, want {steps} front ends and "
         f"{2 * steps} scans (warm-up steps and capture)")
    runs = blocks + WARMUP_STEPS
    need(device["frontend"] == runs and device["linrec"] == 2 * runs,
         f"device launches {device}, want {runs} front ends and {2 * runs} "
         f"scans (warm-up steps and one replay a block)")
    need(rds["pi_code"] == "0x10F0" and rds["station_label"].strip() == "TPU FM"
         and rds["radio_text"] == "VERIFY RUN", "RDS PI/PS/RT")
    need(rds["bit_error_rate"] == 0.0, "RDS BER")
    need(meta["pilot_locked"] and meta["pss_established"], "pilot/PSS lock")
    need(info.rate == 48000 and x.ndim == 2 and x.shape[1] == 2
         and np.isfinite(x).all() and 0.1 < rms < 1.0, "audio")
    return wav, launches


def phase_reference(wav):
    """The capture through the port on cuda and on the CPU, block by block."""
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig

    iq, _ = read_iq_wav_raw(str(wav))
    cfg = ReceiverConfig(block_fm=BLOCK_FM, rds="block", audio_filter_hz=15000,
                         iq_format="i16")
    rxs = {d: Receiver(cfg, device=d) for d in ("cuda", "cpu")}
    st = {d: r.init_state() for d, r in rxs.items()}
    ctl = {d: r.initial_controls() for d, r in rxs.items()}
    T = cfg.block_in
    a_err, m_err, diffs = 0.0, 0.0, []
    nblk = len(iq) // T
    locked_before, prev_locked = [], False
    for b in range(nblk):
        blk = torch.from_numpy(np.array(iq[b * T:(b + 1) * T]))
        outs = {}
        for d, r in rxs.items():
            st[d], outs[d] = r.step(st[d], ctl[d], blk.to(d))
        g, c = outs["cuda"], outs["cpu"]
        a_err = max(a_err, float((g.audio.cpu() - c.audio).abs().max()))
        m_err = max(m_err, float((g.meta_vec.cpu() - c.meta_vec).abs().max()))
        n = int(c.rds.count)
        need(int(g.rds.count) == n, f"block {b}: RDS bit counts differ")
        diffs.append(int((g.rds.bits[:n].cpu() != c.rds.bits[:n]).sum()))
        locked_before.append(prev_locked)
        prev_locked = bool(c.meta.pilot_locked)
    # before the pilot locks the RDS mixer's phase is noise and marginal
    # symbols may flip on f32 rounding; once locked, every bit must agree
    locked_diffs = sum(d for d, lk in zip(diffs, locked_before) if lk)
    emit({"phase": "reference", "blocks": nblk, "audio_max_abs_err": a_err,
          "meta_vec_max_abs_err": m_err, "rds_bit_diffs_per_block": diffs,
          "locked_blocks": sum(locked_before),
          "rds_bit_diffs_after_lock": locked_diffs, "audio_atol": 1e-3})
    need(a_err <= 1e-3 and locked_diffs == 0 and sum(locked_before) >= 8,
         "cuda vs cpu reference")


def phase_times(rx, wav, fe_err, sc_err, launches, card):
    """Step time and per-kernel times at the main path's shapes."""
    from sdrjfm_tpu_torch import constants as C
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw
    from sdrjfm_tpu_torch.kernels.frontend import (HALO, NTAPS, frontend,
                                                   frontend_plain)
    from sdrjfm_tpu_torch.kernels.linrec import linrec, linrec_plain
    import torch.nn.functional as F

    dev = rx.device
    cfg = rx.cfg
    T, M = cfg.block_in, cfg.block_fm
    iq, _ = read_iq_wav_raw(str(wav))
    nblk = len(iq) // T
    blocks = [torch.from_numpy(np.array(iq[b * T:(b + 1) * T])).to(dev)
              for b in range(nblk)]
    # per-block step, state chained over the capture's blocks
    state, ctl = rx.init_state(), rx.initial_controls()
    for b in range(3):
        state, _ = rx.step(state, ctl, blocks[b])
    torch.cuda.synchronize()
    steps, walls = [], []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        a.record()
        for blk in blocks:
            state, out = rx.step(state, ctl, blk)
        e.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - w0) / nblk * 1e3)
        steps.append(a.elapsed_time(e) / nblk)
    step_ms = statistics.median(steps)
    block_s = T / C.INPUT_RATE
    emit({"phase": "times", "what": "step", "block_fm": M,
          "step_ms": step_ms, "step_ms_all": steps,
          "host_wall_ms": statistics.median(walls),
          "fm_stereo_rds_realtime_x": block_s / (step_ms / 1e3),
          "card": card})

    # front end, int16 wire: rotate 10 inputs (63 MB > the 50 MB L2)
    rng = np.random.default_rng(3)
    xs = [_fe_inputs(rng, "i16", T, dev) for _ in range(10)]
    carry = torch.zeros(HALO, dtype=torch.complex64, device=dev)
    sc = lambda v, dt: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
    args = (sc(0.9, torch.float32), sc(1.1, torch.float32),
            sc(0.003 - 0.02j, torch.complex64), sc(137_000, torch.int32),
            sc(12345, torch.int32), True)
    it = iter(range(10 ** 9))
    fe_ms, fe_host_us = device_ms(
        lambda: frontend(xs[next(it) % 10], "i16", carry, rx.k_decim12,
                         *args), "frontend")
    fe_plain_ms = paced_ms(lambda: frontend_plain(xs[next(it) % 10], "i16",
                                                  carry, rx.k_decim12, *args))
    # yardstick: one conv1d (stride 12, TF32 off) on pre-mixed planes,
    # rotated over 8 x 12.6 MB so that the L2 is cold as well
    planes = [torch.randn(2, 1, T + NTAPS - 12, device=dev)
              for _ in range(8)]
    wk = rx.k_decim12.flip(0)[None, None, :].contiguous()
    fe_lib_ms, fe_lib_host_us = device_ms(
        lambda: F.conv1d(planes[next(it) % 8], wk, stride=12), "conv1d")
    fe_bytes = T * 4 + M * 8 + 2 * HALO * 8 + NTAPS * 4
    fe_flops = 4 * NTAPS * M + 10 * T   # FIR (complex x real taps) + mix
    fe_bound = max(fe_bytes / HBM_BYTES_PER_S, fe_flops / FP32_FLOP_PER_S)
    fe_by = ("bytes" if fe_bytes / HBM_BYTES_PER_S
             >= fe_flops / FP32_FLOP_PER_S else "operations")

    # scan: the path's two launches per block ([2, M] then [1, M])
    d2 = torch.rand(2, M, device=dev) * 1e-3
    d1 = torch.rand(1, M, device=dev) * 1e-3
    g2, g1 = [1 - C.CARRIER_ALPHA, 1 - C.FM_DC_ALPHA], [1 - C.PILOT_LOCK_ALPHA]
    y02, y01 = torch.zeros(2, device=dev), torch.zeros(1, device=dev)
    sc2_ms, sc2_host_us = device_ms(lambda: linrec(d2, g2, y02), "linrec R=2")
    sc1_ms, sc1_host_us = device_ms(lambda: linrec(d1, g1, y01), "linrec R=1")
    sc_ms = sc2_ms + sc1_ms
    sc_plain_ms = paced_ms(lambda: (linrec_plain(d2, g2, y02),
                                    linrec_plain(d1, g1, y01)), iters=5)
    sc_bytes = 3 * M * 8 + 3 * 12
    sc_flops = 3 * M * 2
    sc_bound = max(sc_bytes / HBM_BYTES_PER_S, sc_flops / FP32_FLOP_PER_S)
    sc_by = ("bytes" if sc_bytes / HBM_BYTES_PER_S
             >= sc_flops / FP32_FLOP_PER_S else "operations")
    # the n-station step's demod pair: one launch of R = 2S rows for S
    # stations (S = 4, 19; held against the plain version in
    # phase_kernels), drives rotated past the L2
    by_rows = {}
    for n_st in (4, 19):
        R = 2 * n_st
        ds = [torch.rand(R, M, device=dev) * 1e-3 for _ in range(3)]
        gR, y0R = g2 * n_st, torch.zeros(R, device=dev)
        ms_r, host_r = device_ms(lambda: linrec(ds[next(it) % 3], gR, y0R),
                                 f"linrec R={R}")
        nb_r, fl_r = R * M * 8 + R * 12, R * M * 2
        by_rows[f"R={R}"] = {
            "stations": n_st, "ms": ms_r, "host_us_per_call": host_r,
            "bound_ms": max(nb_r / HBM_BYTES_PER_S,
                            fl_r / FP32_FLOP_PER_S) * 1e3,
            "bound_by": ("bytes" if nb_r / HBM_BYTES_PER_S
                         >= fl_r / FP32_FLOP_PER_S else "operations")}
    emit({"phase": "times", "what": "linrec rows", "card": card,
          "rows": by_rows})
    kernels = [
        {"name": "frontend", "route": "cuda",
         "source": "sdrjfm_tpu_torch/csrc/frontend.cu",
         "replaces": "sdrjfm_tpu/ops/pallas_frontend.py:71",
         "launches": launches["frontend"], "max_abs_err": fe_err,
         "ms": fe_ms, "plain_ms": fe_plain_ms, "bound_ms": fe_bound * 1e3,
         "bound_by": fe_by, "library_ms": fe_lib_ms,
         "host_us_per_call": fe_host_us,
         "library_host_us_per_call": fe_lib_host_us,
         "shape": f"int16 [{T},2] -> complex64 [{M}] per block"},
        {"name": "linrec", "route": "cuda",
         "source": "sdrjfm_tpu_torch/csrc/linrec.cu",
         "replaces": "sdrjfm_tpu/ops/blockops.py:282",
         "launches": launches["linrec"], "max_abs_err": sc_err,
         "ms": sc_ms, "plain_ms": sc_plain_ms, "bound_ms": sc_bound * 1e3,
         "bound_by": sc_by, "library_ms": None,
         "ms_per_launch": {"R=2": sc2_ms, "R=1": sc1_ms},
         "ms_by_rows": {k: v["ms"] for k, v in by_rows.items()},
         "bound_ms_by_rows": {k: v["bound_ms"] for k, v in by_rows.items()},
         "host_us_per_call": (sc2_host_us + sc1_host_us) / 2,
         "shape": f"per block: one [2,{M}] and one [1,{M}] float32 launch"},
    ]
    emit({"phase": "times", "what": "kernels", "card": card,
          "kernels": kernels})
    return kernels, step_ms


# substrings of the hand kernels' names in a profile (csrc/*.cu)
HAND_KERNELS = ("frontend", "linrec", "pole_", "costas_", "fir_kernel",
                "poles_emit", "mm_core", "clock_kernel")


def phase_profile(rx, wav, card, what: str = "main path"):
    """torch.profiler over a steady window of steps: the device's busy
    share of the wall time and the ops that take the device time."""
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw

    T = rx.cfg.block_in
    iq, _ = read_iq_wav_raw(str(wav))
    blocks = [torch.from_numpy(np.array(iq[b * T:(b + 1) * T])).to(rx.device)
              for b in range(6)]
    state, ctl = rx.init_state(), rx.initial_controls()
    state, _ = rx.step(state, ctl, blocks[0])

    def steps():
        nonlocal state
        for blk in blocks[1:]:
            state, _ = rx.step(state, ctl, blk)

    _, wall, ev = _traced(steps)
    nstep = len(blocks) - 1
    # device-side events only (kernels, memcpy/memset): the CPU-side op
    # events carry the same device time again
    rows = [(e.self_device_time_total, e.key, e.count) for e in ev
            if e.self_device_time_total > 0]
    rows.sort(reverse=True)
    dev_total_us = sum(r[0] for r in rows)
    launches = sum(r[2] for r in rows)
    emit({"phase": "profile", "what": what, "steps": nstep, "card": card,
          "wall_ms_per_step": wall / nstep * 1e3,
          "device_ms_per_step": (dev_total_us / nstep / 1e3
                                 if rows else "not measured"),
          "device_busy_share": (dev_total_us / 1e6 / wall
                                if rows else "not measured"),
          "device_events_per_step": launches / nstep,
          # the hand kernels' own device time inside a real step
          "hand_kernels": [{"op": k[:80], "us_per_call": us / c,
                            "calls_per_step": c / nstep}
                           for us, k, c in rows
                           if any(n in k for n in HAND_KERNELS)],
          "top_device_ops": [{"op": k[:80], "us_per_step": us / nstep,
                              "calls_per_step": c / nstep}
                             for us, k, c in rows[:12]]})



def _squelch_specs():
    from sdrjfm_tpu_torch.ops.squelch import make_squelch_config
    sq = make_squelch_config()
    return [sq.hp, sq.lp]


def _rds_baseband(seconds: float, seed: int = 4):
    """A clean RDS baseband at 24 kS/s with a constant rotation and a
    little noise (the scan decoders' input z24)."""
    from sdrjfm_tpu_torch import constants as C
    from sdrjfm_tpu_torch.io.synth import rds_baseband
    from sdrjfm_tpu_torch.rds import encode
    syms = encode.differential_encode(encode.make_bitstream(
        pi=0x1234, station="SCANDEC ", repeats=6))
    n = int(seconds * C.RDS_RATE)
    rng = np.random.default_rng(seed)
    z = rds_baseband(syms, n, C.RDS_RATE) * np.exp(1j * 0.4)
    z = z + 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return torch.from_numpy(z.astype(np.complex64))


def _to(state, dev):
    if isinstance(state, tuple):
        return type(state)(*(_to(v, dev) for v in state))
    return state.to(dev)


def _pole_f64(spec, x, w0):
    """One bank's output as float64 recurrences on the host, and its scale
    max_n sum_p |r_p||w_p[n]| (the tolerances' unit: the terms cancel)."""
    from scipy.signal import lfilter
    g = spec.poles.astype(np.complex128)
    xd = x.double().cpu().numpy().astype(np.complex128)
    w0d = w0.cpu().numpy().astype(np.complex128)
    ws = np.stack([lfilter([1.0], [1.0, -gp], xd, zi=[gp * w0d[p]])[0]
                   for p, gp in enumerate(g)])
    ref = np.real((spec.residues.astype(np.complex128)[:, None] * ws).sum(0))
    scale = float((np.abs(spec.residues)[:, None] * np.abs(ws)).sum(0).max())
    return ref, scale


def phase_option_kernels(dev="cuda"):
    """Kernel A against its plain version and the float64 recurrence;
    kernels B1-B3 against their plain versions on chained segments."""
    from sdrjfm_tpu_torch.kernels.linrec import (POLE_CHUNK, POLE_LOOK,
                                                 fold_bank, pole_bank,
                                                 pole_bank_constants,
                                                 pole_bank_plain)
    from sdrjfm_tpu_torch.rds import scan_decoders as SD
    from sdrjfm_tpu_torch.rds.bitrecovery import bit_capacity

    rng = np.random.default_rng(8)
    specs = _squelch_specs()
    rows, a_err = [], 0.0
    # the squelch's shapes (2 banks x 10 poles x 131072), the n-station
    # step's (the 2 banks folded for 4 stations: B = 8, each row its own
    # drive and state), then ragged rows: one bank, a last chunk of one
    # sample (after one chunk, and after more than POLE_LOOK: the
    # look-back's second step), under one chunk, one sample
    cases = ((BLOCK_FM, specs, 1), (BLOCK_FM, specs, 4),
             (BLOCK_FM, specs[1:], 1), (POLE_CHUNK + 1, specs, 1),
             ((POLE_LOOK + 8) * POLE_CHUNK + 1, specs, 1),
             (1000, specs[:1], 1), (1, specs, 1), (BLOCK_FM, specs, 1))
    for case, (T, base, fold) in enumerate(cases):
        banks = list(base) * fold
        x = torch.from_numpy((0.3 * rng.standard_normal((len(banks), T))
                              ).astype(np.float32)).to(dev)
        w0 = torch.from_numpy((0.05 * (rng.standard_normal((len(banks), 10))
                                       + 1j * rng.standard_normal(
                                           (len(banks), 10)))
                               ).astype(np.complex64)).to(dev)
        bank = fold_bank(pole_bank_constants(base, dev), fold)
        y, wT = pole_bank(x, bank, w0)
        if case == len(cases) - 1:
            # a second call queued right behind the first on the same
            # look-back words: it must not read the first's prefixes
            y_first, wT_first = y, wT
            x1 = x.flip(1).contiguous()
            y, wT = pole_bank(x1, bank, w0)
            yp1, wTp1 = pole_bank_plain(x, bank.poles, bank.residues,
                                        w0)
            x = x1
        yp, wTp = pole_bank_plain(x, bank.poles, bank.residues,
                                  w0)
        torch.cuda.synchronize()
        row = {"banks": len(banks), "folded": fold, "poles": 10, "T": T,
               "max_abs_err": float((y - yp).abs().max()),
               "state_err": float((wT - wTp).abs().max())}
        for b, spec in enumerate(banks):
            ref, scale = _pole_f64(spec, x[b], w0[b])
            k64 = float(np.abs(y[b].cpu().numpy() - ref).max()) / scale
            kp = float((y[b] - yp[b]).abs().max()) / scale
            row[f"bank{b}_scale"] = scale
            row[f"bank{b}_kernel_vs_f64_of_scale"] = k64
            row[f"bank{b}_kernel_vs_plain_of_scale"] = kp
            need(k64 <= POLE_RTOL and kp <= POLE_RTOL, f"pole_bank: {row}")
        # the end states, each within 10 POLE_RTOL of the largest
        need(row["state_err"] <= 10 * POLE_RTOL * float(wTp.abs().max()),
             f"pole_bank state: {row}")
        if case == len(cases) - 1:
            first = float((y_first - yp1).abs().max())
            row["back_to_back_first_call_err"] = first
            need(first <= POLE_RTOL * row["bank0_scale"]
                 and float((wT_first - wTp1).abs().max())
                 <= 10 * POLE_RTOL * float(wTp1.abs().max()),
                 f"pole_bank back to back: {row}")
        a_err = max(a_err, row["max_abs_err"])
        rows.append(row)
    emit({"phase": "kernels", "kernel": "pole_bank", "rtol_of_scale": POLE_RTOL,
          "max_abs_err": a_err, "cases": rows})

    # B1-B3: warm up in the plain version on the CPU, hand the same state
    # to the kernel and to the plain version on the card, then chained
    # segments, the last of them a full block (16384 samples)
    z = _rds_baseband(2.0)
    b_err = {}
    for kind, (mk, zero, fn) in SD.DECODERS.items():
        cfg = mk()
        consts = SD.kernel_constants(kind, cfg, dev)
        st = fn(z[:4800], cfg, zero(cfg), 300)[4]          # cpu: plain
        if kind == "scan3":                 # the first segment resyncs
            st = st._replace(need_resync=torch.tensor(True))
        st_k = st_p = _to(st, dev)
        segs, err = [], 0.0
        for lo, hi in ((4800, 6800), (6800, 8800), (8800, 8800 + 16384)):
            seg = z[lo:hi].to(dev)
            cap = bit_capacity(hi - lo)
            st_prev = st_k
            bk, ck, qk, ik, st_k = fn(seg, cfg, st_k, cap, True, consts)
            bp, cp, qp, ip, st_p = SD._PLAIN[int(kind[-1])](seg, cfg, st_p,
                                                            cap, True)
            torch.cuda.synchronize()
            n = int(cp)
            r = {"T": hi - lo, "count": [int(ck), n],
                 "bits_equal": bool(torch.equal(bk[:n], bp[:n])),
                 "iq_err": float((qk - qp).abs().max()),
                 "stream_err": float((ik - ip).abs().max()),
                 "state_err": float((SD.pack_state(st_k)
                                     - SD.pack_state(st_p)).abs().max())}
            if kind == "scan3":
                r["need_resync"] = bool(st_prev.need_resync)
                r["clock_stage_bit_equal"] = _check_clock_stage(
                    fn, seg, cfg, st_prev, cap, consts)
            else:
                r["fir_prepass_bit_equal"] = _check_prepass(
                    fn, seg, cfg, st_prev, cap, consts)
            segs.append(r)
            err = max(err, r["iq_err"], r["stream_err"])
            need(int(ck) == n and r["bits_equal"] and n > 0.9 * (hi - lo)
                 / SD.SPS and max(r["iq_err"], r["stream_err"]) <= RDS_IQ_ATOL
                 and r.get("fir_prepass_bit_equal", True)
                 and r.get("clock_stage_bit_equal", True),
                 f"rds {kind}: {r}")
        b_err[kind] = err
        emit({"phase": "kernels", "kernel": f"rds_{kind}",
              "stages": list(SD.STAGES[int(kind[-1])]),
              "iq_atol": RDS_IQ_ATOL, "max_abs_err": err, "segments": segs})
    return a_err, b_err


def _check_prepass(fn, seg, cfg, state, cap, consts) -> bool:
    """Decoders 1 and 2: one call's stages launched from a plan, then each
    FIR stage's output and new history against fir_in_order on the card
    (torch ops, one rounding per multiply and add) from the same stage
    inputs: equal bit for bit."""
    from sdrjfm_tpu_torch.rds import scan_decoders as SD
    p = fn.plan(seg, cfg, state, cap, True, consts)
    for _, launch in p.stages:
        launch()
    new = SD.unpack_state(p.st_out, state)
    t = lambda a: torch.as_tensor(a, device=seg.device)  # noqa: E731
    if fn.which == 2:
        taps = t(cfg.rrc)
        yr, hr = SD.fir_in_order(state.mf_buf.real, seg.real, taps)
        yi, hi = SD.fir_in_order(state.mf_buf.imag, seg.imag, taps)
        v = p.work["v"]
        pairs = [(v.real, yr), (v.imag, yi),
                 (new.mf_buf, torch.complex(hr, hi))]
    else:
        xv = p.work["xv"]
        v1, h1 = SD.fir_in_order(state.lp_buf, p.work["iq4"].real,
                                 t(cfg.lp21))
        v2, h2 = SD.fir_in_order(state.match_buf, p.work["v1"],
                                 t(cfg.match))
        xb, h3 = SD.fir_in_order(state.sharp_fir, xv[:, 1] * xv[:, 1],
                                 t(cfg.sharp.num))
        pairs = [(p.work["v1"], v1), (xv[:, 1], v2), (xv[:, 0], xb),
                 (new.lp_buf, h1), (new.match_buf, h2), (new.sharp_fir, h3)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in pairs)


def _check_clock_stage(fn, seg, cfg, state, cap, consts) -> bool:
    """Decoder 3: one call's stages launched from a plan, then the clock
    stage's writes from the Costas stage's own output: the new sync_buf,
    lp_buf and p against lowpass_outputs (torch ops in fir_in_order's
    order), and the Costas stage's phase chain (every phase, and the one
    after the block in the new state) against clock_phases (the host
    chain, from the state's phase or the resync's): equal bit for bit."""
    from sdrjfm_tpu_torch.rds import scan_decoders as SD
    p = fn.plan(seg, cfg, state, cap, True, consts)
    for _, launch in p.stages:
        launch()
    new = SD.unpack_state(p.st_out, state)
    n = cfg.symbol_ceiling
    T = seg.shape[0]
    v = p.work["iq4"].real.contiguous()
    f0, last, lp_buf = SD.lowpass_outputs(
        state.lp_buf, v, torch.as_tensor(cfg.lp21, device=seg.device), n)
    p0 = int(state.p)
    ring = state.sync_buf.clone()
    m = min(T, n)
    ring[(p0 + torch.arange(T - m, T, device=seg.device)) % n] = last
    ph0 = state.bit_clk_phase
    if bool(state.need_resync):
        # on the host: its index_add_ sums in order, as the kernel does
        buf0 = state.sync_buf.cpu().clone()
        buf0[p0] = f0.cpu()
        ph0 = SD.sync_bit_clock(buf0, torch.tensor((p0 + 1) % n), cfg)
    ph = torch.from_numpy(SD.clock_phases(ph0.cpu().numpy(), T))
    torch.cuda.synchronize()
    return (torch.equal(new.sync_buf, ring) and torch.equal(new.lp_buf, lp_buf)
            and int(new.p) == (p0 + T) % n
            and torch.equal(p.work["ph"][:T + 1].cpu(), ph)
            and float(new.bit_clk_phase) == float(ph[T])
            and not bool(new.need_resync))


def _write_u8_capture(wav, path, seconds: float):
    """The synth capture resampled on the host to 2.4 MS/s (rtl-sdr's rate)
    and written as a headerless u8 file."""
    from scipy.signal import resample_poly
    from sdrjfm_tpu_torch.io.synth import iq_to_u8
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav
    iq, _ = read_iq_wav(str(wav))
    iq = iq[: int(seconds * 2_304_000)]
    iq_to_u8(resample_poly(iq, 25, 24).astype(np.complex64)).tofile(str(path))


def _write_noise_capture(path, seconds: float, seed: int = 9):
    from sdrjfm_tpu_torch.io.wavio import write_iq_wav
    rng = np.random.default_rng(seed)
    n = int(seconds * 2_304_000)
    iq = (0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    write_iq_wav(str(path), iq, 2_304_000, float32=False)


def _head(src, dst, blocks: int, raw_block_bytes: int = 0):
    """The first `blocks` blocks of a capture (wav or raw)."""
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw, write_iq_wav
    if raw_block_bytes:
        dst.write_bytes(src.read_bytes()[: blocks * raw_block_bytes])
        return
    iq, rate = read_iq_wav_raw(str(src))
    x = np.asarray(iq[: blocks * BLOCK_FM * 12], np.float32) / 32768.0
    write_iq_wav(str(dst), (x[:, 0] + 1j * x[:, 1]).astype(np.complex64),
                 rate, float32=False)


def _counters():
    from sdrjfm_tpu_torch.kernels.frontend import frontend
    from sdrjfm_tpu_torch.kernels.linrec import linrec, pole_bank
    from sdrjfm_tpu_torch.rds import scan_decoders as SD
    return {"frontend": frontend, "linrec": linrec, "pole_bank": pole_bank,
            "rds_scan1": SD.decoder1_scan, "rds_scan2": SD.decoder2_scan,
            "rds_scan3": SD.decoder3_scan}


# (name, capture, flags, launches per block, checks): every option of the
# port's receiver through the CLI
OPTION_RUNS = [
    ("scan1", "station", ["--rds", "--rds-decoder", "scan1"],
     {"frontend": 1, "linrec": 2, "rds_scan1": 1}, "rds"),
    ("scan2", "station", ["--rds", "--rds-decoder", "scan2"],
     {"frontend": 1, "linrec": 2, "rds_scan2": 1}, "rds"),
    ("scan3", "station", ["--rds", "--rds-decoder", "scan3"],
     {"frontend": 1, "linrec": 2, "rds_scan3": 1}, "rds"),
    ("nsq_station", "station", ["--rds", "--squelch", "nsq",
                                "--squelch-level", "80"],
     {"frontend": 1, "linrec": 3, "pole_bank": 1}, "open"),
    ("nsq_noise", "noise", ["--squelch", "nsq", "--squelch-level", "80"],
     {"frontend": 1, "linrec": 3, "pole_bank": 1}, "closed"),
    ("lsq_station", "station", ["--squelch", "lsq", "--squelch-level", "50"],
     {"frontend": 1, "linrec": 2}, "open"),
    ("lsq_noise", "noise", ["--squelch", "lsq", "--squelch-level", "50"],
     {"frontend": 1, "linrec": 2}, "closed"),
    ("pll", "station", ["--rds", "--decoder", "pll"],
     {"frontend": 1, "linrec": 4}, "rds"),
    ("real_baseband", "station", ["--rds", "--decoder", "real_baseband"],
     {"frontend": 1, "linrec": 2}, "rds"),
    ("difference", "station", ["--rds", "--decoder", "difference"],
     {"frontend": 1, "linrec": 2}, "rds"),
    ("am", "station", ["--decoder", "am"], {"frontend": 1, "linrec": 2},
     "finite"),
    ("deemph_scan", "station", ["--rds", "--audio-filter", "0"],
     {"frontend": 1, "linrec": 3}, "rds"),
    ("input_filter", "station", ["--rds", "--input-filter"],
     {"frontend": 0, "linrec": 2}, "rds"),
    ("reference", "station", ["--rds", "--frontend", "reference"],
     {"frontend": 0, "linrec": 2}, "rds"),
    ("audio_192k", "station", ["--rds", "--audio-192k"],
     {"frontend": 1, "linrec": 2}, "rds192"),
    ("test_tone", "station", ["--test-tone"], {"frontend": 1, "linrec": 2},
     "finite"),
    ("taps_dumps", "station", ["--rds", "--taps", "--dump-input", "{tmp}/in.wav",
                               "--dump-if", "{tmp}/if.wav", "--dump-mpx",
                               "{tmp}/mpx.wav"],
     {"frontend": 0, "linrec": 2}, "dumps"),
    ("raw_u8_2400k", "raw", ["--rds", "--iq-format", "u8", "--input-rate",
                             "2400000"], {"frontend": 1, "linrec": 2}, "rds"),
]


def phase_options(wav, dev="cuda", cmp_dev="cpu"):
    """`rx` once per option on `dev`, launch counts, checks, and the first
    two blocks of audio against the same run on `cmp_dev`."""
    import shutil

    # the dumps and captures are large: keep them out of the output folder
    tmp = ROOT / "chiprun_work" / "options_tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        return _run_options(wav, dev, cmp_dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run_options(wav, dev, cmp_dev, tmp):
    import contextlib
    import io
    from sdrjfm_tpu_torch import app
    from sdrjfm_tpu_torch.io.pcmout import quantize_pcm16
    from sdrjfm_tpu_torch.io.wavio import read_wav
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu_torch.runtime.graph import WARMUP_STEPS

    caps = {"station": wav, "noise": tmp / "noise.wav",
            "raw": tmp / "iq_2400k.u8"}
    _write_noise_capture(caps["noise"], 3.0)
    _write_u8_capture(wav, caps["raw"], 4.0)
    raw_blk = BLOCK_FM * 12 * 25 // 24 * 2
    heads = {k: tmp / f"head_{k}{'.u8' if k == 'raw' else '.wav'}"
             for k in caps}
    for k in caps:
        _head(caps[k], heads[k], 2, raw_blk if k == "raw" else 0)
    counters = _counters()
    decoders = {k: c for k, c in counters.items() if k.startswith("rds_")}
    results, launches_by_kernel = [], {}
    for name, cap, flags, per_block, check in OPTION_RUNS:
        fl = [f.format(tmp=tmp) for f in flags]
        audio, rep = tmp / f"{name}.wav", tmp / f"{name}.json"
        for c in counters.values():
            c.launches = 0
        for c in decoders.values():
            c.stage_launches = dict.fromkeys(c.stage_launches, 0)
        t0 = time.perf_counter()
        rc, device = _device_launches(lambda: app.main(
            ["rx", "--iq", str(caps[cap]), "--audio", str(audio),
             "--report", str(rep), "--block-fm", str(BLOCK_FM),
             "--device", dev, *fl]))
        secs = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        stage_launches = {k: dict(c.stage_launches)
                          for k, c in decoders.items() if c.launches}
        need(rc == 0, f"option {name}: rx exited {rc}")
        r = json.loads(rep.read_text())
        blocks = r["blocks"]
        x, info = read_wav(str(audio))
        half = x[len(x) // 2:]
        rms = float(np.sqrt(np.mean(np.asarray(half, np.float64) ** 2)))
        row = {"option": name, "flags": fl, "blocks": blocks,
               "launches": launches, "device_launches": device,
               "rx_s": secs,
               "audio_rate": info.rate, "audio_rms_2nd_half": rms}
        if stage_launches:
            row["stage_launches"] = stage_launches
        # rx steps through the captured graph: the wrappers count the
        # warm-up steps' launches and the capture, the profiler the warm-up
        # launches and one replay's a block
        want = {k: per_block.get(k, 0) * (WARMUP_STEPS + 1)
                for k in counters}
        need(launches == want, f"option {name}: launches {launches} != "
                               f"{want}")
        per_dev = {k: per_block.get(k, 0) for k in DEVICE_KERNELS}
        per_dev["costas"] = (per_block.get("rds_scan1", 0)
                             + per_block.get("rds_scan3", 0))
        per_dev["mm_core"] = per_block.get("rds_scan2", 0)
        want = {k: v * (blocks + WARMUP_STEPS) for k, v in per_dev.items()}
        need(device == want, f"option {name}: device launches {device} != "
                             f"{want}")
        # a decoder call launches each of its stages once
        need(all(v == launches[k] for k, st in stage_launches.items()
                 for v in st.values()),
             f"option {name}: stage launches {stage_launches}")
        for k, v in launches.items():
            if v:
                launches_by_kernel.setdefault(k, {})[name] = v
        need(np.isfinite(x).all(), f"option {name}: audio not finite")
        if check.startswith("rds"):
            rds = r["rds"]
            row.update(pi=rds["pi_code"], ps=rds["station_label"],
                       rt=rds["radio_text"], ber=rds["bit_error_rate"],
                       groups=rds["groups_decoded"])
            need(rds["pi_code"] == "0x10F0"
                 and rds["station_label"].strip() == "TPU FM"
                 and rds["bit_error_rate"] <= 0.01,
                 f"option {name}: RDS {row}")
            need(0.1 < rms < 1.0, f"option {name}: audio rms {rms}")
            need(info.rate == (192000 if check == "rds192" else 48000),
                 f"option {name}: audio rate {info.rate}")
        elif check == "open":
            need(0.1 < rms < 1.0, f"option {name}: squelch did not open")
        elif check == "closed":
            need(rms == 0.0, f"option {name}: squelch did not close ({rms})")
        elif check == "dumps":
            sizes = {n: (tmp / f"{n}.wav").stat().st_size
                     for n in ("in", "if", "mpx")}
            row["dump_bytes"] = sizes
            # float32 wavs: complex input and IF, mono MPX, 44-byte header
            need(sizes == {"in": 44 + blocks * BLOCK_FM * 12 * 8,
                           "if": 44 + blocks * BLOCK_FM * 8,
                           "mpx": 44 + blocks * BLOCK_FM * 4},
                 f"option {name}: dumps {sizes}")
        # the first two blocks on the comparison device
        ca, cr = tmp / f"{name}_cmp.wav", tmp / f"{name}_cmp.json"
        rc = app.main(["rx", "--iq", str(heads[cap]), "--audio", str(ca),
                       "--report", str(cr), "--block-fm", str(BLOCK_FM),
                       "--device", cmp_dev, *fl])
        need(rc == 0, f"option {name}: {cmp_dev} rx exited {rc}")
        xc, _ = read_wav(str(ca))
        err = float(np.abs(x[: len(xc)] - xc).max())
        row[f"audio_err_vs_{cmp_dev}_2_blocks"] = err
        need(len(xc) > 0 and err <= OPT_AUDIO_ATOL,
             f"option {name}: {dev} vs {cmp_dev} audio {err}")
        results.append(row)
        emit({"phase": "options", **row})
    # 2.5 MS/s does not tile a 131072 block: exit 2 with the message
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = app.main(["rx", "--iq", str(wav), "--input-rate", "2500000",
                       "--block-fm", str(BLOCK_FM), "--device", dev])
    msg = err.getvalue().strip()
    emit({"phase": "options", "option": "input_rate_2500000", "exit": rc,
          "message": msg[:160]})
    need(rc == 2 and "must divide by 576" in msg, "2.5 MS/s refusal")
    # emit_audio_i16: the on-device quantizer equals the host's bit for bit
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw
    iq, _ = read_iq_wav_raw(str(wav))
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                                 audio_filter_hz=15000, iq_format="i16",
                                 emit_audio_i16=True), device=dev)
    st, ctl = rx.init_state(), rx.initial_controls()
    T = rx.cfg.block_in
    mism = 0
    for b in range(2):
        st, out = rx.step(st, ctl, torch.from_numpy(
            np.array(iq[b * T:(b + 1) * T])).to(dev))
        mism += int((out.audio_i16.cpu().numpy()
                     != quantize_pcm16(out.audio.cpu().numpy())).sum())
    emit({"phase": "options", "option": "emit_audio_i16",
          "mismatches_vs_host_quantizer": mism})
    need(mism == 0, "emit_audio_i16 != host quantizer")
    results += _afc_and_spectra(wav, dev, tmp)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "options.json").write_text(json.dumps(results, indent=2))
    return launches_by_kernel


AFC_OFFSET_HZ = 1500.0             # a residual carrier offset past the 3 Hz
                                   # deadband


def _afc_and_spectra(wav, dev, tmp):
    """`rx --afc` on a capture with a 1500 Hz residual carrier offset
    (block_fm 32768, 4 s): the AFC offset, replayed from the logged dc_if
    through AFCTracker as the CLI's loop computes it, pulls in as
    tests/test_tuner_scan.py asks (within 400 Hz and half the offset);
    then `rx --spectra` offline (the demod and the rds_demod taps) and
    under --follow writes its keys, finite, at their shapes."""
    from sdrjfm_tpu_torch import app
    from sdrjfm_tpu_torch.models.tuner import AFCTracker
    rows = []
    cap, log = tmp / "afc.wav", tmp / "afc.jsonl"
    need(app.main(["synth", "--out", str(cap), "--seconds", "4",
                   "--carrier-offset", str(AFC_OFFSET_HZ), "--int16"]) == 0,
         "afc synth")
    rc = app.main(["rx", "--iq", str(cap), "--afc", "--mode", "mono",
                   "--block-fm", "32768", "--log-meta", str(log),
                   "--report", str(tmp / "afc.json"), "--device", dev])
    need(rc == 0, f"rx --afc exited {rc}")
    afc = AFCTracker()
    offs = [afc.update(json.loads(ln)["dc_if"])
            for ln in log.read_text().splitlines()]
    row = {"option": "afc", "blocks": len(offs), "afc_offset_hz": offs[-1],
           "afc_offsets_hz": offs, "want_hz": AFC_OFFSET_HZ}
    rows.append(row)
    emit({"phase": "options", **row})
    need(abs(offs[-1] - AFC_OFFSET_HZ) < min(400.0, 0.5 * AFC_OFFSET_HZ),
         f"rx --afc did not pull in: {row}")
    want = {"hf_spectrum_db": (512,), "lf_x_axis_khz": (512,),
            "rds_constellation": (101, 101)}
    for name, flags in (("spectra_demod", []),
                        ("spectra_rds_demod", ["--lf-plot", "rds_demod",
                                               "--lf-zoom", "2"]),
                        ("spectra_follow", ["--follow", "--no-pace"])):
        npz = tmp / f"{name}.npz"
        rc = app.main(["rx", "--iq", str(wav), "--rds", "--spectra",
                       str(npz), "--block-fm", str(BLOCK_FM), "--report",
                       str(tmp / f"{name}.json"), "--device", dev, *flags])
        need(rc == 0, f"rx {name} exited {rc}")
        z = np.load(npz)
        shapes = {k: list(z[k].shape) for k in z.files}
        row = {"option": name, "flags": flags, "keys": shapes}
        rows.append(row)
        emit({"phase": "options", **row})
        keys = set(want) | {"lf_waterfall_db"} | (
            set() if "--follow" in flags else {"hf_rate"})
        need(set(z.files) == keys
             and all(tuple(z[k].shape) == v for k, v in want.items())
             and z["lf_waterfall_db"].shape[1] == 512
             and all(np.isfinite(z[k]).all() for k in z.files),
             f"rx {name}: {row}")
    return rows


# The latency microkernel (csrc/rds_scan.cu sdr_rds_latency, built with the
# decoders' flags): op code, dependent steps, and the second operand y.
LATENCY_OPS = {"add": (0, 1 << 19, 1e-7), "mul": (1, 1 << 19, 1.0000001),
               "div": (2, 1 << 17, 1.0000001), "sincosf": (3, 1 << 15, 0.0),
               "hypotf": (4, 1 << 16, 1e-3), "clock_step": (5, 1 << 19, 0.3)}

# Dependent operations on each sequential stage's chain, per sample and per
# emitted symbol (the latencies come from LATENCY_OPS' measurement).
# Costas step: sincosf, then a = zr c + zi s (mul, add), err = a b (mul),
# freq += beta err (mul, add), the limit test (2), phase += freq (add),
# += alpha err (add), rint(phase / 2 pi) (div, 1), 2 pi * that (mul), the
# subtraction (add).
COSTAS_CHAIN = {"sincosf": 1, "div": 1, "mul": 4, "add": 8}
# decoder 1's pole stage: w = (g_re w_re - g_im w_im) + xb
POLE_CHAIN = {"mul": 1, "add": 2}
# decoder 2's AGC: out = v gain, gain += rate (ref - hypotf(out))
AGC_CHAIN = {"hypotf": 1, "mul": 2, "add": 2}
# decoder 3's clock phase chain, x = ph + omega, less 2 pi where x reaches
# it (measured whole as "clock_step"), on a warp of the Costas stage beside
# the Costas thread (so that stage's floor is the Costas chain's)
CLOCK_CHAIN = {"clock_step": 1}
STAGE_CHAINS = {
    ("rds_decoder1", "costas"): (COSTAS_CHAIN, {}),
    ("rds_decoder1", "poles_emit"): (POLE_CHAIN, {}),
    ("rds_decoder2", "mm_core"): (AGC_CHAIN, COSTAS_CHAIN),
    ("rds_decoder3", "costas"): (COSTAS_CHAIN, {}),
}


def phase_latency(card):
    """Cycles of one dependent f32 operation on one thread, each from a
    chain of n steps timed by clock64 on the card, and the SM clock
    during the add chain (its cycles over its CUDA-event time)."""
    import ctypes
    from sdrjfm_tpu_torch.kernels import build
    from sdrjfm_tpu_torch.rds.scan_decoders import SOURCE
    fn = build.load(SOURCE).sdr_rds_latency
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    cycles, clocks = {}, {}
    for name, (op, n, y) in LATENCY_OPS.items():
        inp = torch.tensor([0.5, y], dtype=torch.float32, device=dev)
        out = torch.empty(1, dtype=torch.float32, device=dev)
        cyc = torch.empty(1, dtype=torch.int64, device=dev)
        for _ in range(2):                       # the second call counts
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            rc = fn(op, n, inp.data_ptr(), out.data_ptr(), cyc.data_ptr(),
                    stream)
            b.record()
            torch.cuda.synchronize()
            need(rc == 0, f"latency {name}: launch failed, CUDA error {rc}")
        need(bool(torch.isfinite(out).all()), f"latency {name}: {out}")
        cycles[name] = int(cyc) / n
        clocks[name] = int(cyc) / (a.elapsed_time(b) / 1e3)
    # the sincosf chain is x = sin x + cos x: take the add off
    cycles["sincosf_plus_add"] = cycles["sincosf"]
    cycles["sincosf"] -= cycles["add"]
    clock = clocks["add"]
    emit({"phase": "latency", "what": "cycles of one dependent f32 "
          "operation on one thread (clock64 over a chain; built with "
          "-fmad=false, no fast math)", "cycles": cycles,
          "steps": {k: v[1] for k, v in LATENCY_OPS.items()},
          "sm_clock_mhz_measured": clock / 1e6,
          "sm_clock_mhz_per_op": {k: v / 1e6 for k, v in clocks.items()},
          "card": card})
    return cycles, clock


def _chain_cycles(chain, cycles) -> float:
    return sum(n * cycles[op] for op, n in chain.items())


def _floor_ms(key, samples: int, symbols: int, cycles, clock) -> float:
    """A sequential stage's latency floor: its dependent chain a sample
    (and a symbol) at the measured latencies, over the measured clock."""
    per_sample, per_symbol = STAGE_CHAINS[key]
    return ((samples * _chain_cycles(per_sample, cycles)
             + symbols * _chain_cycles(per_symbol, cycles)) / clock * 1e3)


# f32 operations a pole and sample of a complex one-pole over a real drive:
# w = g*w + x is 4 multiplies and 3 adds, y += Re(r*w) 2 multiplies and 2
# adds (how the kernel splits its passes is not the function's work)
POLE_FLOPS = 7 + 4


def _flops_per_sample(kind: str, cfg) -> int:
    """f32 operations a sample, counting an accurate sinf/cosf as ~20:
    a Costas step is ~12 besides its sin and cos, a real FIR 2 a tap, a
    complex drive through real taps 4 a tap.  Decoder 2 runs its AGC (~20)
    every sample but M&M and Costas (~52) once a symbol, ~20 samples."""
    if kind == "scan1":
        taps = len(cfg.lp21) + len(cfg.match) + len(cfg.sharp.num)
        return 12 + 2 * 20 + 2 * taps + POLE_FLOPS * len(cfg.sharp.poles)
    if kind == "scan2":
        return 4 * len(cfg.rrc) + 8 + 12 + (12 + 40) // 20
    # decoder 3: the Costas step, the clock phase step, its sinf and the
    # integrator (its lowpass only at ~N+1 outputs a block: not counted)
    return 12 + 2 * 20 + 2 + 20 + 2


def _bound_ms(nbytes: float, flops: float):
    """(bound ms, what bounds it) on the data sheet's HBM and FP32 rates."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def _stage_bound(name: str, cfg, n: int, cap: int):
    """A parallel stage's bound.  A FIR stage: its n x components inputs
    read and outputs written once, the taps and histories; 2 flops a tap
    and output.  Decoder 3's clock stage: 4r and the phases read, the bits
    and points written, its state run twice; a sinf (~20 flops) and the
    integrator (2) a sample, the lowpass at N+1 outputs."""
    if name == "clock":
        K, N = len(cfg.lp21), cfg.symbol_ceiling
        run = K - 1 + N + 6
        return _bound_ms(n * 8 + (n + 1) * 4 + cap * 9 + 2 * run * 4,
                         22 * n + 2 * K * (N + 1))
    if name == "fir_rrc":
        K, nc = len(cfg.rrc), 2
    else:
        K, nc = len({"fir_lp21": cfg.lp21, "fir_match": cfg.match,
                     "fir_sharp_num": cfg.sharp.num}[name]), 1
    nbytes = 2 * n * nc * 4 + K * 4 + 2 * (K - 1) * nc * 4
    return _bound_ms(nbytes, 2 * K * n * nc)


def phase_option_times(a_err, b_err, launches, card):
    """The option kernels' device and host times at the path's shapes,
    their plain versions' and their bounds; for decoders 1 and 2 each
    stage's device time on a line of its own; then the measured latency
    floors of the sequential stages beside their times."""
    from sdrjfm_tpu_torch.kernels.linrec import (pole_bank,
                                                 pole_bank_constants,
                                                 pole_bank_plain)
    from sdrjfm_tpu_torch.rds import scan_decoders as SD
    from sdrjfm_tpu_torch.rds.bitrecovery import bit_capacity

    dev = torch.device("cuda")
    M = BLOCK_FM
    specs = _squelch_specs()
    bank = pole_bank_constants(specs, dev)
    x = torch.rand(2, M, device=dev) - 0.5
    w0 = torch.zeros(len(specs), 10, dtype=torch.complex64, device=dev)
    a_ms, a_host = device_ms(lambda: pole_bank(x, bank, w0), "pole_bank")
    a_plain = paced_ms(lambda: pole_bank_plain(x, bank.poles, bank.residues,
                                               w0),
                       reps=3, iters=3)
    P, B = bank.poles.shape[1], len(specs)
    # drive read and y written once; poles, residues, w0 and wT
    a_bound, a_by = _bound_ms(2 * B * M * 4 + B * P * 8 * 4,
                              B * P * M * POLE_FLOPS)
    kernels = [{
        "name": "pole_bank", "route": "cuda",
        "source": "sdrjfm_tpu_torch/csrc/linrec.cu",
        "replaces": "sdrjfm_tpu/ops/blockops.py:378",
        "launches": launches.get("pole_bank", {}).get("nsq_station", 0),
        "max_abs_err": a_err, "ms": a_ms, "plain_ms": a_plain,
        "bound_ms": a_bound, "bound_by": a_by,
        "library_ms": None, "host_us_per_call": a_host,
        "shape": f"2 banks x 10 poles x {M} float32 (the squelch's, per "
                 f"block; one launch a call)"}]
    emit({"phase": "times", "what": "launch", "kernel": "pole_bank",
          "stage": "pole_bank_kernel", "ms": a_ms, "host_us_per_call": a_host,
          "bound_ms": a_bound, "bound_by": a_by, "card": card})
    cycles, clock = phase_latency(card)
    z = _rds_baseband(1.0).to(dev)[:M // 8]
    n = z.shape[0]
    cap = bit_capacity(n)
    floors = []
    for kind, (mk, zero, fn) in SD.DECODERS.items():
        cfg = mk()
        name = f"rds_decoder{kind[-1]}"
        consts = SD.kernel_constants(kind, cfg, dev)
        st = zero(cfg, device=dev)
        ms, host = device_ms(lambda: fn(z, cfg, st, cap, False, consts),
                             f"rds_{kind}", reps=3, iters=5)
        plain = paced_ms(lambda: SD._PLAIN[int(kind[-1])](z, cfg, st, cap),
                         reps=1, iters=1)
        symbols = int(fn(z, cfg, st, cap, False, consts)[1])
        nbytes = n * 8 + cap * 9 + 2 * 4 * SD.pack_state(st).numel()
        bound, by = _bound_ms(nbytes, n * _flops_per_sample(kind, cfg))
        plan = fn.plan(z, cfg, st, cap, False, consts)
        stage_ms = {}
        for sname, launch in plan.stages:
            s_ms, s_host = device_ms(launch, f"{name} {sname}", reps=3,
                                     iters=5)
            stage_ms[sname] = s_ms
            line = {"phase": "times", "what": "stage", "kernel": name,
                    "stage": sname, "ms": s_ms, "host_us_per_call": s_host,
                    "samples": n, "card": card}
            if (name, sname) == ("rds_decoder3", "costas"):
                line["clock_chain_floor_ms"] = (
                    n * _chain_cycles(CLOCK_CHAIN, cycles) / clock * 1e3)
            if (name, sname) in STAGE_CHAINS:
                line["latency_floor_ms"] = _floor_ms(
                    (name, sname), n, symbols, cycles, clock)
                floors.append({"kernel": name, "stage": sname, "ms": s_ms,
                               "latency_floor_ms": line["latency_floor_ms"],
                               "share_of_floor": line["latency_floor_ms"]
                               / s_ms})
            else:
                line["bound_ms"], line["bound_by"] = _stage_bound(
                    sname, cfg, n, cap)
            emit(line)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sdrjfm_tpu_torch/csrc/rds_scan.cu",
            "replaces": "sdrjfm_tpu/rds/scan_decoders.py:"
                        + {"scan1": "108", "scan2": "191",
                           "scan3": "313"}[kind],
            "launches": launches.get(f"rds_{kind}", {}).get(kind, 0),
            "max_abs_err": b_err[kind], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by,
            "library_ms": None, "host_us_per_call": host,
            "stage_ms": stage_ms,
            "shape": f"complex64 [{n}] per block, {len(plan.stages)} "
                     f"launch(es) a call"})
    emit({"phase": "times", "what": "option kernels", "card": card,
          "kernels": kernels})
    emit({"phase": "model", "what": "latency floors of the sequential "
          "stages: their dependent chains (STAGE_CHAINS) at the latencies "
          "measured on this card by the latency microkernel, over the "
          "measured SM clock", "measured": True, "cycles": cycles,
          "sm_clock_mhz": clock / 1e6, "samples": n,
          "chains": {f"{k[0]}/{k[1]}": {"per_sample": v[0],
                                         "per_symbol": v[1]}
                     for k, v in STAGE_CHAINS.items()},
          "stages": floors, "card": card})
    return kernels


def phase_config_step(wav, card, what: str, **options):
    """Step time and real-time factor of an option config: the main path's
    ReceiverConfig with `options` on top."""
    from sdrjfm_tpu_torch import constants as C
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, audio_filter_hz=15000,
                                 iq_format="i16", **options), device="cuda")
    T = rx.cfg.block_in
    iq, _ = read_iq_wav_raw(str(wav))
    blocks = [torch.from_numpy(np.array(iq[b * T:(b + 1) * T])).to("cuda")
              for b in range(len(iq) // T)]
    state, ctl = rx.init_state(), rx.initial_controls()
    for blk in blocks[:2]:
        state, _ = rx.step(state, ctl, blk)
    torch.cuda.synchronize()
    steps = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        for blk in blocks:
            state, _ = rx.step(state, ctl, blk)
        e.record()
        torch.cuda.synchronize()
        steps.append(a.elapsed_time(e) / len(blocks))
    step_ms = statistics.median(steps)
    emit({"phase": "times", "what": f"step, {what}", "block_fm": BLOCK_FM,
          "step_ms": step_ms, "step_ms_all": steps,
          "fm_stereo_rds_realtime_x": T / C.INPUT_RATE / (step_ms / 1e3),
          "card": card})
    return rx, step_ms

def phase_graph(card, rx):
    """The look-back kernels under CUDA-graph replay: two real-scan calls
    (R=2, then R=1, as the main path launches them), one pole-bank call
    at the squelch's 2 x 10 poles x 131072 and one 4-row front-end launch
    (4 stations on one int16 block), captured in one graph and
    replayed three times, with new random inputs copied into the static
    inputs between replays; each replay against the plain versions
    (SCAN_RTOL of max|y|, POLE_RTOL of the bank's scale, also against
    float64; FE_ATOL / FE_RTOL for the front end, whose DC tickets each
    launch leaves at 0).  A replay that faults is recorded and fails the
    phase."""
    from sdrjfm_tpu_torch import constants as C
    from sdrjfm_tpu_torch.kernels.frontend import (frontend_rows,
                                                   frontend_rows_plain)
    from sdrjfm_tpu_torch.kernels.linrec import (linrec, linrec_plain,
                                                 pole_bank,
                                                 pole_bank_constants,
                                                 pole_bank_plain)
    dev = torch.device("cuda")
    M = BLOCK_FM
    rng = np.random.default_rng(12)
    specs = _squelch_specs()
    bank = pole_bank_constants(specs, dev)
    g2 = [1 - C.CARRIER_ALPHA, 1 - C.FM_DC_ALPHA]
    g1 = [1 - C.PILOT_LOCK_ALPHA]
    d2, d1 = torch.zeros(2, M, device=dev), torch.zeros(1, M, device=dev)
    y02, y01 = torch.zeros(2, device=dev), torch.zeros(1, device=dev)
    x = torch.zeros(2, M, device=dev)
    w0 = torch.zeros(len(specs), 10, dtype=torch.complex64, device=dev)
    fe_wire, fe_idx, fe_p = _rows_case(rng, "i16", 4, 1, 12 * M, dev)

    def rand(*shape, scale=1.0, cplx=False):
        v = scale * rng.standard_normal(shape)
        if cplx:
            v = v + 1j * scale * rng.standard_normal(shape)
        return torch.from_numpy(v.astype(np.complex64 if cplx
                                         else np.float32))

    def new_inputs():
        d2.copy_(rand(2, M, scale=1e-2))
        d1.copy_(rand(1, M, scale=1e-2))
        y02.copy_(rand(2))
        y01.copy_(rand(1))
        x.copy_(rand(2, M, scale=0.3))
        for w in w0:
            w.copy_(rand(10, scale=0.05, cplx=True))
        fe_wire.copy_(_fe_inputs(rng, "i16", 12 * M, dev)[None])
        for buf, v in zip(fe_p, _row_params(rng, 4, dev)):
            buf.copy_(v)

    def body():
        return (linrec(d2, g2, y02), linrec(d1, g1, y01),
                pole_bank(x, bank, w0),
                frontend_rows(fe_wire, "i16", fe_idx, fe_p[0], rx.k_decim12,
                              *fe_p[1:], True))

    new_inputs()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = body()
    rows, ok = [], True
    for r in range(3):
        new_inputs()
        row = {"replay": r + 1}
        rows.append(row)
        try:
            graph.replay()
            torch.cuda.synchronize()
        except RuntimeError as e:
            row["error"] = str(e)[:300]
            ok = False
            break
        for name, d, g, y0, (y, last) in (("scan_R2", d2, g2, y02, outs[0]),
                                          ("scan_R1", d1, g1, y01, outs[1])):
            yp, lastp = linrec_plain(d, g, y0)
            err = float(torch.maximum((y - yp).abs().max(),
                                      (last - lastp).abs().max()))
            row[f"{name}_max_abs_err"] = err
            row[f"{name}_err_of_max"] = err / float(yp.abs().max())
            ok &= err <= SCAN_RTOL * float(yp.abs().max())
        y, wT = outs[2]
        yp, wTp = pole_bank_plain(x, bank.poles, bank.residues,
                                  w0)
        for b, spec in enumerate(specs):
            ref, scale = _pole_f64(spec, x[b], w0[b])
            kp = float((y[b] - yp[b]).abs().max()) / scale
            k64 = float(np.abs(y[b].cpu().numpy() - ref).max()) / scale
            row[f"pole_bank{b}_err_of_scale"] = kp
            row[f"pole_bank{b}_vs_f64_of_scale"] = k64
            ok &= kp <= POLE_RTOL and k64 <= POLE_RTOL
        st = float((wT - wTp).abs().max())
        row["pole_state_max_abs_err"] = st
        ok &= st <= 10 * POLE_RTOL * float(wTp.abs().max())
        y, nc, dm = outs[3]
        yp, ncp, dmp = frontend_rows_plain(fe_wire, "i16", fe_idx, fe_p[0],
                                           rx.k_decim12, *fe_p[1:], True)
        fe_e = (y - yp).abs()
        row["frontend_rows4_max_abs_err"] = float(fe_e.max())
        row["frontend_rows4_carry_err"] = float((nc - ncp).abs().max())
        row["frontend_rows4_dc_err"] = float((dm - dmp).abs().max())
        ok &= (bool((fe_e <= FE_ATOL + FE_RTOL * yp.abs()).all())
               and row["frontend_rows4_carry_err"] <= FE_ATOL
               and row["frontend_rows4_dc_err"] <= 1e-6)
    emit({"phase": "graph", "what": "2 real scans (R=2, R=1), 1 pole bank "
          "and a 4-row front end in one CUDA graph, 3 replays on new "
          "inputs", "ok": bool(ok),
          "scan_rtol_of_max": SCAN_RTOL, "pole_rtol_of_scale": POLE_RTOL,
          "fe_atol": FE_ATOL, "fe_rtol": FE_RTOL,
          "replays": rows, "card": card})
    need(ok, f"graph replays: {rows}")


RUNNER_AUDIO_ATOL = 1e-5           # a runner's audio vs the eager run's on
                                   # the card: the same kernels, but a
                                   # look-back scan may join a predecessor's
                                   # prefix or its aggregate (timing), so the
                                   # last bits may differ; RDS bits equal
CLI_AUDIO_ATOL = 2.0 / 32768       # PCM16 wavs and PCM of two card runs:
                                   # the floats above, rounded to 16 bits


def _rds_ok(bits, meta):
    """The synth capture's PI/PS/RT at BER 0, pilot and PSS locked."""
    from sdrjfm_tpu_torch.rds.live import LiveRDSDecoder
    dec = LiveRDSDecoder()
    dec.feed(bits)
    rep = dec.report()
    d = {"pi": rep["pi_code"], "ps": rep["station_label"],
         "rt": rep["radio_text"], "ber": rep["bit_error_rate"],
         "groups": rep["groups_decoded"],
         "pilot_locked": meta["pilot_locked"],
         "pss_established": meta["pss_established"]}
    ok = (d["pi"] == "0x10F0" and d["ps"].strip() == "TPU FM"
          and d["rt"] == "VERIFY RUN" and d["ber"] == 0.0
          and d["pilot_locked"] and d["pss_established"])
    return ok, d


# kernel names in a profile (csrc/*.cu); a call of RDS decoder 1 or 3
# launches its Costas stage once, one of decoder 2 its M&M core once
DEVICE_KERNELS = {"frontend": "frontend_kernel", "linrec": "linrec_kernel",
                  "pole_bank": "pole_bank_kernel", "costas": "costas_kernel",
                  "mm_core": "mm_core_kernel"}


def _device_launches(fn):
    """(fn(), device kernel launches by counter name over it), the
    launches read from a profiler trace: the wrappers' host counters do
    not see a graph's replays."""
    ret, _, ev = _traced(fn)
    return ret, {k: sum(e.count for e in ev if n in e.key)
                 for k, n in DEVICE_KERNELS.items()}


def _eager_offline(rx, iq):
    """The capture through rx.step itself, block by block, with no graph:
    the yardstick the runners are held to.  Audio, RDS bits, meta dicts."""
    from types import SimpleNamespace
    from sdrjfm_tpu_torch.models.receiver import meta_dict_from_vec
    T = rx.cfg.wire_len
    state, ctl = rx.init_state(), rx.initial_controls()
    audio, bits, metas = [], [], []
    for b in range(len(iq) // T):
        blk = torch.from_numpy(np.array(iq[b * T:(b + 1) * T])).to(rx.device)
        state, out = rx.step(state, ctl, blk)
        meta, n = meta_dict_from_vec(out.meta_vec.cpu().numpy())
        audio.append(out.audio.cpu().numpy())
        bits.append(out.rds.bits[:n].cpu().numpy())
        metas.append(meta)
    return SimpleNamespace(audio=np.concatenate(audio),
                           rds_bits=np.concatenate(bits), meta=metas,
                           counts=[len(b) for b in bits])


def phase_runners(wav, card):
    """Every runner on the card against the eager rx.step loop on the 8 s
    capture (11 blocks, i16 wire): audio within RUNNER_AUDIO_ATOL, RDS
    bits equal, PI/PS/RT decoded at BER 0; chunk graphs of 1, 2 and 4
    blocks (fewer blocks than warm-up steps, and trailing partial chunks)
    and a 2-block capture; launches under the graphs counted from a
    profiler trace; then `rx` through the CLI with --runner scan
    --chunk-blocks 4, --pcm-out and --follow --no-pace against the CLI run
    of phase main (the loop runner), itself against the eager loop."""
    import shutil
    from sdrjfm_tpu_torch import app
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw, read_wav
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu_torch.runtime.native_source import NativeRawSource
    from sdrjfm_tpu_torch.runtime.stream import (run_live, run_offline,
                                                 run_offline_scanned,
                                                 run_streaming)
    iq, _ = read_iq_wav_raw(str(wav))
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                                 audio_filter_hz=15000, iq_format="i16"),
                  device="cuda")
    ref = _eager_offline(rx, iq)
    nblk = len(ref.meta)

    def live():
        with NativeRawSource(str(wav), pace=False) as src:
            return run_live(rx, src)

    runs = (("run_offline", lambda: run_offline(rx, iq)),
            ("run_offline_scanned", lambda: run_offline_scanned(rx, iq)),
            ("run_offline_scanned_chunk4",
             lambda: run_offline_scanned(rx, iq, chunk_blocks=4)),
            ("run_offline_scanned_chunk2",
             lambda: run_offline_scanned(rx, iq, chunk_blocks=2)),
            ("run_offline_scanned_chunk1",
             lambda: run_offline_scanned(rx, iq, chunk_blocks=1)),
            ("run_streaming", lambda: run_streaming(rx, iq)),
            ("run_streaming_chunk4",
             lambda: run_streaming(rx, iq, chunk_blocks=4)),
            ("run_live_raw_unpaced", live))
    results = {}
    for name, fn in runs:
        t0 = time.perf_counter()
        res = fn()
        secs = time.perf_counter() - t0
        results[name] = res
        same_shape = res.audio.shape == ref.audio.shape
        a_err = (float(np.abs(res.audio - ref.audio).max()) if same_shape
                 else float("inf"))
        bits_equal = bool(np.array_equal(res.rds_bits, ref.rds_bits))
        dec_ok, dec = _rds_ok(res.rds_bits, res.meta[-1])
        row = {"phase": "runners", "runner": name, "blocks": len(res.meta),
               "s": secs, "audio_max_abs_diff_vs_eager": a_err,
               "rds_bits_equal": bits_equal,
               "bit_for_bit": bool(same_shape and bits_equal
                                   and np.array_equal(res.audio, ref.audio)),
               "decode": dec, "audio_atol": RUNNER_AUDIO_ATOL}
        if name.startswith("run_live"):
            row["dropped_total"] = res.dropped_total
        emit(row)
        need(len(res.meta) == nblk and a_err <= RUNNER_AUDIO_ATOL
             and bits_equal and dec_ok, f"runner {name}: {row}")
    # a capture of 2 blocks: one chunk of 2, against the eager loop on them
    T = rx.cfg.wire_len
    head, head_ref = (run_offline_scanned(rx, iq[:2 * T]),
                      _eager_offline(rx, iq[:2 * T]))
    h_err = float(np.abs(head.audio - head_ref.audio).max())
    h_eq = bool(np.array_equal(head.rds_bits, head_ref.rds_bits))
    emit({"phase": "runners", "runner": "run_offline_scanned, 2 blocks",
          "blocks": len(head.meta), "audio_max_abs_diff_vs_eager": h_err,
          "rds_bits_equal": h_eq})
    need(len(head.meta) == 2 and head.audio.shape == head_ref.audio.shape
         and h_err <= RUNNER_AUDIO_ATOL and h_eq, "scanned, 2 blocks")
    c0 = results["run_offline_scanned"].audio
    chunk_err = {k: float(np.abs(results[f"run_offline_scanned_{k}"].audio
                                 - c0).max())
                 for k in ("chunk4", "chunk2", "chunk1")}
    # the launches inside the graphs, by kernel name, each graph captured
    # before the trace (so no warm-up step is in it)
    run_offline_scanned(rx, iq)
    counts = {"run_offline_scanned": _device_launches(
                  lambda: run_offline_scanned(rx, iq))[1],
              "run_offline": _device_launches(
                  lambda: run_offline(rx, iq))[1]}
    emit({"phase": "runners", "what": "chunks of 4, 2, 1 vs one chunk, and "
          "device launches under the graphs (profiler)", "blocks": nblk,
          "chunk_vs_none_max_abs_diff": chunk_err,
          "graph_launches": counts, "card": card})
    need(max(chunk_err.values()) <= RUNNER_AUDIO_ATOL, "chunks vs one chunk")
    for k, c in counts.items():
        need(c["frontend"] == nblk and c["linrec"] == 2 * nblk,
             f"{k}: launches under the graph {c}, want {nblk} front ends "
             f"and {2 * nblk} scans")
    # decoders 1-3 under replay: the loop and scan runners against the
    # eager loop
    for rds in ("scan1", "scan2", "scan3"):
        rxd = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds=rds,
                                      audio_filter_hz=15000,
                                      iq_format="i16"), device="cuda")
        e = _eager_offline(rxd, iq)
        for name, g in (("run_offline", run_offline(rxd, iq)),
                        ("run_offline_scanned", run_offline_scanned(rxd,
                                                                    iq))):
            a_err = float(np.abs(e.audio - g.audio).max())
            eq = bool(np.array_equal(e.rds_bits, g.rds_bits))
            emit({"phase": "runners", "runner": f"{name}, {rds}",
                  "audio_max_abs_diff_vs_eager": a_err,
                  "rds_bits_equal": eq})
            need(a_err <= RUNNER_AUDIO_ATOL and eq, f"{name} {rds} vs eager")
    # the CLI's runners against the CLI run of phase main (the loop
    # runner), and that one against the eager loop
    tmp = ROOT / "chiprun_work" / "runners_tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        main_audio, _ = read_wav(str(OUT / "audio.wav"))
        m_err = (float(np.abs(main_audio - ref.audio).max())
                 if main_audio.shape == ref.audio.shape else float("inf"))
        emit({"phase": "runners", "cli": "loop (phase main)",
              "audio_max_abs_diff_vs_eager": m_err,
              "audio_atol": CLI_AUDIO_ATOL})
        need(m_err <= CLI_AUDIO_ATOL, f"rx loop vs eager: {m_err}")
        for name, flags in (("scan_chunk4", ["--runner", "scan",
                                             "--chunk-blocks", "4"]),
                            ("pcm_out", ["--pcm-out", str(tmp / "pcm.raw")]),
                            ("follow", ["--follow", "--no-pace"])):
            a, r = tmp / f"{name}.wav", tmp / f"{name}.json"
            t0 = time.perf_counter()
            rc = app.main(["rx", "--iq", str(wav), "--audio", str(a),
                           "--rds", "--report", str(r), "--block-fm",
                           str(BLOCK_FM), "--iq-format", "i16", "--device",
                           "cuda", *flags])
            secs = time.perf_counter() - t0
            need(rc == 0, f"rx {name} exited {rc}")
            rep = json.loads(r.read_text())
            x, info = read_wav(str(a))
            err = float(np.abs(x - main_audio).max())
            row = {"phase": "runners", "cli": name, "flags": flags,
                   "rx_s": secs, "blocks": rep["blocks"],
                   "throughput_x_realtime": rep["throughput_x_realtime"],
                   "audio_max_abs_diff_vs_loop_cli": err,
                   "pi": rep["rds"]["pi_code"],
                   "ps": rep["rds"]["station_label"],
                   "rt": rep["rds"]["radio_text"],
                   "ber": rep["rds"]["bit_error_rate"],
                   "pilot_locked": rep["meta_last"]["pilot_locked"],
                   "pss_established": rep["meta_last"]["pss_established"]}
            if name == "pcm_out":
                pcm = np.fromfile(str(tmp / "pcm.raw"), "<i2").reshape(-1, 2)
                row["pcm_max_abs_diff_vs_loop_cli"] = float(
                    np.abs(pcm / 32768.0 - main_audio).max())
                err = max(err, row["pcm_max_abs_diff_vs_loop_cli"])
            if name == "follow":
                row["ingest_dropped"] = rep["ingest_dropped"]
                row["latency_ms"] = rep.get("latency_ms")
            emit(row)
            need(rep["blocks"] == nblk and x.shape == main_audio.shape
                 and err <= CLI_AUDIO_ATOL and row["pi"] == "0x10F0"
                 and row["ps"].strip() == "TPU FM"
                 and row["rt"] == "VERIFY RUN" and row["ber"] == 0.0
                 and row["pilot_locked"] and row["pss_established"]
                 and rep.get("ingest_dropped", 0) == 0, f"rx {name}: {row}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_scanned(rx, wav, card, what: str, eager_step_ms: float,
                  passes: int = 7):
    """run_offline_scanned over the capture's blocks, `passes` times after
    the first (which captures): wall ms per block, its real-time factor,
    the same for run_offline (the loop runner), the host's time per
    replay(), the capture and instantiate seconds, the
    device time per step and busy share (profiler), beside the eager
    step; its output against the eager rx.step loop's."""
    from sdrjfm_tpu_torch import constants as C
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw
    from sdrjfm_tpu_torch.runtime.stream import (_wire_blocks, run_offline,
                                                 run_offline_scanned)
    iq, _ = read_iq_wav_raw(str(wav))
    T = rx.cfg.wire_len
    nblk = len(iq) // T
    block_s = rx.cfg.block_in / C.INPUT_RATE
    ref = _eager_offline(rx, iq)
    t0 = time.perf_counter()
    first = run_offline_scanned(rx, iq)
    first_s = time.perf_counter() - t0
    a_err = float(np.abs(first.audio - ref.audio).max())
    bits_eq = bool(np.array_equal(first.rds_bits, ref.rds_bits))
    need(a_err <= RUNNER_AUDIO_ATOL and bits_eq,
         f"scanned {what}: vs eager {a_err}, bits equal {bits_eq}")
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        run_offline_scanned(rx, iq)
        walls.append((time.perf_counter() - t0) / nblk * 1e3)
    # the loop runner (run_offline, rx's default): the per-block graph,
    # an upload, a meta_vec fetch and the hooks' turn between blocks
    run_offline(rx, iq)
    loop_walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        run_offline(rx, iq)
        loop_walls.append((time.perf_counter() - t0) / nblk * 1e3)
    # one run's parts, each ended by a sync: loading the start state and
    # controls into the step's buffers, staging the chunk (host copy into
    # pinned memory, upload), the replays (the host's enqueue alone, then
    # the card's), and fetching the outputs
    sg = rx.jit_step()
    sc = sg.scan(nblk)
    wire = _wire_blocks(iq, rx.cfg, nblk)
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t0) * 1e3

    def replays():
        t0 = time.perf_counter()
        for _ in range(nblk):
            sc.step()
        parts["enqueue_ms"] = (time.perf_counter() - t0) * 1e3

    timed("load_state_ms", lambda: sg.load(rx.init_state(),
                                           rx.initial_controls()))
    timed("stage_ms", lambda: sc.load_blocks(wire))
    timed("replays_ms", replays)
    timed("fetch_ms", lambda: sc.fetch(nblk))
    host_us = parts["enqueue_ms"] / nblk * 1e3
    _, wall, ev = _traced(lambda: run_offline_scanned(rx, iq))
    rows = [(e.self_device_time_total, e.count) for e in ev
            if e.self_device_time_total > 0]
    dev_us = sum(r[0] for r in rows)
    wall_ms = statistics.median(walls)
    emit({"phase": "times", "what": f"scanned, {what}", "blocks": nblk,
          "passes": passes, "wall_ms_per_block": wall_ms,
          "wall_ms_per_block_all": walls,
          "wall_ms_per_block_spread": [min(walls), max(walls)],
          "fm_stereo_rds_realtime_x": block_s / (wall_ms / 1e3),
          "fm_stereo_rds_realtime_x_all": [block_s / (w / 1e3)
                                           for w in walls],
          "device_ms_per_step": (dev_us / nblk / 1e3 if rows
                                 else "not measured"),
          "device_busy_share": (dev_us / 1e6 / wall if rows
                                else "not measured"),
          "device_events_per_step": sum(r[1] for r in rows) / nblk,
          "host_us_per_replay": host_us,
          "loop_wall_ms_per_block": statistics.median(loop_walls),
          "loop_wall_ms_per_block_spread": [min(loop_walls),
                                            max(loop_walls)],
          "loop_fm_stereo_rds_realtime_x": block_s / (
              statistics.median(loop_walls) / 1e3),
          "one_run_parts_ms": parts,
          "capture_and_instantiate_s": sc.capture_s,
          "first_run_s": first_s,
          "eager_step_ms": eager_step_ms,
          "eager_fm_stereo_rds_realtime_x": block_s / (eager_step_ms / 1e3),
          "audio_max_abs_diff_vs_eager": a_err, "card": card})


# phase multistation: four stations of one 8 s capture, each with its own
# LO offset, PI, PS and tones (left, right); n = 19 is every raster channel
# of the +-900 kHz window
MS_STATIONS = ((-600_000, 0x1111, "STATION1", 700.0, 1100.0),
               (-200_000, 0x2222, "STATION2", 1300.0, 500.0),
               (300_000, 0x3333, "STATION3", 900.0, 1700.0),
               (700_000, 0x4444, "STATION4", 1900.0, 400.0))
MS_SECONDS = 8.0
MS_AMPLITUDE = 0.22                # each station; the sum stays under 1 in
                                   # the int16 wav
RASTER_19 = tuple(range(-900_000, 900_001, 100_000))
SCAN_CONTRAST_ATOL_DB = 1e-3       # card vs CPU scan contrast: f32 FFTs of
                                   # the same rows in two libraries


def _write_stations_capture(path, seconds: float = MS_SECONDS):
    """MS_STATIONS summed into one int16 IQ wav at 2.304 MS/s, each a
    stereo FM station with its own RDS PI and PS (group 0A), plus a little
    noise; made from a seed."""
    from sdrjfm_tpu_torch import constants as C
    from sdrjfm_tpu_torch.io import synth
    from sdrjfm_tpu_torch.io.wavio import write_iq_wav
    from sdrjfm_tpu_torch.rds import encode
    n = int(seconds * C.FM_RATE)
    t = np.arange(n) / C.FM_RATE
    total = None
    for off, pi, name, fl, fr in MS_STATIONS:
        bits = []
        for _ in range(int(seconds * 1187.5 / 104 / 4) + 2):
            for seg in range(4):
                bits.extend(encode.group_0a(pi, 10, seg,
                                            name[2 * seg:2 * seg + 2]))
        syms = encode.differential_encode(np.asarray(bits, np.int8))
        mpx = synth.synth_mpx(0.6 * np.sin(2 * np.pi * fl * t),
                              0.6 * np.sin(2 * np.pi * fr * t),
                              synth.MPXParams(rds_level=0.08), rds_bits=syms)
        iq = synth.fm_modulate(mpx, C.FM_RATE, carrier_offset_hz=off,
                               amplitude=MS_AMPLITUDE)
        total = iq if total is None else total + iq
    rng = np.random.default_rng(17)
    total = total + 0.003 * (rng.standard_normal(len(total))
                             + 1j * rng.standard_normal(len(total)))
    write_iq_wav(str(path), total.astype(np.complex64), C.INPUT_RATE,
                 float32=False)


def _station_ok(bits, meta, pi: int, name: str):
    """A station's PI and PS back at BER 0 with its pilot locked."""
    from sdrjfm_tpu_torch.rds.live import LiveRDSDecoder
    dec = LiveRDSDecoder()
    dec.feed(bits)
    rep = dec.report()
    d = {"pi": rep["pi_code"], "ps": rep["station_label"],
         "ber": rep["bit_error_rate"], "groups": rep["groups_decoded"],
         "pilot_locked": bool(meta["pilot_locked"])}
    ok = (d["pi"] == f"0x{pi:04X}" and d["ps"].strip() == name
          and d["ber"] == 0.0 and d["pilot_locked"])
    return ok, d


def _ms_times(rx, iq, offsets, card, passes: int = 7):
    """demodulate_stations over the capture for these offsets: the first
    call (warm-up steps and capture), then `passes` calls: wall ms per
    block (median, spread), station-seconds of air per second; the host's
    us per replay(), capture and instantiate seconds, and the device ms per
    step, busy share and largest device ops from a profiled call."""
    from sdrjfm_tpu_torch import constants as C
    from sdrjfm_tpu_torch.models.multistation import demodulate_stations
    from sdrjfm_tpu_torch.runtime.stream import _wire_blocks
    n = len(offsets)
    T = rx.cfg.wire_len
    nblk = len(iq) // T
    block_s = rx.cfg.block_in / C.INPUT_RATE
    t0 = time.perf_counter()
    demodulate_stations(rx, iq, offsets)
    first_s = time.perf_counter() - t0
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        demodulate_stations(rx, iq, offsets)
        walls.append((time.perf_counter() - t0) / nblk * 1e3)
    msr = rx.stations()
    sg = msr.jit_step().for_stations(n)
    sc = sg.scan(nblk)
    sg.load(msr.init_states(n), msr.controls_for(offsets))
    sc.load_blocks(_wire_blocks(iq, rx.cfg, nblk))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(nblk):
        sc.step()
    host_us = (time.perf_counter() - t0) / nblk * 1e6
    torch.cuda.synchronize()
    _, wall, ev = _traced(lambda: demodulate_stations(rx, iq, offsets))
    rows = [(e.self_device_time_total, e.count, e.key) for e in ev
            if e.self_device_time_total > 0]
    dev_us = sum(r[0] for r in rows)
    top = [{"op": k[:80], "ms_per_step": us / nblk / 1e3,
            "per_step": c / nblk} for us, c, k in sorted(rows)[::-1][:8]]
    wall_ms = statistics.median(walls)
    row = {"phase": "multistation", "what": "times", "stations": n,
           "blocks": nblk, "passes": passes,
           "wall_ms_per_block": wall_ms, "wall_ms_per_block_all": walls,
           "wall_ms_per_block_spread": [min(walls), max(walls)],
           "station_seconds_per_second": n * block_s / (wall_ms / 1e3),
           "device_ms_per_step": (dev_us / nblk / 1e3 if rows
                                  else "not measured"),
           "device_busy_share": (dev_us / 1e6 / wall if rows
                                 else "not measured"),
           "device_events_per_step": sum(r[1] for r in rows) / nblk,
           "top_device_ops": top,
           "host_us_per_replay": host_us,
           "capture_and_instantiate_s": sc.capture_s,
           "first_call_s": first_s, "card": card}
    emit(row)
    return row


def _mesh_stations(rx, iq, offsets, res):
    """demodulate_stations(mesh=) over the cards there are, or one card
    named twice: each station against the unsharded run (audio within
    RUNNER_AUDIO_ATOL, RDS bits equal; whether bit for bit is printed)."""
    from sdrjfm_tpu_torch.models.multistation import demodulate_stations
    from sdrjfm_tpu_torch.parallel.sharding import make_mesh
    n_dev = max(2, torch.cuda.device_count())
    mesh = make_mesh(n_dev, axis="stations")
    t0 = time.perf_counter()
    got = demodulate_stations(rx, iq, offsets, mesh=mesh)
    secs = time.perf_counter() - t0
    errs = [float(np.abs(g["audio"] - r["audio"]).max())
            for g, r in zip(got, res)]
    bits_eq = [bool(np.array_equal(g["rds_bits"], r["rds_bits"]))
               for g, r in zip(got, res)]
    row = {"phase": "multistation", "what": "station axis on a mesh",
           "mesh": [str(d) for d in mesh.devices],
           "cards": torch.cuda.device_count(),
           "stations_per_device": len(offsets) // n_dev, "s": secs,
           "audio_max_abs_diff_vs_unsharded": errs,
           "bit_for_bit": [e == 0.0 for e in errs],
           "rds_bits_equal": bits_eq, "audio_atol": RUNNER_AUDIO_ATOL}
    emit(row)
    need(len(got) == len(offsets) and all(bits_eq)
         and max(errs) <= RUNNER_AUDIO_ATOL, f"multistation mesh: {row}")


def phase_multistation(card):
    """Four stations of one 8 s capture through demodulate_stations (the
    n-station step as a CUDA graph replayed over the capture, one front-end
    launch a block for every station), each station against its own
    single-station run_offline on the card (audio within
    RUNNER_AUDIO_ATOL, RDS bits equal), PI/PS at BER 0 and the pilot
    locked; scan=False against scan=True; the wrappers' counts over the
    main path's run and the device launches under the graph (profiler);
    the station axis on a mesh; then the times at n = 1, 4 and 19.  Returns (the
    capture, its rx, the wrappers' counts)."""
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw
    from sdrjfm_tpu_torch.kernels.frontend import frontend
    from sdrjfm_tpu_torch.kernels.linrec import linrec
    from sdrjfm_tpu_torch.models.multistation import demodulate_stations
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu_torch.runtime.graph import WARMUP_STEPS
    from sdrjfm_tpu_torch.runtime.stream import run_offline
    wav = ROOT / "chiprun_work" / "stations.wav"
    wav.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _write_stations_capture(wav)
    synth_s = time.perf_counter() - t0
    iq, _ = read_iq_wav_raw(str(wav))
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                                 audio_filter_hz=15000, iq_format="i16"),
                  device="cuda")
    offsets = [st[0] for st in MS_STATIONS]
    n = len(offsets)
    nblk = len(iq) // rx.cfg.wire_len
    # the main path, the wrappers' counts set to 0 just before it
    frontend.launches = 0
    linrec.launches = 0
    t0 = time.perf_counter()
    res = demodulate_stations(rx, iq, offsets)
    secs = time.perf_counter() - t0
    launches = {"frontend": frontend.launches, "linrec": linrec.launches}
    steps = WARMUP_STEPS + 1
    emit({"phase": "multistation", "what": "main path", "stations": n,
          "blocks": nblk, "synth_s": synth_s, "s": secs,
          "launches": launches, "warmup_steps": WARMUP_STEPS})
    need(launches == {"frontend": steps, "linrec": 2 * steps},
         f"multistation: wrapper launches {launches}, want {steps} front "
         f"ends and {2 * steps} scans (one and two a step for all {n} "
         f"stations)")
    res_loop = demodulate_stations(rx, iq, offsets, scan=False)
    for s, (off, pi, name, _, _) in enumerate(MS_STATIONS):
        r = res[s]
        single = run_offline(rx, iq, rx.initial_controls()._replace(
            lo_freq_hz=torch.tensor(off, dtype=torch.int32, device="cuda")))
        a_err = (float(np.abs(r["audio"] - single.audio).max())
                 if r["audio"].shape == single.audio.shape else float("inf"))
        bits_eq = bool(np.array_equal(r["rds_bits"], single.rds_bits))
        l_err = float(np.abs(r["audio"] - res_loop[s]["audio"]).max())
        l_eq = bool(np.array_equal(r["rds_bits"], res_loop[s]["rds_bits"]))
        ok, dec = _station_ok(r["rds_bits"], r["meta"], pi, name)
        rms = float(np.sqrt(np.mean(r["audio"][len(r["audio"]) // 2:]
                                    .astype(np.float64) ** 2)))
        row = {"phase": "multistation", "station": name, "offset_hz": off,
               "audio_max_abs_diff_vs_single": a_err,
               "rds_bits_equal_single": bits_eq,
               "scan_false_audio_max_abs_diff": l_err,
               "scan_false_rds_bits_equal": l_eq, "decode": dec,
               "audio_rms_2nd_half": rms, "audio_atol": RUNNER_AUDIO_ATOL}
        emit(row)
        need(a_err <= RUNNER_AUDIO_ATOL and bits_eq and ok
             and l_err <= RUNNER_AUDIO_ATOL and l_eq and 0.05 < rms < 1.0,
             f"multistation {name}: {row}")
    # one front-end launch a block under the graph (captured before the
    # trace, so no warm-up step is in it)
    _, dl = _device_launches(lambda: demodulate_stations(rx, iq, offsets))
    emit({"phase": "multistation", "what": "device launches under the graph "
          "(profiler)", "blocks": nblk, "device_launches": dl})
    need(dl["frontend"] == nblk and dl["linrec"] == 2 * nblk,
         f"multistation: device launches {dl}, want {nblk} front ends and "
         f"{2 * nblk} scans for all {n} stations")
    for what, kw, per_step, levels in MS_CONFIGS:
        _ms_config(iq, offsets, what, kw, per_step, levels, nblk)
    _mesh_stations(rx, iq, offsets, res)
    times = {k: _ms_times(rx, iq, offs, card)
             for k, offs in ((1, offsets[:1]), (4, offsets),
                             (19, list(RASTER_19)))}
    e1, e19 = (times[k]["device_events_per_step"] for k in (1, 19))
    emit({"phase": "multistation", "what": "device events per step",
          "n1": e1, "n19": e19, "ratio": e19 / e1, "card": card})
    need(abs(e19 - e1) <= 0.10 * e1,
         f"multistation: {e19} device events a step at n = 19 against {e1} "
         f"at n = 1 (want within 10 %)")
    return wav, iq, rx, launches, times


# the option configs of the multistation phase at n = 4: (what, config,
# wrapper launches a step for all the stations, each station's squelch
# level: 100 closes the noise squelch, the others leave it open on these
# stations, whose high/low band ratio is ~0.018)
MS_CONFIGS = (("nsq", dict(squelch="nsq"),
               {"frontend": 1, "linrec": 3, "pole_bank": 1},
               (0.0, 30.0, 60.0, 100.0)),
              ("input filter", dict(input_filter=True),
               {"frontend": 0, "linrec": 2, "pole_bank": 0}, None))
SQ_STATE_RTOL = 1e-4    # of each squelch state leaf's largest magnitude:
                        # the station's squelch state in the n-station step
                        # against its own single-station step's (the inputs
                        # differ by f32 rounding, ~1e-6 of scale)
SQ_STATE_BLOCKS = 4


def _ms_config(iq, offsets, what, kw, per_step, levels, nblk):
    """demodulate_stations on another config at n = 4: each station
    against its own single-station run_offline on the card at its own
    squelch level (audio within RUNNER_AUDIO_ATOL, RDS bits equal, PI/PS at
    BER 0 where the squelch is open, silence and no pilot lock where it is
    closed), the wrappers' counts over the run and the device launches
    under the graph.  With squelch levels, the squelch state (the pole
    banks' states, which the folded S x 2-bank launch computes, the band
    averages and the decision) of every station after SQ_STATE_BLOCKS
    eager n-station steps against its own single-station steps'."""
    from sdrjfm_tpu_torch.models.multistation import demodulate_stations
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu_torch.runtime.graph import WARMUP_STEPS, tree_leaves
    from sdrjfm_tpu_torch.runtime.stream import _wire_blocks, run_offline
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                                 audio_filter_hz=15000, iq_format="i16",
                                 **kw), device="cuda")
    lv = [0.0] * len(offsets) if levels is None else list(levels)
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    res = demodulate_stations(rx, iq, offsets, squelch_levels=levels)
    launches = {k: counters[k].launches for k in per_step}
    steps = WARMUP_STEPS + 1
    _, dl = _device_launches(lambda: demodulate_stations(
        rx, iq, offsets, squelch_levels=levels))

    def single_controls(off, level):
        return rx.initial_controls()._replace(
            lo_freq_hz=torch.tensor(off, dtype=torch.int32, device="cuda"),
            squelch_level=torch.tensor(level, dtype=torch.float32,
                                       device="cuda"))
    rows = []
    for s, (off, pi, name, _, _) in enumerate(MS_STATIONS):
        single = run_offline(rx, iq, single_controls(off, lv[s]))
        r = res[s]
        a_err = (float(np.abs(r["audio"] - single.audio).max())
                 if r["audio"].shape == single.audio.shape else float("inf"))
        bits_eq = bool(np.array_equal(r["rds_bits"], single.rds_bits))
        ok, dec = _station_ok(r["rds_bits"], r["meta"], pi, name)
        rms = float(np.sqrt(np.mean(r["audio"].astype(np.float64) ** 2)))
        closed = lv[s] >= 100.0
        if closed:      # the squelch gates the demod: no pilot, no audio
            ok = rms <= 1e-6 and not r["meta"]["pilot_locked"]
        rows.append({"station": name, "squelch_level": lv[s],
                     "squelch_closed": closed, "audio_rms": rms,
                     "audio_max_abs_diff_vs_single": a_err,
                     "rds_bits_equal_single": bits_eq, "decode": dec,
                     "ok": ok and bits_eq and a_err <= RUNNER_AUDIO_ATOL})
    row = {"phase": "multistation", "what": f"config {what}",
           "stations": len(offsets), "launches": launches,
           "want_launches": {k: v * steps for k, v in per_step.items()},
           "device_launches": {k: dl[k] for k in per_step},
           "want_device_launches": {k: v * nblk
                                    for k, v in per_step.items()},
           "stations_vs_single": rows, "audio_atol": RUNNER_AUDIO_ATOL}
    if levels is not None:
        msr = rx.stations()
        st, ctl = msr.init_states(len(offsets)), msr.controls_for(offsets,
                                                                  levels)
        ones = [(rx.init_state(), single_controls(o, lvl))
                for o, lvl in zip(offsets, lv)]
        wire = _wire_blocks(iq, rx.cfg, SQ_STATE_BLOCKS)
        for b in range(SQ_STATE_BLOCKS):
            blk = torch.from_numpy(wire[b]).to("cuda")
            st, _ = msr.step(st, ctl, blk)
            ones = [(rx.step(o_st, o_ctl, blk)[0], o_ctl)
                    for o_st, o_ctl in ones]
        torch.cuda.synchronize()
        sq_rows, sq_ok = [], True
        for s, (o_st, _) in enumerate(ones):
            errs = []
            for a, b in zip(tree_leaves(st.squelch), tree_leaves(o_st.squelch)):
                a = a[s]
                if a.dtype in (torch.bool, torch.int32, torch.int64):
                    errs.append(0.0 if torch.equal(a, b) else float("inf"))
                    continue
                scale = max(float(b.abs().max()), 1e-30)
                errs.append(float((a - b).abs().max()) / scale)
            sq_rows.append({"squelch_level": lv[s],
                            "leaf_err_of_scale": errs,
                            "suppress": bool(st.squelch.suppress[s])})
            sq_ok &= max(errs) <= SQ_STATE_RTOL
        row.update(squelch_state_vs_single=sq_rows,
                   squelch_state_rtol=SQ_STATE_RTOL,
                   squelch_state_blocks=SQ_STATE_BLOCKS)
        need(sq_ok, f"multistation {what}: squelch state {sq_rows}")
    emit(row)
    need(launches == row["want_launches"]
         and row["device_launches"] == row["want_device_launches"]
         and all(x["ok"] for x in rows), f"multistation {what}: {row}")


def _row_times(rx):
    """Device ms of the row launch at the multi-station and scan paths'
    shapes (R = 4 on one int16 block, 19 and 76 on one and four complex64
    blocks; inputs rotated past the 50 MB L2), 76 one-row launches beside
    the 76-row one, the plain version and a conv1d yardstick at R = 4, and
    each shape's bound."""
    from sdrjfm_tpu_torch.kernels.frontend import (HALO, NTAPS, frontend,
                                                   frontend_rows,
                                                   frontend_rows_plain)
    import torch.nn.functional as F
    dev = rx.device
    T, M = rx.cfg.block_in, rx.cfg.block_fm
    rng = np.random.default_rng(23)
    taps = rx.k_decim12
    it = iter(range(10 ** 9))
    out = {}
    for (what, fmt, n_off, nb), sets in zip(ROW_CASES, (10, 5, 2)):
        cases = [_rows_case(rng, fmt, n_off, nb, T, dev)
                 for _ in range(sets)]
        R = n_off * nb

        def call(c):
            wire, bidx, p = c
            return frontend_rows(wire, fmt, bidx, p[0], taps, *p[1:], True)
        ms, host_us = device_ms(lambda: call(cases[next(it) % sets]),
                                f"frontend rows R={R}")
        wire_b = 8 if fmt == "c64" else 4
        nbytes = (nb * T * wire_b + R * (M * 8 + 2 * HALO * 8 + 5 * 4 + 8)
                  + NTAPS * 4)
        flops = R * (4 * NTAPS * M + 10 * T)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
        out[R] = {"case": what, "ms": ms, "host_us_per_call": host_us,
                  "bound_ms": bound * 1e3,
                  "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                               >= flops / FP32_FLOP_PER_S
                               else "operations")}
        if R == 76:
            def one_rows(c):
                wire, bidx, p = c
                for r in range(R):
                    frontend(wire[r % nb], fmt, p[0][r], taps,
                             *(q[r] for q in p[1:]), True)
            out[R]["ms_76_one_row_launches"], out[R][
                "host_us_76_one_row_launches"] = device_ms(
                lambda: one_rows(cases[next(it) % sets]),
                "frontend 76 one-row launches", iters=4)
        if R == 4:
            wire, bidx, p = cases[0]
            out[R]["plain_ms"] = paced_ms(lambda: frontend_rows_plain(
                wire, fmt, bidx, p[0], taps, *p[1:], True))
            planes = [torch.randn(2 * R, 1, T + NTAPS - 12, device=dev)
                      for _ in range(3)]
            wk = taps.flip(0)[None, None, :].contiguous()
            out[R]["library_ms"], _ = device_ms(
                lambda: F.conv1d(planes[next(it) % 3], wk, stride=12),
                "conv1d R=4")
    return out


def rows_kernel_entry(rx, rows_err, launches, card):
    """The row form's line of the kernels JSON: times at the multi-station
    path's shape (R = 4 stations on one int16 block) with the plain version,
    the conv1d yardstick and the bound, and the times and bounds at R = 19
    and 76; `launches` from the multi-station main path's run."""
    t = _row_times(rx)
    emit({"phase": "times", "what": "frontend rows", "card": card,
          "rows": {str(r): v for r, v in t.items()}})
    four = t[4]
    return {"name": "frontend_rows", "route": "cuda",
            "source": "sdrjfm_tpu_torch/csrc/frontend.cu",
            "replaces": "sdrjfm_tpu/ops/pallas_frontend.py:71",
            "launches": launches["frontend"], "max_abs_err": rows_err,
            "ms": four["ms"], "plain_ms": four["plain_ms"],
            "bound_ms": four["bound_ms"], "bound_by": four["bound_by"],
            "library_ms": four["library_ms"],
            "host_us_per_call": four["host_us_per_call"],
            "ms_by_rows": {str(r): v["ms"] for r, v in t.items()},
            "bound_ms_by_rows": {str(r): v["bound_ms"] for r, v in t.items()},
            "ms_76_one_row_launches": t[76]["ms_76_one_row_launches"],
            "shape": f"R rows in one launch; ms at R = 4: int16 [1, "
                     f"{rx.cfg.block_in}, 2] -> complex64 [4, "
                     f"{rx.cfg.block_fm}] (4 stations on one block); also "
                     f"R = 19 (one complex64 block) and 76 (4 blocks)"}


def phase_scan(card, wav):
    """`python -m sdrjfm_tpu_torch.app scan --iq ... --identify
    --stations ...` on the card over the four-station capture: exactly the
    four offsets, each named (PI, PS) and written to the station list; its
    hits against the same scan on the CPU (offsets equal, contrast within
    SCAN_CONTRAST_ATOL_DB); the wrappers' counts over the card's run; then
    BandScanner.decide's device time at 19 x 4 rows against 76 one-row
    scans."""
    import contextlib
    import io
    from sdrjfm_tpu_torch import app
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav
    from sdrjfm_tpu_torch.kernels.frontend import frontend
    from sdrjfm_tpu_torch.kernels.linrec import linrec
    from sdrjfm_tpu_torch.models.bandscan import BandScanner
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig

    def scan(dev, *flags):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = app.main(["scan", "--iq", str(wav), "--block-fm",
                           str(BLOCK_FM), "--device", dev, *flags])
        need(rc == 0, f"scan on {dev} exited {rc}")
        return json.loads(out.getvalue())["hits"], time.perf_counter() - t0

    stations = ROOT / "chiprun_work" / "stations.json"
    stations.unlink(missing_ok=True)
    frontend.launches = 0
    linrec.launches = 0
    hits, secs = scan("cuda", "--identify", "--seconds", str(MS_SECONDS),
                      "--stations", str(stations))
    launches = {"frontend": frontend.launches, "linrec": linrec.launches}
    cpu_hits, cpu_s = scan("cpu")
    listed = json.loads(stations.read_text())["stations"]
    row = {"phase": "scan", "hits": hits, "s": secs, "cpu_s": cpu_s,
           "launches": launches,
           "station_list": [(e["name"], e["frequency_hz"]) for e in listed]}
    emit(row)
    want = {off: (pi, name) for off, pi, name, _, _ in MS_STATIONS}
    need(sorted(h["offset_hz"] for h in hits) == sorted(want),
         f"scan: hits at {[h['offset_hz'] for h in hits]}, want "
         f"{sorted(want)}")
    for h in hits:
        pi, name = want[h["offset_hz"]]
        need(h.get("pi_code") == f"0x{pi:04X}" and h.get("station") == name
             and h.get("pilot_locked"), f"scan: {h}")
    need(sorted(e["name"] for e in listed)
         == sorted(name for _, _, name, _, _ in MS_STATIONS),
         f"scan: station list {listed}")
    need([h["offset_hz"] for h in cpu_hits] == [h["offset_hz"] for h in hits]
         and all(abs(a["contrast_db"] - b["contrast_db"])
                 <= SCAN_CONTRAST_ATOL_DB for a, b in zip(hits, cpu_hits)),
         f"scan: card hits {hits} vs cpu {cpu_hits}")
    # the wrappers over the card's run: one front end for every row of the
    # scan, then the identify step's warm-up steps and capture, each one
    # front end and two scans for all the hits
    from sdrjfm_tpu_torch.runtime.graph import WARMUP_STEPS
    steps = WARMUP_STEPS + 1
    need(launches == {"frontend": 1 + steps, "linrec": 2 * steps},
         f"scan: wrapper launches {launches}")
    # BandScanner.decide's rows against 76 one-row scans, on the card
    iq, _ = read_iq_wav(str(wav))
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="off"),
                  device="cuda")
    T = rx.cfg.block_in
    nb = 4
    idx = np.linspace(0, len(iq) // T - 1, nb).round().astype(int)
    wire = torch.from_numpy(np.stack([iq[i * T:(i + 1) * T]
                                      for i in idx])).cuda()
    sc = BandScanner(rx)
    offs = list(RASTER_19)
    rows_ms, rows_host = device_ms(lambda: sc.scan(wire, offs),
                                   "band scan 19 x 4 rows", iters=4)

    def one_rows():
        for o in offs:
            for b in range(nb):
                sc.scan(wire[b:b + 1], [o])
    # 76 scans are ~7,000 launches, more than the launch queue holds while
    # a device sleep runs: their device time is the sum of their kernels'
    # times (profiler), beside the same sum for the row call and the wall
    # time of each between CUDA events (host-paced where the host is slower)
    emit({"phase": "scan", "what": "BandScanner.decide device time",
          "rows": len(offs) * nb, "rows_ms": rows_ms,
          "rows_host_us": rows_host,
          "rows_kernel_sum_ms": _kernel_sum_ms(lambda: sc.scan(wire, offs)),
          "rows_event_ms": paced_ms(lambda: sc.scan(wire, offs), iters=4),
          "one_row_scans_kernel_sum_ms": _kernel_sum_ms(one_rows),
          "one_row_scans_event_ms": paced_ms(one_rows, reps=3, iters=1),
          "card": card})
    return launches


# ---------------------------------------------------------------------------
# phases sources, control, checkpoint: the live hardware sources, the
# control channel and checkpoints on the card
# ---------------------------------------------------------------------------

SOURCE_PACE_X = 8.0                # the mock devices stream at this many
                                   # times real time: a block arrives every
                                   # 85 ms, far slower than the card takes
                                   # one, so the 4 Mi-frame ring never fills
                                   # (the fakes' sleeps may pace slower)
FAKE_LIBS = ("rtlsdr", "airspy", "hackrf", "sdrplay")
AIRSPY_BLOCK_FM = 147456           # 12 x 12288: the width nearest the main
                                   # path's that 2.5 MS/s tiles and the RDS
                                   # block decoder's 2048-sample carrier
                                   # phase sub-block divides (122880 fails
                                   # the latter: block_rds 15360)
CONTROL_LO_FROM, CONTROL_LO_TO = -600_000, 300_000   # STATION1 -> STATION3
CONTROL_SCRIPT = {2: ["status", f"tune {CONTROL_LO_TO}"], 3: ["volume -6"],
                  4: ["mute on"], 5: ["mute off", "sound swapped"],
                  6: ["squelch 10"], 7: ["status"], 8: ["iqbalance 20"],
                  9: ["quit"]}


class MockRtlTcp:
    """An rtl_tcp server on 127.0.0.1 for one client: the 12-byte header
    ("RTL0", tuner type 5, 29 gains), the u8 frames paced at SOURCE_PACE_X
    times real time (once, or looped), and a record of every 5-byte
    command."""

    def __init__(self, frames: np.ndarray, loop: bool = False):
        import socket
        import threading
        self.payload = np.ascontiguousarray(frames, np.uint8).tobytes()
        self.loop = loop
        self.commands = []
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self._srv.settimeout(120)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _commands(self, conn):
        buf = b""
        while not self._stop.is_set():
            try:
                data = conn.recv(256)
            except OSError:
                return
            if not data:
                return
            buf += data
            while len(buf) >= 5:
                self.commands.append((buf[0],
                                      int.from_bytes(buf[1:5], "big")))
                buf = buf[5:]

    def _serve(self):
        import socket
        import threading
        try:
            conn, _ = self._srv.accept()
        except OSError:
            return
        threading.Thread(target=self._commands, args=(conn,),
                         daemon=True).start()
        bps = 2 * 2_304_000 * SOURCE_PACE_X
        try:
            conn.sendall(b"RTL0" + (5).to_bytes(4, "big")
                         + (29).to_bytes(4, "big"))
            t0, sent, pos = time.perf_counter(), 0, 0
            while not self._stop.is_set():
                if pos >= len(self.payload):
                    if not self.loop:
                        break
                    pos = 0
                part = self.payload[pos:pos + 262144]
                conn.sendall(part)
                pos += len(part)
                sent += len(part)
                ahead = t0 + sent / bps - time.perf_counter()
                if ahead > 0:
                    time.sleep(ahead)
                else:
                    # behind (the client was not reading yet): the
                    # schedule moves, no burst makes the time up
                    t0 -= ahead
            conn.shutdown(socket.SHUT_WR)
            time.sleep(0.5)               # the client drains, sends the rest
        except OSError:
            pass
        finally:
            conn.close()

    def close(self):
        self._stop.set()
        self._srv.close()
        self._thread.join(10)


def _card_captures(wav):
    """The 8 s synth capture in each live wire format: u8 and i8 (the
    rtl_sdr and hackrf conventions) and i16 at 2.304 MS/s, and the airspy's
    12-bit i16 at 2.5 MS/s."""
    from scipy.signal import resample_poly
    from sdrjfm_tpu_torch.io.synth import iq_to_i8, iq_to_u8
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav
    iq, _ = read_iq_wav(str(wav))

    def i16(x, scale):
        out = np.empty((len(x), 2), np.int16)
        out[:, 0] = np.round(x.real * scale)
        out[:, 1] = np.round(x.imag * scale)
        return out
    return {"u8": iq_to_u8(iq), "i8": iq_to_i8(iq * 0.95),
            "i16": i16(iq, 4095),
            "airspy": i16(resample_poly(iq, 625, 576).astype(np.complex64),
                          2047)}


def _build_fake_libs(outdir):
    """The four fake vendor libraries (tests/fake_lib*.c) built with cc,
    all together."""
    native = ROOT / "sdrjfm_tpu_torch" / "runtime" / "native"

    def build(name):
        so = outdir / f"libfake{name}.so"
        subprocess.run([os.environ.get("CC", "cc"), "-shared", "-fPIC",
                        "-O2", f"-I{native}", "-o", str(so),
                        str(ROOT / "tests" / f"fake_lib{name}.c"),
                        "-lpthread"], check=True, capture_output=True)
        return name, str(so)
    with ThreadPoolExecutor(len(FAKE_LIBS)) as ex:
        return dict(ex.map(build, FAKE_LIBS))


def _cli_run(argv, counters=("frontend", "linrec")):
    """`rx` in process with its stderr kept: (exit code, stderr, the
    wrappers' launch counts over the run, set to 0 just before it)."""
    import contextlib
    import io
    from sdrjfm_tpu_torch import app
    cs = _counters()
    for k in counters:
        cs[k].launches = 0
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = app.main(argv)
    return rc, err.getvalue(), {k: cs[k].launches for k in counters}


def _live_ok(rep, pi="0x10F0", ps="TPU FM", rt="VERIFY RUN"):
    rds = rep.get("rds", {})
    return (rds.get("pi_code") == pi and rds.get("station_label", "").strip()
            == ps and (rt is None or rds.get("radio_text") == rt)
            and rds.get("bit_error_rate") == 0.0
            and rep["meta_last"].get("pilot_locked")
            and rep.get("ingest_dropped") == 0)


def phase_sources(card, wav):
    """Every live hardware source through `rx` on the card at block_fm
    131072 (airspy at AIRSPY_BLOCK_FM): rtl_tcp over MockRtlTcp with the
    device flags, and the four in-process USB devices on their fake vendor
    libraries, each streaming the 8 s synth capture once at SOURCE_PACE_X
    times real time.  Each decodes PI/PS/RT at BER 0 with no drop; the
    wrappers count the warm-up steps and the capture; a profiler trace of
    the same run holds one front-end launch a block (airspy's too: the
    kernel reads its stream after the torch rate map).  The rtl_tcp server saw the rate, ppm, gain
    mode, gain and frequency commands."""
    import shutil
    from sdrjfm_tpu_torch.runtime.graph import WARMUP_STEPS
    tmp = ROOT / "chiprun_work" / "sources"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        caps = _card_captures(wav)
        libs = _build_fake_libs(tmp)
        steps = WARMUP_STEPS + 1
        rows = []

        def run(name, argv, env=None):
            rep = tmp / f"{name}.json"

            def once():
                if env is not None:
                    env()
                return _cli_run(["rx", *argv, "--rds", "--report", str(rep),
                                 "--device", "cuda"])
            t0 = time.perf_counter()
            (rc, err, launches), device = _device_launches(once)
            secs = time.perf_counter() - t0
            need(rc == 0, f"sources {name}: rx exited {rc}: {err[-2000:]}")
            r = json.loads(rep.read_text())
            row = {"phase": "sources", "source": name, "blocks": r["blocks"],
                   "launches": launches, "device_launches": device,
                   "rds": {k: r["rds"][k] for k in
                           ("pi_code", "station_label", "radio_text",
                            "bit_error_rate", "groups_decoded")},
                   "ingest_dropped": r["ingest_dropped"],
                   "latency_ms": r.get("latency_ms"),
                   "throughput_x_realtime": r["throughput_x_realtime"],
                   "pace_x": SOURCE_PACE_X, "s": secs,
                   # the wait for the next block, which run_live reads
                   # before it fetches this block's audio (JAX's order):
                   # the part of latency_ms that the pacing sets
                   "arrival_ms_at_pace": (r["latency_ms"]["block"]
                                          / SOURCE_PACE_X
                                          if "latency_ms" in r else None),
                   "card": card}
            if "device" in r:
                row["device"] = r["device"]
            rows.append(row)
            emit(row)
            need(_live_ok(r), f"sources {name}: decode {row}")
            want = {"frontend": steps, "linrec": 2 * steps}
            need(launches == want, f"sources {name}: wrapper launches "
                 f"{launches}, want {want}")
            need(device["frontend"] == r["blocks"] + WARMUP_STEPS,
                 f"sources {name}: {device['frontend']} front ends under "
                 f"the graph for {r['blocks']} blocks")
            return r, err

        # rtl_tcp, with the device flags and the meter
        srv = {}

        def serve():
            if "s" in srv:
                srv["s"].close()
            srv["s"] = MockRtlTcp(caps["u8"])
            srv["url"] = f"rtl_tcp://127.0.0.1:{srv['s'].port}"
        serve()
        argv = ["--iq", "{url}", "--follow", "--tune-hz", "98000000",
                "--gain", "300", "--ppm", "5", "--meter", "--block-fm",
                str(BLOCK_FM)]

        def rtltcp_env():
            if srv["s"].commands:            # a traced rerun: a new server
                serve()
            argv[1] = srv["url"]
        rtltcp_env()
        r, err = run("rtl_tcp", argv, rtltcp_env)
        time.sleep(0.3)
        cmds = list(srv["s"].commands)
        srv["s"].close()
        emit({"phase": "sources", "source": "rtl_tcp", "commands": cmds,
              "meter_lines": err.count("\r"), "card": card})
        need(cmds[:5] == [(2, 2_304_000), (5, 5), (3, 1), (4, 300),
                          (1, 98_000_000)],
             f"sources rtl_tcp: the server saw {cmds}")
        need(r["device"] == {"tuner_type": 5, "tuner_gain_count": 29,
                             "reconnects": 0} and "pilot=LOCK" in err,
             f"sources rtl_tcp: device {r.get('device')}, meter")
        # the in-process devices on their fakes
        for name, fmt, dev_argv, block_fm in (
                ("rtlsdr", "u8", ["--iq", "rtlsdr:0", "--gain", "297"],
                 BLOCK_FM),
                ("hackrf", "i8", ["--iq", "hackrf", "--lna-gain", "24"],
                 BLOCK_FM),
                ("sdrplay", "i16", ["--iq", "sdrplay", "--follow", "--grdb",
                                    "40"], BLOCK_FM),
                ("airspy", "airspy", ["--iq", "airspy", "--linearity", "12"],
                 AIRSPY_BLOCK_FM)):
            cap = tmp / f"{name}.raw"
            caps[fmt].tofile(cap)
            env = name.upper()
            rate = 2_500_000 if name == "airspy" else 2_304_000
            os.environ[f"SDRJFM_LIB{env}"] = libs[name]
            os.environ[f"FAKE_{env}_IQ"] = str(cap)
            os.environ[f"FAKE_{env}_FPS"] = str(int(rate * SOURCE_PACE_X))
            os.environ[f"FAKE_{env}_LOOP"] = "0"
            try:
                run(name, [*dev_argv, "--tune-hz", "98000000", "--block-fm",
                           str(block_fm)])
            finally:
                for k in (f"SDRJFM_LIB{env}", f"FAKE_{env}_IQ",
                          f"FAKE_{env}_FPS", f"FAKE_{env}_LOOP"):
                    os.environ.pop(k, None)
            cap.unlink()
        return rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class _Script:
    """A control channel stand-in: `poll` hands out the commands scripted
    for each block in turn, `respond` keeps the responses."""

    def __init__(self, script):
        self.script, self.n, self.responses = dict(script), 0, []

    def poll(self):
        self.n += 1
        return self.script.get(self.n - 1, [])

    def respond(self, obj):
        self.responses.append(obj)


def _scripted_run(ms_wav, dev):
    """CONTROL_SCRIPT through CommandProcessor.apply as run_live's
    command_hook over an unpaced NativeRawSource of the four-station
    capture: (result, responses, the PI decoded before the retune, the
    RDS decoder, the wrappers' launches over the run, retune_reset count)."""
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu_torch.rds.live import LiveRDSDecoder
    from sdrjfm_tpu_torch.runtime.control import CommandProcessor
    from sdrjfm_tpu_torch.runtime.graph import upload
    from sdrjfm_tpu_torch.runtime.native_source import NativeRawSource
    from sdrjfm_tpu_torch.runtime.stream import run_live
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                                 audio_filter_hz=15000, iq_format="i16"),
                  device=dev)
    live = LiveRDSDecoder()
    seen = {}
    resets = [0]
    reset = rx.retune_reset

    def counted_reset(state):
        resets[0] += 1
        return reset(state)
    rx.retune_reset = counted_reset

    def on_retune():
        seen["pi"] = live.result.pi_code
        seen["ber"] = live.sync.bit_error_rate
        live.reset()
    chan = _Script(CONTROL_SCRIPT)
    proc = CommandProcessor(rx, chan, lo_hz=CONTROL_LO_FROM,
                            on_retune=on_retune)
    ctl = rx.initial_controls()._replace(
        lo_freq_hz=upload(CONTROL_LO_FROM, torch.int32, rx.device))
    proc.seed_from(ctl)
    cs = _counters()
    for k in ("frontend", "linrec"):
        cs[k].launches = 0
    rx.jit_step().prepare()               # before the producer starts
    with NativeRawSource(str(ms_wav), pace=False) as src:
        res = run_live(rx, src, ctl, rds_feedback=live.feed,
                       command_hook=proc.apply)
    launches = {k: cs[k].launches for k in ("frontend", "linrec")}
    return res, chan.responses, seen, live, launches, resets[0], proc


def _apply_us(dev, script, n: int = 200) -> float:
    """Median host us of CommandProcessor.apply with `script(i)` queued
    before call i, on the captured step's buffers (no device sync asked
    for; a synchronising CUDA call inside raises)."""
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu_torch.runtime.control import CommandProcessor
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                                 audio_filter_hz=15000, iq_format="i16"),
                  device=dev)
    sg = rx.jit_step()
    sg.prepare()
    chan = _Script({i: script(i) for i in range(n)})
    proc = CommandProcessor(rx, chan)
    state, ctl = sg.state, sg.controls
    meta = {"pilot_locked": True, "dc_if": 0.0}
    times = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            state, new_ctl, _ = proc.apply(state, ctl, meta)
            times.append((time.perf_counter() - t0) * 1e6)
            sg.load(state, new_ctl)       # what the next step takes in
            ctl = new_ctl
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return statistics.median(times), ctl


def phase_control(card, ms_wav, wav):
    """The control channel on the card.  CONTROL_SCRIPT (tune from STATION1
    to STATION3, volume, mute and unmute, sound, iqbalance, squelch,
    status, quit) through CommandProcessor.apply as run_live's hook over
    the four-station capture, on the card and on the CPU: the card's audio
    within OPT_AUDIO_ATOL of the CPU's, the responses equal (the status
    metadata within 1e-3), PI 0x1111 before the retune and 0x3333 after,
    each at BER 0, retune_reset fired once; the wrappers' counts over the
    card's run.  The host us of an idle apply, a dirty one and a retune,
    with CUDA's sync debug mode set to raise.  Then `rx --follow --control
    <socket>` over MockRtlTcp: `tune` outside the window and back, two
    frequency commands on the wire and control.hw_retunes 2."""
    import socket
    import threading
    from sdrjfm_tpu_torch.runtime.graph import WARMUP_STEPS
    runs = {dev: _scripted_run(ms_wav, dev) for dev in ("cuda", "cpu")}
    (res, resp, seen, live, launches, resets, proc) = runs["cuda"]
    (cres, cresp, cseen, clive, _, cresets, _) = runs["cpu"]
    same_shape = res.audio.shape == cres.audio.shape
    a_err = (float(np.abs(res.audio.astype(np.float64)
                          - cres.audio.astype(np.float64)).max())
             if same_shape else float("inf"))

    def strip(rs):
        return [{k: v for k, v in r.items() if k != "meta"} for r in rs]
    # the status metadata within 1e-3; latency_ms is the host's clock
    metas_close = all(
        abs(a["meta"][k] - b["meta"][k]) <= 1e-3 * max(1, abs(b["meta"][k]))
        for a, b in zip(resp, cresp) if "meta" in a
        for k in b["meta"] if k != "latency_ms")
    pis = (seen.get("pi"), live.result.pi_code)
    row = {"phase": "control", "what": "scripted run", "blocks":
           len(res.meta), "cpu_blocks": len(cres.meta),
           "audio_max_abs_diff_vs_cpu": a_err, "atol": OPT_AUDIO_ATOL,
           "responses": strip(resp), "responses_equal":
           strip(resp) == strip(cresp) and metas_close,
           "pi_before": f"0x{pis[0] or 0:04X}", "pi_after":
           f"0x{pis[1]:04X}", "ber_before": seen.get("ber"),
           "ber_after": live.sync.bit_error_rate,
           "retune_resets": resets, "launches": launches, "card": card}
    emit(row)
    need(len(res.meta) == len(cres.meta) == 10 and a_err <= OPT_AUDIO_ATOL,
         f"control: card vs cpu {row}")
    need(row["responses_equal"], f"control: responses {resp} vs {cresp}")
    need(pis == (0x1111, 0x3333) and seen.get("ber") == 0.0
         and live.sync.bit_error_rate == 0.0
         and (cseen.get("pi"), clive.result.pi_code) == pis,
         f"control: PI flip {row}")
    need(resets == cresets == 1 and proc.retunes == 1,
         f"control: retune_reset fired {resets} times")
    steps = WARMUP_STEPS + 1
    need(launches == {"frontend": steps, "linrec": 2 * steps},
         f"control: wrapper launches {launches}")
    # the host cost of apply on the card
    idle_us, _ = _apply_us("cuda", lambda i: [])
    dirty_us, ctl = _apply_us("cuda", lambda i: [f"volume {-(i % 7)}"])
    tune_us, _ = _apply_us("cuda", lambda i: [
        f"tune {(1 - 2 * (i % 2)) * 400_000}"])
    emit({"phase": "control", "what": "apply host us (median of 200; sync "
          "debug mode raising)", "idle_us": idle_us, "dirty_us": dirty_us,
          "retune_us": tune_us, "card": card})
    need(abs(float(ctl.volume.cpu()) - 10.0 ** (-(199 % 7) / 20.0)) < 1e-6,
         "control: the last dirty apply's volume")
    # the CLI over rtl_tcp, steered through a socket
    caps = _card_captures(wav)
    tmp = ROOT / "chiprun_work" / "control"
    tmp.mkdir(parents=True, exist_ok=True)
    ctl_path, rep = tmp / "ctl.sock", tmp / "rep.json"
    srv = MockRtlTcp(caps["u8"], loop=True)
    got, box = [], {}

    def client():
        deadline = time.time() + 120
        while not ctl_path.exists() and time.time() < deadline:
            time.sleep(0.05)
        cli = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        cli.connect(str(ctl_path))
        cli.settimeout(120)
        buf = b""
        try:
            for line in ("status", "tune 99500000", "tune 98000000",
                         "status", "quit"):
                time.sleep(0.5)
                cli.sendall(line.encode() + b"\n")
                while b"\n" not in buf:
                    buf += cli.recv(65536)
                out, buf = buf.split(b"\n", 1)
                got.append(json.loads(out))
        finally:
            cli.close()
    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        rc, err, cli_launches = _cli_run([
            "rx", "--iq", f"rtl_tcp://127.0.0.1:{srv.port}", "--follow",
            "--block-fm", str(BLOCK_FM), "--rds", "--control", str(ctl_path),
            "--report", str(rep), "--device", "cuda"])
        th.join(60)
        time.sleep(0.3)
    finally:
        srv.close()
    need(rc == 0, f"control CLI: rx exited {rc}: {err[-2000:]}")
    r = json.loads(rep.read_text())
    freqs = [p for c, p in srv.commands if c == 0x01]
    row = {"phase": "control", "what": "rx --follow --control over "
           "rtl_tcp", "responses": [{k: v for k, v in g.items()
                                     if k not in ("meta", "rds")}
                                    for g in got],
           "freq_commands": freqs, "report_control": r.get("control"),
           "blocks": r["blocks"], "launches": cli_launches, "card": card}
    emit(row)
    need(len(got) == 5 and freqs == [99_500_000, 98_000_000]
         and r["control"]["hw_retunes"] == 2
         and r["control"]["tuned_hz"] == 98_000_000
         and got[3]["center_hz"] == 98_000_000, f"control CLI: {row}")
    need(cli_launches == {"frontend": steps, "linrec": 2 * steps},
         f"control CLI: wrapper launches {cli_launches}")
    ctl_path.unlink(missing_ok=True)


def _wav_head(src, dst, first_block: int):
    """The capture from block `first_block` on, as an int16 wav."""
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw, write_iq_wav
    iq, rate = read_iq_wav_raw(str(src))
    x = np.asarray(iq[first_block * BLOCK_FM * 12:], np.float32) / 32768.0
    write_iq_wav(str(dst), (x[:, 0] + 1j * x[:, 1]).astype(np.complex64),
                 rate, float32=False)


def _trace_kernels(path) -> dict:
    """Device kernel launches in an exported Chrome trace, by counter name
    (DEVICE_KERNELS: a name holding the kernel's)."""
    ev = [e for e in json.loads(Path(path).read_text())["traceEvents"]
          if e.get("cat") == "kernel"]
    return {k: sum(n in e.get("name", "") for e in ev)
            for k, n in DEVICE_KERNELS.items()} if ev else {}


def phase_checkpoint(card, wav):
    """Checkpoints on the main path (the 8 s capture, 11 blocks).  `rx
    --ckpt-dir D --ckpt-every 4 --ckpt-keep 2` leaves steps 4 and 8; `rx
    --load-state D` on the capture from block 8 on gives audio within
    RUNNER_AUDIO_ATOL of the uninterrupted run's blocks 8-10 (float32
    wavs), and through the runners the RDS bits equal; the card's
    checkpoint resumes on the CPU within OPT_AUDIO_ATOL; another config's
    load exits 2 with the fingerprint message; `rx --profile DIR` writes a
    trace holding one front-end launch a block.  Times: ms per
    CheckpointManager.save of the card's state, and run_offline's wall ms
    per block with and without a save every block."""
    import shutil
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw, read_wav
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                     load_state)
    from sdrjfm_tpu_torch.runtime.graph import WARMUP_STEPS, tree_leaves
    from sdrjfm_tpu_torch.runtime.stream import run_offline
    tmp = ROOT / "chiprun_work" / "checkpoint"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        base = ["--rds", "--block-fm", str(BLOCK_FM), "--float32",
                "--device", "cuda"]
        ck = tmp / "ck"
        rc, err, launches = _cli_run([
            "rx", "--iq", str(wav), "--ckpt-dir", str(ck), "--ckpt-every",
            "4", "--ckpt-keep", "2", "--audio", str(tmp / "full.wav"),
            "--report", str(tmp / "full.json"), *base])
        need(rc == 0, f"checkpoint: rx --ckpt-dir exited {rc}: {err[-2000:]}")
        steps = sorted(os.listdir(ck))
        tail = tmp / "tail.wav"
        _wav_head(wav, tail, 8)
        rc, err, rlaunches = _cli_run([
            "rx", "--iq", str(tail), "--load-state", str(ck), "--audio",
            str(tmp / "rest.wav"), "--report", str(tmp / "rest.json"),
            *base])
        need(rc == 0, f"checkpoint: rx --load-state exited {rc}: "
             f"{err[-2000:]}")
        full, _ = read_wav(str(tmp / "full.wav"))
        rest, _ = read_wav(str(tmp / "rest.wav"))
        ba = 8 * (BLOCK_FM // 4)
        same = rest.shape == full[ba:].shape
        cli_err = (float(np.abs(rest - full[ba:]).max()) if same
                   else float("inf"))
        # the same through the runners, for the bits; and on the CPU
        iq, _ = read_iq_wav_raw(str(wav))
        cfg = ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                             audio_filter_hz=15000, iq_format="i16")
        rx = Receiver(cfg, device="cuda")
        mgr = CheckpointManager(str(tmp / "api"), cfg=cfg, max_to_keep=1)
        uninterrupted = run_offline(rx, iq, on_state=lambda b, s: (
            mgr.save(b, s) if b == 8 else None))
        mgr.close()
        T = cfg.wire_len
        rx2 = Receiver(cfg, device="cuda")
        state, _ = load_state(str(tmp / "api"), rx2.init_state(), cfg=cfg)
        resumed = run_offline(rx2, iq[8 * T:], init_state=state)
        bits_after = uninterrupted.rds_bits[-len(resumed.rds_bits):]
        api_err = float(np.abs(resumed.audio - uninterrupted.audio[ba:]).max())
        rx_cpu = Receiver(cfg, device="cpu")
        cstate, _ = load_state(str(tmp / "api"), rx_cpu.init_state(),
                               cfg=cfg)
        on_cpu = run_offline(rx_cpu, iq[8 * T:], init_state=cstate)
        cpu_err = float(np.abs(on_cpu.audio - uninterrupted.audio[ba:]).max())
        # another configuration's load
        rc_bad, err_bad, _ = _cli_run([
            "rx", "--iq", str(tail), "--load-state", str(ck),
            "--rds-decoder", "scan2", *base])
        # --profile: one front end a block in the trace
        prof = tmp / "prof"
        for _ in range(PROFILE_TRIES):
            shutil.rmtree(prof, ignore_errors=True)
            rc_p, err_p, _ = _cli_run([
                "rx", "--iq", str(wav), "--profile", str(prof), "--report",
                str(tmp / "prof.json"), *base])
            need(rc_p == 0, f"checkpoint: rx --profile exited {rc_p}")
            traces = list(prof.glob("trace_*.json"))
            kern = _trace_kernels(traces[0]) if traces else {}
            if kern:
                break
            print("chip_smoke: rx --profile's trace held no device event; "
                  "tracing the run again", file=sys.stderr, flush=True)
        pblocks = json.loads((tmp / "prof.json").read_text())["blocks"]
        row = {"phase": "checkpoint", "steps": steps,
               "cli_resume_audio_max_abs_diff": cli_err,
               "api_resume_audio_max_abs_diff": api_err,
               "resume_bits_equal": bool(np.array_equal(resumed.rds_bits,
                                                        bits_after)),
               "cpu_resume_audio_max_abs_diff": cpu_err,
               "atol": RUNNER_AUDIO_ATOL, "cpu_atol": OPT_AUDIO_ATOL,
               "other_config_exit": rc_bad,
               "other_config_message": err_bad.strip().splitlines()[-1],
               "profile_trace_frontend": kern.get("frontend", 0),
               "profile_blocks": pblocks, "launches": launches,
               "resume_launches": rlaunches, "leaves": len(tree_leaves(
                   rx.init_state())), "card": card}
        emit(row)
        need(steps == ["ckpt_000000000004.npz", "ckpt_000000000008.npz"],
             f"checkpoint: steps {steps}")
        need(cli_err <= RUNNER_AUDIO_ATOL and api_err <= RUNNER_AUDIO_ATOL
             and row["resume_bits_equal"] and len(resumed.rds_bits) > 0,
             f"checkpoint: resume {row}")
        need(cpu_err <= OPT_AUDIO_ATOL, f"checkpoint: CPU resume {cpu_err}")
        need(rc_bad == 2 and "different receiver configuration" in err_bad,
             f"checkpoint: another config's load: {rc_bad} {err_bad[-500:]}")
        need(row["profile_trace_frontend"] == pblocks + WARMUP_STEPS,
             f"checkpoint: --profile trace {kern}")
        wsteps = WARMUP_STEPS + 1
        for what, got in (("--ckpt-dir", launches), ("--load-state",
                                                     rlaunches)):
            need(got == {"frontend": wsteps, "linrec": 2 * wsteps},
                 f"checkpoint: {what} wrapper launches {got}")
        # times: a save of the card's state, the loop runner with and
        # without a save every block
        sg = rx.jit_step()
        saver = CheckpointManager(str(tmp / "timed"), cfg=cfg, max_to_keep=2)
        save_ms = []
        for i in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            saver.save(i + 1, sg.state)
            save_ms.append((time.perf_counter() - t0) * 1e3)
        saver.close()

        def per_block(on_state):
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = run_offline(rx, iq, on_state=on_state)
                walls.append((time.perf_counter() - t0) * 1e3 / len(r.meta))
            return statistics.median(walls), min(walls), max(walls)
        every = CheckpointManager(str(tmp / "every"), cfg=cfg, max_to_keep=2)
        plain = per_block(None)
        saving = per_block(lambda b, s: every.save(b, s))
        every.close()
        emit({"phase": "checkpoint", "what": "times", "save_ms_median":
              statistics.median(save_ms), "save_ms_min": min(save_ms),
              "save_ms_max": max(save_ms), "state_bytes": sum(
                  t.numel() * t.element_size()
                  for t in tree_leaves(sg.state)),
              "loop_ms_per_block": plain[0], "loop_ms_spread": plain[1:],
              "loop_ckpt_every_1_ms_per_block": saving[0],
              "loop_ckpt_every_1_spread": saving[1:], "card": card})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase sharded: the time axis over torch.distributed
# ---------------------------------------------------------------------------

# ShardedReceiver: its front end (the 192 kS/s stream and the DC servo,
# the tile sums reduced in the kernel's own order) must equal the
# single-device front end's bit for bit; its audio comes from the same
# replicated fm chain, held to RUNNER_AUDIO_ATOL: two eager single-device
# runs on an H100 differ by up to 6.5e-6 themselves (a look-back scan's
# timing-dependent join), printed beside it
FULL_ATOL = 2e-4                   # FullyShardedReceiver vs the eager step:
                                   # f32 prefix reassociation
                                   # (tests/test_sharding.py:104)
NSQ_ATOL = 5e-4                    # with the noise squelch (the widest
                                   # tolerance of tests/test_sharding.py)
ST_ATOL = 5e-4                     # StationTimeShardedReceiver vs
                                   # MultiStationReceiver (test_sharding.py)
SHARD_HEAVY = dict(input_filter=True, squelch="nsq", rds="scan2")
SHARD_TIMEOUT_S = 300


def _shard_run(ranks, jobs, work, dev):
    """Every job on `ranks` ranks on `dev` (the card(s)), each rank a
    spawned process; returns ({job: [per-rank dict of arrays]}, seconds)."""
    from sdrjfm_tpu_torch.parallel.multihost_worker import run_jobs, spawn
    d = work / f"ranks{ranks}"
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    spawn(run_jobs, ranks, args=(jobs, str(d)), device=dev,
          timeout=SHARD_TIMEOUT_S)
    secs = time.perf_counter() - t0
    out = {}
    for j in jobs:
        out[j["name"]] = []
        for r in range(ranks):
            with np.load(d / f"{j['name']}.rank{r}.npz") as z:
                row = {k: z[k] for k in z.files}
            row["info"] = json.loads(str(row["info"]))
            out[j["name"]].append(row)
    return out, secs


def _stitch(zs, block_len):
    """The ranks' audio slices in time order."""
    per = block_len // len(zs)
    nb = zs[0]["audio"].shape[0] // per
    return np.concatenate([z["audio"][b * per:(b + 1) * per]
                           for b in range(nb) for z in zs])


def _rank_kernels(z) -> dict:
    """A rank's device kernel launches a step, by counter name, from the
    profiler trace of its job (PROFILED_STEPS steps)."""
    i = z["info"]
    n = max(i["profiled_steps"], 1)
    return {k: sum(c for name, c in i["kernels"].items() if kn in name) / n
            for k, kn in DEVICE_KERNELS.items()}


def _shard_line(what, zs, card, **extra):
    """A sharded run's line: the transport, the cards, the ranks a card,
    the collectives a step, each rank's launches (wrappers) and device
    kernels a step (profiler, every rank), step and collective ms."""
    infos = [z["info"] for z in zs]
    cards = max(torch.cuda.device_count(), 1)
    ranks = len(zs)
    row = {"phase": "sharded", "what": what, "ranks": ranks,
           "transport": infos[0]["transport"], "cards": cards,
           "ranks_per_card": -(-ranks // cards),
           "devices": [i["device"] for i in infos],
           "collectives_per_step": [i["counts"] for i in infos],
           "wrapper_launches_per_rank": [i["launches"] for i in infos],
           "device_kernels_per_step": [_rank_kernels(z) for z in zs],
           "blocks": infos[0]["blocks"],
           "step_ms_median_per_rank": [
               statistics.median(z["step_ms"][1:]) for z in zs],
           "collective_ms_median_per_rank": [
               statistics.median(z["collective_ms"][1:]) for z in zs],
           "times_note": ("ranks share a card: not a scaling figure"
                          if ranks > cards else "one rank a card"),
           "card": card}
    row.update(extra)
    emit(row)
    return row


def _bits_match(z, want_bits, want_counts, j: int = 0) -> dict:
    """A sharded rank's RDS bits against a single-device run's: every
    block's count, the whole stream, and the stream from the second block
    on.  A cold start's first bits come from a stream that is still
    ramping up, where f32 reassociation of the distributed recurrences
    (~1e-6) can flip a decision sitting at the threshold (seen on the CPU:
    bits 2 and 3 of 8918); from the second block on they must be equal.
    j: the station of a station-time rank."""
    mv = z["meta_vec"]
    counts = mv[..., -1].reshape(mv.shape[0], -1)[:, j].astype(int).tolist()
    got = z[f"bits{j}"]
    return {"counts_equal": counts == list(want_counts),
            "all_equal": bool(np.array_equal(got, want_bits)),
            "equal_after_first_block": bool(np.array_equal(
                got[counts[0]:], want_bits[want_counts[0]:]))}


def _meta_last(z, j: int = 0):
    from sdrjfm_tpu_torch.models.receiver import meta_dict_from_vec
    mv = z["meta_vec"]
    return meta_dict_from_vec(mv.reshape(mv.shape[0], -1, mv.shape[-1])
                              [-1, j])[0]


def _shard_worker(work, card, dev):
    """parallel.multihost_worker on the card: two processes of one rank,
    each staging only its host_slice, against one process of two ranks."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    mod = "sdrjfm_tpu_torch.parallel.multihost_worker"
    runs = [(work / "w2.store", pid, 2, 1, work / f"w2_p{pid}.json")
            for pid in range(2)] + [(work / "w1.store", 0, 1, 2,
                                     work / "w1.json")]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", mod, str(st), str(pid),
                               str(n), str(rpp), str(out), "3", "--device",
                               dev], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for st, pid, n, rpp, out in runs]
    for p in procs:
        try:
            _, err = p.communicate(timeout=SHARD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            need(False, "sharded: multihost_worker timed out")
        need(p.returncode == 0, f"sharded: multihost_worker exited "
             f"{p.returncode}: {err.decode()[-2000:]}")
    secs = time.perf_counter() - t0
    r0, r1, one = (json.loads(r[4].read_text()) for r in runs)
    row = {"phase": "sharded", "what": "multihost_worker: 2 processes x 1 "
           "rank vs 1 process x 2 ranks, each rank staging its host_slice",
           "transport": r0["transport"], "devices": [r0["device"],
                                                     r1["device"]],
           "cards": torch.cuda.device_count(), "bits": len(r0["bits"]),
           "bits_equal_across_processes": r0["bits"] == r1["bits"],
           "rms_equal_across_processes": r0["rms"] == r1["rms"],
           "equal_to_one_process": (r0["bits"] == one["bits"]
                                    and r0["rms"] == one["rms"]),
           "rms": r0["rms"], "s": secs, "card": card}
    emit(row)
    need(row["bits_equal_across_processes"]
         and row["rms_equal_across_processes"]
         and row["equal_to_one_process"] and len(r0["bits"]) > 200,
         f"sharded worker: {row}")


def phase_sharded(card, wav, ms_wav, dev="cuda"):
    """The time axis over torch.distributed on the card(s): ranks are
    spawned processes; with fewer cards than ranks they share a card
    through gloo with host-staged collectives (NCCL refuses two ranks on
    one device), with a card each through NCCL.  On the 8 s capture at
    block_fm=131072 (int16 wire): ShardedReceiver at 2 ranks, its front end
    and DC servo bit for bit the single-device front end's, its audio
    against the eager single-device step (RUNNER_AUDIO_ATOL, beside two
    eager runs' own difference);
    FullyShardedReceiver at 2 and 4 ranks (FULL_ATOL, PI/PS/RT at BER 0,
    at most 5 gathers and 8 halos a step) and at 2 ranks on the heavy
    config (input filter + nsq + scan2: kernel A and B2 under sharding,
    NSQ_ATOL); StationTimeShardedReceiver 2 x 2 on two stations of the
    four-station capture against MultiStationReceiver (ST_ATOL, PI/PS at
    BER 0); the RDS bits of these (_bits_match): every block's count
    equal, the stream equal from the second block on, and whether it is
    equal from the first printed; every rank's device kernels of one step
    from a profiler trace; then multihost_worker.  Each line names the
    transport, the cards and the ranks a card; the step and collective ms
    of ranks sharing a card are not scaling figures.  dev="cpu" rehearses
    the phase on the CPU (gloo ranks, no profiler)."""
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw
    from sdrjfm_tpu_torch.models.multistation import MultiStationReceiver
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu_torch.runtime.graph import tree_index
    t_phase = time.perf_counter()
    work = ROOT / "chiprun_work" / "sharded"
    work.mkdir(parents=True, exist_ok=True)
    iq, _ = read_iq_wav_raw(str(wav))
    ms_iq, _ = read_iq_wav_raw(str(ms_wav))
    np.save(work / "main.npy", iq)
    np.save(work / "stations.npy", ms_iq)
    main_kw = dict(block_fm=BLOCK_FM, rds="block", audio_filter_hz=15000,
                   iq_format="i16")
    heavy_kw = dict(main_kw, **SHARD_HEAVY)
    st_offsets = [st[0] for st in MS_STATIONS]      # two a station group
    cards = torch.cuda.device_count()
    emit({"phase": "sharded", "what": "setup", "cards": cards,
          "transport_2_ranks": "nccl" if cards >= 2
          else "gloo, host-staged CUDA tensors",
          "dc_servo": "each rank's per-tile DC sums (the kernel's partials) "
                      "ride the end-of-chain gather and are reduced in the "
                      "kernel's own order: the single-device mean bit for "
                      "bit",
          "front_end_halo": "the left neighbour's last 384 wire samples "
                            "through frontend_kernel with its NCO phase",
          "graphs": "the sharded step runs eagerly (no CUDA graph)"})

    def job(name, cls, kw, cap="main.npy"):
        return dict(name=name, kind="receiver", cls=cls, cfg=kw,
                    capture=str(work / cap), profile=True)

    two, t2 = _shard_run(2, [
        dict(job("sr", "ShardedReceiver", main_kw), front_end=True),
        job("fsr", "FullyShardedReceiver", main_kw),
        job("heavy", "FullyShardedReceiver", heavy_kw)], work, dev)
    four, t4 = _shard_run(4, [
        job("fsr", "FullyShardedReceiver", main_kw),
        dict(name="st", kind="station_time", n_stations=2, cfg=main_kw,
             capture=str(work / "stations.npy"), offsets=st_offsets,
             profile=True)], work, dev)

    # the yardsticks: the eager single-device step on the card
    rx = Receiver(ReceiverConfig(**main_kw), device=dev)
    eager = _eager_offline(rx, iq)
    again = _eager_offline(rx, iq)
    floor = float(np.abs(eager.audio - again.audio).max())
    heavy = _eager_offline(Receiver(ReceiverConfig(**heavy_kw),
                                    device=dev), iq)
    cfg = rx.cfg

    # ShardedReceiver: the front end against the single-device front end,
    # bit for bit; the fm chain is replicated, each rank has all the audio
    sr = two["sr"]
    st, ctl = rx.init_state(), rx.initial_controls()
    T = cfg.block_in
    fe_v, fe_dc = [], []
    for b in range(len(iq) // T):
        blk = torch.from_numpy(np.array(iq[b * T:(b + 1) * T])).to(dev)
        v, (dc, _, tail1, tail2, _, _) = rx.front_end(st, ctl, blk)
        fe_v.append(v.cpu().numpy())
        fe_dc.append(dc.cpu().numpy())
        st = st._replace(n0_mod=(st.n0_mod + T) % cfg.input_rate, rf_dc=dc,
                         band1=tail1, band2=tail2)
    fe_eq = [bool(np.array_equal(z["fe_v"], np.stack(fe_v))
                  and np.array_equal(z["fe_dc"], np.stack(fe_dc)))
             for z in sr]
    errs = [float(np.abs(z["audio"] - eager.audio).max()) for z in sr]
    bits = [bool(np.array_equal(z["bits0"], eager.rds_bits)) for z in sr]
    ok, dec = _rds_ok(sr[0]["bits0"], _meta_last(sr[0]))
    _shard_line("ShardedReceiver, main config", sr, card,
                front_end_and_dc_servo_bit_for_bit=fe_eq,
                audio_max_abs_diff_vs_eager=errs,
                bit_for_bit=[e == 0.0 for e in errs],
                eager_vs_eager_max_abs_diff=floor, rds_bits_equal=bits,
                decode=dec, audio_atol=RUNNER_AUDIO_ATOL, spawn_s=t2)
    need(all(fe_eq) and max(errs) <= RUNNER_AUDIO_ATOL and all(bits) and ok,
         f"sharded ShardedReceiver: front end {fe_eq}, errs {errs}, bits "
         f"{bits}, {dec}")
    need(all(z["info"]["counts"]["gather"] == 1
             and z["info"]["counts"]["halo"] == 1 for z in sr),
         "sharded ShardedReceiver: one gather and one halo a step")

    def full(what, zs, want, atol, kern, budget=True):
        got = _stitch(zs, cfg.block_working)
        err = (float(np.abs(got - want.audio).max())
               if got.shape == want.audio.shape else float("inf"))
        bits = [_bits_match(z, want.rds_bits, want.counts) for z in zs]
        ok, dec = _rds_ok(zs[0]["bits0"], _meta_last(zs[0]))
        row = _shard_line(what, zs, card, audio_max_abs_diff_vs_eager=err,
                          rds_bits=bits, decode=dec, audio_atol=atol)
        need(err <= atol and ok and all(b["counts_equal"]
                                        and b["equal_after_first_block"]
                                        for b in bits),
             f"sharded {what}: {row}")
        for z in zs:
            c = z["info"]["counts"]      # the flagship config's budget
            need(not budget or (c["gather"] <= 5 and c["halo"] <= 8),
                 f"sharded {what}: collectives {c}")
            got_k = {n: _rank_kernels(z)[n] for n in kern}
            need(dev == "cpu" or all(v >= 1 for v in got_k.values()),
                 f"sharded {what}: rank {z['info']['rank']} device kernels "
                 f"{got_k}, want each of {kern} in one step")
        return row

    full("FullyShardedReceiver, main config", two["fsr"], eager, FULL_ATOL,
         ("frontend", "linrec"))
    # rank d > 0 runs the front end twice: its halo, then its slice
    fe = [_rank_kernels(z)["frontend"] for z in two["fsr"]]
    need(dev == "cpu" or fe == [1] + [2] * (len(fe) - 1),
         f"sharded: front-end launches a step per rank {fe}, want 1 on "
         f"rank 0 and 2 (halo + slice) on the others")
    full("FullyShardedReceiver, main config", four["fsr"], eager, FULL_ATOL,
         ("frontend", "linrec"))
    full("FullyShardedReceiver, input filter + nsq + scan2", two["heavy"],
         heavy, NSQ_ATOL, ("linrec", "pole_bank", "mm_core"), budget=False)

    # StationTimeShardedReceiver 2 x 2 against MultiStationReceiver
    n_st = len(st_offsets)
    k = n_st // 2                     # stations a group
    msr = MultiStationReceiver(rx)
    st, ctl = msr.init_states(n_st), msr.controls_for(st_offsets)
    T = cfg.block_in
    want, wbits = [], [[] for _ in range(n_st)]
    for b in range(len(ms_iq) // T):
        blk = torch.from_numpy(np.array(ms_iq[b * T:(b + 1) * T])).to(dev)
        st, out = msr.step(st, ctl, blk)
        want.append(out.audio.cpu().numpy())
        for s in range(n_st):
            o = tree_index(out, s)
            wbits[s].append(o.rds.bits[: int(o.rds.count)].cpu().numpy())
    want = np.concatenate(want, axis=1)
    errs, beq, decs = [], [], []
    for s in range(n_st):
        g, j = divmod(s, k)
        zs = sorted([z for z in four["st"]
                     if z["info"]["station_index"] == g],
                    key=lambda z: z["info"]["time_index"])
        half = cfg.block_working // 2
        nb = zs[0]["audio"].shape[1] // half
        got = np.concatenate([z["audio"][j, b * half:(b + 1) * half]
                              for b in range(nb) for z in zs])
        errs.append(float(np.abs(got - want[s]).max()))
        beq.append([_bits_match(z, np.concatenate(wbits[s]),
                                [len(x) for x in wbits[s]], j) for z in zs])
        ok, dec = _station_ok(zs[0][f"bits{j}"], _meta_last(zs[0], j),
                              MS_STATIONS[s][1], MS_STATIONS[s][2])
        decs.append(dict(dec, ok=ok))
    counts = [z["info"]["counts"] for z in four["st"]]
    row = _shard_line(f"StationTimeShardedReceiver 2 x 2, {k} stations a "
                      f"group as one batched step", four["st"], card,
                      audio_max_abs_diff_vs_multistation=errs, rds_bits=beq,
                      decode=decs, audio_atol=ST_ATOL, spawn_s=t4)
    need(max(errs) <= ST_ATOL and all(d["ok"] for d in decs)
         and all(b["counts_equal"] and b["equal_after_first_block"]
                 for st_bits in beq for b in st_bits)
         and all((c["gather"], c["halo"]) == (5, 8) for c in counts),
         f"sharded StationTime: {row}")

    if cards >= 2:
        nccl, _ = _shard_run(2, [job("fsr_nccl", "FullyShardedReceiver",
                                     main_kw)], work, dev)
        need(nccl["fsr_nccl"][0]["info"]["transport"] == "nccl",
             "sharded: two cards and two ranks did not take NCCL")
        full("FullyShardedReceiver, main config, NCCL", nccl["fsr_nccl"],
             eager, FULL_ATOL, ("frontend", "linrec"))
    else:
        emit({"phase": "sharded", "what": "nccl", "run": False,
              "why": f"{cards} card for 2 ranks: NCCL needs a card a rank; "
                     f"the ranks shared the card through gloo with "
                     f"host-staged collectives", "card": card})
    _shard_worker(work, card, dev)
    import shutil
    shutil.rmtree(work)
    secs = time.perf_counter() - t_phase
    emit({"phase": "sharded", "what": "phase", "s": secs, "card": card})


def _kernel_sum_ms(fn) -> float:
    """The summed device time of the kernels of one call of fn (profiler),
    after a warm-up call."""
    fn()
    _, _, ev = _traced(fn)
    return sum(e.self_device_time_total for e in ev) / 1e3


OPTION_CONFIGS = (("input filter + nsq + scan2",
                   dict(rds="scan2", squelch="nsq", input_filter=True)),
                  ("scan3", dict(rds="scan3")))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                                 audio_filter_hz=15000, iq_format="i16"),
                  device="cuda")
    fe_err, sc_err = phase_kernels(rx)
    rows_err = phase_row_kernels(rx)
    a_err, b_err = phase_option_kernels()
    phase_graph(card, rx)
    wav, launches = phase_main()
    phase_reference(wav)
    phase_runners(wav, card)
    opt_launches = phase_options(wav)
    ms_wav, _, _, ms_launches, _ = phase_multistation(card)
    phase_scan(card, ms_wav)
    phase_sources(card, wav)
    phase_control(card, ms_wav, wav)
    phase_sharded(card, wav, ms_wav)
    ms_wav.unlink()
    phase_checkpoint(card, wav)
    kernels, step_ms = phase_times(rx, wav, fe_err, sc_err, launches, card)
    kernels += phase_option_times(a_err, b_err, opt_launches, card)
    kernels.append(rows_kernel_entry(rx, rows_err, ms_launches, card))
    phase_profile(rx, wav, card)
    phase_scanned(rx, wav, card, "main path", step_ms)
    for what, options in OPTION_CONFIGS:
        rx2, step_ms = phase_config_step(wav, card, what, **options)
        phase_profile(rx2, wav, card, what)
        phase_scanned(rx2, wav, card, what, step_ms)
    wav.unlink()                      # 74 MB: keep the output folder small
    (OUT / "kernels.json").write_text(json.dumps({"card": card,
                                                   "kernels": kernels},
                                                  indent=2))
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
