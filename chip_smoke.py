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
             against their host functions.
3b. graph  — the look-back kernels under CUDA-graph replay: two real-scan
             calls (R=2, R=1) and one pole-bank call at the squelch's
             shapes captured in one graph, replayed three times on new
             inputs, each replay against the plain versions.
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
             run on the CPU; emit_audio_i16 against the host quantizer.
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

Then one line {"kernels": [...]}, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}.  Outputs go to
chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import json
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = _fe_inputs(rng, "i16", T, dev)
    args = (s(0.9, torch.float32), s(1.1, torch.float32),
            s(0.003 - 0.02j, torch.complex64), s(137_000, torch.int32),
            s(5, torch.int32), True)
    z = torch.zeros(306, dtype=torch.complex64, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        frontend(x, "i16", z, rx.k_decim12, *args)
        torch.cuda.synchronize()
    fe_kernels = [e.key for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count > 0]
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sdrjfm_tpu_torch.io.wavio import read_iq_wav_raw

    T = rx.cfg.block_in
    iq, _ = read_iq_wav_raw(str(wav))
    blocks = [torch.from_numpy(np.array(iq[b * T:(b + 1) * T])).to(rx.device)
              for b in range(6)]
    state, ctl = rx.init_state(), rx.initial_controls()
    state, _ = rx.step(state, ctl, blocks[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for blk in blocks[1:]:
            state, _ = rx.step(state, ctl, blk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    nstep = len(blocks) - 1
    # device-side events only (kernels, memcpy/memset): the CPU-side op
    # events carry the same device time again
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
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
                                                 pole_bank,
                                                 pole_bank_constants,
                                                 pole_bank_plain)
    from sdrjfm_tpu_torch.rds import scan_decoders as SD
    from sdrjfm_tpu_torch.rds.bitrecovery import bit_capacity

    rng = np.random.default_rng(8)
    specs = _squelch_specs()
    rows, a_err = [], 0.0
    # the squelch's shapes (2 banks x 10 poles x 131072), then ragged rows:
    # one bank, a last chunk of one sample (after one chunk, and after more
    # than POLE_LOOK: the look-back's second step), under one chunk, one
    # sample
    cases = ((BLOCK_FM, specs), (BLOCK_FM, specs[1:]),
             (POLE_CHUNK + 1, specs),
             ((POLE_LOOK + 8) * POLE_CHUNK + 1, specs),
             (1000, specs[:1]), (1, specs), (BLOCK_FM, specs))
    for case, (T, banks) in enumerate(cases):
        x = torch.from_numpy((0.3 * rng.standard_normal((len(banks), T))
                              ).astype(np.float32)).to(dev)
        w0 = [torch.from_numpy((0.05 * (rng.standard_normal(10)
                                        + 1j * rng.standard_normal(10))
                                ).astype(np.complex64)).to(dev)
              for _ in banks]
        bank = pole_bank_constants(banks, dev)
        y, wT = pole_bank(x, bank, w0)
        if case == len(cases) - 1:
            # a second call queued right behind the first on the same
            # look-back words: it must not read the first's prefixes
            y_first, wT_first = y, wT
            x1 = x.flip(1).contiguous()
            y, wT = pole_bank(x1, bank, w0)
            yp1, wTp1 = pole_bank_plain(x, bank.poles, bank.residues,
                                        torch.stack(w0))
            x = x1
        yp, wTp = pole_bank_plain(x, bank.poles, bank.residues,
                                  torch.stack(w0))
        torch.cuda.synchronize()
        row = {"banks": len(banks), "poles": 10, "T": T,
               "max_abs_err": float((y - yp).abs().max()),
               "state_err": float((torch.stack(wT) - wTp).abs().max())}
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
                 and float((torch.stack(wT_first) - wTp1).abs().max())
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
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "options.json").write_text(json.dumps(results, indent=2))
    return launches_by_kernel


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
    w0 = [torch.zeros(10, dtype=torch.complex64, device=dev)
          for _ in specs]
    a_ms, a_host = device_ms(lambda: pole_bank(x, bank, w0), "pole_bank")
    a_plain = paced_ms(lambda: pole_bank_plain(x, bank.poles, bank.residues,
                                               torch.stack(w0)),
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

def phase_graph(card):
    """The look-back kernels under CUDA-graph replay: two real-scan calls
    (R=2, then R=1, as the main path launches them) and one pole-bank call
    at the squelch's 2 x 10 poles x 131072, captured in one graph and
    replayed three times, with new random inputs copied into the static
    inputs between replays; each replay against the plain versions
    (SCAN_RTOL of max|y|, POLE_RTOL of the bank's scale, also against
    float64).  A replay that faults is recorded and fails the phase."""
    from sdrjfm_tpu_torch import constants as C
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
    w0 = [torch.zeros(10, dtype=torch.complex64, device=dev) for _ in specs]

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

    def body():
        return (linrec(d2, g2, y02), linrec(d1, g1, y01),
                pole_bank(x, bank, w0))

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
                                  torch.stack(w0))
        for b, spec in enumerate(specs):
            ref, scale = _pole_f64(spec, x[b], w0[b])
            kp = float((y[b] - yp[b]).abs().max()) / scale
            k64 = float(np.abs(y[b].cpu().numpy() - ref).max()) / scale
            row[f"pole_bank{b}_err_of_scale"] = kp
            row[f"pole_bank{b}_vs_f64_of_scale"] = k64
            ok &= kp <= POLE_RTOL and k64 <= POLE_RTOL
        st = float((torch.stack(wT) - wTp).abs().max())
        row["pole_state_max_abs_err"] = st
        ok &= st <= 10 * POLE_RTOL * float(wTp.abs().max())
    emit({"phase": "graph", "what": "2 real scans (R=2, R=1) and 1 pole "
          "bank in one CUDA graph, 3 replays on new inputs", "ok": bool(ok),
          "scan_rtol_of_max": SCAN_RTOL, "pole_rtol_of_scale": POLE_RTOL,
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ret = fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
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
                           rds_bits=np.concatenate(bits), meta=metas)


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        run_offline_scanned(rx, iq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
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
    a_err, b_err = phase_option_kernels()
    phase_graph(card)
    wav, launches = phase_main()
    phase_reference(wav)
    phase_runners(wav, card)
    opt_launches = phase_options(wav)
    kernels, step_ms = phase_times(rx, wav, fe_err, sc_err, launches, card)
    kernels += phase_option_times(a_err, b_err, opt_launches, card)
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
