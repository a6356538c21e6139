"""Command-line receiver of the PyTorch port (mirror of sdrjfm_tpu.app).

    python -m sdrjfm_tpu_torch.app synth --out iq.wav --seconds 5 \
        --station "TPU FM" --radiotext "hello"

    python -m sdrjfm_tpu_torch.app rx --iq iq.wav --audio out.wav \
        --rds --report report.json [--device cuda|cpu]

`rx` turns an IQ capture (a wav, or a headerless raw file with
`--iq-format u8|i8|i16` at `--input-rate`) into 48 kHz (or 192 kHz) stereo
audio and the RDS report, with the JAX CLI's flags and report keys for every
receiver option and runner: `--runner loop|scan` (`--chunk-blocks`),
`--pcm-out`/`--pcm-pace` (the streaming runner), `--follow` (the live runner
over the native ingest ring; `--no-pace`, `--loop-seconds`), pipe input
(`--iq -` or a FIFO, with `--iq-format u8|i8|i16`) and `--log-meta`.  It
runs on the card unless `--device cpu` is given.  The rtl_tcp and USB
sources and their gains, the control channel, checkpoints, AFC, the scopes
and the `scan` subcommand are not ported yet: they are refused with a
message naming ROADMAP.md, never silently ignored.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# rx flags of the JAX CLI that this port does not take yet
UNPORTED_RX_FLAGS = (
    "--tune-hz", "--afc", "--spectra", "--lf-plot", "--lf-zoom",
    "--save-state", "--ckpt-backend", "--load-state", "--ckpt-dir",
    "--ckpt-every", "--ckpt-keep", "--ckpt-keep-period", "--profile",
    "--control", "--gain", "--agc", "--ppm", "--linearity", "--sensitivity",
    "--grdb", "--lna-state", "--lna-gain", "--vga-gain", "--amp",
    "--reconnect-timeout", "--stations", "--meter", "--config")

# the rtl_tcp and USB sources of the JAX CLI's --iq (not ported yet)
_LIVE_PREFIXES = ("rtl_tcp://", "rtltcp://", "rtlsdr")
_LIVE_NAMES = ("airspy", "hackrf", "sdrplay")


def _is_fifo(path: str) -> bool:
    import os
    import stat
    try:
        return stat.S_ISFIFO(os.stat(path).st_mode)
    except OSError:
        return False


def _build_rx_parser(sub):
    p = sub.add_parser("rx", help="demodulate an IQ capture")
    p.add_argument("--iq", required=True,
                   help="input IQ: a wav capture (I=left, Q=right), a "
                        "headerless raw file (needs --iq-format u8/i8/i16), "
                        "or '-'/a FIFO: a headerless stream from any SDR "
                        "tool (streaming, needs --iq-format u8/i8/i16)")
    p.add_argument("--input-rate", type=int, default=0,
                   help="device-native sample rate of the capture (e.g. "
                        "2400000 rtl-sdr, 2500000 airspy); inserts the "
                        "linear-interpolation conversion to 2.304 MS/s on "
                        "the device (needs a block_fm whose block_in*ratio "
                        "is integral)")
    p.add_argument("--iq-format", default="auto",
                   choices=["auto", "c64", "i16", "i8", "u8"],
                   help="wire format fed to the device: auto picks i16 for "
                        "PCM16 stereo wavs; u8/i8/i16 read raw captures")
    p.add_argument("--audio", help="output audio wav (48 kHz stereo)")
    p.add_argument("--report", help="write JSON report (metadata + RDS)")
    p.add_argument("--freq-offset", type=int, default=0,
                   help="LO offset in Hz (station offset within the capture)")
    p.add_argument("--mode", default="stereo",
                   choices=["mono", "stereo", "stereo_pano"])
    p.add_argument("--decoder", default="complex_baseband",
                   choices=["am", "pll", "mixed", "complex_baseband",
                            "real_baseband", "difference"])
    p.add_argument("--sound", default="stereo")
    p.add_argument("--panorama", type=float, default=1.0,
                   help="stereo panorama factor (0 mono .. 1 stereo .. 2 "
                        "widened), in every stereo mode")
    p.add_argument("--rds", action="store_true", help="decode RDS")
    p.add_argument("--rds-decoder", default="block",
                   choices=["block", "scan1", "scan2", "scan3"],
                   help="bit decoder: the block decoder or the reference's "
                        "per-sample algorithms")
    p.add_argument("--no-pss", action="store_true")
    p.add_argument("--deemphasis", default="50",
                   help="deemphasis time constant in us, or a preset: "
                        "eu=50, us=75, off=0")
    p.add_argument("--audio-filter", type=int, default=15000,
                   help="audio lowpass cutoff Hz (0 = off)")
    p.add_argument("--input-filter", action="store_true",
                   help="enable the strong 65536-pt channel filter")
    p.add_argument("--fm-bandwidth", default=None,
                   help="channel filter bandwidth in kHz, or 'off' (a "
                        "numeric value implies --input-filter)")
    p.add_argument("--dc-remove", default="on", choices=["on", "off"],
                   help="input DC-removal servo")
    p.add_argument("--squelch", default="off", choices=["off", "nsq", "lsq"])
    p.add_argument("--squelch-level", default="0",
                   help="0..100, or 'auto' (nsq only: profile the first "
                        "block's band-energy ratio and pick a threshold)")
    p.add_argument("--volume-db", type=float, default=0.0)
    p.add_argument("--balance", type=int, default=0, help="-100..100")
    p.add_argument("--frontend", default="flat", choices=["flat", "reference"])
    p.add_argument("--block-fm", type=int, default=131072)
    p.add_argument("--pty-locale", type=int, default=0, choices=[0, 1])
    p.add_argument("--float32", action="store_true",
                   help="write float32 wav instead of PCM16")
    p.add_argument("--audio-192k", action="store_true",
                   help="output 192 kHz audio (the reference's -m flag)")
    p.add_argument("--dump-input", help="dump the 2.304 MS/s input IQ after "
                                        "DC removal (complex wav)")
    p.add_argument("--dump-if", help="dump the 192 kHz IF (complex wav)")
    p.add_argument("--dump-mpx", help="dump the demodulated MPX (192 kHz wav)")
    p.add_argument("--test-tone", action="store_true",
                   help="the 1 kHz/25 ms/2 s test-tone injector")
    p.add_argument("--taps", action="store_true",
                   help="emit the debug taps (incl. the input tap)")
    p.add_argument("--runner", default="loop", choices=["loop", "scan"],
                   help="block driver: the captured step replayed a block "
                        "at a time with the host hooks between blocks, or "
                        "over chunks of blocks staged on the device "
                        "(fastest)")
    p.add_argument("--chunk-blocks", type=int,
                   help="with --runner scan: stage and fetch in chunks of "
                        "this many blocks (bounds device memory for long "
                        "captures; the same result)")
    p.add_argument("--log-meta", help="write per-block metadata as JSON lines "
                                      "(the reference's periodic freq/pilot "
                                      "log, radio.cpp:1811-1823)")
    p.add_argument("--pcm-out", help="stream raw s16le PCM as blocks complete "
                                     "('-' = stdout; pipe to aplay/ffplay — "
                                     "the live audioSink equivalent). Uses "
                                     "the streaming runner.")
    p.add_argument("--pcm-pace", action="store_true",
                   help="throttle --pcm-out to real time")
    p.add_argument("--follow", action="store_true",
                   help="live streaming mode: pull blocks from the native "
                        "C++ paced ring (real-time emission, overrun drops "
                        "accounted) instead of loading the capture into "
                        "memory — the reference's device-thread -> ring -> "
                        "engine path (filehulp.cpp:159-202, "
                        "fm-processor.cpp:387-417)")
    p.add_argument("--no-pace", action="store_true",
                   help="with --follow: stream at full speed instead of "
                        "real time")
    p.add_argument("--loop-seconds", type=float,
                   help="with --follow: loop the capture and process this "
                        "many seconds of signal (default: stop at EOF)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "kernels' plain versions)")
    return p


def _build_synth_parser(sub):
    p = sub.add_parser("synth", help="generate a stereo+RDS IQ test capture")
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--left-freq", type=float, default=1000.0)
    p.add_argument("--right-freq", type=float, default=440.0)
    p.add_argument("--pi", type=lambda v: int(v, 0), default=0x10F0)
    p.add_argument("--pty", type=int, default=10)
    p.add_argument("--station", default="TPU FM")
    p.add_argument("--radiotext", default="JAX/XLA broadcast FM receiver")
    p.add_argument("--carrier-offset", type=float, default=0.0)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--int16", action="store_true",
                   help="write a 16-bit PCM wav (default float32)")
    return p


def _load_iq(path: str, iq_fmt: str):
    """(iq, rate, wire format) of a capture, as the JAX CLI loads it: a wav
    (auto/i16 keep PCM16 raw, else complex64) or a headerless raw file."""
    from . import constants as C
    from .io.wavio import is_riff, read_iq_raw, read_iq_wav, read_iq_wav_raw
    if not is_riff(path):
        if iq_fmt not in ("u8", "i8", "i16"):
            raise ValueError("raw (non-wav) capture: pass --iq-format u8, "
                             "i8 (hackrf_transfer) or i16")
        return read_iq_raw(path, iq_fmt), C.INPUT_RATE, iq_fmt
    if iq_fmt in ("u8", "i8"):
        raise ValueError(f"--iq-format {iq_fmt} applies to raw captures; "
                         "wav inputs use auto/c64/i16")
    if iq_fmt in ("auto", "i16"):
        try:
            iq, rate = read_iq_wav_raw(path)
            return iq, rate, "i16"
        except ValueError:
            if iq_fmt == "i16":
                raise
    iq, rate = read_iq_wav(path)
    return iq, rate, "c64"


def _probe_follow(path: str, iq_fmt: str):
    """(rate, wire format, is a wav) of a capture streamed with --follow:
    a header-only probe, the native ring does the reading."""
    from . import constants as C
    from .io.wavio import is_riff, probe_wav
    if not is_riff(path):
        if iq_fmt not in ("u8", "i8", "i16"):
            raise ValueError("raw (non-wav) capture: pass --iq-format u8, "
                             "i8 (hackrf_transfer) or i16")
        return C.INPUT_RATE, iq_fmt, False
    if iq_fmt in ("u8", "i8"):
        raise ValueError(f"--iq-format {iq_fmt} applies to raw captures; "
                         "wav inputs use auto/c64/i16")
    info = probe_wav(path)
    pcm16 = info.fmt == 1 and info.sampwidth == 2 and info.channels == 2
    if iq_fmt == "i16" and not pcm16:
        raise ValueError("--iq-format i16 needs a 16-bit PCM stereo wav")
    return info.rate, ("i16" if pcm16 and iq_fmt in ("auto", "i16")
                       else "c64"), True


class _FollowDumps:
    """--dump-input/--dump-if/--dump-mpx under --follow: each block's taps
    appended to the wav dumps while receiving (fm-processor.cpp:338-349,
    448-455), byte for byte the offline dumps.  The JAX CLI's version also
    serves --spectra and the control channel's dump buttons, which are not
    ported yet."""

    def __init__(self, args, cfg):
        from .io.wavio import StreamingWavWriter
        self.writers = [(tap, StreamingWavWriter(path, rate, ch))
                        for path, tap, rate, ch in (
                            (args.dump_input, "input_dc", cfg.input_rate, 2),
                            (args.dump_if, "if_filtered", cfg.fm_rate, 2),
                            (args.dump_mpx, "demod", cfg.fm_rate, 1))
                        if path]

    def on_taps(self, taps):
        for tap, w in self.writers:
            if tap in taps:
                x = taps[tap].cpu().numpy()
                if w.channels == 2:
                    w.write_iq(x)
                else:
                    w.write(x)

    def finish(self):
        for _, w in self.writers:
            w.close()
            print(f"wrote {w.path}", file=sys.stderr)


def cmd_rx(args) -> int:
    import numpy as np
    import torch
    from . import constants as C
    from .io.wavio import write_iq_wav, write_wav
    from .models.receiver import Receiver, ReceiverConfig
    from .rds.live import LiveRDSDecoder
    from .runtime.stream import (run_live, run_offline, run_offline_scanned,
                                 run_streaming)

    if args.iq.startswith(_LIVE_PREFIXES) or args.iq in _LIVE_NAMES:
        print(f"rx: the rtl_tcp and USB sources ({args.iq}) are not ported "
              "to sdrjfm_tpu_torch yet (ROADMAP.md, queue 1)",
              file=sys.stderr)
        return 2
    if args.chunk_blocks is not None and args.chunk_blocks < 1:
        print("--chunk-blocks must be >= 1", file=sys.stderr)
        return 2
    is_pipe = args.iq == "-" or _is_fifo(args.iq)
    iq, is_wav = None, False
    try:
        if is_pipe:
            # stdin / FIFO: a headerless stream from any external SDR tool
            # (`rtl_sdr -f 95M - | rx --iq - --iq-format u8`), streaming
            if args.iq_format not in ("u8", "i8", "i16"):
                print("pipe/stdin input: pass --iq-format u8, i8 or i16",
                      file=sys.stderr)
                return 2
            args.follow = True
            rate, iq_fmt = C.INPUT_RATE, args.iq_format
        elif args.follow:
            rate, iq_fmt, is_wav = _probe_follow(args.iq, args.iq_format)
        else:
            iq, rate, iq_fmt = _load_iq(args.iq, args.iq_format)
    except (OSError, ValueError) as e:
        print(f"loading device failed: {args.iq}: {e}", file=sys.stderr)
        return 2
    if rate != C.INPUT_RATE:
        print(f"warning: capture rate {rate} != {C.INPUT_RATE}; "
              "proceeding with the contract rate", file=sys.stderr)
    deemph_us = {"eu": 50.0, "us": 75.0, "off": 0.0}.get(
        str(args.deemphasis).lower(), None)
    if deemph_us is None:
        deemph_us = float(args.deemphasis)
    want_taps = bool(args.dump_if or args.dump_mpx or args.dump_input
                     or args.taps)
    # setBandwidth semantics: 'off' disables the channel filter, a number
    # (re)designs it at that bandwidth and turns it on
    input_filter = args.input_filter
    cfg_kw = {}
    if args.fm_bandwidth is not None:
        if str(args.fm_bandwidth).lower() == "off":
            input_filter = False
        else:
            input_filter = True
            cfg_kw["fm_bandwidth_hz"] = float(args.fm_bandwidth) * 1000.0
    if args.block_fm < 4096:
        # low-latency geometry: the overlap-save hops shrink to the block
        cfg_kw["fm_hop"] = args.block_fm
        cfg_kw["input_hop"] = args.block_fm * 12
    cfg = ReceiverConfig(
        block_fm=args.block_fm, decoder=args.decoder, mode=args.mode,
        sound=args.sound, panorama=args.panorama,
        pss_active=not args.no_pss,
        deemphasis_us=deemph_us, audio_filter_hz=args.audio_filter,
        input_filter=input_filter, squelch=args.squelch,
        rds=args.rds_decoder if args.rds else "off",
        audio_rate=192000 if args.audio_192k else C.WORKING_RATE,
        frontend=args.frontend, emit_taps=want_taps,
        native_rate=(args.input_rate
                     if args.input_rate not in (0, C.INPUT_RATE) else 0),
        emit_input_tap=bool(args.dump_input or args.taps),
        # the streaming sinks take the PCM16 quantized on the device (half
        # the audio bytes back; s16le is what they emit) unless the user
        # asked for float32 wav output
        emit_audio_i16=bool((args.pcm_out or args.follow)
                            and not args.float32),
        dc_remove=args.dc_remove == "on", iq_format=iq_fmt,
        test_tone=args.test_tone, **cfg_kw)
    try:
        rx = Receiver(cfg, device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"rx: {e}", file=sys.stderr)
        return 2
    if iq is not None and len(iq) < cfg.wire_len:
        print(f"capture too short: need {cfg.wire_len} samples, got "
              f"{len(iq)}", file=sys.stderr)
        return 2
    balance = args.balance
    lg = (100 - balance) / 100.0 if balance > 0 else 1.0
    rg = (100 + balance) / 100.0 if balance < 0 else 1.0
    sq_auto = str(args.squelch_level).lower() == "auto"
    sq_level = 0.0 if sq_auto else float(args.squelch_level)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                 device=rx.device)
    controls = rx.initial_controls()._replace(
        lo_freq_hz=torch.tensor(args.freq_offset, dtype=torch.int32,
                                device=rx.device),
        volume=f32(10.0 ** (args.volume_db / 20.0)),
        left_gain=f32(lg), right_gain=f32(rg), squelch_level=f32(sq_level))
    if sq_auto:
        if args.follow:
            print("--squelch-level auto needs the in-memory capture; "
                  "pass an explicit level with --follow", file=sys.stderr)
            return 2
        if args.squelch != "nsq":
            print("--squelch-level auto requires --squelch nsq (the profile "
                  "measures the noise-squelch band ratio)", file=sys.stderr)
            return 2
        if cfg.native_rate:
            print("--squelch-level auto profiles at 2.304 MS/s; pass an "
                  "explicit level with --input-rate", file=sys.stderr)
            return 2
        from .ops.squelch import auto_squelch_level, host_demod_profile
        demod0 = host_demod_profile(np.asarray(iq[: cfg.block_in]),
                                    cfg.iq_format, args.freq_offset)
        lvl = auto_squelch_level(demod0, cfg.fm_rate)
        print(f"auto squelch level: {lvl:.1f}", file=sys.stderr)
        controls = controls._replace(squelch_level=f32(lvl))
    live_rds = LiveRDSDecoder(pty_locale=args.pty_locale) if args.rds \
        else None
    feed = live_rds.feed if live_rds else None
    follow_dumps = _FollowDumps(args, cfg) if args.follow and want_taps \
        else None
    sink = None
    if args.pcm_out:
        from .io.pcmout import PCMSink
        sink = PCMSink(args.pcm_out, cfg.audio_rate, pace=args.pcm_pace)

    t0 = time.time()
    try:
        if args.follow:
            from .runtime.native_source import (NativePipeSource,
                                                NativeRawSource,
                                                NativeUnavailable,
                                                NativeWavSource)
            pace, loop = not args.no_pace, args.loop_seconds is not None
            try:
                if is_pipe:
                    src = NativePipeSource(args.iq, fmt=iq_fmt,
                                           rate=cfg.wire_rate)
                elif iq_fmt == "c64":
                    src = NativeWavSource(args.iq, pace=pace, loop=loop)
                elif is_wav:
                    src = NativeRawSource(args.iq, pace=pace, loop=loop)
                else:
                    src = NativeRawSource(args.iq, fmt=iq_fmt,
                                          rate=cfg.wire_rate, pace=pace,
                                          loop=loop)
            except (OSError, ValueError, NativeUnavailable) as e:
                print(f"loading device failed: {args.iq}: {e}",
                      file=sys.stderr)
                return 2
            max_blocks = None
            if args.loop_seconds:
                max_blocks = max(1, int(args.loop_seconds * cfg.wire_rate)
                                 // cfg.wire_len)
            # capture the step BEFORE the producer starts: a paced source
            # would overrun its ring during the capture and drop the head
            # of the stream
            rx.jit_step().prepare()
            src.start()
            try:
                res = run_live(rx, src, controls, max_blocks=max_blocks,
                               on_audio=sink.write if sink else None,
                               rds_feedback=feed,
                               on_taps=(follow_dumps.on_taps
                                        if follow_dumps else None))
            finally:
                src.close()
        elif args.pcm_out:
            res = run_streaming(rx, iq, controls, on_audio=sink.write,
                                rds_feedback=feed, collect_taps=want_taps)
        elif args.runner == "scan":
            res = run_offline_scanned(rx, iq, controls,
                                      collect_taps=want_taps,
                                      chunk_blocks=args.chunk_blocks)
        else:
            res = run_offline(rx, np.asarray(iq), controls,
                              collect_taps=want_taps, rds_feedback=feed)
    finally:
        if sink is not None:
            sink.close()
    dt = time.time() - t0
    n_in = (len(res.meta) if args.follow
            else len(iq) // cfg.wire_len) * cfg.wire_len
    rt = n_in / cfg.wire_rate / dt if dt > 0 else float("inf")
    print(f"processed {n_in} IQ samples in {dt:.2f}s ({rt:.1f}x real-time) "
          f"on {rx.device}", file=sys.stderr)
    if args.follow:
        print(f"ingest overrun drops: {res.dropped_total}", file=sys.stderr)

    if args.audio:
        write_wav(args.audio, res.audio, cfg.audio_rate, float32=args.float32)
        print(f"wrote {args.audio} ({len(res.audio)} frames)", file=sys.stderr)
    report = {
        "input_samples": int(n_in),
        "blocks": len(res.meta),
        "throughput_x_realtime": rt,
        "meta_last": res.meta[-1] if res.meta else {},
    }
    if args.follow:
        report["ingest_dropped"] = res.dropped_total
        lats = sorted(m["latency_ms"] for m in res.meta[2:]
                      if "latency_ms" in m)     # [2:]: past the first blocks
        if lats:
            q = lambda p: lats[min(len(lats) - 1,       # noqa: E731
                                   int(p * len(lats)))]
            report["latency_ms"] = {
                "block": round(1e3 * cfg.block_fm / cfg.fm_rate, 1),
                "p50": round(q(0.50), 1), "p95": round(q(0.95), 1),
                "max": round(lats[-1], 1)}
            print(f"end-to-end latency (ready->audio): p50 "
                  f"{report['latency_ms']['p50']} ms, p95 "
                  f"{report['latency_ms']['p95']} ms "
                  f"(+{report['latency_ms']['block']} ms block accumulation)",
                  file=sys.stderr)
    if live_rds is not None:
        # the scan runner feeds the decoder once, after the run
        if args.runner == "scan" and not (args.follow or args.pcm_out) \
                and res.rds_bits is not None:
            live_rds.feed(res.rds_bits)
        r = live_rds.result
        report["rds"] = live_rds.report()
        print(f"RDS: PI={report['rds']['pi_code']} "
              f"station={r.station_label!r} text={r.radio_text!r} "
              f"groups={live_rds.sync.groups_decoded} "
              f"BER={live_rds.sync.bit_error_rate:.4f}",
              file=sys.stderr)
    if follow_dumps is not None:
        follow_dumps.finish()
    if args.dump_input and "input_dc" in res.taps:
        write_iq_wav(args.dump_input, res.taps["input_dc"], cfg.input_rate)
        print(f"wrote {args.dump_input}", file=sys.stderr)
    if args.dump_if and "if_filtered" in res.taps:
        write_iq_wav(args.dump_if, res.taps["if_filtered"], cfg.fm_rate)
    if args.dump_mpx and "demod" in res.taps:
        write_wav(args.dump_mpx, res.taps["demod"], cfg.fm_rate, float32=True)
    if args.log_meta:
        blk_s = cfg.block_fm / cfg.fm_rate
        with open(args.log_meta, "w") as f:
            for b, m in enumerate(res.meta):
                rec = {"block": b, "t_s": round((b + 1) * blk_s, 6),
                       "freq_offset_hz": args.freq_offset}
                rec.update(m)
                f.write(json.dumps(rec) + "\n")
        print(f"wrote {args.log_meta} ({len(res.meta)} records)",
              file=sys.stderr)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.report}", file=sys.stderr)
    else:
        json.dump(report, sys.stdout, indent=2)
        print()
    return 0


def cmd_synth(args) -> int:
    import numpy as np
    from . import constants as C
    from .io import synth
    from .io.wavio import write_iq_wav
    from .rds import encode

    n = int(args.seconds * C.FM_RATE)
    t = np.arange(n) / C.FM_RATE
    left = 0.6 * np.sin(2 * np.pi * args.left_freq * t)
    right = 0.6 * np.sin(2 * np.pi * args.right_freq * t)
    bits = encode.make_bitstream(pi=args.pi, pty=args.pty,
                                 station=args.station,
                                 radiotext=args.radiotext + "\r",
                                 repeats=max(2, int(args.seconds)))
    syms = encode.differential_encode(bits)
    mpx = synth.synth_mpx(left, right, synth.MPXParams(rds_level=0.07),
                          rds_bits=syms)
    iq = synth.fm_modulate(mpx, C.FM_RATE,
                           carrier_offset_hz=args.carrier_offset,
                           noise_std=args.noise)
    write_iq_wav(args.out, iq, C.INPUT_RATE, float32=not args.int16)
    print(f"wrote {args.out}: {len(iq)} IQ samples at {C.INPUT_RATE} S/s",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "scan":
        print("scan is not ported to sdrjfm_tpu_torch yet (ROADMAP.md, "
              "queue 1: tuner/scanner/bandscan)", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(prog="sdrjfm_tpu_torch",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    _build_rx_parser(sub)
    _build_synth_parser(sub)
    args, unknown = ap.parse_known_args(argv)
    if unknown:
        flags = [a.split("=")[0] for a in unknown if a.startswith("--")]
        unported = [f for f in flags if f in UNPORTED_RX_FLAGS]
        if args.cmd == "rx" and unported:
            print(f"rx: {', '.join(unported)} not ported to sdrjfm_tpu_torch "
                  f"yet (ROADMAP.md, queue 1: the rest of the CLI)",
                  file=sys.stderr)
            return 2
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.cmd == "rx":
        return cmd_rx(args)
    return cmd_synth(args)


if __name__ == "__main__":
    sys.exit(main())
