"""Command-line receiver of the PyTorch port (mirror of sdrjfm_tpu.app).

    python -m sdrjfm_tpu_torch.app synth --out iq.wav --seconds 5 \
        --station "TPU FM" --radiotext "hello"

    python -m sdrjfm_tpu_torch.app rx --iq iq.wav --audio out.wav \
        --rds --report report.json [--device cuda|cpu]

`rx` turns an IQ wav into 48 kHz stereo audio and the RDS report, with the
same report keys as the JAX CLI for the flags it takes.  It runs on the card
unless `--device cpu` is given.  The JAX CLI's other flags and its `scan`
subcommand are not ported yet: they are refused with a message naming
ROADMAP.md, never silently ignored.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# rx flags of the JAX CLI that this port does not take yet
UNPORTED_RX_FLAGS = (
    "--tune-hz", "--input-rate", "--decoder", "--sound", "--panorama",
    "--rds-decoder", "--deemphasis", "--audio-filter", "--input-filter",
    "--fm-bandwidth", "--dc-remove", "--afc", "--squelch", "--squelch-level",
    "--volume-db", "--balance", "--frontend", "--pty-locale", "--float32",
    "--audio-192k", "--dump-input", "--dump-if", "--dump-mpx", "--test-tone",
    "--taps", "--spectra", "--lf-plot", "--lf-zoom", "--save-state",
    "--ckpt-backend", "--load-state", "--ckpt-dir", "--ckpt-every",
    "--ckpt-keep", "--ckpt-keep-period", "--runner", "--chunk-blocks",
    "--log-meta", "--pcm-out", "--pcm-pace", "--follow", "--no-pace",
    "--loop-seconds", "--profile", "--control", "--gain", "--agc", "--ppm",
    "--linearity", "--sensitivity", "--grdb", "--lna-state", "--lna-gain",
    "--vga-gain", "--amp", "--reconnect-timeout", "--stations", "--meter",
    "--config")


def _build_rx_parser(sub):
    p = sub.add_parser("rx", help="demodulate an IQ wav capture")
    p.add_argument("--iq", required=True,
                   help="input IQ wav capture at 2.304 MS/s (I=left, Q=right)")
    p.add_argument("--iq-format", default="auto",
                   choices=["auto", "c64", "i16", "i8", "u8"],
                   help="wire format fed to the device: auto picks i16 for "
                        "PCM16 stereo wavs (half the input bytes of c64); "
                        "u8/i8 apply to raw captures, which are not ported")
    p.add_argument("--audio", help="output audio wav (48 kHz stereo)")
    p.add_argument("--report", help="write JSON report (metadata + RDS)")
    p.add_argument("--freq-offset", type=int, default=0,
                   help="LO offset in Hz (station offset within the capture)")
    p.add_argument("--mode", default="stereo", choices=["mono", "stereo"])
    p.add_argument("--rds", action="store_true", help="decode RDS")
    p.add_argument("--no-pss", action="store_true")
    p.add_argument("--block-fm", type=int, default=131072)
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


def _load_wav(path: str, iq_fmt: str):
    """(iq, rate, wire format) of an IQ wav, as the JAX CLI loads it."""
    from .io.wavio import is_riff, read_iq_wav, read_iq_wav_raw
    if not is_riff(path):
        raise ValueError("not a RIFF/wav file (raw, pipe and live sources "
                         "are not ported yet: ROADMAP.md, queue 1)")
    if iq_fmt in ("auto", "i16"):
        try:
            iq, rate = read_iq_wav_raw(path)
            return iq, rate, "i16"
        except ValueError:
            if iq_fmt == "i16":
                raise
    iq, rate = read_iq_wav(path)
    return iq, rate, "c64"


def cmd_rx(args) -> int:
    import numpy as np
    import torch
    from . import constants as C
    from .io.wavio import write_wav
    from .models.receiver import Receiver, ReceiverConfig
    from .rds.live import LiveRDSDecoder
    from .runtime.stream import run_offline

    if args.iq_format in ("u8", "i8"):
        print(f"--iq-format {args.iq_format} applies to raw captures; wav "
              "inputs use auto/c64/i16", file=sys.stderr)
        return 2
    try:
        iq, rate, iq_fmt = _load_wav(args.iq, args.iq_format)
    except (OSError, ValueError) as e:
        print(f"loading device failed: {args.iq}: {e}", file=sys.stderr)
        return 2
    if rate != C.INPUT_RATE:
        print(f"warning: capture rate {rate} != {C.INPUT_RATE}; "
              "proceeding with the contract rate", file=sys.stderr)
    cfg_kw = {}
    if args.block_fm < 4096:
        # low-latency geometry: the overlap-save hops shrink to the block
        cfg_kw["fm_hop"] = args.block_fm
        cfg_kw["input_hop"] = args.block_fm * 12
    cfg = ReceiverConfig(block_fm=args.block_fm, mode=args.mode,
                         pss_active=not args.no_pss, audio_filter_hz=15000,
                         rds="block" if args.rds else "off",
                         iq_format=iq_fmt, **cfg_kw)
    try:
        rx = Receiver(cfg, device=args.device)
    except (RuntimeError, NotImplementedError) as e:
        print(f"rx: {e}", file=sys.stderr)
        return 2
    if len(iq) < cfg.wire_len:
        print(f"capture too short: need {cfg.wire_len} samples, got "
              f"{len(iq)}", file=sys.stderr)
        return 2
    controls = rx.initial_controls()._replace(
        lo_freq_hz=torch.tensor(args.freq_offset, dtype=torch.int32,
                                device=rx.device))
    live_rds = LiveRDSDecoder() if args.rds else None

    t0 = time.time()
    res = run_offline(rx, np.asarray(iq), controls,
                      rds_feedback=live_rds.feed if live_rds else None)
    dt = time.time() - t0
    n_in = len(iq) // cfg.wire_len * cfg.wire_len
    rt = n_in / cfg.wire_rate / dt if dt > 0 else float("inf")
    print(f"processed {n_in} IQ samples in {dt:.2f}s ({rt:.1f}x real-time) "
          f"on {rx.device}", file=sys.stderr)

    if args.audio:
        write_wav(args.audio, res.audio, cfg.audio_rate, float32=False)
        print(f"wrote {args.audio} ({len(res.audio)} frames)", file=sys.stderr)
    report = {
        "input_samples": int(n_in),
        "blocks": len(res.meta),
        "throughput_x_realtime": rt,
        "meta_last": res.meta[-1] if res.meta else {},
    }
    if live_rds is not None:
        r = live_rds.result
        report["rds"] = live_rds.report()
        print(f"RDS: PI={report['rds']['pi_code']} "
              f"station={r.station_label!r} text={r.radio_text!r} "
              f"groups={live_rds.sync.groups_decoded} "
              f"BER={live_rds.sync.bit_error_rate:.4f}",
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
