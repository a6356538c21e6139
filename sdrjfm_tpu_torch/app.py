"""Command-line receiver of the PyTorch port (mirror of sdrjfm_tpu.app).

    python -m sdrjfm_tpu_torch.app synth --out iq.wav --seconds 5 \
        --station "TPU FM" --radiotext "hello"

    python -m sdrjfm_tpu_torch.app rx --iq iq.wav --audio out.wav \
        --rds --report report.json [--device cuda|cpu]

    python -m sdrjfm_tpu_torch.app scan --iq band.wav --identify \
        --stations stations.json [--device cuda|cpu]

`rx` turns an IQ capture (a wav, or a headerless raw file with
`--iq-format u8|i8|i16` at `--input-rate`), a pipe, or a live device
(`rtl_tcp://host:port`, `rtlsdr[:N]`, `airspy`, `hackrf`, `sdrplay`) into
48 kHz (or 192 kHz) stereo audio and the RDS report, with every flag and
report key of the JAX CLI: the receiver options, the runners (`--runner
loop|scan`, `--pcm-out`, `--follow`), the device settings, the control
channel (`--control`, `--stations`), checkpoints (`--save-state`,
`--load-state`, `--ckpt-dir`), `--meter`, `--config` and `--profile` (a
torch.profiler trace and the program's record of its spans).  `scan`
finds the stations of a capture (every channel of the window as a row of
one front-end call) or sweeps a device across the band, and with
`--identify` demodulates all of a window's hits at once
(`models.multistation`).  Both run on the card unless `--device cpu` is
given.  The one refusal is `--ckpt-backend orbax` (no torch
counterpart; ROADMAP.md, queue 3).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


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
                        "a live device: rtl_tcp://host:port (network, u8), "
                        "rtlsdr[:N] (librtlsdr, u8), airspy (i16 at its "
                        "native rate), hackrf (i8), sdrplay (i16), each "
                        "implying --follow; or '-'/a FIFO: a headerless "
                        "stream from any SDR tool (streaming, needs "
                        "--iq-format u8/i8/i16)")
    p.add_argument("--tune-hz", type=int,
                   help="with a hardware source: tune the device to this "
                        "center frequency")
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
    p.add_argument("--afc", action="store_true",
                   help="automatic frequency control: close the loop around "
                        "the demodulator's DC component every block "
                        "(radio.cpp:1786-1809; loop/pcm-out/follow runners)")
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
    p.add_argument("--spectra", help="write hf/lf spectra + waterfall + RDS "
                                     "constellation to an npz")
    p.add_argument("--lf-plot", default="demod",
                   choices=["if_filtered", "demod", "af_sum", "af_diff",
                            "af_left_filtered", "af_right_filtered",
                            "af_mono_filtered", "rds_input", "rds_baseband",
                            "rds_demod"],
                   help="LF scope tap for --spectra (ELfPlot, "
                        "fm-processor.h:84-86; rds_input/rds_demod need "
                        "--rds)")
    p.add_argument("--lf-zoom", type=int, default=1,
                   help="LF spectrum zoom factor (ls-scope.cpp:131-176 "
                        "display fold)")
    p.add_argument("--save-state", help="write the DSP state (npz) at "
                                        "the end of the run")
    p.add_argument("--ckpt-backend", default="npz", choices=["npz", "orbax"],
                   help="checkpoint writer (orbax has no torch counterpart "
                        "and is refused)")
    p.add_argument("--load-state", help="resume from a saved DSP state "
                                        "(a file, or a --ckpt-dir: its "
                                        "latest step)")
    p.add_argument("--ckpt-dir", help="periodic checkpointing: write the "
                                      "DSP state every --ckpt-every blocks "
                                      "into this directory (loop/follow/"
                                      "--pcm-out runners)")
    p.add_argument("--ckpt-every", type=int, default=64,
                   help="blocks between periodic checkpoints (default 64 "
                        "= 3.6 s of signal)")
    p.add_argument("--ckpt-keep", type=int, default=3,
                   help="retention: keep the newest N periodic checkpoints")
    p.add_argument("--ckpt-keep-period", type=int,
                   help="retention: also keep every checkpoint whose block "
                        "count is a multiple of this")
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
    p.add_argument("--profile", help="write a torch.profiler trace of the "
                                     "run (CPU and CUDA activity, Chrome "
                                     "trace JSON, with the program's spans "
                                     "as ranges) and the program's own "
                                     "record of its spans and counters "
                                     "(spans_<pid>.json; CLOCK_MONOTONIC "
                                     "ns) into this directory")
    p.add_argument("--control",
                   help="runtime control channel: '-' reads commands from "
                        "stdin, a FIFO path reads lines written to it, any "
                        "other path becomes a unix socket server. Commands "
                        "(tune/volume/balance/mute/squelch/afc/gain/agc/ppm/"
                        "status/quit, see runtime/control.py) are serviced "
                        "between blocks (radio.cpp:1040-1075, :1366+). "
                        "Needs a per-block runner (loop/--pcm-out/--follow)")
    p.add_argument("--gain", type=int,
                   help="rtl_tcp/rtlsdr: manual tuner gain in tenths of dB "
                        "(implies manual gain mode)")
    p.add_argument("--agc", action="store_true",
                   help="rtl_tcp/rtlsdr/sdrplay: enable the tuner AGC")
    p.add_argument("--ppm", type=int,
                   help="rtl_tcp/rtlsdr/sdrplay: frequency correction in ppm")
    p.add_argument("--linearity", type=int,
                   help="airspy: composite linearity gain 0-21 "
                        "(airspy-handler.cpp:399-408)")
    p.add_argument("--sensitivity", type=int,
                   help="airspy: composite sensitivity gain 0-21 "
                        "(airspy-handler.cpp:390-397)")
    p.add_argument("--grdb", type=int,
                   help="sdrplay: IF gain reduction dB 20-59 "
                        "(Rsp-device.cpp:174-182)")
    p.add_argument("--lna-state", type=int,
                   help="sdrplay: LNA state (model-dependent bound, "
                        "Rsp-device.cpp:184-190)")
    p.add_argument("--lna-gain", type=int,
                   help="hackrf: LNA (IF) gain dB 0-40 step 8 "
                        "(hackrf-handler.cpp:268-280)")
    p.add_argument("--vga-gain", type=int,
                   help="hackrf: VGA (baseband) gain dB 0-62 step 2 "
                        "(hackrf-handler.cpp:283-295)")
    p.add_argument("--amp", action="store_true",
                   help="hackrf: enable the RF amp "
                        "(hackrf-handler.cpp:299-303)")
    p.add_argument("--reconnect-timeout", type=float, default=0.0,
                   help="rtl_tcp: if the server drops mid-run, retry with "
                        "backoff for up to this many seconds, replay the "
                        "device settings, and resume (outage counted as "
                        "drops); 0 disables")
    p.add_argument("--stations",
                   help="station list JSON (written by `scan --stations`): "
                        "the control channel can `tune <name>` through it "
                        "and `save <name>` the current tuning back "
                        "(program-list.cpp:33-60)")
    p.add_argument("--meter", action="store_true",
                   help="live one-line status meter on stderr (pilot lock/"
                        "strength, peaks, drops, latency, RDS PI/PS; "
                        "--follow/--pcm-out runners)")
    p.add_argument("--config",
                   help="settings profile JSON (the reference's "
                        ".jsdr-fm.ini, main.cpp:33,69): its keys are rx flag "
                        "names and become the flag defaults (explicit flags "
                        "still win); on a clean exit the final tuning/"
                        "volume/balance/squelch are saved back")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "kernels' plain versions)")
    return p


def _build_scan_parser(sub):
    p = sub.add_parser("scan", help="band-scan a capture, identify stations")
    p.add_argument("--iq", required=True,
                   help="IQ capture: wav, a headerless raw file "
                        "(rtl_sdr/hackrf convention; needs --iq-format), or "
                        "a live device (rtl_tcp://host:port, rtlsdr[:N], "
                        "hackrf): that sweeps the hardware across the band "
                        "(radio.cpp:1115-1158)")
    p.add_argument("--iq-format", default="auto",
                   choices=["auto", "c64", "i16", "i8", "u8"],
                   help="raw-capture wire format (wav inputs: auto)")
    p.add_argument("--grid", type=int, default=100_000,
                   help="scan grid in Hz (the FM band raster)")
    p.add_argument("--threshold", type=float, default=20.0,
                   help="signal/noise contrast threshold in dB")
    p.add_argument("--identify", action="store_true",
                   help="demodulate every hit at once and decode its RDS "
                        "(PI/station/PTY)")
    p.add_argument("--seconds", type=float, default=3.0,
                   help="capture seconds to demodulate per station")
    p.add_argument("--stations", help="write/update a station list JSON")
    p.add_argument("--block-fm", type=int, default=32768)
    p.add_argument("--scan-blocks", type=int, default=4,
                   help="blocks averaged per decision (clearAverage depth, "
                        "fm-processor.cpp:480-495; a station flickering in "
                        "one block is not a hit)")
    p.add_argument("--band-start", type=float, default=87.5,
                   help="hardware sweep start in MHz")
    p.add_argument("--band-stop", type=float, default=108.0,
                   help="hardware sweep stop in MHz")
    p.add_argument("--settle-ms", type=int, default=30,
                   help="hardware sweep: stale-sample discard after each "
                        "retune (tuner PLL settle)")
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


def _lf_row(block, rate: int, zoom: int, device):
    """One LF-scope waterfall row (dB) + its kHz axis from one block's tap
    (shared by the offline spectra writer and the live follow-mode one)."""
    import numpy as np
    import torch
    from .models import scopes
    x = torch.as_tensor(block).to(device=device, dtype=torch.complex64)
    xa, amp, _ = scopes.lf_spectrum(x, rate, zoom_factor=zoom)
    return (20.0 * np.log10(np.maximum(amp.cpu().numpy(), 1e-10)),
            np.asarray(xa))


def _lf_rate(args, cfg) -> int:
    return cfg.rds_rate if args.lf_plot.startswith("rds") else cfg.fm_rate


def _write_spectra(args, hf, hf_rate, lf_rows, lf_axis, rds_iq) -> None:
    """The --spectra npz: the HF spectrum (and its rate, so a native-rate
    capture's axis is not misread), the LF waterfall and its axis, the RDS
    constellation, each where the run has it."""
    import numpy as np
    from .models import scopes
    out_npz = {}
    if hf is not None:
        out_npz["hf_spectrum_db"] = hf
        if hf_rate is not None:
            out_npz["hf_rate"] = np.asarray(hf_rate)
    if lf_rows:
        out_npz["lf_waterfall_db"] = scopes.waterfall(lf_rows)
        out_npz["lf_x_axis_khz"] = lf_axis
    if rds_iq is not None:
        out_npz["rds_constellation"] = scopes.iq_constellation(rds_iq)
    np.savez(args.spectra, **out_npz)
    print(f"wrote {args.spectra}", file=sys.stderr)


class _FollowDumps:
    """Incremental dump and scope writers of a live (--follow) run: each
    block's taps appended to the wav dumps while receiving (fm-processor.cpp:
    338-349, 448-455), byte for byte the offline dumps; --spectra
    accumulates its LF waterfall per block (the offline math) and takes the
    HF spectrum from the first block's input tap.  The control channel's
    `dump` command starts and stops the dumps at run time (the GUI dump
    buttons, radio.cpp:208-209): `start`, `stop`, `active`."""

    _KIND_ATTR = {"input": "w_input", "if": "w_if", "mpx": "w_mpx",
                  "audio": "w_audio"}

    def __init__(self, args, cfg, device):
        from .io.wavio import StreamingWavWriter
        self.args, self.cfg, self.device = args, cfg, device
        self.w_input = (StreamingWavWriter(args.dump_input, cfg.input_rate,
                                           2) if args.dump_input else None)
        self.w_if = (StreamingWavWriter(args.dump_if, cfg.fm_rate, 2)
                     if args.dump_if else None)
        self.w_mpx = (StreamingWavWriter(args.dump_mpx, cfg.fm_rate, 1)
                      if args.dump_mpx else None)
        self.w_audio = None
        self.lf_rows = []
        self.lf_axis = None
        self.hf = None

    def start(self, kind: str, path: str):
        """Open a dump writer mid-run; returns an error string or None.
        The audio dump is always possible (the audio reaches the host every
        block); input/if/mpx need their taps in the step."""
        from .io.wavio import StreamingWavWriter
        if kind in ("if", "mpx") and not self.cfg.emit_taps:
            return (f"the {kind} tap is not emitted by this run; start "
                    "with --taps (or a --dump-* flag)")
        if kind == "input" and not self.cfg.emit_input_tap:
            return ("the input tap is not emitted by this run; start "
                    "with --taps or --dump-input")
        rate, ch = {"input": (self.cfg.input_rate, 2),
                    "if": (self.cfg.fm_rate, 2),
                    "mpx": (self.cfg.fm_rate, 1),
                    "audio": (self.cfg.audio_rate, 2)}[kind]
        self.stop(kind)
        try:
            w = StreamingWavWriter(path, rate, ch)
        except OSError as e:
            return f"dump {path!r}: {e}"
        setattr(self, self._KIND_ATTR[kind], w)
        return None

    def stop(self, kind: str):
        """Close a dump writer; returns its path (None if not open)."""
        w = getattr(self, self._KIND_ATTR[kind])
        if w is None:
            return None
        w.close()
        setattr(self, self._KIND_ATTR[kind], None)
        return w.path

    def active(self):
        return {k: getattr(self, a).path
                for k, a in self._KIND_ATTR.items()
                if getattr(self, a) is not None}

    def on_audio(self, frames):
        if self.w_audio is not None:
            self.w_audio.write(frames)

    def on_taps(self, taps):
        # device tensors: only the taps written are fetched
        if self.w_input is not None and "input_dc" in taps:
            self.w_input.write_iq(taps["input_dc"].cpu().numpy())
        if self.w_if is not None and "if_filtered" in taps:
            self.w_if.write_iq(taps["if_filtered"].cpu().numpy())
        if self.w_mpx is not None and "demod" in taps:
            self.w_mpx.write(taps["demod"].cpu().numpy())
        if self.args.spectra:
            from .models import scopes
            if self.hf is None and "input_dc" in taps:
                self.hf = scopes.spectrum_db(taps["input_dc"]).cpu().numpy()
            if self.args.lf_plot in taps:
                row, self.lf_axis = _lf_row(
                    taps[self.args.lf_plot], _lf_rate(self.args, self.cfg),
                    self.args.lf_zoom, self.device)
                self.lf_rows.append(row)

    def finish(self, res):
        for w in (self.w_input, self.w_if, self.w_mpx, self.w_audio):
            if w is not None:
                w.close()
                print(f"wrote {w.path}", file=sys.stderr)
        if self.args.spectra:
            _write_spectra(self.args, self.hf, None, self.lf_rows,
                           self.lf_axis, res.rds_iq)


def _rtltcp_hostport(url: str):
    hostport = url.split("://", 1)[1]
    host, _, port = hostport.partition(":")
    return host, int(port or 1234)


def _rtlsdr_index(spec: str) -> int:
    """'rtlsdr' / 'rtlsdr:1' / 'rtlsdr://1' -> dongle index (default 0)."""
    _, _, idx = spec.partition(":")
    idx = idx.lstrip("/")
    return int(idx) if idx else 0


class _ProfileTrace:
    """--profile: a torch.profiler trace of the run, with CPU activity and,
    on the card, CUDA activity, exported into the directory as Chrome trace
    JSON (the JAX CLI's jax.profiler.trace into the same flag); the
    program's spans are ranges in it.  Beside it, the in-memory record of
    the spans and the counters (`runtime.spans`), set-up included, as
    spans_<pid>.json."""

    def __init__(self, directory: str, device):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.directory = directory
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import os

        from .runtime import spans
        self.prof.__exit__(*exc)
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory,
                                 f"trace_{os.getpid()}_{time.time_ns()}.json")
        self.prof.export_chrome_trace(self.path)
        spans.write_json(os.path.join(self.directory,
                                      f"spans_{os.getpid()}.json"))


def _meter(cfg, ctl_proc, live_rds):
    """--meter: a one-line status repainted on stderr (the GUI's persistent
    displays), at most ~4 Hz in real time and always every 8th block."""
    state = {"t": 0.0, "blocks": 0}
    blk_s = cfg.block_fm / cfg.fm_rate

    def meter(meta):
        state["blocks"] += 1
        now = time.time()
        if now - state["t"] < 0.25 and state["blocks"] % 8:
            return
        state["t"] = now
        parts = [f"[{state['blocks'] * blk_s:7.1f}s]"]
        if ctl_proc is not None:
            parts.append(f"lo={ctl_proc.lo_hz:+d}")
        lock = "LOCK" if meta.get("pilot_locked") else "----"
        parts.append(f"pilot={lock} {meta.get('pilot_strength', 0):.2f}")
        parts.append(f"L={meta.get('peak_left_db', 0):+5.1f}dB "
                     f"R={meta.get('peak_right_db', 0):+5.1f}dB")
        if "ingest_dropped" in meta:
            parts.append(f"drops={meta['ingest_dropped']}")
        if "latency_ms" in meta:
            parts.append(f"lat={meta['latency_ms']:3.0f}ms")
        if live_rds is not None and live_rds.sync.groups_decoded:
            r = live_rds.result
            parts.append(f"PI=0x{r.pi_code:04X} "
                         f"PS={r.station_label.strip()!r}")
        sys.stderr.write("\r" + " ".join(parts) + "   ")
        sys.stderr.flush()
    return meter


_HW_KINDS = ("rtltcp", "rtlsdr", "airspy", "hackrf", "sdrplay")


def _source_kind(iq: str):
    """The kind of a live --iq source (one of _HW_KINDS, or 'pipe'), else
    None."""
    if iq.startswith(("rtl_tcp://", "rtltcp://")):
        return "rtltcp"
    if iq == "rtlsdr" or iq.startswith("rtlsdr:"):
        return "rtlsdr"
    if iq in ("airspy", "hackrf", "sdrplay"):
        return iq
    if iq == "-" or _is_fifo(iq):
        return "pipe"
    return None


def _device_flag_error(args, kind):
    """The JAX CLI's message for a device setting given without its
    device, else None."""
    if args.gain is not None and kind not in ("rtltcp", "rtlsdr"):
        return ("--gain controls an rtl tuner; pass --iq rtl_tcp://host:port "
                "or --iq rtlsdr[:index]")
    if (args.agc or args.ppm is not None) \
            and kind not in ("rtltcp", "rtlsdr", "sdrplay"):
        return ("--agc/--ppm control a hardware device; pass --iq "
                "rtl_tcp://host:port, rtlsdr[:index] or sdrplay")
    if (args.grdb is not None or args.lna_state is not None) \
            and kind != "sdrplay":
        return "--grdb/--lna-state control an sdrplay; pass --iq sdrplay"
    if (args.linearity is not None or args.sensitivity is not None) \
            and kind != "airspy":
        return ("--linearity/--sensitivity control an airspy; pass "
                "--iq airspy")
    if (args.lna_gain is not None or args.vga_gain is not None
            or args.amp) and kind != "hackrf":
        return ("--lna-gain/--vga-gain/--amp control a hackrf; pass "
                "--iq hackrf")
    if args.input_rate and kind in _HW_KINDS:
        return ("--input-rate applies to raw/pipe captures; SDR hardware "
                "negotiates its own rate")
    if args.reconnect_timeout and kind != "rtltcp":
        return ("--reconnect-timeout controls an rtl_tcp device; pass --iq "
                "rtl_tcp://host:port")
    return None


def _open_follow_source(args, kind, cfg, iq_fmt, is_wav, airspy_src):
    """The streaming source of a --follow run, with the device settings in
    each handler's order and the frequency last (rtlsdr-handler.cpp:
    102-116, airspy-handler.cpp:209-231, hackrf-handler.cpp:112-151,
    256-315, Rsp-device.cpp:160-198)."""
    from . import constants as C
    from .runtime import native_source as N
    pace, loop = not args.no_pace, args.loop_seconds is not None
    if kind == "rtltcp":
        host, port = _rtltcp_hostport(args.iq)
        src = N.RtlTcpSource(host, port, rate=C.INPUT_RATE,
                             reconnect_timeout_ms=int(
                                 args.reconnect_timeout * 1000))
    elif kind == "rtlsdr":
        src = N.RtlSdrUsbSource(device_index=_rtlsdr_index(args.iq),
                                rate=C.INPUT_RATE)
    elif kind == "airspy":
        src = airspy_src              # opened while probing (its rate)
    elif kind == "hackrf":
        src = N.HackRfUsbSource(rate=C.INPUT_RATE)
    elif kind == "sdrplay":
        src = N.SdrplayUsbSource(rate=C.INPUT_RATE)
    elif kind == "pipe":
        return N.NativePipeSource(args.iq, fmt=iq_fmt, rate=cfg.wire_rate)
    elif iq_fmt == "c64":
        return N.NativeWavSource(args.iq, pace=pace, loop=loop)
    elif is_wav:
        return N.NativeRawSource(args.iq, pace=pace, loop=loop)
    else:
        return N.NativeRawSource(args.iq, fmt=iq_fmt, rate=cfg.wire_rate,
                                 pace=pace, loop=loop)
    try:
        if kind in ("rtltcp", "rtlsdr"):
            if args.ppm is not None:
                src.set_freq_correction(args.ppm)
            if args.gain is not None:
                src.set_gain_mode(True)
                src.set_gain(args.gain)
            if args.agc:
                src.set_agc(True)
                src.set_gain_mode(False)
        elif kind == "airspy":
            if args.linearity is not None:
                src.set_linearity(args.linearity)
            if args.sensitivity is not None:
                src.set_sensitivity(args.sensitivity)
        elif kind == "hackrf":
            if args.lna_gain is not None:
                src.set_lna_gain(args.lna_gain)
            if args.vga_gain is not None:
                src.set_vga_gain(args.vga_gain)
            if args.amp:
                src.set_amp(True)
            src.set_antenna(True)
        elif kind == "sdrplay":
            if args.grdb is not None:
                src.set_grdb(args.grdb)
            if args.lna_state is not None:
                src.set_lna_state(args.lna_state)
            if args.agc:
                src.set_agc(True)
            if args.ppm is not None:
                src.set_freq_correction(args.ppm)
        if args.tune_hz:
            src.set_frequency(args.tune_hz)
    except (OSError, ValueError):
        src.close()
        raise
    return src


def cmd_rx(args) -> int:
    from . import constants as C
    from .runtime.checkpoint import ORBAX_REFUSAL
    from .runtime.native_source import NativeUnavailable

    kind = _source_kind(args.iq)
    err = _device_flag_error(args, kind)
    if err:
        print(err, file=sys.stderr)
        return 2
    if args.ckpt_backend == "orbax":
        print(f"rx: --ckpt-backend orbax: {ORBAX_REFUSAL}", file=sys.stderr)
        return 2
    if args.chunk_blocks is not None and args.chunk_blocks < 1:
        print("--chunk-blocks must be >= 1", file=sys.stderr)
        return 2
    # input probing runs under the reference's device-load contract
    # (radio.cpp:758-831): a missing/unreadable capture or device is a
    # clean message and exit 2, not a traceback
    iq, is_wav, airspy_src = None, False, None
    try:
        if kind in ("rtltcp", "rtlsdr"):
            # live SDR hardware: a u8 stream over the ring (streaming only)
            args.follow = True
            rate, iq_fmt = C.INPUT_RATE, "u8"
        elif kind == "airspy":
            # airspy opens NOW: its negotiated native rate (closest to 2
            # MS/s, airspy-handler.cpp:103-116) sets the rate adapter
            from .runtime.native_source import AirspyUsbSource
            airspy_src = AirspyUsbSource()
            args.follow = True
            rate, iq_fmt = C.INPUT_RATE, "i16"
            args.input_rate = airspy_src.rate      # -> cfg.native_rate
        elif kind == "hackrf":
            # the chain rate directly, signed bytes (hackrf-handler.cpp:112)
            args.follow = True
            rate, iq_fmt = C.INPUT_RATE, "i8"
        elif kind == "sdrplay":
            # the chain rate, planar shorts into the i16 ring
            # (Rsp-device.cpp:71)
            args.follow = True
            rate, iq_fmt = C.INPUT_RATE, "i16"
        elif kind == "pipe":
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
    except (OSError, ValueError, NativeUnavailable) as e:
        print(f"loading device failed: {args.iq}: {e}", file=sys.stderr)
        return 2
    try:
        return _rx(args, kind, iq, rate, iq_fmt, is_wav, airspy_src)
    finally:
        if airspy_src is not None:
            airspy_src.close()


def _rx(args, kind, iq, rate, iq_fmt, is_wav, airspy_src) -> int:
    import numpy as np
    import torch
    from . import constants as C
    from .io.wavio import write_iq_wav, write_wav
    from .models.receiver import Receiver, ReceiverConfig
    from .rds.live import LiveRDSDecoder
    from .runtime.native_source import NativeUnavailable
    from .runtime.stream import (run_live, run_offline, run_offline_scanned,
                                 run_streaming)

    if rate != C.INPUT_RATE:
        print(f"warning: capture rate {rate} != {C.INPUT_RATE}; "
              "proceeding with the contract rate", file=sys.stderr)
    deemph_us = {"eu": 50.0, "us": 75.0, "off": 0.0}.get(
        str(args.deemphasis).lower(), None)
    if deemph_us is None:
        deemph_us = float(args.deemphasis)
    want_taps = bool(args.dump_if or args.dump_mpx or args.spectra
                     or args.dump_input or args.taps)
    per_block = args.follow or args.pcm_out or args.runner != "scan"
    if args.afc and not per_block:
        print("--afc closes a per-block host loop; use --runner loop, "
              "--pcm-out, or --follow", file=sys.stderr)
        return 2
    if args.control and not per_block:
        print("--control services commands between blocks; use --runner "
              "loop, --pcm-out, or --follow", file=sys.stderr)
        return 2
    if args.ckpt_dir and not per_block:
        raise SystemExit("--ckpt-dir needs a per-block host loop "
                         "(--runner loop, --follow, or --pcm-out); the "
                         "single-dispatch scan runner cannot snapshot "
                         "mid-dispatch")
    if args.meter and not (args.follow or args.pcm_out):
        print("--meter needs a streaming runner (--follow or --pcm-out)",
              file=sys.stderr)
        return 2
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
        # follow-mode --spectra takes its HF spectrum from the input tap
        # (there is no in-memory capture to transform)
        emit_input_tap=bool(args.dump_input or args.taps
                            or (args.spectra and args.follow)),
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

    t0 = time.time()
    init_state = None
    if args.load_state:
        from .runtime.checkpoint import CheckpointError, load_state
        try:
            init_state, ck_meta = load_state(args.load_state,
                                             rx.init_state(), cfg=cfg)
        except (CheckpointError, OSError, KeyError, ValueError) as e:
            print(f"rx: --load-state: {e}", file=sys.stderr)
            return 2
        print(f"resumed state from {args.load_state} {ck_meta}",
              file=sys.stderr)
    live_rds = LiveRDSDecoder(pty_locale=args.pty_locale) if args.rds \
        else None
    feed = live_rds.feed if live_rds else None
    controls_update = None
    if args.afc and not args.control:
        from .models.tuner import AFCTracker
        _afc = AFCTracker(cfg.fm_rate)
        _base_lo = int(args.freq_offset)

        def controls_update(ctl, meta):
            from .runtime.graph import upload
            off = _afc.update(meta["dc_if"])
            return ctl._replace(lo_freq_hz=upload(
                int(round(_base_lo + off)), torch.int32, rx.device))
    ctl_channel = ctl_proc = command_hook = dev_info = None
    if args.control:
        from .runtime.control import CommandProcessor, ControlChannel
        stations = None
        if args.stations:
            from .io.stations import StationList
            stations = StationList.load(args.stations)
        try:
            ctl_channel = ControlChannel(args.control)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        ctl_proc = CommandProcessor(
            rx, ctl_channel, lo_hz=args.freq_offset, afc_active=args.afc,
            on_retune=(live_rds.reset if live_rds else None),
            meta_provider=(lambda: {"rds": live_rds.report()})
            if live_rds else None,
            stations=stations, stations_path=args.stations)
        ctl_proc.seed_from(controls)
        command_hook = ctl_proc.apply
    ckpt_mgr = on_state = sink = None
    try:
        if args.pcm_out:
            from .io.pcmout import PCMSink
            sink = PCMSink(args.pcm_out, cfg.audio_rate, pace=args.pcm_pace)
        if args.ckpt_dir:
            from .runtime.checkpoint import CheckpointManager
            ckpt_mgr = CheckpointManager(
                args.ckpt_dir, cfg=cfg, backend=args.ckpt_backend,
                max_to_keep=args.ckpt_keep,
                keep_period=args.ckpt_keep_period)
            every = max(1, args.ckpt_every)

            def on_state(blocks_done, state):
                if blocks_done % every == 0:
                    ckpt_mgr.save(blocks_done, state)
        follow_dumps = None
        if args.follow and (want_taps or args.control):
            # --control alone enables the runtime dump buttons (the audio
            # dump needs no taps; input/if/mpx also need --taps)
            follow_dumps = _FollowDumps(args, cfg, rx.device)
            if ctl_proc is not None:
                ctl_proc.dumps = follow_dumps
        meter = _meter(cfg, ctl_proc, live_rds) if args.meter else None
        profile = _ProfileTrace(args.profile, rx.device) if args.profile \
            else None
        with (profile if profile is not None
              else contextlib.nullcontext()):
            if args.follow:
                try:
                    src = _open_follow_source(args, kind, cfg, iq_fmt,
                                              is_wav, airspy_src)
                except (OSError, ValueError, NativeUnavailable) as e:
                    print(f"loading device failed: {args.iq}: {e}",
                          file=sys.stderr)
                    return 2
                if ctl_proc is not None:
                    # every live source takes the control-plane commands
                    # that apply to it (pause stops the reader; a source
                    # without a tuner entry cannot retune)
                    ctl_proc.source = src
                    if kind in _HW_KINDS and args.tune_hz:
                        ctl_proc.center_hz = int(args.tune_hz)
                max_blocks = None
                if args.loop_seconds:
                    max_blocks = max(1, int(args.loop_seconds
                                            * cfg.wire_rate)
                                     // cfg.wire_len)
                # capture the step BEFORE the producer starts: a paced or
                # live source would overrun its ring during the capture and
                # drop the head of the stream
                rx.jit_step().prepare()
                try:
                    src.start()
                    on_audio = sink.write if sink else None
                    if follow_dumps is not None:
                        if sink is not None:
                            def on_audio(fr, _w=sink.write,
                                         _d=follow_dumps.on_audio):
                                _w(fr)
                                _d(fr)
                        else:
                            on_audio = follow_dumps.on_audio
                    res = run_live(
                        rx, src, controls, init_state=init_state,
                        max_blocks=max_blocks, on_audio=on_audio,
                        on_meta=meter, rds_feedback=feed,
                        controls_update=controls_update,
                        command_hook=command_hook, on_state=on_state,
                        on_taps=(follow_dumps.on_taps if follow_dumps
                                 else None))
                    if kind == "rtltcp":
                        dev_info = {"tuner_type": src.tuner_type,
                                    "tuner_gain_count": src.tuner_gain_count,
                                    "reconnects": src.reconnects}
                finally:
                    src.close()
            elif args.pcm_out:
                res = run_streaming(rx, iq, controls, init_state=init_state,
                                    on_audio=sink.write, on_meta=meter,
                                    rds_feedback=feed,
                                    collect_taps=want_taps,
                                    controls_update=controls_update,
                                    command_hook=command_hook,
                                    on_state=on_state)
            elif args.runner == "scan":
                res = run_offline_scanned(rx, iq, controls,
                                          collect_taps=want_taps,
                                          init_state=init_state,
                                          chunk_blocks=args.chunk_blocks)
            else:
                res = run_offline(rx, np.asarray(iq), controls,
                                  collect_taps=want_taps,
                                  init_state=init_state, rds_feedback=feed,
                                  controls_update=controls_update,
                                  command_hook=command_hook,
                                  on_state=on_state)
    finally:
        if sink is not None:
            sink.close()
        if ckpt_mgr is not None:
            ckpt_mgr.close()
        if ctl_channel is not None:
            ctl_channel.close()
    dt = time.time() - t0
    if meter is not None:
        sys.stderr.write("\n")
    if profile is not None:
        print(f"wrote profiler trace to {args.profile}", file=sys.stderr)
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
            n_arr = res.arrival_timed
            since = ("ring arrival->audio" if n_arr == len(res.meta)
                     else "read->audio" if n_arr == 0 else
                     f"ring arrival->audio, read->audio for "
                     f"{len(res.meta) - n_arr} blocks")
            print(f"end-to-end latency ({since}): p50 "
                  f"{report['latency_ms']['p50']} ms, p95 "
                  f"{report['latency_ms']['p95']} ms "
                  f"(+{report['latency_ms']['block']} ms block accumulation)",
                  file=sys.stderr)
    if dev_info is not None:
        report["device"] = dev_info
    if ctl_proc is not None:
        report["control"] = {"commands": ctl_proc.commands_handled,
                             "retunes": ctl_proc.retunes,
                             "hw_retunes": ctl_proc.hw_retunes,
                             "final_lo_hz": ctl_proc.lo_hz}
        if ctl_proc.center_hz is not None:
            report["control"]["tuned_hz"] = (ctl_proc.center_hz
                                             + ctl_proc.lo_hz)
    if live_rds is not None:
        # the scan runner feeds the decoder once, after the run
        if not per_block and res.rds_bits is not None:
            live_rds.feed(res.rds_bits)
        r = live_rds.result
        report["rds"] = live_rds.report()
        print(f"RDS: PI={report['rds']['pi_code']} "
              f"station={r.station_label!r} text={r.radio_text!r} "
              f"groups={live_rds.sync.groups_decoded} "
              f"BER={live_rds.sync.bit_error_rate:.4f}",
              file=sys.stderr)
    if follow_dumps is not None:
        follow_dumps.finish(res)
    if args.dump_input and not args.follow and "input_dc" in res.taps:
        write_iq_wav(args.dump_input, res.taps["input_dc"], cfg.input_rate)
        print(f"wrote {args.dump_input}", file=sys.stderr)
    if args.dump_if and not args.follow and "if_filtered" in res.taps:
        write_iq_wav(args.dump_if, res.taps["if_filtered"], cfg.fm_rate)
    if args.dump_mpx and not args.follow and "demod" in res.taps:
        write_wav(args.dump_mpx, res.taps["demod"], cfg.fm_rate, float32=True)
    if args.spectra and not args.follow:
        from .models import scopes
        from .models.bandscan import raw_to_c64
        iq_c = raw_to_c64(np.asarray(iq[: cfg.wire_len]), iq_fmt)
        hf = scopes.spectrum_db(torch.from_numpy(iq_c).to(rx.device)
                                ).cpu().numpy()
        lf_rows, xa = [], None
        if args.lf_plot in res.taps:
            d = res.taps[args.lf_plot]
            blk = (cfg.block_rds if args.lf_plot.startswith("rds")
                   else cfg.block_fm)
            for i in range(len(d) // blk):
                row, xa = _lf_row(d[i * blk:(i + 1) * blk],
                                  _lf_rate(args, cfg), args.lf_zoom,
                                  rx.device)
                lf_rows.append(row)
        elif args.lf_plot != "demod":
            print(f"--lf-plot {args.lf_plot}: tap not present in this "
                  "config", file=sys.stderr)
        # the HF axis spans ±wire_rate/2
        _write_spectra(args, hf, cfg.wire_rate, lf_rows, xa, res.rds_iq)
    if args.save_state and res.final_state is not None:
        from .runtime.checkpoint import save_state
        save_state(args.save_state, res.final_state,
                   {"blocks": len(res.meta)}, cfg=cfg)
        print(f"wrote {args.save_state}", file=sys.stderr)
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
    if args.config:
        _save_profile(args, ctl_proc, sq_auto)
    return 0


def _save_profile(args, ctl_proc, sq_auto: bool) -> None:
    """--config save-on-exit (the reference writes its QSettings back on
    close): run-time control edits win over the flags the run started
    with."""
    import os
    profile = {}
    if os.path.exists(args.config):
        try:
            with open(args.config) as f:
                profile = json.load(f)
        except (ValueError, OSError):
            profile = {}
    profile.update({
        "freq_offset": (int(ctl_proc.lo_hz) if ctl_proc
                        else int(args.freq_offset)),
        "volume_db": (round(ctl_proc.volume_db, 2) if ctl_proc
                      else args.volume_db),
        "balance": ctl_proc.balance if ctl_proc else args.balance,
        "mode": args.mode, "decoder": args.decoder,
        "deemphasis": args.deemphasis, "squelch": args.squelch,
        "rds": bool(args.rds), "block_fm": args.block_fm,
        # live sound-mode / panorama edits win over the starting flags
        # (radio.cpp:504-505, the channelSelector combobox)
        "sound": (ctl_proc.sound if ctl_proc is not None
                  and ctl_proc.sound is not None else args.sound),
        "panorama": (ctl_proc.pano if ctl_proc is not None
                     and ctl_proc.pano is not None else args.panorama),
    })
    if ctl_proc is not None and ctl_proc.squelch_level is not None:
        profile["squelch_level"] = ctl_proc.squelch_level
    elif not sq_auto:
        profile["squelch_level"] = args.squelch_level
    if ctl_proc is not None and ctl_proc.center_hz is not None:
        profile["tune_hz"] = int(ctl_proc.center_hz)
    elif args.tune_hz:
        profile["tune_hz"] = int(args.tune_hz)
    with open(args.config, "w") as f:
        json.dump(profile, f, indent=2)
        f.write("\n")
    print(f"saved settings profile to {args.config}", file=sys.stderr)


def cmd_scan(args) -> int:
    import numpy as np
    import torch
    from . import constants as C
    from .io.wavio import is_riff, read_iq_raw, read_iq_wav
    from .models.bandscan import decode_rds_hit, raw_to_c64, scan_capture
    from .models.receiver import Receiver, ReceiverConfig

    kind = _source_kind(args.iq)
    if kind in ("rtltcp", "rtlsdr", "hackrf"):
        return _scan_hardware(args, kind)
    try:
        if is_riff(args.iq):
            iq, _ = read_iq_wav(args.iq)
        else:
            # headerless raw capture: converted to complex host-side with
            # the device conventions (rtlsdr-handler.cpp:285-294 for u8)
            if args.iq_format not in ("u8", "i8", "i16"):
                print("raw (non-wav) capture: pass --iq-format u8, i8 "
                      "or i16", file=sys.stderr)
                return 2
            iq = raw_to_c64(read_iq_raw(args.iq, args.iq_format),
                            args.iq_format)
    except (OSError, ValueError) as e:
        print(f"loading device failed: {args.iq}: {e}", file=sys.stderr)
        return 2
    try:
        rx = Receiver(ReceiverConfig(block_fm=args.block_fm, rds="off"),
                      device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"scan: {e}", file=sys.stderr)
        return 2
    T = rx.cfg.block_in
    if len(iq) < T:
        print(f"capture too short: need {T} samples", file=sys.stderr)
        return 1
    # decision averaged over blocks spread across the capture (clearAverage
    # depth, fm-processor.cpp:480-495) — not just the first block
    results = scan_capture(rx, iq, grid_hz=args.grid,
                           threshold_db=args.threshold,
                           max_blocks=args.scan_blocks)
    found = [e["offset_hz"] for e in results]
    print(f"scan: {len(found)} hit(s) at offsets {found}", file=sys.stderr)
    if args.identify and found:
        # every hit in one n-station step a block (models.multistation —
        # the reference identifies serially, one retune at a time)
        from .models.multistation import demodulate_stations
        n = min(len(iq), int(args.seconds * C.INPUT_RATE))
        rx = Receiver(ReceiverConfig(block_fm=args.block_fm, rds="block",
                                     audio_filter_hz=15000),
                      device=args.device)
        # >1 card: put the station axis on them (no collective — each
        # card identifies whole stations against its copy of the block)
        mesh = None
        if rx.device.type == "cuda" and torch.cuda.device_count() > 1:
            from .parallel.sharding import make_mesh
            mesh = make_mesh(axis="stations")
            print(f"identify: station axis sharded over "
                  f"{torch.cuda.device_count()} devices", file=sys.stderr)
        per_station = demodulate_stations(rx, iq[:n], found, mesh=mesh)
        for entry, res in zip(results, per_station):
            entry["pilot_locked"] = bool(res["meta"]["pilot_locked"])
            if res["rds_bits"] is not None:
                entry.update(decode_rds_hit(res["rds_bits"]))
            print(f"  offset {entry['offset_hz']:+d} Hz: {entry}",
                  file=sys.stderr)
    if args.stations:
        from .io.stations import StationList
        sl = StationList.load(args.stations)
        for e in results:
            if e.get("station"):
                sl.add(e["station"], e["offset_hz"],
                       pi_code=int(e["pi_code"], 16), pty=e.get("pty"))
        sl.save(args.stations)
        print(f"wrote {args.stations}", file=sys.stderr)
    json.dump({"hits": results}, sys.stdout, indent=2)
    print()
    return 0


def _scan_hardware(args, kind) -> int:
    """The full-band hardware sweep: the device stepped across the raster,
    every channel of each stop decided by one front-end call
    (`models.bandscan.scan_band`; rtl_tcp or the in-process dongles, one
    source contract: set_frequency/read_block/fmt/rate)."""
    from . import constants as C
    from .models.bandscan import scan_band
    from .models.receiver import Receiver, ReceiverConfig
    from .runtime import native_source as N
    try:
        rx = Receiver(ReceiverConfig(block_fm=args.block_fm, rds="off"),
                      device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"scan: {e}", file=sys.stderr)
        return 2
    try:
        if kind == "rtlsdr":
            src = N.RtlSdrUsbSource(_rtlsdr_index(args.iq),
                                    rate=C.INPUT_RATE)
        elif kind == "hackrf":
            src = N.HackRfUsbSource(rate=C.INPUT_RATE)
            src.set_antenna(True)
        else:
            host, port = _rtltcp_hostport(args.iq)
            src = N.RtlTcpSource(host, port, rate=C.INPUT_RATE)
    except (OSError, ValueError, N.NativeUnavailable) as e:
        print(f"loading device failed: {args.iq}: {e}", file=sys.stderr)
        return 2
    try:
        src.start()
        hits = scan_band(
            rx, src, f_start=int(args.band_start * 1e6),
            f_stop=int(args.band_stop * 1e6), grid_hz=args.grid,
            threshold_db=args.threshold, blocks=args.scan_blocks,
            settle_ms=args.settle_ms,
            identify_seconds=args.seconds if args.identify else 0.0,
            log=lambda m: print(m, file=sys.stderr))
    finally:
        src.close()
    for e in hits:
        print(f"  {e['freq_hz'] / 1e6:.1f} MHz: {e}", file=sys.stderr)
    if args.stations:
        from .io.stations import StationList
        sl = StationList.load(args.stations)
        for e in hits:
            if e.get("station"):
                sl.add(e["station"], e["freq_hz"],
                       pi_code=int(e["pi_code"], 16), pty=e.get("pty"))
        sl.save(args.stations)
        print(f"wrote {args.stations}", file=sys.stderr)
    json.dump({"hits": hits}, sys.stdout, indent=2)
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
    import os
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    ap = argparse.ArgumentParser(prog="sdrjfm_tpu_torch",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_rx = _build_rx_parser(sub)
    _build_scan_parser(sub)
    _build_synth_parser(sub)
    # settings profile: its keys become flag DEFAULTS before parsing, so
    # explicit flags still win (the reference restores .jsdr-fm.ini the
    # same way: saved state first, UI actions override)
    if "--config" in argv:
        cfgpath = argv[argv.index("--config") + 1]
        if os.path.exists(cfgpath):
            try:
                with open(cfgpath) as f:
                    profile = json.load(f)
            except (ValueError, OSError) as e:
                print(f"--config {cfgpath}: {e}", file=sys.stderr)
                return 2
            dests = {a.dest for a in p_rx._actions}
            p_rx.set_defaults(**{k: v for k, v in profile.items()
                                 if k in dests})
    args = ap.parse_args(argv)
    if args.cmd == "rx":
        return cmd_rx(args)
    if args.cmd == "scan":
        return cmd_scan(args)
    return cmd_synth(args)


if __name__ == "__main__":
    sys.exit(main())
