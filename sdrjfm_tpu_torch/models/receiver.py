"""The FM receiver — full-chain block pipeline (port of
sdrjfm_tpu.models.receiver).

    state, out = rx.step(state, controls, iq_block)

with `iq_block` one block of 2.304 MS/s wire-format input on the receiver's
device and `out` carrying the 48 kHz stereo audio, the RDS bits and the
metadata.  Chain layout (rates):

    [native] wire decode -> gains -> (rate map to 2.304M)
    [2.304M] (gains) -> DC servo -> LO mix -> ÷12         (one CUDA kernel)
             or, with the input filter, the `reference` cascade or the
             input tap: the same stages as torch ops with the 65536-point
             overlap-save filter or the tap between the mix and the ÷12
    [192k]   discriminator -> (squelch) -> pilot recovery -> PSS -> matrix
             -> RDS tap (57k analytic bandpass, ÷8)
    [48k]    audio filter with the deemphasis folded in (or the deemphasis
             scan) -> volume -> ÷4 -> ramp -> (test tone) -> (÷ to 192k)
    [24k]    RDS bit recovery (block BPSK, or the scan decoders 1-3)

Every single-device option of the JAX ReceiverConfig runs here; only the
sharded paths (`shard_axis`) are not ported (ROADMAP.md, queue 1).  `step`
never synchronises with the host; the one device-to-host transfer a runner
needs per block is `Output.meta_vec`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..kernels.frontend import DC_SUBSAMPLE, decode_wire, frontend
from ..ops import blockops as B
from ..ops import design
from ..ops.demod import (DECODERS, DemodState, demod_zero_state,
                         demodulate_block)
from ..ops.pilot import PilotState, make_pilot_config, pilot_zero_state, \
    recover_pilot
from ..ops.pss import PSSState, make_pss_config, pss_adapt, pss_zero_state
from ..ops.squelch import (SquelchState, level_squelch, make_squelch_config,
                           noise_squelch, squelch_bank, squelch_zero_state)
from ..rds import scan_decoders as SD
from ..rds.bitrecovery import (PHASE_SUB, BitBlock, BitRecoveryState,
                               bitrecovery_zero_state,
                               make_bitrecovery_config, recover_bits)

Tensor = torch.Tensor

__all__ = ["ReceiverConfig", "SOUND_MATRICES", "Controls", "default_controls",
           "Meta", "Output", "meta_dict_from_vec", "ReceiverState",
           "Receiver", "BitBlock", "BitRecoveryState", "DemodState",
           "PilotState", "PSSState", "SquelchState", "quantize_i16"]


@dataclass(frozen=True)
class ReceiverConfig:
    """The JAX package's ReceiverConfig, field for field and default for
    default (see sdrjfm_tpu/models/receiver.py for each field's meaning)."""
    input_rate: int = C.INPUT_RATE
    fm_rate: int = C.FM_RATE
    working_rate: int = C.WORKING_RATE
    audio_rate: int = C.WORKING_RATE
    rds_rate: int = C.RDS_RATE
    native_rate: int = 0
    block_fm: int = 131072
    decoder: str = "complex_baseband"
    mode: str = "stereo"              # mono | stereo | stereo_pano
    sound: str = "stereo"
    panorama: float = 1.0
    pss_active: bool = True
    auto_mono: bool = True
    deemphasis_us: float = 50.0
    input_filter: bool = False
    fm_bandwidth_hz: float = 0.95 * C.FM_RATE
    audio_filter_hz: int = 0
    squelch: str = "off"              # off | nsq | lsq
    rds: str = "block"                # off | block | scan1 | scan2 | scan3
    dc_remove: bool = True
    frontend: str = "flat"
    iq_format: str = "c64"            # c64 [T] | i16, u8, i8 [T,2]
    input_fft: int = C.INPUT_FFT_SIZE
    input_hop: int = 49152
    fm_fft: int = 8192
    fm_hop: int = 4096
    test_tone: bool = False
    emit_taps: bool = False
    emit_input_tap: bool = False
    emit_audio_i16: bool = False

    @property
    def block_in(self) -> int:
        return self.block_fm * (self.input_rate // self.fm_rate)

    @property
    def rate_ratio(self):
        """(num, den): reduced native_rate / input_rate."""
        g = math.gcd(self.native_rate, self.input_rate)
        return self.native_rate // g, self.input_rate // g

    @property
    def wire_len(self) -> int:
        """Samples per block as fed to step(): block_in at input_rate, or
        the native-rate length when a rate adapter is configured.  Raises
        ValueError (with the JAX package's message) when block_in * num is
        not a multiple of den."""
        if not self.native_rate:
            return self.block_in
        num, den = self.rate_ratio
        if self.block_in * num % den:
            raise ValueError(
                f"native_rate {self.native_rate}: block_in {self.block_in} "
                f"* {num} must divide by {den} — pick a block_fm whose "
                f"block_in (block_fm*12) is a multiple of den/gcd; e.g. "
                f"block_fm=12288*k covers the common SDR rates")
        return self.block_in * num // den

    @property
    def wire_rate(self) -> int:
        return self.native_rate or self.input_rate

    @property
    def block_working(self) -> int:
        return self.block_fm // (self.fm_rate // self.working_rate)

    @property
    def block_audio(self) -> int:
        return self.block_working * (self.audio_rate // self.working_rate)

    @property
    def block_rds(self) -> int:
        return self.block_fm // (self.fm_rate // self.rds_rate)


SOUND_MATRICES = {
    "stereo":          ((1.0, 0.0), (0.0, 1.0)),
    "stereo_swapped":  ((0.0, 1.0), (1.0, 0.0)),
    "left":            ((1.0, 0.0), (1.0, 0.0)),
    "right":           ((0.0, 1.0), (0.0, 1.0)),
    "left_plus_right": ((0.5, 0.5), (0.5, 0.5)),
    "left_minus_right": ((0.5, -0.5), (0.5, -0.5)),
}


class Controls(NamedTuple):
    """Run-time controls, each a 0-dim tensor on the receiver's device
    (changing them rebuilds nothing).  Build them with default_controls or
    Receiver.initial_controls."""
    lo_freq_hz: Tensor        # int32 — tuning offset
    volume: Tensor            # f32 — linear volume factor
    left_gain: Tensor         # f32 — balance
    right_gain: Tensor
    input_lgain: Tensor       # f32 — input attenuation
    input_rgain: Tensor
    squelch_level: Tensor     # f32 0..100
    pano: Tensor = None       # f32 stereo panorama multiplier on L-R
    sound_mix: Tensor = None  # [2,2] f32 output channel mix
    tone_gate: Tensor = None  # f32 test-tone gate: 1 inject, 0 clean


def default_controls(sound: str = "stereo", pano: float = 1.0,
                     device=None) -> Controls:
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return Controls(torch.tensor(0, dtype=torch.int32, device=device),
                    f(1.0), f(1.0), f(1.0), f(1.0), f(1.0), f(0.0),
                    pano=f(pano),
                    sound_mix=f(SOUND_MATRICES.get(
                        sound, SOUND_MATRICES["stereo"])),
                    tone_gate=f(1.0))


class Meta(NamedTuple):
    """Per-block metadata (the reference's SMetaData)."""
    pilot_locked: Tensor
    pilot_strength: Tensor
    dc_rf_db: Tensor
    dc_if: Tensor
    pss_phase_deg: Tensor
    pss_established: Tensor
    peak_left_db: Tensor
    peak_right_db: Tensor


class Output(NamedTuple):
    audio: Tensor             # [block_working, 2] float32
    meta: Meta
    rds: Optional[BitBlock]
    taps: Optional[dict]      # debug taps (cfg.emit_taps), else None
    meta_vec: Optional[Tensor] = None    # f32[len(Meta._fields)+1]
    audio_i16: Optional[Tensor] = None   # [block_audio, 2] int16


def meta_dict_from_vec(mv) -> Tuple[dict, int]:
    """Rebuild the per-block meta dict and the RDS bit count from the
    packed vector (a host array): returns (meta_dict, rds_count)."""
    vals = [float(v) for v in mv]
    d = dict(zip(Meta._fields, vals[: len(Meta._fields)]))
    d["pilot_locked"] = bool(d["pilot_locked"])
    d["pss_established"] = bool(d["pss_established"])
    return d, int(vals[len(Meta._fields)])


class ReceiverState(NamedTuple):
    n0_mod: Tensor
    rf_dc: Tensor
    input_filt: Optional[Tensor]
    band1: Tensor
    band2: Tensor
    demod: DemodState
    squelch: Optional[SquelchState]
    pilot: PilotState
    pss: PSSState
    phase_delay: Tensor       # pilot-phase delay line for the RDS mix
    rds57_filt: Optional[Tensor]
    rds_decim: Optional[Tensor]
    bitrec: Optional[object]  # BitRecoveryState or a scan-decoder state
    audio_filt: Optional[Tensor]
    deemph: Tensor
    audio_decim: Tensor
    ramp_remaining: Tensor
    audio_up: Optional[Tensor]
    tone_index: Tensor
    rate_carry: Optional[Tensor] = None


def quantize_i16(audio: Tensor) -> Tensor:
    """io.pcmout's PCM16 quantizer on the device: clip to [-1, 1 - 2^-15],
    scale by 32768, truncate toward zero (numpy's astype(int16))."""
    return torch.trunc(torch.clamp(audio, -1.0, 1.0 - 1.0 / 32768)
                       * 32768.0).to(torch.int16)


class Receiver:
    """Builds the frozen design constants on `device` and exposes
    init_state/step.  `device=None` means CUDA; without CUDA that raises —
    pass device='cpu' to run the plain versions on the CPU."""

    def __init__(self, cfg: ReceiverConfig, device=None):
        if cfg.decoder not in DECODERS:
            raise ValueError(f"unknown decoder {cfg.decoder!r}")
        if cfg.sound not in SOUND_MATRICES \
                and cfg.sound != "left_minus_right_test":
            raise ValueError(f"unknown sound selector {cfg.sound!r}")
        if cfg.iq_format not in ("c64", "i16", "u8", "i8"):
            raise ValueError(f"unknown iq_format {cfg.iq_format!r}")
        if cfg.frontend not in ("flat", "reference"):
            raise ValueError(f"unknown frontend {cfg.frontend!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Receiver: CUDA is not available; pass "
                                   "device='cpu' to run on the CPU")
            # The JAX chain runs every conv and matmul at
            # Precision.HIGHEST.  cuDNN convolutions default to TF32 (~3
            # significant digits), and cuBLAS may use it when allowed, so
            # both are switched off before anything runs on the card.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        dev = self.device
        fs_in, fs_fm = cfg.input_rate, cfg.fm_rate
        as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        # decimation kernels: the reference's 25/3-tap cascade, or the flat
        # pair collapsed into one composite ÷12 kernel conv(h1, upsample6(h2))
        # (bit-identical f32 taps to the JAX receiver's)
        if cfg.frontend == "reference":
            self.k_band1 = design.lowpass_sinc(4 * 6 + 1, fs_fm / 2, fs_in
                                               ).astype(np.float32)
            self.k_band2 = design.lowpass_sinc(2 + 1, fs_fm / 2, fs_in / 6
                                               ).astype(np.float32)
        else:
            self.k_band1 = design.lowpass_sinc(127, 110000.0, fs_in
                                               ).astype(np.float32)
            self.k_band2 = design.lowpass_sinc(31, 110000.0, fs_in / 6
                                               ).astype(np.float32)
        up2 = np.zeros(6 * (len(self.k_band2) - 1) + 1, np.float64)
        up2[::6] = self.k_band2
        self.k_decim12 = as_dev(np.convolve(
            self.k_band1.astype(np.float64), up2).astype(np.float32))
        # the fused kernel serves the flat path unless a stage has to sit
        # between the mix and the ÷12 (the input filter or the input tap)
        self.fused_frontend = (cfg.frontend == "flat" and not cfg.input_filter
                               and not (cfg.emit_taps and cfg.emit_input_tap))
        # strong input filter (inputFilter 65536/251)
        k_in = design.lowpass_sinc(C.INPUT_FILTER_DEGREE,
                                   cfg.fm_bandwidth_hz / 2, fs_in)
        self.H_input = as_dev(design.fft_filter_response(
            k_in, cfg.input_fft).astype(np.complex64))
        self.pilot_cfg = make_pilot_config(fs_fm, cfg.fm_fft, hop=cfg.fm_hop)
        self.pss_cfg = make_pss_config(fs_fm, subblock=min(4096, cfg.block_fm),
                                       device=dev)
        self.squelch_cfg = (make_squelch_config(fs_fm)
                            if cfg.squelch != "off" else None)
        rds_taps = C.PILOTFILTER_SIZE + 1          # 769
        k57 = design.bandpass_complex(
            rds_taps, C.RDS_FREQUENCY - C.RDS_WIDTH / 2,
            C.RDS_FREQUENCY + C.RDS_WIDTH / 2, fs_fm)
        H_rds57 = design.fft_filter_response(k57, cfg.fm_fft
                                             ).astype(np.complex64)
        # the pilot bandpass (x5 input gain folded in) and the RDS bandpass
        # share one forward FFT of demod (fft_filter_apply_multi); without
        # RDS the pilot row is filtered alone
        self.fuse_demod_filters = cfg.rds != "off"
        rows = [5.0 * self.pilot_cfg.response]
        if self.fuse_demod_filters:
            rows.append(H_rds57)
        self.H_demod_pair = as_dev(np.stack(rows).astype(np.complex64))
        self.rds_delay = (rds_taps - 1) // 2
        self.k_rds_decim = as_dev(design.lowpass_sinc(
            C.RDS_DECIM_TAPS, cfg.rds_rate / 2, fs_fm).astype(np.float32))
        self.bitrec_cfg = make_bitrecovery_config(
            cfg.rds_rate, device=dev,
            phase_sub=(min(PHASE_SUB, cfg.block_rds) if cfg.rds == "block"
                       else PHASE_SUB))
        if cfg.rds.startswith("scan"):
            if cfg.rds not in SD.DECODERS:
                raise ValueError(f"unknown rds decoder {cfg.rds!r}")
            self.scan_cfg = SD.DECODERS[cfg.rds][0](cfg.rds_rate)
        elif cfg.rds in ("off", "block"):
            self.scan_cfg = None
        else:
            raise ValueError(f"unknown rds decoder {cfg.rds!r}")
        # audio lowpass with the deemphasis one-pole folded into the same
        # overlap-save kernel when it fits the geometry (receiver.py:367-392
        # of the JAX package); otherwise the deemphasis runs as a scan
        self.deemph_alpha = C.deemphasis_alpha(cfg.deemphasis_us, fs_fm)
        self.deemph_folded = False
        self.H_audio = None
        if cfg.audio_filter_hz > 0:
            k_af = design.lowpass_sinc(C.AUDIO_FILTER_DEGREE,
                                       cfg.audio_filter_hz, fs_fm)
            a = self.deemph_alpha
            max_deg = cfg.fm_fft - cfg.fm_hop + 1 - len(k_af)
            if a < 1.0:
                L = min(max_deg, int(np.ceil(-104.0 / np.log2(1.0 - a))))
                k_d = a * (1.0 - a) ** np.arange(L, dtype=np.float64)
            else:
                k_d = np.ones(1)
            if len(k_d) <= max_deg:
                k_af = np.convolve(np.asarray(k_af, np.float64), k_d)
                self.deemph_folded = True
            self.H_audio = as_dev(design.fft_filter_response(
                k_af, cfg.fm_fft).astype(np.complex64))
        self.k_audio_decim = as_dev(design.polyphase_resampler_kernel(
            fs_fm // cfg.working_rate).astype(np.float32))
        self.k_audio_up = None
        if cfg.audio_rate != cfg.working_rate:
            if cfg.audio_rate % cfg.working_rate:
                raise ValueError(f"audio_rate {cfg.audio_rate} is not a "
                                 f"multiple of {cfg.working_rate}")
            self.k_audio_up = as_dev(design.polyphase_resampler_kernel(
                cfg.audio_rate // cfg.working_rate).astype(np.float32))
        # unit input gains for the fused kernel after the rate map (the
        # gains were applied on the native wire; x1.0 is exact)
        self._unit = torch.ones((), dtype=torch.float32, device=dev)
        self.build_device_constants()
        self._validate()

    def build_device_constants(self) -> None:
        """The device copies of the host-side design arrays that the block
        path reads: the reference cascade's taps, the squelch filters' and
        the scan decoder's constants.  Built once here (a copy per block
        would synchronise); convert.constants_from_numpy calls this again
        after it replaces those arrays."""
        dev = self.device
        self._k_bands = tuple(torch.as_tensor(k, device=dev)
                              for k in (self.k_band1, self.k_band2))
        self._squelch_bank = (squelch_bank(self.squelch_cfg, dev)
                              if self.squelch_cfg is not None else None)
        self._scan_consts = (SD.kernel_constants(self.cfg.rds, self.scan_cfg,
                                                 dev)
                             if self.scan_cfg is not None else None)

    def _validate(self):
        cfg = self.cfg
        if cfg.native_rate:
            cfg.wire_len              # raises unless the ratio tiles a block
        for ok, what in (
                (cfg.block_fm % cfg.fm_hop == 0, "block_fm % fm_hop"),
                (cfg.block_fm % self.pss_cfg.subblock == 0,
                 "block_fm % the PSS sub-block"),
                (not cfg.input_filter or cfg.block_in % cfg.input_hop == 0,
                 "block_in % input_hop"),
                (cfg.rds != "block"
                 or cfg.block_rds % self.bitrec_cfg.phase_sub == 0,
                 "block_rds % the carrier-phase sub-block"),
                (self.squelch_cfg is None
                 or cfg.block_fm % self.squelch_cfg.hold_period == 0,
                 "block_fm % the squelch hold period")):
            if not ok:
                raise ValueError(f"ReceiverConfig: {what} must be 0")

    # ------------------------------------------------------------------
    def initial_controls(self) -> Controls:
        """default_controls seeded from cfg.sound and cfg.panorama, on the
        receiver's device."""
        sound = self.cfg.sound if self.cfg.sound in SOUND_MATRICES \
            else "stereo"
        return default_controls(sound=sound, pano=self.cfg.panorama,
                                device=self.device)

    def _bitrec_zero_state(self):
        cfg, dev = self.cfg, self.device
        if cfg.rds == "block":
            return bitrecovery_zero_state(self.bitrec_cfg, device=dev)
        if cfg.rds.startswith("scan"):
            return SD.DECODERS[cfg.rds][1](self.scan_cfg, device=dev)
        return None

    def init_state(self) -> ReceiverState:
        cfg, dev = self.cfg, self.device
        rds_on = cfg.rds != "off"
        zero_c = lambda: torch.zeros((), dtype=torch.complex64, device=dev)  # noqa: E731
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
        up = cfg.audio_rate // cfg.working_rate
        return ReceiverState(
            n0_mod=i32(0),
            rf_dc=zero_c(),
            input_filt=(B.fft_filter_zero_state(cfg.input_fft, cfg.input_hop,
                                                device=dev)
                        if cfg.input_filter else None),
            band1=B.fir_zero_state(len(self.k_band1)
                                   if cfg.frontend == "reference"
                                   else self.k_decim12.shape[0], device=dev),
            band2=B.fir_zero_state(len(self.k_band2), device=dev),
            demod=demod_zero_state(dev),
            squelch=(squelch_zero_state(self.squelch_cfg, device=dev)
                     if self.squelch_cfg else None),
            pilot=pilot_zero_state(self.pilot_cfg, device=dev),
            pss=pss_zero_state(self.pss_cfg, device=dev),
            phase_delay=torch.zeros(self.rds_delay, dtype=torch.float32,
                                    device=dev),
            rds57_filt=(B.fft_filter_zero_state(cfg.fm_fft, cfg.fm_hop,
                                                device=dev)
                        if rds_on else None),
            rds_decim=(B.fir_zero_state(self.k_rds_decim.shape[0],
                                        device=dev) if rds_on else None),
            bitrec=self._bitrec_zero_state(),
            audio_filt=(B.fft_filter_zero_state(cfg.fm_fft, cfg.fm_hop,
                                                device=dev)
                        if self.H_audio is not None else None),
            deemph=zero_c(),
            audio_decim=B.fir_zero_state(self.k_audio_decim.shape[0],
                                         device=dev),
            ramp_remaining=i32(cfg.working_rate // 2),
            audio_up=(B.fir_zero_state(
                (self.k_audio_up.shape[0] + up - 1) // up, device=dev)
                if self.k_audio_up is not None else None),
            tone_index=i32(0),
            rate_carry=zero_c() if cfg.native_rate else None,
        )

    def _recover_bits(self, z24: Tensor, bitrec_state, want_iq: bool):
        """The selected bit decoder: (BitBlock, demod24, new state).  The
        scan decoders write their bits compacted from inside the kernel, so
        nothing here synchronises (JAX gathers with jnp.nonzero)."""
        cfg = self.cfg
        if cfg.rds == "block":
            return recover_bits(z24, self.bitrec_cfg, bitrec_state)
        bits, count, biq, iq, new = SD.decoder_block(
            cfg.rds, z24, self.scan_cfg, bitrec_state, want_iq,
            self._scan_consts)
        valid = torch.arange(bits.shape[0], device=z24.device) < count
        return BitBlock(bits=bits, valid=valid, count=count, iq=biq), iq, new

    # ------------------------------------------------------------------
    # Front end: wire -> 192 kS/s
    # ------------------------------------------------------------------
    def _dc_update(self, rf_dc: Tensor, sub_mean: Tensor) -> Tensor:
        """One per-block DC-servo step from the stride-64 subsample mean."""
        g_blk = float((1.0 - C.RF_DC_ALPHA) ** self.cfg.block_in)
        return g_blk * rf_dc + (1.0 - g_blk) * sub_mean

    def front_end(self, state: ReceiverState, controls: Controls,
                  iq: Tensor, shard_axis: Optional[str] = None):
        """Wire decode, gains, (rate map), DC servo, LO mix, (input filter)
        and ÷12.  Returns (v [block_fm] complex64, (dc_last, input_tail,
        tail1, tail2, input_tap, rate_carry)) as the JAX front end does."""
        if shard_axis is not None:
            raise NotImplementedError("sharded front end is not ported yet "
                                      "(ROADMAP.md, queue 1: multi-GPU)")
        cfg = self.cfg
        rate_carry = state.rate_carry
        fmt, wire = cfg.iq_format, iq
        lg, rg = controls.input_lgain, controls.input_rgain
        if cfg.native_rate or not self.fused_frontend:
            re, im = decode_wire(iq, cfg.iq_format)
            x = torch.complex(re * lg, im * rg)
            if cfg.native_rate:
                num, den = cfg.rate_ratio
                x, rate_carry = B.rate_map_linear(x, num, den, cfg.block_in,
                                                  state.rate_carry)
            # the kernel reads the mapped stream with unit gains
            fmt, wire, lg, rg = "c64", x.contiguous(), self._unit, self._unit
        if self.fused_frontend:
            v, tail1, sub_mean = frontend(
                wire, fmt, state.band1, self.k_decim12, lg, rg, state.rf_dc,
                controls.lo_freq_hz, state.n0_mod, cfg.dc_remove,
                cfg.input_rate)
            tail2, input_tail, input_tap = state.band2, None, None
        else:
            # the input filter, the reference cascade or the input tap sit
            # between the mix and the ÷12: torch ops, as XLA ops in JAX
            sub_mean = None
            if cfg.dc_remove:
                lim = C.RF_DC_LIMIT
                corr = torch.complex(state.rf_dc.real.clamp(-lim, lim),
                                     state.rf_dc.imag.clamp(-lim, lim))
                sub_mean = x[::DC_SUBSAMPLE].mean()
                x = x - corr
            input_tap = x if (cfg.emit_taps and cfg.emit_input_tap) else None
            x = B.mix_lo(x, controls.lo_freq_hz, cfg.input_rate,
                         state.n0_mod)
            input_tail = None
            if cfg.input_filter:
                x, input_tail = B.fft_filter_apply(x, self.H_input,
                                                   cfg.input_hop,
                                                   state.input_filt)
            if cfg.frontend == "reference":
                x, tail1 = B.fir_decimate(x, self._k_bands[0], 6, state.band1)
                v, tail2 = B.fir_decimate(x, self._k_bands[1], 2, state.band2)
            else:
                v, tail1 = B.fir_decimate(x, self.k_decim12, 12, state.band1)
                tail2 = state.band2
        if cfg.dc_remove:
            dc_last = self._dc_update(state.rf_dc, sub_mean)
        else:
            # setDCRemove(false): servo off, tracked DC reset to zero
            dc_last = torch.zeros_like(state.rf_dc)
        return v, (dc_last, input_tail, tail1, tail2, input_tap, rate_carry)

    # ------------------------------------------------------------------
    def step(self, state: ReceiverState, controls: Controls,
             iq: Tensor) -> Tuple[ReceiverState, Output]:
        cfg = self.cfg
        T_in = cfg.wire_len
        want = (T_in,) if cfg.iq_format == "c64" else (T_in, 2)
        if tuple(iq.shape) != want:
            raise ValueError(f"step: iq block has shape {tuple(iq.shape)}, "
                             f"want {want}")
        v, (dc_last, input_tail, tail1, tail2, input_tap, rate_carry) = \
            self.front_end(state, controls, iq)
        n0_mod = (state.n0_mod + cfg.block_in) % cfg.input_rate
        fe_updates = dict(n0_mod=n0_mod, rf_dc=dc_last,
                          input_filt=input_tail if cfg.input_filter else None,
                          band1=tail1, band2=tail2, input_tap=input_tap,
                          rate_carry=rate_carry)
        return self.fm_chain(state, controls, v, fe_updates)

    # ------------------------------------------------------------------
    # fm chain: 192 kS/s -> audio + RDS
    # ------------------------------------------------------------------
    def fm_chain(self, state: ReceiverState, controls: Controls, v: Tensor,
                 fe_updates: dict, shard_axis: Optional[str] = None
                 ) -> Tuple[ReceiverState, Output]:
        if shard_axis is not None:
            raise NotImplementedError("sharded fm chain is not ported yet "
                                      "(ROADMAP.md, queue 1: multi-GPU)")
        cfg = self.cfg
        dev = v.device
        taps = {} if cfg.emit_taps else None
        if taps is not None:
            if fe_updates.get("input_tap") is not None:
                taps["input_dc"] = fe_updates["input_tap"]
            taps["if_filtered"] = v

        # --- discriminator ---------------------------------------------------
        demod, demod_state, carrier = demodulate_block(
            v, state.demod, cfg.decoder, cfg.fm_rate)

        # --- squelch ---------------------------------------------------------
        squelch_state = state.squelch
        if cfg.squelch == "nsq":
            demod, squelch_state = noise_squelch(
                demod, controls.squelch_level, self.squelch_cfg,
                squelch_state, self._squelch_bank)
        elif cfg.squelch == "lsq":
            demod, squelch_state = level_squelch(
                demod, carrier, controls.squelch_level, self.squelch_cfg,
                squelch_state)
        if taps is not None:
            taps["demod"] = demod           # post-squelch, as the reference

        # --- pilot recovery (+ the fused RDS 57 kHz bandpass) -----------------
        ys, filt_tail = B.fft_filter_apply_multi(
            demod, self.H_demod_pair, cfg.fm_hop, state.pilot.filt)
        pblock, pilot_state = recover_pilot(
            demod, self.pilot_cfg, state.pilot, pre=(ys[0], filt_tail))
        rds_pre = ys[1] if self.fuse_demod_filters else None
        base_phase = 2.0 * (pblock.phase + math.pi / 4.0)

        # --- PSS -------------------------------------------------------------
        pss_off, pss_state = pss_adapt(
            demod, base_phase, pblock.locked, self.pss_cfg, state.pss,
            active=(cfg.pss_active and cfg.mode != "mono"))

        # --- stereo matrix ---------------------------------------------------
        lr_sum = demod
        if cfg.mode == "mono":
            stereo_gate = torch.zeros_like(demod, dtype=torch.bool)
        elif cfg.auto_mono:
            stereo_gate = pblock.locked
        else:
            stereo_gate = torch.ones_like(demod, dtype=torch.bool)
        carrier_phase = base_phase - pss_off
        test_sound = cfg.sound == "left_minus_right_test"
        osc = torch.sin(carrier_phase) if test_sound \
            else torch.cos(carrier_phase)
        lr_diff = torch.where(stereo_gate, 2.0 * osc * demod, 0.0) \
            * controls.pano
        left = lr_sum + lr_diff
        right = lr_sum - lr_diff
        if taps is not None:
            taps["af_sum"] = lr_sum
            taps["af_diff"] = lr_diff
        if test_sound:
            # diagnostic mode (sin-phase oscillator), static by design
            audio = torch.complex(lr_diff, lr_diff)
        else:
            m = controls.sound_mix
            audio = torch.complex(m[0, 0] * left + m[0, 1] * right,
                                  m[1, 0] * left + m[1, 1] * right)

        # --- RDS tap ---------------------------------------------------------
        rds_out = None
        rds57_filt, rds_decim_c, bitrec_state = (state.rds57_filt,
                                                 state.rds_decim, state.bitrec)
        if cfg.rds != "off":
            # the bandpass came out of the shared demod FFT; its carry is
            # the pilot filter's (both are demod tails)
            rds_base, rds57_filt = rds_pre, pilot_state.filt
            # mix with the pilot phase of the same instant: the analytic
            # 57k signal at n carries the input of time n - D
            phase_del, phase_delay = B.delay_apply(pblock.phase,
                                                   state.phase_delay)
            the_phase = 3.0 * phase_del
            rds_bb = rds_base * torch.complex(torch.cos(the_phase),
                                              -torch.sin(the_phase))
            z24, rds_decim_c = B.fir_decimate(rds_bb, self.k_rds_decim, 8,
                                              state.rds_decim)
            if taps is not None:
                taps["rds_baseband"] = z24
                taps["rds_input"] = 20.0 * z24
            rds_out, demod24, bitrec_state = self._recover_bits(
                z24, state.bitrec, taps is not None)
            if taps is not None:
                taps["rds_demod"] = demod24
        else:
            phase_delay = state.phase_delay

        # --- audio filter + deemphasis ---------------------------------------
        audio_filt = state.audio_filt
        if self.H_audio is not None:
            audio, audio_filt = B.fft_filter_apply(audio, self.H_audio,
                                                   cfg.fm_hop,
                                                   state.audio_filt)
        if self.deemph_folded:
            deemph_last = state.deemph      # folded into H_audio above
        else:
            audio, deemph_last = B.ema_apply_complex(audio, self.deemph_alpha,
                                                     state.deemph)
        if taps is not None:
            taps["af_left_filtered"] = audio.real
            taps["af_right_filtered"] = audio.imag
            taps["af_mono_filtered"] = audio.real + audio.imag

        # --- volume / balance ------------------------------------------------
        audio = torch.complex(
            audio.real * controls.volume * controls.left_gain,
            audio.imag * controls.volume * controls.right_gain)

        # --- ÷4 to workingRate ----------------------------------------------
        pcm, audio_decim = B.fir_decimate(
            audio, self.k_audio_decim, cfg.fm_rate // cfg.working_rate,
            state.audio_decim)

        # --- startup/retune ramp ---------------------------------------------
        Tw = cfg.block_working
        ramp_max = cfg.working_rate // 2
        pos = ramp_max - state.ramp_remaining
        gain = torch.clamp((pos + torch.arange(Tw, dtype=torch.float32,
                                               device=dev)) / ramp_max,
                           0.0, 1.0)
        pcm = pcm * gain
        ramp_remaining = torch.clamp(state.ramp_remaining - Tw, min=0)

        # --- test tone: 25 ms of 1 kHz at 0.9 every 2 s; the program is
        # attenuated x0.1 for as long as the gate is on, between bursts too
        # (the reference's insertTestTone) --------------------------------
        tone_index = state.tone_index
        if cfg.test_tone:
            period = 2 * cfg.working_rate
            dur = cfg.working_rate // 40
            idx = (state.tone_index + torch.arange(
                Tw, dtype=torch.int32, device=dev)) % period
            tone = 0.9 * torch.sin((2.0 * math.pi * 1000.0 / cfg.working_rate)
                                   * idx.to(torch.float32))
            tone = torch.where(idx < dur, tone, 0.0) * controls.tone_gate
            pcm = pcm * (1.0 - 0.9 * controls.tone_gate) \
                + torch.complex(tone, tone)
            tone_index = (state.tone_index + Tw) % period

        # --- peak meter ------------------------------------------------------
        peak_l = torch.max(torch.abs(pcm.real))
        peak_r = torch.max(torch.abs(pcm.imag))

        def to_db(p):
            return torch.where(p > 0, 20.0 * torch.log10(
                torch.clamp(p, min=1e-10)), -40.0)

        # --- optional upsample to audioRate (the -m 192 kHz mode) -----------
        audio_up_state = state.audio_up
        if self.k_audio_up is not None:
            pcm, audio_up_state = B.fir_interpolate(
                pcm, self.k_audio_up, cfg.audio_rate // cfg.working_rate,
                state.audio_up)

        meta = Meta(
            pilot_locked=pblock.locked[-1],
            pilot_strength=pblock.strength[-1],
            dc_rf_db=20.0 * torch.log10(torch.abs(fe_updates["rf_dc"])
                                        + 1.0 / 32768.0),
            dc_if=demod_state.fm_afc,
            pss_phase_deg=pss_off[-1] / math.pi * 180.0,
            pss_established=pss_state.minimized,
            peak_left_db=to_db(peak_l),
            peak_right_db=to_db(peak_r),
        )
        new_state = ReceiverState(
            n0_mod=fe_updates["n0_mod"], rf_dc=fe_updates["rf_dc"],
            input_filt=fe_updates["input_filt"], band1=fe_updates["band1"],
            band2=fe_updates["band2"], demod=demod_state,
            squelch=squelch_state, pilot=pilot_state, pss=pss_state,
            phase_delay=phase_delay, rds57_filt=rds57_filt,
            rds_decim=rds_decim_c, bitrec=bitrec_state, audio_filt=audio_filt,
            deemph=deemph_last, audio_decim=audio_decim,
            ramp_remaining=ramp_remaining, audio_up=audio_up_state,
            tone_index=tone_index, rate_carry=fe_updates.get("rate_carry"))

        out_audio = torch.stack([pcm.real, pcm.imag], dim=-1)
        count = (rds_out.count if rds_out is not None
                 else torch.full((), -1, dtype=torch.int32, device=dev))
        meta_vec = torch.stack([t.to(torch.float32) for t in meta]
                               + [count.to(torch.float32)])
        out = Output(audio=out_audio, meta=meta, rds=rds_out, taps=taps,
                     meta_vec=meta_vec,
                     audio_i16=(quantize_i16(out_audio)
                                if cfg.emit_audio_i16 else None))
        return new_state, out

    # ------------------------------------------------------------------
    def jit_step(self):
        """The step as a runtime.graph.StepGraph, called as
        `step(state, controls, iq)` like `step` but replayed from a CUDA
        graph on the card (the name of JAX's jax.jit wrapper, memoized the
        same way: one capture per receiver).  It returns views of static
        buffers that the next call overwrites."""
        if getattr(self, "_jit_step_fn", None) is None:
            from ..runtime.graph import StepGraph
            self._jit_step_fn = StepGraph(self)
        return self._jit_step_fn

    # ------------------------------------------------------------------
    def request_rds_resync(self, state: ReceiverState) -> ReceiverState:
        """Arm decoder 3's bit-clock re-acquisition for the next block (the
        block synchronizer's >3 sync errors, fed back by the runner).  A
        no-op for the other decoders, whose timing loops adapt
        continuously."""
        if self.cfg.rds != "scan3" or state.bitrec is None:
            return state
        return state._replace(bitrec=state.bitrec._replace(
            need_resync=torch.ones((), dtype=torch.bool,
                                   device=self.device)))

    # ------------------------------------------------------------------
    def retune_reset(self, state: ReceiverState) -> ReceiverState:
        """triggerFrequencyChange: a >=100 kHz retune fires the audio mute
        ramp, resets the PSS adaptation and the RDS bit decoder (block or
        scan)."""
        s = state._replace(
            ramp_remaining=torch.tensor(self.cfg.working_rate // 2,
                                        dtype=torch.int32,
                                        device=self.device),
            pss=pss_zero_state(self.pss_cfg, device=self.device))
        if s.bitrec is not None:
            s = s._replace(bitrec=self._bitrec_zero_state())
        return s
