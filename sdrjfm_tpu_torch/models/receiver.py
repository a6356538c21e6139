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

Every option of the JAX ReceiverConfig runs here.  `step` never
synchronises with the host; the one device-to-host transfer a runner needs
per block is `Output.meta_vec`.

`front_end` and `fm_chain` also take a leading station axis on the state,
the controls and the block (`[S, ...]` everywhere, `meta_vec` [S, M]):
the port's `vmap(step)`, which `models/multistation.py` runs.

The time-sharded paths (`parallel/sharding.py`) call `front_end` and
`fm_chain` with `axis`, a `parallel.distributed.TimeAxis`: each rank runs
its contiguous slice of the block, convolutions take ring halos from the
left neighbour, the trackers run through the distributed recurrences, and
one gather at the end of the chain resolves the stream tails, the peaks,
the 24 kS/s RDS stream (bit recovery then runs replicated) and the DC
servo's subsample.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..kernels.frontend import (DC_SUBSAMPLE, HALO_WIRE, dc_mean_of_tiles,
                                decode_wire, frontend)
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

    def dc_mean(self, parts: Tensor) -> Tensor:
        """The block's DC subsample mean from every rank's partials, in rank
        order (`front_end(axis=, defer_dc=True)`'s dc slot, gathered: [P,
        ...], a station axis after the rank axis where the front end ran
        stations): the subsample's mean, or the fused kernel's per-tile
        sums reduced in the kernel's own order."""
        k = parts.dim() - (2 if parts.is_complex() else 3)   # station dims
        p = parts.movedim(0, k)
        if parts.is_complex():
            return p.reshape(p.shape[:k] + (-1,)).mean(-1)
        return dc_mean_of_tiles(p.reshape(p.shape[:k] + (-1, 2)),
                                -(-self.cfg.block_in // DC_SUBSAMPLE))

    def front_end(self, state: ReceiverState, controls: Controls,
                  iq: Tensor, axis=None, defer_dc: bool = False):
        """Wire decode, gains, (rate map), DC servo, LO mix, (input filter)
        and ÷12.  Returns (v [block_fm] complex64, (dc_last, input_tail,
        tail1, tail2, input_tap, rate_carry)) as the JAX front end does.

        `state` and `controls` may carry a leading station axis [S] on
        every leaf, against the one shared block `iq` (the counterpart of
        `vmap(front_end, in_axes=(0, 0, None))`): v is then [S, block_fm]
        and every update carries the [S] axis.  The fused path runs the
        stations as the rows of one kernel launch, the split path as rows
        of the same torch ops.

        With `axis` (a TimeAxis; iq this rank's slice of the block) the LO
        phase starts at n0 + index * t_local, the convolutions take the left
        neighbour's tails as halos, and the returned tails are this rank's
        candidates.  On the fused path the halo is the neighbour's last
        HALO_WIRE WIRE samples run through the same kernel with the
        neighbour's NCO phase: its new carry is the neighbour's mixed tail
        bit for bit, without waiting for the neighbour's launch.
        `defer_dc` leaves the DC update to the caller: the dc slot then
        holds this rank's DC partials, which the caller gathers (in its
        end-of-chain gather) and turns into the mean with `dc_mean`;
        without it the sharded front end gathers them itself.  The
        correction applied is state.rf_dc either way."""
        return self._front(state, controls, iq, None, axis, defer_dc)

    def _front(self, state: ReceiverState, controls: Controls, wire: Tensor,
               block_index: Optional[Tensor], axis, defer_dc: bool):
        """`front_end` on the shared block `wire` (block_index None) or, row
        r on block block_index[r] of `wire` [NB, ...] (`front_end_rows`)."""
        cfg = self.cfg
        q = cfg.input_rate
        dev = state.n0_mod.device
        rows = state.n0_mod.dim() > 0
        R = state.n0_mod.shape[0] if rows else 1
        if axis is None:
            n0 = state.n0_mod
            halo = lambda x, carry: carry  # noqa: E731
        else:
            if cfg.native_rate:
                raise ValueError("rate adaptation is host-ingest-side; shard "
                                 "the adapted 2.304 MS/s stream, not the "
                                 "native wire")
            from ..parallel.distributed import left_halo
            n0 = (state.n0_mod + (axis.index * wire.shape[0]) % q) % q
            halo = lambda x, carry: left_halo(  # noqa: E731
                x, carry.shape[-1], carry, axis)
        partials = axis is not None
        rate_carry = state.rate_carry
        fmt, src, idx = cfg.iq_format, wire, block_index
        if rows and block_index is None:
            src, idx = wire[None], frontend.zero_index(R, dev)
        lg, rg = controls.input_lgain, controls.input_rgain
        if cfg.native_rate or not self.fused_frontend:
            blk = wire if block_index is None else wire.index_select(
                0, block_index)
            re, im = decode_wire(blk, cfg.iq_format)
            x = torch.complex(re * lg[..., None], im * rg[..., None])
            if cfg.native_rate:
                num, den = cfg.rate_ratio
                x, rate_carry = B.rate_map_linear(x, num, den, cfg.block_in,
                                                  state.rate_carry)
            # the kernel reads the mapped stream with unit gains
            fmt, src = "c64", x.contiguous()
            lg = rg = (self._unit if not rows else
                       torch.ones(R, dtype=torch.float32, device=dev))
            if rows:
                idx = torch.arange(R, dtype=torch.int32, device=dev)
        if self.fused_frontend:
            def launch(w, i, carry, n0_w, partials=False):
                args = (carry, self.k_decim12, lg, rg, state.rf_dc,
                        controls.lo_freq_hz, n0_w, cfg.dc_remove, q)
                if not rows:
                    return frontend(w, fmt, *args, partials=partials)
                return frontend.rows(w, fmt, i, *args, partials=partials)
            carry = state.band1
            left = None if axis is None else axis.from_left(
                wire[-HALO_WIRE:])
            if left is not None:
                n0_left = (state.n0_mod
                           + (axis.index * wire.shape[0] - HALO_WIRE) % q) % q
                _, carry, _ = launch(left if not rows else left[None], idx,
                                     state.band1, n0_left)
            v, tail1, sub = launch(src, idx, carry, n0, partials)
            tail2, input_tail, input_tap = state.band2, None, None
        else:
            # the input filter, the reference cascade or the input tap sit
            # between the mix and the ÷12: torch ops, as XLA ops in JAX
            sub = None
            if cfg.dc_remove:
                lim = C.RF_DC_LIMIT
                corr = torch.complex(state.rf_dc.real.clamp(-lim, lim),
                                     state.rf_dc.imag.clamp(-lim, lim))
                sub = (x[..., ::DC_SUBSAMPLE].contiguous() if partials
                       else x[..., ::DC_SUBSAMPLE].mean(-1))
                x = x - corr[..., None]
            input_tap = x if (cfg.emit_taps and cfg.emit_input_tap) else None
            x = B.mix_lo(x, controls.lo_freq_hz, q, n0)
            input_tail = None
            if cfg.input_filter:
                x, input_tail = B.fft_filter_apply(
                    x, self.H_input, cfg.input_hop, halo(x, state.input_filt))
            if cfg.frontend == "reference":
                x, tail1 = B.fir_decimate(x, self._k_bands[0], 6,
                                          halo(x, state.band1))
                v, tail2 = B.fir_decimate(x, self._k_bands[1], 2,
                                          halo(x, state.band2))
            else:
                v, tail1 = B.fir_decimate(x, self.k_decim12, 12,
                                          halo(x, state.band1))
                tail2 = state.band2
        if not cfg.dc_remove:
            # setDCRemove(false): servo off, tracked DC reset to zero
            dc_last = torch.zeros_like(state.rf_dc)
        elif partials and defer_dc:
            dc_last = sub
        else:
            dc_last = self._dc_update(
                state.rf_dc,
                sub if axis is None else self.dc_mean(axis.all_gather(sub)))
        return v, (dc_last, input_tail, tail1, tail2, input_tap, rate_carry)

    def front_end_rows(self, states: ReceiverState, controls: Controls,
                       wire: Tensor, block_index: Optional[Tensor] = None):
        """`front_end` over R rows, the counterpart of `vmap(front_end)`:
        `states` and `controls` carry a leading [R] axis on every leaf, row
        r runs on wire block block_index[r] (int32 [R] on the receiver's
        device) of `wire` [NB, wire_len(, 2)], or every row on the one
        shared block `wire` [wire_len(, 2)] (block_index None: the split
        paths decode it once).  Only the front end's leaves of `states`
        are read.  Returns (v [R, block_fm], fe_updates: the
        per-row updates that `step` hands to `fm_chain`, each with a
        leading [R] axis, None where the config has none).

        The fused path runs every row in one kernel launch; the split
        paths (input filter, `reference` cascade, input tap, native rate)
        run the rows as one batch of the same torch ops."""
        cfg = self.cfg
        v, (dc, itail, t1, t2, itap, rc) = self._front(
            states, controls, wire, block_index, None, False)
        upd = dict(rf_dc=dc, input_filt=itail if cfg.input_filter else None,
                   band1=t1, band2=t2, input_tap=itap, rate_carry=rc,
                   n0_mod=(states.n0_mod + cfg.block_in) % cfg.input_rate)
        return v, upd

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
                 fe_updates: dict, axis=None
                 ) -> Tuple[ReceiverState, Output]:
        """192 kS/s chain.  v [block_fm], or [S, block_fm] with `state`,
        `controls` and `fe_updates` carrying a leading station axis [S] on
        every leaf: the counterpart of `vmap(fm_chain)`, every op taking
        the S rows at once (one station's op count, each op [S, ...] wide)
        and every output with the [S] axis.  With `axis` (a TimeAxis; v
        this rank's slice)
        every stage runs on the slice: convolutions take ring halos,
        trackers run through the distributed recurrences, and the small
        sequential glue (the PSS scalar scan, the squelch decisions, the
        RDS bit recovery on the gathered 24 kS/s stream) runs on every rank
        alike.  Stream carries come back the same on every rank: ONE gather
        at the end of the chain resolves every candidate tail (the front
        end's too, where `fe_updates` holds candidates) to the last rank's,
        the peaks to their maxima, and the deferred DC partials (an
        `fe_updates['rf_dc']` with ndim > 0) to the servo update.  The
        audio is this rank's slice; meta and RDS are replicated.  The taps
        are per-rank slices and are refused here."""
        cfg = self.cfg
        dev = v.device
        lead = v.shape[:-1]              # () or (S,): the station axis
        col = lambda c: c[..., None]  # noqa: E731  a [...] control on rows
        sharded = axis is not None
        if sharded:
            from ..parallel import distributed as DD
            if cfg.emit_taps:
                raise ValueError("emit_taps is not supported on a time axis: "
                                 "the taps are per-rank slices")
        taps = {} if cfg.emit_taps else None
        if taps is not None:
            if fe_updates.get("input_tap") is not None:
                taps["input_dc"] = fe_updates["input_tap"]
            taps["if_filtered"] = v

        # --- discriminator ---------------------------------------------------
        demod, demod_state, carrier = demodulate_block(
            v, state.demod, cfg.decoder, cfg.fm_rate, axis=axis,
            defer_tail=sharded)

        # --- squelch ---------------------------------------------------------
        squelch_state = state.squelch
        if cfg.squelch == "nsq":
            demod, squelch_state = noise_squelch(
                demod, controls.squelch_level, self.squelch_cfg,
                squelch_state, self._squelch_bank, axis=axis)
        elif cfg.squelch == "lsq":
            demod, squelch_state = level_squelch(
                demod, carrier, controls.squelch_level, self.squelch_cfg,
                squelch_state, axis=axis)
        if taps is not None:
            taps["demod"] = demod           # post-squelch, as the reference

        # --- pilot recovery (+ the fused RDS 57 kHz bandpass) -----------------
        if not sharded:
            ys, filt_tail = B.fft_filter_apply_multi(
                demod, self.H_demod_pair, cfg.fm_hop, state.pilot.filt)
        else:
            ys, filt_tail = DD.dist_fft_filter_multi(
                demod, self.H_demod_pair, cfg.fm_hop, state.pilot.filt, axis)
        pblock, pilot_state = recover_pilot(
            demod, self.pilot_cfg, state.pilot, pre=(ys[0], filt_tail),
            axis=axis)
        rds_pre = ys[1] if self.fuse_demod_filters else None
        base_phase = 2.0 * (pblock.phase + math.pi / 4.0)

        # --- PSS -------------------------------------------------------------
        pss_off, pss_state = pss_adapt(
            demod, base_phase, pblock.locked, self.pss_cfg, state.pss,
            active=(cfg.pss_active and cfg.mode != "mono"), axis=axis)

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
            * col(controls.pano)
        left = lr_sum + lr_diff
        right = lr_sum - lr_diff
        if taps is not None:
            taps["af_sum"] = lr_sum
            taps["af_diff"] = lr_diff
        if test_sound:
            # diagnostic mode (sin-phase oscillator), static by design
            audio = torch.complex(lr_diff, lr_diff)
        else:
            m = controls.sound_mix[..., None]        # [..., 2, 2, 1]
            audio = torch.complex(
                m[..., 0, 0, :] * left + m[..., 0, 1, :] * right,
                m[..., 1, 0, :] * left + m[..., 1, 1, :] * right)

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
            if not sharded:
                phase_del, phase_delay = B.delay_apply(pblock.phase,
                                                       state.phase_delay)
            else:
                d = state.phase_delay.shape[-1]
                halo = DD.left_halo(pblock.phase, d, state.phase_delay, axis)
                phase_del = torch.cat([halo, pblock.phase], dim=-1
                                      )[..., : pblock.phase.shape[-1]]
                phase_delay = pblock.phase[..., -d:]
            the_phase = 3.0 * phase_del
            rds_bb = rds_base * torch.complex(torch.cos(the_phase),
                                              -torch.sin(the_phase))
            if not sharded:
                z24, rds_decim_c = B.fir_decimate(
                    rds_bb, self.k_rds_decim, 8, state.rds_decim)
                if taps is not None:
                    taps["rds_baseband"] = z24
                    taps["rds_input"] = 20.0 * z24
                rds_out, demod24, bitrec_state = self._recover_bits(
                    z24, state.bitrec, taps is not None)
                if taps is not None:
                    taps["rds_demod"] = demod24
            else:
                # bit recovery needs the whole 24 kS/s stream: it rides the
                # end-of-chain gather
                z24, rds_decim_c = DD.dist_fir_decimate(
                    rds_bb, self.k_rds_decim, 8, state.rds_decim, axis)
        else:
            phase_delay = state.phase_delay

        # --- audio filter + deemphasis ---------------------------------------
        audio_filt = state.audio_filt
        if self.H_audio is not None:
            if not sharded:
                audio, audio_filt = B.fft_filter_apply(
                    audio, self.H_audio, cfg.fm_hop, state.audio_filt)
            else:
                audio, audio_filt = DD.dist_fft_filter(
                    audio, self.H_audio, cfg.fm_hop, state.audio_filt, axis)
        if self.deemph_folded:
            deemph_last = state.deemph      # folded into H_audio above
        elif not sharded:
            audio, deemph_last = B.ema_apply_complex(audio, self.deemph_alpha,
                                                     state.deemph)
        elif self.deemph_alpha < 1.0:
            a = self.deemph_alpha
            (yr, lr), (yi, li) = DD.dist_ema2(
                audio.real, a, state.deemph.real, audio.imag, a,
                state.deemph.imag, axis)
            audio, deemph_last = torch.complex(yr, yi), torch.complex(lr, li)
        else:
            # alpha = 1: the identity; the stream's last sample is the
            # last rank's, resolved with the end-of-chain gather
            audio, deemph_last = audio.to(torch.complex64), audio[..., -1]
        if taps is not None:
            taps["af_left_filtered"] = audio.real
            taps["af_right_filtered"] = audio.imag
            taps["af_mono_filtered"] = audio.real + audio.imag

        # --- volume / balance ------------------------------------------------
        audio = torch.complex(
            audio.real * col(controls.volume) * col(controls.left_gain),
            audio.imag * col(controls.volume) * col(controls.right_gain))

        # --- ÷4 to workingRate ----------------------------------------------
        if not sharded:
            pcm, audio_decim = B.fir_decimate(
                audio, self.k_audio_decim, cfg.fm_rate // cfg.working_rate,
                state.audio_decim)
        else:
            pcm, audio_decim = DD.dist_fir_decimate(
                audio, self.k_audio_decim, cfg.fm_rate // cfg.working_rate,
                state.audio_decim, axis)

        # --- startup/retune ramp ---------------------------------------------
        Tw = cfg.block_working
        Tw_local = pcm.shape[-1]
        first = axis.index * Tw_local if sharded else 0
        ramp_max = cfg.working_rate // 2
        pos = ramp_max - state.ramp_remaining + first
        gain = torch.clamp((col(pos) + torch.arange(
            Tw_local, dtype=torch.float32, device=dev)) / ramp_max, 0.0, 1.0)
        pcm = pcm * gain
        ramp_remaining = torch.clamp(state.ramp_remaining - Tw, min=0)

        # --- test tone: 25 ms of 1 kHz at 0.9 every 2 s; the program is
        # attenuated x0.1 for as long as the gate is on, between bursts too
        # (the reference's insertTestTone) --------------------------------
        tone_index = state.tone_index
        if cfg.test_tone:
            period = 2 * cfg.working_rate
            dur = cfg.working_rate // 40
            gate = col(controls.tone_gate)
            idx = (col(state.tone_index) + first + torch.arange(
                Tw_local, dtype=torch.int32, device=dev)) % period
            tone = 0.9 * torch.sin((2.0 * math.pi * 1000.0 / cfg.working_rate)
                                   * idx.to(torch.float32))
            tone = torch.where(idx < dur, tone, 0.0) * gate
            pcm = pcm * (1.0 - 0.9 * gate) + torch.complex(tone, tone)
            tone_index = (state.tone_index + Tw) % period

        # --- peak meter (local maxima when sharded: the gather below) -------
        peak_l = torch.abs(pcm.real).amax(dim=-1)
        peak_r = torch.abs(pcm.imag).amax(dim=-1)

        def to_db(p):
            return torch.where(p > 0, 20.0 * torch.log10(
                torch.clamp(p, min=1e-10)), -40.0)

        # --- optional upsample to audioRate (the -m 192 kHz mode) -----------
        audio_up_state = state.audio_up
        if self.k_audio_up is not None:
            up = cfg.audio_rate // cfg.working_rate
            if not sharded:
                pcm, audio_up_state = B.fir_interpolate(
                    pcm, self.k_audio_up, up, state.audio_up)
            else:
                pcm, audio_up_state = DD.dist_fir_interpolate(
                    pcm, self.k_audio_up, up, state.audio_up, axis)

        rf_dc = fe_updates["rf_dc"]
        fe_tails = {}
        if sharded:
            # ---- ONE gather resolves everything across the ranks: the
            # candidate stream tails (the last rank's row wins), the peak
            # maxima, the 24 kS/s RDS stream for bit recovery and the
            # deferred DC partials; the packing is lossless, so every
            # consumer sees the values per-tensor gathers would give -------
            parts = {"pilot_filt": pilot_state.filt,
                     "pss_tail": pss_state.tail,
                     "audio_decim": audio_decim,
                     "peaks": torch.stack([peak_l, peak_r]),
                     "demod_tail": torch.stack([demod_state.prev1,
                                                demod_state.prev2])}
            if not self.deemph_folded and self.deemph_alpha >= 1.0:
                parts["deemph"] = deemph_last
            for k in ("input_filt", "band1", "band2"):
                if fe_updates.get(k) is not None:
                    parts[k] = fe_updates[k]
            if cfg.rds != "off":
                parts.update(rds_decim=rds_decim_c, phase_delay=phase_delay,
                             z24=z24)
            if self.H_audio is not None:
                parts["audio_filt"] = audio_filt
            if self.k_audio_up is not None:
                parts["audio_up"] = audio_up_state
            # deferred: the partials, one axis more than the servo's state
            defer_dc = cfg.dc_remove and rf_dc.dim() > state.rf_dc.dim()
            if defer_dc:
                parts["dc"] = rf_dc
            names = list(parts)
            rows = dict(zip(names, DD.fused_gather([parts[k] for k in names],
                                                   axis)))
            pilot_state = pilot_state._replace(filt=rows["pilot_filt"][-1])
            pss_state = pss_state._replace(tail=rows["pss_tail"][-1])
            audio_decim = rows["audio_decim"][-1]
            demod_state = demod_state._replace(
                prev1=rows["demod_tail"][-1, 0],
                prev2=rows["demod_tail"][-1, 1])
            peak_l = rows["peaks"][:, 0].amax(dim=0)
            peak_r = rows["peaks"][:, 1].amax(dim=0)
            if "deemph" in rows:
                deemph_last = rows["deemph"][-1]
            for k in ("input_filt", "band1", "band2"):
                if k in rows:
                    fe_tails[k] = rows[k][-1]
            if self.H_audio is not None:
                audio_filt = rows["audio_filt"][-1]
            if self.k_audio_up is not None:
                audio_up_state = rows["audio_up"][-1]
            if defer_dc:
                rf_dc = self._dc_update(state.rf_dc, self.dc_mean(rows["dc"]))
            if cfg.rds != "off":
                rds57_filt = pilot_state.filt
                rds_decim_c = rows["rds_decim"][-1]
                phase_delay = rows["phase_delay"][-1]
                z24 = rows["z24"].movedim(0, -2)      # [..., P, T24 / P]
                rds_out, _, bitrec_state = self._recover_bits(
                    z24.reshape(lead + (-1,)), state.bitrec, False)

        hold = int(C.PILOT_LOCK_STABLE_S * cfg.fm_rate)
        meta = Meta(
            pilot_locked=(pilot_state.lock_run > hold if sharded
                          else pblock.locked[..., -1]),
            pilot_strength=(pilot_state.lock_metric if sharded
                            else pblock.strength[..., -1]),
            dc_rf_db=20.0 * torch.log10(torch.abs(rf_dc) + 1.0 / 32768.0),
            dc_if=demod_state.fm_afc,
            pss_phase_deg=(pss_state.acc if sharded else pss_off[..., -1])
            / math.pi * 180.0,
            pss_established=pss_state.minimized,
            peak_left_db=to_db(peak_l),
            peak_right_db=to_db(peak_r),
        )
        new_state = ReceiverState(
            n0_mod=fe_updates["n0_mod"], rf_dc=rf_dc,
            input_filt=fe_tails.get("input_filt", fe_updates["input_filt"]),
            band1=fe_tails.get("band1", fe_updates["band1"]),
            band2=fe_tails.get("band2", fe_updates["band2"]),
            demod=demod_state,
            squelch=squelch_state, pilot=pilot_state, pss=pss_state,
            phase_delay=phase_delay, rds57_filt=rds57_filt,
            rds_decim=rds_decim_c, bitrec=bitrec_state, audio_filt=audio_filt,
            deemph=deemph_last, audio_decim=audio_decim,
            ramp_remaining=ramp_remaining, audio_up=audio_up_state,
            tone_index=tone_index, rate_carry=fe_updates.get("rate_carry"))

        out_audio = torch.stack([pcm.real, pcm.imag], dim=-1)
        count = (rds_out.count if rds_out is not None
                 else torch.full(lead, -1, dtype=torch.int32, device=dev))
        meta_vec = torch.stack([t.to(torch.float32) for t in meta]
                               + [count.to(torch.float32)], dim=-1)
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

    def stations(self):
        """This receiver's `models.multistation.MultiStationReceiver`, one
        per receiver (memoized like `jit_step`), so that repeated
        `demodulate_stations` calls replay the n-station graph they
        captured."""
        if getattr(self, "_stations", None) is None:
            from .multistation import MultiStationReceiver
            self._stations = MultiStationReceiver(self)
        return self._stations

    def stations_on(self, mesh):
        """This receiver's `ShardedMultiStationReceiver` on `mesh` (a
        `parallel.sharding.Mesh`), memoized per mesh like `stations`."""
        got = getattr(self, "_mesh_stations", None)
        if got is None or got[0] != mesh:
            from .multistation import ShardedMultiStationReceiver
            got = (mesh, ShardedMultiStationReceiver(self, mesh))
            self._mesh_stations = got
        return got[1]

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
        scan).  Builds its new leaves without waiting for the card (the
        ramp from pinned memory, the zero states by fills)."""
        from ..runtime.graph import upload
        s = state._replace(
            ramp_remaining=upload(self.cfg.working_rate // 2, torch.int32,
                                  self.device),
            pss=pss_zero_state(self.pss_cfg, device=self.device))
        if s.bitrec is not None:
            s = s._replace(bitrec=self._bitrec_zero_state())
        return s
