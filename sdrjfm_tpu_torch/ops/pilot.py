"""19 kHz pilot recovery — analytic-signal estimator (port of
sdrjfm_tpu.ops.pilot).

A narrow one-sided FFT bandpass extracts the pilot's analytic signal p, and
the phase and lock are read from it directly:

    phi[n] = angle(p[n]) + w19*D + pi

The +pi reproduces the reference PLL's anti-phase lock, and w19*D
compensates the bandpass group delay D.  The lock metric smooths |p| with
alpha = 1/3000 (one launch of the scan kernel) and applies the 0.07 / 500 ms
hold rule.  On the main path the bandpass comes from the receiver's shared
pilot+RDS forward FFT (`pre=`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import constants as C
from . import design
from .blockops import (ema_apply, fft_filter_apply_multi,
                       fft_filter_zero_state, runlength_true)

Tensor = torch.Tensor

PILOT_BP_TAPS = 1537          # ~±500 Hz one-sided bandpass at 192 kHz
PILOT_BP_HALF_WIDTH = 500.0


class PilotConfig(NamedTuple):
    fft_size: int
    hop: int
    response: np.ndarray      # [fft] complex64 (host design data)
    group_delay: int          # (taps-1)/2
    rate: int


def make_pilot_config(rate: int = C.FM_RATE, fft_size: int = 8192,
                      taps: int = PILOT_BP_TAPS,
                      half_width: float = PILOT_BP_HALF_WIDTH,
                      hop: int = 0) -> PilotConfig:
    k = design.bandpass_complex(taps, C.PILOT_FREQUENCY - half_width,
                                C.PILOT_FREQUENCY + half_width, rate)
    H = design.fft_filter_response(k, fft_size).astype(np.complex64)
    hop = hop or fft_size // 2
    assert hop + taps - 1 <= fft_size
    return PilotConfig(fft_size=fft_size, hop=hop, response=H,
                       group_delay=(taps - 1) // 2, rate=rate)


class PilotState(NamedTuple):
    filt: Tensor              # fft-filter carry
    lock_metric: Tensor       # smoothed strength
    lock_run: Tensor          # consecutive above-threshold run length


def pilot_zero_state(cfg: PilotConfig, device=None) -> PilotState:
    return PilotState(
        filt=fft_filter_zero_state(cfg.fft_size, cfg.hop, device=device),
        lock_metric=torch.zeros((), dtype=torch.float32, device=device),
        lock_run=torch.zeros((), dtype=torch.int32, device=device),
    )


class PilotBlock(NamedTuple):
    phase: Tensor             # [T] reference-convention pilot phase
    locked: Tensor            # [T] bool
    strength: Tensor          # [T] lock strength track


def recover_pilot(demod: Tensor, cfg: PilotConfig, state: PilotState,
                  pre=None) -> Tuple[PilotBlock, PilotState]:
    """Per-sample pilot phase and lock over a block of demod at fmRate.

    `pre`, when given, is `(p, filt_tail)`: the analytic pilot signal
    (demod filtered with 5x the config response) and its carry, computed by
    the caller's shared forward FFT."""
    if pre is not None:
        p, filt = pre
    else:
        H = 5.0 * torch.as_tensor(cfg.response, device=demod.device)
        ys, filt = fft_filter_apply_multi(demod, H[None, :], cfg.hop,
                                          state.filt)
        p = ys[0]
    w19 = 2.0 * math.pi * C.PILOT_FREQUENCY / cfg.rate
    phase = torch.angle(p) + (w19 * cfg.group_delay + math.pi)
    strength, metric_last = ema_apply(torch.abs(p), C.PILOT_LOCK_ALPHA,
                                      state.lock_metric)
    run, run_last = runlength_true(strength > C.PILOT_LOCK_THRESHOLD,
                                   state.lock_run)
    hold = int(C.PILOT_LOCK_STABLE_S * cfg.rate)
    locked = run > hold
    new = PilotState(filt=filt, lock_metric=metric_last, lock_run=run_last)
    return PilotBlock(phase=phase, locked=locked, strength=strength), new
