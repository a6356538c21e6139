"""Noise and level squelch (port of sdrjfm_tpu.ops.squelch).

Noise squelch: compare decaying-average band energies of a Chebyshev
highpass above key-100 Hz and a lowpass below key (key = 70 kHz at the fm
rate); decisions latch with hysteresis at the end of every hold period.
Level squelch gates on the demodulator's tracked carrier amplitude against
10^((n-80)/30).

Block shape: both band filters run in ONE call of the pole-bank kernel
(`iir_apply_many`); the rest is ONE launch of `kernels.loops.squelch_gate`,
which reads both bands' outputs and the demod once, forms the decaying
averages' values at the period ends (never the full-rate averages), runs
the ~23 Hz decision lattice (16 hold periods a block at block_fm=131072)
and writes the gated demod; the level squelch is one launch of it too.  On
the CPU its plain version runs (one two-row scan, the period ends, the
lattice as a loop over the periods, the gate): no host sync.  A block may
carry leading station rows ([..., T], the level [...]): every row's filters
share the pole-bank launch, its squelch the gate launch.  The time-sharded
path (`axis`) keeps the steps apart: the averages through dist_ema2, the
period ends gathered across ranks, the lattice as
`kernels.loops.squelch_decide`, and the gate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..kernels import loops as L
from . import design
from .blockops import IIRBank, IIRSpec, iir_apply_many, iir_bank

Tensor = torch.Tensor


class SquelchConfig(NamedTuple):
    hp: IIRSpec
    lp: IIRSpec
    hold_period: int
    rate: int


def make_squelch_config(rate: int = C.FM_RATE, key_freq: int = 70000,
                        order: int = 20,
                        hold_period: int = 8192) -> SquelchConfig:
    """The order-20 Chebyshev pair of the reference's squelch (cheby1, 1 dB
    ripple), deciding every 8192 samples so hold periods tile power-of-two
    blocks."""
    hp = IIRSpec(design.cheby1_sos(order // 2, key_freq - 100, rate,
                                   "highpass"))
    lp = IIRSpec(design.cheby1_sos(order // 2, min(key_freq, int(0.49 * rate)),
                                   rate, "lowpass"))
    return SquelchConfig(hp=hp, lp=lp, hold_period=hold_period, rate=rate)


class SquelchState(NamedTuple):
    hp_state: tuple
    lp_state: tuple
    avg_high: Tensor
    avg_low: Tensor
    suppress: Tensor          # latched decision
    phase: Tensor             # samples into the current hold period


def squelch_zero_state(cfg: SquelchConfig, device=None) -> SquelchState:
    f = lambda: torch.zeros((), dtype=torch.float32, device=device)  # noqa: E731
    return SquelchState(
        hp_state=cfg.hp.zero_state(device), lp_state=cfg.lp.zero_state(device),
        avg_high=f(), avg_low=f(),
        suppress=torch.zeros((), dtype=torch.bool, device=device),
        phase=torch.zeros((), dtype=torch.int32, device=device))


def _periods(T: int, H: int) -> int:
    if T % H:
        raise ValueError(f"squelch: block of {T} samples is not a multiple "
                         f"of the {H}-sample hold period")
    return T // H


def squelch_bank(cfg: SquelchConfig, device) -> IIRBank:
    """The band filters' constants on `device`, for noise_squelch."""
    return iir_bank([cfg.hp, cfg.lp], device)


def _gathered_periods(axis, *xs: Tensor):
    """The period-end values [..., nper] of every rank (one gather), in
    rank order along the last axis."""
    g = axis.all_gather(torch.stack(xs))          # [P, len(xs), ..., nper]
    g = g.movedim(0, -2)                          # [len(xs), ..., P, nper]
    return tuple(g.reshape(g.shape[:-2] + (-1,)))


def _own(sups: Tensor, nper: int, axis) -> Tensor:
    return sups[..., axis.index * nper:(axis.index + 1) * nper]


def noise_squelch(x: Tensor, level: Tensor, cfg: SquelchConfig,
                  state: SquelchState, bank: Optional[IIRBank] = None,
                  axis=None) -> Tuple[Tensor, SquelchState]:
    """Noise squelch over a demod block.  level: 0-dim tensor 0..100 (the
    slider); threshold = 1 - level/100.  Decisions at the end of each hold
    period of a block-aligned lattice.  bank: squelch_bank(cfg, x.device),
    built once by a block loop; without it the filters are copied to the
    device on this call.

    Without `axis` the squelch after the filters is one squelch_gate
    launch.  With `axis` (a TimeAxis, x this rank's slice) the band filters
    run through parallel.distributed.dist_iir_many (both cascades' pole
    banks in one kernel call, one ring halo, one gather), the decaying
    averages through dist_ema2 (one gather); the decision lattice
    (squelch_decide) runs over every rank's period-end averages (one
    gather) on every rank alike, and each rank gates its own periods.
    Requires T_local % hold_period == 0."""
    T = x.shape[-1]
    H = cfg.hold_period
    nper = _periods(T, H)
    thr = 1.0 - level.to(torch.float32) / 100.0
    w = 1.0 / (cfg.rate / 100.0)        # decayingAverage weight
    if bank is None:
        bank = squelch_bank(cfg, x.device)
    if axis is None:
        (v1, hp_state), (v2, lp_state) = iir_apply_many(
            [x, x], bank, [state.hp_state, state.lp_state])
        y, _, sup, (ah_last, al_last) = L.squelch_gate(
            "nsq", v1, v2, x, thr, (state.avg_high, state.avg_low),
            state.suppress, H, w)
    else:
        from ..parallel import distributed as DD
        (v1, hp_state), (v2, lp_state) = DD.dist_iir_many(
            [x, x], bank, [state.hp_state, state.lp_state], axis)
        (ah, ah_last), (al, al_last) = DD.dist_ema2(
            torch.abs(v1), w, state.avg_high, torch.abs(v2), w,
            state.avg_low, axis)
        per = x.shape[:-1] + (nper, H)
        ah_p, al_p = _gathered_periods(axis, ah.reshape(per)[..., -1],
                                       al.reshape(per)[..., -1])
        sups, sup = L.squelch_decide("nsq", ah_p, al_p, thr, state.suppress)
        y = L.gate_periods(x, _own(sups, nper, axis), H)
    new = SquelchState(hp_state=hp_state, lp_state=lp_state, avg_high=ah_last,
                       avg_low=al_last, suppress=sup, phase=state.phase)
    return y, new


def level_squelch(x: Tensor, carrier: Tensor, level: Tensor,
                  cfg: SquelchConfig, state: SquelchState, axis=None
                  ) -> Tuple[Tensor, SquelchState]:
    """Level squelch on the tracked carrier amplitude [..., T]: one
    squelch_gate launch.  With `axis` the period-end carrier values of
    every rank arrive in one gather, the decisions (squelch_decide) run on
    every rank alike and each rank gates its own periods."""
    T = x.shape[-1]
    H = cfg.hold_period
    nper = _periods(T, H)
    thr = torch.pow(10.0, (level.to(torch.float32) - 80.0) / 30.0)
    if axis is None:
        y, _, sup, _ = L.squelch_gate("level", carrier, None, x, thr, None,
                                      state.suppress, H, 0.0)
        return y, state._replace(suppress=sup)
    c_p, = _gathered_periods(
        axis, carrier.reshape(carrier.shape[:-1] + (nper, H))[..., -1])
    sups, sup = L.squelch_decide("level", c_p, None, thr, state.suppress)
    return (L.gate_periods(x, _own(sups, nper, axis), H),
            state._replace(suppress=sup))


# --------------------------------------------------------------------------
# host-side profile for the automatic level (numpy/scipy)
# --------------------------------------------------------------------------


def host_demod_profile(iq: np.ndarray, iq_format: str = "c64",
                       lo_freq_hz: int = 0,
                       input_rate: int = C.INPUT_RATE) -> np.ndarray:
    """Cheap host-side FM demod of one input block, for profiling only
    (auto_squelch_level): convert -> LO mix -> decimate ÷12 -> quadrature
    discriminator.  Band-energy ratios at the fm rate are what the profile
    needs, and those are insensitive to the kernel details.

    Wire formats as the receiver decodes them: i16 /32768, u8 (v-127)/128,
    and i8 signed /128 (the hackrf convention).  The JAX package has no i8
    branch (it reads an i8 [T,2] capture as if it were complex); this port
    decides it as the receiver's own i8 decode (ROADMAP.md queue 3)."""
    from scipy import signal
    if iq_format == "i16":
        x = (iq[:, 0].astype(np.float32)
             + 1j * iq[:, 1].astype(np.float32)) / 32768.0
    elif iq_format == "u8":
        x = ((iq[:, 0].astype(np.float32) - 127.0)
             + 1j * (iq[:, 1].astype(np.float32) - 127.0)) / 128.0
    elif iq_format == "i8":
        x = (iq[:, 0].astype(np.float32)
             + 1j * iq[:, 1].astype(np.float32)) / 128.0
    else:
        x = np.asarray(iq, np.complex64)
    if lo_freq_hz:
        n = np.arange(len(x), dtype=np.float64)
        x = x * np.exp(-2j * np.pi * lo_freq_hz / input_rate * n)
    k = design.lowpass_sinc(127, 110000.0, input_rate)
    v = signal.lfilter(k, [1.0], x)[11::12]
    d = np.angle(v[1:] * np.conj(v[:-1]))
    return d.astype(np.float32)


def auto_squelch_level(demod: np.ndarray, rate: int = C.FM_RATE,
                       key_freq: int = 70000, margin: float = 0.5) -> float:
    """A noise-squelch slider level from a measured demod segment: the
    band-energy ratio r = avg_high/avg_low at its end, the threshold placed
    `margin` of the way from r toward 1 (pure noise), level =
    100*(1 - thr)."""
    from scipy import signal
    x = np.asarray(demod, np.float32)
    hp = design.cheby1_sos(10, key_freq - 100, rate, "highpass")
    lp = design.cheby1_sos(10, min(key_freq, int(0.49 * rate)), rate,
                           "lowpass")
    v1 = np.abs(signal.sosfilt(hp, x))
    v2 = np.abs(signal.sosfilt(lp, x))
    w = 1.0 / (rate / 100.0)
    b, a = [w], [1.0, -(1.0 - w)]
    ah = signal.lfilter(b, a, v1)[-1]
    al = signal.lfilter(b, a, v2)[-1]
    r = float(ah / max(al, 1e-12))
    thr = min(1.0, r + margin * (1.0 - r))
    return float(np.clip(100.0 * (1.0 - thr), 0.0, 100.0))
