"""FM discriminators, batched (port of sdrjfm_tpu.ops.demod).

The six selectable algorithms of the reference's fm_Demodulator.  Each
sample is normalised to the unit circle and compared with the previous one;
the only carried state is the 1-2 sample history, two one-pole trackers
(AFC and AM carrier) and, for `pll`, its frequency estimate.  The two
trackers run as ONE two-row launch of the scan kernel where their drives
are independent (every decoder but `pll`, whose AFC drive is the output of
its own one-pole: two launches then).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

import math

import numpy as np

from .. import constants as C
from .blockops import ema_apply, ema_apply_rows, linrec_apply

Tensor = torch.Tensor

DECODERS = ("am", "pll", "mixed", "complex_baseband", "real_baseband",
            "difference")


class DemodState(NamedTuple):
    prev1: Tensor        # normalised z[-1]
    prev2: Tensor        # normalised z[-2]
    fm_afc: Tensor       # post-demod DC tracker
    am_carr: Tensor      # carrier amplitude tracker
    pll_phase: Tensor    # PLL decoder NCO phase (the batched pll keeps 0)
    pll_incr: Tensor     # PLL decoder frequency estimate


def demod_zero_state(device=None) -> DemodState:
    z = torch.tensor(0.01 + 0.01j, dtype=torch.complex64, device=device)
    f = lambda: torch.zeros((), dtype=torch.float32, device=device)  # noqa: E731
    return DemodState(z, z.clone(), f(), f(), f(), f())


def _normalize(z: Tensor) -> Tensor:
    """Unit-circle projection with the reference's small-signal clamp:
    |z| <= 0.001 -> (0.001, 0.001)."""
    mag = torch.abs(z)
    small = mag <= 1e-3
    safe = torch.where(small, 1.0, mag)
    return torch.complex(torch.where(small, 1e-3, z.real / safe),
                         torch.where(small, 1e-3, z.imag / safe))


def _arg(d: Tensor) -> Tensor:
    return torch.atan2(d.imag, d.real)


def demodulate_block(z: Tensor, state: DemodState,
                     decoder: str = "mixed", rate: int = C.FM_RATE
                     ) -> Tuple[Tensor, DemodState, Tensor]:
    """Demodulate a block of complex baseband at the fm rate.  Returns
    (demod [T] f32 scaled 20*(res - afc)/K_FM — the clipped envelope for
    `am` —, new state, carrier amplitude track [T])."""
    if decoder not in DECODERS:
        raise ValueError(f"unknown decoder {decoder!r}")
    mag = torch.abs(z)
    zn = _normalize(z)
    p1 = torch.cat([state.prev1[None], zn[:-1]])
    prev2 = zn[-2] if zn.shape[0] >= 2 else state.prev1
    tail = dict(prev1=zn[-1], prev2=prev2)
    if decoder == "am":
        # the AFC tracker runs on a zero drive, as the JAX receiver feeds it
        (am_track, am_last), (_, afc_last) = ema_apply_rows(
            [mag, torch.zeros_like(mag)], [C.CARRIER_ALPHA, C.FM_DC_ALPHA],
            [state.am_carr, state.fm_afc])
        res = _decode_am(mag, am_track)
        return res, state._replace(am_carr=am_last, fm_afc=afc_last,
                                   **tail), am_track
    if decoder in ("mixed", "complex_baseband"):
        # atan2(Q*I1 - I*Q1, I*I1 + Q*Q1) == arg(z * conj(prev))
        res = _arg(zn * torch.conj(p1))
    elif decoder == "real_baseband":
        # (I1*Q - Q1*I + 1)/2 -> asin(2u-1)/2, exact asin for the LUT
        u = (p1.real * zn.imag - p1.imag * zn.real + 1.0) / 2.0
        res = torch.asin(2.0 * torch.clamp(u, 0.0, 1.0) - 1.0) / 2.0
    elif decoder == "difference":
        p2 = torch.cat([state.prev2[None], state.prev1[None], zn[:-2]]
                       )[: zn.shape[0]]
        num = (p1.real * (zn.imag - p2.imag)
               - p1.imag * (zn.real - p2.real))
        den = (p1.real ** 2 + p1.imag ** 2) * math.sqrt(2.0)
        res = num / den
    else:                                               # pll
        res, pll_last = _decode_pll_block(zn, p1, state, rate)
        am_track, am_last = ema_apply(mag, C.CARRIER_ALPHA, state.am_carr)
        afc_track, afc_last = ema_apply(res, C.FM_DC_ALPHA, state.fm_afc)
        out = C.DEMOD_GAIN * (res - afc_track) / C.k_fm(rate)
        new = state._replace(fm_afc=afc_last, am_carr=am_last,
                             pll_incr=pll_last, **tail)
        return out.to(torch.float32), new, am_track
    (am_track, am_last), (afc_track, afc_last) = ema_apply_rows(
        [mag, res], [C.CARRIER_ALPHA, C.FM_DC_ALPHA],
        [state.am_carr, state.fm_afc])
    out = C.DEMOD_GAIN * (res - afc_track) / C.k_fm(rate)
    new = state._replace(fm_afc=afc_last, am_carr=am_last, **tail)
    return out.to(torch.float32), new, am_track


def _decode_am(mag: Tensor, carr: Tensor) -> Tensor:
    """AM envelope path (fm_Demodulator::decodeAM)."""
    res = (mag - carr) / torch.clamp(carr, min=0.01)
    return torch.clamp(res, -1.0, 1.0)


def _decode_pll_block(zn: Tensor, p1: Tensor, state: DemodState, rate: int):
    """The JAX package's batched PLL discriminator: the instantaneous
    frequency arg(z[n] conj(z[n-1])) through the PLL's steady-state one-pole
    Beta = exp(-2 pi (0.85 rate)/2/rate), seeded with the carried phase
    increment.  Like JAX it linearises the reference's feedback loop (about
    28 dB against the compiled reference, COVERAGE.md); ROADMAP queue 3."""
    beta = float(np.exp(np.float32(-2.0 * math.pi * (0.85 * rate) / 2.0
                                   / rate)))
    inst = _arg(zn * torch.conj(p1))
    return linrec_apply((1.0 - beta) * inst, beta, state.pll_incr)
