"""FM discriminators, batched (port of sdrjfm_tpu.ops.demod).

Each sample is normalised to the unit circle and compared with the previous
one; the only carried state is the 1-2 sample history and two one-pole
trackers (AFC and AM carrier), which run as ONE two-row launch of the scan
kernel.  `complex_baseband` and `mixed` are ported (they are the same
math); the other discriminators are listed in ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import constants as C
from .blockops import ema_apply_rows

Tensor = torch.Tensor

PORTED_DECODERS = ("mixed", "complex_baseband")


class DemodState(NamedTuple):
    prev1: Tensor        # normalised z[-1]
    prev2: Tensor        # normalised z[-2]
    fm_afc: Tensor       # post-demod DC tracker
    am_carr: Tensor      # carrier amplitude tracker
    pll_phase: Tensor    # PLL decoder NCO phase (pll not ported; kept 0)
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


def demodulate_block(z: Tensor, state: DemodState,
                     decoder: str = "mixed", rate: int = C.FM_RATE
                     ) -> Tuple[Tensor, DemodState, Tensor]:
    """Demodulate a block of complex baseband at the fm rate.  Returns
    (demod [T] f32 scaled 20*(res - afc)/K_FM, new state, carrier amplitude
    track [T])."""
    if decoder not in PORTED_DECODERS:
        raise NotImplementedError(
            f"decoder {decoder!r} is not ported yet (ROADMAP.md queue 1: "
            f"the other discriminators)")
    mag = torch.abs(z)
    zn = _normalize(z)
    p1 = torch.cat([state.prev1[None], zn[:-1]])
    # atan2(Q*I1 - I*Q1, I*I1 + Q*Q1) == arg(z * conj(prev))
    d = zn * torch.conj(p1)
    res = torch.atan2(d.imag, d.real)
    (am_track, am_last), (afc_track, afc_last) = ema_apply_rows(
        [mag, res], [C.CARRIER_ALPHA, C.FM_DC_ALPHA],
        [state.am_carr, state.fm_afc])
    out = C.DEMOD_GAIN * (res - afc_track) / C.k_fm(rate)
    prev2 = zn[-2] if zn.shape[0] >= 2 else state.prev1
    new = state._replace(prev1=zn[-1], prev2=prev2, fm_afc=afc_last,
                         am_carr=am_last)
    return out.to(torch.float32), new, am_track
