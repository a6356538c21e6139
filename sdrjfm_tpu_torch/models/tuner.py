"""Tuning / AFC / band-scan controller (the RadioInterface logic, C1); port
of sdrjfm_tpu.models.tuner.

Host-side control loop around the captured receiver step, mirroring the
reference controller semantics:

  set_tuner    : radio.cpp:1040-1075 — retune inside the capture window by
                 changing the LO offset only (a control leaf, nothing is
                 captured anew); offsets beyond the window are rejected (a
                 live SDR would retune hardware; a file capture cannot).
  AFC          : radio.cpp:1786-1809 — closes a loop around the demodulator's
                 DC component every block with the reference's adaptive gain
                 (0.05 nominal, 0.8 when |dc| is large, 0.005 near lock) and
                 3 Hz deadband.
  scan         : radio.cpp:1115-1158 + fm-processor scan path — every LO
                 offset of a grid over the window as one row of one
                 front-end call (JAX steps them one at a time), then the
                 reference's detection rule per row.
  retune resets: triggerFrequencyChange (fm-processor.cpp:849-855) — audio
                 ramp, RDS reset, PSS reset.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import constants as C
from .receiver import Controls, Receiver
from .scanner import scan_decision
from ..runtime.graph import tree_broadcast, tree_clone, wire_np_dtype


class AFCTracker:
    """The AFC loop filter (radio.cpp:1786-1809), step-able per block.

    offset = K_FM-scaled demod DC converted to Hz, integrated with an
    adaptive alpha (0.005 near lock / 0.05 / 0.8 far off) and a 3 Hz
    deadband.  Shared by RadioController and the rx CLI's --afc.
    """

    def __init__(self, fm_rate: int = C.FM_RATE):
        self.fm_rate = fm_rate
        self.offset = 0.0

    def reset(self):
        self.offset = 0.0

    def update(self, dc_component: float) -> float:
        """Feed the block's demod DC (meta.dc_if); returns the accumulated
        LO correction in Hz."""
        freq_off = dc_component * self.fm_rate / (2.0 * np.pi)
        if abs(freq_off) > 1000.0:
            alpha = 0.8
        elif abs(freq_off) > 100.0:
            alpha = 0.05
        else:
            alpha = 0.005
        if abs(freq_off) >= 3.0:       # deadband (radio.cpp:1809)
            self.offset += alpha * freq_off
        return self.offset


@dataclass
class RadioController:
    rx: Receiver
    afc_active: bool = False
    lo_freq: int = 0
    controls: Optional[Controls] = None

    def __post_init__(self):
        if self.controls is None:
            # seed from the config so cfg.sound/cfg.panorama are honored,
            # exactly like the runners
            self.controls = self.rx.initial_controls()
        self._step = self.rx.jit_step()
        self.state = self.rx.init_state()
        self._afc = AFCTracker(self.rx.cfg.fm_rate)
        self._set_lo(self.lo_freq)

    # -- tuning --------------------------------------------------------
    @property
    def max_offset(self) -> int:
        """Retune window: |offset| <= inputRate/2 - fmRate (radio.cpp:1048)."""
        return self.rx.cfg.input_rate // 2 - self.rx.cfg.fm_rate

    def set_tuner(self, offset_hz: int):
        if abs(offset_hz) > self.max_offset:
            raise ValueError(f"offset {offset_hz} outside capture window "
                             f"±{self.max_offset}")
        big_step = abs(offset_hz - self.lo_freq) >= 100_000
        self.lo_freq = int(offset_hz)
        self._afc.reset()
        self._set_lo(self.lo_freq)
        if big_step:
            self.trigger_frequency_change()

    def _set_lo(self, f: float):
        self.controls = self.controls._replace(
            lo_freq_hz=torch.tensor(int(round(f)), dtype=torch.int32,
                                    device=self.rx.device))

    def trigger_frequency_change(self):
        """Audio mute ramp + RDS/PSS reset (fm-processor.cpp:849-855)."""
        self.state = self.rx.retune_reset(self.state)

    def _wire(self, iq_block) -> torch.Tensor:
        """A host block in the receiver's wire format, on its device."""
        x = np.ascontiguousarray(iq_block, wire_np_dtype(self.rx.cfg))
        return torch.from_numpy(x).to(self.rx.device)

    # -- processing with AFC -------------------------------------------
    def process_block(self, iq_block):
        """One block through the captured step; returns its Output (a copy:
        the step's own outputs are overwritten by the next block)."""
        self.state, out = self._step(self.state, self.controls,
                                     self._wire(iq_block))
        if self.afc_active:
            self._afc_update(float(out.meta.dc_if))
        return tree_clone(out)

    def _afc_update(self, dc_component: float):
        """radio.cpp:1786-1809 via AFCTracker (demod DC (fm_afc) is in
        pre-scale units; the frequency offset is dc * fmRate / (2*pi))."""
        self._set_lo(self.lo_freq + self._afc.update(dc_component))

    # -- band scan ------------------------------------------------------
    def scan(self, iq_block, grid_hz: int = 100_000,
             threshold_db: float = 20.0) -> List[int]:
        """Scan LO offsets across the capture window on one block; returns
        offsets that trigger the reference's detection rule.  Every offset
        is one row of one front-end call at the initial state, with the
        controller's controls at that offset."""
        start = -(self.max_offset // grid_hz) * grid_hz
        offsets = list(range(start, self.max_offset + 1, grid_hz))
        n = len(offsets)
        dev = self.rx.device
        controls = tree_broadcast(self.controls, n)._replace(
            lo_freq_hz=torch.tensor(offsets, dtype=torch.int32, device=dev))
        v, _ = self.rx.front_end_rows(
            tree_broadcast(self.rx.init_state(), n), controls,
            self._wire(iq_block))
        hit, _ = scan_decision(v, threshold_db)
        return [o for o, h in zip(offsets, hit.tolist()) if h]
