"""Offline runner for the block receiver (port of the `run_offline` part of
sdrjfm_tpu.runtime.stream).

`run_offline` feeds the capture through `Receiver.step` block by block.
Per block it fetches one packed vector from the device (`Output.meta_vec`:
the metadata scalars and the RDS bit count); the audio and the RDS bits stay
on the device until the run ends and come back in one transfer each.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..models.receiver import Controls, Receiver, meta_dict_from_vec

_WIRE_DTYPES = {"c64": np.complex64, "i16": np.int16, "i8": np.int8,
                "u8": np.uint8}


@dataclass
class StreamResult:
    audio: np.ndarray                 # [n, 2] float32 at working rate
    meta: List[dict] = field(default_factory=list)
    rds_bits: Optional[np.ndarray] = None
    rds_iq: Optional[np.ndarray] = None
    taps: dict = field(default_factory=dict)
    final_state: object = None
    dropped_total: int = 0


def run_offline(rx: Receiver, iq: np.ndarray,
                controls: Optional[Controls] = None,
                init_state=None,
                rds_feedback=None) -> StreamResult:
    """Process a full IQ array (wire format: complex64 [T], or [T,2] int16 /
    uint8 / int8 per rx.cfg.iq_format) through the receiver.

    init_state: a ReceiverState to start from (for example one carried
    across with convert.state_from_numpy).  rds_feedback(bits) is called
    with each block's recovered bits, in block order, once the run has
    ended (the bits come back from the device in one transfer); its return
    value is ignored, since the block bit decoder takes no resync
    request."""
    cfg = rx.cfg
    controls = controls if controls is not None else rx.initial_controls()
    T = cfg.wire_len
    nblocks = len(iq) // T
    if nblocks <= 0:
        raise ValueError(f"need at least {T} samples, got {len(iq)}")
    state = init_state if init_state is not None else rx.init_state()
    wire = np.ascontiguousarray(iq[: nblocks * T], _WIRE_DTYPES[cfg.iq_format])
    if not wire.flags.writeable:      # a wav read straight from its buffer
        wire = wire.copy()
    wire_t = torch.from_numpy(wire)

    audio, metas, bits, biq, counts = [], [], [], [], []
    for b in range(nblocks):
        blk = wire_t[b * T:(b + 1) * T].to(rx.device)
        state, out = rx.step(state, controls, blk)
        # the one device->host transfer per block
        meta, n = meta_dict_from_vec(out.meta_vec.cpu().numpy())
        audio.append(out.audio)
        metas.append(meta)
        if out.rds is not None:
            bits.append(out.rds.bits[:n])
            biq.append(out.rds.iq[:n])
            counts.append(n)

    res = StreamResult(audio=torch.cat(audio).cpu().numpy(), meta=metas,
                       final_state=state)
    if bits:
        res.rds_bits = torch.cat(bits).cpu().numpy()
        res.rds_iq = torch.cat(biq).cpu().numpy()
        if rds_feedback is not None:
            edges = np.cumsum([0] + counts)
            for i in range(len(counts)):
                rds_feedback(res.rds_bits[edges[i]:edges[i + 1]])
    return res
