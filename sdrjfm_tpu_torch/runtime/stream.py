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
                drop_blocks: int = 0,
                collect_taps: bool = False,
                init_state=None,
                rds_feedback=None) -> StreamResult:
    """Process a full IQ array (wire format: complex64 [T], or [T,2] int16 /
    uint8 / int8 per rx.cfg.iq_format) through the receiver.

    drop_blocks: leading blocks left out of the result (filter warm-up),
    while the state still advances through them.  collect_taps: gather the
    debug taps (cfg.emit_taps) per name.  init_state: a ReceiverState to
    start from (for example one carried across with convert.state_from_numpy).

    rds_feedback(bits) -> bool is the block synchronizer's feedback into the
    bit decoder, called with each block's bits in block order.  With
    decoder 3 (cfg.rds == "scan3") it runs after every block, and True arms
    Receiver.request_rds_resync before the next one: one extra bit fetch a
    block.  The other decoders take no resync request, so for them the
    calls wait until the run has ended (the bits come back in one transfer)
    and the return value is ignored: no added sync on their path."""
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
    per_block_feedback = rds_feedback is not None and cfg.rds == "scan3"

    audio, metas, bits, biq = [], [], [], []
    fed, counts = [], []              # deferred feedback: every block's bits
    taps: dict = {}
    for b in range(nblocks):
        blk = wire_t[b * T:(b + 1) * T].to(rx.device)
        state, out = rx.step(state, controls, blk)
        # the one device->host transfer per block
        meta, n = meta_dict_from_vec(out.meta_vec.cpu().numpy())
        if per_block_feedback and out.rds is not None:
            if rds_feedback(out.rds.bits[:n].cpu().numpy()):
                state = rx.request_rds_resync(state)
        elif rds_feedback is not None and out.rds is not None:
            fed.append(out.rds.bits[:n])
            counts.append(n)
        if b < drop_blocks:
            continue
        audio.append(out.audio)
        metas.append(meta)
        if out.rds is not None:
            bits.append(out.rds.bits[:n])
            biq.append(out.rds.iq[:n])
        if collect_taps and out.taps:
            for k, v in out.taps.items():
                taps.setdefault(k, []).append(v)

    res = StreamResult(audio=(torch.cat(audio).cpu().numpy() if audio
                              else np.zeros((0, 2), np.float32)),
                       meta=metas, final_state=state)
    if taps:
        res.taps = {k: torch.cat(v).cpu().numpy() for k, v in taps.items()}
    if bits:
        res.rds_bits = torch.cat(bits).cpu().numpy()
        res.rds_iq = torch.cat(biq).cpu().numpy()
    if fed:
        all_bits = torch.cat(fed).cpu().numpy()
        edges = np.cumsum([0] + counts)
        for i in range(len(counts)):
            rds_feedback(all_bits[edges[i]:edges[i + 1]])
    return res
