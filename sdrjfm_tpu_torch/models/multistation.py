"""Multi-station receiver: demodulate N stations from ONE capture at once
(port of sdrjfm_tpu.models.multistation).

The reference tunes one station at a time: retuning is an LO-offset change
and the band scan identifies hits serially.  The JAX package vmaps
`Receiver.step` over a station axis: the wideband block is shared, each
station carries its own `Controls` and its own state.  Here the station
axis is written out: one front-end launch runs every station as a row of
the shared block (`Receiver.front_end_rows`, `csrc/frontend.cu` over R
rows), then each station's fm chain runs on its slice of the stacked state
and the outputs are stacked again.  Each station computes what its own
single-station step computes, row for row.  `jit_step()` records the whole
n-station block into one CUDA graph (`runtime.graph.StepGraph`), and
`demodulate_stations` replays it over a capture.

The sharded station axis (`ShardedMultiStationReceiver`, `mesh=`) is the
multi-GPU work of ROADMAP.md queue 1 #24: it raises here.  One card holds
every station.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .receiver import Controls, Receiver, meta_dict_from_vec
from ..runtime.graph import (StepGraph, tree_broadcast, tree_index,
                             tree_stack)
from ..runtime.stream import _wire_blocks

MESH_NOT_PORTED = ("the sharded station axis is not ported yet (ROADMAP.md, "
                   "queue 1 #24: multi-GPU); one card holds every station")


class MultiStationReceiver:
    """`Receiver.step` over a leading station axis, one shared block."""

    def __init__(self, rx: Receiver):
        assert rx.cfg.rds in ("off", "block"), \
            "scan RDS decoders are per-sample sequential; use rds='block'"
        self.rx = rx
        self.cfg = rx.cfg
        self.device = rx.device
        self._rows = {}               # n -> int32 [n] zeros: every row on block 0
        self._jit: Optional[_StationsStep] = None

    def init_states(self, n_stations: int):
        """The receiver's initial state with every leaf repeated along a
        leading [n_stations] axis."""
        return tree_broadcast(self.rx.init_state(), n_stations)

    def controls_for(self, offsets_hz: Sequence[int]) -> Controls:
        """Controls with a leading [n] axis: each station's LO offset, unit
        gains and volume, squelch level 0, and the receiver's panorama,
        sound mix ([n, 2, 2]) and tone gate on every station."""
        n = len(offsets_hz)
        dev = self.device
        base = self.rx.initial_controls()   # seeds pano + sound mix
        ones = lambda: torch.ones(n, dtype=torch.float32, device=dev)  # noqa: E731
        return Controls(
            lo_freq_hz=torch.tensor([int(o) for o in offsets_hz],
                                    dtype=torch.int32, device=dev),
            volume=ones(), left_gain=ones(), right_gain=ones(),
            input_lgain=ones(), input_rgain=ones(),
            squelch_level=torch.zeros(n, dtype=torch.float32, device=dev),
            pano=tree_broadcast(base.pano, n),
            sound_mix=tree_broadcast(base.sound_mix, n),
            tone_gate=tree_broadcast(base.tone_gate, n))

    def _row_index(self, n: int) -> torch.Tensor:
        idx = self._rows.get(n)
        if idx is None:
            idx = torch.zeros(n, dtype=torch.int32, device=self.device)
            self._rows[n] = idx
        return idx

    def step(self, states, controls: Controls, iq: torch.Tensor):
        """One shared input block -> per-station (states, Output) with a
        leading station axis on every leaf.  The front end of every station
        is one `front_end_rows` call (one kernel launch on the fused path);
        each station's fm chain then runs on its row."""
        n = int(controls.lo_freq_hz.shape[0])
        v, fe = self.rx.front_end_rows(states, controls, iq.unsqueeze(0),
                                       self._row_index(n))
        news, outs = [], []
        for s in range(n):
            new, out = self.rx.fm_chain(
                tree_index(states, s), tree_index(controls, s), v[s],
                {k: (None if x is None else x[s]) for k, x in fe.items()})
            news.append(new)
            outs.append(out)
        return tree_stack(news), tree_stack(outs)

    def jit_step(self) -> "_StationsStep":
        """The captured form of `step`, called like it: a
        `runtime.graph.StepGraph` of the n-station step for the n of the
        call.  One graph is kept: a call with another n drops it and
        captures anew."""
        if self._jit is None:
            self._jit = _StationsStep(self)
        return self._jit


class _Stations:
    """The n-station step as `StepGraph` captures it."""

    def __init__(self, msr: MultiStationReceiver, n: int):
        self.msr, self.n = msr, n
        self.cfg, self.device = msr.cfg, msr.device

    def init_state(self):
        return self.msr.init_states(self.n)

    def initial_controls(self) -> Controls:
        return self.msr.controls_for([0] * self.n)

    def step(self, states, controls, iq):
        return self.msr.step(states, controls, iq)


class _StationsStep:
    """What `MultiStationReceiver.jit_step()` returns: the StepGraph of the
    latest station count."""

    def __init__(self, msr: MultiStationReceiver):
        self.msr = msr
        self.graph: Optional[StepGraph] = None

    def for_stations(self, n: int) -> StepGraph:
        """The StepGraph of n stations (captured at its first call)."""
        g = self.graph
        if g is not None and g.rx.n == n:
            return g
        if g is not None and g.captures:
            torch.cuda.synchronize(g.device)
        self.graph = None             # freed before the new one allocates
        self.graph = StepGraph(_Stations(self.msr, n))
        return self.graph

    def __call__(self, states, controls: Controls, iq: torch.Tensor):
        n = int(controls.lo_freq_hz.shape[0])
        return self.for_stations(n)(states, controls, iq)


class ShardedMultiStationReceiver(MultiStationReceiver):
    """The station axis on several cards: not ported (ROADMAP.md queue 1
    #24)."""

    def __init__(self, rx: Receiver, mesh=None, axis: str = "stations"):
        raise NotImplementedError(MESH_NOT_PORTED)


def demodulate_stations(rx: Receiver, iq: np.ndarray,
                        offsets_hz: Sequence[int],
                        mesh=None, scan: bool = True) -> List[dict]:
    """Offline helper: run the whole capture for every offset at once.
    Returns per-station dicts with 'offset_hz', 'audio' [n, 2], 'rds_bits'
    (np.uint8, None without RDS) and 'meta' (the last block's metadata).

    iq: the capture in rx.cfg's wire format (complex64 [N], or [N, 2]).
    The n-station graph is kept with `rx` (`Receiver.stations()`): a later
    call with as many stations replays it, one with another count captures
    anew.
    scan: replay the n-station graph over the whole capture staged on the
    device as one chunk (`ScanGraph`, one replay a block, one fetch at the
    end); False steps it a block at a time (`jit_step()`, an upload and
    the outputs kept on the device each block).  The two agree (on the
    CPU bit for bit; on the card a look-back scan's last bits may vary).
    mesh: the sharded station axis is not ported (ROADMAP.md queue 1 #24);
    anything but None raises NotImplementedError.
    """
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    msr = rx.stations()
    n = len(offsets_hz)
    cfg = rx.cfg
    nblocks = len(iq) // cfg.wire_len
    if nblocks <= 0 or n <= 0:
        raise ValueError(f"demodulate_stations: need at least one station "
                         f"and {cfg.wire_len} samples, got {n} stations and "
                         f"{len(iq)} samples")
    wire = _wire_blocks(iq, cfg, nblocks)
    sg = msr.jit_step().for_stations(n)
    states, controls = msr.init_states(n), msr.controls_for(offsets_hz)
    if scan:
        sc = sg.scan(nblocks)
        sc.prepare()
        sg.load(states, controls)
        sc.load_blocks(wire)
        for _ in range(nblocks):
            sc.step()
        got = sc.fetch(nblocks)
    else:
        wire_t = torch.from_numpy(wire)
        acc = []
        for b in range(nblocks):
            states, out = sg(states, controls, wire_t[b])
            d = {"audio": out.audio.clone(), "meta_vec": out.meta_vec.clone()}
            if out.rds is not None:
                d.update(rds_bits=out.rds.bits.clone(),
                         rds_count=out.rds.count.clone())
            acc.append(d)
        got = {k: torch.stack([d[k] for d in acc]).cpu().numpy()
               for k in acc[0]}
    audio = got["audio"]                       # [nb, n, Tb, 2]
    results = []
    for s in range(n):
        bits = None
        if "rds_bits" in got:
            bits = np.concatenate([got["rds_bits"][b, s,
                                                   : int(got["rds_count"][b, s])]
                                   for b in range(nblocks)])
        results.append({
            "offset_hz": int(offsets_hz[s]),
            "audio": audio[:, s].reshape(-1, audio.shape[-1]),
            "rds_bits": bits,
            "meta": meta_dict_from_vec(got["meta_vec"][-1, s])[0],
        })
    return results
