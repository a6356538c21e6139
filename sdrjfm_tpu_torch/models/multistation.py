"""Multi-station receiver: demodulate N stations from ONE capture at once
(port of sdrjfm_tpu.models.multistation).

The reference tunes one station at a time: retuning is an LO-offset change
and the band scan identifies hits serially.  The JAX package vmaps
`Receiver.step` over a station axis: the wideband block is shared, each
station carries its own `Controls` and its own state.  Here the station
axis is a leading dimension of every tensor: one front-end launch runs
every station as a row of the shared block (`Receiver.front_end_rows`,
`csrc/frontend.cu` over R rows), then ONE `Receiver.fm_chain` runs every
station at once, each op [S, ...] wide (the trackers' two scan launches,
the squelch's pole bank, the FFTs and convolutions carry S rows), so an
n-station step has one station's op count.  Each station computes what
its own single-station step computes (on the CPU bit for bit).
`jit_step()` records the n-station block into one CUDA graph
(`runtime.graph.StepGraph`), and `demodulate_stations` replays it over a
capture.

The station axis across devices (`ShardedMultiStationReceiver`,
`demodulate_stations(mesh=)`) needs no collective: each device of a
`parallel.sharding.Mesh` runs whole stations (the padded station list
split evenly) against its own copy of the wideband block, with its own
captured graph, and every device's step is queued before any result is
fetched.  A mesh may name one device more than once.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .receiver import Controls, Receiver, meta_dict_from_vec
from ..runtime.graph import StepGraph, tree_broadcast
from ..runtime.stream import _wire_blocks

class MultiStationReceiver:
    """`Receiver.step` over a leading station axis, one shared block."""

    def __init__(self, rx: Receiver):
        assert rx.cfg.rds in ("off", "block"), \
            "scan RDS decoders are per-sample sequential; use rds='block'"
        self.rx = rx
        self.cfg = rx.cfg
        self.device = rx.device
        self._jit: Optional[_StationsStep] = None

    def init_states(self, n_stations: int):
        """The receiver's initial state with every leaf repeated along a
        leading [n_stations] axis."""
        return tree_broadcast(self.rx.init_state(), n_stations)

    def controls_for(self, offsets_hz: Sequence[int],
                     squelch_levels: Optional[Sequence[float]] = None
                     ) -> Controls:
        """Controls with a leading [n] axis: each station's LO offset and
        squelch level (0 without `squelch_levels`), unit gains and volume,
        and the receiver's panorama, sound mix ([n, 2, 2]) and tone gate on
        every station."""
        n = len(offsets_hz)
        levels = [0.0] * n if squelch_levels is None else list(squelch_levels)
        if len(levels) != n:
            raise ValueError(f"{len(levels)} squelch levels for {n} stations")
        dev = self.device
        base = self.rx.initial_controls()   # seeds pano + sound mix
        ones = lambda: torch.ones(n, dtype=torch.float32, device=dev)  # noqa: E731
        return Controls(
            lo_freq_hz=torch.tensor([int(o) for o in offsets_hz],
                                    dtype=torch.int32, device=dev),
            volume=ones(), left_gain=ones(), right_gain=ones(),
            input_lgain=ones(), input_rgain=ones(),
            squelch_level=torch.tensor(levels, dtype=torch.float32,
                                       device=dev),
            pano=tree_broadcast(base.pano, n),
            sound_mix=tree_broadcast(base.sound_mix, n),
            tone_gate=tree_broadcast(base.tone_gate, n))

    def step(self, states, controls: Controls, iq: torch.Tensor):
        """One shared input block -> per-station (states, Output) with a
        leading station axis on every leaf: one `front_end_rows` call (one
        kernel launch on the fused path) and one `fm_chain` call over the
        [n, block_fm] rows."""
        v, fe = self.rx.front_end_rows(states, controls, iq)
        return self.rx.fm_chain(states, controls, v, fe)

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
    """The station axis over the devices of a `parallel.sharding.Mesh`.

    Each mesh entry runs `n_stations / n_devices` COMPLETE stations through
    its own MultiStationReceiver (its own captured graph) against a copy of
    the wideband block on its device: zero collectives.  Per-station
    results are those of the one-device MultiStationReceiver (on the CPU
    bit for bit: each row of every batched op computes alone).  n_stations must be a multiple of the mesh size: `pad_offsets`
    rounds a hit list up with dummy stations at offset 0, whose results
    callers drop.  States, controls and outputs are lists, one entry per
    mesh device."""

    def __init__(self, rx: Receiver, mesh=None, axis: str = "stations"):
        from ..parallel.sharding import _same_device, make_mesh
        super().__init__(rx)
        self.mesh = mesh if mesh is not None else make_mesh(axis=axis)
        self.axis = axis
        self.n_devices = len(self.mesh.devices)
        receivers = []
        for d in self.mesh.devices:
            r = next((x for x in [rx] + receivers
                      if _same_device(x.device, d)), None)
            receivers.append(r if r is not None else Receiver(rx.cfg, d))
        self.parts = [MultiStationReceiver(r) for r in receivers]

    def pad_offsets(self, offsets_hz: Sequence[int]) -> List[int]:
        """Round a station list up to a multiple of the mesh size (dummy
        stations at offset 0; callers drop their results)."""
        offsets = list(offsets_hz)
        return offsets + [0] * ((-len(offsets)) % self.n_devices)

    def _split(self, n: int) -> int:
        if n % self.n_devices:
            raise ValueError(f"{n} stations over {self.n_devices} devices "
                             f"(use pad_offsets)")
        return n // self.n_devices

    def init_states(self, n_stations: int):
        k = self._split(n_stations)
        return [p.init_states(k) for p in self.parts]

    def controls_for(self, offsets_hz: Sequence[int],
                     squelch_levels: Optional[Sequence[float]] = None):
        k = self._split(len(offsets_hz))
        offs = list(offsets_hz)
        levels = ([0.0] * len(offs) if squelch_levels is None
                  else list(squelch_levels))
        return [p.controls_for(offs[i * k:(i + 1) * k],
                               levels[i * k:(i + 1) * k])
                for i, p in enumerate(self.parts)]

    def step(self, states, controls, iq: torch.Tensor):
        """One shared block -> ([states], [Output]) per mesh device: the
        block is copied to every device and each device's step queued
        before any result is read."""
        news, outs = [], []
        for p, st, ctl in zip(self.parts, states, controls):
            new, out = p.step(st, ctl, iq.to(p.device, non_blocking=True))
            news.append(new)
            outs.append(out)
        return news, outs


class _Drive:
    """One device's share of `demodulate_stations`: its stations' graph
    over the capture, stepped a block at a time (`step`) so that several
    devices' drives can be interleaved, read at the end (`result`)."""

    def __init__(self, msr: MultiStationReceiver, wire: np.ndarray,
                 offsets: Sequence[int], levels, scan: bool):
        n = len(offsets)
        self.nblocks = wire.shape[0]
        self.sg = msr.jit_step().for_stations(n)
        self.states, self.controls = (msr.init_states(n),
                                      msr.controls_for(offsets, levels))
        self.sc = None
        if scan:
            self.sc = self.sg.scan(self.nblocks)
            self.sc.prepare()
            self.sg.load(self.states, self.controls)
            self.sc.load_blocks(wire)
        else:
            self.wire = torch.from_numpy(wire)
            self.acc, self.b = [], 0

    def step(self) -> None:
        if self.sc is not None:
            self.sc.step()
            return
        self.states, out = self.sg(self.states, self.controls,
                                   self.wire[self.b])
        self.b += 1
        d = {"audio": out.audio.clone(), "meta_vec": out.meta_vec.clone()}
        if out.rds is not None:
            d.update(rds_bits=out.rds.bits.clone(),
                     rds_count=out.rds.count.clone())
        self.acc.append(d)

    def result(self) -> dict:
        if self.sc is not None:
            return self.sc.fetch(self.nblocks)
        return {k: torch.stack([d[k] for d in self.acc]).cpu().numpy()
                for k in self.acc[0]}


def demodulate_stations(rx: Receiver, iq: np.ndarray,
                        offsets_hz: Sequence[int],
                        mesh=None, scan: bool = True,
                        squelch_levels: Optional[Sequence[float]] = None
                        ) -> List[dict]:
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
    mesh: a `parallel.sharding.Mesh` puts the station axis on its devices
    (ShardedMultiStationReceiver, kept with `rx` per mesh): the list is
    padded to the mesh size, each device's blocks are queued in turn, and
    the dummy results are dropped.  Each station's result is bit for bit
    the one-device run's.
    squelch_levels: each station's squelch level (the config's squelch;
    0 for every station without it).
    """
    n_real = len(offsets_hz)
    cfg = rx.cfg
    nblocks = len(iq) // cfg.wire_len
    if nblocks <= 0 or n_real <= 0:
        raise ValueError(f"demodulate_stations: need at least one station "
                         f"and {cfg.wire_len} samples, got {n_real} "
                         f"stations and {len(iq)} samples")
    wire = _wire_blocks(iq, cfg, nblocks)
    if mesh is None:
        parts, offs = [rx.stations()], list(offsets_hz)
    else:
        smsr = rx.stations_on(mesh)
        offs = smsr.pad_offsets(offsets_hz)
        parts = smsr.parts
    levels = ([0.0] * len(offs) if squelch_levels is None
              else list(squelch_levels) + [0.0] * (len(offs) - n_real))
    if len(levels) != len(offs):
        raise ValueError(f"demodulate_stations: {len(squelch_levels)} "
                         f"squelch levels for {n_real} stations")
    k = len(offs) // len(parts)
    drives = [_Drive(p, wire, offs[i * k:(i + 1) * k],
                     levels[i * k:(i + 1) * k], scan)
              for i, p in enumerate(parts)]
    for _ in range(nblocks):
        for d in drives:
            d.step()
    gots = [d.result() for d in drives]
    results = []
    for s in range(n_real):      # padded dummy stations are dropped
        got, j = gots[s // k], s % k
        bits = None
        if "rds_bits" in got:
            bits = np.concatenate([got["rds_bits"][b, j,
                                                   : int(got["rds_count"][b, j])]
                                   for b in range(nblocks)])
        audio = got["audio"]                   # [nb, k, Tb, 2]
        results.append({
            "offset_hz": int(offs[s]),
            "audio": audio[:, j].reshape(-1, audio.shape[-1]),
            "rds_bits": bits,
            "meta": meta_dict_from_vec(got["meta_vec"][-1, j])[0],
        })
    return results
