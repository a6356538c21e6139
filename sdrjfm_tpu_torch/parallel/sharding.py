"""Time-sharded receivers over torch.distributed (port of
sdrjfm_tpu.parallel.sharding).

The reference's only concurrency is a thread pipeline over ring buffers on
one host.  The JAX package scales by data parallelism over time: each
device of a `time` mesh axis holds a contiguous slice of every input block
inside `shard_map`.  Here each slice is a rank: one process per rank,
joined in a process group (`parallel.distributed.TimeAxis`, made by
`init_time_axis`), every rank calling `step` with its slice (or the whole
block, which it slices itself).  The classes:

  ShardedReceiver      the front end on the slice (the fused kernel with a
                       wire halo, or the split path with ring halos), then
                       ONE gather of the 192 kS/s stream, the tails and the
                       DC partials; the fm chain runs replicated.  The
                       front end is bit for bit the single-device one, and
                       so is the step (on the card up to the look-back
                       scans' timing-dependent last bits, which two
                       single-device runs show too).
  FullyShardedReceiver the front end AND the fm chain on the slice
                       (Receiver.fm_chain(axis=)): ring halos, distributed
                       recurrences, one end-of-chain gather.  The audio is
                       the rank's slice; it agrees with the single-device
                       step to f32 reassociation (~1e-5), the RDS bits are
                       equal.
  StationTimeShardedReceiver  stations x time: S station groups of T
                       ranks each (`make_mesh_2d`, one process group per
                       station group), each rank running its station
                       group's stations on its time slice as ONE batched
                       FullySharded step (a leading station axis on every
                       op, as JAX vmaps it): the collectives of one
                       station whatever the group's size.

The step runs eagerly: gloo cannot be captured into a CUDA graph, and an
NCCL capture is later work.  `init_state` builds the receiver's initial
state on the rank's device (the same on every rank).

`make_mesh` lists the devices of one process (the station axis,
models.multistation.ShardedMultiStationReceiver); the time axis is the
process group itself.  JAX's `relaxed_shard_map` has no counterpart: there
is no shard_map, and no replication check to relax.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.frontend import DC_SUBSAMPLE
from ..models.receiver import Controls, Receiver, ReceiverState
from ..runtime.graph import tree_broadcast
from .distributed import TimeAxis, fused_gather, rank_device

AXIS = "time"


class Mesh(NamedTuple):
    """Devices of one process along one named axis; a device may appear
    more than once (several shards of one card)."""
    devices: Tuple[torch.device, ...]
    axis: str = AXIS


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS,
              device=None) -> Mesh:
    """`n_devices` devices (default: every card).  On CUDA entry i is card
    i % device_count, so a machine with fewer cards than n_devices names
    each card more than once; device='cpu' lists the CPU n_devices times.
    Raises when CUDA is asked for and there is no card."""
    if device is not None and torch.device(device).type == "cpu":
        return Mesh(tuple([torch.device("cpu")] * (n_devices or 1)), axis)
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available; pass "
                           "device='cpu' for a CPU mesh")
    count = torch.cuda.device_count()
    n = n_devices or count
    return Mesh(tuple(torch.device("cuda", i % count) for i in range(n)),
                axis)


def _same_device(a: torch.device, b: torch.device) -> bool:
    canon = lambda d: (d.type, d.index if d.index is not None or d.type != "cuda"  # noqa: E731
                       else torch.cuda.current_device())
    return canon(torch.device(a)) == canon(torch.device(b))


def _local(iq: torch.Tensor, axis: TimeAxis, block: int) -> torch.Tensor:
    """This rank's slice of a whole block, or the slice as given."""
    t = block // axis.size
    if iq.shape[0] == block and axis.size > 1:
        return iq[axis.index * t:(axis.index + 1) * t]
    if iq.shape[0] != t:
        raise ValueError(f"step: {iq.shape[0]} samples, want the block "
                         f"({block}) or this rank's slice ({t})")
    return iq


class _TimeSharded:
    """What the time-sharded receivers share: the receiver on the rank's
    device, the axis and the slicing."""

    def __init__(self, rx: Receiver, axis: TimeAxis):
        if not _same_device(rx.device, axis.device):
            raise ValueError(f"the receiver is on {rx.device}, the rank's "
                             f"device is {axis.device}")
        self.rx = rx
        self.axis = axis
        self.cfg = rx.cfg

    def init_state(self) -> ReceiverState:
        return self.rx.init_state()

    def local(self, iq: torch.Tensor) -> torch.Tensor:
        return _local(iq, self.axis, self.cfg.block_in)

    def _n0_next(self, state):
        cfg = self.cfg
        return (state.n0_mod + cfg.block_in) % cfg.input_rate


class ShardedReceiver(_TimeSharded):
    """Receiver step with the front end partitioned over the time axis and
    the fm chain replicated: the single-device step bit for bit (its front
    end on the card too)."""

    def __init__(self, rx: Receiver, axis: TimeAxis):
        super().__init__(rx, axis)
        cfg, n = rx.cfg, axis.size
        t_local = cfg.block_in // n
        _require(cfg.block_in % n == 0, "block_in % ranks")
        _require(t_local % 12 == 0 and t_local % DC_SUBSAMPLE == 0,
                 "the slice % 12 and % the DC subsample stride")
        if cfg.input_filter:
            _require(t_local % cfg.input_hop == 0, "the slice % input_hop")

    def front(self, state: ReceiverState, controls: Controls,
              iq: torch.Tensor):
        """The sharded front end and its ONE gather: (v [block_fm], the
        front end's state updates), the same on every rank and equal to
        the single-device front end's bit for bit."""
        rx, cfg = self.rx, self.cfg
        v, (dc, in_tail, t1, t2, _, _) = rx.front_end(
            state, controls, self.local(iq), axis=self.axis, defer_dc=True)
        parts = [v, t1, t2]
        if cfg.input_filter:
            parts.append(in_tail)
        if cfg.dc_remove:
            parts.append(dc)
        rows = fused_gather(parts, self.axis)
        fe = dict(n0_mod=self._n0_next(state),
                  rf_dc=(rx._dc_update(state.rf_dc, rx.dc_mean(rows[-1]))
                         if cfg.dc_remove else dc),
                  input_filt=rows[3][-1] if cfg.input_filter else None,
                  band1=rows[1][-1], band2=rows[2][-1])
        return rows[0].reshape(-1), fe

    def step(self, state: ReceiverState, controls: Controls,
             iq: torch.Tensor):
        v, fe = self.front(state, controls, iq)
        return self.rx.fm_chain(state, controls, v, fe)


class FullyShardedReceiver(_TimeSharded):
    """Receiver step with BOTH the front end and the fm chain partitioned
    over the time axis.  Audio agrees with the single-device step to f32
    reassociation of the distributed prefix sums (~1e-5); the RDS bits are
    equal.  Every rank returns its slice of the audio and the replicated
    meta and RDS."""

    def __init__(self, rx: Receiver, axis: TimeAxis):
        super().__init__(rx, axis)
        n = axis.size
        cfg = rx.cfg
        # the debug taps are per-rank time slices: use ShardedReceiver (or
        # the single-device step) for tap and scope work
        _require(not cfg.emit_taps,
                 "emit_taps is not supported by FullyShardedReceiver", True)
        t_fm_local = cfg.block_fm // n
        _require(cfg.block_in % n == 0, "block_in % ranks")
        _require(t_fm_local % cfg.fm_hop == 0, "the fm slice % fm_hop")
        _require(t_fm_local % rx.pss_cfg.subblock == 0,
                 "the fm slice % the PSS sub-block")
        _require((cfg.block_in // n) % 12 == 0, "the slice % 12")
        _require((cfg.block_in // n) % DC_SUBSAMPLE == 0,
                 "the slice % the DC subsample stride")
        if cfg.squelch != "off":
            _require(t_fm_local % rx.squelch_cfg.hold_period == 0,
                     "the fm slice % the squelch hold period")
        if cfg.audio_rate != cfg.working_rate:
            _require(t_fm_local % (cfg.fm_rate // cfg.working_rate) == 0,
                     "the fm slice % the audio decimation")
        if cfg.input_filter:
            _require((cfg.block_in // n) % cfg.input_hop == 0,
                     "the slice % input_hop")

    def step(self, state: ReceiverState, controls: Controls,
             iq: torch.Tensor):
        rx = self.rx
        # defer_dc: the DC partials ride fm_chain's end-of-chain gather,
        # with the front end's candidate tails
        v, (dc, in_tail, t1, t2, _, _) = rx.front_end(
            state, controls, self.local(iq), axis=self.axis, defer_dc=True)
        fe = dict(n0_mod=self._n0_next(state), rf_dc=dc, input_filt=in_tail,
                  band1=t1,
                  band2=t2 if self.cfg.frontend == "reference" else None)
        new, out = rx.fm_chain(state, controls, v, fe, axis=self.axis)
        if fe["band2"] is None:
            new = new._replace(band2=state.band2)
        return new, out


def _require(ok: bool, what: str, verbatim: bool = False) -> None:
    if not ok:
        raise ValueError(what if verbatim else f"sharded step: {what} "
                         f"must be 0")


# ---------------------------------------------------------------------------
# Stations x time
# ---------------------------------------------------------------------------


class StationTimeMesh(NamedTuple):
    """This rank's place on a stations x time grid of the world's ranks:
    world rank s * n_time + t holds time slice t of station group s."""
    station_index: int
    n_station_groups: int
    time: TimeAxis


def make_mesh_2d(n_stations: int, n_time: int,
                 device=None) -> StationTimeMesh:
    """The stations x time grid over the world (n_stations * n_time
    ranks): one process group per station group, made by `dist.new_group`
    on every rank (a collective: every rank calls this)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_stations * n_time:
        raise ValueError(f"make_mesh_2d: {n_stations} x {n_time} ranks, the "
                         f"world has {world}")
    groups = [dist.new_group(list(range(s * n_time, (s + 1) * n_time)))
              for s in range(n_stations)]
    s = rank // n_time
    return StationTimeMesh(s, n_stations,
                           TimeAxis(groups[s], rank_device(rank, device)))


class StationTimeShardedReceiver:
    """BOTH parallel dimensions: stations x time.  Each rank runs the
    stations of its station group (`controls_for` keeps them) through ONE
    FullyShardedReceiver step on its time slice, the stations a leading
    axis of every op (JAX vmaps `one_station` inside its shard_map): 5
    gathers and 8 halos a step on the main config whatever the number of
    stations, every collective inside the station group's time axis.  Per-station outputs agree with
    MultiStationReceiver to f32 reassociation (~1e-5), the RDS bits are
    equal.  The same caps as the JAX class: rds off or block, no taps."""

    def __init__(self, rx: Receiver, mesh: StationTimeMesh):
        cfg = rx.cfg
        n_t = mesh.time.size
        _require(cfg.rds in ("off", "block") and not cfg.emit_taps,
                 "StationTimeShardedReceiver: rds must be off or block, "
                 "and no taps", True)
        _require(cfg.block_fm % (n_t * cfg.fm_hop) == 0,
                 "block_fm % (time ranks * fm_hop)")
        _require((cfg.block_fm // n_t) % rx.pss_cfg.subblock == 0,
                 "the fm slice % the PSS sub-block")
        self.rx = rx
        self.mesh = mesh
        self.axis = mesh.time
        self.n_station_groups = mesh.n_station_groups
        self.inner = FullyShardedReceiver(rx, mesh.time)

    def pad_offsets(self, offsets_hz: Sequence[int]):
        offsets = list(offsets_hz)
        return offsets + [0] * ((-len(offsets)) % self.n_station_groups)

    def _mine(self, n: int) -> slice:
        if n % self.n_station_groups:
            raise ValueError(f"{n} stations over {self.n_station_groups} "
                             f"station groups (use pad_offsets)")
        k = n // self.n_station_groups
        return slice(self.mesh.station_index * k,
                     (self.mesh.station_index + 1) * k)

    def init_states(self, n_stations: int):
        """This station group's states: the initial state repeated along a
        leading [n_stations / S] axis."""
        s = self._mine(n_stations)
        return tree_broadcast(self.rx.init_state(), s.stop - s.start)

    def controls_for(self, offsets_hz: Sequence[int]) -> Controls:
        """This station group's controls (its share of `offsets_hz`)."""
        from ..models.multistation import MultiStationReceiver
        offs = list(offsets_hz)[self._mine(len(offsets_hz))]
        return MultiStationReceiver(self.rx).controls_for(offs)

    def step(self, states, controls: Controls, iq: torch.Tensor):
        """Every station of the group on this rank's time slice, as one
        batched step; outputs carry the station axis (audio [n/S, Tw/T,
        2])."""
        return self.inner.step(states, controls, iq)


# ---------------------------------------------------------------------------
# An offline drive
# ---------------------------------------------------------------------------


class ShardedRun(NamedTuple):
    """What `run_sharded` returns on each rank (host arrays)."""
    audio: np.ndarray          # this rank's audio, blocks concatenated
    rds_bits: list             # per station: the bits (uint8), replicated
    meta_vec: np.ndarray       # [blocks(, stations), len(Meta)+1]
    counts: dict               # collectives of the last step
    step_ms: list              # host ms per step (synchronised)
    collective_ms: list        # host ms inside collectives per step


def run_sharded(srx, stage, controls: Optional[Controls] = None,
                state=None) -> ShardedRun:
    """Step a sharded receiver over a capture on this rank: `stage(b)`
    returns this rank's slice of block b on its device (None after the
    last block; multihost.global_iq_block stages one from pinned memory),
    and this rank keeps its slice of the audio.  For
    StationTimeShardedReceiver `controls` and `state` are the station
    group's (required)."""
    axis, rx = srx.axis, srx.rx
    dev = axis.device
    if controls is None:
        controls = rx.initial_controls()
    if state is None:
        state = srx.init_state()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    audio, metas, bits = [], [], None
    step_ms, coll_ms, counts = [], [], {}
    b = 0
    while (x := stage(b)) is not None:
        axis.reset_counts()
        sync()
        t0 = time.perf_counter()
        state, out = srx.step(state, controls, x)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        coll_ms.append(axis.seconds * 1e3)
        counts = dict(axis.counts)
        audio.append(out.audio.cpu().numpy())
        metas.append(out.meta_vec.cpu().numpy())
        if out.rds is not None:
            cnt = out.rds.count.reshape(-1).cpu().numpy()
            bb = out.rds.bits.reshape(len(cnt), -1).cpu().numpy()
            if bits is None:
                bits = [[] for _ in cnt]
            for s, c in enumerate(cnt):
                bits[s].append(bb[s, :int(c)])
        b += 1
    cat_axis = 1 if audio[0].ndim == 3 else 0
    return ShardedRun(
        audio=np.concatenate(audio, axis=cat_axis),
        rds_bits=([np.concatenate(x).astype(np.uint8) for x in bits]
                  if bits is not None else []),
        meta_vec=np.stack(metas), counts=counts, step_ms=step_ms,
        collective_ms=coll_ms)
