"""Worker processes for the multi-process paths (port of
sdrjfm_tpu.parallel.multihost_worker), and the rank launcher they share.

The JAX package's worker, with its argv and JSON output:

    python -m sdrjfm_tpu_torch.parallel.multihost_worker <rendezvous> \\
        <proc_id> <num_procs> <ranks_per_proc> <out_json> [nblocks] \\
        [--device cpu|cuda]

Each of num_procs processes runs ranks_per_proc ranks (JAX's devices per
process; more than one are spawned from the process), so the world has
num_procs * ranks_per_proc ranks.  <rendezvous> is a port (a TCP store on
localhost, rank 0 hosts it), a file path (a FileStore), or `env` for
torchrun's environment (`torchrun --nproc-per-node 2 -m
sdrjfm_tpu_torch.parallel.multihost_worker env - - 1 out.json --device
cpu`: proc_id and num_procs come from RANK and WORLD_SIZE, and a `{proc}`
in <out_json> becomes the process index).  Every rank synthesises the same
deterministic capture, stages ONLY its own host_slice of each block
(multihost.global_iq_block) and steps the FullyShardedReceiver; each
process writes {"process", "bits", "rms", "devices", "transport"}: the
replicated RDS bits and the audio RMS of every block, equal on every rank.

`spawn` starts the ranks of one process group (spawn start method, a
FileStore rendezvous, gloo on the CPU, NCCL or host-staged gloo on cards)
and runs a function of this package on each; `run_jobs` is the function
the tests and chip_smoke.py hand it: sharded receivers over captures
stored as .npy files, and the distributed helpers on slices of stored
inputs, each rank writing its results to an .npz.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .distributed import TimeAxis, init_time_axis, rank_device

BLOCK_FM = 16384
PROFILED_STEPS = 2             # steps a profiled job traces on each rank


# ---------------------------------------------------------------------------
# the rank launcher
# ---------------------------------------------------------------------------


def _rendezvous(spec: str, world: int):
    """A port (a TCP store on localhost), `env` (torchrun's environment) or
    a file path (a FileStore)."""
    if spec == "env":
        return "env://"
    if spec.isdigit():
        return f"tcp://localhost:{spec}"
    return dist.FileStore(spec, world)


def _rank_entry(local: int, first: int, world: int, rendezvous: str, device,
                target, args) -> None:
    """Process entry of rank first + local: join the group, run
    target(axis, *args), leave the group."""
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    axis = init_time_axis(first + local, world,
                          _rendezvous(rendezvous, world), device)
    try:
        target(axis, *args)
    finally:
        dist.destroy_process_group()


def spawn(target, world: int, args=(), device=None,
          timeout: float = 600.0) -> None:
    """Run `target(axis, *args)` on the `world` ranks of a new group, each
    a new process (the spawn start method), joined through a FileStore in
    a temporary directory.  Each rank runs on rank_device(rank, device):
    by default the cards (rank % their count; raises here, before any
    rank starts, when there is none); device="cpu" runs the ranks on the
    CPU.  `target` must be a module-level function (it is pickled by
    name).  Raises the first rank's exception, or TimeoutError (after
    terminating the ranks) when they have not all finished within
    `timeout` seconds."""
    rank_device(0, device)
    with tempfile.TemporaryDirectory(prefix="sdrjfm_ranks_") as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_entry, args=(0, world, str(Path(tmp) / "store"), device,
                               target, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"spawn: ranks still running after "
                                   f"{timeout} s")


# ---------------------------------------------------------------------------
# jobs: what the tests and chip_smoke.py run on the ranks
# ---------------------------------------------------------------------------


def counters() -> dict:
    """The kernel wrappers whose `launches` a job reports."""
    from ..kernels import loops as L
    from ..kernels.frontend import frontend
    from ..kernels.linrec import linrec, pole_bank
    from ..rds import scan_decoders as SD
    return {"frontend": frontend, "linrec": linrec, "pole_bank": pole_bank,
            "rds_scan1": SD.decoder1_scan, "rds_scan2": SD.decoder2_scan,
            "rds_scan3": SD.decoder3_scan, "pss_scan": L.pss_scan,
            "pss_adapt": L.pss_adapt, "runlength": L.runlength,
            "psi_unwrap": L.psi_unwrap, "psi_recover": L.psi_recover,
            "squelch_decide": L.squelch_decide,
            "squelch_gate": L.squelch_gate}


def _controls(rx, values: dict):
    ctl = rx.initial_controls()
    return ctl._replace(**{k: torch.full_like(getattr(ctl, k), v)
                           for k, v in values.items()})


def _profiled_kernels(fn) -> dict:
    """{device kernel name: launches} of one call of fn (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count > 0}


def _receiver_job(axis: TimeAxis, job: dict, out: Path) -> None:
    from ..models.receiver import Receiver, ReceiverConfig
    from . import sharding as S
    cfg = ReceiverConfig(**job["cfg"])
    rx = Receiver(cfg, device=axis.device)
    wire = np.load(job["capture"], mmap_mode="r")
    if job["kind"] == "station_time":
        mesh = S.make_mesh_2d(job["n_stations"],
                              axis.size // job["n_stations"], axis.device)
        srx = S.StationTimeShardedReceiver(rx, mesh)
        offs = srx.pad_offsets(job["offsets"])
        state, controls = srx.init_states(len(offs)), srx.controls_for(offs)
        rank_in_time = mesh.time.index
    else:
        srx = getattr(S, job["cls"])(rx, axis)
        state, controls = srx.init_state(), _controls(rx,
                                                      job.get("controls", {}))
        rank_in_time = axis.index
    t = cfg.block_in // srx.axis.size
    nb = len(wire) // cfg.block_in

    def stage(b):                     # only this rank's slice is read
        if b >= nb:
            return None
        lo = b * cfg.block_in + rank_in_time * t
        from .multihost import global_iq_block
        return global_iq_block(wire[lo:lo + t], srx.axis)

    cnt = counters()
    for c in cnt.values():
        c.launches = 0
    res = S.run_sharded(srx, stage, controls=controls, state=state)
    launches = {k: c.launches for k, c in cnt.items()}
    kernels, steps = {}, 0
    if job.get("profile") and axis.device.type == "cuda":
        # every rank traces PROFILED_STEPS more steps in one window
        steps = PROFILED_STEPS
        st0 = srx.init_states(len(offs)) if job["kind"] == "station_time" \
            else srx.init_state()
        x = stage(0)

        def run():
            st = st0
            for _ in range(steps):
                st, _ = srx.step(st, controls, x)

        kernels = _profiled_kernels(run)
    fe = {}
    if job.get("front_end"):
        # ShardedReceiver's front end alone over the capture, its state
        # carried block to block: the gathered stream and the DC servo
        st = srx.init_state()
        vs, dcs = [], []
        for b in range(nb):
            v, upd = srx.front(st, controls, stage(b))
            vs.append(v.cpu().numpy())
            dcs.append(upd["rf_dc"].cpu().numpy())
            st = st._replace(**{k: upd[k] for k in
                                ("n0_mod", "rf_dc", "input_filt", "band1",
                                 "band2")})
        fe = dict(fe_v=np.stack(vs), fe_dc=np.stack(dcs))
    np.savez(out, audio=res.audio, meta_vec=res.meta_vec,
             step_ms=np.asarray(res.step_ms),
             collective_ms=np.asarray(res.collective_ms),
             info=json.dumps({
                 "counts": res.counts, "launches": launches,
                 "kernels": kernels, "profiled_steps": steps,
                 "transport": srx.axis.transport,
                 "device": str(axis.device), "rank": dist.get_rank(),
                 "time_index": rank_in_time, "blocks": nb,
                 "station_index": (mesh.station_index
                                   if job["kind"] == "station_time" else 0)}),
             **fe, **{f"bits{i}": b for i, b in enumerate(res.rds_bits)})


def _helper_arg(spec, inputs, axis: TimeAxis):
    from .. import constants as C
    from ..ops.blockops import iir_bank
    from ..ops.squelch import make_squelch_config
    kind = spec[0]
    dev = axis.device
    if kind == "shard":
        a = inputs[spec[1]]
        n = a.shape[0] // axis.size
        return torch.from_numpy(np.ascontiguousarray(
            a[axis.index * n:(axis.index + 1) * n])).to(dev)
    if kind == "array":
        return torch.from_numpy(np.ascontiguousarray(inputs[spec[1]])).to(dev)
    if kind == "value":
        return spec[1]
    sq = make_squelch_config(C.FM_RATE)
    if kind == "squelch":
        return getattr(sq, spec[1])
    if kind == "squelch_bank":
        return iir_bank([sq.hp, sq.lp], dev)
    if kind == "zero_state":
        return getattr(sq, spec[1]).zero_state(dev)
    if kind == "list":
        return [_helper_arg(s, inputs, axis) for s in spec[1]]
    raise ValueError(f"unknown helper argument {spec!r}")


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    for v in x:
        out += _flat(v)
    return out


def _helper_job(axis: TimeAxis, job: dict, out: Path) -> None:
    from . import distributed as DD
    inputs = np.load(job["inputs"])
    args = [_helper_arg(a, inputs, axis) for a in job["args"]]
    axis.reset_counts()
    got = getattr(DD, job["fn"])(*args, axis)
    np.savez(out, counts=json.dumps(axis.counts),
             **{f"out{i}": t.detach().cpu().numpy()
                for i, t in enumerate(_flat(got))})


def run_jobs(axis: TimeAxis, jobs, out_dir: str) -> None:
    """Run `jobs` in order on this rank (every rank runs every job), each
    writing <out_dir>/<name>.rank<r>.npz.  A job is a dict:

      {"name", "kind": "receiver", "cls": "ShardedReceiver" |
       "FullyShardedReceiver", "cfg": ReceiverConfig fields, "capture":
       .npy wire capture, "controls": {field: value}, "profile": bool,
       "front_end": bool (ShardedReceiver: also its front end alone over
       the capture, saving the gathered stream and the DC servo)}
      {"name", "kind": "station_time", "n_stations": S, "cfg", "capture",
       "offsets": [Hz]}   (the world as S station groups x time)
      {"name", "kind": "helper", "fn": a parallel.distributed function,
       "inputs": .npz, "args": [["shard", key] | ["array", key] |
       ["value", v] | ["squelch", "hp"|"lp"] | ["squelch_bank"] |
       ["zero_state", "hp"|"lp"] | ["list", [args]]]}

    Receiver jobs save this rank's audio, meta, RDS bits, step and
    collective ms, the collectives of a step, the wrappers' launches over
    the run, and (with `profile`, on the card) the device kernels by name
    of PROFILED_STEPS more steps, traced on every rank."""
    for job in jobs:
        out = Path(out_dir) / f"{job['name']}.rank{dist.get_rank()}.npz"
        if job["kind"] == "helper":
            _helper_job(axis, job, out)
        else:
            _receiver_job(axis, job, out)
        dist.barrier()


# ---------------------------------------------------------------------------
# the JAX worker's run
# ---------------------------------------------------------------------------


def capture(nblocks: int):
    """(cfg, int16 capture): the deterministic stereo+RDS capture every
    host synthesises alike (a deployment reads its own slice from its own
    front end)."""
    from .. import constants as C
    from ..io import synth
    from ..models.receiver import ReceiverConfig
    from ..rds import encode
    cfg = ReceiverConfig(block_fm=BLOCK_FM, rds="block", iq_format="i16")
    t = np.arange(cfg.block_fm * nblocks) / C.FM_RATE
    bits = encode.make_bitstream(pi=0x4242, station="MULTIHST", repeats=2)
    mpx = synth.synth_mpx(0.5 * np.sin(2 * np.pi * 700 * t),
                          0.5 * np.sin(2 * np.pi * 300 * t),
                          synth.MPXParams(rds_level=0.07),
                          rds_bits=encode.differential_encode(bits))
    iq = synth.fm_modulate(mpx, C.FM_RATE)[: cfg.block_in * nblocks]
    return cfg, synth.iq_to_i16(iq)


def worker_rank(axis: TimeAxis, proc_id: int, ranks_per_proc: int,
                nblocks: int, out_path: str) -> None:
    """One rank of the worker: its host_slice of each block staged on its
    device, the FullyShardedReceiver stepped, the replicated bits and the
    per-block RMS (sums of squares gathered in rank order) recorded; the
    process's first rank writes the JSON."""
    from ..models.receiver import Receiver
    from . import multihost as MH
    from .sharding import FullyShardedReceiver
    cfg, i16 = capture(nblocks)
    srx = FullyShardedReceiver(Receiver(cfg, device=axis.device), axis)
    state, controls = srx.init_state(), srx.rx.initial_controls()
    T = cfg.block_in
    bits, rms = [], []
    for b in range(nblocks):
        lo, hi = MH.host_slice(T)
        state, out = srx.step(state, controls,
                              MH.global_iq_block(i16[b * T + lo:b * T + hi],
                                                 axis))
        nb = int(out.rds.count)
        bits.extend(int(v) for v in out.rds.bits[:nb].cpu().tolist())
        a = out.audio.cpu().numpy().astype(np.float64)
        sq = axis.all_gather(torch.tensor([np.sum(a * a), a.size],
                                          dtype=torch.float64,
                                          device=axis.device)).cpu().numpy()
        rms.append(float(np.sqrt(sq[:, 0].sum() / sq[:, 1].sum())))
    if dist.get_rank() % ranks_per_proc == 0:
        Path(out_path).write_text(json.dumps({
            "process": proc_id, "bits": bits, "rms": rms,
            "devices": axis.size, "transport": axis.transport,
            "device": str(axis.device)}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sdrjfm_tpu_torch.parallel."
                                      "multihost_worker",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("rendezvous", help="port, store file, or 'env'")
    ap.add_argument("proc_id", help="this process's index ('-' with env)")
    ap.add_argument("num_procs", help="processes ('-' with env)")
    ap.add_argument("ranks_per_proc", type=int)
    ap.add_argument("out_json")
    ap.add_argument("nblocks", type=int, nargs="?", default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    if a.rendezvous == "env":
        pid, nproc = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if a.ranks_per_proc != 1:
            ap.error("under torchrun each process is one rank")
    else:
        pid, nproc = int(a.proc_id), int(a.num_procs)
    rpp = a.ranks_per_proc
    args = (pid * rpp, nproc * rpp, a.rendezvous, a.device, worker_rank,
            (pid, rpp, a.nblocks, a.out_json.replace("{proc}", str(pid))))
    if rpp == 1:
        _rank_entry(0, *args)
    else:
        torch.multiprocessing.start_processes(
            _rank_entry, args=args, nprocs=rpp, join=True,
            start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
