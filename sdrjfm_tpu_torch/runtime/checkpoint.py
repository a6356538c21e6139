"""Receiver-state checkpoint/resume (port of sdrjfm_tpu.runtime.checkpoint).

The reference persists only GUI settings between runs (QSettings ini,
radio.cpp:466-531); DSP state is never checkpointed (SURVEY.md §5.4).  In
the block design the state tree *is* the complete DSP state, so a checkpoint
is exact: save the state and the stream position, restore, and the
continued stream is the uninterrupted run's.

Format: the JAX package's, byte for byte in layout — an npz of the state's
leaves in flatten order (`leaf_0` ...; `runtime.graph.tree_leaves` walks the
port's tree in JAX's flatten order, leaf for leaf in shape and dtype) and a
`__meta__` uint8 JSON header with the format version, the leaf count, the
caller's `extra` and the config fingerprint.  A checkpoint written by either
package loads into the other.  Loading verifies the version, the
fingerprint, the leaf count and every shape, and casts each leaf to the
template's dtype.

The orbax backend of the JAX module has no torch counterpart: asking for it
raises, and so does loading an orbax directory (ROADMAP.md, queue 3).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Tuple

import numpy as np
import torch

from .graph import tree_leaves, tree_rebuild

# v2: PilotState.filt carries plain demod samples (the JAX module's note:
# v<=1 checkpoints resume with a one-filter-length pilot transient)
FORMAT_VERSION = 2

ORBAX_REFUSAL = ("the orbax checkpoint backend has no torch counterpart "
                 "(ROADMAP.md, queue 3: standing decisions); use npz")

_ENTRY = re.compile(r"ckpt_(\d{12})(?:\.npz)?")


class CheckpointError(RuntimeError):
    pass


def config_fingerprint(cfg) -> str:
    """Stable hash of a ReceiverConfig: the JAX package's value for an
    equal config.  iq_format is left out (it changes the wire, not the DSP
    state), so a resume may switch formats."""
    from dataclasses import asdict
    d = asdict(cfg)
    d.pop("iq_format", None)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def host_leaves(state) -> List[np.ndarray]:
    """Host copies of the state's leaves, in flatten order.  On the card
    the leaves are packed into one byte buffer on the device and fetched in
    one transfer (one copy per checkpoint, whatever the leaf count); the
    call returns when the copy is on the host, so the state may change on
    the device afterwards.  A list of numpy arrays passes through."""
    if isinstance(state, list) and all(isinstance(v, np.ndarray)
                                       for v in state):
        return state
    leaves = [t.detach() for t in tree_leaves(state)]
    if not leaves or leaves[0].device.type != "cuda":
        return [t.cpu().numpy().copy() for t in leaves]
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in leaves])
    host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    torch.cuda.current_stream(flat.device).synchronize()
    buf = host.numpy()
    out, o = [], 0
    for t in leaves:
        dt = _np_dtype(t.dtype)
        n = t.numel() * dt.itemsize
        out.append(buf[o:o + n].view(dt).reshape(tuple(t.shape)).copy())
        o += n
    return out


def save_state(path: str, state: Any, extra: dict | None = None,
               cfg=None) -> None:
    """Save a state tree (or its host_leaves) and JSON-able metadata to an
    npz.  cfg: optional ReceiverConfig whose fingerprint is stored and
    verified at load time."""
    flat = host_leaves(state)
    arrays = {f"leaf_{i}": v for i, v in enumerate(flat)}
    header = {"format_version": FORMAT_VERSION, "n_leaves": len(flat),
              "extra": extra or {}}
    if cfg is not None:
        header["config_fingerprint"] = config_fingerprint(cfg)
    arrays["__meta__"] = np.frombuffer(json.dumps(header).encode(),
                                       dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, template: Any, cfg=None) -> Tuple[Any, dict]:
    """Restore a state tree with `template` (e.g. rx.init_state()) for its
    structure, dtypes and device; returns (state, extra).

    cfg: optional ReceiverConfig to verify against the stored fingerprint.
    A CheckpointManager directory resolves to its latest step."""
    if os.path.isdir(path):
        entries = sorted(n for n in os.listdir(path) if _ENTRY.fullmatch(n))
        if entries:
            path = os.path.join(path, entries[-1])
        if os.path.isdir(path):
            raise CheckpointError(f"checkpoint {path} is a directory (an "
                                  f"orbax checkpoint?): {ORBAX_REFUSAL}")
    data = np.load(path)
    raw = json.loads(bytes(data["__meta__"].tobytes()).decode() or "{}")
    # v0 checkpoints stored the extra dict directly (no header)
    if "format_version" in raw:
        header, extra = raw, raw.get("extra", {})
    else:
        header, extra = {"format_version": 0}, raw
    if header["format_version"] > FORMAT_VERSION:
        raise CheckpointError(
            f"checkpoint {path} has format v{header['format_version']}, "
            f"this build reads up to v{FORMAT_VERSION}")
    if cfg is not None and header.get("config_fingerprint"):
        want = config_fingerprint(cfg)
        if header["config_fingerprint"] != want:
            raise CheckpointError(
                f"checkpoint {path} was written by a different receiver "
                f"configuration (fingerprint {header['config_fingerprint']} "
                f"!= {want}); rebuild with the matching ReceiverConfig")
    flat = tree_leaves(template)
    if header.get("n_leaves") not in (None, len(flat)):
        raise CheckpointError(
            f"checkpoint {path} has {header['n_leaves']} state leaves, "
            f"this configuration expects {len(flat)}")
    leaves = []
    for i, t in enumerate(flat):
        v = data[f"leaf_{i}"]
        if v.shape != tuple(t.shape):
            raise CheckpointError(
                f"state leaf {i}: shape {v.shape} != expected "
                f"{tuple(t.shape)} (checkpoint from a different "
                "configuration?)")
        # astype copies into a C-ordered array of the leaf's own shape
        leaves.append(torch.from_numpy(v.astype(_np_dtype(t.dtype)))
                      .to(t.device))
    return tree_rebuild(template, leaves), extra


class CheckpointManager:
    """Periodic checkpoint writer with retention (the JAX module's npz
    backend).

      max_to_keep  : keep the newest N checkpoints...
      keep_period  : ...plus every checkpoint whose step is a multiple of
                     this (never deleted).

    `save` takes the host copy (`host_leaves`: one device-to-host transfer)
    before it returns and hands the npz write to one worker thread, which
    sees numpy arrays only; `wait_until_finished()` barriers the write.
    Layout: `<dir>/ckpt_<step:012d>.npz`.
    """

    def __init__(self, directory: str, cfg=None, backend: str = "npz",
                 max_to_keep: int = 3, keep_period: int | None = None,
                 async_write: bool = True):
        if backend == "orbax":
            raise CheckpointError(ORBAX_REFUSAL)
        assert backend == "npz", backend
        assert max_to_keep >= 1
        self.directory = os.path.abspath(directory)
        self.cfg = cfg
        self.backend = backend
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        self._pool = ThreadPoolExecutor(max_workers=1) if async_write \
            else None
        self._pending = None
        os.makedirs(self.directory, exist_ok=True)

    # -- step <-> path ----------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:012d}.npz")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _ENTRY.fullmatch(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(set(steps))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- write ------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict | None = None) -> str:
        """Snapshot `state` as checkpoint `step`; returns its path.  The
        host copy is taken before returning; the file write may still be
        in flight."""
        self.wait_until_finished()   # one write in flight
        path = self._path(step)
        host = host_leaves(state)
        meta = dict(extra or {})
        meta["step"] = step
        if self._pool is not None:
            self._pending = self._pool.submit(save_state, path, host, meta,
                                              self.cfg)
        else:
            save_state(path, host, meta, self.cfg)
        self._retain(in_flight=step)
        return path

    def wait_until_finished(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _retain(self, in_flight: int | None = None) -> None:
        """Newest max_to_keep survive, plus any step that is a multiple of
        keep_period.  in_flight: a step whose write may not be on disk yet,
        counted as existing (and never deleted, being the newest)."""
        steps = set(self.all_steps())
        if in_flight is not None:
            steps.add(in_flight)
        for s in sorted(steps)[:-self.max_to_keep]:
            if self.keep_period and s and s % self.keep_period == 0:
                continue
            p = self._path(s)
            if os.path.exists(p):
                os.remove(p)

    # -- read -------------------------------------------------------------
    def restore(self, template: Any, step: int | None = None
                ) -> Tuple[Any, dict]:
        """Load checkpoint `step` (default: latest); (state, extra)."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise CheckpointError(
                    f"no checkpoints under {self.directory}")
        return load_state(self._path(step), template, cfg=self.cfg)

    def close(self) -> None:
        self.wait_until_finished()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
