"""Carrying receiver state and design constants across to this package.

The JAX package keeps its stream state as a NamedTuple tree of arrays;
`state_from_numpy` takes such a tree with numpy leaves (for example
`jax.tree.map(np.asarray, state)` on the JAX side) and builds this package's
`ReceiverState` on a device, matching fields by name; `state_to_numpy` goes
back to numpy leaves.  `constants_from_numpy` loads frozen design arrays
(the JAX Receiver's, say) into a port Receiver, so both packages can be made
to compute from the very same taps; `constants_to_numpy` reads them out.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.receiver import ReceiverState
from .ops.demod import DemodState
from .ops.pilot import PilotState
from .ops.pss import PSSState
from .rds.bitrecovery import BitRecoveryState

# nested state fields and the port's class for each
_NESTED = {"demod": DemodState, "pilot": PilotState, "pss": PSSState,
           "bitrec": BitRecoveryState}

# design constants a Receiver computes from, by attribute path
CONSTANT_NAMES = ("k_decim12", "H_demod_pair", "H_audio", "pss_cfg.kernel",
                  "pss_cfg.ema_weights", "bitrec_cfg.mf_taps", "k_rds_decim",
                  "k_audio_decim")


def _leaf_to_tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v, copy=True)).to(device)


def _tuple_from_numpy(cls, tree, device):
    vals = {}
    for name in cls._fields:
        v = getattr(tree, name)
        vals[name] = None if v is None else _leaf_to_tensor(v, device)
    return cls(**vals)


def state_from_numpy(tree, device) -> ReceiverState:
    """A ReceiverState on `device` from a NamedTuple tree with numpy leaves
    and the same field names (None leaves stay None)."""
    vals = {}
    for name in ReceiverState._fields:
        v = getattr(tree, name, None)
        if v is None:
            vals[name] = None
        elif name in _NESTED:
            vals[name] = _tuple_from_numpy(_NESTED[name], v, device)
        elif name == "squelch":
            raise NotImplementedError("squelch state: squelch is not ported")
        else:
            vals[name] = _leaf_to_tensor(v, device)
    return ReceiverState(**vals)


def _to_numpy(v):
    if v is None:
        return None
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_to_numpy(x) for x in v))
    return v.detach().cpu().numpy()


def state_to_numpy(state: ReceiverState) -> ReceiverState:
    """The same tree with every tensor leaf as a numpy array."""
    return _to_numpy(state)


def _get(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def constants_to_numpy(rx) -> Dict[str, np.ndarray]:
    """The design arrays of a port Receiver, by CONSTANT_NAMES path."""
    out = {}
    for name in CONSTANT_NAMES:
        v = _get(rx, name)
        if v is not None:
            out[name] = v.detach().cpu().numpy()
    return out


def constants_from_numpy(rx, arrays: Dict[str, np.ndarray]) -> None:
    """Load design arrays (keys from CONSTANT_NAMES) into port Receiver
    `rx`, in place, on its device.  Shapes and dtypes must match."""
    for name, value in arrays.items():
        if name not in CONSTANT_NAMES:
            raise KeyError(f"unknown design constant {name!r}")
        old = _get(rx, name)
        new = _leaf_to_tensor(value, rx.device)
        if old is None or new.shape != old.shape or new.dtype != old.dtype:
            raise ValueError(f"{name}: cannot load {tuple(new.shape)} "
                             f"{new.dtype} into this receiver")
        if "." in name:
            cfg_name, field = name.split(".")
            cfg = getattr(rx, cfg_name)
            setattr(rx, cfg_name, cfg._replace(**{field: new}))
        else:
            setattr(rx, name, new)
