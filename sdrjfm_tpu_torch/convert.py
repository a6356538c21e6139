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
from .ops.squelch import SquelchState
from .rds import scan_decoders as SD
from .rds.bitrecovery import BitRecoveryState

# nested state fields and the port's class for each; `bitrec` holds the
# block decoder's state or one of the scan decoders', told apart by fields
_NESTED = {"demod": DemodState, "pilot": PilotState, "pss": PSSState,
           "squelch": SquelchState, "costas": SD.CostasState}
_BITREC = (BitRecoveryState, SD.Decoder1State, SD.Decoder2State,
           SD.Decoder3State)

# design constants a Receiver computes from, by attribute path
CONSTANT_NAMES = ("k_decim12", "H_demod_pair", "H_audio", "pss_cfg.kernel",
                  "pss_cfg.ema_weights", "bitrec_cfg.mf_taps", "k_rds_decim",
                  "k_audio_decim", "H_input", "k_band1", "k_band2",
                  "k_audio_up", "squelch_cfg.hp.num", "squelch_cfg.hp.poles",
                  "squelch_cfg.hp.residues", "squelch_cfg.lp.num",
                  "squelch_cfg.lp.poles", "squelch_cfg.lp.residues",
                  "scan_cfg.lp21", "scan_cfg.match", "scan_cfg.sharp.num",
                  "scan_cfg.sharp.poles", "scan_cfg.sharp.residues",
                  "scan_cfg.rrc")


def _leaf_to_tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v, copy=True)).to(device)


def _bitrec_class(tree):
    fields = set(tree._fields)
    for cls in _BITREC:
        if set(cls._fields) == fields:
            return cls
    raise ValueError(f"unknown bit-decoder state with fields {sorted(fields)}")


def _convert(cls, tree, device):
    vals = {}
    for name in cls._fields:
        v = getattr(tree, name, None)
        if v is None:
            vals[name] = None
        elif name in _NESTED:
            vals[name] = _convert(_NESTED[name], v, device)
        elif name == "bitrec":
            vals[name] = _convert(_bitrec_class(v), v, device)
        elif isinstance(v, tuple) and not hasattr(v, "_fields"):
            # the squelch's (pole states, numerator history) pairs
            vals[name] = tuple(_leaf_to_tensor(x, device) for x in v)
        else:
            vals[name] = _leaf_to_tensor(v, device)
    return cls(**vals)


def state_from_numpy(tree, device) -> ReceiverState:
    """A ReceiverState on `device` from a NamedTuple tree with numpy leaves
    and the same field names (None leaves stay None), squelch and scan
    decoder states included."""
    return _convert(ReceiverState, tree, device)


def _to_numpy(v):
    if v is None:
        return None
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_to_numpy(x) for x in v))
    if isinstance(v, tuple):
        return tuple(_to_numpy(x) for x in v)
    return v.detach().cpu().numpy()


def state_to_numpy(state: ReceiverState) -> ReceiverState:
    """The same tree with every tensor leaf as a numpy array."""
    return _to_numpy(state)


def _get(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def constants_to_numpy(rx) -> Dict[str, np.ndarray]:
    """The design arrays of a port Receiver, by CONSTANT_NAMES path (the
    paths that this receiver's options give it)."""
    out = {}
    for name in CONSTANT_NAMES:
        v = _get(rx, name)
        if v is not None:
            out[name] = (v.detach().cpu().numpy()
                         if isinstance(v, torch.Tensor) else np.asarray(v))
    return out


def _set(rx, path: str, value) -> None:
    """Set the attribute at `path`, rebuilding NamedTuple configs on the
    way up (objects such as IIRSpec are updated in place)."""
    parts = path.split(".")
    objs = [rx]
    for part in parts[:-1]:
        objs.append(getattr(objs[-1], part))
    for obj, key in zip(reversed(objs), reversed(parts)):
        if hasattr(obj, "_replace"):
            value = obj._replace(**{key: value})
        else:
            setattr(obj, key, value)
            return


def _np_dtype(v):
    if isinstance(v, torch.Tensor):
        return torch.empty((), dtype=v.dtype).numpy().dtype
    return np.asarray(v).dtype


def constants_from_numpy(rx, arrays: Dict[str, np.ndarray]) -> None:
    """Load design arrays (keys from CONSTANT_NAMES) into port Receiver
    `rx`, in place, on its device.  Shapes and dtypes must match."""
    for name, value in arrays.items():
        if name not in CONSTANT_NAMES:
            raise KeyError(f"unknown design constant {name!r}")
        old = _get(rx, name)
        value = np.asarray(value)
        if old is None or value.shape != tuple(old.shape) \
                or value.dtype != _np_dtype(old):
            raise ValueError(f"{name}: cannot load {value.shape} "
                             f"{value.dtype} into this receiver")
        _set(rx, name, _leaf_to_tensor(value, rx.device)
             if isinstance(old, torch.Tensor) else np.array(value, copy=True))
    # device copies made from the host-side arrays are stale now
    rx.build_device_constants()
