"""Shared helpers of the port's option tests (tests/test_torch_*.py): run the
JAX receiver into a capture, hand its state across to the port with
convert.state_from_numpy, and step both packages over the same blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.io import synth as jsynth
from sdrjfm_tpu.models.receiver import Receiver as JReceiver
from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig
from sdrjfm_tpu.rds import encode as jencode
from sdrjfm_tpu_torch import convert
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig


def station_iq(seconds: float, seed: int = 0, noise: float = 0.01,
               carrier_offset: float = 50_000.0) -> np.ndarray:
    """Complex64 2.304 MS/s capture of a stereo+RDS station (1 kHz left,
    440 Hz right, PI 0x10F0, "TPU FM")."""
    n = int(seconds * JC.FM_RATE)
    t = np.arange(n) / JC.FM_RATE
    syms = jencode.differential_encode(jencode.make_bitstream(
        pi=0x10F0, pty=10, station="TPU FM", radiotext="PARITY\r",
        repeats=2))
    mpx = jsynth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000 * t),
                           0.6 * np.sin(2 * np.pi * 440 * t),
                           jsynth.MPXParams(rds_level=0.07), rds_bits=syms)
    rng = np.random.default_rng(seed)
    iq = jsynth.fm_modulate(mpx, JC.FM_RATE,
                            carrier_offset_hz=carrier_offset, noise_std=0.0)
    iq = iq + noise * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))
    return iq.astype(np.complex64)


def stations_iq(stations, seconds: float, noise: float = 0.01,
                seed: int = 0) -> np.ndarray:
    """Complex64 2.304 MS/s capture of several stereo+RDS stations, each
    (offset_hz, pi, 8-char name, tone) with its PI and name in group 0A and
    its tone on the left, 1.5 x the tone on the right."""
    n = int(seconds * JC.FM_RATE)
    t = np.arange(n) / JC.FM_RATE
    total = None
    for off, pi, name, tone in stations:
        bits = []
        for _ in range(int(seconds * 3) + 2):
            for seg in range(4):
                bits.extend(jencode.group_0a(pi, 10, seg,
                                             name[2 * seg:2 * seg + 2]))
        syms = jencode.differential_encode(np.asarray(bits, np.int8))
        mpx = jsynth.synth_mpx(0.6 * np.sin(2 * np.pi * tone * t),
                               0.6 * np.sin(2 * np.pi * tone * 1.5 * t),
                               jsynth.MPXParams(rds_level=0.08),
                               rds_bits=syms)
        iq = jsynth.fm_modulate(mpx, JC.FM_RATE, carrier_offset_hz=off)
        total = iq if total is None else total + iq
    rng = np.random.default_rng(seed)
    total = total + noise * (rng.standard_normal(len(total))
                             + 1j * rng.standard_normal(len(total)))
    return total.astype(np.complex64)


def wire_blocks(iq: np.ndarray, cfg, fmt: str):
    """The capture in wire format, cut into cfg.wire_len blocks."""
    if fmt == "i16":
        w = jsynth.iq_to_i16(iq)
    elif fmt == "u8":
        w = jsynth.iq_to_u8(iq)
    elif fmt == "i8":
        w = jsynth.iq_to_i8(iq)
    else:
        w = iq
    T = cfg.wire_len
    return [np.ascontiguousarray(w[b * T:(b + 1) * T])
            for b in range(len(w) // T)]


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


class Pair:
    """The JAX receiver and the port's on the CPU, one config and the
    same controls."""

    def __init__(self, lo_hz: int = -50_000, controls=None, **kw):
        self.jrx = JReceiver(JConfig(**kw))
        self.trx = Receiver(ReceiverConfig(**kw), device="cpu")
        jc = self.jrx.initial_controls()._replace(
            lo_freq_hz=jnp.asarray(lo_hz, jnp.int32))
        tc = self.trx.initial_controls()._replace(
            lo_freq_hz=torch.tensor(lo_hz, dtype=torch.int32))
        for name, v in (controls or {}).items():
            jc = jc._replace(**{name: jnp.asarray(v, jnp.float32)})
            tc = tc._replace(**{name: torch.tensor(v, dtype=torch.float32)})
        self.jctl, self.tctl = jc, tc
        self.jstep = jax.jit(self.jrx.step)

    def warm(self, blocks):
        """JAX over `blocks`, then hand the state to the port."""
        js = self.jrx.init_state()
        for blk in blocks:
            js, _ = self.jstep(js, self.jctl, jnp.asarray(blk))
        ts = convert.state_from_numpy(tree_np(js), "cpu")
        return js, ts

    def step(self, js, ts, blk):
        js, oj = self.jstep(js, self.jctl, jnp.asarray(blk))
        ts, ot = self.trx.step(ts, self.tctl, torch.from_numpy(blk.copy()))
        return js, ts, oj, ot


def rds_bits(out) -> np.ndarray:
    n = int(out.rds.count)
    return np.asarray(out.rds.bits)[:n]
