"""The station axis as a batch: every op of the port's fm chain over
leading station rows ([S, T] blocks, [S]-leading states and controls), the
n-station step as one batched `fm_chain`, and StationTime as one batched
FullySharded step — against the same ops row by row, against JAX's
`jax.vmap` of the same functions, and against JAX's vmapped
`Receiver.step`, on the CPU.

- Each batched op of blockops, the scan kernel's plain versions, the
  discriminators, the squelches, the pilot, PSS and RDS bit recovery, at
  S = 3 with distinct carries and controls: within ROW_ATOL of the op row
  by row (integers and flags equal) and within the op's port-test
  tolerance of `jax.vmap` of the JAX op on the same numpy inputs.
- `MultiStationReceiver.step` over 3 stations (block_fm 16384, the JAX
  state handed over after ~1 s as tests/test_torch_multistation.py does):
  audio within AUDIO_ATOL and meta within META_ATOL of JAX's vmapped
  step (the peak meters, the audio's maxima, within AUDIO_ATOL in
  amplitude), RDS bits equal, for every decoder, nsq and lsq with a level per
  station, mono, the taps, the input filter, the reference cascade, 192 kHz
  audio and the test tone; each station within ROW_ATOL of its own
  single-station `Receiver.step` (bits equal).
- One `MultiStationReceiver.step` dispatches as many aten ops at S = 1 as
  at S = 5 (a TorchDispatchMode count): one station's op count.
- StationTimeShardedReceiver on 2 x 2 gloo ranks with 1 and 3 stations a
  group: the same collectives a step (5 gathers, 8 halos), each station
  within 5e-4 of MultiStationReceiver (tests/test_torch_sharding.py's
  tolerance), RDS bits equal.
"""

import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.io import synth as jsynth
from sdrjfm_tpu.models.multistation import \
    MultiStationReceiver as JMultiStation
from sdrjfm_tpu.models.receiver import Receiver as JReceiver
from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig
from sdrjfm_tpu.ops import blockops as JB
from sdrjfm_tpu.ops import demod as JD
from sdrjfm_tpu.ops import design
from sdrjfm_tpu.ops import pilot as JP
from sdrjfm_tpu.ops import pss as JPS
from sdrjfm_tpu.ops import squelch as JS
from sdrjfm_tpu.rds import bitrecovery as JR
from sdrjfm_tpu_torch import convert
from sdrjfm_tpu_torch.models.multistation import MultiStationReceiver
from sdrjfm_tpu_torch.models.receiver import Meta, Receiver, ReceiverConfig
from sdrjfm_tpu_torch.ops import blockops as TB
from sdrjfm_tpu_torch.ops import demod as TD
from sdrjfm_tpu_torch.ops import pilot as TP
from sdrjfm_tpu_torch.ops import pss as TPS
from sdrjfm_tpu_torch.ops import squelch as TS
from sdrjfm_tpu_torch.rds import bitrecovery as TR
from sdrjfm_tpu_torch.runtime.graph import (tree_index, tree_leaves,
                                            tree_stack)

import torch_parity as P

torch.set_num_threads(2)

S = 3
ROW_ATOL = 1e-6               # a batched op's row against the op on the row
                              # (of the row's scale where it exceeds 1)
IIR_ROW_ATOL = 1e-4           # the biquad cascades' f32 accuracy, of their
                              # scale (tests/test_torch_squelch.py): the
                              # pole bank's plain version is a complex
                              # batched matmul, which MKL rounds otherwise
                              # for another batch
AUDIO_ATOL = 2e-4             # tests/test_torch_multistation.py's
META_ATOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _c64(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _f32(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# The ops: each case builds numpy inputs with a leading [S] axis, and
# returns (port call, JAX call, tolerance against JAX).  A call takes the
# per-row (or stacked) inputs and returns a flat tuple of outputs.
# ---------------------------------------------------------------------------

FS = JC.FM_RATE


def _case_fir_apply(rng):
    k = design.lowpass_sinc(45, 3000.0, 24000.0).astype(np.float32)
    ins = (_c64(rng, (S, 4096)), _c64(rng, (S, 44)))
    return ins, (lambda x, c: TB.fir_apply(x, _t(k), c),
                 lambda x, c: JB.fir_apply(x, jnp.asarray(k), c), 1e-5)


def _case_fir_decimate(rng):
    k = design.lowpass_sinc(307, 110000.0, 2304000.0).astype(np.float32)
    ins = (_c64(rng, (S, 12 * 256)), _c64(rng, (S, 306)))
    return ins, (lambda x, c: TB.fir_decimate(x, _t(k), 12, c),
                 lambda x, c: JB.fir_decimate(x, jnp.asarray(k), 12, c), 1e-5)


def _case_fir_interpolate(rng):
    k = design.polyphase_resampler_kernel(4).astype(np.float32)
    ph = (len(k) + 3) // 4
    ins = (_c64(rng, (S, 1024)), _c64(rng, (S, ph - 1)))
    return ins, (lambda x, c: TB.fir_interpolate(x, _t(k), 4, c),
                 lambda x, c: JB.fir_interpolate(x, jnp.asarray(k), 4, c),
                 1e-5)


def _response(taps, n):
    k = design.lowpass_sinc(taps, 15000.0, FS)
    return design.fft_filter_response(k, n).astype(np.complex64)


def _case_fft_filter(rng):
    H = _response(769, 8192)
    ins = (_c64(rng, (S, 8192)), _c64(rng, (S, 4096)))
    return ins, (lambda x, c: TB.fft_filter_apply(x, _t(H), 4096, c),
                 lambda x, c: JB.fft_filter_apply(x, jnp.asarray(H), 4096, c),
                 1e-5)


def _case_fft_filter_multi(rng):
    Hs = np.stack([_response(769, 8192), _response(1537, 8192)])
    carry = _f32(rng, (S, 4096)).astype(np.complex64)
    ins = (_f32(rng, (S, 16384)), carry)

    def port(x, c):
        ys, tail = TB.fft_filter_apply_multi(x, _t(Hs), 4096, c)
        return ys.movedim(0, -2), tail         # [..., M, T] like JAX's vmap

    return ins, (port, lambda x, c: JB.fft_filter_apply_multi(
        x, jnp.asarray(Hs), 4096, c), 1e-5)


def _case_delay(rng):
    ins = (_f32(rng, (S, 1000)), _f32(rng, (S, 384)))
    return ins, (TB.delay_apply, JB.delay_apply, 0.0)


def _case_linrec(rng):
    ins = (_f32(rng, (S, 4096), 1e-2), _f32(rng, (S,)))
    return ins, (lambda d, y0: TB.linrec_apply(d, 0.999, y0),
                 lambda d, y0: JB.linrec_apply(d, 0.999, y0), 5e-5)


def _case_ema_complex(rng):
    ins = (_c64(rng, (S, 4096)), _c64(rng, (S,)))
    return ins, (lambda x, y0: TB.ema_apply_complex(x, 0.05, y0),
                 lambda x, y0: JB.ema_apply(x, 0.05, y0), 1e-5)


def _case_ema_rows(rng):
    ins = (_f32(rng, (S, 4096)), _f32(rng, (S, 4096)), _f32(rng, (S,)),
           _f32(rng, (S,)))

    def port(a, b, ya, yb):
        (y1, l1), (y2, l2) = TB.ema_apply_rows([a, b], [0.01, 0.2], [ya, yb])
        return y1, l1, y2, l2

    def jx(a, b, ya, yb):
        return JB.ema_apply(a, 0.01, ya) + JB.ema_apply(b, 0.2, yb)

    return ins, (port, jx, 1e-5)


def _case_runlength(rng):
    flags = rng.random((S, 4096)) < 0.995
    flags[1, :] = True                          # a row with no false
    ins = (flags, np.asarray([0, 7, 123456], np.int32))
    return ins, (TB.runlength_true, JB.runlength_true, 0.0)


def _case_iir_many(rng):
    jq, tq = JS.make_squelch_config(), TS.make_squelch_config()
    bank = TB.iir_bank([tq.hp, tq.lp], "cpu")
    nz = len(tq.hp.num) - 1
    ins = (_f32(rng, (S, 4096)), _c64(rng, (S, len(tq.hp.poles)), 0.05),
           _f32(rng, (S, nz), 0.3), _c64(rng, (S, len(tq.lp.poles)), 0.05),
           _f32(rng, (S, len(tq.lp.num) - 1), 0.3))

    def port(x, hw, hn, lw, ln):
        (y1, (w1, n1)), (y2, (w2, n2)) = TB.iir_apply_many(
            [x, x], bank, [(hw, hn), (lw, ln)])
        return y1, w1, n1, y2, w2, n2

    def jx(x, hw, hn, lw, ln):
        y1, (w1, n1) = JB.iir_apply(x, jq.hp, (hw, hn))
        y2, (w2, n2) = JB.iir_apply(x, jq.lp, (lw, ln))
        return y1, w1, n1, y2, w2, n2

    # the cascades' terms cancel: 1e-4 of the output scale
    # (tests/test_torch_squelch.py), ~2e-3 absolute here, between a row
    # and the batch as between the packages
    return ins, (port, jx, 2e-3, IIR_ROW_ATOL)


def _case_mix_lo(rng):
    ins = (_c64(rng, (S, 4096)),
           np.asarray([-900_000, 0, 417_123], np.int32),
           np.asarray([0, 1_000_001, 2_303_999], np.int32))
    return ins, (lambda x, f, n0: TB.mix_lo(x, f, JC.INPUT_RATE, n0),
                 lambda x, f, n0: JB.mix_lo(x, f, JC.INPUT_RATE, n0), 1e-5)


def _case_rate_map(rng):
    ins = (_c64(rng, (S, 2500)), _c64(rng, (S,)))
    return ins, (lambda x, c: TB.rate_map_linear(x, 25, 24, 2400, c),
                 lambda x, c: JB.rate_map_linear(x, 25, 24, 2400, c), 1e-6)


def _fm_iq(rng, n):
    t = np.arange(n) / FS
    out = []
    for s in range(S):
        ph = 2 * np.pi * 75e3 / FS * np.cumsum(
            0.5 * np.sin(2 * np.pi * (700 + 300 * s) * t)
            + 0.1 * np.sin(2 * np.pi * 19e3 * t))
        z = (0.8 + 0.1 * s) * np.exp(1j * (ph + s)) \
            + 0.02 * _c64(rng, n)
        z[100 + s:104 + s] = 1e-4          # below the small-signal clamp
        out.append(z)
    return np.asarray(out, np.complex64)


def _demod_state(rng):
    p1, p2 = _c64(rng, (S,)), _c64(rng, (S,))
    p1, p2 = p1 / np.abs(p1), p2 / np.abs(p2)
    return (p1.astype(np.complex64), p2.astype(np.complex64),
            _f32(rng, (S,), 0.01), np.abs(_f32(rng, (S,))) + 0.5,
            np.zeros(S, np.float32), _f32(rng, (S,), 0.1))


def _case_demod(decoder):
    def make(rng):
        ins = (_fm_iq(rng, 4096),) + _demod_state(rng)

        def port(z, *st):
            y, new, carr = TD.demodulate_block(z, TD.DemodState(*st),
                                               decoder, FS)
            return (y, carr) + tuple(new)

        def jx(z, *st):
            y, new, carr = JD.demodulate_block(z, JD.DemodState(*st),
                                               decoder, FS)
            return (y, carr) + tuple(new)

        # tests/test_torch_demod.py's: 2e-5, real_baseband 1e-3
        return ins, (port, jx, 1e-3 if decoder == "real_baseband" else 2e-5)
    return make


def _squelch_input(rng, n):
    """Per station: a station, noise or both halves, and the carrier."""
    x, car = [], []
    t = np.arange(n) / FS
    for s in range(S):
        station = 0.5 * np.sin(2 * np.pi * 1000 * t) + 0.01 * _f32(rng, n)
        noise = np.diff(rng.standard_normal(n + 1)) * 1.5
        pick = [station, noise, np.where(t < t[n // 2], station, noise)][s]
        x.append(pick)
        car.append(np.where(pick is noise, 0.01, 1.0) * np.ones(n))
    return np.asarray(x, np.float32), np.asarray(car, np.float32)


def _squelch_state_np(rng, tq):
    return (_c64(rng, (S, len(tq.hp.poles)), 0.05),
            _f32(rng, (S, len(tq.hp.num) - 1), 0.1),
            _c64(rng, (S, len(tq.lp.poles)), 0.05),
            _f32(rng, (S, len(tq.lp.num) - 1), 0.1),
            np.abs(_f32(rng, (S,), 0.05)), np.abs(_f32(rng, (S,), 0.05)),
            np.asarray([False, True, False]), np.zeros(S, np.int32))


def _case_squelch(kind):
    def make(rng):
        jq, tq = JS.make_squelch_config(), TS.make_squelch_config()
        x, car = _squelch_input(rng, 2 * jq.hold_period)
        level = np.asarray([0.0, 50.0, 99.95] if kind == "nsq"
                           else [10.0, 60.0, 80.0], np.float32)
        ins = (x, car, level) + _squelch_state_np(rng, tq)
        bank = TS.squelch_bank(tq, "cpu")

        def state(pkg, a):
            return pkg.SquelchState((a[0], a[1]), (a[2], a[3]), *a[4:])

        def port(x, c, lv, *st):
            if kind == "nsq":
                y, new = TS.noise_squelch(x, lv, tq, state(TS, st), bank)
            else:
                y, new = TS.level_squelch(x, c, lv, tq, state(TS, st))
            return (y,) + tuple(tree_leaves(new))

        def jx(x, c, lv, *st):
            if kind == "nsq":
                y, new = JS.noise_squelch(x, lv, jq, state(JS, st))
            else:
                y, new = JS.level_squelch(x, c, lv, jq, state(JS, st))
            return (y,) + tuple(jax.tree.leaves(new))

        return ins, (port, jx, 2e-3, IIR_ROW_ATOL)
    return make


def _mpx(rng, n, level=1.0):
    t = np.arange(n) / FS
    out = []
    for s in range(S):
        syms = rng.integers(0, 2, 400).astype(np.int8)
        mpx = jsynth.synth_mpx(0.6 * np.sin(2 * np.pi * (900 + 200 * s) * t),
                               0.6 * np.sin(2 * np.pi * 440 * t),
                               jsynth.MPXParams(rds_level=0.07),
                               rds_bits=syms)
        out.append(level * mpx + 0.01 * rng.standard_normal(n))
    return np.asarray(out, np.float32)


def _case_pilot(rng):
    jcfg = JP.make_pilot_config(FS, 8192, hop=4096)
    tcfg = TP.make_pilot_config(FS, 8192, hop=4096)
    ins = (_mpx(rng, 16384, 3.0), _f32(rng, (S, 4096), 0.1).astype(
        np.complex64), np.asarray([0.0, 0.3, 0.05], np.float32),
        np.asarray([0, 95000, 500], np.int32))

    def port(d, f, m, r):
        blk, new = TP.recover_pilot(d, tcfg, TP.PilotState(f, m, r))
        return (torch.cos(blk.phase), torch.sin(blk.phase), blk.locked,
                blk.strength) + tuple(new)

    def jx(d, f, m, r):
        blk, new = JP.recover_pilot(d, jcfg, JP.PilotState(f, m, r))
        return (jnp.cos(blk.phase), jnp.sin(blk.phase), blk.locked,
                blk.strength) + tuple(new)

    # tests/test_torch_chain.py's: the phase within 2e-4 rad, 1e-5 strength
    return ins, (port, jx, 2e-4)


def _case_pss(rng):
    jcfg = JPS.make_pss_config(FS, 4096)
    tcfg = TPS.make_pss_config(FS, 4096, device="cpu")
    n = 16384
    base = (2.0 * (np.cumsum(np.full((S, n), 2 * np.pi * 19000 / FS), axis=1)
                   + np.arange(S)[:, None] * 0.3)
            + 0.05 * rng.standard_normal((S, n))).astype(np.float32)
    locked = np.ones((S, n), bool)
    locked[1, :5000] = False                   # one station resets
    ins = (_mpx(rng, n), base, locked, _f32(rng, (S,), 0.01),
           _c64(rng, (S, 294), 0.01), _f32(rng, (S,), 1e-4),
           np.asarray([True, False, True]),
           np.asarray([0, 9000, 200000], np.int32),
           np.asarray([100, 0, 5], np.int32))

    def port(d, bp, lk, *st):
        off, new = TPS.pss_adapt(d, bp, lk, tcfg, TPS.PSSState(*st))
        return (off,) + tuple(new)

    def jx(d, bp, lk, *st):
        off, new = JPS.pss_adapt(d, bp, lk, jcfg, JPS.PSSState(*st))
        return (off,) + tuple(new)

    return ins, (port, jx, 1e-5)        # tests/test_torch_chain.py's


def _case_bits(rng):
    n = 2 * 2048
    zs = []
    for s in range(S):
        bits = rng.integers(0, 2, 300).astype(np.int8)
        bb = jsynth.rds_baseband(bits, n + 200, JC.RDS_RATE)[37 + 5 * s:]
        zs.append(0.3 * bb[:n] * np.exp(1j * (0.7 + s))
                  + 0.01 * _c64(rng, n))
    jcfg = JR.make_bitrecovery_config(JC.RDS_RATE, phase_sub=2048)
    tcfg = TR.make_bitrecovery_config(JC.RDS_RATE, phase_sub=2048,
                                      device="cpu")
    ins = (np.asarray(zs, np.complex64), _c64(rng, (S, 44), 0.1),
           np.asarray([0.0, 2.0, -1.0], np.float32),
           np.asarray([0.0, 7.5, 15.0], np.float32),
           np.asarray([False, True, False]), np.asarray([False, True, True]),
           _c64(rng, (S,)))

    def port(z, *st):
        blk, d24, new = TR.recover_bits(z, tcfg, TR.BitRecoveryState(*st))
        return tuple(blk) + (d24,) + tuple(new)

    def jx(z, *st):
        blk, d24, new = JR.recover_bits(z, jcfg, JR.BitRecoveryState(*st))
        return tuple(blk) + (d24,) + tuple(new)

    return ins, (port, jx, 1e-4)        # tests/test_torch_chain.py's


CASES = {
    "fir_apply": _case_fir_apply, "fir_decimate": _case_fir_decimate,
    "fir_interpolate": _case_fir_interpolate,
    "fft_filter_apply": _case_fft_filter,
    "fft_filter_apply_multi": _case_fft_filter_multi,
    "delay_apply": _case_delay, "linrec_apply": _case_linrec,
    "ema_apply_complex": _case_ema_complex, "ema_apply_rows": _case_ema_rows,
    "runlength_true": _case_runlength, "iir_apply_many": _case_iir_many,
    "mix_lo": _case_mix_lo, "rate_map_linear": _case_rate_map,
    **{f"demod_{d}": _case_demod(d) for d in TD.DECODERS},
    "noise_squelch": _case_squelch("nsq"),
    "level_squelch": _case_squelch("lsq"),
    "recover_pilot": _case_pilot, "pss_adapt": _case_pss,
    "recover_bits": _case_bits,
}


# compared with JAX's eager op: compiled, XLA rounds the bit clock's next
# position tau0 + count * SPS - T (an f32 sum near T) one ulp of T away
# (4.9e-4) from the eager arithmetic, and the sample-hold view follows it
EAGER = {"recover_bits"}


def _exact(a) -> bool:
    return a.dtype in (np.bool_, np.int8, np.int32, np.int64)


@pytest.mark.parametrize("name", list(CASES))
def test_batched_op_matches_rows_and_jax_vmap(name):
    """The op on [S, ...] rows == the op on each row (within ROW_ATOL of
    the row's scale, the cascades IIR_ROW_ATOL; integers and flags equal)
    and jax.vmap of the JAX op (the op's tolerance, of the scale where it
    exceeds 1)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    ins, (port, jx, tol, *row_tol) = CASES[name](rng)
    row_tol = row_tol[0] if row_tol else ROW_ATOL
    got = [t.numpy() for t in tree_leaves(port(*[_t(a) for a in ins]))]
    assert all(g.shape[0] == S for g in got), name
    for s in range(S):
        row = [t.numpy() for t in tree_leaves(port(*[_t(a[s])
                                                     for a in ins]))]
        assert len(row) == len(got)
        for k, (g, r) in enumerate(zip(got, row)):
            if _exact(r):
                np.testing.assert_array_equal(g[s], r, f"{name} out {k}")
            else:
                np.testing.assert_allclose(
                    g[s], r, rtol=0, atol=row_tol * max(1.0, np.abs(r).max()),
                    err_msg=f"{name} out {k}")
    vmapped = jax.vmap(jx) if name in EAGER else jax.jit(jax.vmap(jx))
    want = [np.asarray(a) for a in jax.tree.leaves(
        vmapped(*[jnp.asarray(a) for a in ins]))]
    assert len(want) == len(got)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, k, g.shape, w.shape)
        if _exact(w):
            np.testing.assert_array_equal(g, w, f"{name} out {k}")
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=tol * max(1.0, np.abs(w).max()),
                err_msg=f"{name} out {k}")


# ---------------------------------------------------------------------------
# MultiStationReceiver.step against JAX's vmap(Receiver.step)
# ---------------------------------------------------------------------------

BLOCK_FM = 16384
WARM = 12                     # JAX blocks before the hand-over (~1.02 s)
RUN = 2                       # blocks compared after it
STATIONS = ((-500_000, 0x1111, "STATION1", 700.0),
            (-100_000, 0x2222, "STATION2", 1100.0),
            (400_000, 0x3333, "STATION3", 1300.0))
OFFSETS = [s[0] for s in STATIONS]
BASE = dict(block_fm=BLOCK_FM, rds="block", audio_filter_hz=15000)
OPTIONS = {
    "main_taps": dict(emit_taps=True),
    "am": dict(decoder="am"), "pll": dict(decoder="pll"),
    "mixed": dict(decoder="mixed"),
    "real_baseband": dict(decoder="real_baseband"),
    "difference_mono": dict(decoder="difference", mode="mono"),
    "nsq_input_filter": dict(squelch="nsq", input_filter=True),
    "lsq_reference": dict(squelch="lsq", frontend="reference"),
    "audio_192k_tone": dict(audio_rate=192_000, test_tone=True),
}
LEVELS = {"nsq": [0.0, 40.0, 99.95], "lsq": [10.0, 70.0, 95.0]}


@pytest.fixture(scope="module")
def three_stations():
    return P.stations_iq(STATIONS, (WARM + RUN) * BLOCK_FM / JC.FM_RATE
                         + 0.01)


def _levels(kw):
    return LEVELS.get(kw.get("squelch"))


@pytest.mark.parametrize("opt", list(OPTIONS))
def test_multistation_step_matches_jax_vmap(three_stations, opt):
    kw = dict(BASE, **OPTIONS[opt])
    jmsr = JMultiStation(JReceiver(JConfig(**kw)))
    trx = Receiver(ReceiverConfig(**kw), device="cpu")
    tmsr = MultiStationReceiver(trx)
    js, jc = jmsr.init_states(S), jmsr.controls_for(OFFSETS)
    tc = tmsr.controls_for(OFFSETS)
    if _levels(kw):
        jc = jc._replace(squelch_level=jnp.asarray(_levels(kw), jnp.float32))
        tc = tc._replace(squelch_level=torch.tensor(_levels(kw)))
    T = trx.cfg.block_in
    iq = three_stations
    for b in range(WARM):
        js, out = jmsr.step(js, jc, jnp.asarray(iq[b * T:(b + 1) * T]))
    jst = P.tree_np(js)
    ts = tree_stack([convert.state_from_numpy(
        jax.tree.map(lambda x, s=s: x[s], jst), "cpu") for s in range(S)])
    singles = [tree_index(ts, s) for s in range(S)]
    for b in range(WARM, WARM + RUN):
        blk = iq[b * T:(b + 1) * T]
        js, oj = jmsr.step(js, jc, jnp.asarray(blk))
        ts, ot = tmsr.step(ts, tc, _t(blk))
        assert ot.audio.shape == (S,) + tuple(np.asarray(oj.audio).shape[1:])
        np.testing.assert_allclose(ot.audio.numpy(), np.asarray(oj.audio),
                                   rtol=0, atol=AUDIO_ATOL)
        for name in Meta._fields:
            t, j = getattr(ot.meta, name).numpy(), np.asarray(
                getattr(oj.meta, name))
            assert t.shape == j.shape == (S,), name
            if name in ("pilot_locked", "pss_established"):
                np.testing.assert_array_equal(t.astype(bool), j, name)
            elif name.startswith("peak_"):
                # the audio's maxima, held to the audio's tolerance in
                # amplitude: in dB a quiet output (am's, ~-52 dB) turns
                # the audio's 1e-5 into 0.03 dB
                np.testing.assert_allclose(10.0 ** (t / 20.0),
                                           10.0 ** (j / 20.0), rtol=0,
                                           atol=AUDIO_ATOL, err_msg=name)
            else:
                np.testing.assert_allclose(t, j, rtol=0, atol=META_ATOL,
                                           err_msg=name)
        for s in range(S):
            n = int(oj.rds.count[s])
            assert int(ot.rds.count[s]) == n
            np.testing.assert_array_equal(ot.rds.bits[s, :n].numpy(),
                                          np.asarray(oj.rds.bits[s, :n]))
        if kw.get("emit_taps"):
            assert set(ot.taps) == set(oj.taps)
            for k, v in oj.taps.items():
                v = np.asarray(v)
                assert ot.taps[k].shape == v.shape, k
                np.testing.assert_allclose(
                    ot.taps[k].numpy(), v, rtol=0,
                    atol=AUDIO_ATOL * max(1.0, np.abs(v).max()), err_msg=k)
        # each station against its own single-station step
        for s in range(S):
            singles[s], o1 = trx.step(singles[s], tree_index(tc, s), _t(blk))
            np.testing.assert_allclose(ot.audio[s].numpy(), o1.audio.numpy(),
                                       rtol=0, atol=ROW_ATOL)
            np.testing.assert_allclose(ot.meta_vec[s].numpy(),
                                       o1.meta_vec.numpy(), rtol=0,
                                       atol=ROW_ATOL)
            np.testing.assert_array_equal(ot.rds.bits[s].numpy(),
                                          o1.rds.bits.numpy())
    assert bool(np.asarray(oj.meta.pilot_locked).all()) \
        or kw.get("squelch") or kw.get("decoder") == "am"


# ---------------------------------------------------------------------------
# One station's op count whatever the number of stations
# ---------------------------------------------------------------------------

class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] = self.ops.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def _step_ops(kw, n):
    msr = MultiStationReceiver(Receiver(ReceiverConfig(**kw), device="cpu"))
    st, ctl = msr.init_states(n), msr.controls_for(
        [100_000 * i for i in range(n)])
    iq = _t(P.station_iq(msr.cfg.block_in / JC.INPUT_RATE + 0.001)
            [: msr.cfg.block_in])
    st, _ = msr.step(st, ctl, iq)           # the folded banks are built
    with _CountOps() as c:
        msr.step(st, ctl, iq)
    return c.ops


@pytest.mark.parametrize("kw", [dict(BASE, block_fm=8192),
                                dict(BASE, block_fm=8192, squelch="nsq")],
                         ids=["main", "nsq"])
def test_dispatch_count_is_one_stations(kw):
    one, five = _step_ops(kw, 1), _step_ops(kw, 5)
    assert one == five
    assert sum(one.values()) > 100


# ---------------------------------------------------------------------------
# StationTime 2 x 2 over gloo: one batched FullySharded step
# ---------------------------------------------------------------------------

ST_CFG = dict(block_fm=32768, rds="block", audio_filter_hz=15000)
ST_STATIONS = ((-300_000, 0x4444, "STATIONA", 800.0),
               (250_000, 0x5555, "STATIONB", 1200.0))
GROUP_OFFSETS = {1: [-300_000, 250_000],
                 3: [-300_000, 0, 250_000, 250_000, -300_000, 100_000]}


@pytest.fixture(scope="module")
def station_time_runs(tmp_path_factory):
    from sdrjfm_tpu_torch.parallel.multihost_worker import run_jobs, spawn
    d = tmp_path_factory.mktemp("st")
    cfg = ReceiverConfig(**ST_CFG)
    iq = P.stations_iq(ST_STATIONS, 2 * cfg.block_in / JC.INPUT_RATE + 0.01)
    iq = iq[: 2 * cfg.block_in]
    np.save(d / "cap.npy", iq)
    jobs = [dict(name=f"g{k}", kind="station_time", n_stations=2,
                 cfg=ST_CFG, capture=str(d / "cap.npy"), offsets=offs)
            for k, offs in GROUP_OFFSETS.items()]
    spawn(run_jobs, 4, args=(jobs, str(d)), device="cpu", timeout=600)
    return iq, {k: [np.load(d / f"g{k}.rank{r}.npz") for r in range(4)]
                for k in GROUP_OFFSETS}


def _info(z):
    import json
    return json.loads(str(z["info"]))


def test_station_time_collectives_do_not_grow_with_stations(
        station_time_runs):
    _, runs = station_time_runs
    counts = {k: [_info(r)["counts"] for r in ranks]
              for k, ranks in runs.items()}
    assert counts[1] == counts[3]
    for c in counts[1]:
        assert (c["gather"], c["halo"]) == (5, 8), c


def test_station_time_batched_matches_multistation(station_time_runs):
    iq, runs = station_time_runs
    cfg = ReceiverConfig(**ST_CFG)
    T, Tw = cfg.block_in, cfg.block_working
    offs = GROUP_OFFSETS[3]
    with P.one_thread():
        msr = MultiStationReceiver(Receiver(cfg, device="cpu"))
        st, ctl = msr.init_states(len(offs)), msr.controls_for(offs)
        want, wbits = [], [[] for _ in offs]
        for b in range(len(iq) // T):
            st, out = msr.step(st, ctl, _t(iq[b * T:(b + 1) * T]))
            want.append(out.audio.numpy())
            for s in range(len(offs)):
                wbits[s].append(out.rds.bits[s, : int(out.rds.count[s])]
                                .numpy())
    want = np.concatenate(want, axis=1)
    k = len(offs) // 2
    half = Tw // 2
    for g in range(2):
        mine = sorted([r for r in runs[3] if _info(r)["station_index"] == g],
                      key=lambda r: _info(r)["time_index"])
        for j in range(k):
            s = g * k + j
            got = np.concatenate([r["audio"][j, b * half:(b + 1) * half]
                                  for b in range(len(iq) // T)
                                  for r in mine])
            np.testing.assert_allclose(got, want[s], rtol=0, atol=5e-4)
            for r in mine:
                np.testing.assert_array_equal(
                    r[f"bits{j}"], np.concatenate(wbits[s]).astype(np.uint8))
    assert math.isfinite(float(np.abs(want).max()))
