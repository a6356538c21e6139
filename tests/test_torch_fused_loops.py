"""The fused PSS adaptation and RDS carrier phase (kernels/loops.py
`pss_adapt` and `psi_recover`, called by ops/pss.py `pss_adapt` and
rds/bitrecovery.py `recover_bits`) on the CPU, where each wrapper runs its
plain version, against the torch sequences the callers ran before and
against the JAX package.

Inputs come from a numpy seed.  Tolerances:
- each wrapper against the old sequence written out here (`F * F`, the two
  sums, the flags' stride, `pss_scan_plain`, the expand; `y * y`, the mean,
  `angle`, `psi_unwrap_plain`): bit for bit, the same torch ops;
- the port's `pss_adapt` against JAX's: offsets and acc within 1e-5 rad
  (32 f32 steps a block on sums of 4096 products, which the two libraries
  sum in another order), the mean error within 1e-6 of max(1, |me|), run
  counters and flags exactly;
- `recover_bits` against JAX's: psi within 1e-4 rad (f32 angle of a mean
  of up to 2048 products in two libraries), bits, valid mask and count
  exactly;
- a station row of a 3-row call against its one-row call, and the
  time-sharded `pss_adapt` on 2 gloo ranks against the unsharded call:
  bit for bit (on one thread, as the ranks run; each sub-block lies on one
  rank, and the sharded lowpass equals the single-device one bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.io import synth
from sdrjfm_tpu.ops import pss as JP
from sdrjfm_tpu.rds import bitrecovery as JR
from sdrjfm_tpu_torch.kernels import loops as L
from sdrjfm_tpu_torch.ops import pss as TP
from sdrjfm_tpu_torch.parallel.multihost_worker import spawn
from sdrjfm_tpu_torch.rds import bitrecovery as TR

from torch_parity import one_thread, sharded_pss_job

torch.set_num_threads(2)

SUB = 4096
HOLD = int(JC.PSS_LOCK_STABLE_S * JC.FM_RATE)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _counts():
    return [k.launches for k in (L.pss_adapt, L.pss_scan, L.psi_recover,
                                 L.psi_unwrap)]


def _pss_case(rng, lead, n, sub):
    """The fused wrapper's arguments: F a tone at a row's own phase with
    noise, lock flags with unlocked sub-blocks, entry states around the
    hold."""
    R = int(np.prod(lead))
    T = n * sub
    F = (rng.uniform(0.05, 0.5, (R, 1)) * np.exp(1j * rng.uniform(
        -1.5, 1.5, (R, 1))) + 0.05 * (rng.standard_normal((R, T))
                                      + 1j * rng.standard_normal((R, T))))
    locked = np.repeat(rng.random((R, n)) < 0.8, sub, axis=1)
    locked ^= rng.random((R, T)) < 0.01
    cfg = TP.make_pss_config(JC.FM_RATE, sub, device="cpu")
    state = (_t(rng.uniform(-0.7, 0.7, R).astype(np.float32)),
             _t(rng.uniform(-0.01, 0.01, R).astype(np.float32)),
             _t(rng.random(R) < 0.5),
             _t((HOLD - sub * rng.integers(0, 3, R)).astype(np.int32)),
             _t((HOLD - sub * rng.integers(0, 3, R)).astype(np.int32)))
    state = tuple(v.reshape(lead) for v in state)
    return (_t(F.astype(np.complex64)).reshape(lead + (T,)),
            _t(locked).reshape(lead + (T,)), cfg.ema_weights, state, sub,
            HOLD, float(np.float32(JC.PSS_ALPHA)),
            float(np.float32(cfg.ema_decay)))


def _psi_case(rng, lead, T):
    R = int(np.prod(lead))
    y = (rng.standard_normal((R, T)) + 1j * rng.standard_normal((R, T))
         ).astype(np.complex64)
    psi0 = rng.uniform(-6.0, 6.0, R).astype(np.float32)
    return _t(y).reshape(lead + (T,)), _t(psi0).reshape(lead)


# ---------------------------------------------------------------------------
# the wrappers are the old sequences
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sub", [SUB, 1024])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_pss_adapt_wrapper_is_the_old_sequence(lead, sub):
    F, locked, w, state, sub, hold, alpha, decay = _pss_case(
        np.random.default_rng(21), lead, 9, sub)
    before = _counts()
    off, st = L.pss_adapt(F, locked, w, state, sub, hold, alpha, decay)
    assert _counts() == before
    n, T = F.shape[-1] // sub, F.shape[-1]
    G = (F * F).reshape(lead + (n, sub))
    accs, want = L.pss_scan_plain(
        G.sum(dim=-1), (G * w).sum(dim=-1),
        locked.reshape(lead + (n, sub))[..., 0], state, sub, hold, alpha,
        decay)
    assert off.dtype == torch.float32 and off.shape == lead + (T,)
    assert torch.equal(off, accs[..., None].expand(lead + (n, sub))
                       .reshape(lead + (T,)))
    assert all(torch.equal(a, b) for a, b in zip(st, want))


@pytest.mark.parametrize("phase_sub", [512, 2048])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_psi_recover_wrapper_is_the_old_sequence(lead, phase_sub):
    y, psi0 = _psi_case(np.random.default_rng(22), lead, 8192)
    before = _counts()
    yr, last = L.psi_recover(y, psi0, phase_sub)
    assert _counts() == before
    y2 = (y * y).reshape(lead + (8192 // phase_sub, phase_sub))
    yr_w, last_w = L.psi_unwrap_plain(0.5 * torch.angle(y2.mean(dim=-1)),
                                      psi0, y)
    assert torch.equal(yr, yr_w) and torch.equal(last, last_w)


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------


def _pss_inputs(rng, T, phi, amp, quiet_until=0, unlock=None):
    """One block of T: the pilot's doubled phase and a demod carrying L-R
    on it at phase phi (amplitude amp, silent before `quiet_until`), a
    little noise; lock flags false over `unlock`."""
    n = np.arange(T)
    base = (2.0 * (2 * np.pi * 19000 / JC.FM_RATE * n + 0.3)
            + 0.02 * rng.standard_normal(T))
    m = 1.0 + 0.3 * np.sin(2 * np.pi * 500 / JC.FM_RATE * n)
    demod = amp * m * np.cos(base - phi)
    demod[:quiet_until] = 0.0
    demod = demod + 1e-5 * rng.standard_normal(T)
    locked = np.ones(T, bool)
    if unlock is not None:
        locked[unlock[0]:unlock[1]] = False
    return (demod.astype(np.float32), base.astype(np.float32), locked)


@pytest.mark.parametrize("block", [32768, 131072])
def test_pss_adapt_matches_jax_through_clamp_unlock_and_minimized(block):
    """Blocks of block_fm samples, state carried: quiet blocks take the
    lock counter past its hold (minimized on), loud ones drive acc to
    +-PSS_CLAMP, the pilot drops lock mid-block (the reset)."""
    jcfg = JP.make_pss_config(JC.FM_RATE, SUB)
    tcfg = TP.make_pss_config(JC.FM_RATE, SUB, device="cpu")
    z = JP.pss_zero_state(jcfg)
    js = z._replace(acc=jnp.float32(0.1),
                    lock_run=jnp.int32(HOLD - 2 * SUB))
    ts = TP.pss_zero_state(tcfg, "cpu")._replace(
        acc=torch.tensor(0.1), lock_run=torch.tensor(HOLD - 2 * SUB,
                                                     dtype=torch.int32))
    rng = np.random.default_rng(23)
    q = block // 8
    blocks = [_pss_inputs(rng, block, 1.2, 0.0),
              _pss_inputs(rng, block, 1.2, 3.0, quiet_until=q),
              _pss_inputs(rng, block, 1.2, 3.0),
              _pss_inputs(rng, block, -1.2, 3.0, unlock=(3 * q, 4 * q)),
              _pss_inputs(rng, block, -1.2, 3.0)]
    jstep = jax.jit(lambda d, bp, lk, s: JP.pss_adapt(d, bp, lk, jcfg, s))
    minimized, offs = [], []
    for d, bp, lk in blocks:
        oj, js = jstep(jnp.asarray(d), jnp.asarray(bp), jnp.asarray(lk), js)
        ot, ts = TP.pss_adapt(_t(d), _t(bp), _t(lk), tcfg, ts)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                                   atol=1e-5)
        assert abs(float(ts.acc) - float(js.acc)) <= 1e-5
        me = float(js.mean_error)
        assert abs(float(ts.mean_error) - me) <= 1e-6 * max(1.0, abs(me))
        for f in ("minimized", "lock_run", "unlock_run"):
            assert int(getattr(ts, f)) == int(getattr(js, f)), f
        minimized.append(bool(js.minimized))
        offs.append(np.asarray(oj))
    clamp = np.float32(JC.PSS_CLAMP)
    # what the inputs were chosen to exercise, as JAX ran it
    assert minimized[0] and not minimized[3]
    assert max(np.float32(o.max()) for o in offs[1:3]) == clamp
    assert np.float32(offs[4].min()) == -clamp
    # the sub-blocks whose first sample is unlocked are held at 0
    first = (3 * q + SUB - 1) // SUB
    assert (offs[3][first * SUB:(4 * q // SUB) * SUB] == 0.0).all()


def _rds_blocks(rng, T, nblk, drift):
    bits = rng.integers(0, 2, 4000).astype(np.int8)
    n = nblk * T
    bb = synth.rds_baseband(bits, n + 200, JC.RDS_RATE)[37:37 + n]
    return (0.3 * bb * np.exp(1j * (0.7 + drift * np.arange(n)))
            + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


@pytest.mark.parametrize("phase_sub", [512, 2048])
@pytest.mark.parametrize("block_fm", [32768, 131072])
def test_recover_bits_matches_jax(block_fm, phase_sub):
    """RDS blocks of block_fm / 8 samples whose carrier phase drifts 0.25
    rad a 2048 samples (psi carried across multiples of pi / 2): psi and
    the bits as JAX's."""
    T = block_fm // 8
    nblk = max(3, 32768 // T)
    z = _rds_blocks(np.random.default_rng(24), T, nblk, 0.25 / 2048)
    jcfg = JR.make_bitrecovery_config(JC.RDS_RATE, phase_sub=phase_sub)
    tcfg = TR.make_bitrecovery_config(JC.RDS_RATE, phase_sub=phase_sub,
                                      device="cpu")
    js, ts = JR.bitrecovery_zero_state(jcfg), TR.bitrecovery_zero_state(
        tcfg, "cpu")
    jbits = jax.jit(lambda z, s: JR.recover_bits(z, jcfg, s))
    for b in range(nblk):
        blk = z[b * T:(b + 1) * T]
        bj, _, js = jbits(jnp.asarray(blk), js)
        bt, _, ts = TR.recover_bits(_t(blk), tcfg, ts)
        assert int(bt.count) == int(bj.count)
        np.testing.assert_array_equal(bt.valid.numpy(), np.asarray(bj.valid))
        np.testing.assert_array_equal(bt.bits.numpy(), np.asarray(bj.bits))
        assert abs(float(ts.psi) - float(js.psi)) <= 1e-4
    assert abs(float(js.psi) - 0.7) > np.pi


# ---------------------------------------------------------------------------
# rows, refusals, the time-sharded branch
# ---------------------------------------------------------------------------


def test_fused_rows_equal_one_row_calls():
    rng = np.random.default_rng(25)
    F, locked, w, state, *rest = _pss_case(rng, (3,), 5, SUB)
    y, psi0 = _psi_case(rng, (3,), 4096)
    with one_thread():
        off3, st3 = L.pss_adapt(F, locked, w, state, *rest)
        yr3, last3 = L.psi_recover(y, psi0, 512)
        for s in range(3):
            off1, st1 = L.pss_adapt(F[s], locked[s], w,
                                    tuple(v[s] for v in state), *rest)
            assert torch.equal(off3[s], off1)
            assert all(torch.equal(a[s], b) for a, b in zip(st3, st1))
            yr1, last1 = L.psi_recover(y[s], psi0[s], 512)
            assert torch.equal(yr3[s], yr1) and torch.equal(last3[s], last1)


def test_fused_wrappers_refuse_other_devices_and_bad_inputs():
    rng = np.random.default_rng(26)
    F, locked, w, state, sub, hold, alpha, decay = _pss_case(rng, (2,), 2,
                                                            SUB)
    y, psi0 = _psi_case(rng, (2,), 4096)
    meta = [v.to("meta") for v in (F, locked, w, y, psi0)]
    with pytest.raises(ValueError, match="unsupported device"):
        L.pss_adapt(meta[0], meta[1], meta[2],
                    tuple(v.to("meta") for v in state), sub, hold, alpha,
                    decay)
    with pytest.raises(ValueError, match="unsupported device"):
        L.psi_recover(meta[3], meta[4], 512)
    with pytest.raises(ValueError, match="whole sub-blocks"):
        L.pss_adapt(F[:, :-4], locked[:, :-4], w, state, sub, hold, alpha,
                    decay)
    with pytest.raises(ValueError, match="whole sub-blocks"):
        L.psi_recover(y[:, :-2], psi0, 512)
    with pytest.raises(TypeError, match="complex64"):
        L.pss_adapt(F.to(torch.complex128), locked, w, state, sub, hold,
                    alpha, decay)
    with pytest.raises(TypeError, match="bool"):
        L.pss_adapt(F, locked.to(torch.uint8), w, state, sub, hold, alpha,
                    decay)
    with pytest.raises(TypeError, match="float32"):
        L.pss_adapt(F, locked, w[:-1], state, sub, hold, alpha, decay)
    with pytest.raises(TypeError, match="complex64"):
        L.psi_recover(y.real, psi0, 512)
    with pytest.raises(TypeError, match="float32"):
        L.psi_recover(y, psi0.double(), 512)


def test_sharded_pss_adapt_routes_through_pss_scan(tmp_path):
    """ops.pss.pss_adapt(axis=) on 2 gloo ranks, each its half of two
    32768-sample blocks: every rank calls the unfused pss_scan once a
    block and never the fused wrapper, and the offsets and state equal the
    unsharded call's (which goes through the fused wrapper)."""
    rng = np.random.default_rng(27)
    T = 32768
    blocks = [_pss_inputs(rng, T, 0.9, 2.0, unlock=(9000, 13000)),
              _pss_inputs(rng, T, 0.4, 2.0)]
    tcfg = TP.make_pss_config(JC.FM_RATE, SUB, device="cpu")
    st = TP.pss_zero_state(tcfg, "cpu")._replace(
        acc=torch.tensor(0.2), lock_run=torch.tensor(HOLD - 3 * SUB,
                                                     dtype=torch.int32),
        tail=_t((0.1 * rng.standard_normal(len(tcfg.kernel) - 1)
                 ).astype(np.complex64)))
    np.savez(tmp_path / "in.npz", sub=SUB,
             **{k: np.stack([b[i] for b in blocks])
                for i, k in enumerate(("demod", "base", "locked"))},
             **{f: getattr(st, f).numpy() for f in TP.PSSState._fields})
    spawn(sharded_pss_job, 2, args=(str(tmp_path / "in.npz"),
                                    str(tmp_path)), device="cpu",
          timeout=300)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    want = []
    with one_thread():
        for d, bp, lk in blocks:
            o, st = TP.pss_adapt(_t(d), _t(bp), _t(lk), tcfg, st)
            want.append(o.numpy())
    for b in range(2):
        got = np.concatenate([z["offsets"][b] for z in ranks])
        np.testing.assert_array_equal(got, want[b])
    for z in ranks:
        assert int(z["calls"]) == 2
        for f in ("acc", "mean_error", "minimized", "lock_run",
                  "unlock_run"):
            np.testing.assert_array_equal(z[f], getattr(st, f).numpy())
    np.testing.assert_array_equal(ranks[-1]["tail"], st.tail.numpy())
