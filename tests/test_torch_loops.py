"""The fm chain's sequential loops (sdrjfm_tpu_torch/kernels/loops.py and
their callers) against the JAX package on the CPU, where each wrapper runs
its plain version.

Inputs come from a numpy seed and go through both packages.  Tolerances:
- PSS offsets and acc within 1e-5 rad (32 f32 steps a block on sums of
  4096 products, which the two libraries sum in another order), the mean
  error within 1e-6 of max(1, |me|); run counters and flags exactly; a
  station row of a 3-row call equal to its one-row call bit for bit (on
  one thread, tests/torch_parity.py one_thread).
- Run lengths exactly (integers).
- psi within 1e-4 rad (f32 angle of a mean of 2048 products in two
  libraries), bits, valid mask and count exactly.
- Squelch gates and `suppress` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.io import synth
from sdrjfm_tpu.ops import blockops as JB
from sdrjfm_tpu.ops import pss as JP
from sdrjfm_tpu.ops import squelch as JS
from sdrjfm_tpu.rds import bitrecovery as JR
from sdrjfm_tpu_torch.kernels import loops as L
from sdrjfm_tpu_torch.ops import blockops as TB
from sdrjfm_tpu_torch.ops import pss as TP
from sdrjfm_tpu_torch.ops import squelch as TS
from sdrjfm_tpu_torch.rds import bitrecovery as TR

from torch_parity import one_thread

torch.set_num_threads(2)

BLOCK = 131072
SUB = 4096


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# PSS
# ---------------------------------------------------------------------------

def _jpss(cfg):
    return jax.jit(lambda d, bp, lk, s: JP.pss_adapt(d, bp, lk, cfg, s))


def _pss_inputs(rng, phi, amp, quiet_until=0, unlock=None):
    """One block: the pilot's doubled phase (a 38 kHz oscillator) and a
    demod carrying L-R on it at phase phi (amplitude amp, silent before
    `quiet_until`), a little noise; lock flags false over `unlock`."""
    n = np.arange(BLOCK)
    base = (2.0 * (2 * np.pi * 19000 / JC.FM_RATE * n + 0.3)
            + 0.02 * rng.standard_normal(BLOCK))
    m = 1.0 + 0.3 * np.sin(2 * np.pi * 500 / JC.FM_RATE * n)
    demod = amp * m * np.cos(base - phi)
    demod[:quiet_until] = 0.0
    demod = demod + 1e-5 * rng.standard_normal(BLOCK)
    locked = np.ones(BLOCK, bool)
    if unlock is not None:
        locked[unlock[0]:unlock[1]] = False
    return (demod.astype(np.float32), base.astype(np.float32), locked)


def _pss_states(jcfg, tcfg, **kw):
    """The same entry state for both packages."""
    js = JP.pss_zero_state(jcfg)._replace(
        **{k: jnp.asarray(v, dtype=getattr(JP.pss_zero_state(jcfg), k).dtype)
           for k, v in kw.items()})
    z = TP.pss_zero_state(tcfg, "cpu")
    ts = z._replace(**{k: torch.tensor(v, dtype=getattr(z, k).dtype)
                       for k, v in kw.items()})
    return js, ts


def _pss_close(ot, oj, ts, js):
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                               atol=1e-5)
    assert abs(float(ts.acc) - float(js.acc)) <= 1e-5
    me = float(js.mean_error)
    assert abs(float(ts.mean_error) - me) <= 1e-6 * max(1.0, abs(me))
    for f in ("minimized", "lock_run", "unlock_run"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), f


def test_pss_adapt_matches_jax_through_clamp_unlock_and_minimized():
    """Four blocks, state carried: a quiet block takes the lock counter
    past its hold (minimized turns on), a loud one drives acc to
    +PSS_CLAMP, the pilot drops lock mid-block (the reset: minimized off,
    acc 0) and L-R on the other side drives acc to -PSS_CLAMP."""
    jcfg = JP.make_pss_config(JC.FM_RATE, SUB)
    tcfg = TP.make_pss_config(JC.FM_RATE, SUB, device="cpu")
    hold = int(JC.PSS_LOCK_STABLE_S * JC.FM_RATE)
    js, ts = _pss_states(jcfg, tcfg, acc=0.1, lock_run=hold - 2 * SUB)
    rng = np.random.default_rng(11)
    blocks = [_pss_inputs(rng, 1.2, 0.0),
              _pss_inputs(rng, 1.2, 3.0, quiet_until=20000),
              _pss_inputs(rng, -1.2, 3.0, unlock=(40000, 60000)),
              _pss_inputs(rng, -1.2, 3.0)]
    minimized, offs = [], []
    for d, bp, lk in blocks:
        oj, js = _jpss(jcfg)(jnp.asarray(d), jnp.asarray(bp),
                             jnp.asarray(lk), js)
        ot, ts = TP.pss_adapt(_t(d), _t(bp), _t(lk), tcfg, ts)
        _pss_close(ot, oj, ts, js)
        minimized.append(bool(js.minimized))
        offs.append(np.asarray(oj))
    clamp = np.float32(JC.PSS_CLAMP)
    # what the inputs were chosen to exercise, as JAX ran it
    assert minimized[0] and not minimized[2]
    assert np.float32(offs[1].max()) == clamp
    assert np.float32(offs[3].min()) == -clamp
    # the sub-blocks whose first sample is unlocked (10-14) are held at 0
    assert (offs[2][10 * SUB:15 * SUB] == 0.0).all()
    assert (offs[2][9 * SUB:10 * SUB] != 0.0).all()


def test_pss_adapt_minimized_off_by_unlock_run():
    """minimized on, the error far from the lock threshold and the unlock
    counter one sub-block short of the hold: it turns off in the block."""
    jcfg = JP.make_pss_config(JC.FM_RATE, SUB)
    tcfg = TP.make_pss_config(JC.FM_RATE, SUB, device="cpu")
    hold = int(JC.PSS_LOCK_STABLE_S * JC.FM_RATE)
    js, ts = _pss_states(jcfg, tcfg, acc=-0.2, mean_error=0.5,
                         minimized=True, lock_run=hold + SUB,
                         unlock_run=hold - SUB)
    d, bp, lk = _pss_inputs(np.random.default_rng(12), 0.5, 1.0)
    oj, js = _jpss(jcfg)(jnp.asarray(d), jnp.asarray(bp), jnp.asarray(lk), js)
    ot, ts = TP.pss_adapt(_t(d), _t(bp), _t(lk), tcfg, ts)
    _pss_close(ot, oj, ts, js)
    assert not bool(js.minimized)


def test_pss_adapt_rows_equal_one_row_calls():
    """Three station rows in one call, each its own inputs and entry state,
    over two blocks: each row equals the one-row call bit for bit."""
    tcfg = TP.make_pss_config(JC.FM_RATE, SUB, device="cpu")
    hold = int(JC.PSS_LOCK_STABLE_S * JC.FM_RATE)
    rng = np.random.default_rng(13)
    entry = [dict(acc=0.1, lock_run=hold - 2 * SUB),
             dict(acc=-0.3, mean_error=0.5, minimized=True,
                  unlock_run=hold - SUB),
             dict()]
    z = TP.pss_zero_state(tcfg, "cpu")
    ones = [z._replace(**{k: torch.tensor(v, dtype=getattr(z, k).dtype)
                          for k, v in e.items()}) for e in entry]
    rows = TP.PSSState(*(torch.stack(leaves) for leaves in zip(*ones)))
    with one_thread():
        for b in range(2):
            ins = [_pss_inputs(rng, phi, amp, unlock=unl) for phi, amp, unl
                   in ((1.2, 0.0 if b == 0 else 1.0, None),
                       (0.5, 1.0, (50000, 70000)), (-1.0, 0.7, None))]
            stacked = [_t(np.stack(x)) for x in zip(*ins)]
            o3, rows = TP.pss_adapt(*stacked, tcfg, rows)
            for s, (d, bp, lk) in enumerate(ins):
                o1, ones[s] = TP.pss_adapt(_t(d), _t(bp), _t(lk), tcfg,
                                           ones[s])
                assert torch.equal(o3[s], o1)
                for a, c in zip(rows, ones[s]):
                    assert torch.equal(a[s], c)


# ---------------------------------------------------------------------------
# run length
# ---------------------------------------------------------------------------

_j_rl = jax.jit(jax.vmap(JB.runlength_true))


def _flag_rows(rng, R, T):
    """Row kinds in turn: all true, all false, short random runs, and long
    runs whose falses sit so that runs cross 1024, 2048 and 4096 (and the
    kernel's 16384-sample blocks)."""
    rows = []
    for r in range(R):
        kind = r % 4
        if kind == 0:
            f = np.ones(T, bool)
        elif kind == 1:
            f = np.zeros(T, bool)
        elif kind == 2:
            f = rng.random(T) < 0.9
        else:
            f = np.ones(T, bool)
            cuts = [1000, 5000, 16380, 20000, 70000, 131000]
            cuts += list(rng.integers(0, max(T, 1), 4))
            f[[c for c in cuts if c < T]] = False
        rows.append(f)
    return np.stack(rows)


@pytest.mark.parametrize("r0", [0, 7, 10 ** 6])
@pytest.mark.parametrize("R", [1, 2, 38])
@pytest.mark.parametrize("T", [1, 12000, BLOCK])
def test_runlength_matches_jax(T, R, r0):
    rng = np.random.default_rng(T + R)
    flags = _flag_rows(rng, R, T)
    r0s = (r0 + np.arange(R) % 3).astype(np.int32)
    rj, lj = _j_rl(jnp.asarray(flags), jnp.asarray(r0s))
    rp, lp = L.runlength_plain(_t(flags), _t(r0s))
    rt, lt = TB.runlength_true(_t(flags), _t(r0s))
    for got, last in ((rp, lp), (rt, lt)):
        assert got.dtype == torch.int32 and last.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(rj))
        np.testing.assert_array_equal(last.numpy(), np.asarray(lj))


def test_runlength_one_row_unbatched_matches_jax():
    """A [T] row and a 0-dim carry, as the single-station pilot calls it."""
    flags = _flag_rows(np.random.default_rng(5), 4, 20000)[3]
    rj, lj = JB.runlength_true(jnp.asarray(flags), 123)
    rt, lt = TB.runlength_true(_t(flags), torch.tensor(123, dtype=torch.int32))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert lt.shape == () and int(lt) == int(lj)


# ---------------------------------------------------------------------------
# RDS carrier-phase unwrap
# ---------------------------------------------------------------------------


def test_recover_bits_psi_unwraps_a_drifting_phase_as_jax():
    """A baseband whose carrier phase drifts by 0.25 rad a 2048-sample
    sub-block, ~5 wraps of pi/2 over 4 blocks of 16384: psi and the bits
    as JAX's."""
    rng = np.random.default_rng(14)
    bits = rng.integers(0, 2, 4000).astype(np.int8)
    T, nblk = 16384, 4
    n = nblk * T
    bb = synth.rds_baseband(bits, n + 200, JC.RDS_RATE)[37:37 + n]
    drift = 0.25 / 2048
    z = (0.3 * bb * np.exp(1j * (0.7 + drift * np.arange(n)))
         + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    jcfg = JR.make_bitrecovery_config(JC.RDS_RATE, phase_sub=2048)
    tcfg = TR.make_bitrecovery_config(JC.RDS_RATE, phase_sub=2048,
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
    # the unwrap carried psi across several multiples of pi / 2
    assert abs(float(js.psi) - 0.7) > 2 * np.pi


def test_psi_unwrap_rows_equal_one_row_calls():
    rng = np.random.default_rng(15)
    raw = rng.uniform(-np.pi / 2, np.pi / 2, (3, 8)).astype(np.float32)
    psi0 = np.array([0.1, 4.0, -7.5], np.float32)
    y = (rng.standard_normal((3, 8 * 512))
         + 1j * rng.standard_normal((3, 8 * 512))).astype(np.complex64)
    yr3, last3 = L.psi_unwrap(_t(raw), _t(psi0), _t(y))
    for s in range(3):
        yr1, last1 = L.psi_unwrap(_t(raw[s]), _t(psi0)[s], _t(y[s]))
        assert torch.equal(yr3[s], yr1) and torch.equal(last3[s], last1)


# ---------------------------------------------------------------------------
# squelch decisions
# ---------------------------------------------------------------------------

_j_lsq = jax.jit(JS.level_squelch, static_argnums=3)
_j_nsq = jax.jit(JS.noise_squelch, static_argnums=2)


def _band_trace(rng, nblk):
    """Demod whose high/low band ratio swings across every threshold:
    hold periods of a 1 kHz tone (ratio ~0), white noise (~0.6) and
    noise above 75 kHz (ratio > 1) in turn."""
    from scipy import signal
    n = nblk * BLOCK
    t = np.arange(n) / JC.FM_RATE
    tone = 0.5 * np.sin(2 * np.pi * 1000 * t)
    white = 0.3 * rng.standard_normal(n)
    hf = signal.sosfilt(signal.butter(8, 75000, "highpass", fs=JC.FM_RATE,
                                      output="sos"),
                        rng.standard_normal(n))
    kind = (np.arange(n) // 12288) % 3
    return np.where(kind == 0, tone, np.where(kind == 1, white, hf)
                    ).astype(np.float32)


@pytest.mark.parametrize("level", [0.0, 30.0, 60.0, 100.0])
def test_noise_squelch_decisions_match_jax(level):
    nblk = 3
    x = _band_trace(np.random.default_rng(16), nblk)
    jcfg, tcfg = JS.make_squelch_config(), TS.make_squelch_config()
    jst, tst = JS.squelch_zero_state(jcfg), TS.squelch_zero_state(tcfg)
    lj, lt = jnp.float32(level), torch.tensor(level, dtype=torch.float32)
    gates = []
    for b in range(nblk):
        xb = x[b * BLOCK:(b + 1) * BLOCK]
        yj, jst = _j_nsq(jnp.asarray(xb), lj, jcfg, jst)
        yt, tst = TS.noise_squelch(_t(xb), lt, tcfg, tst)
        gj = np.asarray(yj).reshape(-1, tcfg.hold_period) != 0
        gt = yt.numpy().reshape(-1, tcfg.hold_period) != 0
        np.testing.assert_array_equal(gt, gj)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        assert bool(tst.suppress) == bool(jst.suppress)
        gates += list(gj.any(axis=1))
    if level == 100.0:
        assert not any(gates)               # thr 0 < HYSTERESIS_NSQ: shut
    else:
        assert any(gates) and not all(gates)    # the trace crosses the band


@pytest.mark.parametrize("level", [0.0, 30.0, 60.0, 100.0])
def test_level_squelch_decisions_match_jax(level):
    nblk = 2
    rng = np.random.default_rng(17)
    n = nblk * BLOCK
    x = rng.standard_normal(n).astype(np.float32)
    # the carrier level sweeps 1e-3 .. 10 and back, crossing every level's
    # threshold 10^((level - 80) / 30), and sits on one exactly
    carrier = 10.0 ** (-3.0 + 4.0 * np.abs(np.sin(np.pi * np.arange(n)
                                                   / (0.7 * n))))
    carrier = carrier.astype(np.float32)
    thr = torch.pow(10.0, (torch.tensor(level, dtype=torch.float32) - 80.0)
                    / 30.0)
    carrier[8191] = float(thr)
    jcfg, tcfg = JS.make_squelch_config(), TS.make_squelch_config()
    jst, tst = JS.squelch_zero_state(jcfg), TS.squelch_zero_state(tcfg)
    lj, lt = jnp.float32(level), torch.tensor(level, dtype=torch.float32)
    gates = []
    for b in range(nblk):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        yj, jst = _j_lsq(jnp.asarray(x[sl]), jnp.asarray(carrier[sl]), lj,
                         jcfg, jst)
        yt, tst = TS.level_squelch(_t(x[sl]), _t(carrier[sl]), lt, tcfg,
                                   tst)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        assert bool(tst.suppress) == bool(jst.suppress)
        gates += list((np.asarray(yj).reshape(-1, tcfg.hold_period) != 0)
                      .any(axis=1))
    assert any(gates) and not all(gates)        # the sweep crosses thr


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------


def _counts():
    return [k.launches for k in (L.pss_scan, L.psi_unwrap, L.runlength,
                                 L.squelch_decide)]


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """A CPU tensor runs the plain version (equal bit for bit) and no
    launch is counted."""
    rng = np.random.default_rng(18)
    c = lambda *s: _t((rng.standard_normal(s) + 1j * rng.standard_normal(s)  # noqa: E731
                       ).astype(np.complex64))
    f = lambda *s: _t(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    b = lambda *s: _t(rng.random(s) < 0.7)  # noqa: E731
    i = lambda *v: _t(np.array(v, np.int32))  # noqa: E731
    state = (f(3), f(3), b(3), i(0, 5, 9), i(4, 0, 1))
    calls = [(L.pss_scan, L.pss_scan_plain,
              (c(3, 32), c(3, 32), b(3, 32), state, SUB, 576000, 5e-5, 0.98)),
             (L.psi_unwrap, L.psi_unwrap_plain, (f(3, 8), f(3), c(3, 4096))),
             (L.runlength, L.runlength_plain, (b(2, 5000), i(3, 0)))]
    calls += [(L.squelch_decide, L.squelch_decide_plain,
               (mode, f(2, 16).abs(), f(2, 16).abs(), f(2).abs(), b(2)))
              for mode in ("nsq", "level")]
    before = _counts()
    for wrapper, plain, args in calls:
        got, want = wrapper(*args), plain(*args)
        assert torch.equal(got[0], want[0])
        rest = zip(got[1], want[1]) if isinstance(got[1], tuple) else \
            [(got[1], want[1])]
        assert all(torch.equal(x, y) for x, y in rest)
    assert _counts() == before


def test_wrappers_refuse_other_devices():
    m = torch.empty(2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        L.runlength(m.bool(), torch.zeros(2, dtype=torch.int32,
                                          device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        L.squelch_decide("level", m, m, m[:, 0], m[:, 0].bool())
    with pytest.raises(ValueError, match="mode"):
        L.squelch_decide_plain("other", m, m, m[:, 0], m[:, 0].bool())
