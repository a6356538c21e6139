"""The fused squelch (kernels/loops.py `squelch_gate`, called by
ops/squelch.py `noise_squelch` and `level_squelch`) on the CPU, where the
wrapper runs its plain version, against the torch route the callers ran
before and against the JAX package; the time-sharded squelch, which keeps
`squelch_decide`; and the rank launcher's default device.

Inputs come from a numpy seed.  Tolerances:
- the wrapper against the old route written out here (`abs`,
  `ema_apply_rows`, the period-end slices, `squelch_decide_plain`, the
  gate): bit for bit, the same torch ops;
- the port's noise and level squelch against JAX's over chained blocks:
  decisions and gated output exactly; the band filters' pole states and the
  decaying averages within rtol 1e-3 and atol 1e-4 of their largest
  magnitude (as tests/test_torch_squelch.py holds the cascades: f32
  recurrences in two libraries);
- a row of a 3-row call against its one-row call: bit for bit (on one
  thread);
- the time-sharded squelch on 2 gloo ranks against the unsharded call:
  decisions and gated output exactly (the inputs sit away from every
  decision boundary), the averages within 1e-4 of their magnitude (the
  distributed scan sums in another order than the one-device scan).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.ops import squelch as JS
from sdrjfm_tpu_torch.kernels import loops as L
from sdrjfm_tpu_torch.ops import blockops as TB
from sdrjfm_tpu_torch.ops import squelch as TS
from sdrjfm_tpu_torch.parallel.multihost_worker import spawn

from torch_parity import one_thread, rank_file_job, sharded_squelch_job

torch.set_num_threads(2)

H = 8192
ALPHA = 1.0 / (JC.FM_RATE / 100.0)
HYS = L.HYSTERESIS_NSQ
LEVELS = (0.0, 30.0, 60.0, 100.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nsq_thr(level):
    return 1.0 - torch.tensor(level, dtype=torch.float32) / 100.0


def _lsq_thr(level):
    return torch.pow(10.0, (torch.tensor(level, dtype=torch.float32) - 80.0)
                     / 30.0)


def _gate_case(rng, mode, lead, nper, level):
    """(a, b, x, thr, avg0, sup0) of one call: the demod x; for nsq the two
    bands with random signs, |b| ~ 0.8 and |a| ~ |b| thr + c HYS, c a
    period's own draw of -4 (opens), -0.5 and 0.5 (hold) or 4 (closes),
    each sample's magnitude 1 % noisy; for level the carrier around thr
    (+-50 %), one period on it exactly and one NaN."""
    R = int(np.prod(lead)) if lead else 1
    T = nper * H
    x = rng.standard_normal((R, T)).astype(np.float32)
    thr = (_nsq_thr(level) if mode == "nsq" else _lsq_thr(level)).item()
    sup0 = rng.random(R) < 0.5
    if mode == "nsq":
        c = np.repeat(rng.choice([-4.0, -0.5, 0.5, 4.0], (R, nper)), H, axis=1)
        mb = 0.8 * (1.0 + 0.01 * rng.random((R, T)))
        ma = np.abs(0.8 * thr + c * HYS) * (1.0 + 0.01 * rng.random((R, T)))
        sign = lambda: rng.choice([-1.0, 1.0], (R, T))  # noqa: E731
        ab = np.stack([sign() * ma, sign() * mb], axis=1).astype(np.float32)
        ab = _t(ab).reshape(lead + (2, T))
        a, b = ab[..., 0, :], ab[..., 1, :]       # views, as the pole bank's
        avg0 = tuple(_t(v.astype(np.float32)).reshape(lead)
                     for v in (0.8 * thr * np.ones(R), 0.8 * np.ones(R)))
    else:
        lvl = thr * (1.0 + rng.choice([-0.5, 0.5], (R, nper)))
        lvl[-1, 0] = thr
        if nper > 2:
            lvl[0, 1] = np.nan
        a = _t((np.repeat(lvl, H, axis=1) * (1.0 + 0.01 * rng.standard_normal(
            (R, T)))).astype(np.float32)).reshape(lead + (T,))
        a.reshape(R, nper, H)[..., -1] = _t(lvl.astype(np.float32))
        b, avg0 = None, None
    return (a, b, _t(x).reshape(lead + (T,)),
            (_nsq_thr(level) if mode == "nsq" else _lsq_thr(level)),
            avg0, _t(sup0).reshape(lead))


def _old_route(mode, a, b, x, thr, avg0, sup0):
    """The route noise_squelch / level_squelch ran before squelch_gate."""
    per = x.shape[:-1] + (x.shape[-1] // H, H)
    if mode == "nsq":
        (ah, ah_last), (al, al_last) = TB.ema_apply_rows(
            [torch.abs(a), torch.abs(b)], [ALPHA, ALPHA], list(avg0))
        sups, sup = L.squelch_decide_plain(
            "nsq", ah.reshape(per)[..., -1], al.reshape(per)[..., -1], thr,
            sup0)
        carry = (ah_last, al_last)
    else:
        sups, sup = L.squelch_decide_plain(
            "level", a.reshape(per)[..., -1], None, thr, sup0)
        carry = None
    keep = (~sups).to(x.dtype)
    y = (x.reshape(per) * keep[..., None]).reshape(x.shape)
    return y, sups, sup, carry


def _equal(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        elif isinstance(w, tuple):
            _equal(g, w)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("nper", [1, 4, 16])
@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("mode", ["nsq", "level"])
def test_squelch_gate_wrapper_is_the_old_route(mode, lead, nper, level):
    rng = np.random.default_rng(61 + nper + int(level))
    args = _gate_case(rng, mode, lead, nper, level)
    before = (L.squelch_gate.launches, L.squelch_decide.launches)
    got = L.squelch_gate(mode, *args[:3], args[3], args[4], args[5], H,
                         ALPHA)
    want = _old_route(mode, *args)
    _equal(got, want)
    assert (L.squelch_gate.launches, L.squelch_decide.launches) == before
    sups = want[1].reshape(-1, nper)
    if level == 100.0 and mode == "nsq":
        assert bool(sups.all())              # thr 0 < HYSTERESIS_NSQ: shut
    elif nper == 16:
        # the placement opens, closes and holds
        assert bool(sups.any()) and not bool(sups.all())


def _demod_capture(seed=62):
    """station -> noise -> station, 4 hold periods each (as
    tests/test_torch_squelch.py), with the carrier the level squelch
    reads."""
    rng = np.random.default_rng(seed)
    n = 4 * H
    t = np.arange(n) / JC.FM_RATE
    station = (0.5 * np.sin(2 * np.pi * 1000 * t)
               + 0.1 * np.sin(2 * np.pi * 19000 * t)
               + 0.2 * np.sin(2 * np.pi * 38000 * t)
               + 0.01 * rng.standard_normal(n))
    noise = np.diff(rng.standard_normal(n + 1)) * 1.5
    x = np.concatenate([station, noise, station]).astype(np.float32)
    carrier = np.concatenate([np.full(n, 1.0), np.full(n, 0.01),
                              np.full(n, 1.0)]).astype(np.float32)
    return x, carrier


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", ["nsq", "lsq"])
def test_squelch_matches_jax_over_chained_blocks(kind, level):
    """Blocks of two hold periods, state carried: decisions, the gated
    output and the states as JAX's."""
    x, carrier = _demod_capture()
    jcfg, tcfg = JS.make_squelch_config(), TS.make_squelch_config()
    jst, tst = JS.squelch_zero_state(jcfg), TS.squelch_zero_state(tcfg)
    bank = TS.squelch_bank(tcfg, "cpu")
    B = 2 * H
    lvl_j, lvl_t = jnp.asarray(level, jnp.float32), torch.tensor(level)
    closed = []
    for b in range(len(x) // B):
        xb, cb = x[b * B:(b + 1) * B], carrier[b * B:(b + 1) * B]
        if kind == "nsq":
            yj, jst = JS.noise_squelch(jnp.asarray(xb), lvl_j, jcfg, jst)
            yt, tst = TS.noise_squelch(_t(xb), lvl_t, tcfg, tst, bank)
        else:
            yj, jst = JS.level_squelch(jnp.asarray(xb), jnp.asarray(cb),
                                       lvl_j, jcfg, jst)
            yt, tst = TS.level_squelch(_t(xb), _t(cb), lvl_t, tcfg, tst)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        assert bool(tst.suppress) == bool(jst.suppress)
        closed += list((yt.numpy().reshape(-1, H) == 0).all(1))
        for name in ("avg_high", "avg_low"):
            _close(getattr(tst, name).numpy(), getattr(jst, name))
        for part in ("hp_state", "lp_state"):
            for got, want in zip(getattr(tst, part), getattr(jst, part)):
                got, want = got.numpy(), np.asarray(want)
                if want.dtype.kind == "c":
                    got, want = ([v.real, v.imag] for v in (got, want))
                _close(got, want)
    if level == 100.0 and kind == "nsq":
        assert all(closed)
    elif kind == "lsq" and level < 80.0:
        # the carrier of 0.01 on the noise is below 10^((level-80)/30)
        # only from level 20 up
        assert closed[4:8] == [level > 20.0] * 4 and not any(closed[9:])


@pytest.mark.parametrize("mode", ["nsq", "level"])
def test_squelch_gate_rows_equal_one_row_calls(mode):
    rng = np.random.default_rng(63)
    a, b, x, thr, avg0, sup0 = _gate_case(rng, mode, (3,), 4, 30.0)
    thr = thr.expand(3).clone()
    with one_thread():
        y3, sups3, last3, carry3 = L.squelch_gate(mode, a, b, x, thr, avg0,
                                                  sup0, H, ALPHA)
        for s in range(3):
            y1, sups1, last1, carry1 = L.squelch_gate(
                mode, a[s], None if b is None else b[s], x[s], thr[s],
                None if avg0 is None else tuple(v[s] for v in avg0),
                sup0[s], H, ALPHA)
            assert torch.equal(y3[s], y1) and torch.equal(sups3[s], sups1)
            assert torch.equal(last3[s], last1)
            if mode == "nsq":
                assert all(torch.equal(u[s], v)
                           for u, v in zip(carry3, carry1))
            else:
                assert carry3 is None and carry1 is None


def test_squelch_gate_refuses_other_devices_and_bad_inputs():
    rng = np.random.default_rng(64)
    a, b, x, thr, avg0, sup0 = _gate_case(rng, "nsq", (2,), 2, 30.0)
    m = [v.to("meta") for v in (a, b, x, thr, sup0)]
    with pytest.raises(ValueError, match="unsupported device"):
        L.squelch_gate("nsq", m[0], m[1], m[2], m[3],
                       tuple(v.to("meta") for v in avg0), m[4], H, ALPHA)
    with pytest.raises(ValueError, match="unsupported device"):
        L.squelch_gate("level", m[0], None, m[2], m[3], None, m[4], H, ALPHA)
    with pytest.raises(ValueError, match="mode"):
        L.squelch_gate("other", a, b, x, thr, avg0, sup0, H, ALPHA)
    with pytest.raises(ValueError, match="whole hold periods"):
        L.squelch_gate("nsq", a[..., :-4], b[..., :-4], x[..., :-4], thr,
                       avg0, sup0, H, ALPHA)
    with pytest.raises(ValueError, match="whole hold periods"):
        L.squelch_gate("level", a[..., :H // 2], None, x[..., :H // 2], thr,
                       None, sup0, H, ALPHA)
    with pytest.raises(TypeError, match="float32"):
        L.squelch_gate("nsq", a.double(), b, x, thr, avg0, sup0, H, ALPHA)
    with pytest.raises(TypeError, match="float32"):
        L.squelch_gate("level", a, None, x.double(), thr, None, sup0, H,
                       ALPHA)
    with pytest.raises(TypeError, match="float32"):
        L.squelch_gate("nsq", a, b[..., :H], x, thr, avg0, sup0, H, ALPHA)
    with pytest.raises(TypeError, match="avg0"):
        L.squelch_gate("nsq", a, b, x, thr, None, sup0, H, ALPHA)
    with pytest.raises(TypeError, match="float32"):
        L.squelch_gate("nsq", a, None, x, thr, avg0, sup0, H, ALPHA)


def test_sharded_squelch_routes_through_squelch_decide(tmp_path):
    """noise_squelch and level_squelch with `axis` on 2 gloo ranks, each
    its half of three 32768-sample blocks: every rank calls squelch_decide
    once a block and kind, never the fused squelch_gate, and its gated
    output and decision equal the unsharded call's (which goes through the
    fused wrapper)."""
    x, carrier = _demod_capture(65)
    T, level = 4 * H, 50.0
    nb = len(x) // T
    np.savez(tmp_path / "in.npz", x=x.reshape(nb, T),
             carrier=carrier.reshape(nb, T), level=level)
    spawn(sharded_squelch_job, 2, args=(str(tmp_path / "in.npz"),
                                        str(tmp_path)), device="cpu",
          timeout=300)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    cfg = TS.make_squelch_config()
    bank = TS.squelch_bank(cfg, "cpu")
    lvl = torch.tensor(level)
    for kind in ("nsq", "lsq"):
        st = TS.squelch_zero_state(cfg)
        before = L.squelch_gate.launches
        with one_thread():
            for b in range(nb):
                xb = _t(x[b * T:(b + 1) * T])
                if kind == "nsq":
                    y, st = TS.noise_squelch(xb, lvl, cfg, st, bank)
                else:
                    y, st = TS.level_squelch(
                        xb, _t(carrier[b * T:(b + 1) * T]), lvl, cfg, st)
                got = np.concatenate([z[f"{kind}_y"][b] for z in ranks])
                np.testing.assert_array_equal(got, y.numpy())
        assert L.squelch_gate.launches == before      # plain on the CPU
        for z in ranks:
            assert bool(z[f"{kind}_suppress"]) == bool(st.suppress)
            if kind == "nsq":
                want = np.stack([st.avg_high.numpy(), st.avg_low.numpy()])
                np.testing.assert_allclose(z["nsq_avg"], want, rtol=1e-4)
    for z in ranks:
        assert int(z["calls"]) == 2 * nb
    # the capture opens, closes on the noise and opens again
    zero = (np.concatenate([z["nsq_y"] for z in ranks], axis=1)
            .reshape(-1, H) == 0).all(1)
    assert zero.any() and not zero.all()


def test_spawn_runs_on_the_cards_unless_asked_for_the_cpu(tmp_path,
                                                          monkeypatch):
    """With no device the ranks go on the cards: without CUDA, spawn
    raises rank_device's error before any rank starts; device="cpu" runs
    them on the CPU."""
    spawn(rank_file_job, 2, args=(str(tmp_path),), device="cpu",
          timeout=300)
    assert [(tmp_path / f"rank{r}.txt").read_text() for r in range(2)] \
        == ["cpu", "cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn(rank_file_job, 2, args=(str(tmp_path / "none"),))
    assert not (tmp_path / "none").exists()
