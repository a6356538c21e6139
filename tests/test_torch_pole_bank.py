"""Kernel A's host side (the complex pole bank, kernels/linrec.py), on the
CPU.

- `pole_bank_plain` against the JAX package's pole part of iir_apply
  (sdrjfm_tpu/ops/blockops.py:376-382: jax.vmap of linrec_apply over the
  poles, then Re sum_p r_p w_p) and against the float64 recurrence
  (scipy.signal.lfilter), at T = 1, POLE_CHUNK +- 1 and 131072, with one
  and two banks and fewer poles than POLE_MAXP.  Tolerance: 1e-6 of the
  scale max_n sum_p |r_p| |w_p[n]| (the residues' terms cancel), as
  chip_smoke.py holds the kernel (POLE_RTOL).
- The kernel's per-pole table (`pole_table`) against float64, and a numpy
  emulation of the kernel's decomposition — segments of POLE_SEG samples,
  the warp scan, the walk over the warps, the look-back over chunks (every
  predecessor an aggregate, so the POLE_LOOK-chunk windows are used) and the
  correction y = y_loc + Re sum_p (r g^(i+1)) C — that reads only the
  table, against lfilter.
- The launch geometry (`pole_grid`) and the sizes the CUDA source
  declares.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from sdrjfm_tpu.ops import blockops as JB
from sdrjfm_tpu_torch.kernels import linrec as L
from sdrjfm_tpu_torch.ops import design
from sdrjfm_tpu_torch.ops.blockops import IIRSpec
from sdrjfm_tpu_torch.ops.squelch import make_squelch_config

torch.set_num_threads(2)
POLE_RTOL = 1e-6


def _specs(which):
    """The squelch's two 10-pole banks, one of them, or a 10-pole bank
    beside a 4-pole one (padded with zero poles)."""
    sq = make_squelch_config()
    if which == "mixed":
        bp = IIRSpec(design.bandpass_butter_sos(2, 1000.0, 5000.0, 192000))
        assert len(bp.poles) == 4
        return [sq.lp, bp]
    return {"squelch": [sq.hp, sq.lp], "hp": [sq.hp]}[which]


def _inputs(specs, T, seed):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((len(specs), T))).astype(np.float32)
    w0 = [(0.05 * (rng.standard_normal(len(s.poles))
                   + 1j * rng.standard_normal(len(s.poles)))
           ).astype(np.complex64) for s in specs]
    return x, w0


def _f64(spec, x, w0):
    """(y, wT, scale) of one bank by the float64 recurrence."""
    g = spec.poles.astype(np.complex128)
    xd = x.astype(np.float64).astype(np.complex128)
    ws = np.stack([lfilter([1.0], [1.0, -gp], xd, zi=[gp * w0[p]])[0]
                   for p, gp in enumerate(g)])
    r = spec.residues.astype(np.complex128)[:, None]
    return (np.real((r * ws).sum(0)), ws[:, -1],
            float((np.abs(r) * np.abs(ws)).sum(0).max()))


def _jax_pole_part(spec, x, w0):
    """The pole part of JAX iir_apply (blockops.py:376-382)."""
    xc = jnp.asarray(x).astype(jnp.complex64)
    ys, wT = jax.vmap(lambda w, p: JB.linrec_apply(xc, p, w))(
        jnp.asarray(w0), jnp.asarray(spec.poles))
    y = jnp.real(jnp.sum(jnp.asarray(spec.residues)[:, None] * ys, axis=0))
    return np.asarray(y), np.asarray(wT)


@pytest.mark.parametrize("which", ["squelch", "hp", "mixed"])
@pytest.mark.parametrize("T", [1, L.POLE_CHUNK - 1, L.POLE_CHUNK + 1,
                               131072])
def test_pole_bank_plain_matches_jax_and_float64(which, T):
    specs = _specs(which)
    x, w0 = _inputs(specs, T, T + len(which))
    bank = L.pole_bank_constants(specs, "cpu")
    assert bank.poles.shape[1] == max(len(s.poles) for s in specs) < \
        L.POLE_MAXP
    P = bank.poles.shape[1]
    y, wT = L.pole_bank(torch.from_numpy(x), bank, torch.stack(
        [torch.nn.functional.pad(torch.from_numpy(w), (0, P - len(w)))
         for w in w0]))
    for b, spec in enumerate(specs):
        ref, wref, scale = _f64(spec, x[b], w0[b])
        jy, jw = _jax_pole_part(spec, x[b], w0[b])
        wT_b = wT[b, :len(spec.poles)]
        np.testing.assert_allclose(y[b].numpy(), ref, rtol=0,
                                   atol=POLE_RTOL * scale)
        np.testing.assert_allclose(y[b].numpy(), jy, rtol=0,
                                   atol=POLE_RTOL * scale)
        wscale = float(np.abs(wref).max())
        np.testing.assert_allclose(wT_b.numpy(), wref, rtol=0,
                                   atol=POLE_RTOL * 10 * wscale)
        np.testing.assert_allclose(wT_b.numpy(), jw, rtol=0,
                                   atol=POLE_RTOL * 10 * wscale)


def test_pole_bank_on_the_cpu_launches_nothing():
    specs = _specs("mixed")
    x, w0 = _inputs(specs, 300, 1)
    before = L.pole_bank.launches
    bank = L.pole_bank_constants(specs, "cpu")
    P = bank.poles.shape[1]
    w = torch.stack([torch.nn.functional.pad(torch.from_numpy(v),
                                             (0, P - len(v))) for v in w0])
    y, wT = L.pole_bank(torch.from_numpy(x), bank, w)
    assert L.pole_bank.launches == before
    assert wT.shape == (len(specs), P)
    with pytest.raises(ValueError):
        L.pole_bank(torch.from_numpy(x), bank, w[:1])


# --------------------------------------------------------------------------
# the kernel's table and its decomposition
# --------------------------------------------------------------------------


def test_pole_table_against_float64():
    specs = _specs("mixed")
    bank = L.pole_bank_constants(specs, "cpu")
    tab = bank.table.numpy()
    assert tab.shape == (2, bank.poles.shape[1], L.POLE_NTAB)
    o = L.pole_table_offsets()
    S, C = L.POLE_SEG, L.POLE_CHUNK
    for b, spec in enumerate(specs):
        for p, (g, r) in enumerate(zip(spec.poles.astype(np.complex128),
                                       spec.residues.astype(np.complex128))):
            want = {"g": [g], "r": [r],
                    "rg": [r * g ** (i + 1) for i in range(S)],
                    "gi": [g ** (i + 1) for i in range(S)],
                    "gs": [g ** (S << k) for k in range(5)],
                    "gl": [g ** (S * l) for l in range(32)],
                    "gw": [g ** (S * 32)],
                    "gc": [g ** (C * m) for m in range(L.POLE_LOOK + 1)]}
            for name, n in L.POLE_TABLE:
                got = tab[b, p, o[name]:o[name] + n].astype(np.complex128)
                w = np.asarray(want[name])
                np.testing.assert_allclose(got, w, rtol=2 ** -23, atol=1e-37)
        # padded poles: zero pole, zero residue
        for p in range(len(spec.poles), bank.poles.shape[1]):
            assert not tab[b, p, o["g"]]
            assert not tab[b, p, o["rg"]:o["gi"]].any()
    assert sum(n for _, n in L.POLE_TABLE) == L.POLE_NTAB


def _emulate(x, tab, w0):
    """Kernel A's decomposition in complex128 on one bank, reading only
    the table (float64 arithmetic on the complex64 entries)."""
    o = L.pole_table_offsets()
    S, C, LK = L.POLE_SEG, L.POLE_CHUNK, L.POLE_LOOK
    threads = C // S
    warps = threads // 32
    T = x.shape[0]
    nch, _ = L.pole_grid(1, T)
    xs = np.zeros(nch * C)
    xs[:T] = x
    xs = xs.reshape(nch, threads, S)
    y = np.zeros((nch, threads, S))
    wT = []
    for p in range(tab.shape[0]):
        t = tab[p].astype(np.complex128)
        g, r = t[o["g"]], t[o["r"]]
        a = np.zeros((nch, threads), np.complex128)
        aloc = np.zeros((nch, threads, S), np.complex128)
        for i in range(S):
            a = g * a + xs[:, :, i]
            aloc[:, :, i] = a
            y[:, :, i] += np.real(r * a)
        W = a.reshape(nch, warps, 32).copy()
        for k in range(5):
            o_ = 1 << k
            up = np.zeros_like(W)
            up[:, :, o_:] = W[:, :, :-o_]
            W = np.where(np.arange(32) >= o_, t[o["gs"] + k] * up + W, W)
        xl = np.zeros_like(W)
        xl[:, :, 1:] = W[:, :, :-1]
        ends = W[:, :, 31]
        agg = np.zeros(nch, np.complex128)
        for w in range(warps):
            agg = t[o["gw"]] * agg + ends[:, w]

        def walk(E, c):
            before = np.zeros(warps, np.complex128)
            for w in range(warps):
                before[w] = E
                E = t[o["gw"]] * E + ends[c, w]
            return before, E

        ew = np.zeros((nch, warps), np.complex128)
        pfx0 = None
        for c in range(nch):
            if c == 0:
                E = w0[p]
            else:
                # every predecessor but chunk 0 shows its aggregate
                E = 0.0
                for j in range(c):
                    wgt = t[o["gc"] + j % LK] * t[o["gc"] + LK] ** (j // LK)
                    E += wgt * (pfx0 if j == c - 1 else agg[c - 1 - j])
            ew[c], I = walk(E, c)
            if c == 0:
                pfx0 = I
        Cth = xl + t[o["gl"]:o["gl"] + 32] * ew[:, :, None]
        Cth = Cth.reshape(nch, threads)
        y += np.real(t[o["rg"]:o["rg"] + S][None, None, :] * Cth[:, :, None])
        n = T - 1
        c, th, i = n // C, (n % C) // S, n % S
        wT.append(aloc[c, th, i] + t[o["gi"] + i] * Cth[c, th])
    return y.reshape(-1)[:T], np.asarray(wT)


@pytest.mark.parametrize("T", [1, L.POLE_CHUNK, L.POLE_CHUNK + 1, 131072,
                               (L.POLE_LOOK + 8) * L.POLE_CHUNK + 1])
@pytest.mark.parametrize("b", [0, 1])
def test_kernel_decomposition_from_the_table_matches_float64(T, b):
    specs = _specs("squelch")
    x, w0 = _inputs(specs, T, 3 * T + b)
    tab = L.pole_bank_constants(specs, "cpu").table.numpy()[b]
    y, wT = _emulate(x[b].astype(np.float64), tab,
                     w0[b].astype(np.complex128))
    ref, wref, scale = _f64(specs[b], x[b], w0[b])
    np.testing.assert_allclose(y, ref, rtol=0, atol=POLE_RTOL * scale)
    np.testing.assert_allclose(wT, wref, rtol=0,
                               atol=POLE_RTOL * float(np.abs(wref).max()))


@pytest.mark.parametrize("B,T,nch", [(1, 1, 1), (2, L.POLE_CHUNK - 1, 1),
                                     (2, L.POLE_CHUNK, 1),
                                     (2, L.POLE_CHUNK + 1, 2),
                                     (2, 131072, 131072 // L.POLE_CHUNK),
                                     (3, 1000, 1)])
def test_pole_grid(B, T, nch):
    assert L.pole_grid(B, T) == (nch, B * nch)
    if T == 131072:      # one look-back step spans the squelch's row
        assert nch <= L.POLE_LOOK + 1
    assert (nch - 1) * L.POLE_CHUNK < T <= nch * L.POLE_CHUNK


def test_pole_grid_refuses_empty_shapes():
    for B, T in ((0, 5), (1, 0)):
        with pytest.raises(ValueError):
            L.pole_grid(B, T)


def test_csrc_declares_the_wrappers_geometry():
    """The sizes and table offsets csrc/linrec.cu declares are the
    wrapper's (the library is checked again when it loads on the card)."""
    src = (Path(L.__file__).resolve().parent.parent / "csrc" /
           "linrec.cu").read_text()
    part = src[src.index("namespace poles {"):]
    const = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", part):
        const[name] = eval(expr, {}, dict(const))
    o = L.pole_table_offsets()
    assert (const["SEG"], const["CHUNK"], const["MAXP"], const["LOOK"],
            const["NTAB"]) == (L.POLE_SEG, L.POLE_CHUNK, L.POLE_MAXP,
                               L.POLE_LOOK, L.POLE_NTAB)
    for name in o:
        assert const["T_" + name.upper()] == o[name], name
