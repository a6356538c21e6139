"""The port's fused front end (its plain version, which the wrapper runs for
CPU tensors) == the JAX production front end on the CPU.

The JAX reference is written out as receiver.py composes it: wire decode
and gains, the x[::64] subsample mean, DC correction, mix_lo, then
fir_decimate(÷12) with the composite 307-tap kernel.  Two consecutive
blocks for each wire format and LO sign, with non-zero DC and gains and a
stream index that crosses the rate modulus; no output is skipped.
Tolerance: atol 1e-5 on O(1) outputs — f32 sums of 307 taps in another
order plus sin/cos ulps in two libraries; the DC mean to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.models.receiver import Receiver as JReceiver
from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig
from sdrjfm_tpu.ops import blockops as JB
from sdrjfm_tpu_torch.kernels.frontend import (LEAD, THREADS, TILE,
                                               FrontendKernel,
                                               frontend, frontend_plain,
                                               nco_index_steps)
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu_torch.ops import blockops as TB

torch.set_num_threads(2)

BLOCK_FM = 4096
T = 12 * BLOCK_FM


def _wire(rng, fmt):
    if fmt == "c64":
        return (0.3 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
                ).astype(np.complex64)
    lo, hi, dt = {"i16": (-20000, 20000, np.int16), "u8": (0, 256, np.uint8),
                  "i8": (-128, 128, np.int8)}[fmt]
    return rng.integers(lo, hi, (T, 2)).astype(dt)


def _jax_front_end(x, fmt, carry, hc, lg, rg, rf_dc, lo, n0):
    """receiver.py:560-646 of the JAX package, flat path, dc_remove on."""
    if fmt == "c64":
        re, im = jnp.real(x), jnp.imag(x)
    else:
        v = x.astype(jnp.float32)
        if fmt == "i16":
            re, im = v[:, 0] * (1.0 / 32768.0), v[:, 1] * (1.0 / 32768.0)
        elif fmt == "u8":
            re = (v[:, 0] - 127.0) * (1.0 / 128.0)
            im = (v[:, 1] - 127.0) * (1.0 / 128.0)
        else:
            re, im = v[:, 0] * (1.0 / 128.0), v[:, 1] * (1.0 / 128.0)
    xg = jax.lax.complex(re * lg, im * rg)
    mean = jnp.mean(xg[::64])
    lim = JC.RF_DC_LIMIT
    corr = jax.lax.complex(jnp.clip(jnp.real(rf_dc), -lim, lim),
                           jnp.clip(jnp.imag(rf_dc), -lim, lim))
    xm = JB.mix_lo(xg - corr, lo, JC.INPUT_RATE, n0)
    v, new_carry = JB.fir_decimate(xm, hc, 12, carry)
    return v, new_carry, mean


@pytest.fixture(scope="module")
def taps():
    return JReceiver(JConfig(block_fm=BLOCK_FM)).k_decim12


@pytest.mark.parametrize("fmt", ["c64", "i16", "u8", "i8"])
@pytest.mark.parametrize("lo", [137_000, -250_000])
def test_plain_front_end_matches_jax_over_two_blocks(taps, fmt, lo):
    rng = np.random.default_rng(abs(lo) + len(fmt))
    lg, rg, rf_dc = np.float32(0.9), np.float32(1.1), np.complex64(0.003 - 0.02j)
    cj = jnp.zeros(306, jnp.complex64)
    ct = torch.zeros(306, dtype=torch.complex64)
    n0 = JC.INPUT_RATE - 1000                 # block 2 crosses the modulus
    for _ in range(2):
        x = _wire(rng, fmt)
        vj, cj, mj = _jax_front_end(
            jnp.asarray(x), fmt, cj, jnp.asarray(taps), lg, rg,
            jnp.asarray(rf_dc), jnp.asarray(lo, jnp.int32),
            jnp.asarray(n0, jnp.int32))
        launches = frontend.launches
        vt, ct, mt = frontend(
            torch.from_numpy(x), fmt, ct, torch.from_numpy(taps),
            torch.tensor(lg), torch.tensor(rg), torch.tensor(rf_dc),
            torch.tensor(lo, dtype=torch.int32),
            torch.tensor(n0, dtype=torch.int32), True)
        assert frontend.launches == launches      # CPU: no kernel launch
        assert vt.shape == (BLOCK_FM,) and vt.dtype == torch.complex64
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                                   atol=1e-6)
        assert abs(complex(mt) - complex(mj)) <= 1e-6
        n0 = (n0 + T) % JC.INPUT_RATE


def test_receiver_front_end_dc_servo_matches_jax():
    """Receiver.front_end (DC servo update included) against the JAX
    Receiver.front_end, i16 wire, two blocks."""
    rng = np.random.default_rng(11)
    jrx = JReceiver(JConfig(block_fm=BLOCK_FM, iq_format="i16", rds="off",
                            audio_filter_hz=15000))
    trx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, iq_format="i16",
                                  rds="off", audio_filter_hz=15000),
                   device="cpu")
    js, ts = jrx.init_state(), trx.init_state()
    js = js._replace(rf_dc=jnp.asarray(0.004 + 0.02j, jnp.complex64))
    ts = ts._replace(rf_dc=torch.tensor(0.004 + 0.02j, dtype=torch.complex64))
    jc = jrx.initial_controls()._replace(
        lo_freq_hz=jnp.asarray(-99_000, jnp.int32))
    tc = trx.initial_controls()._replace(
        lo_freq_hz=torch.tensor(-99_000, dtype=torch.int32))
    for _ in range(2):
        x = _wire(rng, "i16") + 300
        vj, (dj, _, t1j, _, _, _) = jrx.front_end(js, jc, jnp.asarray(x))
        vt, (dt, _, t1t, _, _, _) = trx.front_end(ts, tc, torch.from_numpy(x))
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                                   atol=1e-5)
        assert abs(complex(dt) - complex(dj)) <= 1e-7
        js = js._replace(rf_dc=dj, band1=t1j)
        ts = ts._replace(rf_dc=dt, band1=t1t)


def test_wrapper_counts_only_kernel_launches():
    k = FrontendKernel()
    x = torch.zeros(T, dtype=torch.complex64)
    z = lambda dt: torch.zeros((), dtype=dt)  # noqa: E731
    y, c, m = k(x, "c64", torch.zeros(306, dtype=torch.complex64),
                torch.zeros(307), z(torch.float32), z(torch.float32),
                z(torch.complex64), z(torch.int32), z(torch.int32), False)
    assert k.launches == 0 and m is None and y.shape == (BLOCK_FM,)
    # the plain version is the CPU path, identical to calling it directly
    y2, _, _ = frontend_plain(x, "c64", torch.zeros(306,
                                                    dtype=torch.complex64),
                              torch.zeros(307), z(torch.float32),
                              z(torch.float32), z(torch.complex64),
                              z(torch.int32), z(torch.int32), False)
    assert torch.equal(y, y2)


Q = JC.INPUT_RATE


@pytest.mark.parametrize("f", [0, 1, -1, 137_000, -250_000, 1_151_999, Q - 1])
@pytest.mark.parametrize("n0", [0, 12345, Q - 300, Q - 1])
def test_nco_index_steps_exact(f, n0):
    """The kernel's 32-bit NCO stepping == (f * (n0 + n)) mod q, for
    threads whose positions start in the carry, cross tile boundaries and
    the block's end, and cross the rate modulus."""
    for n_first in (-LEAD - 1, 12 * TILE - 300, T - 5 * THREADS - 3,
                    Q - n0 - 7):
        got = nco_index_steps(f, n0, Q, n_first, count=30)
        n = n_first + THREADS * np.arange(30)
        want = np.array([(f * (n0 + int(v))) % Q for v in n])
        np.testing.assert_array_equal(got, want)


# csrc/frontend.cu's shared-memory layout: J consecutive outputs per thread,
# PGROUPS phase groups, the window as S[p][c][u] for index 12*(J*u + c) + p
J, PGROUPS, NROW = 8, 6, 26
NU = (TILE + NROW - 2) // J + 1
PLANE = J * NU + 1
WIN, WSTAGE = 12 * TILE + LEAD, 12 * J * NU


def _tile_window(tile, T):
    """(first window sample, own range start, own range end) of a tile: the
    window starts LEAD samples early; the own ranges partition [0, T)."""
    own = 12 * TILE * tile
    return own - LEAD, own, min(own + 12 * TILE, T)


def _kernel_layout_fir(xm, carry, taps):
    """The kernel's tiling and polyphase register blocking, in numpy
    (float64): stage each tile's window into S, accumulate J outputs per
    thread over each phase group's phases, sum the groups."""
    T = len(xm)
    M = T // 12
    xp = np.concatenate([carry, xm]).astype(np.complex128)
    H = np.zeros((12, NROW))
    for p in range(12):
        for r in range(NROW):
            k = 306 - 12 * r - p
            H[p, r] = taps[k] if k >= 0 else 0.0
    y = np.zeros(-(-M // TILE) * TILE, np.complex128)
    g = np.arange(TILE // J)
    for tile in range(-(-M // TILE)):
        base, _, _ = _tile_window(tile, T)
        w = np.arange(WSTAGE)
        n = base + w
        ok = (w < WIN) & (n < T)
        val = np.where(ok, xp[np.clip(n, -306, T - 1) + 306], 0.0)
        S = np.full(12 * PLANE, np.nan, np.complex128)
        jj, p = w // 12, w % 12
        S[p * PLANE + (jj % J) * NU + jj // J] = val
        acc = np.zeros((PGROUPS, J, len(g)), np.complex128)
        for pg in range(PGROUPS):
            for p in range(pg * 12 // PGROUPS, (pg + 1) * 12 // PGROUPS):
                for i in range(J + NROW - 1):
                    x = S[p * PLANE + (i % J) * NU + g + i // J]
                    for c in range(J):
                        if 0 <= i - c < NROW:
                            acc[pg, c] += H[p, i - c] * x
        y[tile * TILE:(tile + 1) * TILE] = acc.sum(0).T.reshape(-1)
    return y[:M]


@pytest.mark.parametrize("blocks", [(12 * 1000,), (12 * 1024, 12 * 600)])
def test_kernel_tiling_matches_fir_decimate(taps, blocks):
    """Tile windows (LEAD samples early, from the carry for tile 0), a
    ragged last tile, the carry and the polyphase layout reproduce
    fir_decimate's alignment over consecutive blocks; the tiles' own
    ranges partition the block, so each carry sample has one writer."""
    rng = np.random.default_rng(len(blocks))
    carry = np.zeros(306, np.complex64)
    for T in blocks:
        xm = (rng.standard_normal(T) + 1j * rng.standard_normal(T)
              ).astype(np.complex64)
        want, new_carry = TB.fir_decimate(torch.from_numpy(xm),
                                          torch.from_numpy(taps), 12,
                                          torch.from_numpy(carry))
        got = _kernel_layout_fir(xm, carry, taps)
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)
        owns = [_tile_window(t, T)[1:] for t in range(-(-T // 12 // TILE))]
        assert owns[0][0] == 0 and owns[-1][1] == T
        assert all(a[1] == b[0] for a, b in zip(owns, owns[1:]))
        np.testing.assert_array_equal(new_carry.numpy(), xm[T - 306:])
        carry = xm[T - 306:]
