"""sdrjfm_tpu_torch.ops.blockops == sdrjfm_tpu.ops.blockops on the CPU.

Inputs come from a numpy seed and go through both packages; every block
primitive is also checked for split-block == whole-array stitching.
Tolerances: f32 convolutions and FFTs in two libraries, summed in another
order, agree to a few ulps of the output scale (rtol 1e-5 / atol 1e-5 for
O(1) signals); the integer NCO phase is bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.ops import blockops as JB
from sdrjfm_tpu.ops import design
from sdrjfm_tpu_torch.kernels.linrec import KERNEL_CHUNK, linrec_plain
from sdrjfm_tpu_torch.ops import blockops as TB

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-5

# jitted once: eager lax.associative_scan dispatches op by op
_j_ema = jax.jit(JB.ema_apply, static_argnums=1)
_j_runlength = jax.jit(JB.runlength_true)


def _c64(rng, n, scale=1.0):
    return (scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


class TestFIR:
    @pytest.mark.parametrize("complex_kernel", [False, True])
    def test_fir_apply_matches_jax(self, complex_kernel):
        rng = np.random.default_rng(0)
        x = _c64(rng, 4096)
        k = design.lowpass_sinc(45, 3000.0, 24000.0)
        if complex_kernel:
            k = design.bandpass_complex(45, 2000.0, 5000.0, 24000.0)
        k = k.astype(np.complex64 if complex_kernel else np.float32)
        carry = _c64(rng, 44)
        yj, cj = JB.fir_apply(jnp.asarray(x), jnp.asarray(k), jnp.asarray(carry))
        yt, ct = TB.fir_apply(_t(x), _t(k), _t(carry))
        _close(yt, yj)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))

    @pytest.mark.parametrize("factor,taps", [(12, 307), (8, 11), (4, 129)])
    def test_fir_decimate_matches_jax_and_stitches(self, factor, taps):
        rng = np.random.default_rng(factor)
        x = _c64(rng, 3 * 1536)
        k = design.lowpass_sinc(taps, 0.4 / factor, 1.0).astype(np.float32)
        z = np.zeros(taps - 1, np.complex64)
        yj, _ = JB.fir_decimate(jnp.asarray(x), jnp.asarray(k), factor,
                                jnp.asarray(z))
        yt, _ = TB.fir_decimate(_t(x), _t(k), factor, _t(z))
        _close(yt, yj)
        # three blocks with carries == the whole array
        carry, parts = _t(z), []
        for b in range(3):
            y, carry = TB.fir_decimate(_t(x[b * 1536:(b + 1) * 1536]), _t(k),
                                       factor, carry)
            parts.append(y)
        _close(torch.cat(parts), yt, rtol=0, atol=2e-6)


class TestFFTFilter:
    def test_overlap_save_complex_matches_jax_and_stitches(self):
        rng = np.random.default_rng(1)
        F, hop, T = 1024, 512, 2048
        H = design.fft_filter_response(
            design.lowpass_sinc(257, 0.1, 1.0), F).astype(np.complex64)
        x = _c64(rng, 2 * T)
        z = np.zeros(F - hop, np.complex64)
        yj, _ = JB.fft_filter_apply(jnp.asarray(x), jnp.asarray(H), hop,
                                    jnp.asarray(z))
        carry, parts = _t(z), []
        for b in range(2):
            y, carry = TB.fft_filter_apply(_t(x[b * T:(b + 1) * T]), _t(H),
                                           hop, carry)
            parts.append(y)
        _close(torch.cat(parts), yj)

    def test_multi_real_input_rfft_mirror_matches_jax(self):
        rng = np.random.default_rng(2)
        F, hop, T = 2048, 1024, 4096
        Hs = np.stack([
            design.fft_filter_response(design.bandpass_complex(
                769, 18500.0, 19500.0, 192000.0), F),
            design.fft_filter_response(design.bandpass_complex(
                769, 54600.0, 59400.0, 192000.0), F)]).astype(np.complex64)
        x = rng.standard_normal(2 * T).astype(np.float32)
        z = np.zeros(F - hop, np.complex64)
        yj, cj = JB.fft_filter_apply_multi(jnp.asarray(x), jnp.asarray(Hs),
                                           hop, jnp.asarray(z))
        carry, parts = _t(z), []
        for b in range(2):
            y, carry = TB.fft_filter_apply_multi(_t(x[b * T:(b + 1) * T]),
                                                 _t(Hs), hop, carry)
            parts.append(y)
        _close(torch.cat(parts, dim=1), yj)
        np.testing.assert_array_equal(carry.numpy(), np.asarray(cj))


class TestDelayRunlength:
    def test_delay_stitches(self):
        rng = np.random.default_rng(3)
        x = rng.standard_normal(1000).astype(np.float32)
        carry = torch.zeros(37)
        parts = []
        for b in range(4):
            y, carry = TB.delay_apply(_t(x[b * 250:(b + 1) * 250]), carry)
            parts.append(y)
        want = np.concatenate([np.zeros(37, np.float32), x])[:1000]
        np.testing.assert_array_equal(torch.cat(parts).numpy(), want)

    def test_runlength_matches_jax_over_blocks(self):
        rng = np.random.default_rng(4)
        flags = rng.random(3000) > 0.1
        flags[:400] = True
        rj = jnp.asarray(5, jnp.int32)
        rt = torch.tensor(5, dtype=torch.int32)
        for b in range(3):
            f = flags[b * 1000:(b + 1) * 1000]
            yj, rj = _j_runlength(jnp.asarray(f), rj)
            yt, rt = TB.runlength_true(_t(f), rt)
            np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        assert int(rt) == int(rj)


class TestNCO:
    @pytest.mark.parametrize("freq", [0, 137_000, -250_000, -1, 1_151_999,
                                      -2_303_999, 2_000_000_000, -7_777_777])
    @pytest.mark.parametrize("n0", [0, 12345, 2_304_000 - 1, 2_304_000 - 300])
    def test_oscillator_phases_bit_exact(self, freq, n0):
        count = 12 * 1024
        pj = np.asarray(JB.oscillator_phases(jnp.asarray(freq, jnp.int32),
                                             JC.INPUT_RATE,
                                             jnp.asarray(n0, jnp.int32),
                                             count))
        pt = TB.oscillator_phases(torch.tensor(freq, dtype=torch.int32),
                                  JC.INPUT_RATE,
                                  torch.tensor(n0, dtype=torch.int32), count)
        np.testing.assert_array_equal(pt.numpy(), pj)

    def test_mix_lo_matches_jax(self):
        rng = np.random.default_rng(5)
        x = _c64(rng, 24576)
        yj = JB.mix_lo(jnp.asarray(x), jnp.asarray(-250_000, jnp.int32),
                       JC.INPUT_RATE, jnp.asarray(2_303_000, jnp.int32))
        yt = TB.mix_lo(_t(x), torch.tensor(-250_000, dtype=torch.int32),
                       JC.INPUT_RATE, torch.tensor(2_303_000,
                                                   dtype=torch.int32))
        _close(yt, yj, rtol=0, atol=3e-6)


class TestScan:
    @pytest.mark.parametrize("alpha", [JC.CARRIER_ALPHA, JC.FM_DC_ALPHA,
                                       JC.PILOT_LOCK_ALPHA])
    def test_plain_scan_matches_linrec_apply_at_path_length(self, alpha):
        """T=131072 at the path's decays: the chunked plain scan stays
        finite (no g^-n), is within 5e-6 of the output scale of a float64
        recurrence, and within 5e-5 of lax.associative_scan, whose own f32
        tree is the less accurate of the two at g = 1 - 1e-4."""
        from scipy.signal import lfilter
        rng = np.random.default_rng(6)
        x = (1.0 + 0.2 * rng.standard_normal(131072)).astype(np.float32)
        yj, lj = _j_ema(jnp.asarray(x), alpha, jnp.asarray(0.3))
        yt, lt = TB.ema_apply(_t(x), alpha, torch.tensor(0.3))
        assert torch.isfinite(yt).all()
        g = np.float64(np.float32(1.0 - alpha))
        d = (np.float32(alpha) * x).astype(np.float64)
        exact, _ = lfilter([1.0], [1.0, -g], d, zi=[g * np.float32(0.3)])
        scale = float(np.abs(exact).max())
        _close(yt, exact, rtol=0, atol=5e-6 * scale)
        _close(yt, yj, rtol=0, atol=5e-5 * scale)
        assert abs(float(lt) - float(lj)) <= 5e-5 * scale

    def test_plain_scan_rows_and_stitching(self):
        rng = np.random.default_rng(7)
        d = rng.standard_normal((3, 5000)).astype(np.float32) * 1e-3
        g = [1 - 1e-3, 1 - 1e-4, 0.5]
        y0 = torch.tensor([0.1, -0.2, 0.3])
        y, last = linrec_plain(_t(d), g, y0)
        want = np.zeros_like(d, dtype=np.float64)
        prev = y0.numpy().astype(np.float64)
        for n in range(d.shape[1]):
            prev = np.float32(g).astype(np.float64) * prev + d[:, n]
            want[:, n] = prev
        _close(y, want, rtol=0, atol=1e-6)
        # two halves with the carry == the whole
        y1, l1 = linrec_plain(_t(d[:, :2500]), g, y0)
        y2, _ = linrec_plain(_t(d[:, 2500:]), g, l1)
        _close(torch.cat([y1, y2], dim=1), y, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("T,g", [
        (2 * KERNEL_CHUNK + 77, [1 - 1e-3, 0.5]),   # not a multiple
        (100, [1 - 1e-4, 0.9]),                     # shorter than one chunk
        (KERNEL_CHUNK + 1, [1.0, 1 - 1e-3]),        # g = 1: a plain sum
    ])
    def test_plain_scan_against_float64_at_kernel_chunk_edges(self, T, g):
        """Row lengths around the kernel's chunk, and g = 1.0, against a
        float64 recurrence within 1e-6 of the output scale."""
        from scipy.signal import lfilter
        rng = np.random.default_rng(T)
        d = (1e-2 * rng.standard_normal((2, T))).astype(np.float32)
        y0 = np.array([0.4, -0.2], np.float32)
        y, last = linrec_plain(_t(d), g, _t(y0))
        gd = np.float32(g).astype(np.float64)
        want = np.stack([lfilter([1.0], [1.0, -gr], dr, zi=[gr * v])[0]
                         for gr, dr, v in zip(gd, d.astype(np.float64),
                                              y0.astype(np.float64))])
        scale = float(np.abs(want).max())
        _close(y, want, rtol=0, atol=1e-6 * scale)
        _close(last, want[:, -1], rtol=0, atol=1e-6 * scale)


class TestOptionPrimitives:
    """The primitives of the receiver's options: the -m interpolator, the
    native-rate map, the complex deemphasis EMA, wrap_pi and the complex
    scan (pole bank) of the biquad cascades."""

    @pytest.mark.parametrize("factor", [4, 2])
    def test_fir_interpolate_matches_jax_split(self, factor):
        rng = np.random.default_rng(11)
        x = _c64(rng, 2048, 0.5)
        k = design.polyphase_resampler_kernel(factor).astype(np.float32)
        phases = (len(k) + factor - 1) // factor
        carry0 = np.zeros(phases - 1, np.complex64)
        yj, cj = JB.fir_interpolate(jnp.asarray(x), jnp.asarray(k), factor,
                                    jnp.asarray(carry0))
        y1, c1 = TB.fir_interpolate(_t(x[:1024]), _t(k), factor, _t(carry0))
        y2, c2 = TB.fir_interpolate(_t(x[1024:]), _t(k), factor, c1)
        _close(torch.cat([y1, y2]), yj)
        np.testing.assert_array_equal(c2.numpy(), np.asarray(cj))

    @pytest.mark.parametrize("num,den", [(625, 576), (25, 24), (1, 1)])
    def test_rate_map_linear_matches_jax_split(self, num, den):
        """625/576 is airspy's 2.5 MS/s, 25/24 rtl-sdr's 2.4 MS/s; at 1/1
        the map is the stream delayed by one sample (the carry).  Exact:
        both packages lerp in f32 at the same integer positions."""
        rng = np.random.default_rng(12)
        n_out = 576 * 8
        T_in = n_out * num // den
        x = _c64(rng, 2 * T_in)
        carry = np.complex64(0.25 - 0.5j)
        yj = []
        cj = jnp.asarray(carry)
        ct = torch.tensor(carry)
        yt = []
        for b in range(2):
            blk = x[b * T_in:(b + 1) * T_in]
            a, cj = JB.rate_map_linear(jnp.asarray(blk), num, den, n_out, cj)
            t, ct = TB.rate_map_linear(_t(blk), num, den, n_out, ct)
            yj.append(np.asarray(a))
            yt.append(t.numpy())
        np.testing.assert_array_equal(np.concatenate(yt), np.concatenate(yj))
        assert complex(ct) == complex(cj)
        if num == den:
            np.testing.assert_array_equal(np.concatenate(yt)[1:], x[:-1])

    def test_ema_complex_matches_jax_and_split(self):
        rng = np.random.default_rng(13)
        x = _c64(rng, 8192)
        a = JC.deemphasis_alpha(50.0, JC.FM_RATE)
        y0 = np.complex64(0.1 + 0.2j)
        yj, lj = _j_ema(jnp.asarray(x), a, jnp.asarray(y0))
        y1, l1 = TB.ema_apply_complex(_t(x[:4096]), a, torch.tensor(y0))
        y2, l2 = TB.ema_apply_complex(_t(x[4096:]), a, l1)
        # two f32 scans (chunked matmul vs associative scan) of an O(1)
        # stream: a few ulps of the output scale
        _close(torch.cat([y1, y2]), yj, rtol=5e-5, atol=5e-6)
        _close(l2, lj, rtol=5e-5, atol=5e-6)
        yi, li = TB.ema_apply_complex(_t(x), 1.0, torch.tensor(y0))
        np.testing.assert_array_equal(yi.numpy(), x)     # deemphasis off

    def test_wrap_pi_matches_jax(self):
        x = np.linspace(-20, 20, 1001).astype(np.float32)
        np.testing.assert_array_equal(TB.wrap_pi(_t(x)).numpy(),
                                      np.asarray(JB.wrap_pi(jnp.asarray(x))))

    @pytest.mark.parametrize("T", [KERNEL_CHUNK * 3 + 5, 100])
    def test_complex_scan_plain_vs_float64(self, T):
        """The plain complex scan (the pole bank's reference on the card)
        within 2e-6 of the scale of a float64 recurrence, for decays near
        the unit circle like the squelch's poles."""
        from scipy.signal import lfilter
        rng = np.random.default_rng(14)
        g = np.asarray([0.98 * np.exp(0.3j), 0.995 * np.exp(-1.2j), 0.5 + 0j],
                       np.complex64)
        d = _c64(rng, 3 * T).reshape(3, T)
        y0 = _c64(rng, 3)
        y, last = linrec_plain(_t(d), list(g), _t(y0))
        for r in range(3):
            gr = np.complex128(g[r])
            ref = lfilter([1.0], [1.0, -gr], d[r].astype(np.complex128),
                          zi=[gr * np.complex128(y0[r])])[0]
            scale = np.abs(ref).max()
            assert np.abs(y[r].numpy() - ref).max() <= 2e-6 * scale
            assert abs(complex(last[r]) - ref[-1]) <= 2e-6 * scale
