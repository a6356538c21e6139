"""The host side of RDS decoder 3's staged kernels (kernel B3: decoder 1's
Costas stage, then the clock stage), on the CPU.

- The clock phase chain: the compare-and-subtract wrap equals np.fmod bit
  for bit from phases in [0, 2 pi), and `clock_phases` equals JAX's
  jnp.mod chain bit for bit from any start.
- The segmented integrate-and-dump equals the sequential host loop it
  replaced bit for bit (emits, bits, the tail's integrator, prev_bit), and
  the whole plain decoder 3 equals a sequential reference (every sum of
  the clock and the integrator in sample order, the full lowpass) bit for
  bit, with and without a resync, for ragged T and a bit capacity that
  overflows.
- The lowpass outputs and ring positions the clock stage writes, taken
  from the packed state, match JAX's next sync_buf, lp_buf and p; the
  state runs the two stages read lie where the kernels read them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.io.synth import rds_baseband
from sdrjfm_tpu.rds import encode
from sdrjfm_tpu.rds import scan_decoders as JSD
from sdrjfm_tpu_torch import convert
from sdrjfm_tpu_torch.rds import scan_decoders as SD

torch.set_num_threads(2)
F = np.float32


@pytest.fixture(scope="module")
def baseband24k():
    syms = encode.differential_encode(encode.make_bitstream(
        pi=0x1234, station="SCANDEC ", repeats=2))
    n = int(2.0 * JC.RDS_RATE)
    rng = np.random.default_rng(5)
    bb = rds_baseband(syms, n, JC.RDS_RATE) * np.exp(1j * 0.4)
    bb = bb + 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return bb.astype(np.complex64)


# --------------------------------------------------------------------------
# the clock phase chain
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_wrap_step_is_fmod_over_long_chains(seed):
    """200 chains of 4000 steps from random phases in [0, 2 pi): the
    compare-and-subtract equals np.fmod(ph + OMEGA, TWO_PI) at every step,
    vectorised as the kernel's thread 0 runs it and through SD.wrap_step."""
    rng = np.random.default_rng(seed)
    ph = (rng.random(200) * float(SD.TWO_PI)).astype(F)
    ph = np.minimum(ph, np.nextafter(SD.TWO_PI, F(0)))
    for _ in range(4000):
        x = ph + SD.OMEGA
        ref = np.fmod(x, SD.TWO_PI)
        fast = np.where(x >= SD.TWO_PI, x - SD.TWO_PI, x)
        np.testing.assert_array_equal(fast.view(np.int32),
                                      ref.view(np.int32))
        ph = ref
    for x in (ph + SD.OMEGA)[:50]:
        assert SD.wrap_step(x) == np.fmod(x, SD.TWO_PI)


def _jax_phase_chain(ph0, T):
    """JAX decoder3_block's chain: ph = jnp.mod(ph + omega, 2 pi)."""
    omega = 2.0 * jnp.pi * JC.RDS_BITCLK_HZ / JC.RDS_RATE

    def step(ph, _):
        return jnp.mod(ph + omega, 2.0 * jnp.pi), ph
    last, seq = jax.lax.scan(step, jnp.float32(ph0), None, length=T)
    return np.concatenate([np.asarray(seq), np.asarray(last)[None]])


@pytest.mark.parametrize("ph0", [0.0, 1e-30, 3.0, float(SD.TWO_PI) - 1e-6,
                                 float(SD.TWO_PI), -0.3, -7.0, 100.0])
def test_clock_phases_match_jax_chain(ph0):
    """From in-range starts, 2 pi itself, negative and large ones (the
    first step takes jnp.mod's path there)."""
    got = SD.clock_phases(F(ph0), 3000)
    want = _jax_phase_chain(ph0, 3000)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# --------------------------------------------------------------------------
# the integrate-and-dump
# --------------------------------------------------------------------------


def _host_loop(clk, v, integ, prev_clk, prev_bit):
    """The sequential loop the segmented form replaced (float32 scalars)."""
    T = len(clk)
    emit = np.zeros(T, bool)
    bits = np.zeros(T, bool)
    integ, prev_clk = F(integ), F(prev_clk)
    for k in range(T):
        integ = integ + clk[k] * v[k]
        the_bit = bool(integ >= 0)
        if prev_clk <= 0 and clk[k] > 0:
            emit[k] = True
            bits[k] = the_bit ^ prev_bit
            prev_bit = the_bit
            integ = F(0.0)
        prev_clk = clk[k]
    return emit, bits, integ, prev_bit


def _check_segmented(clk, v, integ0, prev_clk, prev_bit):
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt)  # noqa: E731
    emit, bit, tail, after = SD.integrate_and_dump(
        torch.from_numpy(clk), torch.from_numpy(v), t(integ0), t(prev_clk),
        t(prev_bit, torch.bool))
    e, b, integ, pb = _host_loop(clk, v, integ0, prev_clk, prev_bit)
    np.testing.assert_array_equal(emit.numpy(), e)
    np.testing.assert_array_equal(bit.numpy(), b)
    assert tail.numpy().view(np.int32) == F(integ).view(np.int32)
    assert bool(after) == pb
    return int(e.sum())


@pytest.mark.parametrize("prev_bit", [False, True])
@pytest.mark.parametrize("T", [1, 7, 19, 21, 1023, 1024, 1025, 4097, 16384])
def test_integrate_and_dump_matches_host_loop(T, prev_bit):
    rng = np.random.default_rng(T + 7 * prev_bit)
    ph = SD.clock_phases(F(rng.random() * float(SD.TWO_PI)), T)
    clk = np.sin(ph[:T])
    v = (4.0 * rng.standard_normal(T)).astype(F)
    prev_clk = F(rng.standard_normal())
    n = _check_segmented(clk, v, F(rng.standard_normal()), prev_clk,
                         prev_bit)
    if T >= 1023:
        assert abs(n - T / SD.SPS) < 2


def test_integrate_and_dump_without_an_emit():
    """A block on the clock's positive half: no emit, the whole block is
    the tail, summed from the carried integrator; prev_bit is kept."""
    ph = SD.clock_phases(F(0.1), 9)
    clk = np.sin(ph[:9])
    assert (clk > 0).all()
    v = np.linspace(-3, 2, 9).astype(F)
    assert _check_segmented(clk, v, F(0.75), F(0.1), True) == 0


def test_integrate_and_dump_emit_at_the_first_sample():
    """prev_clk <= 0 < clk[0]: the first segment is sample 0 alone."""
    ph = SD.clock_phases(F(0.05), 40)
    clk = np.sin(ph[:40])
    v = np.ones(40, F)
    assert _check_segmented(clk, v, F(-2.0), F(-0.01), False) >= 2


# --------------------------------------------------------------------------
# the whole plain decoder 3 against a sequential reference
# --------------------------------------------------------------------------


def _decoder3_sequential(z, cfg, state, cap):
    """Decoder 3 with the full lowpass (fir_in_order over every sample),
    the clock phase by np.fmod and the integrate-and-dump as one host loop
    (the form the kernel's stages replaced); clk from the same phases."""
    n = cfg.symbol_ceiling
    rr, ri, freq, phase = SD._costas(z.real.numpy(), z.imag.numpy(),
                                     state.costas.freq.numpy(),
                                     state.costas.phase.numpy(),
                                     1.0 / 16.0, 0.02 / 16.0)
    r = torch.complex(torch.from_numpy(rr), torch.from_numpy(ri))
    v = r.real * 4.0
    T = v.shape[0]
    filt, lp_buf = SD.fir_in_order(state.lp_buf, v,
                                   torch.from_numpy(cfg.lp21))
    p0 = int(state.p)
    buf0 = state.sync_buf.clone()
    buf0[p0] = filt[0]
    ph = F(state.bit_clk_phase.numpy())
    if bool(state.need_resync):
        ph = F(SD.sync_bit_clock(buf0, torch.tensor((p0 + 1) % n),
                                 cfg).numpy())
    sync_buf = state.sync_buf.clone()
    for k in range(T):
        sync_buf[(p0 + k) % n] = filt[k]
    phs = np.empty(T + 1, F)
    phs[0] = ph
    for k in range(T):
        phs[k + 1] = np.fmod(phs[k] + SD.OMEGA, SD.TWO_PI)
    clk = np.sin(phs[:T])
    emit, bits, integ, prev_bit = _host_loop(
        clk, v.numpy(), state.bit_integrator.numpy(),
        state.prev_clk.numpy(), bool(state.prev_bit))
    iq = r * 4.0
    f = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt)  # noqa: E731
    new = SD.Decoder3State(SD.CostasState(f(freq), f(phase)), lp_buf,
                           sync_buf, torch.tensor((p0 + T) % n,
                                                  dtype=torch.int32),
                           f(integ), f(phs[T]), f(clk[-1]),
                           f(prev_bit, torch.bool), f(False, torch.bool))
    return (*SD._compact(torch.from_numpy(bits), torch.from_numpy(emit), iq,
                         cap), iq, new)


@pytest.fixture(scope="module")
def warm_state3(baseband24k):
    cfg = SD.make_decoder3_config()
    st = SD.decoder3_plain(torch.from_numpy(baseband24k[:4800]), cfg,
                           SD.decoder3_zero_state(cfg), 300)[4]
    return cfg, st


@pytest.mark.parametrize("resync", [False, True])
@pytest.mark.parametrize("T,cap", [(1, 4), (15, 4), (21, 4), (1025, 60),
                                   (16384, 900), (2000, 40)])
def test_plain_decoder3_matches_sequential_reference(baseband24k, warm_state3,
                                                     T, cap, resync):
    """Bit for bit: bits, count (also past an overflowing cap: 2000
    samples emit ~99 bits into 40 slots), points, the iq stream and every
    state field."""
    cfg, st = warm_state3
    st = st._replace(need_resync=torch.tensor(resync))
    z = torch.from_numpy(baseband24k[4800:4800 + T])
    got = SD.decoder3_plain(z, cfg, st, cap, want_iq=True)
    want = _decoder3_sequential(z, cfg, st, cap)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    for a, b in zip(SD._leaves(got[4]), SD._leaves(want[4])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if T == 2000:
        assert int(got[1]) > cap


# --------------------------------------------------------------------------
# the clock stage's reads and writes in the packed state
# --------------------------------------------------------------------------


def test_state_runs_are_what_the_decoder3_stages_read():
    cfg = SD.make_decoder3_config()
    st = SD.decoder3_zero_state(cfg)
    offs = SD.state_offsets(st)
    K, N = len(cfg.lp21), cfg.symbol_ceiling
    assert SD.run_offset(offs, SD.COSTAS_RUN) == (0, 2)
    assert SD.run_offset(offs, SD.CLOCK3_RUN) == (2, K - 1 + N + 6)
    assert offs["lp_buf"] == (2, K - 1)
    assert offs["sync_buf"] == (2 + K - 1, N)
    assert offs["need_resync"][0] + 1 == SD.pack_state(st).numel()
    # the constant block: the head's Costas gains are decoder 1's, then
    # the sizes the clock stage reads, the taps and the fold index
    co = SD.const_offsets(3, cfg)
    block = SD._const_block(3, cfg)
    block1 = SD._const_block(1, SD.make_decoder1_config())
    np.testing.assert_array_equal(block[:2], block1[:2])
    assert list(block[co["sizes"]:co["sizes"] + 3]) == [
        K, N, int(np.floor(JC.RDS_RATE / JC.RDS_BITCLK_HZ))]
    assert co["fold"] == co["lp21"] + K


def test_decoder3_runs_in_two_stages():
    assert SD.STAGES[3] == ("costas", "clock")
    assert set(SD.decoder3_scan.stage_launches) == {"costas", "clock"}
    cfg = SD.make_decoder3_config()
    z = torch.zeros(64, dtype=torch.complex64)
    with pytest.raises(ValueError, match="unsupported device"):
        SD.decoder3_scan.plan(z, cfg, SD.decoder3_zero_state(cfg), 8)


def _jax_handover(z, warm):
    cfg = JSD.make_decoder3_config()
    block = jax.jit(lambda zz, st: JSD.decoder3_block(zz, cfg, st))
    _, _, _, jst = block(jnp.asarray(z[:warm]), JSD.decoder3_zero_state(cfg))
    st = convert._convert(SD.Decoder3State, jax.tree.map(np.asarray, jst),
                          "cpu")
    return block, jst, st


@pytest.mark.parametrize("T", [7, 21, 5000])
def test_lowpass_outputs_from_packed_state_match_jax(baseband24k, T):
    """After a JAX warm-up and hand-over, the clock stage's writes as the
    kernel assembles them — the history sliced from the packed state at
    state_offsets, filt of the last min(T, N) samples at (p0 + n) mod N,
    the last K-1 inputs, p — give JAX's next sync_buf, lp_buf and p (the
    lowpass summed in another order, and v from another library's Costas
    sin/cos: within 1e-4 of the scale)."""
    warm = int(0.5 * JC.RDS_RATE)
    block, jst, st = _jax_handover(baseband24k, warm)
    blk = baseband24k[warm:warm + T]
    _, _, _, jnew = block(jnp.asarray(blk), jst)
    cfg = SD.make_decoder3_config()
    packed, offs = SD.pack_state(st), SD.state_offsets(st)
    off, k1 = offs["lp_buf"]
    hist = packed[off:off + k1]
    N = cfg.symbol_ceiling
    p0 = int(packed[offs["p"][0]])
    zt = torch.from_numpy(blk)
    rr, _, _, _ = SD._costas(zt.real.numpy(), zt.imag.numpy(),
                             st.costas.freq.numpy(), st.costas.phase.numpy(),
                             1.0 / 16.0, 0.02 / 16.0)
    v = torch.from_numpy(rr) * 4.0
    _, last, lp_buf = SD.lowpass_outputs(hist, v, torch.from_numpy(cfg.lp21),
                                         N)
    off, n = offs["sync_buf"]
    ring = packed[off:off + n].clone()
    m = min(T, N)
    for j in range(m):
        ring[(p0 + T - m + j) % N] = last[j]
    assert (p0 + T) % N == int(jnew.p)
    for got, want in ((ring, jnew.sync_buf), (lp_buf, jnew.lp_buf)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))
