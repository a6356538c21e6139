"""The port's per-sample RDS decoders 1-3 (plain versions of kernels B1-B3)
against the JAX package's lax.scan decoders, on the CPU.

- Parity: JAX runs 0.5 s of the rotated clean baseband of
  tests/test_scan_decoders.py from the zero state, its state is handed to
  the port (convert), and both run four chained 0.25 s segments.  Emitted
  bits and their count must be equal; the constellation points agree within
  1e-4 (they are the Costas output x4, O(1-10), whose phase carries the f32
  rounding of two libraries' sin/cos and filter sums).  From the zero state
  the loops' start-up is not compared sample by sample: decoder 2's Costas
  (alpha = 1) may settle on the other branch of the BPSK phase and decoder
  1's bandpass rings up out of rounding noise, so only their decoded groups
  are held there.
- Decoding: each decoder from the zero state decodes the fixture's PI/PS.
- Resync: tests/test_scan_decoders.py's decoder-3 resync test through the
  port's LiveRDSDecoder and Receiver.request_rds_resync.
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
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu_torch.rds import scan_decoders as SD
from sdrjfm_tpu_torch.rds.blocksync import BlockSynchronizer, Group
from sdrjfm_tpu_torch.rds.groups import GroupDecoder
from sdrjfm_tpu_torch.rds.live import LiveRDSDecoder

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def baseband24k():
    data_bits = encode.make_bitstream(pi=0x1234, station="SCANDEC ",
                                      repeats=3)
    syms = encode.differential_encode(data_bits)
    n = int(3.0 * JC.RDS_RATE)
    bb = rds_baseband(syms, n, JC.RDS_RATE)
    return (bb * np.exp(1j * 0.4)).astype(np.complex64)


def _decode(bits):
    sync = BlockSynchronizer()
    dec = GroupDecoder()
    sync.push_bits(bits, Group(), on_group=dec.decode)
    return sync, dec.result


def _jax_decoder(w):
    """(config, zero state, jitted block fn closed over the config)."""
    cfg = getattr(JSD, f"make_decoder{w}_config")()
    block = getattr(JSD, f"decoder{w}_block")
    return (cfg, getattr(JSD, f"decoder{w}_zero_state")(cfg),
            jax.jit(lambda z, st: block(z, cfg, st)))


@pytest.mark.parametrize("which", ["1", "2", "3"])
def test_plain_decoder_matches_jax_after_handover(baseband24k, which):
    z = baseband24k
    _, jst, jblock = _jax_decoder(which)
    warm = int(0.5 * JC.RDS_RATE)
    _, _, _, jst = jblock(jnp.asarray(z[:warm]), jst)
    cls = {"1": SD.Decoder1State, "2": SD.Decoder2State,
           "3": SD.Decoder3State}[which]
    st = convert._convert(cls, jax.tree.map(np.asarray, jst), "cpu")
    cfg = SD.DECODERS[f"scan{which}"][0]()
    seg = int(0.25 * JC.RDS_RATE)
    total = 0
    for k in range(4):
        blk = z[warm + k * seg: warm + (k + 1) * seg]
        bits, mask, iq, jst = jblock(jnp.asarray(blk), jst)
        m = np.asarray(mask)
        b, cnt, biq, stream, st = SD.decoder_block(
            f"scan{which}", torch.from_numpy(blk), cfg, st, want_iq=True)
        n = int(cnt)
        assert n == int(m.sum())
        np.testing.assert_array_equal(b.numpy()[:n], np.asarray(bits)[m])
        np.testing.assert_allclose(biq.numpy()[:n], np.asarray(iq)[m],
                                   rtol=0, atol=1e-4)
        assert not biq.numpy()[n:].any() and not b.numpy()[n:].any()
        np.testing.assert_allclose(stream.numpy(), np.asarray(iq), rtol=0,
                                   atol=1e-4)
        total += n
    assert total > 0.9 * 4 * seg / SD.SPS


@pytest.mark.parametrize("which", ["1", "2", "3"])
def test_plain_decoder_decodes_fixture(baseband24k, which):
    kind = f"scan{which}"
    mk, zero, _ = SD.DECODERS[kind]
    cfg = mk()
    bits, cnt, _, stream, st = SD.decoder_block(
        kind, torch.from_numpy(baseband24k), cfg, zero(cfg))
    assert stream is None
    got = bits.numpy()[:int(cnt)]
    assert abs(len(got) - 3.0 * JC.RDS_BITCLK_HZ) < 0.05 * 3 * JC.RDS_BITCLK_HZ
    sync, res = _decode(got)
    assert sync.groups_decoded > 15, (which, sync.groups_decoded)
    assert res.pi_code == 0x1234
    assert res.station_label == "SCANDEC "


def test_state_pack_round_trip():
    for kind, (mk, zero, _) in SD.DECODERS.items():
        cfg = mk()
        st = zero(cfg)
        back = SD.unpack_state(SD.pack_state(st), st)
        for a, b in zip(SD._leaves(back), SD._leaves(st)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_decoder3_resync_feedback_recovers_clock():
    """A quarter-bit clock-phase jump mid-stream: without the feedback the
    decoder never recovers; with LiveRDSDecoder.feed -> request_rds_resync
    group decoding resumes (tests/test_scan_decoders.py's test, through the
    port's receiver API)."""
    data_bits = encode.make_bitstream(pi=0x3C3C, station="RESYNC  ",
                                      repeats=16)
    syms = encode.differential_encode(data_bits)
    n = int(20.0 * JC.RDS_RATE)
    bb = rds_baseband(syms, n, JC.RDS_RATE).astype(np.complex64)
    cut = n // 4
    z = np.concatenate([bb[:cut], bb[cut + 5:]])
    nblk = 16
    z = z[: (len(z) // nblk) * nblk]
    blocks = z.reshape(nblk, -1)
    rx = Receiver(ReceiverConfig(block_fm=32768, rds="scan3"), device="cpu")
    cfg = rx.scan_cfg

    def run(with_feedback):
        state = rx.init_state()
        live = LiveRDSDecoder()
        per = []
        for b in range(nblk):
            bits, cnt, _, _, st = SD.decoder_block(
                "scan3", torch.from_numpy(blocks[b]), cfg, state.bitrec)
            state = state._replace(bitrec=st)
            before = live.sync.groups_decoded
            resync = live.feed(bits.numpy()[:int(cnt)])
            if with_feedback and resync:
                state = rx.request_rds_resync(state)
                assert bool(state.bitrec.need_resync)
            per.append(live.sync.groups_decoded - before)
        return live, per

    live_fb, per_fb = run(True)
    live_no, per_no = run(False)
    assert sum(per_fb[:4]) > 40 and sum(per_no[:4]) > 40
    assert sum(per_no[6:]) <= 2, per_no
    assert sum(per_fb[8:]) > 80, per_fb
    assert live_fb.resyncs_requested >= 1
    assert live_fb.result.pi_code == 0x3C3C


def test_request_rds_resync_only_arms_decoder3():
    rx3 = Receiver(ReceiverConfig(block_fm=32768, rds="scan3"), device="cpu")
    st = rx3.init_state()
    st = st._replace(bitrec=st.bitrec._replace(
        need_resync=torch.zeros((), dtype=torch.bool)))
    assert bool(rx3.request_rds_resync(st).bitrec.need_resync)
    for kind in ("block", "scan1", "scan2"):
        rx = Receiver(ReceiverConfig(block_fm=32768, rds=kind), device="cpu")
        s = rx.init_state()
        assert rx.request_rds_resync(s) is s
    # retune_reset restores the scan decoder's zero state
    s = rx3.retune_reset(st)
    assert bool(s.bitrec.need_resync)


# --------------------------------------------------------------------------
# the host side of the staged kernels (decoders 1 and 2): state and
# constant layout, the FIR stages' input and histories, the staging chunks
# --------------------------------------------------------------------------


def _distinct_state(kind):
    """Decoder `kind`'s state with a distinct value in every packed float."""
    mk, zero, _ = SD.DECODERS[kind]
    like = zero(mk())
    n = SD.pack_state(like).numel()
    return SD.unpack_state(torch.arange(1, n + 1, dtype=torch.float32), like)


@pytest.mark.parametrize("kind", ["scan1", "scan2", "scan3"])
def test_state_offsets_locate_every_field(kind):
    st = _distinct_state(kind)
    packed = SD.pack_state(st)
    offs = SD.state_offsets(st)
    at = 0
    for (name, (off, n)), leaf in zip(offs.items(), SD._leaves(st)):
        assert off == at, name
        np.testing.assert_array_equal(packed[off:off + n].numpy(),
                                      SD._flat(leaf).numpy())
        at += n
    assert at == packed.numel()


def test_state_runs_are_what_the_kernels_read():
    o1 = SD.state_offsets(_distinct_state("scan1"))
    cfg1 = SD.make_decoder1_config()
    assert SD.run_offset(o1, SD.COSTAS_RUN) == (0, 2)
    assert o1["lp_buf"] == (2, len(cfg1.lp21) - 1)
    assert o1["match_buf"][1] == len(cfg1.match) - 1
    assert o1["sharp_w"][1] == 2 * SD.POLES
    assert o1["sharp_fir"][1] == len(cfg1.sharp.num) - 1
    off, n = SD.run_offset(o1, SD.EMIT1_RUN)
    assert n == 4 and off + n == SD.pack_state(
        _distinct_state("scan1")).numel()
    o2 = SD.state_offsets(_distinct_state("scan2"))
    K = len(SD.make_decoder2_config().rrc)
    assert o2["mf_buf"] == (0, 2 * (K - 1))
    assert SD.run_offset(o2, SD.CORE2_RUN) == (2 * (K - 1), 15)
    with pytest.raises(ValueError):
        SD.run_offset(o1, ("last_sync", "last_data"))


@pytest.mark.parametrize("which", [1, 2, 3])
def test_const_offsets_locate_every_part(which):
    cfg = SD.DECODERS[f"scan{which}"][0]()
    block = SD._const_block(which, cfg)
    offs = SD.const_offsets(which, cfg)
    parts = dict(SD._const_parts(which, cfg))
    assert list(offs) == list(parts) and offs["head"] == 0
    for name, a in parts.items():
        np.testing.assert_array_equal(block[offs[name]:offs[name] + a.size],
                                      a)
    if which == 1:
        # the pole stage reads the residues right after the poles
        P = len(cfg.sharp.poles)
        assert P == SD.POLES
        assert offs["residues"] == offs["poles"] + 2 * P
        np.testing.assert_array_equal(
            block[offs["poles"]:offs["poles"] + 2 * P].view(np.complex64),
            cfg.sharp.poles)


def _ring_loop(hist, x, taps):
    """Ring::push as a float32 scalar loop: acc = 0, acc += taps[k] *
    in[n-k] for k = 0..K-1, one rounding per operation."""
    w = np.concatenate([hist, x]).astype(np.float32)
    K = len(taps)
    y = np.empty(len(x), np.float32)
    for n in range(len(x)):
        acc = np.float32(0.0)
        for k in range(K):
            acc = np.float32(acc + np.float32(taps[k] * w[n + K - 1 - k]))
        y[n] = acc
    return y


def _fir_taps(name):
    if name == "rrc":
        return SD.make_decoder2_config().rrc
    cfg = SD.make_decoder1_config()
    return {"lp21": cfg.lp21, "match": cfg.match,
            "num": cfg.sharp.num}[name]


@pytest.mark.parametrize("name", ["lp21", "match", "num", "rrc"])
def test_fir_in_order_is_the_ring_sum(name):
    taps = _fir_taps(name)
    rng = np.random.default_rng(11)
    hist = rng.standard_normal(len(taps) - 1).astype(np.float32)
    x = rng.standard_normal(300).astype(np.float32)
    y, _ = SD.fir_in_order(torch.from_numpy(hist), torch.from_numpy(x),
                           torch.from_numpy(taps))
    np.testing.assert_array_equal(y.numpy(), _ring_loop(hist, x, taps))


@pytest.mark.parametrize("T", [1, 5, SD.STAGE_CHUNK - 1, SD.STAGE_CHUNK + 1,
                               16384])
@pytest.mark.parametrize("name", ["lp21", "match", "num", "rrc"])
def test_fir_in_order_matches_fir_apply(name, T):
    """The FIR stage's input (history, then the block) and new history
    against fir_apply, ragged T included (T < K-1 keeps part of the old
    history)."""
    from sdrjfm_tpu_torch.ops.blockops import fir_apply
    taps = torch.from_numpy(_fir_taps(name))
    rng = np.random.default_rng(T)
    hist = torch.from_numpy(rng.standard_normal(taps.shape[0] - 1)
                            .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(T).astype(np.float32))
    y, h = SD.fir_in_order(hist, x, taps)
    yr, hr = fir_apply(x, taps, hist)
    w = torch.cat([hist, x])
    assert torch.equal(h, hr) and torch.equal(h, w[-hist.shape[0]:])
    scale = float(taps.abs().sum()) * float(w.abs().max())
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=0,
                               atol=2e-7 * scale)


@pytest.mark.parametrize("T", [1, SD.STAGE_CHUNK - 1, SD.STAGE_CHUNK,
                               SD.STAGE_CHUNK + 1, 16384, 16385])
def test_stage_chunks_cover_the_block_in_order(T):
    chunks = SD.stage_chunks(T)
    assert len(chunks) == -(-T // SD.STAGE_CHUNK)
    at = 0
    for c, (base, n) in enumerate(chunks):
        assert base == at == c * SD.STAGE_CHUNK and 1 <= n <= SD.STAGE_CHUNK
        at += n
    assert at == T
    tiles = SD.fir_tiles(T)
    assert (tiles - 1) * SD.FIR_TILE < T <= tiles * SD.FIR_TILE


def test_stage_chunks_refuse_an_empty_block():
    with pytest.raises(ValueError):
        SD.stage_chunks(0)


@pytest.mark.parametrize("which", ["1", "2"])
def test_fir_stages_from_packed_state_match_jax(baseband24k, which):
    """After a JAX warm-up and hand-over, the FIR stages as the kernels
    assemble them — each history sliced from the packed state at
    state_offsets, then the block — give the histories of JAX's next
    state."""
    z = baseband24k
    _, jst, jblock = _jax_decoder(which)
    warm = int(0.5 * JC.RDS_RATE)
    _, _, _, jst = jblock(jnp.asarray(z[:warm]), jst)
    cls = {"1": SD.Decoder1State, "2": SD.Decoder2State}[which]
    st = convert._convert(cls, jax.tree.map(np.asarray, jst), "cpu")
    packed, offs = SD.pack_state(st), SD.state_offsets(st)

    def hist(name):
        off, n = offs[name]
        return packed[off:off + n]

    blk = z[warm:warm + int(0.25 * JC.RDS_RATE)]
    _, _, _, jnew = jblock(jnp.asarray(blk), jst)
    cfg = SD.DECODERS[f"scan{which}"][0]()
    if which == "2":
        taps = torch.from_numpy(cfg.rrc)
        h = hist("mf_buf").reshape(-1, 2)
        zt = torch.from_numpy(blk)
        _, hr = SD.fir_in_order(h[:, 0], zt.real, taps)
        _, hi = SD.fir_in_order(h[:, 1], zt.imag, taps)
        np.testing.assert_array_equal(torch.complex(hr, hi).numpy(),
                                      np.asarray(jnew.mf_buf))
        return
    zt = torch.from_numpy(blk)
    rr, _, _, _ = SD._costas(zt.real.numpy(), zt.imag.numpy(),
                             st.costas.freq.numpy(), st.costas.phase.numpy(),
                             1.0 / 16.0, 0.02 / 16.0)
    v = torch.from_numpy(rr) * 4.0
    v1, h1 = SD.fir_in_order(hist("lp_buf"), v, torch.from_numpy(cfg.lp21))
    v2, h2 = SD.fir_in_order(hist("match_buf"), v1,
                             torch.from_numpy(cfg.match))
    _, h3 = SD.fir_in_order(hist("sharp_fir"), v2 * v2,
                            torch.from_numpy(cfg.sharp.num))
    for got, want in ((h1, jnew.lp_buf), (h2, jnew.match_buf),
                      (h3, jnew.sharp_fir)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))


def test_plan_launches_only_on_cuda():
    """plan() is the CUDA route: a CPU tensor is refused there (the call
    itself takes the plain version), nothing falls back."""
    cfg = SD.make_decoder2_config()
    st = SD.decoder2_zero_state(cfg)
    z = torch.zeros(64, dtype=torch.complex64)
    with pytest.raises(ValueError, match="unsupported device"):
        SD.decoder2_scan.plan(z, cfg, st, 8)
    launches = SD.decoder2_scan.launches
    SD.decoder2_scan(z, cfg, st, 8)
    assert SD.decoder2_scan.launches == launches


def test_kernel_constants_hold_decoder1_to_its_pole_count():
    """Decoder 1's pole stage is compiled for POLES poles (a lane each)."""
    from sdrjfm_tpu_torch.ops import design
    from sdrjfm_tpu_torch.ops.blockops import IIRSpec
    cfg = SD.make_decoder1_config()
    SD.kernel_constants("scan1", cfg, "cpu")
    other = cfg._replace(sharp=IIRSpec(design.bandpass_butter_sos(
        3, JC.RDS_BITCLK_HZ - 6.0, JC.RDS_BITCLK_HZ + 6.0, JC.RDS_RATE)))
    assert len(other.sharp.poles) != SD.POLES
    with pytest.raises(ValueError):
        SD.kernel_constants("scan1", other, "cpu")
