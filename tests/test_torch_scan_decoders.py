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
