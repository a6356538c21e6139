"""The port's band scan (models/scanner.py, models/bandscan.py) and the
front end's row form against the JAX package, on the CPU.

- raw_to_c64 per wire format and cluster_hits: equal to JAX's;
- scan_block / scan_decision over a batch of rows: each row equal to JAX's
  single-block call within 1e-3 dB (f32 FFTs in two libraries);
- scan_capture on a planted two-station capture: the same hits as JAX,
  contrast within 1e-3 dB; a carrier present in one block only is not a
  hit (the multi-block majority), one seen in the only block is;
- scan_band over an in-process fake retunable source: exactly the planted
  stations, the same list as JAX's scan_band on the same source, and the
  identify step naming a planted station's PI and PS;
- frontend_rows_plain == frontend_plain row by row, and the row wrapper's
  CPU path == it; BandScanner's row layout (row i * nb + b = offset i on
  block b, default controls, the initial state on every row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.io import synth as jsynth
from sdrjfm_tpu.models import bandscan as JB
from sdrjfm_tpu.models import scanner as JS
from sdrjfm_tpu.models.receiver import Receiver as JReceiver
from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig
from sdrjfm_tpu.rds import encode as jencode
from sdrjfm_tpu_torch.kernels.frontend import (frontend, frontend_plain,
                                               frontend_rows,
                                               frontend_rows_plain)
from sdrjfm_tpu_torch.models import bandscan as TB
from sdrjfm_tpu_torch.models import scanner as TS
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig

torch.set_num_threads(2)

BLOCK_FM = 32768
DB_ATOL = 1e-3


def _station_iq(n_fm, offset_hz, tone=900.0, pi=None, name="        ",
                amplitude=0.6):
    """A stereo FM station at offset_hz (RDS PI/PS when pi is given), as
    tests/test_bandscan.py builds it."""
    t = np.arange(n_fm) / JC.FM_RATE
    rds = None
    if pi is not None:
        raw = []
        for _ in range(1 + n_fm // (4 * 26 * 1187)):
            for seg in range(4):
                raw.extend(jencode.group_0a(pi, 3, seg,
                                            name[2 * seg:2 * seg + 2]))
        rds = jencode.differential_encode(np.asarray(raw, np.int8))
    mpx = jsynth.synth_mpx(0.5 * np.sin(2 * np.pi * tone * t),
                           0.5 * np.sin(2 * np.pi * (tone / 2.5) * t),
                           jsynth.MPXParams(rds_level=0.07 if rds is not None
                                            else 0.0),
                           rds_bits=rds)
    return jsynth.fm_modulate(mpx, JC.FM_RATE, carrier_offset_hz=offset_hz,
                              amplitude=amplitude)


def _noise(n, seed, std=0.02):
    rng = np.random.default_rng(seed)
    return (std * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


@pytest.fixture(scope="module")
def rxs():
    return (JReceiver(JConfig(block_fm=BLOCK_FM, rds="off")),
            Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="off"),
                     device="cpu"))


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["c64", "u8", "i8", "i16"])
def test_raw_to_c64_matches_jax(fmt):
    rng = np.random.default_rng(1)
    if fmt == "c64":
        raw = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
               ).astype(np.complex64)
    else:
        lo, hi, dt = {"u8": (0, 256, np.uint8), "i8": (-128, 128, np.int8),
                      "i16": (-32768, 32768, np.int16)}[fmt]
        raw = rng.integers(lo, hi, (1000, 2)).astype(dt)
    got, want = TB.raw_to_c64(raw, fmt), JB.raw_to_c64(raw, fmt)
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got, want)


def test_raw_to_c64_refuses_an_unknown_format():
    with pytest.raises(ValueError):
        TB.raw_to_c64(np.zeros((4, 2), np.int16), "f32")


@pytest.mark.parametrize("offs,contrast", [
    ([-500_000, -400_000, -300_000, 200_000, 300_000],
     [21.0, 30.0, 22.0, 25.0, 24.0]),
    ([0], [25.0]),
    ([300_000, -100_000, 0, 100_000, 900_000],
     [22.0, 30.0, 31.0, 29.0, 40.0]),
    ([], [])])
def test_cluster_hits_matches_jax(offs, contrast):
    assert TB.cluster_hits(offs, contrast, 100_000) \
        == JB.cluster_hits(offs, contrast, 100_000)


# ---------------------------------------------------------------------------
# scanner
# ---------------------------------------------------------------------------

def test_scan_block_batched_rows_match_jax():
    rng = np.random.default_rng(4)
    v = (rng.standard_normal((3, 2, 4 * 1024 + 100))
         + 1j * rng.standard_normal((3, 2, 4 * 1024 + 100))
         ).astype(np.complex64)
    v[0, 1] += 40.0 * np.exp(2j * np.pi * 0.01 * np.arange(v.shape[-1]))
    s, n = TS.scan_block(torch.from_numpy(v))
    hit, mean = TS.scan_decision(torch.from_numpy(v), 20.0)
    assert s.shape == n.shape == (3, 2, 4) and hit.shape == (3, 2)
    for i in range(3):
        for j in range(2):
            sj, nj = JS.scan_block(jnp.asarray(v[i, j]))
            np.testing.assert_allclose(s[i, j].numpy(), np.asarray(sj),
                                       rtol=0, atol=DB_ATOL)
            np.testing.assert_allclose(n[i, j].numpy(), np.asarray(nj),
                                       rtol=0, atol=DB_ATOL)
            hj, mj = JS.scan_decision(jnp.asarray(v[i, j]), 20.0)
            assert bool(hit[i, j]) == bool(hj)
            assert abs(float(mean[i, j]) - float(mj)) <= DB_ATOL
    assert bool(hit[0, 1]) and not bool(hit[2, 0])


def test_get_db_matches_jax():
    x = np.array([0.0, 1e-13, 1.0, 256.0, 1e4], np.float32)
    np.testing.assert_allclose(TS.get_db(torch.from_numpy(x)).numpy(),
                               np.asarray(JS.get_db(jnp.asarray(x))),
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# scan_capture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planted():
    n_fm = 4 * BLOCK_FM
    iq = (_station_iq(n_fm, -600_000) + _station_iq(n_fm, 400_000)
          ).astype(np.complex64)
    return iq + _noise(len(iq), 1)


def test_scan_capture_matches_jax(rxs, planted):
    jrx, trx = rxs
    got = TB.scan_capture(trx, planted, max_blocks=4)
    want = JB.scan_capture(jrx, planted, max_blocks=4)
    assert [h["offset_hz"] for h in got] == [-600_000, 400_000]
    assert [h["offset_hz"] for h in got] == [h["offset_hz"] for h in want]
    for a, b in zip(got, want):
        assert abs(a["contrast_db"] - b["contrast_db"]) <= DB_ATOL


def test_scan_capture_unclustered_matches_jax(rxs, planted):
    jrx, trx = rxs
    got = TB.scan_capture(trx, planted, max_blocks=4, cluster=False)
    want = JB.scan_capture(jrx, planted, max_blocks=4, cluster=False)
    assert [h["offset_hz"] for h in got] == [h["offset_hz"] for h in want]
    assert len(got) >= 2


def test_scan_capture_averages_out_flicker(rxs):
    """A carrier in the first block only is not a hit over four blocks; a
    steady one is; the single-block decision does see the flicker."""
    _, trx = rxs
    T = trx.cfg.block_in
    n_fm = 4 * BLOCK_FM
    iq = _station_iq(n_fm, 300_000) + _noise(4 * T, 0)
    iq[:T] += _station_iq(n_fm, -500_000)[:T]
    offs = [h["offset_hz"] for h in TB.scan_capture(trx, iq, max_blocks=4)]
    assert 300_000 in offs and all(abs(o - 300_000) <= 200_000 for o in offs)
    one = TB.scan_capture(trx, iq[:T], max_blocks=1)
    assert any(abs(h["offset_hz"] + 500_000) <= 100_000 for h in one)


def test_scan_capture_refuses_a_short_capture(rxs):
    with pytest.raises(ValueError):
        TB.scan_capture(rxs[1], np.zeros(100, np.complex64))


def test_band_scanner_rows_layout(rxs):
    _, trx = rxs
    sc = TB.BandScanner(trx, 20.0)
    wire = torch.zeros((3, trx.cfg.block_in), dtype=torch.complex64)
    states, controls, bidx = sc.rows(wire, [-100_000, 0, 100_000, 200_000])
    assert bidx.tolist() == [0, 1, 2] * 4
    assert controls.lo_freq_hz.tolist() == [o for o in (-100_000, 0, 100_000,
                                                       200_000)
                                            for _ in range(3)]
    assert controls.sound_mix.shape == (12, 2, 2)
    assert bool((controls.input_lgain == 1.0).all())
    assert bool((states.rf_dc == 0).all()) and states.band1.shape[0] == 12


# ---------------------------------------------------------------------------
# the row form's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["c64", "i16", "u8", "i8"])
def test_frontend_rows_plain_is_frontend_plain_per_row(fmt):
    rng = np.random.default_rng(11)
    T, nb, R = 12 * 512, 3, 5
    if fmt == "c64":
        wire = (0.3 * (rng.standard_normal((nb, T))
                       + 1j * rng.standard_normal((nb, T)))
                ).astype(np.complex64)
    else:
        lo, hi, dt = {"u8": (0, 256, np.uint8), "i8": (-128, 128, np.int8),
                      "i16": (-20000, 20000, np.int16)}[fmt]
        wire = rng.integers(lo, hi, (nb, T, 2)).astype(dt)
    wire = torch.from_numpy(wire)
    bidx = torch.tensor([2, 0, 1, 2, 0], dtype=torch.int32)
    carry = torch.from_numpy((0.1 * (rng.standard_normal((R, 306))
                                     + 1j * rng.standard_normal((R, 306)))
                              ).astype(np.complex64))
    taps = torch.from_numpy(rng.standard_normal(307).astype(np.float32))
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    lg, rg = f(rng.uniform(0.5, 1.5, R)), f(rng.uniform(0.5, 1.5, R))
    dc = torch.from_numpy((0.004 * (rng.standard_normal(R) - 1j))
                          .astype(np.complex64))
    lo = torch.from_numpy(rng.integers(-900_000, 900_000, R)
                          .astype(np.int32))
    n0 = torch.from_numpy(rng.integers(0, JC.INPUT_RATE, R).astype(np.int32))
    for dc_remove in (True, False):
        y, nc, dm = frontend_rows_plain(wire, fmt, bidx, carry, taps, lg, rg,
                                        dc, lo, n0, dc_remove)
        y2, nc2, dm2 = frontend_rows(wire, fmt, bidx, carry, taps, lg, rg,
                                     dc, lo, n0, dc_remove)
        assert torch.equal(y, y2) and torch.equal(nc, nc2)
        assert y.shape == (R, T // 12) and nc.shape == (R, 306)
        assert (dm is None) == (not dc_remove)
        for r in range(R):
            yr, cr, dr = frontend_plain(wire[int(bidx[r])], fmt, carry[r],
                                        taps, lg[r], rg[r], dc[r], lo[r],
                                        n0[r], dc_remove)
            assert torch.equal(y[r], yr) and torch.equal(nc[r], cr)
            if dc_remove:
                assert torch.equal(dm[r], dr)
            # the one-station wrapper is the same function on the CPU
            ys, cs, _ = frontend(wire[int(bidx[r])], fmt, carry[r], taps,
                                 lg[r], rg[r], dc[r], lo[r], n0[r],
                                 dc_remove)
            assert torch.equal(ys, yr) and torch.equal(cs, cr)
    assert frontend.launches == 0


# ---------------------------------------------------------------------------
# scan_band over a fake retunable source
# ---------------------------------------------------------------------------

class FakeTuner:
    """A retunable source whose stream depends on the tuned frequency: the
    planted stations that fall inside the window, at their offsets from
    the centre, plus noise.  The scan_band source contract:
    set_frequency, read_block, fmt, rate, flush."""

    fmt = "i16"
    rate = JC.INPUT_RATE

    def __init__(self, stations, seed=0):
        self.stations = stations      # [(freq_hz, pi or None, name)]
        self.freq = None
        self.retunes = []
        self.flushes = 0
        self._seed = seed

    def set_frequency(self, hz):
        self.freq = int(hz)
        self.retunes.append(self.freq)

    def flush(self):
        self.flushes += 1

    def read_block(self, n, timeout_ms=0):
        n_fm = -(-n // 12)
        iq = _noise(12 * n_fm, self._seed + len(self.retunes), std=0.01)
        for f, pi, name in self.stations:
            off = f - self.freq
            if abs(off) < JC.INPUT_RATE // 2 - 100_000:
                iq = iq + _station_iq(n_fm, off, pi=pi, name=name,
                                      amplitude=0.4)
        return jsynth.iq_to_i16(iq[:n])


PLANTED = [(95_000_000, None, ""), (96_700_000, None, "")]


def test_scan_band_finds_the_planted_stations_as_jax_does(rxs):
    jrx, trx = rxs
    kw = dict(f_start=94_500_000, f_stop=97_500_000, blocks=2, settle_ms=1)
    got = TB.scan_band(trx, FakeTuner(PLANTED), **kw)
    want = JB.scan_band(jrx, FakeTuner(PLANTED), **kw)
    assert [e["freq_hz"] for e in got] == [f for f, _, _ in PLANTED]
    assert [e["freq_hz"] for e in got] == [e["freq_hz"] for e in want]
    for a, b in zip(got, want):
        assert a["offset_hz"] == b["offset_hz"]
        assert abs(a["contrast_db"] - b["contrast_db"]) <= DB_ATOL


def test_scan_band_identifies_a_station(rxs):
    _, trx = rxs
    src = FakeTuner([(98_000_000, 0x3456, "IDENT FM")])
    logs = []
    got = TB.scan_band(trx, src, f_start=97_600_000, f_stop=98_400_000,
                       blocks=2, settle_ms=1, identify_seconds=1.4,
                       log=logs.append)
    assert [e["freq_hz"] for e in got] == [98_000_000]
    assert got[0]["pi_code"] == "0x3456" and got[0]["station"] == "IDENT FM"
    assert got[0]["pilot_locked"] and got[0]["ber"] == 0.0
    assert len(src.retunes) == 1 and src.flushes == 1 and logs


def test_scan_band_reports_an_aborted_sweep(rxs):
    class Ended(FakeTuner):
        def read_block(self, n, timeout_ms=0):
            return np.zeros((0, 2), np.int16)
    logs = []
    assert TB.scan_band(rxs[1], Ended([]), f_start=94_500_000,
                        f_stop=97_500_000, log=logs.append) == []
    assert "ABORTED" in logs[0]
