"""The weak-signal configuration (`fmbench/configs/weak_signal.json`: the
strong input filter, the noise squelch and RDS decoder 2) against its plain
reference (`fmbench/reference/weak_signal.py`, plain torch in float32), on
the CPU at block_fm=16384 (a block of 4 input hops and 2 hold periods) over
a seeded weak station (carrier 0.05 under noise 0.01).

- The port's `run_offline_scanned` over 10 blocks, judged by the
  harness's `judge` against the reference, within the configuration's
  limits: the pilot locks after 6 blocks, so the RDS bits of the last 4
  are compared, and no bit may differ.
- Stage by stage: the reference's input filter against the port's
  `fft_filter_apply` with the port's response; the squelch's decisions
  against the port's on a demodulated stream that makes it close and
  reopen, at a level that closes on noise; decoder 2's bits against the
  port's `decoder2_plain` from the same 24 kS/s input, block by block with
  the states carried.

It imports no JAX."""

import json

import numpy as np
import pytest
import torch

from fmbench.harness import ROOT, ProgramRun, judge
from fmbench.reference import receiver as ref_rx
from fmbench.reference import weak_signal as W
from fmbench.synth import StationParams, StationSynth
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu_torch.ops import blockops as B
from sdrjfm_tpu_torch.ops.squelch import (make_squelch_config, noise_squelch,
                                          squelch_bank, squelch_zero_state)
from sdrjfm_tpu_torch.rds import scan_decoders as SD
from sdrjfm_tpu_torch.runtime.stream import run_offline_scanned

CONFIG = json.loads((ROOT / "fmbench/configs/weak_signal.json").read_text())
BLOCK_FM = 16384
CFG = {**CONFIG["receiver"], "block_fm": BLOCK_FM}
T = 12 * BLOCK_FM
NB = 10
STATION = StationParams(amplitude=0.05, noise_std=0.01)
SEEDS = [2 ** 31 + 26, 2 ** 33 + 7, 3_000_000_026]
CPU = torch.device("cpu")


def _capture(seed, nb=NB):
    torch.set_num_threads(4)
    return StationSynth(STATION, seed, nb * T).next(nb * T).numpy()


def _block(wire):
    return lambda b: wire[b * T:(b + 1) * T]


@pytest.fixture(scope="module")
def rx():
    return Receiver(ReceiverConfig(**CFG), device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_port_agrees_with_the_reference(rx, seed):
    wire = _capture(seed)
    res = run_offline_scanned(rx, wire)
    run = ProgramRun(NB, res.audio, res.rds_bits, None, CFG, STATION,
                     _block(wire))
    got = judge([run], CPU, W)
    for k, limit in CONFIG["checks"].items():
        assert got[k] <= limit, got
    assert got["rds_bit_errors"] == 0
    assert len(res.rds_bits) > 4 * 70 and res.meta[-1]["pilot_locked"]


def test_the_reference_refuses_other_options():
    for change in ({"input_filter": False}, {"squelch": "lsq"},
                   {"rds": "block"}, {"input_fft": 32768}):
        with pytest.raises(NotImplementedError):
            W.PlainReceiver({**CFG, **change}, CPU)


def test_input_filter_matches_the_ports():
    """Two blocks of a complex stream through the reference's overlap-save
    filter and the port's, the carry threaded; the responses as designed
    by each."""
    ref = W.PlainReceiver(CFG, CPU)
    H_port = Receiver(ReceiverConfig(**CFG), device="cpu").H_input
    assert torch.allclose(ref.H_in, H_port, rtol=0, atol=1e-6)
    g = torch.Generator().manual_seed(26)
    x = torch.complex(torch.randn(2 * T, generator=g),
                      torch.randn(2 * T, generator=g)) * 0.1
    c_ref = torch.zeros(W.INPUT_FFT - W.INPUT_HOP, dtype=torch.complex64)
    c_port = B.fft_filter_zero_state(W.INPUT_FFT, W.INPUT_HOP)
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        y_ref, c_ref = ref_rx.fft_filter(xb, ref.H_in, W.INPUT_HOP, c_ref)
        y_port, c_port = B.fft_filter_apply(xb, H_port, W.INPUT_HOP, c_port)
        assert y_ref.shape == y_port.shape == (T,)
        assert (y_ref - y_port).abs().max() < 1e-6
        assert torch.equal(c_ref, c_port)


def _closing_demod():
    """Four blocks of 8 hold periods of a demodulated stream: white noise
    (as a discriminator gives without a carrier), then a loud 1 kHz tone
    with a little noise (a station), then noise again, then the station."""
    g = torch.Generator().manual_seed(2026)
    H = W.HOLD
    n = torch.arange(32 * H, dtype=torch.float32)
    noise = torch.randn(32 * H, generator=g)
    tone = torch.sin(2 * np.pi * 1000.0 / 192000.0 * n) + 0.01 * noise
    station = torch.zeros(32 * H, dtype=torch.bool)
    station[6 * H:14 * H] = True
    station[22 * H:] = True
    return torch.where(station, tone, noise)


@pytest.mark.parametrize("level", [50.0, 0.0])
def test_squelch_decisions_match_the_ports(level):
    """At level 50 the squelch closes on noise (its high band's average is
    ~0.6 of its low band's) and opens on the station, twice; at level 0 it
    never closes.  Each hold period's decision and the gated stream are
    the port's, exactly, with the states carried over four blocks."""
    ref = W.PlainReceiver(CFG, CPU, squelch_level=level)
    s = ref.init_state()
    cfg = make_squelch_config()
    bank = squelch_bank(cfg, CPU)
    st = squelch_zero_state(cfg)
    lvl = torch.tensor(level)
    x = _closing_demod()
    shut_ref, shut_port = [], []
    for b in range(4):
        xb = x[b * 8 * W.HOLD:(b + 1) * 8 * W.HOLD]
        y_ref, shut, margin, upd = ref._squelch(s, xb)
        s.update(upd)
        y_port, st = noise_squelch(xb, lvl, cfg, st, bank)
        assert torch.equal(y_ref, y_port)
        shut_ref += shut.tolist()
        shut_port += (y_port.view(8, W.HOLD) == 0).all(-1).tolist()
        assert margin > 0.01
    assert shut_ref == shut_port
    flips = sum(a != b for a, b in zip(shut_ref[:-1], shut_ref[1:]))
    if level:
        assert shut_ref[:5] == [True] * 5 and not any(shut_ref[7:13])
        assert flips == 3 and not any(shut_ref[23:])
    else:
        assert not any(shut_ref)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_decoder2_bits_match_the_ports(seed):
    """The 24 kS/s stream the reference hands its decoder 2, block by block
    through the port's `decoder2_plain` with its state carried: the same
    bits, the same count."""
    wire = _capture(seed)
    ref = W.PlainReceiver(CFG, CPU)
    zs, real = [], ref._decoder2

    def kept(s, z):
        zs.append(z)
        return real(s, z)
    ref._decoder2 = kept
    s, ref_bits = ref.init_state(), []
    with torch.no_grad():
        for b in range(NB):
            s, out = ref.step(s, torch.as_tensor(wire[b * T:(b + 1) * T]))
            ref_bits.append(out["bits"])
    dcfg = SD.make_decoder2_config()
    st = SD.decoder2_zero_state(dcfg)
    total = 0
    for z, want in zip(zs, ref_bits):
        bits, count, _, _, st = SD.decoder2_plain(z, dcfg, st, 4 * len(z))
        n = int(count)
        assert n == len(want)
        assert torch.equal(bits[:n], want)
        total += n
    assert total > NB * 70
