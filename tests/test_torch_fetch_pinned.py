"""The chunk graph's fetch on the card (`runtime/graph.py`
`ScanGraph.fetch`): each output comes down in one DMA copy into
page-locked memory that the caller then owns.

- every fetched array is pinned and byte for byte the chunk output's rows;
- every fetch counts in `scan.fetch_pinned`, and once a fetch of the same
  shapes has been made and dropped, the next allocates no pinned block
  (`scan.fetch_host_allocs` grows by 0);
- a kept fetch shares no memory with a later one and keeps its values;
- `demodulate_stations` at the four stations of
  `test_torch_stations_reference.py` meets the plain reference there
  within that file's limits.

Marked `card`: the card is looked for inside a fixture, which skips
without one.  It imports no JAX; on the machine with the card:
`python -m pytest --noconftest -p no:cacheprovider -m card -q
tests/test_torch_fetch_pinned.py`."""

import numpy as np
import pytest
import torch

import test_torch_stations_reference as SR
from fmbench.compare import numbers
from fmbench.harness import ProgramRun, reference_outputs
from sdrjfm_tpu_torch.models.multistation import demodulate_stations
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu_torch.runtime import graph as G
from sdrjfm_tpu_torch.runtime import spans

K = 4                         # blocks a chunk


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: pinned memory and the copy down "
                    "exist only there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def capture(card):
    return SR.StationsSynth(SR.PARAMS, SR.SEED, SR.NB * SR.T).next(
        SR.NB * SR.T).numpy()


@pytest.fixture(scope="module")
def chunk(card, capture):
    """A chunk graph of K blocks on the card, its state loaded; `run(c)`
    stages and replays chunk c of the capture."""
    rx = Receiver(ReceiverConfig(**SR.CFG), device=card)
    sg = rx.jit_step()
    sc = sg.scan(K)
    sc.prepare()
    sg.load(rx.init_state(), rx.initial_controls())
    blocks = capture.reshape((SR.NB,) + G.wire_shape(rx.cfg))

    def run(c):
        sc.load_blocks(blocks[c * K:(c + 1) * K])
        sc.steps(K)
    return sc, run


def _counted():
    return (spans.counters["scan.fetch_pinned"],
            spans.counters["scan.fetch_host_allocs"])


@pytest.mark.card
def test_each_output_comes_down_pinned_and_byte_equal(chunk):
    sc, run = chunk
    run(0)
    p0, _ = _counted()
    got = sc.fetch(K)
    assert _counted()[0] == p0 + 1
    assert set(got) == set(sc.outs)
    for name, v in sc.outs.items():
        a = got[name]
        assert torch.from_numpy(a).is_pinned(), name
        want = v[:K].cpu().numpy()
        assert a.dtype == want.dtype and a.shape == want.shape, name
        assert a.tobytes() == want.tobytes(), name


@pytest.mark.card
def test_a_warm_fetch_allocates_no_pinned_block(chunk):
    sc, run = chunk
    run(1)
    for _ in range(2):                 # warm: the shapes' blocks made
        got = sc.fetch(K)
        del got
    p0, a0 = _counted()
    for _ in range(3):
        got = sc.fetch(K)
        del got
    assert _counted() == (p0 + 3, a0)


@pytest.mark.card
def test_a_kept_fetch_is_the_callers(chunk):
    sc, run = chunk
    run(2)
    first = sc.fetch(K)
    kept = {name: v.copy() for name, v in first.items()}
    run(3)
    second = sc.fetch(K)
    assert not np.array_equal(first["audio"], second["audio"])
    for name, v in first.items():
        assert not np.shares_memory(v, second[name]), name
        np.testing.assert_array_equal(v, kept[name], err_msg=name)


@pytest.mark.card
def test_four_stations_meet_the_reference_on_the_card(card, capture):
    rx = Receiver(ReceiverConfig(**SR.CFG), device=card)
    p0, _ = _counted()
    res = demodulate_stations(rx, capture, SR.OFFSETS)
    assert _counted()[0] == p0 + 1
    assert [r["offset_hz"] for r in res] == SR.OFFSETS
    for k, got in enumerate(res):
        off = SR.OFFSETS[k]
        ref = reference_outputs(SR.CFG, SR._block(capture), SR.NB, card,
                                tune_hz=off)
        run = ProgramRun(SR.NB, got["audio"], got["rds_bits"], None,
                         SR.CFG, SR.PARAMS[k], SR._block(capture), off)
        n = numbers([(run, ref)])
        assert n["audio_err"] < SR.AUDIO_ATOL, (off, n)
        assert n["rds_bit_errors"] == 0, (off, n)
        assert len(got["rds_bits"]) > 1000 and got["meta"]["pilot_locked"]
