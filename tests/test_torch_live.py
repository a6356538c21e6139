"""The port's sources and live runner against the JAX package's, on the CPU.

- io/source.py: WavFileSource, SynthSource and open_source give the JAX
  copies' samples exactly (the same numpy code);
- run_live over unpaced NativeWavSource (complex64 wav) and NativeRawSource
  (PCM16 wav) against JAX run_live on the same file, both from the same
  state (a JAX warm-up handed over): audio within 2e-4 (f32 chains in two
  libraries, the audio O(0.5)), meta within 1e-3 (booleans and drops
  exact), RDS bits exactly;
- a pipe: NativePipeSource on a FIFO fed by a writer thread, through
  run_live, equals run_offline on the same frames bit for bit.

No wall-clock limit is asserted (a loaded host runs slower, not wrong).
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu.io import source as jsource
from sdrjfm_tpu.models.receiver import Receiver as JReceiver
from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig
from sdrjfm_tpu.runtime import native_source as jnative
from sdrjfm_tpu.runtime import stream as JS
from sdrjfm_tpu_torch import convert
from sdrjfm_tpu_torch.io import source as tsource
from sdrjfm_tpu_torch.io import synth
from sdrjfm_tpu_torch.io.wavio import write_iq_wav, write_wav
from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu_torch.runtime import native_source as tnative
from sdrjfm_tpu_torch.runtime import stream as TS

import torch_parity as P

torch.set_num_threads(2)

BLOCK_FM = 16384
WARM = 12
RUN = 3
AUDIO_ATOL = 2e-4
META_ATOL = 1e-3


@pytest.fixture(scope="module")
def iq():
    return P.station_iq((WARM + RUN) * BLOCK_FM / 192_000.0 + 0.01, seed=5)


@pytest.fixture()
def short_wav(tmp_path, iq):
    path = tmp_path / "short.wav"
    write_iq_wav(str(path), iq[:30_001], 2_304_000)
    return str(path)


@pytest.mark.parametrize("loop", [False, True])
def test_wav_file_source_matches_jax(short_wav, loop):
    a = tsource.WavFileSource(short_wav, loop=loop)
    b = jsource.WavFileSource(short_wav, loop=loop)
    assert a.get_rate() == b.get_rate() == 2_304_000
    for n in (7, 10_000, 19_999, 4_096):
        assert a.samples() == b.samples()
        np.testing.assert_array_equal(a.get_samples(n), b.get_samples(n))
    a.reset_buffer()
    b.reset_buffer()
    np.testing.assert_array_equal(next(a.blocks(1000)), next(b.blocks(1000)))
    assert a.legal_frequency(95_000_000) and not a.legal_frequency(50)


def test_synth_source_and_factory_match_jax(short_wav):
    a = tsource.open_source("synth", seconds_per_chunk=0.01, seed=2)
    b = jsource.open_source("synth", seconds_per_chunk=0.01, seed=2)
    for n in (5_000, 30_000):                   # the second wraps the chunk
        np.testing.assert_array_equal(a.get_samples(n), b.get_samples(n))
    np.testing.assert_array_equal(
        tsource.open_source(f"file:{short_wav}").get_samples(500),
        jsource.open_source(f"file:{short_wav}").get_samples(500))
    with pytest.raises(ValueError, match="ROADMAP"):
        tsource.open_source("rtltcp://localhost:1234")


def test_native_adapter_matches_jax(short_wav):
    a = tsource.open_source(f"native:{short_wav}")
    b = jsource.open_source(f"native:{short_wav}")
    try:
        np.testing.assert_array_equal(a.get_samples(12_345),
                                      b.get_samples(12_345))
    finally:
        a.stop_reader()
        b.stop_reader()


def _handover(fmt, iq):
    """JAX and port receivers for `fmt`, the state after WARM blocks, and
    the wire of the blocks after them."""
    kw = dict(block_fm=BLOCK_FM, rds="block", audio_filter_hz=15000,
              iq_format=fmt)
    jrx = JReceiver(JConfig(**kw))
    trx = Receiver(ReceiverConfig(**kw), device="cpu")
    blocks = P.wire_blocks(iq, jrx.cfg, fmt)
    step = jrx.jit_step()
    js = jrx.init_state()
    ctl = jrx.initial_controls()
    for blk in blocks[:WARM]:
        js, out = step(js, ctl, jnp.asarray(blk))
    assert bool(out.meta.pilot_locked)
    ts = convert.state_from_numpy(P.tree_np(js), "cpu")
    return jrx, trx, js, ts, np.concatenate(blocks[WARM:WARM + RUN])


@pytest.mark.parametrize("fmt", ["c64", "i16"])
def test_run_live_matches_jax(tmp_path, iq, fmt):
    jrx, trx, js, ts, tail = _handover(fmt, iq)
    path = str(tmp_path / f"tail_{fmt}.wav")
    if fmt == "c64":
        write_iq_wav(path, tail, 2_304_000)       # float32: exact
        opener = (lambda m: m.NativeWavSource(path, pace=False))
    else:
        write_wav(path, tail, 2_304_000, float32=False)  # int16 through
        opener = (lambda m: m.NativeRawSource(path, pace=False))
    got = {}
    for name, mod, run, rx, st in (("jax", jnative, JS.run_live, jrx, js),
                                   ("port", tnative, TS.run_live, trx, ts)):
        bits = []
        with opener(mod) as src:
            got[name] = run(rx, src, init_state=st, on_rds_bits=bits.append)
        got[name].cb_bits = bits
    j, t = got["jax"], got["port"]
    assert len(t.meta) == len(j.meta) == RUN
    assert t.dropped_total == j.dropped_total == 0
    np.testing.assert_allclose(t.audio, np.asarray(j.audio), rtol=0,
                               atol=AUDIO_ATOL)
    np.testing.assert_array_equal(t.rds_bits, j.rds_bits)
    for a, b in zip(t.cb_bits, j.cb_bits):
        np.testing.assert_array_equal(a, b)
    for mt, mj in zip(t.meta, j.meta):
        assert set(mt) == set(mj)
        for k in mt:
            if k == "latency_ms":
                assert mt[k] > 0
            elif isinstance(mj[k], (bool, int)):
                assert mt[k] == mj[k], k
            else:
                assert mt[k] == pytest.approx(mj[k], rel=1e-4,
                                              abs=META_ATOL), k


def test_run_live_max_blocks_and_on_state(tmp_path, iq):
    """max_blocks ends the run; on_state sees each block's carry; with
    loop=True the source restarts at EOF."""
    w = synth.iq_to_i16(iq[:2 * BLOCK_FM * 12])
    path = str(tmp_path / "two.wav")
    write_wav(path, w, 2_304_000, float32=False)
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, iq_format="i16"),
                  device="cpu")
    seen = []
    with tnative.NativeRawSource(path, pace=False, loop=True) as src:
        res = TS.run_live(rx, src, max_blocks=5,
                          on_state=lambda n, st: seen.append(
                              (n, type(st).__name__)))
    assert len(res.meta) == 5
    assert seen == [(n, "ReceiverState") for n in range(1, 6)]
    ref = TS.run_offline(rx, w)
    n = len(ref.audio)
    np.testing.assert_array_equal(res.audio[:n], ref.audio)


def test_pipe_through_run_live_equals_offline(tmp_path, iq):
    frames = synth.iq_to_u8(iq[:3 * BLOCK_FM * 12])
    fifo = str(tmp_path / "iq.fifo")
    os.mkfifo(fifo)

    def write():
        with open(fifo, "wb") as f:
            payload = frames.tobytes()
            for off in range(0, len(payload), 65_537):   # odd chunks
                f.write(payload[off:off + 65_537])

    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    rx = Receiver(ReceiverConfig(block_fm=BLOCK_FM, rds="block",
                                 iq_format="u8"), device="cpu")
    with tnative.NativePipeSource(fifo, fmt="u8") as src:
        live = TS.run_live(rx, src)
        assert src.eof and src.dropped == 0
    writer.join()
    ref = TS.run_offline(rx, frames)
    assert len(live.meta) == 3
    np.testing.assert_array_equal(live.audio, ref.audio)
    np.testing.assert_array_equal(live.rds_bits, ref.rds_bits)
