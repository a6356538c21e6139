"""The port's sources and live runner against the JAX package's, on the CPU.

- io/source.py: WavFileSource, SynthSource and open_source give the JAX
  copies' samples exactly (the same numpy code);
- run_live over unpaced NativeWavSource (complex64 wav) and NativeRawSource
  (PCM16 wav) against JAX run_live on the same file, both from the same
  state (a JAX warm-up handed over): audio within 2e-4 (f32 chains in two
  libraries, the audio O(0.5)), meta within 1e-3 (booleans and drops
  exact), RDS bits exactly;
- a pipe: NativePipeSource on a FIFO fed by a writer thread, through
  run_live, equals run_offline on the same frames bit for bit;
- the live loop's order against a source that logs its calls: block k is
  delivered before block k+1 is read, no block is read past `max_blocks`
  or a command_hook's stop, and `live.backlog` counts the blocks whose
  successor was already whole in the source's ring.

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
from sdrjfm_tpu_torch.runtime import spans
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
    # the rtl_tcp adapter without a server: both packages raise IOError
    # (the adapter against a server: tests/test_torch_hw_sources.py)
    for mod in (tsource, jsource):
        with pytest.raises(IOError, match="cannot connect to rtl_tcp"):
            mod.open_source("rtltcp://127.0.0.1:1")


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


@pytest.mark.parametrize("fmt", ["u8", "i8", "i16"])
def test_pipe_adapter_decodes_as_the_receiver(tmp_path, fmt):
    """open_source('pipe:...') converts each wire format as the receiver's
    own decode does: u8 (v - 127) / 128, i8 v / 128, i16 v / 32768, with
    bit_depth 8, 8 and 16.  For i8 this is a standing divergence from the
    JAX adapter, which reports 16 and divides by 32768 (ROADMAP.md, queue
    3: standing decisions)."""
    rng = np.random.default_rng(7)
    dt = {"u8": np.uint8, "i8": np.int8, "i16": np.int16}[fmt]
    info = np.iinfo(dt)
    raw = rng.integers(info.min, info.max + 1, (5000, 2)).astype(dt)
    path = tmp_path / f"iq.{fmt}"
    raw.tofile(path)
    got = {}
    for name, mod in (("port", tsource), ("jax", jsource)):
        dev = mod.open_source(f"pipe:{path}", fmt=fmt)
        try:
            got[name] = (dev.bit_depth(), dev.get_samples(5000))
        finally:
            dev.stop_reader()
    f = raw.astype(np.float32)
    want = {"u8": (f - 127.0) / 128.0, "i8": f / 128.0,
            "i16": f / 32768.0}[fmt]
    want = (want[:, 0] + 1j * want[:, 1]).astype(np.complex64)
    depth, x = got["port"]
    assert depth == (16 if fmt == "i16" else 8)
    np.testing.assert_array_equal(x, want)
    jdepth, jx = got["jax"]
    if fmt == "i8":
        assert jdepth == 16
        np.testing.assert_array_equal(jx, (f[:, 0] + 1j * f[:, 1]
                                           ).astype(np.complex64) / 32768.0)
    else:
        assert jdepth == depth
        np.testing.assert_array_equal(jx, x)


# -- the live loop's order, against a source that logs its calls ------------

LOG_BLOCK_FM = 4096
LOG_BLOCKS = 4


class _LoggedSource:
    """A live source over a u8 wire that logs each `read_block` (and the
    runner's deliveries through `on_audio`); `available`, where given,
    is the frames its ring reports."""

    dropped = 0

    def __init__(self, wire, T, log, available=None):
        self.wire, self.T, self.log = wire, T, log
        self.k = self.delivered = 0
        if available is not None:
            self.available = lambda: available

    def read_block(self, n, timeout_ms=10_000):
        assert n == self.T
        self.log.append(("read", self.k))
        blk = self.wire[self.k * n:(self.k + 1) * n]
        self.k += 1
        return blk

    def on_audio(self, frames):
        self.log.append(("audio", self.delivered))
        self.delivered += 1


@pytest.fixture(scope="module")
def logged_rx():
    return Receiver(ReceiverConfig(block_fm=LOG_BLOCK_FM, iq_format="u8"),
                    device="cpu")


@pytest.fixture(scope="module")
def logged_wire(iq):
    return synth.iq_to_u8(iq[:LOG_BLOCKS * LOG_BLOCK_FM * 12])


def _logged_run(rx, wire, available=None, **kw):
    log = []
    src = _LoggedSource(wire, rx.cfg.wire_len, log, available)
    res = TS.run_live(rx, src, on_audio=src.on_audio, **kw)
    return res, log


def test_run_live_delivers_each_block_before_reading_the_next(logged_rx,
                                                             logged_wire):
    res, log = _logged_run(logged_rx, logged_wire)
    want = [("read", 0)]
    for k in range(LOG_BLOCKS):
        want += [("audio", k), ("read", k + 1)]
    assert log == want                 # the last read finds the end
    assert len(res.meta) == LOG_BLOCKS
    ref = TS.run_offline(logged_rx, logged_wire)
    np.testing.assert_array_equal(res.audio, ref.audio)


@pytest.mark.parametrize("n", [0, 1, 3])
def test_run_live_reads_no_block_past_max_blocks(logged_rx, logged_wire, n):
    res, log = _logged_run(logged_rx, logged_wire, max_blocks=n)
    assert [e for e in log if e[0] == "read"] == [("read", k)
                                                   for k in range(n)]
    assert log[-1:] == ([("audio", n - 1)] if n else [])
    assert len(res.meta) == n


def test_run_live_command_hook_stop_ends_the_reads(logged_rx, logged_wire):
    seen = []

    def hook(state, controls, meta):
        seen.append(meta)
        return state, controls, len(seen) == 2

    res, log = _logged_run(logged_rx, logged_wire, command_hook=hook)
    assert log == [("read", 0), ("audio", 0), ("read", 1), ("audio", 1)]
    assert len(res.meta) == len(seen) == 2


@pytest.mark.parametrize("available,counted", [
    ("whole", LOG_BLOCKS), ("short", 0), ("none", 0), ("absent", 0)])
def test_run_live_backlog_counts_a_whole_successor(logged_rx, logged_wire,
                                                   available, counted):
    """`live.backlog` counts a block whose successor the source's ring
    already holds whole at its delivery; a ring short of a block, empty,
    or a source without `available()` counts none."""
    T = logged_rx.cfg.wire_len
    frames = {"whole": T, "short": T - 1, "none": 0, "absent": None}
    before = spans.counters["live.backlog"]
    res, _ = _logged_run(logged_rx, logged_wire, frames[available])
    assert len(res.meta) == LOG_BLOCKS
    assert spans.counters["live.backlog"] - before == counted
