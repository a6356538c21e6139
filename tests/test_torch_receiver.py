"""The port's Receiver, state conversion and CLI against the JAX package, on
the CPU (device="cpu": every kernel wrapper runs its plain version).

- design constants: the port builds the same f32/c64 arrays bit for bit,
  and constants_from_numpy loads the JAX ones unchanged;
- Receiver.step: the JAX receiver runs ~1 s into a synth capture (pilot
  locked), its state is carried across with state_from_numpy, and both
  packages run 3 more blocks.  Audio within 2e-4 (f32 chains through FFT
  filters, atan2 and the trackers in two libraries: the audio is O(0.5)),
  meta_vec within 1e-3 except the integer/boolean slots (exact), RDS bits
  exactly;
- the CLI drive: synth 4 s, rx --device cpu decodes PI/PS/RT at BER 0.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrjfm_tpu import constants as JC
from sdrjfm_tpu.io import synth as jsynth
from sdrjfm_tpu.models.receiver import Receiver as JReceiver
from sdrjfm_tpu.models.receiver import ReceiverConfig as JConfig
from sdrjfm_tpu.rds import encode as jencode
from sdrjfm_tpu_torch import app, convert
from sdrjfm_tpu_torch.models.receiver import (Meta, Receiver, ReceiverConfig,
                                              ReceiverState)

torch.set_num_threads(2)

BLOCK_FM = 16384
WARM = 12                     # JAX blocks before the hand-over (~1.02 s)
CMP = 3                       # blocks compared after it


def _cfg_kw(**kw):
    base = dict(block_fm=BLOCK_FM, rds="block", audio_filter_hz=15000,
                iq_format="i16")
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def capture():
    n = int((WARM + CMP + 1) * BLOCK_FM)
    t = np.arange(n) / JC.FM_RATE
    syms = jencode.differential_encode(jencode.make_bitstream(
        pi=0x10F0, pty=10, station="TPU FM", radiotext="PARITY\r",
        repeats=2))
    mpx = jsynth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000 * t),
                           0.6 * np.sin(2 * np.pi * 440 * t),
                           jsynth.MPXParams(rds_level=0.07), rds_bits=syms)
    iq = jsynth.fm_modulate(mpx, JC.FM_RATE, carrier_offset_hz=50_000,
                            noise_std=0.01)
    return jsynth.iq_to_i16(iq)


@pytest.mark.parametrize("kw", [
    dict(), dict(squelch="nsq", rds="scan1", audio_rate=192_000,
                 frontend="reference"), dict(rds="scan2")],
    ids=["main", "squelch_scan1_up_reference", "scan2"])
def test_design_constants_bit_equal_and_loadable(kw):
    jrx = JReceiver(JConfig(**_cfg_kw(block_fm=131072, **kw)))
    trx = Receiver(ReceiverConfig(**_cfg_kw(block_fm=131072, **kw)),
                   device="cpu")
    jarr = {}
    for name in convert.CONSTANT_NAMES:
        obj = jrx
        for part in name.split("."):
            obj = getattr(obj, part, None)
        if obj is not None:                   # paths of other options
            jarr[name] = np.asarray(obj)
    own = convert.constants_to_numpy(trx)
    assert set(own) == set(jarr)
    for name, a in jarr.items():
        assert own[name].dtype == a.dtype, name
        np.testing.assert_array_equal(own[name], a, err_msg=name)
    convert.constants_from_numpy(trx, jarr)
    for name, a in convert.constants_to_numpy(trx).items():
        np.testing.assert_array_equal(a, jarr[name], err_msg=name)
    with pytest.raises(ValueError):
        convert.constants_from_numpy(trx, {"k_decim12": jarr["k_decim12"][:5]})


@pytest.mark.parametrize("kw", [dict(), dict(mode="mono", rds="off")],
                         ids=["stereo_rds", "mono_no_rds"])
def test_step_parity_after_state_handover(capture, kw):
    jrx = JReceiver(JConfig(**_cfg_kw(**kw)))
    trx = Receiver(ReceiverConfig(**_cfg_kw(**kw)), device="cpu")
    T = jrx.cfg.block_in
    lo = -50_000
    jctl = jrx.initial_controls()._replace(
        lo_freq_hz=jnp.asarray(lo, jnp.int32))
    tctl = trx.initial_controls()._replace(
        lo_freq_hz=torch.tensor(lo, dtype=torch.int32))
    step = jax.jit(jrx.step)
    js = jrx.init_state()
    for b in range(WARM):
        js, out = step(js, jctl, jnp.asarray(capture[b * T:(b + 1) * T]))
    assert bool(out.meta.pilot_locked)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    # the hand-over is lossless
    back = convert.state_to_numpy(ts)
    for name in ("n0_mod", "rf_dc", "band1", "audio_filt", "phase_delay"):
        np.testing.assert_array_equal(getattr(back, name),
                                      np.asarray(getattr(js, name)))
    nbits = 0
    for b in range(WARM, WARM + CMP):
        blk = capture[b * T:(b + 1) * T]
        js, oj = step(js, jctl, jnp.asarray(blk))
        ts, ot = trx.step(ts, tctl, torch.from_numpy(blk.copy()))
        np.testing.assert_allclose(ot.audio.numpy(), np.asarray(oj.audio),
                                   rtol=0, atol=2e-4)
        mj, mt = np.asarray(oj.meta_vec), ot.meta_vec.numpy()
        exact = [Meta._fields.index("pilot_locked"),
                 Meta._fields.index("pss_established"), len(Meta._fields)]
        np.testing.assert_array_equal(mt[exact], mj[exact])
        np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-3)
        if oj.rds is None:
            assert ot.rds is None
            continue
        n = int(oj.rds.count)
        np.testing.assert_array_equal(ot.rds.bits.numpy()[:n],
                                      np.asarray(oj.rds.bits)[:n])
        nbits += n
    assert nbits > 100 or jrx.cfg.rds == "off"
    assert int(ts.n0_mod) == int(js.n0_mod)
    assert int(ts.ramp_remaining) == int(js.ramp_remaining)


@pytest.mark.parametrize("kw", [
    dict(frontend="reference"), dict(input_filter=True),
    dict(native_rate=2_400_000), dict(squelch="nsq"), dict(rds="scan3"),
    dict(test_tone=True), dict(audio_rate=192_000), dict(emit_taps=True),
    dict(emit_audio_i16=True), dict(decoder="pll"), dict(audio_filter_hz=0)])
def test_unported_options_raise(kw):
    """Every option of the JAX ReceiverConfig builds now; only the sharded
    paths (shard_axis) are unported, and they raise naming ROADMAP.md."""
    rx = Receiver(ReceiverConfig(**_cfg_kw(**kw)), device="cpu")
    st, ctl = rx.init_state(), rx.initial_controls()
    v = torch.zeros(rx.cfg.block_fm, dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rx.fm_chain(st, ctl, v, {}, shard_axis="time")


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert Receiver(ReceiverConfig(**_cfg_kw())).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Receiver(ReceiverConfig(**_cfg_kw()))


def test_state_fields_mirror_jax():
    from sdrjfm_tpu.models import receiver as JR
    from sdrjfm_tpu_torch.models import receiver as TR
    for name in ("ReceiverState", "Controls", "Meta", "Output"):
        assert getattr(TR, name)._fields == getattr(JR, name)._fields, name
    assert ReceiverState._fields == JR.ReceiverState._fields
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ReceiverConfig)}
    assert jf == tf


def test_cli_drive_decodes_rds(tmp_path, capsys):
    iq, audio, report = (tmp_path / "iq.wav", tmp_path / "audio.wav",
                         tmp_path / "report.json")
    assert app.main(["synth", "--out", str(iq), "--seconds", "4",
                     "--station", "TPU FM", "--radiotext", "VERIFY RUN",
                     "--pi", "0x10F0", "--pty", "10"]) == 0
    assert app.main(["rx", "--iq", str(iq), "--audio", str(audio), "--rds",
                     "--report", str(report), "--block-fm", "32768",
                     "--device", "cpu"]) == 0
    rep = json.loads(report.read_text())
    assert set(rep) == {"input_samples", "blocks", "throughput_x_realtime",
                        "meta_last", "rds"}
    rds = rep["rds"]
    assert rds["pi_code"] == "0x10F0"
    assert rds["station_label"].strip() == "TPU FM"
    assert rds["radio_text"] == "VERIFY RUN"
    assert rds["bit_error_rate"] == 0.0
    assert rep["meta_last"]["pilot_locked"]
    assert rep["meta_last"]["pss_established"]
    from sdrjfm_tpu_torch.io.wavio import read_wav
    x, info = read_wav(str(audio))
    assert info.rate == 48000 and x.shape[1] == 2
    assert 0.1 < float(np.sqrt(np.mean(x ** 2))) < 1.0


def test_cli_exits_2_on_bad_flags_and_inputs(tmp_path, capsys):
    # --meter needs a streaming runner; a missing capture fails to load
    # first (the JAX CLI's order and message)
    assert app.main(["rx", "--iq", "x.wav", "--meter", "--device",
                     "cpu"]) == 2
    assert "loading device failed: x.wav" in capsys.readouterr().err
    assert app.main(["scan", "--iq", "x.wav", "--device", "cpu"]) == 2
    assert app.main(["rx", "--iq", str(tmp_path / "missing.wav"),
                     "--device", "cpu"]) == 2
