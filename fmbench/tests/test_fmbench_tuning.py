"""Receivers tuned off 0 Hz, and configurations that bring their own
reference: the tuned plain reference against the port's tuned receivers on
a four-station capture, the harness's one reference for each receiver,
tuning and input, a configuration's reference module found by name, the
multi-station synth, and the control put on tuned receivers.

The card test at the end reads the calibration of a 19-receiver scan of
the four-station capture at the `stereo_rds` geometry and prints its
readings, one JSON line a seed and one a control seed (run it with -s)."""

import hashlib
import json
import sys
import textwrap
import time
import types

import numpy as np
import pytest
import torch

from fmbench import harness
from fmbench.compare import numbers
from fmbench.harness import (ROOT, Bench, ProgramRun, judge,
                             reference_outputs, run_cell)
from fmbench.reference import decode_rds
from fmbench.synth import StationParams, StationSynth, StationsSynth

# four stations of one capture (offset Hz, PI, PS, left Hz, right Hz), each
# at 0.22 of full scale with RDS at 8 %: the sum stays inside the int16 wire
STATIONS = ((-600_000, 0x1111, "STATION1", 700.0, 1100.0),
            (-200_000, 0x2222, "STATION2", 1300.0, 500.0),
            (300_000, 0x3333, "STATION3", 900.0, 1700.0),
            (700_000, 0x4444, "STATION4", 1900.0, 400.0))
OFFSETS = [s[0] for s in STATIONS]
RASTER_19 = list(range(-900_000, 900_001, 100_000))
PARAMS = [StationParams(left_hz=fl, right_hz=fr, rds_level=0.08,
                        amplitude=0.22, pi=pi, ps=ps, rt="RT " + ps,
                        carrier_hz=float(off))
          for off, pi, ps, fl, fr in STATIONS]

BLOCK_FM = 16384
CFG = {"block_fm": BLOCK_FM, "rds": "block", "audio_filter_hz": 15000,
       "iq_format": "i16"}
T = BLOCK_FM * 12
NB = 40                       # 3.4 s of air: a whole RDS rotation and more
AUDIO_ATOL = 2e-5             # the port's float32 chain against the
                              # reference's on the CPU (no TF32 there)


def _blocks(wire, T):
    return lambda b: wire[b * T:(b + 1) * T]


@pytest.fixture(scope="module")
def capture():
    torch.set_num_threads(4)
    return StationsSynth(PARAMS, 2 ** 31 + 3, NB * T).next(NB * T).numpy()


@pytest.fixture(scope="module")
def refs(capture):
    return {off: reference_outputs(CFG, _blocks(capture, T), NB,
                                   torch.device("cpu"), tune_hz=off)
            for off in OFFSETS}


@pytest.fixture(scope="module")
def port(capture):
    """Each station through the port's single-station `Receiver` tuned by
    `lo_freq_hz`, and all four through `demodulate_stations(scan=True)`."""
    from sdrjfm_tpu_torch.models.multistation import demodulate_stations
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    rx = Receiver(ReceiverConfig(**CFG), device="cpu")
    block = _blocks(capture, T)
    single = {}
    for off in OFFSETS:
        s = rx.init_state()
        c = rx.initial_controls()._replace(
            lo_freq_hz=torch.tensor(off, dtype=torch.int32))
        audio, bits = [], []
        for b in range(NB):
            s, o = rx.step(s, c, torch.from_numpy(block(b)))
            audio.append(o.audio.numpy())
            bits.append(o.rds.bits[:int(o.rds.count)].numpy())
        single[off] = (np.concatenate(audio), np.concatenate(bits))
    many = {r["offset_hz"]: (r["audio"], r["rds_bits"].astype(np.int8))
            for r in demodulate_stations(rx, capture, OFFSETS, scan=True)}
    return {"single": single, "stations": many}


@pytest.mark.parametrize("path", ["single", "stations"])
@pytest.mark.parametrize("k", range(len(STATIONS)))
def test_tuned_reference_agrees_with_the_port(capture, refs, port, path, k):
    off = OFFSETS[k]
    audio, bits = port[path][off]
    run = ProgramRun(NB, audio, bits, None, CFG, PARAMS[k],
                     _blocks(capture, T), off)
    got = numbers([(run, refs[off])])
    assert got["audio_err"] < AUDIO_ATOL, got
    assert got["rds_bit_errors"] == 0, got
    # the same run against the reference at 0 Hz is far off: the tuning
    # is what makes them agree
    untuned = reference_outputs(CFG, _blocks(capture, T), 2,
                                torch.device("cpu"))
    run0 = ProgramRun(2, audio[:2 * len(untuned[0]["audio"])], bits, None,
                      CFG, PARAMS[k], None)
    assert numbers([(run0, untuned)])["audio_err"] > 100 * AUDIO_ATOL


@pytest.mark.parametrize("k", range(len(STATIONS)))
def test_tuned_reference_decodes_each_station(refs, k):
    p = PARAMS[k]
    out = refs[OFFSETS[k]]
    d = decode_rds(np.concatenate([o["bits"] for o in out]))
    assert (d["pi"], d["ps"], d["rt"]) == (p.pi, p.ps, p.rt)
    assert d["crc_errors"] == 0 and d["groups"] >= 20
    assert out[-1]["locked"]
    rms = np.sqrt(np.mean(out[-1]["audio"].astype(np.float64) ** 2))
    assert 0.05 < rms < 1.0


def test_tuned_reference_carries_the_sample_index(capture):
    """Blocks 2.. of a run from block 0 equal a run whose state says it
    starts at block 2: the mix's phase follows the global sample index,
    carried modulo the wire rate."""
    from fmbench.reference import PlainReceiver
    ref = PlainReceiver(CFG, "cpu", tune_hz=OFFSETS[3])
    block = _blocks(capture, T)
    s = ref.init_state()
    for b in range(2):
        s, _ = ref.step(s, torch.from_numpy(block(b)))
    assert s["n_mod"] == 2 * T % 2_304_000
    x = ref._front_end(s, torch.from_numpy(block(2)))[0]
    s0 = {**ref.init_state(), "n_mod": 2 * T % 2_304_000,
          "rf_dc": s["rf_dc"], "fe": s["fe"]}
    assert torch.equal(ref._front_end(s0, torch.from_numpy(block(2)))[0], x)
    s0["n_mod"] = 0
    assert not torch.equal(ref._front_end(s0, torch.from_numpy(block(2)))[0],
                           x)


def test_judge_runs_one_reference_per_tuning(capture, refs, monkeypatch):
    """Two tunings of one input take two references; two runs at one
    tuning of one input take one."""
    calls = []

    def counted(receiver, wire_block, nblocks, device, mode="f32",
                tune_hz=0, module=None):
        calls.append(tune_hz)
        return refs[tune_hz]
    monkeypatch.setattr(harness, "reference_outputs", counted)
    block = _blocks(capture, T)

    def run(off):
        a = np.concatenate([o["audio"] for o in refs[off]])
        b = np.concatenate([o["bits"] for o in refs[off]])
        return ProgramRun(NB, a, b, None, CFG, PARAMS[0], block, off)
    got = judge([run(OFFSETS[0]), run(OFFSETS[1])], torch.device("cpu"))
    assert sorted(calls) == sorted(OFFSETS[:2])
    assert got["audio_err"] == 0 and got["rds_bit_errors"] == 0
    calls.clear()
    judge([run(OFFSETS[2]), run(OFFSETS[2])], torch.device("cpu"))
    assert calls == [OFFSETS[2]]
    # the same two runs with their tunings swapped are judged against the
    # other station's reference, and fail
    swapped = [run(OFFSETS[0]), run(OFFSETS[1])]
    swapped[0].tune_hz, swapped[1].tune_hz = OFFSETS[1], OFFSETS[0]
    assert judge(swapped, torch.device("cpu"))["audio_err"] > 0.1


class _ProbeReceiver:
    """A reference module's receiver that records how it is built and
    hands back silence."""
    built = []

    def __init__(self, receiver, device="cpu", tune_hz=0):
        self.T = 12 * int(receiver["block_fm"])
        self.built.append((dict(receiver), int(tune_hz)))

    def init_state(self):
        return {}

    def step(self, s, wire):
        return s, {"audio": torch.zeros(self.T // 48, 2), "locked": False}


@pytest.fixture
def probe_module(monkeypatch):
    mod = types.ModuleType("fmbench.reference.probe")
    mod.PlainReceiver = _ProbeReceiver
    _ProbeReceiver.built = []
    monkeypatch.setitem(sys.modules, "fmbench.reference.probe", mod)
    return mod


def test_a_configuration_names_its_reference(probe_module):
    import fmbench.reference.receiver as receiver
    assert Bench.reference({"receiver": CFG}) is receiver
    assert Bench.reference({"reference": "receiver"}) is receiver
    assert Bench.reference({"reference": "probe"}) is probe_module
    for config in (json.loads((ROOT / c["file"]).read_text())
                   for c in Bench().spec["configs"]):
        assert Bench.reference(config) is receiver


def test_a_cell_added_by_files_gets_its_reference_and_configuration(
        tmp_path, probe_module):
    """A cell whose configuration names a reference module and whose
    traffic kind is new: the kind sees the configuration in its context,
    each of its runs is judged against the named module's receiver at the
    run's tuning, one receiver a tuning."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "probe_kind.py").write_text(textwrap.dedent('''
        import numpy as np
        from fmbench.harness import ProgramRun, Run

        def input_blocks(traffic, wire_len, seconds):
            return int(traffic["blocks"])

        def run(ctx):
            T = 12 * int(ctx.receiver["block_fm"])
            nb = input_blocks(ctx.traffic, T, ctx.seconds)
            assert ctx.config["deployment"] == "probe"
            silent = np.zeros((nb * T // 48, 2), np.float32)
            wire = np.zeros((T, 2), np.int16)
            block = lambda b: wire
            runs = [ProgramRun(nb, silent, np.zeros(0, np.int8), None,
                               ctx.receiver, None, block, f)
                    for f in ctx.traffic["tunings"]]
            return Run(metrics={"air_x": 1.0, "setup_s": 1.0},
                       attempted=nb, failed=0, runs=runs,
                       free=lambda: None)
        '''))
    (tmp_path / "traffic" / "probe_19.json").write_text(json.dumps(
        {"kind": "probe_kind", "blocks": 2,
         "tunings": [-100_000, 0, 100_000, 0]}))
    cfg = {"source": "probe", "deployment": "probe", "reference": "probe",
           "receiver": {"block_fm": 16384, "rds": "off",
                        "audio_filter_hz": 15000, "iq_format": "i16"},
           "reduced": [], "checks": {"audio_err": 1e-4}}
    (tmp_path / "probe.json").write_text(json.dumps(cfg))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "probe", "source": "probe",
                            "file": str(tmp_path / "probe.json"),
                            "reduced": [], "why": "probe"})
    spec["workloads"].append({"name": "probe.probe_19", "config": "probe",
                              "traffic": "probe_19", "chips": 1,
                              "why": "probe"})
    for m in spec["end_to_end"]:
        if m["name"] == "air_x":
            m["workloads"].append("probe.probe_19")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tmp_path / "BENCHMARK.json", base=tmp_path)
    out = run_cell(bench, "probe.probe_19", 1, 1.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert sorted(t for _, t in _ProbeReceiver.built) == [-100_000, 0,
                                                          100_000]
    assert all(r == cfg["receiver"] for r, _ in _ProbeReceiver.built)


def test_one_station_bytes_unchanged():
    """The one-station path gives the bytes it gave before the synth made
    several stations (SHA-256 of this stream, taken on the CPU with the
    single-station generator)."""
    s = StationSynth(StationParams(), 2 ** 31 + 987654321, 3 * T)
    x = torch.cat([s.next(T // 3), s.next(2 * T), s.next(T - T // 3)])
    assert hashlib.sha256(x.numpy().tobytes()).hexdigest() == (
        "7b7bdf4ef2c1a76ba749773c81dbd0d19cf689c287e8cf0143fc0a8ffdd03ddc")
    one = StationsSynth([StationParams()], 2 ** 31 + 987654321, 3 * T,
                        noise_std=StationParams().noise_std).next(3 * T)
    assert torch.equal(one, x)


def test_stations_sum_before_one_quantisation():
    """Without noise, the capture is the stations' IQ summed and then
    rounded once: within half a step of full scale of the sum of each
    station made alone, unrounded."""
    n = 4 * 4096
    got = StationsSynth(PARAMS, 7, n, noise_std=0.0).next(n).double()
    rng = np.random.default_rng(7)
    from fmbench.synth import _Station
    total = sum(_Station(p, rng, n, torch.device("cpu")).iq(0, n)
                for p in PARAMS)
    assert (got - total * 32768.0).abs().max() <= 0.5 + 1e-9
    # each station sits at its carrier: the spectrum's peaks are the four
    # offsets (of the 2.304 MS/s wire, 16384 points: 140.6 Hz a bin)
    z = torch.complex(got[:, 0], got[:, 1])
    spec = torch.fft.fftshift(torch.fft.fft(z).abs())
    freqs = torch.fft.fftshift(torch.fft.fftfreq(n, 1 / 2_304_000))
    for off in OFFSETS:
        near = (freqs - off).abs() < 80_000
        far = ((freqs - off).abs() > 250_000) & \
            ((freqs[:, None] - torch.tensor(OFFSETS)).abs().min(-1).values
             > 250_000)
        assert spec[near].sum() > 100 * spec[far].mean() * near.sum()


# ---------------------------------------------------------------------------
# on the card: the calibration of a 19-receiver scan of the four stations
# ---------------------------------------------------------------------------

CARD_BLOCK_FM = 131072
CARD_BLOCKS = 32              # the stereo_rds recording: 21.85 s, 201 MB
CARD_SEEDS = (2 ** 31 + 1901, 2 ** 31 + 1902, 2 ** 31 + 1903)
STATION_AUDIO_ERR = 1e-4      # the stereo_rds configuration's limit


def _control_kind(tmp_path):
    """A traffic kind added by a file, with the hook `calibrate.py` takes
    its input and tunings from: the four stations at their offsets."""
    (tmp_path / "traffic").mkdir(exist_ok=True)
    (tmp_path / "traffic" / "stations_probe.py").write_text(textwrap.dedent(
        '''
        from fmbench.synth import StationParams, StationsSynth

        def input_blocks(traffic, wire_len, seconds):
            return int(traffic["blocks"])

        def run(ctx):
            raise NotImplementedError("calibration only")

        def control_input(ctx, nblocks):
            T = 12 * int(ctx.receiver["block_fm"])
            st = [StationParams.from_dict(d)
                  for d in ctx.traffic["stations"]]
            syn = StationsSynth(st, ctx.seed, nblocks * T, ctx.device,
                                ctx.traffic["noise_std"])
            wire = syn.next(nblocks * T).cpu().numpy()
            return wire, [(p, int(p.carrier_hz)) for p in st]
        '''))
    stations = [{"left_hz": p.left_hz, "right_hz": p.right_hz,
                 "rds_level": p.rds_level, "amplitude": p.amplitude,
                 "pi": p.pi, "ps": p.ps, "rt": p.rt,
                 "carrier_hz": p.carrier_hz} for p in PARAMS]
    (tmp_path / "traffic" / "file_19_probe.json").write_text(json.dumps(
        {"kind": "stations_probe", "blocks": CARD_BLOCKS,
         "noise_std": 0.01, "stations": stations}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "stereo_rds.file_19_probe",
                              "config": "stereo_rds",
                              "traffic": "file_19_probe", "chips": 1,
                              "why": "calibration"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(tmp_path / "BENCHMARK.json", base=tmp_path)


def test_control_input_hook_on_the_cpu(tmp_path):
    """`calibrate.py` takes a kind's input and tunings from its hook; on
    the CPU (no TF32) the control equals the reference at every tuning."""
    from fmbench.calibrate import control
    torch.set_num_threads(4)
    bench = _control_kind(tmp_path)
    got = control(bench, "stereo_rds.file_19_probe", 5, 1.0, "cpu",
                  {"block_fm": BLOCK_FM}, {"blocks": 4})
    assert sorted(got["by_tune_hz"]) == sorted(str(o) for o in OFFSETS)
    assert got["control"]["audio_err"] == 0 and got["fails"] == []


def _sync(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@pytest.mark.card
def test_card_calibration_of_19_receivers(tmp_path):
    """The four-station capture at the stereo_rds geometry, made on the
    card; `demodulate_stations(scan=True)` over the 19 receivers of the
    100 kHz raster across +-900 kHz, and the tuned reference once a
    receiver.  The four station receivers agree within the configuration's
    limits; every receiver's readings are recorded (those on empty or
    adjacent channels demodulate noise and may not agree).  Then the TF32
    control at the four station receivers, which has to fail the limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from fmbench.calibrate import control
    from sdrjfm_tpu_torch.models.multistation import demodulate_stations
    from sdrjfm_tpu_torch.models.receiver import Receiver, ReceiverConfig
    dev = torch.device("cuda")
    cfg = dict(CFG, block_fm=CARD_BLOCK_FM)
    Tc = 12 * CARD_BLOCK_FM
    card, seeds = torch.cuda.get_device_name(dev), []
    rx = Receiver(ReceiverConfig(**cfg), device=dev)
    for seed in CARD_SEEDS:
        wire, synth_s = _sync(lambda: StationsSynth(
            PARAMS, seed, CARD_BLOCKS * Tc, dev).next(CARD_BLOCKS * Tc)
            .cpu().numpy())
        demodulate_stations(rx, wire, RASTER_19, scan=True)     # warm
        torch.cuda.reset_peak_memory_stats(dev)
        res, call_s = _sync(lambda: demodulate_stations(
            rx, wire, RASTER_19, scan=True))
        peak = torch.cuda.max_memory_allocated(dev)
        block = _blocks(wire, Tc)
        rows = []
        for r in res:
            off = r["offset_hz"]
            ref, ref_s = _sync(lambda: reference_outputs(
                cfg, block, CARD_BLOCKS, dev, tune_hz=off))
            k = OFFSETS.index(off) if off in OFFSETS else None
            run = ProgramRun(CARD_BLOCKS, r["audio"],
                             r["rds_bits"].astype(np.int8), None, cfg,
                             PARAMS[k] if k is not None else None, block, off)
            got = numbers([(run, ref)])
            rows.append({"offset_hz": off, "station": k is not None,
                         "reference_s": ref_s, **got})
        seeds.append({"card": card, "seed": seed, "synth_s": synth_s,
                      "program_call_s": call_s, "memory_peak_bytes": peak,
                      "receivers": rows})
        print(json.dumps(seeds[-1]), flush=True)
    bench = _control_kind(tmp_path)
    controls = [control(bench, "stereo_rds.file_19_probe", s, 30.0, "cuda")
                for s in CARD_SEEDS]
    for c in controls:
        print(json.dumps({k: c[k] for k in ("seed", "control", "by_tune_hz",
                                            "fails", "seconds")}), flush=True)
    for s in seeds:
        for row in s["receivers"]:
            if row["station"]:
                assert row["audio_err"] <= STATION_AUDIO_ERR, row
                assert row["rds_bit_errors"] == 0, row
    for c in controls:
        assert "audio_err" in c["fails"], c
        assert all(v["audio_err"] > STATION_AUDIO_ERR
                   for v in c["by_tune_hz"].values()), c
