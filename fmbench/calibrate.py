#!/usr/bin/env python3
"""The control of a cell's check: the plain reference put in the
program's place and computed in the precision below the one the
configuration states (the card's TF32 routes for float32 with TF32 off),
judged by the same numbers against the reference at float32, on the
cell's own input sizes.  The input, its stations and the receivers'
tunings come from the cell's traffic kind (its `control_input`, where it
has one; else the traffic's one station at 0 Hz), and the reference from
the cell's configuration.

    python3 fmbench/calibrate.py --workload <name> --seeds 11,12,13 \
        [--seconds 30]

Prints one JSON line a seed: the control's numbers (the worst over the
receivers, and each receiver's by its tuning) and the cell's limits.
Each limit must sit below the smallest control reading of some number
(the control has to come out not correct) and above every sound run's
reading.  The benchmark's own runs never run this.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def default_input(ctx, nblocks: int):
    """The traffic's one station at 0 Hz, `nblocks` receiver blocks."""
    from fmbench.synth import StationParams, StationSynth
    n = 12 * int(ctx.receiver["block_fm"]) * nblocks
    station = StationParams.from_dict(ctx.traffic.get("station", {}))
    wire = StationSynth(station, ctx.seed, n, ctx.device).next(n)
    return wire.cpu().numpy(), [(station, 0)]


def control(bench, workload: str, seed: int, seconds: float, device: str,
            receiver_overrides=None, traffic_overrides=None) -> dict:
    import torch
    from fmbench.compare import numbers
    from fmbench.harness import Context, reference_outputs, reference_run
    w = bench.workload(workload)
    config = bench.config(w["config"])
    traffic = {**bench.traffic(w["traffic"]), **(traffic_overrides or {})}
    receiver = {**config["receiver"], **(receiver_overrides or {})}
    T = 12 * int(receiver["block_fm"])
    kind = bench.kind(traffic["kind"])
    nb = kind.input_blocks(traffic, T, seconds)
    dev = torch.device(device)
    ctx = Context(receiver, traffic, int(seed), float(seconds), False, dev,
                  time.monotonic(), config)
    wire, tuned = getattr(kind, "control_input", default_input)(ctx, nb)
    module = bench.reference(config)

    def block(b):
        return wire[b * T:(b + 1) * T]

    t0 = time.monotonic()
    each = {}
    judged = []
    for station, tune in tuned:
        ref = reference_outputs(receiver, block, nb, dev, "f32", tune, module)
        low = reference_outputs(receiver, block, nb, dev, "tf32", tune,
                                module)
        pair = (reference_run(low, receiver, station, block, tune), ref)
        each[str(tune)] = numbers([pair])
        judged.append(pair)
    got = numbers(judged)
    return {"workload": workload, "seed": seed, "blocks": nb,
            "control": got, "by_tune_hz": each, "limits": config["checks"],
            "fails": [k for k, v in config["checks"].items()
                      if got.get(k, float("inf")) > v],
            "seconds": time.monotonic() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from fmbench.harness import Bench
    bench = Bench()
    seconds = args.seconds or bench.spec["run_seconds"]
    for s in args.seeds.split(","):
        print(json.dumps(control(bench, args.workload, int(s), seconds,
                                 args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
