#!/usr/bin/env python3
"""The control of a cell's check: the plain reference put in the
program's place and computed in the precision below the one the
configuration states (the card's TF32 routes for float32 with TF32 off),
judged by the same numbers against the reference at float32, on the
cell's own input sizes.

    python3 fmbench/calibrate.py --workload <name> --seeds 11,12,13 \
        [--seconds 30]

Prints one JSON line a seed: the control's numbers and the cell's limits.
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


def control(bench, workload: str, seed: int, seconds: float, device: str,
            receiver_overrides=None, traffic_overrides=None) -> dict:
    import torch
    from fmbench.compare import numbers
    from fmbench.harness import reference_outputs, reference_run
    from fmbench.synth import StationParams, StationSynth
    w = bench.workload(workload)
    config = bench.config(w["config"])
    traffic = {**bench.traffic(w["traffic"]), **(traffic_overrides or {})}
    receiver = {**config["receiver"], **(receiver_overrides or {})}
    T = 12 * int(receiver["block_fm"])
    nb = bench.kind(traffic["kind"]).input_blocks(traffic, T, seconds)
    station = StationParams.from_dict(traffic.get("station", {}))
    wire = StationSynth(station, seed, T * nb, device).next(T * nb)
    wire = wire.cpu().numpy()

    def block(b):
        return wire[b * T:(b + 1) * T]

    t0 = time.monotonic()
    ref = reference_outputs(receiver, block, nb, torch.device(device), "f32")
    low = reference_outputs(receiver, block, nb, torch.device(device), "tf32")
    got = numbers([(reference_run(low, receiver, station, block), ref)])
    return {"workload": workload, "seed": seed, "blocks": nb,
            "control": got, "limits": config["checks"],
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
