#!/usr/bin/env python3
"""Run one cell of the benchmark of sdrjfm_tpu_torch once, on the card.

    python3 fmbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names its configuration
(`configs/<config>.json`), its traffic (`traffic/<traffic>.json`, whose
"kind" names `traffic/<kind>.py`) and, through BENCHMARK.json, its
per-layer metrics (`metrics/<name>.py`).  With --trace 0 the result holds
the cell's end-to-end metrics, with --trace 1 its per-layer metrics.  The
last line of standard output is the result as one JSON object; the
numbers `correct` compares, each beside its limit, are the last lines of
standard error and the result's last key.  Without a CUDA card the run
exits 2 and prints no result.  Every build and kernel cache stays in
fmbench/.cache and the program's own build directory inside the checkout.
"""

import os
import sys
import time

T_START = time.monotonic()
HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path.insert(0, os.path.dirname(HERE))

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402


def finite(x):
    """The result with an infinite reading (a failed block's latency, a
    shape that does not match) as +-1e300 and NaN as null: strict JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None if math.isnan(x) else math.copysign(1e300, x)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from fmbench.harness import Bench, forbidden_modules, log, run_cell
    bench = Bench()
    chips = bench.workload(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {', '.join(bad)}: no result")
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
