"""The numbers `correct` compares: a run of the timed path against the
plain reference over the same input.

The audio is compared sample for sample.  The RDS bits are compared as one
stream: the program's bits laid end to end against the reference's, from
the reference's pilot lock on, at the lag of a few bits where they agree
most.  Bit timing may settle on either of the two energy peaks of a
biphase symbol (its halves): the two frame the bits into blocks
differently, and may start the stream a bit apart, but decode to the same
stream, so one lag takes up the framing and nothing else.  A timing that
samples between the halves, wanders from one peak to the other, or slips a
bit flips the bits from there on, and they are counted.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

LAG = 4                       # bits either way one lag may take up
MARGIN = 0.05                 # a reference decision nearer 0 than this
                              # share of its symbols' RMS is not compared


def bit_errors(bits: np.ndarray, ref_bits: np.ndarray, ref_sym: np.ndarray,
               start: int) -> float:
    """The program's bits that differ from the reference's, over the
    reference's bits from `start` on, at the lag in [-LAG, LAG] where the
    fewest differ.  A reference bit whose decision (its symbol or the one
    before it) lies within MARGIN of 0 is left out; every reference bit the
    program's stream falls short of counts, and so does each program bit
    beyond the reference's end by more than one."""
    bits = np.asarray(bits, np.int8)
    ref_bits = np.asarray(ref_bits, np.int8)
    n, m = len(bits), len(ref_bits)
    if m <= start:
        return 0.0 if n <= m + 1 else float(n - m - 1)
    re = np.abs(np.asarray(ref_sym).real)
    scale = math.sqrt(float(np.mean(np.abs(ref_sym[start:]) ** 2)))
    sure = re > MARGIN * scale
    sure[1:] &= sure[:-1]
    k = np.arange(start, m)
    best = math.inf
    for lag in range(-LAG, LAG + 1):
        j = k + lag
        have = (j >= 0) & (j < n)
        cmp = have & sure[k]
        bad = np.count_nonzero(bits[j[cmp]] != ref_bits[k[cmp]])
        bad += np.count_nonzero(~have & (j >= n))
        bad += max(0, n - (m + lag) - 1)
        best = min(best, float(bad))
    return best


def numbers(judged: Sequence[Tuple[object, List[dict]]]) -> Dict[str, float]:
    """The numbers `correct` compares, worst over the runs, each run (a
    harness.ProgramRun) beside the reference's outputs over its input:

    - audio_err: the largest |audio - reference audio| of any sample;
    - rds_bit_errors: the program's RDS bits that differ from the
      reference's (`bit_errors`), from the first block after the
      reference's pilot lock; only where the receiver recovers RDS bits;
    - rds_decode_errors: the PI, PS and RT that the program's own RDS
      decoder reported, each against the station's, in the runs whose
      timed path runs that decoder."""
    got: Dict[str, float] = {"audio_err": 0.0}
    for run, ref in judged:
        n = run.nblocks
        want = np.concatenate([o["audio"] for o in ref[:n]])
        if len(ref) < n or run.audio.shape != want.shape:
            got["audio_err"] = math.inf
        else:
            got["audio_err"] = max(got["audio_err"], float(
                np.abs(run.audio - want).max()))
        if "bits" in ref[0]:
            lock = next((b for b in range(1, n) if ref[b - 1]["locked"]), n)
            start = sum(len(o["bits"]) for o in ref[:lock])
            e = bit_errors(run.bits,
                           np.concatenate([o["bits"] for o in ref[:n]]),
                           np.concatenate([o["iq"] for o in ref[:n]]),
                           start)
            got["rds_bit_errors"] = max(got.get("rds_bit_errors", 0.0), e)
        d, st = run.rds, run.station
        if d is not None:
            got["rds_decode_errors"] = got.get("rds_decode_errors", 0) + (
                int(d["pi"] != st.pi) + int(d["ps"] != st.ps)
                + int(d["rt"] != st.rt))
    return got
