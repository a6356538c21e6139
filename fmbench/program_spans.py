"""What the per-layer metrics of source `program_span` and
`program_counter` read: the record of the program's own tracer
(`sdrjfm_tpu_torch.runtime.spans`) in this process, which the run of the
cell has filled.  A checkout whose program has no tracer gives None, and
the metric is left out of the line."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional

import numpy as np


def records() -> Optional[list]:
    """The program's spans and stamps, in the order they began, or None."""
    try:
        from sdrjfm_tpu_torch.runtime import spans
    except ImportError:
        return None
    return spans.records() or None


def _children(recs) -> Dict[int, list]:
    kids: Dict[int, list] = defaultdict(list)
    for r in recs:
        kids[r.parent].append(r)
    return kids


def _median(values: List[float]) -> Optional[float]:
    return float(np.median(values)) if values else None


def per_parent_ms(parent: str, names: Iterable[str],
                  per_count: bool = False) -> Optional[float]:
    """The median, over the `parent` spans that began while no profiler
    recorded, of the milliseconds in their direct children named `names`
    (a block of the parent's count with per_count)."""
    recs = records()
    if recs is None:
        return None
    names, kids = set(names), _children(recs)
    vals = []
    for p in recs:
        if p.name != parent or p.profiled or (per_count and p.count <= 0):
            continue
        ns = sum(c.t1 - c.t0 for c in kids[p.seq] if c.name in names)
        vals.append(ns * 1e-6 / (p.count if per_count else 1))
    return _median(vals)


def after_stamp_ms(parent: str, stamp: str) -> Optional[float]:
    """The median, over the `stamp` records inside `parent` spans that
    began while no profiler recorded, of the parent's end minus the
    stamp, in milliseconds."""
    recs = records()
    if recs is None:
        return None
    by_seq = {r.seq: r for r in recs}
    vals = []
    for s in recs:
        p = by_seq.get(s.parent)
        if s.name == stamp and p is not None and p.name == parent \
                and not p.profiled:
            vals.append((p.t1 - s.t0) * 1e-6)
    return _median(vals)


def self_seconds(name: str) -> Optional[float]:
    """The seconds in the spans named `name` outside their direct
    children, summed over the record."""
    recs = records()
    if recs is None:
        return None
    kids = _children(recs)
    own = [r.t1 - r.t0 - sum(c.t1 - c.t0 for c in kids[r.seq])
           for r in recs if r.name == name]
    return sum(own) * 1e-9 if own else None
