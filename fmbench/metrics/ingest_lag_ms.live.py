"""Live source: the median, over the window's blocks, of how long after
the generator offered a block's last chunk to the pipe its `read_block`
returned (the generator's and the harness's stamps around
NativePipeSource; the generator's own lateness is not charged here)."""

import numpy as np


def read(view):
    s = view.stamps
    if "read" not in s or "offered" not in s:
        return None
    d = s["read"] - s["offered"]
    return float(np.nanmedian(d) * 1e3) if np.isfinite(d).any() else None
