"""Live runner: the median, over the window's blocks, of the time from a
block's `read_block` return to the `on_audio` call that hands its audio
over (run_live reads the next block before it delivers this one)."""

import numpy as np


def read(view):
    s = view.stamps
    if "audio" not in s:
        return None
    d = s["audio"] - s["read"]
    return float(np.nanmedian(d) * 1e3) if np.isfinite(d).any() else None
