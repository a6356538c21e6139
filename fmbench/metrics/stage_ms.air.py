"""Runner staging: the host's milliseconds a block in
`ScanGraph.load_blocks` (the recording's copy into the pinned staging
buffer and the queued upload), the mean over the window's chunks outside
the profiled passes, by the harness's host clock."""

import numpy as np


def read(view):
    ms = view.stamps.get("stage_ms")
    if ms is None or not len(ms):
        return None
    return float(np.mean(ms))
