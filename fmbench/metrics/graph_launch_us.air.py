"""Captured step: the host's microseconds in one graph replay (one
cudaGraphLaunch), the mean over the window's replays outside the profiled
passes, stamped by the harness's host clock (the profiler's activity
tracing would add its own cost to every launch)."""

import numpy as np


def read(view):
    us = view.stamps.get("replay_us")
    if us is None or not len(us):
        return None
    return float(np.mean(us))
