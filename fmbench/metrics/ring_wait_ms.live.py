"""Live source: the median, over the blocks read while no profiler ran, of
the time from the ring's receipt of a block's last frame (the ingest
thread's arrival stamp, `source.arrival`) to the return of the
`source.read` that took it; both on CLOCK_MONOTONIC.  The part of
`ingest_lag_ms.live` after the frames reached the ring."""

from fmbench.program_spans import after_stamp_ms


def read(view):
    return after_stamp_ms("source.read", "source.arrival")
