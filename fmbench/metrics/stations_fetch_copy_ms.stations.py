"""Captured step, n-station path: the host's milliseconds a block in
`scan.fetch_copy`, the copies of every receiver's outputs to the host once
the capture's replays are done; the median over the calls of
`demodulate_stations` (`stations.pass`) recorded while no profiler ran,
from the program's own spans."""

from fmbench.program_spans import per_parent_ms


def read(view):
    return per_parent_ms("stations.pass", ["scan.fetch_copy"],
                         per_count=True)
