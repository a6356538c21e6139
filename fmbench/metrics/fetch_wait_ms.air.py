"""Captured step: the host's milliseconds a block in `scan.fetch_wait`,
`ScanGraph.fetch`'s wait for the chunk's replays before its copies down;
the median over the passes (`scan.pass`) recorded while no profiler ran,
from the program's own spans."""

from fmbench.program_spans import per_parent_ms


def read(view):
    return per_parent_ms("scan.pass", ["scan.fetch_wait"], per_count=True)
