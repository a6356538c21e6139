"""Captured step: the host's milliseconds a block in `scan.fetch_copy`,
`ScanGraph.fetch`'s copies of the chunk's outputs to the host once its
replays are done; the median over the passes (`scan.pass`) recorded while
no profiler ran, from the program's own spans."""

from fmbench.program_spans import per_parent_ms


def read(view):
    return per_parent_ms("scan.pass", ["scan.fetch_copy"], per_count=True)
