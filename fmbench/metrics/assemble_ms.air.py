"""Scan runner: the host's milliseconds a block in `scan.assemble`,
`run_offline_scanned`'s assembly of its result from the fetched chunks
(the per-block lists, the meta dicts, the copy of the final state); the
median over the passes (`scan.pass`) recorded while no profiler ran, from
the program's own spans."""

from fmbench.program_spans import per_parent_ms


def read(view):
    return per_parent_ms("scan.pass", ["scan.assemble"], per_count=True)
