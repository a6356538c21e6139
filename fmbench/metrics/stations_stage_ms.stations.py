"""Captured step, n-station path: the host's milliseconds a block in
`scan.stage`, the staging of the whole capture into the scan graph's
chunk (its copy into pinned memory and the queued upload) inside
`demodulate_stations`; the median over the calls (`stations.pass`)
recorded while no profiler ran, from the program's own spans."""

from fmbench.program_spans import per_parent_ms


def read(view):
    return per_parent_ms("stations.pass", ["scan.stage"], per_count=True)
