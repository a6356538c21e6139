"""n-station runner: the host's milliseconds a block in
`stations.assemble`, `demodulate_stations`' split of the fetched outputs
into each station's audio, RDS bits and metadata; the median over the
calls (`stations.pass`) recorded while no profiler ran, from the
program's own spans."""

from fmbench.program_spans import per_parent_ms


def read(view):
    return per_parent_ms("stations.pass", ["stations.assemble"],
                         per_count=True)
