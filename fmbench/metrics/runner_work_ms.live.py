"""Live runner: the runner's own host milliseconds a block, outside its
wait for the next block: the sum of `live.upload`, `live.step`,
`live.fetch_wait`, `live.deliver` and `live.hooks` in a `live.block`; the
median over the blocks recorded while no profiler ran, from the program's
own spans."""

from fmbench.program_spans import per_parent_ms

PARTS = ("live.upload", "live.step", "live.fetch_wait", "live.deliver",
         "live.hooks")


def read(view):
    return per_parent_ms("live.block", PARTS)
