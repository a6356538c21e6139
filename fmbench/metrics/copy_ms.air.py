"""Runner staging and fetch: the device's host<->device copy time a block
in the traced passes (the profiler's memcpy records)."""


def read(view):
    tr = view.trace
    if tr is None or not view.trace_blocks:
        return None
    cp = [e for e in tr.in_window(tr.memcpy)
          if "HtoD" in e["name"] or "DtoH" in e["name"]]
    if not cp:
        return None
    return sum(e["dur"] for e in cp) * 1e-3 / view.trace_blocks
