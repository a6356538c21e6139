"""Receiver step, live: the kernel milliseconds a block in the traced
stretch of the live window."""


def read(view):
    tr = view.trace
    if tr is None or not view.trace_blocks:
        return None
    ks = tr.in_window(tr.kernels)
    if not ks:
        return None
    return sum(e["dur"] for e in ks) * 1e-3 / view.trace_blocks
