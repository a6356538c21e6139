"""Kernels: the front end's share of its roofline, the least time the
card could take for one block's front-end work (`peaks.front_end_bound_ms`)
over the kernel time a block of every kernel `Receiver.front_end`
launches (the eager attribution pass)."""

from fmbench.peaks import front_end_bound_ms


def read(view):
    a = view.attribution
    if not a or not a.get("front_end") or not view.attribution_blocks:
        return None
    ms = a["front_end"] * 1e-3 / view.attribution_blocks
    return 100.0 * front_end_bound_ms(int(view.receiver["block_fm"])) / ms
