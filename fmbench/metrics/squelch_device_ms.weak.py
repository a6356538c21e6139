"""Squelch: the kernel milliseconds a block that the squelch launches
(the program's span `rx.squelch`: both band filters in the pole-bank
kernel, then the squelch gate), from the eager attribution pass.  A
program without the span gives nothing."""


def read(view):
    a = view.attribution
    if not a or not a.get("rx.squelch") or not view.attribution_blocks:
        return None
    return a["rx.squelch"] * 1e-3 / view.attribution_blocks
