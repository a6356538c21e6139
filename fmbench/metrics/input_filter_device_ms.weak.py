"""Front end, input filter: the kernel milliseconds a block that the
strong input filter launches (the program's span `rx.input_filter`: the
65536-point overlap-save filter at the input rate), from the eager
attribution pass.  A program without the span gives nothing."""


def read(view):
    a = view.attribution
    if not a or not a.get("rx.input_filter") or not view.attribution_blocks:
        return None
    return a["rx.input_filter"] * 1e-3 / view.attribution_blocks
