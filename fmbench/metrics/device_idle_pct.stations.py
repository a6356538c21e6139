"""Device: the share of the traced passes of `demodulate_stations` in
which no kernel, copy or fill ran on the card."""


def read(view):
    tr = view.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
