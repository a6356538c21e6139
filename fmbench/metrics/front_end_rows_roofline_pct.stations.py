"""Kernels: the R-row front end's share of its roofline, the least time
the card could take for one block's front-end work on R rows of one
shared wire block, over the kernel time a block of every kernel
`Receiver.front_end_rows` launches (the eager attribution pass).  R is
the attribution's row count (the stamp `front_end_rows`).

The work, whatever implements it: the wire read once ([T, 2] int16), each
row's 192 kS/s output written once (complex64) and its filter carry read
and written, the taps read once; four operations a tap and output on each
row, and ten a wire frame on each row (decode, gains, DC, mix)."""

from fmbench.peaks import FRONT_END_DECIM, FRONT_END_TAPS, bound_ms


def rows_bound_ms(block_fm: int, rows: int,
                  wire_bytes_per_frame: int = 4) -> float:
    T = block_fm * FRONT_END_DECIM
    halo = FRONT_END_TAPS - 1
    nbytes = T * wire_bytes_per_frame + rows * (block_fm * 8 + 2 * halo * 8) \
        + FRONT_END_TAPS * 4
    flops = rows * (4 * FRONT_END_TAPS * block_fm + 10 * T)
    return bound_ms(nbytes, flops)


def read(view):
    a = view.attribution
    rows = view.stamps.get("front_end_rows")
    if not a or not a.get("front_end") or not view.attribution_blocks \
            or rows is None or not len(rows):
        return None
    ms = a["front_end"] * 1e-3 / view.attribution_blocks
    return 100.0 * rows_bound_ms(int(view.receiver["block_fm"]),
                                 int(rows[0])) / ms
