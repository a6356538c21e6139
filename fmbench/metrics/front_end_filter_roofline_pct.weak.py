"""Kernels: the filtered front end's share of its roofline, the least time
the card could take for one block's front-end work with the strong input
filter (`filtered_bound_ms`) over the kernel time a block of every kernel
`Receiver.front_end` launches (the attribution pass's range `front_end`
and, inside it, the program's span `rx.input_filter`).  A program
without the span gives nothing.

The work, whatever implements it: the wire read once ([T, 2] int16), the
192 kS/s output written once (complex64), the input filter's and the
÷12's carries read and written, the filter's response and the taps read; five operations a point and stage of a
transform (5 N log2 N) for the forward and the inverse transform of each
hop, six a point for the product with the response, four a tap and
output of the ÷12, and ten a wire frame (decode, gains, DC, mix)."""

import math

from fmbench.peaks import FRONT_END_DECIM, FRONT_END_TAPS, bound_ms

INPUT_FFT = 65536
INPUT_HOP = 49152


def filtered_bound_ms(block_fm: int, wire_bytes_per_frame: int = 4) -> float:
    T = block_fm * FRONT_END_DECIM
    hops = T // INPUT_HOP
    N = INPUT_FFT
    carries = 2 * ((N - INPUT_HOP) + (FRONT_END_TAPS - 1)) * 8
    nbytes = T * wire_bytes_per_frame + block_fm * 8 + carries \
        + N * 8 + FRONT_END_TAPS * 4
    flops = hops * (2 * 5 * N * math.log2(N) + 6 * N) \
        + 4 * FRONT_END_TAPS * block_fm + 10 * T
    return bound_ms(nbytes, flops)


def read(view):
    a = view.attribution
    if not a or not a.get("front_end") or not a.get("rx.input_filter") \
            or not view.attribution_blocks:
        return None
    ms = (a["front_end"] + a["rx.input_filter"]) * 1e-3 \
        / view.attribution_blocks
    return 100.0 * filtered_bound_ms(int(view.receiver["block_fm"])) / ms
