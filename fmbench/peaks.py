"""The card's published peaks and the work counts that roofline shares
are taken against.

NVIDIA H100 SXM data sheet: HBM at 3.35 TB/s and 67 TFLOP/s in float32
outside the tensor cores, at the full 700 W power limit."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

FRONT_END_TAPS = 307          # the composite ÷12 lowpass
FRONT_END_DECIM = 12


def bound_ms(nbytes: float, flops: float) -> float:
    """The least time the card could take for this work (ms)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3


def front_end_bound_ms(block_fm: int, wire_bytes_per_frame: int = 4) -> float:
    """The front end's work for one block, whatever implements it: the
    wire read once ([T, 2] int16), the 192 kS/s output written once
    (complex64), the filter's carry read and written, the taps read; four
    operations a tap and output (a complex sample through real taps) and
    ten a wire frame (decode, gains, DC, mix)."""
    T = block_fm * FRONT_END_DECIM
    halo = FRONT_END_TAPS - 1
    nbytes = T * wire_bytes_per_frame + block_fm * 8 + 2 * halo * 8 \
        + FRONT_END_TAPS * 4
    flops = 4 * FRONT_END_TAPS * block_fm + 10 * T
    return bound_ms(nbytes, flops)
