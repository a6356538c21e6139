"""RDS block CRC / syndrome / Meggitt FEC arithmetic (host-side numpy).

Semantics source: src/rds/rds-blocksynchronizer.cpp:114-195 and the offset
word constants in rds-blocksynchronizer.h:81-90.  The encoder side (used only
by our test-fixture generator) is derived from the same syndrome function by
GF(2) linearity, so encode/decode parity is guaranteed by construction.
"""

from __future__ import annotations

import numpy as np

NUM_BITS_CRC = 10
NUM_BITS_PAYLOAD = 16
NUM_BITS_BLOCK = 26
CRC_POLY = 0x5B9            # x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1
REMAINDER_POLY = 0x31B

OFFSET_WORDS = {
    "A": 0xFC,
    "B": 0x198,
    "C1": 0x168,
    "C2": 0x350,
    "D": 0x1B4,
}


def syndrome(bits26: int, offset_word: int) -> int:
    """LFSR syndrome over the 26-bit block (rds-blocksynchronizer.cpp:114-130)."""
    block = bits26 ^ offset_word
    reg = 0
    for k in range(NUM_BITS_BLOCK - 1, -1, -1):
        msb = reg & (1 << (NUM_BITS_CRC - 1))
        reg = (reg << 1) & 0x7FF
        if msb:
            reg ^= CRC_POLY
        if (block >> k) & 1:
            reg ^= REMAINDER_POLY
    return reg & 0x3FF


# --- encoder: solve for the 10 checkbits that zero the syndrome -------------

def _syndrome_matrix():
    cols = [syndrome(1 << j, 0) for j in range(NUM_BITS_BLOCK)]
    return cols


_COLS = _syndrome_matrix()


def encode_block(info16: int, offset_name: str) -> int:
    """26-bit block whose syndrome against the named offset word is zero."""
    offset = OFFSET_WORDS[offset_name]
    target = syndrome(info16 << NUM_BITS_CRC, offset)
    # choose checkbits c (10 bits) with syndrome(c, 0) == target  (linearity)
    basis = _COLS[:NUM_BITS_CRC]            # syndromes of bits 0..9
    c = 0
    acc = target
    # gaussian elimination over GF(2), 10 unknowns
    rows = list(range(10))
    mat = [basis[j] for j in range(10)]
    pivots = {}
    vec = [1 << j for j in range(10)]       # track combination
    for bit in range(9, -1, -1):
        piv = None
        for j in range(10):
            if j in pivots.values():
                continue
            if (mat[j] >> bit) & 1:
                piv = j
                break
        if piv is None:
            continue
        pivots[bit] = piv
        for j in range(10):
            if j != piv and ((mat[j] >> bit) & 1):
                mat[j] ^= mat[piv]
                vec[j] ^= vec[piv]
    for bit in range(9, -1, -1):
        if (acc >> bit) & 1:
            piv = pivots.get(bit)
            assert piv is not None, "syndrome matrix not full rank?"
            acc ^= mat[piv]
            c ^= vec[piv]
    assert acc == 0
    block = (info16 << NUM_BITS_CRC) | c
    assert syndrome(block, offset) == 0
    return block


def _burst_syndrome_table():
    """syndrome -> error mask, for all bursts of length <= 5 in 26 bits.

    The RDS (26,16) shortened cyclic code corrects any single burst spanning
    at most 5 bits — the capability the reference's Meggitt loop
    (rds-blocksynchronizer.cpp:175-195) is meant to implement.  (As written
    there, the loop's corrections are computed but the block is still
    reported as a CRC failure, decodeBlock:148-171, so the reference never
    actually rescues a block; see blocksync.py for how we diverge.)  Building
    the table from `syndrome()` itself guarantees consistency: for a received
    word r = c + e, syndrome(r, off) == syndrome(e, 0) by GF(2) linearity.
    """
    table = {}
    for pattern in range(1, 32, 2):          # bursts starting with a set bit
        length = pattern.bit_length()
        for shift in range(0, NUM_BITS_BLOCK - length + 1):
            e = pattern << shift
            s = syndrome(e, 0)
            table.setdefault(s, e)
    return table


_BURST_TABLE = _burst_syndrome_table()


def meggitt_correct(bits26: int, synd: int):
    """Burst-error correction. Returns (corrected block, residual syndrome,
    n_corrected_bits); residual is 0 iff the syndrome matched a correctable
    (<=5-bit) burst."""
    e = _BURST_TABLE.get(synd & 0x3FF)
    if e is None:
        return bits26, synd & 0x3FF, 0
    return bits26 ^ e, 0, bin(e).count("1")
