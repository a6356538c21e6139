"""RDS groups for the benchmark's station (IEC 62106): 0A groups carry the
programme service name, 2A groups the radiotext.  The checkword of a block
is its 16 information bits times x^10 modulo g(x) = x^10 + x^8 + x^7 + x^5
+ x^4 + x^3 + 1, plus the block's offset word."""

from __future__ import annotations

import numpy as np

POLY = 0x5B9
OFFSETS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "C'": 0x350, "D": 0x1B4}


def checkword(info: int, offset: str) -> int:
    reg = (info & 0xFFFF) << 10
    for bit in range(25, 9, -1):
        if reg >> bit & 1:
            reg ^= POLY << (bit - 10)
    return reg ^ OFFSETS[offset]


def block_bits(info: int, offset: str) -> list:
    word = ((info & 0xFFFF) << 10) | checkword(info, offset)
    return [(word >> k) & 1 for k in range(25, -1, -1)]


def group_bits(a: int, b: int, c: int, d: int) -> list:
    return (block_bits(a, "A") + block_bits(b, "B") + block_bits(c, "C")
            + block_bits(d, "D"))


def group_rotation(pi: int, pty: int, ps: str, rt: str) -> np.ndarray:
    """One rotation of data bits: four 0A groups (the PS name two
    characters each, music, no alternative frequency) then sixteen 2A
    groups (the radiotext, ended by a carriage return and padded with
    spaces to 64 characters)."""
    ps = (ps + " " * 8)[:8]
    rt = ((rt + "\r") + " " * 64)[:64]
    bits = []
    for seg in range(4):
        b = (pty << 5) | (1 << 3) | seg
        d = (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])
        bits += group_bits(pi, b, 0xE0E0, d)
    for seg in range(16):
        b = (2 << 12) | (pty << 5) | seg
        c = (ord(rt[4 * seg]) << 8) | ord(rt[4 * seg + 1])
        d = (ord(rt[4 * seg + 2]) << 8) | ord(rt[4 * seg + 3])
        bits += group_bits(pi, b, c, d)
    return np.asarray(bits, np.int8)
