"""A plain RDS group decoder for the reference's bits (IEC 62106): block
sync by syndromes, then 0A/0B groups for the programme service name and 2A
groups for the radiotext."""

from __future__ import annotations

import numpy as np

POLY = 0x5B9
OFFSETS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "C'": 0x350, "D": 0x1B4}


def _remainders(words: np.ndarray) -> np.ndarray:
    """Each 26-bit word modulo g(x) (10 bits)."""
    r = words.astype(np.int64).copy()
    for bit in range(25, 9, -1):
        hit = (r >> bit) & 1
        r ^= hit * (POLY << (bit - 10))
    return r


def _words(bits: np.ndarray) -> np.ndarray:
    """The 26-bit word starting at every bit position (MSB first)."""
    b = bits.astype(np.int64)
    n = len(b) - 25
    if n <= 0:
        return np.zeros(0, np.int64)
    w = np.zeros(n, np.int64)
    for k in range(26):
        w = (w << 1) | b[k:k + n]
    return w


def decode(bits) -> dict:
    """PI, PS and RT from a stream of RDS data bits, with the counts of
    groups decoded and of blocks that failed their checkword once in
    sync."""
    bits = np.asarray(bits, np.int64)
    words = _words(bits)
    rem = {k: _remainders(words ^ v) for k, v in OFFSETS.items()}
    n = len(words)
    pi, groups, crc_errors = None, 0, 0
    ps, rt = [" "] * 8, [" "] * 64
    ps_seen, rt_end = 0, None
    i = 0
    while i + 78 < n:
        # acquisition: A, B, C or C', D at 26-bit spacing
        if not (rem["A"][i] == 0 and rem["B"][i + 26] == 0
                and (rem["C"][i + 52] == 0 or rem["C'"][i + 52] == 0)
                and rem["D"][i + 78] == 0):
            i += 1
            continue
        misses = 0
        while i + 78 < n and misses < 2:
            blk = [int(words[i + 26 * j]) >> 10 for j in range(4)]
            good = [rem["A"][i] == 0, rem["B"][i + 26] == 0,
                    rem["C"][i + 52] == 0 or rem["C'"][i + 52] == 0,
                    rem["D"][i + 78] == 0]
            if not all(good):
                crc_errors += 4 - sum(good)
                misses += 1
                i += 104
                continue
            misses = 0
            groups += 1
            a, b, c, d = blk
            pi = a
            gtype, ver = b >> 12, (b >> 11) & 1
            if gtype == 0:
                seg = b & 3
                ps[2 * seg], ps[2 * seg + 1] = chr(d >> 8), chr(d & 0xFF)
                ps_seen |= 1 << seg
            elif gtype == 2 and ver == 0:
                seg = b & 0xF
                for k, ch in enumerate((c >> 8, c & 0xFF, d >> 8, d & 0xFF)):
                    rt[4 * seg + k] = chr(ch)
                    if ch == 0x0D and rt_end is None:
                        rt_end = 4 * seg + k
            i += 104
    text = "".join(rt[:rt_end] if rt_end is not None else rt)
    return {"pi": pi, "ps": "".join(ps).strip() if ps_seen == 15 else None,
            "rt": text.strip() if rt_end is not None else None,
            "groups": groups, "crc_errors": crc_errors}
