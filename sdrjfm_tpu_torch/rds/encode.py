"""RDS group/bitstream encoder — test-fixture generator.

The reference ships no fixtures; our end-to-end tests need a spec-correct
bitstream whose decode is known.  Groups are assembled per the RDS layer the
group decoder consumes (rds-groupdecoder.cpp:170-295) and protected with the
checkword arithmetic of rds/crc.py (derived from the block synchronizer's own
syndrome function, so encode/decode are consistent by construction).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

from . import crc


def encode_group(block_a: int, block_b: int, block_c: int, block_d: int,
                 is_type_b: bool = False) -> List[int]:
    """Returns the 104 bits of one group (4 x 26), MSB first per block."""
    names = ["A", "B", "C2" if is_type_b else "C1", "D"]
    bits: List[int] = []
    for info, name in zip((block_a, block_b, block_c, block_d), names):
        blk = crc.encode_block(info & 0xFFFF, name)
        bits.extend((blk >> k) & 1 for k in range(25, -1, -1))
    return bits


def group_0a(pi: int, pty: int, segment: int, char_pair: str,
             af_pair: int = 0xE0E0, tp: int = 0, ta: int = 0,
             ms: int = 1) -> List[int]:
    """Basic tuning group: 2 station-name chars at `segment` (0..3)."""
    b = (0 << 12) | (0 << 11) | (tp << 10) | (pty << 5) | (ta << 4) \
        | (ms << 3) | (0 << 2) | segment
    d = (ord(char_pair[0]) << 8) | ord(char_pair[1])
    return encode_group(pi, b, af_pair, d)


def group_2a(pi: int, pty: int, segment: int, chars4: str,
             ab_flag: int = 0) -> List[int]:
    """Radio-text group: 4 chars at `segment` (0..15)."""
    b = (2 << 12) | (0 << 11) | (pty << 5) | (ab_flag << 4) | segment
    c = (ord(chars4[0]) << 8) | ord(chars4[1])
    d = (ord(chars4[2]) << 8) | ord(chars4[3])
    return encode_group(pi, b, c, d)


def make_bitstream(pi: int = 0x10F0, pty: int = 10,
                   station: str = "TPU FM  ",
                   radiotext: str = "JAX/XLA broadcast FM receiver\r",
                   repeats: int = 8) -> np.ndarray:
    """A realistic rotation of 0A and 2A groups, differentially *decoded*
    domain (these are the data bits before differential encoding)."""
    station = (station + " " * 8)[:8]
    rt = (radiotext + " " * 64)[:64]
    bits: List[int] = []
    for _ in range(repeats):
        for seg in range(4):
            bits.extend(group_0a(pi, pty, seg, station[2 * seg : 2 * seg + 2]))
        for seg in range(16):
            bits.extend(group_2a(pi, pty, seg, rt[4 * seg : 4 * seg + 4]))
    return np.asarray(bits, dtype=np.int8)


def differential_encode(bits: np.ndarray, initial: int = 0) -> np.ndarray:
    """Channel symbols s[k] = b[k] XOR s[k-1] (inverse of the receivers'
    differential decode b[k] = s[k] XOR s[k-1])."""
    s = np.cumsum(bits.astype(np.int64)) + initial
    return (s & 1).astype(np.int8)


def group_4a(pi: int, pty: int, mjd: int, hours: int, minutes: int,
             offset_half_hours: int = 0) -> List[int]:
    """Clock-time/date group (decoded by rds-groupdecoder.cpp:287-295)."""
    b = (4 << 12) | (pty << 5) | ((mjd >> 15) & 0x3)
    c = mjd & 0xFFFF
    d = ((hours & 0xF) << 12) | ((minutes & 0x3F) << 6) \
        | (offset_half_hours & 0x4F)
    return encode_group(pi, b, c, d)


def group_10a(pi: int, pty: int, segment: int, chars4: str,
              ab_flag: int = 0) -> List[int]:
    """Programme-type-name group: 4 chars at `segment` (0..1)."""
    b = (10 << 12) | (pty << 5) | (ab_flag << 4) | (segment & 1)
    c = (ord(chars4[0]) << 8) | ord(chars4[1])
    d = (ord(chars4[2]) << 8) | ord(chars4[3])
    return encode_group(pi, b, c, d)


def group_14a_ps(pi: int, pty: int, pi_on: int, variant: int,
                 char_pair: str) -> List[int]:
    """EON PS(ON) segment group: variant 0..3 carries 2 chars in C."""
    b = (14 << 12) | (pty << 5) | (variant & 0xF)
    c = (ord(char_pair[0]) << 8) | ord(char_pair[1])
    return encode_group(pi, b, c, pi_on)


def group_14a_af(pi: int, pty: int, pi_on: int, af1: int,
                 af2: int = 0) -> List[int]:
    """EON AF(ON) group (variant 4), method-A channel numbers."""
    b = (14 << 12) | (pty << 5) | 4
    return encode_group(pi, b, ((af1 & 0xFF) << 8) | (af2 & 0xFF), pi_on)


def group_14a_pty_ta(pi: int, pty: int, pi_on: int, pty_on: int,
                     ta_on: int = 0) -> List[int]:
    """EON PTY(ON)+TA(ON) group (variant 13)."""
    b = (14 << 12) | (pty << 5) | 13
    return encode_group(pi, b, ((pty_on & 0x1F) << 11) | (ta_on & 1), pi_on)


def group_8a(pi: int, pty: int, event: int, location: int, extent: int = 0,
             direction: int = 0, diversion: int = 0,
             duration: int = 0) -> List[int]:
    """TMC/Alert-C single-group user message (ISO 14819-1 layout)."""
    b = (8 << 12) | (pty << 5) | (0 << 4) | (1 << 3) | (duration & 0x7)
    c = ((diversion & 1) << 15) | ((direction & 1) << 14) \
        | ((extent & 0x7) << 11) | (event & 0x7FF)
    return encode_group(pi, b, c, location & 0xFFFF)
