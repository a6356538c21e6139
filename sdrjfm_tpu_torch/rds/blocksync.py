"""RDS block synchronizer — host-side stream state machine.

At 1187.5 bit/s this is nowhere near a performance path, so it runs in plain
Python/numpy on the host, fed by the TPU bit-recovery blocks.  Semantics:
src/rds/rds-blocksynchronizer.cpp:215-336 — acquisition requires a clean
A -> B -> C run (SYNC_END_BLOCK = BLOCK_C, rds-blocksynchronizer.h:91),
tracking decodes 26-bit blocks against the cycling offset words, BER is
accumulated over 4000-bit windows.

One deliberate divergence: the reference runs Meggitt FEC over the stored
bitstream but then still reports the block as a CRC failure and resyncs
(decodeBlock returns `syndrome == 0` computed *before* correction,
rds-blocksynchronizer.cpp:148-171) — i.e. its FEC never rescues a block.  We
accept a block whose Meggitt-corrected residual syndrome is zero (set
`strict_reference_crc=True` to reproduce the reference behaviour exactly).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from . import crc

BLOCKS = ("A", "B", "C", "D")
NUM_BITS_BER_CALC_RESET = 4000
SYNC_END_BLOCK = "C"


@dataclass
class Group:
    blocks: List[int] = field(default_factory=lambda: [0, 0, 0, 0])

    def clear(self):
        self.blocks = [0, 0, 0, 0]

    def set_block(self, name: str, v: int):
        self.blocks[BLOCKS.index(name)] = v

    def get(self, name: str) -> int:
        return self.blocks[BLOCKS.index(name)]

    @property
    def pi_code(self) -> int:
        return self.blocks[0] & 0xFFFF

    @property
    def group_type(self) -> int:
        return (self.blocks[1] >> 12) & 0xF

    @property
    def is_type_b(self) -> bool:
        return bool((self.blocks[1] >> 11) & 1)

    @property
    def tp_flag(self) -> bool:
        return bool((self.blocks[1] >> 10) & 1)

    @property
    def programme_type(self) -> int:
        return (self.blocks[1] >> 5) & 0x1F


class BlockSynchronizer:
    def __init__(self, fec_enabled: bool = True,
                 strict_reference_crc: bool = False):
        self.fec_enabled = fec_enabled
        self.strict_reference_crc = strict_reference_crc
        self.reset()

    def reset(self):
        self.bitstream = 0
        self.synchronized = False
        self.current_block = "A"
        self.bits_in_block = 0
        self.bits_processed = 0
        self.num_bit_errors = 0
        self.num_sync_errors = 0
        self.num_crc_errors = 0
        self.bit_error_rate = 0.0
        self.groups_decoded = 0
        self.resync_error_counter = 0   # rdsNumofSyncErrors: sync errors
        # since the last reset_resync_error_counter (the decoder-3 feedback
        # counter, rds-blocksynchronizer.cpp:87-104)

    def resync(self):
        self.current_block = "A"
        self.synchronized = False
        self.bits_in_block = 0

    def reset_resync_error_counter(self):
        self.resync_error_counter = 0

    def _offset_name(self, block: str, is_type_b: bool) -> str:
        if block == "C":
            return "C2" if is_type_b else "C1"
        return block

    # ------------------------------------------------------------------
    def push_bits(self, bits, group: Group,
                  on_group: Optional[Callable[[Group], None]] = None):
        """Feed an iterable of hard bits; calls on_group per complete group."""
        for b in bits:
            res = self.push_bit(int(b), group)
            if res == "COMPLETE_GROUP":
                if on_group is not None:
                    on_group(group)
                self.groups_decoded += 1
                group.clear()
            elif res in ("NO_SYNC", "NO_CRC"):
                self.resync()

    def push_bit(self, bit: int, group: Group) -> str:
        if self.synchronized:
            return self._push_synchronized(bit, group)
        if self.current_block == "A":
            return self._push_block_a(bit, group)
        return self._push_not_synchronized(bit, group)

    # ------------------------------------------------------------------
    def _decode_block(self, block_name: str, bits26: int,
                      is_type_b: bool) -> Optional[int]:
        """Returns the 16-bit payload or None on CRC failure (tracking mode)."""
        offset = crc.OFFSET_WORDS[self._offset_name(block_name, is_type_b)]
        synd = crc.syndrome(bits26, offset)
        self.bits_processed += crc.NUM_BITS_PAYLOAD
        payload = None
        if synd == 0:
            payload = (bits26 >> crc.NUM_BITS_CRC) & 0xFFFF
        elif self.fec_enabled and not self.strict_reference_crc:
            corrected, resid, n = crc.meggitt_correct(bits26, synd)
            if resid == 0 and n > 0:
                payload = (corrected >> crc.NUM_BITS_CRC) & 0xFFFF
                self.num_bit_errors += n
        if payload is None and synd != 0:
            self.num_bit_errors += crc.NUM_BITS_PAYLOAD
        self.bit_error_rate = self.num_bit_errors / max(self.bits_processed, 1)
        if self.bits_processed >= NUM_BITS_BER_CALC_RESET:
            self.num_bit_errors = 0
            self.bits_processed = 0
        return payload

    def _push_synchronized(self, bit: int, group: Group) -> str:
        self.bitstream = ((self.bitstream << 1) | bit) & 0x3FFFFFF
        self.bits_in_block += 1
        if self.bits_in_block < crc.NUM_BITS_BLOCK:
            return "BUFFERING"
        self.bits_in_block = 0
        payload = self._decode_block(self.current_block, self.bitstream,
                                     group.is_type_b)
        if payload is None:
            self.num_crc_errors += 1
            return "NO_CRC"
        group.set_block(self.current_block, payload)
        result = ("COMPLETE_GROUP" if self.current_block == "D"
                  else "BUFFERING")
        self._next_block()
        return result

    def _push_block_a(self, bit: int, group: Group) -> str:
        self.bitstream = ((self.bitstream << 1) | bit) & 0x3FFFFFF
        if crc.syndrome(self.bitstream, crc.OFFSET_WORDS["A"]) != 0:
            return "WAITING_FOR_BLOCK_A"
        group.set_block("A", (self.bitstream >> crc.NUM_BITS_CRC) & 0xFFFF)
        self.bits_in_block = 0
        self._next_block()
        return "BUFFERING"

    def _push_not_synchronized(self, bit: int, group: Group) -> str:
        self.bitstream = ((self.bitstream << 1) | bit) & 0x3FFFFFF
        if self.bits_in_block < crc.NUM_BITS_BLOCK - 1:
            self.bits_in_block += 1
            return "BUFFERING"
        self.bits_in_block = 0
        offset = crc.OFFSET_WORDS[self._offset_name(self.current_block,
                                                    group.is_type_b)]
        if crc.syndrome(self.bitstream, offset) != 0:
            self.num_sync_errors += 1
            self.resync_error_counter += 1
            return "NO_SYNC"
        group.set_block(self.current_block,
                        (self.bitstream >> crc.NUM_BITS_CRC) & 0xFFFF)
        if BLOCKS.index(self.current_block) < BLOCKS.index(SYNC_END_BLOCK):
            self._next_block()
            return "BUFFERING"
        self.synchronized = True
        result = ("COMPLETE_GROUP" if self.current_block == "D"
                  else "BUFFERING")
        self._next_block()
        return result

    def _next_block(self):
        i = BLOCKS.index(self.current_block)
        self.current_block = BLOCKS[(i + 1) % 4]
