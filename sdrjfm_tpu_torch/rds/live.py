"""Incremental host-side RDS decode for streaming runs.

The reference decodes RDS continuously while receiving: bits flow from the
bit decoder through the block synchronizer to the group decoder, and the
block synchronizer's error counters feed back into decoder-3's bit-clock
re-acquisition (rds-decoder-3.cpp:94-99).  `LiveRDSDecoder` is that loop's
host half for the block pipeline: feed each block's recovered bits as they
arrive; group results update live; `feed` returns True when the decoder
should re-acquire its clock (>3 sync errors since the last resync — pass it
to runtime.stream.run_live's `rds_feedback`, which calls
Receiver.request_rds_resync).
"""

from __future__ import annotations

from typing import Callable, Optional

from .blocksync import BlockSynchronizer, Group
from .groups import GroupDecoder

RESYNC_ERROR_THRESHOLD = 3    # rds-decoder-3.cpp:94: getNumSyncErrors() > 3


class LiveRDSDecoder:
    def __init__(self, pty_locale: int = 0,
                 on_update: Optional[Callable[[str, object], None]] = None,
                 resync_threshold: int = RESYNC_ERROR_THRESHOLD):
        self.sync = BlockSynchronizer()
        self.decoder = GroupDecoder(pty_locale=pty_locale, on_update=on_update)
        self.group = Group()
        self.resync_threshold = resync_threshold
        self.resyncs_requested = 0
        self._pty_locale = pty_locale
        self._on_update = on_update

    def reset(self) -> None:
        """Fresh sync + group state after a retune (the reference resets the
        whole RDS stack on a frequency change, fm-processor.cpp:849-855 ->
        rds-decoder reset); resync accounting survives for the report."""
        self.sync = BlockSynchronizer()
        self.decoder = GroupDecoder(pty_locale=self._pty_locale,
                                    on_update=self._on_update)
        self.group = Group()

    def feed(self, bits) -> bool:
        """Push one block's bits; True = the bit decoder should re-acquire."""
        self.sync.push_bits(bits, self.group, on_group=self.decoder.decode)
        if self.sync.resync_error_counter > self.resync_threshold:
            self.sync.resync()
            self.sync.reset_resync_error_counter()
            self.resyncs_requested += 1
            return True
        return False

    @property
    def result(self):
        return self.decoder.result

    def report(self) -> dict:
        """JSON-able summary (the rx CLI's 'rds' report section)."""
        sync, r = self.sync, self.decoder.result
        rep = {
            "groups_decoded": sync.groups_decoded,
            "sync_errors": sync.num_sync_errors,
            "crc_errors": sync.num_crc_errors,
            "bit_error_rate": sync.bit_error_rate,
            "pi_code": f"0x{r.pi_code:04X}",
            "pty": r.pty_text,
            "station_label": r.station_label,
            "radio_text": r.radio_text,
            "af_frequencies_khz": [f / 1000.0 for f in r.af_frequencies],
            "music_speech": ({0: "speech", 1: "music"}.get(r.music_speech)
                             if r.music_speech is not None else None),
            "di_code": r.di_code,
            "clock_time": r.clock_time,
            "group_counts": {str(k): v for k, v in r.group_counts.items()},
        }
        if self.resyncs_requested:
            rep["bitclock_resyncs"] = self.resyncs_requested
        if r.station_label_voted.strip() and \
                r.station_label_voted != r.station_label:
            rep["station_label_voted"] = r.station_label_voted
        if r.ptyn.strip():
            rep["ptyn"] = r.ptyn
        if r.eon:
            rep["eon"] = self.decoder.eon_summary()
        if r.tmc_messages:
            rep["tmc_messages"] = r.tmc_messages
        return rep
