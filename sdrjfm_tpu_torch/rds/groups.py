"""RDS group decoder — station name, radio text, AF, clock/date, PTY.

Host-side semantics of src/rds/rds-groupdecoder.cpp:100-343 and the EBU
charset / PTY tables of src/rds/ebu-codetables.c, re-expressed as a plain
Python class with a result-dict + callback interface instead of Qt signals.

Beyond the reference (which stubs group 8 as "TMC" and ignores 10/14,
rds-groupdecoder.cpp:100-168):
  - 10A programme-type name (PTYN, 8 chars)
  - 14A enhanced other networks (EON): PS(ON)/PTY(ON)/TA(ON)/AF(ON) per
    cross-referenced PI
  - 8A TMC/Alert-C single-group user messages (event/location/extent)
  - PS/PI majority voting for noisy streams: `pi_voted` and
    `station_label_voted` are per-position majorities keyed by PI, immune
    to the occasional FEC miscorrection that slips a wrong char into the
    reference-exact `station_label`.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .blocksync import Group
from .tables import PTY_TABLE, map_ebu_to_unicode

STATION_LABEL_LENGTH = 8
NUMBER_OF_NAME_SEGMENTS = 4
NUM_OF_CHARS_RADIOTEXT = 64
NUM_CHARS_PER_RTXT_SEGMENT = 4
NUM_OF_FRAGMENTS = 16
END_OF_RADIO_TEXT = 0x0D

GROUP_NAMES = {
    0: "BASIC_TUNING_AND_SWITCHING",
    1: "SLOW_LABELING_CODES",
    2: "RADIO_TEXT",
    3: "OPEN_DATA",
    4: "CLOCKTIME_AND_DATE",
    8: "TMC_DATA",
    10: "PROGRAM_TYPE_NAME",
    14: "ENHANCED_OTHER_NETWORKS",
}

MAX_TMC_MESSAGES = 64


@dataclass
class RDSResult:
    pi_code: int = 0
    pty_code: int = -1
    pty_text: str = ""
    station_label: str = ""
    radio_text: str = ""
    music_speech: Optional[int] = None
    di_code: int = 0
    af_frequencies: List[int] = field(default_factory=list)
    clock_time: Optional[str] = None
    group_counts: Dict[int, int] = field(default_factory=dict)
    # extensions beyond the reference decoder
    pi_voted: int = 0
    station_label_voted: str = ""
    ptyn: str = ""
    eon: Dict[int, dict] = field(default_factory=dict)
    tmc_messages: List[dict] = field(default_factory=list)


class GroupDecoder:
    def __init__(self, pty_locale: int = 0,
                 on_update: Optional[Callable[[str, object], None]] = None):
        self.pty_locale = pty_locale
        self.on_update = on_update or (lambda k, v: None)
        self.reset()

    def reset(self):
        """Full reset including the PI/PS vote history (explicit retune)."""
        self._pi_votes: Counter = Counter()
        self._ps_votes = defaultdict(Counter)   # (pi, seg) -> Counter[chars]
        self._soft_reset()

    def _soft_reset(self):
        """Station change (PI flip) reset — rds-groupdecoder.cpp:106-110.
        Vote history survives: it is keyed by PI, so a spurious PI from a
        miscorrected block doesn't destroy the majority estimate."""
        self.result = RDSResult()
        self._label = [" "] * STATION_LABEL_LENGTH
        self._name_segments = 0
        self._text = [" "] * NUM_OF_CHARS_RADIOTEXT
        self._text_ab_flag = -1
        self._text_segments = 0
        self._alphabet = 0
        self._ptyn_ab = -1
        self._ptyn = [" "] * STATION_LABEL_LENGTH

    # ------------------------------------------------------------------
    def decode(self, grp: Group) -> bool:
        r = self.result
        gt = grp.group_type
        r.group_counts[gt] = r.group_counts.get(gt, 0) + 1

        if grp.pi_code != r.pi_code:
            # new station: reset (rds-groupdecoder.cpp:106-110)
            counts = r.group_counts
            self._soft_reset()
            r = self.result
            r.group_counts = counts
            r.pi_code = grp.pi_code
            self.on_update("pi_code", r.pi_code)
        self._pi_votes[grp.pi_code] += 1
        r.pi_voted = self._pi_votes.most_common(1)[0][0]

        pty = grp.programme_type
        if pty != r.pty_code:
            r.pty_code = pty
            r.pty_text = PTY_TABLE[pty][self.pty_locale]
            self.on_update("pty", r.pty_text)

        if grp.is_type_b:
            return False

        if gt == 0:
            self._basic_tuning(grp)
        elif gt == 2:
            self._radio_text(grp)
        elif gt == 4:
            self._clock(grp)
        elif gt == 8:
            self._tmc(grp)
        elif gt == 10:
            self._ptyn_decode(grp)
        elif gt == 14:
            self._eon(grp)
        return True

    # ------------------------------------------------------------------
    def _basic_tuning(self, grp: Group):
        r = self.result
        seg = grp.get("B") & 0x3
        chars = grp.get("D") & 0xFFFF
        self._label[2 * seg] = chr((chars >> 8) & 0xFF)
        self._label[2 * seg + 1] = chr(chars & 0xFF)
        if seg == 0:
            self._name_segments = 0
        self._name_segments |= 2 * seg        # quirk preserved from
        # rds-groupdecoder.cpp:199-208 (|= 2*index, not 1<<index)
        r.station_label = "".join(self._label)
        self.on_update("station_label", r.station_label)

        af1 = (grp.get("C") >> 8) & 0xFF
        af2 = grp.get("C") & 0xFF
        f1 = af1 * 100 + 87500 if 0 < af1 < 205 else 0
        f2 = af2 * 100 + 87500 if (af1 != 250 and 0 < af2 < 205) else 0
        for f in (f1, f2):
            if f and f not in r.af_frequencies:
                r.af_frequencies.append(f)

        r.music_speech = (grp.get("B") >> 3) & 1
        r.di_code |= ((grp.get("B") >> 2) & 1) << seg

        # PS majority voting (extension): per-position counts keyed by PI
        self._ps_votes[(grp.pi_code, seg)][chars] += 1
        label = []
        for s in range(NUMBER_OF_NAME_SEGMENTS):
            c = self._ps_votes.get((r.pi_voted, s))
            if c:
                top = c.most_common(1)[0][0]
                label.append(chr((top >> 8) & 0xFF) + chr(top & 0xFF))
            else:
                label.append("  ")
        r.station_label_voted = "".join(label)

    def _radio_text(self, grp: Group):
        r = self.result
        ab = (grp.get("B") >> 4) & 1
        seg = grp.get("B") & 0xF
        if self._text_ab_flag != ab:
            self._text_ab_flag = ab
            self._text = [" "] * NUM_OF_CHARS_RADIOTEXT
            self._text_segments = 0
            r.radio_text = ""
            self.on_update("radio_text", "")
        c, d = grp.get("C"), grp.get("D")
        frag = [(c >> 8) & 0xFF, c & 0xFF, (d >> 8) & 0xFF, d & 0xFF]
        for i, ch in enumerate(frag):
            self._text[4 * seg + i] = chr(ch)
        self._text_segments |= 1 << seg

        end = any(ch == END_OF_RADIO_TEXT for ch in frag)
        contiguous = self._text_segments + 1 == (1 << (seg + 1))
        complete = self._text_segments + 1 == (1 << NUM_OF_FRAGMENTS)
        if end or complete:
            self._emit_text(NUM_OF_CHARS_RADIOTEXT)
        elif contiguous:
            self._emit_text(seg * NUM_CHARS_PER_RTXT_SEGMENT)

    def _emit_text(self, length: int):
        """prepareText (rds-groupdecoder.cpp:298-316): walk the buffer one
        char behind the cursor, emitting the pending char unless it starts a
        2-char alphabet-switch sequence (0x0F 0x0F -> G0, 0x0E 0x0E -> G1,
        0x1B 0x6E -> G2, :318-343).  Reference quirks preserved: after a
        switch the SECOND marker char becomes the pending char (so it is
        emitted as its table mapping) and the char after it is skipped
        (:305-309).  One divergence: we flush the final pending char where
        the reference's `i < length` loop silently drops it — identical for
        full-buffer emission (the tail is 0x0D/padding, stripped anyway),
        one extra real char on contiguous-prefix emission.
        """
        chars = [ord(c) for c in self._text[:max(length, 1)]]
        out = []
        prev = chars[0]
        i = 1
        while i < len(chars):
            cur = chars[i]
            if _alphabet_switch(prev, cur):
                self._alphabet = _set_alphabet(prev)
                prev = cur        # the 2nd marker stays pending...
                i += 2            # ...and the char after it is skipped
            else:
                out.append(map_ebu_to_unicode(self._alphabet, prev))
                prev = cur
                i += 1
        out.append(map_ebu_to_unicode(self._alphabet, prev))
        text = "".join(out).strip()
        if text != self.result.radio_text:
            self.result.radio_text = text
            self.on_update("radio_text", text)

    def _ptyn_decode(self, grp: Group):
        """10A programme-type name: 8 chars, 4 per segment (extension; the
        reference only names the group, rds-groupdecoder.cpp:100-168)."""
        seg = grp.get("B") & 1
        ab = (grp.get("B") >> 4) & 1
        if ab != self._ptyn_ab:
            self._ptyn_ab = ab
            self._ptyn = [" "] * STATION_LABEL_LENGTH
        c, d = grp.get("C"), grp.get("D")
        for i, ch in enumerate(((c >> 8) & 0xFF, c & 0xFF,
                                (d >> 8) & 0xFF, d & 0xFF)):
            self._ptyn[4 * seg + i] = chr(ch)
        self.result.ptyn = "".join(self._ptyn)
        self.on_update("ptyn", self.result.ptyn)

    def _eon(self, grp: Group):
        """14A enhanced other networks (extension): collect PS(ON),
        AF(ON), PTY(ON), TA(ON) keyed by the cross-referenced PI(ON) in
        block D (IEC 62106 §3.1.5.19 layout)."""
        variant = grp.get("B") & 0xF
        pi_on = grp.get("D") & 0xFFFF
        e = self.result.eon.setdefault(
            pi_on, {"ps": [" "] * STATION_LABEL_LENGTH, "pty": None,
                    "ta": None, "af_khz": []})
        c = grp.get("C")
        if variant < 4:                       # PS(ON) segments
            e["ps"][2 * variant] = chr((c >> 8) & 0xFF)
            e["ps"][2 * variant + 1] = chr(c & 0xFF)
        elif variant == 4:                    # AF(ON) method-A pairs
            for af in ((c >> 8) & 0xFF, c & 0xFF):
                f = af * 100 + 87500 if 0 < af < 205 else 0
                if f and f not in e["af_khz"]:
                    e["af_khz"].append(f)
        elif variant == 13:                   # PTY(ON) + TA(ON)
            e["pty"] = (c >> 11) & 0x1F
            e["ta"] = bool(c & 1)
        self.on_update("eon", pi_on)

    def eon_summary(self) -> Dict[str, dict]:
        """JSON-able view of the EON table (PS joined, PI as hex)."""
        out = {}
        for pi, e in self.result.eon.items():
            out[f"0x{pi:04X}"] = {
                "ps": "".join(e["ps"]).strip(),
                "pty": (PTY_TABLE[e["pty"]][self.pty_locale]
                        if e["pty"] is not None else None),
                "ta": e["ta"], "af_khz": list(e["af_khz"]),
            }
        return out

    def _tmc(self, grp: Group):
        """8A TMC/Alert-C single-group user message (extension; the
        reference stubs group 8).  ISO 14819-1 layout: B[4]=T(0=user),
        B[3]=F(1=single-group), B[2:0]=duration; C[15]=diversion,
        C[14]=direction, C[13:11]=extent, C[10:0]=event; D=location."""
        b = grp.get("B")
        if (b >> 4) & 1:                      # tuning information — skip
            return
        if not (b >> 3) & 1:                  # multi-group — not assembled
            return
        c = grp.get("C")
        msg = {"event": c & 0x7FF,
               "location": grp.get("D") & 0xFFFF,
               "extent": (c >> 11) & 0x7,
               "direction": (c >> 14) & 1,
               "diversion": bool((c >> 15) & 1),
               "duration": b & 0x7}
        if msg not in self.result.tmc_messages \
                and len(self.result.tmc_messages) < MAX_TMC_MESSAGES:
            self.result.tmc_messages.append(msg)
            self.on_update("tmc", msg)

    def _clock(self, grp: Group):
        hours = (grp.get("D") >> 12) & 0xF
        minutes = (grp.get("D") >> 6) & 0x3F
        mjd = grp.get("C")
        offset = grp.get("D") & 0x4F
        self.result.clock_time = f"{hours + offset // 2:02d}:{minutes:02d} (MJD {mjd})"
        self.on_update("clock_time", self.result.clock_time)


def _alphabet_switch(c1: int, c2: int) -> bool:
    return ((c1 == 0x0F and c2 == 0x0F) or (c1 == 0x0E and c2 == 0x0E)
            or (c1 == 0x1B and c2 == 0x6E))


def _set_alphabet(c1: int) -> int:
    return {0x0F: 0, 0x0E: 1, 0x1B: 2}.get(c1, 0)
