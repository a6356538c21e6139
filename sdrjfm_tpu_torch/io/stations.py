"""Station list persistence (the programList equivalent, C8); the port's
copy of sdrjfm_tpu.io.stations (numpy-free: the standard library only), so
that a list written by either package loads in the other.

The reference keeps a name+frequency table persisted as XML
(src/various/program-list.cpp:33-60, ~/.jsdr-programs.xml).  Here the
native format is JSON with the same data model plus per-station metadata
the RDS stack can fill in automatically (PI code, PTY) — something the
reference's manual list cannot do — AND the reference's exact XML schema
is read/written for migration: a `.xml` path (or XML content) round-trips
`<fmList><fm-transmitter theName=".." theFrequency="kHz"/></fmList>`
(program-list.cpp:105-144 saveTable/loadTable; frequencies are kHz there,
tableSelect applies Khz()), so an existing ~/.jsdr-programs.xml loads
directly via `--stations`.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import List, Optional


@dataclass
class Station:
    name: str
    frequency_hz: int
    pi_code: Optional[int] = None
    pty: Optional[str] = None


@dataclass
class StationList:
    stations: List[Station] = field(default_factory=list)

    def add(self, name: str, frequency_hz: int, **kw) -> Station:
        for s in self.stations:
            if s.frequency_hz == frequency_hz:
                s.name = name
                for k, v in kw.items():
                    setattr(s, k, v)
                return s
        s = Station(name=name, frequency_hz=int(frequency_hz), **kw)
        self.stations.append(s)
        self.stations.sort(key=lambda s: s.frequency_hz)
        return s

    def remove(self, frequency_hz: int) -> bool:
        before = len(self.stations)
        self.stations = [s for s in self.stations
                         if s.frequency_hz != frequency_hz]
        return len(self.stations) != before

    def find(self, frequency_hz: int, tolerance_hz: int = 50_000):
        for s in self.stations:
            if abs(s.frequency_hz - frequency_hz) <= tolerance_hz:
                return s
        return None

    def save(self, path: str) -> None:
        if str(path).lower().endswith(".xml"):
            return self.save_xml(path)
        Path(path).write_text(json.dumps(
            {"stations": [asdict(s) for s in self.stations]}, indent=2))

    @classmethod
    def load(cls, path: str) -> "StationList":
        p = Path(path)
        if not p.exists():
            return cls()
        text = p.read_text()
        if (str(path).lower().endswith(".xml")
                or text.lstrip().startswith("<")):
            return cls.load_xml(path)
        data = json.loads(text)
        return cls(stations=[Station(**s) for s in data.get("stations", [])])

    # -- reference XML interop (program-list.cpp:105-144) ----------------
    def save_xml(self, path: str) -> None:
        """Write the reference's schema (frequencies in kHz, as its table
        stores and its loader expects).

        Lossy BY DESIGN — the reference format carries only name +
        frequency(kHz): pi_code/pty metadata is dropped and sub-kHz
        frequency detail rounds away (stations within 1 kHz merge on
        reload).  Keep the JSON native format for full fidelity; use
        .xml paths only to exchange lists with the reference receiver."""
        import xml.etree.ElementTree as ET
        root = ET.Element("fmList")
        for s in self.stations:
            ET.SubElement(root, "fm-transmitter",
                          theName=s.name,
                          theFrequency=str(int(round(s.frequency_hz
                                                     / 1000))))
        Path(path).write_text(
            ET.tostring(root, encoding="unicode") + "\n")

    @classmethod
    def load_xml(cls, path: str) -> "StationList":
        import xml.etree.ElementTree as ET
        out = cls()
        root = ET.parse(str(path)).getroot()
        for el in root.iter("fm-transmitter"):
            name = el.get("theName", "")
            freq = el.get("theFrequency", "0")
            try:
                khz = int(float(freq))
            except ValueError:
                continue                   # a hand-edited junk row
            out.add(name, khz * 1000)
        return out
