"""The port's station list (io/stations.py, a copy of the JAX package's
module) against the JAX package's: JSON and the reference's XML round
trips in each package, and a list written by either package loading in
the other with the same stations."""

from dataclasses import asdict

import pytest

from sdrjfm_tpu.io import stations as JS
from sdrjfm_tpu_torch.io import stations as TS

ENTRIES = [("RADIO ONE", 95_000_000, dict(pi_code=0x1234, pty="Pop Music")),
           ("CLASSIC", 101_300_000, dict(pi_code=0xC201, pty=None)),
           ("NEWS 24", 88_900_000, {}),
           ("RADIO ONE", 95_000_000, dict(pi_code=0x1235))]   # an update


def _fill(mod):
    sl = mod.StationList()
    for name, f, kw in ENTRIES:
        sl.add(name, f, **kw)
    return sl


def _rows(sl):
    return [asdict(s) for s in sl.stations]


def test_add_find_remove_match_jax():
    t, j = _fill(TS), _fill(JS)
    assert _rows(t) == _rows(j)
    assert [s.frequency_hz for s in t.stations] == sorted(
        s.frequency_hz for s in t.stations)
    assert t.find(95_040_000).name == j.find(95_040_000).name == "RADIO ONE"
    assert t.find(97_000_000) is None and j.find(97_000_000) is None
    assert t.remove(88_900_000) and j.remove(88_900_000)
    assert not t.remove(88_900_000)
    assert _rows(t) == _rows(j)


@pytest.mark.parametrize("suffix", [".json", ".xml"])
@pytest.mark.parametrize("writer,reader", [(TS, TS), (TS, JS), (JS, TS)],
                         ids=["port_port", "port_to_jax", "jax_to_port"])
def test_round_trips_across_packages(tmp_path, suffix, writer, reader):
    path = str(tmp_path / f"stations{suffix}")
    _fill(writer).save(path)
    got = reader.StationList.load(path)
    want = JS.StationList.load(path)
    assert _rows(got) == _rows(want)
    if suffix == ".json":
        assert _rows(got) == _rows(_fill(JS))
    else:   # the reference's schema keeps name + kHz only
        assert [(s.name, s.frequency_hz) for s in got.stations] == [
            (s.name, s.frequency_hz) for s in _fill(JS).stations]
        assert all(s.pi_code is None for s in got.stations)


def test_xml_content_under_another_name_and_junk_rows(tmp_path):
    p = tmp_path / "programs.list"
    p.write_text('<fmList><fm-transmitter theName="A" theFrequency="95000"/>'
                 '<fm-transmitter theName="B" theFrequency="junk"/>'
                 '<fm-transmitter theName="C" theFrequency="101300.4"/>'
                 '</fmList>')
    assert _rows(TS.StationList.load(str(p))) \
        == _rows(JS.StationList.load(str(p)))
    assert [s.name for s in TS.StationList.load(str(p)).stations] == ["A",
                                                                       "C"]


def test_missing_file_is_an_empty_list(tmp_path):
    assert TS.StationList.load(str(tmp_path / "none.json")).stations == []
