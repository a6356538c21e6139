"""Full-band scan: multi-block averaged decisions + hardware band sweep
(port of sdrjfm_tpu.models.bandscan).

The reference's scan loop retunes the *device* across the FM band
(radio.cpp:1115-1158) and decides per stop from the live stream with
averaging semantics (fm-processor.cpp:480-495,886-904: clearAverage resets
the spectrum average a retune, so a decision reflects several FFT frames).

Every candidate channel inside the current capture window is scanned in one
call: the offsets x blocks become the rows of one `Receiver.front_end_rows`
call (one front-end kernel launch on the card, rows that share a wire block
read it from L2), then `scan_block` over all rows at once.  A 21 MHz band
costs ceil(band / window) hardware retunes rather than 205.

`scan_band` drives any retunable streaming source over the band raster;
`scan_capture` is the offline (file) variant with the multi-block
averaging (a station flickering in one block only is not a hit).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from .receiver import Receiver, default_controls
from .scanner import scan_block
from ..runtime.graph import tree_broadcast, wire_np_dtype

#: FM broadcast band edges (radio.cpp MINIMUM_FREQ/MAXIMUM_FREQ usage)
FM_BAND_START = 87_500_000
FM_BAND_STOP = 108_000_000


def raw_to_c64(raw: np.ndarray, fmt: str) -> np.ndarray:
    """Wire-format frames -> complex64 with the device conventions
    (rtlsdr-handler.cpp:285-294 for u8; i16 full-scale for SDRplay-style)."""
    if fmt == "c64":
        return np.asarray(raw, np.complex64)
    if fmt == "u8":
        return (((raw[:, 0].astype(np.float32) - 127.0)
                 + 1j * (raw[:, 1].astype(np.float32) - 127.0)) / 128.0
                ).astype(np.complex64)
    if fmt == "i8":
        # hackrf signed bytes /128 (hackrf-handler.cpp:360-365)
        return ((raw[:, 0].astype(np.float32)
                 + 1j * raw[:, 1].astype(np.float32)) / 128.0
                ).astype(np.complex64)
    if fmt == "i16":
        return ((raw[:, 0].astype(np.float32)
                 + 1j * raw[:, 1].astype(np.float32)) / 32768.0
                ).astype(np.complex64)
    raise ValueError(f"unknown wire format {fmt!r}")


class BandScanner:
    """Multi-offset multi-block scan decision for one Receiver: the offsets
    x blocks as the rows of one front-end call, at the receiver's initial
    state and the default controls (the DC servo at 0 on every row)."""

    def __init__(self, rx: Receiver, threshold_db: float = 20.0):
        self.rx = rx
        self.threshold_db = float(threshold_db)
        self._state = rx.init_state()
        self._base = default_controls(device=rx.device)

    def rows(self, iq_blocks: torch.Tensor, offsets_hz: Sequence[int]):
        """(states, controls, block_index) of the rows offsets x blocks:
        row i * nb + b runs offset i on block b."""
        dev = self.rx.device
        nb, n_off = iq_blocks.shape[0], len(offsets_hz)
        R = n_off * nb
        # an upload that does not wait for the card (no host sync)
        offs = torch.tensor([int(o) for o in offsets_hz],
                            dtype=torch.int32).to(dev, non_blocking=True)
        controls = tree_broadcast(self._base, R)._replace(
            lo_freq_hz=offs[:, None].expand(n_off, nb).reshape(R))
        block_index = torch.arange(nb, dtype=torch.int32,
                                   device=dev).repeat(n_off)
        return tree_broadcast(self._state, R), controls, block_index

    def scan(self, iq_blocks: torch.Tensor, offsets_hz: Sequence[int]):
        """Per (offset, block): (trigger [n_off, nb] bool, contrast_db
        [n_off, nb]) on the receiver's device, from one front-end call."""
        states, controls, block_index = self.rows(iq_blocks, offsets_hz)
        v, _ = self.rx.front_end_rows(states, controls, iq_blocks,
                                      block_index)
        s_db, n_db = scan_block(v)
        d = s_db - n_db
        # reference trigger rule per block (any 1024-frame over threshold)
        # + the frame-mean contrast for ranking
        shape = (len(offsets_hz), iq_blocks.shape[0])
        return ((d > self.threshold_db).any(dim=-1).view(shape),
                d.mean(dim=-1).view(shape))

    def decide(self, iq_blocks: np.ndarray, offsets_hz: Sequence[int]):
        """iq_blocks (nb, wire_len) in the receiver's wire format (complex64
        for the default config); returns (hit (n_off,) bool, contrast_db
        (n_off,) float).  A hit needs a majority of blocks to trigger — the
        clearAverage-style depth the single-block scan lacked."""
        cfg = self.rx.cfg
        wire = torch.from_numpy(np.ascontiguousarray(
            iq_blocks, wire_np_dtype(cfg))).to(self.rx.device)
        trig, contrast = self.scan(wire, offsets_hz)
        nb = iq_blocks.shape[0]
        hit = trig.cpu().numpy().sum(axis=1) >= (nb + 1) // 2
        return hit, contrast.cpu().numpy().mean(axis=1)


def cluster_hits(offsets: Sequence[int], contrast: Sequence[float],
                 grid_hz: int) -> List[int]:
    """Merge runs of adjacent triggered channels into one station at the
    contrast peak (a strong carrier also trips its grid neighbours; the
    reference simply stops at the first trigger — radio.cpp:1132-1140)."""
    out: List[int] = []
    run: List[tuple] = []
    prev = None
    for off, c in sorted(zip(offsets, contrast)):
        if prev is not None and off - prev > grid_hz:
            out.append(max(run, key=lambda oc: oc[1])[0])
            run = []
        run.append((off, c))
        prev = off
    if run:
        out.append(max(run, key=lambda oc: oc[1])[0])
    return out


def scan_capture(rx: Receiver, iq: np.ndarray, grid_hz: int = 100_000,
                 threshold_db: float = 20.0, max_blocks: int = 8,
                 cluster: bool = True) -> List[dict]:
    """Offline capture scan over the LO window, averaged over up to
    max_blocks blocks spread across the capture (not just the first)."""
    T = rx.cfg.block_in
    nb_avail = len(iq) // T
    if nb_avail == 0:
        raise ValueError(f"capture too short: need {T} samples")
    nb = min(nb_avail, max_blocks)
    # spread the averaged blocks across the whole capture
    idx = np.linspace(0, nb_avail - 1, nb).round().astype(int)
    blocks = np.stack([iq[i * T:(i + 1) * T] for i in idx])
    w = (rx.cfg.input_rate // 2 - rx.cfg.fm_rate) // grid_hz * grid_hz
    offsets = list(range(-w, w + 1, grid_hz))
    sc = BandScanner(rx, threshold_db)
    hit, contrast = sc.decide(blocks, offsets)
    hits = [(o, c) for o, c, h in zip(offsets, contrast, hit) if h]
    if not hits:
        return []
    if cluster:
        peaks = cluster_hits([o for o, _ in hits], [c for _, c in hits],
                             grid_hz)
        hits = [(o, c) for o, c in hits if o in peaks]
    return [{"offset_hz": int(o), "contrast_db": float(c)} for o, c in hits]


def scan_band(rx: Receiver, source,
              f_start: int = FM_BAND_START, f_stop: int = FM_BAND_STOP,
              grid_hz: int = 100_000, threshold_db: float = 20.0,
              blocks: int = 2, settle_ms: int = 30,
              identify_seconds: float = 0.0,
              timeout_ms: int = 30_000,
              log=None) -> List[dict]:
    """Sweep a retunable streaming source across [f_start, f_stop].

    Per hardware stop: set_frequency(center) (setVFOFrequency,
    radio.cpp:1140), flush the ring + discard settle_ms of stale samples
    (resetBuffer + tuner PLL settle), capture `blocks` receiver blocks, and
    scan every raster channel inside the capture window in one front-end
    call.  identify_seconds > 0 additionally demodulates all of a window's
    hits at once (`demodulate_stations`) and attaches RDS PI/station when
    decoded.  `rx` takes complex64 blocks (the default wire format).

    `source` needs: set_frequency(hz), read_block(n, timeout_ms), fmt,
    rate, and optionally flush().
    """
    cfg = rx.cfg
    T = cfg.block_in
    window = cfg.input_rate // 2 - cfg.fm_rate
    # usable half-span per stop, aligned to the grid with margin for the
    # channel's own +-96 kHz occupancy
    half = (window - cfg.fm_rate // 2) // grid_hz * grid_hz
    span = 2 * half + grid_hz            # channels per stop
    chans = list(range(f_start, f_stop + 1, grid_hz))
    sc = BandScanner(rx, threshold_db)
    results: List[dict] = []
    settle = int(source.rate * settle_ms / 1000)
    i = 0
    while i < len(chans):
        group = [c for c in chans[i:] if c - chans[i] < span]
        i += len(group)
        center = group[len(group) // 2]
        source.set_frequency(center)
        flush = getattr(source, "flush", None)
        if flush is not None:
            flush()
        if settle:
            source.read_block(settle, timeout_ms)      # discard
        n_id = int(identify_seconds * source.rate) // T * T
        n_cap = max(blocks * T, n_id)
        raw = source.read_block(n_cap, timeout_ms)
        if len(raw) < blocks * T:
            # source ended / outage outlasted timeout_ms: report the abort
            # loudly — a partial sweep must not read as a station-free band
            if log is not None:
                log(f"scan ABORTED at {center / 1e6:.1f} MHz: source ended "
                    f"({len(raw)}/{blocks * T} frames); "
                    f"{len(chans) - i + len(group)} channels unscanned")
            break
        iq_c = raw_to_c64(raw, source.fmt)
        offsets = [c - center for c in group]
        hit, contrast = sc.decide(
            iq_c[: blocks * T].reshape(blocks, T), offsets)
        hits = [(o, c) for o, c, h in zip(offsets, contrast, hit) if h]
        if log is not None:
            log(f"scan stop {center / 1e6:.1f} MHz: "
                f"{len(group)} channels, {len(hits)} hit(s)")
        if not hits:
            continue
        peaks = cluster_hits([o for o, _ in hits], [c for _, c in hits],
                             grid_hz)
        hits = [(o, c) for o, c in hits if o in peaks]
        entries = [{"freq_hz": int(center + o), "offset_hz": int(o),
                    "contrast_db": float(c)} for o, c in hits]
        if identify_seconds > 0 and len(iq_c) >= T:
            from .multistation import demodulate_stations
            id_rx = _identify_rx(rx)
            per = demodulate_stations(id_rx, iq_c, [o for o, _ in hits])
            for entry, res in zip(entries, per):
                entry["pilot_locked"] = bool(res["meta"]["pilot_locked"])
                if res.get("rds_bits") is not None:
                    entry.update(decode_rds_hit(res["rds_bits"]))
        results.extend(entries)
    # a strong carrier at a stop boundary can also trip its grid neighbour
    # in the NEXT window — per-stop clustering can't see that, so dedupe
    # adjacent absolute frequencies across the whole sweep
    results.sort(key=lambda e: e["freq_hz"])
    deduped: List[dict] = []
    for e in results:
        if deduped and e["freq_hz"] - deduped[-1]["freq_hz"] <= grid_hz:
            if e["contrast_db"] > deduped[-1]["contrast_db"]:
                deduped[-1] = e
        else:
            deduped.append(e)
    return deduped


def decode_rds_hit(bits) -> dict:
    """Host-stack RDS decode of one identified station's bit stream.

    Shared by the hardware sweep and the file-scan identify path.  Prefers
    the majority-voted PI/name: a live capture can start mid-loop/mid-group
    and a Meggitt miscorrection on the seam could slip one wrong PI
    through.  Returns {} when no group decodes."""
    from ..rds.blocksync import BlockSynchronizer, Group
    from ..rds.groups import GroupDecoder
    sync, dec, grp = BlockSynchronizer(), GroupDecoder(), Group()
    sync.push_bits(bits, grp, on_group=dec.decode)
    if not sync.groups_decoded:
        return {}
    r = dec.result
    pi = getattr(r, "pi_voted", 0) or r.pi_code
    name = getattr(r, "station_label_voted", "")
    if not name.strip():
        name = r.station_label
    return {"pi_code": f"0x{pi:04X}", "station": name.strip(),
            "pty": r.pty_text, "groups": sync.groups_decoded,
            "ber": sync.bit_error_rate}


_ID_RX_CACHE: dict = {}


def _identify_rx(rx: Receiver) -> Receiver:
    """RDS-capable sibling of the scan receiver (the scan cfg runs with
    rds off for throughput; identification needs the bit path), on the
    scan receiver's device."""
    if rx.cfg.rds != "off":
        return rx
    cfg = dataclasses.replace(rx.cfg, rds="block", audio_filter_hz=15000)
    key = (cfg, str(rx.device))
    if key not in _ID_RX_CACHE:
        _ID_RX_CACHE[key] = Receiver(cfg, device=rx.device)
    return _ID_RX_CACHE[key]
