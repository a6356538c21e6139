"""Band scanner — signal/noise detection at the fm rate (D7); port of
sdrjfm_tpu.models.scanner.

Semantics: fmProcessor's scan path (fm-processor.cpp:480-495,886-904) runs a
1024-point FFT on the decimated stream and compares edge-band mean magnitude
('signal': bins 5..25 from both edges) against centre-band mean ('noise');
a station is declared when the dB difference exceeds the threshold (default
20, radio.cpp:912-913).  Every 1024-frame of a block is transformed in one
batched FFT, and any leading axes batch too: `v` [..., T] gives [..., n]
per-frame results (the band scan's rows in one call).
"""

from __future__ import annotations

import torch

SCAN_FFT = 1024


def get_db(x: torch.Tensor, full_scale: float = 256.0) -> torch.Tensor:
    """dB relative to full scale (fm-processor getSignal/getNoise usage)."""
    return 20.0 * torch.log10(torch.clamp(x, min=1e-12) / full_scale)


def scan_block(v: torch.Tensor):
    """Scan fm-rate blocks v [..., T]; returns (signal_db, noise_db) per
    1024-frame, each [..., T // 1024].

    signal = mean |V[k]| over k in 5..24 and size-1-(5..24)  (edges)
    noise  = mean |V[k]| around the centre (size/2 ± 5..24)
    """
    n = v.shape[-1] // SCAN_FFT
    frames = v[..., : n * SCAN_FFT].reshape(*v.shape[:-1], n, SCAN_FFT)
    spec = torch.fft.fft(frames, dim=-1).abs()
    lo = torch.arange(5, 25, device=v.device)
    signal = (spec[..., lo].sum(-1) + spec[..., SCAN_FFT - 1 - lo].sum(-1)) \
        / 40.0
    noise = (spec[..., SCAN_FFT // 2 - 1 - lo].sum(-1)
             + spec[..., SCAN_FFT // 2 + 1 + lo].sum(-1)) / 40.0
    return get_db(signal), get_db(noise)


def scan_decision(v: torch.Tensor, threshold_db: float = 20.0):
    """Reference trigger rule: any frame with signal-noise > threshold.
    Returns (hit, mean contrast in dB), each [...] for v [..., T]."""
    s_db, n_db = scan_block(v)
    d = s_db - n_db
    return (d > threshold_db).any(dim=-1), d.mean(dim=-1)
