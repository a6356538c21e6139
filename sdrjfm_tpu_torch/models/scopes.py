"""Spectrum / waterfall / constellation computation — the scopes, headless
(port of sdrjfm_tpu.models.scopes).

The reference renders HF/LF spectra, a waterfall, and the RDS IQ
constellation with Qt/Qwt (src/scopes-qwt6/, SURVEY.md C4-C7).  The
framework computes the same displays as arrays for file export or
downstream UIs:

  spectrum     : windowed segment FFT of the raw input, bin-averaged to
                 display size, exponentially averaged over frames
                 (hs-scope.cpp:96-203); torch, on the input's device
  lf_spectrum  : the same machinery on a selectable tap of the chain
                 (ls-scope.cpp:76-192; tap selection = ELfPlot,
                 fm-processor.h:84-86 — here the receiver's emit_taps dict)
  waterfall    : stacked per-block spectra (numpy)
  iq_points    : RDS constellation histogram (iqdisplay.cpp:32-79; numpy)
"""

from __future__ import annotations

from typing import Literal, Optional

import numpy as np
import torch

Window = Literal["hann", "blackman"]


def _window(n: int, kind: Window = "blackman", device=None) -> torch.Tensor:
    i = torch.arange(n, device=device)
    if kind == "hann":
        return 0.5 - 0.5 * torch.cos(2 * torch.pi * i / (n - 1))
    return (0.42 - 0.5 * torch.cos(2 * torch.pi * i / (n - 1))
            + 0.08 * torch.cos(4 * torch.pi * i / (n - 1)))


def _frame_fft(x: torch.Tensor, seg: int, window: Window) -> torch.Tensor:
    """FFTs of the windowed segments of x, [n // seg, seg].  Shorter than
    one segment: no rows (their means are then NaN, as JAX's are)."""
    n = (x.shape[0] // seg) * seg
    if n == 0:            # an empty transform is refused by some backends
        return torch.zeros((0, seg), dtype=torch.complex64, device=x.device)
    frames = x[:n].reshape(-1, seg) * _window(seg, window, x.device)[None, :]
    return torch.fft.fft(frames, dim=-1)


def spectrum(x: torch.Tensor, display_size: int = 512,
             window: Window = "blackman", average: float = 0.5,
             prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Averaged power spectrum of a block, fftshifted, bin-averaged down to
    display_size (the hs-scope recipe: segments of 4*displaySize)."""
    seg = 4 * display_size
    spec = torch.fft.fftshift(_frame_fft(x, seg, window), dim=-1).abs() ** 2
    binned = spec.mean(dim=0).reshape(display_size, 4).mean(dim=-1)
    if prev is not None:
        binned = average * prev + (1.0 - average) * binned
    return binned


def spectrum_db(x: torch.Tensor, display_size: int = 512,
                **kw) -> torch.Tensor:
    p = spectrum(x, display_size, **kw)
    return 10.0 * torch.log10(torch.clamp(p, min=1e-20))


def map_spectrum(bins: torch.Tensor, display_size: int, zoom_factor: int = 1,
                 show_full: bool = True):
    """The LF scope's display fold (ls_scope::mapSpectrum,
    ls-scope.cpp:131-176): amplitude bins averaged `factor` at a time into
    the display, with the zoom factor narrowing the folded span.  Reference
    quirks preserved: `factor /= 2` is unconditional (the half-spectrum
    branch is commented out upstream), and a too-large zoom is clamped to
    the available factor.  Full mode maps DC..+f up from mid-display and
    the top bins (negative frequencies) mirrored below mid.

    Returns (display [display_size], effective_zoom).
    """
    mag = bins.abs()
    n = mag.shape[-1]
    factor = n // display_size
    factor //= 2
    if factor // max(zoom_factor, 1) >= 1:
        factor //= zoom_factor
        eff_zoom = zoom_factor
    else:
        eff_zoom = factor
        factor = 1
    if show_full:
        half = display_size // 2
        up = mag[: half * factor].reshape(half, factor).mean(-1)
        rev = mag.flip(-1)[: half * factor].reshape(half, factor).mean(-1)
        out = torch.cat([rev.flip(-1), up])
    else:
        out = mag[: display_size * factor].reshape(display_size,
                                                   factor).mean(-1)
    return out, eff_zoom


def lf_spectrum(x: torch.Tensor, sample_rate: float, display_size: int = 512,
                zoom_factor: int = 1, show_full: bool = True,
                window: Window = "blackman"):
    """LF scope spectrum (ls_scope::processLFSpectrum, ls-scope.cpp:76-128):
    windowed FFT of 4*display_size segments, amplitude-averaged across
    segments, folded through `map_spectrum`.  Returns
    (x_axis_khz [display_size] numpy, amplitudes [display_size] tensor,
    effective_zoom) — the x axis follows the reference's labeling
    (±rate/2/zoom for full, 0..rate/2/zoom for half, ls-scope.cpp:106-120).
    """
    seg = 4 * display_size
    bins = _frame_fft(x, seg, window).abs().mean(dim=0)
    out, eff_zoom = map_spectrum(bins, display_size, zoom_factor, show_full)
    temp = sample_rate / 2.0 / display_size
    i = np.arange(display_size)
    if show_full:
        xa = (-(sample_rate / 2.0) + 2 * i * temp) / 1000.0 / eff_zoom
    else:
        xa = (i * temp) / 1000.0 / eff_zoom
    return xa, out, eff_zoom


def waterfall(blocks_spectra) -> np.ndarray:
    """Stack per-block spectra [n_blocks, display] into a waterfall image."""
    return np.stack(blocks_spectra, axis=0)


def iq_constellation(iq_points: np.ndarray, extent: float = 2.0,
                     grid: int = 101) -> np.ndarray:
    """Histogram RDS symbols onto the reference's 101x101 display grid."""
    img = np.zeros((grid, grid), np.float32)
    pts = np.clip((np.stack([iq_points.real, iq_points.imag], -1) / extent
                   + 0.5) * (grid - 1), 0, grid - 1).astype(np.int32)
    np.add.at(img, (pts[:, 1], pts[:, 0]), 1.0)
    return img
