"""Host-side filter/kernel design.

All designs run once at pipeline-construction time in numpy (float64) and are
then frozen into device constants, so there is no LUT machinery on the TPU —
the reference's SinCos/atan2 tables (src/various/sincos.cpp, Xtan2.cpp) are
replaced by vectorized transcendentals on the VPU.

The windowed-sinc recipes mirror the reference's generators semantically
(src/various/fir-filters.cpp): Blackman window over `taps` points with the
centre tap patched to 2*pi*fc, normalised to unit DC gain.  The reference's
DecimatingFIR stores a complex kernel whose imaginary part is the
*unnormalised* tap (fir-filters.cpp:345-346) — that multiplies the whole
stream by the constant (1 + j*sum), a fixed gain/rotation with no effect on
any downstream phase-difference or envelope computation, so we design the
plain real kernel.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "blackman_window",
    "lowpass_sinc",
    "highpass_sinc",
    "bandpass_real",
    "bandpass_complex",
    "fft_filter_response",
    "hilbert_response",
    "root_raised_cosine",
    "biphase_matched_kernel",
    "compute_ntaps",
    "polyphase_resampler_kernel",
    "cheby1_sos",
    "butter_sos",
    "bandpass_butter_sos",
]


def blackman_window(taps: int) -> np.ndarray:
    """Blackman window as used by the reference (fir-filters.cpp:52-55).

    Note the denominator is `taps` (filterSize), not `taps - 1`.
    """
    i = np.arange(taps, dtype=np.float64)
    return (0.42
            - 0.50 * np.cos(2.0 * np.pi * i / taps)
            + 0.08 * np.cos(4.0 * np.pi * i / taps))


def _sinc_core(taps: int, f: float) -> np.ndarray:
    """Windowed sinc before normalisation (fir-filters.cpp:44-57)."""
    i = np.arange(taps, dtype=np.float64)
    m = i - taps // 2
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.sin(2.0 * np.pi * f * m) / m
    v[taps // 2] = 2.0 * np.pi * f
    return v * blackman_window(taps)


def lowpass_sinc(taps: int, fc: float, fs: float) -> np.ndarray:
    """Blackman-windowed sinc lowpass, unit DC gain (LowPassFIR::newKernel)."""
    v = _sinc_core(taps, fc / fs)
    return (v / v.sum()).astype(np.float64)


def highpass_sinc(taps: int, fc: float, fs: float) -> np.ndarray:
    """Spectral-inversion highpass (HighPassFIR::newKernel, fir-filters.cpp:82-105)."""
    v = _sinc_core(taps, fc / fs)
    k = -v / v.sum()
    k[taps // 2] += 1.0
    return k


def bandpass_real(taps: int, low: float, high: float, fs: float) -> np.ndarray:
    """Difference-of-lowpass real bandpass (BasicBandPass, fir-filters.cpp:115-165).

    kernel = lp(high) - lp(low), each normalised to unit DC gain.
    """
    lo = _sinc_core(taps, low / fs)
    hi = _sinc_core(taps, high / fs)
    return hi / hi.sum() - lo / lo.sum()


def bandpass_complex(taps: int, low: float, high: float, fs: float) -> np.ndarray:
    """Complex band-shifted lowpass (BandPassFIR::newKernel, fir-filters.cpp:195-229).

    A lowpass of width (high-low)/2 modulated to centre (high+low)/2; selects
    one side of the complex spectrum.
    """
    width = (high - low) / 2.0 / fs
    shift = (high + low) / 2.0 / fs
    v = _sinc_core(taps, width)
    v = v / v.sum()
    m = np.arange(taps, dtype=np.float64) - taps // 2
    return v * np.exp(1j * 2.0 * np.pi * shift * m)


def fft_filter_response(kernel: np.ndarray, fft_size: int) -> np.ndarray:
    """Frequency response H(k) of a (short) kernel zero-padded to fft_size.

    Mirrors fftFilter::setLowPass/setBand (fft-filters.cpp:58-95); used by the
    overlap-save fast convolver.
    """
    buf = np.zeros(fft_size, dtype=np.complex128)
    buf[: len(kernel)] = kernel
    return np.fft.fft(buf)


def hilbert_response(fft_size: int) -> np.ndarray:
    """One-sided spectrum multiplier (fftFilterHilbert::setHilbert,
    fft-filters.cpp:186-201): DC and Nyquist 1, positive freqs 2, negative 0.
    """
    h = np.zeros(fft_size, dtype=np.float64)
    h[0] = 1.0
    if fft_size % 2 == 0:
        h[1 : fft_size // 2] = 2.0
        h[fft_size // 2] = 1.0
    else:
        h[1 : (fft_size + 1) // 2] = 2.0
    return h


def root_raised_cosine(gain: float, sampling_freq: float, symbol_rate: float,
                       alpha: float, ntaps: int) -> np.ndarray:
    """GnuRadio-style RRC taps with the reference's alpha==1 bugfix
    (src/various/shaping_filter.cpp:33-38).
    """
    ntaps |= 1
    spb = sampling_freq / symbol_rate
    taps = np.zeros(ntaps, dtype=np.float64)
    scale = 0.0
    for i in range(ntaps):
        xindx = i - ntaps // 2
        x1 = np.pi * xindx / spb
        x2 = 4.0 * alpha * xindx / spb
        x3 = x2 * x2 - 1.0
        if abs(x3) >= 1e-6:
            if i != ntaps // 2:
                num = (np.cos((1 + alpha) * x1)
                       + np.sin((1 - alpha) * x1) / (4 * alpha * xindx / spb))
            else:
                num = np.cos((1 + alpha) * x1) + (1 - alpha) * np.pi / (4 * alpha)
            den = x3 * np.pi
        else:
            if alpha == 1:
                taps[i] = -1.0
                scale += taps[i]
                continue
            x3 = (1 - alpha) * x1
            x2 = (1 + alpha) * x1
            num = (np.sin(x2) * (1 + alpha) * np.pi
                   - np.cos(x3) * ((1 - alpha) * np.pi * spb) / (4 * alpha * xindx)
                   + np.sin(x3) * spb * spb / (4 * alpha * xindx * xindx))
            den = -32.0 * np.pi * alpha * alpha * xindx / spb
        taps[i] = 4 * alpha * num / den
        scale += taps[i]
    return taps * gain / scale


def biphase_matched_kernel(rate: float, bitclk_hz: float = 1187.5) -> np.ndarray:
    """cuteSDR bi-phase matched filter (rds-decoder-1.cpp:63-93).

    Odd antisymmetric kernel of length 2*length+1 where length is the even-
    floored symbol span plus one; the 64.01 constant avoids the reference's
    historical inf issue.
    """
    sps = rate / bitclk_hz
    symbol_ceiling = int(np.ceil(sps))
    length = (symbol_ceiling & ~0x1) + 1
    size = 2 * length + 1
    k = np.zeros(size, dtype=np.float64)
    i = np.arange(1, length + 1, dtype=np.float64)
    x = i / rate * bitclk_hz
    val = 0.75 * np.cos(4 * np.pi * x) * (1.0 / (1.0 / x - 64.01 * x)
                                          - 1.0 / (9.0 / x - 64.01 * x))
    k[length + 1 :] = val
    k[length - 1 :: -1] = -val
    return k


def compute_ntaps(sample_freq: float, transition_width: float,
                  attenuation_db: float = 74.0) -> int:
    """GnuRadio tap estimator (fir-filters.cpp:509-533); default Blackman."""
    ntaps = int(attenuation_db * sample_freq / (22.0 * transition_width))
    if ntaps % 2 == 0:
        ntaps += 1
    return ntaps


def polyphase_resampler_kernel(factor: int, taps_per_phase: int = 32,
                               rolloff: float = 0.90) -> np.ndarray:
    """Windowed-sinc anti-alias kernel for an integer-factor decimator.

    Plays the role of libsamplerate SRC_SINC_MEDIUM_QUALITY in the reference's
    fmRate->workingRate and workingRate->audioRate converters
    (src/various/newconverter.cpp:37); a fixed-ratio polyphase windowed sinc
    is the TPU-native equivalent for our exact integer ratios.
    """
    taps = factor * taps_per_phase + 1
    return lowpass_sinc(taps, rolloff * 0.5 / factor, 1.0)


# --- IIR biquad-cascade designs ---------------------------------------------
# The reference designs Chebyshev/Butterworth cascades from analog prototypes
# via the bilinear transform (src/various/iir-filters.cpp:79-117,410-597,
# apass = 1 dB).  scipy's cheby1/butter implement the same textbook recipe; we
# freeze second-order sections at build time.

def cheby1_sos(order: int, fc: float, fs: float, btype: str = "lowpass",
               rp_db: float = 1.0) -> np.ndarray:
    from scipy import signal
    return signal.cheby1(order, rp_db, fc, btype=btype, fs=fs, output="sos")


def butter_sos(order: int, fc: float, fs: float, btype: str = "lowpass") -> np.ndarray:
    from scipy import signal
    return signal.butter(order, fc, btype=btype, fs=fs, output="sos")


def bandpass_butter_sos(order: int, flow: float, fhigh: float, fs: float) -> np.ndarray:
    from scipy import signal
    return signal.butter(order, [flow, fhigh], btype="bandpass", fs=fs, output="sos")
