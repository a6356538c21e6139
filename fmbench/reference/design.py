"""Constants and filter designs of the receive chain, frozen for the plain
reference (the rate plan and the designs of sdr-j-fm that the port
follows: fm-constants.h, fir-filters.cpp, shaping_filter.cpp,
fm-demodulator.cpp, pilot-recover.cpp, stereo-separation.cpp)."""

from __future__ import annotations

import math

import numpy as np

INPUT_RATE = 2_304_000
FM_RATE = 192_000
WORKING_RATE = 48_000
RDS_RATE = 24_000
PILOT_HZ = 19_000
RDS_HZ = 57_000
RDS_WIDTH = 4800
RDS_BITCLK_HZ = 1187.5

FM_DC_ALPHA = 0.0001              # AFC tracker
DEMOD_GAIN = 20.0
PILOT_LOCK_ALPHA = 1.0 / 3000.0
PILOT_LOCK_THRESHOLD = 0.07
PILOT_LOCK_STABLE_S = 0.5
PSS_ALPHA = 10.0 / FM_RATE
PSS_ERROR_BOOST = 10.0
PSS_LOCK_THRESHOLD = 0.001
PSS_LOCK_STABLE_S = 3.0
PSS_CLAMP = math.pi / 4.0
PSS_TAPS = 295
RF_DC_ALPHA = 1.0 / INPUT_RATE
RF_DC_LIMIT = 0.01
RDS_DECIM_TAPS = 11
PILOT_BP_TAPS = 1537
AUDIO_FILTER_TAPS = 756
FM_FFT, FM_HOP = 8192, 4096


def k_fm(rate: int = FM_RATE) -> float:
    f_g = 0.65 * rate / 2.0
    delta_f = 0.95 * rate / 2.0
    return 2.0 * (2.0 * (delta_f + f_g)) * math.pi / f_g


def deemphasis_alpha(tau_us: float, rate: int = FM_RATE) -> float:
    if tau_us <= 0:
        return 1.0
    return 1.0 / (float(rate) / (1e6 / tau_us) + 1.0)


def _blackman(taps: int) -> np.ndarray:
    i = np.arange(taps, dtype=np.float64)
    return (0.42 - 0.5 * np.cos(2 * np.pi * i / taps)
            + 0.08 * np.cos(4 * np.pi * i / taps))


def _sinc(taps: int, f: float) -> np.ndarray:
    m = np.arange(taps, dtype=np.float64) - taps // 2
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.sin(2 * np.pi * f * m) / m
    v[taps // 2] = 2 * np.pi * f
    return v * _blackman(taps)


def lowpass(taps: int, fc: float, fs: float) -> np.ndarray:
    v = _sinc(taps, fc / fs)
    return v / v.sum()


def bandpass_complex(taps: int, low: float, high: float, fs: float):
    v = _sinc(taps, (high - low) / 2.0 / fs)
    m = np.arange(taps, dtype=np.float64) - taps // 2
    return v / v.sum() * np.exp(2j * np.pi * (high + low) / 2.0 / fs * m)


def response(kernel: np.ndarray, size: int) -> np.ndarray:
    buf = np.zeros(size, np.complex128)
    buf[:len(kernel)] = kernel
    return np.fft.fft(buf)


def rrc(rate: float, symbol_rate: float, ntaps: int) -> np.ndarray:
    """Root-raised-cosine, roll-off 1, with the alpha = 1 patch of
    shaping_filter.cpp:33-38, unit DC gain."""
    spb = rate / symbol_rate
    taps = np.zeros(ntaps | 1)
    for i in range(len(taps)):
        x = i - len(taps) // 2
        x1 = np.pi * x / spb
        x3 = (4.0 * x / spb) ** 2 - 1.0
        if abs(x3) >= 1e-6:
            num = np.cos(2 * x1) + (np.sin(0 * x1) / (4 * x / spb)
                                    if x else 0.0)
            taps[i] = 4 * num / (x3 * np.pi)
        else:
            taps[i] = -1.0
    return taps / taps.sum()
