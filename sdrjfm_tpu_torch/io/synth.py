"""Broadcast-FM MPX/IQ synthesizer — the test-signal oracle.

The reference has no test fixtures at all (SURVEY.md §4); correctness there
is judged by ear and by RDS CRC counters.  This module builds the fixtures we
need: a fully parameterised stereo multiplex with pilot, 38 kHz DSB-SC L-R,
and 57 kHz BPSK RDS (spec-correct differential encoding + offset words are
applied by rds/encode.py), FM-modulated to 2.304 MS/s IQ.  End-to-end tests
demodulate these and assert audio SNR, stereo separation, and RDS BER.

Convention: pilot = sin(w19 t), subcarrier = sin(2 w19 t) (the broadcast
standard's phase-locked relationship that the receiver's 2*(phi+pi/4)
reconstruction expects), RDS carrier = cos(3 w19 t) — any fixed RDS phase is
legal per spec; the receiver's carrier-phase estimator resolves it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import constants as C


@dataclass
class MPXParams:
    rate: int = C.FM_RATE                 # synthesis rate of the multiplex
    audio_level: float = 0.9              # (L+R)/2 + subcarrier share
    pilot_level: float = 0.1              # ~9-10 % pilot deviation share
    rds_level: float = 0.06
    pilot_phase0: float = 0.0
    pss_phase_error: float = 0.0          # extra subcarrier phase offset (rad)


def synth_mpx(left: np.ndarray, right: np.ndarray, p: MPXParams,
              rds_bits: np.ndarray | None = None) -> np.ndarray:
    """Build the baseband multiplex at p.rate from audio L/R at p.rate."""
    n = len(left)
    t = np.arange(n, dtype=np.float64)
    theta = 2.0 * np.pi * C.PILOT_FREQUENCY / p.rate * t + p.pilot_phase0
    lsum = 0.5 * (left + right)
    ldiff = 0.5 * (left - right)
    mpx = p.audio_level * (lsum + np.sin(2.0 * theta + p.pss_phase_error) * ldiff)
    mpx += p.pilot_level * np.sin(theta)
    if rds_bits is not None:
        bb = rds_baseband(rds_bits, n, p.rate)
        mpx += p.rds_level * bb * np.cos(3.0 * theta)
    return mpx.astype(np.float64)


def rds_baseband(bits: np.ndarray, n: int, rate: int) -> np.ndarray:
    """Biphase (Manchester) shaped RDS baseband at `rate`.

    Each differential-encoded data bit becomes the pair (b, ~b) at 2*1187.5
    symbols/s, shaped by the spec's ~2.4 kHz lowpass (approximated by a 100 %
    roll-off RRC as in the reference's decoder-2 matched filter,
    rds-decoder-2.cpp:63-69).
    """
    from ..ops.design import root_raised_cosine
    sym_rate = 2.0 * C.RDS_BITCLK_HZ
    nsym = int(np.ceil(n * sym_rate / rate)) + 2
    nbits = (nsym + 1) // 2 + 1
    bits = np.resize(bits, nbits).astype(np.int8)
    symbols = np.empty(2 * nbits, dtype=np.float64)
    symbols[0::2] = 2.0 * bits - 1.0
    symbols[1::2] = -(2.0 * bits - 1.0)
    # impulse train at symbol instants, shaped by RRC
    bb = np.zeros(n, dtype=np.float64)
    pos = np.arange(2 * nbits) * (rate / sym_rate)
    idx = np.round(pos).astype(np.int64)
    keep = idx < n
    bb[idx[keep]] = symbols[keep]
    taps = root_raised_cosine(1.0, rate, sym_rate, 1.0, 161)
    bb = np.convolve(bb, taps, mode="same")
    # normalise to unit peak
    m = np.abs(bb).max()
    return bb / m if m > 0 else bb


def fm_modulate(mpx: np.ndarray, mpx_rate: int,
                out_rate: int = C.INPUT_RATE,
                deviation_hz: float = 75000.0,
                carrier_offset_hz: float = 0.0,
                amplitude: float = 1.0,
                noise_std: float = 0.0,
                seed: int = 0) -> np.ndarray:
    """FM-modulate the multiplex into complex IQ at out_rate."""
    assert out_rate % mpx_rate == 0
    up = out_rate // mpx_rate
    if up > 1:
        # polyphase upsampling: a flat response across the whole multiplex
        # (linear interpolation would shave ~13 % off the 38 kHz subcarrier
        # and cap measurable stereo separation at ~23 dB)
        from scipy.signal import resample_poly
        mpx_up = resample_poly(mpx, up, 1)
    else:
        mpx_up = mpx
    inst = 2.0 * np.pi * (deviation_hz * mpx_up + carrier_offset_hz) / out_rate
    phase = np.cumsum(inst)
    iq = amplitude * np.exp(1j * phase)
    if noise_std > 0:
        rng = np.random.default_rng(seed)
        iq = iq + noise_std * (rng.standard_normal(len(iq))
                               + 1j * rng.standard_normal(len(iq))) / np.sqrt(2)
    return iq.astype(np.complex64)


def tones(n: int, rate: int, freqs=(1000.0,), amps=(0.8,)) -> np.ndarray:
    t = np.arange(n, dtype=np.float64) / rate
    out = np.zeros(n, dtype=np.float64)
    for f, a in zip(freqs, amps):
        out += a * np.sin(2.0 * np.pi * f * t)
    return out


def expected_demod_gain(deviation_hz: float = 75000.0,
                        rate: int = C.FM_RATE) -> float:
    """Scale factor from mpx amplitude to receiver demod output.

    demod = 20/K_FM * inst_freq[rad/sample at fmRate]  (fm-demodulator.cpp:205)
    """
    return (C.DEMOD_GAIN / C.k_fm(rate)) * 2.0 * np.pi * deviation_hz / rate


def iq_to_i16(iq: np.ndarray) -> np.ndarray:
    """Quantize complex IQ to the i16 wire format ([n, 2] int16, the PCM16
    wav layout read back by wavio.read_iq_wav_raw / ReceiverConfig
    iq_format='i16')."""
    return np.stack([np.round(iq.real * 32768.0),
                     np.round(iq.imag * 32768.0)],
                    axis=1).clip(-32768, 32767).astype(np.int16)


def iq_to_i8(iq: np.ndarray) -> np.ndarray:
    """Quantize complex IQ to the i8 wire format ([n, 2] int8, the hackrf
    handler's (v)/128 convention inverted, hackrf-handler.cpp:360-365 —
    hackrf_transfer raw captures are signed bytes)."""
    return np.stack([np.round(iq.real * 128.0),
                     np.round(iq.imag * 128.0)],
                    axis=1).clip(-128, 127).astype(np.int8)


def iq_to_u8(iq: np.ndarray) -> np.ndarray:
    """Quantize complex IQ to the u8 wire format ([n, 2] uint8, the rtlsdr
    handler's (v-127)/128 convention inverted)."""
    return np.stack([np.round(iq.real * 128.0) + 127,
                     np.round(iq.imag * 128.0) + 127],
                    axis=1).clip(0, 255).astype(np.uint8)
