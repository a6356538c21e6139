"""Rate contract and fixed sizes of the FM receive chain.

These mirror the signal contract of the reference receiver
(/root/reference/includes/fm-constants.h:35,105-119, radio.cpp:231-233,
src/fm/fm-processor.cpp:31-36) — the *semantics*, not the code: every stage of
the TPU pipeline obeys the same rate cascade 2,304,000 -> 384,000 -> 192,000
-> 48,000 and the same 19 kHz pilot / 57 kHz RDS frequency plan.
"""

INPUT_RATE = 2_304_000       # complex IQ samples/s into the chain
IRATE = INPUT_RATE // 6      # 384_000, after first decimation stage
FM_RATE = 192_000            # the "fmRate": demodulation rate
WORKING_RATE = 48_000        # audio rate after final decimation
RDS_RATE = 24_000            # RDS processing rate (FM_RATE // 8)

PILOT_FREQUENCY = 19_000     # stereo pilot
RDS_FREQUENCY = 3 * PILOT_FREQUENCY          # 57 kHz RDS subcarrier
RDS_WIDTH = 2 * 2400         # RDS bandpass width (fm-constants.h:119)
RDS_BITCLK_HZ = 1187.5       # RDS symbol rate = 19000 / 16

OMEGA_PILOT = 2.0 * 3.141592653589793 * PILOT_FREQUENCY / FM_RATE

# Decimation factors
DECIM_1 = INPUT_RATE // IRATE    # 6
DECIM_2 = IRATE // FM_RATE       # 2
DECIM_AUDIO = FM_RATE // WORKING_RATE   # 4
DECIM_RDS = FM_RATE // RDS_RATE         # 8

# Filter sizes (reference contract: fm-constants.h:105-106, fm-processor.cpp:76-86,148)
FIR_BAND1_TAPS = 4 * DECIM_1 + 1         # 25 taps @ input rate
FIR_BAND2_TAPS = DECIM_2 + 1             # 3 taps @ IRate
INPUT_FFT_SIZE = 2 * 32768               # strong input channel filter
INPUT_FILTER_DEGREE = 251
AUDIO_FFT_SIZE = 2 * 4096
AUDIO_FILTER_DEGREE = 756
RDS_FFT_SIZE = 32768                     # FFT_SIZE
PILOTFILTER_SIZE = 768
PSS_FFT_SIZE = 2048
PSS_FILTER_DEGREE = 295

# Deemphasis time constants (us); alpha = 1/(fmRate/tau_rate + 1),
# fm-processor.cpp:174,291-297
DEEMPHASIS_EU_US = 50.0
DEEMPHASIS_US_US = 75.0


def deemphasis_alpha(tau_us: float = DEEMPHASIS_EU_US, rate: int = FM_RATE) -> float:
    """One-pole deemphasis coefficient.

    Mirrors ``fmProcessor::setDeemphasis`` (fm-processor.cpp:291-297):
    ``Tau = 1e6 / v;  alpha = 1 / (fmRate / Tau + 1)`` — the value in effect
    at runtime (the constructor initialiser at :174 is overwritten by the GUI
    restoring the deemphasis setting at startup).
    """
    if tau_us <= 0:                      # "off": unit-gain passthrough
        return 1.0
    tau = 1_000_000.0 / tau_us
    return 1.0 / (float(rate) / tau + 1.0)


# --- demodulator scaling (src/fm/fm-demodulator.cpp:56-64) -------------------
def k_fm(rate: int = FM_RATE) -> float:
    """FM gain constant; ~15.04 at 192 kHz (fm-demodulator.cpp:58-64)."""
    f_g = 0.65 * rate / 2.0
    delta_f = 0.95 * rate / 2.0
    b_fm = 2.0 * (delta_f + f_g)
    return 2.0 * b_fm * 3.141592653589793 / f_g


# one-pole tracker coefficients (fm-demodulator.cpp:116-118)
CARRIER_ALPHA = 0.0010      # AM carrier-level tracker
FM_DC_ALPHA = 0.0001        # post-demod DC / AFC tracker
DEMOD_GAIN = 20.0           # output scale: 20*(res-afc)*fm_cvt/K_FM (:205)

# pilot PLL contract (fm-processor.cpp:78-80, pilot-recover.cpp:54-80)
PILOT_PLL_GAIN = 10.0 * 2.0 * 3.141592653589793 / FM_RATE
PILOT_LOCK_ALPHA = 1.0 / 3000.0
PILOT_LOCK_THRESHOLD = 0.07
PILOT_LOCK_STABLE_S = 0.5   # lock must hold 500 ms (pilot-recover.cpp:71-80)

# PSS contract (fm-processor.cpp:81-82, stereo-separation.cpp:60-110)
PSS_ALPHA = 10.0 / FM_RATE
PSS_LOCK_ALPHA = 1.0 / FM_RATE
PSS_ERROR_BOOST = 10.0
PSS_LOCK_THRESHOLD = 0.001
PSS_LOCK_STABLE_S = 3.0
PSS_CLAMP = 3.141592653589793 / 4.0

# input DC servo (fm-processor.cpp:379,423-446)
RF_DC_ALPHA = 1.0 / INPUT_RATE
RF_DC_LIMIT = 0.01

# RDS decimator at the fm rate tap (fm-processor.cpp:382)
RDS_DECIM_TAPS = 11

# audio startup ramp: 0.5 s at working rate (fm-processor.cpp:130-131,638-642)
AUDIO_SUPPRESS_S = 0.5
