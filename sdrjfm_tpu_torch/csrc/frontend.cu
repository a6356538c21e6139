// Fused FM front end for Hopper (sm_90a): wire decode + input gains + DC
// correction + exact integer-NCO LO mix + 307-tap composite ÷12, in one pass
// over the 2.304 MS/s input.
//
// Replaces the TPU kernel sdrjfm_tpu/ops/pallas_frontend.py::_kernel
// (launched by _frontend_call, wrapped by PallasFrontend.__call__), and is
// built to the production XLA semantics of Receiver.front_end
// (sdrjfm_tpu/models/receiver.py:560-646), not to the Pallas kernel's
// approximations:
//   * it reads the wire format directly: complex64 [T], or int16 / uint8 /
//     int8 [T,2] with the receiver's scalings;
//   * the gains and the DC correction are f32 (no 16.16 fixed point);
//   * the carry is the last 306 MIXED samples, exactly fir_decimate's
//     new_carry, so consecutive blocks stitch with no skipped outputs;
//   * it also emits per-block partial sums of x[::64] taken after the gains
//     and before the DC subtraction, so the DC servo needs no second read of
//     the input.
//
// Output alignment (blockops.fir_decimate with factor 12):
//   xp = concat(carry[306], mixed block);  y[m] = sum_k hc[k] xp[12m+317-k].
//
// What bounds it on an H100: per 131072-output block in int16 it must read
// 6.3 MB of input and write 1 MB (~2.2 us at 3.35 TB/s) and do 80.5 M
// real FMAs of the FIR (161 MFLOP, ~2.4 us at the 67 TFLOP/s FP32 rate), so
// the two bounds are close and the arithmetic is the larger.  Design: one
// thread block per 256-output tile; its 3367-sample input window is decoded,
// gained, DC-corrected and mixed once and staged in shared memory in
// polyphase order P[p][j] = window[12j + p], so that thread t's taps read
// P[p][t + r] — consecutive threads, consecutive addresses, no bank
// conflicts.  Each thread accumulates one output in f32 registers; taps sit
// in shared memory and are read as a broadcast.  Every FMA pair costs one
// 8-byte shared load, so this simple design is shared-memory-bandwidth
// bound (~4x over the FMA bound); register blocking over adjacent outputs
// or a tensor-core (3xTF32 wgmma) formulation is the next step.
//
// The NCO phase index (f * (n0 + n)) mod q is computed exactly in 64-bit
// integers — the same integer that blockops.oscillator_phases builds from
// base-512 int32 digits — and the phase is f32(2*pi/q) * f32(index), then
// an accurate sincosf (this file must not be built with --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DECIM = 12;
constexpr int NTAPS = 307;
constexpr int HALO = NTAPS - 1;               // 306 carried mixed samples
constexpr int LEAD = NTAPS - DECIM;           // 295 window samples before a tile's own range
constexpr int TILE = 256;                     // outputs per block == threads per block
constexpr int NROW = (NTAPS + DECIM - 1) / DECIM;   // 26 polyphase rows
constexpr int WIN = DECIM * TILE + LEAD;      // 3367 window samples
constexpr int PW = TILE + NROW;               // 282 >= ceil(WIN / 12) per phase
constexpr int DC_STRIDE = 64;
constexpr float RF_DC_LIMIT = 0.01f;

template <int FMT>
__device__ __forceinline__ float2 load_wire(const void* __restrict__ p,
                                            long long n) {
  if constexpr (FMT == 0) {                   // complex64
    return reinterpret_cast<const float2*>(p)[n];
  } else if constexpr (FMT == 1) {            // int16 pairs / 32768
    short2 v = reinterpret_cast<const short2*>(p)[n];
    return make_float2(__fmul_rn((float)v.x, 1.0f / 32768.0f),
                       __fmul_rn((float)v.y, 1.0f / 32768.0f));
  } else if constexpr (FMT == 2) {            // uint8 pairs (v - 127) / 128
    uchar2 v = reinterpret_cast<const uchar2*>(p)[n];
    return make_float2(__fmul_rn((float)v.x - 127.0f, 1.0f / 128.0f),
                       __fmul_rn((float)v.y - 127.0f, 1.0f / 128.0f));
  } else {                                    // int8 pairs / 128
    char2 v = reinterpret_cast<const char2*>(p)[n];
    return make_float2(__fmul_rn((float)v.x, 1.0f / 128.0f),
                       __fmul_rn((float)v.y, 1.0f / 128.0f));
  }
}

template <int FMT>
__global__ void __launch_bounds__(TILE)
frontend_kernel(const void* __restrict__ wire, long long T,
                const float2* __restrict__ carry,
                const float* __restrict__ taps,
                const float* __restrict__ lgain,
                const float* __restrict__ rgain,
                const float2* __restrict__ rf_dc,
                const int* __restrict__ lo_freq,
                const int* __restrict__ n0_mod,
                int dc_on, int q, float w_rad,
                float2* __restrict__ y, float2* __restrict__ new_carry,
                float2* __restrict__ dc_part) {
  __shared__ float2 P[DECIM][PW];
  __shared__ float H[DECIM][NROW];
  __shared__ float2 red[TILE / 32];

  const int tid = threadIdx.x;
  const long long M = T / DECIM;
  const long long m0 = (long long)blockIdx.x * TILE;
  const long long base = DECIM * m0 - LEAD;   // block index of window[0]

  // polyphase tap table: H[p][r] = hc[306 - 12r - p] (0 past the kernel)
  for (int i = tid; i < DECIM * NROW; i += TILE) {
    const int p = i / NROW, r = i % NROW;
    const int k = HALO - DECIM * r - p;
    H[p][r] = k >= 0 ? taps[k] : 0.0f;
  }

  const float lg = *lgain, rg = *rgain;
  float2 corr = make_float2(0.0f, 0.0f);
  if (dc_on) {
    const float2 d = *rf_dc;
    corr = make_float2(fminf(fmaxf(d.x, -RF_DC_LIMIT), RF_DC_LIMIT),
                       fminf(fmaxf(d.y, -RF_DC_LIMIT), RF_DC_LIMIT));
  }
  // floor-mod into [0, q), as jnp's % does for a negative LO
  const long long fq = (((long long)*lo_freq % q) + q) % q;
  const long long n0 = (((long long)*n0_mod % q) + q) % q;

  float2 dc_sum = make_float2(0.0f, 0.0f);
  for (int w = tid; w < WIN; w += TILE) {
    const long long n = base + w;
    float2 v;
    if (n < 0) {
      v = carry[HALO + n];                    // already mixed
    } else if (n < T) {
      const float2 raw = load_wire<FMT>(wire, n);
      const float xr = __fmul_rn(raw.x, lg);
      const float xi = __fmul_rn(raw.y, rg);
      if (dc_on && w >= LEAD && (n % DC_STRIDE) == 0) {
        dc_sum.x += xr;
        dc_sum.y += xi;
      }
      const float gr = __fsub_rn(xr, corr.x);
      const float gi = __fsub_rn(xi, corr.y);
      const long long idx = (fq * ((n0 + n) % q)) % q;
      const float ph = __fmul_rn(w_rad, (float)idx);
      float s, c;
      sincosf(ph, &s, &c);
      // x * e^{-j ph}
      v = make_float2(__fadd_rn(__fmul_rn(gr, c), __fmul_rn(gi, s)),
                      __fsub_rn(__fmul_rn(gi, c), __fmul_rn(gr, s)));
      if (w >= LEAD && n >= T - HALO) new_carry[n - (T - HALO)] = v;
    } else {
      v = make_float2(0.0f, 0.0f);            // ragged last tile
    }
    P[w % DECIM][w / DECIM] = v;
  }

  // per-tile partial sum of the DC subsample
  if (dc_part != nullptr) {
    for (int off = 16; off > 0; off >>= 1) {
      dc_sum.x += __shfl_down_sync(0xffffffffu, dc_sum.x, off);
      dc_sum.y += __shfl_down_sync(0xffffffffu, dc_sum.y, off);
    }
    if ((tid & 31) == 0) red[tid >> 5] = dc_sum;
  }
  __syncthreads();
  if (dc_part != nullptr && tid == 0) {
    float2 s = red[0];
    for (int i = 1; i < TILE / 32; ++i) {
      s.x += red[i].x;
      s.y += red[i].y;
    }
    dc_part[blockIdx.x] = s;
  }

  // y[m0 + t] = sum_{p, r} H[p][r] * P[p][t + r]
  float ar = 0.0f, ai = 0.0f;
#pragma unroll
  for (int p = 0; p < DECIM; ++p) {
#pragma unroll
    for (int r = 0; r < NROW; ++r) {
      const float h = H[p][r];
      const float2 x = P[p][tid + r];
      ar = fmaf(h, x.x, ar);
      ai = fmaf(h, x.y, ai);
    }
  }
  if (m0 + tid < M) y[m0 + tid] = make_float2(ar, ai);
}

}  // namespace

extern "C" {

// fmt: 0 complex64 [T], 1 int16 [T,2], 2 uint8 [T,2], 3 int8 [T,2].
// Scalars are device pointers (no host sync): lgain/rgain f32, rf_dc
// complex64, lo_freq/n0_mod int32.  dc_part may be null (dc_on == 0),
// else it has ceil(T/12/256) float2 slots.  Returns cudaGetLastError().
int sdr_frontend(const void* wire, int fmt, long long T, const void* carry,
                 const void* taps, const void* lgain, const void* rgain,
                 const void* rf_dc, const void* lo_freq, const void* n0_mod,
                 int dc_on, int q, float w_rad, void* y, void* new_carry,
                 void* dc_part, void* stream) {
  const long long M = T / DECIM;
  const unsigned grid = (unsigned)((M + TILE - 1) / TILE);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define SDR_FE_ARGS                                                     \
  wire, T, (const float2*)carry, (const float*)taps, (const float*)lgain, \
      (const float*)rgain, (const float2*)rf_dc, (const int*)lo_freq,    \
      (const int*)n0_mod, dc_on, q, w_rad, (float2*)y, (float2*)new_carry, \
      (float2*)dc_part
  switch (fmt) {
    case 0: frontend_kernel<0><<<grid, TILE, 0, st>>>(SDR_FE_ARGS); break;
    case 1: frontend_kernel<1><<<grid, TILE, 0, st>>>(SDR_FE_ARGS); break;
    case 2: frontend_kernel<2><<<grid, TILE, 0, st>>>(SDR_FE_ARGS); break;
    case 3: frontend_kernel<3><<<grid, TILE, 0, st>>>(SDR_FE_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_FE_ARGS
  return (int)cudaGetLastError();
}

int sdr_frontend_tile() { return TILE; }

}  // extern "C"
