// Fused FM front end for Hopper (sm_90a): wire decode + input gains + DC
// correction + exact integer-NCO LO mix + 307-tap composite ÷12, in one pass
// over the 2.304 MS/s input, and the DC servo's subsample mean finished in
// the same launch.
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
//   * it sums x[::64] after the gains and before the DC subtraction, and the
//     thread block that finishes last turns the per-tile sums into the mean,
//     so the DC servo needs no second read of the input and no second launch.
//
// Rows: under jax.vmap the Pallas call gains a grid axis (stations over one
// shared block, the band scan's offsets x blocks).  Here one launch runs R
// rows; row r reads wire block block_index[r] of an [nb, ...] wire tensor
// with its own LO, NCO phase, gains, DC state and carry, and writes its own
// outputs.  The row is blockIdx.x, the fastest-varying index, so the R rows
// of one wire tile are scheduled together and the tile is read from HBM
// about once and from L2 by the other rows.  Each row keeps its own DC
// partials and ticket.  R = 1 is the one-station front end, bit for bit.
//
// Output alignment (blockops.fir_decimate with factor 12):
//   xp = concat(carry[306], mixed block);  y[m] = sum_k hc[k] xp[12m+317-k].
//
// What bounds it on an H100, per 131072-output block in int16: 6.3 MB read
// and 1 MB written (2.19 us at 3.35 TB/s); 80.5 M real FMAs of the FIR plus
// ~10 flops a sample for gains, DC and mix (2.64 us at the 67 TFLOP/s FP32
// rate).  The two are close; the operations are the larger.  Besides the FMA
// rate, what holds a direct design back is shared-memory bandwidth (one
// 8-byte load per FMA pair when each thread owns one output), the mix's
// integer work (64-bit `%` is emulated in software), the halo that each
// tile re-stages, and extra launches to finish the DC mean.  What this
// design does about each:
//   * register-blocked polyphase FIR: a thread accumulates J = 8 consecutive
//     outputs over 2 of the 12 phases, holding a phase's 26 taps in
//     registers, so each staged sample it loads feeds up to 8 FMA pairs
//     (26*8 FMA pairs per 33 loads).  Six phase groups are summed in a fixed
//     order through shared memory.  Shared memory holds the window as
//     S[p][c][u] with window index 12*(8u + c) + p, so lane g of a warp reads
//     S[p][i%8][g + i/8]: neighbouring lanes, neighbouring addresses.  The
//     phase planes are padded to an odd length so the mix's stores spread
//     over the banks;
//   * NCO without per-sample division: a thread computes the exact index
//     (f * (n0 + n)) mod q of its first position once (32-bit remainders,
//     and one product mod q whose quotient comes from doubles), then steps
//     it by (f * 384) mod q from one of its positions to the next, with one
//     32-bit add and one conditional subtract.  The phase is
//     f32(2*pi/q) * f32(index) and an accurate sincosf (no --use_fast_math),
//     as before.  The integer formats' scale is folded into the gains (a
//     power of two: the same f32 products);
//   * the tile's raw wire window goes to shared memory first, as 16-byte
//     cp.async copies that are all in flight at once, so the mix never
//     waits on device memory sample by sample; interior tiles mix most of
//     their positions with no bounds tests;
//   * 512-output tiles: the 295-sample halo is 4.8% of a tile's input
//     (9.6% with 256-output tiles);
//   * one launch per block: warp 0 sums the tile's DC points before the
//     mix and takes an atomic ticket whose round trip hides behind the mix;
//     the tile with the last ticket adds all tiles' sums in a fixed order
//     and resets the ticket for the next launch.
// Still on the table: the mix (an accurate sincosf a sample) and the FIR run
// one after the other in each thread block, and the copy overlaps neither;
// a persistent, warp-specialised kernel (one group of warps mixing the next
// tile while another filters this one), or the FIR as a 3xTF32 product on
// the tensor cores, are the next steps.  Measured: PERF.md (chip_smoke.py
// phase `times`).

#include <cuda/atomic>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DECIM = 12;
constexpr int NTAPS = 307;
constexpr int HALO = NTAPS - 1;               // 306 carried mixed samples
constexpr int LEAD = NTAPS - DECIM;           // 295 window samples before a tile's own range
constexpr int NROW = (NTAPS + DECIM - 1) / DECIM;   // 26 taps per phase
constexpr int J = 8;                          // consecutive outputs per thread
constexpr int GROUPS = 64;                    // output groups of J per tile
constexpr int TILE = GROUPS * J;              // 512 outputs per thread block
constexpr int PGROUPS = 6;                    // phase groups, PPG phases each
constexpr int PPG = DECIM / PGROUPS;
constexpr int THREADS = PGROUPS * GROUPS;     // 384
constexpr int WIN = DECIM * TILE + LEAD;      // 6439 window samples
constexpr int NI = J + NROW - 1;              // 33 polyphase columns a thread reads
constexpr int NU = (TILE + NROW - 2) / J + 1; // 68 columns of J
constexpr int PLANE = J * NU + 1;             // 545 (odd: phases spread over banks)
constexpr int WSTAGE = DECIM * J * NU;        // 6528 staged window positions
constexpr int ITERS = (WSTAGE + THREADS - 1) / THREADS;   // positions a thread
constexpr int RS = NU;                        // row stride of the phase-group sums
constexpr int DC_STRIDE = 64;
constexpr float RF_DC_LIMIT = 0.01f;
// shared memory: S, the taps, then the raw window
constexpr int RAW_OFFSET = DECIM * PLANE * 8 + DECIM * NROW * 4;
static_assert(DECIM % PGROUPS == 0 && GROUPS % 32 == 0, "warp mapping");
static_assert(PGROUPS * J * RS <= DECIM * PLANE, "sums alias the window");
static_assert(GROUPS - 1 + (NI - 1) / J < NU, "a thread's columns lie in S");
static_assert(RAW_OFFSET % 16 == 0, "raw window is 16-byte aligned");
static_assert(THREADS % (DECIM * J) == 0, "a thread's positions keep p, c");
static_assert((ITERS - 1) * THREADS <= WIN && LEAD < THREADS,
              "iterations 1 .. ITERS-2 hold own window samples only");

template <int FMT>
__host__ __device__ constexpr int spt() {     // samples per 16 bytes
  return FMT == 0 ? 2 : FMT == 1 ? 4 : 8;
}

template <int FMT>
constexpr int smem_bytes() {
  return RAW_OFFSET + ((WSTAGE - 1) / spt<FMT>() + 2) * 16;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// (a * b) mod q for 0 <= a, b < q < 2^22, without a 64-bit division: the
// quotient from doubles is off by at most one, the remainder is exact
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b, int q) {
  const long long p = (long long)a * b;
  const long long quo = (long long)((double)p / (double)q);
  long long r = p - quo * q;
  r += r < 0 ? q : 0;
  r -= r >= q ? q : 0;
  return (uint32_t)r;
}

// raw sample e of the staged wire window as floats, before the format's
// scale (the integer formats' 1/32768 or 1/128, folded into the gains)
template <int FMT>
__device__ __forceinline__ float2 decode(const uint4* raw, int e) {
  if constexpr (FMT == 0) {                   // complex64
    return reinterpret_cast<const float2*>(raw)[e];
  } else if constexpr (FMT == 1) {            // int16 pairs
    const short2 v = reinterpret_cast<const short2*>(raw)[e];
    return make_float2((float)v.x, (float)v.y);
  } else if constexpr (FMT == 2) {            // uint8 pairs, centred at 127
    const uchar2 v = reinterpret_cast<const uchar2*>(raw)[e];
    return make_float2((float)v.x - 127.0f, (float)v.y - 127.0f);
  } else {                                    // int8 pairs
    const char2 v = reinterpret_cast<const char2*>(raw)[e];
    return make_float2((float)v.x, (float)v.y);
  }
}

template <int FMT>
__host__ __device__ constexpr float wire_scale() {
  return FMT == 0 ? 1.0f : FMT == 1 ? 1.0f / 32768.0f : 1.0f / 128.0f;
}

template <int FMT>
__global__ void __launch_bounds__(THREADS, 2)
frontend_kernel(const void* __restrict__ wire, long long block_bytes,
                int nb, const int* __restrict__ block_index, int T,
                const float2* __restrict__ carry,
                const float* __restrict__ taps,
                const float* __restrict__ lgain,
                const float* __restrict__ rgain,
                const float2* __restrict__ rf_dc,
                const int* __restrict__ lo_freq,
                const int* __restrict__ n0_mod,
                int dc_on, int q, float w_rad,
                float2* __restrict__ y, float2* __restrict__ new_carry,
                float2* __restrict__ dc_part, unsigned* __restrict__ ticket,
                float2* __restrict__ dc_mean) {
  constexpr int SPT = spt<FMT>();
  extern __shared__ float4 smem_raw[];
  float2* S = reinterpret_cast<float2*>(smem_raw);        // [DECIM][PLANE]
  float* H = reinterpret_cast<float*>(S + DECIM * PLANE); // [DECIM][NROW]
  uint4* raw = reinterpret_cast<uint4*>(
      reinterpret_cast<char*>(smem_raw) + RAW_OFFSET);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int M = T / DECIM;
  // the row is the fastest-varying block index, so the rows that read one
  // wire tile run together and all but the first find it in L2
  const int row = blockIdx.x, tile = blockIdx.y, ntiles = gridDim.y;
  const int m0 = tile * TILE;
  const int base = DECIM * m0 - LEAD;         // block index of window[0]
  // this row's parameters, state and outputs
  carry += (long long)row * HALO;
  lgain += row;
  rgain += row;
  rf_dc += row;
  lo_freq += row;
  n0_mod += row;
  y += (long long)row * M;
  new_carry += (long long)row * HALO;
  dc_part += (long long)row * ntiles;
  ticket += row;
  dc_mean += row;
  const int bidx = block_index[row];
  if (bidx < 0 || bidx >= nb) {               // no such wire block: NaN out
    const float nan = __int_as_float(0x7fc00000);
    for (int t = tid; t < TILE; t += THREADS)
      if (m0 + t < M) y[m0 + t] = make_float2(nan, nan);
    if (tile == ntiles - 1)
      for (int t = tid; t < HALO; t += THREADS)
        new_carry[t] = make_float2(nan, nan);
    if (dc_on && tile == 0 && tid == 0) *dc_mean = make_float2(nan, nan);
    return;                                   // no ticket is drawn
  }
  wire = static_cast<const char*>(wire) + bidx * block_bytes;
  // the wire block's misalignment to the 16-byte grid, in samples
  const int mis = (int)((reinterpret_cast<uintptr_t>(wire) & 15u)
                        / (16 / SPT));

  // ---- the raw window -> shared memory ---------------------------------
  // 16-byte cp.async copies, all in flight at once.  Vector k holds wire
  // elements [k*SPT, k*SPT + SPT) of the 16-byte aligned view, sample n =
  // element - mis; only chunks that hold samples of the block are copied.
  const int k_first = floor_div(base + mis, SPT);
  const int k_end = floor_div(base + mis + WSTAGE - 1, SPT) + 1;
  const uint4* vec = reinterpret_cast<const uint4*>(
      static_cast<const char*>(wire) - (long long)mis * (16 / SPT));
  for (int k = k_first + tid; k < k_end; k += THREADS) {
    if (k >= 0 && k * SPT - mis < T)
      __pipeline_memcpy_async(raw + (k - k_first), vec + k, 16);
  }
  __pipeline_commit();

  // polyphase taps: H[p][r] = hc[306 - 12r - p] (0 past the kernel)
  for (int i = tid; i < DECIM * NROW; i += THREADS) {
    const int p = i / NROW, r = i % NROW;
    const int k = HALO - DECIM * r - p;
    H[i] = k >= 0 ? taps[k] : 0.0f;
  }
  // (v * scale) * gain == v * (gain * scale) in f32: the scale is a power
  // of two, so both products round the same real number once
  const float lg = __fmul_rn(*lgain, wire_scale<FMT>());
  const float rg = __fmul_rn(*rgain, wire_scale<FMT>());
  float2 corr = make_float2(0.0f, 0.0f);
  if (dc_on) {
    const float2 d = *rf_dc;
    corr = make_float2(fminf(fmaxf(d.x, -RF_DC_LIMIT), RF_DC_LIMIT),
                       fminf(fmaxf(d.y, -RF_DC_LIMIT), RF_DC_LIMIT));
  }
  // exact NCO index of the thread's first position, then one 32-bit step of
  // (f * THREADS) mod q per position (q < 2^22, so every sum fits)
  const uint32_t fq = (uint32_t)(((*lo_freq % q) + q) % q);
  const int n0 = ((*n0_mod % q) + q) % q;
  uint32_t idx = mulmod(fq, (uint32_t)(((n0 + base + tid) % q + q) % q), q);
  const uint32_t step = mulmod(fq, (uint32_t)(THREADS % q), q);
  const uint32_t uq = (uint32_t)q;

  const int e_first = k_first * SPT - mis;    // sample of raw element 0
  __pipeline_wait_prior(0);
  __syncthreads();

  // ---- DC subsample: the tile's sum, and an atomic ticket ---------------
  // Warp 0 sums the tile's own x[::64] points (after the gains, before the
  // DC subtraction) from the raw window and publishes the sum with a
  // release-acquire ticket.  It reads the ticket only after the mix, so the
  // round trip hides behind it; the tile that drew the last ticket then
  // adds every tile's sum in a fixed order.
  unsigned my_ticket = 0;
  if (dc_on && warp == 0) {
    const int own_end = min(DECIM * (m0 + TILE), T);
    float2 s = make_float2(0.0f, 0.0f);
    for (int n = (DECIM * m0 + DC_STRIDE - 1) / DC_STRIDE * DC_STRIDE
                 + lane * DC_STRIDE;
         n < own_end; n += 32 * DC_STRIDE) {
      const float2 x = decode<FMT>(raw, n - e_first);
      s.x += __fmul_rn(x.x, lg);
      s.y += __fmul_rn(x.y, rg);
    }
    for (int off = 16; off > 0; off >>= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
    }
    if (lane == 0) {
      dc_part[tile] = s;
      cuda::atomic_ref<unsigned, cuda::thread_scope_device> t(*ticket);
      my_ticket = t.fetch_add(1u, cuda::memory_order_acq_rel);
    }
  }

  // ---- mix the window: decode, gains, DC correction, NCO -> S -----------
  // A thread's positions are w = tid + it * THREADS.  THREADS is a multiple
  // of 12 * J, so they keep their phase p and column c and step
  // THREADS / 12 / J columns of S each iteration.
  float2* Sw = S + (tid % DECIM) * PLANE + (tid / DECIM % J) * NU
               + tid / DECIM / J;
  auto mix = [&](int n) {                     // a wire sample, 0 <= n < T
    const float2 x = decode<FMT>(raw, n - e_first);
    const float gr = __fsub_rn(__fmul_rn(x.x, lg), corr.x);
    const float gi = __fsub_rn(__fmul_rn(x.y, rg), corr.y);
    const float ph = __fmul_rn(w_rad, (float)idx);
    float sn, cs;
    sincosf(ph, &sn, &cs);
    // x * e^{-j ph}
    return make_float2(__fadd_rn(__fmul_rn(gr, cs), __fmul_rn(gi, sn)),
                       __fsub_rn(__fmul_rn(gi, cs), __fmul_rn(gr, sn)));
  };
  // Interior tiles: every position of iterations 1 .. ITERS-2 is an own,
  // in-block sample before the carry range, so those need no tests.
  const bool interior = base >= 0 && base + WIN <= T - HALO;
  for (int it = 0; it < ITERS; ++it) {
    const int w = tid + it * THREADS;
    const int n = base + w;
    float2 v = make_float2(0.0f, 0.0f);
    if (interior && it > 0 && it < ITERS - 1) {
      v = mix(n);
    } else if (w >= WIN) {
      // past the window (or the staged range): read with zero taps only
    } else if (n < 0) {
      v = carry[HALO + n];                    // already mixed
    } else if (n < T) {
      v = mix(n);
      if (w >= LEAD && n >= T - HALO) new_carry[n - (T - HALO)] = v;
    }
    if (w < WSTAGE) Sw[it * (THREADS / DECIM / J)] = v;
    idx += step;
    idx = idx >= uq ? idx - uq : idx;
  }
  __syncthreads();

  // the last ticket: every tile's sum is visible (acquire), add them
  if (dc_on && warp == 0 &&
      __shfl_sync(0xffffffffu, my_ticket, 0) == (unsigned)ntiles - 1) {
    __threadfence();                          // lane 0 acquired for the warp
    float2 s = make_float2(0.0f, 0.0f);
    for (int i = lane; i < ntiles; i += 32) {
      const float2 v = __ldcg(dc_part + i);
      s.x += v.x;
      s.y += v.y;
    }
    for (int off = 16; off > 0; off >>= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
    }
    if (lane == 0) {
      const float n_sub = (float)((T + DC_STRIDE - 1) / DC_STRIDE);
      *dc_mean = make_float2(__fdiv_rn(s.x, n_sub), __fdiv_rn(s.y, n_sub));
      *ticket = 0u;                           // ready for the next launch
    }
  }

  // ---- polyphase FIR, J outputs x PPG phases per thread ----------------
  const int pg = warp / (GROUPS / 32);        // phase group of this warp
  const int g = (warp % (GROUPS / 32)) * 32 + lane;   // output group
  float ar[J], ai[J];
#pragma unroll
  for (int c = 0; c < J; ++c) ar[c] = ai[c] = 0.0f;
#pragma unroll 1
  for (int pp = 0; pp < PPG; ++pp) {
    const int p = pg * PPG + pp;
    float h[NROW];
#pragma unroll
    for (int r = 0; r < NROW; ++r) h[r] = H[p * NROW + r];
    const float2* Sp = S + p * PLANE + g;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float2 x = Sp[(i % J) * NU + i / J];
#pragma unroll
      for (int c = 0; c < J; ++c) {
        const int r = i - c;
        if (r >= 0 && r < NROW) {
          ar[c] = fmaf(h[r], x.x, ar[c]);
          ai[c] = fmaf(h[r], x.y, ai[c]);
        }
      }
    }
  }
  __syncthreads();                            // S is reused for the sums
  float2* R = S;                              // [PGROUPS][J][RS]
#pragma unroll
  for (int c = 0; c < J; ++c)
    R[(pg * J + c) * RS + g] = make_float2(ar[c], ai[c]);
  __syncthreads();
  for (int t = tid; t < TILE; t += THREADS) {
    const int c = t % J, gg = t / J;
    float2 s = R[c * RS + gg];
#pragma unroll
    for (int q2 = 1; q2 < PGROUPS; ++q2) {
      const float2 v = R[(q2 * J + c) * RS + gg];
      s.x += v.x;
      s.y += v.y;
    }
    if (m0 + t < M) y[m0 + t] = s;
  }
}

template <int FMT>
int launch(dim3 grid, cudaStream_t st, const void* wire, long long block_bytes,
           int nb, const int* block_index, int T, const float2* carry,
           const float* taps, const float* lgain, const float* rgain,
           const float2* rf_dc, const int* lo_freq, const int* n0_mod,
           int dc_on, int q, float w_rad, float2* y, float2* new_carry,
           float2* dc_part, unsigned* ticket, float2* dc_mean) {
  // > 48 KB of shared memory: set once per device (at the first launch,
  // which runs before any graph capture), so that a launch recorded into a
  // CUDA graph is the kernel launch alone
  constexpr int MAX_DEVICES = 64;
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    e = cudaFuncSetAttribute(frontend_kernel<FMT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<FMT>());
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  frontend_kernel<FMT><<<grid, THREADS, smem_bytes<FMT>(), st>>>(
      wire, block_bytes, nb, block_index, T, carry, taps, lgain, rgain, rf_dc,
      lo_freq, n0_mod, dc_on, q, w_rad, y, new_carry, dc_part, ticket,
      dc_mean);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// R rows in one launch.  Row r runs the front end on wire block
// block_index[r] (int32 on the device; a row whose index is outside
// [0, nb) gets NaN outputs) of a contiguous [nb, T] complex64 (fmt 0) or
// [nb, T, 2] int16 / uint8 / int8 (fmt 1, 2, 3) wire, whose base pointer is
// aligned to its sample size; each block may sit anywhere on the 16-byte
// grid.  Per row, all device arrays: lgain[R], rgain[R] f32, rf_dc[R]
// complex64, lo_freq[R], n0_mod[R] int32, carry[R, 306] complex64; out
// y[R, T/12], new_carry[R, 306] complex64.  With dc_on, dc_part has
// R * ceil(T / 12 / TILE) float2 slots, ticket R unsigned words that are 0
// between launches (zero them once; each row's last tile resets its own),
// and dc_mean[R] receives each row's complex64 mean of x[::64]; launches
// that share tickets must run in stream order.  The rows are the grid's x
// axis and the tiles its y axis (at most 65535 tiles).  Returns
// cudaGetLastError().
int sdr_frontend_rows(const void* wire, int fmt, long long T, int nb,
                      int rows, const void* block_index, const void* carry,
                      const void* taps, const void* lgain, const void* rgain,
                      const void* rf_dc, const void* lo_freq,
                      const void* n0_mod, int dc_on, int q, float w_rad,
                      void* y, void* new_carry, void* dc_part, void* ticket,
                      void* dc_mean, void* stream) {
  const dim3 grid((unsigned)rows, (unsigned)((T / DECIM + TILE - 1) / TILE));
  const long long block_bytes = T * (fmt == 0 ? 8 : fmt == 1 ? 4 : 2);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define SDR_FE_ARGS                                                         \
  grid, st, wire, block_bytes, nb, (const int*)block_index, (int)T,         \
      (const float2*)carry, (const float*)taps, (const float*)lgain,        \
      (const float*)rgain, (const float2*)rf_dc, (const int*)lo_freq,       \
      (const int*)n0_mod, dc_on, q, w_rad, (float2*)y, (float2*)new_carry,  \
      (float2*)dc_part, (unsigned*)ticket, (float2*)dc_mean
  switch (fmt) {
    case 0: return launch<0>(SDR_FE_ARGS);
    case 1: return launch<1>(SDR_FE_ARGS);
    case 2: return launch<2>(SDR_FE_ARGS);
    case 3: return launch<3>(SDR_FE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_FE_ARGS
}

int sdr_frontend_tile() { return TILE; }

}  // extern "C"
