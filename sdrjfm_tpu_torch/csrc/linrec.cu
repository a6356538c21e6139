// First-order linear-recurrence scans for Hopper (sm_90a).
//
// Part 1, sdr_linrec: real decays,
//   y[r, n] = g[r] * y[r, n-1] + d[r, n],  y[r, -1] = y0[r],
// row by row, in one pass over the input.
//
// The JAX package gets this from lax.associative_scan with the combine
// _first_order_combine (sdrjfm_tpu/ops/blockops.py:277-294); it has no
// Pallas counterpart.  On the main path it runs the AM-carrier and AFC
// trackers (two rows of 131072) and the pilot lock metric (one row).
//
// What bounds it on an H100: 3 rows x 131072 samples read and written per
// block, ~3 MB, under 1 us at 3.35 TB/s; 2 flops a sample.  The work is
// tiny, so a launch is bound by latency: how many SMs share a row, and how
// long the carry takes to cross the row.  One program per row walking its
// chunks in sequence keeps at most 3 of 132 SMs busy.  This design is a
// single-pass decoupled look-back scan:
//   * grid (chunks, rows), CHUNK = 2048 samples: a 131072-sample row
//     spreads over 64 thread blocks;
//   * inside a chunk each of 256 threads scans 8 consecutive samples in
//     sequence (zero carry-in); warps join the threads' partial results with
//     a shuffle scan and the block joins its 8 warps, every join weighted
//     by an exact decay power g^n = exp2(n * log2 g) (log2 g from the host
//     in float64), which keeps it within ~1e-6 of the scale of a float64
//     recurrence (decay products formed by a scan tree lose more);
//   * between chunks: each chunk publishes its aggregate (zero carry-in
//     value at its end), then its inclusive prefix, each packed with a
//     state and the call's epoch into one 64-bit word, stored and loaded
//     as a whole (no separate flag to order).  A chunk's first warp reads
//     32 predecessors at a time until it finds an inclusive prefix, and sums
//     the aggregates in between with their decay powers.  Words of earlier
//     calls carry another epoch and read as "not ready", so no launch has to
//     clear them.  A chunk waits only on chunks of lower linear block index,
//     which the hardware dispatches first (the premise of CUB's scans).
// Rounding of the look-back sum depends on which predecessors had
// published their prefix, so results may differ in the last bits between
// runs.  Measured: PERF.md (chip_smoke.py phase `times`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 8;                        // consecutive samples a thread
constexpr int CHUNK = THREADS * PER;          // 2048 samples a thread block
constexpr int WARPS = THREADS / 32;
constexpr unsigned AGG = 1u, PFX = 2u;        // published states
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ void publish(unsigned long long* slot,
                                        unsigned epoch, unsigned state,
                                        float v) {
  const unsigned long long w =
      ((unsigned long long)((epoch << 2) | state) << 32) | __float_as_uint(v);
  *reinterpret_cast<volatile unsigned long long*>(slot) = w;
}

__global__ void __launch_bounds__(THREADS)
linrec_kernel(const float* __restrict__ d, const float* __restrict__ g,
              const float* __restrict__ l2g, const float* __restrict__ y0,
              float* __restrict__ y, float* __restrict__ last, int T,
              unsigned long long* __restrict__ status, unsigned epoch) {
  __shared__ float buf[CHUNK + CHUNK / 32];
  __shared__ float wagg[WARPS], wexc[WARPS];
  __shared__ float s_carry;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, row = blockIdx.y, nchunks = gridDim.x;
  const long long rbase = (long long)row * T;
  const int c0 = chunk * CHUNK;
  const int len = min(CHUNK, T - c0);
  const float gr = g[row], lg = l2g[row];

  // coalesced load into shared memory, padded so that thread t's 8
  // consecutive samples sit in 8 distinct banks
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS;
    buf[pad(i)] = i < len ? d[rbase + c0 + i] : 0.0f;
  }
  __syncthreads();

  // each thread: its 8 samples in sequence, zero carry-in
  float v[PER];
  float a = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    a = fmaf(gr, a, buf[pad(tid * PER + i)]);
    v[i] = a;
  }
  // warp: inclusive scan of the threads' ends, segments joined by g^(8*o)
  float W = a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(FULL, W, o);
    if (lane >= o) W = fmaf(exp2f((float)(PER * o) * lg), up, W);
  }
  float xl = __shfl_up_sync(FULL, W, 1);      // zero-carry value before lane
  if (lane == 0) xl = 0.0f;
  if (lane == 31) wagg[warp] = W;
  __syncthreads();

  if (warp == 0) {
    // block: scan of the 8 warp ends, joined by g^(256*o)
    float A = lane < WARPS ? wagg[lane] : 0.0f;
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const float up = __shfl_up_sync(FULL, A, o);
      if (lane >= o) A = fmaf(exp2f((float)(32 * PER * o) * lg), up, A);
    }
    float ex = __shfl_up_sync(FULL, A, 1);
    if (lane == 0) ex = 0.0f;
    if (lane < WARPS) wexc[lane] = ex;
    const float agg = __shfl_sync(FULL, A, WARPS - 1);   // chunk, zero carry-in
    const float gL = exp2f((float)CHUNK * lg);
    unsigned long long* st = status + (long long)row * nchunks;

    float E;                                  // y just before the chunk
    if (chunk == 0) {
      E = y0[row];
    } else {
      if (lane == 0) publish(st + chunk, epoch, AGG, agg);
      E = 0.0f;
      int first = chunk - 1;                  // predecessor read by lane 0
      for (int win = 0;; ++win) {
        const int pred = first - lane;
        unsigned state;
        float val = 0.0f;
        do {
          state = PFX;                        // before chunk 0: never read
          if (pred >= 0) {
            const unsigned long long w =
                *reinterpret_cast<volatile unsigned long long*>(st + pred);
            const unsigned hi = (unsigned)(w >> 32);
            state = (hi >> 2) == epoch ? (hi & 3u) : 0u;
            val = __uint_as_float((unsigned)w);
          }
        } while (__any_sync(FULL, state == 0u));
        const unsigned pmask = __ballot_sync(FULL, state == PFX);
        const int kp = pmask ? __ffs(pmask) - 1 : 31;   // nearest prefix
        float c = lane <= kp
            ? exp2f((float)lane * (float)CHUNK * lg) * val : 0.0f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
        E = fmaf(exp2f((float)(32 * win) * (float)CHUNK * lg), c, E);
        if (pmask) break;
        first -= 32;
      }
    }
    if (lane == 0) {
      publish(st + chunk, epoch, PFX, fmaf(gL, E, agg));
      s_carry = E;
    }
  }
  __syncthreads();

  // y = zero-carry value + decayed true carry, thread by thread
  const float Xt = fmaf(exp2f((float)(PER * lane) * lg), wexc[warp], xl);
  const float Ct = fmaf(exp2f((float)(PER * tid) * lg), s_carry, Xt);
#pragma unroll
  for (int i = 0; i < PER; ++i)
    buf[pad(tid * PER + i)] = fmaf(exp2f((float)(i + 1) * lg), Ct, v[i]);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS;
    if (i < len) {
      const float out = buf[pad(i)];
      y[rbase + c0 + i] = out;
      if (c0 + i == T - 1) last[row] = out;
    }
  }
}

}  // namespace

extern "C" {

// d, y: [R, T] float32; g, l2g (log2 g), y0, last: [R] float32; all device
// pointers.  status has R * sdr_linrec_chunks(T) 64-bit words, zeroed once;
// epoch is in [1, 2^30) and differs from the previous launch's that used
// the same status words (such launches must run in stream order).
// Returns cudaGetLastError().
int sdr_linrec(const void* d, const void* g, const void* l2g, const void* y0,
               void* y, void* last, int R, int T, void* status,
               unsigned epoch, void* stream) {
  if (R < 1 || R > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((T + CHUNK - 1) / CHUNK), (unsigned)R);
  linrec_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)d, (const float*)g, (const float*)l2g, (const float*)y0,
      (float*)y, (float*)last, T, (unsigned long long*)status, epoch);
  return (int)cudaGetLastError();
}

int sdr_linrec_chunk() { return CHUNK; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Part 2, sdr_pole_bank (kernel A): banks of complex one-pole recurrences
// over a shared real drive, summed with their residues,
//   w[b, p, n] = g[b, p] * w[b, p, n-1] + d[b, n],   w[b, p, -1] = w0[b, p]
//   y[b, n]    = Re sum_p r[b, p] * w[b, p, n]
// -- a biquad cascade factored into poles (IIRSpec).  It replaces the JAX
// package's jax.vmap(linrec_apply) over the poles in iir_apply
// (sdrjfm_tpu/ops/blockops.py:378-382), an associative scan with no Pallas
// counterpart.  On the squelch path: two banks (high- and low-pass) of 10
// poles over 131072 samples a block.
//
// What bounds it on an H100: it reads B*T floats and writes B*T floats
// (2 MB a block for the squelch, under 1 us at 3.35 TB/s) and does 8 flops
// per pole and sample twice over (0.04 GFLOP, under 1 us at 67 TFLOP/s):
// latency-bound, like the real scan.  Design, reduce-then-scan in two
// launches over chunks of 4096 samples (grid chunks x banks, 256 threads,
// 16 consecutive samples a thread):
//   * pole_agg_kernel: each chunk's zero-carry-in end state per pole (a
//     thread runs its 16 samples in sequence, a shuffle tree and the block
//     join the segments);
//   * pole_scan_kernel: each chunk takes its carry-in from w0 and its
//     predecessors' aggregates in sequence (at most T/4096 complex FMAs a
//     pole), then a shuffle scan gives each thread its carry-in, and the
//     thread reruns its 16 samples from it, summing Re(r w) over the poles
//     in registers: the [P, T] pole states never reach device memory.
// Every join of segments multiplies by a power g^(16 * 2^k) computed in
// float64 on the host and rounded once (a power formed as exp(n log g) in
// f32 would lose ~n * 1e-7 rad of phase), so each join costs at most a few
// f32 roundings; inside a segment the recurrence runs exactly as written.
// Deterministic: no atomics, no look-back.  Measured: PERF.md (chip_smoke.py
// phases kernels and times).
// ---------------------------------------------------------------------------

namespace poles {

constexpr int THREADS = 256;
constexpr int SEG = 16;                       // consecutive samples a thread
constexpr int CHUNK = THREADS * SEG;          // 4096 samples a thread block
constexpr int WARPS = THREADS / 32;
constexpr int NPOW = 9;                       // g^(SEG * 2^k), k < NPOW
constexpr int MAXP = 16;                      // poles a bank, at most

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * b + c
__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 c) {
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, c.x)),
                     fmaf(a.x, b.y, fmaf(a.y, b.x, c.y)));
}
// g * w + x for a real drive sample x
__device__ __forceinline__ float2 step(float2 g, float2 w, float x) {
  return make_float2(fmaf(g.x, w.x, fmaf(-g.y, w.y, x)),
                     fmaf(g.x, w.y, g.y * w.x));
}
__device__ __forceinline__ float2 shfl_up2(float2 v, int o) {
  return make_float2(__shfl_up_sync(FULL, v.x, o),
                     __shfl_up_sync(FULL, v.y, o));
}
__device__ __forceinline__ float2 shfl_down2(float2 v, int o) {
  return make_float2(__shfl_down_sync(FULL, v.x, o),
                     __shfl_down_sync(FULL, v.y, o));
}
// g^(SEG * n) for 0 <= n < 2^NPOW, a product of the binary powers
__device__ __forceinline__ float2 seg_pow(const float2* pw, int n) {
  float2 r = make_float2(1.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < NPOW; ++k)
    if ((n >> k) & 1) r = cmul(r, pw[k]);
  return r;
}

__device__ __forceinline__ void load_seg(const float* __restrict__ d,
                                         long long rbase, int base, int T,
                                         float (&x)[SEG]) {
#pragma unroll
  for (int i = 0; i < SEG; ++i)
    x[i] = base + i < T ? d[rbase + base + i] : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
pole_agg_kernel(const float* __restrict__ d, const float2* __restrict__ g,
                const float2* __restrict__ pw, float2* __restrict__ agg,
                int P, int T) {
  __shared__ float2 s_pw[MAXP][NPOW];
  __shared__ float2 s_w[MAXP][WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x;
  for (int i = tid; i < P * NPOW; i += THREADS)
    s_pw[i / NPOW][i % NPOW] = pw[(long long)b * P * NPOW + i];
  float x[SEG];
  load_seg(d, (long long)b * T, chunk * CHUNK + tid * SEG, T, x);
  __syncthreads();
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    if (p >= P) break;
    const float2 gp = g[b * P + p];
    float2 a = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < SEG; ++i) a = step(gp, a, x[i]);
    // shuffle tree: the left segment decays across the right one
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int o = 1 << k;
      const float2 right = shfl_down2(a, o);
      if ((lane & (2 * o - 1)) == 0) a = cfma(s_pw[p][k], a, right);
    }
    if (lane == 0) s_w[p][warp] = a;
  }
  __syncthreads();
  if (tid < P) {
    float2 A = s_w[tid][0];
    for (int w = 1; w < WARPS; ++w) A = cfma(s_pw[tid][5], A, s_w[tid][w]);
    agg[((long long)b * nchunks + chunk) * P + tid] = A;
  }
}

__global__ void __launch_bounds__(THREADS)
pole_scan_kernel(const float* __restrict__ d, const float2* __restrict__ g,
                 const float2* __restrict__ r, const float2* __restrict__ pw,
                 const float2* __restrict__ w0,
                 const float2* __restrict__ agg, float* __restrict__ y,
                 float2* __restrict__ wT, int P, int T) {
  __shared__ float2 s_pw[MAXP][NPOW];
  __shared__ float2 s_w[MAXP][WARPS];
  __shared__ float2 s_E[MAXP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x;
  for (int i = tid; i < P * NPOW; i += THREADS)
    s_pw[i / NPOW][i % NPOW] = pw[(long long)b * P * NPOW + i];
  const int base = chunk * CHUNK + tid * SEG;
  float x[SEG];
  load_seg(d, (long long)b * T, base, T, x);
  __syncthreads();
  if (tid < P) {
    // the state just before this chunk: w0, then each predecessor chunk
    const float2 gC = s_pw[tid][NPOW - 1];    // g^CHUNK
    float2 E = w0[b * P + tid];
    for (int k = 0; k < chunk; ++k)
      E = cfma(gC, E, agg[((long long)b * nchunks + k) * P + tid]);
    s_E[tid] = E;
  }
  float2 C[MAXP], X[MAXP];
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    if (p >= P) break;
    const float2 gp = g[b * P + p];
    float2 a = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < SEG; ++i) a = step(gp, a, x[i]);
    // warp inclusive scan of the segments' zero-carry ends
    float2 W = a;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int o = 1 << k;
      const float2 up = shfl_up2(W, o);
      if (lane >= o) W = cfma(s_pw[p][k], up, W);
    }
    float2 xl = shfl_up2(W, 1);
    if (lane == 0) xl = make_float2(0.0f, 0.0f);
    X[p] = xl;
    if (lane == 31) s_w[p][warp] = W;
  }
  __syncthreads();
  if (tid < P) {
    // exclusive prefix over the warps, zero carry into the chunk
    float2 acc = make_float2(0.0f, 0.0f);
    for (int w = 0; w < WARPS; ++w) {
      const float2 wt = s_w[tid][w];
      s_w[tid][w] = acc;
      acc = cfma(s_pw[tid][5], acc, wt);
    }
  }
  __syncthreads();
  float yv[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) yv[i] = 0.0f;
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    if (p >= P) break;
    // carry into this thread's segment
    C[p] = cfma(seg_pow(s_pw[p], lane), s_w[p][warp], X[p]);
    C[p] = cfma(seg_pow(s_pw[p], tid), s_E[p], C[p]);
    const float2 gp = g[b * P + p], rp = r[b * P + p];
    float2 w = C[p];
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      w = step(gp, w, x[i]);
      yv[i] = fmaf(rp.x, w.x, fmaf(-rp.y, w.y, yv[i]));
      if (base + i == T - 1) wT[b * P + p] = w;
    }
  }
  const long long rbase = (long long)b * T;
#pragma unroll
  for (int i = 0; i < SEG; ++i)
    if (base + i < T) y[rbase + base + i] = yv[i];
}

}  // namespace poles

extern "C" {

// d, y: [B, T] float32; g (poles), r (residues), w0, wT: [B, P] complex64
// (float2); pw: [B, P, NPOW] complex64 with pw[b, p, k] = g^(16 * 2^k)
// from float64; agg: B * ceil(T/4096) * P complex64 of scratch.  All device
// pointers; two launches on `stream`.  Returns cudaGetLastError().
int sdr_pole_bank(const void* d, const void* g, const void* r, const void* pw,
                  const void* w0, void* y, void* wT, void* agg, int B, int P,
                  int T, void* stream) {
  if (B < 1 || B > 65535 || P < 1 || P > poles::MAXP || T < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((T + poles::CHUNK - 1) / poles::CHUNK),
                  (unsigned)B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  poles::pole_agg_kernel<<<grid, poles::THREADS, 0, s>>>(
      (const float*)d, (const float2*)g, (const float2*)pw, (float2*)agg, P,
      T);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  poles::pole_scan_kernel<<<grid, poles::THREADS, 0, s>>>(
      (const float*)d, (const float2*)g, (const float2*)r, (const float2*)pw,
      (const float2*)w0, (const float2*)agg, (float*)y, (float2*)wT, P, T);
  return (int)cudaGetLastError();
}

int sdr_pole_chunk() { return poles::CHUNK; }
int sdr_pole_maxp() { return poles::MAXP; }

}  // extern "C"
