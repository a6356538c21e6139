// First-order linear-recurrence scan for Hopper (sm_90a):
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
