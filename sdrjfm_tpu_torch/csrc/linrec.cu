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
//     value at its end), packed with a ready state into one 64-bit word,
//     stored and loaded as a whole (no separate flag to order).  A chunk's
//     first warp reads its predecessors' aggregates 32 at a time, nearest
//     first, and sums them with their decay powers in a fixed order (a
//     xor tree in a window, the windows in turn), then adds y0 decayed to
//     the chunk: the carry is the same sum whatever the timing, so a
//     launch is deterministic.  (A look-back that stops at the nearest
//     published inclusive prefix rounds by which prefixes were ready: a
//     station's audio then moved by up to 8e-6 from run to run, PERF.md
//     PR 11.)  The aggregates need no chain, so they are ready together; a
//     chunk reads ceil(chunk / 32) windows, 2 for a 131072-sample row.
//     The launch's words are zeroed ("not ready") by a memset queued just
//     before the kernel on the same stream, so no value that changes from
//     call to call is a launch argument and a captured CUDA graph replays
//     correctly.  A chunk waits only on chunks of lower linear block index,
//     which the hardware dispatches first (the premise of CUB's scans).
// Measured: PERF.md (chip_smoke.py phase `times`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 8;                        // consecutive samples a thread
constexpr int CHUNK = THREADS * PER;          // 2048 samples a thread block
constexpr int WARPS = THREADS / 32;
constexpr unsigned AGG = 1u, PFX = 2u;        // published states (the real
                                              // scan publishes AGG only)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ void publish(unsigned long long* slot,
                                        unsigned state, float v) {
  const unsigned long long w =
      ((unsigned long long)state << 32) | __float_as_uint(v);
  *reinterpret_cast<volatile unsigned long long*>(slot) = w;
}

__global__ void __launch_bounds__(THREADS)
linrec_kernel(const float* __restrict__ d, const float* __restrict__ g,
              const float* __restrict__ l2g, const float* __restrict__ y0,
              float* __restrict__ y, float* __restrict__ last, int T,
              unsigned long long* __restrict__ status) {
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
    unsigned long long* st = status + (long long)row * nchunks;

    // y just before the chunk: sum over k < chunk of
    // g^(CHUNK (chunk-1-k)) agg_k, plus g^(CHUNK chunk) y0
    if (lane == 0) publish(st + chunk, AGG, agg);
    float E = 0.0f;
    for (int first = chunk - 1, win = 0; first >= 0; first -= 32, ++win) {
      const int pred = first - lane;          // lane 0: the nearest
      unsigned state;
      float val = 0.0f;
      do {
        state = AGG;                          // before chunk 0: never read
        if (pred >= 0) {
          const unsigned long long w =
              *reinterpret_cast<volatile unsigned long long*>(st + pred);
          state = (unsigned)(w >> 32) & 3u;
          val = __uint_as_float((unsigned)w);
        }
      } while (__any_sync(FULL, state == 0u));
      float c = exp2f((float)lane * (float)CHUNK * lg) * val;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
      E = fmaf(exp2f((float)(32 * win) * (float)CHUNK * lg), c, E);
    }
    E = fmaf(exp2f((float)chunk * (float)CHUNK * lg), y0[row], E);
    if (lane == 0) s_carry = E;
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
// pointers.  status: R * ceil(T / sdr_linrec_chunk()) 64-bit words of
// scratch that no other launch uses until this one has run (allocate them
// per call); they are zeroed here, by a memset on `stream` before the
// kernel.  Every argument is the same on each replay of a captured graph.
// Returns the first CUDA error.
int sdr_linrec(const void* d, const void* g, const void* l2g, const void* y0,
               void* y, void* last, int R, int T, void* status,
               void* stream) {
  if (R < 1 || R > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  const unsigned nch = (unsigned)((T + CHUNK - 1) / CHUNK);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(
      status, 0, (size_t)R * nch * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return (int)e;
  linrec_kernel<<<dim3(nch, (unsigned)R), THREADS, 0, st>>>(
      (const float*)d, (const float*)g, (const float*)l2g, (const float*)y0,
      (float*)y, (float*)last, T, (unsigned long long*)status);
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
// (2 MB a block for the squelch, under 1 us at 3.35 TB/s) and does 11
// flops per pole and sample (0.03 GFLOP, under 1 us at 67 TFLOP/s):
// latency-bound, like the real scan.  Design, one launch and a single
// pass, as the real scan above:
//   * grid: one block a chunk of CHUNK = 2048 samples of one bank (128
//     blocks for the squelch's 2 x 131072), 256 threads of SEG = 8
//     consecutive samples (on the card, 2048-sample chunks beat 1024: the
//     look-back spans fewer chunks); blocks take their chunk from a ticket
//     counter in the order they start, so a chunk waits only on chunks
//     already running.  The flags and the ticket are zeroed by a memset
//     queued before each launch, so that every launch argument is the same
//     from call to call (a captured CUDA graph replays correctly);
//   * the chunk is staged in shared memory by coalesced loads (padded, so
//     that a thread's 8 samples sit in 8 banks) and each sample is read
//     once: per pole, the thread runs the zero-carry recurrence over its
//     segment and accumulates y_loc[i] = Re sum_p r_p w_loc_p[i] in
//     registers; a warp scan and the block's walk over its 4 warps join the
//     segments' ends; the table is staged with every load in flight;
//   * the chunk's carry-in, P complex values, comes from a decoupled
//     look-back: each chunk publishes its aggregate (the zero-carry state at
//     its end), then its inclusive prefix, into payload arrays, and only
//     then release-stores the flag word (its state), so
//     a reader that acquire-loads a ready flag finds the payload.  Warp 0
//     reads LOOK = 64 predecessors' flags at a time (two a lane: one step
//     covers a 131072-sample row) until one holds a prefix, and sums the
//     payloads in between with their powers (a warp reduction a pole);
//   * no rerun: y[i] = y_loc[i] + Re sum_p (r_p g_p^(i+1)) C_p, with C_p the
//     state just before the thread's segment, and the state at T-1 is
//     w_loc + g^(i+1) C.
// Every power (the warp scan's g^(SEG 2^k), g^(SEG lane), g^(SEG 32),
// g^(CHUNK m), the correction's r g^(i+1) and g^(i+1)) is computed in
// float64 on the host and rounded once (kernels/linrec.py pole_table): a
// power formed in f32 would lose ~n * 1e-7 rad of phase.  Rounding of the
// look-back sum depends on which predecessors had published their prefix,
// so results may differ in the last bits between runs.  Measured: PERF.md
// (chip_smoke.py phases kernels and times).
// ---------------------------------------------------------------------------

namespace poles {

constexpr int THREADS = 256;
constexpr int SEG = 8;                        // consecutive samples a thread
constexpr int CHUNK = THREADS * SEG;          // 1024 samples a thread block
constexpr int WARPS = THREADS / 32;
constexpr int MAXP = 16;                      // poles a bank, at most
constexpr int LPL = 2;                        // predecessors a lane reads
constexpr int LOOK = 32 * LPL;                // predecessors a look-back step
// the per-pole table (complex64 each; kernels/linrec.py pole_table)
constexpr int T_G = 0;                        // g
constexpr int T_R = 1;                        // r
constexpr int T_RG = 2;                       // r g^(i+1), i < SEG
constexpr int T_GI = T_RG + SEG;              // g^(i+1), i < SEG
constexpr int T_GS = T_GI + SEG;              // g^(SEG 2^k), k < 5
constexpr int T_GL = T_GS + 5;                // g^(SEG l), l < 32
constexpr int T_GW = T_GL + 32;               // g^(SEG 32), a warp's span
constexpr int T_GC = T_GW + 1;                // g^(CHUNK m), m <= LOOK
constexpr int NTAB = T_GC + LOOK + 1;

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
__device__ __forceinline__ float2 shfl_xor2(float2 v, int o) {
  return make_float2(__shfl_xor_sync(FULL, v.x, o),
                     __shfl_xor_sync(FULL, v.y, o));
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// flags [B * nch] (the state, 0 until published), agg / pfx [B * nch * P]
// complex64: each chunk's aggregate and inclusive prefix; ticket: one
// counter, 0 at the launch, whose tickets are 0 .. B * nch - 1.
__global__ void __launch_bounds__(THREADS)
pole_bank_kernel(const float* __restrict__ d, const float2* __restrict__ tab,
                 const float2* __restrict__ w0, float* __restrict__ y,
                 float2* __restrict__ wT, int P, int T, int nch,
                 unsigned* __restrict__ flags, float2* __restrict__ agg,
                 float2* __restrict__ pfx, unsigned* __restrict__ ticket) {
  __shared__ float buf[CHUNK + CHUNK / 32];
  __shared__ float2 s_tab[MAXP][NTAB];
  __shared__ float2 s_w[MAXP][WARPS];   // warp ends, then the state before
                                        // each warp
  __shared__ float2 s_wloc[MAXP];
  __shared__ unsigned s_ticket;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const int b = (int)(s_ticket / (unsigned)nch);
  const int c = (int)(s_ticket % (unsigned)nch);
  const long long rbase = (long long)b * T;
  const long long slot = (long long)b * nch + c;
  const int c0 = c * CHUNK;
  const int len = min(CHUNK, T - c0);
  {
    // every load in flight before the first store
    constexpr int ITERS = (MAXP * NTAB + THREADS - 1) / THREADS;
    const float2* tb = tab + (long long)b * P * NTAB;
    float2 t[ITERS];
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = tid + k * THREADS;
      if (i < P * NTAB) t[k] = tb[i];
    }
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = tid + k * THREADS;
      if (i < P * NTAB) s_tab[i / NTAB][i % NTAB] = t[k];
    }
  }
#pragma unroll
  for (int k = 0; k < SEG; ++k) {
    const int i = tid + k * THREADS;
    buf[pad(i)] = i < len ? d[rbase + c0 + i] : 0.0f;
  }
  __syncthreads();
  float x[SEG], yl[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) {
    x[i] = buf[pad(tid * SEG + i)];
    yl[i] = 0.0f;
  }
  const int first_n = c0 + tid * SEG;           // this thread's first sample
  float2 X[MAXP];                               // zero-carry state before
                                                // the segment, in the warp
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    if (p >= P) break;                          // P is uniform
    const float2 g = s_tab[p][T_G], r = s_tab[p][T_R];
    float2 a = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      a = step(g, a, x[i]);
      yl[i] = fmaf(r.x, a.x, fmaf(-r.y, a.y, yl[i]));
      if (first_n + i == T - 1) s_wloc[p] = a;
    }
    float2 W = a;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int o = 1 << k;
      const float2 up = shfl_up2(W, o);
      if (lane >= o) W = cfma(s_tab[p][T_GS + k], up, W);
    }
    X[p] = shfl_up2(W, 1);
    if (lane == 0) X[p] = make_float2(0.0f, 0.0f);
    if (lane == 31) s_w[p][warp] = W;
  }
  __syncthreads();

  if (warp == 0) {
    float2 E = make_float2(0.0f, 0.0f);         // the state before the chunk
    if (c == 0) {
      if (lane < P) E = w0[b * P + lane];
    } else {
      if (lane < P) {
        float2 A = make_float2(0.0f, 0.0f);     // the chunk, zero carry-in
        for (int w = 0; w < WARPS; ++w)
          A = cfma(s_tab[lane][T_GW], A, s_w[lane][w]);
        agg[slot * P + lane] = A;
        __threadfence();
      }
      __syncwarp();
      if (lane == 0) st_release(flags + slot, AGG);
      // lane p < P ends with pole p's sum; the window's power in `mult`
      float2 mult = make_float2(1.0f, 0.0f);
      for (int first = c - 1;; first -= LOOK) {
        // lane j reads the chunks first - m, m = j + 32 k for k < LPL (m
        // chunks before chunk first; their ends decay by g^(CHUNK m))
        unsigned st[LPL];
        bool wait;
        do {
          wait = false;
#pragma unroll
          for (int k = 0; k < LPL; ++k) {
            const int pred = first - lane - 32 * k;
            st[k] = PFX;                        // before chunk 0: never read
            if (pred >= 0) {
              const unsigned f = ld_acquire(flags + (slot - c + pred));
              st[k] = f & 3u;
            }
            wait |= st[k] == 0u;
          }
        } while (__any_sync(FULL, wait));
        int kp = LOOK;                          // m of the nearest prefix
#pragma unroll
        for (int k = LPL - 1; k >= 0; --k) {
          const unsigned pm = __ballot_sync(FULL, st[k] == PFX);
          if (pm) kp = 32 * k + __ffs(pm) - 1;
        }
        float2 acc[MAXP];
#pragma unroll
        for (int p = 0; p < MAXP; ++p) acc[p] = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int k = 0; k < LPL; ++k) {
          const int m = lane + 32 * k, pred = first - m;
          const bool use = m <= kp && pred >= 0;
          const float2* src =
              (st[k] == PFX ? pfx : agg) + (slot - c + max(pred, 0)) * P;
          // all P loads in flight at once, then the weighted sums
          float2 v[MAXP];
#pragma unroll
          for (int p = 0; p < MAXP; ++p)
            v[p] = (use && p < P) ? __ldcg(src + p) : make_float2(0.0f, 0.0f);
#pragma unroll
          for (int p = 0; p < MAXP; ++p)
            if (p < P) acc[p] = cfma(s_tab[p][T_GC + m], v[p], acc[p]);
        }
#pragma unroll
        for (int p = 0; p < MAXP; ++p) {
          if (p < P) {
            float2 t = acc[p];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              const float2 u = shfl_xor2(t, o);
              t.x += u.x;
              t.y += u.y;
            }
            if (p == lane) E = cfma(mult, t, E);
          }
        }
        if (kp < LOOK) break;
        if (lane < P) mult = cmul(mult, s_tab[lane][T_GC + LOOK]);
      }
    }
    if (lane < P) {
      // the state before each warp, then after the chunk: its prefix
      float2 acc = E;
      for (int w = 0; w < WARPS; ++w) {
        const float2 wt = s_w[lane][w];
        s_w[lane][w] = acc;
        acc = cfma(s_tab[lane][T_GW], acc, wt);
      }
      pfx[slot * P + lane] = acc;
      __threadfence();
    }
    __syncwarp();
    if (lane == 0) st_release(flags + slot, PFX);
  }
  __syncthreads();

  // the carry's part: C = the state just before this thread's segment
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    if (p >= P) break;
    const float2 C = cfma(s_tab[p][T_GL + lane], s_w[p][warp], X[p]);
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      const float2 rg = s_tab[p][T_RG + i];
      yl[i] = fmaf(rg.x, C.x, fmaf(-rg.y, C.y, yl[i]));
    }
    const int il = T - 1 - first_n;
    if (il >= 0 && il < SEG)
      wT[b * P + p] = cfma(s_tab[p][T_GI + il], C, s_wloc[p]);
  }
#pragma unroll
  for (int i = 0; i < SEG; ++i) buf[pad(tid * SEG + i)] = yl[i];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SEG; ++k) {
    const int i = tid + k * THREADS;
    if (i < len) y[rbase + c0 + i] = buf[pad(i)];
  }
}

}  // namespace poles

extern "C" {

// d, y: [B, T] float32; tab: [B, P, sdr_pole_ntab()] complex64 (float2),
// the per-pole table; w0, wT: [B, P] complex64.  The look-back scratch,
// which no other launch uses until this one has run (allocate it per
// call): flags, B * nch + 1 32-bit words, the last of them the ticket
// counter, zeroed here by a memset on `stream` before the kernel; agg, pfx:
// B * nch * P complex64 each.  nch = ceil(T / sdr_pole_chunk()).  All
// device pointers; one memset and one launch on `stream`, with the same
// arguments on each replay of a captured graph.  Returns the first CUDA
// error.
int sdr_pole_bank(const void* d, const void* tab, const void* w0, void* y,
                  void* wT, int B, int P, int T, void* flags, void* agg,
                  void* pfx, void* stream) {
  if (B < 1 || P < 1 || P > poles::MAXP || T < 1
      || T > 0x7fffffff - poles::CHUNK)
    return (int)cudaErrorInvalidValue;
  const long long nch = (T + poles::CHUNK - 1) / poles::CHUNK;
  if (nch * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  unsigned* fl = (unsigned*)flags;
  const cudaError_t e =
      cudaMemsetAsync(fl, 0, (size_t)(nch * B + 1) * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  poles::pole_bank_kernel<<<(unsigned)(nch * B), poles::THREADS, 0, st>>>(
      (const float*)d, (const float2*)tab, (const float2*)w0, (float*)y,
      (float2*)wT, P, T, (int)nch, fl, (float2*)agg, (float2*)pfx,
      fl + nch * B);
  return (int)cudaGetLastError();
}

int sdr_pole_chunk() { return poles::CHUNK; }
int sdr_pole_seg() { return poles::SEG; }
int sdr_pole_maxp() { return poles::MAXP; }
int sdr_pole_look() { return poles::LOOK; }
int sdr_pole_ntab() { return poles::NTAB; }

}  // extern "C"
