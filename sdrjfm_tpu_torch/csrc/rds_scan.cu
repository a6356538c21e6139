// Per-sample RDS bit decoders 1, 2 and 3 for Hopper (sm_90a).
//
// They replace the JAX package's lax.scan decoders (no Pallas counterpart):
//   decoder 1  <- sdrjfm_tpu/rds/scan_decoders.py:108 decoder1_block
//   decoder 2  <- sdrjfm_tpu/rds/scan_decoders.py:191 decoder2_block
//   decoder 3  <- sdrjfm_tpu/rds/scan_decoders.py:313 decoder3_block
// Each runs one block of the 24 kS/s RDS baseband (16384 samples at
// block_fm=131072) through the decoder's feedback loops in sample order,
// reads its state from `st_in` and writes the new state to `st_out` (out of
// place), writes each emitted bit and its constellation point compacted at
// the running emit count (count may exceed cap; points past it are dropped,
// and bits/iq from count to cap are zeroed), and, when `iqs` is not null,
// the per-sample 24 kHz iq stream (the RDS_DEMOD scope tap).
//
// Each decoder runs in stages, one launch each on the caller's stream; the
// wrapper (rds/scan_decoders.py) launches them in order, owns the scratch
// between them and places every history and state run in the packed state:
//   decoder 1: costas_kernel      one thread: the Costas loop; writes 4r
//              fir_kernel x 3     parallel, one output a thread: the 21-tap
//                                 lowpass of Re(4r), the bi-phase match, the
//                                 bandpass numerator on v2^2
//              poles_emit_kernel  one warp: a lane for each of the 8
//                                 complex poles, then the residue sum and
//                                 slope / emit / differential 32 samples
//                                 at a time
//   decoder 2: fir_kernel         parallel: the 45-tap RRC, re and im apart
//              mm_core_kernel     one thread: AGC, M&M timing, Costas
//   decoder 3: costas_kernel      decoder 1's stage 1, as it is
//              clock_kernel       one block: the lowpass outputs it reads,
//                                 the bit-clock phase chain on one thread,
//                                 then clk, the emits and the
//                                 integrate-and-dump in parallel
// Only the feedback recursions stay on one thread: no FIR feeds back into
// them, so the FIRs are a parallel pre-pass between the sequential stages;
// decoder 3's integrator is reset at each emit, and its clock phase needs
// no data, so only its phase chain (an add and a compare-and-select a
// sample) stays sequential besides the Costas loop.
//
// What bounds each stage on an H100.  The sequential stages: the
// recursion's dependency chain on one thread, not bytes (128 KB a block)
// or flops.  Per sample the Costas loop chains an accurate sincosf, an IEEE
// division and about 12 dependent f32 operations; the AGC a multiply, an
// accurate hypotf and 3 operations (M&M and Costas once a symbol, ~20
// samples); each pole 3 operations.  chip_smoke.py measures those
// latencies on the card and prints each stage's floor beside its time.
// The FIR stages: their launch (16384 outputs of 21-45 taps is far below a
// microsecond of the card's bandwidth or flops).  Design: a sequential
// stage keeps its state in registers (no array is indexed at run time, so
// nothing lives in local memory; decoder 1's pole count is a template
// parameter, a lane a pole) and reads its input from shared memory,
// staged one chunk ahead by the whole block with cp.async (a ring of two
// chunks of STAGE_CHUNK samples; any T >= 1).  Its stores go straight out.
// A FIR stage stages its window and taps in shared memory and sums each
// output in the order of the sequential ring it replaces (acc = 0, then
// acc + taps[k] * x[n-k] for k = 0..K-1).
//
// The source builds without FMA contraction (-fmad=false, kernels/build.py)
// and without fast math, so each multiply and add rounds on its own, as in
// the plain versions' float32 host loops and torch ops: a contracted FMA
// moves the Costas phase or the M&M floor(mu), and the bit stream shifts
// from there.  Measured: PERF.md (chip_smoke.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_TAPS = 64;
constexpr int STAGE_CHUNK = 1024;   // samples of a staged input chunk
constexpr int STAGE_THREADS = 128;  // block of a sequential stage
constexpr int FIR_TILE = 256;       // outputs (and threads) of a FIR block

// scalar head of the constant block (rds/scan_decoders.py _const_parts)
struct Head {
  float alpha, beta, limit, two_pi, omega, sps, mm_alpha, agc_rate, agc_ref;
};
constexpr int HEAD = 9;

__device__ __forceinline__ Head read_head(const float* c) {
  return Head{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8]};
}

struct Costas {
  float freq, phase;
  // r = z * e^{-i phase}, then the loop update (rds-decoder.cpp:79-82)
  __device__ float2 step(float zr, float zi, const Head& H, float alpha,
                         float beta) {
    float s, c;
    sincosf(phase, &s, &c);
    const float a = zr * c + zi * s;
    const float b = zi * c - zr * s;
    const float err = a * b;
    freq = freq + beta * err;
    if (fabsf(freq) > H.limit) freq = 0.0f;
    phase = phase + freq + alpha * err;
    phase = phase - H.two_pi * rintf(phase / H.two_pi);
    return make_float2(a, b);
  }
};

struct Emitter {
  int8_t* bits;
  float2* biq;
  int cap, count;
  __device__ void emit(bool bit, float2 iq) {
    if (count < cap) {
      bits[count] = bit ? 1 : 0;
      biq[count] = iq;
    }
    ++count;
  }
};

// ---------------------------------------------------------------------------
// input staging of the sequential stages
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// NS input streams of float2, staged chunk by chunk into a shared ring of
// two slots: chunk c holds samples [c*STAGE_CHUNK, min(T, (c+1)*STAGE_CHUNK))
// in slot c & 1.  The stage's loop, for chunks k = 0..nch-1:
//   wait for this thread's copies; barrier (chunk k has landed everywhere,
//   and thread 0 is done with chunk k-1, whose slot chunk k+1 takes);
//   issue chunk k+1; thread 0 runs the recursion over chunk k.
template <int NS>
struct Staging {
  float2 (*ring)[NS][STAGE_CHUNK];
  const float2* src[NS];
  int T;
  __device__ int len(int c) const {
    return min(STAGE_CHUNK, T - c * STAGE_CHUNK);
  }
  // each of the STAGE_THREADS staging threads, its share of chunk c
  __device__ void issue(int c) const {
    const int base = c * STAGE_CHUNK, n = len(c);
    for (int i = threadIdx.x; i < n; i += STAGE_THREADS) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        cp_async8(&ring[c & 1][s][i], src[s] + base + i);
    }
    cp_async_commit();
  }
};

// bits and points from `count` to cap are zeroed by the whole block
__device__ void zero_tail(const Emitter& em, int count) {
  for (int i = count + (int)threadIdx.x; i < em.cap; i += blockDim.x) {
    em.bits[i] = 0;
    em.biq[i] = make_float2(0.0f, 0.0f);
  }
}

// ---------------------------------------------------------------------------
// decoders 1 and 3, stage 1: the Costas loop (sequential); for decoder 3
// also its bit clock's phase chain, on a warp of its own
// ---------------------------------------------------------------------------

// jnp.mod(x, 2 pi) in float32
__device__ __forceinline__ float mod_2pi(float x, float two_pi) {
  const float r = fmodf(x, two_pi);
  return (r != 0.0f && r < 0.0f) ? r + two_pi : r;
}

// One step of the clock phase, x = ph + omega.  For 0 <= x < 4 pi the
// compare-and-subtract is exact (x - 2 pi for 2 pi <= x <= 2 * 2 pi is exact
// by Sterbenz's lemma) and equals fmodf(x, 2 pi) and mod_2pi(x) bit for bit.
// Every step but the first starts from a phase in [0, 2 pi], so only the
// first, from a phase handed in from outside, may need mod_2pi.
__device__ __forceinline__ float wrap_step(float x, float two_pi) {
  return x >= two_pi ? x - two_pi : x;
}
__device__ __forceinline__ float first_step(float x, float two_pi) {
  return (x >= 0.0f && x < 2.0f * two_pi) ? wrap_step(x, two_pi)
                                          : mod_2pi(x, two_pi);
}

// Decoder 3's clock phase before each of the T samples and after the last
// (ph [T + 1]) and the clock clk = sinf(ph) of each sample (clk [T]), on one
// thread beside the Costas loop (sinf is off the chain).  The phase depends on
// no data but its start: the state's phase, or at a resync the phase that
// synchronizeOnBitClk (rds-decoder-3.cpp:119-154) finds in sync_buf with
// filt[0] at p0.  filt[0] needs the Costas output of sample 0, which this
// thread takes itself from z[0] and the Costas state (the same step, so the
// same bits as the Costas thread's).  corr lives in shared memory.
// clk_in: the run lp_buf [K-1], sync_buf [N], p, bit_integrator,
// bit_clk_phase, prev_clk, prev_bit, need_resync.
__device__ void clock_chain(const float2* __restrict__ z, int T,
                            const float* __restrict__ c,
                            const float* __restrict__ cs_in,
                            const float* __restrict__ clk_in,
                            float* __restrict__ ph, float* __restrict__ clk,
                            float* corr) {
  const Head H = read_head(c);
  const int K = (int)c[HEAD], N = (int)c[HEAD + 1];
  const int fl = (int)c[HEAD + 2];              // floor(rate / bit clock)
  const float* lp = c + HEAD + 3;
  const float* kf = lp + K;                     // fold index, as floats
  const float* lp_buf = clk_in;
  const float* sync_buf = clk_in + K - 1;
  const int o = K - 1 + N;
  const int p0 = (int)clk_in[o];
  float x = clk_in[o + 2];
  if (clk_in[o + 5] != 0.0f) {
    Costas cs{cs_in[0], cs_in[1]};
    const float2 r = cs.step(z[0].x, z[0].y, H, H.alpha, H.beta);
    float f0 = 0.0f;                            // filt[0], as fir_in_order
    for (int k = 0; k < K; ++k)
      f0 = f0 + lp[k] * (k == 0 ? r.x * 4.0f : lp_buf[K - 1 - k]);
    for (int j = 0; j < N; ++j) corr[j] = 0.0f;
    const int first = p0 + 1 == N ? 0 : p0 + 1;
    for (int j = 0; j < N; ++j) {
      const int q = first + j >= N ? first + j - N : first + j;
      const int k = (int)kf[j];
      corr[k] = corr[k] + (q == p0 ? f0 : sync_buf[q]);
    }
    int pos1 = fl, pos2 = fl;
    for (int j = 0; j < fl; ++j)
      if (corr[j] <= 0.0f) { pos1 = j; break; }
    for (int j = 0; j < fl; ++j)
      if (corr[j] >= 0.0f && j > pos1) { pos2 = j; break; }
    const int i_min = pos1 >= fl ? fl : min(pos2 + 1, fl);
    x = mod_2pi(-H.omega * ((float)i_min - 1.0f), H.two_pi);
  }
  ph[0] = x;
  clk[0] = sinf(x);
  x = first_step(x + H.omega, H.two_pi);
#pragma unroll 8
  for (int n = 1; n < T; ++n) {
    ph[n] = x;
    clk[n] = sinf(x);
    x = wrap_step(x + H.omega, H.two_pi);
  }
  ph[T] = x;
}

// the staging barrier of the Costas threads (the first STAGE_THREADS):
// the whole block, or with a chain warp beside them, a named barrier
template <bool CHAIN>
__device__ __forceinline__ void stage_sync() {
  if (CHAIN)
    asm volatile("bar.sync 1, %0;" ::"n"(STAGE_THREADS) : "memory");
  else
    __syncthreads();
}

// CHAIN (decoder 3): two more warps; the second's lane 0 runs clock_chain
// into ph [T + 1] and clk [T] = ph + T + 1 (on another scheduler than the
// Costas thread's), the first exits.  Without CHAIN (decoder 1) clk_in and
// ph are unused.
template <bool CHAIN>
__global__ void __launch_bounds__(CHAIN ? STAGE_THREADS + 64 : STAGE_THREADS)
    costas_kernel(const float2* __restrict__ z, int T, int nch,
                  const float* __restrict__ c,
                  const float* __restrict__ cs_in,  // freq, phase
                  float* __restrict__ cs_out, float2* __restrict__ iq4,
                  const float* __restrict__ clk_in, float* __restrict__ ph) {
  __shared__ float2 ring[2][1][STAGE_CHUNK];
  if (CHAIN && threadIdx.x >= STAGE_THREADS) {
    __shared__ float corr[MAX_TAPS];
    if (threadIdx.x == STAGE_THREADS + 32)
      clock_chain(z, T, c, cs_in, clk_in, ph, ph + T + 1, corr);
    return;
  }
  const Staging<1> st{ring, {z}, T};
  const Head H = read_head(c);
  Costas cs{cs_in[0], cs_in[1]};
  st.issue(0);
  for (int k = 0; k < nch; ++k) {
    cp_async_wait_all();
    stage_sync<CHAIN>();
    if (k + 1 < nch) st.issue(k + 1);
    if (threadIdx.x == 0) {
      const float2* s = ring[k & 1][0];
      float2* out = iq4 + k * STAGE_CHUNK;
      const int n = st.len(k);
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float2 r = cs.step(s[i].x, s[i].y, H, H.alpha, H.beta);
        out[i] = make_float2(r.x * 4.0f, r.y * 4.0f);
      }
    }
  }
  if (threadIdx.x == 0) {
    cs_out[0] = cs.freq;
    cs_out[1] = cs.phase;
  }
}

// ---------------------------------------------------------------------------
// the FIR pre-pass (parallel): decoder 1's three FIRs, decoder 2's RRC
// ---------------------------------------------------------------------------

// y[n] = sum_k taps[k] * in(n - k), summed k = 0..K-1 from 0.0f, for NC
// interleaved components (decoder 2's re and im apart).  The input stream
// is the history `hist` (K-1 values a component, oldest first) followed by
// x[j * xstride + c] for j = 0..T-1, squared
// first when SQUARE (the history already holds squares).  One output a
// thread; block 0 also writes the new history, the last K-1 inputs.
template <int NC, bool SQUARE>
__global__ void __launch_bounds__(FIR_TILE)
    fir_kernel(const float* __restrict__ hist, float* __restrict__ hist_out,
               const float* __restrict__ x, int xstride, int T,
               const float* __restrict__ taps, int K, float* __restrict__ y,
               int ystride) {
  __shared__ float tp[MAX_TAPS];
  __shared__ float win[NC][FIR_TILE + MAX_TAPS - 1];
  auto input = [&](int j, int c) -> float {
    if (j < 0) return hist[(j + K - 1) * NC + c];
    if (j >= T) return 0.0f;
    const float v = x[(size_t)j * xstride + c];
    return SQUARE ? v * v : v;
  };
  const int n0 = blockIdx.x * FIR_TILE;
  for (int k = threadIdx.x; k < K; k += blockDim.x) tp[k] = taps[k];
  for (int i = threadIdx.x; i < FIR_TILE + K - 1; i += blockDim.x) {
#pragma unroll
    for (int c = 0; c < NC; ++c) win[c][i] = input(n0 - (K - 1) + i, c);
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < K - 1; i += blockDim.x) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        hist_out[i * NC + c] = input(T - (K - 1) + i, c);
    }
  }
  __syncthreads();
  const int n = n0 + threadIdx.x;
  if (n >= T) return;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float* w = win[c] + threadIdx.x + K - 1;  // w[-k] = in(n - k)
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) acc = acc + tp[k] * w[-k];
    y[(size_t)n * ystride + c] = acc;
  }
}

// ---------------------------------------------------------------------------
// decoder 1, stage 3: the bit-clock pole bank and the emit logic
// ---------------------------------------------------------------------------

// The same function as this sequential loop, in which only the pole states
// w feed back (3 dependent operations a sample):
//   mag = 0; for p < P: w[p] = g[p] w[p] + xb (as (gr wr - gi wi) + xb, gr wi
//   + gi wr); mag = mag + (rr nr - ri ni)
//   slope = mag - last_sync; emit = slope < 0 && last_slope >= 0;
//   the_bit = last_data >= 0; on emit: emit bit the_bit != prev_bit and
//   the point 4r, prev_bit = the_bit; last_sync = mag; last_slope = slope;
//   last_data = v2.
// One warp runs it, a sub-block of POLE_SUB samples at a time: lane p < P
// runs pole p's recursion and writes its residue term; then each lane sums
// one sample's P terms in the order p = 0..P-1 and the warp decides 32
// samples' emits at once (the carried values by shuffles, the emit slots and
// the differential bit's previous emit by ballots).  Every operation and
// its order are the loop's, so the results are equal bit for bit.
constexpr int POLE_SUB = 256;

// xv: (xb, v2) a sample, from the FIR pre-pass; iq4: the Costas stage's 4r.
// pr: the P poles, then the P residues (re, im).  tail: last_sync,
// last_sync_slope, last_data, prev_bit.
template <int P>
__global__ void __launch_bounds__(STAGE_THREADS)
    poles_emit_kernel(const float2* __restrict__ xv,
                      const float2* __restrict__ iq4, int T, int nch,
                      const float* __restrict__ pr,
                      const float* __restrict__ w_in,
                      float* __restrict__ w_out,
                      const float* __restrict__ tail_in,
                      float* __restrict__ tail_out, Emitter em,
                      int* __restrict__ count) {
  static_assert(P <= 32, "one lane a pole");
  __shared__ float2 ring[2][2][STAGE_CHUNK];
  __shared__ float term[P][POLE_SUB + 1];  // +1: the P lanes' stores
                                           // fall in P banks
  __shared__ int s_count;
  const Staging<2> st{ring, {xv, iq4}, T};
  const int lane = threadIdx.x;             // meaningful in warp 0
  const int p = lane < P ? lane : 0;        // lane p's pole
  const float gr = pr[2 * p], gi = pr[2 * p + 1];
  const float rr = pr[2 * P + 2 * p], ri = pr[2 * P + 2 * p + 1];
  float wr = w_in[2 * p], wi = w_in[2 * p + 1];
  float last_sync = tail_in[0], last_slope = tail_in[1],
        last_data = tail_in[2];
  bool prev_bit = tail_in[3] != 0.0f;
  int cnt = 0;
  st.issue(0);
  for (int k = 0; k < nch; ++k) {
    cp_async_wait_all();
    __syncthreads();
    if (k + 1 < nch) st.issue(k + 1);
    if (threadIdx.x >= 32) continue;
    const float2* a = ring[k & 1][0];
    const float2* q = ring[k & 1][1];
    const int n = st.len(k);
    for (int s0 = 0; s0 < n; s0 += POLE_SUB) {
      const int m = min(POLE_SUB, n - s0);
      if (lane < P) {
        // xb three samples ahead: a shared load outlasts the 3-op chain
        const float* x = &a[s0].x;
        float x0 = x[0], x1 = x[2 * min(1, m - 1)], x2 = x[2 * min(2, m - 1)];
#pragma unroll 4
        for (int i = 0; i < m; ++i) {
          const float x3 = x[2 * min(i + 3, m - 1)];
          const float nr = (gr * wr - gi * wi) + x0;
          const float ni = gr * wi + gi * wr;
          wr = nr;
          wi = ni;
          term[p][i] = rr * nr - ri * ni;
          x0 = x1;
          x1 = x2;
          x2 = x3;
        }
      }
      __syncwarp();
      for (int g = 0; g < m; g += 32) {
        const int i = g + lane;
        const int valid = min(32, m - g);   // lanes holding a sample
        const bool ok = lane < valid;
        float mag = 0.0f;
        if (ok) {
#pragma unroll
          for (int pp = 0; pp < P; ++pp) mag = mag + term[pp][i];
        }
        const float v2 = ok ? a[s0 + i].y : 0.0f;
        // sample i - 1's mag, slope and v2 (lane 0: the carried ones)
        const float up_mag = __shfl_up_sync(0xffffffffu, mag, 1);
        const float before = lane == 0 ? last_sync : up_mag;
        const float slope = mag - before;
        const float up_slope = __shfl_up_sync(0xffffffffu, slope, 1);
        const float up_v2 = __shfl_up_sync(0xffffffffu, v2, 1);
        const float prev_slope = lane == 0 ? last_slope : up_slope;
        const float prev_data = lane == 0 ? last_data : up_v2;
        const bool emit = ok && slope < 0.0f && prev_slope >= 0.0f;
        const bool the_bit = prev_data >= 0.0f;
        const unsigned mask = __ballot_sync(0xffffffffu, emit);
        const unsigned bitmask = __ballot_sync(0xffffffffu, the_bit);
        const unsigned below = mask & ((1u << lane) - 1u);
        // the held bit: the_bit at the last emit before this sample
        const bool held = below ? ((bitmask >> (31 - __clz(below))) & 1u)
                                : prev_bit;
        if (emit) {
          const int slot = cnt + __popc(below);
          if (slot < em.cap) {
            em.bits[slot] = (the_bit != held) ? 1 : 0;
            em.biq[slot] = q[s0 + i];
          }
        }
        cnt += __popc(mask);
        if (mask) prev_bit = (bitmask >> (31 - __clz(mask))) & 1u;
        last_sync = __shfl_sync(0xffffffffu, mag, valid - 1);
        last_slope = __shfl_sync(0xffffffffu, slope, valid - 1);
        last_data = __shfl_sync(0xffffffffu, v2, valid - 1);
      }
      __syncwarp();
    }
  }
  if (threadIdx.x < P) {
    w_out[2 * p] = wr;
    w_out[2 * p + 1] = wi;
  }
  if (threadIdx.x == 0) {
    tail_out[0] = last_sync;
    tail_out[1] = last_slope;
    tail_out[2] = last_data;
    tail_out[3] = prev_bit ? 1.0f : 0.0f;
    *count = cnt;
    s_count = cnt;
  }
  __syncthreads();
  zero_tail(em, s_count);
}

__device__ __forceinline__ float rail(float x) { return x > 0.0f ? 1.0f : -1.0f; }

// ---------------------------------------------------------------------------
// decoder 2, stage 2: AGC, Mueller & Muller timing and Costas (sequential)
// ---------------------------------------------------------------------------

// v: the RRC output.  si / so: agc_gain, freq, phase, s0, s1, s2 (re, im),
// count, skip, mu, prev_bit, last_iq (re, im).
__global__ void __launch_bounds__(STAGE_THREADS)
    mm_core_kernel(const float2* __restrict__ v, int T, int nch,
                   const float* __restrict__ c, const float* __restrict__ si,
                   float* __restrict__ so, Emitter em,
                   int* __restrict__ count, float2* __restrict__ iqs) {
  __shared__ float2 ring[2][1][STAGE_CHUNK];
  __shared__ int s_count;
  const Staging<1> st{ring, {v}, T};
  const Head H = read_head(c);
  float gain = si[0];
  Costas cs{si[1], si[2]};
  float s0r = si[3], s0i = si[4], s1r = si[5], s1i = si[6];
  float s2r = si[7], s2i = si[8];
  int cnt = (int)si[9], skip = (int)si[10];
  float mu = si[11];
  bool prev_bit = si[12] != 0.0f;
  float lr = si[13], li = si[14];
  st.issue(0);
  for (int k = 0; k < nch; ++k) {
    cp_async_wait_all();
    __syncthreads();
    if (k + 1 < nch) st.issue(k + 1);
    if (threadIdx.x == 0) {
      const float2* s = ring[k & 1][0];
      const int base = k * STAGE_CHUNK, n = st.len(k);
      float2 cur = s[0];
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float2 nxt = s[min(i + 1, n - 1)];  // loads ahead of the chain
        const float outr = cur.x * gain, outi = cur.y * gain;
        cur = nxt;
        gain = gain + H.agc_rate * (H.agc_ref - hypotf(outr, outi));
        s0r = s1r; s0i = s1i;
        s1r = s2r; s1i = s2i;
        s2r = outr; s2i = outi;
        ++cnt;
        if (cnt >= skip) {
          const float x = (rail(s2r) - rail(s0r)) * s1r
                          + (rail(s2i) - rail(s0i)) * s1i;
          const float y = (s2r - s0r) * rail(s1r) + (s2i - s0i) * rail(s1i);
          mu = mu + H.sps + H.mm_alpha * (y - x);
          skip = (int)floorf(mu);
          mu = mu - (float)skip;
          const float2 r = cs.step(s2r, s2i, H, H.alpha, H.beta);
          const bool the_bit = r.x >= 0.0f;
          em.emit(the_bit != prev_bit, r);
          prev_bit = the_bit;
          lr = r.x;
          li = r.y;
          cnt = 0;
        }
        if (iqs) iqs[base + i] = make_float2(lr, li);
      }
    }
  }
  if (threadIdx.x == 0) {
    so[0] = gain;
    so[1] = cs.freq;
    so[2] = cs.phase;
    so[3] = s0r; so[4] = s0i;
    so[5] = s1r; so[6] = s1i;
    so[7] = s2r; so[8] = s2i;
    so[9] = (float)cnt;
    so[10] = (float)skip;
    so[11] = mu;
    so[12] = prev_bit ? 1.0f : 0.0f;
    so[13] = lr;
    so[14] = li;
    *count = em.count;
    s_count = em.count;
  }
  __syncthreads();
  zero_tail(em, s_count);
}

// ---------------------------------------------------------------------------
// decoder 3, stage 2: the lowpass outputs it reads, the bit clock and the
// integrate-and-dump (its stage 1 is costas_kernel)
// ---------------------------------------------------------------------------

constexpr int CLK_THREADS = 1024;
constexpr int CLK_PER = 4;                          // samples a thread
constexpr int CLK_CHUNK = CLK_THREADS * CLK_PER;    // samples a pass
constexpr int CLK_MAX_EMITS = CLK_CHUNK / 2;        // no two emits in a row

// Decoder 3 needs of its 21-tap lowpass only filt[0] (the clock search at
// a resync reads it through sync_buf: the Costas stage's chain warp took
// it) and the last min(T, N) outputs (the new sync_buf), N =
// symbol_ceiling; each is summed k = 0..K-1 from 0 as fir_in_order sums
// it.  The clock and its phases come from the Costas stage (clock_chain).
// A pass of CLK_CHUNK samples at a time, the block takes the emits
// (clk[n-1] <= 0 < clk[n]) and their slots by a block prefix count,
// and one thread a bit sums integ = integ + clk * v over its segment in
// sample order (from the carried integrator in the first segment, from 0
// after each emit), so every sum is the sequential loop's.  v is Re(4r),
// the Costas stage's output; the points are 4r at the emits.  Nothing is
// sequential here beyond a segment of ~20 samples.
// st_in / st_out: lp_buf [K-1], sync_buf [N], p, bit_integrator,
// bit_clk_phase, prev_clk, prev_bit, need_resync.
__global__ void __launch_bounds__(CLK_THREADS)
    clock_kernel(const float2* __restrict__ iq4, const float* __restrict__ ph,
                 int T, const float* __restrict__ c,
                 const float* __restrict__ si, float* __restrict__ so,
                 Emitter em, int* __restrict__ count) {
  __shared__ float s_clk[CLK_CHUNK];
  __shared__ float s_v[CLK_CHUNK];
  __shared__ int s_pos[CLK_MAX_EMITS];   // emit positions in the pass
  __shared__ unsigned char s_tb[CLK_MAX_EMITS];  // the_bit at each emit
  __shared__ int s_wsum[CLK_THREADS / 32];
  __shared__ float s_sync[MAX_TAPS];
  __shared__ float s_tail;
  __shared__ int s_nemit;
  const int K = (int)c[HEAD], N = (int)c[HEAD + 1];
  const float* lp = c + HEAD + 3;
  const int o = K - 1 + N;
  const int p0 = (int)si[o];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the lowpass's input stream: the history, then v
  auto input = [&](int j) -> float {
    return j < 0 ? si[j + K - 1] : iq4[j].x;
  };
  auto filt = [&](int n) -> float {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = acc + lp[k] * input(n - k);
    return acc;
  };

  // the new ring: the last min(T, N) outputs at their positions
  const int m = min(T, N);
  if (tid < N) s_sync[tid] = si[K - 1 + tid];
  __syncthreads();
  if (tid < m) {
    const int n = T - m + tid;
    s_sync[(p0 + n % N) % N] = filt(n);
  }
  if (tid < K - 1) so[tid] = input(T - (K - 1) + tid);   // the new lp_buf
  __syncthreads();
  if (tid < N) so[K - 1 + tid] = s_sync[tid];

  float integ = si[o + 1], prev_clk = si[o + 3];
  bool prev_bit = si[o + 4] != 0.0f;

  int cnt = 0;
  for (int b0 = 0; b0 < T; b0 += CLK_CHUNK) {
    const int n = min(CLK_CHUNK, T - b0);
    for (int i = tid; i < n; i += CLK_THREADS) {
      s_clk[i] = ph[T + 1 + b0 + i];
      s_v[i] = iq4[b0 + i].x;
    }
    __syncthreads();
    // the emits of this thread's CLK_PER samples, then their slots
    const int i0 = tid * CLK_PER;
    unsigned mine = 0u;
#pragma unroll
    for (int k = 0; k < CLK_PER; ++k) {
      const int i = i0 + k;
      if (i < n) {
        const float before = i == 0 ? prev_clk : s_clk[i - 1];
        if (before <= 0.0f && s_clk[i] > 0.0f) mine |= 1u << k;
      }
    }
    const int ne = __popc(mine);
    int incl = ne;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) s_wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = s_wsum[lane];
      int wi = w;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, wi, d);
        if (lane >= d) wi += up;
      }
      s_wsum[lane] = wi - w;
      if (lane == 31) s_nemit = wi;
    }
    __syncthreads();
    int at = s_wsum[warp] + incl - ne;
#pragma unroll
    for (int k = 0; k < CLK_PER; ++k)
      if ((mine >> k) & 1u) s_pos[at++] = i0 + k;
    __syncthreads();
    // segment k ends at emit k; segment nemit is the tail of the pass
    const int nemit = s_nemit;
    for (int k = tid; k <= nemit; k += CLK_THREADS) {
      const int start = k == 0 ? 0 : s_pos[k - 1] + 1;
      const int end = k < nemit ? s_pos[k] : n - 1;
      float acc = k == 0 ? integ : 0.0f;        // k == 0: thread 0's carry
      for (int i = start; i <= end; ++i) acc = acc + s_clk[i] * s_v[i];
      if (k < nemit)
        s_tb[k] = acc >= 0.0f ? 1 : 0;
      else
        s_tail = acc;
    }
    __syncthreads();
    for (int k = tid; k < nemit; k += CLK_THREADS) {
      const int slot = cnt + k;
      if (slot < em.cap) {
        const bool held = k == 0 ? prev_bit : s_tb[k - 1] != 0;
        em.bits[slot] = ((s_tb[k] != 0) != held) ? 1 : 0;
        em.biq[slot] = iq4[b0 + s_pos[k]];
      }
    }
    if (tid == 0) {
      if (nemit) prev_bit = s_tb[nemit - 1] != 0;
      integ = s_tail;
      prev_clk = s_clk[n - 1];
    }
    cnt += nemit;
    __syncthreads();
  }
  if (tid == 0) {
    so[o] = (float)((p0 + T % N) % N);
    so[o + 1] = integ;
    so[o + 2] = ph[T];
    so[o + 3] = prev_clk;
    so[o + 4] = prev_bit ? 1.0f : 0.0f;
    so[o + 5] = 0.0f;
    *count = cnt;
  }
  zero_tail(em, cnt);
}

// ---------------------------------------------------------------------------
// latency microkernel: n dependent applications of one operation on one
// thread, timed by the SM's cycle counter (built with the decoders' flags)
// ---------------------------------------------------------------------------

__global__ void latency_kernel(int op, int n, const float* __restrict__ in,
                               float* __restrict__ out,
                               long long* __restrict__ cycles) {
  float x = in[0];
  const float y = in[1];
  const long long t0 = clock64();
  switch (op) {
    case 0:
#pragma unroll 16
      for (int i = 0; i < n; ++i) x = x + y;
      break;
    case 1:
#pragma unroll 16
      for (int i = 0; i < n; ++i) x = x * y;
      break;
    case 2:
#pragma unroll 16
      for (int i = 0; i < n; ++i) x = x / y;
      break;
    case 3:
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        float s, c;
        sincosf(x, &s, &c);
        x = s + c;
      }
      break;
    case 4:
#pragma unroll 4
      for (int i = 0; i < n; ++i) x = hypotf(x, y);
      break;
    default:  // decoder 3's clock phase step (clock_kernel's chain)
#pragma unroll 16
      for (int i = 0; i < n; ++i) x = wrap_step(x + y, 6.2831855f);
      break;
  }
  const long long t1 = clock64();
  out[0] = x;
  cycles[0] = t1 - t0;
}

bool chunks_ok(int T, int nch) {
  return T >= 1 && nch >= 1 && (long long)nch * STAGE_CHUNK >= T
         && (long long)(nch - 1) * STAGE_CHUNK < T;
}

}  // namespace

extern "C" {

// Every entry point takes device pointers and launches on `stream` without
// synchronising; it returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments it refuses, without launching).  T: samples in the block; nch:
// its staging chunks, ceil(T / STAGE_CHUNK); tiles: its FIR blocks,
// ceil(T / FIR_TILE).  bits [cap] int8, biq [cap] complex64, count: one
// int32.

// decoders 1 and 3, stage 1.  z [T] complex64; head: the decoder's
// constant block; cs_in / cs_out: (freq, phase); iq4 [T] complex64 out (4r,
// the iq stream).  Decoder 3 (clk_in not null): clk_in is its state run
// from lp_buf to need_resync, and ph [2T + 1] floats out: the clock phases
// [T + 1], then the clock [T].
int sdr_rds_costas(const void* z, int T, int nch, const void* head,
                   const void* cs_in, void* cs_out, void* iq4,
                   const void* clk_in, void* ph, void* stream) {
  if (!chunks_ok(T, nch) || cs_in == cs_out || (clk_in && !ph))
    return (int)cudaErrorInvalidValue;
  if (clk_in)
    costas_kernel<true><<<1, STAGE_THREADS + 64, 0, (cudaStream_t)stream>>>(
        (const float2*)z, T, nch, (const float*)head, (const float*)cs_in,
        (float*)cs_out, (float2*)iq4, (const float*)clk_in, (float*)ph);
  else
    costas_kernel<false><<<1, STAGE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float2*)z, T, nch, (const float*)head, (const float*)cs_in,
        (float*)cs_out, (float2*)iq4, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// a FIR stage.  hist / hist_out: (K-1) x nc floats; x: input floats with
// stride xstride; y: output floats with stride ystride (nc components
// interleaved in each); square: the input is squared (nc == 1 only).
int sdr_rds_fir(const void* hist, void* hist_out, const void* x, int xstride,
                int T, const void* taps, int K, int nc, int square, void* y,
                int ystride, int tiles, void* stream) {
  if (T < 1 || K < 2 || K > MAX_TAPS || hist == hist_out || xstride < nc
      || ystride < nc || (long long)tiles * FIR_TILE < T
      || (long long)(tiles - 1) * FIR_TILE >= T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* h = (const float*)hist;
  const float* xx = (const float*)x;
  const float* tp = (const float*)taps;
  if (nc == 1 && !square)
    fir_kernel<1, false><<<tiles, FIR_TILE, 0, s>>>(
        h, (float*)hist_out, xx, xstride, T, tp, K, (float*)y, ystride);
  else if (nc == 1)
    fir_kernel<1, true><<<tiles, FIR_TILE, 0, s>>>(
        h, (float*)hist_out, xx, xstride, T, tp, K, (float*)y, ystride);
  else if (nc == 2 && !square)
    fir_kernel<2, false><<<tiles, FIR_TILE, 0, s>>>(
        h, (float*)hist_out, xx, xstride, T, tp, K, (float*)y, ystride);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// decoder 1 stage 3.  xv [T] (xb, v2) pairs; iq4 [T] complex64; pr: P poles
// then P residues (complex); w_in / w_out: the P pole states; tail_in /
// tail_out: last_sync, last_sync_slope, last_data, prev_bit.  P must be 8.
int sdr_rds_poles_emit(const void* xv, const void* iq4, int T, int nch,
                       const void* pr, int P, const void* w_in, void* w_out,
                       const void* tail_in, void* tail_out, void* bits,
                       void* biq, void* count, int cap, void* stream) {
  if (!chunks_ok(T, nch) || P != 8 || cap < 1 || w_in == w_out
      || tail_in == tail_out)
    return (int)cudaErrorInvalidValue;
  Emitter em{(int8_t*)bits, (float2*)biq, cap, 0};
  poles_emit_kernel<8><<<1, STAGE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)xv, (const float2*)iq4, T, nch, (const float*)pr,
      (const float*)w_in, (float*)w_out, (const float*)tail_in,
      (float*)tail_out, em, (int*)count);
  return (int)cudaGetLastError();
}

// decoder 2 stage 2.  v [T] complex64 (the RRC output); head: the constant
// block; st_in / st_out: the 15 floats from agc_gain to last_iq; iqs [T]
// complex64 or null.
int sdr_rds_mm_core(const void* v, int T, int nch, const void* head,
                    const void* st_in, void* st_out, void* bits, void* biq,
                    void* count, int cap, void* iqs, void* stream) {
  if (!chunks_ok(T, nch) || cap < 1 || st_in == st_out)
    return (int)cudaErrorInvalidValue;
  Emitter em{(int8_t*)bits, (float2*)biq, cap, 0};
  mm_core_kernel<<<1, STAGE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)v, T, nch, (const float*)head, (const float*)st_in,
      (float*)st_out, em, (int*)count, (float2*)iqs);
  return (int)cudaGetLastError();
}

// decoder 3 stage 2.  iq4 [T] complex64 and ph [2T + 1] floats (the Costas
// stage's 4r, clock phases and clock); consts: decoder 3's constant block;
// st_in / st_out: the run from lp_buf to need_resync (distinct buffers).
int sdr_rds_clock(const void* iq4, const void* ph, int T, const void* consts,
                  const void* st_in, void* st_out, void* bits, void* biq,
                  void* count, int cap, void* stream) {
  if (T < 1 || cap < 1 || st_in == st_out) return (int)cudaErrorInvalidValue;
  Emitter em{(int8_t*)bits, (float2*)biq, cap, 0};
  clock_kernel<<<1, CLK_THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)iq4, (const float*)ph, T, (const float*)consts,
      (const float*)st_in, (float*)st_out, em, (int*)count);
  return (int)cudaGetLastError();
}

// op: 0 add, 1 multiply, 2 IEEE division (x = x op in[1]), 3 sincosf (x =
// sin x + cos x), 4 hypotf (x = hypotf(x, in[1])), 5 the clock phase step
// (x = x + in[1], less 2 pi where that reaches 2 pi); n >= 1 steps from x =
// in[0].  out: the final x; cycles: one int64, clock64 around the loop.
int sdr_rds_latency(int op, int n, const void* in, void* out, void* cycles,
                    void* stream) {
  if (op < 0 || op > 5 || n < 1) return (int)cudaErrorInvalidValue;
  latency_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      op, n, (const float*)in, (float*)out, (long long*)cycles);
  return (int)cudaGetLastError();
}

int sdr_rds_max_taps() { return MAX_TAPS; }
int sdr_rds_stage_chunk() { return STAGE_CHUNK; }
int sdr_rds_fir_tile() { return FIR_TILE; }
int sdr_rds_clock_chunk() { return CLK_CHUNK; }

}  // extern "C"
