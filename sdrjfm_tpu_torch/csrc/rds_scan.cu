// Per-sample RDS bit decoders 1, 2 and 3 for Hopper (sm_90a), one thread a
// stream.
//
// They replace the JAX package's lax.scan decoders (no Pallas counterpart):
//   decoder1_kernel  <- sdrjfm_tpu/rds/scan_decoders.py:108 decoder1_block
//   decoder2_kernel  <- sdrjfm_tpu/rds/scan_decoders.py:191 decoder2_block
//   decoder3_kernel  <- sdrjfm_tpu/rds/scan_decoders.py:313 decoder3_block
// Each runs one block of the 24 kS/s RDS baseband (16384 samples at
// block_fm=131072) through the decoder's feedback loops in sample order,
// reads its state from `st_in` and writes the new state to `st_out` (out of
// place), writes each emitted bit and its constellation point compacted at
// the running emit count (count may exceed cap; points past it are dropped,
// and bits/iq from count to cap are zeroed), and, when `iqs` is not null,
// the per-sample 24 kHz iq stream (the RDS_DEMOD scope tap).
//
// What bounds them on an H100: the recursion.  Every sample's Costas phase,
// AGC gain, timing phase and pole states depend on the previous sample's,
// so a block is a chain of 16384 dependent steps; bytes (128 KB in) and
// flops (~300 a sample) are negligible.  The time is the dependency chain:
// per sample an accurate sinf/cosf pair (~40-60 cycles each), then the FIR
// sums (21 + 43 + 9 taps for decoder 1, accumulated in sequence) and the
// 8 complex poles.  chip_smoke.py reports this chain estimate beside the
// roofline bound.  Design: a single thread keeps the state in registers and
// the FIR histories in doubled ring buffers (a contiguous window per sample
// without a modulo).  The source builds without FMA contraction
// (-fmad=false, kernels/build.py) and without fast math, so each multiply
// and add rounds on its own, as in the plain versions' float32 host loops:
// a contracted FMA moves the Costas phase or the M&M floor(mu), and the
// bit stream shifts from there.  Measured: PERF.md (chip_smoke.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_TAPS = 64;
constexpr int MAX_POLES = 16;

// scalar head of the constant block (rds/scan_decoders.py _consts)
struct Head {
  float alpha, beta, limit, two_pi, omega, sps, mm_alpha, agc_rate, agc_ref;
};
constexpr int HEAD = 9;

__device__ __forceinline__ Head read_head(const float* c) {
  return Head{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8]};
}

// FIR history of K samples in a doubled ring: the window oldest..newest is
// v[h+1 .. h+K] after a push at h.
struct Ring {
  float v[2 * MAX_TAPS];
  int K, h;
  __device__ void init(const float* hist, int k) {  // hist: K-1, oldest first
    K = k;
    h = 0;
    for (int j = 1; j < K; ++j) v[j] = v[j + K] = hist[j - 1];
  }
  // push x, return sum_k taps[k] * x[n-k], summed k = 0..K-1
  __device__ float push(float x, const float* taps) {
    v[h] = x;
    v[h + K] = x;
    // one accumulator, k in order; unrolled so the loads issue ahead
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) acc = acc + taps[k] * v[h + K - k];
    h = h + 1 == K ? 0 : h + 1;
    return acc;
  }
  __device__ void save(float* out) const {  // the last K-1 inputs
    for (int j = 0; j < K - 1; ++j) out[j] = v[h + 1 + j];
  }
};

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
  __device__ void finish(int* out) {
    for (int i = count; i < cap; ++i) {
      bits[i] = 0;
      biq[i] = make_float2(0.0f, 0.0f);
    }
    *out = count;
  }
};

__global__ void decoder1_kernel(const float2* __restrict__ z, int T,
                                const float* __restrict__ c,
                                const float* __restrict__ si,
                                float* __restrict__ so, Emitter em,
                                int* __restrict__ count,
                                float2* __restrict__ iqs) {
  const Head H = read_head(c);
  const int Ll = (int)c[HEAD], Lm = (int)c[HEAD + 1], Ln = (int)c[HEAD + 2];
  const int P = (int)c[HEAD + 3];
  const float* lp = c + HEAD + 4;
  const float* mk = lp + Ll;
  const float* num = mk + Lm;
  const float* pol = num + Ln;
  const float* res = pol + 2 * P;
  // state layout: freq, phase, lp_buf, match_buf, sharp_w (re, im),
  // sharp_fir, last_sync, last_sync_slope, last_data, prev_bit
  Costas cs{si[0], si[1]};
  int o = 2;
  Ring rl, rm, rn;
  rl.init(si + o, Ll);
  o += Ll - 1;
  rm.init(si + o, Lm);
  o += Lm - 1;
  float wr[MAX_POLES], wi[MAX_POLES];
  for (int p = 0; p < P; ++p) {
    wr[p] = si[o + 2 * p];
    wi[p] = si[o + 2 * p + 1];
  }
  const int o_w = o;
  o += 2 * P;
  rn.init(si + o, Ln);
  const int o_fir = o;
  o += Ln - 1;
  float last_sync = si[o], last_slope = si[o + 1], last_data = si[o + 2];
  bool prev_bit = si[o + 3] != 0.0f;

  for (int n = 0; n < T; ++n) {
    const float2 zi = z[n];
    const float2 r = cs.step(zi.x, zi.y, H, H.alpha, H.beta);
    const float v = r.x * 4.0f;
    const float v1 = rl.push(v, lp);
    const float v2 = rm.push(v1, mk);
    const float xb = rn.push(v2 * v2, num);
    float mag = 0.0f;
    for (int p = 0; p < P; ++p) {
      const float gr = pol[2 * p], gi = pol[2 * p + 1];
      const float nr = (gr * wr[p] - gi * wi[p]) + xb;
      const float ni = gr * wi[p] + gi * wr[p];
      wr[p] = nr;
      wi[p] = ni;
      mag = mag + (res[2 * p] * nr - res[2 * p + 1] * ni);
    }
    const float slope = mag - last_sync;
    const bool emit = slope < 0.0f && last_slope >= 0.0f;
    const bool the_bit = last_data >= 0.0f;
    const float2 iq = make_float2(r.x * 4.0f, r.y * 4.0f);
    if (emit) {
      em.emit(the_bit != prev_bit, iq);
      prev_bit = the_bit;
    }
    last_sync = mag;
    last_slope = slope;
    last_data = v2;
    if (iqs) iqs[n] = iq;
  }
  so[0] = cs.freq;
  so[1] = cs.phase;
  rl.save(so + 2);
  rm.save(so + 2 + Ll - 1);
  for (int p = 0; p < P; ++p) {
    so[o_w + 2 * p] = wr[p];
    so[o_w + 2 * p + 1] = wi[p];
  }
  rn.save(so + o_fir);
  so[o] = last_sync;
  so[o + 1] = last_slope;
  so[o + 2] = last_data;
  so[o + 3] = prev_bit ? 1.0f : 0.0f;
  em.finish(count);
}

__device__ __forceinline__ float rail(float x) { return x > 0.0f ? 1.0f : -1.0f; }

__global__ void decoder2_kernel(const float2* __restrict__ z, int T,
                                const float* __restrict__ c,
                                const float* __restrict__ si,
                                float* __restrict__ so, Emitter em,
                                int* __restrict__ count,
                                float2* __restrict__ iqs) {
  const Head H = read_head(c);
  const int K = (int)c[HEAD];
  const float* rrc = c + HEAD + 1;
  // state layout: mf_buf (re, im), agc_gain, freq, phase, s0, s1, s2
  // (re, im), count, skip, mu, prev_bit, last_iq (re, im)
  float hr[MAX_TAPS], hi[MAX_TAPS];
  for (int j = 0; j < K - 1; ++j) {
    hr[j] = si[2 * j];
    hi[j] = si[2 * j + 1];
  }
  Ring rr_, ri_;
  rr_.init(hr, K);
  ri_.init(hi, K);
  int o = 2 * (K - 1);
  float gain = si[o];
  Costas cs{si[o + 1], si[o + 2]};
  float s0r = si[o + 3], s0i = si[o + 4], s1r = si[o + 5], s1i = si[o + 6];
  float s2r = si[o + 7], s2i = si[o + 8];
  int cnt = (int)si[o + 9], skip = (int)si[o + 10];
  float mu = si[o + 11];
  bool prev_bit = si[o + 12] != 0.0f;
  float lr = si[o + 13], li = si[o + 14];

  for (int n = 0; n < T; ++n) {
    const float2 zi = z[n];
    const float vr = rr_.push(zi.x, rrc);
    const float vi = ri_.push(zi.y, rrc);
    const float outr = vr * gain, outi = vi * gain;
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
    if (iqs) iqs[n] = make_float2(lr, li);
  }
  rr_.save(hr);
  ri_.save(hi);
  for (int j = 0; j < K - 1; ++j) {
    so[2 * j] = hr[j];
    so[2 * j + 1] = hi[j];
  }
  so[o] = gain;
  so[o + 1] = cs.freq;
  so[o + 2] = cs.phase;
  so[o + 3] = s0r; so[o + 4] = s0i;
  so[o + 5] = s1r; so[o + 6] = s1i;
  so[o + 7] = s2r; so[o + 8] = s2i;
  so[o + 9] = (float)cnt;
  so[o + 10] = (float)skip;
  so[o + 11] = mu;
  so[o + 12] = prev_bit ? 1.0f : 0.0f;
  so[o + 13] = lr;
  so[o + 14] = li;
  em.finish(count);
}

// jnp.mod(x, 2 pi) in float32
__device__ __forceinline__ float mod_2pi(float x, float two_pi) {
  const float r = fmodf(x, two_pi);
  return (r != 0.0f && r < 0.0f) ? r + two_pi : r;
}

__global__ void decoder3_kernel(const float2* __restrict__ z, int T,
                                const float* __restrict__ c,
                                const float* __restrict__ si,
                                float* __restrict__ so, Emitter em,
                                int* __restrict__ count,
                                float2* __restrict__ iqs) {
  const Head H = read_head(c);
  const int Ll = (int)c[HEAD], N = (int)c[HEAD + 1];
  const int fl = (int)c[HEAD + 2];              // floor(rate / bit clock)
  const float* lp = c + HEAD + 3;
  const float* kf = lp + Ll;                  // fold index, as floats
  // state layout: freq, phase, lp_buf, sync_buf[N], p, bit_integrator,
  // bit_clk_phase, prev_clk, prev_bit, need_resync
  Costas cs{si[0], si[1]};
  Ring rl;
  rl.init(si + 2, Ll);
  const int o_s = 2 + Ll - 1;
  float sb[MAX_TAPS];
  for (int j = 0; j < N; ++j) sb[j] = si[o_s + j];
  const int o = o_s + N;
  int p = (int)si[o];
  float integ = si[o + 1], ph = si[o + 2], prev_clk = si[o + 3];
  bool prev_bit = si[o + 4] != 0.0f;
  const bool need_resync = si[o + 5] != 0.0f;

  for (int n = 0; n < T; ++n) {
    const float2 zi = z[n];
    const float2 r = cs.step(zi.x, zi.y, H, H.alpha, H.beta);
    const float v = r.x * 4.0f;
    sb[p] = rl.push(v, lp);
    p = p + 1 == N ? 0 : p + 1;
    if (n == 0 && need_resync) {
      // synchronizeOnBitClk (rds-decoder-3.cpp:119-154), at a resync only
      float corr[MAX_TAPS];
      for (int j = 0; j < N; ++j) corr[j] = 0.0f;
      for (int j = 0; j < N; ++j) {
        const int q = p + j >= N ? p + j - N : p + j;
        corr[(int)kf[j]] = corr[(int)kf[j]] + sb[q];
      }
      int pos1 = fl, pos2 = fl;
      for (int j = 0; j < fl; ++j)
        if (corr[j] <= 0.0f) { pos1 = j; break; }
      for (int j = 0; j < fl; ++j)
        if (corr[j] >= 0.0f && j > pos1) { pos2 = j; break; }
      const int i_min = pos1 >= fl ? fl : min(pos2 + 1, fl);
      ph = mod_2pi(-H.omega * ((float)i_min - 1.0f), H.two_pi);
    }
    float clk = sinf(ph);
    integ = integ + clk * v;
    const bool the_bit = integ >= 0.0f;
    if (prev_clk <= 0.0f && clk > 0.0f) {
      em.emit(the_bit != prev_bit, make_float2(r.x * 4.0f, r.y * 4.0f));
      prev_bit = the_bit;
      integ = 0.0f;
    }
    ph = mod_2pi(ph + H.omega, H.two_pi);
    prev_clk = clk;
    if (iqs) iqs[n] = make_float2(r.x * 4.0f, r.y * 4.0f);
  }
  so[0] = cs.freq;
  so[1] = cs.phase;
  rl.save(so + 2);
  for (int j = 0; j < N; ++j) so[o_s + j] = sb[j];
  so[o] = (float)p;
  so[o + 1] = integ;
  so[o + 2] = ph;
  so[o + 3] = prev_clk;
  so[o + 4] = prev_bit ? 1.0f : 0.0f;
  so[o + 5] = 0.0f;
  em.finish(count);
}

}  // namespace

extern "C" {

// which: 1, 2 or 3.  z: [T] complex64; consts: the decoder's constant
// block; st_in / st_out: the packed state (nstate floats, distinct buffers);
// bits [cap] int8, biq [cap] complex64, count: one int32; iqs: [T]
// complex64 or null.  All device pointers; one launch of one thread on
// `stream`.  Returns cudaGetLastError().
int sdr_rds_decoder(int which, const void* z, int T, const void* consts,
                    const void* st_in, void* st_out, int nstate, void* bits,
                    void* biq, void* count, int cap, void* iqs,
                    void* stream) {
  if (T < 1 || cap < 1 || nstate < 1 || st_in == st_out)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  Emitter em{(int8_t*)bits, (float2*)biq, cap, 0};
  const float2* zz = (const float2*)z;
  const float* c = (const float*)consts;
  const float* si = (const float*)st_in;
  float* so = (float*)st_out;
  switch (which) {
    case 1:
      decoder1_kernel<<<1, 1, 0, s>>>(zz, T, c, si, so, em, (int*)count,
                                      (float2*)iqs);
      break;
    case 2:
      decoder2_kernel<<<1, 1, 0, s>>>(zz, T, c, si, so, em, (int*)count,
                                      (float2*)iqs);
      break;
    case 3:
      decoder3_kernel<<<1, 1, 0, s>>>(zz, T, c, si, so, em, (int*)count,
                                      (float2*)iqs);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int sdr_rds_max_taps() { return MAX_TAPS; }
int sdr_rds_max_poles() { return MAX_POLES; }

}  // extern "C"
