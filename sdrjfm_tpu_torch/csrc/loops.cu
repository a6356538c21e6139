// The fm chain's last sequential device loops for Hopper (sm_90a): four
// small kernels, each a port of a JAX `lax.scan` / `associative_scan` that
// the torch code ran as a Python loop of 0-dim (or [S]) tensor ops or as
// `torch.cummax`.  Every kernel takes R independent rows (R stations, or
// one), launches once a call and allocates nothing: its outputs come from
// the wrapper (kernels/loops.py), so a captured CUDA graph replays it with
// the same arguments.  Built with -fmad=false (kernels/build.py): the
// loops are feedback recurrences, and each multiply and add rounds on its
// own as in the plain versions, op by op.
//
// 1. pss_scan_kernel -- the PSS sub-block recurrence, JAX
//    sdrjfm_tpu/ops/pss.py:164 (lax.scan(step, ...)): 32 steps a
//    131072-sample block of boost, cos/sin(-2 acc), the Costas error, the
//    clamp, the error EMA, the lock / unlock run counters, `minimized` and
//    the pilot-unlock reset.  What bounds it: a dependent chain of ~40
//    cycles of sincosf and ~10 f32 operations a step, ~1.5 us a block; the
//    bytes (R x 32 x 17 B) are nothing.  Design: one thread a row runs the
//    steps in order, 64 rows a block; the block first stages 32 steps of
//    its rows' inputs in shared memory with every load in flight, so no
//    step waits on a global load, and writes the offsets out from shared
//    memory along the rows.
// 2. psi_unwrap_kernel -- the RDS carrier-phase unwrap, JAX
//    sdrjfm_tpu/rds/bitrecovery.py:128 (lax.scan(unwrap, ...)), fused with
//    the derotation y e^{-j psi} it feeds.  What bounds it: the derotation's
//    bytes, R x T complex64 read and written (0.26 MB a 16384-sample row,
//    ~0.08 us at 3.35 TB/s).  Design: grid (chunks of 2048 samples, rows);
//    in each block the sub-blocks' estimates are staged in shared memory,
//    then one thread runs the unwrap psi = r + rint((psi - r) / pi) pi
//    over the sub-blocks up to its chunk (8 steps a block at most;
//    rint is half to even, as torch.round and jnp.round), the sub-blocks'
//    cos / sin once each into shared memory, then 256 threads derotate 8
//    samples each with coalesced loads and stores.
// 3. runlength_kernel -- the consecutive-true run length, JAX
//    sdrjfm_tpu/ops/blockops.py:391-405 runlength_true
//    (associative_scan(jnp.maximum) at :400): the pilot lock counter.  What
//    bounds it: bytes, T flags read and T int32 written a row (131072 x 5 B,
//    0.0002 ms).  Design: a row is one cluster of 8 blocks of 1024 threads
//    (Hopper's thread-block clusters), each block 16384 samples of a
//    131072-sample step, 16 consecutive samples a thread (one 16-byte load
//    of flags where the row is 16-byte aligned): each thread finds the last
//    false index among its 16, a block max-scan over the threads (warp
//    shuffles, then the 32 warp totals) gives the block's total, which the
//    cluster's blocks read from each other's shared memory (distributed
//    shared memory, between two cluster barriers); joined with the steps
//    before, each thread has the last false index before its samples and
//    writes its run lengths into shared memory, from where the block
//    writes them out with consecutive threads on consecutive 16 bytes.  No
//    scratch and no look-back: replay-safe, deterministic, and integers
//    only, so it equals torch.cummax's route bit for bit.  (One block a
//    row took 0.030-0.040 ms on an H100, a row's 512 KB of stores and 128
//    KB of loads all through one SM; PERF.md.)
// 4. squelch_decide_kernel -- the hysteresis lattices of the noise squelch
//    (JAX sdrjfm_tpu/ops/squelch.py:120, mode 0: open below
//    a_low thr - HYS, close at or above a_low thr + HYS, held in between,
//    forced shut when thr < HYS) and of the level squelch (:208, mode 1:
//    closed below thr, open at or above it, held on NaN).  What bounds it:
//    16 dependent selects a block, nanoseconds.  Design: one thread a row,
//    its inputs staged in shared memory as the PSS scan's.
// Measured: PERF.md (chip_smoke.py phases kernels, times and latency).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;

// int32 addition that wraps as torch's and XLA's int32 tensors do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// ---------------------------------------------------------------------------
// 1. PSS
// ---------------------------------------------------------------------------

constexpr int PSS_THREADS = 64;                       // rows a block
constexpr int STAGE = 32;                             // steps staged at once

struct PssConsts {
  float alpha, decay, boost, clamp, thresh;
  int sub, hold;
};

// S, W: [R, n] complex64 sub-block sums; lk: the sub-block lock flags,
// element (r, k) at lk[r * lk_r + k * lk_c]; the state in (acc0 .. unlock0)
// and out (acc1 .. unlock1), [R] each; accs: [R, n], the offset held over
// each sub-block.  The block stages STAGE steps of its rows' inputs in
// shared memory with every load in flight, then each thread runs its row's
// steps from there.
__global__ void __launch_bounds__(PSS_THREADS)
pss_scan_kernel(const float2* __restrict__ S, const float2* __restrict__ W,
                const unsigned char* __restrict__ lk, long long lk_r,
                long long lk_c, const float* __restrict__ acc0,
                const float* __restrict__ me0,
                const unsigned char* __restrict__ min0,
                const int* __restrict__ lock0, const int* __restrict__ unlock0,
                float* __restrict__ accs, float* __restrict__ acc1,
                float* __restrict__ me1, unsigned char* __restrict__ min1,
                int* __restrict__ lock1, int* __restrict__ unlock1, int R,
                int n, PssConsts k) {
  __shared__ float2 s_S[PSS_THREADS][STAGE + 1], s_W[PSS_THREADS][STAGE + 1];
  __shared__ float s_acc[PSS_THREADS][STAGE + 1];
  __shared__ unsigned char s_lk[PSS_THREADS][STAGE + 1];
  const int tid = threadIdx.x, first = blockIdx.x * PSS_THREADS;
  const int r = first + tid, rows = min(PSS_THREADS, R - first);
  const bool live = r < R;
  float acc = 0.0f, me = 0.0f;
  bool minimized = false;
  int lock_run = 0, unlock_run = 0;
  if (live) {
    acc = acc0[r];
    me = me0[r];
    minimized = min0[r] != 0;
    lock_run = lock0[r];
    unlock_run = unlock0[r];
  }
  for (int k0 = 0; k0 < n; k0 += STAGE) {
    const int cnt = min(STAGE, n - k0);
    __syncthreads();                                  // the last stage read
    for (int j = tid; j < rows * STAGE; j += PSS_THREADS) {
      const int q = j / STAGE, i = j % STAGE, rr = first + q;
      if (i < cnt) {
        const long long e = (long long)rr * n + k0 + i;
        s_S[q][i] = S[e];
        s_W[q][i] = W[e];
        s_lk[q][i] = lk[rr * lk_r + (long long)(k0 + i) * lk_c];
      }
    }
    __syncthreads();
    for (int i = 0; live && i < cnt; ++i) {
      const bool locked = s_lk[tid][i] != 0;
      const float2 s = s_S[tid][i], w = s_W[tid][i];
      const float boost = minimized ? 1.0f : k.boost;
      const float x = -2.0f * acc;
      const float c = cosf(x), sn = sinf(x);
      // Im(e^{-2j acc} S_k), Im(e^{-2j acc} W_k), each product rounded
      const float err = 0.5f * (c * s.y + sn * s.x) * boost;
      float acc_n = acc + k.alpha * err;
      if (!isnan(acc_n)) acc_n = fminf(fmaxf(acc_n, -k.clamp), k.clamp);
      const float me_n = k.decay * me + (0.5f * boost) * (c * w.y + sn * w.x);
      const bool below = fabsf(me_n) < k.thresh;
      const int lock_n = below ? wrap_add(lock_run, k.sub) : 0;
      const int unlock_n = below ? 0 : wrap_add(unlock_run, k.sub);
      const bool min_n = below ? (minimized || lock_n > k.hold)
                               : (minimized && !(unlock_n > k.hold));
      s_acc[tid][i] = locked ? acc : 0.0f;
      // pilot unlock resets the analyzer
      acc = locked ? acc_n : 0.0f;
      me = locked ? me_n : 0.0f;
      minimized = locked && min_n;
      lock_run = locked ? lock_n : 0;
      unlock_run = locked ? unlock_n : 0;
    }
    __syncthreads();
    // the offsets out along each row, consecutive threads on consecutive
    // steps
    for (int j = tid; j < rows * STAGE; j += PSS_THREADS) {
      const int q = j / STAGE, i = j % STAGE;
      if (i < cnt) accs[(long long)(first + q) * n + k0 + i] = s_acc[q][i];
    }
  }
  if (!live) return;
  acc1[r] = acc;
  me1[r] = me;
  min1[r] = minimized ? 1 : 0;
  lock1[r] = lock_run;
  unlock1[r] = unlock_run;
}

// ---------------------------------------------------------------------------
// 2. RDS carrier-phase unwrap and derotation
// ---------------------------------------------------------------------------

constexpr int PSI_THREADS = 256;
constexpr int PSI_PER = 8;
constexpr int PSI_CHUNK = PSI_THREADS * PSI_PER;     // samples a block
constexpr int PSI_MAXSUB = 1024;                     // sub-blocks a row

// raw: [R, nsub] the per-sub-block estimates (psi mod pi); psi0: [R] the
// carried estimate; y, yr: [R, T] complex64; psi_last: [R].
__global__ void __launch_bounds__(PSI_THREADS)
psi_unwrap_kernel(const float* __restrict__ raw,
                  const float* __restrict__ psi0,
                  const float2* __restrict__ y, float2* __restrict__ yr,
                  float* __restrict__ psi_last, int T, int nsub, int sub,
                  float inv_pi, float pi) {
  __shared__ float2 s_rot[PSI_MAXSUB];                // (cos psi, -sin psi)
  __shared__ float s_psi[PSI_MAXSUB];                 // raw, then psi
  const int tid = threadIdx.x, row = blockIdx.y;
  const int c0 = blockIdx.x * PSI_CHUNK;
  const int kmax = min(nsub - 1, (min(c0 + PSI_CHUNK, T) - 1) / sub);
  const int k0 = c0 / sub;
  for (int k = tid; k <= kmax; k += PSI_THREADS)
    s_psi[k] = raw[(long long)row * nsub + k];
  __syncthreads();
  if (tid == 0) {
    float psi = psi0[row];
    for (int k = 0; k <= kmax; ++k) {
      const float r = s_psi[k];
      // (psi - r) / pi as torch on the card computes it: times the f32
      // reciprocal
      psi = r + rintf((psi - r) * inv_pi) * pi;
      s_psi[k] = psi;
    }
    if (kmax == nsub - 1 && blockIdx.x == gridDim.x - 1) psi_last[row] = psi;
  }
  __syncthreads();
  for (int k = k0 + tid; k <= kmax; k += PSI_THREADS)
    s_rot[k] = make_float2(cosf(s_psi[k]), -sinf(s_psi[k]));
  __syncthreads();
  const long long rb = (long long)row * T;
#pragma unroll
  for (int j = 0; j < PSI_PER; ++j) {
    const int n = c0 + tid + j * PSI_THREADS;
    if (n < T) {
      const float2 v = y[rb + n], e = s_rot[n / sub];
      yr[rb + n] = make_float2(v.x * e.x - v.y * e.y, v.x * e.y + v.y * e.x);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. run length of consecutive trues
// ---------------------------------------------------------------------------

constexpr int RL_THREADS = 1024;
constexpr int RL_PER = 16;                            // samples a thread
constexpr int RL_TILE = RL_THREADS * RL_PER;          // samples a block
constexpr int RL_CLUSTER = 8;                         // blocks a row
constexpr int RL_SPAN = RL_TILE * RL_CLUSTER;         // a cluster's step

// flags i .. i + 15 of a row as 16 bytes; past the row's end, true (they
// come after every sample of the row, so they change no run length)
template <bool VEC>
__device__ __forceinline__ uint4 load16(const unsigned char* f, int i,
                                        int T) {
  if (VEC) {
    if (i < T) return __ldg(reinterpret_cast<const uint4*>(f + i));
    return make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
  }
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = i + 4 * q + b;
      const unsigned fl = j < T ? (f[j] != 0 ? 1u : 0u) : 1u;
      v |= fl << (8 * b);
    }
    w[q] = v;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ bool flag_at(const uint4& v, int j) {
  const unsigned w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return ((w >> (8 * (j & 3))) & 0xffu) != 0u;
}

// flags: [R, T] bool; r0: [R] int32 the run carried in; rl: [R, T] int32;
// last: [R] = rl[:, T-1].  VEC: T % 16 == 0 and flags, rl 16-byte aligned.
// Grid (RL_CLUSTER, R): a row is one cluster, block `rank` of it takes
// samples [s0 + rank RL_TILE, + RL_TILE) of each RL_SPAN step s0.
// Dynamic shared memory: RL_TILE int32, the block's run lengths, written
// out by consecutive threads in 16-byte pieces.
template <bool VEC>
__global__ void __cluster_dims__(RL_CLUSTER, 1, 1)
__launch_bounds__(RL_THREADS)
runlength_kernel(const unsigned char* __restrict__ flags,
                 const int* __restrict__ r0, int* __restrict__ rl,
                 int* __restrict__ last, int T) {
  extern __shared__ int4 s_out4[];                    // RL_TILE / 4
  int* s_out = reinterpret_cast<int*>(s_out4);
  __shared__ int s_warp[32];
  __shared__ int s_total;                             // read by the cluster
  __shared__ int s_ranks[RL_CLUSTER];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  const unsigned char* f = flags + (long long)row * T;
  int* out = rl + (long long)row * T;
  const int carry_in = r0[row];
  int before = -1;                 // last false index before this step
  for (int s0 = 0; s0 < T; s0 += RL_SPAN) {
    const int t0 = s0 + rank * RL_TILE, base = t0 + tid * RL_PER;
    const uint4 cur = load16<VEC>(f, base, T);
    int lf = -1;                   // last false among this thread's 16
#pragma unroll
    for (int j = 0; j < RL_PER; ++j)
      if (!flag_at(cur, j)) lf = base + j;
    // inclusive max-scan over the block's threads
    int x = lf;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x = max(x, u);
    }
    int ex = __shfl_up_sync(FULL, x, 1);
    if (lane == 0) ex = -1;
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w = max(w, u);
      }
      s_warp[lane] = w;
      if (lane == 31) s_total = w;
    }
    cluster.sync();                // every block's total published
    if (tid < RL_CLUSTER) s_ranks[tid] = *cluster.map_shared_rank(&s_total,
                                                                  tid);
    __syncthreads();
    int lower = before;            // the blocks before this one, this step
#pragma unroll
    for (int q = 0; q < RL_CLUSTER; ++q) {
      if (q < rank) lower = max(lower, s_ranks[q]);
      before = max(before, s_ranks[q]);
    }
    int cur_lf = max(lower, ex);
    if (warp > 0) cur_lf = max(cur_lf, s_warp[warp - 1]);
    int o[RL_PER];
#pragma unroll
    for (int j = 0; j < RL_PER; ++j) {
      const int i = base + j;
      const bool fl = flag_at(cur, j);
      if (!fl) cur_lf = i;
      o[j] = !fl ? 0 : (cur_lf >= 0 ? i - cur_lf
                                    : wrap_add(wrap_add(i, 1), carry_in));
    }
    const int il = T - 1 - base;
    if (il >= 0 && il < RL_PER) {
#pragma unroll
      for (int j = 0; j < RL_PER; ++j)
        if (j == il) last[row] = o[j];
    }
#pragma unroll
    for (int q = 0; q < RL_PER / 4; ++q)
      s_out4[tid * (RL_PER / 4) + q] =
          make_int4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    __syncthreads();
    const int len = min(RL_TILE, T - t0);
    if (VEC) {
      int4* ov = reinterpret_cast<int4*>(out + t0);
#pragma unroll
      for (int q = 0; q < RL_PER / 4; ++q) {
        const int i4 = tid + q * RL_THREADS;
        if (4 * i4 < len) ov[i4] = s_out4[i4];
      }
    } else {
      for (int i = tid; i < len; i += RL_THREADS) out[t0 + i] = s_out[i];
    }
    // the totals read before the next step rewrites them, and before any
    // block of the cluster exits
    cluster.sync();
  }
}

// ---------------------------------------------------------------------------
// 4. squelch decisions
// ---------------------------------------------------------------------------

constexpr int SQ_THREADS = 64;                        // rows a block

// a, b: [R, n] the period-end values, element (r, k) at a[r * a_r + k *
// a_c] (b read in mode 0 only); thr: [R]; sup0: [R] the latched decision;
// sups: [R, n] each period's decision; sup_last: [R].  Staged as the PSS
// scan's inputs and outputs.
__global__ void __launch_bounds__(SQ_THREADS)
squelch_decide_kernel(int mode, const float* __restrict__ a, long long a_r,
                      long long a_c, const float* __restrict__ b,
                      long long b_r, long long b_c,
                      const float* __restrict__ thr,
                      const unsigned char* __restrict__ sup0,
                      unsigned char* __restrict__ sups,
                      unsigned char* __restrict__ sup_last, int R, int n,
                      float hys) {
  __shared__ float s_a[SQ_THREADS][STAGE + 1], s_b[SQ_THREADS][STAGE + 1];
  __shared__ unsigned char s_sup[SQ_THREADS][STAGE + 1];
  const int tid = threadIdx.x, first = blockIdx.x * SQ_THREADS;
  const int r = first + tid, rows = min(SQ_THREADS, R - first);
  const bool live = r < R;
  const float t = live ? thr[r] : 0.0f;
  bool sup = live && sup0[r] != 0;
  for (int k0 = 0; k0 < n; k0 += STAGE) {
    const int cnt = min(STAGE, n - k0);
    __syncthreads();
    for (int j = tid; j < rows * STAGE; j += SQ_THREADS) {
      const int q = j / STAGE, i = j % STAGE;
      const long long rr = first + q, kk = k0 + i;
      if (i < cnt) {
        s_a[q][i] = a[rr * a_r + kk * a_c];
        if (mode == 0) s_b[q][i] = b[rr * b_r + kk * b_c];
      }
    }
    __syncthreads();
    for (int i = 0; live && i < cnt; ++i) {
      const float av = s_a[tid][i];
      if (mode == 0) {
        const float bv = s_b[tid][i];
        const bool open = av < bv * t - hys;
        const bool close = av >= bv * t + hys;
        sup = t < hys ? true : (open ? false : (close ? true : sup));
      } else {
        sup = av < t ? true : (av >= t ? false : sup);
      }
      s_sup[tid][i] = sup ? 1 : 0;
    }
    __syncthreads();
    for (int j = tid; j < rows * STAGE; j += SQ_THREADS) {
      const int q = j / STAGE, i = j % STAGE;
      if (i < cnt) sups[(long long)(first + q) * n + k0 + i] = s_sup[q][i];
    }
  }
  if (live) sup_last[r] = sup ? 1 : 0;
}

}  // namespace

extern "C" {

// Every pointer is a device pointer; each entry launches one kernel on
// `stream` and returns the first CUDA error (0 on success).

int sdr_pss_scan(const void* S, const void* W, const void* lk, long long lk_r,
                 long long lk_c, const void* acc0, const void* me0,
                 const void* min0, const void* lock0, const void* unlock0,
                 void* accs, void* acc1, void* me1, void* min1, void* lock1,
                 void* unlock1, int R, int n, float alpha, float decay,
                 float boost, float clamp, float thresh, int sub, int hold,
                 void* stream) {
  if (R < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const PssConsts k{alpha, decay, boost, clamp, thresh, sub, hold};
  pss_scan_kernel<<<(R + PSS_THREADS - 1) / PSS_THREADS, PSS_THREADS, 0,
                    (cudaStream_t)stream>>>(
      (const float2*)S, (const float2*)W, (const unsigned char*)lk, lk_r,
      lk_c, (const float*)acc0, (const float*)me0,
      (const unsigned char*)min0, (const int*)lock0, (const int*)unlock0,
      (float*)accs, (float*)acc1, (float*)me1, (unsigned char*)min1,
      (int*)lock1, (int*)unlock1, R, n, k);
  return (int)cudaGetLastError();
}

int sdr_psi_unwrap(const void* raw, const void* psi0, const void* y, void* yr,
                   void* psi_last, int R, int T, int nsub, float inv_pi,
                   float pi, void* stream) {
  if (R < 1 || R > 65535 || T < 1 || nsub < 1 || nsub > PSI_MAXSUB
      || T % nsub != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((T + PSI_CHUNK - 1) / PSI_CHUNK), (unsigned)R);
  psi_unwrap_kernel<<<grid, PSI_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)raw, (const float*)psi0, (const float2*)y, (float2*)yr,
      (float*)psi_last, T, nsub, T / nsub, inv_pi, pi);
  return (int)cudaGetLastError();
}

int sdr_runlength(const void* flags, const void* r0, void* rl, void* last,
                  int R, int T, void* stream) {
  if (R < 1 || R > 65535 || T < 1 || T > 0x7fffffff - RL_SPAN)
    return (int)cudaErrorInvalidValue;
  const bool vec = T % 16 == 0 && (uintptr_t)flags % 16 == 0
                   && (uintptr_t)rl % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int smem = RL_TILE * (int)sizeof(int);
  // above 48 KB: opt in once a device (not a stream operation, so a
  // launch being captured into a graph needs nothing more)
  static bool attrs[256] = {};
  int device = 0;
  const cudaError_t ed = cudaGetDevice(&device);
  if (ed != cudaSuccess) return (int)ed;
  if (device < 0 || device >= 256) return (int)cudaErrorInvalidDevice;
  if (!attrs[device]) {
    cudaError_t e = cudaFuncSetAttribute(
        runlength_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(runlength_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e != cudaSuccess) return (int)e;
    attrs[device] = true;
  }
  const dim3 grid(RL_CLUSTER, (unsigned)R);
  if (vec)
    runlength_kernel<true><<<grid, RL_THREADS, smem, st>>>(
        (const unsigned char*)flags, (const int*)r0, (int*)rl, (int*)last,
        T);
  else
    runlength_kernel<false><<<grid, RL_THREADS, smem, st>>>(
        (const unsigned char*)flags, (const int*)r0, (int*)rl, (int*)last,
        T);
  return (int)cudaGetLastError();
}

int sdr_squelch_decide(int mode, const void* a, long long a_r, long long a_c,
                       const void* b, long long b_r, long long b_c,
                       const void* thr, const void* sup0, void* sups,
                       void* sup_last, int R, int n, float hys,
                       void* stream) {
  if (R < 1 || n < 1 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  squelch_decide_kernel<<<(R + SQ_THREADS - 1) / SQ_THREADS, SQ_THREADS, 0,
                          (cudaStream_t)stream>>>(
      mode, (const float*)a, a_r, a_c, (const float*)b, b_r, b_c,
      (const float*)thr, (const unsigned char*)sup0, (unsigned char*)sups,
      (unsigned char*)sup_last, R, n, hys);
  return (int)cudaGetLastError();
}

int sdr_psi_maxsub() { return PSI_MAXSUB; }
int sdr_rl_span() { return RL_SPAN; }

}  // extern "C"
