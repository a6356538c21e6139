// The fm chain's last sequential device loops for Hopper (sm_90a): small
// kernels, each a port of a JAX `lax.scan` / `associative_scan` that the
// torch code ran as a Python loop of 0-dim (or [S]) tensor ops or as
// `torch.cummax`.  Every kernel takes R independent rows (R stations, or
// one), launches once a call and allocates nothing: its outputs come from
// the wrapper (kernels/loops.py), so a captured CUDA graph replays it with
// the same arguments.  Built with -fmad=false (kernels/build.py): the
// loops are feedback recurrences, and each multiply and add rounds on its
// own as in the plain versions, op by op.
//
// 1. pss_adapt_kernel -- the PSS adaptation of one block after its
//    lowpass, JAX sdrjfm_tpu/ops/pss.py:121-124 (the sub-block sums of
//    F^2 and of EMA-weighted F^2), :164 (lax.scan(step, ...)) and :170
//    (jnp.repeat of the offsets): 32 steps a 131072-sample block of boost,
//    cos/sin(-2 acc), the Costas error, the clamp, the error EMA, the lock
//    / unlock run counters, `minimized` and the pilot-unlock reset, on sums
//    it forms itself, and the offsets written at the full rate.  What
//    bounds it: F read once and the offsets written once (R x T x 12 B,
//    1.57 MB a 131072-sample row, ~0.47 us at 3.35 TB/s), then a dependent
//    chain of sincosf and ~10 f32 operations a step (~3 us a block)
//    between the read and the write.  Design: a row is one cluster of 8
//    blocks of 512 threads; each block reduces its share of the sub-blocks
//    (4 of 4096 samples) from 16-byte loads all in flight, F^2 and F^2 w
//    formed in registers, each sub-block summed in a fixed order (each
//    thread's terms, a warp butterfly, the warps in turn) and stores the
//    sums into block 0's shared memory (distributed shared memory); after
//    a cluster barrier one thread of block 0 runs the steps and its warp
//    stores each offset into the block that holds its sub-block; after a
//    second barrier each block writes its offsets with 16-byte stores.  No
//    block reads another's memory, so no third barrier holds a block back
//    from exiting.  More sub-blocks than a cluster holds (n > 32) loop over
//    cluster steps, the state carried by that one thread.
//    pss_scan_kernel is the same recurrence on sums formed outside (the
//    time-sharded path gathers them across ranks between the sums and the
//    steps): one thread a row, 64 rows a block, 32 steps of its rows'
//    inputs staged in shared memory with every load in flight.
// 2. psi_recover_kernel -- the RDS carrier phase of one block, JAX
//    sdrjfm_tpu/rds/bitrecovery.py:120-121 (psi mod pi = angle(mean(y^2))
//    / 2 a sub-block), :128 (lax.scan(unwrap, ...)) and the derotation y
//    e^{-j psi} it feeds.  What bounds it: y read once and yr written once
//    (0.26 MB a 16384-sample row, ~0.08 us at 3.35 TB/s).  Design: a row
//    is one cluster of 8 blocks x 256 threads x 8 samples (16384 samples,
//    a 131072-sample block's RDS rate); each block loads its samples once
//    into registers, sums y^2 over each sub-block it touches in a fixed
//    order, and after a cluster barrier one warp of block 0 adds the
//    blocks' parts in rank order through distributed shared memory, scales
//    the sum as torch's mean does, takes 0.5 atan2, runs the unwrap psi =
//    r + rint((psi - r) / pi) pi on one lane (rint is half to even, as
//    torch.round and jnp.round) and each sub-block's cos / sin once; after
//    a second barrier every block reads its rotations, arrives at a third
//    (block 0 may not exit before) and derotates the samples it holds in
//    registers, waiting at it only after its stores.  A cluster step holds
//    whole sub-blocks (512 to 16384 samples); longer rows loop over steps,
//    psi carried.
//    psi_unwrap_kernel is the unwrap and derotation on estimates formed
//    outside: grid (chunks of 2048 samples, rows), each block's thread 0
//    runs the unwrap up to its chunk.
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
// 4. squelch_gate_kernel -- the noise squelch after its band filters, JAX
//    sdrjfm_tpu/ops/squelch.py:94-95 (the two decaying averages of |band|),
//    :104-105 (their period ends), :120 (lax.scan of the hysteresis lattice:
//    open below a_low thr - HYS, close at or above a_low thr + HYS, held in
//    between, forced shut when thr < HYS) and :124 (the jnp.repeat gate);
//    mode 1 the level squelch, :208 (closed below thr, open at or above it,
//    held on NaN) and :212.  What bounds it: bytes, the two bands and the
//    demod read once and the gated demod written once (R x T x 16 B, 2 MB
//    a 131072-sample row, ~0.63 us at 3.35 TB/s; level 1 MB), then a chain
//    of 16 carry steps and decisions a block, nanoseconds.  The averages at
//    full rate are never formed: a period's end is Y_k = g^H Y_(k-1) + P_k,
//    P_k = sum_j g^(H-1-j) alpha |v_j| over its H samples, g = 1 - alpha.
//    Design, mode 0: a row is one cluster of 8 blocks of 512 threads, each
//    block 16384 samples of a 131072-sample step (two 8192-sample
//    periods); a block loads its share of both bands with 16-byte loads all
//    in flight and sums each period's P_k for both in a fixed order (each
//    thread's terms, a warp butterfly, the warps in turn), the powers of g
//    from a table formed in float64 and rounded once (kernels/loops.py);
//    then it loads its demod samples, in flight across the barriers, and
//    pushes its P_k into block 0's shared memory (distributed shared
//    memory); after a cluster barrier one thread of block 0 runs the carry
//    and the lattice, its warp pushes each decision into the block that
//    holds the period, and after a second barrier each block writes x keep
//    with 16-byte stores.  No block reads another's memory after the second
//    barrier, so no third holds a block back from exiting.  More periods
//    than a step holds loop over steps, the state carried by that thread.
//    Mode 1 needs no cluster: grid (chunks of 16384 samples, rows), each
//    block stages the row's period-end carrier values up to its chunk, runs
//    the level lattice on one thread (every block alike) and gates its
//    chunk.  squelch_decide_kernel is the lattices alone on period ends
//    formed outside, which the time-sharded path gathers across ranks: one
//    thread a row, its inputs staged in shared memory as the PSS scan's.
// Measured: PERF.md (chip_smoke.py phases kernels, times, latency and
// stages).  Built with -DSDR_STAMP (kernels/build.py, stamped=True), thread
// 0 of each block of the cluster kernels records clock64 at its stage
// boundaries; the default build compiles none of it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifdef SDR_STAMP
// the stamped build: g_stamp[block][slot], block = blockIdx.y gridDim.x +
// blockIdx.x, slot 0 the start of a cluster step, 1 before its first
// cluster barrier, 2 after it, 3 before the second (block 0: after the
// serial chain), 4 after it, 5 after the stores were issued; a row of
// several steps keeps its last step's
constexpr int SDR_NSTAMP = 6;
__device__ long long* g_stamp = nullptr;
#define SDR_STAMP_AT(slot)                                                  \
  do {                                                                      \
    if (threadIdx.x == 0 && g_stamp != nullptr)                             \
      g_stamp[((long long)blockIdx.y * gridDim.x + blockIdx.x) * SDR_NSTAMP \
              + (slot)] = clock64();                                        \
  } while (0)
#else
#define SDR_STAMP_AT(slot) \
  do {                     \
  } while (0)
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;

// the two halves of a cluster barrier: a thread arrives once it is done
// with the other blocks' shared memory and waits where it needs all of
// them to be (release / acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

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

struct PssState {
  float acc, me;
  bool minimized;
  int lock_run, unlock_run;
};

__device__ __forceinline__ PssState pss_load(
    const float* acc0, const float* me0, const unsigned char* min0,
    const int* lock0, const int* unlock0, int r) {
  return PssState{acc0[r], me0[r], min0[r] != 0, lock0[r], unlock0[r]};
}

__device__ __forceinline__ void pss_store(
    const PssState& st, float* acc1, float* me1, unsigned char* min1,
    int* lock1, int* unlock1, int r) {
  acc1[r] = st.acc;
  me1[r] = st.me;
  min1[r] = st.minimized ? 1 : 0;
  lock1[r] = st.lock_run;
  unlock1[r] = st.unlock_run;
}

// One sub-block of the recurrence on its sums s = S_k, w = W_k: advances
// the state and returns the offset held over the sub-block.
__device__ __forceinline__ float pss_step(PssState& st, float2 s, float2 w,
                                          bool locked, const PssConsts& k) {
  const float boost = st.minimized ? 1.0f : k.boost;
  // sincosf: cosf's and sinf's values with one range reduction, a
  // shorter chain a step than the two calls
  float c, sn;
  sincosf(-2.0f * st.acc, &sn, &c);
  // Im(e^{-2j acc} S_k), Im(e^{-2j acc} W_k), each product rounded
  const float err = 0.5f * (c * s.y + sn * s.x) * boost;
  float acc_n = st.acc + k.alpha * err;
  if (!isnan(acc_n)) acc_n = fminf(fmaxf(acc_n, -k.clamp), k.clamp);
  const float me_n = k.decay * st.me + (0.5f * boost) * (c * w.y + sn * w.x);
  const bool below = fabsf(me_n) < k.thresh;
  const int lock_n = below ? wrap_add(st.lock_run, k.sub) : 0;
  const int unlock_n = below ? 0 : wrap_add(st.unlock_run, k.sub);
  const bool min_n = below ? (st.minimized || lock_n > k.hold)
                           : (st.minimized && !(unlock_n > k.hold));
  const float out = locked ? st.acc : 0.0f;
  // pilot unlock resets the analyzer
  st.acc = locked ? acc_n : 0.0f;
  st.me = locked ? me_n : 0.0f;
  st.minimized = locked && min_n;
  st.lock_run = locked ? lock_n : 0;
  st.unlock_run = locked ? unlock_n : 0;
  return out;
}

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
  PssState st{};
  if (live) st = pss_load(acc0, me0, min0, lock0, unlock0, r);
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
    for (int i = 0; live && i < cnt; ++i)
      s_acc[tid][i] = pss_step(st, s_S[tid][i], s_W[tid][i],
                               s_lk[tid][i] != 0, k);
    __syncthreads();
    // the offsets out along each row, consecutive threads on consecutive
    // steps
    for (int j = tid; j < rows * STAGE; j += PSS_THREADS) {
      const int q = j / STAGE, i = j % STAGE;
      if (i < cnt) accs[(long long)(first + q) * n + k0 + i] = s_acc[q][i];
    }
  }
  if (live) pss_store(st, acc1, me1, min1, lock1, unlock1, r);
}

constexpr int PSS_FT = 512;                           // threads a block
constexpr int PSS_WARPS = PSS_FT / 32;
constexpr int PSS_PER = 16;                           // float4 a thread
constexpr int PSS_CLUSTER = 8;                        // blocks a row

// component by component, in a fixed order
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 warp_sum4(float4 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(FULL, v.x, o);
    v.y += __shfl_xor_sync(FULL, v.y, o);
    v.z += __shfl_xor_sync(FULL, v.z, o);
    v.w += __shfl_xor_sync(FULL, v.w, o);
  }
  return v;
}

// F: [R, n S] complex64 as float4 (two samples each), rows 16-byte
// aligned; lk: the per-sample lock flags, element (r, t) at lk[r * lk_r +
// t * lk_c], read at t = k S; w: [S] the EMA weights as float2; the state
// in (acc0 .. unlock0) and out (acc1 .. unlock1), [R] each; off: [R, n S]
// float32 as float4, the offset of every sample.  QPS: float4 a thread in
// each sub-block, S = QPS x 1024 samples; a block takes SUBS = 16 / QPS
// sub-blocks of each cluster step, block `rank` sub-blocks s0 + rank SUBS
// .. + SUBS - 1.
template <int QPS>
__global__ void __cluster_dims__(PSS_CLUSTER, 1, 1)
__launch_bounds__(PSS_FT)
pss_adapt_kernel(const float4* __restrict__ F,
                 const unsigned char* __restrict__ lk, long long lk_r,
                 long long lk_c, const float2* __restrict__ w,
                 const float* __restrict__ acc0,
                 const float* __restrict__ me0,
                 const unsigned char* __restrict__ min0,
                 const int* __restrict__ lock0,
                 const int* __restrict__ unlock0, float4* __restrict__ off,
                 float* __restrict__ acc1, float* __restrict__ me1,
                 unsigned char* __restrict__ min1, int* __restrict__ lock1,
                 int* __restrict__ unlock1, int n, PssConsts k) {
  constexpr int S = QPS * 2 * PSS_FT;                 // samples a sub-block
  constexpr int SUBS = PSS_PER / QPS;                 // sub-blocks a block
  constexpr int SPAN = SUBS * PSS_CLUSTER;            // a cluster's step
  __shared__ float4 s_part[SUBS][PSS_WARPS];
  __shared__ unsigned char s_lk[SUBS];
  __shared__ float4 s_all[SPAN];        // block 0: the step's (S_k, W_k)
  __shared__ unsigned char s_alk[SPAN]; // block 0: the step's lock flags
  __shared__ float s_acc[SPAN];         // block 0: the step's offsets
  __shared__ float s_mine[SUBS];        // this block's offsets
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  const bool leader = rank == 0 && tid == 0;
  const long long T = (long long)n * S;
  const float4* f = F + row * (T / 2);
  float4* o = off + row * (T / 4);
  // this thread's EMA weights, the same in every sub-block: float4 q of
  // sub-block j holds its samples 2 ((q % QPS) PSS_FT + tid) and + 1
  float2 wq[QPS];
#pragma unroll
  for (int qq = 0; qq < QPS; ++qq) wq[qq] = w[qq * PSS_FT + tid];
  PssState st{};
  if (leader) st = pss_load(acc0, me0, min0, lock0, unlock0, row);
  for (int s0 = 0; s0 < n; s0 += SPAN) {
    SDR_STAMP_AT(0);
    const int kb = s0 + rank * SUBS;
    const int nsb = max(0, min(SUBS, n - kb));        // this block's
    const float4* fb = f + (long long)kb * (S / 2);
    float4 v[PSS_PER];
#pragma unroll
    for (int q = 0; q < PSS_PER; ++q)
      v[q] = q / QPS < nsb ? __ldg(fb + q * PSS_FT + tid)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (tid < nsb) s_lk[tid] = lk[row * lk_r + (long long)(kb + tid) * S
                                  * lk_c];
#pragma unroll
    for (int j = 0; j < SUBS; ++j) {
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int qq = 0; qq < QPS; ++qq) {
        const float4 x = v[j * QPS + qq];
        const float2 ww = wq[qq];
        // G = F * F as torch forms it: (re re - im im, re im + im re)
        const float g0r = x.x * x.x - x.y * x.y, g0i = x.x * x.y + x.y * x.x;
        const float g1r = x.z * x.z - x.w * x.w, g1i = x.z * x.w + x.w * x.z;
        a = add4(a, make_float4(g0r, g0i, g0r * ww.x, g0i * ww.x));
        a = add4(a, make_float4(g1r, g1i, g1r * ww.y, g1i * ww.y));
      }
      a = warp_sum4(a);
      if (lane == 0) s_part[j][warp] = a;
    }
    __syncthreads();
    // each sub-block's sums, and its lock flag, pushed into block 0 (remote
    // stores: no block reads another's memory after the second barrier,
    // so no third is needed before a block exits)
    if (tid < nsb) {
      float4 a = s_part[tid][0];
#pragma unroll
      for (int q = 1; q < PSS_WARPS; ++q) a = add4(a, s_part[tid][q]);
      *cluster.map_shared_rank(&s_all[rank * SUBS + tid], 0) = a;
      *cluster.map_shared_rank(&s_alk[rank * SUBS + tid], 0) = s_lk[tid];
    }
    SDR_STAMP_AT(1);
    cluster.sync();                      // every block's sums in block 0
    SDR_STAMP_AT(2);
    if (rank == 0 && warp == 0) {
      const int cnt = min(SPAN, n - s0);
      if (lane == 0)
        for (int i = 0; i < cnt; ++i) {
          const float4 a = s_all[i];
          s_acc[i] = pss_step(st, make_float2(a.x, a.y),
                              make_float2(a.z, a.w), s_alk[i] != 0, k);
        }
      __syncwarp();
      // the offsets pushed into the blocks that hold their sub-blocks
      for (int i = lane; i < cnt; i += 32)
        *cluster.map_shared_rank(&s_mine[i % SUBS], i / SUBS) = s_acc[i];
    }
    SDR_STAMP_AT(3);
    cluster.sync();                      // every block's offsets in place
    SDR_STAMP_AT(4);
    // the block's sub-blocks' offsets, consecutive threads on consecutive
    // 16 bytes
    float4* ob = o + (long long)kb * (S / 4);
#pragma unroll
    for (int p = 0; p < PSS_PER / 2; ++p) {
      const int i4 = p * PSS_FT + tid, j = i4 / (S / 4);
      if (j < nsb) {
        const float a = s_mine[j];
        ob[i4] = make_float4(a, a, a, a);
      }
    }
    SDR_STAMP_AT(5);
  }
  if (leader) pss_store(st, acc1, me1, min1, lock1, unlock1, row);
}

// ---------------------------------------------------------------------------
// 2. RDS carrier-phase unwrap and derotation
// ---------------------------------------------------------------------------

constexpr int PSI_THREADS = 256;
constexpr int PSI_PER = 8;
constexpr int PSI_CHUNK = PSI_THREADS * PSI_PER;     // samples a block
constexpr int PSI_MAXSUB = 1024;                     // sub-blocks a row

// the unwrap's step; (psi - r) / pi as torch on the card computes it:
// times the f32 reciprocal
__device__ __forceinline__ float psi_next(float psi, float r, float inv_pi,
                                          float pi) {
  return r + rintf((psi - r) * inv_pi) * pi;
}

// v e^{-j psi} with e = (cos psi, -sin psi), each product rounded
__device__ __forceinline__ float2 derotate(float2 v, float2 e) {
  return make_float2(v.x * e.x - v.y * e.y, v.x * e.y + v.y * e.x);
}

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
      psi = psi_next(psi, s_psi[k], inv_pi, pi);
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
      yr[rb + n] = derotate(y[rb + n], s_rot[n / sub]);
    }
  }
}

constexpr int PR_THREADS = 256;
constexpr int PR_WARPS = PR_THREADS / 32;
constexpr int PR_PER = 4;                             // float4 a thread
constexpr int PR_TILE = PR_THREADS * PR_PER * 2;      // samples a block
constexpr int PR_CLUSTER = 8;                         // blocks a row
constexpr int PR_SPAN = PR_TILE * PR_CLUSTER;         // a cluster's step
constexpr int PR_MINSUB = 512;                        // samples a sub-block
constexpr int PR_MAXG = PR_SPAN / PR_MINSUB;          // sub-blocks a step
constexpr int PR_SLOTS = 5;                           // sub-blocks a block

// y, yr: [R, T] complex64 as float4 (two samples each), rows 16-byte
// aligned; psi0, psi_last: [R]; P: samples a sub-block, even, PR_MINSUB ..
// PR_SPAN, dividing T.  Each cluster step takes G = PR_SPAN / P whole
// sub-blocks (L = G P samples); block `rank` holds samples [rank PR_TILE,
// + PR_TILE) of the step, which touch at most PR_SLOTS sub-blocks (slot s
// = sub-block kf + s, kf the block's first).  mean_scale: torch's factor
// of a mean over P samples, fl(1 / P).
__global__ void __cluster_dims__(PR_CLUSTER, 1, 1)
__launch_bounds__(PR_THREADS)
psi_recover_kernel(const float4* __restrict__ y,
                   const float* __restrict__ psi0, float4* __restrict__ yr,
                   float* __restrict__ psi_last, int T, int P,
                   float mean_scale, float inv_pi, float pi) {
  __shared__ float2 s_part[PR_SLOTS][PR_WARPS];
  __shared__ float2 s_sum[PR_SLOTS];    // the block's parts, read by block 0
  __shared__ float s_psi[PR_MAXG];      // block 0: raw, then psi
  __shared__ float2 s_rot[PR_MAXG];     // block 0: (cos psi, -sin psi)
  __shared__ float2 s_mine[PR_SLOTS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  const bool leader = rank == 0 && tid == 0;
  const int L = (PR_SPAN / P) * P;
  const float4* yy = y + (long long)row * (T / 2);
  float4* out = yr + (long long)row * (T / 2);
  float psi = leader ? psi0[row] : 0.0f;
  for (int c0 = 0; c0 < T; c0 += L) {
    SDR_STAMP_AT(0);
    const int len = min(L, T - c0);                   // whole sub-blocks
    const int t0 = c0 + rank * PR_TILE;               // the block's first
    const int blen = max(0, min(PR_TILE, len - rank * PR_TILE));
    const int kf = t0 / P;
    float4 v[PR_PER];
    int slot[PR_PER];
    float2 acc[PR_SLOTS];
#pragma unroll
    for (int s = 0; s < PR_SLOTS; ++s) acc[s] = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < PR_PER; ++q) {
      const int i = q * PR_THREADS + tid, n = 2 * i;  // P even: a float4's
      const bool in = n < blen;                       // two samples share
      v[q] = in ? __ldg(yy + t0 / 2 + i)              // a sub-block
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      slot[q] = in ? (t0 + n) / P - kf : PR_SLOTS;
    }
#pragma unroll
    for (int q = 0; q < PR_PER; ++q) {
      const float4 x = v[q];
      // y * y as torch forms it: (re re - im im, re im + im re)
      const float2 g0 = make_float2(x.x * x.x - x.y * x.y,
                                    x.x * x.y + x.y * x.x);
      const float2 g1 = make_float2(x.z * x.z - x.w * x.w,
                                    x.z * x.w + x.w * x.z);
#pragma unroll
      for (int s = 0; s < PR_SLOTS; ++s)
        if (slot[q] == s) {
          acc[s].x += g0.x;
          acc[s].y += g0.y;
          acc[s].x += g1.x;
          acc[s].y += g1.y;
        }
    }
#pragma unroll
    for (int s = 0; s < PR_SLOTS; ++s) {
      float2 a = acc[s];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a.x += __shfl_xor_sync(FULL, a.x, o);
        a.y += __shfl_xor_sync(FULL, a.y, o);
      }
      if (lane == 0) s_part[s][warp] = a;
    }
    __syncthreads();
    if (tid < PR_SLOTS) {
      float2 a = s_part[tid][0];
#pragma unroll
      for (int q = 1; q < PR_WARPS; ++q) {
        a.x += s_part[tid][q].x;
        a.y += s_part[tid][q].y;
      }
      s_sum[tid] = a;
    }
    SDR_STAMP_AT(1);
    cluster.sync();                      // every block's parts published
    SDR_STAMP_AT(2);
    const int k0 = c0 / P, g = len / P;
    if (rank == 0 && warp == 0) {
      if (lane < g) {
        // sub-block k0 + lane: the parts of the blocks that hold it, in
        // rank order; every block's part read at once (a remote load's
        // latency paid once, not once a block)
        const int k = k0 + lane;
        bool has[PR_CLUSTER];
        float2 p[PR_CLUSTER];
#pragma unroll
        for (int b = 0; b < PR_CLUSTER; ++b) {
          const int bt = c0 + b * PR_TILE;
          const int bl = min(PR_TILE, len - b * PR_TILE);
          const int bf = bt / P;
          has[b] = bl > 0 && k >= bf && k <= (bt + bl - 1) / P;
          p[b] = *cluster.map_shared_rank(&s_sum[has[b] ? k - bf : 0], b);
        }
        float2 a = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int b = 0; b < PR_CLUSTER; ++b)
          if (has[b]) {
            a.x += p[b].x;
            a.y += p[b].y;
          }
        // torch's mean (the sum times fl(1 / P)), then 0.5 angle
        s_psi[lane] = 0.5f * atan2f(a.y * mean_scale, a.x * mean_scale);
      }
      __syncwarp();
      if (lane == 0)
        for (int i = 0; i < g; ++i) {
          psi = psi_next(psi, s_psi[i], inv_pi, pi);
          s_psi[i] = psi;
        }
      __syncwarp();
      if (lane < g) {
        float c, sn;
        sincosf(s_psi[lane], &sn, &c);
        s_rot[lane] = make_float2(c, -sn);
      }
    }
    SDR_STAMP_AT(3);
    cluster.sync();                      // the step's rotations published
    SDR_STAMP_AT(4);
    if (blen > 0 && tid < PR_SLOTS && kf + tid <= (t0 + blen - 1) / P)
      s_mine[tid] = *cluster.map_shared_rank(&s_rot[kf + tid - k0], 0);
    // done with block 0's memory: its next step, and its exit, wait for
    // this (the wait below), while the samples go out
    cluster_arrive();
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PR_PER; ++q)
      if (slot[q] < PR_SLOTS) {
        const float4 x = v[q];
        const float2 e = s_mine[slot[q]];
        const float2 a = derotate(make_float2(x.x, x.y), e);
        const float2 b = derotate(make_float2(x.z, x.w), e);
        out[t0 / 2 + q * PR_THREADS + tid] = make_float4(a.x, a.y, b.x, b.y);
      }
    SDR_STAMP_AT(5);
    cluster_wait();
  }
  if (leader) psi_last[row] = psi;
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
// 4. squelch gate and decisions
// ---------------------------------------------------------------------------

// the noise lattice's step on the period ends a (high band) and b (low
// band): open below b t - hys, close at or above b t + hys, held in
// between, forced shut when t < hys
__device__ __forceinline__ bool nsq_decide(bool sup, float a, float b,
                                           float t, float hys) {
  const bool open = a < b * t - hys;
  const bool close = a >= b * t + hys;
  return t < hys ? true : (open ? false : (close ? true : sup));
}

// the level lattice's step on the carrier c: closed below t, open at or
// above it, held on NaN
__device__ __forceinline__ bool level_decide(bool sup, float c, float t) {
  return c < t ? true : (c >= t ? false : sup);
}

// v * keep component by component, as torch's x * gate
__device__ __forceinline__ float4 gate4(float4 v, float keep) {
  return make_float4(v.x * keep, v.y * keep, v.z * keep, v.w * keep);
}

constexpr int SG_THREADS = 512;
constexpr int SG_WARPS = SG_THREADS / 32;
constexpr int SG_PER = 8;                             // float4 a thread
constexpr int SG_TILE = SG_THREADS * SG_PER * 4;      // samples a block
constexpr int SG_CLUSTER = 8;                         // blocks a row (nsq)
constexpr int SG_SPAN = SG_TILE * SG_CLUSTER;         // a cluster's step
constexpr int SG_QUANT = SG_THREADS * 4;              // samples a float4 row
constexpr int SG_MAXQPH = SG_PER;                     // nsq: H <= SG_TILE
constexpr int SG_GROUP = 16;                          // lattice steps whose
                                                      // inputs load at once

// Mode 0 (nsq), launched as clusters of SG_CLUSTER blocks over grid
// (SG_CLUSTER, R): a, b the high and low bands' filter outputs, row r at a
// + r a_r (16-byte aligned, a_r % 4 == 0); x the demod likewise; y [R, T]
// the gated demod; wt [H / 4] float4, g^(H-1-j) at sample j of a period;
// thr, avg0h, avg0l, sup0 [R]; sups [R, nper]; sup_last, avgh, avgl [R].
// A period is QPH float4 rows of SG_THREADS (H = QPH SG_QUANT); block
// `rank` holds periods s0 + rank SUBS .. + SUBS - 1 of each step s0.
// Mode 1 (level), grid (T / SG_TILE rounded up, R), no cluster: a the
// carrier, read at the period ends only (any a_r); b, wt, avg* unused.
template <int MODE, int QPH>
__global__ void __launch_bounds__(SG_THREADS)
squelch_gate_kernel(const float* __restrict__ a, long long a_r,
                    const float* __restrict__ b, long long b_r,
                    const float* __restrict__ x, long long x_r,
                    float* __restrict__ y, const float4* __restrict__ wt,
                    const float* __restrict__ thr,
                    const float* __restrict__ avg0h,
                    const float* __restrict__ avg0l,
                    const unsigned char* __restrict__ sup0,
                    unsigned char* __restrict__ sups,
                    unsigned char* __restrict__ sup_last,
                    float* __restrict__ avgh, float* __restrict__ avgl,
                    int T, int H, float alpha, float gH, float hys) {
  const int tid = threadIdx.x, row = blockIdx.y;
  const int nper = T / H;
  const float4* xr = reinterpret_cast<const float4*>(x + row * x_r);
  float4* yr = reinterpret_cast<float4*>(y + (long long)row * T);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (MODE == 0) {
    constexpr int SUBS = SG_PER / QPH;                // periods a block
    constexpr int STEP = SUBS * SG_CLUSTER;           // periods a step
    constexpr int H4 = QPH * SG_THREADS;              // float4 a period
    __shared__ float2 s_part[SUBS][SG_WARPS];
    __shared__ float2 s_all[STEP];       // block 0: the step's (P_h, P_l)
    __shared__ unsigned char s_dec[STEP];  // block 0: the step's decisions
    __shared__ unsigned char s_mine[SUBS];  // this block's decisions
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int lane = tid & 31, warp = tid >> 5;
    const bool leader = rank == 0 && tid == 0;
    const float4* ar = reinterpret_cast<const float4*>(a + row * a_r);
    const float4* br = reinterpret_cast<const float4*>(b + row * b_r);
    // this thread's powers of g, the same in every period: float4 q of a
    // period holds its samples 4 ((q % QPH) SG_THREADS + tid) .. + 3
    float4 wq[QPH];
#pragma unroll
    for (int qq = 0; qq < QPH; ++qq) wq[qq] = __ldg(wt + qq * SG_THREADS + tid);
    float yh = 0.0f, yl = 0.0f, t = 0.0f;
    bool sup = false;
    if (leader) {
      yh = avg0h[row];
      yl = avg0l[row];
      t = thr[row];
      sup = sup0[row] != 0;
    }
    for (int s0 = 0; s0 < nper; s0 += STEP) {
      SDR_STAMP_AT(0);
      const int kb = s0 + rank * SUBS;
      const int nsb = max(0, min(SUBS, nper - kb));   // this block's
      const long long f0 = (long long)kb * H4;        // its first float4
      float4 va[SG_PER], vb[SG_PER];
#pragma unroll
      for (int q = 0; q < SG_PER; ++q) {
        const bool in = q / QPH < nsb;
        va[q] = in ? __ldg(ar + f0 + q * SG_THREADS + tid) : zero;
        vb[q] = in ? __ldg(br + f0 + q * SG_THREADS + tid) : zero;
      }
#pragma unroll
      for (int j = 0; j < SUBS; ++j) {
        // the EMA drive alpha |v| rounded as torch forms it, times g^(H-1-j)
        float ph = 0.0f, pl = 0.0f;
#pragma unroll
        for (int qq = 0; qq < QPH; ++qq) {
          const float4 u = va[j * QPH + qq], v = vb[j * QPH + qq];
          const float4 w = wq[qq];
          ph += w.x * (alpha * fabsf(u.x));
          ph += w.y * (alpha * fabsf(u.y));
          ph += w.z * (alpha * fabsf(u.z));
          ph += w.w * (alpha * fabsf(u.w));
          pl += w.x * (alpha * fabsf(v.x));
          pl += w.y * (alpha * fabsf(v.y));
          pl += w.z * (alpha * fabsf(v.z));
          pl += w.w * (alpha * fabsf(v.w));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          ph += __shfl_xor_sync(FULL, ph, o);
          pl += __shfl_xor_sync(FULL, pl, o);
        }
        if (lane == 0) s_part[j][warp] = make_float2(ph, pl);
      }
      // the demod's samples, in flight across the barriers
      float4 vx[SG_PER];
#pragma unroll
      for (int q = 0; q < SG_PER; ++q)
        vx[q] = q / QPH < nsb ? __ldg(xr + f0 + q * SG_THREADS + tid) : zero;
      __syncthreads();
      // each period's parts pushed into block 0 (remote stores: no block
      // reads another's memory after the second barrier)
      if (tid < nsb) {
        float2 p = s_part[tid][0];
#pragma unroll
        for (int q = 1; q < SG_WARPS; ++q) {
          p.x += s_part[tid][q].x;
          p.y += s_part[tid][q].y;
        }
        *cluster.map_shared_rank(&s_all[rank * SUBS + tid], 0) = p;
      }
      SDR_STAMP_AT(1);
      cluster.sync();                    // every block's parts in block 0
      SDR_STAMP_AT(2);
      if (rank == 0 && warp == 0) {
        const int cnt = min(STEP, nper - s0);
        if (lane == 0)
          // SG_GROUP periods' parts read at once, then their chain
          for (int i0 = 0; i0 < cnt; i0 += SG_GROUP) {
            float2 p[SG_GROUP];
#pragma unroll
            for (int i = 0; i < SG_GROUP; ++i)
              if (i0 + i < cnt) p[i] = s_all[i0 + i];
#pragma unroll
            for (int i = 0; i < SG_GROUP; ++i)
              if (i0 + i < cnt) {
                yh = gH * yh + p[i].x;
                yl = gH * yl + p[i].y;
                sup = nsq_decide(sup, yh, yl, t, hys);
                s_dec[i0 + i] = sup ? 1 : 0;
              }
          }
        __syncwarp();
        // the decisions pushed into the blocks that hold their periods
        for (int i = lane; i < cnt; i += 32) {
          *cluster.map_shared_rank(&s_mine[i % SUBS], i / SUBS) = s_dec[i];
          sups[(long long)row * nper + s0 + i] = s_dec[i];
        }
      }
      SDR_STAMP_AT(3);
      cluster.sync();                    // every block's decisions in place
      SDR_STAMP_AT(4);
#pragma unroll
      for (int q = 0; q < SG_PER; ++q)
        if (q / QPH < nsb)
          yr[f0 + q * SG_THREADS + tid] =
              gate4(vx[q], s_mine[q / QPH] ? 0.0f : 1.0f);
      SDR_STAMP_AT(5);
    }
    if (leader) {
      sup_last[row] = sup ? 1 : 0;
      avgh[row] = yh;
      avgl[row] = yl;
    }
  } else {
    __shared__ float s_c[SG_THREADS];    // a round of period-end values
    __shared__ unsigned char s_dec[SG_TILE / SG_QUANT + 1];  // this chunk's
    const int c0 = blockIdx.x * SG_TILE;
    const int k0 = c0 / H;                            // the chunk's periods
    const int kmax = (min(c0 + SG_TILE, T) - 1) / H;  // k0 .. kmax
    float4 vx[SG_PER];
#pragma unroll
    for (int q = 0; q < SG_PER; ++q) {
      const int i4 = c0 / 4 + q * SG_THREADS + tid;
      vx[q] = 4 * i4 < T ? __ldg(xr + i4) : zero;
    }
    const float t = thr[row];
    bool sup = sup0[row] != 0;
    for (int r0 = 0; r0 <= kmax; r0 += SG_THREADS) {
      __syncthreads();                   // the last round read
      const int k = r0 + tid;
      if (k <= kmax) s_c[tid] = a[row * a_r + (long long)(k + 1) * H - 1];
      __syncthreads();
      if (tid == 0) {
        const int cnt = min(SG_THREADS, kmax + 1 - r0);
        for (int i0 = 0; i0 < cnt; i0 += SG_GROUP) {
          float c[SG_GROUP];
#pragma unroll
          for (int i = 0; i < SG_GROUP; ++i)
            if (i0 + i < cnt) c[i] = s_c[i0 + i];
#pragma unroll
          for (int i = 0; i < SG_GROUP; ++i)
            if (i0 + i < cnt) {
              sup = level_decide(sup, c[i], t);
              const int kk = r0 + i0 + i;
              if (kk >= k0) s_dec[kk - k0] = sup ? 1 : 0;
            }
        }
      }
    }
    __syncthreads();
    // the decisions of the periods that start in this chunk, and the last
    const int k = k0 + tid;
    if (k <= kmax && (long long)k * H >= c0)
      sups[(long long)row * nper + k] = s_dec[tid];
    if (tid == 0 && blockIdx.x == gridDim.x - 1) sup_last[row] = sup ? 1 : 0;
#pragma unroll
    for (int q = 0; q < SG_PER; ++q) {
      const int i4 = c0 / 4 + q * SG_THREADS + tid;
      if (4 * i4 < T)
        yr[i4] = gate4(vx[q], s_dec[4 * i4 / H - k0] ? 0.0f : 1.0f);
    }
  }
}

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
      sup = mode == 0 ? nsq_decide(sup, av, s_b[tid][i], t, hys)
                      : level_decide(sup, av, t);
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

int sdr_pss_adapt(const void* F, const void* lk, long long lk_r,
                  long long lk_c, const void* w, const void* acc0,
                  const void* me0, const void* min0, const void* lock0,
                  const void* unlock0, void* off, void* acc1, void* me1,
                  void* min1, void* lock1, void* unlock1, int R, int n,
                  int sub, float alpha, float decay, float boost, float clamp,
                  float thresh, int hold, void* stream) {
  if (R < 1 || R > 65535 || n < 1 || (long long)n * sub > 0x7fffffff
      || (uintptr_t)F % 16 != 0 || (uintptr_t)off % 16 != 0
      || (uintptr_t)w % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const PssConsts k{alpha, decay, boost, clamp, thresh, sub, hold};
  const dim3 grid(PSS_CLUSTER, (unsigned)R);
  cudaStream_t st = (cudaStream_t)stream;
#define SDR_PSS_ADAPT(QPS)                                                  \
  pss_adapt_kernel<QPS><<<grid, PSS_FT, 0, st>>>(                          \
      (const float4*)F, (const unsigned char*)lk, lk_r, lk_c,              \
      (const float2*)w, (const float*)acc0, (const float*)me0,             \
      (const unsigned char*)min0, (const int*)lock0, (const int*)unlock0,  \
      (float4*)off, (float*)acc1, (float*)me1, (unsigned char*)min1,       \
      (int*)lock1, (int*)unlock1, n, k)
  switch (sub) {
    case 1024: SDR_PSS_ADAPT(1); break;
    case 2048: SDR_PSS_ADAPT(2); break;
    case 4096: SDR_PSS_ADAPT(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_PSS_ADAPT
  return (int)cudaGetLastError();
}

int sdr_psi_recover(const void* y, const void* psi0, void* yr,
                    void* psi_last, int R, int T, int P, float mean_scale,
                    float inv_pi, float pi, void* stream) {
  if (R < 1 || R > 65535 || T < 1 || P < PR_MINSUB || P > PR_SPAN
      || P % 2 != 0 || T % P != 0 || T > 0x7fffffff - PR_SPAN
      || (uintptr_t)y % 16 != 0 || (uintptr_t)yr % 16 != 0)
    return (int)cudaErrorInvalidValue;
  psi_recover_kernel<<<dim3(PR_CLUSTER, (unsigned)R), PR_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const float4*)y, (const float*)psi0, (float4*)yr, (float*)psi_last, T,
      P, mean_scale, inv_pi, pi);
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

int sdr_squelch_gate(int mode, const void* a, long long a_r, const void* b,
                     long long b_r, const void* x, long long x_r, void* y,
                     const void* wt, const void* thr, const void* avg0h,
                     const void* avg0l, const void* sup0, void* sups,
                     void* sup_last, void* avgh, void* avgl, int R, int T,
                     int H, float alpha, float gH, float hys, void* stream) {
  if (R < 1 || R > 65535 || H < SG_QUANT || H % SG_QUANT != 0 || T < H
      || T % H != 0 || T > 0x7fffffff - SG_SPAN || (uintptr_t)x % 16 != 0
      || x_r % 4 != 0 || (uintptr_t)y % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 1) {
    const dim3 grid((unsigned)((T + SG_TILE - 1) / SG_TILE), (unsigned)R);
    squelch_gate_kernel<1, 1><<<grid, SG_THREADS, 0, st>>>(
        (const float*)a, a_r, (const float*)b, b_r, (const float*)x, x_r,
        (float*)y, (const float4*)wt, (const float*)thr, (const float*)avg0h,
        (const float*)avg0l, (const unsigned char*)sup0, (unsigned char*)sups,
        (unsigned char*)sup_last, (float*)avgh, (float*)avgl, T, H, alpha, gH,
        hys);
    return (int)cudaGetLastError();
  }
  if (mode != 0 || H / SG_QUANT > SG_MAXQPH || (uintptr_t)a % 16 != 0
      || (uintptr_t)b % 16 != 0 || a_r % 4 != 0 || b_r % 4 != 0
      || (uintptr_t)wt % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // a cluster of SG_CLUSTER blocks a row, set at launch (mode 1 of the
  // same template runs without one)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SG_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SG_CLUSTER, (unsigned)R);
  cfg.blockDim = dim3(SG_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaErrorInvalidValue;
#define SDR_SQUELCH_GATE(QPH)                                               \
  e = cudaLaunchKernelEx(                                                  \
      &cfg, squelch_gate_kernel<0, QPH>, (const float*)a, a_r,             \
      (const float*)b, b_r, (const float*)x, x_r, (float*)y,               \
      (const float4*)wt, (const float*)thr, (const float*)avg0h,           \
      (const float*)avg0l, (const unsigned char*)sup0,                     \
      (unsigned char*)sups, (unsigned char*)sup_last, (float*)avgh,        \
      (float*)avgl, T, H, alpha, gH, hys)
  switch (H / SG_QUANT) {
    case 1: SDR_SQUELCH_GATE(1); break;
    case 2: SDR_SQUELCH_GATE(2); break;
    case 4: SDR_SQUELCH_GATE(4); break;
    case 8: SDR_SQUELCH_GATE(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_SQUELCH_GATE
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef SDR_STAMP
int sdr_stamp_buffer(void* p) {
  return (int)cudaMemcpyToSymbol(g_stamp, &p, sizeof(p));
}
int sdr_stamp_slots() { return SDR_NSTAMP; }
#endif

int sdr_squelch_quant() { return SG_QUANT; }
int sdr_squelch_span() { return SG_SPAN; }
int sdr_psi_maxsub() { return PSI_MAXSUB; }
int sdr_psi_span() { return PR_SPAN; }
int sdr_rl_span() { return RL_SPAN; }

}  // extern "C"
