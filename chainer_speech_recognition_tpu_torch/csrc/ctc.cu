// CTC alpha (forward + loss) and beta (backward + gradient) recursions.
//
// Replace ops/ctc_pallas.py::_fwd_kernel (:59) and ::_bwd_kernel (:101).
// Same boundary as the TPU kernels' custom VJP, without their (8, 128)
// padding (a Mosaic rule): lp_ext [B, T, S] fp32 emissions of the extended
// label sequence (b l1 b l2 ... lL b, S = 2L_max + 1), allow2 [B, S] fp32
// (1 where the skip transition s-2 -> s is allowed), t_len / lab_len [B]
// int32. A state s is valid for utterance b iff s < 2 lab_len[b] + 1.
//
//   forward:  alphas [B, T, S] fp32 (alpha after each frame; rows frozen for
//             t >= t_len), loss [B] = -lse(alpha[2L], alpha[2L-1]).
//   backward: grad [B, T, S] = -g exp(min(alpha + beta - lp + loss, 0)),
//             zero for t >= t_len and invalid s; beta is initialised at
//             t == t_len - 1 (the last two states take lp).
//
// All math is fp32 with LOG_ZERO = -1e30 and ctc_jax._logsumexp3's clamps
// kept exactly (max clamped to LOG_ZERO/2, the sum clamped to 1e-37, and a
// result <= LOG_ZERO/2 snapped to LOG_ZERO), so the sentinel arithmetic of
// impossible samples matches the reference; expf / logf, the order of the
// three terms and of every sum are those of the plain recursions, so the
// outputs are bitwise those of ops/ctc.py.
//
// What bounds it on Hopper: the dependency over T. The bytes (lp + alphas,
// ~12.6 MB at B=24, T=256, S=257) would take ~4 us at HBM rate (3.2 and
// 4.4 us for what the training shape's live frames and states need), but
// each frame waits on the one before: a step costs one lse3 chain (three
// expf, one logf) for each of a thread's states, the shuffles, and the
// staging of the next rows; the warps' edge states cross every few
// frames. Measured on an NVIDIA H100 80GB HBM3 (700 W; PERF.md rows 9-10):
// about 0.26 us a step forward and 0.30 us backward at the training shape,
// where the first version took 0.45 and 0.55.
//
// Design ("lanes" kernels, S <= kMaxWarps * kOwn): one block owns one
// utterance and walks its live frames.
// - The wavefront lives in registers: a thread holds kStates consecutive
//   states; the forward's s-1, s-2 come from the lane below by
//   __shfl_up_sync, the backward's s+1, s+2 from the lane above by
//   __shfl_down_sync. A warp owns kOwn states and also computes the kHalo
//   next to them (below them forward, above them backward); every
//   kExchange frames the neighbouring warp's values replace that halo,
//   through shared memory under one named barrier of the utterance's live
//   warps. With one live warp a step has no barrier at all.
// - Emissions (and in the backward alphas) do not depend on the recursion:
//   each thread copies its own states of frame t + kRing - 1 into a ring of
//   kRing slots by 4-byte cp.async while frame t computes (rows are only
//   4-byte aligned: S * 4 bytes with S odd). A slot holds kStates columns
//   for each thread, not one for each state: a halo state's lp is staged
//   twice, by the halo lane and by its owner, each into its own columns.
//   So a step reads only shared memory its own thread filled, a column is
//   refilled only by the thread that read it and after it read it, and the
//   thread's cp.async.wait_group is all the ordering the ring needs: the
//   warps may drift apart by up to kExchange - 1 frames between exchanges.
// - Every state computes and then selects, without a branch, so a thread's
//   kStates lse3 chains interleave.
// - Only live work enters the recursion: the forward stops at t_len, the
//   backward starts at t_len - 1; warps whose own states all lie at or
//   past 2 lab_len + 1 never enter it. Each thread writes its own columns
//   of the frozen alpha rows and zero gradient rows (all rows, for a warp
//   that never entered the recursion) while the others run.
// Above that S the "wide" kernels (the first version: the wavefront in
// shared memory, threads striding over the states, every frame to T, one
// barrier a step) take the utterance, up to the 227 KB of a block.
#include <math.h>

#include "common.cuh"

namespace {

constexpr float kLogZero = -1e30f;
constexpr int kStates = 2;      // states a thread
constexpr int kRing = 8;        // frames in the ring, kRing - 1 ahead
constexpr int kMaxWarps = 16;   // warps an utterance
constexpr int kWideThreads = 512;
// A warp's first (forward) or last (backward) kHaloLanes lanes hold the
// kHalo states next to its own, which the neighbouring warp owns. The
// recursion reaches 2 states further each frame, so recomputed locally
// they stay exact for kExchange frames; then the neighbour's values
// replace them, through shared memory under one barrier.
constexpr int kHaloLanes = 4;
constexpr int kHalo = kHaloLanes * kStates;
constexpr int kExchange = kHalo / 2;
constexpr int kOwn = (32 - kHaloLanes) * kStates;   // a warp's own states
// the halo values exchanged, [2][kMaxWarps][kHalo] floats
constexpr int kExchangeFloats = 2 * kMaxWarps * kHalo;
constexpr size_t kSmemLimit = 227 * 1024;   // what a block may take

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float m_safe = fmaxf(m, kLogZero / 2);
  const float se = expf(a - m_safe) + expf(b - m_safe) + expf(c - m_safe);
  const float out = m_safe + logf(fmaxf(se, 1e-37f));
  return m <= kLogZero / 2 ? kLogZero : out;
}

__device__ __forceinline__ uint32_t smem_addr(const float* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the live warps of one utterance meet (barrier 1; __syncthreads is 0)
__device__ __forceinline__ void utterance_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// copy this thread's states [lo, n) of its K in one row (those at or
// above state 0 and below 2 lab_len + 1) from `src` to the shared address
// `dst`
template <int K>
__device__ __forceinline__ void stage(uint32_t dst, const float* src, int lo,
                                      int n) {
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (j >= lo && j < n) cp_async4(dst + 4 * j, src + j);
}

// The launch bound's second argument (one block an SM) lets ptxas give a
// thread the registers to interleave its K lse3 chains: with the default
// budget it ran them one after another (PERF.md, rows 9-10).
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    ctc_fwd_lanes_kernel(const float* __restrict__ lp,
                         const float* __restrict__ allow2,
                         const int* __restrict__ t_len,
                         const int* __restrict__ lab_len,
                         float* __restrict__ alphas,
                         float* __restrict__ loss, int T, int S) {
  constexpr int K = kStates;
  extern __shared__ float sh[];
  const int slot = blockDim.x * K;        // a ring slot: K floats a thread
  float* ring = sh;                       // [kRing][threads][K] lp
  float* fin = ring + kRing * slot;       // [S] the last live row
  float* xbuf = fin + S;                  // [2][kMaxWarps][kHalo]
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tl = min(t_len[b], T);
  const int L = lab_len[b];
  const int s_valid = 2 * L + 1;
  // lanes [0, kHaloLanes): the halo below the warp's own states
  const int s0 = warp * kOwn + (lane - kHaloLanes) * K;
  const bool own = lane >= kHaloLanes;
  const int live_warps = min((s_valid + kOwn - 1) / kOwn,
                             static_cast<int>(blockDim.x >> 5));
  const float* lpb = lp + static_cast<int64_t>(b) * T * S + s0;
  float* col = alphas + static_cast<int64_t>(b) * T * S + s0;

  float a[K];
#pragma unroll
  for (int j = 0; j < K; ++j) a[j] = kLogZero;
  int t_frozen = 0;                       // rows [t_frozen, T) hold a
  if (warp < live_warps) {
    const int threads = live_warps * 32;
    unsigned skip = 0;                    // bit j: s0 + j - 2 -> s0 + j
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = s0 + j;
      if (s >= 2 && s < S && allow2[static_cast<int64_t>(b) * S + s] > 0.5f)
        skip |= 1u << j;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = s0 + j;
      const bool init = s == 0 || (s == 1 && L > 0);
      if (init && s < s_valid) a[j] = lpb[j];
      if (own && s < S) col[j] = a[j];
    }
    // the ring: this thread's states of frame r at ring[r % kRing][tid]
    const uint32_t ring0 = smem_addr(ring + tid * K);
    const int lo = -s0, n = s_valid - s0;
    for (int r = 1; r < kRing; ++r) {     // frames 1 .. kRing - 1
      if (r < tl)
        stage<K>(ring0 + 4 * r * slot, lpb + static_cast<int64_t>(r) * S, lo,
                 n);
      cp_async_commit();
    }
    const float* ahead = lpb + static_cast<int64_t>(kRing) * S;
    for (int t = 1; t < tl; ++t) {
      cp_async_wait<kRing - 2>();         // this thread's copy of frame t
      if (t > 1 && (t - 1) % kExchange == 0 && threads > 32) {
        utterance_sync(threads);          // the halo of frame t - 1
        if (!own && warp > 0) {
          const float* x =
              xbuf + ((((t - 1) / kExchange) & 1) * kMaxWarps + warp - 1) *
                         kHalo + lane * K;
#pragma unroll
          for (int j = 0; j < K; ++j) a[j] = x[j];
        }
      }
      // lane 0's states below the halo: not needed exactly (above)
      float up1 = __shfl_up_sync(0xffffffffu, a[K - 1], 1);
      float up2 = __shfl_up_sync(0xffffffffu, a[K - 2], 1);
      if (lane == 0) up1 = up2 = kLogZero;
      // every state computes and selects, without a branch, so a
      // thread's K chains interleave (the first warp's halo, below state
      // 0, is LOG_ZERO)
      const float* row = ring + (t % kRing) * slot + tid * K;
      float nx[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float sh1 = j >= 1 ? a[j - 1] : up1;
        const float sh2 = (skip >> j) & 1u
                              ? (j >= 2 ? a[j - 2] : j == 1 ? up1 : up2)
                              : kLogZero;
        const float v = lse3(a[j], sh1, sh2) + row[j];
        nx[j] = static_cast<unsigned>(s0 + j) < static_cast<unsigned>(s_valid)
                    ? v
                    : kLogZero;
      }
      col += S;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        a[j] = nx[j];
        if (own && s0 + j < S) col[j] = a[j];
      }
      if (t % kExchange == 0 && lane >= 32 - kHaloLanes && threads > 32) {
        float* x = xbuf + (((t / kExchange) & 1) * kMaxWarps + warp) * kHalo +
                   (lane - (32 - kHaloLanes)) * K;
#pragma unroll
        for (int j = 0; j < K; ++j) x[j] = a[j];
      }
      // frame t + kRing - 1 into the slot of frame t - 1, whose values this
      // thread has consumed
      if (t + kRing - 1 < tl)
        stage<K>(ring0 + 4 * ((t + kRing - 1) % kRing) * slot, ahead, lo, n);
      cp_async_commit();
      ahead += S;
    }
    cp_async_wait<0>();
    t_frozen = max(tl, 1);
    col += S;
  }
  // this thread's own columns past the recursion: the last live values (or
  // LOG_ZERO, for a warp that never entered it), while the others run
  if (own) {
    for (int t = t_frozen; t < T; ++t, col += S) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (s0 + j < S) col[j] = a[j];
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (s0 + j < S) fin[s0 + j] = a[j];
  }
  __syncthreads();
  if (tid == 0) {
    const float last = fin[2 * L];
    const float prev = L > 0 ? fin[2 * L - 1] : kLogZero;
    loss[b] = -lse3(last, prev, kLogZero);
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    ctc_bwd_lanes_kernel(const float* __restrict__ lp,
                         const float* __restrict__ allow2,
                         const int* __restrict__ t_len,
                         const int* __restrict__ lab_len,
                         const float* __restrict__ alphas,
                         const float* __restrict__ loss,
                         const float* __restrict__ g,
                         float* __restrict__ grad, int T, int S) {
  constexpr int K = kStates;
  extern __shared__ float sh[];
  const int slot = blockDim.x * K;        // a ring slot: K floats a thread
  float* lring = sh;                      // [kRing][threads][K] lp
  float* aring = lring + kRing * slot;    // [kRing][threads][K] alphas
  float* xbuf = aring + kRing * slot;     // [2][kMaxWarps][kHalo]
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tl = min(t_len[b], T);
  const int L = lab_len[b];
  const int s_valid = 2 * L + 1;
  // lanes [32 - kHaloLanes, 32): the halo above the warp's own states
  const int s0 = warp * kOwn + lane * K;
  const bool own = lane < 32 - kHaloLanes;
  const int live_warps = min((s_valid + kOwn - 1) / kOwn,
                             static_cast<int>(blockDim.x >> 5));
  const float gb = g[b];
  const float logp = -loss[b];
  const int64_t base = static_cast<int64_t>(b) * T * S + s0;
  float* col = grad + base;

  int t_zero = 0;                         // rows [t_zero, T) are zero
  if (warp < live_warps && tl > 0) {
    const int threads = live_warps * 32;
    unsigned skip = 0;                    // bit j: s0 + j + 2 -> s0 + j
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = s0 + j;
      if (s + 2 < S && allow2[static_cast<int64_t>(b) * S + s + 2] > 0.5f)
        skip |= 1u << j;
    }
    // step i computes frame t = t_len - 1 - i from ring slot i % kRing
    const uint32_t lring0 = smem_addr(lring + tid * K);
    const uint32_t aring0 = smem_addr(aring + tid * K);
    const int n = s_valid - s0;
    const float* lpf = lp + base + static_cast<int64_t>(tl - 1) * S;
    const float* af = alphas + base + static_cast<int64_t>(tl - 1) * S;
    for (int i = 0; i < kRing - 1; ++i) {
      if (i < tl) {
        stage<K>(lring0 + 4 * i * slot, lpf - static_cast<int64_t>(i) * S, 0,
                 n);
        stage<K>(aring0 + 4 * i * slot, af - static_cast<int64_t>(i) * S, 0, n);
      }
      cp_async_commit();
    }
    lpf -= static_cast<int64_t>(kRing - 1) * S;
    af -= static_cast<int64_t>(kRing - 1) * S;
    col += static_cast<int64_t>(tl - 1) * S;
    float bt[K];
#pragma unroll
    for (int j = 0; j < K; ++j) bt[j] = kLogZero;
    for (int i = 0; i < tl; ++i) {
      cp_async_wait<kRing - 2>();         // this thread's copies of step i
      if (i > 1 && (i - 1) % kExchange == 0 && threads > 32) {
        utterance_sync(threads);          // the halo of step i - 1
        if (!own && warp + 1 < live_warps) {
          const float* x =
              xbuf + ((((i - 1) / kExchange) & 1) * kMaxWarps + warp + 1) *
                         kHalo + (lane - (32 - kHaloLanes)) * K;
#pragma unroll
          for (int j = 0; j < K; ++j) bt[j] = x[j];
        }
      }
      // lane 31's states above the halo: not needed exactly (above)
      float dn1 = __shfl_down_sync(0xffffffffu, bt[0], 1);
      float dn2 = __shfl_down_sync(0xffffffffu, bt[1], 1);
      if (lane == 31) dn1 = dn2 = kLogZero;
      const float* lrow = lring + (i % kRing) * slot + tid * K;
      const float* arow = aring + (i % kRing) * slot + tid * K;
      float nx[K], gv[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int s = s0 + j;
        const float lpv = lrow[j];
        const float sh1 = j + 1 < K ? bt[j + 1] : dn1;
        const float sh2 = (skip >> j) & 1u
                              ? (j + 2 < K ? bt[j + 2]
                                 : j + 2 == K ? dn1 : dn2)
                              : kLogZero;
        const bool init = s == 2 * L || (s == 2 * L - 1 && L > 0);
        // every state computes its recursion and its exp and only then
        // selects (the empty asm keeps the compiler from sinking either
        // into a branch), so a thread's K chains interleave
        float rec = lse3(bt[j], sh1, sh2) + lpv;
        asm volatile("" : "+f"(rec));
        float v = i == 0 ? (init ? lpv : kLogZero) : rec;
        v = s < s_valid ? v : kLogZero;
        const float post = arow[j] + v - lpv - logp;
        float ex = expf(fminf(post, 0.0f));
        asm volatile("" : "+f"(ex));
        gv[j] = s < s_valid ? -ex * gb : 0.0f;
        nx[j] = v;
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        bt[j] = nx[j];
        if (own && s0 + j < S) col[j] = gv[j];
      }
      if (i > 0 && i % kExchange == 0 && lane < kHaloLanes && threads > 32) {
        float* x = xbuf + (((i / kExchange) & 1) * kMaxWarps + warp) * kHalo +
                   lane * K;
#pragma unroll
        for (int j = 0; j < K; ++j) x[j] = bt[j];
      }
      // step i + kRing - 1 into the slot of step i - 1, whose values this
      // thread has consumed
      if (i + kRing - 1 < tl) {
        const int at = 4 * ((i + kRing - 1) % kRing) * slot;
        stage<K>(lring0 + at, lpf, 0, n);
        stage<K>(aring0 + at, af, 0, n);
      }
      cp_async_commit();
      lpf -= S;
      af -= S;
      col -= S;
    }
    cp_async_wait<0>();
    t_zero = tl;
    col = grad + base + static_cast<int64_t>(tl) * S;
  }
  // this thread's own columns past the recursion (every row, for a warp
  // that never entered it) are zero, written while the others run
  if (own) {
    for (int t = t_zero; t < T; ++t, col += S) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (s0 + j < S) col[j] = 0.0f;
    }
  }
}

// The wide kernels (S past the lanes kernels' reach): the wavefront in
// shared memory, double-buffered, thread i on states i, i + blockDim, ...;
// every frame up to T, one barrier a step.
__global__ void ctc_fwd_wide_kernel(const float* __restrict__ lp,
                                    const float* __restrict__ allow2,
                                    const int* __restrict__ t_len,
                                    const int* __restrict__ lab_len,
                                    float* __restrict__ alphas,
                                    float* __restrict__ loss, int T, int S) {
  extern __shared__ float sh[];  // [2][S] alpha wavefront
  const int b = blockIdx.x;
  const int tl = t_len[b];
  const int L = lab_len[b];
  const int s_valid = 2 * L + 1;
  const float* lpb = lp + static_cast<int64_t>(b) * T * S;
  const float* a2 = allow2 + static_cast<int64_t>(b) * S;
  float* ab = alphas + static_cast<int64_t>(b) * T * S;

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const bool init = s == 0 || (s == 1 && L > 0);
    const float v = (init && s < s_valid) ? lpb[s] : kLogZero;
    sh[s] = v;
    ab[s] = v;
  }
  __syncthreads();
  int cur = 0;
  for (int t = 1; t < T; ++t) {
    const float* a = sh + cur * S;
    float* nxt = sh + (cur ^ 1) * S;
    const float* lpt = lpb + static_cast<int64_t>(t) * S;
    const bool alive = t < tl;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float stay = a[s];
      float v = stay;
      if (alive) {
        const float sh1 = s >= 1 ? a[s - 1] : kLogZero;
        const float sh2 = (s >= 2 && a2[s] > 0.5f) ? a[s - 2] : kLogZero;
        v = s < s_valid ? lse3(stay, sh1, sh2) + lpt[s] : kLogZero;
      }
      nxt[s] = v;
      ab[static_cast<int64_t>(t) * S + s] = v;
    }
    __syncthreads();
    cur ^= 1;
  }
  if (threadIdx.x == 0) {
    const float* a = sh + cur * S;
    const float last = a[2 * L];
    const float prev = L > 0 ? a[2 * L - 1] : kLogZero;
    loss[b] = -lse3(last, prev, kLogZero);
  }
}

__global__ void ctc_bwd_wide_kernel(const float* __restrict__ lp,
                                    const float* __restrict__ allow2,
                                    const int* __restrict__ t_len,
                                    const int* __restrict__ lab_len,
                                    const float* __restrict__ alphas,
                                    const float* __restrict__ loss,
                                    const float* __restrict__ g,
                                    float* __restrict__ grad, int T, int S) {
  extern __shared__ float sh[];  // [2][S] beta wavefront
  const int b = blockIdx.x;
  const int tl = t_len[b];
  const int L = lab_len[b];
  const int s_valid = 2 * L + 1;
  const float gb = g[b];
  const float logp = -loss[b];
  const float* lpb = lp + static_cast<int64_t>(b) * T * S;
  const float* a2 = allow2 + static_cast<int64_t>(b) * S;
  const float* ab = alphas + static_cast<int64_t>(b) * T * S;
  float* gr = grad + static_cast<int64_t>(b) * T * S;

  for (int s = threadIdx.x; s < S; s += blockDim.x) sh[s] = kLogZero;
  __syncthreads();
  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    const float* bp = sh + cur * S;
    float* nxt = sh + (cur ^ 1) * S;
    const int64_t row = static_cast<int64_t>(t) * S;
    const bool inside = t < tl;
    const bool at_init = tl == t + 1;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float v = kLogZero;
      float gv = 0.0f;
      if (s < s_valid) {
        const float lpv = lpb[row + s];
        if (at_init) {
          const bool init = s == 2 * L || (s == 2 * L - 1 && L > 0);
          v = init ? lpv : kLogZero;
        } else if (inside) {
          const float sh1 = s + 1 < S ? bp[s + 1] : kLogZero;
          const float sh2 =
              (s + 2 < S && a2[s + 2] > 0.5f) ? bp[s + 2] : kLogZero;
          v = lse3(bp[s], sh1, sh2) + lpv;
        } else {
          v = bp[s];
        }
        if (inside) {
          const float post = ab[row + s] + v - lpv - logp;
          gv = -expf(fminf(post, 0.0f)) * gb;
        }
      }
      nxt[s] = v;
      gr[row + s] = gv;
    }
    __syncthreads();
    cur ^= 1;
  }
}

cudaError_t set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The launch shape for S extended states: the lanes kernels (kStates
// states a thread, warps of kOwn own states) up to kMaxWarps warps, the
// wide kernels above; `states` 0 means the wide kernels.
struct Plan {
  int states, warps;
  size_t smem;                            // dynamic shared memory, bytes
};

Plan plan_for(int S, bool bwd) {
  const int warps = (S + kOwn - 1) / kOwn;
  if (warps <= kMaxWarps) {
    // the rings (lp, and in the backward alphas), the forward's last row,
    // the halo exchange
    const size_t floats =
        static_cast<size_t>(bwd ? 2 : 1) * kRing * warps * 32 * kStates +
        (bwd ? 0 : S) + kExchangeFloats;
    return {kStates, warps, floats * sizeof(float)};
  }
  return {0, min((S + 31) / 32, kWideThreads / 32),
          2 * static_cast<size_t>(S) * sizeof(float)};
}

}  // namespace

// The plan csr_ctc_fwd (bwd 0) or csr_ctc_bwd (bwd 1) launches for S
// extended states: out = (states a thread, 0 for the wide kernels; warps
// a block; shared memory bytes a block). cudaErrorInvalidValue past what a
// block may take.
CSR_API int csr_ctc_plan(int S, int bwd, int* out) {
  if (S < 1) return cudaErrorInvalidValue;
  const Plan p = plan_for(S, bwd != 0);
  if (p.smem > kSmemLimit) return cudaErrorInvalidValue;
  out[0] = p.states;
  out[1] = p.warps;
  out[2] = static_cast<int>(p.smem);
  return cudaSuccess;
}

// lp [B, T, S], allow2 [B, S] fp32; t_len, lab_len [B] int32 (t_len <= T,
// 2 lab_len + 1 <= S: the wrapper clamps and checks); alphas [B, T, S] and
// loss [B] fp32 out. B, T, S >= 1.
CSR_API int csr_ctc_fwd(const float* lp, const float* allow2,
                        const int* t_len, const int* lab_len, float* alphas,
                        float* loss, int B, int T, int S,
                        cudaStream_t stream) {
  const Plan p = plan_for(S, false);
  if (p.smem > kSmemLimit) return cudaErrorInvalidValue;
  const void* fn = p.states == 0
                       ? reinterpret_cast<const void*>(ctc_fwd_wide_kernel)
                       : reinterpret_cast<const void*>(ctc_fwd_lanes_kernel);
  const cudaError_t err = set_smem(fn, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.states == 0)
    ctc_fwd_wide_kernel<<<B, p.warps * 32, p.smem, stream>>>(
        lp, allow2, t_len, lab_len, alphas, loss, T, S);
  else
    ctc_fwd_lanes_kernel<<<B, p.warps * 32, p.smem, stream>>>(
        lp, allow2, t_len, lab_len, alphas, loss, T, S);
  CSR_RETURN_LAUNCH_STATUS();
}

// As csr_ctc_fwd's inputs plus alphas and loss from it and g [B] (the
// upstream gradient, already zero for samples without an alignment);
// grad [B, T, S] fp32 out.
CSR_API int csr_ctc_bwd(const float* lp, const float* allow2,
                        const int* t_len, const int* lab_len,
                        const float* alphas, const float* loss,
                        const float* g, float* grad, int B, int T, int S,
                        cudaStream_t stream) {
  const Plan p = plan_for(S, true);
  if (p.smem > kSmemLimit) return cudaErrorInvalidValue;
  const void* fn = p.states == 0
                       ? reinterpret_cast<const void*>(ctc_bwd_wide_kernel)
                       : reinterpret_cast<const void*>(ctc_bwd_lanes_kernel);
  const cudaError_t err = set_smem(fn, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.states == 0)
    ctc_bwd_wide_kernel<<<B, p.warps * 32, p.smem, stream>>>(
        lp, allow2, t_len, lab_len, alphas, loss, g, grad, T, S);
  else
    ctc_bwd_lanes_kernel<<<B, p.warps * 32, p.smem, stream>>>(
        lp, allow2, t_len, lab_len, alphas, loss, g, grad, T, S);
  CSR_RETURN_LAUNCH_STATUS();
}
