// CTC prefix beam search with n-gram LM shallow fusion, one launch a chunk.
//
// Replaces no Pallas kernel: the reference's beam is one jitted lax.scan of
// decode/beam.py::_beam_step (:342) inside _beam_decode_jit (:532) and
// _beam_chunk_jit (:683), with its traceback on the device. Ported as
// plain tensor code a frame is ~60 small ops, ~15,000 launches for a
// 32-utterance batch at T' = 251; here the scan of a whole batch (or of one
// streaming chunk), the final ordering and the traceback are one launch.
// The plain version is decode/beam.py::beam_chunk_plain; this kernel
// computes the same function:
//
//   state [B, K] (pb, pnb fp32; hashes, hashes2, phashes, phashes2, last
//   int32; ctx [B, K, ctx_len] int32) is scanned over lp [B, T, V] fp32
//   log-probs (log_softmax is torch's, before the launch); frames t >=
//   lengths[b] freeze the row. Then `keep` beams are traced back — the
//   best-first order of the final scores (`ordered`: offline decoding) or
//   beams 0..keep-1 in place (a streaming chunk) — into chars [B, keep,
//   width] (the first `width` emissions in time order, -1 pads), counts
//   [B, keep] (clamped to width) and parent0 [B, keep] (the beam at frame
//   0); final [B, K] (sorted when `ordered`) and the new state are written.
//
// Exactness. The top-K is jax.lax.top_k's: descending score, the lower flat
// index (stays 0..K-1, then extension (j, v) at K + j V + v) first on ties;
// ties are real, since while fewer than K beams live many candidates sit at
// exactly LOG_ZERO. The rolling hashes ((h mod M) * MULT + c) mod M and the
// hashed LM's keys (h1 V + c, (h2 MULT2 + c) mod M2, uint32(key1) *
// 2654435761 & mask) are int32 arithmetic that wraps, with floor modulo, in
// the reference: they are computed here in uint32 with the floor modulo
// written out (signed overflow is undefined in C++ and % truncates). Every
// fp32 expression keeps the plain version's order of operations, with
// __fmul_rn / __fadd_rn where nvcc would otherwise contract to an FMA, and
// logaddexp is torch's own formula (max + log1p(exp(-|a - b|))).
//
// What bounds it on Hopper: the chain of dependent frames, not the bytes.
// A batch reads lp once (32 x 251 x 64 x 4 B = 2 MB at bigru: ~0.6 us at
// HBM rate) and the LM rows its hypotheses touch; each frame waits for the
// last one's top-K, and a frame is a few dependent steps with a block
// barrier between each.
//
// Two forms, one block per utterance row in both; csr_beam_plan picks one.
//
// The narrow form (beam_kernel: K <= 32 and an LM context of <= 8 lanes,
// order <= 9), kThreads threads, the [K] beam state in static shared memory
// (two copies, flipped each frame). Per frame:
//   1. the next frame's lp row is staged into shared memory by 4-byte
//      cp.async while this one computes (double-buffered; rows past
//      kStageMaxV symbols are read from global memory instead);
//   2. K threads: each beam's total, stay scores, lp[last], and its LM
//      row (dense: the positional fold of the context; hashed: probe L.P
//      slots longest level first, exactly beam.py:369-405);
//   3. K threads: stay k's merge with the matching extensions (the double
//      hash of its parent prefix against every beam's, a loop over K), the
//      merged stay_pnb, and the consumed extensions (j, last_k) noted per
//      parent j;
//   4. the block scans the K + K.V candidates without storing the grid;
//      each thread keeps a sorted top-KMAX list of its own in registers,
//      then K rounds of a warp argmax (score, then index) merge a warp's
//      lists, and warp 0 merges the warps' lists the same way;
//   5. K threads write the new state and the traceback (parent, char) of
//      frame t (shared memory when the chunk's tracebacks fit, else the
//      scratch in global memory).
// After the frames, `keep` threads follow the parent chains back from the
// live frames' end (twice: count, then write) into the outputs.
//
// The wide form (beam_wide_kernel: any other K <= 32767 and any context
// length), kWideThreads threads. Its per-frame steps loop k += blockDim.x,
// and everything that grows with K or the context (the state's two copies,
// the context lanes, the per-beam scratch, the merge lists, the survivors)
// lives in one workspace (wide_layout) that csr_beam_plan places in dynamic
// shared memory when it fits beside the staged lp rows, else in a [B, bytes]
// scratch in global memory; the tracebacks follow as in the narrow form.
// Steps 1, 2 and 5 are the narrow form's; 3 and 4 differ:
//   3. the consumed extensions are kept as lists per hash class: stay k
//      with last_k > 0 joins (atomicExch, a linked list through next[]) the
//      list of the lowest beam j whose (hash, hash2) equals its parent
//      hashes; extension (j, v) is consumed when v is the last char of a
//      beam on the list of j's class (rep[j]: the lowest beam with j's
//      hashes). The lists hold at most K entries whatever K is;
//   4. top-K by a radix select: each candidate's score maps to an
//      order-preserving uint32 key (-0 as +0, so a float compare's ties
//      stay ties); four passes of 8 bits, each a sweep that recomputes
//      the candidates (nothing of the K + K.V grid is stored) into a
//      256-bin shared histogram (warp-aggregated atomics), then one warp
//      finds the digit that holds the K-th key. Then one sweep keeps every
//      key above the threshold (atomic slots) and, when the threshold's
//      ties outnumber what is left, a second sweep ranks those ties in
//      ascending flat index (each warp owns a contiguous index range, so
//      ballots and the warps' counts give the order); a bitonic sort of
//      the K survivors by (key descending, index ascending) gives
//      lax.top_k's order. The final order sorts the K final scores the
//      same way.
// Traceback entries pack (parent << 16) | (char & 0xffff), so the wide form
// takes K <= 32767 (and V <= 32767, the reference's own limit).
#include <cuda_fp16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBeam = 32;            // one lane a beam in the merges
constexpr int kMaxCtx = 8;              // LM order <= 9
constexpr int kStageMaxV = 12288;       // 2 staged rows: 96 KB
constexpr int kSharedBudget = 200 * 1024;
constexpr float kLogZero = -1.0e30f;
constexpr float kHalfLogZero = -5.0e29f;
constexpr int kHashMult = 1000003;
constexpr int kHashMod = (1 << 30) - 35;
constexpr int kHashMult2 = 754877;
constexpr int kHashMod2 = (1 << 30) - 173;
constexpr int kCtxMult2 = 754877;       // decode/lm.py _CTX_MULT2
constexpr int kCtxMod2 = (1 << 30) - 173;
constexpr uint32_t kSlotMult = 2654435761u;
constexpr int kWideThreads = 512;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kRadixBins = 256;         // 8 bits a pass, 4 passes
constexpr int kMaxWideBeam = 32767;     // (parent << 16) | char tracebacks

}  // namespace

// The launch's arguments (ops/beam_cuda.BeamArgs mirrors this layout).
struct BeamArgs {
  const float* lp;           // [B, T, V] fp32 log-probs
  const int32_t* lengths;    // [B] live frames (clamped to [0, T])
  const float* pb_in;        // state [B, K] ...
  const float* pnb_in;
  const int32_t* h_in;
  const int32_t* h2_in;
  const int32_t* ph_in;
  const int32_t* ph2_in;
  const int32_t* last_in;
  const int32_t* ctx_in;     // [B, K, ctx_len]
  float* pb_out;             // the new state, same shapes (may alias in)
  float* pnb_out;
  int32_t* h_out;
  int32_t* h2_out;
  int32_t* ph_out;
  int32_t* ph2_out;
  int32_t* last_out;
  int32_t* ctx_out;
  const void* lm_table;      // dense [C, V] fp32 | hashed [cap, 3] int32
  const void* lm_rows;       // hashed [R, V] fp32 or fp16
  int32_t* tb_scratch;       // [B, T, K] when the tracebacks pass shared mem
  void* ws_scratch;          // [B, ws bytes]: the wide form's workspace when
                             // it passes shared memory
  int32_t* out_chars;        // [B, keep, width]
  int32_t* out_counts;       // [B, keep]
  int32_t* out_parent0;      // [B, keep]
  float* out_final;          // [B, K]
  int B, T, V, K, ctx_len;
  int lm_kind;               // 0 none, 1 dense, 2 hashed
  int lm_order, rows_fp16, cap, probes;
  float alpha, beta;
  int keep, width, ordered;
};

namespace {

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// ((h mod m) * mult + c) mod m in wrapping int32 with floor modulo
__device__ __forceinline__ int roll(int h, int c, int mult, int m) {
  const uint32_t a = static_cast<uint32_t>(floor_mod(h, m));
  const int x = static_cast<int>(a * static_cast<uint32_t>(mult) +
                                 static_cast<uint32_t>(c));
  return floor_mod(x, m);
}

// torch.logaddexp's formula
__device__ __forceinline__ float lae(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
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

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct BeamShared {
  float pb[2][kMaxBeam], pnb[2][kMaxBeam];
  int h[2][kMaxBeam], h2[2][kMaxBeam], ph[2][kMaxBeam], ph2[2][kMaxBeam];
  int last[2][kMaxBeam];
  int ctx[2][kMaxBeam][kMaxCtx];
  float total[kMaxBeam], spb[kMaxBeam], spnb[kMaxBeam], stay[kMaxBeam];
  long long roff[kMaxBeam];          // LM row offset (elements), per beam
  int ncons[kMaxBeam];               // consumed extensions of parent j
  int cons[kMaxBeam][kMaxBeam];      // ... their chars
  float wscore[kWarps][kMaxBeam];
  int widx[kWarps][kMaxBeam];
  float tscore[kMaxBeam];
  int tidx[kMaxBeam];
  float fin[kMaxBeam];
  int order[kMaxBeam];
};

// score of extension (j, v) before consumption: base + lp[v] (+ LM)
__device__ __forceinline__ float ext_raw(const BeamArgs& a, const float* lpr,
                                         float pb_j, float total_j,
                                         int last_j, long long roff_j,
                                         int v) {
  const float base = v == last_j ? pb_j : total_j;
  float s = base + lpr[v];
  if (a.lm_kind != 0) {
    float r;
    if (a.lm_kind == 1)
      r = static_cast<const float*>(a.lm_table)[roff_j + v];
    else if (a.rows_fp16)
      r = __half2float(static_cast<const __half*>(a.lm_rows)[roff_j + v]);
    else
      r = static_cast<const float*>(a.lm_rows)[roff_j + v];
    s = __fadd_rn(__fadd_rn(s, __fmul_rn(a.alpha, r)), a.beta);
  }
  return v == 0 ? kLogZero : s;
}

// the LM row of a context window (oldest char first)
__device__ long long lm_row_offset(const BeamArgs& a, const int* ctx) {
  const int V = a.V;
  if (a.lm_kind == 1) {
    long long cid = 0;
    if (a.lm_order > 1) {
      cid = ctx[0];
      for (int lane = 1; lane < a.lm_order - 1; ++lane)
        cid = cid * V + ctx[lane];
    }
    return cid * V;
  }
  // hashed: longest level first, the first level that hits owns the row
  const int L = a.lm_order - 1;
  const int32_t* table = static_cast<const int32_t*>(a.lm_table);
  const uint32_t mask = static_cast<uint32_t>(a.cap - 1);
  for (int lev = L; lev >= 1; --lev) {
    uint32_t h1 = 0;
    int h2 = 0;
    for (int lane = L - lev; lane < L; ++lane) {
      const uint32_t c = static_cast<uint32_t>(ctx[lane]);
      h1 = h1 * static_cast<uint32_t>(V) + c;
      h2 = floor_mod(static_cast<int>(static_cast<uint32_t>(h2) *
                                          static_cast<uint32_t>(kCtxMult2) +
                                      c),
                     kCtxMod2);
    }
    const int k1 = static_cast<int>(h1);
    if (k1 == 0 && h2 == 0) continue;
    const uint32_t slot0 = (h1 * kSlotMult) & mask;
    for (int p = 0; p < a.probes; ++p) {
      const uint32_t s = (slot0 + static_cast<uint32_t>(p)) & mask;
      if (table[3 * s] == k1 && table[3 * s + 1] == h2)
        return static_cast<long long>(table[3 * s + 2]) * V;
    }
  }
  return 0;
}

template <int KMAX>
__device__ __forceinline__ void insert(float (&ls)[KMAX], int (&li)[KMAX],
                                       float s, int i) {
  if (!better(s, i, ls[KMAX - 1], li[KMAX - 1])) return;
#pragma unroll
  for (int q = KMAX - 1; q > 0; --q) {
    if (better(s, i, ls[q - 1], li[q - 1])) {
      ls[q] = ls[q - 1];
      li[q] = li[q - 1];
    } else if (better(s, i, ls[q], li[q])) {
      ls[q] = s;
      li[q] = i;
    }
  }
  if (better(s, i, ls[0], li[0])) {
    ls[0] = s;
    li[0] = i;
  }
}

// warp argbest of (s, i) by score, then lower index
__device__ __forceinline__ void warp_best(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, s, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

template <int KMAX, bool kStage>
__global__ void __launch_bounds__(kThreads)
    beam_kernel(const BeamArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ BeamShared sh;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int T = a.T, V = a.V, K = a.K, CL = a.ctx_len;
  const int n = min(max(a.lengths[b], 0), T);
  const int NC = K + K * V;
  float* s_lp = reinterpret_cast<float*>(dyn);                  // [2][V]
  int32_t* tb = a.tb_scratch != nullptr
                    ? a.tb_scratch + static_cast<long long>(b) * T * K
                    : reinterpret_cast<int32_t*>(dyn) +
                          (kStage ? 2 * V : 0);                  // [T][K]
  const float* lp_row = a.lp + static_cast<long long>(b) * T * V;

  if (tid < K) {
    const int o = b * K + tid;
    sh.pb[0][tid] = a.pb_in[o];
    sh.pnb[0][tid] = a.pnb_in[o];
    sh.h[0][tid] = a.h_in[o];
    sh.h2[0][tid] = a.h2_in[o];
    sh.ph[0][tid] = a.ph_in[o];
    sh.ph2[0][tid] = a.ph2_in[o];
    sh.last[0][tid] = a.last_in[o];
    for (int c = 0; c < CL; ++c) sh.ctx[0][tid][c] = a.ctx_in[o * CL + c];
  }
  if (kStage && n > 0) {
    for (int v = tid; v < V; v += kThreads)
      cp_async4(smem_u32(s_lp + v), lp_row + v);
  }
  cp_async_commit();
  int st = 0;

  for (int t = 0; t < n; ++t) {
    const float* lpr;
    if (kStage) {
      if (t + 1 < n) {
        float* dst = s_lp + ((t + 1) & 1) * V;
        const float* src = lp_row + static_cast<long long>(t + 1) * V;
        for (int v = tid; v < V; v += kThreads)
          cp_async4(smem_u32(dst + v), src + v);
      }
      cp_async_commit();
      cp_async_wait1();
      lpr = s_lp + (t & 1) * V;
    } else {
      lpr = lp_row + static_cast<long long>(t) * V;
    }
    __syncthreads();

    // 2. per-beam totals, stay scores and LM rows
    if (tid < K) {
      const float pb = sh.pb[st][tid], pnb = sh.pnb[st][tid];
      const int last = sh.last[st][tid];
      float total = lae(fmaxf(pb, kLogZero), pnb);
      if (fmaxf(pb, pnb) <= kHalfLogZero) total = kLogZero;
      sh.total[tid] = total;
      sh.spb[tid] = total + lpr[0];
      sh.spnb[tid] = last > 0 ? pnb + lpr[last] : kLogZero;
      sh.roff[tid] = a.lm_kind != 0 ? lm_row_offset(a, sh.ctx[st][tid]) : 0;
      sh.ncons[tid] = 0;
    }
    __syncthreads();

    // 3. merges: stay k <- ext(j, last_k) where beam j is k's parent prefix
    if (tid < K) {
      const int k = tid, last_k = sh.last[st][k];
      const int ph = sh.ph[st][k], ph2 = sh.ph2[st][k];
      float mmax = kLogZero;
      for (int j = 0; j < K; ++j) {
        const bool m = last_k > 0 && ph == sh.h[st][j] && ph2 == sh.h2[st][j];
        if (m) {
          const float c = ext_raw(a, lpr, sh.pb[st][j], sh.total[j],
                                  sh.last[st][j], sh.roff[j], last_k);
          mmax = fmaxf(mmax, c);
          sh.cons[j][atomicAdd(&sh.ncons[j], 1)] = last_k;
        }
      }
      const float mmax_s = fmaxf(mmax, kHalfLogZero);
      float msum = 0.f;
      for (int j = 0; j < K; ++j) {
        const bool m = last_k > 0 && ph == sh.h[st][j] && ph2 == sh.h2[st][j];
        const float c = m ? ext_raw(a, lpr, sh.pb[st][j], sh.total[j],
                                    sh.last[st][j], sh.roff[j], last_k)
                          : kLogZero;
        msum += expf(c - mmax_s);
      }
      const float merged = mmax <= kHalfLogZero
                               ? kLogZero
                               : mmax_s + logf(fmaxf(msum, 1e-37f));
      float spnb = lae(fmaxf(sh.spnb[k], kLogZero), fmaxf(merged, kLogZero));
      if (spnb <= kHalfLogZero) spnb = kLogZero;
      sh.spnb[k] = spnb;
      sh.stay[k] = lae(fmaxf(sh.spb[k], kHalfLogZero),
                       fmaxf(spnb, kHalfLogZero));
    }
    __syncthreads();

    // 4. top-K of the K stays and the K.V extensions
    float ls[KMAX];
    int li[KMAX];
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      ls[q] = -INFINITY;
      li[q] = 0x7fffffff;
    }
    if (tid < K) insert<KMAX>(ls, li, sh.stay[tid], tid);
    for (int j = 0; j < K; ++j) {
      const float pb_j = sh.pb[st][j], total_j = sh.total[j];
      const int last_j = sh.last[st][j], nc = sh.ncons[j];
      const long long roff_j = sh.roff[j];
      const int i0 = K + j * V;
      for (int v = tid; v < V; v += kThreads) {
        float s = ext_raw(a, lpr, pb_j, total_j, last_j, roff_j, v);
        for (int q = 0; q < nc; ++q)
          if (sh.cons[j][q] == v) s = kLogZero;
        insert<KMAX>(ls, li, s, i0 + v);
      }
    }
    for (int r = 0; r < K; ++r) {          // warp merge
      float s = ls[0];
      int i = li[0];
      warp_best(s, i);
      if (li[0] == i) {
#pragma unroll
        for (int q = 0; q < KMAX - 1; ++q) {
          ls[q] = ls[q + 1];
          li[q] = li[q + 1];
        }
        ls[KMAX - 1] = -INFINITY;
        li[KMAX - 1] = 0x7fffffff;
      }
      if (lane == 0) {
        sh.wscore[warp][r] = s;
        sh.widx[warp][r] = i;
      }
    }
    __syncthreads();
    if (warp == 0) {                       // cross-warp merge
      int head = 0;
      for (int r = 0; r < K; ++r) {
        float s = -INFINITY;
        int i = 0x7fffffff;
        if (lane < kWarps && head < K) {
          s = sh.wscore[lane][head];
          i = sh.widx[lane][head];
        }
        const int mine = i;
        warp_best(s, i);
        if (lane < kWarps && head < K && mine == i) ++head;
        if (lane == 0) {
          sh.tscore[r] = s;
          sh.tidx[r] = i;
        }
      }
    }
    __syncthreads();

    // 5. the new state and the traceback of frame t
    if (tid < K) {
      const int k = tid, idx = sh.tidx[k];
      const bool is_stay = idx < K || idx >= NC;   // >= NC: never (NaN only)
      const int e = max(idx - K, 0);
      const int parent = idx < K ? idx : (is_stay ? k : e / V);
      const int ch = is_stay ? -1 : e % V;
      const int nx = st ^ 1;
      sh.pb[nx][k] = is_stay ? sh.spb[parent] : kLogZero;
      sh.pnb[nx][k] = is_stay ? sh.spnb[parent] : sh.tscore[k];
      const int ph = sh.h[st][parent], ph2 = sh.h2[st][parent];
      sh.h[nx][k] = is_stay ? ph : roll(ph, ch, kHashMult, kHashMod);
      sh.h2[nx][k] = is_stay ? ph2 : roll(ph2, ch, kHashMult2, kHashMod2);
      sh.ph[nx][k] = is_stay ? sh.ph[st][parent] : ph;
      sh.ph2[nx][k] = is_stay ? sh.ph2[st][parent] : ph2;
      sh.last[nx][k] = is_stay ? sh.last[st][parent] : ch;
      const bool shift = !is_stay && a.lm_order > 1;
      for (int c = 0; c < CL; ++c)
        sh.ctx[nx][k][c] = shift ? (c + 1 < CL ? sh.ctx[st][parent][c + 1]
                                               : ch)
                                 : sh.ctx[st][parent][c];
      tb[t * K + k] = (parent << 16) | (ch & 0xffff);
    }
    st ^= 1;
    __syncthreads();
  }

  // final scores, their order, the state out
  if (tid < K) {
    sh.fin[tid] = lae(fmaxf(sh.pb[st][tid], kHalfLogZero),
                      fmaxf(sh.pnb[st][tid], kHalfLogZero));
    const int o = b * K + tid;
    a.pb_out[o] = sh.pb[st][tid];
    a.pnb_out[o] = sh.pnb[st][tid];
    a.h_out[o] = sh.h[st][tid];
    a.h2_out[o] = sh.h2[st][tid];
    a.ph_out[o] = sh.ph[st][tid];
    a.ph2_out[o] = sh.ph2[st][tid];
    a.last_out[o] = sh.last[st][tid];
    for (int c = 0; c < CL; ++c) a.ctx_out[o * CL + c] = sh.ctx[st][tid][c];
  }
  __syncthreads();
  if (tid < K) {
    const float f = sh.fin[tid];
    int rank = tid;
    if (a.ordered) {
      rank = 0;
      for (int j = 0; j < K; ++j)
        rank += better(sh.fin[j], j, f, tid) ? 1 : 0;
    }
    sh.order[rank] = tid;
    a.out_final[b * K + rank] = f;
  }
  __syncthreads();

  // traceback of `keep` beams: count the emissions, then write the first
  // `width` of them in time order
  if (tid < a.keep) {
    int cur = sh.order[tid], cnt = 0;
    for (int t = n - 1; t >= 0; --t) {
      const int e = tb[t * K + cur];
      cnt += static_cast<int16_t>(e & 0xffff) >= 0 ? 1 : 0;
      cur = e >> 16;
    }
    const int W = a.width;
    int32_t* out = a.out_chars + (static_cast<long long>(b) * a.keep + tid) * W;
    a.out_counts[b * a.keep + tid] = min(cnt, W);
    a.out_parent0[b * a.keep + tid] = cur;
    for (int w = cnt; w < W; ++w) out[w] = -1;
    cur = sh.order[tid];
    int pos = cnt;
    for (int t = n - 1; t >= 0; --t) {
      const int e = tb[t * K + cur];
      const int ch = static_cast<int16_t>(e & 0xffff);
      if (ch >= 0 && --pos < W) out[pos] = ch;
      cur = e >> 16;
    }
  }
}

// Dynamic shared memory past 48 KB with the kernel's static part must be
// allowed first, or the launch is refused.
template <typename Kernel>
cudaError_t allow_smem(Kernel fn, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess && smem + attr.sharedSizeBytes > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  return err;
}

template <int KMAX, bool kStage>
int launch(const BeamArgs& a, size_t smem, cudaStream_t stream) {
  auto fn = beam_kernel<KMAX, kStage>;
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<a.B, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the wide form
// ---------------------------------------------------------------------------

// 32-bit [K] arrays of the workspace (pairs: the state's two copies)
enum WideSlot {
  kWPb = 0, kWPnb = 2, kWH = 4, kWH2 = 6, kWPh = 8, kWPh2 = 10, kWLast = 12,
  kWTotal = 14, kWSpb, kWSpnb, kWStay, kWRep, kWHead, kWNext, kWSlots
};

struct WideLayout {
  long long roff, surv, ctx, bytes;     // byte offsets, then the size
};

__host__ __device__ inline int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

// One row's workspace: kWSlots [K] arrays of 32 bits, roff [K] int64 (LM
// row offsets), surv [P2] uint64 (the survivors, then the final order; P2
// the power of 2 >= K), ctx [2][K][ctx_len] int32.
__host__ __device__ inline WideLayout wide_layout(int K, int CL) {
  WideLayout l;
  l.roff = (static_cast<long long>(kWSlots) * K * 4 + 15) / 16 * 16;
  l.surv = l.roff + 8LL * K;
  l.ctx = l.surv + 8LL * pow2_at_least(K);
  l.bytes = (l.ctx + 8LL * K * CL + 15) / 16 * 16;
  return l;
}

// order-preserving key of a score (a larger score, a larger key), -0 as +0
__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t u = __float_as_uint(__fadd_rn(s, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// (key, flat index) as one uint64 whose descending order is lax.top_k's
__device__ __forceinline__ unsigned long long survivor(uint32_t key, int i) {
  return (static_cast<unsigned long long>(key) << 32) |
         (0xffffffffu - static_cast<uint32_t>(i));
}

__device__ __forceinline__ int survivor_index(unsigned long long c) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(c));
}

// descending bitonic sort of s[0, n), n a power of 2, by the whole block
__device__ void bitonic_desc(unsigned long long* s, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = threadIdx.x; q < n / 2; q += blockDim.x) {
        const int lo = 2 * q - (q & (stride - 1)), hi = lo + stride;
        const unsigned long long x = s[lo], y = s[hi];
        if ((x < y) == ((lo & size) == 0)) {
          s[lo] = y;
          s[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

template <bool kStage, bool kWsShared>
__global__ void __launch_bounds__(kWideThreads)
    beam_wide_kernel(const BeamArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int hist[2][kRadixBins];
  __shared__ int wcount[kWideWarps];
  __shared__ uint32_t sel_prefix;
  __shared__ int sel_shift, sel_need, sel_all, n_taken;
  const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int T = a.T, V = a.V, K = a.K, CL = a.ctx_len;
  const int n = min(max(a.lengths[b], 0), T);
  const int N = K + K * V;
  const int P2 = pow2_at_least(K);
  const WideLayout L = wide_layout(K, CL);
  const long long stage = kStage ? 2LL * V * 4 : 0;
  float* s_lp = reinterpret_cast<float*>(dyn);                  // [2][V]
  unsigned char* ws =
      kWsShared ? dyn + stage
                : static_cast<unsigned char*>(a.ws_scratch) + b * L.bytes;
  int32_t* tb = a.tb_scratch != nullptr
                    ? a.tb_scratch + static_cast<long long>(b) * T * K
                    : reinterpret_cast<int32_t*>(
                          dyn + stage + (kWsShared ? L.bytes : 0));  // [T][K]
  float* wf = reinterpret_cast<float*>(ws);
  int* wi = reinterpret_cast<int*>(ws);
  long long* roff = reinterpret_cast<long long*>(ws + L.roff);
  unsigned long long* surv =
      reinterpret_cast<unsigned long long*>(ws + L.surv);
  int* wctx = reinterpret_cast<int*>(ws + L.ctx);              // [2][K][CL]
  auto F = [&](int slot, int k) -> float& { return wf[slot * K + k]; };
  auto I = [&](int slot, int k) -> int& { return wi[slot * K + k]; };
  const float* lp_row = a.lp + static_cast<long long>(b) * T * V;
  // warp w owns the flat indices [w span, (w + 1) span), 32 a round
  const int span = ((N + kWideWarps - 1) / kWideWarps + 31) / 32 * 32;
  const int i0 = warp * span + lane;

  for (int k = tid; k < K; k += nthr) {
    const long long o = static_cast<long long>(b) * K + k;
    F(kWPb, k) = a.pb_in[o];
    F(kWPnb, k) = a.pnb_in[o];
    I(kWH, k) = a.h_in[o];
    I(kWH2, k) = a.h2_in[o];
    I(kWPh, k) = a.ph_in[o];
    I(kWPh2, k) = a.ph2_in[o];
    I(kWLast, k) = a.last_in[o];
    for (int c = 0; c < CL; ++c) wctx[k * CL + c] = a.ctx_in[o * CL + c];
  }
  if (kStage && n > 0) {
    for (int v = tid; v < V; v += nthr)
      cp_async4(smem_u32(s_lp + v), lp_row + v);
  }
  cp_async_commit();
  int st = 0;

  for (int t = 0; t < n; ++t) {
    const float* lpr;
    if (kStage) {
      if (t + 1 < n) {
        float* dst = s_lp + ((t + 1) & 1) * V;
        const float* src = lp_row + static_cast<long long>(t + 1) * V;
        for (int v = tid; v < V; v += nthr)
          cp_async4(smem_u32(dst + v), src + v);
      }
      cp_async_commit();
      cp_async_wait1();
      lpr = s_lp + (t & 1) * V;
    } else {
      lpr = lp_row + static_cast<long long>(t) * V;
    }
    __syncthreads();
    const int* ctx_st = wctx + st * K * CL;

    // 2. per-beam totals, stay scores and LM rows; each beam's hash class
    for (int k = tid; k < K; k += nthr) {
      const float pb = F(kWPb + st, k), pnb = F(kWPnb + st, k);
      const int last = I(kWLast + st, k);
      float total = lae(fmaxf(pb, kLogZero), pnb);
      if (fmaxf(pb, pnb) <= kHalfLogZero) total = kLogZero;
      F(kWTotal, k) = total;
      F(kWSpb, k) = total + lpr[0];
      F(kWSpnb, k) = last > 0 ? pnb + lpr[last] : kLogZero;
      roff[k] = a.lm_kind != 0 ? lm_row_offset(a, ctx_st + k * CL) : 0;
      const int h = I(kWH + st, k), h2 = I(kWH2 + st, k);
      int rep = k;
      for (int j = 0; j < k; ++j) {
        if (I(kWH + st, j) == h && I(kWH2 + st, j) == h2) {
          rep = j;
          break;
        }
      }
      I(kWRep, k) = rep;
      I(kWHead, k) = -1;
    }
    for (int q = tid; q < kRadixBins; q += nthr) hist[0][q] = 0;
    if (tid == 0) {
      sel_prefix = 0;
      sel_need = K;
      sel_all = 0;
      n_taken = 0;
    }
    __syncthreads();

    // 3. merges: stay k <- ext(j, last_k) for every beam j of k's parent
    // prefix; k joins the consumed list of the lowest such j
    for (int k = tid; k < K; k += nthr) {
      const int last_k = I(kWLast + st, k);
      const int ph = I(kWPh + st, k), ph2 = I(kWPh2 + st, k);
      float mmax = kLogZero;
      int first = -1;
      for (int j = 0; last_k > 0 && j < K; ++j) {
        if (ph == I(kWH + st, j) && ph2 == I(kWH2 + st, j)) {
          mmax = fmaxf(mmax, ext_raw(a, lpr, F(kWPb + st, j), F(kWTotal, j),
                                     I(kWLast + st, j), roff[j], last_k));
          if (first < 0) first = j;
        }
      }
      const float mmax_s = fmaxf(mmax, kHalfLogZero);
      float msum = 0.f;        // the other beams add exp(LOG_ZERO - m) = 0
      for (int j = max(first, 0); first >= 0 && j < K; ++j) {
        if (ph == I(kWH + st, j) && ph2 == I(kWH2 + st, j))
          msum += expf(ext_raw(a, lpr, F(kWPb + st, j), F(kWTotal, j),
                               I(kWLast + st, j), roff[j], last_k) -
                       mmax_s);
      }
      const float merged = mmax <= kHalfLogZero
                               ? kLogZero
                               : mmax_s + logf(fmaxf(msum, 1e-37f));
      float spnb = lae(fmaxf(F(kWSpnb, k), kLogZero), fmaxf(merged, kLogZero));
      if (spnb <= kHalfLogZero) spnb = kLogZero;
      F(kWSpnb, k) = spnb;
      F(kWStay, k) = lae(fmaxf(F(kWSpb, k), kHalfLogZero),
                         fmaxf(spnb, kHalfLogZero));
      if (first >= 0) I(kWNext, k) = atomicExch(&I(kWHead, first), k);
    }
    __syncthreads();

    // 4. top-K of the K stays and the K.V extensions
    auto cand = [&](int i) -> float {
      if (i < K) return F(kWStay, i);
      const int e = i - K, j = e / V, v = e - j * V;
      float s = ext_raw(a, lpr, F(kWPb + st, j), F(kWTotal, j),
                        I(kWLast + st, j), roff[j], v);
      for (int k = I(kWHead, I(kWRep, j)); v > 0 && k >= 0; k = I(kWNext, k)) {
        if (I(kWLast + st, k) == v) {
          s = kLogZero;
          break;
        }
      }
      return s;
    };
    for (int pass = 0; pass < 4; ++pass) {    // radix select, 8 bits a pass
      const int cur = pass & 1, shift = 24 - 8 * pass;
      const uint32_t prefix = sel_prefix;
      for (int r = 0; r < span; r += 32) {
        const int i = i0 + r;
        int bin = -1;
        if (i < N) {
          const uint32_t key = order_key(cand(i));
          if (pass == 0 || (key >> (shift + 8)) == prefix)
            bin = static_cast<int>((key >> shift) & 0xffu);
        }
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(&hist[cur][bin], __popc(peers));
      }
      __syncthreads();
      if (warp == 0) {             // the bin that holds the need-th key
        const int need = sel_need;
        int c[8], sum = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          c[q] = hist[cur][kRadixBins - 1 - 8 * lane - q];
          sum += c[q];
        }
        int incl = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += y;
        }
        const int src = __ffs(__ballot_sync(0xffffffffu, incl >= need)) - 1;
        if (lane == src) {
          int above = incl - sum, q = 0;
          while (above + c[q] < need) above += c[q++];
          sel_prefix = (prefix << 8) |
                       static_cast<uint32_t>(kRadixBins - 1 - 8 * lane - q);
          sel_shift = shift;
          sel_need = need - above;
          sel_all = c[q] == need - above;
        }
      } else {
        for (int q = tid - 32; q < kRadixBins; q += nthr - 32)
          hist[cur ^ 1][q] = 0;
      }
      __syncthreads();
      if (sel_all) break;
    }
    // keys above the threshold class, and the class too when all of it is
    // taken; else its first `need` members in ascending index
    const uint32_t P = sel_prefix;
    const int shift = sel_shift, need = sel_need;
    const bool all = sel_all;
    int ties = 0;
    for (int r = 0; r < span; r += 32) {
      const int i = i0 + r;
      bool tie = false;
      if (i < N) {
        const uint32_t key = order_key(cand(i));
        const uint32_t hi = key >> shift;
        if (hi > P || (all && hi == P))
          surv[atomicAdd(&n_taken, 1)] = survivor(key, i);
        tie = !all && hi == P;
      }
      ties += __popc(__ballot_sync(0xffffffffu, tie));
    }
    if (lane == 0) wcount[warp] = ties;
    for (int q = K + tid; q < P2; q += nthr) surv[q] = 0ULL;
    __syncthreads();
    if (!all) {
      int base = 0;
      for (int w = 0; w < warp; ++w) base += wcount[w];
      for (int r = 0; r < span && ties > 0 && base < need; r += 32) {
        const int i = i0 + r;
        uint32_t key = 0;
        bool tie = false;
        if (i < N) {
          key = order_key(cand(i));
          tie = (key >> shift) == P;
        }
        const unsigned m = __ballot_sync(0xffffffffu, tie);
        const int pos = base + __popc(m & ((1u << lane) - 1u));
        if (tie && pos < need) surv[K - need + pos] = survivor(key, i);
        base += __popc(m);
        ties -= __popc(m);
      }
      __syncthreads();
    }
    bitonic_desc(surv, P2);

    // 5. the new state and the traceback of frame t
    const int nx = st ^ 1;
    int* ctx_nx = wctx + nx * K * CL;
    for (int k = tid; k < K; k += nthr) {
      const unsigned long long c = surv[k];
      const int idx = survivor_index(c);
      const bool is_stay = idx < K;
      const int e = max(idx - K, 0);
      const int parent = is_stay ? idx : e / V;
      const int ch = is_stay ? -1 : e - parent * V;
      F(kWPb + nx, k) = is_stay ? F(kWSpb, parent) : kLogZero;
      F(kWPnb + nx, k) = is_stay ? F(kWSpnb, parent)
                                 : key_score(static_cast<uint32_t>(c >> 32));
      const int ph = I(kWH + st, parent), ph2 = I(kWH2 + st, parent);
      I(kWH + nx, k) = is_stay ? ph : roll(ph, ch, kHashMult, kHashMod);
      I(kWH2 + nx, k) = is_stay ? ph2 : roll(ph2, ch, kHashMult2, kHashMod2);
      I(kWPh + nx, k) = is_stay ? I(kWPh + st, parent) : ph;
      I(kWPh2 + nx, k) = is_stay ? I(kWPh2 + st, parent) : ph2;
      I(kWLast + nx, k) = is_stay ? I(kWLast + st, parent) : ch;
      const bool shift_ctx = !is_stay && a.lm_order > 1;
      const int* pc = ctx_st + parent * CL;
      for (int q = 0; q < CL; ++q)
        ctx_nx[k * CL + q] = shift_ctx ? (q + 1 < CL ? pc[q + 1] : ch) : pc[q];
      tb[static_cast<long long>(t) * K + k] = (parent << 16) | (ch & 0xffff);
    }
    st = nx;
    __syncthreads();
  }

  // final scores, their order, the state out
  const int* ctx_st = wctx + st * K * CL;
  for (int k = tid; k < K; k += nthr) {
    F(kWStay, k) = lae(fmaxf(F(kWPb + st, k), kHalfLogZero),
                       fmaxf(F(kWPnb + st, k), kHalfLogZero));
    const long long o = static_cast<long long>(b) * K + k;
    a.pb_out[o] = F(kWPb + st, k);
    a.pnb_out[o] = F(kWPnb + st, k);
    a.h_out[o] = I(kWH + st, k);
    a.h2_out[o] = I(kWH2 + st, k);
    a.ph_out[o] = I(kWPh + st, k);
    a.ph2_out[o] = I(kWPh2 + st, k);
    a.last_out[o] = I(kWLast + st, k);
    for (int c = 0; c < CL; ++c) a.ctx_out[o * CL + c] = ctx_st[k * CL + c];
  }
  __syncthreads();
  if (a.ordered) {
    for (int q = tid; q < P2; q += nthr)
      surv[q] = q < K ? survivor(order_key(F(kWStay, q)), q) : 0ULL;
    __syncthreads();
    bitonic_desc(surv, P2);
  }
  for (int r = tid; r < K; r += nthr) {
    const int k = a.ordered ? survivor_index(surv[r]) : r;
    I(kWRep, r) = k;                                  // the order
    a.out_final[static_cast<long long>(b) * K + r] = F(kWStay, k);
  }
  __syncthreads();

  // traceback of `keep` beams, as the narrow form's
  for (int r = tid; r < a.keep; r += nthr) {
    int cur = I(kWRep, r), cnt = 0;
    for (int t = n - 1; t >= 0; --t) {
      const int e = tb[static_cast<long long>(t) * K + cur];
      cnt += static_cast<int16_t>(e & 0xffff) >= 0 ? 1 : 0;
      cur = e >> 16;
    }
    const int W = a.width;
    int32_t* out = a.out_chars + (static_cast<long long>(b) * a.keep + r) * W;
    a.out_counts[b * a.keep + r] = min(cnt, W);
    a.out_parent0[b * a.keep + r] = cur;
    for (int w = cnt; w < W; ++w) out[w] = -1;
    cur = I(kWRep, r);
    int pos = cnt;
    for (int t = n - 1; t >= 0; --t) {
      const int e = tb[static_cast<long long>(t) * K + cur];
      const int ch = static_cast<int16_t>(e & 0xffff);
      if (ch >= 0 && --pos < W) out[pos] = ch;
      cur = e >> 16;
    }
  }
}

template <bool kStage, bool kWsShared>
int launch_wide(const BeamArgs& a, size_t smem, cudaStream_t stream) {
  auto fn = beam_wide_kernel<kStage, kWsShared>;
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<a.B, kWideThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan of a call: out[0] = 1 for the wide form (K > 32, an LM
// context past 8 lanes, or `wide` asked for), out[1] = 1 if lp rows are
// staged in shared memory, out[2] = 1 if the tracebacks fit in shared
// memory (else the caller's [B, T, K] int32 scratch holds them), out[3] =
// 1 if the wide form's workspace fits in shared memory beside the staged
// rows (else the caller's [B, out[5]] byte scratch holds it; 1 for the
// narrow form, whose state is static), out[4] = dynamic shared bytes a
// block, out[5] = the workspace's bytes a row (0 for the narrow form).
CSR_API int csr_beam_plan(int T, int V, int K, int ctx_len, int wide,
                          int* out) {
  wide = wide || K > kMaxBeam || ctx_len > kMaxCtx;
  const long long stage = V <= kStageMaxV ? 2LL * V * 4 : 0;
  const long long ws = wide ? wide_layout(K, max(ctx_len, 1)).bytes : 0;
  const bool ws_smem = stage + ws <= kSharedBudget;
  const long long used = stage + (ws_smem ? ws : 0);
  const long long tbb = static_cast<long long>(T) * K * 4;
  const bool tb_smem = used + tbb <= kSharedBudget;
  out[0] = wide ? 1 : 0;
  out[1] = stage > 0;
  out[2] = tb_smem;
  out[3] = ws_smem;
  out[4] = static_cast<int>(used + (tb_smem ? tbb : 0));
  out[5] = static_cast<int>(ws);
  return 0;
}

// The narrow form. Requires 1 <= K <= 32, 1 <= V <= 32767, 1 <= T,
// ctx_len <= 8, keep <= K, width >= 0; tb_scratch non-null exactly when
// csr_beam_plan says the tracebacks do not fit in shared memory (the
// wrapper checks all of it).
CSR_API int csr_beam(const BeamArgs* args, cudaStream_t stream) {
  BeamArgs a = *args;
  if (a.B < 1 || a.T < 1 || a.V < 1 || a.V > 32767 || a.K < 1 ||
      a.K > kMaxBeam || a.ctx_len < 1 || a.ctx_len > kMaxCtx ||
      a.keep < 0 || a.keep > a.K || a.width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int plan[6];
  csr_beam_plan(a.T, a.V, a.K, a.ctx_len, 0, plan);
  if ((a.tb_scratch == nullptr) != (plan[2] == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(plan[4]);
  if (plan[1]) {
    return a.K <= 8 ? launch<8, true>(a, smem, stream)
                    : launch<32, true>(a, smem, stream);
  }
  return a.K <= 8 ? launch<8, false>(a, smem, stream)
                  : launch<32, false>(a, smem, stream);
}

// The wide form. Requires 1 <= K <= 32767 (the tracebacks pack the parent
// into 16 bits), 1 <= V <= 32767, 1 <= T, ctx_len >= 1, keep <= K, width
// >= 0; tb_scratch and ws_scratch non-null exactly where csr_beam_plan
// (wide = 1) places the tracebacks and the workspace in global memory.
CSR_API int csr_beam_wide(const BeamArgs* args, cudaStream_t stream) {
  BeamArgs a = *args;
  if (a.B < 1 || a.T < 1 || a.V < 1 || a.V > 32767 || a.K < 1 ||
      a.K > kMaxWideBeam || a.ctx_len < 1 || a.keep < 0 || a.keep > a.K ||
      a.width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int plan[6];
  csr_beam_plan(a.T, a.V, a.K, a.ctx_len, 1, plan);
  if ((a.tb_scratch == nullptr) != (plan[2] == 1) ||
      (a.ws_scratch == nullptr) != (plan[3] == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(plan[4]);
  if (plan[1]) {
    return plan[3] ? launch_wide<true, true>(a, smem, stream)
                   : launch_wide<true, false>(a, smem, stream);
  }
  return plan[3] ? launch_wide<false, true>(a, smem, stream)
                 : launch_wide<false, false>(a, smem, stream);
}
