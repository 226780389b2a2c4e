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
// Design: one block of kThreads threads per utterance row, the [K] beam
// state in shared memory (two copies, flipped each frame). Per frame:
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

template <int KMAX, bool kStage>
int launch(const BeamArgs& a, size_t smem, cudaStream_t stream) {
  auto fn = beam_kernel<KMAX, kStage>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<a.B, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan: out[0] = 1 if lp rows are staged in shared memory,
// out[1] = 1 if the tracebacks fit in shared memory (else the caller's
// [B, T, K] int32 scratch holds them), out[2] = dynamic shared bytes.
CSR_API int csr_beam_plan(int T, int V, int K, int* out) {
  const long long stage = V <= kStageMaxV ? 2LL * V * 4 : 0;
  const long long tbb = static_cast<long long>(T) * K * 4;
  const bool tb_smem = stage + tbb <= kSharedBudget;
  out[0] = stage > 0;
  out[1] = tb_smem;
  out[2] = static_cast<int>(stage + (tb_smem ? tbb : 0));
  return 0;
}

// Requires 1 <= K <= 32, 1 <= V <= 32767, 1 <= T, ctx_len <= 8, keep <= K,
// width >= 0; tb_scratch non-null exactly when csr_beam_plan says the
// tracebacks do not fit in shared memory (the wrapper checks all of it).
CSR_API int csr_beam(const BeamArgs* args, cudaStream_t stream) {
  BeamArgs a = *args;
  if (a.B < 1 || a.T < 1 || a.V < 1 || a.V > 32767 || a.K < 1 ||
      a.K > kMaxBeam || a.ctx_len < 1 || a.ctx_len > kMaxCtx ||
      a.keep < 0 || a.keep > a.K || a.width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int plan[3];
  csr_beam_plan(a.T, a.V, a.K, plan);
  if ((a.tb_scratch == nullptr) != (plan[1] == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(plan[2]);
  if (plan[0]) {
    return a.K <= 8 ? launch<8, true>(a, smem, stream)
                    : launch<32, true>(a, smem, stream);
  }
  return a.K <= 8 ? launch<8, false>(a, smem, stream)
                  : launch<32, false>(a, smem, stream);
}
