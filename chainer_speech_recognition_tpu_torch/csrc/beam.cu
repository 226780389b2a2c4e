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
// exactly LOG_ZERO. Every selection here works on one 64-bit word a
// candidate, (order key << 32) | (2^32 - 1 - index): the order key maps a
// score to a uint32 whose order is the float order (-0 as +0), so the
// word's descending order is lax.top_k's and no two words are equal. The
// rolling hashes ((h mod M) * MULT + c) mod M and the hashed LM's keys (h1
// V + c, (h2 MULT2 + c) mod M2, uint32(key1) * 2654435761 & mask) are int32
// arithmetic that wraps, with floor modulo, in the reference: they are
// computed here in uint32 with the floor modulo written out. Every fp32
// expression keeps the plain version's order of operations, with
// __fmul_rn / __fadd_rn where nvcc would otherwise contract to an FMA, and
// logaddexp is torch's own formula (max + log1p(exp(-|a - b|))).
//
// What bounds it on Hopper: the chain of dependent frames, not the bytes.
// A batch reads lp once (32 x 251 x 64 x 4 B = 2 MB at bigru: ~0.6 us at
// HBM rate) and the LM rows its hypotheses touch; each frame waits for the
// last one's top-K. The design keeps that chain short: no step of a frame
// loops over K dependent rounds, and each candidate's score is computed
// once a frame.
//
// Per frame, in both forms (one row's blocks; the helpers below):
//   1. the next frame's lp row is staged into shared memory by 4-byte
//      cp.async while this one computes (double-buffered; rows past
//      kStageMaxV symbols are read from global memory instead);
//   2. a thread a beam: its total, stay scores, lp[last] and its LM row
//      (dense: the positional fold of the context; hashed: probe L.P slots
//      longest level first, exactly beam.py:369-405);
//   3. the K.K (stay k, parent j) pairs spread over the block, a stay on a
//      segment of lanes: the merge of k with the extensions (j, last_k) of
//      every beam j of k's parent prefix (max and sum as segment
//      reductions of shuffles), then a thread a stay: the merged stay_pnb
//      and the stay's score; k joins the consumed list of its parent's hash
//      class (the lowest beam with those hashes), and each beam notes its
//      own class (rep) and the first symbols of its class's list;
//   4. the top-K of the K stays and the K.V extensions (an extension (j, v)
//      is LOG_ZERO where a beam on the list of rep[j] has last == v): each
//      candidate's key is computed once into shared memory, then the form's
//      selection (below);
//   5. a thread a beam writes the new state and the traceback (parent,
//      char) of frame t (shared memory when the chunk's tracebacks fit,
//      else the scratch in global memory).
// After the frames the final scores are ordered (a warp sorts each 32 by
// their ranks in the warp, then ranking merges the sorted runs) and `keep`
// threads follow the parent chains back from the live frames' end (twice:
// count, then write) into the outputs. Traceback entries pack (parent <<
// 16) | (char & 0xffff), so K <= 32767 (and V <= 32767, the reference's
// own limit).
//
// The narrow form (beam_kernel: K <= 32, an LM context of <= 8 lanes, and
// the row's keys in shared memory), 128 threads a row, or 256 where the row
// has more than kNarrowLongRow candidates; the state in static shared
// memory (make_plan, beam_plan.cuh: the block size measured faster by
// tools/kernel_ab.py).
// Its selection is two ranks deep, not 2K warp rounds:
//   a. each thread keeps the best word of its run of m = ceil(N / NT)
//      consecutive candidates; each thread's rank among its warp's 32
//      bests (all pairs, by shuffles) places them in order, and each entry
//      of a warp's top K adds, by binary search, the entries of the other
//      <= 7 warps that beat it: the one ranked K-1 is the K-th best thread
//      best, a threshold no higher than the K-th best candidate (K threads
//      hold a candidate at least as good);
//   b. every candidate at or above the threshold is appended to a list in
//      shared memory (at most K threads hold such candidates, so at most K
//      times a thread's count), and each list entry counts the entries
//      that beat it: those ranked below K are the top-K, in order.
//
// The wide form (beam_wide_kernel: every other call, K <= 32767, any
// context length), 512 threads a block and a cluster of C = 1, 2 or 4
// blocks a row (csr_beam_plan: the fewest whose share of the row's keys
// fits in shared memory, and two at least past kWideLongRow candidates,
// where two blocks were measured faster than one). Every block keeps the
// whole state (its workspace, wide_layout, in shared memory or a [B,
// bytes] scratch where it does not fit, then C = 1) and runs steps 2, 3
// and 5 itself; the K + K.V
// candidates are split into C contiguous index ranges, one a block, and
// each block's into 16 warps' contiguous ranges. Its selection is a radix
// select of the order keys, 11, 11 and 10 bits a pass (a pass stops the
// select once its digit's bin is all taken): the first pass computes each
// key, keeps it in shared memory where the block's share fits (else the
// later sweeps compute it again) and counts its top digit into a 2048-bin
// histogram; the blocks' histograms are summed through distributed shared
// memory (the cluster barrier between), and each block finds the digit
// whose bin holds the need-th key by a block-wide scan. Then the keys above
// the threshold class (and the class too when all of it is taken) are
// survivors; else the class's first `need` members in ascending index (the
// blocks' and warps' ranges are in index order, so each block's and each
// warp's tie count gives its offset); every block writes its survivors into
// every block's shared memory, and each block orders the K survivors (32 at
// a time by their ranks in a warp, then ranking merges the runs).
#include <cuda_fp16.h>
#include <math.h>

#include "beam_plan.cuh"
#include "common.cuh"

namespace {

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
constexpr int kDigitBits = 11;          // radix digits: 11, 11, 10 bits
constexpr int kRadixBins = 1 << kDigitBits;
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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// the address of the same shared-memory location in block `rank`
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ int ld_cluster(uint32_t addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n"
               : "=r"(v)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster(uint32_t addr,
                                           unsigned long long v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;\n" ::"r"(addr), "l"(v)
               : "memory");
}

// every thread of the row's blocks: after it, each one's earlier stores to
// a peer's shared memory are seen (release / acquire); one block alone
// takes the block barrier
__device__ __forceinline__ void row_sync(int C) {
  if (C > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

// block q's copy of a shared int of this block's layout
__device__ __forceinline__ int peer_int(const int* p, int q, int self) {
  return q == self ? *p : ld_cluster(map_rank(p, static_cast<uint32_t>(q)));
}

// order-preserving key of a score (a larger score, a larger key), -0 as +0
__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t u = __float_as_uint(__fadd_rn(s, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// (key, flat index) as one word whose descending order is lax.top_k's;
// every candidate's word is above 0
__device__ __forceinline__ unsigned long long word(uint32_t key, int i) {
  return (static_cast<unsigned long long>(key) << 32) |
         (0xffffffffu - static_cast<uint32_t>(i));
}

__device__ __forceinline__ int word_index(unsigned long long c) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(c));
}

// this lane's rank among its warp's 32 words: how many lanes hold a larger
// word, or an equal one at a lower lane (32 broadcast shuffles, side by
// side: no step waits for another), so the ranks are 0..31 and a word
// written at its rank leaves the warp's words in descending order
__device__ __forceinline__ int warp_rank(unsigned long long x) {
  const int lane = threadIdx.x & 31;
  int r = 0;
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    const unsigned long long y = __shfl_sync(0xffffffffu, x, l);
    r += (y > x || (y == x && l < lane)) ? 1 : 0;
  }
  return r;
}

// how many of s[0, 32) (descending) are above x: a binary search of fixed
// steps, unrolled, so searches in several lists run side by side
__device__ __forceinline__ int count_above32(const unsigned long long* s,
                                             unsigned long long x) {
  int pos = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (s[pos + step - 1] > x) pos += step;
  return pos + (s[pos] > x ? 1 : 0);
}

// s[0, n) (distinct words) in descending order, by the whole block: each
// warp ranks runs of 32 (warp_rank) into tmp, then every word counts the
// words of the other runs above it (count_above32) and lands at its rank.
// → the sorted array (tmp for one run, else s)
__device__ __forceinline__ const unsigned long long* sort_desc(
    unsigned long long* s, unsigned long long* tmp, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int runs = (n + 31) / 32;
  for (int r = warp; r < runs; r += blockDim.x >> 5) {
    const int i = r * 32 + lane;
    const unsigned long long x = i < n ? s[i] : 0ULL;
    tmp[r * 32 + warp_rank(x)] = x;
  }
  __syncthreads();
  if (runs == 1) return tmp;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / 32;
    const unsigned long long x = tmp[i];   // i < n: a word, not padding
    int rank = i - 32 * r;
    for (int q = 0; q < runs; ++q)
      if (q != r) rank += count_above32(tmp + 32 * q, x);
    s[rank] = x;
  }
  __syncthreads();
  return s;
}

// the LM's score of symbol v in the row at element offset `off`
__device__ __forceinline__ float lm_val(const BeamArgs& a, long long off) {
  if (a.lm_kind == 1) return static_cast<const float*>(a.lm_table)[off];
  if (a.rows_fp16)
    return __half2float(static_cast<const __half*>(a.lm_rows)[off]);
  return static_cast<const float*>(a.lm_rows)[off];
}

// score of extension (j, v) before consumption: base + lp[v] (+ LM)
__device__ __forceinline__ float ext_raw(const BeamArgs& a, const float* lpr,
                                         float pb_j, float total_j,
                                         int last_j, long long roff_j,
                                         int v) {
  const float base = v == last_j ? pb_j : total_j;
  float s = base + lpr[v];
  if (a.lm_kind != 0)
    s = __fadd_rn(__fadd_rn(s, __fmul_rn(a.alpha, lm_val(a, roff_j + v))),
                  a.beta);
  return v == 0 ? kLogZero : s;
}

// the LM row of a context window (oldest char first)
__device__ __forceinline__ long long lm_row_offset(const BeamArgs& a,
                                                  const int* ctx) {
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

// a beam's first consumed symbols kept beside it (its class list walked
// once, in step 3); the last slot -2 where the list is longer
constexpr int kCached = 4;

// n / d for 0 <= n < 2^31 by a multiply-high (Granlund and Montgomery's
// round-up form; the magic computed once a launch): a runtime division
// costs a few dozen dependent instructions
struct FastDiv {
  uint32_t d, m;
  int l;
  __device__ explicit FastDiv(int d_) : d(static_cast<uint32_t>(d_)), l(0) {
    while ((1u << l) < d) ++l;
    m = static_cast<uint32_t>(((1ULL << 32) * ((1ULL << l) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    if (d == 1) return n;
    const uint32_t u = static_cast<uint32_t>(n), t = __umulhi(m, u);
    return static_cast<int>((t + ((u - t) >> 1)) >> (l - 1));
  }
};

// One row's per-beam arrays (the narrow form's static shared memory, the
// wide form's workspace): the state's two copies, flipped each frame (copy
// 1 of an array at cs elements past copy 0, of ctx at ccs), then the
// frame's per-beam scratch.
struct Row {
  float *pb, *pnb;
  int *h, *h2, *ph, *ph2, *last, *ctx;
  int cs, ccs;
  float *total, *spb, *spnb, *stay;
  long long* roff;
  int *rep, *head, *next;
  int* cons;         // [K][kCached]: each beam's consumed symbols
};

// one copy of the state (plain pointers, so they stay in registers)
struct State {
  float *pb, *pnb;
  int *h, *h2, *ph, *ph2, *last, *ctx;
};

__device__ __forceinline__ State state_of(const Row& R, int st) {
  const int o = st * R.cs, oc = st * R.ccs;
  return State{R.pb + o, R.pnb + o, R.h + o, R.h2 + o, R.ph + o,
               R.ph2 + o, R.last + o, R.ctx + oc};
}

// the state in, at the row's copy 0
__device__ __forceinline__ void load_state(const BeamArgs& a, const State& S,
                                           int b) {
  const int K = a.K, CL = a.ctx_len;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const long long o = static_cast<long long>(b) * K + k;
    S.pb[k] = a.pb_in[o];
    S.pnb[k] = a.pnb_in[o];
    S.h[k] = a.h_in[o];
    S.h2[k] = a.h2_in[o];
    S.ph[k] = a.ph_in[o];
    S.ph2[k] = a.ph2_in[o];
    S.last[k] = a.last_in[o];
    for (int c = 0; c < CL; ++c) S.ctx[k * CL + c] = a.ctx_in[o * CL + c];
  }
}

// lp row t into shared copy t & 1 (row t + 1 in flight) → the row to read
template <bool kStage>
__device__ __forceinline__ const float* lp_row_of(const float* lp_row,
                                                  float* s_lp, int t, int n,
                                                  int V) {
  if (!kStage) return lp_row + static_cast<long long>(t) * V;
  if (t + 1 < n) {
    float* dst = s_lp + ((t + 1) & 1) * V;
    const float* src = lp_row + static_cast<long long>(t + 1) * V;
    for (int v = threadIdx.x; v < V; v += blockDim.x)
      cp_async4(smem_u32(dst + v), src + v);
  }
  cp_async_commit();
  cp_async_wait1();
  return s_lp + (t & 1) * V;
}

template <bool kStage>
__device__ __forceinline__ void lp_first(const float* lp_row, float* s_lp,
                                         int n, int V) {
  if (kStage && n > 0) {
    for (int v = threadIdx.x; v < V; v += blockDim.x)
      cp_async4(smem_u32(s_lp + v), lp_row + v);
  }
  cp_async_commit();
}

// 2. per-beam totals, stay scores and LM rows; the consumed lists emptied
__device__ __forceinline__ void prepare(const BeamArgs& a, const Row& R,
                                        const State& S, const float* lpr) {
  const int K = a.K, CL = a.ctx_len;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float pb = S.pb[k], pnb = S.pnb[k];
    const int last = S.last[k];
    float total = lae(fmaxf(pb, kLogZero), pnb);
    if (fmaxf(pb, pnb) <= kHalfLogZero) total = kLogZero;
    R.total[k] = total;
    R.spb[k] = total + lpr[0];
    R.spnb[k] = last > 0 ? pnb + lpr[last] : kLogZero;
    R.roff[k] = a.lm_kind != 0 ? lm_row_offset(a, S.ctx + k * CL) : 0;
    R.head[k] = -1;
  }
}

// 3. the merges, a stay k on a segment of G lanes, lane j of it the parents
// j, j + G, ... (G the largest power of 2 <= 32 and <= K with 2 G K <= the
// block's threads, so every stay fits in one or two passes): the merge of
// k with ext(j, last_k) for every beam j of k's parent prefix (the sum
// only over the matches, since the others add exp(LOG_ZERO - m) = 0, by a
// segment's shuffles where at most two terms are nonzero, else in
// ascending j by the segment's first lane, so the sum's order does not
// depend on G); k joins the consumed list of the lowest such j, and rep[k]
// is the lowest beam with k's own hashes. Then a thread a stay: the merged
// stay_pnb and the stay's score (every stay's logaddexps at once), and the
// first consumed symbols of beam k as a parent (its class list's).
__device__ __forceinline__ void merge_stays(const BeamArgs& a, const Row& R,
                                            const State& S,
                                            const float* lpr) {
  const int K = a.K;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  int G = 1;
  while (G < 32 && G < K && 2 * G * K <= static_cast<int>(blockDim.x)) G *= 2;
  const int per = 32 / G, sl = lane % G;
  for (int k0 = (threadIdx.x >> 5) * per; k0 < K; k0 += nw * per) {
    const int k = k0 + lane / G;
    const bool on = k < K;
    const int last_k = on ? S.last[k] : 0;
    const int ph = on ? S.ph[k] : 0, ph2 = on ? S.ph2[k] : 0;
    const int hk = on ? S.h[k] : 0, hk2 = on ? S.h2[k] : 0;
    float mmax = kLogZero, m1 = kLogZero, m2 = kLogZero;  // lane's matches
    int first = K, rep = on ? k : K, n_match = 0;
#pragma unroll 4
    for (int j = sl; on && j < K; j += G) {
      const int hj = S.h[j], hj2 = S.h2[j];
      if (hj == hk && hj2 == hk2) rep = min(rep, j);
      if (last_k > 0 && hj == ph && hj2 == ph2) {
        const float c = ext_raw(a, lpr, S.pb[j], R.total[j], S.last[j],
                                R.roff[j], last_k);
        mmax = fmaxf(mmax, c);
        if (n_match == 0) m1 = c;
        if (n_match == 1) m2 = c;
        first = min(first, j);
        ++n_match;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < G) {
        mmax = fmaxf(mmax, __shfl_xor_sync(0xffffffffu, mmax, off));
        first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
        rep = min(rep, __shfl_xor_sync(0xffffffffu, rep, off));
        n_match += __shfl_xor_sync(0xffffffffu, n_match, off);
      }
    }
    const float mmax_s = fmaxf(mmax, kHalfLogZero);
    float msum = 0.f;             // n_match <= 2: a lane holds its matches
    if (n_match <= 2 && m1 > kLogZero) msum += expf(m1 - mmax_s);
    if (n_match <= 2 && m2 > kLogZero) msum += expf(m2 - mmax_s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      if (off < G) msum += __shfl_xor_sync(0xffffffffu, msum, off);
    if (on && sl == 0) {
      if (n_match > 2) {
        msum = 0.f;
        for (int j = first; j < K; ++j) {
          if (S.h[j] == ph && S.h2[j] == ph2)
            msum += expf(ext_raw(a, lpr, S.pb[j], R.total[j], S.last[j],
                                 R.roff[j], last_k) - mmax_s);
        }
      }
      R.stay[k] = mmax <= kHalfLogZero ? kLogZero
                                       : mmax_s + logf(fmaxf(msum, 1e-37f));
      R.rep[k] = rep;
      if (first < K) R.next[k] = atomicExch(&R.head[first], k);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float spnb = lae(fmaxf(R.spnb[k], kLogZero), fmaxf(R.stay[k], kLogZero));
    if (spnb <= kHalfLogZero) spnb = kLogZero;
    R.spnb[k] = spnb;
    R.stay[k] = lae(fmaxf(R.spb[k], kHalfLogZero), fmaxf(spnb, kHalfLogZero));
    int c = R.head[R.rep[k]];             // beam k's class list, as parent
#pragma unroll
    for (int q = 0; q < kCached; ++q) {
      R.cons[k * kCached + q] = c >= 0 ? S.last[c] : -1;
      c = c >= 0 ? R.next[c] : -1;
    }
    if (c >= 0) R.cons[k * kCached + kCached - 1] = -2;
  }
}

// One thread's candidate keys, the beam's values and its cached consumed
// symbols kept while its j stays the same (a thread's candidates are runs
// of one beam's symbols; the class list walked only when it is longer than
// the cache): stay i < K, else extension (j, v), LOG_ZERO where a beam of
// j's class list ends in v.
struct Cand {
  int j = -1;
  float pb, total;
  int last, cons[kCached];
  long long roff;

  __device__ __forceinline__ uint32_t key(const BeamArgs& a, const Row& R,
                                          const State& S, const float* lpr,
                                          int i, int j_, int v) {
    if (i < a.K) return order_key(R.stay[i]);
    if (j_ != j) {
      j = j_;
      pb = S.pb[j];
      total = R.total[j];
      last = S.last[j];
      roff = R.roff[j];
#pragma unroll
      for (int q = 0; q < kCached; ++q) cons[q] = R.cons[j * kCached + q];
    }
    const float s = ext_raw(a, lpr, pb, total, last, roff, v);
    bool consumed = false;
#pragma unroll
    for (int q = 0; q < kCached; ++q) consumed |= cons[q] == v;
    for (int k = cons[kCached - 1] == -2 ? R.head[R.rep[j]] : -1;
         !consumed && k >= 0; k = R.next[k])
      consumed = S.last[k] == v;
    return order_key(v > 0 && consumed ? kLogZero : s);
  }
};

// (j, v) of flat index i (a stay: j < 0), and its step of d indices
struct Walk {
  int j, v, dj, dv;
  __device__ __forceinline__ Walk(int i, int d, int K, const FastDiv& fv) {
    const int V = static_cast<int>(fv.d), e = i - K;
    j = e >= 0 ? fv.div(e) : -1 - fv.div(-e - 1);      // floor division
    v = e - j * V;
    dj = fv.div(d);
    dv = d - dj * V;
  }
  __device__ __forceinline__ void step(int V) {
    j += dj;
    v += dv;
    if (v >= V) {
      v -= V;
      ++j;
    }
  }
};

// 5. the new state from the sorted top-K words, the traceback of frame t
__device__ __forceinline__ void advance(const BeamArgs& a, const Row& R,
                                        const State& S, const State& X,
                                        const FastDiv& fv,
                                        const unsigned long long* top,
                                        int32_t* tb, int t) {
  const int K = a.K, V = a.V, CL = a.ctx_len;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const unsigned long long c = top[k];
    const int idx = word_index(c);
    const bool is_stay = idx < K;
    const int e = max(idx - K, 0);
    const int parent = is_stay ? idx : fv.div(e);
    const int ch = is_stay ? -1 : e - parent * V;
    X.pb[k] = is_stay ? R.spb[parent] : kLogZero;
    X.pnb[k] = is_stay ? R.spnb[parent]
                           : key_score(static_cast<uint32_t>(c >> 32));
    const int ph = S.h[parent], ph2 = S.h2[parent];
    X.h[k] = is_stay ? ph : roll(ph, ch, kHashMult, kHashMod);
    X.h2[k] = is_stay ? ph2 : roll(ph2, ch, kHashMult2, kHashMod2);
    X.ph[k] = is_stay ? S.ph[parent] : ph;
    X.ph2[k] = is_stay ? S.ph2[parent] : ph2;
    X.last[k] = is_stay ? S.last[parent] : ch;
    const bool shift_ctx = !is_stay && a.lm_order > 1;
    const int* pc = S.ctx + parent * CL;
    for (int q = 0; q < CL; ++q)
      X.ctx[k * CL + q] =
          shift_ctx ? (q + 1 < CL ? pc[q + 1] : ch) : pc[q];
    if (tb != nullptr)
      tb[static_cast<long long>(t) * K + k] = (parent << 16) | (ch & 0xffff);
  }
}

// after the frames: the state out, the final scores in their order, the
// traceback of `keep` beams (count the emissions, then write the first
// `width` of them in time order); s and tmp hold K rounded up to 32 words
__device__ __forceinline__ void finish(const BeamArgs& a, const Row& R,
                                       const State& S, int b, int n,
                                       const int32_t* tb,
                                       unsigned long long* s,
                                       unsigned long long* tmp) {
  const int K = a.K, CL = a.ctx_len;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    R.stay[k] = lae(fmaxf(S.pb[k], kHalfLogZero),
                    fmaxf(S.pnb[k], kHalfLogZero));
    const long long o = static_cast<long long>(b) * K + k;
    a.pb_out[o] = S.pb[k];
    a.pnb_out[o] = S.pnb[k];
    a.h_out[o] = S.h[k];
    a.h2_out[o] = S.h2[k];
    a.ph_out[o] = S.ph[k];
    a.ph2_out[o] = S.ph2[k];
    a.last_out[o] = S.last[k];
    for (int c = 0; c < CL; ++c)
      a.ctx_out[o * CL + c] = S.ctx[k * CL + c];
    s[k] = word(order_key(R.stay[k]), k);
  }
  __syncthreads();
  const unsigned long long* sorted = a.ordered ? sort_desc(s, tmp, K) : s;
  int* order = R.rep;
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    const int k = a.ordered ? word_index(sorted[r]) : r;
    order[r] = k;
    a.out_final[static_cast<long long>(b) * K + r] = R.stay[k];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < a.keep; r += blockDim.x) {
    int cur = order[r], cnt = 0;
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
    cur = order[r];
    int pos = cnt;
    for (int t = n - 1; t >= 0; --t) {
      const int e = tb[static_cast<long long>(t) * K + cur];
      const int ch = static_cast<int16_t>(e & 0xffff);
      if (ch >= 0 && --pos < W) out[pos] = ch;
      cur = e >> 16;
    }
  }
}

// ---------------------------------------------------------------------------
// the narrow form
// ---------------------------------------------------------------------------

struct NarrowShared {
  float pb[2][kMaxBeam], pnb[2][kMaxBeam];
  int h[2][kMaxBeam], h2[2][kMaxBeam], ph[2][kMaxBeam], ph2[2][kMaxBeam];
  int last[2][kMaxBeam];
  int ctx[2][kMaxBeam * kMaxCtx];
  float total[kMaxBeam], spb[kMaxBeam], spnb[kMaxBeam], stay[kMaxBeam];
  long long roff[kMaxBeam];
  int rep[kMaxBeam], head[kMaxBeam], next[kMaxBeam];
  int cons[kMaxBeam * kCached];
  unsigned long long wl[kThreads * kMaxSplit / 32][32];  // warps' bests
  unsigned long long top[kMaxBeam], fin[kMaxBeam];
  unsigned long long thr;
  int n_list;
};

template <int NT, bool kStage>
__global__ void __launch_bounds__(NT, 1) beam_kernel(const BeamArgs a) {
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ NarrowShared sh;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int T = a.T, V = a.V, K = a.K;
  const int n = min(max(a.lengths[b], 0), T);
  const int N = K + K * V;
  const int m = (N + NT - 1) / NT;             // candidates a thread
  const Plan P = make_plan(T, V, K, a.ctx_len, 0);
  float* s_lp = reinterpret_cast<float*>(dyn);                  // [2][V]
  uint32_t* keys = reinterpret_cast<uint32_t*>(dyn + P.keys);   // [N]
  unsigned long long* list =
      reinterpret_cast<unsigned long long*>(dyn + P.list);      // [cap]
  int32_t* tb = P.tb_shared
                    ? reinterpret_cast<int32_t*>(dyn + P.tb)
                    : a.tb_scratch + static_cast<long long>(b) * T * K;
  const float* lp_row = a.lp + static_cast<long long>(b) * T * V;
  Row R;
  R.pb = sh.pb[0];
  R.pnb = sh.pnb[0];
  R.h = sh.h[0];
  R.h2 = sh.h2[0];
  R.ph = sh.ph[0];
  R.ph2 = sh.ph2[0];
  R.last = sh.last[0];
  R.ctx = sh.ctx[0];
  R.cs = kMaxBeam;
  R.ccs = kMaxBeam * kMaxCtx;
  R.total = sh.total;
  R.spb = sh.spb;
  R.spnb = sh.spnb;
  R.stay = sh.stay;
  R.roff = sh.roff;
  R.rep = sh.rep;
  R.head = sh.head;
  R.next = sh.next;
  R.cons = sh.cons;
  const FastDiv fv(V);

  load_state(a, state_of(R, 0), b);
  lp_first<kStage>(lp_row, s_lp, n, V);
  int st = 0;

  for (int t = 0; t < n; ++t) {
    const float* lpr = lp_row_of<kStage>(lp_row, s_lp, t, n, V);
    const State S = state_of(R, st);
    __syncthreads();
    prepare(a, R, S, lpr);
    if (tid == 0) sh.n_list = 0;
    __syncthreads();
    merge_stays(a, R, S, lpr);
    __syncthreads();

    // 4a. each candidate's key once; each thread's best word over its run
    // of m consecutive indices (one symbol's extensions of different beams
    // lie V apart, in different threads)
    unsigned long long best = 0;
    {
      const int i_end = min(N, (tid + 1) * m);
      Walk w(tid * m, 1, K, fv);
      Cand cand;
#pragma unroll 4
      for (int i = tid * m; i < i_end; ++i) {
        const uint32_t key = cand.key(a, R, S, lpr, i, w.j, w.v);
        keys[i] = key;
        const unsigned long long c = word(key, i);
        best = c > best ? c : best;
        w.step(V);
      }
    }
    // the K-th best thread best: each thread's rank in its warp places the
    // warp's bests in order; an entry of a warp's top K adds the entries
    // above it in the other warps' lists (their searches side by side)
    const int q = warp_rank(best);
    sh.wl[warp][q] = best;
    __syncthreads();
    if (q < K) {
      int rank = q;
#pragma unroll
      for (int w2 = 0; w2 < NW; ++w2)
        if (w2 != warp) rank += count_above32(sh.wl[w2], best);
      if (rank == K - 1) sh.thr = best;
    }
    __syncthreads();
    // 4b. the candidates at or above it, ranked among themselves
    const unsigned long long thr = sh.thr;
#pragma unroll 4
    for (int i = tid; i < N; i += NT) {
      const unsigned long long c = word(keys[i], i);
      if (c >= thr) list[atomicAdd(&sh.n_list, 1)] = c;
    }
    __syncthreads();
    const int nl = sh.n_list;
    for (int s = tid; s < nl; s += NT) {
      const unsigned long long c = list[s];
      int rank = 0;
      for (int x = 0; x < nl; ++x) rank += list[x] > c ? 1 : 0;
      if (rank < K) sh.top[rank] = c;
    }
    __syncthreads();

    advance(a, R, S, state_of(R, st ^ 1), fv, sh.top, tb, t);
    st ^= 1;
    __syncthreads();
  }
  finish(a, R, state_of(R, st), b, n, tb, sh.fin, sh.top);
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

template <int NT, bool kStage>
int launch(const BeamArgs& a, size_t smem, cudaStream_t stream) {
  auto fn = beam_kernel<NT, kStage>;
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<a.B, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the wide form
// ---------------------------------------------------------------------------

template <bool kStage, bool kWsShared>
__global__ void __launch_bounds__(kWideThreads, 1)
    beam_wide_kernel(const BeamArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int hist[2][kRadixBins];
  __shared__ int wsum[kWideWarps], wcount[kWideWarps];
  __shared__ uint32_t sel_prefix;
  __shared__ int sel_need, sel_all, n_loc;
  __shared__ int pub[2];     // this block's survivors above, ties
  const int C = static_cast<int>(cluster_size());
  const int rank = static_cast<int>(cluster_rank());
  const int b = blockIdx.x / C, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int T = a.T, V = a.V, K = a.K, CL = a.ctx_len;
  const int n = min(max(a.lengths[b], 0), T);
  const int N = K + K * V;
  const Plan P = make_plan(T, V, K, CL, 1);
  const WideLayout L = wide_layout(K, CL);
  float* s_lp = reinterpret_cast<float*>(dyn);                  // [2][V]
  unsigned char* ws =
      kWsShared ? dyn + P.ws
                : static_cast<unsigned char*>(a.ws_scratch) + b * L.bytes;
  uint32_t* keys = reinterpret_cast<uint32_t*>(dyn + P.keys);
  int32_t* tb = rank != 0 ? nullptr
                : P.tb_shared
                    ? reinterpret_cast<int32_t*>(dyn + P.tb)
                    : a.tb_scratch + static_cast<long long>(b) * T * K;
  float* wf = reinterpret_cast<float*>(ws);
  int* wi = reinterpret_cast<int*>(ws);
  unsigned long long* loc =
      reinterpret_cast<unsigned long long*>(ws + L.loc);
  unsigned long long* surv =
      reinterpret_cast<unsigned long long*>(ws + L.surv);
  unsigned long long* tmp = reinterpret_cast<unsigned long long*>(ws + L.tmp);
  Row R;
  R.pb = wf + kWPb * K;
  R.pnb = wf + kWPnb * K;
  R.h = wi + kWH * K;
  R.h2 = wi + kWH2 * K;
  R.ph = wi + kWPh * K;
  R.ph2 = wi + kWPh2 * K;
  R.last = wi + kWLast * K;
  R.ctx = reinterpret_cast<int*>(ws + L.ctx);
  R.cs = K;
  R.ccs = K * CL;
  R.total = wf + kWTotal * K;
  R.spb = wf + kWSpb * K;
  R.spnb = wf + kWSpnb * K;
  R.stay = wf + kWStay * K;
  R.roff = reinterpret_cast<long long*>(ws + L.roff);
  R.rep = wi + kWRep * K;
  R.head = wi + kWHead * K;
  R.next = wi + kWNext * K;
  R.cons = wi + kWCons * K;
  const FastDiv fv(V);
  const float* lp_row = a.lp + static_cast<long long>(b) * T * V;
  // this block's index range, warp w's part of it [i0 - lane, iend)
  const int nb = (N + C - 1) / C;
  const int lo = rank * nb, hi = min(N, lo + nb);
  const int span = ((nb + kWideWarps - 1) / kWideWarps + 31) / 32 * 32;
  const int i0 = lo + warp * span + lane;
  const int iend = min(hi, lo + (warp + 1) * span);
  const bool stored = P.keys_shared;

  load_state(a, state_of(R, 0), b);
  for (int q = tid; q < 2 * kRadixBins; q += kWideThreads)
    hist[q / kRadixBins][q % kRadixBins] = 0;
  lp_first<kStage>(lp_row, s_lp, n, V);
  row_sync(C);              // the peers run before any reads their memory
  int st = 0, pc = 0;

  for (int t = 0; t < n; ++t) {
    const float* lpr = lp_row_of<kStage>(lp_row, s_lp, t, n, V);
    const State S = state_of(R, st);
    __syncthreads();
    prepare(a, R, S, lpr);
    if (tid == 0) n_loc = 0;
    __syncthreads();
    merge_stays(a, R, S, lpr);
    __syncthreads();
    // visits this thread's indices in order, 32 a warp a round, f(valid,
    // i, key) for every lane of every round (the warps stay converged)
    auto visit = [&](auto&& f) {
      if (stored) {
        for (int r = 0; r < span; r += 32) {
          const int i = i0 + r;
          const bool valid = i < iend;
          f(valid, i, valid ? keys[i - lo] : 0u);
        }
      } else {
        Walk w(i0, 32, K, fv);
        Cand cand;
        for (int r = 0; r < span; r += 32) {
          const int i = i0 + r;
          const bool valid = i < iend;
          f(valid, i, valid ? cand.key(a, R, S, lpr, i, w.j, w.v) : 0u);
          w.step(V);
        }
      }
    };

    // 4. radix select: pass 0 computes every key (kept where they fit)
    uint32_t prefix = 0;
    int need = K, shift = 0;
    bool all = false;
    for (int pass = 0; pass < 3; ++pass) {
      const int bits = pass < 2 ? kDigitBits : 32 - 2 * kDigitBits;
      shift = 32 - kDigitBits * pass - bits;
      int* hb = hist[pc & 1];
      auto count = [&](bool valid, int, uint32_t key) {
        int bin = -1;
        if (valid && (pass == 0 || (key >> (shift + bits)) == prefix))
          bin = static_cast<int>((key >> shift) & ((1u << bits) - 1u));
        if (__any_sync(0xffffffffu, bin >= 0)) {
          const unsigned peers = __match_any_sync(0xffffffffu, bin);
          if (bin >= 0 && lane == __ffs(peers) - 1)
            atomicAdd(&hb[bin], __popc(peers));
        }
      };
      if (pass == 0) {
        Walk w(i0, 32, K, fv);
        Cand cand;
        for (int r = 0; r < span; r += 32) {
          const int i = i0 + r;
          const bool valid = i < iend;
          const uint32_t key =
              valid ? cand.key(a, R, S, lpr, i, w.j, w.v) : 0u;
          if (valid && stored) keys[i - lo] = key;
          count(valid, i, key);
          w.step(V);
        }
      } else {
        visit(count);
      }
      row_sync(C);
      // the digit whose bin holds the need-th key, bins in descending
      // order over the threads (the row's blocks' counts summed)
      const int nbins = 1 << bits, per = nbins / kWideThreads;
      int cnt[kRadixBins / kWideThreads], sum = 0;
#pragma unroll
      for (int q = 0; q < kRadixBins / kWideThreads; ++q) {
        cnt[q] = 0;
        if (q < per) {
          const int bin = nbins - 1 - (tid * per + q);
          for (int c = 0; c < C; ++c) cnt[q] += peer_int(hb + bin, c, rank);
          sum += cnt[q];
        }
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      int above = incl - sum;
      for (int w = 0; w < warp; ++w) above += wsum[w];
      if (above < need && need <= above + sum) {
        int digit = 0, in_bin = 0;
        bool found = false;
#pragma unroll
        for (int q = 0; q < kRadixBins / kWideThreads; ++q) {
          if (!found && q < per) {
            if (above + cnt[q] >= need) {
              found = true;
              digit = nbins - 1 - (tid * per + q);
              in_bin = cnt[q];
            } else {
              above += cnt[q];
            }
          }
        }
        sel_prefix = (prefix << bits) | static_cast<uint32_t>(digit);
        sel_need = need - above;
        sel_all = in_bin == need - above;
      }
      for (int q = tid; q < kRadixBins; q += kWideThreads)
        hist[(pc & 1) ^ 1][q] = 0;     // the next pass's (read a pass ago)
      __syncthreads();
      prefix = sel_prefix;
      need = sel_need;
      all = sel_all != 0;
      ++pc;
      if (all) break;
    }

    // the survivors: keys above the threshold class (the class too when
    // all of it is taken) in any order, then the class's first `need`
    // members in ascending index
    int ties = 0;
    visit([&](bool valid, int i, uint32_t key) {
      const uint32_t h = key >> shift;
      if (valid && (h > prefix || (all && h == prefix)))
        loc[atomicAdd(&n_loc, 1)] = word(key, i);
      ties += __popc(__ballot_sync(0xffffffffu, valid && !all &&
                                                    h == prefix));
    });
    if (lane == 0) wcount[warp] = ties;
    __syncthreads();
    if (tid == 0) {
      int s = 0;
      for (int w = 0; w < kWideWarps; ++w) s += wcount[w];
      pub[0] = n_loc;
      pub[1] = s;
    }
    row_sync(C);
    int off_above = 0, tie_base = 0, n_above = 0;
    for (int c = 0; c < C; ++c) {
      const int na = peer_int(&pub[0], c, rank);
      if (c < rank) {
        off_above += na;
        tie_base += peer_int(&pub[1], c, rank);
      }
      n_above += na;
    }
    auto put = [&](int slot, unsigned long long v) {
      if (C == 1) {
        surv[slot] = v;
      } else {
        for (int c = 0; c < C; ++c)
          st_cluster(map_rank(surv + slot, static_cast<uint32_t>(c)), v);
      }
    };
    for (int x = tid; x < n_loc; x += kWideThreads)
      put(off_above + x, loc[x]);
    if (!all) {
      int base = tie_base;
      for (int w = 0; w < warp; ++w) base += wcount[w];
      if (ties > 0 && base < need) {
        visit([&](bool valid, int i, uint32_t key) {
          const bool tie = valid && (key >> shift) == prefix;
          const unsigned m = __ballot_sync(0xffffffffu, tie);
          const int pos = base + __popc(m & ((1u << lane) - 1u));
          if (tie && pos < need) put(n_above + pos, word(key, i));
          base += __popc(m);
        });
      }
    }
    row_sync(C);
    const unsigned long long* top = sort_desc(surv, tmp, K);

    advance(a, R, S, state_of(R, st ^ 1), fv, top, tb, t);
    st ^= 1;
    __syncthreads();
  }
  if (rank == 0) finish(a, R, state_of(R, st), b, n, tb, surv, tmp);
  row_sync(C);              // no block leaves while a peer may read it
}

template <bool kStage, bool kWsShared>
int launch_wide(const BeamArgs& a, int C, size_t smem, cudaStream_t stream) {
  auto fn = beam_wide_kernel<kStage, kWsShared>;
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * C);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// The launch plan of a call (make_plan, beam_plan.cuh): out[0] = 1 for the
// wide form (K > 32, an LM context past 8 lanes, a row whose keys pass the
// narrow form's shared memory, or `wide` asked for), out[1] = 1 if lp rows
// are staged in shared memory, out[2] = 1 if the tracebacks fit in shared
// memory (else the caller's [B, T, K] int32 scratch holds them), out[3] = 1
// if the wide form's workspace fits in shared memory (else the caller's [B,
// out[5]] byte scratch holds it; 1 for the narrow form, whose state is
// static), out[4] = dynamic shared bytes a block, out[5] = the workspace's
// bytes a row (0 for the narrow form), out[6] = the split (the narrow
// form's threads / 128, the wide form's blocks a row), out[7] = 1 if the
// keys of a block's candidates stay in shared memory (else the wide form
// computes them again each sweep).
CSR_API int csr_beam_plan(int T, int V, int K, int ctx_len, int wide,
                          int* out) {
  plan_out(T, V, K, ctx_len, wide, out);
  return 0;
}

// The narrow form. Requires 1 <= K <= 32, 1 <= V <= 32767, 1 <= T,
// ctx_len <= 8, keep <= K, width >= 0, a row csr_beam_plan gives the
// narrow form; tb_scratch non-null exactly when the plan says the
// tracebacks do not fit in shared memory (the wrapper checks all of it).
CSR_API int csr_beam(const BeamArgs* args, cudaStream_t stream) {
  BeamArgs a = *args;
  if (a.B < 1 || a.T < 1 || a.V < 1 || a.V > 32767 || a.K < 1 ||
      a.K > kMaxBeam || a.ctx_len < 1 || a.ctx_len > kMaxCtx ||
      a.keep < 0 || a.keep > a.K || a.width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(a.T, a.V, a.K, a.ctx_len, 0);
  if (p.wide || (a.tb_scratch == nullptr) != (p.tb_shared == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(p.smem);
  if (p.split == kMaxSplit) {
    return p.staged ? launch<kThreads * kMaxSplit, true>(a, smem, stream)
                    : launch<kThreads * kMaxSplit, false>(a, smem, stream);
  }
  return p.staged ? launch<kThreads, true>(a, smem, stream)
                  : launch<kThreads, false>(a, smem, stream);
}

// The wide form. Requires 1 <= K <= 32767 (the tracebacks pack the parent
// into 16 bits), 1 <= V <= 32767, 1 <= T, ctx_len >= 1, keep <= K, width
// >= 0; tb_scratch and ws_scratch non-null exactly where csr_beam_plan
// (wide = 1) places the tracebacks and the workspace in global memory. A
// cluster launch the card refuses returns its error.
CSR_API int csr_beam_wide(const BeamArgs* args, cudaStream_t stream) {
  BeamArgs a = *args;
  if (a.B < 1 || a.T < 1 || a.V < 1 || a.V > 32767 || a.K < 1 ||
      a.K > kMaxWideBeam || a.ctx_len < 1 || a.keep < 0 || a.keep > a.K ||
      a.width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(a.T, a.V, a.K, a.ctx_len, 1);
  if ((a.tb_scratch == nullptr) != (p.tb_shared == 1) ||
      (a.ws_scratch == nullptr) != (p.ws_shared == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(p.smem);
  if (p.staged) {
    return p.ws_shared ? launch_wide<true, true>(a, p.split, smem, stream)
                       : launch_wide<true, false>(a, p.split, smem, stream);
  }
  return p.ws_shared ? launch_wide<false, true>(a, p.split, smem, stream)
                     : launch_wide<false, false>(a, p.split, smem, stream);
}
