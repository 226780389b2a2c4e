// Flash self-attention backward: dQ over key tiles, dK and dV over query
// tiles, with the probabilities recomputed from the forward's logsumexp
// rows (nothing [T, T] is ever stored).
//
// Replaces ops/attention_pallas.py::_bwd_dq_kernel and ::_bwd_dkv_kernel
// (the TPU kernels behind _flash_backward). The split is the TPU's: the dQ
// kernel walks key tiles, the dK/dV kernel walks query tiles, so each
// output tile has one owner block and neither kernel needs atomics: both
// are deterministic, bitwise from run to run.
//
// q, k, v, dO are read as [B, T, h, dh] through their strides; lse and
// D = rowsum(dO * O) are [B, h, T] fp32 (D is computed by one torch op
// before the launch, as the reference computes it in XLA); dq, dk, dv are
// [B, T, h, dh] contiguous in the compute dtype. Per tile pair:
//   p  = exp(q.k^T * scale - lse)  where allowed, else exactly 0
//   ds = p * (dO.v^T - D)          (p unrounded)
//   dq += round(ds) . k,  dv += round(p)^T . dO,  dk += round(ds)^T . q
// with fp32 accumulators and the scale applied to dq and dk after the sum,
// as the TPU kernels round p and ds to the input dtype before their
// products.
//
// What bounds them on Hopper: operations. Each kernel recomputes q.k^T and
// dO.v^T, so dK/dV does 8*dh operations an allowed (query, key) pair and
// dQ 6*dh, against ~16*dh bytes a row: at T' ~ 700 some 300 operations a
// byte, above the bf16 ridge (989 TFLOP/s / 3.35 TB/s = 295).
//
// bf16, dh = 64 (both presets): the products run on the tensor cores,
// mma.sync m16n8k16 with fp32 accumulators (FlashAttention-2's design). One
// block per (b*h, 64-row tile), four warps, each owning 16 rows of the tile:
// 16 keys in dK/dV, which computes the transposed scores S^T = K.Q^T and
// dP^T = V.dO^T, 16 queries in dQ. The accumulators of S and dP become p
// and ds in registers and, rounded to bf16 where the plain version rounds
// them, the A operands of the next products (dV += P^T.dO, dK += dS^T.Q;
// dQ += dS.K) without a trip through shared memory. The operands stay
// bf16 in shared memory, [64][64] tiles whose 16-byte chunks are XOR-
// swizzled by row (no bank conflicts for ldmatrix or for the copies in);
// the streamed tiles (Q, dO, lse, D for dK/dV; K, V for dQ) arrive by
// cp.async, zero-filled past T, double-buffered so the next tile is in
// flight while the current one is multiplied. A warp holds the scores of
// 32 columns at a time, which keeps the registers (dK/dV: two 16 x 64 fp32
// accumulators) within 168 a thread, three blocks an SM; shared memory is
// 48-49 KB a block. p is exp2 of one fma. The tensor cores sum q.k and
// dO.v in another order than the plain version's fp32 matmul, so a p or ds
// near a bf16 rounding midpoint may round one ulp the other way: the
// gradients are held to a bar derived from that rounding (2^-7 |b| plus
// the sum of one bf16 ulp of each p or ds times its partner operand, plus
// 1e-3: attention_cuda.bwd_rounding_room). mma.sync rather than wgmma: a
// warp's 16 rows are the unit of FlashAttention-2's register reuse,
// wgmma's 64-row warpgroup tiles would need its descriptors and a producer
// warp; mma.sync issues at a lower rate than wgmma on Hopper, the cost of
// this simpler design.
//
// Wider heads (dh = 64n, n = 2 .. 8, the reference's set), bf16: as in the
// forward (attention_fwd.cu), the outputs' head columns are split over a
// grid dimension of n 64-column slices. The block's own rows (Q and dO in
// dQ, K and V in dK/dV) stay in shared memory as n chunk tiles; the
// other side streams through a two-stage ring a chunk at a time, so each
// 64 x 64 score tile S and dP (S^T and dP^T in dK/dV) is summed over the
// head dim in the same order in every slice, and a last step per tile
// brings the slice's columns of the product's operand (K_z in dQ; Q_z and
// dO_z in dK/dV, with lse and D). Shared memory: (2n + 4) 8 KB tiles, 160
// KB at dh = 512 (holding both sides whole with two stages would be 384
// KB); registers: full 64-column S and dP beside the 64-column
// accumulators, two blocks an SM. The score products are repeated in each
// of the n slices, the price of this simple design.
//
// fp32 (the parity runs only): the first version's FMA path, with fp32
// [64][65] tiles in shared memory (attention_common.cuh) and the wide
// heads' column split at every dh: the scores summed over the head dim's
// chunks, then the product with the slice's chunk. TF32 tensor cores would
// keep ~3 decimal digits and miss the fp32 gradient bar (3e-4).
//
// The window: dQ walks the key tiles between the bounds of its rows'
// length and chunk window (key_range); dK/dV walks every query tile whose
// rows may attend one of its keys (query_range: every query row < T,
// padded rows included, as the TPU kernel does); a key tile at or past the
// row's length writes zeros.
#include "attention_mma.cuh"

namespace {

using namespace csr_attn;

// ------------------------------------------------------------- fp32 (FMA)

// scores and dO.v^T of the tile pair: s[i][j] = q_i.k_j, dp[i][j] = do_i.v_j
// for the thread's rows 4ty+i and columns tx+16j
template <int DH>
__device__ __forceinline__ void scores_and_dp(const float* Qs,
                                              const float* dOs,
                                              const float* Ks,
                                              const float* Vs, int ty,
                                              int tx, float s[4][4],
                                              float dp[4][4]) {
#pragma unroll 4
  for (int dd = 0; dd < DH; ++dd) {
    float a[4], g[4], kk[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(4 * ty + i) * (DH + 1) + dd];
      g[i] = dOs[(4 * ty + i) * (DH + 1) + dd];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kk[j] = Ks[(tx + 16 * j) * (DH + 1) + dd];
      vv[j] = Vs[(tx + 16 * j) * (DH + 1) + dd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
}

// p and ds of the tile pair (queries q0.., keys k0..) into [64][65] tiles
__device__ __forceinline__ void probs_and_ds(
    float s[4][4], float dp[4][4], int q0, int k0, int len, const Dims& d,
    const float* lse_row, const float* d_row, float scale, int ty, int tx,
    float* Ps, float* dSs) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    const bool row = t < d.T;
    const float lse_t = row ? lse_row[t] : 0.0f;
    const float d_t = row ? d_row[t] : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = row && allowed(t, k0 + tx + 16 * j, len, d);
      const float p = ok ? expf(s[i][j] * scale - lse_t) : 0.0f;
      if (Ps) Ps[(4 * ty + i) * kLdP + tx + 16 * j] = p;
      dSs[(4 * ty + i) * kLdP + tx + 16 * j] = p * (dp[i][j] - d_t);
    }
  }
}

// dQ: one block per (b*h, 64-query tile, 64-column slice z of the head
// dim); per key tile the scores and dO.V^T summed over the head dim's
// chunks (the same order in every slice), then dq_z += ds . K_z
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const int* __restrict__ lens,
                    const float* __restrict__ lse,
                    const float* __restrict__ drows, float* __restrict__ dq,
                    Dims d, Strides sq, Strides sk, Strides sv,
                    Strides sdo) {
  constexpr int LD = kDh + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;         // [64][65]

  const int nc = d.dh / kDh, col0 = blockIdx.z * kDh;
  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int q0 = blockIdx.x * kTile;
  const int len = max(0, min(lens[b], d.T));
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float scale = 1.0f / sqrtf(static_cast<float>(d.dh));
  const float* lse_row = lse + static_cast<int64_t>(bh) * d.T;
  const float* d_row = drows + static_cast<int64_t>(bh) * d.T;

  float acc[4][4] = {};
  int k_begin, k_end;
  key_range(q0, len, d, &k_begin, &k_end);
  for (int k0 = (k_begin / kTile) * kTile; k0 < k_end; k0 += kTile) {
    float s[4][4] = {}, dp[4][4] = {};
    for (int c = 0; c < nc; ++c) {
      __syncthreads();                  // the previous readers are done
      load_tile<float, kDh>(Qs, q + c * kDh, sq, b, head, q0, d.T);
      load_tile<float, kDh>(dOs, dout + c * kDh, sdo, b, head, q0, d.T);
      load_tile<float, kDh>(Ks, k + c * kDh, sk, b, head, k0, d.T);
      load_tile<float, kDh>(Vs, v + c * kDh, sv, b, head, k0, d.T);
      __syncthreads();
      scores_and_dp<kDh>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    }
    probs_and_ds(s, dp, q0, k0, len, d, lse_row, d_row, scale, ty, tx,
                 nullptr, dSs);
    if (nc > 1) {                       // K's chunk z for the product
      __syncthreads();
      load_tile<float, kDh>(Ks, k + col0, sk, b, head, k0, d.T);
    }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
      float g[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = dSs[(4 * ty + i) * kLdP + key];
#pragma unroll
      for (int c = 0; c < 4; ++c) kk[c] = Ks[key * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(g[i], kk[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= d.T) continue;
    float* o = dq + ((static_cast<int64_t>(b) * d.T + t) * d.h + head) * d.dh +
               col0;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[tx + 16 * c] = acc[i][c] * scale;
  }
}

// dK/dV: one block per (b*h, 64-key tile, 64-column slice z); per query
// tile the scores and dO.V^T summed over the head dim's chunks, then dv_z
// += p^T . dO_z and dk_z += ds^T . Q_z
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const int* __restrict__ lens,
                     const float* __restrict__ lse,
                     const float* __restrict__ drows, float* __restrict__ dk,
                     float* __restrict__ dv, Dims d, Strides sq, Strides sk,
                     Strides sv, Strides sdo) {
  constexpr int LD = kDh + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;         // [64][65]
  float* dSs = Ps + kTile * kLdP;       // [64][65]

  const int nc = d.dh / kDh, col0 = blockIdx.z * kDh;
  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int k0 = blockIdx.x * kTile;
  const int len = max(0, min(lens[b], d.T));
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float scale = 1.0f / sqrtf(static_cast<float>(d.dh));
  const float* lse_row = lse + static_cast<int64_t>(bh) * d.T;
  const float* d_row = drows + static_cast<int64_t>(bh) * d.T;

  // this thread's keys 4ty+i, head-dim columns col0 + tx+16c
  float ak[4][4] = {}, av[4][4] = {};
  if (k0 < len) {
    int q_begin, q_end;
    query_range(k0, len, d, &q_begin, &q_end);
    for (int q0 = (q_begin / kTile) * kTile; q0 < q_end; q0 += kTile) {
      float s[4][4] = {}, dp[4][4] = {};
      for (int c = 0; c < nc; ++c) {
        __syncthreads();                // the previous readers are done
        load_tile<float, kDh>(Ks, k + c * kDh, sk, b, head, k0, d.T);
        load_tile<float, kDh>(Vs, v + c * kDh, sv, b, head, k0, d.T);
        load_tile<float, kDh>(Qs, q + c * kDh, sq, b, head, q0, d.T);
        load_tile<float, kDh>(dOs, dout + c * kDh, sdo, b, head, q0, d.T);
        __syncthreads();
        scores_and_dp<kDh>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
      }
      probs_and_ds(s, dp, q0, k0, len, d, lse_row, d_row, scale, ty, tx, Ps,
                   dSs);
      if (nc > 1) {                     // Q's and dO's chunk z
        __syncthreads();
        load_tile<float, kDh>(Qs, q + col0, sq, b, head, q0, d.T);
        load_tile<float, kDh>(dOs, dout + col0, sdo, b, head, q0, d.T);
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float p[4], g[4], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[qq * kLdP + 4 * ty + i];
          g[i] = dSs[qq * kLdP + 4 * ty + i];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qv[c] = Qs[qq * LD + tx + 16 * c];
          gv[c] = dOs[qq * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            av[i][c] = fmaf(p[i], gv[c], av[i][c]);
            ak[i][c] = fmaf(g[i], qv[c], ak[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + 4 * ty + i;
    if (s >= d.T) continue;
    const int64_t off =
        ((static_cast<int64_t>(b) * d.T + s) * d.h + head) * d.dh + col0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dk[off + tx + 16 * c] = ak[i][c] * scale;
      dv[off + tx + 16 * c] = av[i][c];
    }
  }
}

// ------------------------------------------------- bf16 (tensor cores)

constexpr int kRowsBytes = 2 * 2 * kTile * 4;  // lse and D, two stages

// p = exp(s * scale - lse), the fast form
__device__ __forceinline__ float prob(float s, float scale, float lse_t) {
  return exp2f(fmaf(s, scale * kLog2e, -lse_t * kLog2e));
}

// p (into s) and ds = p (dP - D) (into dp) of a warp's 16 query rows
// against 32 keys, n-tile j holding keys key0 + 8j + 2 (l % 4) + {0, 1};
// p is exactly 0 outside each row's window [s_lo, s_hi)
__device__ __forceinline__ void probs_by_key(float s[4][4], float dp[4][4],
                                             int key0, const int s_lo[2],
                                             const int s_hi[2],
                                             const float lse_r[2],
                                             const float dr[2], float scale,
                                             int l) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int key = key0 + 8 * j + 2 * (l & 3) + (e & 1);
      const bool ok = key >= s_lo[i] && key < s_hi[i];
      s[j][e] = ok ? prob(s[j][e], scale, lse_r[i]) : 0.0f;
      dp[j][e] = s[j][e] * (dp[j][e] - dr[i]);
    }
}

// the same for a warp's 16 key rows (S^T, dP^T) against the 32 queries
// q0 + c0 + 8j + 2 (l % 4) + {0, 1}, their lse and D in shared memory
// (lse_s[c], d_s[c] of query q0 + c); p is 0 outside [t_lo, t_hi)
__device__ __forceinline__ void probs_by_query(float s[4][4], float dp[4][4],
                                               int q0, int c0,
                                               const int t_lo[2],
                                               const int t_hi[2],
                                               const float* lse_s,
                                               const float* d_s, float scale,
                                               int l) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int c = c0 + 8 * j + 2 * (l & 3) + (e & 1);
      const int t = q0 + c;
      const bool ok = t >= t_lo[i] && t < t_hi[i];
      s[j][e] = ok ? prob(s[j][e], scale, lse_s[c]) : 0.0f;
      dp[j][e] = s[j][e] * (dp[j][e] - d_s[c]);
    }
}

// lse and D of this thread's queries t0 + 8i (0 past T)
__device__ __forceinline__ void query_rows(const float* lse,
                                           const float* drows, int bh,
                                           int t0, const Dims& d,
                                           float lse_r[2], float dr[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + 8 * i;
    const bool row = t < d.T;
    const int64_t at = static_cast<int64_t>(bh) * d.T + t;
    lse_r[i] = row ? lse[at] : 0.0f;
    dr[i] = row ? drows[at] : 0.0f;
  }
}

// S (or S^T) and dP (or dP^T) of a warp's 16 rows against 32 columns:
// x = A_x . Bx^T, y = A_y . By^T over the head dim, A rows r0.. of tiles
// ax, ay; B rows c0.. of tiles bx, by
__device__ __forceinline__ void scores_tc(uint32_t ax, uint32_t ay,
                                          uint32_t bx, uint32_t by, int r0,
                                          int c0, int l, float x[4][4],
                                          float y[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    uint32_t fa[4], fb[4];
    ldsm_x4(a_frag(ax, r0, kk, l), fa);
    ldsm_x4(a_frag(ay, r0, kk, l), fb);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      uint32_t gx[4], gy[4];
      ldsm_x4(b_frag(bx, c0 + 16 * nb, kk, l), gx);
      ldsm_x4(b_frag(by, c0 + 16 * nb, kk, l), gy);
      mma(x[2 * nb], fa, gx[0], gx[1]);
      mma(x[2 * nb + 1], fa, gx[2], gx[3]);
      mma(y[2 * nb], fb, gy[0], gy[1]);
      mma(y[2 * nb + 1], fb, gy[2], gy[3]);
    }
  }
}

// dQ: a block owns 64 queries (Q, dO resident), walks the key tiles of
// its window with K, V double-buffered; warp w owns queries 16w..16w+15
__global__ void __launch_bounds__(kThreadsTc, 3)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const int* __restrict__ lens,
                       const float* __restrict__ lse,
                       const float* __restrict__ drows, bf16* __restrict__ dq,
                       Dims d, Strides sq, Strides sk, Strides sv,
                       Strides sdo) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  // Q, dO, then two stages of (K, V)
  const uint32_t sQ = smem_addr(smem_tc), sdO = sQ + kTileBytes;
  const uint32_t sKV = sQ + 2 * kTileBytes;

  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int q0 = blockIdx.x * kTile;
  const int len = max(0, min(lens[b], d.T));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const float scale = 1.0f / sqrtf(static_cast<float>(kDh));
  const bf16* kb = k + b * sk.b + head * sk.h;
  const bf16* vb = v + b * sv.b + head * sv.h;

  // this thread's queries t0 + 8i: lse, D and the keys [s_lo, s_hi) each
  // may attend (none past T)
  const int t0 = q0 + 16 * w + (l >> 2);
  float lse_r[2], dr[2];
  int s_lo[2], s_hi[2];
  query_rows(lse, drows, bh, t0, d, lse_r, dr);
  row_windows(t0, len, d, s_lo, s_hi);

  float acc[8][4] = {};
  int k_begin, k_end;
  key_range(q0, len, d, &k_begin, &k_end);
  const int first = (k_begin / kTile) * kTile;
  const int n = k_end > first ? (k_end - first + kTile - 1) / kTile : 0;
  if (n > 0) {
    load_tile_async(sQ, q + b * sq.b + head * sq.h, sq.t, q0, d.T);
    load_tile_async(sdO, dout + b * sdo.b + head * sdo.h, sdo.t, q0, d.T);
    load_tile_async(sKV, kb, sk.t, first, d.T);
    load_tile_async(sKV + kTileBytes, vb, sv.t, first, d.T);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    const int k0 = first + it * kTile;
    const uint32_t sK = sKV + (it & 1) * 2 * kTileBytes, sV = sK + kTileBytes;
    if (it + 1 < n) {
      const uint32_t nK = sKV + ((it + 1) & 1) * 2 * kTileBytes;
      load_tile_async(nK, kb, sk.t, k0 + kTile, d.T);
      load_tile_async(nK + kTileBytes, vb, sv.t, k0 + kTile, d.T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;
      float s[4][4], dp[4][4];
      scores_tc(sQ, sdO, sK, sV, 16 * w, c0, l, s, dp);
      probs_by_key(s, dp, k0 + c0, s_lo, s_hi, lse_r, dr, scale, l);
      uint32_t da[2][4];
      to_a_frags(dp, da);
      product_tc(acc, da, sK, c0, l);
    }
    __syncthreads();
  }
  store_rows(dq, acc, scale, b, t0, head, d, l);
}

// dK/dV: a block owns 64 keys (K, V resident), walks the query tiles that
// may attend them with Q, dO, lse and D double-buffered; warp w owns keys
// 16w..16w+15 and computes S^T, dP^T so P^T, dS^T are its A operands
__global__ void __launch_bounds__(kThreadsTc, 3)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const int* __restrict__ lens,
                        const float* __restrict__ lse,
                        const float* __restrict__ drows,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, Dims d,
                        Strides sq, Strides sk, Strides sv, Strides sdo) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  // K, V, two stages of (Q, dO), then two stages of (lse[64], D[64])
  const uint32_t sK = smem_addr(smem_tc), sV = sK + kTileBytes;
  const uint32_t sQO = sK + 2 * kTileBytes;
  float* rows = reinterpret_cast<float*>(smem_tc + 6 * kTileBytes);

  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int k0 = blockIdx.x * kTile;
  const int len = max(0, min(lens[b], d.T));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const float scale = 1.0f / sqrtf(static_cast<float>(kDh));
  const bf16* qb = q + b * sq.b + head * sq.h;
  const bf16* ob = dout + b * sdo.b + head * sdo.h;
  const float* lse_row = lse + static_cast<int64_t>(bh) * d.T;
  const float* d_row = drows + static_cast<int64_t>(bh) * d.T;

  const int s0 = k0 + 16 * w + (l >> 2);
  int t_lo[2], t_hi[2];
  key_windows(s0, len, d, t_lo, t_hi);

  // stage st: the Q and dO tiles, lse and D of queries [q0, q0 + 64)
  auto load_stage = [&](int st, int q0) {
    const uint32_t sQ = sQO + st * 2 * kTileBytes;
    load_tile_async(sQ, qb, sq.t, q0, d.T);
    load_tile_async(sQ + kTileBytes, ob, sdo.t, q0, d.T);
    const int t = q0 + (threadIdx.x & (kTile - 1));
    const float* src = threadIdx.x < kTile ? lse_row : d_row;
    cp_async4(smem_addr(rows + st * 2 * kTile + threadIdx.x),
              src + (t < d.T ? t : 0), t < d.T);
  };

  float acc_k[8][4] = {}, acc_v[8][4] = {};
  if (k0 < len) {
    int q_begin, q_end;
    query_range(k0, len, d, &q_begin, &q_end);
    const int first = (q_begin / kTile) * kTile;
    const int n = (q_end - first + kTile - 1) / kTile;
    load_tile_async(sK, k + b * sk.b + head * sk.h, sk.t, k0, d.T);
    load_tile_async(sV, v + b * sv.b + head * sv.h, sv.t, k0, d.T);
    load_stage(0, first);
    cp_async_commit();
    for (int it = 0; it < n; ++it) {
      const int q0 = first + it * kTile, st = it & 1;
      if (it + 1 < n) {
        load_stage(st ^ 1, q0 + kTile);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint32_t sQ = sQO + st * 2 * kTileBytes, sdO = sQ + kTileBytes;
      const float* lse_s = rows + st * 2 * kTile;
      const float* d_s = lse_s + kTile;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = 32 * half;
        float s[4][4], dp[4][4];
        scores_tc(sK, sV, sQ, sdO, 16 * w, c0, l, s, dp);
        probs_by_query(s, dp, q0, c0, t_lo, t_hi, lse_s, d_s, scale, l);
        uint32_t pa[2][4], da[2][4];
        to_a_frags(s, pa);
        to_a_frags(dp, da);
        product_tc(acc_v, pa, sdO, c0, l);
        product_tc(acc_k, da, sQ, c0, l);
      }
      __syncthreads();
    }
  }
  store_rows(dk, acc_k, scale, b, s0, head, d, l);
  store_rows(dv, acc_v, 1.0f, b, s0, head, d, l);
}

// S (or S^T) and dP (or dP^T) of a warp's 16 rows against 64 columns,
// summed over one 64-column chunk of the head dim: x += A_x . Bx^T, y +=
// A_y . By^T, A rows r0.. of the chunk tiles ax, ay, B rows 0..63 of bx, by
__device__ __forceinline__ void scores_chunk(uint32_t ax, uint32_t ay,
                                             uint32_t bx, uint32_t by,
                                             int r0, int l, float x[8][4],
                                             float y[8][4]) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    uint32_t fa[4], fb[4];
    ldsm_x4(a_frag(ax, r0, kk, l), fa);
    ldsm_x4(a_frag(ay, r0, kk, l), fb);
#pragma unroll
    for (int nb = 0; nb < kTile / 16; ++nb) {
      uint32_t gx[4], gy[4];
      ldsm_x4(b_frag(bx, 16 * nb, kk, l), gx);
      ldsm_x4(b_frag(by, 16 * nb, kk, l), gy);
      mma(x[2 * nb], fa, gx[0], gx[1]);
      mma(x[2 * nb + 1], fa, gx[2], gx[3]);
      mma(y[2 * nb], fb, gy[0], gy[1]);
      mma(y[2 * nb + 1], fb, gy[2], gy[3]);
    }
  }
}

__device__ __forceinline__ void zero8(float x[8][4], float y[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.0f;
}

// dQ, dh = 64n (n = 2 .. 8): one block per (b*h, 64-query tile, 64-column
// slice z of the head dim). Q's and dO's n chunks stay in shared memory;
// each key tile is n + 1 steps through a two-stage ring of two tiles:
// chunks c of K and V (S += Q_c . K_c^T, dP += dO_c . V_c^T, in the same
// order in every slice), then K's chunk z (p and ds of all 64 keys, dq_z
// += ds . K_z)
__global__ void __launch_bounds__(kThreadsTc, 2)
flash_bwd_dq_wide_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const int* __restrict__ lens,
                         const float* __restrict__ lse,
                         const float* __restrict__ drows,
                         bf16* __restrict__ dq, Dims d, Strides sq,
                         Strides sk, Strides sv, Strides sdo) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int nc = d.dh / kDh, col0 = blockIdx.z * kDh;
  // Q's and dO's chunks, then two stages of two tiles
  const uint32_t sQ = smem_addr(smem_tc), sdO = sQ + nc * kTileBytes;
  const uint32_t sSt = sQ + 2 * nc * kTileBytes;

  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int q0 = blockIdx.x * kTile;
  const int len = max(0, min(lens[b], d.T));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const float scale = 1.0f / sqrtf(static_cast<float>(d.dh));
  const bf16* kb = k + b * sk.b + head * sk.h;
  const bf16* vb = v + b * sv.b + head * sv.h;

  // this thread's queries t0 + 8i: lse, D and the keys [s_lo, s_hi) each
  // may attend (none past T)
  const int t0 = q0 + 16 * w + (l >> 2);
  float lse_r[2], dr[2];
  int s_lo[2], s_hi[2];
  query_rows(lse, drows, bh, t0, d, lse_r, dr);
  row_windows(t0, len, d, s_lo, s_hi);

  float acc[8][4] = {}, s[8][4] = {}, dp[8][4] = {};
  int k_begin, k_end;
  key_range(q0, len, d, &k_begin, &k_end);
  const int first = (k_begin / kTile) * kTile;
  const int tiles = k_end > first ? (k_end - first + kTile - 1) / kTile : 0;
  const int steps = tiles * (nc + 1);
  // step g: key tile first + 64 (g / (nc + 1)), part c = g % (nc + 1)
  auto load_step = [&](int g) {
    const int c = g % (nc + 1), k0 = first + (g / (nc + 1)) * kTile;
    const uint32_t dst = sSt + (g & 1) * 2 * kTileBytes;
    if (c < nc) {
      load_tile_async(dst, kb + c * kDh, sk.t, k0, d.T);
      load_tile_async(dst + kTileBytes, vb + c * kDh, sv.t, k0, d.T);
    } else {
      load_tile_async(dst, kb + col0, sk.t, k0, d.T);
    }
  };
  if (steps > 0) {
    load_chunks_async(sQ, q + b * sq.b + head * sq.h, sq.t, q0, d.T, nc);
    load_chunks_async(sdO, dout + b * sdo.b + head * sdo.h, sdo.t, q0, d.T,
                      nc);
    load_step(0);
    cp_async_commit();
  }
  for (int g = 0; g < steps; ++g) {
    const int c = g % (nc + 1), k0 = first + (g / (nc + 1)) * kTile;
    const uint32_t cur = sSt + (g & 1) * 2 * kTileBytes;
    if (g + 1 < steps) {
      load_step(g + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (c < nc) {
      if (c == 0) zero8(s, dp);
      scores_chunk(sQ + c * kTileBytes, sdO + c * kTileBytes, cur,
                   cur + kTileBytes, 16 * w, l, s, dp);
    } else {
      probs_by_key(s, dp, k0, s_lo, s_hi, lse_r, dr, scale, l);
      probs_by_key(s + 4, dp + 4, k0 + 32, s_lo, s_hi, lse_r, dr, scale, l);
      uint32_t da[2][4];
      to_a_frags(dp, da);
      product_tc(acc, da, cur, 0, l);
      to_a_frags(dp + 4, da);
      product_tc(acc, da, cur, 32, l);
    }
    __syncthreads();
  }
  store_rows(dq, acc, scale, b, t0, head, d, l, col0);
}

// dK/dV, dh = 64n (n = 2 .. 8): one block per (b*h, 64-key tile, 64-column
// slice z). K's and V's n chunks stay in shared memory; each query tile is
// n + 1 steps through a two-stage ring of two tiles and the rows: chunks c
// of Q and dO (S^T += K_c . Q_c^T, dP^T += V_c . dO_c^T), then Q's and dO's
// chunk z with the tile's lse and D (p and ds, dv_z += P^T . dO_z, dk_z +=
// dS^T . Q_z)
__global__ void __launch_bounds__(kThreadsTc, 2)
flash_bwd_dkv_wide_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const int* __restrict__ lens,
                          const float* __restrict__ lse,
                          const float* __restrict__ drows,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          Dims d, Strides sq, Strides sk, Strides sv,
                          Strides sdo) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int nc = d.dh / kDh, col0 = blockIdx.z * kDh;
  // K's and V's chunks, two stages of two tiles, then two stages of
  // (lse[64], D[64])
  const uint32_t sK = smem_addr(smem_tc), sV = sK + nc * kTileBytes;
  const uint32_t sSt = sK + 2 * nc * kTileBytes;
  float* rows =
      reinterpret_cast<float*>(smem_tc + (2 * nc + 4) * kTileBytes);

  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int k0 = blockIdx.x * kTile;
  const int len = max(0, min(lens[b], d.T));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const float scale = 1.0f / sqrtf(static_cast<float>(d.dh));
  const bf16* qb = q + b * sq.b + head * sq.h;
  const bf16* ob = dout + b * sdo.b + head * sdo.h;
  const float* lse_row = lse + static_cast<int64_t>(bh) * d.T;
  const float* d_row = drows + static_cast<int64_t>(bh) * d.T;

  const int s0 = k0 + 16 * w + (l >> 2);
  int t_lo[2], t_hi[2];
  key_windows(s0, len, d, t_lo, t_hi);

  float acc_k[8][4] = {}, acc_v[8][4] = {}, s[8][4] = {}, dp[8][4] = {};
  if (k0 < len) {
    int q_begin, q_end;
    query_range(k0, len, d, &q_begin, &q_end);
    const int first = (q_begin / kTile) * kTile;
    const int steps = (q_end - first + kTile - 1) / kTile * (nc + 1);
    // step g: query tile first + 64 (g / (nc + 1)), part c = g % (nc + 1)
    auto load_step = [&](int g) {
      const int c = g % (nc + 1), q0 = first + (g / (nc + 1)) * kTile;
      const int st = g & 1, col = c < nc ? c * kDh : col0;
      const uint32_t dst = sSt + st * 2 * kTileBytes;
      load_tile_async(dst, qb + col, sq.t, q0, d.T);
      load_tile_async(dst + kTileBytes, ob + col, sdo.t, q0, d.T);
      if (c == nc) {
        const int t = q0 + (threadIdx.x & (kTile - 1));
        const float* src = threadIdx.x < kTile ? lse_row : d_row;
        cp_async4(smem_addr(rows + st * 2 * kTile + threadIdx.x),
                  src + (t < d.T ? t : 0), t < d.T);
      }
    };
    load_chunks_async(sK, k + b * sk.b + head * sk.h, sk.t, k0, d.T, nc);
    load_chunks_async(sV, v + b * sv.b + head * sv.h, sv.t, k0, d.T, nc);
    load_step(0);
    cp_async_commit();
    for (int g = 0; g < steps; ++g) {
      const int c = g % (nc + 1), q0 = first + (g / (nc + 1)) * kTile;
      const int st = g & 1;
      const uint32_t sQ = sSt + st * 2 * kTileBytes, sdO = sQ + kTileBytes;
      if (g + 1 < steps) {
        load_step(g + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (c < nc) {
        if (c == 0) zero8(s, dp);
        scores_chunk(sK + c * kTileBytes, sV + c * kTileBytes, sQ, sdO,
                     16 * w, l, s, dp);
      } else {
        const float* lse_s = rows + st * 2 * kTile;
        const float* d_s = lse_s + kTile;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          probs_by_query(s + 4 * half, dp + 4 * half, q0, 32 * half, t_lo,
                         t_hi, lse_s, d_s, scale, l);
          uint32_t pa[2][4], da[2][4];
          to_a_frags(s + 4 * half, pa);
          to_a_frags(dp + 4 * half, da);
          product_tc(acc_v, pa, sdO, 32 * half, l);
          product_tc(acc_k, da, sQ, 32 * half, l);
        }
      }
      __syncthreads();
    }
  }
  store_rows(dk, acc_k, scale, b, s0, head, d, l, col0);
  store_rows(dv, acc_v, 1.0f, b, s0, head, d, l, col0);
}

// ------------------------------------------------------------- launches

// the dynamic shared memory above 48 KB, set once a kernel (so a launch
// is only a launch, and may be captured in a CUDA graph)
template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const int* lens, const float* lse, const float* drows, void* dq,
              const Dims& d, const int* strides, bool bf16_path,
              cudaStream_t stream) {
  const int nc = d.dh / kDh;
  const dim3 grid((d.T + kTile - 1) / kTile, d.B * d.h, nc);
  const Strides s0 = strides_at(strides, 0), s1 = strides_at(strides, 1),
                s2 = strides_at(strides, 2), s3 = strides_at(strides, 3);
  if (bf16_path && nc == 1) {
    constexpr int bytes = 6 * kTileBytes;
    static const int attr = set_smem(flash_bwd_dq_tc_kernel, bytes);
    if (attr) return attr;
    flash_bwd_dq_tc_kernel<<<grid, kThreadsTc, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lens,
        lse, drows, static_cast<bf16*>(dq), d, s0, s1, s2, s3);
  } else if (bf16_path) {
    static const int attr = set_smem(flash_bwd_dq_wide_kernel,
                                     (2 * kMaxDh / kDh + 4) * kTileBytes);
    if (attr) return attr;
    flash_bwd_dq_wide_kernel<<<grid, kThreadsTc, (2 * nc + 4) * kTileBytes,
                               stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lens,
        lse, drows, static_cast<bf16*>(dq), d, s0, s1, s2, s3);
  } else {
    constexpr int bytes = smem_bytes<kDh>(4, 1);
    static const int attr = set_smem(flash_bwd_dq_kernel, bytes);
    if (attr) return attr;
    flash_bwd_dq_kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lens,
        lse, drows, static_cast<float*>(dq), d, s0, s1, s2, s3);
  }
  CSR_RETURN_LAUNCH_STATUS();
}

int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const int* lens, const float* lse, const float* drows,
               void* dk, void* dv, const Dims& d, const int* strides,
               bool bf16_path, cudaStream_t stream) {
  const int nc = d.dh / kDh;
  const dim3 grid((d.T + kTile - 1) / kTile, d.B * d.h, nc);
  const Strides s0 = strides_at(strides, 0), s1 = strides_at(strides, 1),
                s2 = strides_at(strides, 2), s3 = strides_at(strides, 3);
  if (bf16_path && nc == 1) {
    constexpr int bytes = 6 * kTileBytes + kRowsBytes;
    static const int attr = set_smem(flash_bwd_dkv_tc_kernel, bytes);
    if (attr) return attr;
    flash_bwd_dkv_tc_kernel<<<grid, kThreadsTc, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lens,
        lse, drows, static_cast<bf16*>(dk), static_cast<bf16*>(dv), d, s0,
        s1, s2, s3);
  } else if (bf16_path) {
    static const int attr = set_smem(
        flash_bwd_dkv_wide_kernel,
        (2 * kMaxDh / kDh + 4) * kTileBytes + kRowsBytes);
    if (attr) return attr;
    flash_bwd_dkv_wide_kernel<<<grid, kThreadsTc,
                                (2 * nc + 4) * kTileBytes + kRowsBytes,
                                stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lens,
        lse, drows, static_cast<bf16*>(dk), static_cast<bf16*>(dv), d, s0,
        s1, s2, s3);
  } else {
    constexpr int bytes = smem_bytes<kDh>(4, 2);
    static const int attr = set_smem(flash_bwd_dkv_kernel, bytes);
    if (attr) return attr;
    flash_bwd_dkv_kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lens,
        lse, drows, static_cast<float*>(dk), static_cast<float*>(dv), d, s0,
        s1, s2, s3);
  }
  CSR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// q, k, v, dout [B, T, h, dh] (bf16 if `use_bf16` else fp32, strided, head dim
// dense; bf16 rows 16-byte aligned, which the caller checks:
// ops/attention_cuda.py rows_aligned16), lens [B] int32, lse and drows [B,
// h, T] fp32, dq [B, T, h, dh] contiguous in the same dtype; dims (host) =
// {B, T, h, dh, chunk, left}, strides (host) = the (b, t, h) element
// strides of q, k, v, dout. dh is one of 64, 128, ..., 512 (any other is
// refused).
CSR_API int csr_flash_bwd_dq(const void* q, const void* k, const void* v,
                             const void* dout, const int* lens,
                             const float* lse, const float* drows, void* dq,
                             const int* dims, const int* strides, int use_bf16,
                             cudaStream_t stream) {
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5]};
  if (!dh_taken(d.dh)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dq(q, k, v, dout, lens, lse, drows, dq, d, strides,
                   use_bf16 != 0, stream);
}

// as csr_flash_bwd_dq, writing dk and dv [B, T, h, dh] contiguous
CSR_API int csr_flash_bwd_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const int* lens,
                              const float* lse, const float* drows, void* dk,
                              void* dv, const int* dims, const int* strides,
                              int use_bf16, cudaStream_t stream) {
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5]};
  if (!dh_taken(d.dh)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dkv(q, k, v, dout, lens, lse, drows, dk, dv, d, strides,
                    use_bf16 != 0, stream);
}

