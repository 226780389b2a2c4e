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
// bf16 (both presets): the products run on the tensor cores, mma.sync
// m16n8k16 with fp32 accumulators (FlashAttention-2's design). One block
// per (b*h, 64-row tile), four warps, each owning 16 rows of the tile:
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
// 48-49 KB a block. p is exp2 of one fma; the rounding guard below makes
// p and ds round to bf16 as the plain version's fp32 arithmetic rounds
// them. mma.sync rather than wgmma: a warp's 16 rows are the unit of
// FlashAttention-2's register reuse, wgmma's 64-row warpgroup tiles would
// need its descriptors and a producer warp; mma.sync issues at a lower
// rate than wgmma on Hopper, the cost of this simpler design.
//
// fp32 (the parity runs only): the first version's FMA path, with fp32
// tiles in shared memory (attention_common.cuh). TF32 tensor cores would
// keep ~3 decimal digits and miss the fp32 gradient bar (3e-4).
//
// The window: dQ walks the key tiles between the bounds of its rows'
// length and chunk window (key_range); dK/dV walks every query tile whose
// rows may attend one of its keys (query_range: every query row < T,
// padded rows included, as the TPU kernel does); a key tile at or past the
// row's length writes zeros.
#include "attention_common.cuh"

namespace {

using namespace csr_attn;
using bf16 = __nv_bfloat16;

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

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const int* __restrict__ lens,
                    const float* __restrict__ lse,
                    const float* __restrict__ drows, float* __restrict__ dq,
                    Dims d, Strides sq, Strides sk, Strides sv,
                    Strides sdo) {
  constexpr int LD = DH + 1;
  constexpr int NC = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;         // [64][65]

  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int q0 = blockIdx.x * kTile;
  const int len = max(0, min(lens[b], d.T));
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const float* lse_row = lse + static_cast<int64_t>(bh) * d.T;
  const float* d_row = drows + static_cast<int64_t>(bh) * d.T;

  load_tile<float, DH>(Qs, q, sq, b, head, q0, d.T);
  load_tile<float, DH>(dOs, dout, sdo, b, head, q0, d.T);
  float acc[4][NC] = {};

  int k_begin, k_end;
  key_range(q0, len, d, &k_begin, &k_end);
  for (int k0 = (k_begin / kTile) * kTile; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<float, DH>(Ks, k, sk, b, head, k0, d.T);
    load_tile<float, DH>(Vs, v, sv, b, head, k0, d.T);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    scores_and_dp<DH>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    probs_and_ds(s, dp, q0, k0, len, d, lse_row, d_row, scale, ty, tx,
                 nullptr, dSs);
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
      float g[4], kk[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = dSs[(4 * ty + i) * kLdP + key];
#pragma unroll
      for (int c = 0; c < NC; ++c) kk[c] = Ks[key * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(g[i], kk[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= d.T) continue;
    float* o = dq + ((static_cast<int64_t>(b) * d.T + t) * d.h + head) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = acc[i][c] * scale;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const int* __restrict__ lens,
                     const float* __restrict__ lse,
                     const float* __restrict__ drows, float* __restrict__ dk,
                     float* __restrict__ dv, Dims d, Strides sq, Strides sk,
                     Strides sv, Strides sdo) {
  constexpr int LD = DH + 1;
  constexpr int NC = DH / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;         // [64][65]
  float* dSs = Ps + kTile * kLdP;       // [64][65]

  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int k0 = blockIdx.x * kTile;
  const int len = max(0, min(lens[b], d.T));
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const float* lse_row = lse + static_cast<int64_t>(bh) * d.T;
  const float* d_row = drows + static_cast<int64_t>(bh) * d.T;

  // this thread's keys 4ty+i, head-dim columns tx+16c
  float ak[4][NC] = {}, av[4][NC] = {};
  if (k0 < len) {
    load_tile<float, DH>(Ks, k, sk, b, head, k0, d.T);
    load_tile<float, DH>(Vs, v, sv, b, head, k0, d.T);
    int q_begin, q_end;
    query_range(k0, len, d, &q_begin, &q_end);
    for (int q0 = (q_begin / kTile) * kTile; q0 < q_end; q0 += kTile) {
      __syncthreads();
      load_tile<float, DH>(Qs, q, sq, b, head, q0, d.T);
      load_tile<float, DH>(dOs, dout, sdo, b, head, q0, d.T);
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      scores_and_dp<DH>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
      probs_and_ds(s, dp, q0, k0, len, d, lse_row, d_row, scale, ty, tx, Ps,
                   dSs);
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float p[4], g[4], qv[NC], gv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[qq * kLdP + 4 * ty + i];
          g[i] = dSs[qq * kLdP + 4 * ty + i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          qv[c] = Qs[qq * LD + tx + 16 * c];
          gv[c] = dOs[qq * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
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
    const int64_t off = ((static_cast<int64_t>(b) * d.T + s) * d.h + head) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tx + 16 * c] = ak[i][c] * scale;
      dv[off + tx + 16 * c] = av[i][c];
    }
  }
}

// ------------------------------------------------- bf16 (tensor cores)

constexpr int kDh = 64;                   // the head width of this path
constexpr int kWarps = kTile / 16;        // a warp owns 16 rows of a tile
constexpr int kThreadsTc = 32 * kWarps;
constexpr int kTileBytes = kTile * kDh * 2;   // a [64][64] bf16 tile
constexpr int kRowsBytes = 2 * 2 * kTile * 4;  // lse and D, two stages
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (8 values) of row r in a [64][64] bf16
// tile: the chunk is stored at c ^ (r % 8), so the 8 rows that one phase
// of ldmatrix reads, or a warp's copies write, fall in distinct banks
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
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

// rows [row0, row0 + 64) of one head (base: its row 0, st: the t stride)
// into a swizzled tile; rows at or past T are zero-filled
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* base,
                                                int64_t st, int row0, int T) {
#pragma unroll
  for (int j = 0; j < kTile * 8 / kThreadsTc; ++j) {
    const int i = threadIdx.x + j * kThreadsTc, r = i >> 3, c = i & 7;
    const int t = row0 + r;
    const bool ok = t < T;
    cp_async16(dst + swz(r, c), base + (ok ? t * st : 0) + c * 8, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Fragment addresses (lane l) of the m16n8k16 operands in a swizzled tile.
// A: rows r0..r0+15, k-step kk (columns 16kk..16kk+15), row-major.
__device__ __forceinline__ uint32_t a_frag(uint32_t tile, int r0, int kk,
                                           int l) {
  return tile + swz(r0 + (l & 15), 2 * kk + (l >> 4));
}
// B of two n-tiles (rows n0..n0+15 of a tile stored [n][k]) at k-step kk:
// registers {0, 1} hold n-tile n0, {2, 3} n-tile n0 + 8
__device__ __forceinline__ uint32_t b_frag(uint32_t tile, int n0, int kk,
                                           int l) {
  return tile + swz(n0 + (l & 7) + ((l >> 4) << 3), 2 * kk + ((l >> 3) & 1));
}
// B of two n-tiles (columns 16nb..16nb+15) of a tile stored [k][n], k rows
// k0..k0+15, for ldmatrix.trans: registers {0, 1} hold columns 16nb.., {2,
// 3} columns 16nb+8..
__device__ __forceinline__ uint32_t bt_frag(uint32_t tile, int k0, int nb,
                                            int l) {
  return tile + swz(k0 + (l & 7) + (((l >> 3) & 1) << 3), 2 * nb + (l >> 4));
}

// c += a . b for one m16n8k16 bf16 product with fp32 accumulators
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulators x[j] of four n-tiles (32 columns) as the A operands of
// two k-steps over those columns, rounded to bf16: n-tile j is the half
// j % 2 of k-step j / 2 (the FlashAttention-2 register reuse).
__device__ __forceinline__ void to_a_frags(const float x[4][4],
                                           uint32_t a[2][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j >> 1][2 * (j & 1)] = pack_bf16(x[j][0], x[j][1]);
    a[j >> 1][2 * (j & 1) + 1] = pack_bf16(x[j][2], x[j][3]);
  }
}

// p = exp(s * scale - lse), the fast form (the guard below covers its
// last bits)
__device__ __forceinline__ float prob(float s, float scale, float lse_t) {
  return exp2f(fmaf(s, scale * kLog2e, -lse_t * kLog2e));
}

// Rounding guard. The tensor cores sum q.k and dO.v in another order than
// the plain version's fp32 matmul, so s and dp differ from it in the last
// bits, and a p or ds that lies near a bf16 rounding midpoint can round the
// other way: one ulp of a large p or ds moves dv, dk or dq by more than the
// gradient bar (2^-7 |b| + 1e-3). An element is flagged when it is large
// enough for that (p >= 2^-5, |ds| >= 2^-2: a flip below moves an output
// by less than 2^-13 |dO| or 2^-13 |q|, under the bar's 1e-3) and lies
// within kNear fp32 ulps of a midpoint (several times the difference the
// two sums show at these widths), or ds = p (dp - D) is near a
// cancellation (|dp - D| < 2); a flagged element is recomputed with the
// plain version's arithmetic (dot_seq, expf), so its p and ds round as
// there. A warp with no large p or ds skips the test. Without the guard,
// the gradients of chip_smoke.py's chunk 16/4 case (short windows, large
// p) break the bar.
//
// The four constants (kPMin, kDsMin, kNear and the |dp - D| < 2 test) were
// fitted by sweeps, not derived: on an H100, bf16, h = 4, dh = 64, at
// chip_smoke.py phase 18's three shapes (B = 32, T' = 701, chunk 0 and
// chunk 16 / left 4; B = 24, T' = 256), on phase 18's own inputs and on
// numpy generators seeded 3 (all three shapes), 7 and 8 (chunk 16/4) and
// 9 (chunk 0 at T' = 701). No bound on the tensor
// cores' summation error backs the 512-ulp window: a bar derived from the
// rounding itself (one bf16 ulp of each p or ds times its partner operand,
// summed) is to replace the guard and its constants (ROADMAP.md).
constexpr float kPMin = 0.03125f;
constexpr float kDsMin = 0.25f;
constexpr uint32_t kNear = 0x200;

__device__ __forceinline__ bool near_midpoint(float x) {
  return ((__float_as_uint(x) + (kNear - 0x8000u)) & 0xffffu) <= 2 * kNear;
}

// x[idx / 4][idx % 4] = v, with the register index known at compile time
__device__ __forceinline__ void put(float x[4][4], int idx, float v) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (idx == 4 * j + e) x[j][e] = v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float fma_pair(uint32_t a, uint32_t b, float s) {
  s = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), s);
  return fmaf(__uint_as_float(a & 0xffff0000u),
              __uint_as_float(b & 0xffff0000u), s);
}

// row ra of tile ta . row rb of tile tb as the plain version's fp32 matmul
// sums it: fmaf over the head dim in order, from 0
__device__ __forceinline__ float dot_seq(uint32_t ta, int ra, uint32_t tb,
                                         int rb) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kDh / 8; ++c) {
    const uint4 a = lds128(ta + swz(ra, c)), b = lds128(tb + swz(rb, c));
    s = fma_pair(a.x, b.x, s);
    s = fma_pair(a.y, b.y, s);
    s = fma_pair(a.z, b.z, s);
    s = fma_pair(a.w, b.w, s);
  }
  return s;
}

// The guard over a warp's 4 x 4 elements of p and ds (p is tested only with
// kCheckP: the dQ kernel rounds ds alone); exact(idx, p, ds) recomputes
// element idx = 4j + e, which each lane does for one flag at a time.
template <bool kCheckP, typename Exact>
__device__ __forceinline__ void guard(float p[4][4], float ds[4][4],
                                      Exact exact) {
  bool large = false;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      large |= (kCheckP && p[j][e] >= kPMin) || fabsf(ds[j][e]) >= kDsMin;
  if (!__any_sync(0xffffffffu, large)) return;
  uint32_t flags = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = p[j][e], y = ds[j][e];
      if ((kCheckP && x >= kPMin && near_midpoint(x)) ||
          (fabsf(y) >= kDsMin && (near_midpoint(y) || fabsf(y) < 2.0f * x)))
        flags |= 1u << (4 * j + e);
    }
  while (__any_sync(0xffffffffu, flags)) {
    const int idx = flags ? __ffs(flags) - 1 : -1;
    flags &= flags - 1;
    if (idx >= 0) {
      float pe, dse;
      exact(idx, pe, dse);
      put(p, idx, pe);
      put(ds, idx, dse);
    }
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

// acc[0..7] (a warp's 16 rows x 64 head-dim columns) += a . tile rows
// k0..k0+31, a the A operands of two k-steps
__device__ __forceinline__ void product_tc(float acc[8][4],
                                           const uint32_t a[2][4],
                                           uint32_t tile, int k0, int l) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int nb = 0; nb < kDh / 16; ++nb) {
      uint32_t f[4];
      ldsm_x4_t(bt_frag(tile, k0 + 16 * kk, nb, l), f);
      mma(acc[2 * nb], a[kk], f[0], f[1]);
      mma(acc[2 * nb + 1], a[kk], f[2], f[3]);
    }
}

// a warp's accumulator rows (r, r + 8 with r = lane / 4; columns 8j + 2
// (lane % 4) + {0, 1}) times `scale` into rows t0, t0 + 8 of a [B, T, h,
// 64] contiguous bf16 output; rows at or past T are not written
__device__ __forceinline__ void store_rows(bf16* out, const float acc[8][4],
                                           float scale, int b, int t0,
                                           int head, const Dims& d, int l) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + 8 * i;
    if (t >= d.T) continue;
    bf16* o = out + ((static_cast<int64_t>(b) * d.T + t) * d.h + head) * kDh +
              2 * (l & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
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

  // this thread's queries t0 + 8i: lse (in log2 units), D and the keys
  // [s_lo, s_hi) each may attend (none past T)
  const int t0 = q0 + 16 * w + (l >> 2);
  float lse_r[2], dr[2];
  int s_lo[2], s_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + 8 * i;
    const bool row = t < d.T;
    const int64_t at = static_cast<int64_t>(bh) * d.T + t;
    lse_r[i] = row ? lse[at] : 0.0f;
    dr[i] = row ? drows[at] : 0.0f;
    s_lo[i] = 0;
    s_hi[i] = row ? len : 0;
    if (row && d.chunk) {
      const int qc = t / d.chunk;
      s_lo[i] = max(0, (qc - d.left) * d.chunk);
      s_hi[i] = min(len, (qc + 1) * d.chunk);
    }
  }

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
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = k0 + c0 + 8 * j + 2 * (l & 3) + (e & 1);
          const bool ok = key >= s_lo[i] && key < s_hi[i];
          s[j][e] = ok ? prob(s[j][e], scale, lse_r[i]) : 0.0f;
          dp[j][e] = s[j][e] * (dp[j][e] - dr[i]);
        }
      guard<false>(s, dp, [&](int idx, float& p, float& ds) {
        const int i = (idx & 3) >> 1;
        const int c = c0 + 8 * (idx >> 2) + 2 * (l & 3) + (idx & 1);
        const int r = 16 * w + (l >> 2) + 8 * i;
        p = expf(dot_seq(sQ, r, sK, c) * scale - (i ? lse_r[1] : lse_r[0]));
        ds = p * (dot_seq(sdO, r, sV, c) - (i ? dr[1] : dr[0]));
      });
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

  // this thread's keys s0 + 8i and the queries [t_lo, t_hi) that may
  // attend each (none for a key at or past the length)
  const int s0 = k0 + 16 * w + (l >> 2);
  int t_lo[2], t_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = s0 + 8 * i;
    t_lo[i] = 0;
    t_hi[i] = key < len ? d.T : 0;
    if (key < len && d.chunk) {
      const int kc = key / d.chunk;
      t_lo[i] = kc * d.chunk;
      t_hi[i] = min(d.T, (kc + d.left + 1) * d.chunk);
    }
  }

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
        guard<true>(s, dp, [&](int idx, float& p, float& ds) {
          const int c = c0 + 8 * (idx >> 2) + 2 * (l & 3) + (idx & 1);
          const int r = 16 * w + (l >> 2) + 8 * ((idx & 3) >> 1);
          p = expf(dot_seq(sK, r, sQ, c) * scale - lse_s[c]);
          ds = p * (dot_seq(sV, r, sdO, c) - d_s[c]);
        });
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
  const dim3 grid((d.T + kTile - 1) / kTile, d.B * d.h);
  const Strides s0 = strides_at(strides, 0), s1 = strides_at(strides, 1),
                s2 = strides_at(strides, 2), s3 = strides_at(strides, 3);
  if (bf16_path) {
    constexpr int bytes = 6 * kTileBytes;
    static const int attr = set_smem(flash_bwd_dq_tc_kernel, bytes);
    if (attr) return attr;
    flash_bwd_dq_tc_kernel<<<grid, kThreadsTc, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lens,
        lse, drows, static_cast<bf16*>(dq), d, s0, s1, s2, s3);
  } else {
    constexpr int bytes = smem_bytes<kDh>(4, 1);
    static const int attr = set_smem(flash_bwd_dq_kernel<kDh>, bytes);
    if (attr) return attr;
    flash_bwd_dq_kernel<kDh><<<grid, kThreads, bytes, stream>>>(
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
  const dim3 grid((d.T + kTile - 1) / kTile, d.B * d.h);
  const Strides s0 = strides_at(strides, 0), s1 = strides_at(strides, 1),
                s2 = strides_at(strides, 2), s3 = strides_at(strides, 3);
  if (bf16_path) {
    constexpr int bytes = 6 * kTileBytes + kRowsBytes;
    static const int attr = set_smem(flash_bwd_dkv_tc_kernel, bytes);
    if (attr) return attr;
    flash_bwd_dkv_tc_kernel<<<grid, kThreadsTc, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lens,
        lse, drows, static_cast<bf16*>(dk), static_cast<bf16*>(dv), d, s0,
        s1, s2, s3);
  } else {
    constexpr int bytes = smem_bytes<kDh>(4, 2);
    static const int attr = set_smem(flash_bwd_dkv_kernel<kDh>, bytes);
    if (attr) return attr;
    flash_bwd_dkv_kernel<kDh><<<grid, kThreads, bytes, stream>>>(
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
// strides of q, k, v, dout. dh is 64.
CSR_API int csr_flash_bwd_dq(const void* q, const void* k, const void* v,
                             const void* dout, const int* lens,
                             const float* lse, const float* drows, void* dq,
                             const int* dims, const int* strides, int use_bf16,
                             cudaStream_t stream) {
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5]};
  if (d.dh != kDh) return static_cast<int>(cudaErrorInvalidValue);
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
  if (d.dh != kDh) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dkv(q, k, v, dout, lens, lse, drows, dk, dv, d, strides,
                    use_bf16 != 0, stream);
}

