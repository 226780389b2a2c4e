// Tensor-core building blocks of the bf16 flash-attention kernels
// (attention_fwd.cu, attention_bwd.cu): swizzled [64][64] bf16 tiles in
// shared memory filled by cp.async, ldmatrix fragments, mma.sync m16n8k16
// with fp32 accumulators, accumulators reused as A operands (the
// FlashAttention-2 register reuse) and the stores of a warp's rows. A head
// wider than 64 is handled in 64-column chunks: a [64][dh] operand sits in
// shared memory as dh/64 consecutive [64][64] tiles (load_chunks), each
// swizzled on its own, so every fragment helper below works unchanged on
// one chunk.
//
// A block has four warps; warp w owns rows 16w .. 16w+15 of a tile. An
// m16n8k16 accumulator c[4] of lane l holds rows l/4 and l/4 + 8, columns
// 2 (l % 4) and 2 (l % 4) + 1 of its 16 x 8 tile.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace csr_attn {

using bf16 = __nv_bfloat16;

constexpr int kDh = 64;                   // the head width of the narrow
                                          // kernels, and the chunk width of
                                          // the wide ones (dh = 64n)
constexpr int kWarps = kTile / 16;        // a warp owns 16 rows of a tile
constexpr int kThreadsTc = 32 * kWarps;
constexpr int kTileBytes = kTile * kDh * 2;   // a [64][64] bf16 tile
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

// rows [row0, row0 + kRows) of one head (base: its row 0, st: the t
// stride) into a swizzled tile of kRows rows, shared by a block of kN
// threads; rows at or past T are zero-filled
template <int kN = kThreadsTc, int kRows = kTile>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* base,
                                                int64_t st, int row0, int T) {
#pragma unroll
  for (int j = 0; j < (kRows * 8 + kN - 1) / kN; ++j) {
    const int i = threadIdx.x + j * kN, r = i >> 3, c = i & 7;
    if (kRows * 8 % kN == 0 || i < kRows * 8) {
      const int t = row0 + r;
      const bool ok = t < T;
      cp_async16(dst + swz(r, c), base + (ok ? t * st : 0) + c * 8, ok);
    }
  }
}

// the n 64-column chunks of rows [row0, row0 + kRows) into n consecutive
// swizzled tiles (chunk c: head-dim columns 64c .. 64c + 63)
template <int kN = kThreadsTc, int kRows = kTile>
__device__ __forceinline__ void load_chunks_async(uint32_t dst,
                                                  const bf16* base, int64_t st,
                                                  int row0, int T, int n) {
  for (int c = 0; c < n; ++c)
    load_tile_async<kN, kRows>(dst + c * kRows * 128, base + c * kDh, st,
                               row0, T);
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

// ------------- the wide kernels (dh = 64n, n = 2 .. 8): slices in one block
//
// A wide block owns every 64-column slice of its rows. It has W warp
// groups of a warp for every 16 rows; warp (r, g) owns rows 16r .. 16r + 15
// and the n-tiles [ntile_lo(g, W), ntile_lo(g + 1, W)) of a tile's 8: 8-key
// (8-query in dK/dV) column blocks of the score tile, and the same 8-column
// blocks of every slice's output.

constexpr int kMaxSlices = 4;   // warp groups a block, and the slices (256
                                // columns) up to which a stage holds a tile
constexpr int kSmemBlockMax = 232448;   // dynamic shared memory a block

// the first of a tile's 8 n-tiles that warp group g of W owns
__host__ __device__ constexpr int ntile_lo(int g, int W) {
  return (8 * g + W - 1) / W;
}

// B fragments (ldmatrix.trans) of the two n-tiles at 16-byte chunks c0 and
// c0 + 1 of a tile stored [k][n], k rows k0..k0+15 (bt_frag at any chunk)
__device__ __forceinline__ uint32_t bt_chunk(uint32_t tile, int k0, int c0,
                                             int l) {
  return tile + swz(k0 + (l & 7) + (((l >> 3) & 1) << 3), c0 + (l >> 4));
}

// bf16(x) of a warp's accumulators (rows r0 + l/4 and + 8, n-tiles j0..)
// into the swizzled [64][64] tile t
template <int kJ>
__device__ __forceinline__ void store_ntiles(uint32_t t, const float x[kJ][4],
                                             int r0, int j0, int jn, int l) {
  const int r = r0 + (l >> 2);
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (j < jn) {
      const uint32_t at = 4 * (l & 3);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(t + swz(r, j0 + j) +
                                                       at),
                   "r"(pack_bf16(x[j][0], x[j][1]))
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(t + swz(r + 8, j0 + j) +
                                                       at),
                   "r"(pack_bf16(x[j][2], x[j][3]))
                   : "memory");
    }
  }
}

// this thread's queries t0 + 8i and the keys [s_lo, s_hi) each may attend
// (none past T)
__device__ __forceinline__ void row_windows(int t0, int len, const Dims& d,
                                            int s_lo[2], int s_hi[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + 8 * i;
    const bool row = t < d.T;
    s_lo[i] = 0;
    s_hi[i] = row ? len : 0;
    if (row && d.chunk) {
      const int qc = t / d.chunk;
      s_lo[i] = max(0, (qc - d.left) * d.chunk);
      s_hi[i] = min(len, (qc + 1) * d.chunk);
    }
  }
}

// this thread's keys s0 + 8i and the queries [t_lo, t_hi) that may
// attend each (none for a key at or past the length)
__device__ __forceinline__ void key_windows(int s0, int len, const Dims& d,
                                            int t_lo[2], int t_hi[2]) {
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
}

// a warp's accumulator rows (r, r + 8 with r = lane / 4; columns col0 + 8j
// + 2 (lane % 4) + {0, 1}) times `scale` into rows t0, t0 + 8 of a [B, T,
// h, dh] contiguous bf16 output; rows at or past T are not written
__device__ __forceinline__ void store_rows(bf16* out, const float acc[8][4],
                                           float scale, int b, int t0,
                                           int head, const Dims& d, int l,
                                           int col0 = 0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + 8 * i;
    if (t >= d.T) continue;
    bf16* o = out + ((static_cast<int64_t>(b) * d.T + t) * d.h + head) * d.dh +
              col0 + 2 * (l & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

}  // namespace csr_attn
