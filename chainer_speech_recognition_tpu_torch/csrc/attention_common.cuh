// Shared by the flash-attention kernels (attention_fwd.cu,
// attention_bwd.cu): the geometry passed from ops/attention_cuda.py, the
// mask, the tile loop bounds, tile loads into shared memory and the
// thread layout of a 64 x 64 score tile.
//
// Thread layout (256 threads): ty = tid / 16 owns rows 4*ty .. 4*ty+3 of a
// tile, tx = tid % 16 owns its columns tx, tx+16, tx+32, tx+48 (scores) or
// tx + 16*c (head-dim columns). The 16 lanes of one ty are one half of a
// warp, so a row's reductions are shuffles with xor offsets 8, 4, 2, 1.
// Shared tiles are fp32 with a row stride of DH+1 (65 floats), so
// the 16 rows a half-warp reads at one head-dim index fall in 16 banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "rnn_common.cuh"

namespace csr_attn {

using csr_rnn::from_f32;
using csr_rnn::round_to;
using csr_rnn::to_f32;

constexpr int kTile = 64;          // query and key rows per tile
constexpr int kMaxDh = 512;        // head widths taken: 64, 128, ..., 512
                                   // (attention_pallas.py:383's set)
constexpr int kThreads = 256;
constexpr int kLdP = kTile + 1;    // row stride of the [64][64] p/ds tiles
constexpr float kNeg = -1e30f;     // the reference's masking constant

struct Dims {
  int B, T, h, dh, chunk, left;
};

// the head widths the kernels take: 64, 128, ..., kMaxDh
__host__ __device__ inline bool dh_taken(int dh) {
  return dh >= 64 && dh <= kMaxDh && dh % 64 == 0;
}

// element strides of a [B, T, h, dh] operand (the head dim is dense)
struct Strides {
  int64_t b, t, h;
};

__host__ inline Strides strides_at(const int* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// query t may attend key s: s inside the row's length and, with chunk > 0,
// s's chunk within [t's chunk - left, t's chunk]
__device__ __forceinline__ bool allowed(int t, int s, int len,
                                        const Dims& d) {
  if (s >= len) return false;
  if (d.chunk) {
    const int qc = t / d.chunk, kc = s / d.chunk;
    return kc <= qc && kc >= qc - d.left;
  }
  return true;
}

// [k_begin, k_end): the keys any query of the tile [q0, q0 + 64) may attend
// (the row's length and the chunk window; replaces _skip_block)
__device__ __forceinline__ void key_range(int q0, int len, const Dims& d,
                                          int* k_begin, int* k_end) {
  const int q1 = min(q0 + kTile, d.T) - 1;
  *k_begin = 0;
  *k_end = len;
  if (d.chunk) {
    *k_begin = max(0, (q0 / d.chunk - d.left) * d.chunk);
    *k_end = min(len, (q1 / d.chunk + 1) * d.chunk);
  }
}

// [q_begin, q_end): the queries that may attend a key of the tile
// [k0, k0 + 64); every query row < T, padded rows included
__device__ __forceinline__ void query_range(int k0, int len, const Dims& d,
                                            int* q_begin, int* q_end) {
  *q_begin = 0;
  *q_end = d.T;
  if (d.chunk) {
    const int k1 = min(k0 + kTile, len) - 1;
    *q_begin = (k0 / d.chunk) * d.chunk;
    *q_end = min(d.T, (k1 / d.chunk + d.left + 1) * d.chunk);
  }
}

// rows [row0, row0 + 64) of head `head` of batch row `b` into a [64][DH+1]
// fp32 tile; rows at or past T read as zeros
template <typename S, int DH>
__device__ __forceinline__ void load_tile(float* dst, const S* src,
                                          const Strides& st, int b, int head,
                                          int row0, int T) {
  const S* base = src + b * st.b + head * st.h;
  for (int i = threadIdx.x; i < kTile * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    const int t = row0 + r;
    dst[r * (DH + 1) + c] = t < T ? to_f32(base[t * st.t + c]) : 0.0f;
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] += Σ_d A[4ty+i][d] * B[tx+16j][d] over two [64][DH+1] tiles
template <int DH>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * (DH + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// shared memory of a kernel that holds n_rows [64][DH+1] tiles and n_p
// [64][65] tiles
template <int DH>
constexpr int smem_bytes(int n_rows, int n_p) {
  return (n_rows * kTile * (DH + 1) + n_p * kTile * kLdP) *
         static_cast<int>(sizeof(float));
}

}  // namespace csr_attn
