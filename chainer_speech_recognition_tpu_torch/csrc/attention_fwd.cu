// Flash self-attention forward: online softmax over key tiles, with the
// key-padding mask and the chunk-causal mask built in the kernel, and the
// logsumexp rows for the backward.
//
// Replaces ops/attention_pallas.py::_fwd_kernel (the TPU kernel behind
// _flash_forward / flash_mhsa).
//
// q, k, v are read as [B, T, h, dh] through their strides (the q/k/v
// slices of the fused qkv projection need no copy); out is [B, T, h, dh] in
// the compute dtype (fp32 or bf16), lse [B, h, T] fp32.
//
// What bounds it on Hopper: operations. 4*T_eff*dh per (row, head) (T_eff
// the keys inside a row's window) against ~8*dh bytes a row in bf16: at
// T' ~ 700 some 350 operations a byte, above the bf16 ridge (989 TFLOP/s /
// 3.35 TB/s = 295).
//
// bf16, dh = 64 (both presets): FlashAttention-2's layout on the tensor
// cores, mma.sync m16n8k16 with fp32 accumulators (attention_mma.cuh,
// shared with the backward). One block per (b*h, 64-query tile), four warps; warp w
// holds the A fragments of its 16 query rows in registers for the whole
// loop. The block walks the 64-key tiles between the bounds that its rows'
// length and chunk window give (key_range: the TPU kernel visits every key
// block and skips in _skip_block; here no tile outside the window is
// loaded), K and V double-buffered by cp.async into XOR-swizzled bf16 tiles,
// zero-filled past T. Per tile a warp computes S = Q.K^T (16 x 64, fp32
// registers), scales it into log2 units, masks the elements outside each
// row's window (only on tiles some row of the warp does not wholly see),
// keeps the running max m of each row (shuffles over the row's quad of
// lanes) and a thread's partial row sums l of the unrounded p, rescales its
// output accumulators, and rounds p to bf16, as the reference rounds it
// (attention_pallas.py:153), straight into the A operands of O += P.V (V
// read through ldmatrix.trans). Masked elements contribute exactly 0, so a
// row with no allowed key ends with l = 0 and is written as out = 0, lse =
// -1e30: every row stays finite. 40 KB of shared memory a block.
//
// Wider heads (dh = 64n, n = 2 .. 8, the reference's set): the output's
// head columns are split over blocks, a grid dimension of n 64-column
// slices. Each block computes the full-width S = Q.K^T (Q's n chunks in
// shared memory, K's streamed a chunk at a time through a two-stage ring,
// then V's chunk z) and accumulates only its slice of O. A [64][dh] tile
// held whole would not fit: Q and two stages of (K, V) are 640*dh bytes,
// 320 KB at dh = 512, and Q's fragments held in registers for the loop
// would be dh/4 a thread. Here shared memory is (n + 2) 8 KB tiles (80 KB
// at dh = 512) and the registers are those of dh = 64. The score product
// is repeated in each of the n slices: n times the operations of one pass,
// the price of this simple design (making it fast is later work).
//
// fp32 (the parity runs only): the first version's FMA path, with the
// wide heads' column split at every dh. One block per (b*h, 64-query tile,
// 64-column slice), 256 threads; Q and K stream through [64][65] fp32
// tiles a chunk at a time and each thread keeps a 4 x 4 block of scores,
// the running max and sum of its 4 rows (shuffle reductions over the 16
// lanes of a row) and a 4 x 4 block of the output accumulator in fp32
// registers; the probabilities go through shared memory (66,560 bytes at
// every dh). TF32 tensor cores would keep ~3 decimal digits and miss the
// fp32 bar (2e-5).
#include <math.h>

#include "attention_mma.cuh"

namespace {

using namespace csr_attn;

// ------------------------------------------------------------- fp32 (FMA)

// One block per (b*h, 64-query tile, 64-column slice z of the head dim):
// the scores are summed over the head dim's 64-column chunks (Q_c and K_c
// through the same [64][65] tiles, in the same order in every slice, so
// all slices see the same p and l), then O_z += P.V_z. Only slice 0
// writes lse.
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lens,
                 float* __restrict__ out, float* __restrict__ lse, Dims d,
                 Strides sq, Strides sk, Strides sv) {
  constexpr int LD = kDh + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;          // [64][65]

  const int nc = d.dh / kDh, z = blockIdx.z, col0 = z * kDh;
  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int q0 = blockIdx.x * kTile;
  const int len = max(0, min(lens[b], d.T));
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float scale = 1.0f / sqrtf(static_cast<float>(d.dh));

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  }

  int k_begin, k_end;
  key_range(q0, len, d, &k_begin, &k_end);
  for (int k0 = (k_begin / kTile) * kTile; k0 < k_end; k0 += kTile) {
    float s[4][4] = {};
    for (int c = 0; c < nc; ++c) {
      __syncthreads();                  // the previous readers are done
      load_tile<float, kDh>(Qs, q + c * kDh, sq, b, head, q0, d.T);
      load_tile<float, kDh>(Ks, k + c * kDh, sk, b, head, k0, d.T);
      __syncthreads();
      tile_dot<kDh>(Qs, Ks, ty, tx, s);
    }
    load_tile<float, kDh>(Vs, v + col0, sv, b, head, k0, d.T);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + 4 * ty + i;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = allowed(t, k0 + tx + 16 * j, len, d);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        sum += p;
        Ps[(4 * ty + i) * kLdP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
      float p[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * ty + i) * kLdP + key];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = Vs[key * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= d.T) continue;
    const bool live = l[i] > 0.0f;
    float* o = out + ((static_cast<int64_t>(b) * d.T + t) * d.h + head) * d.dh +
               col0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o[tx + 16 * c] = live ? acc[i][c] / l[i] : 0.0f;
    if (z == 0 && tx == 0)
      lse[static_cast<int64_t>(bh) * d.T + t] =
          live ? m[i] + logf(l[i]) : kNeg;
  }
}

// ------------------------------------------------- bf16 (tensor cores)

constexpr float kLn2 = 0.6931471805599453f;

// one key tile of the online softmax for a warp's 16 rows: s (S = Q.K^T of
// keys k0 .. k0 + 63; n-tile j holds keys k0 + 8j + 2 (l % 4) + {0, 1})
// scaled into log2 units and masked outside each row's window (only on
// tiles some row of the warp does not wholly see), the running max m and
// this thread's part of the row sums lsum updated, acc rescaled, and s
// replaced by the unrounded p
__device__ __forceinline__ void softmax_tile(float s[8][4], float m[2],
                                             float lsum[2], float acc[8][4],
                                             int k0, const int s_lo[2],
                                             const int s_hi[2], float scale2,
                                             int l) {
  const bool whole = k0 >= max(s_lo[0], s_lo[1]) &&
                     k0 + kTile <= min(s_hi[0], s_hi[1]);
  const bool masked = !__all_sync(0xffffffffu, whole);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int key = k0 + 8 * j + 2 * (l & 3) + (e & 1);
      s[j][e] = masked && (key < s_lo[i] || key >= s_hi[i])
                    ? -INFINITY
                    : s[j][e] * scale2;
      mx[i] = fmaxf(mx[i], s[j][e]);
    }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = exp2f(m[i] - mx[i]);
    m[i] = mx[i];
    lsum[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      s[j][e] = exp2f(s[j][e] - m[i]);      // masked: 2^-inf = 0
      lsum[i] += s[j][e];
      acc[j][e] *= corr[i];
    }
}

// O += P.V over one key tile, P (s) rounded to bf16 as the A operands of
// two k-steps a half, V's 64 columns read from the swizzled tile sV
__device__ __forceinline__ void pv_tile(float acc[8][4], const float s[8][4],
                                        uint32_t sV, int l) {
  uint32_t pa[2][4];
  to_a_frags(s, pa);
  product_tc(acc, pa, sV, 0, l);
  to_a_frags(s + 4, pa);
  product_tc(acc, pa, sV, 32, l);
}

// the rows' out (acc / l into columns col0 .. col0 + 63) and, where
// `with_lse`, lse; a row with no allowed key (l = 0) gets out = 0 and lse
// = -1e30
__device__ __forceinline__ void store_out(bf16* out, float* lse,
                                          const float acc[8][4],
                                          const float m[2], float lsum[2],
                                          int b, int bh, int head, int t0,
                                          const Dims& d, int l, int col0,
                                          bool with_lse) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
    const int t = t0 + 8 * i;
    if (t >= d.T) continue;
    const bool live = lsum[i] > 0.0f;
    const float den = live ? lsum[i] : 1.0f;   // acc is 0 where l is
    bf16* o = out + ((static_cast<int64_t>(b) * d.T + t) * d.h + head) * d.dh +
              col0 + 2 * (l & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
    if (with_lse && (l & 3) == 0)
      lse[static_cast<int64_t>(bh) * d.T + t] =
          live ? m[i] * kLn2 + logf(lsum[i]) : kNeg;
  }
}

// dh = 64
__global__ void __launch_bounds__(kThreadsTc, 3)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ lens,
                    bf16* __restrict__ out, float* __restrict__ lse, Dims d,
                    Strides sq, Strides sk, Strides sv) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  // Q, then two stages of (K, V)
  const uint32_t sQ = smem_addr(smem_tc), sKV = sQ + kTileBytes;

  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int q0 = blockIdx.x * kTile;
  const int len = max(0, min(lens[b], d.T));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  // scores into log2 units: p = 2^(s * scale * log2(e) - m)
  const float scale2 = kLog2e / sqrtf(static_cast<float>(kDh));
  const bf16* kb = k + b * sk.b + head * sk.h;
  const bf16* vb = v + b * sv.b + head * sv.h;

  const int t0 = q0 + 16 * w + (l >> 2);
  int s_lo[2], s_hi[2];
  row_windows(t0, len, d, s_lo, s_hi);

  // m: running max (log2 units), lsum: this thread's part of the row sums
  float m[2] = {kNeg, kNeg}, lsum[2] = {0.0f, 0.0f};
  float acc[8][4] = {};
  uint32_t qa[kDh / 16][4];
  int k_begin, k_end;
  key_range(q0, len, d, &k_begin, &k_end);
  const int first = (k_begin / kTile) * kTile;
  const int n = k_end > first ? (k_end - first + kTile - 1) / kTile : 0;
  if (n > 0) {
    load_tile_async(sQ, q + b * sq.b + head * sq.h, sq.t, q0, d.T);
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
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk)
        ldsm_x4(a_frag(sQ, 16 * w, kk, l), qa[kk]);
    }

    // S = Q.K^T: n-tile j holds keys k0 + 8j + 2 (l % 4) + {0, 1}
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < kTile / 16; ++nb) {
        uint32_t g[4];
        ldsm_x4(b_frag(sK, 16 * nb, kk, l), g);
        mma(s[2 * nb], qa[kk], g[0], g[1]);
        mma(s[2 * nb + 1], qa[kk], g[2], g[3]);
      }
    softmax_tile(s, m, lsum, acc, k0, s_lo, s_hi, scale2, l);
    pv_tile(acc, s, sV, l);
    __syncthreads();                    // the stage is read: it may refill
  }
  store_out(out, lse, acc, m, lsum, b, bh, head, t0, d, l, 0, true);
}

// dh = 64n, n = 2 .. 8: one block per (b*h, 64-query tile, 64-column slice
// z of the head dim). Q's n chunks stay in shared memory; each key tile is
// n + 1 steps through a two-stage ring of one tile: chunk c of K (S += Q_c
// . K_c^T, the same sums in the same order in every slice, so all slices
// see the same p and l), then chunk z of V (the softmax step and O_z +=
// P.V_z). Only slice 0 writes lse.
__global__ void __launch_bounds__(kThreadsTc, 2)
flash_fwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ lens, bf16* __restrict__ out,
                      float* __restrict__ lse, Dims d, Strides sq, Strides sk,
                      Strides sv) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int nc = d.dh / kDh, z = blockIdx.z, col0 = z * kDh;
  // Q's nc chunks, then two stages of one tile
  const uint32_t sQ = smem_addr(smem_tc), sSt = sQ + nc * kTileBytes;

  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int q0 = blockIdx.x * kTile;
  const int len = max(0, min(lens[b], d.T));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const float scale2 = kLog2e / sqrtf(static_cast<float>(d.dh));
  const bf16* kb = k + b * sk.b + head * sk.h;
  const bf16* vb = v + b * sv.b + head * sv.h + col0;

  const int t0 = q0 + 16 * w + (l >> 2);
  int s_lo[2], s_hi[2];
  row_windows(t0, len, d, s_lo, s_hi);

  float m[2] = {kNeg, kNeg}, lsum[2] = {0.0f, 0.0f};
  float acc[8][4] = {}, s[8][4] = {};
  int k_begin, k_end;
  key_range(q0, len, d, &k_begin, &k_end);
  const int first = (k_begin / kTile) * kTile;
  const int tiles = k_end > first ? (k_end - first + kTile - 1) / kTile : 0;
  const int steps = tiles * (nc + 1);
  // step g: key tile first + 64 (g / (nc + 1)), part c = g % (nc + 1)
  auto load_step = [&](int g) {
    const int c = g % (nc + 1), k0 = first + (g / (nc + 1)) * kTile;
    const uint32_t dst = sSt + (g & 1) * kTileBytes;
    if (c < nc)
      load_tile_async(dst, kb + c * kDh, sk.t, k0, d.T);
    else
      load_tile_async(dst, vb, sv.t, k0, d.T);
  };
  if (steps > 0) {
    load_chunks_async(sQ, q + b * sq.b + head * sq.h, sq.t, q0, d.T, nc);
    load_step(0);
    cp_async_commit();
  }
  for (int g = 0; g < steps; ++g) {
    const int c = g % (nc + 1), k0 = first + (g / (nc + 1)) * kTile;
    const uint32_t cur = sSt + (g & 1) * kTileBytes;
    if (g + 1 < steps) {
      load_step(g + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (c < nc) {
      if (c == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      }
      const uint32_t sQc = sQ + c * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        uint32_t qa[4];
        ldsm_x4(a_frag(sQc, 16 * w, kk, l), qa);
#pragma unroll
        for (int nb = 0; nb < kTile / 16; ++nb) {
          uint32_t g4[4];
          ldsm_x4(b_frag(cur, 16 * nb, kk, l), g4);
          mma(s[2 * nb], qa, g4[0], g4[1]);
          mma(s[2 * nb + 1], qa, g4[2], g4[3]);
        }
      }
    } else {
      softmax_tile(s, m, lsum, acc, k0, s_lo, s_hi, scale2, l);
      pv_tile(acc, s, cur, l);
    }
    __syncthreads();                    // the stage is read: it may refill
  }
  store_out(out, lse, acc, m, lsum, b, bh, head, t0, d, l, col0, z == 0);
}

// the dynamic shared memory above 48 KB, set once a kernel (so a launch
// is only a launch, and may be captured in a CUDA graph)
template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

int launch(const void* q, const void* k, const void* v, const int* lens,
           void* out, float* lse, const Dims& d, const int* strides,
           bool bf16_path, cudaStream_t stream) {
  const int nc = d.dh / kDh;
  const dim3 grid((d.T + kTile - 1) / kTile, d.B * d.h, nc);
  const Strides s0 = strides_at(strides, 0), s1 = strides_at(strides, 1),
                s2 = strides_at(strides, 2);
  if (bf16_path && nc == 1) {
    constexpr int bytes = 5 * kTileBytes;
    flash_fwd_tc_kernel<<<grid, kThreadsTc, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), lens, static_cast<bf16*>(out), lse, d,
        s0, s1, s2);
  } else if (bf16_path) {
    static const int attr = set_smem(flash_fwd_wide_kernel,
                                     (kMaxDh / kDh + 2) * kTileBytes);
    if (attr) return attr;
    flash_fwd_wide_kernel<<<grid, kThreadsTc, (nc + 2) * kTileBytes,
                            stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), lens, static_cast<bf16*>(out), lse, d,
        s0, s1, s2);
  } else {
    constexpr int bytes = smem_bytes<kDh>(3, 1);
    static const int attr = set_smem(flash_fwd_kernel, bytes);
    if (attr) return attr;
    flash_fwd_kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lens, static_cast<float*>(out), lse, d,
        s0, s1, s2);
  }
  CSR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// q, k, v [B, T, h, dh] (bf16 if `use_bf16` else fp32, strided, head dim
// dense; bf16 rows 16-byte aligned, which the caller checks:
// ops/attention_cuda.py rows_aligned16), lens [B] int32, out [B, T, h, dh]
// contiguous in the same dtype, lse [B, h, T] fp32; dims (host) = {B, T, h,
// dh, chunk, left}, strides (host) = the (b, t, h) element strides of q, k,
// v. dh is one of 64, 128, ..., 512 (any other is refused).
CSR_API int csr_flash_fwd(const void* q, const void* k, const void* v,
                          const int* lens, void* out, float* lse,
                          const int* dims, const int* strides, int use_bf16,
                          cudaStream_t stream) {
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5]};
  if (!dh_taken(d.dh)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, lens, out, lse, d, strides, use_bf16 != 0,
                stream);
}
