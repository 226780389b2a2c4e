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
// Wider heads (dh = 64n, n = 2 .. 8, the reference's set): each score
// tile is computed once for all n 64-column slices of the output. Bound as
// above, by operations (4*T_eff*dh a row and head, ~350 a byte at T' ~
// 700); on mma.sync the kernel is held by its shared-memory reads
// (ldmatrix), its barriers and its instruction count, so the design reads
// each operand as few times as its registers allow and fixes every loop
// count at compile time (a template a width). A block owns every slice of
// its rows: a whole 64-row tile, or at dh 192-256 32 rows where the grid
// has fewer 64-row tiles than the card has SMs (fwd_rows), in W warp
// groups (fwd_warps: one at dh = 128, else four; a warp's accumulators
// are 32n / W registers), each a warp for every 16 rows. Warp (r, g) owns
// rows 16r .. 16r + 15 and the n-tiles [ntile_lo(g, W), ntile_lo(g + 1,
// W)) of the 8: 8-key column blocks of the score tile, and the same
// 8-column blocks of every slice's output. Q stays in shared memory at
// full width (n chunk tiles; with one warp group its A fragments in
// registers); each key tile's n K chunks, then its n V chunks, stream
// through a ring of 2-4 cp.async stages (fwd_stages: as many as fit), each
// loaded once a block. Each warp sums its n-tiles of S over the head dim
// in one accumulator an n-tile, chunk by chunk. With one warp group a warp
// holds whole score rows and runs the slice-a-block kernel's softmax in
// registers. With four, the four warps that share rows meet twice a key
// tile at a named barrier of their own: after each writes its row maxima
// over its keys (the tile's max m is the largest of the four), and after
// each writes its p = 2^(s - m), bf16 into the P tile (the A operands of
// every warp's P.V, read by ldmatrix) and fp32 into a p tile, from which
// warp groups 0 and 1 add the sums of rows r and r + 8 key by key in
// n-tile order. Every score, max, p, row sum and product is the
// slice-a-block kernel's operation on the same values in the same order
// (the rescaled row sum and its first term in one fma, as that kernel's
// compiler fused them), so out and lse are its bits. 64^3 products a tile
// pair: 2n, against n (n + 1) when each slice was a block that repeated
// the scores. Shared memory 80-227 KB (ops/attention_cuda.py
// flash_fwd_plan computes the launch).
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

// the rows' out (acc / l) and lse; a row with no allowed key (l = 0) gets
// out = 0 and lse = -1e30
__device__ __forceinline__ void store_out(bf16* out, float* lse,
                                          const float acc[8][4],
                                          const float m[2], float lsum[2],
                                          int b, int bh, int head, int t0,
                                          const Dims& d, int l) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
    const int t = t0 + 8 * i;
    if (t >= d.T) continue;
    const bool live = lsum[i] > 0.0f;
    const float den = live ? lsum[i] : 1.0f;   // acc is 0 where l is
    bf16* o = out + ((static_cast<int64_t>(b) * d.T + t) * d.h + head) * d.dh +
              2 * (l & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
    if ((l & 3) == 0)
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
  store_out(out, lse, acc, m, lsum, b, bh, head, t0, d, l);
}

// ------------------------ bf16, dh = 64n (n = 2 .. 8): slices in one block

// row stride (floats) of the fp32 p tile: the rows of a half-warp's float2
// stores and loads fall in distinct banks
constexpr int kLdPf = kTile + 8;
constexpr int kSmSlots = 128;   // a grid of fewer one-block-an-SM blocks
                                // than this leaves some of an H100's 132
                                // SMs idle
constexpr int kMaxStages = 4;   // ring stages, at most

// warp groups a block at dh = 64n: one at n = 2 (a warp owns whole score
// rows and every slice of them: no exchange), else four (a warp's
// accumulators are 32n / W registers)
__host__ __device__ constexpr int fwd_warps(int n) {
  return n == 2 ? 1 : kMaxSlices;
}
__host__ __device__ constexpr int fwd_threads(int n, int rows) {
  return 2 * rows * fwd_warps(n);
}
// blocks an SM the launch bounds ask for: one at 512 threads, else two
__host__ __device__ constexpr int fwd_blocks(int n, int rows) {
  return fwd_threads(n, rows) >= 512 ? 1 : 2;
}
// rows a block at dh = 64n on a grid of `tiles` 64-row query tiles (b*h
// times the tiles of T): the whole tile, but at n = 3, 4, where the
// tiles' blocks (one an SM) do not fill the card, two blocks a tile of 32
// rows (two warps a warp group, two blocks an SM; past n = 4 two such
// blocks do not hold a ring of whole tiles, and at n = 2 whole tiles ran
// faster on an H100)
__host__ __device__ constexpr int fwd_rows(int n, int tiles) {
  return n > 2 && n <= kMaxSlices && tiles < kSmSlots ? kTile / 2 : kTile;
}
// shared memory besides the ring: Q's n chunk tiles of `rows` rows and,
// with more than one warp group, the bf16 P tile, the fp32 p tile and each
// warp group's row maxima
__host__ __device__ constexpr int fwd_fixed(int n, int rows) {
  return fwd_warps(n) == 1
             ? n * rows * 128
             : (n + 1) * rows * 128 + rows * kLdPf * 4 +
                   kMaxSlices * rows * 4;
}
// ring stages, each a key tile's n chunks of K or of V: as many as fit,
// up to kMaxStages, in the block's share of an SM's shared memory (all of
// it at one block an SM, else half; two always fit)
__host__ __device__ constexpr int fwd_stages(int n, int rows) {
  const int share =
      fwd_blocks(n, rows) == 1 ? kSmemBlockMax : kSmemBlockMax / 2 - 512;
  const int fit = (share - fwd_fixed(n, rows)) / (n * kTileBytes);
  return fit < kMaxStages ? fit : kMaxStages;
}
// dynamic shared memory of the wide forward (ops/attention_cuda.py
// flash_fwd_plan computes the same)
__host__ __device__ constexpr int fwd_smem(int n, int rows) {
  return fwd_fixed(n, rows) + fwd_stages(n, rows) * n * kTileBytes;
}

// a barrier of the `threads` threads that share a named barrier `id`
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared2(uint32_t a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(x), "f"(y)
               : "memory");
}
__device__ __forceinline__ void ld_shared2(uint32_t a, float& x, float& y) {
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x), "=f"(y)
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void st_shared1(uint32_t a, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(x) : "memory");
}
__device__ __forceinline__ float ld_shared1(uint32_t a) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(a) : "memory");
  return x;
}

// S (x) of a warp's 16 rows r0.. against the kJ n-tiles j0.. (rows 8 j0..
// of the key tile bt; kJ even), summed over one 64-column chunk: x += A .
// Bt^T
template <int kJ>
__device__ __forceinline__ void score_ntiles(uint32_t a, uint32_t bt, int r0,
                                             int j0, int l, float x[kJ][4]) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(a_frag(a, r0, kk, l), fa);
#pragma unroll
    for (int j = 0; j < kJ; j += 2) {
      uint32_t g[4];
      ldsm_x4(b_frag(bt, 8 * (j0 + j), kk, l), g);
      mma(x[j], fa, g[0], g[1]);
      mma(x[j + 1], fa, g[2], g[3]);
    }
  }
}

// dh = 64N (N = 2 .. 8): one block per (b*h, 16R rows of a 64-query tile:
// the tile, or a half) owning its N slices, W = fwd_warps(N) warp groups
// of R warps; warp (r, g) owns the rows 16r .. 16r + 15 and the n-tiles
// [ntile_lo(g, W), ntile_lo(g + 1, W)): of each key tile's keys in the
// scores, of each slice's head columns in the products. Q's N chunks stay
// in shared memory (with one warp group, their A fragments in registers);
// each key tile in the rows' window streams through a ring of fwd_stages
// stages, loaded that many steps less one ahead, in two steps: its N K
// chunks (S += Q_c . K_c^T over the warp's keys, each score once a block),
// then its N V chunks (O_s += P . V_s over the warp's columns of each
// slice s).
//
// With one warp group a warp holds whole score rows: the slice-a-block
// kernel's softmax_tile, and P from registers. With four, after the last
// K step the four warps that share rows exchange through shared memory,
// under a named barrier of their own: each warp's row maxima over its
// keys, a barrier, the tile's row max m, then p = 2^(s - m) of its keys
// into the bf16 P tile (the products' A operands, rounded as the reference
// rounds p) and the fp32 p tile, a barrier, and warp groups 0 and 1 add
// every p of the rows r and r + 8 to their row sums l in the order of the
// slice-a-block kernel (key by key in n-tile order, the quad of lanes
// summed at the end). Either way out and lse are that kernel's bits.
template <int N, int R>
__global__ void __launch_bounds__(fwd_threads(N, 16 * R),
                                  fwd_blocks(N, 16 * R))
flash_fwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ lens, bf16* __restrict__ out,
                      float* __restrict__ lse, Dims d, Strides sq, Strides sk,
                      Strides sv) {
  constexpr int W = fwd_warps(N);
  constexpr int kJ = 8 / W;                 // n-tiles a warp
  constexpr int kRows = 16 * R;
  constexpr int kN = fwd_threads(N, kRows);
  constexpr int kChunk = kRows * 128;       // a [kRows][64] bf16 tile
  constexpr int kStages = fwd_stages(N, kRows);
  constexpr int kStage = N * kTileBytes;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  // Q's chunks; with W > 1 the P tile, the p tile, the row maxima
  // [W][kRows]; the ring
  const uint32_t sQ = smem_addr(smem_tc), sP = sQ + N * kChunk;
  const uint32_t sPf = sP + kChunk, sXm = sPf + kRows * kLdPf * 4;
  const uint32_t sRing = sQ + fwd_fixed(N, kRows);

  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int tq = blockIdx.x * kTile, q0 = tq + kRows * blockIdx.z;
  const int len = max(0, min(lens[b], d.T));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int rl = 16 * (w % R), g = w / R;
  const int r = rl + (l >> 2);              // the thread's rows r, r + 8
  const int j0 = ntile_lo(g, W);
  const float scale2 = kLog2e / sqrtf(static_cast<float>(d.dh));
  const bf16* kb = k + b * sk.b + head * sk.h;
  const bf16* vb = v + b * sv.b + head * sv.h;

  const int t0 = q0 + r;
  int s_lo[2], s_hi[2];
  row_windows(t0, len, d, s_lo, s_hi);

  // m: running max (log2 units); lsum: this thread's part of the row sums,
  // of both rows with one warp group, else of row r + 8g in groups 0 and 1
  float m[2] = {kNeg, kNeg}, lsum[2] = {0.0f, 0.0f};
  float acc[N][kJ][4] = {}, s[kJ][4];
  uint32_t qa[W == 1 ? N : 1][kDh / 16][4];
  // the key tiles of the whole 64-row tile, as the slice-a-block kernel
  // walked them
  int k_begin, k_end;
  key_range(tq, len, d, &k_begin, &k_end);
  const int first = (k_begin / kTile) * kTile;
  const int tiles = k_end > first ? (k_end - first + kTile - 1) / kTile : 0;
  const int steps = 2 * tiles;
  // step e: key tile first + 64 (e / 2), its K chunks (e even) or its V
  // chunks, into stage e % kStages; a group is committed for every step,
  // empty past the last
  auto load_step = [&](int e) {
    if (e < steps) {
      const bool score = (e & 1) == 0;
      const bf16* src = score ? kb : vb;
      const int64_t st = score ? sk.t : sv.t;
      const uint32_t dst = sRing + (e % kStages) * kStage;
#pragma unroll
      for (int c = 0; c < N; ++c)
        load_tile_async<kN>(dst + c * kTileBytes, src + c * kDh, st,
                            first + (e >> 1) * kTile, d.T);
    }
    cp_async_commit();
  };
  if (steps > 0) {
    load_chunks_async<kN, kRows>(sQ, q + b * sq.b + head * sq.h, sq.t, q0,
                                 d.T, N);
#pragma unroll
    for (int e = 0; e + 1 < kStages; ++e) load_step(e);
  }
  for (int e = 0; e < steps; ++e) {
    cp_async_wait<kStages - 2>();   // step e's tiles have arrived
    __syncthreads();            // for every thread; and step e - 1 is done
    load_step(e + kStages - 1);     // into the stage step e - 1 used
    const int k0 = first + (e >> 1) * kTile;
    const uint32_t cur = sRing + (e % kStages) * kStage;
    if (e & 1) {
      // O_z += P . V_z for every slice z
      if constexpr (W == 1) {
#pragma unroll
        for (int z = 0; z < N; ++z)
          pv_tile(acc[z], s, cur + z * kTileBytes, l);
      } else {
        // P's A operands from the P tile, a k-step at a time
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          uint32_t pa[4];
          ldsm_x4(a_frag(sP, rl, kk, l), pa);
#pragma unroll
          for (int z = 0; z < N; ++z) {
            const uint32_t vt = cur + z * kTileBytes;
#pragma unroll
            for (int j = 0; j < kJ; j += 2) {
              uint32_t f[4];
              ldsm_x4_t(bt_chunk(vt, 16 * kk, j0 + j, l), f);
              mma(acc[z][j], pa, f[0], f[1]);
              mma(acc[z][j + 1], pa, f[2], f[3]);
            }
          }
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = 0.0f;
    if constexpr (W == 1) {
      if (e == 0) {
#pragma unroll
        for (int z = 0; z < N; ++z)
#pragma unroll
          for (int kk = 0; kk < kDh / 16; ++kk)
            ldsm_x4(a_frag(sQ + z * kChunk, rl, kk, l), qa[z][kk]);
      }
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const uint32_t kt = cur + c * kTileBytes;
#pragma unroll
        for (int kk = 0; kk < kDh / 16; ++kk)
#pragma unroll
          for (int nb = 0; nb < kTile / 16; ++nb) {
            uint32_t g4[4];
            ldsm_x4(b_frag(kt, 16 * nb, kk, l), g4);
            mma(s[2 * nb], qa[c][kk], g4[0], g4[1]);
            mma(s[2 * nb + 1], qa[c][kk], g4[2], g4[3]);
          }
      }
      // the rows' softmax in registers (slice 0 rescaled in it), the other
      // slices rescaled alike
      const float m_old[2] = {m[0], m[1]};
      softmax_tile(s, m, lsum, acc[0], k0, s_lo, s_hi, scale2, l);
      const float corr[2] = {exp2f(m_old[0] - m[0]), exp2f(m_old[1] - m[1])};
#pragma unroll
      for (int z = 1; z < N; ++z)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[z][j][x] *= corr[x >> 1];
    } else {
#pragma unroll
      for (int c = 0; c < N; ++c)
        score_ntiles<kJ>(sQ + c * kChunk, cur + c * kTileBytes, rl, j0, l, s);
      // the scores are whole: scaled into log2 units, masked outside each
      // row's window (only on tiles some row of the warp does not wholly
      // see), and the warp's row maxima over its keys to its row group
      const bool whole = k0 >= max(s_lo[0], s_lo[1]) &&
                         k0 + kTile <= min(s_hi[0], s_hi[1]);
      const bool masked = !__all_sync(0xffffffffu, whole);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = x >> 1;
          const int key = k0 + 8 * (j0 + j) + 2 * (l & 3) + (x & 1);
          s[j][x] = masked && (key < s_lo[i] || key >= s_hi[i])
                        ? -INFINITY
                        : s[j][x] * scale2;
          mx[i] = fmaxf(mx[i], s[j][x]);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        if ((l & 3) == 0) st_shared1(sXm + 4 * (g * kRows + r + 8 * i), mx[i]);
      }
      named_sync(1 + w % R, 32 * W);
      // the tile's row max, p of the warp's keys into the P and p tiles
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mn = ld_shared1(sXm + 4 * (r + 8 * i));
#pragma unroll
        for (int o = 1; o < W; ++o)
          mn = fmaxf(mn, ld_shared1(sXm + 4 * (o * kRows + r + 8 * i)));
        corr[i] = exp2f(m[i] - mn);
        m[i] = mn;
      }
      const uint32_t p0 = sPf + 4 * (r * kLdPf + 8 * j0 + 2 * (l & 3));
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          s[j][x] = exp2f(s[j][x] - m[x >> 1]);      // masked: 2^-inf = 0
        st_shared2(p0 + 32 * j, s[j][0], s[j][1]);
        st_shared2(p0 + 32 * j + 32 * kLdPf, s[j][2], s[j][3]);
      }
      store_ntiles<kJ>(sP, s, rl, j0, kJ, l);
#pragma unroll
      for (int z = 0; z < N; ++z)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[z][j][x] *= corr[x >> 1];
      named_sync(1 + w % R, 32 * W);
      if (g < 2) {
        // row r + 8g: rescaled with its first p in one fma, as the
        // slice-a-block kernel's compiler fused them, then every other p of
        // the tile added in order
        const uint32_t prow = sPf + 4 * ((r + 8 * g) * kLdPf + 2 * (l & 3));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x, y;
          ld_shared2(prow + 32 * j, x, y);
          lsum[0] = j == 0 ? fmaf(lsum[0], g == 0 ? corr[0] : corr[1], x)
                           : lsum[0] + x;
          lsum[0] += y;
        }
      }
    }
  }
  // the row sums, summed over each row's quad (with W > 1 from warp groups
  // 0 and 1 to all: every thread has passed the last step's barrier, so
  // the row maxima's place is free)
  float li[2];
  if constexpr (W == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
      lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
      li[i] = lsum[i];
    }
  } else {
    if (g < 2) {
      lsum[0] += __shfl_xor_sync(0xffffffffu, lsum[0], 1);
      lsum[0] += __shfl_xor_sync(0xffffffffu, lsum[0], 2);
      if ((l & 3) == 0) st_shared1(sXm + 4 * (r + 8 * g), lsum[0]);
    }
    __syncthreads();
    li[0] = ld_shared1(sXm + 4 * r);
    li[1] = ld_shared1(sXm + 4 * (r + 8));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + 8 * i;
    if (t >= d.T) continue;
    const bool live = li[i] > 0.0f;
    const float den = live ? li[i] : 1.0f;    // acc is 0 where l is
    bf16* o = out + ((static_cast<int64_t>(b) * d.T + t) * d.h + head) * d.dh +
              8 * j0 + 2 * (l & 3);
#pragma unroll
    for (int z = 0; z < N; ++z)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o + kDh * z + 8 * j) =
            __floats2bfloat162_rn(acc[z][j][2 * i] / den,
                                  acc[z][j][2 * i + 1] / den);
    if (g == 0 && (l & 3) == 0)
      lse[static_cast<int64_t>(bh) * d.T + t] =
          live ? m[i] * kLn2 + logf(li[i]) : kNeg;
  }
}

// the dynamic shared memory above 48 KB, set once a kernel (so a launch
// is only a launch, and may be captured in a CUDA graph)
template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// launches flash_fwd_wide_kernel<N, R> on the grid of (query tiles, b*h,
// the tile's row blocks), the most dynamic shared memory a block may have
// allowed once for that kernel, as set_smem does
template <int N, int R, typename... Act>
int launch_wide_rows(const Dims& d, cudaStream_t stream, Act... args) {
  constexpr auto kernel = flash_fwd_wide_kernel<N, R>;
  static const int attr = set_smem(kernel, kSmemBlockMax);
  if (attr) return attr;
  const dim3 grid((d.T + kTile - 1) / kTile, d.B * d.h, 4 / R);
  kernel<<<grid, fwd_threads(N, 16 * R), fwd_smem(N, 16 * R), stream>>>(
      args...);
  CSR_RETURN_LAUNCH_STATUS();
}

// blocks of fwd_rows' rows (32-row blocks exist at N = 3, 4 only)
template <int N, typename... Act>
int launch_wide(const Dims& d, cudaStream_t stream, Act... args) {
  if constexpr (N > 2 && N <= kMaxSlices) {
    const int tiles = (d.T + kTile - 1) / kTile * d.B * d.h;
    if (fwd_rows(N, tiles) != kTile)
      return launch_wide_rows<N, 2>(d, stream, args...);
  }
  return launch_wide_rows<N, 4>(d, stream, args...);
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
    const auto* q_ = static_cast<const bf16*>(q);
    const auto* k_ = static_cast<const bf16*>(k);
    const auto* v_ = static_cast<const bf16*>(v);
    auto* o_ = static_cast<bf16*>(out);
    switch (nc) {
      case 2:
        return launch_wide<2>(d, stream, q_, k_, v_, lens, o_, lse, d, s0,
                              s1, s2);
      case 3:
        return launch_wide<3>(d, stream, q_, k_, v_, lens, o_, lse, d, s0,
                              s1, s2);
      case 4:
        return launch_wide<4>(d, stream, q_, k_, v_, lens, o_, lse, d, s0,
                              s1, s2);
      case 5:
        return launch_wide<5>(d, stream, q_, k_, v_, lens, o_, lse, d, s0,
                              s1, s2);
      case 6:
        return launch_wide<6>(d, stream, q_, k_, v_, lens, o_, lse, d, s0,
                              s1, s2);
      case 7:
        return launch_wide<7>(d, stream, q_, k_, v_, lens, o_, lse, d, s0,
                              s1, s2);
      default:
        return launch_wide<8>(d, stream, q_, k_, v_, lens, o_, lse, d, s0,
                              s1, s2);
    }
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

// The wide forward's launch at head width dh (128 .. 512) on a grid of
// `tiles` 64-row query tiles (b*h times the tiles of T) into out[0 .. W +
// 5]: {W = fwd_warps warp groups, rows a block (fwd_rows), dynamic shared
// memory bytes, blocks an SM holds (the occupancy query), ring stages
// (fwd_stages), then ntile_lo(g, W) for g = 0 .. W: the n-tiles each warp
// group owns} (ops/attention_cuda.py's flash_fwd_plan computes all but the
// occupancy) → the query's status
CSR_API int csr_flash_fwd_plan(int dh, int tiles, int* out) {
  if (!dh_taken(dh) || dh == kDh || tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = dh / kDh, W = fwd_warps(n), rows = fwd_rows(n, tiles);
  const int smem = fwd_smem(n, rows), threads = fwd_threads(n, rows);
  out[0] = W;
  out[1] = rows;
  out[2] = smem;
  out[4] = fwd_stages(n, rows);
  for (int g = 0; g <= W; ++g) out[5 + g] = ntile_lo(g, W);
  auto occupancy = [&](auto kernel) {
    const int e = set_smem(kernel, kSmemBlockMax);
    return e ? e
             : static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &out[3], kernel, threads, smem));
  };
  if (rows != kTile) {
    return n == 3 ? occupancy(flash_fwd_wide_kernel<3, 2>)
                  : occupancy(flash_fwd_wide_kernel<4, 2>);
  }
  return n == 2   ? occupancy(flash_fwd_wide_kernel<2, 4>)
       : n == 3   ? occupancy(flash_fwd_wide_kernel<3, 4>)
       : n == 4   ? occupancy(flash_fwd_wide_kernel<4, 4>)
       : n == 5   ? occupancy(flash_fwd_wide_kernel<5, 4>)
       : n == 6   ? occupancy(flash_fwd_wide_kernel<6, 4>)
       : n == 7   ? occupancy(flash_fwd_wide_kernel<7, 4>)
                  : occupancy(flash_fwd_wide_kernel<8, 4>);
}
