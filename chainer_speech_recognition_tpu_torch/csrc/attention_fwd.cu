// Flash self-attention forward: online softmax over key tiles, with the
// key-padding mask and the chunk-causal mask built in the kernel, and the
// logsumexp rows for the backward.
//
// Replaces ops/attention_pallas.py::_fwd_kernel (the TPU kernel behind
// _flash_forward / flash_mhsa).
//
// q, k, v are read as [B, T, h, dh] through their strides (the q/k/v
// slices of the fused qkv projection need no copy); out is [B, T, h, dh] in
// the compute dtype S (fp32 or bf16), lse [B, h, T] fp32.
//
// What bounds it on Hopper: operations. 4*T*T_eff*dh per (row, head)
// (T_eff the keys inside a row's window) against ~T*dh*10 bytes moved:
// at T' ~ 700 that is ~100 flops a byte, above the fp32 FMA ridge
// (67 TFLOP/s / 3.35 TB/s = 20). This first version multiplies in plain
// fp32 FMA from shared memory (a product of two bf16 values is exact in
// fp32, so bf16 inputs give the reference's fp32 scores), not on the
// tensor cores; mma/wgmma with a TMA-fed pipeline is later work.
//
// Design: one block per (b*h, 64-query tile), 256 threads. The Q tile is
// staged in shared memory once; the block walks the 64-key tiles between
// the bounds that the row's length and the chunk window give (the TPU
// kernel visits every key block and skips in _skip_block; here no tile
// outside the window is loaded), masking a partial tile per element at
// -1e30. Each thread keeps a 4 x 4 block of scores, the running max m and
// sum l of its 4 rows (shuffle reductions over the 16 lanes of a row) and
// a 4 x dh/16 block of the output accumulator in fp32 registers; the
// probabilities go through shared memory rounded to S (the reference
// rounds them to the compute dtype before the value product) while l sums
// them unrounded. Masked scores contribute exactly 0, so a row with no
// allowed key ends with l = 0 and is written as out = 0, lse = -1e30:
// every row stays finite.
#include "attention_common.cuh"

namespace {

using namespace csr_attn;

template <typename S, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const S* __restrict__ q, const S* __restrict__ k,
                 const S* __restrict__ v, const int* __restrict__ lens,
                 S* __restrict__ out, float* __restrict__ lse, Dims d,
                 Strides sq, Strides sk, Strides sv) {
  constexpr int LD = DH + 1;
  constexpr int NC = DH / 16;           // head-dim columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;          // [64][65]

  const int bh = blockIdx.y, b = bh / d.h, head = bh % d.h;
  const int q0 = blockIdx.x * kTile;
  const int len = max(0, min(lens[b], d.T));
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));

  load_tile<S, DH>(Qs, q, sq, b, head, q0, d.T);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  int k_begin, k_end;
  key_range(q0, len, d, &k_begin, &k_end);
  for (int k0 = (k_begin / kTile) * kTile; k0 < k_end; k0 += kTile) {
    __syncthreads();                    // the previous tile's readers are done
    load_tile<S, DH>(Ks, k, sk, b, head, k0, d.T);
    load_tile<S, DH>(Vs, v, sv, b, head, k0, d.T);
    __syncthreads();

    float s[4][4] = {};
    tile_dot<DH>(Qs, Ks, ty, tx, s);
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
        Ps[(4 * ty + i) * kLdP + tx + 16 * j] = round_to<S>(p);
      }
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * ty + i) * kLdP + key];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[key * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= d.T) continue;
    const bool live = l[i] > 0.0f;
    S* o = out + ((static_cast<int64_t>(b) * d.T + t) * d.h + head) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[tx + 16 * c] = from_f32<S>(live ? acc[i][c] / l[i] : 0.0f);
    if (tx == 0)
      lse[static_cast<int64_t>(bh) * d.T + t] =
          live ? m[i] + logf(l[i]) : kNeg;
  }
}

template <typename S, int DH>
int launch(const void* q, const void* k, const void* v, const int* lens,
           void* out, float* lse, const Dims& d, const int* strides,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH>(3, 1);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<S, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((d.T + kTile - 1) / kTile, d.B * d.h);
  flash_fwd_kernel<S, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(k),
      static_cast<const S*>(v), lens, static_cast<S*>(out), lse, d,
      strides_at(strides, 0), strides_at(strides, 1),
      strides_at(strides, 2));
  CSR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// q, k, v [B, T, h, dh] (S = bf16 if `bf16` else fp32, strided, head dim
// dense), lens [B] int32, out [B, T, h, dh] S contiguous, lse [B, h, T]
// fp32; dims (host) = {B, T, h, dh, chunk, left}, strides (host) = the
// (b, t, h) element strides of q, k, v. dh is 64 (the presets' width).
CSR_API int csr_flash_fwd(const void* q, const void* k, const void* v,
                          const int* lens, void* out, float* lse,
                          const int* dims, const int* strides, int bf16,
                          cudaStream_t stream) {
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5]};
  if (d.dh != 64) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, lens, out, lse, d,
                                          strides, stream)
              : launch<float, 64>(q, k, v, lens, out, lse, d, strides,
                                  stream);
}
