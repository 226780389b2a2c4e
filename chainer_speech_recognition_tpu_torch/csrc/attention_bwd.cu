// Flash self-attention backward: dQ over key tiles, dK and dV over query
// tiles, with the probabilities recomputed from the forward's logsumexp
// rows (nothing [T, T] is ever stored).
//
// Replaces ops/attention_pallas.py::_bwd_dq_kernel and ::_bwd_dkv_kernel
// (the TPU kernels behind _flash_backward). The split is the TPU's: the dQ
// kernel walks key tiles, the dK/dV kernel walks query tiles, so each
// output tile has one owner block and neither kernel needs atomics: both
// are deterministic.
//
// q, k, v, dO are read as [B, T, h, dh] through their strides; lse and
// D = rowsum(dO * O) are [B, h, T] fp32 (D is computed by one torch op
// before the launch, as the reference computes it in XLA); dq, dk, dv are
// [B, T, h, dh] contiguous in the compute dtype S. Per tile pair:
//   p  = exp(q.k^T * scale - lse)  where allowed, else exactly 0
//   ds = p * (dO.v^T - D)
//   dq += round_S(ds) . k * scale,  dv += round_S(p)^T . dO,
//   dk += round_S(ds)^T . q * scale
// with fp32 accumulators, as the TPU kernels round p and ds to the input
// dtype before their products.
//
// What bounds them on Hopper: operations, as the forward (each kernel
// recomputes q.k^T and dO.v^T: 8*T*T_eff*dh a (row, head) for dK/dV, 6 for
// dQ, against ~T*dh*16 bytes). Plain fp32 FMA from shared memory in this
// first version, tensor cores later.
//
// Design: one block per (b*h, 64-row tile), 256 threads, the thread layout
// of attention_common.cuh. dQ: the Q and dO tiles stay in shared memory,
// the block walks the key tiles between the bounds of the row's length and
// the chunk window, ds goes through shared memory to the dq product. dK/dV:
// the K and V tiles stay, the block walks every query tile whose rows may
// attend one of its keys (every query row < T, padded rows included, as
// the TPU kernel does), p and ds go through shared memory to the two
// products; a key tile at or past the row's length writes zeros.
#include "attention_common.cuh"

namespace {

using namespace csr_attn;

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

// p and ds of the tile pair (queries q0.., keys k0..) into [64][65] tiles,
// rounded to S
template <typename S>
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
      const float ds = p * (dp[i][j] - d_t);
      if (Ps) Ps[(4 * ty + i) * kLdP + tx + 16 * j] = round_to<S>(p);
      dSs[(4 * ty + i) * kLdP + tx + 16 * j] = round_to<S>(ds);
    }
  }
}

template <typename S, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const S* __restrict__ q, const S* __restrict__ k,
                    const S* __restrict__ v, const S* __restrict__ dout,
                    const int* __restrict__ lens,
                    const float* __restrict__ lse,
                    const float* __restrict__ drows, S* __restrict__ dq,
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

  load_tile<S, DH>(Qs, q, sq, b, head, q0, d.T);
  load_tile<S, DH>(dOs, dout, sdo, b, head, q0, d.T);
  float acc[4][NC] = {};

  int k_begin, k_end;
  key_range(q0, len, d, &k_begin, &k_end);
  for (int k0 = (k_begin / kTile) * kTile; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<S, DH>(Ks, k, sk, b, head, k0, d.T);
    load_tile<S, DH>(Vs, v, sv, b, head, k0, d.T);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    scores_and_dp<DH>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    probs_and_ds<S>(s, dp, q0, k0, len, d, lse_row, d_row, scale, ty, tx,
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
    S* o = dq + ((static_cast<int64_t>(b) * d.T + t) * d.h + head) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = from_f32<S>(acc[i][c] * scale);
  }
}

template <typename S, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const S* __restrict__ q, const S* __restrict__ k,
                     const S* __restrict__ v, const S* __restrict__ dout,
                     const int* __restrict__ lens,
                     const float* __restrict__ lse,
                     const float* __restrict__ drows, S* __restrict__ dk,
                     S* __restrict__ dv, Dims d, Strides sq, Strides sk,
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
    load_tile<S, DH>(Ks, k, sk, b, head, k0, d.T);
    load_tile<S, DH>(Vs, v, sv, b, head, k0, d.T);
    int q_begin, q_end;
    query_range(k0, len, d, &q_begin, &q_end);
    for (int q0 = (q_begin / kTile) * kTile; q0 < q_end; q0 += kTile) {
      __syncthreads();
      load_tile<S, DH>(Qs, q, sq, b, head, q0, d.T);
      load_tile<S, DH>(dOs, dout, sdo, b, head, q0, d.T);
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      scores_and_dp<DH>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
      probs_and_ds<S>(s, dp, q0, k0, len, d, lse_row, d_row, scale, ty, tx,
                      Ps, dSs);
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
      dk[off + tx + 16 * c] = from_f32<S>(ak[i][c] * scale);
      dv[off + tx + 16 * c] = from_f32<S>(av[i][c]);
    }
  }
}

template <typename S, int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const int* lens, const float* lse, const float* drows,
              void* dq, const Dims& d, const int* strides,
              cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH>(4, 1);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<S, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((d.T + kTile - 1) / kTile, d.B * d.h);
  flash_bwd_dq_kernel<S, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(k),
      static_cast<const S*>(v), static_cast<const S*>(dout), lens, lse,
      drows, static_cast<S*>(dq), d, strides_at(strides, 0),
      strides_at(strides, 1), strides_at(strides, 2),
      strides_at(strides, 3));
  CSR_RETURN_LAUNCH_STATUS();
}

template <typename S, int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const int* lens, const float* lse, const float* drows,
               void* dk, void* dv, const Dims& d, const int* strides,
               cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH>(4, 2);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<S, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((d.T + kTile - 1) / kTile, d.B * d.h);
  flash_bwd_dkv_kernel<S, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(k),
      static_cast<const S*>(v), static_cast<const S*>(dout), lens, lse,
      drows, static_cast<S*>(dk), static_cast<S*>(dv), d,
      strides_at(strides, 0), strides_at(strides, 1),
      strides_at(strides, 2), strides_at(strides, 3));
  CSR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// q, k, v, dout [B, T, h, dh] (S = bf16 if `bf16` else fp32, strided, head
// dim dense), lens [B] int32, lse and drows [B, h, T] fp32, dq [B, T, h,
// dh] S contiguous; dims (host) = {B, T, h, dh, chunk, left}, strides
// (host) = the (b, t, h) element strides of q, k, v, dout. dh is 64.
CSR_API int csr_flash_bwd_dq(const void* q, const void* k, const void* v,
                             const void* dout, const int* lens,
                             const float* lse, const float* drows, void* dq,
                             const int* dims, const int* strides, int bf16,
                             cudaStream_t stream) {
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5]};
  if (d.dh != 64) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lens, lse, drows,
                                             dq, d, strides, stream)
              : launch_dq<float, 64>(q, k, v, dout, lens, lse, drows, dq, d,
                                     strides, stream);
}

// as csr_flash_bwd_dq, writing dk and dv [B, T, h, dh] S contiguous
CSR_API int csr_flash_bwd_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const int* lens,
                              const float* lse, const float* drows, void* dk,
                              void* dv, const int* dims, const int* strides,
                              int bf16, cudaStream_t stream) {
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5]};
  if (d.dh != 64) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lens, lse,
                                              drows, dk, dv, d, strides,
                                              stream)
              : launch_dkv<float, 64>(q, k, v, dout, lens, lse, drows, dk, dv,
                                      d, strides, stream);
}
