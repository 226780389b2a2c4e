// Bidirectional GRU recurrence, inference (no residual streams).
//
// Replaces ops/rnn_pallas.py::_gru_fwd_kernel in its residual-free form
// (_fwd_impl(residuals=False), reached through birnn_pallas's primal).
//
// Same boundary as the TPU kernel: xs [T, R=2B, 3H] in the stream dtype
// (bf16 under bf16 compute, fp32 under fp32), w [2, H, 3H] already cast to
// the compute dtype by the wrapper (the TPU kernel casts it in-step, which
// is the same value), lo/hi [R] fp32 -> ys [T, R, H] fp32. Rows [0, B) use
// w[0] and rows [B, 2B) use w[1]; row r is live at step t iff
// lo[r] <= t < hi[r], and its h is frozen otherwise. The recurrent product
// rounds h (and w) to the compute dtype and accumulates in fp32, exactly as
// _dot2; the carry and the gate math (_gru_gates) stay fp32.
//
// What bounds it on Hopper: the sequential dependency over T. Each step is
// a [rows x H] x [H x 3H] product that needs all of W (256*768 bf16 =
// 393 KB per direction at bigru) and the previous h. In this design every
// block streams its direction's W from L2 once per step (W fits L2 many
// times over, never shared memory), so a step costs the L2 latency of the
// W loads unless they are overlapped, and at most the L2 bandwidth divided
// among all blocks' W streams (64 blocks x 393 KB = 25 MB a step at B=32).
//
// Design (the simple right version): rows are independent given W, so a
// block owns kRows rows of one direction and loops over all T inside the
// kernel; nothing crosses blocks. Thread j owns hidden unit j: it
// accumulates the r, z and n pre-activations of unit j for its rows (W
// reads coalesced across j, h broadcast from shared memory as float4),
// applies the gates and keeps its fp32 h in registers. W is read in
// register chunks of kChunk rows, the next chunk's loads issued before the
// current chunk's FMAs, which hides the L2 latency (measured on an H100 at
// bigru, B=32: 12.7 ms a layer without the pipelining, 4.4 ms with it at
// kRows=4, 3.2 ms at kRows=1, the chosen value). The compute-dtype copy of
// h that the next step reads is double-buffered in shared memory, so a
// step needs one barrier. Bounds: 32 <= H <= 512, H % 32 == 0 (one thread
// per unit; at ~120 registers a thread, 512 threads fill one SM's register
// file; capping registers with __launch_bounds__ measured 25% slower);
// any B. Keeping W resident across SMs (thread block clusters
// with distributed shared memory, one slice of W per SM) and tensor-core
// products are later work.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = 1;   // batch rows per block
constexpr int kChunk = 8;  // W rows per register batch (H % 32 == 0)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an fp32 value to the compute dtype S (kept in an fp32 register)
template <typename S>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// W rows k0..k0+kChunk-1 of unit j's three gate columns
template <typename S>
__device__ __forceinline__ void load_chunk(const S* __restrict__ wd, int k0,
                                           int j, int H, int G, S* wr, S* wz,
                                           S* wn) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const S* wk = wd + static_cast<int64_t>(k0 + u) * G;
    wr[u] = wk[j];
    wz[u] = wk[H + j];
    wn[u] = wk[2 * H + j];
  }
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename S>
__global__ void gru_fwd_kernel(const S* __restrict__ xs,
                               const S* __restrict__ w,
                               const float* __restrict__ lo,
                               const float* __restrict__ hi,
                               float* __restrict__ ys, int T, int B, int H) {
  extern __shared__ float hs[];  // [2][kRows][H] compute-dtype h
  const int d = blockIdx.y;      // direction
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - r0);
  const int j = threadIdx.x;     // hidden unit
  const int R = 2 * B;
  const int G = 3 * H;
  const S* wd = w + static_cast<int64_t>(d) * H * G;

  float h[kRows], lo_r[kRows], hi_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    h[r] = 0.0f;
    lo_r[r] = 1.0f;  // rows past B are never live
    hi_r[r] = 0.0f;
    if (r < nrows) {
      lo_r[r] = lo[d * B + r0 + r];
      hi_r[r] = hi[d * B + r0 + r];
    }
    hs[r * H + j] = 0.0f;
  }
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float xr[kRows], xz[kRows], xn[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      xr[r] = xz[r] = xn[r] = 0.0f;
      if (r < nrows) {
        const S* x = xs + (static_cast<int64_t>(t) * R + d * B + r0 + r) * G;
        xr[r] = to_f32(x[j]);
        xz[r] = to_f32(x[H + j]);
        xn[r] = to_f32(x[2 * H + j]);
      }
    }
    float ar[kRows], az[kRows], an[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) ar[r] = az[r] = an[r] = 0.0f;
    const float* hb = hs + cur * kRows * H;
    // W in chunks of kChunk rows held in registers; the next chunk's loads
    // are issued before this chunk's FMAs, so L2 latency overlaps compute
    S wr[kChunk], wz[kChunk], wn[kChunk];
    load_chunk(wd, 0, j, H, G, wr, wz, wn);
    for (int k0 = 0; k0 < H; k0 += kChunk) {
      S nr[kChunk], nz[kChunk], nn[kChunk];
      if (k0 + kChunk < H) load_chunk(wd, k0 + kChunk, j, H, G, nr, nz, nn);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4* h4 = reinterpret_cast<const float4*>(hb + r * H + k0);
#pragma unroll
        for (int q = 0; q < kChunk / 4; ++q) {
          const float4 hv = h4[q];
          const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            ar[r] = fmaf(hk[u], to_f32(wr[4 * q + u]), ar[r]);
            az[r] = fmaf(hk[u], to_f32(wz[4 * q + u]), az[r]);
            an[r] = fmaf(hk[u], to_f32(wn[4 * q + u]), an[r]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        wr[u] = nr[u];
        wz[u] = nz[u];
        wn[u] = nn[u];
      }
    }
    float* hnext = hs + (cur ^ 1) * kRows * H;
    const float tf = static_cast<float>(t);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float rg = sigmoidf(xr[r] + ar[r]);
      const float z = sigmoidf(xz[r] + az[r]);
      const float n = tanhf(xn[r] + rg * an[r]);
      const float hn = (1.0f - z) * n + z * h[r];
      if (lo_r[r] <= tf && tf < hi_r[r]) h[r] = hn;
      if (r < nrows)
        ys[(static_cast<int64_t>(t) * R + d * B + r0 + r) * H + j] = h[r];
      hnext[r * H + j] = round_to<S>(h[r]);
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <typename S>
int launch(const void* xs, const void* w, const float* lo, const float* hi,
           float* ys, int T, int B, int H, cudaStream_t stream) {
  const dim3 grid((B + kRows - 1) / kRows, 2);
  const size_t smem = 2 * kRows * H * sizeof(float);
  gru_fwd_kernel<S><<<grid, H, smem, stream>>>(
      static_cast<const S*>(xs), static_cast<const S*>(w), lo, hi, ys, T, B,
      H);
  CSR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// xs [T, 2B, 3H] and w [2, H, 3H] both bf16 (bf16 != 0) or both fp32;
// lo/hi [2B] fp32; ys [T, 2B, H] fp32. Requires 32 <= H <= 512,
// H % 32 == 0, T >= 1, B >= 1 (the wrapper checks).
CSR_API int csr_gru_fwd(const void* xs, const void* w, const float* lo,
                        const float* hi, float* ys, int T, int B, int H,
                        int bf16, cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16>(xs, w, lo, hi, ys, T, B, H, stream);
  return launch<float>(xs, w, lo, hi, ys, T, B, H, stream);
}
