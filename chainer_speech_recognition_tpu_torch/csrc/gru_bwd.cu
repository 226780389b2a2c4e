// Bidirectional GRU recurrence, backward (reverse-time gradient walk).
//
// Replaces ops/rnn_pallas.py::_gru_bwd_kernel (the custom VJP's backward,
// _birnn_bwd). Same boundary: gates [T, R=2B, 4H] = (r, z, n, hp_n) from
// the training forward (csrc/gru_fwd.cu, stream dtype), the recurrent
// weights transposed per direction wt [2, 3H, H] in the compute dtype (the
// wrapper makes this copy once per call), lo/hi [R] fp32, h_prev [T, R, H]
// fp32 (the carries shifted by one step, zeros first) and g [T, R, H] fp32
// (the gradient of the layer's ys). Out, in the stream dtype:
//   dxs [T, R, 3H] = (dr, dz, dn) pre-activation gradients, masked to the
//                    live steps; they are the gradient of xs and, for the
//                    r and z columns, of the recurrent pre-activations;
//   dhn [T, R, H]  = the recurrent n pre-activation gradient dn * r, masked.
// dW = sum_t h_prev^T (dr, dz, dhn) is one matmul after the kernel, off the
// sequential path, as the TPU kernel leaves it to XLA.
//
// Per step and row, with dh the carried gradient (fp32):
//   dh_total = g[t] + dh
//   dz = dh_total (h_prev - n) z (1 - z)
//   dn = dh_total (1 - z) (1 - n^2)
//   dr = dn hp_n r (1 - r)
//   dh_prev = dh_total z + (dr, dz, dn r) W^T   (compute-dtype operands,
//                                                fp32 accumulation)
//   dh = live ? dh_prev : dh_total              (frozen outside [lo, hi))
//
// What bounds it on Hopper: as the forward, the dependency over T. Each
// step is a [rows x 3H] x [3H x H] product that needs all of the
// direction's W (393 KB in bf16 at bigru) and the step before's dh. The
// streamed bytes (gates, h_prev, g in; dxs, dhn out: ~76 MB a layer at
// B=24, T=256) would take ~23 us at HBM rate.
//
// Design: the forward's, turned around. Rows are independent given W, so
// one block owns one row of one direction and walks T backwards; thread j
// owns hidden unit j and keeps its dh in a register. The row's (dr, dz,
// dn r) vector goes to shared memory (double-buffered: one barrier a step)
// and each thread then reduces it against column j of W^T, i.e. row j of
// wt[d], streaming wt from L2 in register chunks whose next loads are
// issued before the current FMAs (reads coalesced across j, which is why
// the wrapper passes W transposed: W's own row j is strided by 3H across
// a warp). The chunk is 96 rows at H <= 256: with 8 (the forward's 8 rows
// x 3 gates per batch is 24 loads; the backward has one column) a step
// makes 96 dependent L2 round trips, and a sweep of chunk sizes on an H100
// at B=24, T'=256 found the larger chunks faster up to 96. The product
// keeps four partial sums (the lanes of a float4), so its 3H FMAs form
// four dependent chains instead of one: in chip_smoke.py's profiled
// training steps on an NVIDIA H100 80GB HBM3 (700 W) that made the kernel
// ~5% faster. The next
// step's gates, h_prev and g are loaded before the product, so their
// latency hides behind it. Bounds: 32 <= H <= 512, H % 32 == 0, any B.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "rnn_common.cuh"

namespace {

// wt rows per register batch (3H % kChunk == 0 for H % 32 == 0): 96 up to
// H = 256; above, 512 threads a block leave 128 registers a thread, too
// few for 2 x 96 W values, so the kernel takes 24-row batches there
constexpr int kChunkSmallH = 96;
constexpr int kChunkLargeH = 24;

using namespace csr_rnn;

// the per-step inputs of one (row, unit)
struct StepIn {
  float r, z, n, hn, hp, g;
};

template <typename S>
__device__ __forceinline__ StepIn load_step(const S* __restrict__ gates,
                                            const float* __restrict__ hprev,
                                            const float* __restrict__ g,
                                            int64_t row, int H, int j) {
  const S* gt = gates + row * 4 * H;
  StepIn in;
  in.r = to_f32(gt[j]);
  in.z = to_f32(gt[H + j]);
  in.n = to_f32(gt[2 * H + j]);
  in.hn = to_f32(gt[3 * H + j]);
  in.hp = hprev[row * H + j];
  in.g = g[row * H + j];
  return in;
}

template <typename S, int kChunk, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
    gru_bwd_kernel(const S* __restrict__ gates,
                               const S* __restrict__ wt,
                               const float* __restrict__ lo,
                               const float* __restrict__ hi,
                               const float* __restrict__ hprev,
                               const float* __restrict__ g,
                               S* __restrict__ dxs, S* __restrict__ dhn,
                               int T, int B, int H) {
  extern __shared__ float dp[];  // [2][3H] compute-dtype (dr, dz, dn r)
  const int d = blockIdx.y;      // direction
  const int b = blockIdx.x;      // row within the direction
  const int j = threadIdx.x;     // hidden unit
  const int R = 2 * B;
  const int G = 3 * H;
  const int rr = d * B + b;
  const S* wd = wt + static_cast<int64_t>(d) * G * H;
  const float lo_r = lo[rr];
  const float hi_r = hi[rr];

  float dh = 0.0f;
  int cur = 0;
  StepIn in = load_step(gates, hprev, g, static_cast<int64_t>(T - 1) * R + rr,
                        H, j);
  for (int t = T - 1; t >= 0; --t) {
    const int64_t row = static_cast<int64_t>(t) * R + rr;
    const float dh_total = in.g + dh;
    const float dz = dh_total * (in.hp - in.n) * in.z * (1.0f - in.z);
    const float dn = dh_total * (1.0f - in.z) * (1.0f - in.n * in.n);
    const float dr = dn * in.hn * in.r * (1.0f - in.r);
    const float dhn_j = dn * in.r;
    const float zt = in.z;
    const float tf = static_cast<float>(t);
    const bool live = lo_r <= tf && tf < hi_r;
    S* dx = dxs + row * G;
    dx[j] = from_f32<S>(live ? dr : 0.0f);
    dx[H + j] = from_f32<S>(live ? dz : 0.0f);
    dx[2 * H + j] = from_f32<S>(live ? dn : 0.0f);
    dhn[row * H + j] = from_f32<S>(live ? dhn_j : 0.0f);
    float* buf = dp + cur * G;
    buf[j] = to_f32(from_f32<S>(dr));
    buf[H + j] = to_f32(from_f32<S>(dz));
    buf[2 * H + j] = to_f32(from_f32<S>(dhn_j));
    __syncthreads();
    if (t > 0) in = load_step(gates, hprev, g, row - R, H, j);

    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // 4 partial sums
    S w[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) w[u] = wd[static_cast<int64_t>(u) * H + j];
    for (int k0 = 0; k0 < G; k0 += kChunk) {
      S nw[kChunk];
      if (k0 + kChunk < G) {
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          nw[u] = wd[static_cast<int64_t>(k0 + kChunk + u) * H + j];
      }
      const float4* v4 = reinterpret_cast<const float4*>(buf + k0);
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        const float4 v = v4[q];
        acc.x = fmaf(v.x, to_f32(w[4 * q]), acc.x);
        acc.y = fmaf(v.y, to_f32(w[4 * q + 1]), acc.y);
        acc.z = fmaf(v.z, to_f32(w[4 * q + 2]), acc.z);
        acc.w = fmaf(v.w, to_f32(w[4 * q + 3]), acc.w);
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) w[u] = nw[u];
    }
    const float dot = (acc.x + acc.y) + (acc.z + acc.w);
    dh = live ? dh_total * zt + dot : dh_total;
    cur ^= 1;
  }
}

template <typename S>
int launch(const void* gates, const void* wt, const float* lo,
           const float* hi, const float* hprev, const float* g, void* dxs,
           void* dhn, int T, int B, int H, cudaStream_t stream) {
  const dim3 grid(B, 2);
  const size_t smem = 2 * 3 * H * sizeof(float);
  if (H <= 256)
    gru_bwd_kernel<S, kChunkSmallH, 256><<<grid, H, smem, stream>>>(
        static_cast<const S*>(gates), static_cast<const S*>(wt), lo, hi,
        hprev, g, static_cast<S*>(dxs), static_cast<S*>(dhn), T, B, H);
  else
    gru_bwd_kernel<S, kChunkLargeH, 512><<<grid, H, smem, stream>>>(
        static_cast<const S*>(gates), static_cast<const S*>(wt), lo, hi,
        hprev, g, static_cast<S*>(dxs), static_cast<S*>(dhn), T, B, H);
  CSR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// gates [T, 2B, 4H], wt [2, 3H, H], dxs [T, 2B, 3H] and dhn [T, 2B, H] all
// bf16 (bf16 != 0) or all fp32; lo/hi [2B], hprev and g [T, 2B, H] fp32.
// Requires 32 <= H <= 512, H % 32 == 0, T >= 1, B >= 1 (the wrapper checks).
CSR_API int csr_gru_bwd(const void* gates, const void* wt, const float* lo,
                        const float* hi, const float* hprev, const float* g,
                        void* dxs, void* dhn, int T, int B, int H, int bf16,
                        cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16>(gates, wt, lo, hi, hprev, g, dxs, dhn, T, B,
                                 H, stream);
  return launch<float>(gates, wt, lo, hi, hprev, g, dxs, dhn, T, B, H, stream);
}
