// Bidirectional LSTM recurrence, backward (reverse-time gradient walk).
//
// Replaces ops/rnn_pallas.py::_lstm_bwd_kernel (the custom VJP's backward,
// _birnn_bwd's LSTM branch). Same boundary but one stream: gates [T, R=2B,
// 4H] = (i, f, o, u) from the training forward (csrc/lstm_fwd.cu, stream
// dtype), the recurrent weights transposed per direction as k-quads
// (below), lo/hi [R] fp32, cs [T, R, H] fp32 (the cell states) and g
// [T, R, H] fp32 (the gradient of the layer's ys). The reference also takes
// c_prev, the cell states shifted by one step with zeros first; here a
// step reads cs one step back (0 at t = 0) instead. Out: dxs [T, R, 4H] in
// the stream dtype = the gate pre-activation gradients dg = (di, df, do,
// du), masked to the live steps; they are the gradient of xs and of the
// recurrent pre-activations, so dW = sum_t h_prev^T dxs is one matmul after
// the kernel, off the sequential path, as the TPU kernel leaves it to XLA.
//
// Per step and row, with dh and dc the carried gradients (fp32):
//   dh_total = g[t] + dh,         tc = tanh(c_t)
//   do = dh_total tc o (1 - o)
//   dc_t = dc + dh_total o (1 - tc^2)
//   df = dc_t c_{t-1} f (1 - f),  di = dc_t u i (1 - i)
//   du = dc_t i (1 - u^2)
//   dh_prev = dg W^T              (dg rounded to the compute dtype first,
//                                  fp32 accumulation: _dot2(transpose))
//   live: dh = dh_prev, dc = dc_t f;  otherwise both pass through
//
// What bounds it on Hopper: as the forward, the dependency over T. Each
// step is a [rows x 4H] x [4H x H] product that needs all of the
// direction's W (1.18 MB in bf16 at bilstm_deep) and the step before's dh.
//
// Design: the forward's, turned around (csrc/gru_bwd.cu's with four
// gates). One block owns one row of one direction and walks T backwards;
// thread j owns hidden unit j and keeps its dh and dc in registers. It
// writes its unit's four dg values, rounded to the compute dtype, to shared
// memory (double-buffered: one barrier a step), then reduces the row's 4H
// values against column j of W^T, i.e. row j of W. The wrapper passes W as
// k-quads of W^T, wtq [2][H][H][4]: wtq[d][k4][j][kk] = W[d][j][4 k4 + kk],
// so a thread fetches four reduction rows with one load and a warp's loads
// are contiguous. W is streamed from L2 in register chunks of kQ quads
// (4 kQ rows) whose next loads are issued before the current FMAs; the
// product keeps four partial sums (the lanes of a float4). The chunk sets
// the number of dependent L2 round trips a step (4H / (4 kQ)) against the
// registers it takes: 64 rows in bf16 (24 round trips a step at H = 384;
// on an H100 at B = 24, T' = 256 as fast as 96 rows and faster than 24,
// 32, 48 and 128, PERF.md), which also fits the 512-thread block, and 32
// in fp32, whose rows take twice the registers. The next step's gates, c,
// c_{t-1} and g are loaded before the product, so their latency hides
// behind it.
// Bounds: 32 <= H <= 512, H % 32 == 0, any B, T >= 1.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "rnn_common.cuh"

namespace {

using namespace csr_rnn;

// the per-step inputs of one (row, unit); cp is c_{t-1}
struct StepIn {
  float i, f, o, u, cp, c, g;
};

template <typename S>
__device__ __forceinline__ StepIn load_step(const S* __restrict__ gates,
                                            const float* __restrict__ cs,
                                            const float* __restrict__ g,
                                            int64_t row, int R, int t, int H,
                                            int j) {
  const S* gt = gates + row * 4 * H;
  StepIn in;
  in.i = to_f32(gt[j]);
  in.f = to_f32(gt[H + j]);
  in.o = to_f32(gt[2 * H + j]);
  in.u = to_f32(gt[3 * H + j]);
  in.cp = t > 0 ? cs[(row - R) * H + j] : 0.0f;
  in.c = cs[row * H + j];
  in.g = g[row * H + j];
  return in;
}

template <typename S, int kQ, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_bwd_kernel(const S* __restrict__ gates,
                    const typename Quad<S>::T* __restrict__ wtq,
                    const float* __restrict__ lo, const float* __restrict__ hi,
                    const float* __restrict__ cs, const float* __restrict__ g,
                    S* __restrict__ dxs, int T, int B, int H) {
  using Q = typename Quad<S>::T;
  extern __shared__ float dgs[];  // [2][4H] compute-dtype (di, df, do, du)
  const int d = blockIdx.y;       // direction
  const int rr = d * B + blockIdx.x;
  const int j = threadIdx.x;      // hidden unit
  const int R = 2 * B;
  const int G = 4 * H;
  const Q* wd = wtq + static_cast<int64_t>(d) * H * H;  // [H quads][H]
  const float lo_r = lo[rr];
  const float hi_r = hi[rr];

  float dh = 0.0f, dc = 0.0f;
  int cur = 0;
  StepIn in = load_step(gates, cs, g, static_cast<int64_t>(T - 1) * R + rr,
                        R, T - 1, H, j);
  for (int t = T - 1; t >= 0; --t) {
    const int64_t row = static_cast<int64_t>(t) * R + rr;
    const float dh_total = in.g + dh;
    const float tc = tanhf(in.c);
    const float dog = dh_total * tc * in.o * (1.0f - in.o);
    const float dct = dc + dh_total * in.o * (1.0f - tc * tc);
    const float dfg = dct * in.cp * in.f * (1.0f - in.f);
    const float dig = dct * in.u * in.i * (1.0f - in.i);
    const float dug = dct * in.i * (1.0f - in.u * in.u);
    const float ft = in.f;
    const float tf = static_cast<float>(t);
    const bool live = lo_r <= tf && tf < hi_r;
    S* dx = dxs + row * G;
    dx[j] = from_f32<S>(live ? dig : 0.0f);
    dx[H + j] = from_f32<S>(live ? dfg : 0.0f);
    dx[2 * H + j] = from_f32<S>(live ? dog : 0.0f);
    dx[3 * H + j] = from_f32<S>(live ? dug : 0.0f);
    float* buf = dgs + cur * G;
    buf[j] = round_to<S>(dig);
    buf[H + j] = round_to<S>(dfg);
    buf[2 * H + j] = round_to<S>(dog);
    buf[3 * H + j] = round_to<S>(dug);
    __syncthreads();
    if (t > 0) in = load_step(gates, cs, g, row - R, R, t - 1, H, j);

    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // 4 partial sums
    const float4* v4 = reinterpret_cast<const float4*>(buf);
    Q w[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) w[q] = wd[static_cast<int64_t>(q) * H + j];
    for (int k4 = 0; k4 < H; k4 += kQ) {
      Q nw[kQ];
      if (k4 + kQ < H) {
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          nw[q] = wd[static_cast<int64_t>(k4 + kQ + q) * H + j];
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 v = v4[k4 + q];
        const float4 wv = Quad<S>::unpack(w[q]);
        acc.x = fmaf(v.x, wv.x, acc.x);
        acc.y = fmaf(v.y, wv.y, acc.y);
        acc.z = fmaf(v.z, wv.z, acc.z);
        acc.w = fmaf(v.w, wv.w, acc.w);
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) w[q] = nw[q];
    }
    const float dot = (acc.x + acc.y) + (acc.z + acc.w);
    if (live) {
      dh = dot;
      dc = dct * ft;
    } else {
      dh = dh_total;
    }
    cur ^= 1;
  }
}

// W^T quads per register chunk: 16 (64 rows) in bf16, 8 (32 rows) in fp32;
// both divide the H quads of any H % 32 == 0
template <typename S>
constexpr int kChunkQuads = sizeof(S) == 2 ? 16 : 8;

template <typename S>
int launch(const void* gates, const void* wtq, const float* lo,
           const float* hi, const float* cs, const float* g, void* dxs, int T,
           int B, int H, cudaStream_t stream) {
  using Q = typename Quad<S>::T;
  const dim3 grid(B, 2);
  const size_t smem = 2 * 4 * H * sizeof(float);
  if (H <= 384)
    lstm_bwd_kernel<S, kChunkQuads<S>, 384><<<grid, H, smem, stream>>>(
        static_cast<const S*>(gates), static_cast<const Q*>(wtq), lo, hi, cs,
        g, static_cast<S*>(dxs), T, B, H);
  else
    lstm_bwd_kernel<S, kChunkQuads<S>, 512><<<grid, H, smem, stream>>>(
        static_cast<const S*>(gates), static_cast<const Q*>(wtq), lo, hi, cs,
        g, static_cast<S*>(dxs), T, B, H);
  CSR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// gates [T, 2B, 4H], wtq [2, H, H, 4] and dxs [T, 2B, 4H] all bf16
// (bf16 != 0) or all fp32; lo/hi [2B], cs and g [T, 2B, H] fp32.
// Requires 32 <= H <= 512, H % 32 == 0, T >= 1, B >= 1 (the wrapper
// checks).
CSR_API int csr_lstm_bwd(const void* gates, const void* wtq, const float* lo,
                         const float* hi, const float* cs, const float* g,
                         void* dxs, int T, int B, int H, int bf16,
                         cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16>(gates, wtq, lo, hi, cs, g, dxs, T, B, H,
                                 stream);
  return launch<float>(gates, wtq, lo, hi, cs, g, dxs, T, B, H, stream);
}
