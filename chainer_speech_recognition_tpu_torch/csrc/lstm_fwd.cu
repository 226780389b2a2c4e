// LSTM recurrence (bidirectional or forward-only): inference, the training
// forward that also streams the cell states and the gate activations, and
// the streaming window.
//
// Replaces ops/rnn_pallas.py::_lstm_fwd_kernel in both its forms:
// residual-free (_fwd_impl(residuals=False), birnn_pallas's primal; entry
// csr_lstm_fwd) and with residuals (_fwd_impl(residuals=True), the custom
// VJP's forward; entry csr_lstm_fwd_train); and
// ops/rnn_pallas.py::_lstm_stream_kernel (birnn_pallas_stream; entry
// csr_lstm_fwd_stream). The training form also writes cs [T, R, H] fp32
// (the cell state c of every step) and gates [T, R, 4H] = (i, f, o, u) in
// the stream dtype, which the backward kernel (csrc/lstm_bwd.cu) reads
// instead of recomputing the gate matmul. The stream form seeds h and c
// from h0 [R, 2H] = h||c fp32 instead of 0 and writes carry [R, 2H], the
// h||c of step emit_t - 1 (h0 when emit_t == 0). The three forms are one
// template (kResiduals, kStream).
//
// Same boundary as the TPU kernel: xs [T, R=ndir*B, 4H] in the stream
// dtype (bf16 under bf16 compute, fp32 under fp32), lo/hi [R] fp32 -> ys
// [T, R, H] fp32. Rows [d*B, (d+1)*B) use direction d's W (ndir = 2 for a
// bidirectional layer, 1 for a forward-only one); row r is live at step t
// iff lo[r] <= t < hi[r], and its h and c are frozen otherwise. The gates
// are
//   g = xs[t] + h W,  i = s(g_i), f = s(g_f + 1), o = s(g_o), u = tanh(g_u)
//   c = f c + i u,    h = o tanh(c)
// with the product's operands rounded to the compute dtype and fp32
// accumulation (_dot2), and the carries and gate math in fp32 (the stream
// form's h0 seeds the fp32 registers, its compute-dtype rounding the shared
// copy of h that the first product reads).
//
// W arrives from the wrapper in the compute dtype as k-quads,
// wq [ndir][H/4][4H][4]: wq[d][k4][col][kk] = W[d][4 k4 + kk][col], so thread
// j fetches four reduction rows of its gate column with one load.
//
// What bounds it on Hopper: the sequential dependency over T. Each step is
// a [rows x H] x [H x 4H] product that needs all of the direction's W
// (384 x 1536 bf16 = 1.18 MB at bilstm_deep) and the step before's h. As
// in csrc/gru_fwd.cu, every block streams its direction's W from L2 once a
// step, so a step costs the dependent L2 round trips of the W loads unless
// they overlap, and at most the L2 bandwidth shared by all blocks' streams
// (64 blocks x 1.18 MB = 75 MB a step at B = 32).
//
// Design (csrc/gru_fwd.cu's, with four gates): a block owns one row of one
// direction and loops over all T inside the kernel; nothing crosses
// blocks. Thread j owns hidden unit j: it accumulates the i, f, o and u
// pre-activations of unit j (W reads coalesced across j, h broadcast from
// shared memory as float4) and keeps its fp32 h and c in registers. W is
// read in register chunks of kQ quads (4 kQ reduction rows) per gate, the
// next chunk's loads issued before the current chunk's FMAs; the k-quad
// layout halves (bf16) the loads and registers of gru_fwd.cu's one-row
// loads, so four gates fit in a chunk of 16 rows: 24 dependent round trips
// a step at H = 384. The next step's xs is loaded before the product, so its latency
// hides behind it. The compute-dtype copy of h that the next step reads is
// double-buffered in shared memory: one barrier a step. Bounds:
// 32 <= H <= 512, H % 32 == 0 (one thread per unit), any B, T >= 1.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "rnn_common.cuh"

namespace {

using namespace csr_rnn;

template <typename S, int kQ>
__device__ __forceinline__ void load_chunk(
    const typename Quad<S>::T* __restrict__ wd, int k4, int j, int H,
    typename Quad<S>::T (&w)[4][kQ]) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const typename Quad<S>::T* row = wd + static_cast<int64_t>(k4 + q) * 4 * H;
#pragma unroll
    for (int g = 0; g < 4; ++g) w[g][q] = row[g * H + j];
  }
}

template <typename S>
__device__ __forceinline__ void load_x(const S* __restrict__ xs, int64_t row,
                                       int H, int j, float (&x)[4]) {
  const S* xr = xs + row * 4 * H;
#pragma unroll
  for (int g = 0; g < 4; ++g) x[g] = to_f32(xr[g * H + j]);
}

template <typename S, int kQ, int kMaxThreads, bool kResiduals, bool kStream>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_fwd_kernel(const S* __restrict__ xs,
                    const typename Quad<S>::T* __restrict__ wq,
                    const float* __restrict__ lo, const float* __restrict__ hi,
                    const float* __restrict__ h0, float* __restrict__ ys,
                    float* __restrict__ cs, S* __restrict__ gates,
                    float* __restrict__ carry, int T, int B, int H,
                    int emit_t) {
  using Q = typename Quad<S>::T;
  extern __shared__ float hs[];  // [2][H] compute-dtype h
  const int d = blockIdx.y;      // direction
  const int rr = d * B + blockIdx.x;
  const int j = threadIdx.x;     // hidden unit
  const int R = gridDim.y * B;   // ndir * B
  const int nq = H / 4;          // quads per gate column
  const Q* wd = wq + static_cast<int64_t>(d) * nq * 4 * H;
  const float lo_r = lo[rr];
  const float hi_r = hi[rr];
  // this row's h||c in h0 and carry [R, 2H]
  const int64_t hc_off = static_cast<int64_t>(rr) * 2 * H;

  float h = 0.0f, c = 0.0f;
  if (kStream) {
    h = h0[hc_off + j];
    c = h0[hc_off + H + j];
    if (emit_t == 0) {
      carry[hc_off + j] = h;
      carry[hc_off + H + j] = c;
    }
  }
  float x[4];
  load_x(xs, rr, H, j, x);
  hs[j] = round_to<S>(h);
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float nx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (t + 1 < T) load_x(xs, static_cast<int64_t>(t + 1) * R + rr, H, j, nx);
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float4* h4 = reinterpret_cast<const float4*>(hs + cur * H);
    Q w[4][kQ];
    load_chunk<S, kQ>(wd, 0, j, H, w);
    for (int k4 = 0; k4 < nq; k4 += kQ) {
      Q nw[4][kQ];
      if (k4 + kQ < nq) load_chunk<S, kQ>(wd, k4 + kQ, j, H, nw);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 hv = h4[k4 + q];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 wv = Quad<S>::unpack(w[g][q]);
          a[g] = fmaf(hv.x, wv.x, a[g]);
          a[g] = fmaf(hv.y, wv.y, a[g]);
          a[g] = fmaf(hv.z, wv.z, a[g]);
          a[g] = fmaf(hv.w, wv.w, a[g]);
        }
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q)
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g][q] = nw[g][q];
    }
    const float ig = sigmoidf(x[0] + a[0]);
    const float fg = sigmoidf((x[1] + a[1]) + 1.0f);  // forget bias +1
    const float og = sigmoidf(x[2] + a[2]);
    const float ug = tanhf(x[3] + a[3]);
    const float cn = fg * c + ig * ug;
    const float hn = og * tanhf(cn);
    const float tf = static_cast<float>(t);
    if (lo_r <= tf && tf < hi_r) {
      h = hn;
      c = cn;
    }
    const int64_t row = static_cast<int64_t>(t) * R + rr;
    ys[row * H + j] = h;
    if (kResiduals) {
      cs[row * H + j] = c;
      S* gt = gates + row * 4 * H;
      gt[j] = from_f32<S>(ig);
      gt[H + j] = from_f32<S>(fg);
      gt[2 * H + j] = from_f32<S>(og);
      gt[3 * H + j] = from_f32<S>(ug);
    }
    if (kStream && t == emit_t - 1) {
      carry[hc_off + j] = h;
      carry[hc_off + H + j] = c;
    }
    hs[(cur ^ 1) * H + j] = round_to<S>(h);
    __syncthreads();
    cur ^= 1;
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = nx[g];
  }
}

// W rows per register chunk and gate: 16 in bf16 (4 quads of 8 bytes),
// 8 in fp32 (2 quads of 16 bytes), the same 32 registers per chunk
template <typename S>
constexpr int kQuads = sizeof(S) == 2 ? 4 : 2;

template <typename S, bool kResiduals, bool kStream>
int launch(const void* xs, const void* wq, const float* lo, const float* hi,
           const float* h0, float* ys, float* cs, void* gates, float* carry,
           int T, int B, int H, int ndir, int emit_t, cudaStream_t stream) {
  using Q = typename Quad<S>::T;
  const dim3 grid(B, ndir);
  const size_t smem = 2 * H * sizeof(float);
  if (H <= 384)
    lstm_fwd_kernel<S, kQuads<S>, 384, kResiduals, kStream>
        <<<grid, H, smem, stream>>>(
            static_cast<const S*>(xs), static_cast<const Q*>(wq), lo, hi, h0,
            ys, cs, static_cast<S*>(gates), carry, T, B, H, emit_t);
  else
    lstm_fwd_kernel<S, kQuads<S>, 512, kResiduals, kStream>
        <<<grid, H, smem, stream>>>(
            static_cast<const S*>(xs), static_cast<const Q*>(wq), lo, hi, h0,
            ys, cs, static_cast<S*>(gates), carry, T, B, H, emit_t);
  CSR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// xs [T, ndir*B, 4H] and wq [ndir, H/4, 4H, 4] both bf16 (bf16 != 0) or
// both fp32; lo/hi [ndir*B] fp32; ys [T, ndir*B, H] fp32. Requires
// 32 <= H <= 512, H % 32 == 0, T >= 1, B >= 1, ndir 1 or 2 (the wrapper
// checks).
CSR_API int csr_lstm_fwd(const void* xs, const void* wq, const float* lo,
                         const float* hi, float* ys, int T, int B, int H,
                         int ndir, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16, false, false>(
        xs, wq, lo, hi, nullptr, ys, nullptr, nullptr, nullptr, T, B, H, ndir,
        0, stream);
  return launch<float, false, false>(xs, wq, lo, hi, nullptr, ys, nullptr,
                                     nullptr, nullptr, T, B, H, ndir, 0,
                                     stream);
}

// As csr_lstm_fwd with ndir = 2, plus cs [T, 2B, H] fp32 and gates
// [T, 2B, 4H] in the stream dtype (the dtype of xs) out: c and (i, f, o, u)
// of every step, live or not.
CSR_API int csr_lstm_fwd_train(const void* xs, const void* wq,
                               const float* lo, const float* hi, float* ys,
                               float* cs, void* gates, int T, int B, int H,
                               int bf16, cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16, true, false>(
        xs, wq, lo, hi, nullptr, ys, cs, gates, nullptr, T, B, H, 2, 0,
        stream);
  return launch<float, true, false>(xs, wq, lo, hi, nullptr, ys, cs, gates,
                                    nullptr, T, B, H, 2, 0, stream);
}

// As csr_lstm_fwd, with h||c seeded from h0 [ndir*B, 2H] fp32 and carry
// [ndir*B, 2H] fp32 out: h||c after step emit_t - 1, h0 when emit_t == 0.
// Requires 0 <= emit_t <= T (the wrapper checks).
CSR_API int csr_lstm_fwd_stream(const void* xs, const void* wq,
                                const float* lo, const float* hi,
                                const float* h0, float* ys, float* carry,
                                int T, int B, int H, int ndir, int emit_t,
                                int bf16, cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16, false, true>(
        xs, wq, lo, hi, h0, ys, nullptr, nullptr, carry, T, B, H, ndir,
        emit_t, stream);
  return launch<float, false, true>(xs, wq, lo, hi, h0, ys, nullptr, nullptr,
                                    carry, T, B, H, ndir, emit_t, stream);
}
