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
// h||c of step emit_t - 1 (h0 when emit_t == 0).
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
// Three kernels. The bf16 forms, all three (the presets' path), run on a
// thread-block cluster with the step product on the tensor cores: up to
// H = 512 with W resident in the cluster's shared memory
// (lstm_fwd_tc_kernel, below; one template over kResiduals and kStream),
// above with W streamed from global memory at each step
// (lstm_fwd_wide_kernel, further below). The fp32 forms run the FMA kernel
// (lstm_fwd_kernel, one template over kResiduals and kStream).
//
// What bounds it on Hopper: the sequential dependency over T. Each step is
// a [rows x H] x [H x 4H] product that needs all of the direction's W
// (384 x 1536 bf16 = 1.18 MB at bilstm_deep) and the step before's h; the
// bytes the function must move (xs, ys, the residuals) take ~0.03 ms at
// the training shape, the T dependent steps far longer.
//
// The FMA kernel (csrc/gru_fwd.cu's design, with four gates): a block owns
// one row of one direction and loops over all T inside the kernel; nothing
// crosses blocks. Thread j owns hidden unit j: it accumulates the i, f, o
// and u pre-activations of unit j (W reads coalesced across j, h broadcast
// from shared memory as float4) and keeps its fp32 h and c in registers.
// W arrives as k-quads, wq [ndir][H/4][4H][4]: wq[d][k4][col][kk] =
// W[d][4 k4 + kk][col], so thread j fetches four reduction rows of its gate
// column with one load; every block streams its direction's W from L2 once
// a step, in register chunks of kQ quads (4 kQ reduction rows) per gate,
// the next chunk's loads issued before the current chunk's FMAs: 24
// dependent round trips a step at H = 384. The next step's xs is loaded
// before the product, so its latency hides behind it. The compute-dtype
// copy of h that the next step reads is double-buffered in shared memory:
// one barrier a step. Past H = 512 a thread owns kUPT = 2 (H <= 1024) or
// 4 units, j and j + H / kUPT ..., one after the other, in blocks of
// H / kUPT <= 512 threads. Bounds: 32 <= H <= 2048, H % 32 == 0, any B,
// T >= 1.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "rnn_common.cuh"
#include "rnn_mma.cuh"

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

template <typename S, int kQ, int kMaxThreads, int kUPT, bool kResiduals,
          bool kStream>
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
  const int R = gridDim.y * B;   // ndir * B
  const int nq = H / 4;          // quads per gate column
  const Q* wd = wq + static_cast<int64_t>(d) * nq * 4 * H;
  const float lo_r = lo[rr];
  const float hi_r = hi[rr];
  // this row's h||c in h0 and carry [R, 2H]
  const int64_t hc_off = static_cast<int64_t>(rr) * 2 * H;

  // thread's hidden units: j = threadIdx.x + q blockDim.x, q < kUPT
  // (blockDim.x = H / kUPT)
  float h[kUPT], c[kUPT], x[kUPT][4];
#pragma unroll
  for (int q = 0; q < kUPT; ++q) {
    const int j = threadIdx.x + q * blockDim.x;
    h[q] = 0.0f;
    c[q] = 0.0f;
    if (kStream) {
      h[q] = h0[hc_off + j];
      c[q] = h0[hc_off + H + j];
      if (emit_t == 0) {
        carry[hc_off + j] = h[q];
        carry[hc_off + H + j] = c[q];
      }
    }
    load_x(xs, rr, H, j, x[q]);
    hs[j] = round_to<S>(h[q]);
  }
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float nx[kUPT][4] = {};
    if (t + 1 < T)
#pragma unroll
      for (int q = 0; q < kUPT; ++q)
        load_x(xs, static_cast<int64_t>(t + 1) * R + rr, H,
               threadIdx.x + q * blockDim.x, nx[q]);
    const float4* h4 = reinterpret_cast<const float4*>(hs + cur * H);
#pragma unroll
    for (int q = 0; q < kUPT; ++q) {
      const int j = threadIdx.x + q * blockDim.x;
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      Q w[4][kQ];
      load_chunk<S, kQ>(wd, 0, j, H, w);
      for (int k4 = 0; k4 < nq; k4 += kQ) {
        Q nw[4][kQ];
        if (k4 + kQ < nq) load_chunk<S, kQ>(wd, k4 + kQ, j, H, nw);
#pragma unroll
        for (int qq = 0; qq < kQ; ++qq) {
          const float4 hv = h4[k4 + qq];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float4 wv = Quad<S>::unpack(w[g][qq]);
            a[g] = fmaf(hv.x, wv.x, a[g]);
            a[g] = fmaf(hv.y, wv.y, a[g]);
            a[g] = fmaf(hv.z, wv.z, a[g]);
            a[g] = fmaf(hv.w, wv.w, a[g]);
          }
        }
#pragma unroll
        for (int qq = 0; qq < kQ; ++qq)
#pragma unroll
          for (int g = 0; g < 4; ++g) w[g][qq] = nw[g][qq];
      }
      const float ig = sigmoidf(x[q][0] + a[0]);
      const float fg = sigmoidf((x[q][1] + a[1]) + 1.0f);  // forget bias +1
      const float og = sigmoidf(x[q][2] + a[2]);
      const float ug = tanhf(x[q][3] + a[3]);
      const float cn = fg * c[q] + ig * ug;
      const float hn = og * tanhf(cn);
      const float tf = static_cast<float>(t);
      if (lo_r <= tf && tf < hi_r) {
        h[q] = hn;
        c[q] = cn;
      }
      const int64_t row = static_cast<int64_t>(t) * R + rr;
      ys[row * H + j] = h[q];
      if (kResiduals) {
        cs[row * H + j] = c[q];
        S* gt = gates + row * 4 * H;
        gt[j] = from_f32<S>(ig);
        gt[H + j] = from_f32<S>(fg);
        gt[2 * H + j] = from_f32<S>(og);
        gt[3 * H + j] = from_f32<S>(ug);
      }
      if (kStream && t == emit_t - 1) {
        carry[hc_off + j] = h[q];
        carry[hc_off + H + j] = c[q];
      }
      hs[(cur ^ 1) * H + j] = round_to<S>(h[q]);
    }
    __syncthreads();
    cur ^= 1;
#pragma unroll
    for (int q = 0; q < kUPT; ++q)
#pragma unroll
      for (int g = 0; g < 4; ++g) x[q][g] = nx[q][g];
  }
}

// W rows per register chunk and gate: 8 (2 fp32 quads of 16 bytes, 32
// registers a chunk)
constexpr int kQuads = 2;

template <typename S, int kMaxThreads, int kUPT, bool kResiduals,
          bool kStream>
void launch_upt(const void* xs, const void* wq, const float* lo,
                const float* hi, const float* h0, float* ys, float* cs,
                void* gates, float* carry, int T, int B, int H, int ndir,
                int emit_t, cudaStream_t stream) {
  using Q = typename Quad<S>::T;
  // one quad a chunk past one unit a thread: its registers go to the
  // units' carries and prefetched inputs
  lstm_fwd_kernel<S, kUPT == 1 ? kQuads : 1, kMaxThreads, kUPT, kResiduals,
                  kStream>
      <<<dim3(B, ndir), H / kUPT, 2 * H * sizeof(float), stream>>>(
          static_cast<const S*>(xs), static_cast<const Q*>(wq), lo, hi, h0,
          ys, cs, static_cast<S*>(gates), carry, T, B, H, emit_t);
}

// one unit a thread up to H = 512, two up to 1024, four above
template <typename S, bool kResiduals, bool kStream>
int launch(const void* xs, const void* wq, const float* lo, const float* hi,
           const float* h0, float* ys, float* cs, void* gates, float* carry,
           int T, int B, int H, int ndir, int emit_t, cudaStream_t stream) {
  if (H <= 384)
    launch_upt<S, 384, 1, kResiduals, kStream>(xs, wq, lo, hi, h0, ys, cs,
                                               gates, carry, T, B, H, ndir,
                                               emit_t, stream);
  else if (H <= 512)
    launch_upt<S, 512, 1, kResiduals, kStream>(xs, wq, lo, hi, h0, ys, cs,
                                               gates, carry, T, B, H, ndir,
                                               emit_t, stream);
  else if (H <= 1024)
    launch_upt<S, 512, 2, kResiduals, kStream>(xs, wq, lo, hi, h0, ys, cs,
                                               gates, carry, T, B, H, ndir,
                                               emit_t, stream);
  else
    launch_upt<S, 512, 4, kResiduals, kStream>(xs, wq, lo, hi, h0, ys, cs,
                                               gates, carry, T, B, H, ndir,
                                               emit_t, stream);
  CSR_RETURN_LAUNCH_STATUS();
}

// ---------------------------------------------------------------------------
// The bf16 forward on a thread-block cluster (csr_lstm_fwd,
// csr_lstm_fwd_train and csr_lstm_fwd_stream under bf16 compute; layout in
// rnn_mma.cuh).
//
// Grid: C·groups x ndir blocks, C = H / 32, in clusters of C along x;
// cluster (group, d) serves rows [16 group, 16 group + 16) of direction d,
// block c of it the units [32 c, 32 c + 32) with all four gates of each,
// so the gate math and the c update stay in the block. Its W slice, wt[d]
// [c] = [4][32][H] bf16 (element [g][u][k] = W[d][k][g H + 32 c + u], laid
// out by the wrapper), is copied into shared memory once and read there for
// all T steps: the n rows (gate columns) of the product's B operand,
// k-major, so ldmatrix reads them without a transpose. A step:
//   1. the product: the group's 16 rows of h (bf16, where _dot2 rounds
//      it) times the W slice, split over 16 warps: warp w takes unit block
//      w % 4 (units 8 (w % 4) .. + 7, four m16n8 accumulators, one a gate)
//      and quarter w / 4 of the H / 16 k-steps of mma.sync m16n8k16 (bf16
//      operands, fp32 accumulators, the next k-step's fragments loaded
//      before the current one's products); the four quarters' partial sums
//      meet in shared memory;
//   2. thread p owns the pair (row p / 32, unit p % 32): it adds the
//      quarters in a fixed order (no atomics: bitwise repeatable), adds xs
//      (prefetched a step ahead), and runs the gate math on fp32 h and c,
//      which stay in its registers for all T steps;
//   3. the new h, rounded to bf16, goes into this block's columns of the
//      next A buffer, and from there into every other block's through
//      DSMEM; one cluster barrier a step (release / acquire) makes it
//      visible, the step's global stores made between its arrive and its
//      wait.
// Double buffering makes one barrier enough: a block writes buffer t % 2
// only after every block has passed the barrier that follows its reads of
// that buffer at step t - 2. The stream form (kStream) seeds each thread's
// fp32 h and c from h0's h||c and A[0] from bf16(h), every block filling
// all H columns of its 16 rows from global memory (rnn_mma.cuh's
// fill_h0), so step 0 needs no exchange; it writes carry = h||c after step
// emit_t - 1's padding freeze, or h0 at entry when emit_t == 0. The three
// forms share the product and the gate math, so their ys are equal (the
// stream form's at h0 = 0).
//
// What bounds a step: each block reads its W slice (H x 128 bf16, 98 KB at
// H = 384) from shared memory once a step, runs the gate math of its 512
// pairs and exchanges h; C = H / 32 spreads all three over the most blocks
// that keep 32 units (n8 tiles of whole unit blocks) each.
template <bool kResiduals, bool kStream>
__global__ void __launch_bounds__(csr_rnn_mma::kRows * csr_rnn_mma::kUnits, 1)
    lstm_fwd_tc_kernel(const __nv_bfloat16* __restrict__ xs,
                       const __nv_bfloat16* __restrict__ wt,
                       const float* __restrict__ lo,
                       const float* __restrict__ hi,
                       const float* __restrict__ h0, float* __restrict__ ys,
                       float* __restrict__ cs,
                       __nv_bfloat16* __restrict__ gates,
                       float* __restrict__ carry, int T, int B, int H,
                       int emit_t) {
  namespace tc = csr_rnn_mma;
  constexpr int kU = tc::kUnits, kM = tc::kRows, kN = 4 * kU;
  constexpr int kLd = tc::kPartLd;   // row stride of the partial sums
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(tc::cluster_nctarank());
  const int c = static_cast<int>(tc::cluster_ctarank());
  const int d = blockIdx.y, group = blockIdx.x / C;
  const int R = gridDim.y * B;
  const int row_b = tc::row_bytes(H);
  const uint32_t s_w = tc::smem_addr(smem);
  const uint32_t s_a = s_w + kN * row_b;         // A[2][kM]
  const uint32_t a_bytes = kM * row_b;
  // partial sums [4 quarters][4 gates][kM][kLd] fp32
  float* part = reinterpret_cast<float*>(smem + kN * row_b + 2 * a_bytes);
  const int tid = threadIdx.x, l = tid & 31, w = tid >> 5;

  // the W slice, once; A[0] = h_0: 0, or the stream form's bf16(h0), the
  // h half of h0's rows h||c
  const __nv_bfloat16* wsrc = wt + (static_cast<int64_t>(d) * C + c) * kN * H;
  const int kc = H / 8;
  for (int i = tid; i < kN * kc; i += blockDim.x)
    tc::cp_async16(s_w + (i / kc) * row_b + (i % kc) * 16,
                   wsrc + static_cast<int64_t>(i / kc) * H + (i % kc) * 8,
                   true);
  tc::cp_async_commit();
  if (kStream)
    tc::fill_h0(smem + (s_a - s_w), h0 + (static_cast<int64_t>(d) * B +
                                          group * kM) * 2 * H,
                2 * H, B - group * kM, H);
  else
    for (uint32_t i = tid * 16; i < a_bytes; i += blockDim.x * 16)
      *reinterpret_cast<uint4*>(smem + (s_a - s_w) + i) =
          make_uint4(0, 0, 0, 0);
  tc::cp_async_wait<0>();
  __syncthreads();
  tc::cluster_sync();   // every peer has started before DSMEM stores

  // this thread's pair
  const int r = tid / kU, u = tid % kU, j = c * kU + u;
  const int b = group * kM + r;
  const bool valid = b < B;
  const int rr = d * B + b;
  const float lo_r = valid ? lo[rr] : 0.0f;
  const float hi_r = valid ? hi[rr] : 0.0f;   // never live
  // this warp's product: unit block ub, k-steps [k0, k1) of H / 16;
  // fragment addresses: A row l % 16 at k chunk l / 16; B rows (gates g,
  // g + 1 of unit 8 ub + l % 8) at k chunk l / 8 % 2
  const int ub = w & 3, K = H / 16;
  const int k0 = K * (w >> 2) / 4, k1 = K * ((w >> 2) + 1) / 4;
  const uint32_t a_off = (l & 15) * row_b + (l >> 4) * 16 + k0 * 32;
  uint32_t b_base[2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
    b_base[p] = s_w + (2 * p * kU + 8 * ub + (l & 7) + (l >> 4) * kU) * row_b +
                ((l >> 3) & 1) * 16 + k0 * 32;
  // where this lane's accumulator elements go: gate g, row l / 4 (+ 8),
  // units 8 ub + 2 (l % 4) (+ 1) of quarter w / 4
  float* part_w = part + (w >> 2) * 4 * kM * kLd + (l >> 2) * kLd + 8 * ub +
                  2 * (l & 3);

  auto load_x = [&](int t, float (&v)[4]) {
    const __nv_bfloat16* xr =
        xs + (static_cast<int64_t>(t) * R + rr) * 4 * H + j;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      v[g] = valid ? __bfloat162float(xr[g * H]) : 0.0f;
  };
  float x[4];
  load_x(0, x);
  float h = 0.0f, cv = 0.0f;
  const int64_t hc = static_cast<int64_t>(rr) * 2 * H + j;  // [R, 2H] h||c
  if (kStream && valid) {
    h = h0[hc];
    cv = h0[hc + H];
    if (emit_t == 0) {
      carry[hc] = h;
      carry[hc + H] = cv;
    }
  }
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float nx[4];
    if (t + 1 < T) load_x(t + 1, nx);
    const uint32_t a_base = s_a + cur * a_bytes + a_off;
    float acc[4][4] = {};
    if (k0 < k1) {
      uint32_t a[4], b0[4], b1[4];   // gates (0, 1) and (2, 3)
      tc::ldsm_x4(a_base, a);
      tc::ldsm_x4(b_base[0], b0);
      tc::ldsm_x4(b_base[1], b1);
      for (int kk = 0; kk < k1 - k0; ++kk) {
        // the next k-step, clamped
        const int kn = kk + 1 < k1 - k0 ? kk + 1 : kk;
        uint32_t na[4], nb0[4], nb1[4];
        tc::ldsm_x4(a_base + kn * 32, na);
        tc::ldsm_x4(b_base[0] + kn * 32, nb0);
        tc::ldsm_x4(b_base[1] + kn * 32, nb1);
        tc::mma(acc[0], a, b0[0], b0[1]);
        tc::mma(acc[1], a, b0[2], b0[3]);
        tc::mma(acc[2], a, b1[0], b1[1]);
        tc::mma(acc[3], a, b1[2], b1[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = na[q];
          b0[q] = nb0[q];
          b1[q] = nb1[q];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(part_w + (g * kM + 8 * i) * kLd) =
            make_float2(acc[g][2 * i], acc[g][2 * i + 1]);
    __syncthreads();
    float pre[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float* p = part + (g * kM + r) * kLd + u;
      pre[g] = ((p[0] + p[4 * kM * kLd]) + p[8 * kM * kLd]) +
               p[12 * kM * kLd];
    }
    const float ig = sigmoidf(x[0] + pre[0]);
    const float fg = sigmoidf((x[1] + pre[1]) + 1.0f);  // forget bias +1
    const float og = sigmoidf(x[2] + pre[2]);
    const float ug = tanhf(x[3] + pre[3]);
    const float cn = fg * cv + ig * ug;
    const float hn = og * tanhf(cn);
    const float tf = static_cast<float>(t);
    if (lo_r <= tf && tf < hi_r) {
      h = hn;
      cv = cn;
    }
    const int nxt = cur ^ 1;
    const bool more = t + 1 < T;
    if (more) {
      // h into this block's columns of A[nxt], then its 16 rows x 64 bytes
      // into every other block's
      const uint32_t s_nxt = s_a + nxt * a_bytes;
      reinterpret_cast<__nv_bfloat16*>(smem + (s_nxt - s_w) + r * row_b)[j] =
          __float2bfloat16_rn(h);
      __syncthreads();
      for (int q = tid; q < (C - 1) * kM * 4; q += blockDim.x) {
        const int p = q / (kM * 4), e = q % (kM * 4);
        const uint32_t ad = s_nxt + (e >> 2) * row_b + c * kU * 2 + (e & 3) * 16;
        tc::st_cluster16(tc::map_rank(ad, p + (p >= c)), tc::ld_shared16(ad));
      }
      tc::cluster_arrive();
    }
    if (valid) {
      const int64_t row = static_cast<int64_t>(t) * R + rr;
      ys[row * H + j] = h;
      if (kResiduals) {
        cs[row * H + j] = cv;
        __nv_bfloat16* gt = gates + row * 4 * H + j;
        gt[0] = __float2bfloat16_rn(ig);
        gt[H] = __float2bfloat16_rn(fg);
        gt[2 * H] = __float2bfloat16_rn(og);
        gt[3 * H] = __float2bfloat16_rn(ug);
      }
      if (kStream && t == emit_t - 1) {
        carry[hc] = h;
        carry[hc + H] = cv;
      }
    }
    if (more) {
      tc::cluster_wait();
#pragma unroll
      for (int g = 0; g < 4; ++g) x[g] = nx[g];
    }
    cur = nxt;
  }
}

template <bool kResiduals, bool kStream>
int launch_tc(const void* xs, const void* wt, const float* lo,
              const float* hi, const float* h0, float* ys, float* cs,
              void* gates, float* carry, int T, int B, int H, int ndir,
              int emit_t, int C, cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  if (C * tc::kUnits != H) return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_clusters(
      lstm_fwd_tc_kernel<kResiduals, kStream>, C,
      (B + tc::kRows - 1) / tc::kRows, ndir, tc::kRows * tc::kUnits,
      tc::fwd_smem(H), stream, static_cast<const __nv_bfloat16*>(xs),
      static_cast<const __nv_bfloat16*>(wt), lo, hi, h0, ys, cs,
      static_cast<__nv_bfloat16*>(gates), carry, T, B, H, emit_t);
}

// ---------------------------------------------------------------------------
// The bf16 forward past H = 512, W streamed (rnn_mma.cuh's streamed-W form;
// the same three entries under bf16 compute).
//
// Grid and clusters as lstm_fwd_tc_kernel's, with C = wide_cluster(H)
// blocks of U = wide_units(H) units and 4 U threads: warp w of block c owns
// the 8 units of unit block ub = U c / 8 + w (none past H) with all four
// gates, over the whole reduction, so no partial sums cross warps. Its
// B fragments come from wf[d][ub] = [H / 16 k-steps][4 gates][32 lanes]
// uint2 (ops/rnn_cuda.py's wide_fwd_weights), read from global memory at
// every step, kP k-steps ahead of the mma.sync products; A (the group's
// 16 rows of bf16 h) is double-buffered in shared memory as in the
// resident form. Each lane keeps the pairs its accumulators hold: rows
// l / 4 and l / 4 + 8, units 8 ub + 2 (l % 4) + {0, 1} (fp32 h and c in
// registers), runs their gate math straight from the accumulators, writes
// their bf16 h into the next A buffer, and the block pushes its columns to
// every peer over DSMEM (push_columns); one cluster barrier a step, the
// step's global stores between its arrive and its wait. The stream form
// fills A[0] with bf16(h0) (fill_h0) and seeds the lanes' h and c from
// h0, as the resident form does.
template <bool kResiduals, bool kStream, int kP>
__global__ void __launch_bounds__(csr_rnn_mma::wide_max_threads(kP), 1)
    lstm_fwd_wide_kernel(const __nv_bfloat16* __restrict__ xs,
                         const uint2* __restrict__ wf,
                         const float* __restrict__ lo,
                         const float* __restrict__ hi,
                         const float* __restrict__ h0, float* __restrict__ ys,
                         float* __restrict__ cs,
                         __nv_bfloat16* __restrict__ gates,
                         float* __restrict__ carry, int T, int B, int H,
                         int emit_t) {
  namespace tc = csr_rnn_mma;
  constexpr int kM = tc::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(tc::cluster_nctarank());
  const int c = static_cast<int>(tc::cluster_ctarank());
  const int U = tc::wide_units(H), K = H / 16;
  const int d = blockIdx.y, group = blockIdx.x / C;
  const int R = gridDim.y * B;
  const int row_b = tc::row_bytes(H);
  const uint32_t s_a = tc::smem_addr(smem);    // A[2][kM]
  const uint32_t a_bytes = kM * row_b;
  const int tid = threadIdx.x, l = tid & 31, w = tid >> 5;
  const int u0 = c * U, uc = min(U, H - u0);   // this block's units
  const bool active = 8 * w < uc;              // this warp's unit block
  const int j = u0 + 8 * w + 2 * (l & 3);      // this lane's units j, j + 1

  // A[0] = h_0: 0, or the stream form's bf16(h0), the h half of h0's rows
  if (kStream)
    tc::fill_h0(smem, h0 + (static_cast<int64_t>(d) * B + group * kM) * 2 * H,
                2 * H, B - group * kM, H);
  else
    tc::zero_shared(smem, a_bytes);
  __syncthreads();
  tc::cluster_sync();   // every peer has started before DSMEM stores

  // this lane's rows i = 0, 1: l / 4 and l / 4 + 8 of the group
  bool valid[2];
  int rr[2];
  float lo_r[2], hi_r[2], h[2][2] = {}, cv[2][2] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int b = group * kM + (l >> 2) + 8 * i;
    valid[i] = active && b < B;
    rr[i] = d * B + b;
    lo_r[i] = valid[i] ? lo[rr[i]] : 0.0f;
    hi_r[i] = valid[i] ? hi[rr[i]] : 0.0f;   // never live
    if (kStream && valid[i]) {
      const float* src = h0 + static_cast<int64_t>(rr[i]) * 2 * H + j;
      h[i][0] = src[0];
      h[i][1] = src[1];
      cv[i][0] = src[H];
      cv[i][1] = src[H + 1];
      if (emit_t == 0) {
        float* dst = carry + static_cast<int64_t>(rr[i]) * 2 * H + j;
        *reinterpret_cast<float2*>(dst) = make_float2(h[i][0], h[i][1]);
        *reinterpret_cast<float2*>(dst + H) = make_float2(cv[i][0], cv[i][1]);
      }
    }
  }
  // A row l % 16 at k chunk l / 16; this warp's fragments
  const uint32_t a_off = (l & 15) * row_b + (l >> 4) * 16;
  const uint2* wb =
      wf + (static_cast<int64_t>(d) * (H / 8) + u0 / 8 + w) * K * 4 * 32 + l;

  // xs of the lane's pairs: [row i][gate g] as (unit j, unit j + 1)
  auto load_x = [&](int t, float2 (&v)[2][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* xr =
          xs + (static_cast<int64_t>(t) * R + rr[i]) * 4 * H + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        v[i][g] = valid[i] ? __bfloat1622float2(
                                 *reinterpret_cast<const __nv_bfloat162*>(
                                     xr + g * H))
                           : make_float2(0.0f, 0.0f);
    }
  };
  float2 x[2][4];
  load_x(0, x);
  uint2 ring[kP][4];      // this warp's B fragments in flight
  if (active) tc::stream_prefetch<4, kP>(wb, K, ring);
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float2 nx[2][4];
    if (t + 1 < T) load_x(t + 1, nx);
    float acc[4][4] = {};
    if (active) {
      tc::streamed_product<4, kP>(s_a + cur * a_bytes + a_off, wb, K, ring,
                                   acc);
      // the next step's first fragments, in flight over the gate math,
      // the exchange and the barrier
      if (t + 1 < T) tc::stream_prefetch<4, kP>(wb, K, ring);
    }
    // gate math of the lane's pairs (accumulator element 2 i + e: row i,
    // unit j + e)
    float gv[2][2][4];
    const float tf = static_cast<float>(t);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xe[4] = {e ? x[i][0].y : x[i][0].x,
                             e ? x[i][1].y : x[i][1].x,
                             e ? x[i][2].y : x[i][2].x,
                             e ? x[i][3].y : x[i][3].x};
        const float ig = sigmoidf(xe[0] + acc[0][2 * i + e]);
        const float fg = sigmoidf((xe[1] + acc[1][2 * i + e]) + 1.0f);
        const float og = sigmoidf(xe[2] + acc[2][2 * i + e]);
        const float ug = tanhf(xe[3] + acc[3][2 * i + e]);
        const float cn = fg * cv[i][e] + ig * ug;
        const float hn = og * tanhf(cn);
        if (lo_r[i] <= tf && tf < hi_r[i]) {
          h[i][e] = hn;
          cv[i][e] = cn;
        }
        gv[i][e][0] = ig;
        gv[i][e][1] = fg;
        gv[i][e][2] = og;
        gv[i][e][3] = ug;
      }
    const int nxt = cur ^ 1;
    const bool more = t + 1 < T;
    if (more) {
      // h into this block's columns of A[nxt], then into every peer's
      const uint32_t s_nxt = s_a + nxt * a_bytes;
      if (active)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<__nv_bfloat162*>(
              smem + (s_nxt - s_a) + ((l >> 2) + 8 * i) * row_b + 2 * j) =
              __floats2bfloat162_rn(h[i][0], h[i][1]);
      __syncthreads();
      tc::push_columns(s_nxt, row_b, 2 * u0, uc / 8, c, C);
      tc::cluster_arrive();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!valid[i]) continue;
      const int64_t row = static_cast<int64_t>(t) * R + rr[i];
      *reinterpret_cast<float2*>(ys + row * H + j) =
          make_float2(h[i][0], h[i][1]);
      if (kResiduals) {
        *reinterpret_cast<float2*>(cs + row * H + j) =
            make_float2(cv[i][0], cv[i][1]);
        __nv_bfloat16* gt = gates + row * 4 * H + j;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          *reinterpret_cast<__nv_bfloat162*>(gt + g * H) =
              __floats2bfloat162_rn(gv[i][0][g], gv[i][1][g]);
      }
      if (kStream && t == emit_t - 1) {
        float* dst = carry + static_cast<int64_t>(rr[i]) * 2 * H + j;
        *reinterpret_cast<float2*>(dst) = make_float2(h[i][0], h[i][1]);
        *reinterpret_cast<float2*>(dst + H) = make_float2(cv[i][0], cv[i][1]);
      }
    }
    if (more) {
      tc::cluster_wait();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) x[i][g] = nx[i][g];
    }
    cur = nxt;
  }
}

template <bool kResiduals, bool kStream, int kP>
int launch_wide_kp(const void* xs, const void* wf, const float* lo,
                   const float* hi, const float* h0, float* ys, float* cs,
                   void* gates, float* carry, int T, int B, int H, int ndir,
                   int emit_t, cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  return tc::launch_clusters(
      lstm_fwd_wide_kernel<kResiduals, kStream, kP>, tc::wide_cluster(H),
      (B + tc::kRows - 1) / tc::kRows, ndir, tc::wide_fwd_threads(H),
      tc::wide_fwd_smem(H), stream, static_cast<const __nv_bfloat16*>(xs),
      static_cast<const uint2*>(wf), lo, hi, h0, ys, cs,
      static_cast<__nv_bfloat16*>(gates), carry, T, B, H, emit_t);
}

// the bf16 forms: the resident cluster kernel up to H = 512, W streamed
// above
template <bool kResiduals, bool kStream>
int launch_bf16(const void* xs, const void* wt, const float* lo,
                const float* hi, const float* h0, float* ys, float* cs,
                void* gates, float* carry, int T, int B, int H, int ndir,
                int emit_t, int C, cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  if (H <= tc::kResidentMax)
    return launch_tc<kResiduals, kStream>(xs, wt, lo, hi, h0, ys, cs, gates,
                                          carry, T, B, H, ndir, emit_t, C,
                                          stream);
  if (C != tc::wide_cluster(H)) return static_cast<int>(cudaErrorInvalidValue);
  switch (tc::wide_prefetch(tc::wide_fwd_threads(H))) {
    case 16:
      return launch_wide_kp<kResiduals, kStream, 16>(
          xs, wt, lo, hi, h0, ys, cs, gates, carry, T, B, H, ndir, emit_t,
          stream);
    case 8:
      return launch_wide_kp<kResiduals, kStream, 8>(
          xs, wt, lo, hi, h0, ys, cs, gates, carry, T, B, H, ndir, emit_t,
          stream);
    default:
      return launch_wide_kp<kResiduals, kStream, 4>(
          xs, wt, lo, hi, h0, ys, cs, gates, carry, T, B, H, ndir, emit_t,
          stream);
  }
}

}  // namespace

// xs [T, ndir*B, 4H] fp32 and wq [ndir, H/4, 4H, 4] fp32 (the FMA kernel),
// or, when bf16 != 0, xs bf16 and wq = wt [ndir, C, 4, 32, H] bf16 (the
// cluster kernel: C = H / 32 blocks a cluster, ops/rnn_cuda.py's
// lstm_plan; past H = 512 the streamed-W fragments [ndir, H/8, H/16, 4,
// 32, 4] and C = wide_cluster(H), rnn_cuda.wide_fwd_weights; unread under
// fp32); lo/hi [ndir*B] fp32; ys [T, ndir*B, H] fp32. Requires 32 <= H <=
// 2048, H % 32 == 0, T >= 1, B >= 1, ndir 1 or 2 (the wrapper checks).
CSR_API int csr_lstm_fwd(const void* xs, const void* wq, const float* lo,
                         const float* hi, float* ys, int T, int B, int H,
                         int ndir, int C, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch_bf16<false, false>(xs, wq, lo, hi, nullptr, ys, nullptr,
                                     nullptr, nullptr, T, B, H, ndir, 0, C,
                                     stream);
  return launch<float, false, false>(xs, wq, lo, hi, nullptr, ys, nullptr,
                                     nullptr, nullptr, T, B, H, ndir, 0,
                                     stream);
}

// As csr_lstm_fwd (ndir 1 or 2 likewise), plus cs [T, ndir*B, H] fp32 and
// gates [T, ndir*B, 4H] in the stream dtype (the dtype of xs) out: c and
// (i, f, o, u) of every step, live or not.
CSR_API int csr_lstm_fwd_train(const void* xs, const void* wq,
                               const float* lo, const float* hi, float* ys,
                               float* cs, void* gates, int T, int B, int H,
                               int ndir, int C, int bf16,
                               cudaStream_t stream) {
  if (bf16)
    return launch_bf16<true, false>(xs, wq, lo, hi, nullptr, ys, cs, gates,
                                    nullptr, T, B, H, ndir, 0, C, stream);
  return launch<float, true, false>(xs, wq, lo, hi, nullptr, ys, cs, gates,
                                    nullptr, T, B, H, ndir, 0, stream);
}

// The cluster forward's plan as the card takes it: out[0] = its shared
// memory bytes at hidden size H (C = H / 32 blocks up to H = 512, the
// streamed-W form's wide_cluster(H) above), out[1] = how many of its
// clusters the card holds at once (cudaOccupancyMaxActiveClusters; 0: it
// cannot launch).
CSR_API int csr_lstm_fwd_occupancy(int H, int* out) {
  namespace tc = csr_rnn_mma;
  if (H > tc::kResidentMax) {
    const int threads = tc::wide_fwd_threads(H);
    out[0] = tc::wide_fwd_smem(H);
    const int kP = tc::wide_prefetch(threads);
    auto kernel = kP == 16  ? lstm_fwd_wide_kernel<true, false, 16>
                  : kP == 8 ? lstm_fwd_wide_kernel<true, false, 8>
                            : lstm_fwd_wide_kernel<true, false, 4>;
    return tc::max_clusters(kernel, tc::wide_cluster(H), threads, out[0],
                            out + 1);
  }
  out[0] = tc::fwd_smem(H);
  return tc::max_clusters(lstm_fwd_tc_kernel<true, false>, H / tc::kUnits,
                          tc::kRows * tc::kUnits, out[0], out + 1);
}

// As csr_lstm_fwd (wq and C likewise), with h||c seeded from h0
// [ndir*B, 2H] fp32 and carry [ndir*B, 2H] fp32 out: h||c after step
// emit_t - 1, h0 when emit_t == 0. Requires 0 <= emit_t <= T (the wrapper
// checks).
CSR_API int csr_lstm_fwd_stream(const void* xs, const void* wq,
                                const float* lo, const float* hi,
                                const float* h0, float* ys, float* carry,
                                int T, int B, int H, int ndir, int emit_t,
                                int C, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch_bf16<false, true>(xs, wq, lo, hi, h0, ys, nullptr, nullptr,
                                    carry, T, B, H, ndir, emit_t, C, stream);
  return launch<float, false, true>(xs, wq, lo, hi, h0, ys, nullptr, nullptr,
                                    carry, T, B, H, ndir, emit_t, stream);
}
