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
// Three kernels. The bf16 forms, all three (the presets' path), run the
// step product on the tensor cores: up to H = 512 on a thread-block
// cluster with W resident in the cluster's shared memory
// (lstm_fwd_tc_kernel, below; one template over kResiduals and kStream),
// above as one persistent cooperative launch over the whole card, W
// spread over its blocks' shared memory and A staged there at each step
// (lstm_fwd_persist_kernel, further below). The fp32 forms run the FMA
// kernel (lstm_fwd_kernel, one template over kResiduals and kStream).
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
// The bf16 forward past H = 512: the persistent form (rnn_mma.cuh; the same
// three entries under bf16 compute, for ops/rnn_pallas.py's
// _lstm_fwd_kernel in both its forms and _lstm_stream_kernel),
// csrc/gru_fwd.cu's gru_fwd_persist_kernel with four gates, a cell state
// and A staged in shared memory.
//
// What bounds it on Hopper: a step multiplies every row of a direction by
// all of its W (4 H^2 bf16: 8.4 MB at H = 1024, 33.6 MB at 2048), and the
// T steps run one after another. The clustered form that came before read
// W from L2 once per 16-row group at every step, on the 16 SMs of one
// cluster per group and direction (twice a step at B = 24 or 32, at most
// 64 of the 132 SMs reading), its warps each owning one unit block over
// the whole reduction (14.5 µs a training step at H = 1024 against cuDNN's
// 10.6). In the persistent form the step is held by the latency of the
// product's loads of A from L2, which every block reads whole (PERF.md, PR
// 23: with A already in shared memory the GRU forward's step took 0.65-0.86
// of its time, with half the A bytes 0.96-1.01).
//
// What this design does about it: W is spread over the whole card and read
// once a step for all rows, and each warp copies its k-steps of A into
// shared memory by cp.async as soon as the grid barrier has passed, all of
// them in flight at once (a ring of kStages slots, the whole of the warp's
// A where it fits beside W: up to H = 1024 at ndir 2), so the product reads
// A and B from shared memory. Block (d, cb) of the NB ndir blocks owns nt
// n8 tiles of units, tiles [nt cb, nt cb + nt), with their i, f, o and u
// columns (nc = 4 nt B columns), so the gate math and c stay in the block;
// its slice of W, wf[d][cb] = [K = H / 16][nc][32 lanes] uint2 in mma.sync
// fragment order (ops/rnn_cuda.py's persist_lstm_fwd_weights), is copied
// into shared memory once a launch (the first kr k-steps of each warp's
// range where the whole slice does not fit beside the ring: the rest go
// through the ring at each step). On a card of fewer than ndir H / 32 SMs
// a block owns more than kGroupTiles tiles and runs them as groups of NT
// (rnn_mma.cuh), steps 1-2 once a group in turn, each group staging A
// anew. A step, for each pass of 32 rows (B > 32 takes more passes, B <=
// 16 one m16 tile):
//   1. the product: warp w of four multiplies the pass's rows of h (bf16,
//      where _dot2 rounds it) by the block's columns over its quarter of
//      the K k-steps, each B fragment feeding both m16 tiles; at nt = 4 (16
//      columns, 128 accumulators a thread) in two halves of 8 columns, each
//      half staging A anew, so the accumulators fit the registers;
//   2. the quarters meet in shared memory; a slot (m-tile, tile, lane)
//      adds them in warp order (no atomics: bitwise repeatable) and runs
//      the gate math of its two rows and two units. With one pass, one
//      group and one slot a thread (B <= 32, nt <= 2) the slot keeps its
//      fp32 h and c in
//      registers and its xs, lo and hi for the next step are loaded during
//      the barrier; otherwise h_prev is read back from ys[t - 1] (or h0 /
//      0), c from the workspace's carried [ndir·B][H] (written by the same
//      slot the step before), and xs at the step;
//   3. the new h, rounded to bf16, goes into the next step's A buffer in
//      global memory (two buffers, by step parity), then one grid barrier
//      (rnn_mma.cuh's grid_arrive / grid_wait).
// Measured on an H100 (tools/kernel_ab.py --cases rnn_wide against copies
// of this build, PERF.md): the training forward (B = 24, T' = 256) takes
// 1.90 ms at H = 1024 and 7.90 at 2048, where cuDNN takes 2.60 and 8.51.
// Staging A takes 0.80 of the time of a copy that reads A from L2
// (persist_product in place of staged_product) at H = 1024. The product is 54-79% of a step,
// the ring's copies 3-16% at H = 1024 and 33-36% at 2048 (measured with
// one-k-step slots; most of them the streamed W's: 4 of each warp's 32
// k-steps stay resident), the grid barrier 3-8%.
// At t = 0 the product of h_0 = 0 is skipped (it is +0 exactly); the
// stream form (kStream) first writes bf16(h0) of its units into A[0] and
// passes one more barrier, seeds h and c from h0's h||c and writes carry =
// h||c after step emit_t - 1 (h0 at entry when emit_t == 0). The three
// forms share the product and the gate math, so their ys are equal (the
// stream form's at h0 = 0). The launch is cooperative (rnn_mma.cuh's
// launch_cooperative): all NB ndir <= sms blocks are resident, or it
// fails.
constexpr int kFwdWarps = 4;    // warps a block of the persistent form
constexpr int kFwdCols = 12;    // columns a product at most (nt = 4: halves)

// a slot's inputs at one step: xs of its two rows (the bf16 pairs of its
// two units, gates i, f, o, u) and the rows' lo and hi
struct LstmIn {
  uint32_t x[2][4];
  float lo[2], hi[2];
};

template <int NT, bool kResiduals, bool kStream>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
    lstm_fwd_persist_kernel(const __nv_bfloat16* __restrict__ xs,
                            const uint2* __restrict__ wf,
                            const float* __restrict__ lo,
                            const float* __restrict__ hi,
                            const float* __restrict__ h0,
                            float* __restrict__ ys, float* __restrict__ cs,
                            __nv_bfloat16* __restrict__ gates,
                            float* __restrict__ carry, unsigned int* counter,
                            uint4* abuf, float* held, int T, int B, int H,
                            int NB, int tiles, int groups, int kr, int ck,
                            int emit_t) {
  namespace tc = csr_rnn_mma;
  // NT: tiles a group (nw8); the block's `tiles` run as `groups` of them
  constexpr int NC = 4 * NT, kW = kFwdWarps;
  constexpr int kHalves = (NC + kFwdCols - 1) / kFwdCols;
  constexpr int NCH = NC / kHalves;   // columns a product
  // slots (m-tile, tile, lane) a thread, and whether one pass of one slot
  // a thread can keep the slot's h, c and next inputs in registers
  constexpr int kSlots = (2 * NT * 32 + 32 * kW - 1) / (32 * kW);
  constexpr bool kCanHold = kSlots == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);
  unsigned char* res = smem + tc::persist_part(NC, kW);
  const int ndir = gridDim.x / NB;
  const int d = blockIdx.x / NB, cb = blockIdx.x % NB;
  const int R = ndir * B, G = 4 * H, K = H / 16, nt_all = H / 8;
  const int passes = (B + tc::kPassRows - 1) / tc::kPassRows;
  const bool two = B > 16;
  const bool hold = kCanHold && passes == 1 && groups == 1;
  const int tid = threadIdx.x, l = tid & 31, w = tid >> 5;
  const uint2* slice = wf + int64_t(d * NB + cb) * groups * K * NC * 32;
  // A of direction d, pass p, m-tile m in buffer buf: [2][ndir][passes][2]
  // [K][32] uint4
  auto a_of = [&](int buf, int p, int m) {
    return abuf + (int64_t((buf * ndir + d) * passes + p) * 2 + m) * K * 32;
  };
  tc::load_resident(tc::smem_addr(res), slice, kW, K, kr, NC, groups);
  __syncthreads();
  const tc::WarpSteps ws = tc::warp_steps(w, kW, K, kr);
  const int kq = (K + kW - 1) / kW;
  const int sz = tc::stage_bytes(NCH, kr < kq);
  unsigned char* ring =
      res + groups * kW * kr * NC * 256 + w * tc::kStages * ck * sz;
  const int rot = ck > 0 ? (ws.kw + ck - 1) / ck * cb / NB : 0;
  // group 0's resident fragments of this lane (a shared-space address),
  // and its streamed ones (group g's kW kr NC 256 bytes and K NC 32 uint2
  // further on)
  const uint32_t sb0 = tc::smem_addr(res) + (w * kr * NC * 32 + l) * 8;
  const uint2* gb0 = slice + int64_t(ws.kb) * NC * 32;
  const int nslots = (two ? 2 : 1) * NT * 32;
  unsigned int barriers = 0;

  // slot s of group g of a block of nt tiles: m-tile m, its tile's lane
  // ls, its tile ti in the group, unit j (the pair j, j + 1); `own`: a
  // slot of this launch's rows, of one of the block's tiles and of a unit
  // below H
  struct Slot {
    int m, ls, ti, j;
    bool own;
  };
  auto slot_of = [&](int q, int g, int nt) {
    const int s = tid + q * 32 * kW, ti = (s / 32) % NT, ib = g * NT + ti;
    const int tg = cb * nt + ib;
    return Slot{s / (NT * 32), s & 31, ti, 8 * tg + 2 * (s & 3),
                s < nslots && ib < nt && tg < nt_all};
  };
  auto row_of = [&](int p, const Slot& o, int i) {
    return p * tc::kPassRows + 16 * o.m + (o.ls >> 2) + 8 * i;
  };
  auto load_in = [&](int t, int p, const Slot& o) {
    LstmIn in;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = row_of(p, o, i);
      const bool valid = b < B;
      const int64_t rr = int64_t(d) * B + b, row = int64_t(t) * R + rr;
      in.lo[i] = valid ? lo[rr] : 0.0f;   // rows past B: never live
      in.hi[i] = valid ? hi[rr] : 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        in.x[i][g] = valid ? *reinterpret_cast<const uint32_t*>(
                                 xs + row * G + g * H + o.j)
                           : 0u;
    }
    return in;
  };
  LstmIn next[kCanHold ? kSlots : 1];
  float2 hreg[kCanHold ? kSlots : 1][2], creg[kCanHold ? kSlots : 1][2];

  // h_0 and c_0: 0, or the stream form's h0 = h||c (and bf16(h) into A[0])
  for (int gr = 0; gr < groups; ++gr)
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const Slot o = slot_of(q, gr, tiles);
      if (!o.own) continue;
      for (int p = 0; p < passes; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int b = row_of(p, o, i);
          const int64_t rr = int64_t(d) * B + b;
          float2 v = make_float2(0.0f, 0.0f), c = v;
          if (kStream) {
            if (b < B) {
              v = *reinterpret_cast<const float2*>(h0 + rr * 2 * H + o.j);
              c = *reinterpret_cast<const float2*>(h0 + rr * 2 * H + H +
                                                   o.j);
            }
            *tc::a_word(a_of(0, p, o.m), o.j, i, o.ls) = tc::bf16x2(v.x, v.y);
            if (b < B && emit_t == 0) {
              *reinterpret_cast<float2*>(carry + rr * 2 * H + o.j) = v;
              *reinterpret_cast<float2*>(carry + rr * 2 * H + H + o.j) = c;
            }
          }
          if (kCanHold) {
            hreg[kCanHold ? q : 0][i] = v;
            creg[kCanHold ? q : 0][i] = c;
          }
        }
      if (hold) next[kCanHold ? q : 0] = load_in(0, 0, o);
    }
  if (kStream) {
    tc::grid_arrive(counter);
    tc::grid_wait(counter, ++barriers * gridDim.x);
  }
  // group gr's share of step t, pass p: its product, then its slots'
  // gate math (a copy for one group a block, one for more: OneGroup,
  // Groups)
  auto group_step = [&](auto tag, int t, int p, int gr) {
    const bool keep = decltype(tag)::one && hold;
    const int nt = decltype(tag)::one ? NT : tiles;   // NT: nt of one group
    const int cur = t & 1;
    const bool product = kStream || t > 0;
    const float tf = static_cast<float>(t);
    if (product) {
      const uint32_t sb = sb0 + gr * kW * kr * NC * 256;
      const uint2* gb = gb0 + int64_t(gr) * K * NC * 32;
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        float acc[2][NCH][4] = {};
        tc::staged_product<NCH>(
            acc, a_of(cur, p, 0) + ws.kb * 32, a_of(cur, p, 1) + ws.kb * 32,
            two, ws.kw, ws.kres, rot, sb + hf * NCH * 256, NC,
            gb + hf * NCH * 32, ring, ck, sz, l);
        tc::store_partials<NCH>(part, acc, two, w, l, NC, hf * NCH);
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const Slot o = slot_of(q, gr, nt);
      if (!o.own) continue;
      float4 pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        pre[g] = product ? tc::sum_partials(part, kW, NC, o.m, 4 * o.ti + g,
                                            o.ls)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const LstmIn in = keep ? next[kCanHold ? q : 0] : load_in(t, p, o);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = row_of(p, o, i);
        const bool valid = b < B;
        const int64_t rr = int64_t(d) * B + b;
        const int64_t row = int64_t(t) * R + rr;
        float2 hp = make_float2(0.0f, 0.0f), cp = hp, x[4];
        if (keep) {
          hp = hreg[kCanHold ? q : 0][i];
          cp = creg[kCanHold ? q : 0][i];
        } else if (valid) {
          if (t > 0) {
            hp = *reinterpret_cast<const float2*>(ys + (row - R) * H + o.j);
            cp = *reinterpret_cast<const float2*>(held + rr * H + o.j);
          } else if (kStream) {
            hp = *reinterpret_cast<const float2*>(h0 + rr * 2 * H + o.j);
            cp = *reinterpret_cast<const float2*>(h0 + rr * 2 * H + H + o.j);
          }
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
          x[g] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&in.x[i][g]));
        const bool live = in.lo[i] <= tf && tf < in.hi[i];
        float h[2], c[2], gv[2][4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          auto pick = [&](const float4& v) {
            return i ? (e ? v.w : v.z) : (e ? v.y : v.x);
          };
          const float ig = sigmoidf((e ? x[0].y : x[0].x) + pick(pre[0]));
          const float fg =
              sigmoidf(((e ? x[1].y : x[1].x) + pick(pre[1])) + 1.0f);
          const float og = sigmoidf((e ? x[2].y : x[2].x) + pick(pre[2]));
          const float ug = tanhf((e ? x[3].y : x[3].x) + pick(pre[3]));
          const float cv = e ? cp.y : cp.x, hv = e ? hp.y : hp.x;
          const float cn = fg * cv + ig * ug;
          const float hn = og * tanhf(cn);
          h[e] = live ? hn : hv;
          c[e] = live ? cn : cv;
          gv[e][0] = ig;
          gv[e][1] = fg;
          gv[e][2] = og;
          gv[e][3] = ug;
        }
        if (kCanHold && decltype(tag)::one) {
          hreg[kCanHold ? q : 0][i] = make_float2(h[0], h[1]);
          creg[kCanHold ? q : 0][i] = make_float2(c[0], c[1]);
        }
        if (t + 1 < T)
          *tc::a_word(a_of(cur ^ 1, p, o.m), o.j, i, o.ls) =
              tc::bf16x2(h[0], h[1]);
        if (!valid) continue;
        if (!keep && t + 1 < T)
          *reinterpret_cast<float2*>(held + rr * H + o.j) =
              make_float2(c[0], c[1]);
        *reinterpret_cast<float2*>(ys + row * H + o.j) =
            make_float2(h[0], h[1]);
        if (kResiduals) {
          *reinterpret_cast<float2*>(cs + row * H + o.j) =
              make_float2(c[0], c[1]);
#pragma unroll
          for (int g = 0; g < 4; ++g)
            *reinterpret_cast<uint32_t*>(gates + row * G + g * H + o.j) =
                tc::bf16x2(gv[0][g], gv[1][g]);
        }
        if (kStream && t == emit_t - 1) {
          *reinterpret_cast<float2*>(carry + rr * 2 * H + o.j) =
              make_float2(h[0], h[1]);
          *reinterpret_cast<float2*>(carry + rr * 2 * H + H + o.j) =
              make_float2(c[0], c[1]);
        }
      }
    }
    __syncthreads();
  };
  // the T steps, in a loop of their own for each copy, so that what one
  // copy keeps in registers across its steps does not crowd the other
  auto run = [&](auto tag) {
    for (int t = 0; t < T; ++t) {
      for (int p = 0; p < passes; ++p) {
        if constexpr (decltype(tag)::one)
          group_step(tag, t, p, 0);
        else
          for (int gr = 0; gr < groups; ++gr) group_step(tag, t, p, gr);
      }
      if (t + 1 < T) {
        tc::grid_arrive(counter);
        // the next step's inputs, in flight over the wait and the product
        if (decltype(tag)::one && hold)
#pragma unroll
          for (int q = 0; q < kSlots; ++q) {
            const Slot o = slot_of(q, 0, NT);
            if (o.own) next[kCanHold ? q : 0] = load_in(t + 1, 0, o);
          }
        tc::grid_wait(counter, ++barriers * gridDim.x);
      }
    }
  };
  // more than one group means groups of three or four tiles, so a kernel
  // of one or two tiles a group has the one copy only
  if constexpr (NT <= 2)
    run(tc::OneGroup{});
  else if (groups == 1)
    run(tc::OneGroup{});
  else
    run(tc::Groups{});
}

// the persistent forward's plan on a card of `sms` SMs (ops/rnn_cuda.py's
// persist_plan("lstm_fwd", ...))
csr_rnn_mma::PersistPlan fwd_persist_plan(int H, int ndir, int B,
                                          int sms) {
  return csr_rnn_mma::persist_plan(H, ndir, B, sms, 4, H / 16, kFwdWarps, 1,
                                   true, kFwdCols);
}

// the persistent kernel of groups of `width` tiles
template <bool kResiduals, bool kStream, typename Fn>
int with_persist_kernel(int width, Fn&& fn) {
  static_assert(csr_rnn_mma::kGroupTiles == 4, "a kernel a group width");
  switch (width) {
    case 1:
      return fn(lstm_fwd_persist_kernel<1, kResiduals, kStream>);
    case 2:
      return fn(lstm_fwd_persist_kernel<2, kResiduals, kStream>);
    case 3:
      return fn(lstm_fwd_persist_kernel<3, kResiduals, kStream>);
    case 4:
      return fn(lstm_fwd_persist_kernel<4, kResiduals, kStream>);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the bf16 forms: the resident cluster kernel up to H = 512, the
// persistent form above (C: its blocks a direction, sms: the SM count its
// plan was made for, work: its workspace of the plan's bytes,
// rnn_mma.cuh's PersistPlan)
template <bool kResiduals, bool kStream>
int launch_bf16(const void* xs, const void* wt, const float* lo,
                const float* hi, const float* h0, float* ys, float* cs,
                void* gates, float* carry, void* work, int T, int B, int H,
                int ndir, int emit_t, int C, int sms, cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  if (H <= tc::kResidentMax)
    return launch_tc<kResiduals, kStream>(xs, wt, lo, hi, h0, ys, cs, gates,
                                          carry, T, B, H, ndir, emit_t, C,
                                          stream);
  const cudaError_t e = tc::check_sms(sms, ndir);
  if (e != cudaSuccess) return static_cast<int>(e);
  const tc::PersistPlan p = fwd_persist_plan(H, ndir, B, sms);
  if (C != p.blocks || work == nullptr || p.chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(work);
  unsigned int* counter = reinterpret_cast<unsigned int*>(base);
  uint4* abuf = reinterpret_cast<uint4*>(base + 256);
  float* held = reinterpret_cast<float*>(base + p.held);
  return with_persist_kernel<kResiduals, kStream>(p.width, [&](auto kernel) {
    return tc::launch_cooperative(
        kernel, p.blocks * ndir, 32 * kFwdWarps, p.smem, stream, counter,
        static_cast<const __nv_bfloat16*>(xs), static_cast<const uint2*>(wt),
        lo, hi, h0, ys, cs, static_cast<__nv_bfloat16*>(gates), carry,
        counter, abuf, held, T, B, H, p.blocks, p.tiles, p.groups,
        p.resident, p.chunk, emit_t);
  });
}

}  // namespace

// xs [T, ndir*B, 4H] fp32 and wq [ndir, H/4, 4H, 4] fp32 (the FMA kernel),
// or, when bf16 != 0, xs bf16 and wq = wt [ndir, C, 4, 32, H] bf16 (the
// cluster kernel: C = H / 32 blocks a cluster, ops/rnn_cuda.py's
// lstm_plan; past H = 512 the persistent form's fragments [ndir, C,
// ng·H/16, nw8, 4, 32, 4], C its blocks a direction, on a card of `sms`
// SMs, rnn_cuda.persist_lstm_fwd_weights; unread under fp32); lo/hi
// [ndir*B] fp32; ys [T, ndir*B, H] fp32; work the persistent form's
// workspace (csr_lstm_fwd_persist_plan's bytes; unread elsewhere); sms the
// SM count the persistent plan was made for (ndir <= sms <= the card's;
// unread elsewhere). Requires 32 <= H <= 2048, H % 32 == 0, T >= 1, B >=
// 1, ndir 1 or 2 (the wrapper checks).
CSR_API int csr_lstm_fwd(const void* xs, const void* wq, const float* lo,
                         const float* hi, float* ys, void* work, int T, int B,
                         int H, int ndir, int C, int sms, int bf16,
                         cudaStream_t stream) {
  if (bf16)
    return launch_bf16<false, false>(xs, wq, lo, hi, nullptr, ys, nullptr,
                                     nullptr, nullptr, work, T, B, H, ndir, 0,
                                     C, sms, stream);
  return launch<float, false, false>(xs, wq, lo, hi, nullptr, ys, nullptr,
                                     nullptr, nullptr, T, B, H, ndir, 0,
                                     stream);
}

// As csr_lstm_fwd (ndir 1 or 2 likewise), plus cs [T, ndir*B, H] fp32 and
// gates [T, ndir*B, 4H] in the stream dtype (the dtype of xs) out: c and
// (i, f, o, u) of every step, live or not.
CSR_API int csr_lstm_fwd_train(const void* xs, const void* wq,
                               const float* lo, const float* hi, float* ys,
                               float* cs, void* gates, void* work, int T,
                               int B, int H, int ndir, int C, int sms,
                               int bf16, cudaStream_t stream) {
  if (bf16)
    return launch_bf16<true, false>(xs, wq, lo, hi, nullptr, ys, cs, gates,
                                    nullptr, work, T, B, H, ndir, 0, C, sms,
                                    stream);
  return launch<float, true, false>(xs, wq, lo, hi, nullptr, ys, cs, gates,
                                    nullptr, T, B, H, ndir, 0, stream);
}

// The cluster forward's plan as the card takes it (H <= 512): out[0] = its
// shared memory bytes at hidden size H (C = H / 32 blocks), out[1] = how
// many of its clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot launch). Past H = 512 see
// csr_lstm_fwd_persist_plan.
CSR_API int csr_lstm_fwd_occupancy(int H, int* out) {
  namespace tc = csr_rnn_mma;
  if (H > tc::kResidentMax) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = tc::fwd_smem(H);
  return tc::max_clusters(lstm_fwd_tc_kernel<true, false>, H / tc::kUnits,
                          tc::kRows * tc::kUnits, out[0], out + 1);
}

// The persistent forward's plan as the card takes it at hidden size H >
// 512, ndir directions, B rows a direction and `sms` SMs
// (rnn_mma.cuh's report_plan; out: 8 int64). cudaErrorInvalidValue where
// sms is below ndir or above the card's.
CSR_API int csr_lstm_fwd_persist_plan(int H, int ndir, int B, int sms,
                                      long long* out) {
  namespace tc = csr_rnn_mma;
  const cudaError_t e = tc::check_sms(sms, ndir);
  if (e != cudaSuccess) return static_cast<int>(e);
  const tc::PersistPlan p = fwd_persist_plan(H, ndir, B, sms);
  return with_persist_kernel<true, false>(p.width, [&](auto kernel) {
    return tc::report_plan(p, kernel, 32 * kFwdWarps, out);
  });
}

// As csr_lstm_fwd (wq, C, sms and work likewise), with h||c seeded from h0
// [ndir*B, 2H] fp32 and carry [ndir*B, 2H] fp32 out: h||c after step
// emit_t - 1, h0 when emit_t == 0. Requires 0 <= emit_t <= T (the wrapper
// checks).
CSR_API int csr_lstm_fwd_stream(const void* xs, const void* wq,
                                const float* lo, const float* hi,
                                const float* h0, float* ys, float* carry,
                                void* work, int T, int B, int H, int ndir,
                                int emit_t, int C, int sms, int bf16,
                                cudaStream_t stream) {
  if (bf16)
    return launch_bf16<false, true>(xs, wq, lo, hi, h0, ys, nullptr, nullptr,
                                    carry, work, T, B, H, ndir, emit_t, C,
                                    sms, stream);
  return launch<float, false, true>(xs, wq, lo, hi, h0, ys, nullptr, nullptr,
                                    carry, T, B, H, ndir, emit_t, stream);
}
