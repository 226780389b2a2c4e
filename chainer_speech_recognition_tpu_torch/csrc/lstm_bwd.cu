// LSTM recurrence (bidirectional or forward-only), backward (reverse-time
// gradient walk).
//
// Replaces ops/rnn_pallas.py::_lstm_bwd_kernel (the custom VJP's backward,
// _birnn_bwd's LSTM branch). Same boundary but one stream: gates [T,
// R=ndir*B, 4H] = (i, f, o, u) from the training forward (csrc/lstm_fwd.cu,
// stream dtype), the recurrent weights (laid out for each kernel, below),
// lo/hi [R] fp32, cs [T, R, H] fp32 (the cell states) and g
// [T, R, H] fp32 (the gradient of the layer's ys). The reference also takes
// c_prev, the cell states shifted by one step with zeros first; here a
// step reads cs one step back (0 at t = 0) instead. Out: dxs [T, R, 4H] in
// the stream dtype = the gate pre-activation gradients dg = (di, df, do,
// du), masked to the live steps; they are the gradient of xs and of the
// recurrent pre-activations, so dW = sum_t h_prev^T dxs is one matmul after
// the kernel, off the sequential path, as the TPU kernel leaves it to XLA.
// Rows [d*B, (d+1)*B) use w[d], ndir 2 or, for a forward-only layer, 1 (its
// one W, not duplicated as on the TPU path).
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
// Two kernels: under bf16 compute (the presets' path) a thread-block
// cluster keeps W resident in its shared memory and runs the step product
// on the tensor cores (lstm_bwd_tc_kernel, below); under fp32 the FMA
// kernel (lstm_bwd_kernel).
//
// The FMA kernel: the forward's, turned around (csrc/gru_bwd.cu's with
// four gates). One block owns one row of one direction and walks T
// backwards; thread j owns hidden unit j and keeps its dh and dc in
// registers. It writes its unit's four dg values to shared memory
// (double-buffered: one barrier a step), then reduces the row's 4H values
// against column j of W^T, i.e. row j of W. The wrapper passes W as k-quads
// of W^T, wtq [2][H][H][4]: wtq[d][k4][j][kk] = W[d][j][4 k4 + kk], so a
// thread fetches four reduction rows with one load and a warp's loads are
// contiguous. W is streamed from L2 in register chunks of 8 quads (32
// rows) whose next loads are issued before the current FMAs; the product
// keeps four partial sums (the lanes of a float4). The next step's gates,
// c, c_{t-1} and g are loaded before the product, so their latency hides
// behind it.
// Past H = 512 a thread owns kUPT = 2 (H <= 1024) or 4 units, one after
// the other, in blocks of H / kUPT <= 512 threads. Bounds: 32 <= H <= 2048,
// H % 32 == 0, any B, T >= 1.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "rnn_common.cuh"
#include "rnn_mma.cuh"

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

template <typename S, int kQ, int kMaxThreads, int kUPT>
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
  const int R = gridDim.y * B;   // ndir * B
  const int G = 4 * H;
  const Q* wd = wtq + static_cast<int64_t>(d) * H * H;  // [H quads][H]
  const float lo_r = lo[rr];
  const float hi_r = hi[rr];

  // thread's hidden units: j = threadIdx.x + q blockDim.x, q < kUPT
  // (blockDim.x = H / kUPT)
  float dh[kUPT], dc[kUPT];
  StepIn in[kUPT];
#pragma unroll
  for (int q = 0; q < kUPT; ++q) {
    dh[q] = 0.0f;
    dc[q] = 0.0f;
    in[q] = load_step(gates, cs, g, static_cast<int64_t>(T - 1) * R + rr, R,
                      T - 1, H, threadIdx.x + q * blockDim.x);
  }
  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    const int64_t row = static_cast<int64_t>(t) * R + rr;
    const float tf = static_cast<float>(t);
    const bool live = lo_r <= tf && tf < hi_r;
    float dct[kUPT], ft[kUPT], dht[kUPT];
    float* buf = dgs + cur * G;
#pragma unroll
    for (int q = 0; q < kUPT; ++q) {
      const int j = threadIdx.x + q * blockDim.x;
      const float dh_total = in[q].g + dh[q];
      const float tc = tanhf(in[q].c);
      const float dog = dh_total * tc * in[q].o * (1.0f - in[q].o);
      dct[q] = dc[q] + dh_total * in[q].o * (1.0f - tc * tc);
      const float dfg = dct[q] * in[q].cp * in[q].f * (1.0f - in[q].f);
      const float dig = dct[q] * in[q].u * in[q].i * (1.0f - in[q].i);
      const float dug = dct[q] * in[q].i * (1.0f - in[q].u * in[q].u);
      ft[q] = in[q].f;
      dht[q] = dh_total;
      S* dx = dxs + row * G;
      dx[j] = from_f32<S>(live ? dig : 0.0f);
      dx[H + j] = from_f32<S>(live ? dfg : 0.0f);
      dx[2 * H + j] = from_f32<S>(live ? dog : 0.0f);
      dx[3 * H + j] = from_f32<S>(live ? dug : 0.0f);
      buf[j] = round_to<S>(dig);
      buf[H + j] = round_to<S>(dfg);
      buf[2 * H + j] = round_to<S>(dog);
      buf[3 * H + j] = round_to<S>(dug);
    }
    __syncthreads();
    if (t > 0)
#pragma unroll
      for (int q = 0; q < kUPT; ++q)
        in[q] = load_step(gates, cs, g, row - R, R, t - 1, H,
                          threadIdx.x + q * blockDim.x);

    const float4* v4 = reinterpret_cast<const float4*>(buf);
#pragma unroll
    for (int q = 0; q < kUPT; ++q) {
      const int j = threadIdx.x + q * blockDim.x;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // 4 partial sums
      Q w[kQ];
#pragma unroll
      for (int qq = 0; qq < kQ; ++qq)
        w[qq] = wd[static_cast<int64_t>(qq) * H + j];
      for (int k4 = 0; k4 < H; k4 += kQ) {
        Q nw[kQ];
        if (k4 + kQ < H) {
#pragma unroll
          for (int qq = 0; qq < kQ; ++qq)
            nw[qq] = wd[static_cast<int64_t>(k4 + kQ + qq) * H + j];
        }
#pragma unroll
        for (int qq = 0; qq < kQ; ++qq) {
          const float4 v = v4[k4 + qq];
          const float4 wv = Quad<S>::unpack(w[qq]);
          acc.x = fmaf(v.x, wv.x, acc.x);
          acc.y = fmaf(v.y, wv.y, acc.y);
          acc.z = fmaf(v.z, wv.z, acc.z);
          acc.w = fmaf(v.w, wv.w, acc.w);
        }
#pragma unroll
        for (int qq = 0; qq < kQ; ++qq) w[qq] = nw[qq];
      }
      const float dot = (acc.x + acc.y) + (acc.z + acc.w);
      if (live) {
        dh[q] = dot;
        dc[q] = dct[q] * ft[q];
      } else {
        dh[q] = dht[q];
      }
    }
    cur ^= 1;
  }
}

// W^T quads per register chunk: 8 (32 rows, fp32), which divides the H
// quads of any H % 32 == 0
constexpr int kChunkQuads = 8;

template <int kMaxThreads, int kUPT>
cudaError_t launch_upt(const void* gates, const void* wtq, const float* lo,
                       const float* hi, const float* cs, const float* g,
                       void* dxs, int T, int B, int H, int ndir,
                       cudaStream_t stream) {
  // half the chunk past one unit a thread: its registers go to the
  // units' carries and prefetched inputs
  auto kernel = lstm_bwd_kernel<float, kUPT == 1 ? kChunkQuads
                                                 : kChunkQuads / 2,
                                kMaxThreads, kUPT>;
  const int smem = 2 * 4 * H * sizeof(float);   // 64 KB at H = 2048
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(B, ndir), H / kUPT, smem, stream>>>(
      static_cast<const float*>(gates), static_cast<const float4*>(wtq), lo,
      hi, cs, g, static_cast<float*>(dxs), T, B, H);
  return cudaSuccess;
}

// one unit a thread up to H = 512, two up to 1024, four above
int launch_fp32(const void* gates, const void* wtq, const float* lo,
                const float* hi, const float* cs, const float* g, void* dxs,
                int T, int B, int H, int ndir, cudaStream_t stream) {
  cudaError_t e;
  if (H <= 384)
    e = launch_upt<384, 1>(gates, wtq, lo, hi, cs, g, dxs, T, B, H, ndir,
                           stream);
  else if (H <= 512)
    e = launch_upt<512, 1>(gates, wtq, lo, hi, cs, g, dxs, T, B, H, ndir,
                           stream);
  else if (H <= 1024)
    e = launch_upt<512, 2>(gates, wtq, lo, hi, cs, g, dxs, T, B, H, ndir,
                           stream);
  else
    e = launch_upt<512, 4>(gates, wtq, lo, hi, cs, g, dxs, T, B, H, ndir,
                           stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  CSR_RETURN_LAUNCH_STATUS();
}


// ---------------------------------------------------------------------------
// The bf16 backward on a thread-block cluster (csr_lstm_bwd under bf16
// compute; layout in rnn_mma.cuh).
//
// Grid: C·groups x 2 blocks, C = H / 32, in clusters of C along x, as the
// forward's: cluster (group, d) walks rows [16 group, 16 group + 16) of
// direction d backwards, block c of it owns units [32 c, 32 c + 32) and
// their 128 gate columns. Thread p owns the pair (row p / 32, unit
// p % 32) and keeps its dh and dc (fp32) in registers. The product is
// split by the reduction, not by the output: block c multiplies its own
// dg columns by the matching columns of every row of W, so it needs no
// other block's dg, and sends each block the partial sums for that block's
// units (a reduce-scatter: 16 x H fp32 a step leave each block, half the
// bytes of gathering the 16 x 4H bf16 dg). Its W slice, wb[d][c] =
// [H][4][32] bf16 (element [j][g][u] = W[d][j][g H + 32 c + u], laid out by
// the wrapper), stays in shared memory for all T steps: the n rows (units
// j) of the product's B operand, k-major. A step:
//   1. dg = (di, df, do, du) of the pair from the prefetched gates, c_t,
//      c_{t-1} and g; the next step's inputs are loaded;
//   2. the unmasked dg, rounded to bf16 (where _dot2 rounds it), into this
//      block's A [16][128];
//   3. warp w takes n-tiles w, w + 16, ... of the H units: 8 k-steps of
//      mma.sync m16n8k16 (bf16 operands, fp32 accumulators, A fragments
//      loaded once a step), and stores its 16 x 8 partial sums into the
//      owning block's buffer slot for source c through DSMEM;
//   4. the cluster barrier, release / acquire (dxs = dg masked to the live
//      steps is stored between its halves);
//   5. dh_prev of the pair = the C partial sums added in source order: no
//      atomics, bitwise repeatable; live: dh = dh_prev, dc = dc_t f;
//      otherwise dh = dh_total and dc passes through.
// The partial sums are double-buffered, so one cluster barrier a step is
// enough, as in the forward. At t = 0 the product is not needed.
__global__ void __launch_bounds__(csr_rnn_mma::kRows * csr_rnn_mma::kUnits, 1)
    lstm_bwd_tc_kernel(const __nv_bfloat16* __restrict__ gates,
                       const __nv_bfloat16* __restrict__ wb,
                       const float* __restrict__ lo,
                       const float* __restrict__ hi,
                       const float* __restrict__ cs,
                       const float* __restrict__ g,
                       __nv_bfloat16* __restrict__ dxs, int T, int B, int H) {
  namespace tc = csr_rnn_mma;
  constexpr int kU = tc::kUnits, kM = tc::kRows, kK = 4 * kU;
  constexpr int kSteps = kK / 16;                // k-steps of the product
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(tc::cluster_nctarank());
  const int c = static_cast<int>(tc::cluster_ctarank());
  const int G = 4 * H;
  const int d = blockIdx.y, group = blockIdx.x / C;
  const int R = gridDim.y * B;   // ndir * B
  constexpr int row_b = tc::row_bytes(kK);
  const uint32_t s_w = tc::smem_addr(smem);
  const uint32_t s_a = s_w + H * row_b;          // A [kM][kK]
  const uint32_t s_p = s_a + kM * row_b;         // partials [2][C][kM][kU]
  const float* part = reinterpret_cast<const float*>(smem + (s_p - s_w));
  const int part_buf = C * kM * kU;              // floats a buffer
  const int tid = threadIdx.x, l = tid & 31, wp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // the W slice, once
  const __nv_bfloat16* wsrc = wb + (static_cast<int64_t>(d) * C + c) * H * kK;
  for (int i = tid; i < H * (kK / 8); i += blockDim.x)
    tc::cp_async16(s_w + (i / (kK / 8)) * row_b + (i % (kK / 8)) * 16,
                   wsrc + static_cast<int64_t>(i) * 8, true);
  tc::cp_async_commit();
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
  // fragment addresses: A row l % 16 at k chunk l / 16; B rows (units) of
  // an n-tile at k chunks l / 8 of two k-steps
  const uint32_t a_base = s_a + (l & 15) * row_b + (l >> 4) * 16;
  const uint32_t b_off = (l & 7) * row_b + (l >> 3) * 16;

  struct In {
    float i, f, o, u, cp, c, g;
  };
  auto load_in = [&](int t) {
    In in = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (valid) {
      const int64_t row = static_cast<int64_t>(t) * R + rr;
      const __nv_bfloat16* gt = gates + row * G;
      in.i = __bfloat162float(gt[j]);
      in.f = __bfloat162float(gt[H + j]);
      in.o = __bfloat162float(gt[2 * H + j]);
      in.u = __bfloat162float(gt[3 * H + j]);
      in.cp = t > 0 ? cs[(row - R) * H + j] : 0.0f;
      in.c = cs[row * H + j];
      in.g = g[row * H + j];
    }
    return in;
  };
  auto store_dxs = [&](int t, const float (&dgv)[4], bool live) {
    if (!valid) return;
    __nv_bfloat16* dx = dxs + (static_cast<int64_t>(t) * R + rr) * G;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dx[q * H + j] = __float2bfloat16_rn(live ? dgv[q] : 0.0f);
  };

  float dh = 0.0f, dc = 0.0f;
  In in = load_in(T - 1);
  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    const float dh_total = in.g + dh;
    const float tc_ = tanhf(in.c);
    const float dog = dh_total * tc_ * in.o * (1.0f - in.o);
    const float dct = dc + dh_total * in.o * (1.0f - tc_ * tc_);
    const float dfg = dct * in.cp * in.f * (1.0f - in.f);
    const float dig = dct * in.u * in.i * (1.0f - in.i);
    const float dug = dct * in.i * (1.0f - in.u * in.u);
    const float ft = in.f;
    const float tf = static_cast<float>(t);
    const bool live = lo_r <= tf && tf < hi_r;
    const float dgv[4] = {dig, dfg, dog, dug};
    if (t == 0) {   // dh_prev of step 0 is not needed
      store_dxs(t, dgv, live);
      break;
    }
    in = load_in(t - 1);
    __nv_bfloat16* arow =
        reinterpret_cast<__nv_bfloat16*>(smem + (s_a - s_w) + r * row_b);
#pragma unroll
    for (int q = 0; q < 4; ++q) arow[q * kU + u] = __float2bfloat16_rn(dgv[q]);
    __syncthreads();

    uint32_t af[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) tc::ldsm_x4(a_base + kk * 32, af[kk]);
    const uint32_t s_dst = s_p + (cur * part_buf + c * kM * kU) * 4;
    for (int nt = wp; nt < H / 8; nt += n_warps) {
      uint32_t bf[kSteps / 2][4];
#pragma unroll
      for (int kp = 0; kp < kSteps / 2; ++kp)
        tc::ldsm_x4(s_w + nt * 8 * row_b + b_off + kp * 64, bf[kp]);
      // two accumulators (even and odd k-steps) halve the dependent chain
      float acc[2][4] = {};
#pragma unroll
      for (int kp = 0; kp < kSteps / 2; ++kp) {
        tc::mma(acc[0], af[2 * kp], bf[kp][0], bf[kp][1]);
        tc::mma(acc[1], af[2 * kp + 1], bf[kp][2], bf[kp][3]);
      }
      // units 8 nt + 2 (l % 4) + {0, 1} belong to block 8 nt / 32
      const int owner = nt / (kU / 8);
      const int col = (nt % (kU / 8)) * 8 + 2 * (l & 3);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        tc::st_cluster8(
            tc::map_rank(s_dst + (((l >> 2) + 8 * i) * kU + col) * 4, owner),
            acc[0][2 * i] + acc[1][2 * i], acc[0][2 * i + 1] + acc[1][2 * i + 1]);
    }
    tc::cluster_arrive();
    store_dxs(t, dgv, live);
    tc::cluster_wait();
    const float* p = part + cur * part_buf + r * kU + u;
    float dot = p[0];
    for (int src = 1; src < C; ++src) dot += p[src * kM * kU];
    if (live) {
      dh = dot;
      dc = dct * ft;
    } else {
      dh = dh_total;
    }
    cur ^= 1;
  }
}

// ---------------------------------------------------------------------------
// The bf16 backward past H = 512, W streamed (rnn_mma.cuh's streamed-W
// form; csr_lstm_bwd under bf16 compute).
//
// Clusters as lstm_bwd_tc_kernel's, with C = wide_cluster(H) blocks of U =
// wide_units(H) units (the last may own fewer) and 512 threads. The pairs
// (row p / U, unit p % U) of a block go to threads p, p + 512, ... (up to
// kPairs a thread), each keeping its dh and dc in registers. A step:
//   1. dg of the thread's pairs, from the prefetched inputs; the next
//      step's are loaded; the unmasked dg, rounded to bf16, into this
//      block's A [16][K] (column g U + u; K = wide_bwd_k(H, 4), its
//      padding and the columns of units past H stay zero);
//   2. the reduce-scatter's product A W_c^T -> [16][H] partial sums of dh:
//      warp w takes a contiguous range of the H / 32 n-groups (4 n8 tiles,
//      32 units j), each over the K / 16 k-steps, its B fragments streamed
//      from wb[d][c] = [H / 32][K / 16][4 tiles][32 lanes] uint2
//      (ops/rnn_cuda.py's wide_bwd_weights) kP k-steps ahead, across the
//      n-groups; a finished n-group's 16 x 32 sums go to their owners'
//      buffer slot for source c through DSMEM (an n8 tile never straddles
//      two owners: U % 8 == 0);
//   3. the cluster barrier (dxs stored between its halves), then each pair
//      adds its C partial sums in source order (bitwise repeatable) and
//      updates dh and dc as lstm_bwd_tc_kernel does;
//   4. with one partial-sum buffer (wide_bwd_bufs), a second cluster
//      barrier, so no block writes the next step's sums before every block
//      has read this step's.
template <int kP, int kPairs>
__global__ void __launch_bounds__(csr_rnn_mma::kWideBwdThreads, 1)
    lstm_bwd_wide_kernel(const __nv_bfloat16* __restrict__ gates,
                         const uint2* __restrict__ wb,
                         const float* __restrict__ lo,
                         const float* __restrict__ hi,
                         const float* __restrict__ cs,
                         const float* __restrict__ g,
                         __nv_bfloat16* __restrict__ dxs, int T, int B,
                         int H) {
  namespace tc = csr_rnn_mma;
  constexpr int kM = tc::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(tc::cluster_nctarank());
  const int c = static_cast<int>(tc::cluster_ctarank());
  const int U = tc::wide_units(H), K = tc::wide_bwd_k(H, 4), KS = K / 16;
  const int NG = H / 32;                         // n-groups of the product
  const int G = 4 * H;
  const int d = blockIdx.y, group = blockIdx.x / C;
  const int R = gridDim.y * B;   // ndir * B
  const int row_b = tc::row_bytes(K);
  const int bufs = tc::wide_bwd_bufs(H, 4);
  const uint32_t s_a = tc::smem_addr(smem);      // A [kM][K]
  const uint32_t s_p = s_a + kM * row_b;         // partials [bufs][C][kM][U]
  const float* part = reinterpret_cast<const float*>(smem + kM * row_b);
  const int part_buf = C * kM * U;               // floats a buffer
  const int tid = threadIdx.x, l = tid & 31, wp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int u0 = c * U, uc = min(U, H - u0);     // this block's units

  tc::zero_shared(smem, kM * row_b);
  __syncthreads();
  tc::cluster_sync();   // every peer has started before DSMEM stores

  // this thread's pairs
  bool has[kPairs], valid[kPairs];
  int pr[kPairs], pu[kPairs], rr[kPairs];
  float lo_r[kPairs], hi_r[kPairs], dh[kPairs], dc[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int p = tid + q * blockDim.x;
    pr[q] = p / U;
    pu[q] = p % U;
    has[q] = p < kM * U && pu[q] < uc;
    const int b = group * kM + pr[q];
    valid[q] = has[q] && b < B;
    rr[q] = d * B + b;
    lo_r[q] = valid[q] ? lo[rr[q]] : 0.0f;
    hi_r[q] = valid[q] ? hi[rr[q]] : 0.0f;   // never live
    dh[q] = 0.0f;
    dc[q] = 0.0f;
  }
  struct In {
    float i, f, o, u, cp, c, g;
  };
  auto load_in = [&](int t, int q) {
    In in = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (valid[q]) {
      const int64_t row = static_cast<int64_t>(t) * R + rr[q];
      const int j = u0 + pu[q];
      const __nv_bfloat16* gt = gates + row * G + j;
      in.i = __bfloat162float(gt[0]);
      in.f = __bfloat162float(gt[H]);
      in.o = __bfloat162float(gt[2 * H]);
      in.u = __bfloat162float(gt[3 * H]);
      in.cp = t > 0 ? cs[(row - R) * H + j] : 0.0f;
      in.c = cs[row * H + j];
      in.g = g[row * H + j];
    }
    return in;
  };
  // this warp's n-groups [ng0, ng1) and their fragments
  const int ng0 = wp * NG / n_warps, ng1 = (wp + 1) * NG / n_warps;
  const uint2* wsrc =
      wb + ((static_cast<int64_t>(d) * C + c) * NG + ng0) * KS * 4 * 32 + l;
  const uint32_t a_lane = s_a + (l & 15) * row_b + (l >> 4) * 16;

  const int n = (ng1 - ng0) * KS;   // this warp's k-steps a step
  uint2 b[kP][4];                   // its B fragments in flight
  tc::stream_prefetch<4, kP>(wsrc, n, b);
  In in[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) in[q] = load_in(T - 1, q);
  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    const float tf = static_cast<float>(t);
    float dgv[kPairs][4], dct[kPairs], ft[kPairs], dht[kPairs];
    bool live[kPairs];
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const float dh_total = in[q].g + dh[q];
      const float tc_ = tanhf(in[q].c);
      dgv[q][2] = dh_total * tc_ * in[q].o * (1.0f - in[q].o);
      dct[q] = dc[q] + dh_total * in[q].o * (1.0f - tc_ * tc_);
      dgv[q][1] = dct[q] * in[q].cp * in[q].f * (1.0f - in[q].f);
      dgv[q][0] = dct[q] * in[q].u * in[q].i * (1.0f - in[q].i);
      dgv[q][3] = dct[q] * in[q].i * (1.0f - in[q].u * in[q].u);
      ft[q] = in[q].f;
      dht[q] = dh_total;
      live[q] = lo_r[q] <= tf && tf < hi_r[q];
    }
    auto store_dxs = [&]() {
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        if (!valid[q]) continue;
        __nv_bfloat16* dx =
            dxs + (static_cast<int64_t>(t) * R + rr[q]) * G + u0 + pu[q];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dx[k * H] = __float2bfloat16_rn(live[q] ? dgv[q][k] : 0.0f);
      }
    };
    if (t == 0) {   // dh_prev of step 0 is not needed
      store_dxs();
      break;
    }
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      in[q] = load_in(t - 1, q);
      if (has[q]) {
        __nv_bfloat16* arow = reinterpret_cast<__nv_bfloat16*>(
            smem + pr[q] * row_b);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          arow[k * U + pu[q]] = __float2bfloat16_rn(dgv[q][k]);
      }
    }
    __syncthreads();

    // the product over this warp's n-groups, fragments kP k-steps ahead
    {
      const uint32_t s_dst = s_p + (cur * part_buf + c * kM * U) * 4;
      float acc[4][4] = {};
      int ks = 0, ng = ng0;
      for (int s0 = 0; s0 < n; s0 += kP) {
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const int st = s0 + p;
          if (st < n) {
            uint32_t a[4];
            tc::ldsm_x4(a_lane + ks * 32, a);
#pragma unroll
            for (int q = 0; q < 4; ++q) tc::mma(acc[q], a, b[p][q].x, b[p][q].y);
            if (st + kP < n)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                b[p][q] = __ldg(wsrc + ((st + kP) * 4 + q) * 32);
            if (++ks == KS) {
              // the n-group's 16 x 32 sums to their owners: tile q holds
              // units 32 ng + 8 q + 2 (l % 4) + {0, 1} of rows l / 4 (+ 8)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int j0 = 32 * ng + 8 * q;
                const int owner = j0 / U;
                const int col = j0 - owner * U + 2 * (l & 3);
#pragma unroll
                for (int i = 0; i < 2; ++i)
                  tc::st_cluster8(
                      tc::map_rank(s_dst + (((l >> 2) + 8 * i) * U + col) * 4,
                                   owner),
                      acc[q][2 * i], acc[q][2 * i + 1]);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
              }
              ks = 0;
              ++ng;
            }
          }
        }
      }
      // the next step's first fragments (W is the same at every step), in
      // flight over the barrier and the reduction
      if (t > 1) tc::stream_prefetch<4, kP>(wsrc, n, b);
    }
    tc::cluster_arrive();
    store_dxs();
    tc::cluster_wait();
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      if (!has[q]) continue;
      const float* p = part + cur * part_buf + pr[q] * U + pu[q];
      float dot = p[0];
      for (int src = 1; src < C; ++src) dot += p[src * kM * U];
      if (live[q]) {
        dh[q] = dot;
        dc[q] = dct[q] * ft[q];
      } else {
        dh[q] = dht[q];
      }
    }
    if (bufs == 2)
      cur ^= 1;
    else
      tc::cluster_sync();
  }
}


int launch_wide(const void* gates, const void* wb, const float* lo,
                const float* hi, const float* cs, const float* g, void* dxs,
                int T, int B, int H, int ndir, int C, cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  if (C != tc::wide_cluster(H)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kP = tc::wide_prefetch(tc::kWideBwdThreads);
  auto kernel = tc::wide_pairs(H) == 2 ? lstm_bwd_wide_kernel<kP, 2>
                                       : lstm_bwd_wide_kernel<kP, 4>;
  return tc::launch_clusters(
      kernel, C, (B + tc::kRows - 1) / tc::kRows, ndir, tc::kWideBwdThreads,
      tc::wide_bwd_smem(H, 4), stream,
      static_cast<const __nv_bfloat16*>(gates),
      static_cast<const uint2*>(wb), lo, hi, cs, g,
      static_cast<__nv_bfloat16*>(dxs), T, B, H);
}

}  // namespace

// gates [T, ndir*B, 4H], dxs [T, ndir*B, 4H] and the weights all fp32 (the
// FMA kernel: wtq [ndir, H, H, 4]) or, when bf16 != 0, all bf16 (the
// cluster kernel: wb [ndir, C, H, 4, 32], C = H / 32 blocks a cluster,
// ops/rnn_cuda.py's lstm_plan; past H = 512 the streamed-W fragments
// [ndir, C, H/32, K/16, 4, 32, 4], C = wide_cluster(H),
// rnn_cuda.wide_bwd_weights; unread under fp32); lo/hi [ndir*B], cs and g
// [T, ndir*B, H] fp32. Requires 32 <= H <= 2048, H % 32 == 0, T >= 1,
// B >= 1, ndir 1 or 2 (the wrapper checks).
CSR_API int csr_lstm_bwd(const void* gates, const void* wtq, const float* lo,
                         const float* hi, const float* cs, const float* g,
                         void* dxs, int T, int B, int H, int ndir, int C,
                         int bf16, cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  if (ndir != 1 && ndir != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (!bf16)
    return launch_fp32(gates, wtq, lo, hi, cs, g, dxs, T, B, H, ndir,
                       stream);
  if (H > tc::kResidentMax)
    return launch_wide(gates, wtq, lo, hi, cs, g, dxs, T, B, H, ndir, C,
                       stream);
  if (C * tc::kUnits != H) return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_clusters(
      lstm_bwd_tc_kernel, C, (B + tc::kRows - 1) / tc::kRows, ndir,
      tc::kRows * tc::kUnits, tc::bwd_smem(H), stream,
      static_cast<const __nv_bfloat16*>(gates),
      static_cast<const __nv_bfloat16*>(wtq), lo, hi, cs, g,
      static_cast<__nv_bfloat16*>(dxs), T, B, H);
}

// The cluster backward's plan as the card takes it: out[0] = its shared
// memory bytes at hidden size H (C = H / 32 blocks), out[1] = how many of
// its clusters the card holds at once (cudaOccupancyMaxActiveClusters; 0:
// it cannot launch).
CSR_API int csr_lstm_bwd_occupancy(int H, int* out) {
  namespace tc = csr_rnn_mma;
  if (H > tc::kResidentMax) {
    out[0] = tc::wide_bwd_smem(H, 4);
    constexpr int kP = tc::wide_prefetch(tc::kWideBwdThreads);
    auto kernel = tc::wide_pairs(H) == 2 ? lstm_bwd_wide_kernel<kP, 2>
                                         : lstm_bwd_wide_kernel<kP, 4>;
    return tc::max_clusters(kernel, tc::wide_cluster(H), tc::kWideBwdThreads,
                            out[0], out + 1);
  }
  out[0] = tc::bwd_smem(H);
  return tc::max_clusters(lstm_bwd_tc_kernel, H / tc::kUnits,
                          tc::kRows * tc::kUnits, out[0], out + 1);
}
