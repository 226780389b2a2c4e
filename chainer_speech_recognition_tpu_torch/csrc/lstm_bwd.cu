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
// Three kernels: under bf16 compute (the presets' path) the step product
// runs on the tensor cores, up to H = 512 on a thread-block cluster that
// keeps W resident in its shared memory (lstm_bwd_tc_kernel, below), above
// as one persistent cooperative launch over the whole card
// (lstm_bwd_persist_kernel, further below); under fp32 the FMA kernel
// (lstm_bwd_kernel).
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
// The bf16 backward past H = 512: the persistent form (rnn_mma.cuh;
// csr_lstm_bwd under bf16 compute).
//
// What bounds it on Hopper: a step multiplies every row's dg [4H] by Wᵀ,
// all of the direction's W (4 H^2 bf16: 8.4 MB at H = 1024, 33.6 MB at
// 2048), one step after another. The clustered form that came before read
// W from L2 once per 16-row group at every step on one 16-SM cluster per
// group and direction, and scattered [16 x H] fp32 partial sums of dh
// between its blocks over DSMEM (131 KB a block a step at 2048, with a
// second cluster barrier where two buffers did not fit): 14.4 µs a step at
// H = 1024 and 54.2 at 2048, against cuDNN's 13.0 and 32.9.
//
// What this design does about it: each block owns output units of dh_prev
// and computes them whole. Block (d, cb) owns nt n8 tiles of units j: the
// rows W[j, :] over all 4H gate columns, its B operand (B[k][j] = W[j][k],
// k-major over K = 4H / 16 k-steps), laid out by the wrapper in fragment
// order, wb[d][cb] = [K][nt][32 lanes] uint2 (ops/rnn_cuda.py's
// persist_bwd_weights), kept in shared memory as far as it fits (at H =
// 1024 all 131 KB a block; at 2048 each warp keeps its first kr k-steps and
// reads the rest from L2 at each step). The block also owns the same units'
// gate math: it keeps their carried dc and dh_total (in registers with one
// pass of one group, else in a global scratch that only the owning thread
// reads and writes) and publishes their dg. On a card of fewer than ndir
// H / 32 SMs a block owns more than kGroupTiles tiles and runs them as
// groups of NT (rnn_mma.cuh), steps 1-2 once a group in turn, one slot a
// thread a group. A step t, for each pass of 32 rows:
//   1. (t < T - 1) the product: warp w of eight multiplies the pass's dg of
//      step t + 1 (bf16, where _dot2 rounds it; A fragments from the global
//      buffer, one 16- or 8-byte load a lane) by the block's columns over its
//      eighth of the K k-steps, each B fragment feeding both m16 tiles;
//      the eighths meet in shared memory and a slot (m-tile, tile, lane)
//      adds them in warp order: dh_prev of its two rows and two units, in
//      a fixed order, with no atomics and no partial sums between blocks
//      (bitwise repeatable);
//   2. the slot's dh (dh_prev where step t + 1 was live, else the carried
//      dh_total) and dc, and its dg = (di, df, do, du) from gates, c_t,
//      c_{t-1} and g; dxs = dg masked to the live steps; the unmasked dg,
//      rounded to bf16, into the next A buffer (two, by step parity). With
//      one pass of one group (B <= 32) dc and dh_total stay in registers
//      and the next step's inputs are loaded during the barrier;
//   3. one grid barrier (rnn_mma.cuh's grid_arrive / grid_wait).
// Measured on an H100 (tools/kernel_ab.py --cases rnn_wide, against this
// build and copies of it with a part of the step left out; PERF.md): at
// H = 1024 the slice is resident and the product (77% of a step) is held
// by the latency of its A loads from L2 (256 KB a block a step, each
// warp's ring as deep as the registers allow; with A from shared memory
// the step would take 0.60 of its time, with half the A bytes 0.95,
// without the mma.sync chain 0.88); at 2048, ndir 2,
// 60% of W is read from L2 at each step, prefetched into L2 two rings
// ahead (6% of the step; 17% more without the prefetch).
// The launch is cooperative (rnn_mma.cuh's launch_cooperative): all NB ndir
// <= sms blocks are resident, or it fails.
constexpr int kBwdWarps = 8;   // warps a block of the persistent form

// a slot's inputs at one step, for its two rows and two units: the gates
// (i, f, o, u) as bf16 pairs, c_t, c_{t-1} and the gradient of ys, and the
// rows' lo and hi
struct LstmIn {
  uint32_t q[2][4];
  float2 c[2], cp[2], g[2];
  float lo[2], hi[2];
};

template <int NT, int P, bool kSt>
__global__ void __launch_bounds__(32 * kBwdWarps, 1)
    lstm_bwd_persist_kernel(const __nv_bfloat16* __restrict__ gates,
                            const uint2* __restrict__ wb,
                            const float* __restrict__ lo,
                            const float* __restrict__ hi,
                            const float* __restrict__ cs,
                            const float* __restrict__ g,
                            __nv_bfloat16* __restrict__ dxs,
                            unsigned int* counter, uint4* abuf, float* held,
                            int T, int B, int H, int NB, int tiles,
                            int groups, int kr) {
  namespace tc = csr_rnn_mma;
  // NT: tiles a group (nw8); the block's `tiles` run as `groups` of them
  constexpr int NC = NT, kW = kBwdWarps;
  static_assert(2 * NT * 32 <= 32 * kW, "one slot a thread a group");
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);
  unsigned char* res = smem + tc::persist_part(NC, kW);
  const int ndir = gridDim.x / NB;
  const int d = blockIdx.x / NB, cb = blockIdx.x % NB;
  const int R = ndir * B, G = 4 * H, K = H / 4, nt_all = H / 8;
  const int passes = (B + tc::kPassRows - 1) / tc::kPassRows;
  // one pass of one group: the slot's carried dc and dh_total and its next
  // inputs stay in registers; more: dc and dh_total go through the global
  // scratch
  const bool two = B > 16, hold = passes == 1 && groups == 1;
  const int tid = threadIdx.x, l = tid & 31, w = tid >> 5;
  const uint2* slice = wb + int64_t(d * NB + cb) * groups * K * NC * 32;
  // A (dg) of direction d, pass p, m-tile m in buffer buf: [2][ndir]
  // [passes][2][K][32] uint4
  auto a_of = [&](int buf, int p, int m) {
    return abuf + (int64_t((buf * ndir + d) * passes + p) * 2 + m) * K * 32;
  };
  // what a slot carries past its step: dc and dh_total, [R][H] fp32 each
  float* dc_held = held;
  float* dh_held = held + int64_t(R) * H;
  tc::load_resident(tc::smem_addr(res), slice, kW, K, kr, NC, groups);
  __syncthreads();
  const tc::WarpSteps ws = tc::warp_steps(w, kW, K, kr, cb, NB);
  // group 0's resident fragments of this warp's lane (a shared-space
  // address) and its streamed ones (group g's kW kr NC 256 bytes and K NC
  // 32 uint2 further on)
  const uint32_t sb = tc::smem_addr(res) + (w * kr * NC * 32 + l) * 8;
  const uint2* gb = slice + int64_t(ws.kb) * NC * 32 + l;
  // this thread's slot of each group: m-tile m, its tile's lane ls, its
  // tile in the group, unit j of group g (the pair j, j + 1); `own`: a
  // slot of this launch's rows, of one of the block's tiles and of a unit
  // below H
  const int m = tid / (NT * 32), ls = tid & 31, tile = (tid / 32) % NT;
  // (of a block of nt tiles: the plan's, or NT where a block runs one
  // group)
  auto unit_of = [&](int gr, int nt) {
    return 8 * (cb * nt + gr * NT + tile) + 2 * (ls & 3);
  };
  auto own_of = [&](int gr, int nt) {
    return tid < (two ? 2 : 1) * NT * 32 && gr * NT + tile < nt &&
           cb * nt + gr * NT + tile < nt_all;
  };
  auto row_of = [&](int p, int i) {
    return p * tc::kPassRows + 16 * m + (ls >> 2) + 8 * i;
  };
  auto load_in = [&](int t, int p, int j) {
    LstmIn in;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = row_of(p, i);
      const bool valid = b < B;
      const int64_t rr = int64_t(d) * B + b, row = int64_t(t) * R + rr;
      const float2 z = make_float2(0.0f, 0.0f);
      in.lo[i] = valid ? lo[rr] : 0.0f;   // rows past B: never live
      in.hi[i] = valid ? hi[rr] : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        in.q[i][k] = valid ? *reinterpret_cast<const uint32_t*>(
                                 gates + row * G + k * H + j)
                           : 0u;
      in.c[i] = valid ? *reinterpret_cast<const float2*>(cs + row * H + j)
                      : z;
      in.cp[i] = valid && t > 0 ? *reinterpret_cast<const float2*>(
                                      cs + (row - R) * H + j)
                                : z;
      in.g[i] = valid ? *reinterpret_cast<const float2*>(g + row * H + j)
                      : z;
    }
    return in;
  };
  LstmIn next;
  float2 dc_reg[2], dh_reg[2];
  if (hold && own_of(0, NT)) next = load_in(T - 1, 0, unit_of(0, NT));
  unsigned int barriers = 0;

  // group gr's share of step t, pass p: its product, then its slots'
  // gate math (a copy for one group a block, one for more: OneGroup,
  // Groups)
  auto group_step = [&](auto tag, int t, int p, int gr) {
    const bool keep = decltype(tag)::one && hold;
    const int nt = decltype(tag)::one ? NT : tiles;   // NT: nt of one group
    // the many-group copy's ring one k-step shallower, for fewer
    // registers in that copy
    constexpr int kP = decltype(tag)::one || P < 2 ? P : P - 1;
    const bool product = t < T - 1;
    const float tf = static_cast<float>(t);
    if (product) {
      const int rp = B - p * tc::kPassRows;   // rows of the pass (> 0)
      float acc[2][NC][4] = {};
      tc::persist_product<NC, kP, kSt>(
          acc, a_of((t + 1) & 1, p, 0) + ws.kb * 32 + l,
          a_of((t + 1) & 1, p, 1) + ws.kb * 32 + l, two, rp > 8, rp > 24,
          ws.kw, ws.kres, ws.rot, sb + gr * kW * kr * NC * 256,
          gb + int64_t(gr) * K * NC * 32);
      tc::store_partials<NC>(part, acc, two, w, l);
    }
    __syncthreads();
    if (own_of(gr, nt)) {
      const int j = unit_of(gr, nt);
      const float4 dhp = product
                             ? tc::sum_partials(part, kW, NC, m, tile, ls)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const LstmIn in = keep ? next : load_in(t, p, j);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = row_of(p, i);
        const bool valid = b < B;
        const int64_t rr = int64_t(d) * B + b;
        const int64_t row = int64_t(t) * R + rr;
        const bool live = in.lo[i] <= tf && tf < in.hi[i];
        const bool live_next =
            product && in.lo[i] <= tf + 1.0f && tf + 1.0f < in.hi[i];
        // dc and dh from step t + 1 (0 at t = T - 1): dh = dh_prev where
        // that step was live, else its dh_total passes through
        float2 dc = make_float2(0.0f, 0.0f), dh = dc;
        if (product && (keep || valid)) {
          dc = keep ? dc_reg[i]
                    : *reinterpret_cast<const float2*>(dc_held + rr * H + j);
          dh = live_next ? (i ? make_float2(dhp.z, dhp.w)
                              : make_float2(dhp.x, dhp.y))
               : keep    ? dh_reg[i]
                         : *reinterpret_cast<const float2*>(dh_held +
                                                            rr * H + j);
        }
        float dg[4][2], dc_next[2], dh_total[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float q[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&in.q[i][k]));
            q[k] = e ? v.y : v.x;
          }
          const float ig = q[0], fg = q[1], og = q[2], ug = q[3];
          const float dht = (e ? in.g[i].y : in.g[i].x) + (e ? dh.y : dh.x);
          const float tc_ = tanhf(e ? in.c[i].y : in.c[i].x);
          const float dcv = e ? dc.y : dc.x;
          dg[2][e] = dht * tc_ * og * (1.0f - og);
          const float dct = dcv + dht * og * (1.0f - tc_ * tc_);
          dg[1][e] = dct * (e ? in.cp[i].y : in.cp[i].x) * fg * (1.0f - fg);
          dg[0][e] = dct * ug * ig * (1.0f - ig);
          dg[3][e] = dct * ig * (1.0f - ug * ug);
          dc_next[e] = live ? dct * fg : dcv;
          dh_total[e] = dht;
        }
        if (t > 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            *tc::a_word(a_of(t & 1, p, m), k * H + j, i, ls) =
                tc::bf16x2(dg[k][0], dg[k][1]);
          if (keep) {
            dc_reg[i] = make_float2(dc_next[0], dc_next[1]);
            dh_reg[i] = make_float2(dh_total[0], dh_total[1]);
          } else if (valid) {
            *reinterpret_cast<float2*>(dc_held + rr * H + j) =
                make_float2(dc_next[0], dc_next[1]);
            *reinterpret_cast<float2*>(dh_held + rr * H + j) =
                make_float2(dh_total[0], dh_total[1]);
          }
        }
        if (valid)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            *reinterpret_cast<uint32_t*>(dxs + row * G + k * H + j) =
                tc::bf16x2(live ? dg[k][0] : 0.0f, live ? dg[k][1] : 0.0f);
      }
    }
    __syncthreads();
  };
  // the T steps, in a loop of their own for each copy, so that what one
  // copy keeps in registers across its steps does not crowd the other
  auto run = [&](auto tag) {
    for (int t = T - 1; t >= 0; --t) {
      for (int p = 0; p < passes; ++p) {
        if constexpr (decltype(tag)::one)
          group_step(tag, t, p, 0);
        else
          for (int gr = 0; gr < groups; ++gr) group_step(tag, t, p, gr);
      }
      if (t > 0) {
        tc::grid_arrive(counter);
        // the next step's inputs, in flight over the wait and the product
        if (decltype(tag)::one && hold && own_of(0, NT))
          next = load_in(t - 1, 0, unit_of(0, NT));
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

// the persistent backward's plan on a card of `sms` SMs (ops/rnn_cuda.py's
// persist_plan("lstm_bwd", ...))
csr_rnn_mma::PersistPlan bwd_persist_plan(int H, int ndir, int B,
                                          int sms) {
  return csr_rnn_mma::persist_plan(H, ndir, B, sms, 1, H / 4, kBwdWarps,
                                   2);
}

// the persistent kernel of groups of p.width tiles (the slice may not fit
// shared memory past one tile; a block of more than one group has groups
// of three or four)
template <typename Fn>
int with_persist_kernel(const csr_rnn_mma::PersistPlan& p, Fn&& fn) {
  static_assert(csr_rnn_mma::kGroupTiles == 4, "a kernel a group width");
  const bool resident = p.resident * kBwdWarps >= p.ksteps;
  switch (p.width) {
    case 1:
      return fn(lstm_bwd_persist_kernel<1, 12, false>);
    case 2:
      return resident ? fn(lstm_bwd_persist_kernel<2, 10, false>)
                      : fn(lstm_bwd_persist_kernel<2, 8, true>);
    case 3:
      return fn(lstm_bwd_persist_kernel<3, 6, true>);
    case 4:
      return fn(lstm_bwd_persist_kernel<4, 6, true>);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C: the blocks a direction; sms: the SM count the plan was made for;
// work: the workspace of the plan's bytes (rnn_mma.cuh's PersistPlan)
int launch_persist(const void* gates, const void* wb, const float* lo,
                   const float* hi, const float* cs, const float* g,
                   void* dxs, void* work, int T, int B, int H, int ndir,
                   int C, int sms, cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  const cudaError_t e = tc::check_sms(sms, ndir);
  if (e != cudaSuccess) return static_cast<int>(e);
  const tc::PersistPlan p = bwd_persist_plan(H, ndir, B, sms);
  if (C != p.blocks || work == nullptr ||
      (p.width == 1 && p.resident * kBwdWarps < H / 4))
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(work);
  unsigned int* counter = reinterpret_cast<unsigned int*>(base);
  uint4* abuf = reinterpret_cast<uint4*>(base + 256);
  float* held = reinterpret_cast<float*>(base + p.held);
  return with_persist_kernel(p, [&](auto kernel) {
    return tc::launch_cooperative(
        kernel, p.blocks * ndir, 32 * kBwdWarps, p.smem, stream, counter,
        static_cast<const __nv_bfloat16*>(gates),
        static_cast<const uint2*>(wb), lo, hi, cs, g,
        static_cast<__nv_bfloat16*>(dxs), counter, abuf, held, T, B, H,
        p.blocks, p.tiles, p.groups, p.resident);
  });
}

}  // namespace

// gates [T, ndir*B, 4H], dxs [T, ndir*B, 4H] and the weights all fp32 (the
// FMA kernel: wtq [ndir, H, H, 4]) or, when bf16 != 0, all bf16 (the
// cluster kernel: wb [ndir, C, H, 4, 32], C = H / 32 blocks a cluster,
// ops/rnn_cuda.py's lstm_plan; past H = 512 the persistent form's
// fragments [ndir, C, ng·H/4, nw8, 32, 4], C its blocks a direction, on a
// card of `sms` SMs, rnn_cuda.persist_bwd_weights; unread under fp32);
// lo/hi [ndir*B], cs and g [T, ndir*B, H] fp32; work the persistent form's
// workspace (csr_lstm_bwd_persist_plan's bytes; unread elsewhere); sms the
// SM count the persistent plan was made for (ndir <= sms <= the card's;
// unread elsewhere). Requires 32 <= H <= 2048, H % 32 == 0, T >= 1, B >=
// 1, ndir 1 or 2 (the wrapper checks).
CSR_API int csr_lstm_bwd(const void* gates, const void* wtq, const float* lo,
                         const float* hi, const float* cs, const float* g,
                         void* dxs, void* work, int T, int B, int H, int ndir,
                         int C, int sms, int bf16, cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  if (ndir != 1 && ndir != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (!bf16)
    return launch_fp32(gates, wtq, lo, hi, cs, g, dxs, T, B, H, ndir,
                       stream);
  if (H > tc::kResidentMax)
    return launch_persist(gates, wtq, lo, hi, cs, g, dxs, work, T, B, H,
                          ndir, C, sms, stream);
  if (C * tc::kUnits != H) return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_clusters(
      lstm_bwd_tc_kernel, C, (B + tc::kRows - 1) / tc::kRows, ndir,
      tc::kRows * tc::kUnits, tc::bwd_smem(H), stream,
      static_cast<const __nv_bfloat16*>(gates),
      static_cast<const __nv_bfloat16*>(wtq), lo, hi, cs, g,
      static_cast<__nv_bfloat16*>(dxs), T, B, H);
}

// The cluster backward's plan as the card takes it (H <= 512): out[0] =
// its shared memory bytes at hidden size H (C = H / 32 blocks), out[1] =
// how many of its clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot launch). Past H = 512 see
// csr_lstm_bwd_persist_plan.
CSR_API int csr_lstm_bwd_occupancy(int H, int* out) {
  namespace tc = csr_rnn_mma;
  if (H > tc::kResidentMax) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = tc::bwd_smem(H);
  return tc::max_clusters(lstm_bwd_tc_kernel, H / tc::kUnits,
                          tc::kRows * tc::kUnits, out[0], out + 1);
}

// The persistent backward's plan as the card takes it at hidden size H >
// 512, ndir directions, B rows a direction and `sms` SMs
// (rnn_mma.cuh's report_plan; out: 8 int64; A is read from L2, so a
// slot's k-steps are 0). cudaErrorInvalidValue where sms is below ndir
// or above the card's.
CSR_API int csr_lstm_bwd_persist_plan(int H, int ndir, int B, int sms,
                                      long long* out) {
  namespace tc = csr_rnn_mma;
  const cudaError_t e = tc::check_sms(sms, ndir);
  if (e != cudaSuccess) return static_cast<int>(e);
  const tc::PersistPlan p = bwd_persist_plan(H, ndir, B, sms);
  return with_persist_kernel(p, [&](auto kernel) {
    return tc::report_plan(p, kernel, 32 * kBwdWarps, out);
  });
}
