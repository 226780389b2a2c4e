// GRU recurrence (bidirectional or forward-only), backward (reverse-time
// gradient walk).
//
// Replaces ops/rnn_pallas.py::_gru_bwd_kernel (the custom VJP's backward,
// _birnn_bwd). Same boundary: gates [T, R=ndir*B, 4H] = (r, z, n, hp_n) from
// the training forward (csrc/gru_fwd.cu, stream dtype), the recurrent
// weights in the compute dtype (laid out for each kernel by the wrapper,
// once per call: below), lo/hi [R] fp32, ys [T, R, H] fp32 (the
// forward's carries: h_prev[t] is read as ys[t - 1], zeros at t = 0, so no
// shifted copy is made) and g [T, R, H] fp32 (the gradient of the layer's
// ys). Out, in the stream dtype:
//   dxs [T, R, 3H] = (dr, dz, dn) pre-activation gradients, masked to the
//                    live steps; they are the gradient of xs and, for the
//                    r and z columns, of the recurrent pre-activations;
//   dhn [T, R, H]  = the recurrent n pre-activation gradient dn * r, masked.
// Rows [d*B, (d+1)*B) use w[d]: ndir = 2 for a bidirectional layer, 1 for a
// forward-only one, which runs its one W over its B rows (the TPU path
// runs a forward-only layer with W duplicated, two halves of B rows whose
// dW autodiff sums; the forward rows' gradients are the same).
// dW = sum_t h_prev^T (dr, dz, dhn) is one launch of csrc/dw.cu after the
// kernel, off the sequential path, as the TPU kernel leaves it to XLA.
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
// Three kernels: under bf16 compute (the presets' path) a thread-block
// cluster runs the step product on the tensor cores, with W resident in
// its shared memory up to H = 512 (gru_bwd_tc_kernel, below) and streamed
// from global memory above (gru_bwd_wide_kernel, further below); under
// fp32 the FMA kernel (gru_bwd_kernel).
//
// The FMA kernel: the forward's, turned around. Rows are independent
// given W, so one block owns one row of one direction and walks T
// backwards; thread j owns hidden unit j and keeps its dh in a register.
// The row's (dr, dz, dn r) vector goes to shared memory (double-buffered:
// one barrier a step) and each thread then reduces it against column j of
// W^T, i.e. row j of wt[d], streaming wt from L2 in register chunks whose
// next loads are issued before the current FMAs (reads coalesced across j,
// which is why the wrapper passes W transposed: W's own row j is strided
// by 3H across a warp). The chunk is 96 rows at H <= 256: a sweep of chunk
// sizes on an H100 at B=24, T'=256 found the larger chunks faster up to
// 96. The product keeps four partial sums (the lanes of a float4), so its
// 3H FMAs form four dependent chains instead of one (~5% faster in
// chip_smoke.py's profiled training steps on an NVIDIA H100 80GB HBM3,
// 700 W). The next step's gates, h_prev and g are loaded before the
// product, so their latency hides behind it. Past H = 512 a thread owns
// kUPT = 2 (H <= 1024) or 4 units, one after the other. Bounds: 32 <= H
// <= 2048, H % 32 == 0, any B.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "rnn_common.cuh"
#include "rnn_mma.cuh"

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

// (h_prev is ys one step back: row - R, zero in step 0's rows)
template <typename S>
__device__ __forceinline__ StepIn load_step(const S* __restrict__ gates,
                                            const float* __restrict__ ys,
                                            const float* __restrict__ g,
                                            int64_t row, int R, int H,
                                            int j) {
  const S* gt = gates + row * 4 * H;
  StepIn in;
  in.r = to_f32(gt[j]);
  in.z = to_f32(gt[H + j]);
  in.n = to_f32(gt[2 * H + j]);
  in.hn = to_f32(gt[3 * H + j]);
  in.hp = row >= R ? ys[(row - R) * H + j] : 0.0f;
  in.g = g[row * H + j];
  return in;
}

template <typename S, int kChunk, int kMaxThreads, int kUPT>
__global__ void __launch_bounds__(kMaxThreads)
    gru_bwd_kernel(const S* __restrict__ gates,
                               const S* __restrict__ wt,
                               const float* __restrict__ lo,
                               const float* __restrict__ hi,
                               const float* __restrict__ ys,
                               const float* __restrict__ g,
                               S* __restrict__ dxs, S* __restrict__ dhn,
                               int T, int B, int H) {
  extern __shared__ float dp[];  // [2][3H] compute-dtype (dr, dz, dn r)
  const int d = blockIdx.y;      // direction
  const int b = blockIdx.x;      // row within the direction
  const int R = gridDim.y * B;   // ndir * B
  const int G = 3 * H;
  const int rr = d * B + b;
  const S* wd = wt + static_cast<int64_t>(d) * G * H;
  const float lo_r = lo[rr];
  const float hi_r = hi[rr];

  // thread's hidden units: j = threadIdx.x + q blockDim.x, q < kUPT
  // (blockDim.x = H / kUPT)
  float dh[kUPT];
  StepIn in[kUPT];
#pragma unroll
  for (int q = 0; q < kUPT; ++q) {
    dh[q] = 0.0f;
    in[q] = load_step(gates, ys, g, static_cast<int64_t>(T - 1) * R + rr, R,
                      H, threadIdx.x + q * blockDim.x);
  }
  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    const int64_t row = static_cast<int64_t>(t) * R + rr;
    const float tf = static_cast<float>(t);
    const bool live = lo_r <= tf && tf < hi_r;
    float* buf = dp + cur * G;
    float dht[kUPT], zt[kUPT];
#pragma unroll
    for (int q = 0; q < kUPT; ++q) {
      const int j = threadIdx.x + q * blockDim.x;
      const float dh_total = in[q].g + dh[q];
      const float dz = dh_total * (in[q].hp - in[q].n) * in[q].z *
                       (1.0f - in[q].z);
      const float dn = dh_total * (1.0f - in[q].z) *
                       (1.0f - in[q].n * in[q].n);
      const float dr = dn * in[q].hn * in[q].r * (1.0f - in[q].r);
      const float dhn_j = dn * in[q].r;
      zt[q] = in[q].z;
      dht[q] = dh_total;
      S* dx = dxs + row * G;
      dx[j] = from_f32<S>(live ? dr : 0.0f);
      dx[H + j] = from_f32<S>(live ? dz : 0.0f);
      dx[2 * H + j] = from_f32<S>(live ? dn : 0.0f);
      dhn[row * H + j] = from_f32<S>(live ? dhn_j : 0.0f);
      buf[j] = to_f32(from_f32<S>(dr));
      buf[H + j] = to_f32(from_f32<S>(dz));
      buf[2 * H + j] = to_f32(from_f32<S>(dhn_j));
    }
    __syncthreads();
    if (t > 0)
#pragma unroll
      for (int q = 0; q < kUPT; ++q)
        in[q] = load_step(gates, ys, g, row - R, R, H,
                          threadIdx.x + q * blockDim.x);

#pragma unroll
    for (int q = 0; q < kUPT; ++q) {
      const int j = threadIdx.x + q * blockDim.x;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // 4 partial sums
      S w[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        w[u] = wd[static_cast<int64_t>(u) * H + j];
      for (int k0 = 0; k0 < G; k0 += kChunk) {
        S nw[kChunk];
        if (k0 + kChunk < G) {
#pragma unroll
          for (int u = 0; u < kChunk; ++u)
            nw[u] = wd[static_cast<int64_t>(k0 + kChunk + u) * H + j];
        }
        const float4* v4 = reinterpret_cast<const float4*>(buf + k0);
#pragma unroll
        for (int qq = 0; qq < kChunk / 4; ++qq) {
          const float4 v = v4[qq];
          acc.x = fmaf(v.x, to_f32(w[4 * qq]), acc.x);
          acc.y = fmaf(v.y, to_f32(w[4 * qq + 1]), acc.y);
          acc.z = fmaf(v.z, to_f32(w[4 * qq + 2]), acc.z);
          acc.w = fmaf(v.w, to_f32(w[4 * qq + 3]), acc.w);
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) w[u] = nw[u];
      }
      const float dot = (acc.x + acc.y) + (acc.z + acc.w);
      dh[q] = live ? dht[q] * zt[q] + dot : dht[q];
    }
    cur ^= 1;
  }
}

template <int kChunk, int kMaxThreads, int kUPT>
void launch_upt(const void* gates, const void* wt, const float* lo,
                const float* hi, const float* ys, const float* g, void* dxs,
                void* dhn, int T, int B, int H, int ndir,
                cudaStream_t stream) {
  const size_t smem = 2 * 3 * H * sizeof(float);   // 48 KB at H = 2048
  gru_bwd_kernel<float, kChunk, kMaxThreads, kUPT>
      <<<dim3(B, ndir), H / kUPT, smem, stream>>>(
          static_cast<const float*>(gates), static_cast<const float*>(wt),
          lo, hi, ys, g, static_cast<float*>(dxs), static_cast<float*>(dhn),
          T, B, H);
}

// one unit a thread up to H = 512, two up to 1024, four above
int launch_fp32(const void* gates, const void* wt, const float* lo,
                const float* hi, const float* ys, const float* g,
                void* dxs, void* dhn, int T, int B, int H, int ndir,
                cudaStream_t stream) {
  if (H <= 256)
    launch_upt<kChunkSmallH, 256, 1>(gates, wt, lo, hi, ys, g, dxs, dhn, T,
                                     B, H, ndir, stream);
  else if (H <= 512)
    launch_upt<kChunkLargeH, 512, 1>(gates, wt, lo, hi, ys, g, dxs, dhn, T,
                                     B, H, ndir, stream);
  else if (H <= 1024)
    launch_upt<kChunkLargeH, 512, 2>(gates, wt, lo, hi, ys, g, dxs, dhn, T,
                                     B, H, ndir, stream);
  else
    launch_upt<kChunkLargeH, 512, 4>(gates, wt, lo, hi, ys, g, dxs, dhn, T,
                                     B, H, ndir, stream);
  CSR_RETURN_LAUNCH_STATUS();
}


// ---------------------------------------------------------------------------
// The bf16 backward on a thread-block cluster (csr_gru_bwd under bf16
// compute; layout in rnn_mma.cuh): the LSTM's reduce-scatter
// (csrc/lstm_bwd.cu) with three gates.
//
// Grid: C·groups x 2 blocks, C = H / kU, in clusters of C along x, as the
// forward's, with kU = gru_bwd_units(H) (rnn_mma.cuh: 16 units a block up
// to H = 256, where 16 blocks of 16 beat 8 of 32, and 32 above, where 16
// units would need more than 16 blocks a cluster): cluster (group, d)
// walks rows [16 group, 16 group + 16) of
// direction d backwards, block c of it owns units [kU c, kU c + kU) and
// their 3 kU gate columns. Thread p owns the pair (row p / kU, unit
// p % kU) and keeps its dh (fp32) in a register. The product is split by
// the reduction, not by the output: block c multiplies its own (dr, dz,
// dn r) columns by the matching columns of every row of W, so it needs no
// other block's gradients, and sends each block the partial sums for that
// block's units (a reduce-scatter: 16 x H fp32 a step leave each block).
// Its W slice, wb[d][c] = [H][3][kU] bf16 (element [j][g][u] =
// W[d][j][g H + kU c + u], laid out by the wrapper), stays in shared
// memory for all T steps: the n rows (units j) of the product's B
// operand, k-major. A step:
//   1. (dr, dz, dn) and dn r of the pair from the prefetched gates
//      (r, z, n, hp_n), h_prev (ys one step back) and g; the next step's
//      inputs are loaded;
//   2. the unmasked (dr, dz, dn r), rounded to bf16 (where _dot2 rounds
//      it), into this block's A [16][3 kU];
//   3. warp w takes n-tiles w, w + kU / 2, ... of the H units: 3 kU / 16
//      k-steps of mma.sync m16n8k16 (bf16 operands, fp32 accumulators, A
//      fragments loaded once a step; B by ldmatrix.x4 for two k-steps, .x2
//      for the odd last one at kU = 16), and stores its 16 x 8 partial sums
//      into the owning block's buffer slot for source c through DSMEM;
//   4. the cluster barrier, release / acquire (dxs and dhn, masked to the
//      live steps, are stored between its halves);
//   5. dh_prev of the pair = dh_total z + the C partial sums added in
//      source order: no atomics, bitwise repeatable; live: dh = dh_prev,
//      otherwise dh = dh_total.
// The partial sums are double-buffered, so one cluster barrier a step is
// enough, as in the forward. At t = 0 the product is not needed.
template <int kU>
__global__ void __launch_bounds__(csr_rnn_mma::kRows * kU, 1)
    gru_bwd_tc_kernel(const __nv_bfloat16* __restrict__ gates,
                      const __nv_bfloat16* __restrict__ wb,
                      const float* __restrict__ lo,
                      const float* __restrict__ hi,
                      const float* __restrict__ ys,
                      const float* __restrict__ g,
                      __nv_bfloat16* __restrict__ dxs,
                      __nv_bfloat16* __restrict__ dhn, int T, int B, int H) {
  namespace tc = csr_rnn_mma;
  constexpr int kM = tc::kRows, kK = 3 * kU;
  constexpr int kSteps = kK / 16;                // k-steps of the product
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(tc::cluster_nctarank());
  const int c = static_cast<int>(tc::cluster_ctarank());
  const int G = 3 * H;
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
  // an n-tile at k chunks l / 8 of two k-steps (x4) or l / 8 % 2 of one
  // (x2, the odd last k-step)
  const uint32_t a_base = s_a + (l & 15) * row_b + (l >> 4) * 16;
  const uint32_t b_off = (l & 7) * row_b + (l >> 3) * 16;
  const uint32_t b1_off = (l & 7) * row_b + ((l >> 3) & 1) * 16;

  struct In {
    float r, z, n, hn, hp, g;
  };
  auto load_in = [&](int t) {
    In in = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (valid) {
      const int64_t row = static_cast<int64_t>(t) * R + rr;
      const __nv_bfloat16* gt = gates + row * 4 * H + j;
      in.r = __bfloat162float(gt[0]);
      in.z = __bfloat162float(gt[H]);
      in.n = __bfloat162float(gt[2 * H]);
      in.hn = __bfloat162float(gt[3 * H]);
      in.hp = t > 0 ? ys[(row - R) * H + j] : 0.0f;
      in.g = g[row * H + j];
    }
    return in;
  };
  auto store_out = [&](int t, float dr, float dz, float dn, float dhn_j,
                       bool live) {
    if (!valid) return;
    const int64_t row = static_cast<int64_t>(t) * R + rr;
    __nv_bfloat16* dx = dxs + row * G + j;
    dx[0] = __float2bfloat16_rn(live ? dr : 0.0f);
    dx[H] = __float2bfloat16_rn(live ? dz : 0.0f);
    dx[2 * H] = __float2bfloat16_rn(live ? dn : 0.0f);
    dhn[row * H + j] = __float2bfloat16_rn(live ? dhn_j : 0.0f);
  };

  float dh = 0.0f;
  In in = load_in(T - 1);
  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    const float dh_total = in.g + dh;
    const float dz = dh_total * (in.hp - in.n) * in.z * (1.0f - in.z);
    const float dn = dh_total * (1.0f - in.z) * (1.0f - in.n * in.n);
    const float dr = dn * in.hn * in.r * (1.0f - in.r);
    const float dhn_j = dn * in.r;
    const float zt = in.z;
    const float tf = static_cast<float>(t);
    const bool live = lo_r <= tf && tf < hi_r;
    if (t == 0) {   // dh_prev of step 0 is not needed
      store_out(t, dr, dz, dn, dhn_j, live);
      break;
    }
    in = load_in(t - 1);
    __nv_bfloat16* arow =
        reinterpret_cast<__nv_bfloat16*>(smem + (s_a - s_w) + r * row_b);
    arow[u] = __float2bfloat16_rn(dr);
    arow[kU + u] = __float2bfloat16_rn(dz);
    arow[2 * kU + u] = __float2bfloat16_rn(dhn_j);
    __syncthreads();

    uint32_t af[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) tc::ldsm_x4(a_base + kk * 32, af[kk]);
    const uint32_t s_dst = s_p + (cur * part_buf + c * kM * kU) * 4;
    for (int nt = wp; nt < H / 8; nt += n_warps) {
      const uint32_t s_b = s_w + nt * 8 * row_b;
      uint32_t bf[(kSteps + 1) / 2][4];
#pragma unroll
      for (int kp = 0; kp < kSteps / 2; ++kp)
        tc::ldsm_x4(s_b + b_off + kp * 64, bf[kp]);
      if constexpr (kSteps % 2 != 0)
        tc::ldsm_x2(s_b + b1_off + (kSteps - 1) * 32, bf[kSteps / 2]);
      // two accumulators (even and odd k-steps) halve the dependent chain
      float acc[2][4] = {};
#pragma unroll
      for (int kp = 0; kp < kSteps / 2; ++kp) {
        tc::mma(acc[0], af[2 * kp], bf[kp][0], bf[kp][1]);
        tc::mma(acc[1], af[2 * kp + 1], bf[kp][2], bf[kp][3]);
      }
      if constexpr (kSteps % 2 != 0)
        tc::mma(acc[0], af[kSteps - 1], bf[kSteps / 2][0],
                bf[kSteps / 2][1]);
      // units 8 nt + 2 (l % 4) + {0, 1} belong to block 8 nt / kU
      const int owner = nt / (kU / 8);
      const int col = (nt % (kU / 8)) * 8 + 2 * (l & 3);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        tc::st_cluster8(
            tc::map_rank(s_dst + (((l >> 2) + 8 * i) * kU + col) * 4, owner),
            acc[0][2 * i] + acc[1][2 * i], acc[0][2 * i + 1] + acc[1][2 * i + 1]);
    }
    tc::cluster_arrive();
    store_out(t, dr, dz, dn, dhn_j, live);
    tc::cluster_wait();
    const float* p = part + cur * part_buf + r * kU + u;
    float dot = p[0];
    for (int src = 1; src < C; ++src) dot += p[src * kM * kU];
    dh = live ? dh_total * zt + dot : dh_total;
    cur ^= 1;
  }
}

template <int kU>
int launch_tc(const void* gates, const void* wb, const float* lo,
              const float* hi, const float* ys, const float* g, void* dxs,
              void* dhn, int T, int B, int H, int ndir, int C,
              cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  return tc::launch_clusters(
      gru_bwd_tc_kernel<kU>, C, (B + tc::kRows - 1) / tc::kRows, ndir,
      tc::kRows * kU, tc::bwd_smem(H, 3, kU), stream,
      static_cast<const __nv_bfloat16*>(gates),
      static_cast<const __nv_bfloat16*>(wb), lo, hi, ys, g,
      static_cast<__nv_bfloat16*>(dxs), static_cast<__nv_bfloat16*>(dhn), T,
      B, H);
}

// ---------------------------------------------------------------------------
// The bf16 backward past H = 512, W streamed (rnn_mma.cuh's streamed-W
// form; csr_gru_bwd under bf16 compute): csrc/lstm_bwd.cu's
// lstm_bwd_wide_kernel with three gates. A block's pairs (row p / U, unit
// p % U) go to threads p, p + 512, ...; a step writes their unmasked
// (dr, dz, dn r), rounded to bf16, into A [16][K] (column g U + u, K =
// wide_bwd_k(H, 3): 3 U padded to a multiple of 32 with zeros), multiplies
// it by the block's W columns streamed from wb[d][c] = [H / 32][K / 16][4
// tiles][32 lanes] uint2 (ops/rnn_cuda.py's wide_bwd_weights), sends each
// finished n-group's 16 x 32 partial sums of dh to their owners through
// DSMEM, and after the cluster barrier (dxs and dhn stored between its
// halves) adds each pair's C sums in source order: dh_prev = dh_total z +
// the sum. One partial-sum buffer takes a second cluster barrier a step
// (wide_bwd_bufs).
template <int kP, int kPairs>
__global__ void __launch_bounds__(csr_rnn_mma::kWideBwdThreads, 1)
    gru_bwd_wide_kernel(const __nv_bfloat16* __restrict__ gates,
                        const uint2* __restrict__ wb,
                        const float* __restrict__ lo,
                        const float* __restrict__ hi,
                        const float* __restrict__ ys,
                        const float* __restrict__ g,
                        __nv_bfloat16* __restrict__ dxs,
                        __nv_bfloat16* __restrict__ dhn, int T, int B,
                        int H) {
  namespace tc = csr_rnn_mma;
  constexpr int kM = tc::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(tc::cluster_nctarank());
  const int c = static_cast<int>(tc::cluster_ctarank());
  const int U = tc::wide_units(H), K = tc::wide_bwd_k(H, 3), KS = K / 16;
  const int NG = H / 32;                         // n-groups of the product
  const int G = 3 * H;
  const int d = blockIdx.y, group = blockIdx.x / C;
  const int R = gridDim.y * B;   // ndir * B
  const int row_b = tc::row_bytes(K);
  const int bufs = tc::wide_bwd_bufs(H, 3);
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
  float lo_r[kPairs], hi_r[kPairs], dh[kPairs];
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
  }
  struct In {
    float r, z, n, hn, hp, g;
  };
  auto load_in = [&](int t, int q) {
    In in = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (valid[q]) {
      const int64_t row = static_cast<int64_t>(t) * R + rr[q];
      const int j = u0 + pu[q];
      const __nv_bfloat16* gt = gates + row * 4 * H + j;
      in.r = __bfloat162float(gt[0]);
      in.z = __bfloat162float(gt[H]);
      in.n = __bfloat162float(gt[2 * H]);
      in.hn = __bfloat162float(gt[3 * H]);
      in.hp = t > 0 ? ys[(row - R) * H + j] : 0.0f;
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
    // (dr, dz, dn, dn r) of each pair
    float dgv[kPairs][4], zt[kPairs], dht[kPairs];
    bool live[kPairs];
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const float dh_total = in[q].g + dh[q];
      const float dz = dh_total * (in[q].hp - in[q].n) * in[q].z *
                       (1.0f - in[q].z);
      const float dn = dh_total * (1.0f - in[q].z) *
                       (1.0f - in[q].n * in[q].n);
      dgv[q][0] = dn * in[q].hn * in[q].r * (1.0f - in[q].r);
      dgv[q][1] = dz;
      dgv[q][2] = dn;
      dgv[q][3] = dn * in[q].r;
      zt[q] = in[q].z;
      dht[q] = dh_total;
      live[q] = lo_r[q] <= tf && tf < hi_r[q];
    }
    auto store_out = [&]() {
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        if (!valid[q]) continue;
        const int64_t row = static_cast<int64_t>(t) * R + rr[q];
        const int j = u0 + pu[q];
        __nv_bfloat16* dx = dxs + row * G + j;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          dx[k * H] = __float2bfloat16_rn(live[q] ? dgv[q][k] : 0.0f);
        dhn[row * H + j] = __float2bfloat16_rn(live[q] ? dgv[q][3] : 0.0f);
      }
    };
    if (t == 0) {   // dh_prev of step 0 is not needed
      store_out();
      break;
    }
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      in[q] = load_in(t - 1, q);
      if (has[q]) {
        __nv_bfloat16* arow = reinterpret_cast<__nv_bfloat16*>(
            smem + pr[q] * row_b);
        arow[pu[q]] = __float2bfloat16_rn(dgv[q][0]);
        arow[U + pu[q]] = __float2bfloat16_rn(dgv[q][1]);
        arow[2 * U + pu[q]] = __float2bfloat16_rn(dgv[q][3]);
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
    store_out();
    tc::cluster_wait();
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      if (!has[q]) continue;
      const float* p = part + cur * part_buf + pr[q] * U + pu[q];
      float dot = p[0];
      for (int src = 1; src < C; ++src) dot += p[src * kM * U];
      dh[q] = live[q] ? dht[q] * zt[q] + dot : dht[q];
    }
    if (bufs == 2)
      cur ^= 1;
    else
      tc::cluster_sync();
  }
}


int launch_wide(const void* gates, const void* wb, const float* lo,
                const float* hi, const float* ys, const float* g, void* dxs,
                void* dhn, int T, int B, int H, int ndir, int C,
                cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  if (C != tc::wide_cluster(H)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kP = tc::wide_prefetch(tc::kWideBwdThreads);
  auto kernel = tc::wide_pairs(H) == 2 ? gru_bwd_wide_kernel<kP, 2>
                                       : gru_bwd_wide_kernel<kP, 4>;
  return tc::launch_clusters(
      kernel, C, (B + tc::kRows - 1) / tc::kRows, ndir, tc::kWideBwdThreads,
      tc::wide_bwd_smem(H, 3), stream,
      static_cast<const __nv_bfloat16*>(gates),
      static_cast<const uint2*>(wb), lo, hi, ys, g,
      static_cast<__nv_bfloat16*>(dxs), static_cast<__nv_bfloat16*>(dhn), T,
      B, H);
}

}  // namespace

// gates [T, ndir*B, 4H], dxs [T, ndir*B, 3H], dhn [T, ndir*B, H] and the
// weights all fp32 (the FMA kernel: wt [ndir, 3H, H], W transposed) or,
// when bf16 != 0, all bf16 (the cluster kernel: wb [ndir, C, H, 3, H/C],
// C = H / gru_bwd_units(H) blocks a cluster, ops/rnn_cuda.py's gru_plan;
// past H = 512 the streamed-W fragments [ndir, C, H/32, K/16, 4, 32, 4],
// C = wide_cluster(H), rnn_cuda.wide_bwd_weights; unread under fp32);
// lo/hi [ndir*B], ys (the carries; h_prev is read one step back) and g
// [T, ndir*B, H] fp32. Requires 32 <= H <= 2048, H % 32 == 0, T >= 1,
// B >= 1, ndir 1 or 2 (the wrapper checks).
CSR_API int csr_gru_bwd(const void* gates, const void* wt, const float* lo,
                        const float* hi, const float* ys, const float* g,
                        void* dxs, void* dhn, int T, int B, int H, int ndir,
                        int C, int bf16, cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  if (ndir != 1 && ndir != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (!bf16)
    return launch_fp32(gates, wt, lo, hi, ys, g, dxs, dhn, T, B, H, ndir,
                       stream);
  if (H > tc::kResidentMax)
    return launch_wide(gates, wt, lo, hi, ys, g, dxs, dhn, T, B, H, ndir, C,
                       stream);
  if (C * tc::gru_bwd_units(H) != H)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc::gru_bwd_units(H) == 16)
    return launch_tc<16>(gates, wt, lo, hi, ys, g, dxs, dhn, T, B, H, ndir,
                         C, stream);
  return launch_tc<tc::kUnits>(gates, wt, lo, hi, ys, g, dxs, dhn, T, B,
                               H, ndir, C, stream);
}

// The cluster backward's plan as the card takes it: out[0] = its shared
// memory bytes at hidden size H (C = H / gru_bwd_units(H) blocks), out[1]
// = how many of its clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot launch).
CSR_API int csr_gru_bwd_occupancy(int H, int* out) {
  namespace tc = csr_rnn_mma;
  if (H > tc::kResidentMax) {
    out[0] = tc::wide_bwd_smem(H, 3);
    constexpr int kP = tc::wide_prefetch(tc::kWideBwdThreads);
    auto kernel = tc::wide_pairs(H) == 2 ? gru_bwd_wide_kernel<kP, 2>
                                         : gru_bwd_wide_kernel<kP, 4>;
    return tc::max_clusters(kernel, tc::wide_cluster(H), tc::kWideBwdThreads,
                            out[0], out + 1);
  }
  const int U = tc::gru_bwd_units(H);
  out[0] = tc::bwd_smem(H, 3, U);
  return U == 16 ? tc::max_clusters(gru_bwd_tc_kernel<16>, H / U,
                                    tc::kRows * U, out[0], out + 1)
                 : tc::max_clusters(gru_bwd_tc_kernel<tc::kUnits>, H / U,
                                    tc::kRows * U, out[0], out + 1);
}
