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
// Three kernels: under bf16 compute (the presets' path) the step product
// runs on the tensor cores, up to H = 512 on a thread-block cluster with W
// resident in its shared memory (gru_bwd_tc_kernel, below), above as one
// persistent cooperative launch over the whole card, A staged in shared
// memory at each step (gru_bwd_persist_kernel, further below); under fp32
// the FMA kernel (gru_bwd_kernel).
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
// The bf16 backward past H = 512: the persistent form (rnn_mma.cuh;
// csr_gru_bwd under bf16 compute, for ops/rnn_pallas.py's
// _gru_bwd_kernel), csrc/lstm_bwd.cu's
// lstm_bwd_persist_kernel with three gate columns, the dhn output and A
// staged in shared memory.
//
// What bounds it on Hopper: a step multiplies every row's (dr, dz, dn r)
// [3H] by Wᵀ, all of the direction's W (3 H^2 bf16: 6.3 MB at H = 1024,
// 25.2 MB at 2048), one step after another. The clustered form that came
// before read W from L2 once per 16-row group at every step on one 16-SM
// cluster per group and direction, and scattered [16 x H] fp32 partial
// sums of dh between its blocks over DSMEM, with a second cluster barrier
// a step where two buffers did not fit (40.1 µs a step at H = 2048 against
// cuDNN's 27.4). In the persistent form the step is held by the latency
// of the product's A loads from L2 (PERF.md: with A already in shared
// memory the LSTM backward's step took 0.60 of its time).
//
// What this design does about it: each block owns output units of dh_prev
// and computes them whole. Block (d, cb) owns nt n8 tiles of units j: the
// rows W[j, :] over all 3H gate columns, its B operand (B[k][j] = W[j][k],
// k-major over K = 3H / 16 k-steps), laid out by the wrapper in fragment
// order, wb[d][cb] = [K][nt][32 lanes] uint2 (ops/rnn_cuda.py's
// persist_gru_bwd_weights), kept in shared memory as far as it fits (at H
// = 1024 all 96 KB a block; at 2048 each warp keeps its first kr k-steps
// and the rest go through its ring at each step). Each warp copies its
// k-steps of A into shared memory by cp.async as soon as the grid barrier
// has passed, through a ring of kStages slots (192 KB of A a pass at H =
// 1024 do not fit beside W), so the product reads A and B from shared
// memory. The block also owns the same units' gate math: it keeps their
// carried dh (in registers with one pass of one group, else in the
// workspace's carried [ndir·B][H], which only the owning thread reads and
// writes) and publishes their gradients. On a card of fewer than ndir H /
// 32 SMs a block owns more than kGroupTiles tiles and runs them as groups
// of NT (rnn_mma.cuh), steps 1-2 once a group in turn, each staging A
// anew, one slot a thread a group. A step t, for each pass of 32 rows:
//   1. (t < T - 1) the product: warp w of eight multiplies the pass's
//      (dr, dz, dn r) of step t + 1 (bf16, where _dot2 rounds it) by the
//      block's columns over its eighth of the K k-steps, each B fragment
//      feeding both m16 tiles; the eighths meet in shared memory and a slot
//      (m-tile, tile, lane) adds them in warp order: the product's share of
//      dh_prev of its two rows and two units, in a fixed order, with no
//      atomics and no partial sums between blocks (bitwise repeatable);
//   2. the slot's dh: its carried value (dh_total z where step t + 1 was
//      live, else dh_total) plus the product where that step was live, 0
//      at t = T - 1; its (dr, dz, dn) and dn r from the gates (r, z, n,
//      hp_n), h_prev (ys one step back) and g; dxs and dhn masked to the
//      live steps; the unmasked (dr, dz, dn r), rounded to bf16, into the
//      next A buffer at gate columns g H + j (two buffers, by step parity).
//      With one pass of one group (B <= 32) the carried dh stays in
//      registers and the next step's inputs are loaded during the barrier;
//   3. one grid barrier (rnn_mma.cuh's grid_arrive / grid_wait).
// Measured on an H100 (tools/kernel_ab.py --cases rnn_wide against copies
// of this build, PERF.md): 1.93 ms at H = 1024 and 4.68 at 2048 (B = 24,
// T' = 256), where cuDNN's backward takes 3.09 and 6.58. Staging A takes
// 0.79 of the time of a copy that reads A from L2 (persist_product in
// place of staged_product) at H = 1024. The product is 69-79% of a step, the ring's
// copies 24% at H = 1024 and 31% at 2048 (measured with one-k-step slots;
// at 2048 8 of each warp's 48 k-steps of W stay resident), the grid
// barrier 3-4%.
// The launch is cooperative (rnn_mma.cuh's launch_cooperative): all NB ndir
// <= sms blocks are resident, or it fails.
constexpr int kBwdWarps = 8;   // warps a block of the persistent form

// a slot's inputs at one step, for its two rows and two units: the gates
// (r, z, n, hp_n) as bf16 pairs, h_prev and the gradient of ys, and the
// rows' lo and hi
struct GruIn {
  uint32_t q[2][4];
  float2 hp[2], g[2];
  float lo[2], hi[2];
};

template <int NT>
__global__ void __launch_bounds__(32 * kBwdWarps, 1)
    gru_bwd_persist_kernel(const __nv_bfloat16* __restrict__ gates,
                           const uint2* __restrict__ wb,
                           const float* __restrict__ lo,
                           const float* __restrict__ hi,
                           const float* __restrict__ ys,
                           const float* __restrict__ g,
                           __nv_bfloat16* __restrict__ dxs,
                           __nv_bfloat16* __restrict__ dhn,
                           unsigned int* counter, uint4* abuf, float* held,
                           int T, int B, int H, int NB, int tiles, int groups,
                           int kr, int ck) {
  namespace tc = csr_rnn_mma;
  // NT: tiles a group (nw8); the block's `tiles` run as `groups` of them
  constexpr int NC = NT, kW = kBwdWarps;
  static_assert(2 * NT * 32 <= 32 * kW, "one slot a thread a group");
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);
  unsigned char* res = smem + tc::persist_part(NC, kW);
  const int ndir = gridDim.x / NB;
  const int d = blockIdx.x / NB, cb = blockIdx.x % NB;
  const int R = ndir * B, G = 3 * H, K = 3 * H / 16, nt_all = H / 8;
  const int passes = (B + tc::kPassRows - 1) / tc::kPassRows;
  // one pass of one group: the slot's carried dh and its next inputs stay
  // in registers; more: dh goes through the workspace
  const bool two = B > 16, hold = passes == 1 && groups == 1;
  const int tid = threadIdx.x, l = tid & 31, w = tid >> 5;
  const uint2* slice = wb + int64_t(d * NB + cb) * groups * K * NC * 32;
  // A of direction d, pass p, m-tile m in buffer buf: [2][ndir]
  // [passes][2][K][32] uint4
  auto a_of = [&](int buf, int p, int m) {
    return abuf + (int64_t((buf * ndir + d) * passes + p) * 2 + m) * K * 32;
  };
  tc::load_resident(tc::smem_addr(res), slice, kW, K, kr, NC, groups);
  __syncthreads();
  const tc::WarpSteps ws = tc::warp_steps(w, kW, K, kr);
  const int kq = (K + kW - 1) / kW;
  const int sz = tc::stage_bytes(NC, kr < kq);
  unsigned char* ring =
      res + groups * kW * kr * NC * 256 + w * tc::kStages * ck * sz;
  const int rot = ck > 0 ? (ws.kw + ck - 1) / ck * cb / NB : 0;
  // group 0's resident fragments of this lane (a shared-space address),
  // and its streamed ones (group g's kW kr NC 256 bytes and K NC 32 uint2
  // further on)
  const uint32_t sb = tc::smem_addr(res) + (w * kr * NC * 32 + l) * 8;
  const uint2* gb = slice + int64_t(ws.kb) * NC * 32;
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
    GruIn in;
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
                                 gates + row * 4 * H + k * H + j)
                           : 0u;
      in.hp[i] = valid && t > 0 ? *reinterpret_cast<const float2*>(
                                      ys + (row - R) * H + j)
                                : z;
      in.g[i] = valid ? *reinterpret_cast<const float2*>(g + row * H + j)
                      : z;
    }
    return in;
  };
  GruIn next;
  float2 dh_reg[2];
  if (hold && own_of(0, NT)) next = load_in(T - 1, 0, unit_of(0, NT));
  unsigned int barriers = 0;

  // group gr's share of step t, pass p: its product, then its slots'
  // gate math (a copy for one group a block, one for more: OneGroup,
  // Groups)
  auto group_step = [&](auto tag, int t, int p, int gr) {
    const bool keep = decltype(tag)::one && hold;
    const int nt = decltype(tag)::one ? NT : tiles;   // NT: nt of one group
    const bool product = t < T - 1;
    const float tf = static_cast<float>(t);
    if (product) {
      const int buf = (t + 1) & 1;
      float acc[2][NC][4] = {};
      tc::staged_product<NC>(
          acc, a_of(buf, p, 0) + ws.kb * 32, a_of(buf, p, 1) + ws.kb * 32,
          two, ws.kw, ws.kres, rot, sb + gr * kW * kr * NC * 256, NC,
          gb + int64_t(gr) * K * NC * 32, ring, ck, sz, l);
      tc::store_partials<NC>(part, acc, two, w, l);
    }
    __syncthreads();
    if (own_of(gr, nt)) {
      const int j = unit_of(gr, nt);
      const float4 dot = product
                             ? tc::sum_partials(part, kW, NC, m, tile, ls)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const GruIn in = keep ? next : load_in(t, p, j);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = row_of(p, i);
        const bool valid = b < B;
        const int64_t rr = int64_t(d) * B + b;
        const int64_t row = int64_t(t) * R + rr;
        const bool live = in.lo[i] <= tf && tf < in.hi[i];
        const bool live_next =
            product && in.lo[i] <= tf + 1.0f && tf + 1.0f < in.hi[i];
        // dh from step t + 1 (0 at t = T - 1): its carried dh_total z
        // plus the product where that step was live, else its dh_total
        float2 dh = make_float2(0.0f, 0.0f);
        if (product && (keep || valid)) {
          dh = keep ? dh_reg[i]
                    : *reinterpret_cast<const float2*>(held + rr * H + j);
          if (live_next) {
            dh.x += i ? dot.z : dot.x;
            dh.y += i ? dot.w : dot.y;
          }
        }
        float dg[4][2], carried[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float q[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&in.q[i][k]));
            q[k] = e ? v.y : v.x;
          }
          const float r = q[0], z = q[1], n = q[2], hn = q[3];
          const float dht = (e ? in.g[i].y : in.g[i].x) + (e ? dh.y : dh.x);
          const float hp = e ? in.hp[i].y : in.hp[i].x;
          const float dz = dht * (hp - n) * z * (1.0f - z);
          const float dn = dht * (1.0f - z) * (1.0f - n * n);
          dg[0][e] = dn * hn * r * (1.0f - r);
          dg[1][e] = dz;
          dg[2][e] = dn;
          dg[3][e] = dn * r;
          carried[e] = live ? dht * z : dht;
        }
        if (t > 0) {
          // (dr, dz, dn r) at gate columns g H + j
#pragma unroll
          for (int k = 0; k < 3; ++k)
            *tc::a_word(a_of(t & 1, p, m), k * H + j, i, ls) =
                tc::bf16x2(dg[k == 2 ? 3 : k][0], dg[k == 2 ? 3 : k][1]);
          if (keep)
            dh_reg[i] = make_float2(carried[0], carried[1]);
          else if (valid)
            *reinterpret_cast<float2*>(held + rr * H + j) =
                make_float2(carried[0], carried[1]);
        }
        if (valid) {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            *reinterpret_cast<uint32_t*>(dxs + row * G + k * H + j) =
                tc::bf16x2(live ? dg[k][0] : 0.0f, live ? dg[k][1] : 0.0f);
          *reinterpret_cast<uint32_t*>(dhn + row * H + j) =
              tc::bf16x2(live ? dg[3][0] : 0.0f, live ? dg[3][1] : 0.0f);
        }
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
// persist_plan("gru_bwd", ...))
csr_rnn_mma::PersistPlan bwd_persist_plan(int H, int ndir, int B,
                                          int sms) {
  return csr_rnn_mma::persist_plan(H, ndir, B, sms, 1, 3 * H / 16,
                                   kBwdWarps, 1, true);
}

// the persistent kernel of groups of `width` tiles
template <typename Fn>
int with_persist_kernel(int width, Fn&& fn) {
  static_assert(csr_rnn_mma::kGroupTiles == 4, "a kernel a group width");
  switch (width) {
    case 1:
      return fn(gru_bwd_persist_kernel<1>);
    case 2:
      return fn(gru_bwd_persist_kernel<2>);
    case 3:
      return fn(gru_bwd_persist_kernel<3>);
    case 4:
      return fn(gru_bwd_persist_kernel<4>);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C: the blocks a direction; sms: the SM count the plan was made for;
// work: the workspace of the plan's bytes (rnn_mma.cuh's PersistPlan)
int launch_persist(const void* gates, const void* wb, const float* lo,
                   const float* hi, const float* ys, const float* g,
                   void* dxs, void* dhn, void* work, int T, int B, int H,
                   int ndir, int C, int sms, cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  const cudaError_t e = tc::check_sms(sms, ndir);
  if (e != cudaSuccess) return static_cast<int>(e);
  const tc::PersistPlan p = bwd_persist_plan(H, ndir, B, sms);
  if (C != p.blocks || work == nullptr || p.chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(work);
  unsigned int* counter = reinterpret_cast<unsigned int*>(base);
  uint4* abuf = reinterpret_cast<uint4*>(base + 256);
  float* held = reinterpret_cast<float*>(base + p.held);
  return with_persist_kernel(p.width, [&](auto kernel) {
    return tc::launch_cooperative(
        kernel, p.blocks * ndir, 32 * kBwdWarps, p.smem, stream, counter,
        static_cast<const __nv_bfloat16*>(gates),
        static_cast<const uint2*>(wb), lo, hi, ys, g,
        static_cast<__nv_bfloat16*>(dxs), static_cast<__nv_bfloat16*>(dhn),
        counter, abuf, held, T, B, H, p.blocks, p.tiles, p.groups,
        p.resident, p.chunk);
  });
}

}  // namespace

// gates [T, ndir*B, 4H], dxs [T, ndir*B, 3H], dhn [T, ndir*B, H] and the
// weights all fp32 (the FMA kernel: wt [ndir, 3H, H], W transposed) or,
// when bf16 != 0, all bf16 (the cluster kernel: wb [ndir, C, H, 3, H/C],
// C = H / gru_bwd_units(H) blocks a cluster, ops/rnn_cuda.py's gru_plan;
// past H = 512 the persistent form's fragments [ndir, C, ng·3H/16, nw8,
// 32, 4], C its blocks a direction, on a card of `sms` SMs,
// rnn_cuda.persist_gru_bwd_weights; unread under fp32); lo/hi [ndir*B],
// ys (the carries; h_prev is read one step back) and g [T, ndir*B, H]
// fp32; work the persistent form's workspace (csr_gru_bwd_persist_plan's
// bytes; unread elsewhere); sms the SM count the persistent plan was made
// for (ndir <= sms <= the card's; unread elsewhere). Requires 32 <= H <=
// 2048, H % 32 == 0, T >= 1, B >= 1, ndir 1 or 2 (the wrapper checks).
CSR_API int csr_gru_bwd(const void* gates, const void* wt, const float* lo,
                        const float* hi, const float* ys, const float* g,
                        void* dxs, void* dhn, void* work, int T, int B, int H,
                        int ndir, int C, int sms, int bf16,
                        cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  if (ndir != 1 && ndir != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (!bf16)
    return launch_fp32(gates, wt, lo, hi, ys, g, dxs, dhn, T, B, H, ndir,
                       stream);
  if (H > tc::kResidentMax)
    return launch_persist(gates, wt, lo, hi, ys, g, dxs, dhn, work, T, B, H,
                          ndir, C, sms, stream);
  if (C * tc::gru_bwd_units(H) != H)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc::gru_bwd_units(H) == 16)
    return launch_tc<16>(gates, wt, lo, hi, ys, g, dxs, dhn, T, B, H, ndir,
                         C, stream);
  return launch_tc<tc::kUnits>(gates, wt, lo, hi, ys, g, dxs, dhn, T, B,
                               H, ndir, C, stream);
}

// The cluster backward's plan as the card takes it (H <= 512): out[0] =
// its shared memory bytes at hidden size H (C = H / gru_bwd_units(H)
// blocks), out[1] = how many of its clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot launch). Past H = 512 see
// csr_gru_bwd_persist_plan.
CSR_API int csr_gru_bwd_occupancy(int H, int* out) {
  namespace tc = csr_rnn_mma;
  if (H > tc::kResidentMax) return static_cast<int>(cudaErrorInvalidValue);
  const int U = tc::gru_bwd_units(H);
  out[0] = tc::bwd_smem(H, 3, U);
  return U == 16 ? tc::max_clusters(gru_bwd_tc_kernel<16>, H / U,
                                    tc::kRows * U, out[0], out + 1)
                 : tc::max_clusters(gru_bwd_tc_kernel<tc::kUnits>, H / U,
                                    tc::kRows * U, out[0], out + 1);
}

// The persistent backward's plan as the card takes it at hidden size H >
// 512, ndir directions, B rows a direction and `sms` SMs
// (rnn_mma.cuh's report_plan; out: 8 int64). cudaErrorInvalidValue where
// sms is below ndir or above the card's.
CSR_API int csr_gru_bwd_persist_plan(int H, int ndir, int B, int sms,
                                     long long* out) {
  namespace tc = csr_rnn_mma;
  const cudaError_t e = tc::check_sms(sms, ndir);
  if (e != cudaSuccess) return static_cast<int>(e);
  const tc::PersistPlan p = bwd_persist_plan(H, ndir, B, sms);
  return with_persist_kernel(p.width, [&](auto kernel) {
    return tc::report_plan(p, kernel, 32 * kBwdWarps, out);
  });
}
