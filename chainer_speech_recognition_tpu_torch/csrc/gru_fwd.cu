// GRU recurrence (bidirectional or forward-only): inference, the training
// forward that also streams the gate residuals, and the streaming window.
//
// Replaces ops/rnn_pallas.py::_gru_fwd_kernel in both its forms:
// residual-free (_fwd_impl(residuals=False), birnn_pallas's primal; entry
// csr_gru_fwd) and with residuals (_fwd_impl(residuals=True), the custom
// VJP's forward; entry csr_gru_fwd_train); and
// ops/rnn_pallas.py::_gru_stream_kernel (birnn_pallas_stream; entry
// csr_gru_fwd_stream). The training form also writes, per step and row,
// gates [T, R, 4H] = (r, z, n, hp_n) in the stream dtype, hp_n being the
// recurrent n pre-activation h W_n; the backward kernel (csrc/gru_bwd.cu)
// reads them instead of recomputing the gate matmul. The stream form seeds
// h from h0 [R, H] fp32 instead of 0 and writes carry [R, H] fp32, the h
// of step emit_t - 1 (h0 when emit_t == 0), so a streaming window carries
// its forward state across the chunk boundary inside its lookahead. In
// each kernel below the three forms are one template (compile-time flags),
// so the inference form compiles to the same code as before the other
// forms existed.
//
// Same boundary as the TPU kernel: xs [T, R=ndir*B, 3H] in the stream
// dtype (bf16 under bf16 compute, fp32 under fp32), W [ndir, H, 3H]
// already cast to the compute dtype by the wrapper (the TPU kernel casts it
// in-step, which is the same value; the cluster kernel takes it in slices,
// below), lo/hi [R] fp32 -> ys [T, R, H] fp32.
// Rows [d*B, (d+1)*B) use w[d]: ndir = 2 for a bidirectional layer, 1 for a
// forward-only one, in every form (the TPU path duplicates the one W
// instead, which needs an even R, and sums the two halves' dW; one stream
// at batch 1 has R = 1). Row r is live at step t iff
// lo[r] <= t < hi[r], and its h is frozen otherwise. The recurrent product
// rounds h (and w) to the compute dtype and accumulates in fp32, exactly as
// _dot2; the carry and the gate math (_gru_gates) stay fp32, and h0 seeds
// the fp32 register while its compute-dtype rounding seeds the shared copy
// the first product reads.
//
// Three kernels. The bf16 forms, all three (the presets' path), run on a
// thread-block cluster with the step product on the tensor cores: up to
// H = 512 with W resident in the cluster's shared memory
// (gru_fwd_tc_kernel, below; one template over kResiduals and kStream),
// above with W streamed from global memory at each step
// (gru_fwd_wide_kernel, further below). The fp32 forms run the FMA kernel
// (gru_fwd_kernel, one template over kGates and kStream).
//
// What bounds it on Hopper: the sequential dependency over T. Each step is
// a [rows x H] x [H x 3H] product that needs all of the direction's W
// (256 x 768 bf16 = 393 KB at bigru) and the step before's h; the bytes
// the function must move (xs, ys, the residuals) take ~0.02 ms at the
// training shape, the T dependent steps far longer.
//
// The FMA kernel (the simple right version): rows are independent given W,
// so a block owns kRows rows of one direction and loops over all T inside
// the kernel; nothing crosses blocks. Thread j owns hidden unit j: it
// accumulates the r, z and n pre-activations of unit j for its rows (W
// reads coalesced across j, h broadcast from shared memory as float4),
// applies the gates and keeps its fp32 h in registers. Every block streams
// its direction's W from L2 once a step, in register chunks of kChunk
// rows, the next chunk's loads issued before the current chunk's FMAs,
// which hides the L2 latency (measured on an H100 at bigru, B=32: 12.7 ms
// a layer without the pipelining, 4.4 ms with it at kRows=4, 3.2 ms at
// kRows=1, the chosen value). The compute-dtype copy of h that the next
// step reads is double-buffered in shared memory, so a step needs one
// barrier. Up to H = 512 one thread a unit (at ~120 registers a thread,
// 512 threads fill one SM's register file; capping registers with
// __launch_bounds__ measured 25% slower); past it a thread owns kUPT = 2
// (H <= 1024) or 4 units, one after the other. Bounds: 32 <= H <= 2048,
// H % 32 == 0, any B.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "rnn_common.cuh"
#include "rnn_mma.cuh"

namespace {

constexpr int kRows = 1;   // batch rows per block
constexpr int kChunk = 8;  // W rows per register batch (H % 32 == 0)

using namespace csr_rnn;

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

template <typename S, int kUPT, bool kGates, bool kStream>
__global__ void gru_fwd_kernel(const S* __restrict__ xs,
                               const S* __restrict__ w,
                               const float* __restrict__ lo,
                               const float* __restrict__ hi,
                               const float* __restrict__ h0,
                               float* __restrict__ ys, S* __restrict__ gates,
                               float* __restrict__ carry, int T, int B, int H,
                               int emit_t) {
  extern __shared__ float hs[];  // [2][kRows][H] compute-dtype h
  const int d = blockIdx.y;      // direction
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - r0);
  const int R = gridDim.y * B;   // ndir * B
  const int G = 3 * H;
  const S* wd = w + static_cast<int64_t>(d) * H * G;

  // thread's hidden units: j = threadIdx.x + u blockDim.x, u < kUPT
  // (blockDim.x = H / kUPT)
  float h[kUPT][kRows], lo_r[kRows], hi_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    lo_r[r] = 1.0f;  // rows past B are never live
    hi_r[r] = 0.0f;
    if (r < nrows) {
      const int64_t row = d * B + r0 + r;
      lo_r[r] = lo[row];
      hi_r[r] = hi[row];
    }
  }
#pragma unroll
  for (int q = 0; q < kUPT; ++q) {
    const int j = threadIdx.x + q * blockDim.x;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      h[q][r] = 0.0f;
      if (r < nrows && kStream) {
        const int64_t row = d * B + r0 + r;
        h[q][r] = h0[row * H + j];
        if (emit_t == 0) carry[row * H + j] = h[q][r];
      }
      hs[r * H + j] = round_to<S>(h[q][r]);
    }
  }
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* hb = hs + cur * kRows * H;
    float* hnext = hs + (cur ^ 1) * kRows * H;
    const float tf = static_cast<float>(t);
#pragma unroll
    for (int q = 0; q < kUPT; ++q) {
      const int j = threadIdx.x + q * blockDim.x;
      float xr[kRows], xz[kRows], xn[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        xr[r] = xz[r] = xn[r] = 0.0f;
        if (r < nrows) {
          const S* x =
              xs + (static_cast<int64_t>(t) * R + d * B + r0 + r) * G;
          xr[r] = to_f32(x[j]);
          xz[r] = to_f32(x[H + j]);
          xn[r] = to_f32(x[2 * H + j]);
        }
      }
      float ar[kRows], az[kRows], an[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) ar[r] = az[r] = an[r] = 0.0f;
      // W in chunks of kChunk rows held in registers; the next chunk's
      // loads are issued before this chunk's FMAs, so L2 latency overlaps
      // compute
      S wr[kChunk], wz[kChunk], wn[kChunk];
      load_chunk(wd, 0, j, H, G, wr, wz, wn);
      for (int k0 = 0; k0 < H; k0 += kChunk) {
        S nr[kChunk], nz[kChunk], nn[kChunk];
        if (k0 + kChunk < H) load_chunk(wd, k0 + kChunk, j, H, G, nr, nz, nn);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4* h4 = reinterpret_cast<const float4*>(hb + r * H + k0);
#pragma unroll
          for (int qq = 0; qq < kChunk / 4; ++qq) {
            const float4 hv = h4[qq];
            const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              ar[r] = fmaf(hk[u], to_f32(wr[4 * qq + u]), ar[r]);
              az[r] = fmaf(hk[u], to_f32(wz[4 * qq + u]), az[r]);
              an[r] = fmaf(hk[u], to_f32(wn[4 * qq + u]), an[r]);
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
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float rg = sigmoidf(xr[r] + ar[r]);
        const float z = sigmoidf(xz[r] + az[r]);
        const float n = tanhf(xn[r] + rg * an[r]);
        const float hn = (1.0f - z) * n + z * h[q][r];
        if (lo_r[r] <= tf && tf < hi_r[r]) h[q][r] = hn;
        if (r < nrows) {
          const int64_t row = static_cast<int64_t>(t) * R + d * B + r0 + r;
          ys[row * H + j] = h[q][r];
          if (kGates) {
            S* gt = gates + row * 4 * H;
            gt[j] = from_f32<S>(rg);
            gt[H + j] = from_f32<S>(z);
            gt[2 * H + j] = from_f32<S>(n);
            gt[3 * H + j] = from_f32<S>(an[r]);
          }
          if (kStream && t == emit_t - 1)
            carry[(static_cast<int64_t>(d) * B + r0 + r) * H + j] = h[q][r];
        }
        hnext[r * H + j] = round_to<S>(h[q][r]);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <typename S, int kUPT, bool kGates, bool kStream>
void launch_upt(const void* xs, const void* w, const float* lo,
                const float* hi, const float* h0, float* ys, void* gates,
                float* carry, int T, int B, int H, int ndir, int emit_t,
                cudaStream_t stream) {
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  const size_t smem = 2 * kRows * H * sizeof(float);
  gru_fwd_kernel<S, kUPT, kGates, kStream><<<grid, H / kUPT, smem, stream>>>(
      static_cast<const S*>(xs), static_cast<const S*>(w), lo, hi, h0, ys,
      static_cast<S*>(gates), carry, T, B, H, emit_t);
}

// one unit a thread up to H = 512, two up to 1024, four above
template <typename S, bool kGates, bool kStream>
int launch(const void* xs, const void* w, const float* lo, const float* hi,
           const float* h0, float* ys, void* gates, float* carry, int T,
           int B, int H, int ndir, int emit_t, cudaStream_t stream) {
  if (H <= 512)
    launch_upt<S, 1, kGates, kStream>(xs, w, lo, hi, h0, ys, gates, carry, T,
                                      B, H, ndir, emit_t, stream);
  else if (H <= 1024)
    launch_upt<S, 2, kGates, kStream>(xs, w, lo, hi, h0, ys, gates, carry, T,
                                      B, H, ndir, emit_t, stream);
  else
    launch_upt<S, 4, kGates, kStream>(xs, w, lo, hi, h0, ys, gates, carry, T,
                                      B, H, ndir, emit_t, stream);
  CSR_RETURN_LAUNCH_STATUS();
}

// ---------------------------------------------------------------------------
// The bf16 forward on a thread-block cluster (csr_gru_fwd,
// csr_gru_fwd_train and csr_gru_fwd_stream under bf16 compute; layout in
// rnn_mma.cuh), the LSTM's design (csrc/lstm_fwd.cu) with three gates.
//
// Grid: C·groups x ndir blocks, C = H / kU, in clusters of C along x;
// cluster (group, d) serves rows [16 group, 16 group + 16) of direction d,
// block c of it the units [kU c, kU c + kU) with their r, z and n columns,
// so the gate math stays in the block. Its W slice, wt[d][c] = [3][kU][H]
// bf16 (element [g][u][k] = W[d][k][g H + kU c + u], laid out by the
// wrapper), is copied into shared memory once and read there for all T
// steps: the 3 kU rows (gate columns) of the product's B operand, k-major,
// so ldmatrix reads them without a transpose. A step:
//   1. the product: the group's 16 rows of h (bf16, where _dot2 rounds
//      it) times the W slice, split over kU / 2 warps: warp w takes unit
//      block w % (kU / 8) (8 units, three m16n8 accumulators, one a gate:
//      r and z from one ldmatrix.x4, n from an x2) and quarter w / (kU / 8)
//      of the H / 16 k-steps of mma.sync m16n8k16 (bf16 operands, fp32
//      accumulators, the next k-step's fragments loaded before the current
//      one's products); the four quarters' partial sums meet in shared
//      memory;
//   2. thread p owns the pair (row p / kU, unit p % kU): it adds the
//      quarters in a fixed order (no atomics: bitwise repeatable), and runs
//      the gate math on its fp32 h, which stays in its register for all T
//      steps. The recurrent n pre-activation hp_n = (h W_n) stays apart
//      from xs: n = tanh(x_n + r hp_n), and hp_n is the 4th residual;
//   3. the new h, rounded to bf16, goes into this block's columns of the
//      next A buffer, and from there into every other block's through
//      DSMEM; one cluster barrier a step (release / acquire) makes it
//      visible, the step's global stores made between its arrive and its
//      wait.
// Double buffering makes one barrier enough: a block writes buffer t % 2
// only after every block has passed the barrier that follows its reads of
// that buffer at step t - 2. The stream form (kStream) seeds each thread's
// fp32 h from h0 and A[0] from bf16(h0), every block filling all H columns
// of its 16 rows from global memory (rnn_mma.cuh's fill_h0), so step 0
// needs no exchange; it writes carry after step emit_t - 1's padding
// freeze, or h0 at entry when emit_t == 0. The three forms share the
// product and the gate math, so their ys are equal (the stream form's at
// h0 = 0).
//
// What bounds a step: each block reads its W slice (H x 3 kU bf16, 49.5
// KB at H = 256 and kU = 32) from shared memory once a step, runs the gate
// math of its 16 kU pairs and exchanges h. A stream window has few steps
// (T = 16-20), so the fixed cost weighs more there: the launch, the W
// slice's copy into shared memory and the first cluster barrier.
template <int kU, bool kResiduals, bool kStream>
__global__ void __launch_bounds__(csr_rnn_mma::kRows * kU, 1)
    gru_fwd_tc_kernel(const __nv_bfloat16* __restrict__ xs,
                      const __nv_bfloat16* __restrict__ wt,
                      const float* __restrict__ lo,
                      const float* __restrict__ hi,
                      const float* __restrict__ h0, float* __restrict__ ys,
                      __nv_bfloat16* __restrict__ gates,
                      float* __restrict__ carry, int T, int B, int H,
                      int emit_t) {
  namespace tc = csr_rnn_mma;
  constexpr int kM = tc::kRows, kN = 3 * kU;
  constexpr int kNB = kU / 8;              // unit blocks of 8 a block
  constexpr int kLd = tc::part_ld(kU);     // row stride of the partial sums
  constexpr int kQ = 3 * kM * kLd;         // floats a quarter's partials
  constexpr int kChunks = kU / 8;          // 16-byte chunks of a row's h
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = static_cast<int>(tc::cluster_nctarank());
  const int c = static_cast<int>(tc::cluster_ctarank());
  const int d = blockIdx.y, group = blockIdx.x / C;
  const int R = gridDim.y * B;
  const int G = 3 * H;
  const int row_b = tc::row_bytes(H);
  const uint32_t s_w = tc::smem_addr(smem);
  const uint32_t s_a = s_w + kN * row_b;         // A[2][kM]
  const uint32_t a_bytes = kM * row_b;
  // partial sums [4 quarters][3 gates][kM][kLd] fp32
  float* part = reinterpret_cast<float*>(smem + kN * row_b + 2 * a_bytes);
  const int tid = threadIdx.x, l = tid & 31, w = tid >> 5;

  // the W slice, once; A[0] = h_0: 0, or the stream form's bf16(h0)
  const __nv_bfloat16* wsrc = wt + (static_cast<int64_t>(d) * C + c) * kN * H;
  const int kc = H / 8;
  for (int i = tid; i < kN * kc; i += blockDim.x)
    tc::cp_async16(s_w + (i / kc) * row_b + (i % kc) * 16,
                   wsrc + static_cast<int64_t>(i / kc) * H + (i % kc) * 8,
                   true);
  tc::cp_async_commit();
  if (kStream)
    tc::fill_h0(smem + (s_a - s_w), h0 + (static_cast<int64_t>(d) * B +
                                          group * kM) * H,
                H, B - group * kM, H);
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
  // fragment addresses: A row l % 16 at k chunk l / 16; B rows of gates r
  // and z (x4: gate l / 16) and of gate n (x2) of unit 8 ub + l % 8 at k
  // chunk l / 8 % 2
  const int ub = w % kNB, qt = w / kNB, K = H / 16;
  const int k0 = K * qt / 4, k1 = K * (qt + 1) / 4;
  const uint32_t a_off = (l & 15) * row_b + (l >> 4) * 16 + k0 * 32;
  const uint32_t b_k = ((l >> 3) & 1) * 16 + k0 * 32;
  const uint32_t b_rz = s_w + (8 * ub + (l & 7) + (l >> 4) * kU) * row_b + b_k;
  const uint32_t b_n = s_w + (2 * kU + 8 * ub + (l & 7)) * row_b + b_k;
  // where this lane's accumulator elements go: gate g, row l / 4 (+ 8),
  // units 8 ub + 2 (l % 4) (+ 1) of quarter qt
  float* part_w = part + qt * kQ + (l >> 2) * kLd + 8 * ub + 2 * (l & 3);

  auto load_x = [&](int t, float (&v)[3]) {
    const __nv_bfloat16* xr = xs + (static_cast<int64_t>(t) * R + rr) * G + j;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      v[g] = valid ? __bfloat162float(xr[g * H]) : 0.0f;
  };
  float x[3];
  load_x(0, x);
  float h = 0.0f;
  const int64_t hc = static_cast<int64_t>(rr) * H + j;   // [R, H] h0, carry
  if (kStream && valid) {
    h = h0[hc];
    if (emit_t == 0) carry[hc] = h;
  }
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float nx[3];
    if (t + 1 < T) load_x(t + 1, nx);
    const uint32_t a_base = s_a + cur * a_bytes + a_off;
    float acc[3][4] = {};
    if (k0 < k1) {
      uint32_t a[4], brz[4], bn[2];
      tc::ldsm_x4(a_base, a);
      tc::ldsm_x4(b_rz, brz);
      tc::ldsm_x2(b_n, bn);
      for (int kk = 0; kk < k1 - k0; ++kk) {
        // the next k-step, clamped
        const int kn = kk + 1 < k1 - k0 ? kk + 1 : kk;
        uint32_t na[4], nrz[4], nn[2];
        tc::ldsm_x4(a_base + kn * 32, na);
        tc::ldsm_x4(b_rz + kn * 32, nrz);
        tc::ldsm_x2(b_n + kn * 32, nn);
        tc::mma(acc[0], a, brz[0], brz[1]);
        tc::mma(acc[1], a, brz[2], brz[3]);
        tc::mma(acc[2], a, bn[0], bn[1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = na[q];
          brz[q] = nrz[q];
        }
        bn[0] = nn[0];
        bn[1] = nn[1];
      }
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(part_w + (g * kM + 8 * i) * kLd) =
            make_float2(acc[g][2 * i], acc[g][2 * i + 1]);
    __syncthreads();
    float pre[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float* p = part + (g * kM + r) * kLd + u;
      pre[g] = ((p[0] + p[kQ]) + p[2 * kQ]) + p[3 * kQ];
    }
    const float rg = sigmoidf(x[0] + pre[0]);
    const float z = sigmoidf(x[1] + pre[1]);
    const float n = tanhf(x[2] + rg * pre[2]);
    const float hn = (1.0f - z) * n + z * h;
    const float tf = static_cast<float>(t);
    if (lo_r <= tf && tf < hi_r) h = hn;
    const int nxt = cur ^ 1;
    const bool more = t + 1 < T;
    if (more) {
      // h into this block's columns of A[nxt], then its 16 rows x 2 kU
      // bytes into every other block's
      const uint32_t s_nxt = s_a + nxt * a_bytes;
      reinterpret_cast<__nv_bfloat16*>(smem + (s_nxt - s_w) + r * row_b)[j] =
          __float2bfloat16_rn(h);
      __syncthreads();
      for (int q = tid; q < (C - 1) * kM * kChunks; q += blockDim.x) {
        const int p = q / (kM * kChunks), e = q % (kM * kChunks);
        const uint32_t ad = s_nxt + (e / kChunks) * row_b + c * kU * 2 +
                            (e % kChunks) * 16;
        tc::st_cluster16(tc::map_rank(ad, p + (p >= c)), tc::ld_shared16(ad));
      }
      tc::cluster_arrive();
    }
    if (valid) {
      const int64_t row = static_cast<int64_t>(t) * R + rr;
      ys[row * H + j] = h;
      if (kResiduals) {
        __nv_bfloat16* gt = gates + row * 4 * H + j;
        gt[0] = __float2bfloat16_rn(rg);
        gt[H] = __float2bfloat16_rn(z);
        gt[2 * H] = __float2bfloat16_rn(n);
        gt[3 * H] = __float2bfloat16_rn(pre[2]);
      }
      if (kStream && t == emit_t - 1) carry[hc] = h;
    }
    if (more) {
      tc::cluster_wait();
#pragma unroll
      for (int g = 0; g < 3; ++g) x[g] = nx[g];
    }
    cur = nxt;
  }
}

// units a block of the cluster kernel (ops/rnn_cuda.py's gru_plan; 16
// were no faster at bigru's H = 256: csrc/rnn_mma.cuh, gru_bwd_units)
constexpr int kTcUnits = csr_rnn_mma::kUnits;

template <bool kResiduals, bool kStream>
int launch_tc(const void* xs, const void* wt, const float* lo,
              const float* hi, const float* h0, float* ys, void* gates,
              float* carry, int T, int B, int H, int ndir, int emit_t, int C,
              cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  if (C * kTcUnits != H) return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_clusters(
      gru_fwd_tc_kernel<kTcUnits, kResiduals, kStream>, C,
      (B + tc::kRows - 1) / tc::kRows, ndir, tc::kRows * kTcUnits,
      tc::fwd_smem(H, 3, kTcUnits), stream,
      static_cast<const __nv_bfloat16*>(xs),
      static_cast<const __nv_bfloat16*>(wt), lo, hi, h0, ys,
      static_cast<__nv_bfloat16*>(gates), carry, T, B, H, emit_t);
}

// ---------------------------------------------------------------------------
// The bf16 forward past H = 512, W streamed (rnn_mma.cuh's streamed-W form;
// the same three entries under bf16 compute): csrc/lstm_fwd.cu's
// lstm_fwd_wide_kernel with three gates. Warp w of block c owns the 8
// units of unit block ub = U c / 8 + w with their r, z and n columns, over
// the whole reduction (B fragments wf[d][ub] = [H / 16][3][32 lanes] uint2,
// ops/rnn_cuda.py's wide_fwd_weights, streamed kP k-steps ahead); each
// lane runs the gate math of its accumulators' pairs (rows l / 4 and
// l / 4 + 8, units 8 ub + 2 (l % 4) + {0, 1}), keeping hp_n = h W_n apart
// (n = tanh(x_n + r hp_n), the 4th residual), and the block pushes its
// columns of the next A buffer to every peer over DSMEM; one cluster
// barrier a step.
template <bool kResiduals, bool kStream, int kP>
__global__ void __launch_bounds__(csr_rnn_mma::wide_max_threads(kP), 1)
    gru_fwd_wide_kernel(const __nv_bfloat16* __restrict__ xs,
                        const uint2* __restrict__ wf,
                        const float* __restrict__ lo,
                        const float* __restrict__ hi,
                        const float* __restrict__ h0, float* __restrict__ ys,
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
  const int G = 3 * H;
  const int row_b = tc::row_bytes(H);
  const uint32_t s_a = tc::smem_addr(smem);    // A[2][kM]
  const uint32_t a_bytes = kM * row_b;
  const int tid = threadIdx.x, l = tid & 31, w = tid >> 5;
  const int u0 = c * U, uc = min(U, H - u0);   // this block's units
  const bool active = 8 * w < uc;              // this warp's unit block
  const int j = u0 + 8 * w + 2 * (l & 3);      // this lane's units j, j + 1

  // A[0] = h_0: 0, or the stream form's bf16(h0)
  if (kStream)
    tc::fill_h0(smem, h0 + (static_cast<int64_t>(d) * B + group * kM) * H, H,
                B - group * kM, H);
  else
    tc::zero_shared(smem, a_bytes);
  __syncthreads();
  tc::cluster_sync();   // every peer has started before DSMEM stores

  // this lane's rows i = 0, 1: l / 4 and l / 4 + 8 of the group
  bool valid[2];
  int rr[2];
  float lo_r[2], hi_r[2], h[2][2] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int b = group * kM + (l >> 2) + 8 * i;
    valid[i] = active && b < B;
    rr[i] = d * B + b;
    lo_r[i] = valid[i] ? lo[rr[i]] : 0.0f;
    hi_r[i] = valid[i] ? hi[rr[i]] : 0.0f;   // never live
    if (kStream && valid[i]) {
      const float* src = h0 + static_cast<int64_t>(rr[i]) * H + j;
      h[i][0] = src[0];
      h[i][1] = src[1];
      if (emit_t == 0)
        *reinterpret_cast<float2*>(carry + static_cast<int64_t>(rr[i]) * H +
                                   j) = make_float2(h[i][0], h[i][1]);
    }
  }
  // A row l % 16 at k chunk l / 16; this warp's fragments
  const uint32_t a_off = (l & 15) * row_b + (l >> 4) * 16;
  const uint2* wb =
      wf + (static_cast<int64_t>(d) * (H / 8) + u0 / 8 + w) * K * 3 * 32 + l;

  // xs of the lane's pairs: [row i][gate g] as (unit j, unit j + 1)
  auto load_x = [&](int t, float2 (&v)[2][3]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* xr =
          xs + (static_cast<int64_t>(t) * R + rr[i]) * G + j;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        v[i][g] = valid[i] ? __bfloat1622float2(
                                 *reinterpret_cast<const __nv_bfloat162*>(
                                     xr + g * H))
                           : make_float2(0.0f, 0.0f);
    }
  };
  float2 x[2][3];
  load_x(0, x);
  uint2 ring[kP][3];      // this warp's B fragments in flight
  if (active) tc::stream_prefetch<3, kP>(wb, K, ring);
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float2 nx[2][3];
    if (t + 1 < T) load_x(t + 1, nx);
    float acc[3][4] = {};
    if (active) {
      tc::streamed_product<3, kP>(s_a + cur * a_bytes + a_off, wb, K, ring,
                                   acc);
      // the next step's first fragments, in flight over the gate math,
      // the exchange and the barrier
      if (t + 1 < T) tc::stream_prefetch<3, kP>(wb, K, ring);
    }
    // gate math of the lane's pairs (accumulator element 2 i + e: row i,
    // unit j + e); gv: (r, z, n, hp_n)
    float gv[2][2][4];
    const float tf = static_cast<float>(t);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xe[3] = {e ? x[i][0].y : x[i][0].x,
                             e ? x[i][1].y : x[i][1].x,
                             e ? x[i][2].y : x[i][2].x};
        const float hp_n = acc[2][2 * i + e];
        const float rg = sigmoidf(xe[0] + acc[0][2 * i + e]);
        const float z = sigmoidf(xe[1] + acc[1][2 * i + e]);
        const float n = tanhf(xe[2] + rg * hp_n);
        const float hn = (1.0f - z) * n + z * h[i][e];
        if (lo_r[i] <= tf && tf < hi_r[i]) h[i][e] = hn;
        gv[i][e][0] = rg;
        gv[i][e][1] = z;
        gv[i][e][2] = n;
        gv[i][e][3] = hp_n;
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
        __nv_bfloat16* gt = gates + row * 4 * H + j;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          *reinterpret_cast<__nv_bfloat162*>(gt + g * H) =
              __floats2bfloat162_rn(gv[i][0][g], gv[i][1][g]);
      }
      if (kStream && t == emit_t - 1)
        *reinterpret_cast<float2*>(carry + static_cast<int64_t>(rr[i]) * H +
                                   j) = make_float2(h[i][0], h[i][1]);
    }
    if (more) {
      tc::cluster_wait();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g) x[i][g] = nx[i][g];
    }
    cur = nxt;
  }
}

template <bool kResiduals, bool kStream, int kP>
int launch_wide_kp(const void* xs, const void* wf, const float* lo,
                   const float* hi, const float* h0, float* ys, void* gates,
                   float* carry, int T, int B, int H, int ndir, int emit_t,
                   cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  return tc::launch_clusters(
      gru_fwd_wide_kernel<kResiduals, kStream, kP>, tc::wide_cluster(H),
      (B + tc::kRows - 1) / tc::kRows, ndir, tc::wide_fwd_threads(H),
      tc::wide_fwd_smem(H), stream, static_cast<const __nv_bfloat16*>(xs),
      static_cast<const uint2*>(wf), lo, hi, h0, ys,
      static_cast<__nv_bfloat16*>(gates), carry, T, B, H, emit_t);
}

// the bf16 forms: the resident cluster kernel up to H = 512, W streamed
// above
template <bool kResiduals, bool kStream>
int launch_bf16(const void* xs, const void* wt, const float* lo,
                const float* hi, const float* h0, float* ys, void* gates,
                float* carry, int T, int B, int H, int ndir, int emit_t,
                int C, cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  if (H <= tc::kResidentMax)
    return launch_tc<kResiduals, kStream>(xs, wt, lo, hi, h0, ys, gates,
                                          carry, T, B, H, ndir, emit_t, C,
                                          stream);
  if (C != tc::wide_cluster(H)) return static_cast<int>(cudaErrorInvalidValue);
  switch (tc::wide_prefetch(tc::wide_fwd_threads(H))) {
    case 16:
      return launch_wide_kp<kResiduals, kStream, 16>(
          xs, wt, lo, hi, h0, ys, gates, carry, T, B, H, ndir, emit_t,
          stream);
    case 8:
      return launch_wide_kp<kResiduals, kStream, 8>(
          xs, wt, lo, hi, h0, ys, gates, carry, T, B, H, ndir, emit_t,
          stream);
    default:
      return launch_wide_kp<kResiduals, kStream, 4>(
          xs, wt, lo, hi, h0, ys, gates, carry, T, B, H, ndir, emit_t,
          stream);
  }
}

}  // namespace

// xs [T, ndir*B, 3H] and w [ndir, H, 3H] both fp32 (the FMA kernel), or,
// when bf16 != 0, xs bf16 and w = wt [ndir, C, 3, H/C, H] bf16 (the
// cluster kernel: C = H / 32 blocks a cluster, ops/rnn_cuda.py's
// gru_plan; past H = 512 the streamed-W fragments [ndir, H/8, H/16, 3, 32,
// 4] and C = wide_cluster(H), rnn_cuda.wide_fwd_weights; unread under
// fp32); lo/hi [ndir*B] fp32; ys [T, ndir*B, H] fp32. Requires 32 <= H <=
// 2048, H % 32 == 0, T >= 1, B >= 1, ndir 1 or 2 (the wrapper checks).
CSR_API int csr_gru_fwd(const void* xs, const void* w, const float* lo,
                        const float* hi, float* ys, int T, int B, int H,
                        int ndir, int C, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch_bf16<false, false>(xs, w, lo, hi, nullptr, ys, nullptr,
                                     nullptr, T, B, H, ndir, 0, C, stream);
  return launch<float, false, false>(xs, w, lo, hi, nullptr, ys, nullptr,
                                     nullptr, T, B, H, ndir, 0, stream);
}

// As csr_gru_fwd (ndir 1 or 2 likewise: a forward-only layer runs its one
// W over its B rows), plus gates [T, ndir*B, 4H] in the stream dtype (the
// dtype of xs) out: (r, z, n, hp_n) of every step, live or not.
CSR_API int csr_gru_fwd_train(const void* xs, const void* w, const float* lo,
                              const float* hi, float* ys, void* gates, int T,
                              int B, int H, int ndir, int C, int bf16,
                              cudaStream_t stream) {
  if (bf16)
    return launch_bf16<true, false>(xs, w, lo, hi, nullptr, ys, gates,
                                    nullptr, T, B, H, ndir, 0, C, stream);
  return launch<float, true, false>(xs, w, lo, hi, nullptr, ys, gates,
                                    nullptr, T, B, H, ndir, 0, stream);
}

// The cluster forward's plan as the card takes it: out[0] = its shared
// memory bytes at hidden size H (C = H / 32 blocks), out[1] = how many of
// its clusters the card holds at once (cudaOccupancyMaxActiveClusters; 0:
// it cannot launch).
CSR_API int csr_gru_fwd_occupancy(int H, int* out) {
  namespace tc = csr_rnn_mma;
  if (H > tc::kResidentMax) {
    const int threads = tc::wide_fwd_threads(H);
    out[0] = tc::wide_fwd_smem(H);
    const int kP = tc::wide_prefetch(threads);
    auto kernel = kP == 16  ? gru_fwd_wide_kernel<true, false, 16>
                  : kP == 8 ? gru_fwd_wide_kernel<true, false, 8>
                            : gru_fwd_wide_kernel<true, false, 4>;
    return tc::max_clusters(kernel, tc::wide_cluster(H), threads, out[0],
                            out + 1);
  }
  out[0] = tc::fwd_smem(H, 3, kTcUnits);
  return tc::max_clusters(gru_fwd_tc_kernel<kTcUnits, true, false>,
                          H / kTcUnits,
                          tc::kRows * kTcUnits, out[0], out + 1);
}

// As csr_gru_fwd (w and C likewise), with h seeded from h0 [ndir*B, H]
// fp32 and carry [ndir*B, H] fp32 out: h after step emit_t - 1, h0 when
// emit_t == 0. Requires 0 <= emit_t <= T (the wrapper checks).
CSR_API int csr_gru_fwd_stream(const void* xs, const void* w,
                               const float* lo, const float* hi,
                               const float* h0, float* ys, float* carry,
                               int T, int B, int H, int ndir, int emit_t,
                               int C, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch_bf16<false, true>(xs, w, lo, hi, h0, ys, nullptr, carry, T,
                                    B, H, ndir, emit_t, C, stream);
  return launch<float, false, true>(xs, w, lo, hi, h0, ys, nullptr, carry, T,
                                    B, H, ndir, emit_t, stream);
}
