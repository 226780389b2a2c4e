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
// Three kernels. The bf16 forms, all three (the presets' path), run the
// step product on the tensor cores: up to H = 512 on a thread-block
// cluster with W resident in the cluster's shared memory
// (gru_fwd_tc_kernel, below; one template over kResiduals and kStream),
// above as one persistent cooperative launch over the whole card, W spread
// over its blocks' shared memory (gru_fwd_persist_kernel, further below).
// The fp32 forms run the FMA kernel (gru_fwd_kernel, one template over
// kGates and kStream).
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
// The bf16 forward past H = 512: the persistent form (rnn_mma.cuh; the same
// three entries under bf16 compute).
//
// What bounds it on Hopper: a step multiplies every row of a direction by
// all of its W (3 H^2 bf16: 6.3 MB at H = 1024, 25.2 MB at 2048), and the
// T steps run one after another. The clustered form that came before read
// W from L2 once per 16-row group at every step, on the 16 SMs of one
// cluster per group and direction: twice a step at B = 24 or 32, with at
// most 64 of the 132 SMs reading (11.0 µs a step at H = 1024, 33.5 at
// 2048 in the stream window, where cuDNN took 9.1 and 16.5).
//
// What this design does about it: W is spread over the whole card and
// read once a step for all rows. Block (d, cb) of the NB ndir blocks owns
// nt n8 tiles of units, tiles [nt cb, nt cb + nt), with their r, z and n
// columns (nc = 3 nt B columns), so the gate math stays in the block; its
// slice of W, wf[d][cb] = [K = H / 16][nc][32 lanes] uint2 in mma.sync
// fragment order (ops/rnn_cuda.py's persist_fwd_weights), is copied into
// shared memory once a launch (the first kr k-steps of each warp's range
// where the whole slice does not fit, the rest read from L2 at each step;
// at H = 2048 and ndir 1 all 196 KB of it fit). On a card of fewer than
// ndir H / 32 SMs a block owns more than kGroupTiles tiles and runs them
// as groups of NT (rnn_mma.cuh), steps 1-2 once a group in turn, the
// group's slice [K][nc][32] after the one before it. A step, for each
// pass of 32 rows (B > 32 takes more passes, B <= 16 one m16 tile):
//   1. the product: warp w of four multiplies the pass's rows of h
//      (bf16, where _dot2 rounds it; A fragments from the global buffer,
//      one 16- or 8-byte load a lane, P k-steps ahead) by the block's columns
//      over its quarter of the K k-steps, each B fragment feeding both m16
//      tiles;
//   2. the quarters meet in shared memory; a slot (m-tile, tile, lane)
//      adds them in warp order (no atomics: bitwise repeatable) and runs
//      the gate math of its two rows and two units, hp_n = h W_n kept
//      apart from xs (n = tanh(x_n + r hp_n), the 4th residual). With one
//      pass, one group and one slot a thread (B <= 32, nt <= 2) the slot
//      keeps its
//      fp32 h in registers and its xs, lo and hi for the next step are
//      loaded during the barrier; otherwise h_prev is read back from ys[t
//      - 1] (or h0 / 0) and xs at the step;
//   3. the new h, rounded to bf16, goes into the next step's A buffer in
//      global memory (two buffers, by step parity), then one grid barrier
//      (rnn_mma.cuh's grid_arrive / grid_wait): a block writes buffer
//      (t + 1) % 2 only after every block has passed the barrier that ends
//      its reads of it.
// Measured on an H100 (tools/kernel_ab.py --cases rnn_wide, against this
// build and copies of it with a part of the step left out; PERF.md): a
// step is the grid barrier (3-11%), the gate math with its loads, and the
// product (54-74%), which is held by the latency of its A loads from L2
// (every block reads the whole A; with A from shared memory the step
// would take 0.65-0.86 of its time, with half the A bytes 0.96-1.01)
// rather than by the mma.sync chain (3-8%).
// At t = 0 the product of h_0 = 0 is skipped (it is +0 exactly); the
// stream form (kStream) first writes bf16(h0) of its units into A[0] and
// passes one more barrier, seeds h_prev from h0 and writes carry after
// step emit_t - 1 (h0 at entry when emit_t == 0). The three forms share the
// product and the gate math, so their ys are equal (the stream form's at
// h0 = 0). The launch is cooperative (rnn_mma.cuh's launch_cooperative):
// all NB ndir <= sms blocks are resident, or it fails.
constexpr int kFwdWarps = 4;   // warps a block of the persistent form

// a slot's inputs at one step: xs of its two rows (the bf16 pairs of its
// two units, gates r, z, n) and the rows' lo and hi
struct GruIn {
  uint32_t x[2][3];
  float lo[2], hi[2];
};

template <int NT, int P, bool kSt, bool kResiduals, bool kStream>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
    gru_fwd_persist_kernel(const __nv_bfloat16* __restrict__ xs,
                           const uint2* __restrict__ wf,
                           const float* __restrict__ lo,
                           const float* __restrict__ hi,
                           const float* __restrict__ h0,
                           float* __restrict__ ys,
                           __nv_bfloat16* __restrict__ gates,
                           float* __restrict__ carry, unsigned int* counter,
                           uint4* abuf, int T, int B, int H, int NB,
                           int tiles, int groups, int kr, int emit_t) {
  namespace tc = csr_rnn_mma;
  // NT: tiles a group (nw8); the block's `tiles` run as `groups` of them
  constexpr int NC = 3 * NT, kW = kFwdWarps;
  // slots (m-tile, tile, lane) a thread, and whether one pass of one slot
  // a thread can keep the slot's h and next inputs in registers
  constexpr int kSlots = (2 * NT * 32 + 32 * kW - 1) / (32 * kW);
  constexpr bool kCanHold = kSlots == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);
  unsigned char* res = smem + tc::persist_part(NC, kW);
  const int ndir = gridDim.x / NB;
  const int d = blockIdx.x / NB, cb = blockIdx.x % NB;
  const int R = ndir * B, G = 3 * H, K = H / 16, nt_all = H / 8;
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
  const tc::WarpSteps ws = tc::warp_steps(w, kW, K, kr, cb, NB);
  // group 0's resident fragments of this warp's lane (a shared-space
  // address) and its streamed ones (group g's kW kr NC 256 bytes and K NC
  // 32 uint2 further on)
  const uint32_t sb = tc::smem_addr(res) + (w * kr * NC * 32 + l) * 8;
  const uint2* gb = slice + int64_t(ws.kb) * NC * 32 + l;
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
    GruIn in;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = row_of(p, o, i);
      const bool valid = b < B;
      const int64_t rr = int64_t(d) * B + b, row = int64_t(t) * R + rr;
      in.lo[i] = valid ? lo[rr] : 0.0f;   // rows past B: never live
      in.hi[i] = valid ? hi[rr] : 0.0f;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        in.x[i][g] = valid ? *reinterpret_cast<const uint32_t*>(
                                 xs + row * G + g * H + o.j)
                           : 0u;
    }
    return in;
  };
  GruIn held[kCanHold ? kSlots : 1];
  float2 hreg[kCanHold ? kSlots : 1][2];

  // h_0: 0, or the stream form's h0 (and bf16(h0) into A[0])
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
          float2 v = make_float2(0.0f, 0.0f);
          if (kStream) {
            if (b < B)
              v = *reinterpret_cast<const float2*>(h0 + rr * H + o.j);
            *tc::a_word(a_of(0, p, o.m), o.j, i, o.ls) = tc::bf16x2(v.x, v.y);
            if (b < B && emit_t == 0)
              *reinterpret_cast<float2*>(carry + rr * H + o.j) = v;
          }
          if (kCanHold) hreg[kCanHold ? q : 0][i] = v;
        }
      if (hold) held[kCanHold ? q : 0] = load_in(0, 0, o);
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
    // the many-group copy's ring one k-step shallower, for fewer
    // registers in that copy
    constexpr int kP = decltype(tag)::one || P < 2 ? P : P - 1;
    const int cur = t & 1;
    const bool product = kStream || t > 0;
    const float tf = static_cast<float>(t);
    if (product) {
      const int rp = B - p * tc::kPassRows;   // rows of the pass (> 0)
      float acc[2][NC][4] = {};
      tc::persist_product<NC, kP, kSt>(
          acc, a_of(cur, p, 0) + ws.kb * 32 + l,
          a_of(cur, p, 1) + ws.kb * 32 + l, two, rp > 8, rp > 24, ws.kw,
          ws.kres, ws.rot, sb + gr * kW * kr * NC * 256,
          gb + int64_t(gr) * K * NC * 32);
      tc::store_partials<NC>(part, acc, two, w, l);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const Slot o = slot_of(q, gr, nt);
      if (!o.own) continue;
      float4 pre[3];
#pragma unroll
      for (int g = 0; g < 3; ++g)
        pre[g] = product ? tc::sum_partials(part, kW, NC, o.m, 3 * o.ti + g,
                                            o.ls)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const GruIn in = keep ? held[kCanHold ? q : 0] : load_in(t, p, o);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = row_of(p, o, i);
        const bool valid = b < B;
        const int64_t rr = int64_t(d) * B + b;
        const int64_t row = int64_t(t) * R + rr;
        float2 hp = make_float2(0.0f, 0.0f), x[3];
        if (keep) {
          hp = hreg[kCanHold ? q : 0][i];
        } else if (valid) {
          if (t > 0)
            hp = *reinterpret_cast<const float2*>(ys + (row - R) * H + o.j);
          else if (kStream)
            hp = *reinterpret_cast<const float2*>(h0 + rr * H + o.j);
        }
#pragma unroll
        for (int g = 0; g < 3; ++g)
          x[g] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&in.x[i][g]));
        const bool live = in.lo[i] <= tf && tf < in.hi[i];
        float h[2], gv[2][4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          auto pick = [&](const float4& v) {
            return i ? (e ? v.w : v.z) : (e ? v.y : v.x);
          };
          const float hp_n = pick(pre[2]);
          const float rg = sigmoidf((e ? x[0].y : x[0].x) + pick(pre[0]));
          const float z = sigmoidf((e ? x[1].y : x[1].x) + pick(pre[1]));
          const float n = tanhf((e ? x[2].y : x[2].x) + rg * hp_n);
          const float hv = e ? hp.y : hp.x;
          const float hn = (1.0f - z) * n + z * hv;
          h[e] = live ? hn : hv;
          gv[e][0] = rg;
          gv[e][1] = z;
          gv[e][2] = n;
          gv[e][3] = hp_n;
        }
        if (kCanHold && decltype(tag)::one)
          hreg[kCanHold ? q : 0][i] = make_float2(h[0], h[1]);
        if (t + 1 < T)
          *tc::a_word(a_of(cur ^ 1, p, o.m), o.j, i, o.ls) =
              tc::bf16x2(h[0], h[1]);
        if (!valid) continue;
        *reinterpret_cast<float2*>(ys + row * H + o.j) =
            make_float2(h[0], h[1]);
        if (kResiduals)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            *reinterpret_cast<uint32_t*>(gates + row * 4 * H + g * H + o.j) =
                tc::bf16x2(gv[0][g], gv[1][g]);
        if (kStream && t == emit_t - 1)
          *reinterpret_cast<float2*>(carry + rr * H + o.j) =
              make_float2(h[0], h[1]);
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
            if (o.own) held[kCanHold ? q : 0] = load_in(t + 1, 0, o);
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
// persist_plan("gru_fwd", ...))
csr_rnn_mma::PersistPlan fwd_persist_plan(int H, int ndir, int B,
                                          int sms) {
  return csr_rnn_mma::persist_plan(H, ndir, B, sms, 3, H / 16, kFwdWarps,
                                   0);
}

// the persistent kernel of groups of `width` tiles (P k-steps of loads in
// flight a warp; the slice may not fit shared memory past two tiles: a
// block of more than one group has groups of three or four)
template <bool kResiduals, bool kStream, typename Fn>
int with_persist_kernel(int width, Fn&& fn) {
  static_assert(csr_rnn_mma::kGroupTiles == 4, "a kernel a group width");
  switch (width) {
    case 1:
      return fn(gru_fwd_persist_kernel<1, 12, false, kResiduals, kStream>);
    case 2:
      return fn(gru_fwd_persist_kernel<2, 8, false, kResiduals, kStream>);
    case 3:
      return fn(gru_fwd_persist_kernel<3, 3, true, kResiduals, kStream>);
    case 4:
      return fn(gru_fwd_persist_kernel<4, 2, true, kResiduals, kStream>);
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
                const float* hi, const float* h0, float* ys, void* gates,
                float* carry, void* work, int T, int B, int H, int ndir,
                int emit_t, int C, int sms, cudaStream_t stream) {
  namespace tc = csr_rnn_mma;
  if (H <= tc::kResidentMax)
    return launch_tc<kResiduals, kStream>(xs, wt, lo, hi, h0, ys, gates,
                                          carry, T, B, H, ndir, emit_t, C,
                                          stream);
  const cudaError_t e = tc::check_sms(sms, ndir);
  if (e != cudaSuccess) return static_cast<int>(e);
  const tc::PersistPlan p = fwd_persist_plan(H, ndir, B, sms);
  if (C != p.blocks || work == nullptr ||
      (p.width <= 2 && p.resident * kFwdWarps < H / 16))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned int* counter = static_cast<unsigned int*>(work);
  uint4* abuf = reinterpret_cast<uint4*>(static_cast<char*>(work) + 256);
  return with_persist_kernel<kResiduals, kStream>(p.width, [&](auto kernel) {
    return tc::launch_cooperative(
        kernel, p.blocks * ndir, 32 * kFwdWarps, p.smem, stream, counter,
        static_cast<const __nv_bfloat16*>(xs), static_cast<const uint2*>(wt),
        lo, hi, h0, ys, static_cast<__nv_bfloat16*>(gates), carry, counter,
        abuf, T, B, H, p.blocks, p.tiles, p.groups, p.resident, emit_t);
  });
}

}  // namespace

// xs [T, ndir*B, 3H] and w [ndir, H, 3H] both fp32 (the FMA kernel), or,
// when bf16 != 0, xs bf16 and w = wt [ndir, C, 3, H/C, H] bf16 (the
// cluster kernel: C = H / 32 blocks a cluster, ops/rnn_cuda.py's
// gru_plan; past H = 512 the persistent form's fragments [ndir, C,
// ng·H/16, nw8, 3, 32, 4], C its blocks a direction, on a card of `sms`
// SMs, rnn_cuda.persist_fwd_weights; unread under fp32); lo/hi [ndir*B]
// fp32; ys [T, ndir*B, H] fp32; work the persistent form's workspace
// (csr_gru_fwd_persist_plan's bytes; unread elsewhere); sms the SM count
// the persistent plan was made for (ndir <= sms <= the card's; unread
// elsewhere). Requires 32 <= H <= 2048, H % 32 == 0, T >= 1, B >= 1,
// ndir 1 or 2 (the wrapper checks).
CSR_API int csr_gru_fwd(const void* xs, const void* w, const float* lo,
                        const float* hi, float* ys, void* work, int T, int B,
                        int H, int ndir, int C, int sms, int bf16,
                        cudaStream_t stream) {
  if (bf16)
    return launch_bf16<false, false>(xs, w, lo, hi, nullptr, ys, nullptr,
                                     nullptr, work, T, B, H, ndir, 0, C, sms,
                                     stream);
  return launch<float, false, false>(xs, w, lo, hi, nullptr, ys, nullptr,
                                     nullptr, T, B, H, ndir, 0, stream);
}

// As csr_gru_fwd (ndir 1 or 2 likewise: a forward-only layer runs its one
// W over its B rows), plus gates [T, ndir*B, 4H] in the stream dtype (the
// dtype of xs) out: (r, z, n, hp_n) of every step, live or not.
CSR_API int csr_gru_fwd_train(const void* xs, const void* w, const float* lo,
                              const float* hi, float* ys, void* gates,
                              void* work, int T, int B, int H, int ndir,
                              int C, int sms, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch_bf16<true, false>(xs, w, lo, hi, nullptr, ys, gates,
                                    nullptr, work, T, B, H, ndir, 0, C, sms,
                                    stream);
  return launch<float, true, false>(xs, w, lo, hi, nullptr, ys, gates,
                                    nullptr, T, B, H, ndir, 0, stream);
}

// The cluster forward's plan as the card takes it (H <= 512): out[0] = its
// shared memory bytes at hidden size H (C = H / 32 blocks), out[1] = how
// many of its clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot launch). Past H = 512 see
// csr_gru_fwd_persist_plan.
CSR_API int csr_gru_fwd_occupancy(int H, int* out) {
  namespace tc = csr_rnn_mma;
  if (H > tc::kResidentMax) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = tc::fwd_smem(H, 3, kTcUnits);
  return tc::max_clusters(gru_fwd_tc_kernel<kTcUnits, true, false>,
                          H / kTcUnits,
                          tc::kRows * kTcUnits, out[0], out + 1);
}

// The persistent forward's plan as the card takes it at hidden size H >
// 512, ndir directions, B rows a direction and `sms` SMs
// (rnn_mma.cuh's report_plan; out: 8 int64; A is read from L2, so a
// slot's k-steps are 0). cudaErrorInvalidValue where sms is below ndir
// or above the card's.
CSR_API int csr_gru_fwd_persist_plan(int H, int ndir, int B, int sms,
                                     long long* out) {
  namespace tc = csr_rnn_mma;
  const cudaError_t e = tc::check_sms(sms, ndir);
  if (e != cudaSuccess) return static_cast<int>(e);
  const tc::PersistPlan p = fwd_persist_plan(H, ndir, B, sms);
  return with_persist_kernel<true, false>(p.width, [&](auto kernel) {
    return tc::report_plan(p, kernel, 32 * kFwdWarps, out);
  });
}

// As csr_gru_fwd (w, C, sms and work likewise), with h seeded from h0
// [ndir*B, H] fp32 and carry [ndir*B, H] fp32 out: h after step emit_t -
// 1, h0 when emit_t == 0. Requires 0 <= emit_t <= T (the wrapper checks).
CSR_API int csr_gru_fwd_stream(const void* xs, const void* w,
                               const float* lo, const float* hi,
                               const float* h0, float* ys, float* carry,
                               void* work, int T, int B, int H, int ndir,
                               int emit_t, int C, int sms, int bf16,
                               cudaStream_t stream) {
  if (bf16)
    return launch_bf16<false, true>(xs, w, lo, hi, h0, ys, nullptr, carry,
                                    work, T, B, H, ndir, emit_t, C, sms,
                                    stream);
  return launch<float, false, true>(xs, w, lo, hi, h0, ys, nullptr, carry, T,
                                    B, H, ndir, emit_t, stream);
}
