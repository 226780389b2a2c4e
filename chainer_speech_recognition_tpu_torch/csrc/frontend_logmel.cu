// Fused log-mel front-end: framing -> Hann window -> real FFT power ->
// slaney mel -> log, fp32.
//
// Replaces frontend/pallas_frontend.py::_kernel_rows + _dft_mel_log (the
// TPU kernel behind fused_logmel_rows / batch_features_pallas) and, in its
// framed form, ::_kernel (the TPU kernel behind fused_logmel).
//
// Input is the reflect-extended signal [B, ext_len] fp32 (built by
// frontend/torch_frontend.py::extend_signal); frame t is the 512 samples
// ext[b, t*160 : t*160 + 512]. The framed form (csr_frontend_logmel_frames)
// reads pre-framed, un-windowed input [B, T, 512] fp32 instead and shares
// everything past the load. Output is [B, T, n_mels] fp32
// log(max(mel, 1e-10)).
//
// What bounds it on Hopper: bytes. The function reads the signal once and
// writes [B, T, 40]; a 512-point real FFT is ~12 kFLOP a frame and the mel
// filters are triangles (each bin feeds at most two), so its arithmetic is
// ~17 kFLOP a frame, about the time of its bytes at the fp32 rate. The TPU
// kernel computed a dense DFT on its matrix unit (bf16 x3 split); the
// port's first version a dense fp32 FMA DFT (~0.53 MFLOP a frame, 30x the
// FFT's work, arithmetic-bound). This version computes the FFT.
//
// Design: one block per (utterance, tile of kFrames = 32 frames), 4 warps
// (8 in the framed form). The block copies the tile's signal into shared memory once with
// 16-byte loads (the extended form: the contiguous span from the first
// frame's window start to the last frame's window end, (kFrames-1)*160 +
// 400 samples; the framed form: each frame's 400 windowed samples). The
// host tables (twiddles, window, mel ranges and weights: fft_tables() in
// frontend/cuda_frontend.py, computed in fp64, stored fp32; 8 KB) are
// read from device memory through L1, where every block of an SM finds
// them (a per-block copy into shared memory measured slower). No frames
// or spectra reach device memory. Each warp then transforms one frame at a
// time, all in registers and a 2.6 KB warp-private scratch:
//   * the windowed frame x packed as 256 complex points z[n] = x[2n] +
//     i x[2n+1]; lane n1 loads z[n1 + 32 n2], n2 < 8;
//   * stage 1: a radix-8 DFT over n2 in each lane, twiddle W256^(n1 k2);
//   * stage 2: lane (k2, m1) takes the values of lanes m1 + 4 m2 through a
//     second radix-8 DFT, twiddle W32^(m1 j2);
//   * stage 3: two radix-4 DFTs a lane give Z[64 j1 + 8 j2 + k2];
//   * the post-twiddle X[k] = (Z[k] + Z*[256-k])/2 + W512^k (Z[k] -
//     Z*[256-k])/2i splits Z into the 257 bins of the real frame; the
//     power goes to the scratch, each mel filter is summed over its bin
//     range (the wide ones split over four lanes), then the log.
// The scratch layouts between stages are padded (rows of 36 and 10 pairs)
// so a warp's accesses touch each bank pair at most twice. Against the
// plain version (cuFFT's rfft, the mel matmul, log) the FFT's rounding is
// of the same order (~2e-7 of a frame's largest bin; ~2e-5 on the log-mel,
// under the 5e-4 bar: tests/test_torch_frontend_fft.py models this
// arithmetic on the CPU), so the TPU kernel's fallback, a 3-pass bf16
// split DFT on the tensor cores, is not needed.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kHop = 160;
constexpr int kNfft = 512;
constexpr int kWin = 400;                          // the window's support
constexpr int kLpad = (kNfft - kWin) / 2;          // its first sample: 56
constexpr int kFrames = 32;                        // frames a block
constexpr int kMels = 40;                          // fft_tables()'s filters
constexpr int kTabF = 2 * kNfft + kWin;            // W512^k (re, im), window
constexpr int kRow1 = 36;                          // stage-1 rows (pairs)
constexpr int kRow2 = 10, kPlane2 = 81;            // stage-2 rows, planes
constexpr int kScratch = 4 * kPlane2;              // float2 a warp (>= 288)
constexpr float kLogEps = 1e-10f;
constexpr float kR = 0.70710678118654752f;         // sqrt(1/2)

// warps a block: 4 for the extended form, 8 for the framed one, whose
// larger tile leaves fewer blocks an SM (each measured the faster)
template <bool kFramed>
__host__ __device__ constexpr int warps() {
  return kFramed ? 8 : 4;
}
// shared memory (floats) of a block: the signal, then the warps' scratch
template <bool kFramed>
__host__ __device__ constexpr int sig_floats() {
  return kFramed ? kFrames * kWin : (kFrames - 1) * kHop + kWin;
}
template <bool kFramed>
__host__ __device__ constexpr int smem_floats() {
  return sig_floats<kFramed>() + 2 * warps<kFramed>() * kScratch;
}

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 neg_i(float2 a) {      // a * (-i)
  return make_float2(a.y, -a.x);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x));
}

// radix-4 DFT of c[0..3], in place
__device__ __forceinline__ void dft4(float2 c[4]) {
  const float2 d0 = add(c[0], c[2]), d2 = sub(c[0], c[2]);
  const float2 d1 = add(c[1], c[3]), d3 = neg_i(sub(c[1], c[3]));
  c[0] = add(d0, d1);
  c[1] = add(d2, d3);
  c[2] = sub(d0, d1);
  c[3] = sub(d2, d3);
}

// radix-8 DFT of a[0..7], in place, outputs in natural order: a radix-2
// step (the differences times W8^n), then radix-4 DFTs of the sums (even
// outputs) and of the differences (odd outputs)
__device__ __forceinline__ void dft8(float2 a[8]) {
  float2 s[4], t[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    s[n] = add(a[n], a[n + 4]);
    t[n] = sub(a[n], a[n + 4]);
  }
  t[1] = make_float2(kR * (t[1].x + t[1].y), kR * (t[1].y - t[1].x));
  t[2] = neg_i(t[2]);
  t[3] = make_float2(kR * (t[3].y - t[3].x), -kR * (t[3].x + t[3].y));
  dft4(s);
  dft4(t);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a[2 * q] = s[q];
    a[2 * q + 1] = t[q];
  }
}

// one frame (its windowed samples at win_sig[0 .. 400)) through the FFT,
// power, mel and log into out_row[0 .. kMels); sc is the warp's scratch,
// the tables are read from device memory (through L1)
__device__ __forceinline__ void frame_logmel(
    const float* win_sig, const float2* __restrict__ tw,
    const float* __restrict__ win, const float* __restrict__ melw,
    const int* __restrict__ first, const int* __restrict__ offs, float2* sc,
    float* out_row, int l) {
  // stage 1: lane l holds z[l + 32 n2] = x[p] + i x[p + 1], p = 2l + 64 n2
  float2 a[8];
#pragma unroll
  for (int n2 = 0; n2 < 8; ++n2) {
    const int p = 2 * l + 64 * n2 - kLpad;     // in the window's support?
    if (p >= 0 && p < kWin) {
      const float2 x = *reinterpret_cast<const float2*>(win_sig + p);
      const float2 w = *reinterpret_cast<const float2*>(win + p);
      a[n2] = make_float2(x.x * w.x, x.y * w.y);
    } else {
      a[n2] = make_float2(0.0f, 0.0f);
    }
  }
  dft8(a);
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2)
    sc[k2 * kRow1 + l] = k2 ? cmul(a[k2], tw[2 * l * k2]) : a[k2];
  __syncwarp();
  // stage 2: lane (k2, m1) takes stage 1's lanes m1 + 4 m2
  const int k2 = l >> 2, m1 = l & 3;
#pragma unroll
  for (int m2 = 0; m2 < 8; ++m2) a[m2] = sc[k2 * kRow1 + m1 + 4 * m2];
  dft8(a);
  __syncwarp();                                // stage 1 is read
#pragma unroll
  for (int j2 = 0; j2 < 8; ++j2)
    sc[m1 * kPlane2 + k2 * kRow2 + j2] =
        j2 ? cmul(a[j2], tw[16 * m1 * j2]) : a[j2];
  __syncwarp();
  // stage 3: for (k2, j2) = c = l and l + 32, a radix-4 DFT over m1
  float2 z[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = l + 32 * h;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      z[h][m] = sc[m * kPlane2 + (c >> 3) * kRow2 + (c & 7)];
    dft4(z[h]);
  }
  __syncwarp();                                // stage 2 is read
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = l + 32 * h;
#pragma unroll
    for (int j1 = 0; j1 < 4; ++j1)
      sc[64 * j1 + 8 * (c & 7) + (c >> 3)] = z[h][j1];
  }
  __syncwarp();
  // post-twiddle and power of bins k = l + 32 j (and 256 in lane 0)
  float pw[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = l + 32 * j;
    const float2 zk = sc[k], zn = sc[(256 - k) & 255];
    const float2 e = make_float2(0.5f * (zk.x + zn.x), 0.5f * (zk.y - zn.y));
    const float2 o = make_float2(0.5f * (zk.y + zn.y), -0.5f * (zk.x - zn.x));
    const float2 x = add(e, cmul(o, tw[k]));
    pw[j] = x.x * x.x + x.y * x.y;
  }
  const float2 z0 = sc[0];
  const float p256 = (z0.x - z0.y) * (z0.x - z0.y);
  __syncwarp();                                // Z is read
  float* power = reinterpret_cast<float*>(sc);
#pragma unroll
  for (int j = 0; j < 8; ++j) power[l + 32 * j] = pw[j];
  if (l == 0) power[256] = p256;
  __syncwarp();
  // mel: lane l sums filter l (the narrow ones, at most 20 bins); the
  // filters 32 .. 39 (the widest, up to 36 bins) are split in quarters
  // over the warp's lanes, four a filter, and summed by two shuffles, so no
  // lane sums more than ~30 products
  static_assert(kMels == 40, "the wide filters take all 32 lanes");
  {
    const float* pm = power + first[l] - offs[l];
    float acc = 0.0f;
#pragma unroll 4
    for (int i = offs[l]; i < offs[l + 1]; ++i)
      acc = fmaf(pm[i], melw[i], acc);
    out_row[l] = logf(fmaxf(acc, kLogEps));
  }
  {
    const int m = 32 + (l >> 2), q = l & 3;
    const int n = offs[m + 1] - offs[m], part = (n + 3) >> 2;
    const int i0 = offs[m] + q * part, i1 = min(i0 + part, offs[m + 1]);
    const float* pm = power + first[m] - offs[m];
    float acc = 0.0f;
#pragma unroll 4
    for (int i = i0; i < i1; ++i) acc = fmaf(pm[i], melw[i], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2, 4);
    if (q == 0) out_row[m] = logf(fmaxf(acc, kLogEps));
  }
  __syncwarp();                                // the power is read
}

// kFramed: src is [B, T, 512] frames; otherwise the extended signal [B,
// src_len]. tabf: fft_tables()'s floats; tabi: its ints.
template <bool kFramed>
__global__ void __launch_bounds__(32 * warps<kFramed>())
logmel_kernel(const float* __restrict__ src, int src_len, int T,
              const float* __restrict__ tabf, const int* __restrict__ tabi,
              float* __restrict__ out) {
  constexpr int kStride = kFramed ? kWin : kHop;   // frame to frame in sig
  constexpr int kWarps = warps<kFramed>(), kThreads = 32 * kWarps;
  extern __shared__ __align__(16) float smem[];
  float* sig = smem;
  float2* scratch = reinterpret_cast<float2*>(sig + sig_floats<kFramed>());

  const int b = blockIdx.y, t0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, T - t0);
  const int tid = threadIdx.x;

  // the tile's windowed samples, 16 bytes a load where rows are aligned
  if constexpr (kFramed) {
    const float* fr =
        src + (static_cast<int64_t>(b) * T + t0) * kNfft + kLpad;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      constexpr int kQ = kWin / 4;
      for (int i = tid; i < nf * kQ; i += kThreads) {
        const int f = i / kQ, c = i - f * kQ;
        reinterpret_cast<float4*>(sig)[i] =
            *reinterpret_cast<const float4*>(fr + f * kNfft + 4 * c);
      }
    } else {
      for (int i = tid; i < nf * kWin; i += kThreads) {
        const int f = i / kWin;
        sig[i] = fr[f * kNfft + i - f * kWin];
      }
    }
  } else {
    const float* row = src + static_cast<int64_t>(b) * src_len;
    const int64_t p0 = static_cast<int64_t>(t0) * kHop + kLpad;
    const int n = (nf - 1) * kHop + kWin;          // a multiple of 4
    if ((src_len & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      for (int i = tid; i < n / 4; i += kThreads) {
        const int64_t p = p0 + 4 * i;
        reinterpret_cast<float4*>(sig)[i] =
            p < src_len ? *reinterpret_cast<const float4*>(row + p)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      for (int i = tid; i < n; i += kThreads)
        sig[i] = p0 + i < src_len ? row[p0 + i] : 0.0f;
    }
  }
  __syncthreads();

  const int w = tid >> 5, l = tid & 31;
  const float2* tw = reinterpret_cast<const float2*>(tabf);
  for (int f = w; f < nf; f += kWarps)
    frame_logmel(sig + f * kStride, tw, tabf + 2 * kNfft, tabf + kTabF,
                 tabi, tabi + kMels, scratch + w * kScratch,
                 out + (static_cast<int64_t>(b) * T + t0 + f) * kMels, l);
}

// the dynamic shared memory above 48 KB, set once a form (so a launch is
// only a launch, and may be captured in a CUDA graph)
template <bool kFramed>
int launch(const float* src, int src_len, int B, int T, const float* tabf,
           const int* tabi, int n_mels, float* out, cudaStream_t stream) {
  constexpr int bytes = smem_floats<kFramed>() * 4;
  static const cudaError_t attr = cudaFuncSetAttribute(
      logmel_kernel<kFramed>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n_mels != kMels)                     // the tables hold 40 filters
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + kFrames - 1) / kFrames, B);
  logmel_kernel<kFramed><<<grid, 32 * warps<kFramed>(), bytes, stream>>>(
      src, src_len, T, tabf, tabi, out);
  CSR_RETURN_LAUNCH_STATUS();
}

}  // namespace

// The kernel's tile, frames a block (the card tests cover its edges).
CSR_API int csr_frontend_frames_per_block() { return kFrames; }

// ext [B, ext_len] fp32, tabf / tabi the host tables
// (frontend/cuda_frontend.py::fft_tables), out [B, T, n_mels] fp32
// (n_mels = 40, the tables' filters); requires ext_len >= (T - 1) * 160 +
// 512.
CSR_API int csr_frontend_logmel(const float* ext, int ext_len, int B, int T,
                                const float* tabf, const int* tabi,
                                int n_mels, float* out, cudaStream_t stream) {
  return launch<false>(ext, ext_len, B, T, tabf, tabi, n_mels, out, stream);
}

// frames [B, T, 512] fp32 (un-windowed), tables and out as above.
CSR_API int csr_frontend_logmel_frames(const float* frames, int B, int T,
                                       const float* tabf, const int* tabi,
                                       int n_mels, float* out,
                                       cudaStream_t stream) {
  return launch<true>(frames, 0, B, T, tabf, tabi, n_mels, out, stream);
}
