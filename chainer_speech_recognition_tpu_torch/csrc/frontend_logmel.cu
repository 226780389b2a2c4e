// Fused log-mel front-end: framing -> windowed DFT power -> mel -> log.
//
// Replaces frontend/pallas_frontend.py::_kernel_rows + _dft_mel_log (the
// TPU kernel behind fused_logmel_rows / batch_features_pallas) and, in its
// framed form, ::_kernel (the TPU kernel behind fused_logmel).
//
// Input is the reflect-extended signal [B, ext_len] fp32 (built by
// frontend/torch_frontend.py::extend_signal); frame t is the 512 samples
// ext[b, t*160 : t*160 + 512], i.e. hop rows t..t+2 plus 32 samples of row
// t+3. The framed form (csr_frontend_logmel_frames) reads pre-framed,
// un-windowed input [B, T, 512] fp32 instead and shares everything past
// the load. Output is [B, T, n_mels] fp32 log(max(mel, 1e-10)).
//
// What bounds it on Hopper: arithmetic. The DFT is a dense [512 x 514]
// product per frame (~0.53 MFLOP/frame, ~17 GFLOP for 32 x 10 s), done
// here in plain fp32 FMA (no tensor cores); memory traffic is only the
// signal (read once) and the [B,T,40] output. The [512, 2*257] windowed
// DFT table (526 KB) is re-read by every block and stays in L2.
//
// Design: one block per (utterance, tile of kFrames frames). The block
// copies the tile's contiguous signal span (kFrames-1 hops + 512 samples)
// into shared memory once, so no [B,T,512] frames tensor is ever written;
// thread k owns DFT bin k and keeps re/im accumulators for all kFrames
// frames in registers, reading the table row n once per block per n (one
// coalesced load serves kFrames frames). The power spectrum goes to shared
// memory and the 40-mel projection + log run from there. The TPU kernel's
// bf16x3 split DFT is an MXU choice and is not copied: fp32 FMA is the
// simple right version; tensor-core DFT (TF32 or split bf16 wgmma) is
// later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kHop = 160;
constexpr int kNfft = 512;
constexpr int kBins = kNfft / 2 + 1;                  // 257
constexpr int kFrames = 16;                           // frames per block
constexpr int kThreads = ((kBins + 31) / 32) * 32;    // 288: one per bin
constexpr int kSpan = (kFrames - 1) * kHop + kNfft;   // 2912 samples
constexpr float kLogEps = 1e-10f;

// kFramed: src is [B, T, 512] frames (a frame's samples are 512 apart in
// shared memory); otherwise the extended signal [B, src_len] (160 apart).
template <bool kFramed>
__global__ void __launch_bounds__(kThreads)
logmel_kernel(const float* __restrict__ src, int src_len, int T,
              const float* __restrict__ dft,  // [kNfft][2*kBins] re | im
              const float* __restrict__ mel,  // [kBins][n_mels]
              int n_mels, float* __restrict__ out) {
  constexpr int kStride = kFramed ? kNfft : kHop;
  constexpr int kSig = kFramed ? kFrames * kNfft : kSpan;
  // the framed form's power spectrum reuses the frames' shared memory
  // (both together pass the 48 KB of static shared memory)
  constexpr int kSmem = kFramed ? kSig : kSig + kFrames * kBins;
  __shared__ float smem[kSmem];
  float* sig = smem;
  float(*power)[kBins] =
      reinterpret_cast<float(*)[kBins]>(kFramed ? smem : smem + kSig);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  if constexpr (kFramed) {
    const float* fr = src + (static_cast<int64_t>(b) * T + t0) * kNfft;
    const int n_valid = min(kFrames, T - t0) * kNfft;
    for (int i = threadIdx.x; i < kSig; i += kThreads)
      sig[i] = i < n_valid ? fr[i] : 0.0f;
  } else {
    const int64_t base = static_cast<int64_t>(t0) * kHop;
    const float* row = src + static_cast<int64_t>(b) * src_len;
    for (int i = threadIdx.x; i < kSpan; i += kThreads) {
      const int64_t p = base + i;
      sig[i] = p < src_len ? row[p] : 0.0f;
    }
  }
  __syncthreads();

  const int k = threadIdx.x;
  float re[kFrames], im[kFrames];
#pragma unroll
  for (int f = 0; f < kFrames; ++f) re[f] = im[f] = 0.0f;
  if (k < kBins) {
#pragma unroll 4
    for (int n = 0; n < kNfft; ++n) {
      const float wr = __ldg(dft + n * (2 * kBins) + k);
      const float wi = __ldg(dft + n * (2 * kBins) + kBins + k);
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const float x = sig[f * kStride + n];
        re[f] = fmaf(x, wr, re[f]);
        im[f] = fmaf(x, wi, im[f]);
      }
    }
  }
  if constexpr (kFramed) __syncthreads();   // sig is read: power may reuse it
  if (k < kBins) {
#pragma unroll
    for (int f = 0; f < kFrames; ++f)
      power[f][k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int o = threadIdx.x; o < kFrames * n_mels; o += kThreads) {
    const int f = o / n_mels;
    const int m = o - f * n_mels;
    const int t = t0 + f;
    if (t >= T) continue;
    float acc = 0.0f;
    for (int j = 0; j < kBins; ++j)
      acc = fmaf(power[f][j], __ldg(mel + j * n_mels + m), acc);
    out[(static_cast<int64_t>(b) * T + t) * n_mels + m] =
        logf(fmaxf(acc, kLogEps));
  }
}

}  // namespace

// ext [B, ext_len] fp32, dft [512, 514] fp32, mel [257, n_mels] fp32,
// out [B, T, n_mels] fp32; requires ext_len >= (T - 1) * 160 + 512.
CSR_API int csr_frontend_logmel(const float* ext, int ext_len, int B, int T,
                                const float* dft, const float* mel,
                                int n_mels, float* out, cudaStream_t stream) {
  const dim3 grid((T + kFrames - 1) / kFrames, B);
  logmel_kernel<false><<<grid, kThreads, 0, stream>>>(ext, ext_len, T, dft,
                                                      mel, n_mels, out);
  CSR_RETURN_LAUNCH_STATUS();
}

// frames [B, T, 512] fp32 (un-windowed), dft, mel and out as above.
CSR_API int csr_frontend_logmel_frames(const float* frames, int B, int T,
                                       const float* dft, const float* mel,
                                       int n_mels, float* out,
                                       cudaStream_t stream) {
  const dim3 grid((T + kFrames - 1) / kFrames, B);
  logmel_kernel<true><<<grid, kThreads, 0, stream>>>(frames, 0, T, dft, mel,
                                                     n_mels, out);
  CSR_RETURN_LAUNCH_STATUS();
}
