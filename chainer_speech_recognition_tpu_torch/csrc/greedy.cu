// Masked greedy (best-path) CTC decode: per-frame argmax + keep mask.
//
// Replaces decode/greedy_pallas.py::_kernel (greedy_decode_pallas). The
// [B, T] -> [B, U] compaction stays outside, in plain torch
// (decode/greedy.py::compact_kept), as it does in JAX.
//
// Semantics (the TPU kernel's, not XLA argmax's):
// * best[b,t] = first index of the frame's maximum; a frame holding ANY NaN
//   maps to blank (the TPU kernel's max is NaN then, nothing compares equal
//   to it, and the out-of-vocab sentinel becomes blank);
// * keep[b,t] = best != blank && best != best[b,t-1] && t < length[b],
//   with best[b,-1] = blank. Live frames are a prefix, so the previous live
//   frame of a live frame t is t-1; this is the TPU kernel's carried prev.
//
// What bounds it on Hopper: memory. It reads the [B, T, V] fp32 logits once
// (32 x 251 x 64 x 4 B = 2 MB at bigru) and writes two [B, T] int32 masks;
// there is no sequential carry left once prev is read from the neighbour
// frame, so the whole grid runs in parallel.
//
// Design: one block per (utterance, tile of kTile frames). Each warp takes
// whole frames (lanes stride over V, then a shuffle reduction that keeps
// the larger value and, on ties, the smaller index) and writes the frame's
// best symbol to shared memory; the tile also recomputes the frame before
// it, so the keep mask needs no second pass.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;     // frames per block
constexpr int kThreads = 256;
constexpr int kBlank = 0;     // constants.BLANK_ID

__global__ void __launch_bounds__(kThreads)
greedy_kernel(const float* __restrict__ logits,
              const int32_t* __restrict__ lengths, int T, int V,
              int32_t* __restrict__ best, int32_t* __restrict__ keep) {
  __shared__ int32_t sbest[kTile + 1];  // sbest[i] = best of frame t0-1+i
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = warp; i < kTile + 1; i += kThreads / 32) {
    const int t = t0 - 1 + i;
    if (t < 0 || t >= T) {
      if (lane == 0) sbest[i] = kBlank;
      continue;
    }
    const float* frame = logits + (static_cast<int64_t>(b) * T + t) * V;
    float m = -INFINITY;
    int idx = V;                       // sentinel: nothing seen yet
    bool nan = false;
    for (int v = lane; v < V; v += 32) {
      const float x = frame[v];
      if (isnan(x)) {
        nan = true;
      } else if (x > m || (x == m && v < idx)) {
        m = x;
        idx = v;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
      if (m2 > m || (m2 == m && i2 < idx)) {
        m = m2;
        idx = i2;
      }
    }
    nan = __any_sync(0xffffffffu, nan);
    if (lane == 0) sbest[i] = (nan || idx >= V) ? kBlank : idx;
  }
  __syncthreads();

  const int len = lengths[b];
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int t = t0 + i;
    if (t >= T) break;
    const int32_t cur = sbest[i + 1];
    const int32_t prev = sbest[i];
    const int64_t o = static_cast<int64_t>(b) * T + t;
    best[o] = cur;
    keep[o] = (cur != kBlank && cur != prev && t < len) ? 1 : 0;
  }
}

}  // namespace

// logits [B, T, V] fp32, lengths [B] int32 -> best, keep [B, T] int32.
// Requires B >= 1, T >= 1 (the wrapper checks).
CSR_API int csr_greedy(const float* logits, const int32_t* lengths, int B,
                       int T, int V, int32_t* best, int32_t* keep,
                       cudaStream_t stream) {
  const dim3 grid((T + kTile - 1) / kTile, B);
  greedy_kernel<<<grid, kThreads, 0, stream>>>(logits, lengths, T, V, best,
                                               keep);
  CSR_RETURN_LAUNCH_STATUS();
}
