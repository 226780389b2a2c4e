// Greedy (best-path) CTC decoding in one launch: per-frame argmax, the
// keep mask and the compaction of the kept symbols.
//
// Replaces decode/greedy_pallas.py::_kernel (greedy_decode_pallas) and the
// compaction after it (decode/greedy.py::compact_kept in the reference,
// plain XLA there).
//
// Semantics (the TPU kernel's, not XLA argmax's):
// * best[b,t] = first index of the frame's maximum; a frame holding ANY NaN
//   maps to blank (the TPU kernel's max is NaN then, nothing compares equal
//   to it, and the out-of-vocab sentinel becomes blank);
// * keep[b,t] = best != blank && best != best[b,t-1] && t < length[b],
//   with best[b,-1] = blank;
// * ids[b, :] = the kept symbols in order, then PAD_LABEL_ID out to
//   max_len; out_lens[b] = min(sum_t keep[b,t], max_len).
//
// What bounds it on Hopper: memory. It reads the live frames of the
// [B, T, V] fp32 logits once (32 x 251 x 64 x 4 B = 2 MB at bigru) and
// writes [B, max_len] + [B] int32, ~0.6 us at HBM rate. The old design ran
// the argmax as one kernel and the compaction as about eleven torch
// kernels around it, each a launch of a few us.
//
// Design: one block per utterance, kWarps warps. Frames are taken in
// chunks of kChunk (a frame a thread in the scan):
//   1. warp w takes a contiguous run of the chunk's live frames, kFrames
//      frames at a time (their loads issued together: 16-byte loads where
//      V % 4 == 0, scalar otherwise), and reduces each with shuffles that
//      keep the larger value and, on ties, the smaller index; a NaN in the
//      frame votes it to blank; the frame's best goes to shared memory;
//   2. thread i takes frame c0 + i: its predecessor is sbest[i - 1] (or the
//      carry from the chunk before), its keep bit goes into a warp ballot,
//      and a block scan of the warps' popcounts gives each kept frame its
//      slot; slots below max_len are written;
// then the rest of the row is padded and out_lens written. Frames at or
// past len[b] are never read. A sweep on an H100 (16 or 32 warps, 4, 8 or
// 16 frames a warp at once) found 32 warps of 4 frames the fastest at
// both decode shapes (T' = 251 and 701), 16 frames the slowest: the time
// is the block's chain of dependent steps (lengths, loads, reductions,
// the scan), not the loads in flight.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = kThreads;   // frames a chunk: a thread each in the scan
constexpr int kFrames = 4;         // frames a warp reduces at once
constexpr int kBlank = 0;          // constants.BLANK_ID
constexpr int kPad = -1;           // constants.PAD_LABEL_ID

struct Best {
  float m;
  int idx;
  bool nan;
};

__device__ __forceinline__ void take(Best& s, float x, int v) {
  if (isnan(x))
    s.nan = true;
  else if (x > s.m || (x == s.m && v < s.idx)) {
    s.m = x;
    s.idx = v;
  }
}

// the frame's best symbol from this lane's partial result
__device__ __forceinline__ int reduce(Best s, int V) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, s.m, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, s.idx, off);
    if (m2 > s.m || (m2 == s.m && i2 < s.idx)) {
      s.m = m2;
      s.idx = i2;
    }
  }
  const bool nan = __any_sync(0xffffffffu, s.nan);
  return (nan || s.idx >= V) ? kBlank : s.idx;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    greedy_kernel(const float* __restrict__ logits,
                  const int32_t* __restrict__ lengths, int T, int V,
                  int max_len, int32_t* __restrict__ ids,
                  int32_t* __restrict__ out_lens) {
  __shared__ int32_t sbest[kChunk];
  __shared__ int32_t wsum[kWarps];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(max(lengths[b], 0), T);
  const float* row = logits + static_cast<int64_t>(b) * T * V;
  int32_t* out = ids + static_cast<int64_t>(b) * max_len;
  int base = 0;          // kept symbols of the chunks before
  int carry = kBlank;    // best of the frame before the chunk

  for (int c0 = 0; c0 < len; c0 += kChunk) {
    const int n = min(kChunk, len - c0);
    // 1. the chunk's best symbols: warp w takes frames [f0, f1)
    const int run = (n + kWarps - 1) / kWarps;
    const int f0 = min(warp * run, n), f1 = min(f0 + run, n);
    for (int f = f0; f < f1; f += kFrames) {
      Best s[kFrames];
#pragma unroll
      for (int q = 0; q < kFrames; ++q) s[q] = {-INFINITY, V, false};
      if (kVec) {
        for (int v4 = lane; v4 < V / 4; v4 += 32) {
          float4 x[kFrames];
#pragma unroll
          for (int q = 0; q < kFrames; ++q)
            if (f + q < f1)
              x[q] = reinterpret_cast<const float4*>(
                  row + static_cast<int64_t>(c0 + f + q) * V)[v4];
#pragma unroll
          for (int q = 0; q < kFrames; ++q)
            if (f + q < f1) {
              take(s[q], x[q].x, 4 * v4);
              take(s[q], x[q].y, 4 * v4 + 1);
              take(s[q], x[q].z, 4 * v4 + 2);
              take(s[q], x[q].w, 4 * v4 + 3);
            }
        }
      } else {
        for (int v = lane; v < V; v += 32) {
          float x[kFrames];
#pragma unroll
          for (int q = 0; q < kFrames; ++q)
            if (f + q < f1)
              x[q] = row[static_cast<int64_t>(c0 + f + q) * V + v];
#pragma unroll
          for (int q = 0; q < kFrames; ++q)
            if (f + q < f1) take(s[q], x[q], v);
        }
      }
#pragma unroll
      for (int q = 0; q < kFrames; ++q) {
        const int best = reduce(s[q], V);   // every lane takes part
        if (lane == 0 && f + q < f1) sbest[f + q] = best;
      }
    }
    __syncthreads();

    // 2. keep bits, their slots by a block scan, the kept symbols
    const int i = threadIdx.x;
    const int cur = i < n ? sbest[i] : kBlank;
    const int prev = i == 0 ? carry : sbest[i - 1];
    const bool keep = i < n && cur != kBlank && cur != prev;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wsum[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
    const int slot = base + before + __popc(ballot & ((1u << lane) - 1u));
    if (keep && slot < max_len) out[slot] = cur;
    base += total;
    carry = sbest[n - 1];
    __syncthreads();   // sbest and wsum are rewritten by the next chunk
  }

  const int kept = min(base, max_len);
  for (int s = kept + threadIdx.x; s < max_len; s += kThreads) out[s] = kPad;
  if (threadIdx.x == 0) out_lens[b] = kept;
}

}  // namespace

// logits [B, T, V] fp32 (16-byte-aligned base), lengths [B] int32 (any
// value: clamped to [0, T]) -> ids [B, max_len], out_lens [B] int32.
// Requires B >= 1, T >= 1, V >= 1, max_len >= 0 (the wrapper checks).
CSR_API int csr_greedy(const float* logits, const int32_t* lengths, int B,
                       int T, int V, int max_len, int32_t* ids,
                       int32_t* out_lens, cudaStream_t stream) {
  if (B < 1 || T < 1 || V < 1 || max_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (V % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0)
    greedy_kernel<true><<<B, kThreads, 0, stream>>>(logits, lengths, T, V,
                                                    max_len, ids, out_lens);
  else
    greedy_kernel<false><<<B, kThreads, 0, stream>>>(logits, lengths, T, V,
                                                     max_len, ids, out_lens);
  CSR_RETURN_LAUNCH_STATUS();
}
