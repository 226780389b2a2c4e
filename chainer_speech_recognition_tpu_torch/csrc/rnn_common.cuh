// Shared by the recurrence kernels (gru_*.cu, lstm_*.cu): conversions
// between the stream/compute dtype S of the FMA kernels (float: the bf16
// forms run on the cluster kernels, rnn_mma.cuh) and fp32 registers, the
// sigmoid, and the k-quad weight loads of the LSTM kernels.
#pragma once

#include <math.h>

namespace csr_rnn {

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename S>
__device__ __forceinline__ S from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// round an fp32 value to the compute dtype S (kept in an fp32 register)
template <typename S>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<S>(v));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Four consecutive reduction rows (k, k+1, k+2, k+3) of one weight column,
// stored next to each other so a thread fetches them with one 16-byte
// load; the wrappers in ops/rnn_cuda.py lay the weights out this way
// ("k-quads").
template <typename S>
struct Quad;
template <>
struct Quad<float> {
  using T = float4;
  static __device__ __forceinline__ float4 unpack(float4 q) { return q; }
};

}  // namespace csr_rnn
