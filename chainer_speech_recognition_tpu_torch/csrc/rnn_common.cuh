// Shared by the recurrence kernels (gru_*.cu, lstm_*.cu): conversions
// between the stream/compute dtype S (float or bf16) and fp32 registers,
// the sigmoid, and the k-quad weight loads of the LSTM kernels.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

namespace csr_rnn {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename S>
__device__ __forceinline__ S from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an fp32 value to the compute dtype S (kept in an fp32 register)
template <typename S>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<S>(v));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Four consecutive reduction rows (k, k+1, k+2, k+3) of one weight column,
// stored next to each other so a thread fetches them with one 8-byte (bf16)
// or 16-byte (fp32) load; the wrappers in ops/rnn_cuda.py lay the weights
// out this way ("k-quads").
template <typename S>
struct Quad;
template <>
struct Quad<float> {
  using T = float4;
  static __device__ __forceinline__ float4 unpack(float4 q) { return q; }
};
template <>
struct Quad<__nv_bfloat16> {
  using T = uint2;
  // a bf16 value is the upper half of the fp32 with the same bits; the
  // lower-addressed element of each 32-bit word is its low half
  static __device__ __forceinline__ float4 unpack(uint2 q) {
    return make_float4(__uint_as_float(q.x << 16),
                       __uint_as_float(q.x & 0xffff0000u),
                       __uint_as_float(q.y << 16),
                       __uint_as_float(q.y & 0xffff0000u));
  }
};

}  // namespace csr_rnn
