// CTC alpha (forward + loss) and beta (backward + gradient) recursions.
//
// Replace ops/ctc_pallas.py::_fwd_kernel and ::_bwd_kernel. Same boundary
// as the TPU kernels' custom VJP, without their (8, 128) padding (a Mosaic
// rule): lp_ext [B, T, S] fp32 emissions of the extended label sequence
// (b l1 b l2 ... lL b, S = 2L_max + 1), allow2 [B, S] fp32 (1 where the
// skip transition s-2 -> s is allowed), t_len / lab_len [B] int32.
// A state s is valid for utterance b iff s < 2 lab_len[b] + 1.
//
//   forward:  alphas [B, T, S] fp32 (alpha after each frame; rows frozen for
//             t >= t_len), loss [B] = -lse(alpha[2L], alpha[2L-1]).
//   backward: grad [B, T, S] = -g exp(min(alpha + beta - lp + loss, 0)),
//             zero for t >= t_len and invalid s; beta is re-initialised at
//             t == t_len - 1 (the last two states take lp) and frozen past it.
//
// All math is fp32 with LOG_ZERO = -1e30 and ctc_jax._logsumexp3's clamps
// kept exactly (max clamped to LOG_ZERO/2, the sum clamped to 1e-37, and a
// result <= LOG_ZERO/2 snapped to LOG_ZERO), so the sentinel arithmetic of
// impossible samples matches the reference.
//
// What bounds it on Hopper: the dependency over T. Per step a block reads
// one [S] row of lp (and alphas in the backward) and writes one row; the
// bytes (lp + alphas, ~12.6 MB at B=24, T=256, S=257) would take ~4 us at
// HBM rate, but each step waits on the one before, so the kernel pays one
// global-load latency and one barrier per step.
//
// Design (the simple right version): utterances are independent, so one
// block owns one utterance and walks all T inside the kernel; the [S]
// wavefront lives in shared memory, double-buffered, so a step needs one
// barrier. Thread i handles states i, i + blockDim, ... (any S; the
// wavefront takes 8 S bytes of shared memory).
#include <math.h>

#include "common.cuh"

namespace {

constexpr float kLogZero = -1e30f;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float m_safe = fmaxf(m, kLogZero / 2);
  const float se = expf(a - m_safe) + expf(b - m_safe) + expf(c - m_safe);
  const float out = m_safe + logf(fmaxf(se, 1e-37f));
  return m <= kLogZero / 2 ? kLogZero : out;
}

__global__ void ctc_fwd_kernel(const float* __restrict__ lp,
                               const float* __restrict__ allow2,
                               const int* __restrict__ t_len,
                               const int* __restrict__ lab_len,
                               float* __restrict__ alphas,
                               float* __restrict__ loss, int T, int S) {
  extern __shared__ float sh[];  // [2][S] alpha wavefront
  const int b = blockIdx.x;
  const int tl = t_len[b];
  const int L = lab_len[b];
  const int s_valid = 2 * L + 1;
  const float* lpb = lp + static_cast<int64_t>(b) * T * S;
  const float* a2 = allow2 + static_cast<int64_t>(b) * S;
  float* ab = alphas + static_cast<int64_t>(b) * T * S;

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const bool init = s == 0 || (s == 1 && L > 0);
    const float v = (init && s < s_valid) ? lpb[s] : kLogZero;
    sh[s] = v;
    ab[s] = v;
  }
  __syncthreads();
  int cur = 0;
  for (int t = 1; t < T; ++t) {
    const float* a = sh + cur * S;
    float* nxt = sh + (cur ^ 1) * S;
    const float* lpt = lpb + static_cast<int64_t>(t) * S;
    const bool alive = t < tl;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float stay = a[s];
      float v = stay;
      if (alive) {
        const float sh1 = s >= 1 ? a[s - 1] : kLogZero;
        const float sh2 = (s >= 2 && a2[s] > 0.5f) ? a[s - 2] : kLogZero;
        v = s < s_valid ? lse3(stay, sh1, sh2) + lpt[s] : kLogZero;
      }
      nxt[s] = v;
      ab[static_cast<int64_t>(t) * S + s] = v;
    }
    __syncthreads();
    cur ^= 1;
  }
  if (threadIdx.x == 0) {
    const float* a = sh + cur * S;
    const float last = a[2 * L];
    const float prev = L > 0 ? a[2 * L - 1] : kLogZero;
    loss[b] = -lse3(last, prev, kLogZero);
  }
}

__global__ void ctc_bwd_kernel(const float* __restrict__ lp,
                               const float* __restrict__ allow2,
                               const int* __restrict__ t_len,
                               const int* __restrict__ lab_len,
                               const float* __restrict__ alphas,
                               const float* __restrict__ loss,
                               const float* __restrict__ g,
                               float* __restrict__ grad, int T, int S) {
  extern __shared__ float sh[];  // [2][S] beta wavefront
  const int b = blockIdx.x;
  const int tl = t_len[b];
  const int L = lab_len[b];
  const int s_valid = 2 * L + 1;
  const float gb = g[b];
  const float logp = -loss[b];
  const float* lpb = lp + static_cast<int64_t>(b) * T * S;
  const float* a2 = allow2 + static_cast<int64_t>(b) * S;
  const float* ab = alphas + static_cast<int64_t>(b) * T * S;
  float* gr = grad + static_cast<int64_t>(b) * T * S;

  for (int s = threadIdx.x; s < S; s += blockDim.x) sh[s] = kLogZero;
  __syncthreads();
  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    const float* bp = sh + cur * S;
    float* nxt = sh + (cur ^ 1) * S;
    const int64_t row = static_cast<int64_t>(t) * S;
    const bool inside = t < tl;
    const bool at_init = tl == t + 1;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float v = kLogZero;
      float gv = 0.0f;
      if (s < s_valid) {
        const float lpv = lpb[row + s];
        if (at_init) {
          const bool init = s == 2 * L || (s == 2 * L - 1 && L > 0);
          v = init ? lpv : kLogZero;
        } else if (inside) {
          const float sh1 = s + 1 < S ? bp[s + 1] : kLogZero;
          const float sh2 =
              (s + 2 < S && a2[s + 2] > 0.5f) ? bp[s + 2] : kLogZero;
          v = lse3(bp[s], sh1, sh2) + lpv;
        } else {
          v = bp[s];
        }
        if (inside) {
          const float post = ab[row + s] + v - lpv - logp;
          gv = -expf(fminf(post, 0.0f)) * gb;
        }
      }
      nxt[s] = v;
      gr[row + s] = gv;
    }
    __syncthreads();
    cur ^= 1;
  }
}

int threads_for(int S) {
  const int n = (S + 31) / 32 * 32;
  return n < kMaxThreads ? n : kMaxThreads;
}

cudaError_t set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// lp [B, T, S], allow2 [B, S] fp32; t_len, lab_len [B] int32 (t_len <= T,
// 2 lab_len + 1 <= S: the wrapper clamps and checks); alphas [B, T, S] and
// loss [B] fp32 out. B, T, S >= 1.
CSR_API int csr_ctc_fwd(const float* lp, const float* allow2,
                        const int* t_len, const int* lab_len, float* alphas,
                        float* loss, int B, int T, int S,
                        cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  const cudaError_t err =
      set_smem(reinterpret_cast<const void*>(ctc_fwd_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_fwd_kernel<<<B, threads_for(S), smem, stream>>>(lp, allow2, t_len,
                                                      lab_len, alphas, loss,
                                                      T, S);
  CSR_RETURN_LAUNCH_STATUS();
}

// As csr_ctc_fwd's inputs plus alphas and loss from it and g [B] (the
// upstream gradient, already zero for samples without an alignment);
// grad [B, T, S] fp32 out.
CSR_API int csr_ctc_bwd(const float* lp, const float* allow2,
                        const int* t_len, const int* lab_len,
                        const float* alphas, const float* loss,
                        const float* g, float* grad, int B, int T, int S,
                        cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  const cudaError_t err =
      set_smem(reinterpret_cast<const void*>(ctc_bwd_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_bwd_kernel<<<B, threads_for(S), smem, stream>>>(
      lp, allow2, t_len, lab_len, alphas, loss, g, grad, T, S);
  CSR_RETURN_LAUNCH_STATUS();
}
