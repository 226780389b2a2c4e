// Shared by the bf16 cluster kernels of the recurrences (lstm_fwd.cu,
// lstm_bwd.cu, gru_fwd.cu, gru_bwd.cu): the shared-memory layout, the
// thread-block cluster's rank, distributed shared memory (DSMEM) stores and
// barrier, and the cluster launch; and, past H = 512, the streamed-W
// form's geometry and product (below).
//
// Up to H = 512, a cluster of C = H / U blocks serves one direction and
// one group of kRows = 16 rows (one m16 tile; rows past B are zero); block
// c owns the U hidden units [U c, U c + U) (U = kUnits = 32, but
// gru_bwd_units for the GRU's backward) with all G gate columns of each
// (G = 4 for the LSTM, 3 for the GRU). Its slice of W
// stays in its shared memory for all T steps, as bf16 rows of a k-extent K
// (the reduction) padded by 16 bytes: row r starts at r (2 K + 16) bytes,
// so the 8 rows that one ldmatrix phase reads fall in 8 distinct 16-byte
// bank groups for every K % 16 == 0 (the row stride is an odd multiple of
// 16 bytes). ops/rnn_cuda.py's lstm_plan and gru_plan compute the same
// sizes.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "common.cuh"

namespace csr_rnn_mma {

using csr_attn::cp_async16;
using csr_attn::cp_async_commit;
using csr_attn::cp_async_wait;
using csr_attn::ldsm_x4;
using csr_attn::mma;
using csr_attn::smem_addr;

constexpr int kUnits = 32;   // hidden units a block
constexpr int kRows = 16;    // rows a cluster: one m16 tile

// hidden units a block of the GRU's backward: 16 up to H = 256 (C = H / 16
// <= 16 blocks, the largest cluster), kUnits above. At bigru's H = 256 the
// backward on 16 blocks of 16 units took 0.846x the time of 8 blocks of 32
// in tools/kernel_ab.py's rounds on an H100; the forward was no faster so
// (1.00x), and keeps kUnits.
__host__ __device__ constexpr int gru_bwd_units(int H) {
  return H <= 256 ? 16 : kUnits;
}

// bytes of one padded bf16 row of K values
__host__ __device__ constexpr int row_bytes(int K) { return 2 * K + 16; }

// the forward's partial sums: rows of U fp32 padded to U + 8, so the
// float2 stores of a half-warp's 4 rows fall in distinct banks
__host__ __device__ constexpr int part_ld(int U) { return U + 8; }
constexpr int kPartLd = part_ld(kUnits);

// forward: the W slice [G][U][H] (its gate columns, k-major), the double
// buffer of h, [2][kRows][H], and the partial sums of the product's four
// k-quarters, [4][G gates][kRows][U + 8] fp32
__host__ __device__ constexpr int fwd_smem(int H, int G = 4,
                                           int U = kUnits) {
  return (G * U + 2 * kRows) * row_bytes(H) + 4 * G * kRows * part_ld(U) * 4;
}

// backward: the W slice [H][G][U] (its gate columns of every row of W),
// this block's gate gradients [kRows][G U] and the double buffer of
// partial sums [2][C][kRows][U] fp32 (C = H / U sources)
__host__ __device__ constexpr int bwd_smem(int H, int G = 4,
                                           int U = kUnits) {
  return (H + kRows) * row_bytes(G * U) + 2 * kRows * H * 4;
}

// ---------------------------------------------------------------------------
// The streamed-W form, 512 < H <= kMaxHidden (H % 32 == 0): a direction's
// W (8 H^2 bytes for the LSTM: 8.4 MB at H = 1024) no longer fits the
// shared memory of a 16-block cluster, so every block streams its slice
// from global memory (L2) at each step, straight into the mma.sync B
// fragments, laid out by the wrapper in fragment order (ops/rnn_cuda.py's
// wide_fwd_weights, wide_bwd_weights): for each k-step and n-tile, lane l's
// four bf16 values (rows 2 (l % 4) + {0, 1, 8, 9} of the k16 step, column
// l / 4 of the n8 tile) are 8 consecutive bytes, so a warp reads each
// fragment as 256 contiguous bytes with one 8-byte load a lane, kP k-steps
// ahead of the products. h (forward) is exchanged over DSMEM as in the
// resident form; the backward's reduce-scatter keeps its partial sums in
// one buffer where two do not fit (wide_bwd_bufs), with a second cluster
// barrier a step.
//
// Geometry: a cluster of C = ceil(H / U) <= 16 blocks, U = wide_units(H) =
// 8 ceil(H / 128) units a block (the last block may own fewer: H - U (C -
// 1), a multiple of 8), kRows rows a cluster.
constexpr int kResidentMax = 512;   // the resident form's largest H
constexpr int kMaxHidden = 2048;
constexpr int kSmemMax = 232448;    // dynamic shared memory a block (H100)

__host__ __device__ constexpr int wide_units(int H) {
  return 8 * ((H + 127) / 128);
}
__host__ __device__ constexpr int wide_cluster(int H) {
  return (H + wide_units(H) - 1) / wide_units(H);
}
// the forward: a warp per 8 units (one n8 tile of every gate); the double
// buffer of h, [2][kRows][H]
__host__ __device__ constexpr int wide_fwd_threads(int H) {
  return 4 * wide_units(H);
}
__host__ __device__ constexpr int wide_fwd_smem(int H) {
  return 2 * kRows * row_bytes(H);
}
// the backward: 16 warps; its product's reduction extent (G U gate
// gradients, zero-padded to a multiple of 32: two k-steps), the partial
// sums [bufs][C][kRows][U] fp32 and the gate gradients [kRows][K] bf16
constexpr int kWideBwdThreads = 512;
__host__ __device__ constexpr int wide_bwd_k(int H, int G) {
  return (G * wide_units(H) + 31) / 32 * 32;
}
__host__ __device__ constexpr int wide_bwd_part(int H) {
  return kRows * wide_cluster(H) * wide_units(H) * 4;
}
__host__ __device__ constexpr int wide_bwd_bufs(int H, int G) {
  return kRows * row_bytes(wide_bwd_k(H, G)) + 2 * wide_bwd_part(H) <=
                 kSmemMax
             ? 2
             : 1;
}
__host__ __device__ constexpr int wide_bwd_smem(int H, int G) {
  return kRows * row_bytes(wide_bwd_k(H, G)) +
         wide_bwd_bufs(H, G) * wide_bwd_part(H);
}
// the backward's (row, unit) pairs a thread: 16 U / 512 = U / 32, at most
// 2 up to H = 1024 (U <= 64) and 4 above (fewer registers where fewer do)
__host__ __device__ constexpr int wide_pairs(int H) {
  return wide_units(H) <= 64 ? 2 : 4;
}
// B fragments in flight a warp, as many k-steps as the registers a thread
// leave room for: 16 up to 256 threads a block, 8 up to 384, 4 at 512
// (128 registers a thread)
__host__ __device__ constexpr int wide_prefetch(int threads) {
  return threads <= 256 ? 16 : threads <= 384 ? 8 : 4;
}
// the most threads a block of a kernel streaming kP k-steps ahead takes
__host__ __device__ constexpr int wide_max_threads(int kP) {
  return kP == 16 ? 256 : kP == 8 ? 384 : 512;
}

// The B fragments of the first kP k-steps of a streamed product into the
// register ring b (bf: this lane's first fragment of [K][J][32 lanes]
// uint2). W is the same at every step, so a kernel issues these loads for
// the next step as soon as a step's product is done: they are in flight
// over its gate math, exchange and barrier.
template <int J, int kP>
__device__ __forceinline__ void stream_prefetch(const uint2* __restrict__ bf,
                                                int K, uint2 (&b)[kP][J]) {
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int j = 0; j < J; ++j)
      b[p][j] = p < K ? __ldg(bf + (p * J + j) * 32) : make_uint2(0, 0);
}

// acc[J][4] += A B over K k-steps for J n8 tiles: A's 16 rows in shared
// memory (a_lane: this lane's ldmatrix address at k-step 0, 32 bytes a
// k-step further each step), B streamed from global memory through the
// ring b that stream_prefetch filled, each slot refilled with the k-step
// kP ahead once its products are issued; the ring is spent on return
template <int J, int kP>
__device__ __forceinline__ void streamed_product(uint32_t a_lane,
                                                 const uint2* __restrict__ bf,
                                                 int K, uint2 (&b)[kP][J],
                                                 float (&acc)[J][4]) {
  for (int k0 = 0; k0 < K; k0 += kP) {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int k = k0 + p;
      if (k < K) {
        uint32_t a[4];
        ldsm_x4(a_lane + k * 32, a);
#pragma unroll
        for (int j = 0; j < J; ++j) mma(acc[j], a, b[p][j].x, b[p][j].y);
        if (k + kP < K)
#pragma unroll
          for (int j = 0; j < J; ++j)
            b[p][j] = __ldg(bf + ((k + kP) * J + j) * 32);
      }
    }
  }
}

// the two 8x8 bf16 matrices whose row addresses lanes 0-7 and 8-15 give
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t r[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// The stream forms' first A buffer: row r < kRows of `a` (bf16, rows of
// row_bytes(H)) takes bf16(h0[r ld + k]) for k < H where r < rows, zeros
// past them (the m16 tile's rows past B); the block's threads share the
// work. Each block reads its h0 rows straight from global memory, so step
// 0 needs no DSMEM exchange.
__device__ __forceinline__ void fill_h0(unsigned char* a,
                                        const float* __restrict__ h0, int ld,
                                        int rows, int H) {
  const int half = H / 2;
  for (int i = threadIdx.x; i < kRows * half; i += blockDim.x) {
    const int r = i / half, k = 2 * (i % half);
    const float* src = h0 + static_cast<int64_t>(r) * ld + k;
    *reinterpret_cast<__nv_bfloat162*>(a + r * row_bytes(H) + 2 * k) =
        r < rows ? __floats2bfloat162_rn(src[0], src[1])
                 : __floats2bfloat162_rn(0.0f, 0.0f);
  }
}

// the address of the same shared-memory location in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster8(uint32_t addr, float x,
                                            float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(x), "f"(y)
               : "memory");
}

__device__ __forceinline__ void st_cluster16(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// the cluster barrier in two halves: after arrive (release), this
// thread's earlier stores to peers' shared memory are seen by every thread
// that has returned from wait (acquire); wait returns once every thread
// of the cluster has arrived
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// the streamed-W forward's exchange: this block's columns of the kRows
// rows of an A buffer (s_buf, rows of row_b bytes; byte offset col0, n16
// 16-byte chunks a row) into the same place of every other block of the
// cluster, the block's threads sharing the stores
__device__ __forceinline__ void push_columns(uint32_t s_buf, int row_b,
                                             int col0, int n16, int c,
                                             int C) {
  for (int q = threadIdx.x; q < (C - 1) * kRows * n16; q += blockDim.x) {
    const int p = q / (kRows * n16), e = q % (kRows * n16);
    const uint32_t ad = s_buf + (e / n16) * row_b + col0 + (e % n16) * 16;
    st_cluster16(map_rank(ad, p + (p >= c)), ld_shared16(ad));
  }
}

// zeros over `bytes` (a multiple of 16) of shared memory at p
__device__ __forceinline__ void zero_shared(unsigned char* p, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
}

// the launch configuration of `kernel` on clusters of C blocks along x,
// grid (C·nx, ny), `smem` bytes of dynamic shared memory (the kernel's
// attributes set to allow them) → the status of setting the attributes
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;

  template <typename... Exp>
  cudaError_t init(void (*kernel)(Exp...), int C, int nx, int ny,
                   int threads, int smem, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(C * nx, ny);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
};

// launches `kernel` on clusters (ClusterLaunch::init) → the launch status
template <typename... Exp, typename... Act>
int launch_clusters(void (*kernel)(Exp...), int C, int nx, int ny,
                    int threads, int smem, cudaStream_t stream,
                    Act&&... args) {
  ClusterLaunch l;
  cudaError_t e = l.init(kernel, C, nx, ny, threads, smem, stream);
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&l.cfg, kernel, static_cast<Act&&>(args)...);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// how many clusters of `kernel` (C blocks of `threads`, `smem` bytes) the
// card can hold at once, into *n → the query's status
template <typename... Exp>
int max_clusters(void (*kernel)(Exp...), int C, int threads, int smem,
                 int* n) {
  ClusterLaunch l;
  cudaError_t e = l.init(kernel, C, 1, 1, threads, smem, nullptr);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(n, kernel, &l.cfg);
  return static_cast<int>(e);
}

}  // namespace csr_rnn_mma
