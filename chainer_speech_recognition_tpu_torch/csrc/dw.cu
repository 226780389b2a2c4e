// The recurrent weights' gradient of the GRU and LSTM training backward,
// bidirectional (ndir = 2) or forward-only (ndir = 1): dW[d] = sum over
// (t, b) of h_prev[t, dB + b, :]^T dg[t, dB + b, :] -> fp32 [ndir, H, N],
// with h_prev[t] = ys[t - 1] (zeros at t = 0) rounded to bf16 and dg the
// bf16 gate gradients, products accumulated in fp32.
//
// Replaces ops/rnn_pallas.py::_dw_einsum (an XLA einsum, not a Pallas
// kernel: the TPU left this product to XLA, after the backward kernel).
//
// What bounds it on Hopper: bytes. At bilstm_deep's training shape (H =
// 384, N = 4H, T' = 256, B = 24) it reads ys (fp32, 18.9 MB) and dxs (bf16,
// 37.7 MB) once and writes dW (4.7 MB): ~18 us at HBM rate, against ~15 us
// for its 14.5 GFLOP at the bf16 tensor-core peak. A bf16 x bf16 product
// is exact in fp32, so the tensor cores form the products the fp32 SIMT
// matmul formed; only the order of the fp32 sums differs.
//
// A forward-only layer has one W and its B rows (the TPU path duplicates
// W, runs 2B rows and sums the two halves' dW: the same sum over the same
// products of the forward rows).
//
// Design: a GEMM on wgmma with its operands read in place by TMA.
// * Each operand is a 4-D tensor map over [T, ndir, B, X] (X = H for ys,
//   the gate tensor's row stride for dg, whose column slice is the map's
//   extent), so a box of kt frames x bc rows x 64 columns of one
//   direction lands in shared memory as a [kt bc][64] K-tile. The shift of
//   h_prev is the ys map addressed one frame back: the K walk starts at
//   t = 1 (frame 0 contributes nothing), and TMA fills the rows past B and
//   the frames past T with zeros, so no copy of ys, no direction slice and
//   no stack or cat remain.
// * ys is fp32: each consumer warpgroup rounds its 64-column half of the
//   fp32 K-tile to bf16 (round to nearest even, as torch's .to(bf16)) into
//   a 128-byte-swizzled tile of its own; dg arrives bf16, swizzled by TMA.
//   Both are MN-major in shared memory (M = H and N contiguous), which
//   wgmma takes for 16-bit operands (imm-trans-a = imm-trans-b = 1).
// * Block tile 128 x 256: two consumer warpgroups of 64 rows issue four
//   m64n64k16 products a k-step into fp32 registers (one wgmma group a
//   K-tile, waited for before its stage is released); one producer warp
//   keeps a ring of kStages K-tiles in flight under mbarriers. The operands
//   are read again by each tile along the other dimension, so the traffic
//   from L2 is what the tile size sets: on an H100 128 x 256 ran
//   bilstm_deep's layer in about half the time of 128 x 128, and keeping
//   one wgmma group in flight was slower at both (a sweep of variants).
// * The output has few tiles (36 at bilstm_deep, 12 at bigru's fused
//   N = 3H, 6 at uni_gru's) against 132 SMs, and K is long, so K is split
//   over a cluster of S blocks (the plan below); each block leaves its
//   partial tile in its shared memory and rank r sums the rows it owns
//   over the cluster's blocks in rank order through distributed shared
//   memory: a fixed order, no atomics, so two runs are bitwise equal.
//   Each output element is written once.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 256;   // block tile: M (units of h) x N
constexpr int kNSub = kBN / 64;       // 64-column dg boxes (n64 products)
constexpr int kKMax = 64;             // K rows of a K-tile, at most
constexpr int kMaxSplit = 8;          // blocks a cluster along K, at most
constexpr int kThreads = 288;         // 2 consumer warpgroups + 1 producer
constexpr int kAHalf = kKMax * 64 * 4;        // fp32 ys box of one half
constexpr int kBSub = kKMax * 128;            // bf16 dg box of 64 columns
constexpr int kStage = 2 * kAHalf + kNSub * kBSub;
constexpr int kABf = kKMax * 128;             // a warpgroup's bf16 A tile
constexpr int kStages = 3;                    // ring depth: what fits
constexpr int kRing = kStages * kStage;
constexpr int kRedLd = kBN + 8;               // partial tile row, floats
constexpr int kSmem = kRing + 4 * kABf + 2 * kStages * 8 + 1024;
static_assert(kBM * kRedLd * 4 <= kRing, "partial tile must fit the ring");
static_assert(kSmem <= 232448, "a block may take 227 KB of shared memory");

struct Plan {
  int bc, kt;       // a K-tile: kt frames x bc rows of a direction
  int nk;           // K-tiles of a direction
  int split;        // S: blocks a cluster along K
  int mt, nt;       // output tiles along M and N
};

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// kt bc is a multiple of 16 (a wgmma k-step) and at most kKMax: B whole
// when that allows it (B = 24: kt = 2), otherwise B rounded up to 16 rows
// in chunks of at most kKMax, the rows past B zero-filled by TMA
Plan plan_for(int T, int B, int H, int N, int ndir, int sms) {
  Plan p;
  const int g = 16 / gcd(B, 16);
  if (B * g <= kKMax) {
    p.bc = B;
    p.kt = g * (kKMax / (B * g));
  } else {
    p.bc = ((B + 15) / 16) * 16;
    if (p.bc > kKMax) p.bc = kKMax;
    p.kt = 1;
  }
  const int nbc = (B + p.bc - 1) / p.bc;
  p.nk = (T - 1 + p.kt - 1) / p.kt * nbc;
  p.mt = (H + kBM - 1) / kBM;
  p.nt = (N + kBN - 1) / kBN;
  const int tiles = ndir * p.mt * p.nt;
  int s = sms / tiles;
  if (s > kMaxSplit) s = kMaxSplit;
  if (s > p.nk) s = p.nk;
  p.split = s < 1 ? 1 : s;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// one 4-D box (column, row, direction, frame) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int b, int d,
                                         int t) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(b), "r"(d), "r"(t),
      "r"(bar)
      : "memory");
}

// a wgmma descriptor of a 1024-byte-aligned, 128-byte-swizzled MN-major
// tile [K rows][64] bf16: 8-row groups 1024 bytes apart (the stride byte
// offset); one 64-wide swizzle atom along M or N, so the leading byte
// offset is never used
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// acc (64 x 64 fp32 of the warpgroup) += A (64 x 16) B (16 x 64), both
// MN-major bf16 in shared memory
__device__ __forceinline__ void wgmma_m64n64k16(float (&a)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(a[0]), "+f"(a[1]), "+f"(a[2]), "+f"(a[3]), "+f"(a[4]),
        "+f"(a[5]), "+f"(a[6]), "+f"(a[7]), "+f"(a[8]), "+f"(a[9]),
        "+f"(a[10]), "+f"(a[11]), "+f"(a[12]), "+f"(a[13]), "+f"(a[14]),
        "+f"(a[15]), "+f"(a[16]), "+f"(a[17]), "+f"(a[18]), "+f"(a[19]),
        "+f"(a[20]), "+f"(a[21]), "+f"(a[22]), "+f"(a[23]), "+f"(a[24]),
        "+f"(a[25]), "+f"(a[26]), "+f"(a[27]), "+f"(a[28]), "+f"(a[29]),
        "+f"(a[30]), "+f"(a[31])
      : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from moving the accumulators while wgmma owns them
__device__ __forceinline__ void fence_acc(float (&a)[kNSub][32]) {
#pragma unroll
  for (int j = 0; j < kNSub; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(a[j][i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ float4 ld_peer(uint32_t addr, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Args {
  int H, N, n1, n2;     // N = n1 + n2 output columns, n2 from the 2nd map
  int bc, kt, nbc, nk;  // the plan's K-tiles
  int ndir;             // directions: 2, or 1 for a forward-only layer
  float* out;           // [ndir, H, N] fp32
};

// Grid (nt, mt, ndir S), clusters of S along z: block (n, m, d S + r) owns
// output tile (m, n) of direction d and K-tiles [r nk / S, (r+1) nk / S).
__global__ void __launch_bounds__(kThreads, 1)
    dw_kernel(const __grid_constant__ CUtensorMap ys_map,
              const __grid_constant__ CUtensorMap g1_map,
              const __grid_constant__ CUtensorMap g2_map, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_ring = smem_u32(smem);
  const uint32_t s_abf = s_ring + kRing;              // [2 wg][2 buf]
  const uint32_t s_full = s_abf + 4 * kABf;
  const uint32_t s_empty = s_full + kStages * 8;

  const int S = gridDim.z / a.ndir;
  const uint32_t rank = cluster_rank();
  const int d = blockIdx.z / S;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = static_cast<int>(static_cast<int64_t>(rank) * a.nk / S);
  const int k_end =
      static_cast<int>(static_cast<int64_t>(rank + 1) * a.nk / S);
  const int krows = a.kt * a.bc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(s_full + 8 * s, 1);
      mbar_init(s_empty + 8 * s, 8);   // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer: one lane keeps the ring full
    if (lane == 0) {
      const uint32_t bytes = krows * (2 * 64 * 4 + kNSub * 64 * 2);
      for (int q = k_begin; q < k_end; ++q) {
        const int i = q - k_begin, s = i % kStages;
        mbar_wait(s_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t full = s_full + 8 * s;
        mbar_expect_tx(full, bytes);
        const int t0 = 1 + (q / a.nbc) * a.kt, b0 = (q % a.nbc) * a.bc;
        const uint32_t st = s_ring + s * kStage;
        tma_load(st, &ys_map, full, m0, b0, d, t0 - 1);
        tma_load(st + kAHalf, &ys_map, full, m0 + 64, b0, d, t0 - 1);
        for (int j = 0; j < kNSub; ++j) {
          const int c = n0 + 64 * j;
          const bool first = c < a.n1 || a.n2 == 0;
          tma_load(st + 2 * kAHalf + j * kBSub, first ? &g1_map : &g2_map,
                   full, first ? c : c - a.n1, b0, d, t0);
        }
      }
    }
    __syncwarp();
  } else {
    // consumers: warpgroup w owns rows [m0 + 64 w, m0 + 64 w + 64)
    const int w = warp >> 2, wt = tid & 127;
    float acc[kNSub][32];
#pragma unroll
    for (int j = 0; j < kNSub; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;
    for (int q = k_begin; q < k_end; ++q) {
      const int i = q - k_begin, s = i % kStages;
      mbar_wait(s_full + 8 * s, (i / kStages) & 1);
      const unsigned char* st = smem + s * kStage;
      const float* src = reinterpret_cast<const float*>(st + w * kAHalf);
      const uint32_t abf = s_abf + (2 * w + (i & 1)) * kABf;
      unsigned char* abf_p = smem + kRing + (2 * w + (i & 1)) * kABf;
      // fp32 [krows][64] -> bf16 [krows][64], 16-byte chunks swizzled
      for (int e = wt; e < krows * 8; e += 128) {
        const int k = e >> 3, c = e & 7;
        const float4* x = reinterpret_cast<const float4*>(src + k * 64 + 8 * c);
        const float4 x0 = x[0], x1 = x[1];
        const uint4 v =
            make_uint4(pack_bf16(x0.x, x0.y), pack_bf16(x0.z, x0.w),
                       pack_bf16(x1.x, x1.y), pack_bf16(x1.z, x1.w));
        *reinterpret_cast<uint4*>(abf_p + k * 128 + ((c ^ (k & 7)) << 4)) = v;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + w, 128);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint32_t sb = s_ring + s * kStage + 2 * kAHalf;
      for (int kk = 0; kk < krows / 16; ++kk) {
        const uint64_t da = mn_desc(abf + kk * 2048);
#pragma unroll
        for (int j = 0; j < kNSub; ++j)
          wgmma_m64n64k16(acc[j], da, mn_desc(sb + j * kBSub + kk * 2048));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (lane == 0) mbar_arrive(s_empty + 8 * s);
    }
    // every consumer is done with the ring: it takes the partial tile
    named_sync(3, 256);
    float* red = reinterpret_cast<float*>(smem);
    const int r0 = 64 * w + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kNSub; ++j)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = r0 + 8 * ((i >> 1) & 1);
        const int col = 64 * j + 8 * (i >> 2) + 2 * (lane & 3);
        *reinterpret_cast<float2*>(red + row * kRedLd + col) =
            make_float2(acc[j][i], acc[j][i + 1]);
      }
  }
  cluster_sync();   // every block's partial tile is in its shared memory

  // rank r sums rows [r rpr, r rpr + rpr) over the cluster, in rank order
  const int rpr = (kBM + S - 1) / S;
  const int row0 = static_cast<int>(rank) * rpr;
  const int rows = min(rpr, kBM - row0);
  for (int e = tid; e < rows * (kBN / 4); e += kThreads) {
    const int row = row0 + e / (kBN / 4), c4 = e % (kBN / 4);
    const int m = m0 + row, n = n0 + 4 * c4;
    if (m >= a.H || n >= a.N) continue;
    const uint32_t addr = s_ring + (row * kRedLd + 4 * c4) * 4;
    float4 v = ld_peer(addr, 0);
    for (int r = 1; r < S; ++r) {
      const float4 x = ld_peer(addr, r);
      v.x += x.x;
      v.y += x.y;
      v.z += x.z;
      v.w += x.w;
    }
    *reinterpret_cast<float4*>(
        a.out + (static_cast<int64_t>(d) * a.H + m) * a.N + n) = v;
  }
  cluster_sync();   // no block leaves while a peer reads its tile
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// the map of one operand over [T, ndir, B, cols] with row stride `ld`
// elements, boxes of 64 columns x bc rows x 1 direction x kt frames
bool encode(CUtensorMap* map, const void* base, bool bf16, int T, int ndir,
            int B, int cols, int ld, const Plan& p) {
  const uint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(B),
                              static_cast<cuuint64_t>(ndir),
                              static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[3] = {ld * es, B * ld * es,
                                 static_cast<cuuint64_t>(ndir) * B * ld * es};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(p.bc), 1,
                             static_cast<cuuint32_t>(p.kt)};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  return fn != nullptr &&
         fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

bool takes(int T, int B, int H, int ndir, int ld1, int n1, int ld2,
           int n2) {
  return T >= 1 && B >= 1 && (ndir == 1 || ndir == 2) && H >= 4 &&
         H % 4 == 0 && n1 >= 4 && n1 % 4 == 0 && ld1 % 8 == 0 && ld1 >= n1 &&
         n2 >= 0 &&
         n2 % 4 == 0 && (n2 == 0 || (n1 % 64 == 0 && ld2 % 8 == 0 &&
                                     ld2 >= n2));
}

}  // namespace

// The launch shape at (T, B, H, N, ndir) on this card: out = {bc, kt,
// K-tiles a direction, S (blocks a cluster along K), output tiles (ndir mt
// nt), shared memory a block}.
CSR_API int csr_dw_plan(int T, int B, int H, int N, int ndir, int* out) {
  if (T < 1 || B < 1 || H < 1 || N < 1 || (ndir != 1 && ndir != 2))
    return cudaErrorInvalidValue;
  const Plan p = plan_for(T, B, H, N, ndir, sm_count());
  out[0] = p.bc;
  out[1] = p.kt;
  out[2] = p.nk;
  out[3] = p.split;
  out[4] = ndir * p.mt * p.nt;
  out[5] = kSmem;
  return cudaSuccess;
}

// ys [T, ndir*B, H] fp32 (the layer's carries); g1 [T, ndir*B, ld1] bf16
// read at columns [0, n1) and, when n2 > 0, g2 [T, ndir*B, ld2] bf16 at
// [0, n2) (the GRU's dxs[..., :2H] and dhn); out [ndir, H, n1 + n2] fp32,
// written whole. Requires H % 4 == 0, n1 % 4 == 0 (n1 % 64 == 0 with a
// second map), n2 % 4 == 0, row strides a multiple of 8 elements and
// 16-byte-aligned bases (the wrapper checks), T >= 1, B >= 1, ndir 1 or 2.
CSR_API int csr_dw(const float* ys, const void* g1, int ld1, int n1,
                   const void* g2, int ld2, int n2, float* out, int T, int B,
                   int H, int ndir, cudaStream_t stream) {
  if (!takes(T, B, H, ndir, ld1, n1, ld2, n2)) return cudaErrorInvalidValue;
  const int N = n1 + n2;
  const Plan p = plan_for(T, B, H, N, ndir, sm_count());
  CUtensorMap ys_map, g1_map, g2_map;
  if (!encode(&ys_map, ys, false, T, ndir, B, H, H, p) ||
      !encode(&g1_map, g1, true, T, ndir, B, n1, ld1, p) ||
      !encode(&g2_map, n2 > 0 ? g2 : g1, true, T, ndir, B, n2 > 0 ? n2 : n1,
              n2 > 0 ? ld2 : ld1, p))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nt, p.mt, ndir * p.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Args a = {H, N, n1, n2, p.bc, p.kt, (B + p.bc - 1) / p.bc, p.nk,
                  ndir, out};
  e = cudaLaunchKernelEx(&cfg, dw_kernel, ys_map, g1_map, g2_map, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
