// Shared by the bf16 kernels of the recurrences (lstm_fwd.cu, lstm_bwd.cu,
// gru_fwd.cu, gru_bwd.cu): the clusters' shared-memory layout, the
// thread-block cluster's rank, distributed shared memory (DSMEM) stores and
// barrier, and the cluster launch; past H = 512, the persistent form's
// geometry and products (every bf16 kernel of both cells; below).
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

// The bf16 kernels past the resident form take up to H = kMaxHidden (the
// persistent form, below); a block may use kSmemMax bytes of dynamic
// shared memory.
constexpr int kResidentMax = 512;   // the resident form's largest H
constexpr int kMaxHidden = 2048;
constexpr int kSmemMax = 232448;    // dynamic shared memory a block (H100)

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

// ---------------------------------------------------------------------------
// The persistent form, past H = 512: gru_fwd.cu's gru_fwd_persist_kernel and
// lstm_bwd.cu's lstm_bwd_persist_kernel (A read from L2), lstm_fwd.cu's
// lstm_fwd_persist_kernel and gru_bwd.cu's gru_bwd_persist_kernel (A staged
// in shared memory). One cooperative launch of at most one block an SM, a
// direction's W spread over about sms / ndir blocks and kept in their
// shared memory where it fits, every row of the direction multiplied at
// each step (32 rows a pass: two m16 tiles share each B fragment), and the
// step's exchange through global memory (L2) behind one grid barrier a
// step.
//
// Geometry (ops/rnn_cuda.py's persist_plan computes the same): the
// product's N is H units in n8 tiles; a block owns nt = ceil((H / 8) /
// (sms / ndir)) tiles (the last block of a direction may own fewer), so a
// direction has NB = ceil((H / 8) / nt) blocks and the grid NB ndir, on a
// card of any SM count sms >= ndir. The kernels are built for groups of
// at most kGroupTiles tiles: a block runs its nt tiles as ng = ceil(nt /
// kGroupTiles) groups of nw8 = ceil(nt / ng) tiles (the last group may
// hold fewer of the block's tiles: its other columns are zero and their
// slots own nothing), one group after another inside each step, each
// group's product, partial sums and gate math in turn (one grid barrier a
// step still). On an H100 SXM (132 SMs) ng = 1 at every H; fewer SMs (an
// H100 PCIe's 114, a MIG slice) give ng > 1 past ndir H / 32 SMs. Each
// tile brings `cols` n8 columns of B (the forwards: their G gates; the
// backwards: one, the units j of dh_prev), nc = cols nw8 a group. The
// reduction of K k-steps is split over the block's warps, warp w taking
// [K w / nw, K (w + 1) / nw). B is laid out by the wrapper in fragment
// order, [ndir][NB][ng][K][nc][32 lanes] uint2 (each group's slice
// contiguous; with one group the [ndir][NB][K][nc][32] of a block of nt
// tiles); a warp keeps up to kr of its k-steps of every group in shared
// memory ([ng][nw][kr][nc][32] uint2, copied in once a launch) and reads
// the rest from global memory at each step (kr is as many as fit beside
// the partial sums and the staged A, 0 where none do). A, the exchanged
// h (forward) or dg (backward) in bf16, sits in global memory in fragment
// order too, [pass][2 m-tiles][K][32 lanes] uint4 a direction (a_word), so
// a lane's A fragment is one 16-byte word (8 bytes where the m-tile's rows
// 8-15 are past B). The GRU's forwards and the LSTM's backward read it
// with ld.global.cg through a register ring (persist_product); the LSTM's
// forwards and the GRU's backward stage it (staged_product), once a group:
// each warp copies its k-steps of A, and of B past its kr, into a ring of
// kStages slots of `chunk` k-steps in shared memory by cp.async.cg (L2
// only, never a stale L1 line), kStages - 1 slots ahead of its products,
// the whole of its A where it fits. The warps' partial sums meet in shared
// memory, [nw][2][nc][32] float4 (one group's, reused by the next behind a
// block barrier), and are added in warp order (no atomics: bitwise
// repeatable).
//
// The workspace, in global memory: the grid barrier's counter (256
// bytes), then the two A buffers ([2 parities][ndir][passes][2 m-tiles]
// [K][32 lanes] uint4, 1024·K bytes a pass and direction), then `carried`
// fp32 arrays [ndir·B][H] of what a slot carries past a step where it does
// not stay in registers (the LSTM backward: dc and dh_total; the LSTM
// forward: c; the GRU backward: dh). The wrappers allocate `work` bytes
// (on the card as csr_*_persist_plan reports them), and the kernels take
// their offsets from the same plan.
//
// A slot's state goes through registers only with one pass of one group
// (ng = 1), otherwise through the workspace. The C entries take the SM
// count their caller planned for and refuse one above the card's or
// below ndir (check_sms).
struct PersistPlan {
  int tiles, groups, width;   // nt, ng, nw8: tiles a block, groups, a group's
  int blocks, cols, warps, ksteps, resident, smem, passes;
  int chunk;            // k-steps a slot of the staged ring (0: A from L2)
  int64_t held, work;   // the carried state's offset; the workspace bytes
};

// The two copies of a persistent kernel's steps (generic lambdas over a
// tag, so each copy is its own loop, inlined where it is called once):
// OneGroup where a block runs one group, as on a card of ndir H / 32 SMs
// or more (the group index 0 at compile time, a slot's state in
// registers where the form allows: the code of a kernel built for nt
// tiles), Groups for more (any group, the state through the workspace)
struct OneGroup {
  static constexpr bool one = true;
};
struct Groups {
  static constexpr bool one = false;
};

constexpr int kPassRows = 32;   // rows a pass: two m16 tiles
constexpr int kGroupTiles = 4;  // tiles a group at most: the built widths
constexpr int kStages = 4;      // slots of a warp's staged ring
constexpr int kStreamChunk = 2; // k-steps a slot where W is streamed

__host__ __device__ constexpr int persist_part(int nc, int warps) {
  return warps * 2 * nc * 512;
}

// the bytes of one k-step in a slot of the staged ring: A's two m-tiles
// (1024), and B's ncw columns (256 each) where the warps stream some of W
__host__ __device__ constexpr int stage_bytes(int ncw, bool streamed) {
  return 1024 + (streamed ? ncw * 256 : 0);
}

// The plan of a kernel of `cols` B columns a tile, K = ksteps, `warps`
// warps and `carried` fp32 [ndir·B][H] arrays on a card of `sms` >= ndir
// SMs; `staged`: A staged in shared memory (the products of at most
// `ncmax` columns: a wider group runs them in halves, and its ring holds
// a half's streamed B). The resident W counts every group's columns (ng nc
// 256 bytes a k-step). Staged, the warps keep all their k-steps of W
// where it fits beside a ring of chunks as large as fit up to ceil(kq /
// kStages) (then the ring holds the whole of a warp's A); where W does
// not fit, a ring of kStreamChunk-k-step slots of A and the streamed B,
// and as many resident k-steps as fit beside it (slots of 2 k-steps
// against 1: 0.91x the GRU backward's time at H = 2048, 0.96-0.98x the
// LSTM forwards', on an H100, PERF.md).
inline PersistPlan persist_plan(int H, int ndir, int B, int sms, int cols,
                                int ksteps, int warps, int carried,
                                bool staged = false, int ncmax = 1 << 30) {
  PersistPlan p{};
  const int nt_all = H / 8, per = sms / ndir;
  p.tiles = per > 0 ? (nt_all + per - 1) / per : nt_all;
  p.groups = (p.tiles + kGroupTiles - 1) / kGroupTiles;
  p.width = (p.tiles + p.groups - 1) / p.groups;
  p.blocks = (nt_all + p.tiles - 1) / p.tiles;
  p.cols = cols;
  p.warps = warps;
  p.ksteps = ksteps;
  const int nc = cols * p.width, part = persist_part(nc, warps);
  const int kq = (ksteps + warps - 1) / warps;
  const int wk = p.groups * nc * 256;             // W bytes a k-step
  if (staged) {
    const int room = (kSmemMax - part) / warps;   // bytes a warp
    const int ncw = nc / ((nc + ncmax - 1) / ncmax);
    const int whole = (kq + kStages - 1) / kStages;
    int ring = 0;
    if (kq * wk + kStages * stage_bytes(ncw, false) <= room) {
      p.resident = kq;
      const int fit = (room - kq * wk) / (kStages * stage_bytes(ncw, false));
      p.chunk = fit < whole ? fit : whole;
    } else {
      p.chunk = kStreamChunk;
      ring = kStages * kStreamChunk * stage_bytes(ncw, true);
      p.resident = (room - ring) / wk;
    }
    if (ring == 0) ring = kStages * p.chunk * stage_bytes(ncw, false);
    p.smem = part + warps * (p.resident * wk + ring);
  } else {
    const int fit = (kSmemMax - part) / (warps * wk);
    p.resident = kq < fit ? kq : fit;
    p.smem = part + warps * p.resident * wk;
  }
  p.passes = (B + kPassRows - 1) / kPassRows;
  p.held = 256 + int64_t(2) * ndir * p.passes * 1024 * ksteps;
  p.work = p.held + int64_t(carried) * ndir * B * H * 4;
  return p;
}

// the SM count of the current device, into *n → the query's status
inline cudaError_t device_sms(int* n) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess
             ? e
             : cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
}

// whether a caller's SM count can be planned for on this card: at least
// one block a direction (ndir), at most the card's SMs → cudaSuccess,
// cudaErrorInvalidValue, or the query's error
inline cudaError_t check_sms(int sms, int ndir) {
  int n = 0;
  const cudaError_t e = device_sms(&n);
  if (e != cudaSuccess) return e;
  return sms < ndir || sms > n ? cudaErrorInvalidValue : cudaSuccess;
}

// the blocks of `kernel` (`threads`, `smem` bytes) the card holds at once,
// into *n → the query's status (the attribute for `smem` set first)
template <typename... Exp>
cudaError_t coresident_blocks(void (*kernel)(Exp...), int threads, int smem,
                              int* n) {
  int sms = 0, per = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = device_sms(&sms);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads,
                                                      smem);
  *n = per * sms;
  return e;
}

// plan p as the csr_*_persist_plan queries report it: out = (blocks a
// direction, tiles a block, resident k-steps a warp, shared memory bytes
// a block, blocks of `kernel` (`threads` a block) the card holds at once:
// cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs, workspace
// bytes, k-steps a slot of the staged ring: 0 where A is read from L2,
// groups a block) → the occupancy query's status
template <typename... Exp>
int report_plan(const PersistPlan& p, void (*kernel)(Exp...), int threads,
                long long* out) {
  int n = 0;
  const cudaError_t e = coresident_blocks(kernel, threads, p.smem, &n);
  const long long v[8] = {p.blocks, p.tiles, p.resident, p.smem,
                          n,        p.work,  p.chunk,    p.groups};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return static_cast<int>(e);
}

// zeroes the grid barrier's counter (4 bytes at `counter`) on `stream`,
// then launches `kernel` on `grid` blocks as a cooperative launch: all
// blocks resident at once, or the launch fails (never a partial grid that
// would wait forever at the barrier) → the launch status
template <typename... Exp, typename... Act>
int launch_cooperative(void (*kernel)(Exp...), int grid, int threads,
                       int smem, cudaStream_t stream, void* counter,
                       Act&&... args) {
  int n = 0;
  cudaError_t e = coresident_blocks(kernel, threads, smem, &n);
  if (e == cudaSuccess && n < grid) e = cudaErrorCooperativeLaunchTooLarge;
  if (e == cudaSuccess) e = cudaMemsetAsync(counter, 0, 4, stream);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The grid barrier, in two halves: after grid_wait, every block's stores
// before its grid_arrive are seen by every thread of the block. A monotone
// counter (zeroed before the launch, so a CUDA graph's replay starts
// clean); the n-th barrier of a launch waits for n·gridDim.x arrivals.
// Thread 0 arrives (fence, then a release add at GPU scope) once the
// block's threads have passed a block barrier, and polls with acquire
// loads; a block barrier after the poll orders its threads' loads. Work
// between the halves (the next step's input loads) overlaps the wait; it
// must not touch what other blocks write before their arrival. A barrier
// still short of its arrivals after 2^28 polls (minutes) traps: a launch
// error, not a hang.
__device__ __forceinline__ void grid_arrive(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.add.u32 [%0], %1;\n" ::"l"(counter),
                 "r"(1u)
                 : "memory");
  }
}

__device__ __forceinline__ void grid_wait(unsigned int* counter,
                                          unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int v, polls = 0;
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(counter)
                   : "memory");
      if (++polls == (1u << 28)) __trap();
    } while (v < target);
  }
  __syncthreads();
}

// 8 and 16 bytes of shared memory at a shared-space address: the
// persistent products read their shared memory so, since through a
// generic pointer the compiler may rebuild the shared window's base at
// each k-step (an S2UR on the load's address path)
__device__ __forceinline__ uint2 lds8(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// the line at p into L2, kept past lines marked to go first
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2::evict_last [%0];\n" ::"l"(p));
}

// acc[m][c] += A_m B_c over one warp's kw k-steps: A from global memory
// (a0, a1: this lane's fragment of m-tile 0 and 1 at the warp's first
// k-step, 32 uint4 a k-step, words (a0, a2, a1, a3) of the m16n8k16
// fragment; m-tile 1 only where `two`; `full0` / `full1`: whether rows
// 8-15 of the m-tile hold rows of the pass, else only the first 8 bytes,
// rows 0-7, are read), B from shared memory for the first kres k-steps
// (sb: the shared-space address of this lane's fragment of column 0 at
// the first k-step, nc·256 bytes a k-step) and from global memory past
// them (gb: the same in the launch's
// layout; only with kSt). Where the slice is resident (!kSt) the warp
// walks its k-steps from `rot` on, wrapping: each block of a direction
// starts elsewhere, so the blocks do not all ask L2 for the same lines at
// once (where B is streamed too, the plain order measured faster). A (and
// streamed B) loads run P k-steps ahead in a register ring, the registers
// allowing no deeper one; the streamed B of k-step i + 2P is prefetched
// into L2 at k-step i (measured against a copy without it, PERF.md);
// a k-step's B fragments are all loaded from shared memory before its
// products, so their latency is paid once a k-step.
template <int NC, int P, bool kSt>
__device__ __forceinline__ void persist_product(
    float (&acc)[2][NC][4], const uint4* __restrict__ a0,
    const uint4* __restrict__ a1, bool two, bool full0, bool full1, int kw,
    int kres, int rot, uint32_t sb, const uint2* __restrict__ gb) {
  uint4 ra[P][2];
  uint2 rb[kSt ? P : 1][NC];
  if (kSt) rot = 0;
  auto step = [&](int i) { return i + rot < kw ? i + rot : i + rot - kw; };
  auto half = [](const uint4* a, bool full) {
    if (full) return __ldcg(a);
    const uint2 v = __ldcg(reinterpret_cast<const uint2*>(a));
    return make_uint4(v.x, v.y, 0u, 0u);
  };
  auto fetch = [&](int slot, int i) {
    const int k = step(i);
    ra[slot][0] = half(a0 + k * 32, full0);
    if (two) ra[slot][1] = half(a1 + k * 32, full1);
    if (kSt && k >= kres)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        rb[kSt ? slot : 0][c] = __ldg(gb + (k * NC + c) * 32);
  };
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (p < kw) fetch(p, p);
  for (int k0 = 0; k0 < kw; k0 += P) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = k0 + p;
      if (i < kw) {
        const int k = step(i);
        uint2 b[NC];
        if (!kSt || k < kres) {
#pragma unroll
          for (int c = 0; c < NC; ++c) b[c] = lds8(sb + (k * NC + c) * 256);
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c) b[c] = rb[kSt ? p : 0][c];
        }
        const uint32_t am[4] = {ra[p][0].x, ra[p][0].z, ra[p][0].y,
                                ra[p][0].w};
        const uint32_t an[4] = {ra[p][1].x, ra[p][1].z, ra[p][1].y,
                                ra[p][1].w};
        if (i + P < kw) fetch(p, i + P);
        if (kSt && i + 2 * P < kw && step(i + 2 * P) >= kres)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            prefetch_l2(gb + (step(i + 2 * P) * NC + c) * 32);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          mma(acc[0][c], am, b[c].x, b[c].y);
          if (two) mma(acc[1][c], an, b[c].x, b[c].y);
        }
      }
    }
  }
}

// acc[m][c] += A_m B_c over one warp's kw k-steps for NC columns, A and
// the streamed B staged in shared memory. a0, a1: m-tile 0 and 1 of A in
// global memory at the warp's first k-step (32 uint4 a k-step, all lanes;
// m-tile 1 only where `two`); sb: the shared-space address of this lane's
// resident fragment of the first column at that k-step (nc·256 bytes a
// k-step, its first kres k-steps); gb: the same columns in the launch's layout in global memory
// (lane 0), read past kres; ring: this warp's kStages slots of ck k-steps
// of stage_bytes(NC, kres < kq) bytes each (`sz`). The warp walks its
// chunks of ck k-steps from chunk `rot` on, wrapping, and copies chunk i +
// kStages - 1 (A, and B past kres) by cp.async.cg while it multiplies
// chunk i from its slot; each lane waits for its own copies, then a warp
// barrier makes every lane's visible. The caller has passed the barrier
// after which A is complete; the ring is free again on return.
template <int NC>
__device__ __forceinline__ void staged_product(
    float (&acc)[2][NC][4], const uint4* __restrict__ a0,
    const uint4* __restrict__ a1, bool two, int kw, int kres, int rot,
    uint32_t sb, int nc, const uint2* __restrict__ gb, unsigned char* ring,
    int ck, int sz, int l) {
  const int nq = (kw + ck - 1) / ck;
  const uint32_t s_ring = smem_addr(ring);
  auto first = [&](int q) {
    const int c = q + rot < nq ? q + rot : q + rot - nq;
    return c * ck;
  };
  auto copy = [&](int q) {
    const int k0 = first(q), n = kw - k0 < ck ? kw - k0 : ck;
    const uint32_t slot = s_ring + (q % kStages) * ck * sz;
    for (int kk = 0; kk < n; ++kk) {
      const int k = k0 + kk;
      const uint32_t dst = slot + kk * sz;
      cp_async16(dst + l * 16, a0 + k * 32 + l, true);
      if (two) cp_async16(dst + 512 + l * 16, a1 + k * 32 + l, true);
      if (k >= kres) {
        const char* src = reinterpret_cast<const char*>(gb + k * nc * 32);
        for (int i = l; i < NC * 16; i += 32)
          cp_async16(dst + 1024 + i * 16, src + i * 16, true);
      }
    }
  };
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < nq) copy(q);
    cp_async_commit();
  }
  for (int q = 0; q < nq; ++q) {
    if (q + kStages - 1 < nq) copy(q + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int k0 = first(q), n = kw - k0 < ck ? kw - k0 : ck;
    const uint32_t slot = s_ring + (q % kStages) * ck * sz;
    for (int kk = 0; kk < n; ++kk) {
      const int k = k0 + kk;
      const uint32_t st = slot + kk * sz;
      const uint4 va = lds16(st + l * 16);
      const uint4 vb = two ? lds16(st + 512 + l * 16)
                           : make_uint4(0u, 0u, 0u, 0u);
      uint2 b[NC];
      if (k < kres) {
#pragma unroll
        for (int c = 0; c < NC; ++c) b[c] = lds8(sb + (k * nc + c) * 256);
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) b[c] = lds8(st + 1024 + (c * 32 + l) * 8);
      }
      const uint32_t am[4] = {va.x, va.z, va.y, va.w};
      const uint32_t an[4] = {vb.x, vb.z, vb.y, vb.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        mma(acc[0][c], am, b[c].x, b[c].y);
        if (two) mma(acc[1][c], an, b[c].x, b[c].y);
      }
    }
    __syncwarp();
  }
}

// A warp's k-steps [kb, kb + kw) of K over nw warps, how many of them it
// keeps in shared memory (kr at most), and where block cb of NB starts
// its walk over them (spread evenly)
struct WarpSteps {
  int kb, kw, kres, rot;
};
__device__ __forceinline__ WarpSteps warp_steps(int w, int nw, int K,
                                                int kr, int cb = 0,
                                                int NB = 1) {
  WarpSteps s;
  s.kb = K * w / nw;
  s.kw = K * (w + 1) / nw - s.kb;
  s.kres = s.kw < kr ? s.kw : kr;
  s.rot = s.kw * cb / NB;
  return s;
}

// the block's resident B fragments into shared memory: for each of its
// ng groups (the group's [K][nc][32] uint2 at slice + g K nc 32, the
// block's slice in the launch's layout), warp w's first kres k-steps of
// its range (nc·256 bytes a k-step, contiguous) at s_res + (g nw + w) kr
// nc 256; every thread shares the copies
__device__ __forceinline__ void load_resident(uint32_t s_res,
                                              const uint2* __restrict__ slice,
                                              int nw, int K, int kr, int nc,
                                              int ng = 1) {
  for (int g = 0; g < ng; ++g)
    for (int w = 0; w < nw; ++w) {
      const WarpSteps s = warp_steps(w, nw, K, kr);
      const char* src = reinterpret_cast<const char*>(slice) +
                        (int64_t(g) * K + s.kb) * nc * 256;
      const uint32_t dst = s_res + (g * nw + w) * kr * nc * 256;
      for (int q = threadIdx.x; q < s.kres * nc * 16; q += blockDim.x)
        cp_async16(dst + q * 16, src + int64_t(q) * 16, true);
    }
  cp_async_commit();
  cp_async_wait<0>();
}

// a warp's accumulators into its slots of the partial sums
// ([nw][2][nc][32] float4 at s_part): NC columns from column c0 of the
// block's nc (a product run in column halves), all of them by default
template <int NC>
__device__ __forceinline__ void store_partials(float* part,
                                               const float (&acc)[2][NC][4],
                                               bool two, int w, int l,
                                               int nc = NC, int c0 = 0) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
    if (m == 0 || two)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        reinterpret_cast<float4*>(part)[((w * 2 + m) * nc + c0 + c) * 32 + l] =
            make_float4(acc[m][c][0], acc[m][c][1], acc[m][c][2],
                        acc[m][c][3]);
}

// the sum over the nw warps, in warp order, of slot (m, c, l)
__device__ __forceinline__ float4 sum_partials(const float* part, int nw,
                                               int nc, int m, int c, int l) {
  const float4* p = reinterpret_cast<const float4*>(part);
  float4 s = p[(m * nc + c) * 32 + l];
  for (int w = 1; w < nw; ++w) {
    const float4 v = p[((w * 2 + m) * nc + c) * 32 + l];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  return s;
}

// where the bf16 pair of A at (row m·16 + l/4 + 8i, column k, k + 1), k
// even, goes: the 4-byte word of lane l' = 4 (row % 8) + (k % 8) / 2 of
// k-step k / 16 — for a slot's own pair (l' = l) the word 2 i + k / 8 % 2
// of lane l's uint4 (fragment words a0, a2, a1, a3: rows 0-7 of the m16
// tile in the first 8 bytes)
__device__ __forceinline__ uint32_t* a_word(uint4* a_mt, int k, int i,
                                            int l) {
  return reinterpret_cast<uint32_t*>(a_mt + (k / 16) * 32 + l) + 2 * i +
         ((k / 8) & 1);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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
