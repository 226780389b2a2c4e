// The prefix beam's launch plan (beam.cu): which form takes a call, the
// narrow form's block size or the wide form's blocks a row, and where each
// part of a block's dynamic shared memory lies. Plain C++ apart from the
// host/device qualifier, so a host compiler builds it too: the kernels
// compute the plan again from their arguments, so the host and the device
// agree on every offset.
#pragma once

#ifdef __CUDACC__
#define CSR_HD __host__ __device__
#else
#define CSR_HD
#endif

namespace {

constexpr int kThreads = 128;           // the narrow form's block
constexpr int kMaxSplit = 2;            // ... 256 threads on long rows
constexpr int kNarrowLongRow = 1024;    // candidates past which: 256 threads
constexpr int kMaxBeam = 32;            // the narrow form: a warp's ranks
constexpr int kMaxCtx = 8;              // LM order <= 9
constexpr int kStageMaxV = 12288;       // 2 staged rows: 96 KB
constexpr int kSharedBudget = 200 * 1024;
constexpr int kMaxCluster = 4;          // blocks a row in the wide form
constexpr int kWideLongRow = 6144;      // candidates past which: >= 2

CSR_HD inline long long round16(long long x) {
  return (x + 15) / 16 * 16;
}

// 32-bit [K] arrays of the wide form's workspace (pairs: the state's two
// copies)
enum WideSlot {
  kWPb = 0, kWPnb = 2, kWH = 4, kWH2 = 6, kWPh = 8, kWPh2 = 10, kWLast = 12,
  kWTotal = 14, kWSpb, kWSpnb, kWStay, kWRep, kWHead, kWNext, kWCons,
  kWSlots = kWCons + 4
};

// One row's workspace (byte offsets, then the size): kWSlots [K] arrays of
// 32 bits, roff [K] int64 (LM row offsets), loc [K] (this block's
// survivors), surv and tmp [K rounded up to 32] (every block's survivors,
// the runs of their sort; then the final order), ctx [2][K][ctx_len].
struct WideLayout {
  long long roff, loc, surv, tmp, ctx, bytes;
};

CSR_HD inline WideLayout wide_layout(int K, int CL) {
  const long long kr = (K + 31) / 32 * 32;
  WideLayout l;
  l.roff = round16(static_cast<long long>(kWSlots) * K * 4);
  l.loc = l.roff + 8LL * K;
  l.surv = round16(l.loc + 8LL * K);
  l.tmp = l.surv + 8 * kr;
  l.ctx = l.tmp + 8 * kr;
  l.bytes = round16(l.ctx + 8LL * K * CL);
  return l;
}

// A call's launch plan. Dynamic shared memory: the narrow form [staged
// lp][keys][list][tracebacks], the wide form [staged lp][workspace][keys]
// [tracebacks], each part present where the plan says it fits.
struct Plan {
  int wide, staged, tb_shared, ws_shared, keys_shared;
  int split;         // narrow: threads / 128; wide: blocks a row (cluster)
  long long ws, keys, list, tb, smem, ws_bytes;   // offsets, sizes (bytes)
  long long cap;     // narrow: the list's entries
};

// The narrow form where K <= kMaxBeam, CL <= kMaxCtx, `wide` is 0 and the
// row's keys and list fit (256 threads past kNarrowLongRow candidates);
// else the wide form on the fewest blocks a row (1, 2 or kMaxCluster) whose
// share of the keys fits, two at least past kWideLongRow candidates (four
// with the keys computed again each sweep where none fits; one where the
// workspace itself does not fit and lives in a scratch).
CSR_HD inline Plan make_plan(int T, int V, int K, int CL, int wide) {
  const long long N = K + static_cast<long long>(K) * V;
  const long long stage = V <= kStageMaxV ? 2LL * V * 4 : 0;
  const long long tbb = static_cast<long long>(T) * K * 4;
  Plan p = {};
  p.staged = stage > 0;
  if (!wide && K <= kMaxBeam && CL <= kMaxCtx) {
    const int s = N > kNarrowLongRow ? kMaxSplit : 1;
    const long long nt = static_cast<long long>(kThreads) * s;
    p.cap = K * ((N + nt - 1) / nt);
    p.keys = round16(stage);
    p.list = round16(p.keys + 4 * N);
    p.tb = round16(p.list + 8 * p.cap);
    if (p.tb <= kSharedBudget) {
      p.split = s;
      p.ws_shared = p.keys_shared = 1;
      p.tb_shared = p.tb + tbb <= kSharedBudget;
      p.smem = p.tb + (p.tb_shared ? tbb : 0);
      return p;
    }
  }
  p.wide = 1;
  p.cap = 0;
  p.ws_bytes = wide_layout(K, CL > 1 ? CL : 1).bytes;
  p.ws = round16(stage);
  p.ws_shared = p.ws + p.ws_bytes <= kSharedBudget;
  const long long used = p.ws + (p.ws_shared ? p.ws_bytes : 0);
  int c = 1;
  if (p.ws_shared) {
    c = kMaxCluster;
    for (int q = N > kWideLongRow ? 2 : 1; q <= kMaxCluster; q *= 2) {
      if (used + 4 * ((N + q - 1) / q) <= kSharedBudget) {
        c = q;
        break;
      }
    }
  }
  p.split = c;
  p.keys = round16(used);
  const long long kb = 4 * ((N + c - 1) / c);
  p.keys_shared = p.keys + kb <= kSharedBudget;
  p.tb = round16(p.keys + (p.keys_shared ? kb : 0));
  p.tb_shared = p.tb + tbb <= kSharedBudget;
  p.smem = p.tb + (p.tb_shared ? tbb : 0);
  return p;
}

// csr_beam_plan's out[8] (its comment says what each entry is).
inline void plan_out(int T, int V, int K, int CL, int wide, int* out) {
  const Plan p = make_plan(T, V, K, CL, wide);
  out[0] = p.wide;
  out[1] = p.staged;
  out[2] = p.tb_shared;
  out[3] = p.ws_shared;
  out[4] = static_cast<int>(p.smem);
  out[5] = static_cast<int>(p.wide ? p.ws_bytes : 0);
  out[6] = p.split;
  out[7] = p.keys_shared;
}

}  // namespace
