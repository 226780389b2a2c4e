// Batch Levenshtein distance over padded int32 id matrices: the host-side
// scoring of the evaluate CLI and the training loop's dev eval (one call an
// eval batch and decoder). The port's copy of edit_distance_i32 and
// edit_distance_batch_i32 of the reference's native/csr_native.cpp.
//
// Built by utils/native.py with `g++ -O3 -shared -fPIC` at first use and
// loaded with ctypes; decode/metrics.edit_distance_py is the plain version
// the tests hold it to.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Levenshtein distance between two int32 id sequences.
int64_t edit_distance_i32(const int32_t* a, int64_t la,
                          const int32_t* b, int64_t lb) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  std::vector<int64_t> prev(lb + 1), cur(lb + 1);
  for (int64_t j = 0; j <= lb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= la; ++i) {
    cur[0] = i;
    const int32_t ai = a[i - 1];
    for (int64_t j = 1; j <= lb; ++j) {
      const int64_t sub = prev[j - 1] + (ai != b[j - 1]);
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

// Batch edit distance over padded id matrices [n, stride].
void edit_distance_batch_i32(const int32_t* hyps, const int32_t* hyp_lens,
                             const int32_t* refs, const int32_t* ref_lens,
                             int64_t n, int64_t hyp_stride, int64_t ref_stride,
                             int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = edit_distance_i32(hyps + i * hyp_stride, hyp_lens[i],
                               refs + i * ref_stride, ref_lens[i]);
  }
}

}  // extern "C"
