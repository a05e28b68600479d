// Accuracy hits: one pass over the rows a mask keeps of a [n, c] float32
// matrix of scores, counting the rows whose argmax equals their label.
//
// The argmax has numpy's semantics exactly (numpy's float argmax loop):
//   * the first maximum wins on ties (-0.0 and +0.0 are equal),
//   * a row holding a NaN takes the index of its first NaN.
// A label outside [0, c) never hits.  So hits / rows equals
// (pred[mask].argmax(-1) == y[mask]).mean() bit for bit.
//
// No masked copy and no per-row call: rows are walked in blocks, each
// block's kept row indices compacted without a branch, and the rows kPrefetch
// places ahead in that list prefetched (the hardware's prefetchers stop at
// the 4 KiB page boundaries of a freshly allocated buffer, and the kept rows
// skip about).  On AVX2 hosts a row of 8 to 64 columns takes its maximum, NaN
// check and first-maximum search in vector registers (the first maximum is
// the lowest set bit of the row's equality mask).  Other widths, other hosts
// and rows holding a NaN take numpy's scalar loop.  Single-threaded: integer
// counts need no threads.
//
// Built at first use by stemgnn_tpu_torch/utils/native_build.py
// (g++ -O3 -march=native -std=c++17 -fPIC -shared) for utils/metrics.py.

#include <cstdint>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int64_t kBlock = 4096;
constexpr int64_t kPrefetch = 16;

// numpy's argmax loop for floats
inline int64_t argmax_scalar(const float* r, int64_t c) {
  float m = r[0];
  int64_t best = 0;
  if (m != m) return 0;
  for (int64_t j = 1; j < c; ++j) {
    const float v = r[j];
    if (!(v <= m)) {  // greater, or NaN
      m = v;
      best = j;
      if (v != v) break;
    }
  }
  return best;
}

#if defined(__AVX2__)
inline uint64_t eq_bits(const float* r, __m256 m) {
  return static_cast<uint32_t>(
      _mm256_movemask_ps(_mm256_cmp_ps(_mm256_loadu_ps(r), m, _CMP_EQ_OQ)));
}

// 8 <= c <= 64.  The last 8 columns are read as one (overlapping) vector,
// so no column is left out whatever c is.
inline int64_t argmax_avx2(const float* r, int64_t c) {
  const __m256 head = _mm256_loadu_ps(r);
  const __m256 tail = _mm256_loadu_ps(r + c - 8);
  __m256 mx = _mm256_max_ps(head, tail);
  __m256 nan = _mm256_or_ps(_mm256_cmp_ps(head, head, _CMP_UNORD_Q),
                            _mm256_cmp_ps(tail, tail, _CMP_UNORD_Q));
  for (int64_t j = 8; j + 8 <= c; j += 8) {
    const __m256 v = _mm256_loadu_ps(r + j);
    mx = _mm256_max_ps(mx, v);
    nan = _mm256_or_ps(nan, _mm256_cmp_ps(v, v, _CMP_UNORD_Q));
  }
  if (__builtin_expect(_mm256_movemask_ps(nan) != 0, 0))
    return argmax_scalar(r, c);
  // without NaNs the maximum is one of the row's values
  __m128 m4 = _mm_max_ps(_mm256_castps256_ps128(mx),
                         _mm256_extractf128_ps(mx, 1));
  m4 = _mm_max_ps(m4, _mm_movehl_ps(m4, m4));
  m4 = _mm_max_ss(m4, _mm_shuffle_ps(m4, m4, 1));
  const __m256 m = _mm256_set1_ps(_mm_cvtss_f32(m4));
  uint64_t bits = eq_bits(r + c - 8, m) << (c - 8);
  for (int64_t j = 0; j + 8 <= c; j += 8) bits |= eq_bits(r + j, m) << j;
  return __builtin_ctzll(bits);
}
#endif

inline int64_t row_argmax(const float* r, int64_t c) {
#if defined(__AVX2__)
  if (c >= 8 && c <= 64) return argmax_avx2(r, c);
#endif
  return argmax_scalar(r, c);
}

}  // namespace

extern "C" {

// pred [n, c] row-major float32 (c >= 1), y [n] int64 labels, mask [n]
// bytes (0 = skip) or null for every row.  Returns the hits and writes the
// rows kept to *rows.
int64_t stemgnn_masked_hits(const float* pred, const int64_t* y,
                            const uint8_t* mask, int64_t n, int64_t c,
                            int64_t* rows) {
  int64_t hits = 0, kept = 0;
  int64_t idx[kBlock + kPrefetch];
  const int64_t row_bytes = c * static_cast<int64_t>(sizeof(float));
  for (int64_t i0 = 0; i0 < n; i0 += kBlock) {
    const int64_t i1 = i0 + kBlock < n ? i0 + kBlock : n;
    int64_t k = 0;
    if (mask != nullptr) {
      for (int64_t i = i0; i < i1; ++i) {
        idx[k] = i;
        k += mask[i] != 0;
      }
    } else {
      for (int64_t i = i0; i < i1; ++i) idx[k++] = i;
    }
    // the prefetches past the block's last kept row read row i0 again
    for (int64_t t = k; t < k + kPrefetch; ++t) idx[t] = i0;
    for (int64_t t = 0; t < k; ++t) {
      const char* ahead =
          reinterpret_cast<const char*>(pred + idx[t + kPrefetch] * c);
      const char* last = ahead + row_bytes - 1;  // a row may span a line more
      for (; ahead < last; ahead += 64) __builtin_prefetch(ahead);
      __builtin_prefetch(last);
      const int64_t i = idx[t];
      hits += row_argmax(pred + i * c, c) == y[i];
    }
    kept += k;
  }
  *rows = kept;
  return hits;
}

}  // extern "C"
