// The row walk shared by scatter_rows_sorted.cu,
// gathered_scatter_rows_sorted.cu and masked_scatter_rows_sorted.cu on
// NVIDIA Hopper (sm_90a).
//
// The three kernels sum edge rows into output rows.  A host-side plan
// (stemgnn_tpu_torch/ops/edge_layout.py, RowPlan) lists the counted edges
// in output-row order (inside a row in the layout's order) and cuts them
// into work items: output row item_row[i], plan positions [item_start[i],
// item_start[i + 1]), at most RowPlan.chunk of them.  Every output row has
// at least one item, so every row gets its epilogue.
//
// One warp owns one work item and one slice of columns.  Lane l owns the
// chunks l, l + 32, ..., l + 32 (NV - 1) of Vec adjacent columns (16-byte
// reads for Vec = 8 bf16), so a warp reads 32 * Vec * 2 contiguous bytes of
// a bf16 row per chunk, and keeps NV * Vec f32 sums in registers: no shared
// memory, so occupancy is set by registers.  The warp loads 32 edges'
// indices at once (one coalesced read a lane) and passes them round with
// __shfl_sync; it then issues the rows of U edges before it adds any.  U is
// small (1-2, per kernel): on the H100 the registers a deeper unroll costs
// are worth more as warps an SM than as rows in flight a warp.
//
// An item of an unsplit row applies the epilogue and writes its output row
// once.  The items of a row longer than the chunk (a split row) write f32
// partial sums to a scratch slot each, and split_rows_kernel adds a split
// row's partials in item order and applies the epilogue.  No atomics: the
// sums are deterministic.
//
// A warp covers 32 * Vec * NV columns (768 with 16-byte reads); grid.y
// walks further slices of that width where D is wider, grid.x the items.
// Lanes whose chunk lies beyond D hold no columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace row_walk {

constexpr int kWarps = 4;                   // warps (work items) per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// Vec values of T (bf16 or f32) held as raw 32-bit words, read with one or
// two vector loads through the read-only path.
template <typename T, int Vec>
struct Vals {
  static constexpr int kWords = Vec * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kWords == 8) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    } else if constexpr (kWords == 4) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    } else if constexpr (kWords == 2) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = a.x; w[1] = a.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
  }
  // value i as f32 (a bf16 widens exactly: its bits are the top half)
  __device__ __forceinline__ float operator[](int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else {
      const uint32_t word = w[i >> 1];
      return __uint_as_float((i & 1) ? (word & 0xffff0000u) : (word << 16));
    }
  }
};

template <int Vec>
__device__ __forceinline__ void store_vals(float* p, const float (&v)[Vec]) {
  if constexpr (Vec == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (Vec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

template <int Vec>
__device__ __forceinline__ void store_vals(__nv_bfloat16* p,
                                           const float (&v)[Vec]) {
  uint32_t w[Vec / 2];
#pragma unroll
  for (int i = 0; i < Vec / 2; ++i) {
    const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(v[2 * i],
                                                               v[2 * i + 1]));
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  if constexpr (Vec == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (Vec == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// Vec values of an array that is bf16 (is_bf16) or f32, as f32.
template <int Vec>
__device__ __forceinline__ void load_any(const void* p, long long off,
                                         int is_bf16, float (&v)[Vec]) {
  if (is_bf16) {
    Vals<__nv_bfloat16, Vec> a;
    a.load(static_cast<const __nv_bfloat16*>(p) + off);
#pragma unroll
    for (int i = 0; i < Vec; ++i) v[i] = a[i];
  } else {
    Vals<float, Vec> a;
    a.load(static_cast<const float*>(p) + off);
#pragma unroll
    for (int i = 0; i < Vec; ++i) v[i] = a[i];
  }
}

// The columns a lane owns in this block's slice.
template <int Vec, int NV>
struct Lane {
  int col[NV];
  bool has[NV];
  __device__ __forceinline__ Lane(int d) {
    const int lane = threadIdx.x & 31;
    const int col0 = blockIdx.y * (32 * Vec * NV);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      col[c] = col0 + (lane + 32 * c) * Vec;
      has[c] = col[c] < d;
    }
  }
};

// The warp's work item (-1 past the last one).
__device__ __forceinline__ long long warp_item(int n_items) {
  const long long i = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  return i < n_items ? i : -1;
}

// Ask L2 for the lane's columns of row ``row`` of an epilogue input (init
// or gate, ``esize`` bytes a value) before the walk, so that the epilogue's
// reads after it find them there (kept on the H100 with
// stemgnn_tpu_torch/tune_row_walk.py, which builds -DROW_WALK_PREFETCH=0).
#ifndef ROW_WALK_PREFETCH
#define ROW_WALK_PREFETCH 1
#endif
template <int Vec, int NV>
__device__ __forceinline__ void prefetch_row(const void* p, int esize,
                                             long long row, int d,
                                             const Lane<Vec, NV>& ln) {
  if (!ROW_WALK_PREFETCH || !p) return;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    if (!ln.has[c]) continue;
    const char* a = static_cast<const char*>(p) + (row * d + ln.col[c]) *
                                                      esize;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
  }
}

// out[row] = gate?(scale[row] * (init[row] + acc)) for the lane's columns;
// the order of the f32 operations is the plain version's.
template <typename OutT, int Vec, int NV>
__device__ __forceinline__ void finish_row(
    float (&acc)[NV][Vec], const Lane<Vec, NV>& ln, long long row, int d,
    const void* init, int init_bf16, const float* scale, const void* gate,
    int gate_bf16, OutT* out) {
  const float s = scale ? __ldg(scale + row) : 1.f;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    if (!ln.has[c]) continue;
    const long long off = row * d + ln.col[c];
    if (init) {
      float v[Vec];
      load_any<Vec>(init, off, init_bf16, v);
#pragma unroll
      for (int i = 0; i < Vec; ++i) acc[c][i] += v[i];
    }
    if (scale) {
#pragma unroll
      for (int i = 0; i < Vec; ++i) acc[c][i] *= s;
    }
    if (gate) {
      float g[Vec];
      load_any<Vec>(gate, off, gate_bf16, g);
#pragma unroll
      for (int i = 0; i < Vec; ++i) acc[c][i] = g[i] > 0.f ? acc[c][i] : 0.f;
    }
    store_vals<Vec>(out + off, acc[c]);
  }
}

// An item of an unsplit row finishes its row; an item of a split row
// writes its partial sums to its slot.
template <typename OutT, int Vec, int NV>
__device__ __forceinline__ void finish_item(
    float (&acc)[NV][Vec], const Lane<Vec, NV>& ln, long long row, int slot,
    int d, const void* init, int init_bf16, const float* scale,
    const void* gate, int gate_bf16, OutT* out, float* partials) {
  if (slot >= 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c)
      if (ln.has[c])
        store_vals<Vec>(partials + static_cast<long long>(slot) * d +
                            ln.col[c], acc[c]);
    return;
  }
  finish_row<OutT, Vec, NV>(acc, ln, row, d, init, init_bf16, scale, gate,
                            gate_bf16, out);
}

// The second pass: one warp per split row adds the row's partial sums in
// item order, then applies the epilogue and writes the row.
template <typename OutT, int Vec, int NV>
__global__ void __launch_bounds__(kThreads)
split_rows_kernel(const int32_t* __restrict__ split_row,
                  const int32_t* __restrict__ split_ptr,
                  const float* __restrict__ partials, int n_split, int d,
                  const void* __restrict__ init, int init_bf16,
                  const float* __restrict__ scale,
                  const void* __restrict__ gate, int gate_bf16,
                  OutT* __restrict__ out) {
  const long long k = warp_item(n_split);
  if (k < 0) return;
  const Lane<Vec, NV> ln(d);
  const long long row = __ldg(split_row + k);
  const int lo = __ldg(split_ptr + k), hi = __ldg(split_ptr + k + 1);
  prefetch_row<Vec, NV>(init, init_bf16 ? 2 : 4, row, d, ln);
  prefetch_row<Vec, NV>(gate, gate_bf16 ? 2 : 4, row, d, ln);
  float acc[NV][Vec];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int i = 0; i < Vec; ++i) acc[c][i] = 0.f;
#pragma unroll 4
  for (int s = lo; s < hi; ++s) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if (!ln.has[c]) continue;
      Vals<float, Vec> p;
      p.load(partials + static_cast<long long>(s) * d + ln.col[c]);
#pragma unroll
      for (int i = 0; i < Vec; ++i) acc[c][i] += p[i];
    }
  }
  finish_row<OutT, Vec, NV>(acc, ln, row, d, init, init_bf16, scale, gate,
                            gate_bf16, out);
}

inline dim3 grid_for(int n_items, int d, int slice_cols) {
  return dim3((n_items + kWarps - 1) / kWarps,
              (d + slice_cols - 1) / slice_cols);
}

template <typename OutT, int Vec, int NV>
cudaError_t launch_split_pass(const void* split_row, const void* split_ptr,
                              const float* partials, int n_split, int d,
                              const void* init, int init_bf16,
                              const float* scale, const void* gate,
                              int gate_bf16, OutT* out,
                              cudaStream_t stream) {
  if (n_split == 0) return cudaSuccess;
  split_rows_kernel<OutT, Vec, NV>
      <<<grid_for(n_split, d, 32 * Vec * NV), kThreads, 0, stream>>>(
          static_cast<const int32_t*>(split_row),
          static_cast<const int32_t*>(split_ptr), partials, n_split, d, init,
          init_bf16, scale, gate, gate_bf16, out);
  return cudaGetLastError();
}

// Column layouts a launch may take (the wrapper picks one from D and the
// pointers' alignment):
//   kFullRow: Vec 8, NV 3 -> 768 columns a warp (16-byte reads);
//   kPairs:   Vec 2, NV 3 -> 192 columns a warp, any even D.
enum ColMode { kFullRow = 0, kPairs = 1 };

}  // namespace row_walk
