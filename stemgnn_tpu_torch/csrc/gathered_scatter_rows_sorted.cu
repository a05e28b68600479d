// gathered_scatter_rows_sorted for NVIDIA Hopper (sm_90a): segment
// scatter-sum of messages that the kernel builds itself from gathered node
// rows, with a fused epilogue.
//
// Replaces the Pallas TPU kernel stemgnn_tpu/ops/scatter_pallas.py
// gathered_scatter_rows_sorted (:740, pallas_call :865; body
// _gathered_block_kernel :561, epilogue _epilogue :82).  Its contract:
//
//   msg[e]  = bf16(relu?(f32(x[keys[e]]) + f32(T[xe[e]] | t0)))
//   out[n]  = gate?(scale[n] * (init[n] + sum_{e in [bp[b], bp[b+1]),
//                                           lrow[e] == n mod 128} msg[e]))
//
// with b = n / 128, f32 sums, lrow == 128 (the sentinel) on padded edges
// (whose key is the sentinel N_pad), x and the type table in bf16.  The
// message is rounded to bf16 after the f32 add and the relu (which keeps
// NaN), then summed in f32: bit for bit what the TPU kernel and the JAX
// gather route do.  A key outside [0, N_pad) on a counted edge reads a zero
// row, as the TPU kernel's windows give it; padded edges are not in the
// plan, so the sentinel key is never dereferenced.
//
// The TPU kernel rebuilt each edge chunk's rows from sequential windows of
// x with one-hot matrix products, which pays only on locality-ordered
// graphs.  On Hopper a row gather goes through L2 at any address, so the
// kernel reads x[keys[e]] directly and needs no windows.
//
// Merged local/stray split (the TPU kernel's stray_src / stray_idx inputs,
// _gathered_block_kernel's with_stray branch): an edge whose stray rank
// stray_idx[e] >= 0 takes its row from stray_src[stray_idx[e]] (bf16, the
// rows the TPU kernel's one-hot product rounds to bf16) in place of
// x[keys[e]]; t0 / T[xe], the relu and the epilogue then apply as for every
// other edge.  Its key is the sentinel, which is never read.  The TPU
// kernel's per-chunk DMA metadata (stray_off, stray_cnt) is checked on the
// host and not read here.  The ranks come in plan order, as the keys do, so
// a merged launch is the same walk with one more index read per edge; the
// kernel without strays is a separate instantiation (kStray false) and
// does not pay for it.  Its least time adds the stray rows (S * D * 2) and
// the ranks (E * 4) to the bytes above.
//
// Bound on the H100: bytes.  Each gathered bf16 value is used in one or
// two adds, far below the ~295 operations per byte at which the tensor
// cores would bind.  The least time reads each input once: (distinct x rows
// * D * 2 + E * 8 [keys, lrow] (+ E * 4 [xe]) + N_pad * D * 4 [f32 init]
// + N_pad * D * 4 [f32 out]) / 3.35 TB/s.  The walk asks for one x row per
// edge (E * 2D bytes), served from L2 where the row is still there.
//
// Design: the row walk of row_walk.cuh.  The host plan (RowPlan) hands the
// kernel the keys (and xe) already permuted into output-row order, so one
// warp walks one work item of at most RowPlan.chunk edges of one output
// row, its f32 sums in registers, and finishes the row (init, scale, gate)
// with one write; a row longer than the chunk is split over several items
// and finished by the second pass.  The type table (<= 32 rows on the
// typed paths) is read through L1 like x; the t0 row is held in registers.

#include "row_walk.cuh"

namespace {

namespace rw = row_walk;
using bf16 = __nv_bfloat16;

enum TableMode { kNoTable = 0, kT0 = 1, kXe = 2 };

struct Args {
  const int32_t* keys;        // [E_cnt] keys in plan order
  const int32_t* types;       // [E_cnt] xe in plan order, or NULL
  const int32_t* sidx;        // [E_cnt] stray ranks in plan order, or NULL
  const bf16* stray_src;      // [S, d] stray rows, or NULL
  const int32_t* item_row;
  const int32_t* item_start;
  const int32_t* item_slot;
  const void* split_row;
  const void* split_ptr;
  const bf16* x;
  const bf16* table;
  const void* init;
  const float* scale;
  const void* gate;
  void* out;
  float* partials;
  int n_items, n_split, n_pad, d, t_rows, relu, init_bf16, gate_bf16;
};

template <int kTable, bool kStray, typename OutT, int Vec, int NV, int U,
          int kMinBlocks>
__global__ void __launch_bounds__(rw::kThreads, kMinBlocks)
gathered_rows_kernel(const Args a) {
  const long long item = rw::warp_item(a.n_items);
  if (item < 0) return;
  const rw::Lane<Vec, NV> ln(a.d);
  const int lane = threadIdx.x & 31;
  const long long row = __ldg(a.item_row + item);
  const int start = __ldg(a.item_start + item);
  const int end = __ldg(a.item_start + item + 1);
  const int slot = __ldg(a.item_slot + item);
  const long long d = a.d;  // 64-bit: the row offsets k * d, s * d, t * d
  if (slot < 0) {  // this item finishes its row: fetch the epilogue's rows
    rw::prefetch_row<Vec, NV>(a.init, a.init_bf16 ? 2 : 4, row, a.d, ln);
    rw::prefetch_row<Vec, NV>(a.gate, a.gate_bf16 ? 2 : 4, row, a.d, ln);
  }

  float acc[NV][Vec];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int i = 0; i < Vec; ++i) acc[c][i] = 0.f;
  // a 1-row table without an xe stream is the broadcast t0 shift
  rw::Vals<bf16, Vec> t0[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    if (kTable == kT0 && ln.has[c]) t0[c].load(a.table + ln.col[c]);
    else t0[c].zero();
  }

  for (int base = start; base < end; base += 32) {
    const int n_e = min(32, end - base);
    // 32 edges' indices, one coalesced read; passed round by shuffles
    const int my_key = lane < n_e ? __ldg(a.keys + base + lane) : -1;
    const int my_type =
        (kTable == kXe && lane < n_e) ? __ldg(a.types + base + lane) : -1;
    const int my_sidx = (kStray && lane < n_e) ? __ldg(a.sidx + base + lane)
                                               : -1;
    for (int j = 0; j < n_e; j += U) {
      rw::Vals<bf16, Vec> xr[U][NV];
      rw::Vals<bf16, Vec> tr[kTable == kXe ? U : 1][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = __shfl_sync(rw::kFull, my_key, (j + u) & 31);
        const bool live = j + u < n_e;
        const bool kin = live && k >= 0 && k < a.n_pad;
        const bf16* src = kin ? a.x + k * d : nullptr;
        if constexpr (kStray) {
          const int s = __shfl_sync(rw::kFull, my_sidx, (j + u) & 31);
          if (live && s >= 0) src = a.stray_src + s * d;
        }
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          if (src && ln.has[c]) xr[u][c].load(src + ln.col[c]);
          else xr[u][c].zero();
        }
        if constexpr (kTable == kXe) {
          const int t = __shfl_sync(rw::kFull, my_type, (j + u) & 31);
          const bool tin = live && t >= 0 && t < a.t_rows;
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            if (tin && ln.has[c]) tr[u][c].load(a.table + t * d + ln.col[c]);
            else tr[u][c].zero();
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u >= n_e) continue;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
#pragma unroll
          for (int i = 0; i < Vec; ++i) {
            float m = xr[u][c][i];
            if constexpr (kTable == kXe) m += tr[u][c][i];
            if constexpr (kTable == kT0) m += t0[c][i];
            if (a.relu) m = m < 0.f ? 0.f : m;      // keeps NaN
            acc[c][i] += __bfloat162float(__float2bfloat16_rn(m));
          }
        }
      }
    }
  }
  rw::finish_item<OutT, Vec, NV>(acc, ln, row, slot, a.d, a.init,
                                 a.init_bf16, a.scale, a.gate, a.gate_bf16,
                                 static_cast<OutT*>(a.out), a.partials);
}

template <int kTable, bool kStray, typename OutT, int Vec, int NV, int U,
          int kMinBlocks>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.n_items > 0)
    gathered_rows_kernel<kTable, kStray, OutT, Vec, NV, U, kMinBlocks>
        <<<rw::grid_for(a.n_items, a.d, 32 * Vec * NV), rw::kThreads, 0,
           stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return rw::launch_split_pass<OutT, Vec, NV>(
      a.split_row, a.split_ptr, a.partials, a.n_split, a.d, a.init,
      a.init_bf16, a.scale, a.gate, a.gate_bf16, static_cast<OutT*>(a.out),
      stream);
}

// Whole rows: rows in flight per warp (U) against warps per SM (the
// register cap of kMinBlocks blocks an SM), chosen on the H100 with
// stemgnn_tpu_torch/tune_row_walk.py, which builds other values with -D:
// more warps beat deeper unrolling, down to one row a warp in xe mode,
// whose type rows cost registers; the t0 and plain tails keep two.
#ifndef K2_UNROLL
#define K2_UNROLL 2
#endif
#ifndef K2_MIN_BLOCKS
#define K2_MIN_BLOCKS 5
#endif
#ifndef K2_XE_UNROLL
#define K2_XE_UNROLL 1
#endif
#ifndef K2_XE_MIN_BLOCKS
#define K2_XE_MIN_BLOCKS 8
#endif
template <int kTable, bool kStray, typename OutT>
cudaError_t launch_cols(const Args& a, int col_mode, cudaStream_t stream) {
  switch (col_mode) {
    case rw::kFullRow:
      if constexpr (kTable == kXe)
        return launch<kTable, kStray, OutT, 8, 3, K2_XE_UNROLL,
                      K2_XE_MIN_BLOCKS>(a, stream);
      else
        return launch<kTable, kStray, OutT, 8, 3, K2_UNROLL, K2_MIN_BLOCKS>(
            a, stream);
    case rw::kPairs:
      return launch<kTable, kStray, OutT, 2, 3, 4, 1>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kStray, typename OutT>
cudaError_t launch_table(const Args& a, int col_mode, cudaStream_t stream) {
  if (!a.table) return launch_cols<kNoTable, kStray, OutT>(a, col_mode,
                                                           stream);
  if (!a.types) return launch_cols<kT0, kStray, OutT>(a, col_mode, stream);
  return launch_cols<kXe, kStray, OutT>(a, col_mode, stream);
}

template <typename OutT>
cudaError_t launch_stray(const Args& a, int col_mode, cudaStream_t stream) {
  if (a.sidx) return launch_table<true, OutT>(a, col_mode, stream);
  return launch_table<false, OutT>(a, col_mode, stream);
}

}  // namespace

// Plain C entry for ctypes.  keys and types [E_cnt] int32 in plan order
// (types NULL without an xe stream), sidx [E_cnt] int32 stray ranks in plan
// order and stray_src [S, d] bf16 (both NULL without strays), the plan's item_row, item_slot
// [n_items], item_start [n_items + 1], split_row [n_split] and split_ptr
// [n_split + 1] int32, x [n_pad, d] bf16, table [t_rows, d] bf16 or NULL
// (a 1-row table with types NULL: t0 added to every message), init [n_pad,
// d] (bf16 if init_bf16 else f32) or NULL, scale [n_pad] f32 or NULL, gate
// [n_pad, d] (bf16 if gate_bf16 else f32) or NULL, out [n_pad, d] (bf16 if
// out_bf16 else f32), partials [RowPlan.num_slots, d] f32 scratch (NULL
// when n_split is 0).  col_mode is a row_walk::ColMode whose vector width
// divides d and the pointers' alignment.  Launches the walk, then the
// second pass over the split rows; returns the first cudaError_t (0 =
// success).
extern "C" int gathered_scatter_rows_sorted_launch(
    const void* keys, const void* types, const void* sidx,
    const void* stray_src, const void* item_row,
    const void* item_start, const void* item_slot, const void* split_row,
    const void* split_ptr, const void* x, const void* table,
    const void* init, const void* scale, const void* gate, void* out,
    void* partials, int n_items, int n_split, int n_pad, int d, int t_rows,
    int out_bf16, int relu, int init_bf16, int gate_bf16, int col_mode,
    void* stream) {
  const Args a{static_cast<const int32_t*>(keys),
               static_cast<const int32_t*>(types),
               static_cast<const int32_t*>(sidx),
               static_cast<const bf16*>(stray_src),
               static_cast<const int32_t*>(item_row),
               static_cast<const int32_t*>(item_start),
               static_cast<const int32_t*>(item_slot), split_row, split_ptr,
               static_cast<const bf16*>(x), static_cast<const bf16*>(table),
               init, static_cast<const float*>(scale), gate, out,
               static_cast<float*>(partials), n_items, n_split, n_pad, d,
               t_rows, relu, init_bf16, gate_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) return launch_stray<bf16>(a, col_mode, s);
  return launch_stray<float>(a, col_mode, s);
}
