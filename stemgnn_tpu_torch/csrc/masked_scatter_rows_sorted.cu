// masked_scatter_rows_sorted for NVIDIA Hopper (sm_90a): segment scatter-sum
// of per-edge gradients gated by the forward's relu mask, which the kernel
// recomputes from the node rows and the edge-type table.
//
// Replaces the Pallas TPU kernel stemgnn_tpu/ops/scatter_pallas.py
// masked_scatter_rows_sorted (:480, pallas_call :546; body
// _masked_block_kernel :356).  Its contract, over sender-sorted edges:
//
//   out[n] = sum_{e in [bp[b], bp[b+1]), lrow[e] == n mod 128}
//              1[f32(x[snd[e]]) + f32(T[xe[e]]) > 0] * dm[e]
//
// per column, with b = n / 128, f32 sums and no epilogue.  Without a table
// the mask is x[snd[e]] > 0.  x and the table are bf16: the TPU kernel
// rebuilt the pre-activation from bf16 one-hot products with f32
// accumulation, which is exactly the f32 sum of the two bf16 values tested
// here.  lrow == 128 (the sentinel) marks padded edges, whose sender is the
// sentinel N_pad: they are not in the plan, so x[N_pad] is never read.  A
// sender outside [0, N_pad) on a counted edge reads as a zero row, as the
// TPU kernel's windows give it.  dm is summed as given (bf16 or f32); the
// TPU kernel rounded an f32 dm to bf16 for its matrix unit.
//
// The TPU kernel streamed each edge chunk's sender rows from sequential
// x windows (win_lo, win_nsub, win_w) into one-hot matrix products.  In the
// sender-sorted layout lrow is the sender mod 128, so the row that gates an
// edge is its output row: the kernel holds that x row in registers and
// takes no window arrays.
//
// Bound on the H100: bytes.  Each dm value is used in one compare and one
// add, far below the ~295 operations per byte at which the tensor cores
// would bind.  The least time reads each input once and writes the output
// once: (E*(2D [bf16 dm] + 12 [lrow, snd, xe]) + N_pad*D*2 [x]
// + N_pad*D*4 [f32 out]) / 3.35 TB/s; dm dominates.
//
// Design: the row walk of row_walk.cuh.  The host plan (RowPlan) hands the
// kernel each counted edge's layout position (dm keeps the layout's sender
// order, so dm[pos] is one full row read per edge), sender and type in
// output-row order.  One warp walks one work item of at most RowPlan.chunk
// edges of one output row with the row's own x row in registers, its f32
// sums in registers, and writes the row once; a row longer than the chunk
// is split over several items and finished by the second pass.  An edge
// whose sender is not its row (no layout builds one; the contract allows
// it) reads x[snd] through the cache.  The type table is read through L1.

#include "row_walk.cuh"

namespace {

namespace rw = row_walk;
using bf16 = __nv_bfloat16;

struct Args {
  const void* dm;             // [E_pad, d] in layout order
  const int32_t* pos;         // [E_cnt] plan order -> layout position
  const int32_t* snd;         // [E_cnt] senders in plan order
  const int32_t* types;       // [E_cnt] xe in plan order, or NULL
  const int32_t* item_row;
  const int32_t* item_start;
  const int32_t* item_slot;
  const void* split_row;
  const void* split_ptr;
  const bf16* x;
  const bf16* table;
  void* out;
  float* partials;
  int n_items, n_split, n_pad, d, t_rows;
};

template <bool kTyped, typename MsgT, typename OutT, int Vec, int NV, int U,
          int kMinBlocks>
__global__ void __launch_bounds__(rw::kThreads, kMinBlocks)
masked_rows_kernel(const Args a) {
  const long long item = rw::warp_item(a.n_items);
  if (item < 0) return;
  const rw::Lane<Vec, NV> ln(a.d);
  const int lane = threadIdx.x & 31;
  const long long row = __ldg(a.item_row + item);
  const int start = __ldg(a.item_start + item);
  const int end = __ldg(a.item_start + item + 1);
  const int slot = __ldg(a.item_slot + item);
  const long long d = a.d;
  const MsgT* dm = static_cast<const MsgT*>(a.dm);

  float acc[NV][Vec];
  rw::Vals<bf16, Vec> xo[NV];                 // the output row's own x row
#pragma unroll
  for (int c = 0; c < NV; ++c) {
#pragma unroll
    for (int i = 0; i < Vec; ++i) acc[c][i] = 0.f;
    if (ln.has[c] && start < end) xo[c].load(a.x + row * d + ln.col[c]);
    else xo[c].zero();
  }

  for (int base = start; base < end; base += 32) {
    const int n_e = min(32, end - base);
    // 32 edges' indices, one coalesced read each; passed round by shuffles
    const int my_pos = lane < n_e ? __ldg(a.pos + base + lane) : 0;
    const int my_snd = lane < n_e ? __ldg(a.snd + base + lane) : -1;
    const int my_type =
        (kTyped && lane < n_e) ? __ldg(a.types + base + lane) : -1;
    for (int j = 0; j < n_e; j += U) {
      rw::Vals<MsgT, Vec> g[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long p = __shfl_sync(rw::kFull, my_pos, (j + u) & 31);
        const bool live = j + u < n_e;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          if (live && ln.has[c]) g[u][c].load(dm + p * d + ln.col[c]);
          else g[u][c].zero();
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long s = __shfl_sync(rw::kFull, my_snd, (j + u) & 31);
        const int t = __shfl_sync(rw::kFull, my_type, (j + u) & 31);
        if (j + u >= n_e) continue;
        const bool tin = kTyped && t >= 0 && t < a.t_rows;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          if (!ln.has[c]) continue;
          // the gating row: the output row's own on the sender-sorted
          // layout, else a read through the cache, zero outside [0, N_pad)
          rw::Vals<bf16, Vec> xs;
          if (s == row) xs = xo[c];
          else if (s >= 0 && s < a.n_pad) xs.load(a.x + s * d + ln.col[c]);
          else xs.zero();
          rw::Vals<bf16, Vec> tr;
          if (tin) tr.load(a.table + t * d + ln.col[c]);
          else tr.zero();
#pragma unroll
          for (int i = 0; i < Vec; ++i) {
            const float pre = kTyped ? xs[i] + tr[i] : xs[i];
            if (pre > 0.f) acc[c][i] += g[u][c][i];
          }
        }
      }
    }
  }
  rw::finish_item<OutT, Vec, NV>(acc, ln, row, slot, a.d, nullptr, 0,
                                 nullptr, nullptr, 0,
                                 static_cast<OutT*>(a.out), a.partials);
}

template <bool kTyped, typename MsgT, typename OutT, int Vec, int NV, int U,
          int kMinBlocks>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.n_items > 0)
    masked_rows_kernel<kTyped, MsgT, OutT, Vec, NV, U, kMinBlocks>
        <<<rw::grid_for(a.n_items, a.d, 32 * Vec * NV), rw::kThreads, 0,
           stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return rw::launch_split_pass<OutT, Vec, NV>(
      a.split_row, a.split_ptr, a.partials, a.n_split, a.d, nullptr, 0,
      nullptr, nullptr, 0, static_cast<OutT*>(a.out), stream);
}

// Whole rows: one dm row in flight a warp (U = 1) and no register cap
// (kMinBlocks 1), chosen on the H100 with stemgnn_tpu_torch/tune_row_walk.py,
// which builds other values with -D: the registers a deeper unroll costs
// buy more as warps an SM.
#ifndef K3_UNROLL
#define K3_UNROLL 1
#endif
#ifndef K3_MIN_BLOCKS
#define K3_MIN_BLOCKS 1
#endif
template <bool kTyped, typename MsgT, typename OutT>
cudaError_t launch_cols(const Args& a, int col_mode, cudaStream_t stream) {
  switch (col_mode) {
    case rw::kFullRow:
      return launch<kTyped, MsgT, OutT, 8, 3, K3_UNROLL, K3_MIN_BLOCKS>(
          a, stream);
    case rw::kPairs:
      return launch<kTyped, MsgT, OutT, 2, 3, 4, 1>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename MsgT, typename OutT>
cudaError_t launch_table(const Args& a, int col_mode, cudaStream_t stream) {
  if (a.table) return launch_cols<true, MsgT, OutT>(a, col_mode, stream);
  return launch_cols<false, MsgT, OutT>(a, col_mode, stream);
}

}  // namespace

// Plain C entry for ctypes.  dm [e_pad, d] (bf16 if dm_bf16 else f32) in
// layout order, pos, senders and types [E_cnt] int32 in plan order (types
// NULL without a table), the plan's item_row, item_slot [n_items],
// item_start [n_items + 1], split_row [n_split] and split_ptr [n_split + 1]
// int32, x [n_pad, d] bf16, table [t_rows, d] bf16 or NULL, out [n_pad, d]
// (bf16 if out_bf16 else f32), partials [RowPlan.num_slots, d] f32 scratch
// (NULL when n_split is 0).  col_mode is a row_walk::ColMode whose vector
// width divides d and the pointers' alignment.  Launches the walk, then the
// second pass over the split rows; returns the first cudaError_t (0 =
// success).
extern "C" int masked_scatter_rows_sorted_launch(
    const void* dm, const void* pos, const void* senders, const void* types,
    const void* item_row, const void* item_start, const void* item_slot,
    const void* split_row, const void* split_ptr, const void* x,
    const void* table, void* out, void* partials, int n_items, int n_split,
    int n_pad, int d, int t_rows, int dm_bf16, int out_bf16, int col_mode,
    void* stream) {
  const Args a{dm, static_cast<const int32_t*>(pos),
               static_cast<const int32_t*>(senders),
               static_cast<const int32_t*>(types),
               static_cast<const int32_t*>(item_row),
               static_cast<const int32_t*>(item_start),
               static_cast<const int32_t*>(item_slot), split_row, split_ptr,
               static_cast<const bf16*>(x), static_cast<const bf16*>(table),
               out, static_cast<float*>(partials), n_items, n_split, n_pad,
               d, table ? t_rows : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dm_bf16 && out_bf16) return launch_table<bf16, bf16>(a, col_mode, s);
  if (dm_bf16) return launch_table<bf16, float>(a, col_mode, s);
  if (out_bf16) return launch_table<float, bf16>(a, col_mode, s);
  return launch_table<float, float>(a, col_mode, s);
}
