// scatter_rows_sorted for NVIDIA Hopper (sm_90a): segment scatter-sum of
// block-grouped edge messages into node rows, with a fused epilogue.
//
// Replaces the Pallas TPU kernel stemgnn_tpu/ops/scatter_pallas.py
// scatter_rows_sorted (:252, pallas_call :339; bodies _rolling_kernel :158,
// _block_kernel :98, _chunk_matmul :55, _epilogue :82).  Its contract:
//
//   out[n] = gate?(scale[n] * (init[n] + sum_{e in [bp[b], bp[b+1]),
//                                          lrow[e] == n mod 128} relu?(m[e])))
//
// with b = n / 128, f32 accumulation, and lrow == 128 (the sentinel) marking
// padded edges.  Inside a node block the edges are sorted by gather key, NOT
// by local row, so a row's edges are scattered over the block's range.  m is
// bf16 or f32 and summed as given; relu keeps NaN, as torch.relu does.
//
// Bound on the H100: bytes.  Each message value is read once and used in one
// add (and one compare under relu), far below the ~295 operations per byte
// at which the tensor cores would bind.  The least time is (E*(2D + 4)
// [bf16 messages, lrow] + N_pad*D*4 [f32 init] + N_pad*D*4 [f32 out])
// / 3.35 TB/s; the messages dominate.
//
// Design: the row walk of row_walk.cuh, as kernel 3 reads dm.  The host plan
// (RowPlan) lists each counted edge's layout position in output-row order
// (inside a row in the layout's order), cut into work items of at most
// RowPlan.chunk edges.  One warp walks one item: it loads 32 positions at
// once, passes them round by shuffles, reads one whole message row per edge
// (16 contiguous bytes a lane), keeps the row's f32 sums in registers and
// writes the row once with its epilogue; a row longer than the chunk is
// split over several items whose f32 partials the second pass adds in item
// order.  No shared-memory accumulator and no atomics: the sums are
// deterministic, and an unsplit row is summed in the plain version's
// index_add_ order.  The first design (one CUDA block per node block x 128
// columns, a 64 KB shared-memory tile, an edge at a time in gather-key order)
// read 35% / 26% of this bound on the arxiv hub tails: three blocks an SM,
// a shared-memory read-modify-write per edge and value, and node blocks of
// tens of thousands of edges beside blocks of a handful.

#include "row_walk.cuh"

namespace {

namespace rw = row_walk;
using bf16 = __nv_bfloat16;

struct Args {
  const void* m;              // [E_pad, d] messages in layout order
  const int32_t* pos;         // [E_cnt] plan order -> layout position
  const int32_t* item_row;
  const int32_t* item_start;
  const int32_t* item_slot;
  const void* split_row;
  const void* split_ptr;
  const void* init;
  const float* scale;
  const void* gate;
  void* out;
  float* partials;
  int n_items, n_split, d, relu, init_bf16, gate_bf16;
};

// The epilogue prefetch of row_walk.cuh (prefetch_row) is off here: on the
// H100 kernel 1's dropout tails ran 4.5% (forward) and 6.5% (backward)
// faster without it (stemgnn_tpu_torch/tune_row_walk.py, which builds
// -DK1_PREFETCH=1 to replay it), while kernel 2's forward tail gains from it.
#ifndef K1_PREFETCH
#define K1_PREFETCH 0
#endif

template <typename MsgT, typename OutT, int Vec, int NV, int U,
          int kMinBlocks>
__global__ void __launch_bounds__(rw::kThreads, kMinBlocks)
scatter_rows_kernel(const Args a) {
  const long long item = rw::warp_item(a.n_items);
  if (item < 0) return;
  const rw::Lane<Vec, NV> ln(a.d);
  const int lane = threadIdx.x & 31;
  const long long row = __ldg(a.item_row + item);
  const int start = __ldg(a.item_start + item);
  const int end = __ldg(a.item_start + item + 1);
  const int slot = __ldg(a.item_slot + item);
  const long long d = a.d;
  const MsgT* m = static_cast<const MsgT*>(a.m);
  if (K1_PREFETCH && slot < 0) {  // fetch the epilogue's rows
    rw::prefetch_row<Vec, NV>(a.init, a.init_bf16 ? 2 : 4, row, a.d, ln);
    rw::prefetch_row<Vec, NV>(a.gate, a.gate_bf16 ? 2 : 4, row, a.d, ln);
  }

  float acc[NV][Vec];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int i = 0; i < Vec; ++i) acc[c][i] = 0.f;

  for (int base = start; base < end; base += 32) {
    const int n_e = min(32, end - base);
    // 32 edges' positions, one coalesced read; passed round by shuffles
    const int my_pos = lane < n_e ? __ldg(a.pos + base + lane) : 0;
    for (int j = 0; j < n_e; j += U) {
      rw::Vals<MsgT, Vec> v[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long p = __shfl_sync(rw::kFull, my_pos, (j + u) & 31);
        const bool live = j + u < n_e;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          if (live && ln.has[c]) v[u][c].load(m + p * d + ln.col[c]);
          else v[u][c].zero();
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u >= n_e) continue;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
#pragma unroll
          for (int i = 0; i < Vec; ++i) {
            float x = v[u][c][i];
            if (a.relu) x = x < 0.f ? 0.f : x;      // keeps NaN
            acc[c][i] += x;
          }
        }
      }
    }
  }
  rw::finish_item<OutT, Vec, NV>(acc, ln, row, slot, a.d, a.init,
                                 a.init_bf16, a.scale, a.gate, a.gate_bf16,
                                 static_cast<OutT*>(a.out), a.partials);
}

template <typename MsgT, typename OutT, int Vec, int NV, int U,
          int kMinBlocks>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.n_items > 0)
    scatter_rows_kernel<MsgT, OutT, Vec, NV, U, kMinBlocks>
        <<<rw::grid_for(a.n_items, a.d, 32 * Vec * NV), rw::kThreads, 0,
           stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return rw::launch_split_pass<OutT, Vec, NV>(
      a.split_row, a.split_ptr, a.partials, a.n_split, a.d, a.init,
      a.init_bf16, a.scale, a.gate, a.gate_bf16, static_cast<OutT*>(a.out),
      stream);
}

// Whole rows: rows in flight a warp (U) against warps an SM (the register
// cap of kMinBlocks blocks an SM), replayed on the H100 with
// stemgnn_tpu_torch/tune_row_walk.py, which builds other values with -D:
// without the prefetch, one row in flight read 0.8% / 1.6% faster than two
// on the dropout tails (forward / backward), four 13-14%, eight 47-50%.
#ifndef K1_UNROLL
#define K1_UNROLL 1
#endif
#ifndef K1_MIN_BLOCKS
#define K1_MIN_BLOCKS 5
#endif
template <typename MsgT, typename OutT>
cudaError_t launch_cols(const Args& a, int col_mode, cudaStream_t stream) {
  switch (col_mode) {
    case rw::kFullRow:
      return launch<MsgT, OutT, 8, 3, K1_UNROLL, K1_MIN_BLOCKS>(a, stream);
    case rw::kPairs: return launch<MsgT, OutT, 2, 3, 4, 1>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes.  m [e_pad, d] (bf16 if msg_bf16 else f32) in
// layout order, pos [E_cnt] int32 (the plan's layout positions in plan
// order), the plan's item_row, item_slot [n_items], item_start [n_items + 1],
// split_row [n_split] and split_ptr [n_split + 1] int32, init [n_pad, d]
// (bf16 if init_bf16 else f32) or NULL, scale [n_pad] f32 or NULL, gate
// [n_pad, d] (bf16 if gate_bf16 else f32) or NULL, out [n_pad, d] (bf16 if
// out_bf16 else f32), partials [RowPlan.num_slots, d] f32 scratch (NULL when
// n_split is 0).  col_mode is a row_walk::ColMode whose vector width divides
// d and the pointers' alignment.  Launches the walk, then the second pass
// over the split rows; returns the first cudaError_t (0 = success).
extern "C" int scatter_rows_sorted_launch(
    const void* m, const void* pos, const void* item_row,
    const void* item_start, const void* item_slot, const void* split_row,
    const void* split_ptr, const void* init, const void* scale,
    const void* gate, void* out, void* partials, int n_items, int n_split,
    int d, int msg_bf16, int out_bf16, int relu, int init_bf16,
    int gate_bf16, int col_mode, void* stream) {
  const Args a{m, static_cast<const int32_t*>(pos),
               static_cast<const int32_t*>(item_row),
               static_cast<const int32_t*>(item_start),
               static_cast<const int32_t*>(item_slot), split_row, split_ptr,
               init, static_cast<const float*>(scale), gate, out,
               static_cast<float*>(partials), n_items, n_split, d, relu,
               init_bf16, gate_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (msg_bf16 && out_bf16) return launch_cols<bf16, bf16>(a, col_mode, s);
  if (msg_bf16) return launch_cols<bf16, float>(a, col_mode, s);
  if (out_bf16) return launch_cols<float, bf16>(a, col_mode, s);
  return launch_cols<float, float>(a, col_mode, s);
}
