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
// sentinel N_pad: such an edge loads nothing, so x[N_pad] is never read.  A
// sender outside [0, N_pad) on a live edge reads as a zero row, as the TPU
// kernel's windows give it.  dm is summed as given (bf16 or f32); the TPU
// kernel rounded an f32 dm to bf16 for its matrix unit.
//
// The TPU kernel streamed each edge chunk's sender rows from sequential
// x windows (win_lo, win_nsub, win_w) into one-hot matrix products.  In the
// sender-sorted layout lrow is the sender mod 128, so the row that gates an
// edge is one of its node block's own 128 output rows: the kernel stages
// that x tile once, and takes no window arrays.
//
// Bound on the H100: bytes.  Each dm value is used in one compare and one
// add, far below the ~295 operations per byte at which the tensor cores
// would bind.  The least time reads each input once and writes the output
// once: (E*(2D [bf16 dm] + 12 [lrow, snd, xe]) + N_pad*D*2 [x]
// + N_pad*D*4 [f32 out]) / 3.35 TB/s; dm dominates.
//
// Design, shared with scatter_rows_sorted.cu and
// gathered_scatter_rows_sorted.cu: one CUDA block owns one 128-row node
// block x one 128-column slice of D; each of its 64 threads owns two
// adjacent columns for all 128 rows.  Its f32 accumulator ([128][64] float2,
// 64 KB), its columns of the block's x tile ([128][64] bf16x2, 32 KB) and
// of the type table ([T][64] bf16x2) sit in shared memory, and no other
// thread touches them: no atomics, no barriers, a deterministic sum.  The
// thread walks the block's edge range kUnroll edges at a time; each batch's
// lrow, sender and type load one batch ahead, then all kUnroll dm loads are
// issued (a warp reads 128 or 256 contiguous bytes of a row), then the
// gated adds.  With ~97 KB of shared memory two blocks fit on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNodeBlock = 128;             // rows per node block (layout)
constexpr int kThreads = 64;                // threads per CUDA block
constexpr int kCols = 2 * kThreads;         // columns per CUDA block
constexpr int kUnroll = 16;                 // dm loads in flight

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ __nv_bfloat162 raw2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const __nv_bfloat162*>(p);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

// One batch of kUnroll edges' indices: local row (-1 when the edge does not
// count), sender and type row.  Loaded a batch ahead of its use.
struct EdgeBatch {
  int row[kUnroll];
  int snd[kUnroll];
  int type[kUnroll];
};

template <bool kTyped>
__device__ __forceinline__ void load_batch(EdgeBatch& eb, int base, int end,
                                           const int32_t* __restrict__ lrow,
                                           const int32_t* __restrict__ snd,
                                           const int32_t* __restrict__ xe) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int e = base + u;
    const bool in = e < end;
    const int r = in ? __ldg(lrow + e) : kNodeBlock;
    eb.row[u] = (r >= 0 && r < kNodeBlock) ? r : -1;
    // every slot below end is a valid array entry (padding holds the
    // sentinel), so sender and type load beside lrow, not after it
    eb.snd[u] = in ? __ldg(snd + e) : -1;
    if (kTyped) eb.type[u] = in ? __ldg(xe + e) : -1;
  }
}

template <bool kTyped, typename MsgT, typename OutT>
__global__ void __launch_bounds__(kThreads)
masked_scatter_rows_sorted_kernel(
    const MsgT* __restrict__ dm, const int32_t* __restrict__ lrow,
    const int32_t* __restrict__ snd, const int32_t* __restrict__ block_ptr,
    const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ table,
    const int32_t* __restrict__ xe, OutT* __restrict__ out, int e_pad,
    int n_pad, int d, int t_rows) {
  extern __shared__ float2 smem[];
  float2* acc = smem;                                   // [128][kThreads]
  __nv_bfloat162* xs = reinterpret_cast<__nv_bfloat162*>(
      smem + kNodeBlock * kThreads);                    // [128][kThreads]
  __nv_bfloat162* ts = xs + kNodeBlock * kThreads;      // [t_rows][kThreads]
  const int tid = threadIdx.x;
  const int col = blockIdx.y * kCols + 2 * tid;
  if (col >= d) return;                     // d is even: both columns or none
  const long long b = blockIdx.x;
  const long long row0 = b * kNodeBlock;
  // this thread's columns of the block's x tile and of the type table
  for (int r = 0; r < kNodeBlock; ++r) {
    acc[r * kThreads + tid] = make_float2(0.f, 0.f);
    xs[r * kThreads + tid] = raw2(x + (row0 + r) * d + col);
  }
  if (kTyped) {
    for (int t = 0; t < t_rows; ++t)
      ts[t * kThreads + tid] = raw2(table + static_cast<long long>(t) * d +
                                    col);
  }

  const int start = block_ptr[b];
  const int end = min(block_ptr[b + 1], e_pad);
  EdgeBatch cur, nxt;
  load_batch<kTyped>(nxt, start, end, lrow, snd, xe);
  for (int base = start; base < end; base += kUnroll) {
    cur = nxt;
    // the next batch's indices load while this batch's dm rows do
    if (base + kUnroll < end)
      load_batch<kTyped>(nxt, base + kUnroll, end, lrow, snd, xe);
    float2 g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      g[u] = cur.row[u] >= 0
                 ? load2(dm + static_cast<long long>(base + u) * d + col)
                 : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cur.row[u] < 0) continue;
      // the gating row: the block's own tile on the sender-sorted layout,
      // else a read through the cache, zero outside [0, N_pad)
      const long long s = cur.snd[u];
      float2 pre;
      if (s >= row0 && s < row0 + kNodeBlock)
        pre = __bfloat1622float2(xs[(s - row0) * kThreads + tid]);
      else if (s >= 0 && s < n_pad)
        pre = load2(x + s * d + col);
      else
        pre = make_float2(0.f, 0.f);
      if (kTyped) {
        const int t = cur.type[u];
        if (t >= 0 && t < t_rows) {
          const float2 tr = __bfloat1622float2(ts[t * kThreads + tid]);
          pre.x += tr.x;
          pre.y += tr.y;
        }
      }
      float2& a = acc[cur.row[u] * kThreads + tid];
      if (pre.x > 0.f) a.x += g[u].x;
      if (pre.y > 0.f) a.y += g[u].y;
    }
  }

  for (int r = 0; r < kNodeBlock; ++r)
    store2(out + (row0 + r) * d + col, acc[r * kThreads + tid]);
}

template <bool kTyped, typename MsgT, typename OutT>
cudaError_t launch(const void* dm, const void* lrow, const void* snd,
                   const void* block_ptr, const void* x, const void* table,
                   const void* xe, void* out, int num_blocks, int e_pad,
                   int d, int t_rows, cudaStream_t stream) {
  auto kernel = masked_scatter_rows_sorted_kernel<kTyped, MsgT, OutT>;
  const int smem = kNodeBlock * kThreads * sizeof(float2) +
                   (kNodeBlock + (kTyped ? t_rows : 0)) * kThreads *
                       sizeof(__nv_bfloat162);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_blocks, (d + kCols - 1) / kCols);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const MsgT*>(dm), static_cast<const int32_t*>(lrow),
      static_cast<const int32_t*>(snd),
      static_cast<const int32_t*>(block_ptr),
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(table),
      static_cast<const int32_t*>(xe), static_cast<OutT*>(out), e_pad,
      num_blocks * kNodeBlock, d, t_rows);
  return cudaGetLastError();
}

template <typename MsgT, typename OutT>
cudaError_t launch_table(const void* dm, const void* lrow, const void* snd,
                         const void* block_ptr, const void* x,
                         const void* table, const void* xe, void* out,
                         int num_blocks, int e_pad, int d, int t_rows,
                         cudaStream_t stream) {
  if (table)
    return launch<true, MsgT, OutT>(dm, lrow, snd, block_ptr, x, table, xe,
                                    out, num_blocks, e_pad, d, t_rows,
                                    stream);
  return launch<false, MsgT, OutT>(dm, lrow, snd, block_ptr, x, table, xe,
                                   out, num_blocks, e_pad, d, 0, stream);
}

}  // namespace

// Plain C entry for ctypes.  dm [e_pad, d] (bf16 if dm_bf16 else f32),
// lrow, snd [e_pad] int32, block_ptr [num_blocks + 1] int32, x [N_pad, d]
// bf16 with N_pad = 128 * num_blocks, table [t_rows, d] bf16 with xe
// [e_pad] int32, or both NULL, out [N_pad, d] (bf16 if out_bf16 else f32).
// d must be even, all arrays contiguous, and the shared memory of
// 96 KB + t_rows * 256 B must fit a block (t_rows <= 512).  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int masked_scatter_rows_sorted_launch(
    const void* dm, const void* lrow, const void* snd, const void* block_ptr,
    const void* x, const void* table, const void* xe, void* out,
    int num_blocks, int e_pad, int d, int t_rows, int dm_bf16, int out_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dm_bf16 && out_bf16)
    return launch_table<__nv_bfloat16, __nv_bfloat16>(
        dm, lrow, snd, block_ptr, x, table, xe, out, num_blocks, e_pad, d,
        t_rows, s);
  if (dm_bf16)
    return launch_table<__nv_bfloat16, float>(dm, lrow, snd, block_ptr, x,
                                              table, xe, out, num_blocks,
                                              e_pad, d, t_rows, s);
  if (out_bf16)
    return launch_table<float, __nv_bfloat16>(dm, lrow, snd, block_ptr, x,
                                              table, xe, out, num_blocks,
                                              e_pad, d, t_rows, s);
  return launch_table<float, float>(dm, lrow, snd, block_ptr, x, table, xe,
                                    out, num_blocks, e_pad, d, t_rows, s);
}
