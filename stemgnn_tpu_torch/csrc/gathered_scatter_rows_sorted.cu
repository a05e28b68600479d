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
// message is rounded to bf16 after the f32 add and the relu, then summed
// in f32: bit for bit what the TPU kernel and the JAX gather route do.
//
// The TPU kernel rebuilt each edge chunk's rows from sequential windows of
// x with one-hot matrix products, which pays only on locality-ordered
// graphs.  On Hopper a row gather goes through L2 at any address, so the
// kernel reads x[keys[e]] directly and needs no windows: it is the gather
// route (index_select of an [E, D] message tensor + scatter_rows_sorted)
// without the message tensor's write and re-read.
//
// Bound on the H100: bytes.  Each gathered bf16 value is used in one or
// two adds, far below the ~295 operations per byte at which the tensor
// cores would bind.  The least time reads each input once: (N_pad*D*2 [x]
// + E*8 [keys, lrow] + N_pad*D*4 [f32 init] + N_pad*D*4 [f32 out])
// / 3.35 TB/s.  The row walk in edge order asks for about E*2D bytes of x
// instead (E/N_pad ~ 4.3 rows per node on the arxiv tail), served from L2
// where the rows are still there.
//
// Design, shared with scatter_rows_sorted.cu: one CUDA block owns one
// 128-row node block x one 128-column slice of D; each of its 64 threads
// owns two adjacent columns for all 128 rows in a [128][64] float2
// shared-memory accumulator (64 KB), so there are no atomics, no barriers
// and the sum is deterministic.  The thread walks the block's edge range
// kUnroll edges at a time.  Each batch's lrow, key (and xe) are loaded one
// batch ahead, side by side, so a batch waits on one round trip (its rows)
// and not three (lrow, then key, then row); then all kUnroll row loads are
// issued (a warp reads 128 contiguous bytes of a row), then the adds.  The
// grid walks all node blocks of one column slice before the next, so the
// slice of x being read (N_pad x 256 B, 43 MB at arxiv scale) stays in L2.
// The type table is tiny (<= 32 rows) and is read through the cache like
// x; the table form (none, t0, xe) is a template parameter.  An edge whose
// lrow is not a row of the block (padding, or outside the range) loads no
// row, so the sentinel key N_pad is never dereferenced; a key outside
// [0, N_pad) on a live edge reads as a zero row, as the TPU kernel's
// windows give it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNodeBlock = 128;             // rows per node block (layout)
constexpr int kThreads = 64;                // threads per CUDA block
constexpr int kCols = 2 * kThreads;         // columns per CUDA block
constexpr int kUnroll = 16;                 // row loads in flight

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2_any(const void* p, long long off,
                                            int is_bf16) {
  return is_bf16 ? load2(static_cast<const __nv_bfloat16*>(p) + off)
                 : load2(static_cast<const float*>(p) + off);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

// relu that keeps NaN (as torch.relu does): NaN < 0 is false
__device__ __forceinline__ float relu1(float x) { return x < 0.f ? 0.f : x; }

enum TableMode { kNoTable = 0, kT0 = 1, kXe = 2 };

// One batch of kUnroll edges' indices: local row (-1 when the edge does not
// count), gather key and type row.  Loaded a batch ahead of its use.
struct EdgeBatch {
  int row[kUnroll];
  int key[kUnroll];
  int type[kUnroll];
};

template <int kTable>
__device__ __forceinline__ void load_batch(EdgeBatch& eb, int base, int end,
                                           const int32_t* __restrict__ lrow,
                                           const int32_t* __restrict__ keys,
                                           const int32_t* __restrict__ xe) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int e = base + u;
    const bool in = e < end;
    const int r = in ? __ldg(lrow + e) : kNodeBlock;
    eb.row[u] = (r >= 0 && r < kNodeBlock) ? r : -1;
    // keys and xe are read beside lrow, not after it: every slot below
    // end is a valid array entry (padding holds the sentinel)
    eb.key[u] = in ? __ldg(keys + e) : -1;
    if (kTable == kXe) eb.type[u] = in ? __ldg(xe + e) : -1;
  }
}

template <int kTable, typename OutT>
__global__ void __launch_bounds__(kThreads)
gathered_scatter_rows_sorted_kernel(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ lrow,
    const int32_t* __restrict__ block_ptr,
    const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ table,
    const int32_t* __restrict__ xe, const void* __restrict__ init,
    const float* __restrict__ scale, const void* __restrict__ gate,
    OutT* __restrict__ out, int e_pad, int n_pad, int d, int t_rows,
    int relu, int init_bf16, int gate_bf16) {
  extern __shared__ float2 acc[];           // [kNodeBlock][kThreads]
  const int tid = threadIdx.x;
  const int col = blockIdx.y * kCols + 2 * tid;
  if (col >= d) return;                     // d is even: both columns or none
  for (int r = 0; r < kNodeBlock; ++r) {
    acc[r * kThreads + tid] = make_float2(0.f, 0.f);
  }
  // a 1-row table without an xe stream is the broadcast t0 shift
  const float2 t0 = kTable == kT0 ? load2(table + col)
                                  : make_float2(0.f, 0.f);

  const long long b = blockIdx.x;
  const int start = block_ptr[b];
  const int end = min(block_ptr[b + 1], e_pad);
  EdgeBatch cur, nxt;
  load_batch<kTable>(nxt, start, end, lrow, keys, xe);
  for (int base = start; base < end; base += kUnroll) {
    cur = nxt;
    // the next batch's indices load while this batch's rows do
    if (base + kUnroll < end)
      load_batch<kTable>(nxt, base + kUnroll, end, lrow, keys, xe);
    float2 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = cur.key[u];
      v[u] = (cur.row[u] >= 0 && k >= 0 && k < n_pad)
                 ? load2(x + static_cast<long long>(k) * d + col)
                 : make_float2(0.f, 0.f);
      if (kTable == kXe) {
        const int t = cur.type[u];
        const float2 tr =
            (cur.row[u] >= 0 && t >= 0 && t < t_rows)
                ? load2(table + static_cast<long long>(t) * d + col)
                : make_float2(0.f, 0.f);
        v[u] = make_float2(v[u].x + tr.x, v[u].y + tr.y);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cur.row[u] >= 0) {
        float2 m = make_float2(v[u].x + t0.x, v[u].y + t0.y);
        if (relu) m = make_float2(relu1(m.x), relu1(m.y));
        m = __bfloat1622float2(__float22bfloat162_rn(m));   // bf16 message
        float2& a = acc[cur.row[u] * kThreads + tid];
        a.x += m.x;
        a.y += m.y;
      }
    }
  }

  for (int r = 0; r < kNodeBlock; ++r) {
    const long long n = b * kNodeBlock + r;
    const long long off = n * d + col;
    float2 o = acc[r * kThreads + tid];
    if (init) {
      const float2 i = load2_any(init, off, init_bf16);
      o.x += i.x;
      o.y += i.y;
    }
    if (scale) {
      const float s = scale[n];
      o.x *= s;
      o.y *= s;
    }
    if (gate) {
      const float2 g = load2_any(gate, off, gate_bf16);
      o.x = g.x > 0.f ? o.x : 0.f;
      o.y = g.y > 0.f ? o.y : 0.f;
    }
    store2(out + off, o);
  }
}

template <int kTable, typename OutT>
cudaError_t launch(const void* keys, const void* lrow, const void* block_ptr,
                   const void* x, const void* table, const void* xe,
                   const void* init, const void* scale, const void* gate,
                   void* out, int num_blocks, int e_pad, int d, int t_rows,
                   int relu, int init_bf16, int gate_bf16,
                   cudaStream_t stream) {
  auto kernel = gathered_scatter_rows_sorted_kernel<kTable, OutT>;
  const int smem = kNodeBlock * kThreads * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_blocks, (d + kCols - 1) / kCols);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(lrow),
      static_cast<const int32_t*>(block_ptr),
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(table),
      static_cast<const int32_t*>(xe), init, static_cast<const float*>(scale),
      gate, static_cast<OutT*>(out), e_pad, num_blocks * kNodeBlock, d,
      t_rows, relu, init_bf16, gate_bf16);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_out(const void* keys, const void* lrow,
                       const void* block_ptr, const void* x,
                       const void* table, const void* xe, const void* init,
                       const void* scale, const void* gate, void* out,
                       int num_blocks, int e_pad, int d, int t_rows, int relu,
                       int init_bf16, int gate_bf16, cudaStream_t stream) {
  if (!table)
    return launch<kNoTable, OutT>(keys, lrow, block_ptr, x, table, xe, init,
                                  scale, gate, out, num_blocks, e_pad, d,
                                  t_rows, relu, init_bf16, gate_bf16, stream);
  if (!xe)
    return launch<kT0, OutT>(keys, lrow, block_ptr, x, table, xe, init,
                             scale, gate, out, num_blocks, e_pad, d, t_rows,
                             relu, init_bf16, gate_bf16, stream);
  return launch<kXe, OutT>(keys, lrow, block_ptr, x, table, xe, init, scale,
                           gate, out, num_blocks, e_pad, d, t_rows, relu,
                           init_bf16, gate_bf16, stream);
}

}  // namespace

// Plain C entry for ctypes.  keys and lrow [e_pad] int32, block_ptr
// [num_blocks + 1] int32, x [N_pad, d] bf16 with N_pad = 128 * num_blocks,
// table [t_rows, d] bf16 or NULL, xe [e_pad] int32 or NULL (NULL with a
// 1-row table: t0 added to every message), init [N_pad, d] (bf16 if
// init_bf16 else f32) or NULL, scale [N_pad] f32 or NULL, gate [N_pad, d]
// (bf16 if gate_bf16 else f32) or NULL, out [N_pad, d] (bf16 if out_bf16
// else f32).  d must be even and all arrays contiguous.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int gathered_scatter_rows_sorted_launch(
    const void* keys, const void* lrow, const void* block_ptr, const void* x,
    const void* table, const void* xe, const void* init, const void* scale,
    const void* gate, void* out, int num_blocks, int e_pad, int d,
    int t_rows, int out_bf16, int relu, int init_bf16, int gate_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_out<__nv_bfloat16>(keys, lrow, block_ptr, x, table, xe,
                                     init, scale, gate, out, num_blocks,
                                     e_pad, d, t_rows, relu, init_bf16,
                                     gate_bf16, s);
  return launch_out<float>(keys, lrow, block_ptr, x, table, xe, init, scale,
                           gate, out, num_blocks, e_pad, d, t_rows, relu,
                           init_bf16, gate_bf16, s);
}
