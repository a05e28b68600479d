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
// by local row, so a row's edges are scattered over the block's range.
//
// Bound on the H100: bytes.  Each message byte is read once and used in one
// add (E_pad*D adds for E_pad*D*2 bytes of bf16 messages), far below the
// ~295 operations per byte at which the tensor cores would bind.  The least
// time is (E_pad*(2D + 4) + N_pad*D*4 [init] + N_pad*D*4 [out]) / 3.35 TB/s.
//
// Design (the contract, not the TPU mechanism): one CUDA block owns one
// 128-row node block x one 128-column slice of D.  Each of its 64 threads
// owns two adjacent columns for all 128 rows: the f32 accumulator is a
// [128][64] float2 tile in shared memory (64 KB), and no other thread ever
// touches a thread's columns, so there are no atomics and no barriers, and
// the sum is deterministic.  The thread walks the block's edge range in
// order, kUnroll edges at a time: it first issues all kUnroll message loads
// (one 4-byte bf16x2 / 8-byte float2 per edge; a warp reads 128/256
// contiguous bytes of the row) and then does the kUnroll shared-memory adds,
// so kUnroll loads per thread are in flight to hide device-memory latency.
// Three blocks fit on an SM (192 KB of shared memory).  The epilogue reads
// init / scale / gate and writes the output once, coalesced.  wgmma, TMA
// and a row-sorted walk are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNodeBlock = 128;             // rows per node block (layout)
constexpr int kThreads = 64;                // threads per CUDA block
constexpr int kCols = 2 * kThreads;         // columns per CUDA block
constexpr int kUnroll = 16;                 // message loads in flight

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

template <typename MsgT, typename OutT>
__global__ void __launch_bounds__(kThreads)
scatter_rows_sorted_kernel(const MsgT* __restrict__ m,
                           const int32_t* __restrict__ lrow,
                           const int32_t* __restrict__ block_ptr,
                           const void* __restrict__ init,
                           const float* __restrict__ scale,
                           const void* __restrict__ gate,
                           OutT* __restrict__ out, int e_pad, int d, int relu,
                           int init_bf16, int gate_bf16) {
  extern __shared__ float2 acc[];           // [kNodeBlock][kThreads]
  const int tid = threadIdx.x;
  const int col = blockIdx.y * kCols + 2 * tid;
  if (col >= d) return;                     // d is even: both columns or none
  for (int r = 0; r < kNodeBlock; ++r) {
    acc[r * kThreads + tid] = make_float2(0.f, 0.f);
  }

  const long long b = blockIdx.x;
  const int start = block_ptr[b];
  const int end = min(block_ptr[b + 1], e_pad);
  for (int base = start; base < end; base += kUnroll) {
    int rows[kUnroll];
    float2 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u;
      rows[u] = e < end ? __ldg(lrow + e) : kNodeBlock;
      v[u] = (rows[u] >= 0 && rows[u] < kNodeBlock)
                 ? load2(m + static_cast<long long>(e) * d + col)
                 : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (rows[u] >= 0 && rows[u] < kNodeBlock) {
        float2 x = v[u];
        if (relu) x = make_float2(relu1(x.x), relu1(x.y));
        float2& a = acc[rows[u] * kThreads + tid];
        a.x += x.x;
        a.y += x.y;
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

template <typename MsgT, typename OutT>
cudaError_t launch(const void* m, const void* lrow, const void* block_ptr,
                   const void* init, const void* scale, const void* gate,
                   void* out, int num_blocks, int e_pad, int d, int relu,
                   int init_bf16, int gate_bf16, cudaStream_t stream) {
  auto kernel = scatter_rows_sorted_kernel<MsgT, OutT>;
  const int smem = kNodeBlock * kThreads * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_blocks, (d + kCols - 1) / kCols);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const MsgT*>(m), static_cast<const int32_t*>(lrow),
      static_cast<const int32_t*>(block_ptr), init,
      static_cast<const float*>(scale), gate, static_cast<OutT*>(out), e_pad,
      d, relu, init_bf16, gate_bf16);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  m [e_pad, d] (bf16 if msg_bf16 else f32),
// lrow [e_pad] int32, block_ptr [num_blocks + 1] int32, init [N_pad, d]
// (bf16 if init_bf16 else f32) or NULL, scale [N_pad] f32 or NULL, gate
// [N_pad, d] (bf16 if gate_bf16 else f32) or NULL, out [N_pad, d] (bf16 if
// out_bf16 else f32) with N_pad = 128 * num_blocks.  d must be even and all
// arrays contiguous.  Returns the cudaError_t of the launch (0 = success).
extern "C" int scatter_rows_sorted_launch(
    const void* m, const void* lrow, const void* block_ptr, const void* init,
    const void* scale, const void* gate, void* out, int num_blocks, int e_pad,
    int d, int msg_bf16, int out_bf16, int relu, int init_bf16, int gate_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (msg_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        m, lrow, block_ptr, init, scale, gate, out, num_blocks, e_pad, d,
        relu, init_bf16, gate_bf16, s);
  if (msg_bf16)
    return launch<__nv_bfloat16, float>(m, lrow, block_ptr, init, scale, gate,
                                        out, num_blocks, e_pad, d, relu,
                                        init_bf16, gate_bf16, s);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(m, lrow, block_ptr, init, scale, gate,
                                        out, num_blocks, e_pad, d, relu,
                                        init_bf16, gate_bf16, s);
  return launch<float, float>(m, lrow, block_ptr, init, scale, gate, out,
                              num_blocks, e_pad, d, relu, init_bf16, gate_bf16,
                              s);
}
