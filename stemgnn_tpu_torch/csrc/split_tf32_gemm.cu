// split_tf32_gemm for NVIDIA Hopper (sm_90a): f32 matrix products on the
// tensor cores at f32 accuracy, for the three products of nn.layers.Linear
// (the forward x @ w, dX = dY @ w^T and dW = x^T @ dY).
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA's
// f32 dot.  The port left them to torch.matmul, which with TF32 off runs
// cuBLAS's f32 kernels on the CUDA cores (67 TFLOP/s peak; ~47 TFLOP/s on
// the main path's shapes), while the tensor cores sat idle.  Plain TF32 is
// a lower precision than the configurations state, so this kernel splits
// each f32 operand into two TF32 parts,
//
//   hi = tf32(a), lo = tf32(a - hi),   a.b ~ hi.hi + hi.lo + lo.hi,
//
// and sums the three TF32 products in f32 (the dropped lo.lo is below f32's
// rounding).  Bound: operations.  Three TF32 products per f32 product give
// a ceiling of 495 / 3 = 165 TFLOP/s of f32 work on the H100; every
// main-path shape is far above the card's ridge point, so bytes do not
// bind.  Measured: 66-77 TFLOP/s of f32 work at the main path's shapes,
// 40-47% of that ceiling and 1.25-1.55x cuBLAS's f32 product; the two
// warpgroups wait for each slice's products before adding them (below).
//
// Accuracy: the tensor cores sum into their accumulator with truncation, so
// a product summed there over a whole reduction drifts: kept in the
// accumulator over all of K, the split read 10-30x cuBLAS's f32 error
// against f64 (normalised by |A| |B|; 2.6e-6 against 9e-9 over 9,000 rows).
// Each 32-deep slice of K is therefore summed on the tensor cores from zero
// and added to an f32 register sum by the CUDA cores (round to nearest):
// max / mean error 1.3e-7 / 1.1e-8 against cuBLAS's 4.1e-7 / 2.0e-8 at
// [169344, 768] x [768, 768] (chip_smoke.py phase gemm; PERF.md §6).
//
// Design: wgmma.m64n128k8 TF32 on 128 x 128 x 32 block tiles, two
// warpgroups of 64 rows.  Raw f32 tiles arrive by cp.async (16-byte copies)
// in a 3-deep ring of padded shared-memory tiles, which take either major
// order: K-major A (x, dY) with K-major B (w^T) or N-major B (w, dY), and
// M-major A (x^T) for dW.  A is split in registers as each warp reads its
// fragment (wgmma takes A from registers).  wgmma reads B from shared
// memory, K-major only, so the block splits each B tile once into hi and lo
// tiles in the canonical no-swizzle K-major layout (8-row x 16-byte core
// matrices), transposing an N-major tile on the way; the hi / lo tiles are
// double-buffered, so the next tile's split overlaps this tile's products.
// No split copy of an operand is ever written to device memory.  dW reduces
// over all of a graph's rows into as few as 768 x 768 outputs: the wrapper
// cuts it along K into splits whose f32 partials a second kernel sums in
// split order, so repeated runs give the same bits (no atomics).
//
// Bias is added in the epilogue (after the product's sum, as x @ w + b
// rounds it).  The wrapper (ops/split_gemm.py) decides which products take
// this kernel; its module note holds the shape rule and the times that set
// it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int STAGES = 3;                // raw tiles in flight
constexpr int THREADS = 256;             // two warpgroups of 64 rows
constexpr int SLAB = BN * 8;             // floats of one k8 slab of split B
constexpr int HL = 2 * (BK / 8) * SLAB;  // floats of one hi + lo buffer

// One raw operand tile of 128 outer rows (M for A, N for B) by BK: K-major
// [128][BK + 4] or outer-major [BK][128 + 8].  The padding puts the 32
// values a fragment read takes on 32 different banks, and keeps every row
// start 16-byte aligned for cp.async.
template <bool KMAJ>
struct Tile {
  static constexpr int LD = KMAJ ? BK + 4 : BM + 8;
  static constexpr int FLOATS = KMAJ ? BM * (BK + 4) : BK * (BM + 8);
  __device__ static __forceinline__ int at(int o, int k) {
    return KMAJ ? o * LD + k : k * LD + o;
  }
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// D (+)= A B for a warpgroup's 64 x 128 tile and one k8 slab: A from
// registers (each warp a 16 x 8 fragment, mma.m16n8k8's layout), B from
// shared memory by descriptor; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// keeps the compiler from moving reads and writes of an accumulator
// register across the wgmma fences and waits
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Copy one 128 x BK tile of an operand whose element (o, k) is at
// g[o * ld + k] (K-major) or g[k * ld + o]; rows past O and columns past
// kend are filled with zeros (O and kend are multiples of 4).
template <bool KMAJ>
__device__ __forceinline__ void load_tile(float* s, const float* g, int ld,
                                          int o0, int O, int k0, int kend,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int o = KMAJ ? c / (BK / 4) : (c % (BM / 4)) * 4;
    const int k = KMAJ ? (c % (BK / 4)) * 4 : c / (BM / 4);
    const int go = o0 + o, gk = k0 + k;
    const bool ok = go < O && gk < kend;
    const float* src = ok ? (KMAJ ? g + (size_t)go * ld + gk
                                  : g + (size_t)gk * ld + go)
                          : g;
    const uint32_t dst = static_cast<uint32_t>(
        __cvta_generic_to_shared(s + Tile<KMAJ>::at(o, k)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// offset (floats) of B's (n, k) in a split buffer: slab k / 8, core matrix
// (n / 8, (k % 8) / 4) of 8 rows x 16 bytes, row n % 8, column k % 4
__device__ __forceinline__ int core_at(int n, int k) {
  return (k >> 3) * SLAB + ((n >> 3) * 2 + ((k & 7) >> 2)) * 32 +
         (n & 7) * 4 + (k & 3);
}

// wgmma descriptor of one k8 slab: no swizzle, K-adjacent core matrices 128
// bytes apart (leading byte offset), 8-row groups 256 bytes apart (stride
// byte offset), both in 16-byte units
__device__ __forceinline__ uint64_t slab_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// Split one raw B tile into the hi and lo buffers `hl` (hi first)
template <bool B_KMAJ>
__device__ __forceinline__ void split_b(float* hl, const float* b_s,
                                        int tid) {
  using TB = Tile<B_KMAJ>;
#pragma unroll
  for (int i = 0; i < BN * BK / 4 / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int n = c % BN, k = (c / BN) * 4;
    float v[4];
    if constexpr (B_KMAJ) {
      const float4 q = *reinterpret_cast<const float4*>(b_s + TB::at(n, k));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = b_s[TB::at(n, k + r)];
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) split(v[r], h[r], l[r]);
    *reinterpret_cast<uint4*>(hl + core_at(n, k)) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(hl + HL / 2 + core_at(n, k)) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// C[M, N] (+ bias) = A[M, K] B[K, N] over the K range of split blockIdx.z;
// a split's output goes to C + z * M * ldc (the partials of a split-K call).
template <bool A_KMAJ, bool B_KMAJ>
__global__ void __launch_bounds__(THREADS, 1)
split_tf32_gemm_kernel(const float* __restrict__ A,
                       const float* __restrict__ B, float* __restrict__ C,
                       const float* __restrict__ bias, int M, int N, int K,
                       int lda, int ldb, int ldc, int kps) {
  using TA = Tile<A_KMAJ>;
  using TB = Tile<B_KMAJ>;
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* sB = sA + STAGES * TA::FLOATS;
  float* sHL = sB + STAGES * TB::FLOATS;   // two hi + lo buffers

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;              // the warp's 16 rows
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * kps;
  const int kend = min(K, kbeg + kps);
  const int nk = (kend - kbeg + BK - 1) / BK;

  float acc[64], step[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0.f;

#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < nk) {
      load_tile<A_KMAJ>(sA + s * TA::FLOATS, A, lda, m0, M, kbeg + s * BK,
                        kend, tid);
      load_tile<B_KMAJ>(sB + s * TB::FLOATS, B, ldb, n0, N, kbeg + s * BK,
                        kend, tid);
    }
    commit();
  }
  wait_groups<1>();
  __syncthreads();
  split_b<B_KMAJ>(sHL, sB, tid);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    // tile kt: raw A in slot kt % 3, split B in buffer kt & 1
    if (kt + 2 < nk) {
      const int s = (kt + 2) % STAGES;
      load_tile<A_KMAJ>(sA + s * TA::FLOATS, A, lda, m0, M,
                        kbeg + (kt + 2) * BK, kend, tid);
      load_tile<B_KMAJ>(sB + s * TB::FLOATS, B, ldb, n0, N,
                        kbeg + (kt + 2) * BK, kend, tid);
    }
    commit();
    const float* a_s = sA + (kt % STAGES) * TA::FLOATS;
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int q = 0; q < BK / 8; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split(a_s[TA::at(wrow + g + (r & 1) * 8, q * 8 + t + (r >> 1) * 4)],
              ah[q][r], al[q][r]);
    const float* hl = sHL + (kt & 1) * HL;
#pragma unroll
    for (int r = 0; r < 64; ++r) fence_operand(step[r]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int q = 0; q < BK / 8; ++q) {
      const uint64_t dh = slab_desc(hl + q * SLAB);
      const uint64_t dl = slab_desc(hl + HL / 2 + q * SLAB);
      wgmma_tf32(step, al[q], dh, q);
      wgmma_tf32(step, ah[q], dl, 1);
      wgmma_tf32(step, ah[q], dh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < 64; ++r) fence_operand(step[r]);
    // beside the products: split the next tile's B
    if (kt + 1 < nk) {
      wait_groups<1>();
      __syncthreads();
      split_b<B_KMAJ>(sHL + ((kt + 1) & 1) * HL,
                      sB + ((kt + 1) % STAGES) * TB::FLOATS, tid);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      fence_operand(step[r]);
      acc[r] += step[r];
    }
    __syncthreads();
  }
  wait_groups<0>();

  float* out = C + (size_t)blockIdx.z * M * ldc;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    if (col >= N) continue;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = bias[col];
      b1 = bias[col + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wrow + g + h * 8;
      if (row >= M) continue;
      *reinterpret_cast<float2*>(out + (size_t)row * ldc + col) =
          make_float2(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
    }
  }
}

// out = sum over the splits of part[z] (in split order) (+ bias), by float4;
// named as part of the GEMM, which its time is (the benchmark's dense_ms
// counts kernels by name)
__global__ void split_tf32_gemm_sum_kernel(const float4* __restrict__ part,
                                   float4* __restrict__ out,
                                   const float* __restrict__ bias,
                                   long long n4, int splits, int N) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int z = 1; z < splits; ++z) {
      const float4 p = part[z * n4 + i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    if (bias != nullptr) {
      const int col = static_cast<int>((i * 4) % N);
      s.x += bias[col];
      s.y += bias[col + 1];
      s.z += bias[col + 2];
      s.w += bias[col + 3];
    }
    out[i] = s;
  }
}

template <bool A_KMAJ, bool B_KMAJ>
int launch(const float* A, const float* B, float* C, const float* bias,
           int M, int N, int K, int lda, int ldb, int ldc, int splits,
           int kps, cudaStream_t stream) {
  auto kern = split_tf32_gemm_kernel<A_KMAJ, B_KMAJ>;
  const int bytes = (STAGES * (Tile<A_KMAJ>::FLOATS + Tile<B_KMAJ>::FLOATS) +
                     2 * HL) * static_cast<int>(sizeof(float));
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, THREADS, bytes, stream>>>(A, B, C, bias, M, N, K, lda, ldb,
                                         ldc, kps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C[M, N] = A[M, K] B[K, N] (+ bias[N]).  A's element (m, k) is at
// A[m * lda + k] (a_kmajor) or A[k * lda + m]; B's (k, n) at B[n * ldb + k]
// (b_kmajor) or B[k * ldb + n]; K-major A with either B (the forward and
// dX) or M-major A with N-major B (dW).  With splits > 1 the K range is cut
// into splits of kps (a multiple of 32) whose partials go to `partial`
// ([splits, M, N] f32) and are summed into C (ldc == N) by a second kernel.
// M, N, K, lda, ldb and ldc are multiples of 4 and every pointer is 16-byte
// aligned (the wrapper checks).  Returns the CUDA error of the launches.
extern "C" int split_tf32_gemm_launch(
    const void* A, const void* B, void* C, const void* bias, void* partial,
    int M, int N, int K, int lda, int ldb, int ldc, int a_kmajor,
    int b_kmajor, int splits, int kps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  const float* bi = static_cast<const float*>(bias);
  float* out = splits > 1 ? static_cast<float*>(partial)
                          : static_cast<float*>(C);
  const float* gemm_bias = splits > 1 ? nullptr : bi;
  const int ld_out = splits > 1 ? N : ldc;
  int err;
  if (a_kmajor && !b_kmajor)        // the forward: x @ w
    err = launch<true, false>(a, b, out, gemm_bias, M, N, K, lda, ldb,
                              ld_out, splits, kps, s);
  else if (a_kmajor && b_kmajor)    // dX = dY @ w^T
    err = launch<true, true>(a, b, out, gemm_bias, M, N, K, lda, ldb,
                             ld_out, splits, kps, s);
  else if (!b_kmajor)               // dW = x^T @ dY
    err = launch<false, false>(a, b, out, gemm_bias, M, N, K, lda, ldb,
                               ld_out, splits, kps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0 || splits == 1) return err;
  const long long n4 = (long long)M * N / 4;
  const int blocks = static_cast<int>(
      n4 / 256 + 1 < 132 * 8 ? n4 / 256 + 1 : 132 * 8);
  split_tf32_gemm_sum_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float4*>(partial), static_cast<float4*>(C), bi, n4,
      splits, N);
  return static_cast<int>(cudaGetLastError());
}
