// Tiled matrix product C[M,N] = A[M,K] · B[K,N] for sm_90a.
//
// Replaces: src/repro/kernels/matmul_tiled.py::_matmul_kernel (the
// pallas_call at matmul_tiled.py:54), the paper's running example.
//
// What bounds it on an H100: at the sizes the port times (4096^3 f32) the
// product does 2·M·N·K operations on 3·4096^2 floats, ~1000 operations
// per byte, far above the card's ridge, so it is bound by operations.
// Float32 inputs must hold rtol 2e-4 / atol 2e-5 against the plain
// version in float64 at K = 512, which neither TF32 nor 3xTF32 does, so
// the tensor cores are off limits: the ceiling is the 67 TFLOP/s of
// plain f32 FMA.
//
// What the design does about it.  The CUDA grid is the kernel's own: one
// block of 256 threads per 128 × 128 output tile (1024 blocks at 4096²),
// whatever block_m/n/k are — the reference's blocks set only its grid and
// the cost rule; the result does not depend on them.  Blocks are ordered in
// groups of 8 tile rows, so the A and B panels a wave reads stay in
// L2.  The k axis is staged 32 deep at a time through a 3-stage cp.async
// ring in shared memory, one barrier per stage: stage s + 2 loads while
// stage s is computed (32 deep, not 16, halves the barriers).  A is stored
// k-major (its 4-byte copies transpose it on the way) and B as it lies, so
// each thread reads its 8 rows of A and 8 columns of B for one k as four
// float4 (LDS.128): 4 vector loads per 64 FMAs.  Each 16-deep slice sums
// into its own partial (its first product a multiply, then 15 FMAs) before
// joining the accumulator (the TPU kernel's `acc += dot(block)`, one level
// finer): the rounding error of a K-long f32 sum then grows like 16 + K/16
// terms, not K, which keeps f32 within the plain version's tolerance.  The
// partial and the accumulator are 128 registers a thread, so one block
// runs per SM and the ring, not a second block, hides the loads' latency.
// Ragged M, N and K against the 128 × 128 × 32 tile are zero-filled on
// staging and masked on the store.  bf16 inputs are widened to f32 when
// staged (synchronous loads in the same ring); the sum is always f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 128;   // output tile rows of a CUDA block
constexpr int kTileN = 128;   // output tile columns
constexpr int kSliceK = 16;   // k depth of one partial sum
constexpr int kStageK = 32;   // k depth of one stage of the ring
constexpr int kStages = 3;    // stages in the shared-memory ring
constexpr int kThreads = 256; // 16 × 16 threads, 8 × 8 outputs each
constexpr int kGroupM = 8;    // tile rows per group of the block order
// A k-major, padded by 4 floats: float4 reads stay aligned and a warp's
// transposing stores (32 k of one row) spread over 8 banks, not 1
constexpr int kLdA = kTileM + 4;

struct Stage {
  float a[kStageK][kLdA];     // A[m][k0 + k] at a[k][m]
  float b[kStageK][kTileN];   // B[k0 + k][n] at b[k][n]
};
static_assert(kStageK % kSliceK == 0, "a stage holds whole slices");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 4- and 16-byte asynchronous copies; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* a;
  const void* b;
  void* c;
  int m, n, k;
  int vec_b;    // B rows 16-byte aligned (N % 4 == 0): float4 copies
};

// Stage the kStageK-deep k range at k0 of the block's A rows [r0, r0 + kTileM) and B
// columns [c0, c0 + kTileN) into `st`, zero outside the matrices.
template <typename T>
__device__ __forceinline__ void stage(Stage& st, const Args& g, int r0,
                                      int c0, int k0) {
  const T* a = (const T*)g.a;
  const T* b = (const T*)g.b;
  const int tid = threadIdx.x;
  // A: thread tid copies column k0 + tid % kStageK of rows
  // tid / kStageK + (kThreads / kStageK) j
  const int ka = tid % kStageK;
  const bool ka_ok = k0 + ka < g.k;
#pragma unroll
  for (int j = 0; j < kTileM * kStageK / kThreads; ++j) {
    const int r = tid / kStageK + kThreads / kStageK * j;
    const bool ok = ka_ok && r0 + r < g.m;
    const T* src = ok ? a + (size_t)(r0 + r) * g.k + k0 + ka : a;
    if constexpr (sizeof(T) == 4) {
      cp_async4(&st.a[ka][r], src, ok ? 4 : 0);
    } else {
      st.a[ka][r] = ok ? widen(*src) : 0.f;
    }
  }
  if constexpr (sizeof(T) == 4) {
    if (g.vec_b) {
      // thread tid copies float4 tid % 32 of rows tid / 32 + 8 j
#pragma unroll
      for (int j = 0; j < kStageK * kTileN / 4 / kThreads; ++j) {
        const int kb = tid / 32 + kThreads / 32 * j;
        const int cc = (tid % 32) * 4;
        const bool ok = k0 + kb < g.k && c0 + cc < g.n;
        const T* src = ok ? b + (size_t)(k0 + kb) * g.n + c0 + cc : b;
        cp_async16(&st.b[kb][cc], src, ok ? 16 : 0);
      }
      return;
    }
  }
  // B element by element: column tid % 128 of rows tid / 128 + 2 j
#pragma unroll
  for (int j = 0; j < kStageK * kTileN / kThreads; ++j) {
    const int kb = tid / kTileN + kThreads / kTileN * j;
    const int cc = tid % kTileN;
    const bool ok = k0 + kb < g.k && c0 + cc < g.n;
    const T* src = ok ? b + (size_t)(k0 + kb) * g.n + c0 + cc : b;
    if constexpr (sizeof(T) == 4) {
      cp_async4(&st.b[kb][cc], src, ok ? 4 : 0);
    } else {
      st.b[kb][cc] = ok ? widen(*src) : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
matmul_tiled_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* ring = reinterpret_cast<Stage*>(smem_raw);

  // the block's tile, in groups of kGroupM tile rows (column-major inside
  // a group)
  const int tiles_m = (g.m + kTileM - 1) / kTileM;
  const int tiles_n = (g.n + kTileN - 1) / kTileN;
  const int per_group = kGroupM * tiles_n;
  const int first_m = (int)blockIdx.x / per_group * kGroupM;
  const int rows_in_group = min(tiles_m - first_m, kGroupM);
  const int in_group = (int)blockIdx.x % per_group;
  const int r0 = (first_m + in_group % rows_in_group) * kTileM;
  const int c0 = in_group / rows_in_group * kTileN;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_stages = (g.k + kStageK - 1) / kStageK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) stage<T>(ring[s], g, r0, c0, s * kStageK);
    cp_async_commit();
  }

  // rows ty·4 + i and 64 + ty·4 + i, columns tx·4 + j and 64 + tx·4 + j
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_ring();   // stage s landed, for this thread's copies
    __syncthreads();        // ... for every thread's; stage s - 1 consumed
    const int next = s + kStages - 1;
    if (next < n_stages)
      stage<T>(ring[next % kStages], g, r0, c0, next * kStageK);
    cp_async_commit();

    const Stage& st = ring[s % kStages];
#pragma unroll
    for (int k0 = 0; k0 < kStageK; k0 += kSliceK) {
      float part[8][8];   // one 16-deep slice, its first product a mul
#pragma unroll
      for (int k = k0; k < k0 + kSliceK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&st.a[k][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&st.a[k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&st.b[k][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&st.b[k][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            part[i][j] = k == k0 ? av[i] * bv[j]
                                 : fmaf(av[i], bv[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  T* c = (T*)g.c;
  const bool vec_c = sizeof(T) == 4 && g.vec_b &&
                     (uintptr_t)g.c % 16 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i < 4 ? 0 : 64) + ty * 4 + i % 4;
    if (r >= g.m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = c0 + 64 * h + tx * 4;
      T* out = c + (size_t)r * g.n + cc;
      if (vec_c && cc < g.n) {
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (cc + j < g.n) narrow(out + j, acc[i][4 * h + j]);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           void* stream) {
  if (m == 0 || n == 0) return (int)cudaSuccess;
  const Args g = {a, b, c, m, n, k,
                  n % 4 == 0 && (uintptr_t)b % 16 == 0};
  const int bytes = (int)(kStages * sizeof(Stage));
  cudaError_t err = cudaFuncSetAttribute(
      matmul_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = ((m + kTileM - 1) / kTileM) * ((n + kTileN - 1) / kTileN);
  matmul_tiled_kernel<T><<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// a[M, K] · b[K, N] → c[M, N], all contiguous, row-major
extern "C" int repro_matmul_tiled_f32(const void* a, const void* b, void* c,
                                      int m, int n, int k, void* stream) {
  return launch<float>(a, b, c, m, n, k, stream);
}

extern "C" int repro_matmul_tiled_bf16(const void* a, const void* b, void* c,
                                       int m, int n, int k, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, m, n, k, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
