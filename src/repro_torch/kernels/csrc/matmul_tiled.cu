// Tiled matrix product C[M,N] = A[M,K] · B[K,N] for sm_90a.
//
// Replaces: src/repro/kernels/matmul_tiled.py::_matmul_kernel (the
// pallas_call at matmul_tiled.py:54), the paper's running example.
//
// What bounds it on an H100: at the sizes the port times (4096^3 f32) the
// product does 2·M·N·K operations on 3·4096^2 floats, ~1000 operations
// per byte, far above the card's ridge, so it is bound by operations.
// Float32 inputs must hold rtol 2e-4 against the plain version, so the
// tensor cores (TF32 at best) are off limits: the ceiling is the 67
// TFLOP/s of plain f32 FMA.
//
// What the design does about it: each CUDA block owns the block_m ×
// block_n output tile that one TPU grid column owned, and walks the k
// axis panel by panel (block_k), as the TPU's sequential grid axis did.
// A 256-wide A and B panel pair would not fit in 227 KB of shared memory,
// so the block loops over 128 × 128 output sub-tiles and 16-deep k slices:
// each slice of A and B is staged once in shared memory and feeds 8 × 8
// register accumulators per thread (64 FMAs for 16 shared-memory reads).
// Each 16-deep slice sums into its own partial before joining the
// accumulator (the TPU kernel's `acc += dot(block)`, one level finer):
// the rounding error of a K-long f32 sum then grows like 16 + K/16 terms,
// not K, which keeps f32 within the plain version's tolerance.  bf16
// inputs are widened to f32 when staged; the sum is always f32.
// No double buffering, TMA or wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTileM = 128;   // output sub-tile rows
constexpr int kTileN = 128;   // output sub-tile columns
constexpr int kSliceK = 16;   // k depth staged per shared-memory slice
constexpr int kThreads = 256; // 16 × 16 threads, 8 × 8 outputs each

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_tiled_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ c, int n_cols, int k_dim, int bm,
                    int bn, int bk) {
  // +1 column of padding: the transposed A stores are conflict-free
  __shared__ float as[kSliceK][kTileM + 1];
  __shared__ float bs[kSliceK][kTileN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row_block = blockIdx.y * bm;
  const int col_block = blockIdx.x * bn;

  for (int sm = 0; sm < bm; sm += kTileM) {
    for (int sn = 0; sn < bn; sn += kTileN) {
      const int rows = min(kTileM, bm - sm);
      const int cols = min(kTileN, bn - sn);
      const int r0 = row_block + sm;
      const int c0 = col_block + sn;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

      for (int kp = 0; kp < k_dim; kp += bk) {      // k panels
        for (int ks = 0; ks < bk; ks += kSliceK) {  // slices of a panel
          const int depth = min(kSliceK, bk - ks);
          const int k0 = kp + ks;
          for (int i = tid; i < kTileM * kSliceK; i += kThreads) {
            const int r = i / kSliceK;
            const int k = i % kSliceK;
            float v = 0.f;
            if (r < rows && k < depth)
              v = widen(a[(size_t)(r0 + r) * k_dim + k0 + k]);
            as[k][r] = v;
          }
          for (int i = tid; i < kSliceK * kTileN; i += kThreads) {
            const int k = i / kTileN;
            const int cc = i % kTileN;
            float v = 0.f;
            if (k < depth && cc < cols)
              v = widen(b[(size_t)(k0 + k) * n_cols + c0 + cc]);
            bs[k][cc] = v;
          }
          __syncthreads();
          float part[8][8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll
          for (int k = 0; k < kSliceK; ++k) {
            float av[8], bv[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) av[i] = as[k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 8; ++j) bv[j] = bs[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                part[i][j] = fmaf(av[i], bv[j], part[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
          __syncthreads();
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cc = tx + 16 * j;
          if (r < rows && cc < cols)
            narrow(&c[(size_t)(r0 + r) * n_cols + c0 + cc], acc[i][j]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           int bm, int bn, int bk, void* stream) {
  const dim3 grid(n / bn, m / bm);
  matmul_tiled_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (T*)c, n, k, bm, bn, bk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_matmul_tiled_f32(const void* a, const void* b, void* c,
                                      int m, int n, int k, int bm, int bn,
                                      int bk, void* stream) {
  return launch<float>(a, b, c, m, n, k, bm, bn, bk, stream);
}

extern "C" int repro_matmul_tiled_bf16(const void* a, const void* b, void* c,
                                       int m, int n, int k, int bm, int bn,
                                       int bk, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, m, n, k, bm, bn, bk, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
