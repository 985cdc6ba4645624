// DG element-wise differentiation out[m, :, e] = D_m · ut[:, e] for
// sm_90a.  Paper §8.4.
//
// Replaces: src/repro/kernels/dg_diff.py::_dg_kernel (the pallas_call at
// dg_diff.py:41).
//
// What bounds it on an H100: 2·N² operations per element column against
// 4·N bytes read and 4·M·N bytes written; at N = 64, M = 3 that is about
// 20 operations per byte, on the card's f32 ridge (67 TFLOP/s over
// 3.35 TB/s), so operations and bytes bound it about equally.
//
// What the design does about it: one CUDA block per (matrix m, slab of
// block_e elements), the TPU grid's programs.  D_m (N × N, 16 KB at
// N = 64) is staged once in shared memory and stays resident while the
// block sweeps its slab, as it stayed in VMEM across the TPU's element
// sweep.  Each thread owns one element column at a time: it streams the N
// values of ut[:, e] from device memory (coalesced across the warp, the
// element axis stays last as in the reference) and keeps the N outputs in
// registers.  D is read as float4 broadcasts, one 16-byte shared-memory
// load for every four FMAs.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;

template <int N>
__global__ void __launch_bounds__(kThreads)
dg_diff_kernel(const float* __restrict__ d, const float* __restrict__ ut,
               float* __restrict__ out, int k_dim, int be) {
  __shared__ __align__(16) float ds[N * N];
  const int m = blockIdx.y;
  const float* dm = d + (size_t)m * N * N;
  for (int i = threadIdx.x; i < N * N; i += kThreads) ds[i] = dm[i];
  __syncthreads();

  float* om = out + (size_t)m * N * k_dim;
  const int e0 = blockIdx.x * be;
  for (int e = e0 + threadIdx.x; e < e0 + be; e += kThreads) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
#pragma unroll 2
    for (int j = 0; j < N; j += 4) {
      const float u0 = ut[(size_t)(j + 0) * k_dim + e];
      const float u1 = ut[(size_t)(j + 1) * k_dim + e];
      const float u2 = ut[(size_t)(j + 2) * k_dim + e];
      const float u3 = ut[(size_t)(j + 3) * k_dim + e];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float4 dv = *reinterpret_cast<const float4*>(&ds[i * N + j]);
        acc[i] = fmaf(dv.x, u0, acc[i]);
        acc[i] = fmaf(dv.y, u1, acc[i]);
        acc[i] = fmaf(dv.z, u2, acc[i]);
        acc[i] = fmaf(dv.w, u3, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) om[(size_t)i * k_dim + e] = acc[i];
  }
}

template <int N>
int launch(const void* d, const void* ut, void* out, int m, int k, int be,
           void* stream) {
  const dim3 grid(k / be, m);
  dg_diff_kernel<N><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)ut, (float*)out, k, be);
  return (int)cudaGetLastError();
}

}  // namespace

// n must be one of 8, 16, 32, 64 (the wrapper checks)
extern "C" int repro_dg_diff_f32(const void* d, const void* ut, void* out,
                                 int m, int n, int k, int be, void* stream) {
  switch (n) {
    case 8: return launch<8>(d, ut, out, m, k, be, stream);
    case 16: return launch<16>(d, ut, out, m, k, be, stream);
    case 32: return launch<32>(d, ut, out, m, k, be, stream);
    case 64: return launch<64>(d, ut, out, m, k, be, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
