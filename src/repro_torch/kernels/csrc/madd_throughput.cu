// Peak-FLOP chain out = Σ_{i<8} chain_i, chain_i = (x + i) pushed through
// `iters` steps of y ← y·a + b, for sm_90a.  The paper's SHOC MaxFlops
// pattern (§7.1.2).
//
// Replaces: src/repro/kernels/microbench.py::_madd_kernel (the
// pallas_call at microbench.py:80).
//
// What bounds it on an H100: 8·iters fused multiply-adds (16·iters
// operations) plus 15 adds per element against 8 bytes of traffic — at
// iters = 256 about 512 operations per byte, far above the f32 ridge, so
// it is bound by operations at 67 TFLOP/s (FMA units, no tensor cores).
//
// What the design does about it: every thread owns one element at a time
// (grid-stride) and keeps its 8 chains in registers, so each warp has 8
// independent FFMAs per step to cover the FMA latency and device memory
// is touched once per element.  a, b and iters are runtime arguments and
// the chain is written with fmaf, so the compiler can neither fold nor
// reassociate it (built without fast-math): the SASS issues 8 FFMAs per
// step.  fmaf rounds once where the TPU kernel's x·a + b rounds twice;
// the chains end in the reference's summation order ((x0 + x1) + x2) ….
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 resident blocks per SM

__global__ void __launch_bounds__(kThreads)
madd_kernel(const float* __restrict__ x, float* __restrict__ out,
            unsigned n, int iters, float a, float b) {
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < n;
       e += gridDim.x * kThreads) {
    const float v = x[e];
    float y0 = v + 0.0f, y1 = v + 1.0f, y2 = v + 2.0f, y3 = v + 3.0f;
    float y4 = v + 4.0f, y5 = v + 5.0f, y6 = v + 6.0f, y7 = v + 7.0f;
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
      y0 = fmaf(y0, a, b);
      y1 = fmaf(y1, a, b);
      y2 = fmaf(y2, a, b);
      y3 = fmaf(y3, a, b);
      y4 = fmaf(y4, a, b);
      y5 = fmaf(y5, a, b);
      y6 = fmaf(y6, a, b);
      y7 = fmaf(y7, a, b);
    }
    out[e] = ((((((y0 + y1) + y2) + y3) + y4) + y5) + y6) + y7;
  }
}

}  // namespace

extern "C" int repro_madd_throughput_f32(const void* x, void* out, int n,
                                         int iters, float a, float b,
                                         void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = ((unsigned)n + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  madd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (unsigned)n, iters, a, b);
  return (int)cudaGetLastError();
}
