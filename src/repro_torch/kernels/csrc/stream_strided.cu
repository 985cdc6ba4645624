// Block-stride memory stream out[i·block + t] = Σ_j arrays[j][(i·stride)·block
// + t], summed in float32 in input order, for sm_90a.  The paper's
// parameterized global-memory access-pattern microbenchmark (§7.1).
//
// Replaces: src/repro/kernels/microbench.py::_stream_kernel (the
// pallas_call at microbench.py:44).
//
// What bounds it on an H100: n_arrays − 1 adds per output against
// 4·(n_arrays + 1) bytes of compulsory traffic — bound by bytes at
// 3.35 TB/s.  With stride > 1 only every stride-th input block is read,
// so the bytes (and the bound) shrink by the stride.
//
// What the design does about it: the TPU grid walked one block per step;
// here every thread owns four consecutive outputs at a time (one float4)
// and the grid strides over all n_out·block outputs, so each warp reads
// and writes 512 contiguous bytes per input and the input rows that are
// skipped are never touched.  The inputs' pointers travel by value in a
// small struct (kArraysPerLaunch of them), so a launch needs no
// device-side pointer table; more inputs take more launches, each after
// the first seeding its sum with `out` and adding the next group, which
// keeps the reference's f32 order (array 0, then 1, 2, ... in turn).
// When block is not a multiple of 4 (or a pointer is not 16-byte
// aligned) the same loop runs one float per thread.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kArraysPerLaunch = 8;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 resident blocks per SM

struct Inputs {
  const float* p[kArraysPerLaunch];
};

// Indices are 32-bit: the wrapper admits arrays of fewer than 2^31
// elements, so every output and source index fits.  The loop over inputs
// is unrolled to kArraysPerLaunch with a guard, so each pointer is read
// from the launch parameters at a constant offset.  With `accumulate` the
// sum starts from out (the earlier groups' sum) instead of input 0.
__global__ void __launch_bounds__(kThreads)
stream_vec4_kernel(Inputs in, int n_arrays, int accumulate,
                   float4* __restrict__ out, unsigned n_out4,
                   unsigned block4, unsigned stride) {
  for (unsigned o = blockIdx.x * kThreads + threadIdx.x; o < n_out4;
       o += gridDim.x * kThreads) {
    const unsigned i = o / block4;
    const unsigned src = i * stride * block4 + (o - i * block4);
    float4 acc = accumulate ? out[o]
                            : reinterpret_cast<const float4*>(in.p[0])[src];
#pragma unroll
    for (int j = 0; j < kArraysPerLaunch; ++j) {
      if ((accumulate || j > 0) && j < n_arrays) {
        const float4 v = reinterpret_cast<const float4*>(in.p[j])[src];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    out[o] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
stream_scalar_kernel(Inputs in, int n_arrays, int accumulate,
                     float* __restrict__ out, unsigned n_out,
                     unsigned block, unsigned stride) {
  for (unsigned o = blockIdx.x * kThreads + threadIdx.x; o < n_out;
       o += gridDim.x * kThreads) {
    const unsigned i = o / block;
    const unsigned src = i * stride * block + (o - i * block);
    float acc = accumulate ? out[o] : in.p[0][src];
#pragma unroll
    for (int j = 0; j < kArraysPerLaunch; ++j) {
      if ((accumulate || j > 0) && j < n_arrays) acc += in.p[j][src];
    }
    out[o] = acc;
  }
}

int grid_for(unsigned work) {
  const unsigned blocks = (work + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// ptrs: host array of n_arrays device pointers (copied, a group of
// kArraysPerLaunch at a time, into the launches' parameters); vec4: 1
// when block % 4 == 0 and every pointer is 16-byte aligned.  Launches
// ceil(n_arrays / kArraysPerLaunch) kernels in order on the stream.
// Returns the first nonzero cudaGetLastError(), or cudaErrorInvalidValue
// for n_arrays < 1.
extern "C" int repro_stream_strided_f32(const void* const* ptrs,
                                        int n_arrays, void* out, int n_out,
                                        int block, int stride, int vec4,
                                        void* stream) {
  if (n_arrays < 1) return (int)cudaErrorInvalidValue;
  const unsigned total = (unsigned)n_out * (unsigned)block;
  if (total == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  for (int first = 0; first < n_arrays; first += kArraysPerLaunch) {
    const int n = n_arrays - first < kArraysPerLaunch ? n_arrays - first
                                                      : kArraysPerLaunch;
    Inputs in = {};
    for (int j = 0; j < n; ++j) in.p[j] = (const float*)ptrs[first + j];
    const int accumulate = first > 0;
    if (vec4) {
      const unsigned total4 = total / 4;
      stream_vec4_kernel<<<grid_for(total4), kThreads, 0, s>>>(
          in, n, accumulate, (float4*)out, total4, block / 4, stride);
    } else {
      stream_scalar_kernel<<<grid_for(total), kThreads, 0, s>>>(
          in, n, accumulate, (float*)out, total, block, stride);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
