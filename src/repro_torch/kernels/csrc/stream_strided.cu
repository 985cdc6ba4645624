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
// What the design does about it: one pass, one CUDA block per
// kThreads · kPerThread outputs (float4, or floats on the one-float
// path), sized from the work.  Each thread owns kPerThread outputs
// kThreads apart, so every warp access is 32 neighbouring float4 (512
// contiguous bytes) of an input or of out, and the input rows that are
// skipped are never touched.  A thread issues all of its loads (every
// output of every input, through __restrict__ locals, with the streaming
// hint ld.global.cs) before its first add, then adds in input order and
// stores with st.global.cs: nothing is read twice, so nothing should stay
// in L2.  The output block of an index comes from a multiply by the
// host's magic number and a shift (exact for indices below 2^31, the
// wrapper's bound), not from a division.  The inputs' pointers travel by
// value (kArraysPerLaunch of them) and the kernel is instantiated for each
// count, so no load waits on a test of the count.  More inputs take more
// launches, each after the first seeding its sum with `out` and adding
// the next group, which keeps the reference's f32 order (array 0, then 1,
// 2, ...).
// When block is not a multiple of 4 (or a pointer is not 16-byte
// aligned) the same kernel runs one float per output.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kArraysPerLaunch = 8;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;   // outputs a thread owns, kThreads apart
constexpr unsigned kPerBlock = kThreads * kPerThread;

struct Inputs {
  const float* p[kArraysPerLaunch];
};

// Output index o (in units of T) reads input index
// o + (o / block)·block·(stride − 1); o / block = (o · magic) >> shift.
struct Index {
  unsigned magic;
  unsigned shift;
  unsigned skip;    // block·(stride − 1)
};

__device__ __forceinline__ unsigned source(unsigned o, const Index& x) {
  const unsigned i =
      (unsigned)(((unsigned long long)o * x.magic) >> x.shift);
  return o + i * x.skip;
}

__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }

// kArrays inputs; with `accumulate` the sum starts from out (the earlier
// groups' sum) instead of input 0.  Indices are 32-bit: the wrapper
// admits arrays of fewer than 2^31 elements.
template <int kArrays, typename T>
__global__ void __launch_bounds__(kThreads)
stream_kernel(Inputs in, int accumulate, T* __restrict__ out,
              unsigned n_out, Index x) {
  const unsigned o0 = blockIdx.x * kPerBlock + threadIdx.x;
  unsigned src[kPerThread];
  bool ok[kPerThread];
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    const unsigned o = o0 + v * kThreads;
    ok[v] = o < n_out;
    src[v] = source(o, x);
  }
  T got[kArrays][kPerThread];
#pragma unroll
  for (int j = 0; j < kArrays; ++j) {
    const T* __restrict__ p = reinterpret_cast<const T*>(in.p[j]);
#pragma unroll
    for (int v = 0; v < kPerThread; ++v)
      if (ok[v]) got[j][v] = __ldcs(p + src[v]);
  }
  T acc[kPerThread];
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    if (!ok[v]) continue;
    if (accumulate) {
      acc[v] = __ldcs(out + o0 + v * kThreads);
      add(acc[v], got[0][v]);
    } else {
      acc[v] = got[0][v];
    }
#pragma unroll
    for (int j = 1; j < kArrays; ++j) add(acc[v], got[j][v]);
    __stcs(out + o0 + v * kThreads, acc[v]);
  }
}

// Launch the instantiation for n inputs (kArrays counts up to n).
template <typename T, int kArrays = 1>
cudaError_t launch(const Inputs& in, int n, int accumulate, T* out,
                   unsigned n_out, const Index& x, cudaStream_t s) {
  if (n != kArrays) {
    if constexpr (kArrays < kArraysPerLaunch) {
      return launch<T, kArrays + 1>(in, n, accumulate, out, n_out, x, s);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  const unsigned grid = (n_out + kPerBlock - 1) / kPerBlock;
  stream_kernel<kArrays, T><<<grid, kThreads, 0, s>>>(in, accumulate, out,
                                                      n_out, x);
  return cudaGetLastError();
}

}  // namespace

// ptrs: host array of n_arrays device pointers (copied, a group of
// kArraysPerLaunch at a time, into the launches' parameters); vec4: 1
// when block % 4 == 0 and every pointer is 16-byte aligned; magic, shift:
// the wrapper's multiplier for dividing an output index by block (by
// block / 4 when vec4).  Launches ceil(n_arrays / kArraysPerLaunch)
// kernels in order on the stream.  Returns the first nonzero
// cudaGetLastError(), or cudaErrorInvalidValue for n_arrays < 1.
extern "C" int repro_stream_strided_f32(const void* const* ptrs,
                                        int n_arrays, void* out, int n_out,
                                        int block, int stride, int vec4,
                                        unsigned magic, int shift,
                                        void* stream) {
  if (n_arrays < 1) return (int)cudaErrorInvalidValue;
  const unsigned total = (unsigned)n_out * (unsigned)block;
  if (total == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned width = vec4 ? (unsigned)block / 4 : (unsigned)block;
  const Index x = {magic, (unsigned)shift, width * (unsigned)(stride - 1)};
  for (int first = 0; first < n_arrays; first += kArraysPerLaunch) {
    const int n = n_arrays - first < kArraysPerLaunch ? n_arrays - first
                                                      : kArraysPerLaunch;
    Inputs in = {};
    for (int j = 0; j < n; ++j) in.p[j] = (const float*)ptrs[first + j];
    const int accumulate = first > 0;
    const cudaError_t err =
        vec4 ? launch(in, n, accumulate, (float4*)out, total / 4, x, s)
             : launch(in, n, accumulate, (float*)out, total, x, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
