// Five-point Laplacian out = N + S + W + E − 4·C on the zero-padded
// input, for sm_90a.  Paper §8.5.
//
// Replaces: src/repro/kernels/stencil5.py::_stencil_kernel (the
// pallas_call at stencil5.py:43) together with the wrapper's separate
// jnp.pad pass (stencil5.py:40).
//
// What bounds it on an H100: 5 operations per output against 8 bytes of
// compulsory traffic (one read and one write per element) — bound by
// bytes at 3.35 TB/s.
//
// What the design does about it: one CUDA block per block_m × block_n
// output tile, as one TPU grid program.  The block stages its halo window
// in shared memory strip by strip (32 output rows plus the two halo rows,
// block_n + 2 columns), filling cells outside the array with zero, so the
// padded copy the TPU version wrote first is never materialised.  Each
// input element is read from device memory once per tile that covers it;
// the halo rows between strips and tiles come back from L2.  Threads are
// laid out 32 wide along rows so every warp reads and writes contiguous
// 128-byte runs.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kStripRows = 32;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
stencil5_kernel(const float* __restrict__ u, float* __restrict__ out,
                int m, int n, int bm, int bn) {
  extern __shared__ float win[];  // (kStripRows + 2) × (bn + 2)
  const int width = bn + 2;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int i0 = blockIdx.y * bm;
  const int j0 = blockIdx.x * bn;

  for (int s = 0; s < bm; s += kStripRows) {
    const int rows = min(kStripRows, bm - s);
    const int gi0 = i0 + s - 1;  // window origin in u
    const int gj0 = j0 - 1;
    for (int r = ty; r < rows + 2; r += kThreadsY) {
      const int gi = gi0 + r;
      const bool row_in = gi >= 0 && gi < m;
      for (int c = tx; c < width; c += kThreadsX) {
        const int gj = gj0 + c;
        win[r * width + c] = (row_in && gj >= 0 && gj < n)
                                 ? u[(size_t)gi * n + gj]
                                 : 0.f;
      }
    }
    __syncthreads();
    for (int r = ty; r < rows; r += kThreadsY) {
      const float* w = win + (r + 1) * width + 1;
      float* o = out + (size_t)(i0 + s + r) * n + j0;
      for (int c = tx; c < bn; c += kThreadsX) {
        const float v = ((w[c - width] + w[c + width]) + w[c - 1]) + w[c + 1];
        o[c] = v - 4.0f * w[c];
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int repro_stencil5_f32(const void* u, void* out, int m, int n,
                                  int bm, int bn, void* stream) {
  const size_t smem = (size_t)(kStripRows + 2) * (bn + 2) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n / bn, m / bm);
  const dim3 block(kThreadsX, kThreadsY);
  stencil5_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)u, (float*)out, m, n, bm, bn);
  return (int)cudaGetLastError();
}
