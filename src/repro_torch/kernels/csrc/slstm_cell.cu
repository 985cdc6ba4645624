// sLSTM recurrent cell for sm_90a: the whole time loop of one (batch row,
// head) in one CUDA block, stabilized exponential gating.
//
// Replaces: src/repro/kernels/slstm_cell.py::_slstm_kernel (the
// pallas_call at slstm_cell.py:77).
//
// What bounds it on an H100: per step and head dh·4dh multiply-adds of the
// block-diagonal recurrence h·r[h] plus ~40 gating operations per hidden
// unit, against one read of g_in and one write of h per step: by the
// roofline, operations at the 67 TFLOP/s of f32 FMA (xlstm-125m, dh = 192,
// H = 4, batch 8: 0.58 ms for 4096 steps).  But the S steps are a chain:
// each needs the last step's h, so the latency of one step (a dot of
// length dh, two barriers, the gating) times S is a floor the roofline
// does not show, and only B·H blocks can run at once.
//
// What the design does about it: the TPU ran one program per batch row
// with all of r pinned in VMEM.  The recurrence is block-diagonal per head
// (einsum "bhd,hdge->bghe"), so (batch row, head) pairs are independent:
// one CUDA block each, 4·dh threads, each owning one gate column e.  A
// step reads h (dh floats) from shared memory and column e of r[h] from
// device memory — r[h] is 590 KB in f32 at dh = 192, over the 227 KB of
// shared memory a block may have, so it is not pinned on chip but read
// from the 50 MB L2 every step (2.36 MB for all heads, L2-resident).  A
// barrier, then the first dh threads gate their hidden unit: log_sigmoid
// in the stable form min(x, 0) − log1p(exp(−|x|)), m = max(lf + m, li),
// exp, tanh, sigmoid, n floored at 1e-6, m starting at 0, as the
// reference's step does; they write h to shared memory and to y[b, t].
// Pinning r on chip (a cluster of 4 blocks sharing distributed shared
// memory, or the weights in registers across a cluster) is later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxDh = 256;   // 4·dh threads <= 1024

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(4 * kMaxDh)
slstm_kernel(const float* __restrict__ g_in, const float* __restrict__ r,
             const float* __restrict__ bias, float* __restrict__ y,
             int steps, int heads, int dh) {
  __shared__ float hs[kMaxDh];
  __shared__ float gs[4 * kMaxDh];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int e = threadIdx.x;         // gate column: gate e / dh, unit e % dh
  const int cols = 4 * dh;
  const bool owns_col = e < cols;
  const int gate = e / dh;
  const int unit = e - gate * dh;
  // r[h] is [dh, 4·dh]: column e strided by 4·dh
  const float* rcol = r + (size_t)h * dh * cols + e;
  const float b_e = owns_col ? bias[((size_t)gate * heads + h) * dh + unit]
                             : 0.f;
  // g_in[b, t, gate, h, unit]: one step of one row is 4·H·dh floats
  const float* gin = g_in + (size_t)b * steps * 4 * heads * dh +
                     ((size_t)gate * heads + h) * dh + unit;
  float* yrow = y + (size_t)b * steps * heads * dh + (size_t)h * dh + e;

  float c = 0.f, n = 0.f, m = 0.f;
  if (e < dh) hs[e] = 0.f;
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    if (owns_col) {
      const float g = gin[(size_t)t * 4 * heads * dh];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
      int d = 0;
      for (; d + 4 <= dh; d += 4) {
        acc0 = fmaf(hs[d], rcol[(size_t)d * cols], acc0);
        acc1 = fmaf(hs[d + 1], rcol[(size_t)(d + 1) * cols], acc1);
        acc2 = fmaf(hs[d + 2], rcol[(size_t)(d + 2) * cols], acc2);
        acc3 = fmaf(hs[d + 3], rcol[(size_t)(d + 3) * cols], acc3);
      }
      for (; d < dh; ++d) acc0 = fmaf(hs[d], rcol[(size_t)d * cols], acc0);
      gs[e] = g + ((acc0 + acc1) + (acc2 + acc3)) + b_e;
    }
    __syncthreads();   // every gate pre-activation is in gs; h is read
    if (e < dh) {
      const float li = gs[e];
      const float lf = log_sigmoid(gs[dh + e]);
      const float z = gs[2 * dh + e];
      const float o = gs[3 * dh + e];
      const float m_new = fmaxf(lf + m, li);
      const float ip = expf(li - m_new);
      const float fp = expf(lf + m - m_new);
      c = fp * c + ip * tanhf(z);
      n = fp * n + ip;
      const float h_new = (1.f / (1.f + expf(-o))) * c / fmaxf(n, 1e-6f);
      m = m_new;
      hs[e] = h_new;
      yrow[(size_t)t * heads * dh] = h_new;
    }
    __syncthreads();   // h of step t is in hs
  }
}

}  // namespace

// g_in[B, S, 4, H, dh], r_gates[H, dh, 4, dh], b_gates[4, H, dh] →
// y[B, S, H, dh], all f32 and contiguous; dh <= 256.
extern "C" int repro_slstm_cell_f32(const void* g_in, const void* r_gates,
                                    const void* b_gates, void* y, int batch,
                                    int steps, int heads, int dh,
                                    void* stream) {
  if (dh < 1 || dh > kMaxDh) return (int)cudaErrorInvalidValue;
  if (batch == 0 || steps == 0 || heads == 0) return (int)cudaSuccess;
  const int threads = (4 * dh + 31) / 32 * 32;
  slstm_kernel<<<dim3(heads, batch), threads, 0, (cudaStream_t)stream>>>(
      (const float*)g_in, (const float*)r_gates, (const float*)b_gates,
      (float*)y, steps, heads, dh);
  return (int)cudaGetLastError();
}
