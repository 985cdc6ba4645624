// Pieces the sLSTM's forward (slstm_cell.cu) and backward
// (slstm_cell_bwd.cu) share: the cluster's distributed-shared-memory
// exchange (mbarriers, st.async), the gating's log-sigmoid, and the
// instances built with their launch configuration and plan.  See
// slstm_cell.cu for the design.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDh = 256;
constexpr int kSlices = 16;     // threads per pair of hidden units
constexpr unsigned kFull = 0xffffffffu;

// threads of a block: 16 per pair of the block's hidden units, in whole
// warps, for dh up to 16·dpt over cs blocks
constexpr int max_threads(int dpt, int cs) {
  return (kSlices * (((kSlices * dpt + cs - 1) / cs + 1) / 2) + 31) / 32 * 32;
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - __logf(1.f + __expf(-fabsf(x)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address of shared-memory address `addr` in cluster block `rank`
__device__ __forceinline__ unsigned peer_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count) : "memory");
}

// one arrival on the barrier's phase, which then also awaits `bytes`
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// v into a cluster block's shared memory, its 4 bytes counted on that
// block's barrier `bar` (both addresses from peer_addr)
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// four floats (16-byte aligned) the same way, 16 bytes counted
__device__ __forceinline__ void st_async4(unsigned addr, float a, float b,
                                          float c, float d, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)),
      "r"(__float_as_uint(c)), "r"(__float_as_uint(d)), "r"(bar)
      : "memory");
}

template <int DPT, int CS, int ROWS>
cudaLaunchConfig_t config(int batch, int heads, int threads,
                          cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, heads, (batch + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CS;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// one instance of a kernel, as a type
template <int DPT, int CS, int ROWS>
struct Instance {
  static constexpr int dpt = DPT, cs = CS, rows = ROWS;
};

// f(Instance<DPT, CS, ROWS>{}) for the smallest DPT (inputs per thread)
// with 16·DPT >= dh, and the caller's cluster size `cs` and batch rows
// per cluster `rows`; cudaErrorInvalidValue where that instance is not
// built (clusters of 6 for dh <= 192, of 8 above; 1 or 2 rows)
template <int ROWS, typename F>
cudaError_t with_rows(int dh, int cs, F&& f) {
  if (dh < 1 || dh > kMaxDh) return cudaErrorInvalidValue;
  if (cs == 6 && dh <= 64) return f(Instance<4, 6, ROWS>{});
  if (cs == 6 && dh <= 128) return f(Instance<8, 6, ROWS>{});
  if (cs == 6 && dh <= 192) return f(Instance<12, 6, ROWS>{});
  if (cs == 8 && dh > 192) return f(Instance<16, 8, ROWS>{});
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t with_instance(int dh, int cs, int rows, F&& f) {
  if (rows == 1) return with_rows<1>(dh, cs, f);
  if (rows == 2) return with_rows<2>(dh, cs, f);
  return cudaErrorInvalidValue;
}

// threads of a block of the instance for dh
template <typename I>
int threads_for(int dh) {
  const int units = (dh + I::cs - 1) / I::cs;
  return (kSlices * ((units + 1) / 2) + 31) / 32 * 32;
}

// The launch plan of a cluster kernel (kernel_of(instance) gives its
// function) for [B, ·, ·, H, dh] operands on clusters of `cs` blocks:
// out = {batch rows per cluster, resident clusters at most
// (cudaOccupancyMaxActiveClusters), threads per block}.  Batch rows per
// cluster: 1 if all B·H clusters can be resident at once, else 2.
template <typename KernelOf>
int cluster_plan(int batch, int heads, int dh, int cs, int* out,
                 KernelOf kernel_of) {
  if (batch < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  for (int rows = 1; rows <= 2; ++rows) {
    int threads = 0, clusters = 0;
    const cudaError_t err =
        with_instance(dh, cs, rows, [&](auto inst) {
          using I = decltype(inst);
          threads = threads_for<I>(dh);
          cudaLaunchAttribute attr;
          cudaLaunchConfig_t cfg = config<I::dpt, I::cs, I::rows>(
              batch, heads, threads, &attr, nullptr);
          return cudaOccupancyMaxActiveClusters(
              &clusters, (void*)kernel_of(inst), &cfg);
        });
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    if (rows == 2 || (long long)batch * heads <= clusters) {
      out[0] = rows;
      out[1] = clusters;
      out[2] = threads;
      return (int)cudaSuccess;
    }
  }
  return (int)cudaErrorInvalidValue;   // not reached
}

// Launch kernel_of(instance) for (dh, cs, rows) on a cluster grid with
// `args`; with B, S or H empty only the instance is checked.
template <typename KernelOf, typename... Args>
int cluster_launch(int batch, int steps, int heads, int dh, int cs,
                   int rows, cudaStream_t stream, KernelOf kernel_of,
                   Args... args) {
  if (batch == 0 || steps == 0 || heads == 0)
    return (int)with_instance(dh, cs, rows, [](auto) { return cudaSuccess; });
  const cudaError_t err = with_instance(dh, cs, rows, [&](auto inst) {
    using I = decltype(inst);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config<I::dpt, I::cs, I::rows>(
        batch, heads, threads_for<I>(dh), &attr, stream);
    return cudaLaunchKernelEx(&cfg, kernel_of(inst), args...);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
