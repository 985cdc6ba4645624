// DG element-wise differentiation out[m, :, e] = D_m · ut[:, e] for
// sm_90a.  Paper §8.4.
//
// Replaces: src/repro/kernels/dg_diff.py::_dg_kernel (the pallas_call at
// dg_diff.py:41).
//
// What bounds it on an H100: 2·N² operations per element column against
// 4·N bytes read and 4·M·N bytes written; at N = 64, M = 3 that is about
// 20 operations per byte, on the card's f32 ridge (67 TFLOP/s over
// 3.35 TB/s), so operations and bytes bound it about equally.  The f32
// tolerance (rtol 2e-4 against the plain version in float64) rules out
// TF32, so the ceiling is plain f32 FMA.
//
// What the design does about it.  One CUDA block per slab of E = 8192 / N
// elements (128 at N = 64) computes all M outputs of its slab, so ut is
// read from device memory once, not once per matrix; block_e is the TPU's
// block and sets nothing here.  The slab (N × E floats, 32 KB for every N)
// is copied into shared memory with cp.async in four commit groups of N/4
// rows, and the first matrix starts on the rows that have arrived while
// the rest are in flight; the next slab loads in the other blocks of the
// SM (four resident: 48 KB of shared memory, at most 128 registers a
// thread).  The block then walks m: D_m is staged transposed, Dt[j][i],
// from L2.  Each of the 128 threads owns an 8 × 8 tile of the output,
// split as in an SGEMM: rows i0..i0+3 and N/2 + i0..+3, elements
// c0..c0+3 and E/2 + c0..+3.  Per j it reads 8 values of D and 8 of ut,
// four LDS.128, for 64 FMAs.  A warp spans 4 row groups × 8 element
// groups, so each of its ut reads is 128 contiguous bytes and each D read
// 4 neighbouring 16-byte words broadcast to 8 threads: free of bank
// conflicts without padding, as are the transposing stores of D
// (consecutive threads on consecutive i).  Outputs leave as float4
// streaming stores (st.global.cs), coalesced along e: they are written
// once and never read back.  Each output sums j in order, one FMA a term.
// The last slab is masked when E does not divide K; when K % 4 != 0 or a
// pointer is not 16-byte aligned the same kernel copies and stores one
// float at a time.
//
// Any N <= 64: the kernel is instantiated at the widths W = 8, 16, 32, 64
// and an N between them (the DG node counts 10, 20, 35, 56) runs at the
// next W with N as a runtime bound: only the N rows of ut are copied, the
// j loop stops at N, and output rows i >= N are computed in registers and
// never stored.  D_m is read with its own row stride N (float4 reads only
// when N % 4 == 0).  Nothing is padded on the host.  N equal to its width
// takes an instantiation with N a compile-time constant (kFull), so the
// widths themselves keep their fully unrolled loops.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSlabFloats = 8192;  // N × E floats of ut a block stages
constexpr int kTile = 8;           // output rows i × elements e a thread owns
constexpr int kChunks = 4;         // commit groups the slab arrives in
// resident blocks an SM: 4 × 48 KB of shared memory, at most 128
// registers a thread.  The one-float path (unaligned operands, K % 4 != 0)
// computes 4 × more copy and store addresses and is built for 2, so that
// it does not spill either.
constexpr int kBlocksPerSM = 4;
constexpr int kBlocksPerSMOneFloat = 2;

template <int W>
struct Tile {
  static constexpr int E = kSlabFloats / W;          // slab width
  static constexpr int IG = W / kTile;               // row groups
  static constexpr int EG = E / kTile;               // element groups
  static constexpr int IGW = IG < 4 ? IG : 4;        // row groups a warp spans
  static constexpr int EGW = 32 / IGW;               // element groups a warp spans
  static constexpr int WI = IG / IGW;                // warps along i
  static_assert(IG * EG == kThreads, "one tile per thread");
  static_assert(kThreads / 32 / WI * EGW == EG, "warps cover the slab");
  static_assert(W % kChunks == 0, "whole rows per commit group");
  static_assert(kSlabFloats / kChunks % (4 * kThreads) == 0,
                "every thread copies whole 16-byte pieces of a group");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` commit groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}
static_assert(kChunks <= 4, "cp_async_wait covers up to 3 pending groups");

// D_m (row-major n × n) into dt transposed, dt[j·W + i] = D_m[i][j] for
// i, j < n.  Consecutive threads take consecutive i, so the stores hit
// consecutive banks; the reads come from L2 (D is 16 KB a matrix at
// n = 64).
template <int W, bool kVec>
__device__ __forceinline__ void stage_d(float* dt,
                                        const float* __restrict__ dm,
                                        int n) {
  if (kVec && n % 4 == 0) {
    for (int q = threadIdx.x; q < n * n / 4; q += kThreads) {
      const int i = q % n, j = q / n * 4;
      const float4 v = __ldg(reinterpret_cast<const float4*>(dm + i * n + j));
      dt[(j + 0) * W + i] = v.x;
      dt[(j + 1) * W + i] = v.y;
      dt[(j + 2) * W + i] = v.z;
      dt[(j + 3) * W + i] = v.w;
    }
  } else {
    for (int q = threadIdx.x; q < n * n; q += kThreads) {
      const int i = q % n, j = q / n;
      dt[j * W + i] = __ldg(dm + i * n + j);
    }
  }
}

// kVec: K % 4 == 0 and every pointer 16-byte aligned (16-byte copies and
// float4 stores); otherwise one float at a time.  W is the instantiated
// width, n_nodes <= W the node count; kFull: n_nodes == W.
template <int W, bool kVec, bool kFull>
__global__ void __launch_bounds__(kThreads,
                                  kVec ? kBlocksPerSM : kBlocksPerSMOneFloat)
dg_diff_kernel(const float* __restrict__ d, const float* __restrict__ ut,
               float* __restrict__ out, int n_mats, int n_nodes,
               int k_dim) {
  using T = Tile<W>;
  const int n = kFull ? W : n_nodes;
  constexpr int kChunkRows = W / kChunks;
  constexpr int kHalf = kTile / 2;
  __shared__ __align__(16) float us[kSlabFloats];  // us[j·E + c] = ut[j][e0 + c]
  __shared__ __align__(16) float dt[W * W];        // dt[j·W + i] = D_m[i][j]
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * T::E;
  const int valid = min(T::E, k_dim - e0);   // elements of this slab in K

  // the slab, one commit group per kChunkRows rows: 2048 floats a group,
  // 4 16-byte copies (or 16 4-byte ones) a thread; rows >= n are not
  // copied (the j loop never reads them)
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    if constexpr (kVec) {
      constexpr int kPieces = kChunkRows * T::E / 4;
#pragma unroll
      for (int q = 0; q < kPieces / kThreads; ++q) {
        const int p = tid + q * kThreads;
        const int r = c * kChunkRows + p / (T::E / 4);
        const int col = p % (T::E / 4) * 4;
        if (col < valid && (kFull || r < n))
          cp_async16(&us[r * T::E + col], ut + (size_t)r * k_dim + e0 + col);
      }
    } else {
      constexpr int kPieces = kChunkRows * T::E;
#pragma unroll 1
      for (int q = 0; q < kPieces / kThreads; ++q) {
        const int p = tid + q * kThreads;
        const int r = c * kChunkRows + p / T::E;
        const int col = p % T::E;
        if (col < valid && (kFull || r < n))
          cp_async4(&us[r * T::E + col], ut + (size_t)r * k_dim + e0 + col);
      }
    }
    cp_async_commit();
  }

  // this thread's rows i0 + r and W/2 + i0 + r, elements c0 + c and
  // E/2 + c0 + c (r, c < 4)
  const int warp = tid / 32, lane = tid % 32;
  const int i0 = ((warp % T::WI) * T::IGW + lane / T::EGW) * kHalf;
  const int c0 = ((warp / T::WI) * T::EGW + lane % T::EGW) * kHalf;

  for (int m = 0; m < n_mats; ++m) {
    if (m > 0) __syncthreads();   // every thread is done with D_{m-1}
    stage_d<W, kVec>(dt, d + (size_t)m * n * n, n);
    float acc[kTile][kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) acc[r][c] = 0.f;
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
      // the first matrix waits for each commit group in turn; the barrier
      // also publishes D_m
      if (m == 0) cp_async_wait(kChunks - 1 - c);
      if (m == 0 || c == 0) __syncthreads();
      const int j_end =
          kFull ? (c + 1) * kChunkRows : min((c + 1) * kChunkRows, n);
#pragma unroll 4
      for (int j = c * kChunkRows; j < j_end; ++j) {
        const float* dj = &dt[j * W + i0];
        const float* uj = &us[j * T::E + c0];
        const float4 da = *reinterpret_cast<const float4*>(dj);
        const float4 db = *reinterpret_cast<const float4*>(dj + W / 2);
        const float4 ua = *reinterpret_cast<const float4*>(uj);
        const float4 ub = *reinterpret_cast<const float4*>(uj + T::E / 2);
        const float dv[kTile] = {da.x, da.y, da.z, da.w,
                                 db.x, db.y, db.z, db.w};
        const float uv[kTile] = {ua.x, ua.y, ua.z, ua.w,
                                 ub.x, ub.y, ub.z, ub.w};
#pragma unroll
        for (int r = 0; r < kTile; ++r)
#pragma unroll
          for (int cc = 0; cc < kTile; ++cc)
            acc[r][cc] = fmaf(dv[r], uv[cc], acc[r][cc]);
      }
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const int row = r < kHalf ? i0 + r : W / 2 + i0 + r - kHalf;
      if (!kFull && row >= n) continue;
      float* o = out + ((size_t)m * n + row) * k_dim + e0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + h * (T::E / 2);
        const int a = h * kHalf;
        if constexpr (kVec) {
          if (col < valid)
            __stcs(reinterpret_cast<float4*>(o + col),
                   make_float4(acc[r][a], acc[r][a + 1], acc[r][a + 2],
                               acc[r][a + 3]));
        } else {
#pragma unroll
          for (int cc = 0; cc < kHalf; ++cc)
            if (col + cc < valid) __stcs(o + col + cc, acc[r][a + cc]);
        }
      }
    }
  }
}

template <int W, bool kFull>
void launch_as(const void* d, const void* ut, void* out, int m, int n, int k,
               bool vec, cudaStream_t stream) {
  const int slabs = (k + Tile<W>::E - 1) / Tile<W>::E;
  if (vec) {
    dg_diff_kernel<W, true, kFull><<<slabs, kThreads, 0, stream>>>(
        (const float*)d, (const float*)ut, (float*)out, m, n, k);
  } else {
    dg_diff_kernel<W, false, kFull><<<slabs, kThreads, 0, stream>>>(
        (const float*)d, (const float*)ut, (float*)out, m, n, k);
  }
}

template <int W>
int launch(const void* d, const void* ut, void* out, int m, int n, int k,
           cudaStream_t stream) {
  const bool vec = k % 4 == 0 &&
      ((uintptr_t)d | (uintptr_t)ut | (uintptr_t)out) % 16 == 0;
  if (n == W) {
    launch_as<W, true>(d, ut, out, m, n, k, vec, stream);
  } else {
    launch_as<W, false>(d, ut, out, m, n, k, vec, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// d [m, n, n], ut [n, k], out [m, n, k], all contiguous f32; 1 <= n <= 64
// (the wrapper checks), run at the width 8, 16, 32 or 64 at or above n.
// One block per slab of 8192 / width elements.
extern "C" int repro_dg_diff_f32(const void* d, const void* ut, void* out,
                                 int m, int n, int k, void* stream) {
  if (m == 0 || k == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (n <= 8) return launch<8>(d, ut, out, m, n, k, s);
  if (n <= 16) return launch<16>(d, ut, out, m, n, k, s);
  if (n <= 32) return launch<32>(d, ut, out, m, n, k, s);
  if (n <= 64) return launch<64>(d, ut, out, m, n, k, s);
  return (int)cudaErrorInvalidValue;
}
