// Pieces the SSD's forward (mamba2_ssd.cu) and backward
// (mamba2_ssd_bwd.cu) share: staging by cp.async, the error-compensated
// TF32 warp product, the chunk's cumsum, the per-chunk state kernel and
// the pass along the chunks.  See mamba2_ssd.cu for the design.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

#include "mma_bf16.cuh"   // smem_addr

namespace {

constexpr int kThreads = 256;   // 16 × 16 (pass (a)), or 8 warps
constexpr int kTile = 64;       // the longest chunk the kernels take
constexpr int kMaxDim = 64;     // P, N <= 64
// padded rows: float4 reads of 16 rows, and the tensor cores' fragment
// reads (g rows by t columns), hit distinct banks; x, read as the B
// operand (t rows by g columns), takes 72
constexpr int kLd = 68;
constexpr int kLdX = 72;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, kTile) of an operand with `valid` rows of `width` floats
// (row stride `stride` floats) into dst[kTile][ld] by cp.async, zero
// past `width` up to kMaxDim and past `valid` rows.  `vec`: the caller's
// row width is a multiple of 4; the copies are 16 bytes only where the
// stride is too and `src` is 16-byte aligned (a contiguous view may
// start at any float), else 4 bytes.
__device__ void stage(float* dst, const float* src, size_t stride, int width,
                      int valid, bool vec, int ld = kLd) {
  if (vec && (stride & 3) == 0 &&
      (reinterpret_cast<size_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < kTile * kMaxDim / 4; i += kThreads) {
      const int r = i / (kMaxDim / 4);
      const int c = (i - r * (kMaxDim / 4)) * 4;
      const bool ok = r < valid && c < width;
      cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kMaxDim; i += kThreads) {
      const int r = i / kMaxDim;
      const int c = i - r * kMaxDim;
      const bool ok = r < valid && c < width;
      cp_async4(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

// a float rounded to TF32 (10 mantissa bits), as a b32 operand of mma
__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d[4] += a[4]·b[2]: one m16n8k8 TF32 product, f32 accumulation
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: d[nt] (a 16 × 32 tile as four m16n8 accumulators) += A·B
// over k in [kbeg, kend), both multiples of 8, in error-compensated TF32:
// each operand x = hi + lo with hi = tf32(x) and lo = tf32(x − hi), and
// a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b (the dropped lo_a·lo_b is
// ~2^-22 of a·b), every product and sum in the tensor cores' f32.
// A(r, k) = A[r·lda + k] (A[k·lda + r] with kATrans) from row m0;
// B(k, n) = B[k·ldb + n] (kBRows) or B[n·ldb + k], from column n0.
// Fragment layouts of the PTX ISA's m16n8k8 .tf32: a (g, t) (g+8, t)
// (g, t+4) (g+8, t+4), b (t, g) (t+4, g), d (g, 2t) (g, 2t+1) (g+8, 2t)
// (g+8, 2t+1), g = lane / 4, t = lane % 4.
template <bool kBRows, bool kATrans = false>
__device__ __forceinline__ void warp_mma3(float (&d)[4][4], const float* A,
                                          int lda, int m0, const float* B,
                                          int ldb, int n0, int kend,
                                          int kbeg = 0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  for (int k0 = kbeg; k0 < kend; k0 += 8) {
    float av[4];
    if (kATrans) {
      const float* ar = A + (k0 + t) * lda + m0 + g;
      av[0] = ar[0], av[1] = ar[8], av[2] = ar[4 * lda],
      av[3] = ar[4 * lda + 8];
    } else {
      const float* ar = A + (m0 + g) * lda + k0 + t;
      av[0] = ar[0], av[1] = ar[8 * lda], av[2] = ar[4],
      av[3] = ar[8 * lda + 4];
    }
    unsigned ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ahi[i] = tf32(av[i]);
      alo[i] = tf32(av[i] - __uint_as_float(ahi[i]));
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + 8 * nt + g;
      const float bv[2] = {
          kBRows ? B[(k0 + t) * ldb + n] : B[n * ldb + k0 + t],
          kBRows ? B[(k0 + t + 4) * ldb + n] : B[n * ldb + k0 + t + 4]};
      unsigned bhi[2], blo[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bhi[i] = tf32(bv[i]);
        blo[i] = tf32(bv[i] - __uint_as_float(bhi[i]));
      }
      mma_tf32(d[nt], alo, bhi);
      mma_tf32(d[nt], ahi, blo);
      mma_tf32(d[nt], ahi, bhi);
    }
  }
}

// la[i] = da_0 + ... + da_i over the chunk's L <= 64 tokens (one a
// thread of the first two warps); la[i] = la[L − 1] past L.  Ends in a
// barrier.  T is float, or double where a kernel takes differences
// la_i − la_j: in f32 each la carries ~ulp(|la|) of error (|la| reaches
// a few units over 64 tokens), which exp(la_i − la_j) multiplies into
// terms that can cancel to a result 10^3 times smaller.
template <typename T>
__device__ void chunk_cumsum(T* la, const float* da, size_t stride, int L) {
  if (threadIdx.x < kTile) {
    const int lane = threadIdx.x & 31;
    T v = threadIdx.x < L ? (T)da[threadIdx.x * stride] : (T)0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    la[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x >= 32 && threadIdx.x < kTile) la[threadIdx.x] += la[31];
  __syncthreads();
}

struct Params {
  const float* x;    // [B, S, H, P]
  const float* da;   // [B, S, H]
  const float* bm;   // [B, S, H, N]
  const float* cm;   // [B, S, H, N]
  float* y;          // [B, S, H, P]
  float* states;     // [B, S/chunk, H, P, N]: ds_c, then the state before c
  float* decay;      // [B, S/chunk, H]: exp(la_L) of each chunk
  int s, h, p, n, chunk;
};

// One block per (head, chunk, batch): a chunk's own state,
//   ds_c[p][n] = Σ_j x[j][p]·w_j·B[j][n],
// with w_j = exp(la_L − la_j) (pass (a) of the forward, which also
// writes exp(la_L) to `decay`) or, with kGrad, w_j = exp(la_j): then x
// is the output gradient dy, B is C and ds_c the chunk's own gradient of
// the state before it, Σ_i exp(la_i)·dy_i ⊗ C_i (pass (a′) of the
// backward).
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(Params prm) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [kTile][kLd]
  float* bs = xs + kTile * kLd;     // [kTile][kLd]
  // [kTile] in double (chunk_cumsum), so exp(la_L − la_j) keeps the
  // difference's own bits
  double* la = reinterpret_cast<double*>(bs + kTile * kLd);
  float* w = reinterpret_cast<float*>(la + kTile);   // [kTile]: w_j
  // heads fastest: blocks running together read whole token rows
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int L = prm.chunk, nc = prm.s / L;
  const size_t tok0 = (size_t)b * prm.s + (size_t)c * L;
  const size_t xstride = (size_t)prm.h * prm.p;
  const size_t bstride = (size_t)prm.h * prm.n;
  const bool bvec = (prm.n & 3) == 0;

  stage(xs, prm.x + (tok0 * prm.h + hh) * prm.p, xstride, prm.p, L,
        (prm.p & 3) == 0);
  stage(bs, prm.bm + (tok0 * prm.h + hh) * prm.n, bstride, prm.n, L, bvec);
  cp_commit();
  chunk_cumsum(la, prm.da + tok0 * prm.h + hh, prm.h, L);
  const double la_last = la[L - 1];
  if (threadIdx.x < kTile)
    w[threadIdx.x] = threadIdx.x >= L ? 0.f
        : expf((float)(kGrad ? la[threadIdx.x] : la_last - la[threadIdx.x]));
  if (!kGrad && threadIdx.x == 0)
    prm.decay[((size_t)b * nc + c) * prm.h + hh] = expf((float)la_last);
  cp_wait<0>();
  __syncthreads();
  // x rows ∘ w_j, in place (rows past L are zero)
  for (int i = threadIdx.x; i < L * kMaxDim; i += kThreads) {
    const int r = i / kMaxDim;
    xs[r * kLd + i - r * kMaxDim] *= w[r];
  }
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};   // p = ty·4 + i, n = tx·4 + e
  for (int j = 0; j < L; ++j) {
    const float4 xv = *reinterpret_cast<const float4*>(&xs[j * kLd + ty * 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&bs[j * kLd + tx * 4]);
    const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(xa[i], bv.x, acc[i][0]);
      acc[i][1] = fmaf(xa[i], bv.y, acc[i][1]);
      acc[i][2] = fmaf(xa[i], bv.z, acc[i][2]);
      acc[i][3] = fmaf(xa[i], bv.w, acc[i][3]);
    }
  }
  float* out =
      prm.states + (((size_t)b * nc + c) * prm.h + hh) * prm.p * prm.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pp = ty * 4 + i;
    if (pp >= prm.p || tx * 4 >= prm.n) continue;
    float* o = out + (size_t)pp * prm.n + tx * 4;
    if (bvec) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (tx * 4 + e < prm.n) o[e] = acc[i][e];
    }
  }
}

// The pass along the chunks of a (batch, head), one thread per state
// element: slot c (ds_c on entry) becomes the running sum before chunk
// c, run_0 = 0 and run_{c+1} = run_c·decay_c + ds_c — forwards the
// state before chunk c (pass (b), `final` taking the state after the
// last one when not null), or with kReverse walking the chunks from the
// last, the gradient of the state after chunk c (pass (b′): G_c =
// local_c + exp(la_L, c)·G_{c+1}, slot c gets G_{c+1}).  A chunk's slots
// of all heads are contiguous, so the threads stream through memory
// together; loads and stores bypass L1 (each value is read once, then
// overwritten).
template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                  float* __restrict__ final, int heads, int nc, int elems) {
  const int b = blockIdx.y;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t per_chunk = (size_t)heads * elems;   // one chunk, all heads
  if (idx >= per_chunk) return;
  float* st = states + (size_t)b * nc * per_chunk + idx;
  const float* dk = decay + (size_t)b * nc * heads + idx / elems;
  constexpr int kBatch = 16;   // loads in flight ahead of the chain
  float run = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float v[kBatch], f[kBatch];   // past the last chunk: run · 1 + 0
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const size_t ci = kReverse ? nc - 1 - (c0 + i) : c0 + i;
      v[i] = c0 + i < nc ? __ldcg(st + ci * per_chunk) : 0.f;
      f[i] = c0 + i < nc ? dk[ci * heads] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const size_t ci = kReverse ? nc - 1 - (c0 + i) : c0 + i;
      if (c0 + i < nc) __stcg(st + ci * per_chunk, run);
      run = fmaf(run, f[i], v[i]);
    }
  }
  if (final != nullptr) final[(size_t)b * per_chunk + idx] = run;
}

constexpr size_t kStateSmem =
    sizeof(float) * (2 * kTile * kLd + kTile) + sizeof(double) * kTile;

bool shape_ok(int p, int n, int chunk, int s) {
  return p >= 1 && p <= kMaxDim && n >= 1 && n <= kMaxDim && chunk >= 1 &&
         chunk <= kTile && s % chunk == 0;
}

// Launch chunk_state_kernel<kGrad> over (heads, chunks, batch).
template <bool kGrad>
cudaError_t launch_chunk_state(const Params& prm, int batch,
                               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      chunk_state_kernel<kGrad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kStateSmem);
  if (err != cudaSuccess) return err;
  chunk_state_kernel<kGrad>
      <<<dim3(prm.h, prm.s / prm.chunk, batch), kThreads, kStateSmem,
         stream>>>(prm);
  return cudaGetLastError();
}

// Launch state_pass_kernel<kReverse> over (state elements, batch).
template <bool kReverse>
cudaError_t launch_state_pass(float* states, const float* decay,
                              float* final, int batch, int s, int h, int p,
                              int n, int chunk, cudaStream_t stream) {
  const size_t per_chunk = (size_t)h * p * n;
  state_pass_kernel<kReverse>
      <<<dim3((unsigned)((per_chunk + kThreads - 1) / kThreads), batch),
         kThreads, 0, stream>>>(states, decay, final, h, s / chunk, p * n);
  return cudaGetLastError();
}

}  // namespace
