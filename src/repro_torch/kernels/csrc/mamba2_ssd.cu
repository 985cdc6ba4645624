// Mamba-2 SSD chunked scan for sm_90a, chunk-parallel in three passes:
// each chunk's own state, the states passed along the chunks, each
// chunk's output.
//
// Replaces: src/repro/kernels/mamba2_ssd.py::_ssd_kernel (the pallas_call
// at mamba2_ssd.py:78).
//
// What bounds it on an H100: each chunk of L tokens does L·L·(N + P)/2
// multiply-adds for the masked quadratic form and 2·L·P·N for the state
// terms, against (2·P + 2·N + 1)·4 bytes per token moved once (x, B, C,
// dt·A in, y out).  At the zamba2-7b widths (P = N = 64) and the chunk
// of 64 the kernel runs at, that is ~24 operations per byte, just above
// the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20): operations bound it,
// at the 67 TFLOP/s of plain f32 FMA.
//
// What the design does about it: the TPU grid (B, H, S/chunk) walked the
// chunks in order, the [P, N] state in VMEM scratch.  Only the state
// crosses chunks, and it enters linearly, so the algebra of _ssd_kernel
// splits into three grids and every chunk's heavy work runs in parallel:
//   (a) chunk_state_kernel, one block per (head, chunk, batch): the
//       chunk's cumsum la of dt·A as a two-warp scan (shuffles), then
//       ds_c = (x ∘ exp(la_L − la))ᵀ·B, [P, N], in f32 FMA, written to
//       scratch beside exp(la_L);
//   (b) state_pass_kernel, one thread per state element of a (batch,
//       head): S_0 = 0, S_c = S_{c−1}·exp(la_L, c−1) + ds_{c−1}, in place
//       over the scratch, so slot c holds the state before chunk c; when
//       the caller asks for it (a served prefill leaves it in the cache),
//       the state after the last chunk goes to one more slot, `final`
//       [B, H, P, N];
//   (c) chunk_out_kernel, one block per (head, chunk, batch):
//       y = exp(la) ∘ (C·S_cᵀ) + ((C·Bᵀ) ∘ exp(la_i − la_j), j <= i)·x,
//       its three 64 × 64 products on the tensor cores in
//       error-compensated TF32 (3 TF32 products per f32 product, ~2^-21
//       of it lost) by 8 warps of 16 × 32.
// The result does not depend on the chunk, only the work does: the
// quadratic form costs L·(N + P)/2 a token and the state terms 2·P·N, so
// the wrapper runs the kernel at the largest divisor of the caller's
// chunk up to 64 tokens (zamba2-7b's 256 split in four): a chunk is one
// 64-row tile, pass (c) one diagonal tile pair, and the shorter f32
// cumsums lose less; the scratch then holds S/L states of a head.
// exp(la_i − la_j) is computed only where j <= i and selected, never
// multiplied by a mask: above the diagonal the exponent is positive and
// may overflow, and inf·0 is NaN.  Operands are staged in shared memory
// by cp.async with zero fill past the chunk and past P and N.  Pass (c)
// writes G over the B tile it came from and takes 69 KB, so three
// blocks share an SM; its B and x tiles load while C·Sᵀ runs.  Grids run
// heads fastest, so blocks that run together read whole token rows, and
// the scratch is chunk-major, so pass (b)'s threads stream through it
// together.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;   // pass (a): 16 × 16, 4 × 4 outputs each
constexpr int kTile = 64;       // the longest chunk the kernels take
constexpr int kMaxDim = 64;     // P, N <= 64
// padded rows: float4 reads of 16 rows, and the tensor cores' fragment
// reads (g rows by t columns), hit distinct banks; x, read as the B
// operand (t rows by g columns), takes 72
constexpr int kLd = 68;
constexpr int kLdX = 72;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

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
// past `width` up to kMaxDim and past `valid` rows
__device__ void stage(float* dst, const float* src, size_t stride, int width,
                      int valid, bool vec, int ld = kLd) {
  if (vec) {   // width and stride multiples of 4: 16-byte copies
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
// over k in [0, kend), kend a multiple of 8, in error-compensated TF32:
// each operand x = hi + lo with hi = tf32(x) and lo = tf32(x − hi), and
// a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b (the dropped lo_a·lo_b is
// ~2^-22 of a·b), every product and sum in the tensor cores' f32.
// A(r, k) = A[r·lda + k] from row m0; B(k, n) = B[k·ldb + n] (kBRows) or
// B[n·ldb + k], from column n0.  Fragment layouts of the PTX ISA's
// m16n8k8 .tf32: a (g, t) (g+8, t) (g, t+4) (g+8, t+4), b (t, g) (t+4, g),
// d (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1), g = lane / 4, t = lane % 4.
template <bool kBRows>
__device__ __forceinline__ void warp_mma3(float (&d)[4][4], const float* A,
                                          int lda, int m0, const float* B,
                                          int ldb, int n0, int kend) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  for (int k0 = 0; k0 < kend; k0 += 8) {
    const float* ar = A + (m0 + g) * lda + k0 + t;
    const float av[4] = {ar[0], ar[8 * lda], ar[4], ar[8 * lda + 4]};
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
// barrier.
__device__ void chunk_cumsum(float* la, const float* da, size_t stride,
                             int L) {
  if (threadIdx.x < kTile) {
    const int lane = threadIdx.x & 31;
    float v = threadIdx.x < L ? da[threadIdx.x * stride] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, v, off);
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

// pass (a): ds_c[p][n] = Σ_j x[j][p]·exp(la_L − la_j)·B[j][n]
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(Params prm) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [kTile][kLd]
  float* bs = xs + kTile * kLd;     // [kTile][kLd]
  float* la = bs + kTile * kLd;     // [kTile]
  float* w = la + kTile;            // [kTile]: exp(la_L − la_j)
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
  const float la_last = la[L - 1];
  if (threadIdx.x < kTile)
    w[threadIdx.x] = threadIdx.x < L ? expf(la_last - la[threadIdx.x]) : 0.f;
  if (threadIdx.x == 0)
    prm.decay[((size_t)b * nc + c) * prm.h + hh] = expf(la_last);
  cp_wait<0>();
  __syncthreads();
  // x rows ∘ exp(la_L − la_j), in place (rows past L are zero)
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

// pass (b): slot c of each (batch, head) becomes the state before chunk
// c, and `final` (when not null) the state after the last one.  A
// chunk's slots of all heads are contiguous, so the threads, each
// walking one element along the chunks, stream through memory together;
// loads and stores bypass L1 (each value is read once, then overwritten).
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
      v[i] = c0 + i < nc ? __ldcg(st + (size_t)(c0 + i) * per_chunk) : 0.f;
      f[i] = c0 + i < nc ? dk[(size_t)(c0 + i) * heads] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < nc) __stcg(st + (size_t)(c0 + i) * per_chunk, run);
      run = fmaf(run, f[i], v[i]);
    }
  }
  if (final != nullptr) final[(size_t)b * per_chunk + idx] = run;
}

// pass (c): one chunk, on the tensor cores in error-compensated TF32
// (warp_mma3).  Warp w owns rows 16·(w % 4) and columns 32·(w / 4) of
// the chunk's 64 × 64 products.
__global__ void __launch_bounds__(kThreads, 3)
chunk_out_kernel(Params prm) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                 // [kTile][kLd]: C rows
  float* bs = cs + kTile * kLd;     // [kTile][kLd]: B rows,
  float* gs = bs;                   // then (C·Bᵀ) ∘ decay over them
  float* xs = bs + kTile * kLd;     // [kTile][kLdX]: x rows
  float* st = xs + kTile * kLdX;    // [kMaxDim][kLd]: the state, [p][n]
  float* la = st + kMaxDim * kLd;   // [kTile]
  // heads fastest, so blocks running together read whole token rows
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int L = prm.chunk, nc = prm.s / L;
  const size_t tok0 = (size_t)b * prm.s + (size_t)c * L;
  const size_t xstride = (size_t)prm.h * prm.p;
  const size_t bstride = (size_t)prm.h * prm.n;
  const bool bvec = (prm.n & 3) == 0;

  // groups in order: C + state, B, x
  stage(cs, prm.cm + (tok0 * prm.h + hh) * prm.n, bstride, prm.n, L, bvec);
  stage(st, prm.states + (((size_t)b * nc + c) * prm.h + hh) * prm.p * prm.n,
        prm.n, prm.n, prm.p, bvec);
  cp_commit();
  stage(bs, prm.bm + (tok0 * prm.h + hh) * prm.n, bstride, prm.n, L, bvec);
  cp_commit();
  stage(xs, prm.x + (tok0 * prm.h + hh) * prm.p, xstride, prm.p, L,
        (prm.p & 3) == 0, kLdX);
  cp_commit();
  chunk_cumsum(la, prm.da + tok0 * prm.h + hh, prm.h, L);

  const int warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int kn = (prm.n + 7) & ~7, kp = (prm.p + 7) & ~7;
  // y = exp(la_i) ∘ (C·stateᵀ): rows m0 + g (+8), columns n0 + 8 nt + 2t
  float y[4][4] = {};
  cp_wait<2>();
  __syncthreads();
  if (n0 < kp) warp_mma3<false>(y, cs, kLd, m0, st, kLd, n0, kn);
  const float scale[2] = {expf(la[min(m0 + g, L - 1)]),
                          expf(la[min(m0 + g + 8, L - 1)])};
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[nt][e] *= scale[e >> 1];

  // G = C·Bᵀ ∘ exp(la_i − la_j) where key j <= row i < L, else 0; keys
  // past this warp's last row are all masked
  cp_wait<1>();
  __syncthreads();
  float gt[4][4] = {};
  if (n0 <= m0 + 15) warp_mma3<false>(gt, cs, kLd, m0, bs, kLd, n0, kn);
  __syncthreads();   // B is read: G goes where it was
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ri = m0 + g + 8 * (e >> 1);
      const int cj = n0 + 8 * nt + 2 * t + (e & 1);
      gs[ri * kLd + cj] = (cj <= ri && ri < L)
          ? gt[nt][e] * expf(la[ri] - la[cj]) : 0.f;
    }
  cp_wait<0>();      // x
  __syncthreads();   // and G is whole
  // y += G · x over the keys up to this warp's last row
  if (n0 < kp) warp_mma3<true>(y, gs, kLd, m0, xs, kLdX, n0, m0 + 16);

  float* yg = prm.y + (tok0 * prm.h + hh) * prm.p;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int ri = m0 + g + 8 * e2;
    if (ri >= L) continue;
    float* yrow = yg + (size_t)ri * xstride;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + 8 * nt + 2 * t;
      if (col + 1 < prm.p) {
        yrow[col] = y[nt][2 * e2];
        yrow[col + 1] = y[nt][2 * e2 + 1];
      } else if (col < prm.p) {
        yrow[col] = y[nt][2 * e2];
      }
    }
  }
}

constexpr size_t kStateSmem = sizeof(float) * (2 * kTile * kLd + 2 * kTile);
constexpr size_t kOutSmem = sizeof(float) * (2 * kTile * kLd + kTile * kLdX +
                                             kMaxDim * kLd + kTile);

bool shape_ok(int p, int n, int chunk, int s) {
  return p >= 1 && p <= kMaxDim && n >= 1 && n <= kMaxDim && chunk >= 1 &&
         chunk <= kTile && s % chunk == 0;
}

Params params(const void* xdt, const void* da, const void* bm,
              const void* cm, void* y, void* states, void* decay, int s,
              int h, int p, int n, int chunk) {
  return {(const float*)xdt, (const float*)da, (const float*)bm,
          (const float*)cm, (float*)y, (float*)states, (float*)decay,
          s, h, p, n, chunk};
}

}  // namespace

// The three passes over xdt[B, S, H, P], da[B, S, H], bm/cm[B, S, H, N]
// → y[B, S, H, P], all f32 and contiguous; P, N, chunk <= 64, the
// chunk dividing S.  Scratch: states[B, S/chunk, H, P, N], decay[B, S/chunk,
// H], f32.  Launch in order on one stream.

// (a) each chunk's own state into `states`, exp(la_L) into `decay`
extern "C" int repro_ssd_chunk_state_f32(const void* xdt, const void* da,
                                         const void* bm, void* states,
                                         void* decay, int batch, int s,
                                         int h, int p, int n, int chunk,
                                         void* stream) {
  if (!shape_ok(p, n, chunk, s)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || s == 0 || h == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kStateSmem);
  if (err != cudaSuccess) return (int)err;
  const Params prm = params(xdt, da, bm, nullptr, nullptr, states, decay, s,
                            h, p, n, chunk);
  chunk_state_kernel<<<dim3(h, s / chunk, batch), kThreads, kStateSmem,
                       (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}

// (b) slot c of `states` becomes the state before chunk c, and the state
// after the last chunk goes to final[B, H, P, N] unless `final` is null
extern "C" int repro_ssd_state_pass_f32(void* states, const void* decay,
                                        void* final, int batch, int s, int h,
                                        int p, int n, int chunk,
                                        void* stream) {
  if (!shape_ok(p, n, chunk, s)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || s == 0 || h == 0) return (int)cudaSuccess;
  const size_t per_chunk = (size_t)h * p * n;
  state_pass_kernel<<<dim3((unsigned)((per_chunk + kThreads - 1) / kThreads),
                           batch),
                      kThreads, 0, (cudaStream_t)stream>>>(
      (float*)states, (const float*)decay, (float*)final, h, s / chunk,
      p * n);
  return (int)cudaGetLastError();
}

// (c) y from C, B, x and the state before each chunk
extern "C" int repro_ssd_chunk_out_f32(const void* xdt, const void* da,
                                       const void* bm, const void* cm,
                                       const void* states, void* y,
                                       int batch, int s, int h, int p, int n,
                                       int chunk, void* stream) {
  if (!shape_ok(p, n, chunk, s)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || s == 0 || h == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kOutSmem);
  if (err != cudaSuccess) return (int)err;
  const Params prm = params(xdt, da, bm, cm, y, (void*)states, nullptr, s, h,
                            p, n, chunk);
  chunk_out_kernel<<<dim3(h, s / chunk, batch), kThreads, kOutSmem,
                     (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}
