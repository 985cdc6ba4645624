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
//       its three 64 × 64 products in f32 FMA on the CUDA cores
//       (warp_fma) by 8 warps of 16 × 32, each sum in k order.
// Precision: y_i can be 10^3 times smaller than the sum of |terms| it
// cancels from (P = N = 64, unit inputs); the reference's elementwise
// f32 tolerance (rtol 2e-4, atol 2e-5) then leaves ~2e-7 of that sum.
// With its products on the tensor cores in error-compensated TF32 (3
// TF32 products per f32 product, ~2^-22 of each term lost, the tensor
// cores' f32 sums on top) and la in f32
// (each la_i carries ~ulp(|la|), which exp(la_i − la_j) makes a
// relative error): at zamba2-7b's layer 61 of 29.4 M outputs missed the
// tolerance on an H100 (700 W), 10 with la in double and the diagonal
// block in f32 FMA, 0 with all three products in f32 FMA on four seed
// sets (worst 0.97 of the tolerance; tools/ssd_fwd_precision.py).  So
// passes (a) and (c) keep la in double, and pass (c) runs in f32 FMA:
// zamba2-7b's 9-layer training step spends 26% more time in the
// forward's kernels than with the TF32 products (87.0 against 69.1 ms
// in one run), 1.1% more in all.
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
// together.  Passes (a) and (b), the staging and the TF32 product live in
// ssd_common.cuh, which the backward (mamba2_ssd_bwd.cu) shares.
#include "ssd_common.cuh"

namespace {

// One warp: d (a 16 × 32 tile in warp_mma3's accumulator layout: rows
// m0 + g and m0 + g + 8, columns n0 + 8·nt + 2t and + 1) += A·B over k
// in [kbeg, kend), in f32 FMA on the CUDA cores, each sum in k order.
// A(r, k) = A[r·lda + k]; B(k, n) = B[k·ldb + n] (kBRows) or B[n·ldb + k].
template <bool kBRows>
__device__ __forceinline__ void warp_fma(float (&d)[4][4], const float* A,
                                         int lda, int m0, const float* B,
                                         int ldb, int n0, int kend,
                                         int kbeg = 0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* a0 = A + (m0 + g) * lda;
  const float* a8 = a0 + 8 * lda;
  // unrolled 4 deep under two blocks an SM (96 registers, no spills):
  // 2% less time than the rolled loop at three blocks an SM (70
  // registers); the compiler's default unrolling at three blocks spills
#pragma unroll 4
  for (int k = kbeg; k < kend; ++k) {
    const float u = a0[k], w = a8[k];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + 8 * nt + 2 * t;
      float b0, b1;
      if (kBRows) {
        const float2 bv = *reinterpret_cast<const float2*>(B + k * ldb + n);
        b0 = bv.x, b1 = bv.y;
      } else {
        b0 = B[n * ldb + k], b1 = B[(n + 1) * ldb + k];
      }
      d[nt][0] = fmaf(u, b0, d[nt][0]);
      d[nt][1] = fmaf(u, b1, d[nt][1]);
      d[nt][2] = fmaf(w, b0, d[nt][2]);
      d[nt][3] = fmaf(w, b1, d[nt][3]);
    }
  }
}

// pass (c): one chunk, in f32 FMA (warp_fma).  Warp w owns rows
// 16·(w % 4) and columns 32·(w / 4) of the chunk's 64 × 64 products.
__global__ void __launch_bounds__(kThreads, 2)
chunk_out_kernel(Params prm) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                 // [kTile][kLd]: C rows
  float* bs = cs + kTile * kLd;     // [kTile][kLd]: B rows,
  float* gs = bs;                   // then (C·Bᵀ) ∘ decay over them
  float* xs = bs + kTile * kLd;     // [kTile][kLdX]: x rows
  float* st = xs + kTile * kLdX;    // [kMaxDim][kLd]: the state, [p][n]
  double* la = reinterpret_cast<double*>(st + kMaxDim * kLd);  // [kTile]
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
  if (n0 < kp) warp_fma<false>(y, cs, kLd, m0, st, kLd, n0, kn);
  const float scale[2] = {expf((float)la[min(m0 + g, L - 1)]),
                          expf((float)la[min(m0 + g + 8, L - 1)])};
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[nt][e] *= scale[e >> 1];

  // G = C·Bᵀ ∘ exp(la_i − la_j) where key j <= row i < L, else 0; keys
  // past this warp's last row are all masked
  cp_wait<1>();
  __syncthreads();
  float gt[4][4] = {};
  if (n0 <= m0 + 15) warp_fma<false>(gt, cs, kLd, m0, bs, kLd, n0, kn);
  __syncthreads();   // B is read: G goes where it was
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ri = m0 + g + 8 * (e >> 1);
      const int cj = n0 + 8 * nt + 2 * t + (e & 1);
      gs[ri * kLd + cj] = (cj <= ri && ri < L)
          ? gt[nt][e] * expf((float)(la[ri] - la[cj])) : 0.f;
    }
  cp_wait<0>();      // x
  __syncthreads();   // and G is whole
  // y += G · x over the keys up to this warp's last row, summed from
  // zero as the plain version's sum is
  if (n0 < kp) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) gt[nt][e] = 0.f;   // G is in smem now
    warp_fma<true>(gt, gs, kLd, m0, xs, kLdX, n0, m0 + 16);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][e] += gt[nt][e];
  }

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

constexpr size_t kOutSmem =
    sizeof(float) * (2 * kTile * kLd + kTile * kLdX + kMaxDim * kLd) +
    sizeof(double) * kTile;

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
  const Params prm = params(xdt, da, bm, nullptr, nullptr, states, decay, s,
                            h, p, n, chunk);
  return (int)launch_chunk_state<false>(prm, batch, (cudaStream_t)stream);
}

// (b) slot c of `states` becomes the state before chunk c, and the state
// after the last chunk goes to final[B, H, P, N] unless `final` is null
extern "C" int repro_ssd_state_pass_f32(void* states, const void* decay,
                                        void* final, int batch, int s, int h,
                                        int p, int n, int chunk,
                                        void* stream) {
  if (!shape_ok(p, n, chunk, s)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || s == 0 || h == 0) return (int)cudaSuccess;
  return (int)launch_state_pass<false>((float*)states, (const float*)decay,
                                       (float*)final, batch, s, h, p, n,
                                       chunk, (cudaStream_t)stream);
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
