// Mamba-2 SSD chunked scan for sm_90a: within a chunk the decay-masked
// quadratic form, across chunks a carried [P, N] f32 state.
//
// Replaces: src/repro/kernels/mamba2_ssd.py::_ssd_kernel (the pallas_call
// at mamba2_ssd.py:78).
//
// What bounds it on an H100: each chunk of L tokens does L·L·(N + P)/2
// multiply-adds for the masked quadratic form and 2·L·P·N for the state
// terms, against (2·P + 2·N + 1)·4 bytes per token moved once (x, B, C,
// dt·A in, y out).  At the zamba2-7b widths (P = N = 64, L = 256) that is
// ~30 operations per byte, above the f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20): operations bound it, at the 67 TFLOP/s of plain f32 FMA.
//
// What the design does about it: the TPU grid (B, H, S/chunk) walked the
// chunks sequentially with the state in VMEM scratch; here one CUDA block
// owns one (batch, head) and loops over the chunks itself, the state
// staying in shared memory (64 × 64 f32, 16 KB) for the whole sequence.
// At chunk 256 the L × L form alone would be 256 KB, so it is built and
// consumed in 64 × 64 sub-tiles: for each 64-row tile of queries, the
// tiles of keys at or before it (j <= i: the tiles above the diagonal are
// all zero and are skipped) give G = (C·Bᵀ)∘decay in shared memory, then
// y += G·x; then y += (C·stateᵀ)∘exp(la) with the state from before this
// chunk, and after all rows the state update
// state·exp(la_L) + (x∘exp(la_L − la))ᵀ·B.  exp(la_i − la_j) is computed
// only where i >= j and selected, never multiplied by a mask: above the
// diagonal the exponent is positive and may overflow, and inf·0 is NaN.
// x and B of the chunk (2 × 68 KB at L = 256), the C rows of the current
// tile, G and the state take 188 KB: one block per SM, and B·H blocks
// (112 for zamba2-7b at batch 1) leave 20 of the 132 SMs idle.  All f32
// FMA from shared memory; no tensor cores, no overlap of the next chunk's
// loads with this chunk's arithmetic.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;   // 16 × 16: 4 rows × 4 columns each
constexpr int kTile = 64;       // sub-tile of the L × L form
constexpr int kMaxChunk = 256;
constexpr int kMaxDim = 64;     // P, N <= 64
constexpr int kLd = 68;         // 4 · 17: float4 reads of 16 rows hit distinct banks

struct Params {
  const float* x;    // [B, S, H, P]
  const float* da;   // [B, S, H]
  const float* bm;   // [B, S, H, N]
  const float* cm;   // [B, S, H, N]
  float* y;          // [B, S, H, P]
  int s, h, p, n, chunk;
};

// rows [row0, row0 + rows) of a [S, H, width] operand (head already
// offset; row stride H·width) into dst[rows][kLd], zero past `width`
// up to kMaxDim and past `valid` rows
__device__ void stage(float* dst, const float* src, int h, int width,
                      int row0, int rows, int valid) {
  for (int i = threadIdx.x; i < rows * kMaxDim; i += kThreads) {
    const int r = i / kMaxDim;
    const int c = i - r * kMaxDim;
    float v = 0.f;
    if (r < valid && c < width)
      v = src[(size_t)(row0 + r) * h * width + c];
    dst[r * kLd + c] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(Params prm) {
  extern __shared__ __align__(16) float smem[];
  const int L = prm.chunk;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int lp = n_tiles * kTile;
  float* xs = smem;                    // [lp][kLd]
  float* bs = xs + lp * kLd;           // [lp][kLd]
  float* cs = bs + lp * kLd;           // [kTile][kLd]: C rows of one tile
  float* gs = cs + kTile * kLd;        // [kTile][kLd]: (C·Bᵀ)∘decay
  float* st = gs + kTile * kLd;        // [kMaxDim][kMaxDim]: state[p][n] at st[n][p]
  float* la = st + kMaxDim * kMaxDim;  // [lp]: cumsum of dt·A in the chunk
  float* w = la + lp;                  // [lp]: exp(la_L − la_j)

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row0 = (size_t)b * prm.s;   // first token of this batch row
  const float* xg = prm.x + row0 * prm.h * prm.p + (size_t)hh * prm.p;
  const float* bg = prm.bm + row0 * prm.h * prm.n + (size_t)hh * prm.n;
  const float* cg = prm.cm + row0 * prm.h * prm.n + (size_t)hh * prm.n;
  const float* dg = prm.da + row0 * prm.h + hh;
  float* yg = prm.y + row0 * prm.h * prm.p + (size_t)hh * prm.p;
  const int n4 = (prm.n + 3) & ~3;

  for (int i = threadIdx.x; i < kMaxDim * kMaxDim; i += kThreads) st[i] = 0.f;

  for (int c0 = 0; c0 < prm.s; c0 += L) {
    __syncthreads();   // the last chunk's state update is done with xs, bs
    stage(xs, xg, prm.h, prm.p, c0, lp, L);
    stage(bs, bg, prm.h, prm.n, c0, lp, L);
    for (int i = threadIdx.x; i < lp; i += kThreads)
      la[i] = i < L ? dg[(size_t)(c0 + i) * prm.h] : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        run += la[i];
        la[i] = run;
      }
    }
    __syncthreads();
    const float la_last = la[L - 1];
    for (int i = threadIdx.x; i < lp; i += kThreads)
      w[i] = i < L ? expf(la_last - la[i]) : 0.f;

    for (int rt = 0; rt < n_tiles; ++rt) {
      const int r0 = rt * kTile;
      __syncthreads();   // the last row tile is done with cs (and w is set)
      stage(cs, cg, prm.h, prm.n, c0 + r0, kTile, L - r0);
      float y[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[i][e] = 0.f;

      for (int ct = 0; ct <= rt; ++ct) {
        const int k0 = ct * kTile;
        __syncthreads();   // cs staged; the last G tile is consumed
        // G = C·Bᵀ: query rows r0 + ty + 16 i, key rows k0 + tx + 16 j
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
        for (int c = 0; c < n4; c += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = *reinterpret_cast<const float4*>(&cs[(ty + 16 * i) * kLd + c]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = *reinterpret_cast<const float4*>(
                &bs[(k0 + tx + 16 * j) * kLd + c]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              g[i][j] = fmaf(cv[i].x, bv[j].x, g[i][j]);
              g[i][j] = fmaf(cv[i].y, bv[j].y, g[i][j]);
              g[i][j] = fmaf(cv[i].z, bv[j].z, g[i][j]);
              g[i][j] = fmaf(cv[i].w, bv[j].w, g[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ri = r0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cj = k0 + tx + 16 * j;
            gs[(ty + 16 * i) * kLd + tx + 16 * j] = (cj <= ri && ri < L)
                ? g[i][j] * expf(la[ri] - la[cj]) : 0.f;
          }
        }
        __syncthreads();
        // y += G · x: value columns tx · 4 + e
        for (int j = 0; j < kTile; j += 4) {
          float4 gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            gv[i] = *reinterpret_cast<const float4*>(&gs[(ty + 16 * i) * kLd + j]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 xv = *reinterpret_cast<const float4*>(
                &xs[(k0 + j + jj) * kLd + tx * 4]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float gij = jj == 0 ? gv[i].x : jj == 1 ? gv[i].y
                              : jj == 2 ? gv[i].z : gv[i].w;
              y[i][0] = fmaf(gij, xv.x, y[i][0]);
              y[i][1] = fmaf(gij, xv.y, y[i][1]);
              y[i][2] = fmaf(gij, xv.z, y[i][2]);
              y[i][3] = fmaf(gij, xv.w, y[i][3]);
            }
          }
        }
      }

      // y += (C · stateᵀ) ∘ exp(la), the state from before this chunk
      float yi[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) yi[i][e] = 0.f;
      for (int c = 0; c < n4; c += 4) {
        float4 cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(&cs[(ty + 16 * i) * kLd + c]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 sv = *reinterpret_cast<const float4*>(
              &st[(c + cc) * kMaxDim + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float cic = cc == 0 ? cv[i].x : cc == 1 ? cv[i].y
                            : cc == 2 ? cv[i].z : cv[i].w;
            yi[i][0] = fmaf(cic, sv.x, yi[i][0]);
            yi[i][1] = fmaf(cic, sv.y, yi[i][1]);
            yi[i][2] = fmaf(cic, sv.z, yi[i][2]);
            yi[i][3] = fmaf(cic, sv.w, yi[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = r0 + ty + 16 * i;
        if (ri >= L) continue;
        const float scale = expf(la[ri]);
        float* yrow = yg + (size_t)(c0 + ri) * prm.h * prm.p;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = tx * 4 + e;
          if (col < prm.p) yrow[col] = y[i][e] + yi[i][e] * scale;
        }
      }
    }

    // state[p][n] = state[p][n]·exp(la_L) + Σ_j (x[j][p]·w[j])·B[j][n]:
    // rows p = ty + 16 i, columns n = tx · 4 + e
    __syncthreads();   // every row tile has read the old state
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[i][e] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(&bs[j * kLd + tx * 4]);
      const float wj = w[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xw = xs[j * kLd + ty + 16 * i] * wj;
        ds[i][0] = fmaf(xw, bv.x, ds[i][0]);
        ds[i][1] = fmaf(xw, bv.y, ds[i][1]);
        ds[i][2] = fmaf(xw, bv.z, ds[i][2]);
        ds[i][3] = fmaf(xw, bv.w, ds[i][3]);
      }
    }
    const float keep = expf(la_last);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* cell = &st[(tx * 4 + e) * kMaxDim + ty + 16 * i];
        *cell = *cell * keep + ds[i][e];
      }
  }
}

}  // namespace

// xdt[B, S, H, P], da[B, S, H], bm/cm[B, S, H, N] → y[B, S, H, P], all
// f32 and contiguous; P, N <= 64, chunk <= 256 dividing S.
extern "C" int repro_mamba2_ssd_f32(const void* xdt, const void* da,
                                    const void* bm, const void* cm, void* y,
                                    int batch, int s, int h, int p, int n,
                                    int chunk, void* stream) {
  if (p < 1 || p > kMaxDim || n < 1 || n > kMaxDim || chunk < 1 ||
      chunk > kMaxChunk || s % chunk)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || s == 0 || h == 0) return (int)cudaSuccess;
  const int lp = (chunk + kTile - 1) / kTile * kTile;
  const size_t bytes = sizeof(float) *
      ((size_t)2 * lp * kLd + 2 * kTile * kLd + kMaxDim * kMaxDim + 2 * lp);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const Params prm = {(const float*)xdt, (const float*)da, (const float*)bm,
                      (const float*)cm, (float*)y, s, h, p, n, chunk};
  ssd_kernel<<<dim3(h, batch), kThreads, bytes, (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}
