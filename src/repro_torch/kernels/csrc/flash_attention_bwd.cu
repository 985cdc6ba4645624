// The gradient of flash_attention.cu's function for sm_90a: dq, dk and dv
// of softmax attention with scale, tanh logit soft-capping, causal and
// sliding-window masks, GQA (kv head h / G), Dk != Dv and Sq != Skv, f32
// or bf16 operands.
//
// Replaces: nothing on the TPU.  The reference trains through
// jax.value_and_grad of its jnp attention (src/repro/models/layers.py::
// blockwise_attention); its Pallas kernel (kernels/flash_attention.py::
// _flash_kernel) has no backward.  The port runs its attention through
// the hand forward kernel, so the gradient needs a hand kernel too.
//
// The function.  With s = c·tanh(scale·q·k / c) (or scale·q·k without a
// cap), P = exp(s - lse) on the visible pairs (the forward's mask) and
// lse the forward's log-sum-exp of each query row:
//   dV_j = Σ_i P_ij dO_i,   dP_ij = dO_i · V_j,   Δ_i = Σ_j P_ij dP_ij,
//   dS_ij = P_ij (dP_ij - Δ_i) (1 - (s_ij / c)²),
//   dQ_i = scale Σ_j dS_ij K_j,   dK_j = scale Σ_i dS_ij Q_i,
// dK and dV summed over the G query heads that read kv head j's head.
//
// What bounds it on an H100: the five products (Q·Kᵀ, dO·Vᵀ, Pᵀ·dO,
// dSᵀ·Q, dS·K), 2·(3·D + 2·Dv) operations per visible pair, 2.5× the
// forward's 2·(D + Dv) at D = Dv, against every byte of q, k, v, o, dO,
// lse, dq, dk, dv once: at gemma2-9b's widths (D = 256, S = 4096)
// thousands of operations per byte, so the tensor cores' 989 TFLOP/s
// bound it in bf16 and the 67 TFLOP/s of FMA in f32.
//
// What the design does about it.  No atomics, so the result does not
// depend on the order blocks run in: every output element is owned by
// one block, which sums its terms in a fixed order.  Four launches:
//   (Δ) one block per (batch, q head, query tile): for each key tile the
//       rows can see, recompute S = Q·Kᵀ and dP = dO·Vᵀ and sum P∘dP;
//   (dQ) the same blocks recompute them again, form dS, and accumulate
//        dS·K;
//   (dK) one block per (batch, kv head, key tile): for each of the G
//        query heads and each query tile that sees the keys, recompute
//        Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, and accumulate dSᵀ·Q;
//   (dV) the same blocks, recomputing Sᵀ only, accumulate Pᵀ·dO.
// Δ is the row sum of the kernel's own f32 P∘dP, not rowsum(dO∘O) of the
// bf16 output: the vjp's dS rows sum to zero only against the P they
// were formed with, and Δ from O rounded to bf16 leaves an error of ~2⁻⁹
// |dO||O| in every dS_ij, which in rows where dS nearly cancels (a
// query with one or two keys it attends to) is several times the
// gradient itself (PERF.md).  dK and dV run apart because at D = 256 one
// 16-row accumulator of 256 columns already holds 128 f32 registers a
// thread; both together would spill.  So the backward runs ten products
// where FlashAttention-2 (with atomics for dQ) runs five.  The four
// passes are one template: a row tile (the rows the block owns), column
// tiles streamed past it, a weight matrix W (P∘dP, dS or P) formed from
// the recomputed scores, and then Δ = rowsum(W) or acc += W · X with X
// the column tile's K, Q or dO.
//
// bf16 (the trained path), on the tensor cores: 64-row row tiles, four
// warps of 16 rows each, 32-row column tiles staged by 16-byte cp.async
// into a two-stage ring (tile t + 1 loads while tile t is computed).
// The products are mma.sync.m16n8k16 (bf16 operands, f32 accumulation)
// fed by ldmatrix, in the forward's layouts: S and dP as its Q·Kᵀ, acc +=
// W·X as its P·V, with W (rounded to bf16) taken straight from the score
// fragment, whose C layout is the A layout of one k16 step.  Rows are
// padded by 16 bytes in shared memory (the 8 rows an ldmatrix reads fall
// on distinct bank groups).  At D = Dv = 256 the tiles take 136 KB.
//
// f32 (the check path) on FMA from shared memory: 32-row row tiles and
// 32-row column tiles, 256 threads, each computing 2 × 2 scores and 2
// rows × 4 columns of each 64-column group of the accumulator, W staged
// through shared memory.
//
// The probabilities are recomputed exactly as the forward computed them:
// the same scale, the same softcap form (in bf16 c·(1 - 2/(1 + e^{2u})),
// one ex2 and one rcp.approx; in f32 tanhf), the same mask, and P =
// exp(s - lse) in place of the online softmax, zero on masked pairs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

enum Mode { kDelta = 0, kDQ = 1, kDK = 2, kDV = 3 };

// The Δ and dQ passes own query rows and stream keys; dK and dV the
// reverse.
__host__ __device__ constexpr bool row_is_query(int mode) {
  return mode == kDelta || mode == kDQ;
}

struct Params {
  const void* q;      // [B, Sq, Hq, D]
  const void* k;      // [B, Skv, Hkv, D]
  const void* v;      // [B, Skv, Hkv, Dv]
  const void* dout;   // [B, Sq, Hq, Dv]
  const float* lse;   // [B, Hq, Sq]
  float* delta;       // [B, Hq, Sq], written by the Δ pass
  void* gq;           // dq [B, Sq, Hq, D]
  void* gk;           // dk [B, Skv, Hkv, D]
  void* gv;           // dv [B, Skv, Hkv, Dv]
  int batch, sq, skv, hq, hkv, d, dv;
  float scale;
  float softcap;      // 0: none
  int causal;
  int window;         // < 0: none
};


// Whether query qpos sees key kpos (the forward's mask, and both in range).
__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool keep = qpos < p.sq && kpos < p.skv;
  if (p.causal) keep = keep && qpos >= kpos;
  if (p.window >= 0) keep = keep && qpos - kpos < p.window;
  return keep;
}

// The keys query rows [first, last] can see: [*lo, *hi) (the forward's
// kv_tiles before rounding).
__device__ __forceinline__ void keys_seen(const Params& p, int first,
                                          int last, int* lo, int* hi) {
  *lo = p.window >= 0 ? max(0, first - p.window + 1) : 0;
  *hi = !p.causal ? p.skv : p.window == 0 ? 0 : min(p.skv, last + 1);
}

// The queries that see a key of rows [first, last]: [*lo, *hi).
__device__ __forceinline__ void queries_seeing(const Params& p, int first,
                                               int last, int* lo, int* hi) {
  *lo = p.causal ? first : 0;
  *hi = p.window >= 0 ? min(p.sq, last + p.window) : p.sq;
  if (p.causal && p.window == 0) *hi = *lo;
}

// The column tiles a row tile [r0, r0 + rows) meets, in units of `tile`
// rows: [*t_lo, *t_hi) per head, over `heads` heads (the G query heads of
// a kv head in the dK/dV passes, the one kv head in the Δ and dQ passes).
template <int MODE>
__device__ __forceinline__ void column_tiles(const Params& p, int r0,
                                             int rows, int tile, int* t_lo,
                                             int* t_hi, int* heads) {
  const int n = row_is_query(MODE) ? p.sq : p.skv;
  const int last = min(r0 + rows, n) - 1;
  int lo, hi;
  if (row_is_query(MODE))
    keys_seen(p, r0, last, &lo, &hi);
  else
    queries_seeing(p, r0, last, &lo, &hi);
  *t_lo = lo / tile;
  *t_hi = lo < hi ? (hi + tile - 1) / tile : *t_lo;
  *heads = row_is_query(MODE) ? 1 : p.hq / p.hkv;
}

// The operands of a pass for block (b, head hh, row tile): the row side
// (R_a, R_b: Q and dO in Δ and dQ, K and V in dK/dV), the column side of
// column head g (C_a, C_b: K and V in Δ and dQ, Q and dO in dK/dV) and
// the output (none in Δ).
template <typename T, int MODE>
struct Operands {
  const T *ra, *rb, *ca, *cb;
  size_t ra_stride, rb_stride, ca_stride, cb_stride;
  T* out;
  size_t out_stride;
  int dacc;             // columns of the output (D, or Dv in dV)
  const float* lse;     // [Sq] of the query head (row head in dQ)
  const float* delta;

  __device__ Operands(const Params& p, int b, int hh, int g) {
    const int G = p.hq / p.hkv;
    const int hq = row_is_query(MODE) ? hh : hh * G + g;   // the query head
    const int hk = row_is_query(MODE) ? hh / G : hh;       // the kv head
    const T* q = (const T*)p.q + ((size_t)b * p.sq * p.hq + hq) * p.d;
    const T* go = (const T*)p.dout + ((size_t)b * p.sq * p.hq + hq) * p.dv;
    const T* k = (const T*)p.k + ((size_t)b * p.skv * p.hkv + hk) * p.d;
    const T* v = (const T*)p.v + ((size_t)b * p.skv * p.hkv + hk) * p.dv;
    const size_t qs = (size_t)p.hq * p.d, os = (size_t)p.hq * p.dv;
    const size_t ks = (size_t)p.hkv * p.d, vs = (size_t)p.hkv * p.dv;
    if (row_is_query(MODE)) {
      ra = q; ra_stride = qs; rb = go; rb_stride = os;
      ca = k; ca_stride = ks; cb = v; cb_stride = vs;
      out = (T*)p.gq + ((size_t)b * p.sq * p.hq + hq) * p.d;
      out_stride = qs;
      dacc = p.d;
    } else {
      ra = k; ra_stride = ks; rb = v; rb_stride = vs;
      ca = q; ca_stride = qs; cb = go; cb_stride = os;
      if (MODE == kDK) {
        out = (T*)p.gk + ((size_t)b * p.skv * p.hkv + hk) * p.d;
        out_stride = ks;
        dacc = p.d;
      } else {
        out = (T*)p.gv + ((size_t)b * p.skv * p.hkv + hk) * p.dv;
        out_stride = vs;
        dacc = p.dv;
      }
    }
    lse = p.lse + ((size_t)b * p.hq + hq) * p.sq;
    delta = p.delta + ((size_t)b * p.hq + hq) * p.sq;
  }
};

// =========================================================================
// f32: FMA from shared memory
// =========================================================================
namespace fma_path {

constexpr int kTR = 32;        // rows a block owns
constexpr int kTC = 32;        // column rows per step
constexpr int kThreads = 256;  // 16 × 16
constexpr int kLdW = kTC + 4;
static_assert(kTR == kTC, "stage() copies kTR rows of either side");

// Stage rows [row0, row0 + kTC) (kTC == kTR) of a [*, n_cols] operand
// into `dst` (row stride `ld`), zero past the last row and past n_cols up
// to `width`.
__device__ void stage(float* dst, int ld, int width, const float* src,
                      size_t stride, int row0, int n_rows, int n_cols) {
  for (int i = threadIdx.x; i < kTR * width; i += kThreads) {
    const int r = i / width;
    const int c = i - r * width;
    float x = 0.f;
    if (row0 + r < n_rows && c < n_cols)
      x = src[(size_t)(row0 + r) * stride + c];
    dst[r * ld + c] = x;
  }
}

// NG: groups of 64 accumulator columns (dacc <= 64 · NG); wa, wb: staged
// widths (64-multiples) of the D and Dv operands, lda = wa + 4, ldb =
// wb + 4 (odd multiples of 4 floats: the rows a quarter-warp reads as
// float4 fall on distinct banks)
template <int MODE, int NG>
__global__ void __launch_bounds__(kThreads, 1)
bwd_kernel(Params p, int wa, int wb) {
  extern __shared__ __align__(16) float smem[];
  const int lda = wa + 4, ldb = wb + 4;
  float* ra = smem;                  // [kTR][lda]
  float* rb = ra + kTR * lda;        // [kTR][ldb]
  float* ca = rb + kTR * ldb;        // [kTC][lda]
  float* cb = ca + kTC * lda;        // [kTC][ldb]
  float* ws = cb + kTC * ldb;        // [kTR][kLdW]
  float* lse_s = ws + kTR * kLdW;    // [kTC]
  float* dl_s = lse_s + kTC;         // [kTC]
  constexpr bool kRowQ = row_is_query(MODE);
  constexpr bool kNeedDP = MODE != kDV;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int hh = blockIdx.x;
  const int r0 = blockIdx.y * kTR;
  const int b = blockIdx.z;
  const int n_rows = kRowQ ? p.sq : p.skv;
  const int n_cols = kRowQ ? p.skv : p.sq;
  const int d4 = (p.d + 3) & ~3, dv4 = (p.dv + 3) & ~3;

  const Operands<float, MODE> rop(p, b, hh, 0);
  stage(ra, lda, wa, rop.ra, rop.ra_stride, r0, n_rows, p.d);
  if (kNeedDP) stage(rb, ldb, wb, rop.rb, rop.rb_stride, r0, n_rows, p.dv);

  // the Δ and dQ passes' rows are queries: their lse (and Δ) stay in
  // registers; the Δ pass sums its rows' P∘dP there
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  if (kRowQ) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + ty + 16 * i;
      if (row < p.sq) {
        lse_r[i] = rop.lse[row];
        if (MODE == kDQ) dl_r[i] = rop.delta[row];
      }
    }
  }

  float acc[2][NG][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;

  int t_lo, t_hi, heads;
  column_tiles<MODE>(p, r0, kTR, kTC, &t_lo, &t_hi, &heads);
  const int n_tiles = t_hi - t_lo;
  for (int it = 0; it < heads * n_tiles; ++it) {
    const int g = it / n_tiles;
    const int c0 = (t_lo + it % n_tiles) * kTC;
    const Operands<float, MODE> cop(p, b, hh, g);
    __syncthreads();   // the last step is done with ca, cb and ws
    stage(ca, lda, wa, cop.ca, cop.ca_stride, c0, n_cols, p.d);
    stage(cb, ldb, wb, cop.cb, cop.cb_stride, c0, n_cols, p.dv);
    if (!kRowQ && threadIdx.x < kTC) {
      const int col = c0 + threadIdx.x;
      lse_s[threadIdx.x] = col < p.sq ? cop.lse[col] : 0.f;
      dl_s[threadIdx.x] = col < p.sq ? cop.delta[col] : 0.f;
    }
    __syncthreads();

    // s = R_a · C_aᵀ and dp = R_b · C_bᵀ: rows ty + 16 i, columns tx + 16 j
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int c = 0; c < d4; c += 4) {
      float4 x[2], y[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        x[i] = *reinterpret_cast<const float4*>(&ra[(ty + 16 * i) * lda + c]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        y[j] = *reinterpret_cast<const float4*>(&ca[(tx + 16 * j) * lda + c]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
          s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
          s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
          s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
        }
    }
    if (kNeedDP) {
      for (int c = 0; c < dv4; c += 4) {
        float4 x[2], y[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          x[i] = *reinterpret_cast<const float4*>(
              &rb[(ty + 16 * i) * ldb + c]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          y[j] = *reinterpret_cast<const float4*>(
              &cb[(tx + 16 * j) * ldb + c]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            dp[i][j] = fmaf(x[i].x, y[j].x, dp[i][j]);
            dp[i][j] = fmaf(x[i].y, y[j].y, dp[i][j]);
            dp[i][j] = fmaf(x[i].z, y[j].z, dp[i][j]);
            dp[i][j] = fmaf(x[i].w, y[j].w, dp[i][j]);
          }
      }
    }

    // W: P∘dP in Δ (summed into rs), dS (with the softcap factor) in dQ
    // and dK, P in dV
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r0 + ty + 16 * i, col = c0 + tx + 16 * j;
        const int qpos = kRowQ ? row : col;
        const int kpos = kRowQ ? col : row;
        float x = s[i][j] * p.scale, t = 0.f;
        if (p.softcap > 0.f) {
          t = tanhf(x / p.softcap);
          x = p.softcap * t;
        }
        const float lse = kRowQ ? lse_r[i] : lse_s[tx + 16 * j];
        const float pr = visible(p, qpos, kpos) ? expf(x - lse) : 0.f;
        float w = pr;
        if (MODE == kDelta) {
          rs[i] = fmaf(pr, dp[i][j], rs[i]);
        } else if (MODE != kDV) {
          const float dl = MODE == kDQ ? dl_r[i] : dl_s[tx + 16 * j];
          w = pr * (dp[i][j] - dl);
          if (p.softcap > 0.f) w *= 1.f - t * t;
        }
        if (MODE != kDelta) ws[(ty + 16 * i) * kLdW + tx + 16 * j] = w;
      }
    if (MODE == kDelta) continue;
    __syncthreads();

    // acc += W · X: rows ty + 16 i, columns g · 64 + tx · 4 + e
    const float* xs = MODE == kDV ? cb : ca;
    const int ldx = MODE == kDV ? ldb : lda;
    for (int j = 0; j < kTC; j += 4) {
      float4 w4[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        w4[i] = *reinterpret_cast<const float4*>(&ws[(ty + 16 * i) * kLdW + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int gg = 0; gg < NG; ++gg) {
          const float4 xv = *reinterpret_cast<const float4*>(
              &xs[(j + jj) * ldx + gg * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float wij = jj == 0 ? w4[i].x : jj == 1 ? w4[i].y
                            : jj == 2 ? w4[i].z : w4[i].w;
            acc[i][gg][0] = fmaf(wij, xv.x, acc[i][gg][0]);
            acc[i][gg][1] = fmaf(wij, xv.y, acc[i][gg][1]);
            acc[i][gg][2] = fmaf(wij, xv.z, acc[i][gg][2]);
            acc[i][gg][3] = fmaf(wij, xv.w, acc[i][gg][3]);
          }
        }
      }
    }
  }

  if (MODE == kDelta) {   // the 16 threads of a row are one half-warp
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float r = rs[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        r += __shfl_xor_sync(0xffffffffu, r, off);
      const int row = r0 + ty + 16 * i;
      if (tx == 0 && row < p.sq)
        p.delta[((size_t)b * p.hq + hh) * p.sq + row] = r;
    }
    return;
  }
  const float out_scale = MODE == kDV ? 1.f : p.scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n_rows) continue;
    float* orow = rop.out + (size_t)row * rop.out_stride;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = gg * 64 + tx * 4 + e;
        if (col < rop.dacc) orow[col] = acc[i][gg][e] * out_scale;
      }
  }
}

template <int MODE, int NG>
int launch(const Params& p, cudaStream_t stream) {
  const int wa = (p.d + 63) / 64 * 64, wb = (p.dv + 63) / 64 * 64;
  const size_t bytes = sizeof(float) *
      ((size_t)(kTR + kTC) * (wa + 4 + wb + 4) + kTR * kLdW + 2 * kTC);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<MODE, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = row_is_query(MODE) ? p.sq : p.skv;
  const dim3 grid(row_is_query(MODE) ? p.hq : p.hkv,
                  (rows + kTR - 1) / kTR, p.batch);
  bwd_kernel<MODE, NG><<<grid, kThreads, bytes, stream>>>(p, wa, wb);
  return (int)cudaGetLastError();
}

template <int MODE>
int run_mode(const Params& p, cudaStream_t s) {
  if constexpr (MODE == kDelta) {
    return launch<MODE, 1>(p, s);   // no accumulator
  } else {
    switch (((MODE == kDV ? p.dv : p.d) + 63) / 64) {
      case 1: return launch<MODE, 1>(p, s);
      case 2: return launch<MODE, 2>(p, s);
      case 3: return launch<MODE, 3>(p, s);
      default: return launch<MODE, 4>(p, s);
    }
  }
}

}  // namespace fma_path

// =========================================================================
// bf16: tensor cores (mma.sync m16n8k16)
// =========================================================================
namespace mma_path {

constexpr int kTR = 64;         // rows a block owns
constexpr int kWarps = kTR / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTC = 32;         // column rows per step

struct Shape {
  int d16, dv16;     // D and Dv rounded up to 16
  int lda, ldb;      // shared row strides (elements) of the D and Dv operands
  int vec;           // 16-byte cp.async staging (else element by element)
  float scale_l;     // scale · log2 e
  float cap_k;       // 2 · log2 e · scale / softcap
  float cap_l;       // softcap · log2 e
  float inv_cap_l;   // 1 / cap_l
};

// Stage rows [row0, row0 + rows) of a [*, n_cols] bf16 operand (row
// stride `stride` elements) into `dst` (row stride `ld`), zero past the
// last row and from n_cols up to `width` (a multiple of 16): 16-byte
// cp.async copies when `vec` (returning before they land), else element
// by element.
__device__ __forceinline__ void stage(bf16* dst, int ld, int width,
                                      const bf16* src, size_t stride,
                                      int row0, int rows, int n_rows,
                                      int n_cols, bool vec) {
  if (vec) {
    // thread t copies the 16-byte chunk t % 32 (width <= 256) of rows
    // t / 32 + kWarps · j
    const int c = (threadIdx.x % 32) * 8;
    if (c >= width) return;
    const bool col_ok = c < n_cols;
    for (int r = threadIdx.x / 32; r < rows; r += kWarps) {
      const bool ok = col_ok && row0 + r < n_rows;
      const bf16* from = ok ? src + (size_t)(row0 + r) * stride + c : src;
      cp_async16(smem_addr(dst + r * ld + c), from, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += kThreads) {
      const int r = i / width;
      const int c = i - r * width;
      bf16 x = __float2bfloat16(0.f);
      if (row0 + r < n_rows && c < n_cols)
        x = src[(size_t)(row0 + r) * stride + c];
      dst[r * ld + c] = x;
    }
  }
}

// c[n] (kTC / 8 n8 tiles) = A rows (this warp's 16, from a_base) · B rowsᵀ
// (kTC of them, from b_base + b_off), over `depth16` k16 steps; ld the B
// operand's row stride in elements
__device__ __forceinline__ void scores(float (&c)[kTC / 8][4],
                                       uint32_t a_base, uint32_t b_base,
                                       int ld, int depth16) {
#pragma unroll
  for (int n = 0; n < kTC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  for (int kk = 0; kk < depth16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a_base + kk * 32, a);
#pragma unroll
    for (int np = 0; np < kTC / 16; ++np) {
      uint32_t bq[4];
      ldsm_x4(b_base + (np * 16 * ld + kk * 16) * 2, bq);
      mma16816(c[2 * np], a, bq[0], bq[1]);
      mma16816(c[2 * np + 1], a, bq[2], bq[3]);
    }
  }
}

// NV: n8 tiles of the accumulator (8 · NV >= its width rounded up to 16)
template <int MODE, int NV>
__global__ void __launch_bounds__(kThreads, 1)
bwd_mma_kernel(Params p, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ra = reinterpret_cast<bf16*>(smem_raw);  // [kTR][lda]
  bf16* rb = ra + kTR * sh.lda;                  // [kTR][ldb]
  bf16* ca = rb + kTR * sh.ldb;                  // [2][kTC][lda]
  bf16* cb = ca + 2 * kTC * sh.lda;              // [2][kTC][ldb]
  float* lse_s = reinterpret_cast<float*>(cb + 2 * kTC * sh.ldb);  // [2][kTC]
  float* dl_s = lse_s + 2 * kTC;                                   // [2][kTC]
  constexpr bool kRowQ = row_is_query(MODE);
  constexpr bool kNeedDP = MODE != kDV;

  const int hh = blockIdx.x;
  const int r0 = blockIdx.y * kTR;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_rows = kRowQ ? p.sq : p.skv;
  const int n_cols = kRowQ ? p.skv : p.sq;
  const bool vec = sh.vec != 0;

  const Operands<bf16, MODE> rop(p, b, hh, 0);
  stage(ra, sh.lda, sh.d16, rop.ra, rop.ra_stride, r0, kTR, n_rows, p.d, vec);
  if (kNeedDP)
    stage(rb, sh.ldb, sh.dv16, rop.rb, rop.rb_stride, r0, kTR, n_rows, p.dv,
          vec);

  int t_lo, t_hi, heads;
  column_tiles<MODE>(p, r0, kTR, kTC, &t_lo, &t_hi, &heads);
  const int n_tiles = t_hi - t_lo;
  const int total = heads * n_tiles;

  // stage column step `it` into ring slot `st`
  auto stage_cols = [&](int it, int st) {
    const int g = it / n_tiles;
    const int c0 = (t_lo + it % n_tiles) * kTC;
    const Operands<bf16, MODE> cop(p, b, hh, g);
    stage(ca + st * kTC * sh.lda, sh.lda, sh.d16, cop.ca, cop.ca_stride, c0,
          kTC, n_cols, p.d, vec);
    stage(cb + st * kTC * sh.ldb, sh.ldb, sh.dv16, cop.cb, cop.cb_stride, c0,
          kTC, n_cols, p.dv, vec);
    if (!kRowQ && threadIdx.x < kTC) {
      const int col = c0 + threadIdx.x;
      lse_s[st * kTC + threadIdx.x] =
          col < p.sq ? cop.lse[col] * kLog2e : 0.f;
      dl_s[st * kTC + threadIdx.x] = col < p.sq ? cop.delta[col] : 0.f;
    }
  };
  if (total > 0) stage_cols(0, 0);
  cp_async_commit();

  // the two rows this thread's fragments hold, and (Δ, dQ) their lse
  // (and Δ); the Δ pass sums its rows' P∘dP in rs
  const int row_a = r0 + warp * 16 + lane / 4;
  const int col_t = 2 * (lane % 4);
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  if (kRowQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row < p.sq) {
        lse_r[r] = rop.lse[row] * kLog2e;
        if (MODE == kDQ) dl_r[r] = rop.delta[row];
      }
    }
  }

  // per-lane ldmatrix offsets (elements), the forward's: the row tile as
  // the A operand, a column tile as two n8 B tiles, X transposed
  const uint32_t ra_base = smem_addr(
      ra + (warp * 16 + lane % 16) * sh.lda + (lane / 16) * 8);
  const uint32_t rb_base = smem_addr(
      rb + (warp * 16 + lane % 16) * sh.ldb + (lane / 16) * 8);
  const int ca_off = (lane % 8 + (lane / 16) * 8) * sh.lda + ((lane / 8) % 2) * 8;
  const int cb_off = (lane % 8 + (lane / 16) * 8) * sh.ldb + ((lane / 8) % 2) * 8;
  const int ldx = MODE == kDV ? sh.ldb : sh.lda;
  const int x16 = MODE == kDV ? sh.dv16 : sh.d16;
  const int x_off = (lane % 8 + ((lane / 8) % 2) * 8) * ldx + (lane / 16) * 8;

  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    cp_async_wait_all();   // step it landed, for this thread's copies
    __syncthreads();       // ... for every thread's; step it - 1 is consumed
    if (it + 1 < total) stage_cols(it + 1, st ^ 1);
    cp_async_commit();
    const int c0 = (t_lo + it % n_tiles) * kTC;

    float s[kTC / 8][4], dp[kTC / 8][4];
    scores(s, ra_base, smem_addr(ca + st * kTC * sh.lda + ca_off), sh.lda,
           sh.d16 / 16);
    if (kNeedDP)
      scores(dp, rb_base, smem_addr(cb + st * kTC * sh.ldb + cb_off), sh.ldb,
             sh.dv16 / 16);

    // W in place of s: P∘dP in Δ (summed into rs), dS (with the softcap
    // factor) in dQ and dK, P in dV
#pragma unroll
    for (int n = 0; n < kTC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + 8 * (e / 2);
        const int cl = n * 8 + col_t + (e & 1);   // column within the tile
        const int qpos = kRowQ ? row : c0 + cl;
        const int kpos = kRowQ ? c0 + cl : row;
        float x = s[n][e], t = 0.f;
        if (p.softcap > 0.f) {
          x = fmaf(-2.f * sh.cap_l, rcp(1.f + ex2(x * sh.cap_k)), sh.cap_l);
          t = x * sh.inv_cap_l;
        } else {
          x *= sh.scale_l;
        }
        const float lse = kRowQ ? lse_r[e / 2] : lse_s[st * kTC + cl];
        const float pr = visible(p, qpos, kpos) ? ex2(x - lse) : 0.f;
        float w = pr;
        if (MODE == kDelta) {
          rs[e / 2] = fmaf(pr, dp[n][e], rs[e / 2]);
        } else if (kNeedDP) {
          const float dl = MODE == kDQ ? dl_r[e / 2] : dl_s[st * kTC + cl];
          w = pr * (dp[n][e] - dl);
          if (p.softcap > 0.f) w *= 1.f - t * t;
        }
        s[n][e] = w;
      }
    if (MODE == kDelta) continue;

    // acc += W · X: W rounded to bf16, the score C fragments of columns
    // 16 kk .. 16 kk + 15 reused as the A fragment of one k16 step
    const bf16* xs = MODE == kDV ? cb + st * kTC * sh.ldb
                                 : ca + st * kTC * sh.lda;
    const uint32_t x_base = smem_addr(xs + x_off);
#pragma unroll
    for (int kk = 0; kk < kTC / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NV / 2; ++np) {
        if (np * 16 >= x16) break;
        uint32_t bx[4];
        ldsm_x4_trans(x_base + (kk * 16 * ldx + np * 16) * 2, bx);
        mma16816(acc[2 * np], a, bx[0], bx[1]);
        mma16816(acc[2 * np + 1], a, bx[2], bx[3]);
      }
    }
  }
  cp_async_wait_all();   // nothing in flight when the block exits

  if (MODE == kDelta) {   // the 4 threads of a row are adjacent lanes
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = rs[r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const int row = row_a + 8 * r;
      if (lane % 4 == 0 && row < p.sq)
        p.delta[((size_t)b * p.hq + hh) * p.sq + row] = x;
    }
    return;
  }
  const float out_scale = MODE == kDV ? 1.f : p.scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= n_rows) continue;
    bf16* orow = rop.out + (size_t)row * rop.out_stride;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int col = n * 8 + col_t;
      const float x0 = acc[n][2 * r] * out_scale;
      const float x1 = acc[n][2 * r + 1] * out_scale;
      if (rop.dacc % 2 == 0 && col < rop.dacc) {   // an aligned pair
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < rop.dacc) orow[col] = __float2bfloat16(x0);
        if (col + 1 < rop.dacc) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int MODE, int NV>
int launch(const Params& p, const Shape& sh, cudaStream_t stream) {
  const size_t bytes =
      sizeof(bf16) * ((size_t)(kTR + 2 * kTC) * (sh.lda + sh.ldb)) +
      sizeof(float) * 4 * kTC;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_mma_kernel<MODE, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = row_is_query(MODE) ? p.sq : p.skv;
  const dim3 grid(row_is_query(MODE) ? p.hq : p.hkv,
                  (rows + kTR - 1) / kTR, p.batch);
  bwd_mma_kernel<MODE, NV><<<grid, kThreads, bytes, stream>>>(p, sh);
  return (int)cudaGetLastError();
}

template <int MODE>
int run_mode(const Params& p, const Shape& sh, cudaStream_t s) {
  if constexpr (MODE == kDelta) {
    return launch<MODE, 8>(p, sh, s);   // no accumulator
  } else {
    switch (((MODE == kDV ? sh.dv16 : sh.d16) + 63) / 64) {
      case 1: return launch<MODE, 8>(p, sh, s);
      case 2: return launch<MODE, 16>(p, sh, s);
      case 3: return launch<MODE, 24>(p, sh, s);
      default: return launch<MODE, 32>(p, sh, s);
    }
  }
}

Shape shape_of(const Params& p) {
  Shape sh;
  sh.d16 = (p.d + 15) & ~15;
  sh.dv16 = (p.dv + 15) & ~15;
  sh.lda = sh.d16 + 8;     // + 16 bytes: an odd number of 16-byte units
  sh.ldb = sh.dv16 + 8;
  const uintptr_t addr = (uintptr_t)p.q | (uintptr_t)p.k | (uintptr_t)p.v |
                         (uintptr_t)p.dout;
  sh.vec = p.d % 8 == 0 && p.dv % 8 == 0 && addr % 16 == 0;
  sh.scale_l = p.scale * kLog2e;
  sh.cap_k = p.softcap > 0.f ? 2.f * kLog2e * p.scale / p.softcap : 0.f;
  sh.cap_l = p.softcap * kLog2e;
  sh.inv_cap_l = p.softcap > 0.f ? 1.f / sh.cap_l : 0.f;
  return sh;
}

}  // namespace mma_path

int check(const Params& p) {
  if (p.d < 1 || p.d > 256 || p.dv < 1 || p.dv > 256 || p.hkv < 1 ||
      p.hq % p.hkv)
    return (int)cudaErrorInvalidValue;
  return p.batch == 0 || p.sq == 0 || p.skv == 0 ? -1 : 0;
}

template <int MODE>
int run_pass(const Params& p, float, cudaStream_t s) {
  return fma_path::run_mode<MODE>(p, s);
}
template <int MODE>
int run_pass(const Params& p, bf16, cudaStream_t s) {
  return mma_path::run_mode<MODE>(p, mma_path::shape_of(p), s);
}

// The Δ, dQ, dK and dV passes, stopping at the first launch error
template <typename T>
int run(const Params& p, cudaStream_t s) {
  const int c = check(p);
  if (c != 0) return c < 0 ? (int)cudaSuccess : c;
  int err = run_pass<kDelta>(p, T(), s);
  if (err == 0) err = run_pass<kDQ>(p, T(), s);
  if (err == 0) err = run_pass<kDK>(p, T(), s);
  if (err == 0) err = run_pass<kDV>(p, T(), s);
  return err;
}

}  // namespace

// q[B, Sq, Hq, D], k[B, Skv, Hkv, D], v[B, Skv, Hkv, Dv], dout
// [B, Sq, Hq, Dv], lse [B, Hq, Sq] (the forward's), all contiguous; delta
// is f32 scratch [B, Hq, Sq]; writes dq, dk, dv in the operands' shapes
// (every element, zero where no pair is visible).  softcap 0 means none,
// window < 0 means none.  An empty problem launches nothing.
extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int batch, int sq, int skv, int hq, int hkv, int d, int dv_dim,
    float scale, float softcap, int causal, int window, void* stream) {
  const Params p = {q, k, v, dout, lse, delta, dq, dk, dv, batch, sq,
                    skv, hq, hkv, d, dv_dim, scale, softcap, causal, window};
  return run<float>(p, (cudaStream_t)stream);
}

extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int batch, int sq, int skv, int hq, int hkv, int d, int dv_dim,
    float scale, float softcap, int causal, int window, void* stream) {
  const Params p = {q, k, v, dout, lse, delta, dq, dk, dv, batch, sq,
                    skv, hq, hkv, d, dv_dim, scale, softcap, causal, window};
  return run<bf16>(p, (cudaStream_t)stream);
}
