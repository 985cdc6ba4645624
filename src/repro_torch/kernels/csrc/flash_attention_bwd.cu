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
// bound it in bf16 (0.3475 ms for its global layer, 16 / 8 heads,
// causal) and the 67 TFLOP/s of FMA in f32.
//
// What the design does about it, on both paths.  No atomics, so the
// result does not depend on the order blocks run in: every output
// element is owned by one block, which sums its terms in a fixed order,
// and two runs on the same inputs agree bit for bit.  Δ is the row sum of
// the kernel's own f32 P∘dP, not rowsum(dO∘O) of the bf16 output: the
// vjp's dS rows sum to zero only against the P they were formed with, and
// Δ from O rounded to bf16 leaves an error of ~2⁻⁹ |dO||O| in every
// dS_ij, which in rows where dS nearly cancels (a query with one or two
// keys it attends to) is several times the gradient itself (PERF.md).
// The probabilities are recomputed exactly as the forward computed them:
// the same scale, the same softcap form (in bf16 c·(1 - 2/(1 + e^{2u})),
// one ex2 and one rcp.approx; in f32 tanhf), the same mask, and P =
// exp(s - lse) in place of the online softmax, zero on masked pairs.
// Blocks visit only the column tiles their rows can see (the forward's
// mask forms: visible, keys_seen, queries_seeing, column_tiles).
//
// bf16 (the trained path), wg_path: Hopper's asynchronous tensor cores.
// Three launches, nine products:
//   (Δ) one block per (batch, q head, 64-row query tile): for each 64-row
//       key tile the rows can see, S = Q·Kᵀ and dP = dO·Vᵀ, Δ += rowsum(P∘dP);
//   (dQ) the same blocks again: S, dP, dS, and dQ += dS·K;
//   (dK+dV) one block per (batch, kv head, 64-row key tile), walking the
//       G query heads and each query tile that sees the keys: one
//       warpgroup holds the dV sum, computes Sᵀ = K·Qᵀ and adds Pᵀ·dO, the
//       other holds the dK sum, computes dPᵀ = V·dOᵀ and adds dSᵀ·Q.  With
//       one 64 × 256 f32 sum a warpgroup (128 registers a thread) dK and dV
//       fit one pass, which the mma.sync layout (one 16-row sum a warp)
//       could not.
// Every product is a warpgroup wgmma.mma_async with f32 accumulators:
// the score products (S, dP, Sᵀ, dPᵀ) m64n64k16 with both operands in
// shared memory, K-major; the sums (dS·K, Pᵀ·dO, dSᵀ·Q) m64nNk16, N = D
// or Dv rounded up to 64, with the weights as the A operand from registers — the score accumulator
// rounded to bf16 is the A fragment of one k16 step — and the column
// tile read MN-major (tnspB).  A producer warpgroup issues TMA loads (one
// 64 × 64 box per 128-byte-swizzled slab, tensor maps made on the host by
// cuTensorMapEncodeTiled; zero filled past Sq, Skv, D and Dv) of the row
// tile once and of the column tiles into a ring of kStages stages with
// full/empty mbarriers, so the next tiles land while the consumers
// compute; in the dK+dV pass it also copies the column queries' lse and
// Δ into the stage.
//
// What limits a step is the probabilities: three MUFU operations an
// element (the softcap's ex2 and rcp, then ex2(s - lse)), 64 × 64 × 3 a
// tile at 16 an SM a cycle, ~770 cycles against ~1000 for a tile's two
// score products — without the probability arithmetic the three passes
// took 1.07 ms instead of 1.51 at gemma2-9b's global layer on an H100
// (tools/oneoff_attention_bwd_probe.py).  So two
// consumer warpgroups share each pass's probabilities or overlap them
// with each other's products: in the Δ pass (and dQ at D ≤ 192) they take
// the column steps in turn; in the dK+dV pass each computes one of the two
// score products and the probabilities of half the elements, and they
// trade the halves through shared memory under named barriers.  The dQ
// pass at D = 256 runs one consumer: a 64 × 256 f32 sum with both score
// tiles needs more than the 240 registers two consumers can have (it
// spills), and splitting the pass's work between two warpgroups as the
// dK+dV pass does measured no faster in the probe calls that tried it
// (not timed in turns with this design).
//
// Shared memory (Smem::kBytes) at D = Dv = 256: the Δ and dQ passes the
// Q and dO row tiles 64 KB + two stages of K and V 128 KB = 192 KB; dK+dV
// K and V 64 KB + two stages of Q and dO 128 KB + the 24 KB exchange +
// lse/Δ 1 KB = 217 KB (one block an SM).
// At D = 129–192 the dK+dV ring has three stages and the Δ and dQ rings
// two (an even count, so that each of their consumers owns its stages:
// see bwd_wg_query_kernel); at D ≤ 128 every ring has four.
// The mbarrier waits are parity waits: a wait on parity P returns at once
// unless the barrier's current, incomplete phase has parity P, so a wait
// is exact only when the barrier is at most one phase behind the phase
// awaited.  Every waiter here has itself waited on the previous phase of
// the same barrier (the producer on each stage's empty barrier, and a
// consumer on each full barrier of a stage it owns), which makes every
// wait exact.  Blocks of the Δ and dQ
// passes run heaviest first under a causal mask (the last query tiles see
// the most keys), as the forward's.
//
// bf16 fallback, mma_path (the earlier design, kept for exactly the shapes a
// TMA tensor map cannot describe: D or Dv not a multiple of 8, or an
// operand not 16-byte aligned; run() dispatches on that and counts each
// route, repro_flash_attention_bwd_routes): four launches (Δ, dQ, dK,
// dV), 64-row row tiles of four warps of 16 rows, 32-row column tiles
// staged element by element (or by 16-byte cp.async when aligned) into a
// two-stage ring, mma.sync.m16n8k16 fed by ldmatrix, rows padded by 16
// bytes in shared memory.
//
// f32 (the check path), fma_path: FMA from shared memory, four launches
// as the fallback's, 32-row row tiles and 32-row column tiles, 256
// threads, each computing 2 × 2 scores and 2 rows × 4 columns of each
// 64-column group of the accumulator, W staged through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_sm90.cuh"

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
// bf16 fallback: tensor cores (mma.sync m16n8k16), for the shapes wg_path
// does not take
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

// =========================================================================
// bf16: warpgroup wgmma products on TMA-loaded swizzled tiles
// =========================================================================
namespace wg_path {

constexpr int kRows = 64;   // rows a block owns, and column rows per step
constexpr int kWG = 128;    // threads of a warpgroup

using mma_path::Shape;

// Whether the path takes the problem: TMA needs 16-byte aligned operands
// and row strides (D and Dv multiples of 8 bf16)
bool takes(const Params& p) {
  const uintptr_t addr = (uintptr_t)p.q | (uintptr_t)p.k | (uintptr_t)p.v |
                         (uintptr_t)p.dout;
  return p.d % 8 == 0 && p.dv % 8 == 0 && addr % 16 == 0;
}

// The dynamic shared memory of a block: the row tile's two operands, a
// ring of kStages column steps (two tiles each), in the dK+dV pass the
// warpgroups' exchange (xs, xpf, xp: 16 f32 a consumer thread each) and
// each stage's lse and Δ, then the mbarriers (the row
// tile's, kStages full, kStages empty).  A tile is NS slabs of 64 rows ×
// 128 bytes, all tiles 1024-byte aligned (the swizzle's period).
template <int NS, bool kKey>
struct Smem {
  // even in the Δ and dQ passes, whose two consumers take the column
  // steps in turn, so that steps it and it + kStages (one stage) fall to
  // one consumer
  static constexpr int kStages = NS == 4 ? 2 : NS == 3 ? (kKey ? 3 : 2) : 4;
  static constexpr int kTile = NS * kSlabBytes;
  static constexpr int kTiles = 2 + 2 * kStages;
  static constexpr int kXch = kKey ? 3 * 16 * kWG * 4 : 0;
  static constexpr int kStats = kKey ? 2 * kStages * kRows * 4 : 0;
  static constexpr int kBars = 8 * (1 + 2 * kStages);
  static constexpr size_t kBytes =
      1024 + (size_t)kTiles * kTile + kXch + kStats + kBars;

  uint32_t base;        // shared address of tile 0
  unsigned char* ptr;   // its generic address

  __device__ explicit Smem(unsigned char* raw) {
    const uint32_t a = smem_addr(raw);
    base = (a + 1023) & ~1023u;
    ptr = raw + (base - a);
  }
  // the row tile's D-wide (a) and Dv-wide (b) operands, and stage st's
  __device__ uint32_t row_a() const { return base; }
  __device__ uint32_t row_b() const { return base + kTile; }
  __device__ uint32_t col_a(int st) const {
    return base + (2 + 2 * st) * kTile;
  }
  __device__ uint32_t col_b(int st) const {
    return base + (3 + 2 * st) * kTile;
  }
  __device__ float* xch() const {
    return reinterpret_cast<float*>(ptr + kTiles * kTile);
  }
  __device__ float* lse_s(int st) const {
    return reinterpret_cast<float*>(ptr + kTiles * kTile + kXch) +
           st * kRows;
  }
  __device__ float* dl_s(int st) const {
    return lse_s(kStages + st);
  }
  // the mbarriers' shared addresses: the row tile's, stage st's full and
  // empty
  __device__ uint32_t row_full() const {
    return base + kTiles * kTile + kXch + kStats;
  }
  __device__ uint32_t full(int st) const { return row_full() + 8 + 8 * st; }
  __device__ uint32_t empty(int st) const {
    return row_full() + 8 * (1 + kStages + st);
  }
};

// Zero the slabs past D (a tiles) and Dv (b tiles), which no load writes
// and the products read, and make that visible to wgmma; initialise the
// barriers (row tile 1 arrival, full `full_count`, empty `empty_count`).
template <int NS, bool kKey>
__device__ void setup(const Smem<NS, kKey>& sm, int na, int nb,
                      unsigned full_count, unsigned empty_count) {
  using SM = Smem<NS, kKey>;
  for (int t = 0; t < SM::kTiles; ++t) {
    const int n = t % 2 ? nb : na;
    uint4* z = reinterpret_cast<uint4*>(sm.ptr + t * SM::kTile +
                                        n * kSlabBytes);
    for (int i = threadIdx.x; i < (NS - n) * kSlabBytes / 16;
         i += blockDim.x)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  if (threadIdx.x == 0) {
    mbar_init(sm.row_full(), 1);
    for (int s = 0; s < SM::kStages; ++s) {
      mbar_init(sm.full(s), full_count);
      mbar_init(sm.empty(s), empty_count);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// Load one 64-row tile (n slabs) of operand `map` at rows `r0` of head
// `h`, batch `b`, into shared `dst`, completing on `bar`
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int n, int h, int r0,
                                          int b) {
  for (int s = 0; s < n; ++s)
    tma_load_4d(dst + s * kSlabBytes, map, bar, 64 * s, h, r0, b);
}

// The probability of raw score x (q·k) in base 2, the forward's form; *t
// the tanh of the capped score (0 without a cap)
__device__ __forceinline__ float prob(const Params& p, const Shape& sh,
                                      float x, float lse_l, bool vis,
                                      float* t) {
  if (p.softcap > 0.f) {
    x = fmaf(-2.f * sh.cap_l, rcp(1.f + ex2(x * sh.cap_k)), sh.cap_l);
    *t = x * sh.inv_cap_l;
  } else {
    x *= sh.scale_l;
    *t = 0.f;
  }
  return vis ? ex2(x - lse_l) : 0.f;
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// Store a 64 × 64·NS f32 sum (the m64nN accumulator layout: this thread's
// rows row0 and row0 + 8, column pairs 8·j + col_t) times `scale` as bf16
// rows of `out` (row stride `stride`), rows < n_rows, columns < width
// (a multiple of 8)
template <int NS>
__device__ __forceinline__ void store_rows(const float (&acc)[32 * NS],
                                           bf16* out, size_t stride,
                                           int row0, int col_t, int n_rows,
                                           int width, float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n_rows) continue;
    bf16* orow = out + (size_t)row * stride;
#pragma unroll
    for (int j = 0; j < 8 * NS; ++j) {
      const int col = 8 * j + col_t;
      if (col < width)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                  acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// The Δ (MODE kDelta) and dQ (kDQ) passes: one block per (q head, query
// tile, batch); warpgroup 0 is the producer (one thread issues the loads),
// the others consume.  With two consumers (query_consumers) they take the
// column steps in turn (even, odd), each summing its own part of the
// rows' Δ or dQ, so one warpgroup's probabilities (three MUFU operations
// an element) run while the other's products are on the tensor cores; at
// the end warpgroup 2 hands its sum to warpgroup 1 through the row tiles'
// shared memory (named barriers 1 and 2), which adds it and stores — a
// fixed order, the same result run to run.  Two consumers need
// setmaxnreg (24 registers for the producer, 240 for each consumer); at
// D = 256 the dQ pass's consumer (its 64 × 256 f32 sum, the 64 × 64 S and
// dP tiles and their weights) needs more than 240 and spills, so that one
// instance runs a single consumer with up to 255 registers.
constexpr int kQueryProducerRegs = 24, kQueryConsumerRegs = 240;

template <int MODE, int NS>
__host__ __device__ constexpr int query_consumers() {
  return MODE == kDQ && NS == 4 ? 1 : 2;
}

template <int MODE, int NS>
__global__ void __launch_bounds__((1 + query_consumers<MODE, NS>()) * kWG, 1)
bwd_wg_query_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mo, Params p,
                    Shape sh) {
  using SM = Smem<NS, false>;
  constexpr int S = SM::kStages;
  constexpr int kCons = query_consumers<MODE, NS>();
  // Consumer c waits on full(st) of step it after its own wait on step
  // it - S of the same stage (it - S ≡ it mod 2 with S even), so the
  // barrier is never two phases behind: with S odd a stage alternates
  // between the consumers, and a consumer could wait while the stage is
  // still in the other's earlier phase, of the other parity, and pass at
  // once onto a tile still being written.
  static_assert(kCons == 1 || S % 2 == 0,
                "two consumers in turn need an even number of stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SM sm(smem_raw);
  const int na = (p.d + 63) / 64, nb = (p.dv + 63) / 64;
  const unsigned tile_bytes = (na + nb) * kSlabBytes;
  const uint32_t row_full = sm.row_full();

  const int hh = blockIdx.x;
  const int r0 = (p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int b = blockIdx.z;
  const int hk = hh / (p.hq / p.hkv);
  int t_lo, t_hi, heads;
  column_tiles<kDQ>(p, r0, kRows, kRows, &t_lo, &t_hi, &heads);
  const int total = t_hi - t_lo;

  // empty: the one warpgroup that consumed the step
  setup(sm, na, nb, 1, kWG);

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {   // the producer warpgroup
    if constexpr (kCons == 2) setmaxnreg_dec<kQueryProducerRegs>();
    if (threadIdx.x != 0) return;
    mbar_arrive_expect_tx(row_full, tile_bytes);
    load_tile(sm.row_a(), &mq, row_full, na, hh, r0, b);
    load_tile(sm.row_b(), &mo, row_full, nb, hh, r0, b);
    for (int it = 0; it < total; ++it) {
      const int st = it % S;
      mbar_wait(sm.empty(st), ((it / S) & 1) ^ 1);
      const int c0 = (t_lo + it) * kRows;
      mbar_arrive_expect_tx(sm.full(st), tile_bytes);
      load_tile(sm.col_a(st), &mk, sm.full(st), na, hk, c0, b);
      load_tile(sm.col_b(st), &mv, sm.full(st), nb, hk, c0, b);
    }
    return;
  }
  if constexpr (kCons == 2) setmaxnreg_inc<kQueryConsumerRegs>();

  // a consumer: this thread's rows row0 and row0 + 8, and their lse (and
  // Δ); the Δ pass sums its rows' P∘dP in rs
  const int second = wg - 1;   // 0: the even column steps, 1: the odd
  const int tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = r0 + warp * 16 + lane / 4;
  const int col_t = 2 * (lane % 4);
  const size_t stat0 = ((size_t)b * p.hq + hh) * p.sq;
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < p.sq) {
      lse_r[r] = p.lse[stat0 + row] * kLog2e;
      if (MODE == kDQ) dl_r[r] = p.delta[stat0 + row];
    }
  }
  float acc[32 * NS];
  zero(acc);

  mbar_wait(row_full, 0);
  for (int it = second; it < total; it += kCons) {
    const int st = it % S;
    mbar_wait(sm.full(st), (it / S) & 1);
    const int c0 = (t_lo + it) * kRows;
    float s[32], dp[32];   // the first k step overwrites (scale-d 0)
    wg_fence();
    product_ss<NS>(s, sm.row_a(), sm.col_a(st));    // Q·Kᵀ
    product_ss<NS>(dp, sm.row_b(), sm.col_b(st));   // dO·Vᵀ
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // W in place of s: P∘dP in Δ (summed into rs), dS (with the softcap
    // factor) in dQ
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const int col = c0 + (i / 4) * 8 + col_t + (i % 2);
      float t;
      const float pr =
          prob(p, sh, s[i], lse_r[r], visible(p, row0 + 8 * r, col), &t);
      if (MODE == kDelta) {
        rs[r] = fmaf(pr, dp[i], rs[r]);
      } else {
        float w = pr * (dp[i] - dl_r[r]);
        if (p.softcap > 0.f) w *= 1.f - t * t;
        s[i] = w;
      }
    }
    if (MODE == kDQ) {   // dQ += dS · K
      uint32_t w[16];
      pack_weights(s, w);
      reg_fence(acc);
      wg_fence();
      product_rs<NS>(acc, w, sm.col_a(st));
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
    }
    mbar_arrive(sm.empty(st));
  }
  if (MODE == kDelta) {   // the 4 threads of a row are adjacent lanes
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    }
  }

  if constexpr (kCons == 2) {
    // warpgroup 2's sum to warpgroup 1, through the row tiles (2 × NS
    // slabs = 64 × 64·NS f32), once both are done with every tile
    bar_sync(1, 2 * kWG);
    float* part = reinterpret_cast<float*>(sm.ptr);
    if (second) {
      fence_proxy_async();   // the async proxy (TMA, wgmma) is done here
      if (MODE == kDelta) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (lane % 4 == 0) part[warp * 16 + lane / 4 + 8 * r] = rs[r];
      } else {
#pragma unroll
        for (int i = 0; i < 32 * NS; ++i) part[i * kWG + tid] = acc[i];
      }
    }
    bar_sync(2, 2 * kWG);
    if (second) return;
    if (MODE == kDelta) {
#pragma unroll
      for (int r = 0; r < 2; ++r) rs[r] += part[warp * 16 + lane / 4 + 8 * r];
    } else {
#pragma unroll
      for (int i = 0; i < 32 * NS; ++i) acc[i] += part[i * kWG + tid];
    }
  }

  if (MODE == kDelta) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (lane % 4 == 0 && row < p.sq) p.delta[stat0 + row] = rs[r];
    }
  } else {
    store_rows<NS>(acc, (bf16*)p.gq + ((size_t)b * p.sq * p.hq + hh) * p.d,
                   (size_t)p.hq * p.d, row0, col_t, p.sq, p.d, p.scale);
  }
}

// The fused dK + dV pass: one block per (kv head, key tile, batch) of
// three warpgroups — 0 the producer (its warp 0 loads; 40 registers a
// thread), 1 holds dV, 2 holds dK (232 each: a 64 × 256 f32 sum is 128).
// Named barriers hand the exchange areas over: 1 xs written, 2 xpf
// written, 3 xp written (by the dK warpgroup), 4 xs and xpf read (by the
// dK warpgroup), 5 xp read.  Both consumers run one instruction stream
// for their products, the operands picked by warpgroup, so no product
// is in a divergent branch.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int NS>
__global__ void __launch_bounds__(3 * kWG, 1)
bwd_wg_key_kernel(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mo, Params p,
                  Shape sh) {
  using SM = Smem<NS, true>;
  constexpr int S = SM::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SM sm(smem_raw);
  const int na = (p.d + 63) / 64, nb = (p.dv + 63) / 64;
  const unsigned tile_bytes = (na + nb) * kSlabBytes;
  const uint32_t row_full = sm.row_full();

  const int hk = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int G = p.hq / p.hkv;
  int t_lo, t_hi, heads;
  column_tiles<kDK>(p, k0, kRows, kRows, &t_lo, &t_hi, &heads);
  const int n_tiles = t_hi - t_lo;
  const int total = heads * n_tiles;

  // full: the loader's arrival with the expected bytes, then the 32
  // lanes' after they stage the lse and Δ
  setup(sm, na, nb, 33, 2 * kWG);

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {   // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_arrive_expect_tx(row_full, tile_bytes);
      load_tile(sm.row_a(), &mk, row_full, na, hk, k0, b);
      load_tile(sm.row_b(), &mv, row_full, nb, hk, k0, b);
    }
    for (int it = 0; it < total; ++it) {
      const int st = it % S;
      mbar_wait(sm.empty(st), ((it / S) & 1) ^ 1);
      const int hq = hk * G + it / n_tiles;
      const int c0 = (t_lo + it % n_tiles) * kRows;
      if (lane == 0) {
        mbar_arrive_expect_tx(sm.full(st), tile_bytes);
        load_tile(sm.col_a(st), &mq, sm.full(st), na, hq, c0, b);
        load_tile(sm.col_b(st), &mo, sm.full(st), nb, hq, c0, b);
      }
      const size_t stat0 = ((size_t)b * p.hq + hq) * p.sq;
      for (int j = lane; j < kRows; j += 32) {
        const int col = c0 + j;
        sm.lse_s(st)[j] = col < p.sq ? p.lse[stat0 + col] * kLog2e : 0.f;
        sm.dl_s(st)[j] = col < p.sq ? p.delta[stat0 + col] : 0.f;
      }
      mbar_arrive(sm.full(st));
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // the consumers: this thread's keys row0 and row0 + 8 of the 64 × 64
  // transposed score tiles, their query columns c0 + 8·j + col_t (+ 1)
  const bool is_dv = wg == 1;
  const int tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = k0 + warp * 16 + lane / 4;
  const int col_t = 2 * (lane % 4);
  // the exchange: xs [16][kWG] (Sᵀ of elements 16..31, dV's warpgroup to
  // dK's), xpf [16][kWG] (P·(1 - t²) of elements 0..15, the same way), xp
  // [16][kWG] (P of elements 16..31, back); each thread's own fragment
  // positions, so the accesses of a warp are consecutive
  float* xs = sm.xch();
  float* xpf = xs + 16 * kWG;
  float* xp = xpf + 16 * kWG;
  float acc[32 * NS];
  zero(acc);

  mbar_wait(row_full, 0);
  for (int it = 0; it < total; ++it) {
    const int st = it % S;
    mbar_wait(sm.full(st), (it / S) & 1);
    const int c0 = (t_lo + it % n_tiles) * kRows;
    // Sᵀ = K·Qᵀ (dV's warpgroup) or dPᵀ = V·dOᵀ (dK's)
    float s[32];   // the first k step overwrites (scale-d 0)
    wg_fence();
    product_ss<NS>(s, is_dv ? sm.row_a() : sm.row_b(),
                   is_dv ? sm.col_a(st) : sm.col_b(st));
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    // Pᵀ from Sᵀ, each warpgroup the probabilities (three MUFU operations
    // an element) of half the tile's elements: the dV warpgroup i < 16,
    // the dK warpgroup i ≥ 16 from Sᵀ handed over in xs.  Then dV's
    // warpgroup takes the other half of Pᵀ (xp), dK's the other half of
    // P·(1 - t²) (xpf), and dSᵀ = P·(1 - t²)·(dPᵀ - Δ)
    const float* lse_s = sm.lse_s(st);
    if (is_dv) {
      if (it > 0) bar_sync(4, 2 * kWG);
#pragma unroll
      for (int i = 16; i < 32; ++i) xs[(i - 16) * kWG + tid] = s[i];
      bar_arrive(1, 2 * kWG);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = (i / 2) % 2;
        const int cl = (i / 4) * 8 + col_t + (i % 2);
        float t;
        const float pr = prob(p, sh, s[i], lse_s[cl],
                              visible(p, c0 + cl, row0 + 8 * r), &t);
        xpf[i * kWG + tid] = p.softcap > 0.f ? pr * (1.f - t * t) : pr;
        s[i] = pr;
      }
      bar_arrive(2, 2 * kWG);
      bar_sync(3, 2 * kWG);
#pragma unroll
      for (int i = 16; i < 32; ++i) s[i] = xp[(i - 16) * kWG + tid];
      if (it + 1 < total) bar_arrive(5, 2 * kWG);
    } else {
      const float* dl_s = sm.dl_s(st);
      bar_sync(1, 2 * kWG);
      if (it > 0) bar_sync(5, 2 * kWG);
#pragma unroll
      for (int i = 16; i < 32; ++i) {
        const int r = (i / 2) % 2;
        const int cl = (i / 4) * 8 + col_t + (i % 2);
        float t;
        const float pr = prob(p, sh, xs[(i - 16) * kWG + tid], lse_s[cl],
                              visible(p, c0 + cl, row0 + 8 * r), &t);
        xp[(i - 16) * kWG + tid] = pr;
        const float pf = p.softcap > 0.f ? pr * (1.f - t * t) : pr;
        s[i] = pf * (s[i] - dl_s[cl]);
      }
      bar_arrive(3, 2 * kWG);
      bar_sync(2, 2 * kWG);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int cl = (i / 4) * 8 + col_t + (i % 2);
        s[i] = xpf[i * kWG + tid] * (s[i] - dl_s[cl]);
      }
      if (it + 1 < total) bar_arrive(4, 2 * kWG);
    }
    // dV += Pᵀ·dO, dK += dSᵀ·Q
    uint32_t w[16];
    pack_weights(s, w);
    reg_fence(acc);
    wg_fence();
    product_rs<NS>(acc, w, is_dv ? sm.col_b(st) : sm.col_a(st));
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    mbar_arrive(sm.empty(st));
  }

  if (is_dv)
    store_rows<NS>(acc,
                   (bf16*)p.gv + ((size_t)b * p.skv * p.hkv + hk) * p.dv,
                   (size_t)p.hkv * p.dv, row0, col_t, p.skv, p.dv, 1.f);
  else
    store_rows<NS>(acc, (bf16*)p.gk + ((size_t)b * p.skv * p.hkv + hk) * p.d,
                   (size_t)p.hkv * p.d, row0, col_t, p.skv, p.d, p.scale);
}

// --- host side --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// link against libcuda); 0 where the driver has none
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// The tensor map of a contiguous bf16 [batch, rows, heads, width] operand:
// a box of 64 columns (one 128-byte swizzled slab) × 64 rows of one head,
// zero filled outside the tensor
int make_map(CUtensorMap* map, const void* ptr, int batch, int rows,
             int heads, int width) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)heads * width * 2,
                                 (cuuint64_t)rows * heads * width * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

struct Maps {
  CUtensorMap q, k, v, o;
};

template <typename Kernel>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t bytes,
                  const Maps& m, const Params& p, const Shape& sh,
                  cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, bytes, stream>>>(m.q, m.k, m.v, m.o, p, sh);
  return (int)cudaGetLastError();
}

template <int NS>
int run_ns(const Params& p, const Shape& sh, const Maps& m, cudaStream_t s) {
  const dim3 qgrid(p.hq, (p.sq + kRows - 1) / kRows, p.batch);
  const dim3 kgrid(p.hkv, (p.skv + kRows - 1) / kRows, p.batch);
  int err = launch_kernel(bwd_wg_query_kernel<kDelta, NS>, qgrid,
                          (1 + query_consumers<kDelta, NS>()) * kWG,
                          Smem<NS, false>::kBytes, m, p, sh, s);
  if (err == 0)
    err = launch_kernel(bwd_wg_query_kernel<kDQ, NS>, qgrid,
                        (1 + query_consumers<kDQ, NS>()) * kWG,
                        Smem<NS, false>::kBytes, m, p, sh, s);
  if (err == 0)
    err = launch_kernel(bwd_wg_key_kernel<NS>, kgrid, 3 * kWG,
                        Smem<NS, true>::kBytes, m, p, sh, s);
  return err;
}

// The Δ, dQ and dK+dV passes, stopping at the first error
int run(const Params& p, cudaStream_t s) {
  Maps m;
  int err = make_map(&m.q, p.q, p.batch, p.sq, p.hq, p.d);
  if (err == 0) err = make_map(&m.k, p.k, p.batch, p.skv, p.hkv, p.d);
  if (err == 0) err = make_map(&m.v, p.v, p.batch, p.skv, p.hkv, p.dv);
  if (err == 0) err = make_map(&m.o, p.dout, p.batch, p.sq, p.hq, p.dv);
  if (err != 0) return err;
  const Shape sh = mma_path::shape_of(p);
  switch (((p.d > p.dv ? p.d : p.dv) + 63) / 64) {
    case 1: return run_ns<1>(p, sh, m, s);
    case 2: return run_ns<2>(p, sh, m, s);
    case 3: return run_ns<3>(p, sh, m, s);
    default: return run_ns<4>(p, sh, m, s);
  }
}

// The descriptor and swizzle check: c[64, n] (f32) = a[64, 256] · B with
// B = b[n, 256]ᵀ read K-major, A from shared memory (the score products'
// form; n = 64), or B = b[256, n] read MN-major as four 64-row tiles, A
// from registers (the sums' form; n = 64·NS)
template <int NS, bool kMN>
__global__ void __launch_bounds__(kWG, 1)
wgmma_tile_kernel(const __grid_constant__ CUtensorMap ma,
                  const __grid_constant__ CUtensorMap mb, const bf16* a,
                  float* c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bar;
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t a_tile = base, b_tile = base + 4 * kSlabBytes;
  constexpr int kBSlabs = kMN ? 4 * NS : 4;
  const uint32_t bar_addr = smem_addr(&bar);
  if (threadIdx.x == 0) {
    mbar_init(bar_addr, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar_addr,
                          (kMN ? kBSlabs : 4 + kBSlabs) * kSlabBytes);
    if (kMN) {
      for (int t = 0; t < 4; ++t)
        load_tile(b_tile + t * NS * kSlabBytes, &mb, bar_addr, NS, 0, 64 * t,
                  0);
    } else {
      load_tile(a_tile, &ma, bar_addr, 4, 0, 0, 0);
      load_tile(b_tile, &mb, bar_addr, 4, 0, 0, 0);
    }
  }
  mbar_wait(bar_addr, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16 + lane / 4, col_t = 2 * (lane % 4);
  float acc[32 * NS];
  zero(acc);
  if (kMN) {
    for (int t = 0; t < 4; ++t) {
      uint32_t w[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + 8 * (e % 2);
          const int col = 64 * t + 16 * kk + 8 * (e / 2) + col_t;
          w[4 * kk + e] =
              *reinterpret_cast<const uint32_t*>(a + row * 256 + col);
        }
      reg_fence(acc);
      wg_fence();
      product_rs<NS>(acc, w, b_tile + t * NS * kSlabBytes);
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
    }
  } else if constexpr (NS == 1) {
    wg_fence();
    product_ss<4>(acc, a_tile, b_tile);
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
  }
#pragma unroll
  for (int i = 0; i < 32 * NS; ++i) {
    const int row = row0 + 8 * ((i / 2) % 2);
    const int col = (i / 4) * 8 + col_t + (i % 2);
    c[row * 64 * NS + col] = acc[i];
  }
}

template <int NS, bool kMN>
int tile_check(const void* a, const void* b, float* c, cudaStream_t s) {
  CUtensorMap ma, mb;
  int err = make_map(&ma, a, 1, 64, 1, 256);
  if (err == 0)
    err = kMN ? make_map(&mb, b, 1, 256, 1, 64 * NS)
              : make_map(&mb, b, 1, 64, 1, 256);
  if (err != 0) return err;
  const size_t bytes = 1024 + (4 + (kMN ? 4 * NS : 4)) * kSlabBytes;
  const cudaError_t set = cudaFuncSetAttribute(
      wgmma_tile_kernel<NS, kMN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (set != cudaSuccess) return (int)set;
  wgmma_tile_kernel<NS, kMN><<<1, kWG, bytes, s>>>(ma, mb, (const bf16*)a, c);
  return (int)cudaGetLastError();
}

}  // namespace wg_path

// calls of the bf16 backward by route: wg_path, mma_path
long long bf16_routes[2] = {0, 0};

int check(const Params& p) {
  if (p.d < 1 || p.d > 256 || p.dv < 1 || p.dv > 256 || p.hkv < 1 ||
      p.hq % p.hkv)
    return (int)cudaErrorInvalidValue;
  return p.batch == 0 || p.sq == 0 || p.skv == 0 ? -1 : 0;
}

// f32: the fma path's Δ, dQ, dK and dV passes, stopping at the first
// launch error
int run(const Params& p, float, cudaStream_t s) {
  int err = fma_path::run_mode<kDelta>(p, s);
  if (err == 0) err = fma_path::run_mode<kDQ>(p, s);
  if (err == 0) err = fma_path::run_mode<kDK>(p, s);
  if (err == 0) err = fma_path::run_mode<kDV>(p, s);
  return err;
}

// bf16: wg_path where its TMA loads can describe the operands, else the
// mma.sync fallback's four passes
int run(const Params& p, bf16, cudaStream_t s) {
  if (wg_path::takes(p)) {
    ++bf16_routes[0];
    return wg_path::run(p, s);
  }
  ++bf16_routes[1];
  const mma_path::Shape sh = mma_path::shape_of(p);
  int err = mma_path::run_mode<kDelta>(p, sh, s);
  if (err == 0) err = mma_path::run_mode<kDQ>(p, sh, s);
  if (err == 0) err = mma_path::run_mode<kDK>(p, sh, s);
  if (err == 0) err = mma_path::run_mode<kDV>(p, sh, s);
  return err;
}

template <typename T>
int run(const Params& p, cudaStream_t s) {
  const int c = check(p);
  if (c != 0) return c < 0 ? (int)cudaSuccess : c;
  return run(p, T(), s);
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

// The bf16 backward's calls by route since the library loaded: out[0]
// through the wgmma path, out[1] through the mma.sync fallback
extern "C" int repro_flash_attention_bwd_routes(long long* out) {
  out[0] = bf16_routes[0];
  out[1] = bf16_routes[1];
  return 0;
}

// The wgmma descriptor and swizzle check (wg_path::wgmma_tile_kernel):
// c[64, n] f32 = a[64, 256] · b[n, 256]ᵀ (mn_major 0, n = 64) or
// a[64, 256] · b[256, n] (mn_major 1, n = 64, 128, 192 or 256), a and b
// contiguous bf16, 16-byte aligned
extern "C" int repro_wgmma_tile_bf16(const void* a, const void* b, float* c,
                                     int n, int mn_major, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!mn_major)
    return n == 64 ? wg_path::tile_check<1, false>(a, b, c, s)
                   : (int)cudaErrorInvalidValue;
  switch (n) {
    case 64: return wg_path::tile_check<1, true>(a, b, c, s);
    case 128: return wg_path::tile_check<2, true>(a, b, c, s);
    case 192: return wg_path::tile_check<3, true>(a, b, c, s);
    case 256: return wg_path::tile_check<4, true>(a, b, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
