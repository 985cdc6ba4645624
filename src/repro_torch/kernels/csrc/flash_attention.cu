// Streaming-softmax (flash) attention for sm_90a: causal, GQA (kv head
// h / G), sliding window and tanh logit soft-capping, f32 or bf16 operands.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the
// pallas_call at flash_attention.py:109).
//
// What bounds it on an H100: per unmasked (query, key) pair D + Dv
// multiply-adds against (D + Dv) · elem bytes read once per key row: at
// the gemma2-9b widths (D = Dv = 256, 16 query heads over 8 kv heads,
// S = 8192) that is thousands of operations per byte, so operations bound
// it — in bf16 the tensor cores' 989 TFLOP/s, in f32 the 67 TFLOP/s of
// plain FMA.
//
// What the design does about it.  The TPU grid (B, Hq, Sq/bq, Skv/bk)
// walked the kv axis sequentially with m, l and the accumulator in VMEM
// scratch; here one CUDA block owns a query tile of one (batch, head) and
// loops over the keys in 64-row tiles itself, with m, l and the
// accumulator in registers.  The reference's block_q/block_k set only its
// grid (and the cost rule); the result does not depend on them.
//
// Only the kv tiles a query tile can see are visited: from causal and
// window, query rows [q0, q_last] see keys [max(0, q0 - window + 1),
// min(Skv, q_last + 1)) — the lower end only with a window, the upper end
// only when causal (a window without causal keeps every later key, as the
// reference's mask does) — rounded out to whole tiles.  This is exact:
// the reference visits the other tiles too, but there every score is
// masked to -1e30, so m_new = m_prev, corr = exp(0) = 1 and p = 0 (the
// s <= -5e29 guard), and the tile adds nothing, bit for bit.  The element
// mask runs only where a consumer's 64 rows (wgmma route) or a warp's 16
// (mma.sync route) straddle an edge (causal diagonal, window edge, ragged
// Skv); on the mma.sync route a warp whose 16 rows see none of a tile
// skips it, for the same reason.
//
// Three routes, chosen from the operands (routes[] counts the calls of
// each, repro_flash_attention_routes):
//
// bf16 where TMA tensor maps can describe q, k and v (D and Dv multiples
// of 8, every operand 16-byte aligned: tma_takes_bf16, the rule the
// backward's wgmma route follows too) — the main path: every attention
// layer of gemma2-9b (D = 256) and zamba2-7b (D = 112), serving and
// training — wg_path, Hopper's asynchronous tensor cores.  A block owns a
// 128-row query tile of one (batch, head) and has three warpgroups:
//  * the producer (warpgroup 0, setmaxnreg down to 24 registers): one
//    thread issues TMA loads (one 64 × 64 box per 128-byte-swizzled slab,
//    zero filled past Sq, Skv, D and Dv, so zamba2's D = 112 and
//    deepseek's 192 / 128 need no copy) of Q once and of the kv tiles the
//    rows can see, and only those (kv_tiles), into a ring of K stages and
//    a ring of V stages, each stage with a full mbarrier (the load's
//    bytes) and an empty one (both consumers' 256 threads);
//  * two consumers (warpgroups 1 and 2, 240 registers each), 64 query
//    rows each.  For kv tile j a consumer issues S_j = Q·K_jᵀ (m64n64k16,
//    Q and K both K-major from shared memory) together with O +=
//    P_{j-1}·V_{j-1} (m64nNk16, N = Dv rounded up to 64, V MN-major, P
//    the A operand from registers: the score accumulator rounded to bf16
//    is the A fragment of a k16 step), waits for S_j only, runs scale,
//    softcap, mask and the online softmax on S_j in registers while its
//    own P·V and the other consumer's products run, then rescales O by
//    corr_j and packs P_j.  K_j is released once S_j is in, V_{j-1} once
//    O is, so the producer's next K load starts a tile earlier than its
//    V load needs to.
// The two consumers take turns to issue (named barriers 1 and 2, handed
// over right after the issue): one warpgroup's softmax — three MUFU
// operations a score (the softcap's ex2 and rcp, exp's ex2), ~770 cycles
// a 64 × 64 tile at 16 an SM a cycle — runs while the tensor cores work
// on the other's products (~1000 cycles a tile at D = Dv = 256), which is
// how the kernel gets below the serial sum of its tensor and MUFU floors.
// Shared memory: Q plus the two rings, 1024-byte aligned slabs — at D =
// Dv = 256 Q 64 KB and two stages of K and V 128 KB (193 KB), at 129–192
// three stages (193 KB), at ≤ 128 four (161 KB at 128).  O's m64n256 f32
// sum is 128 registers a thread, S 32 and P's fragments 16.  Each
// consumer waits on every full barrier in order and arrives on every
// empty one, tiles its rows see none of included (fully masked: they add
// nothing), so both stay within a tile of each other and every parity
// wait is exact.
//
// bf16 otherwise (Dk 100 / Dv 60, odd widths, views off a 16-byte
// boundary), mma_path, FlashAttention-2 style (the main path's route until
// the wgmma route took it; repro_flash_attention_bf16_mma runs it on any
// bf16 operands, to time and check it): a 128-row query tile, eight warps
// of 16 rows each.  Q·Kᵀ and P·V are mma.sync.m16n8k16 (bf16 operands,
// f32 accumulation), fed by ldmatrix (.trans for V).  The score fragment
// stays in registers: scale, softcap, mask and the online softmax run on
// it, the row max by shuffles across the 4 threads that share a row (the
// row sum l is kept per thread and reduced once at the end).  p is
// rounded to bf16 in registers and used directly as P·V's A operand — the
// C layout of two adjacent n8 score tiles is the A layout of one k16 step
// — while l sums the unrounded p, as the reference's p.astype(v.dtype)
// and sum(p) do.  K and V tiles are staged with 16-byte cp.async (or
// element by element where D or Dv is not a multiple of 8 or an operand
// is unaligned) into a two-stage ring (tile t+1 loads while tile t is
// computed; one barrier per tile).  D and Dv are zero-padded to a
// multiple of 16 in shared memory, and every row is padded by 16 bytes,
// an odd number of 16-byte units, so the 8 rows an ldmatrix reads fall on
// distinct bank groups.  The Dv = 256 accumulator is 128 f32 registers a
// thread; Q's fragments do not fit beside it, so Q is re-read by
// ldmatrix on every kv tile, and every warp reads the whole K and V tile.
// Both bf16 routes order blocks heads fastest — the G query heads of one
// kv head adjacent, sharing K and V in L2 — and the latest (heaviest,
// under a causal mask) query tiles first, to cut the tail; both write
// each row's lse in the same units and layout (the backward reads it);
// neither uses atomics, so two runs agree bit for bit.
//
// exp is exp2 of arguments pre-scaled by log2 e (ex2.approx, relative
// error ~2^-22).  The softcap c·tanh(s/c) is c·(1 - 2/(1 + e^{2s/c})):
// one ex2 and one rcp.approx, exact at both ends (e^{2s/c} = inf gives 1,
// 0 gives -1), absolute error ~1e-7·c — tanhf's long software sequence
// would cost about as much as the bound at ~540 M scores a layer.
//
// f32, fma_path (not timed at real size), keeps the FMA design: a 64-row
// query tile, scores and P·V as f32 FMA from shared memory with Q, one
// K-then-V buffer and the probabilities staged there (TF32 would not hold
// rtol 2e-4 against float64), plus the same tile skip.
//
// The reference's order is kept throughout: scale, softcap, mask to -1e30
// (not -inf: an all-masked row would compute -inf - -inf = NaN),
// exp(s - m_new) zeroed where s <= -5e29, corr = exp(m_prev - m_new), and
// the final divide by max(l, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTileK = 64;      // key/value rows per inner step (every route)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;      // [B, Hq, Sq] log-sum-exp of each row's scores, or null
  int sq, skv, hq, hkv, d, dv;
  float scale;
  float softcap;   // 0: none
  int causal;
  int window;      // < 0: none
};

// The keys query rows [q_first, q_last] can see, rounded out to whole kv
// tiles: [*t_lo, *t_hi) (empty when the rows see no key, as under a causal
// mask with window 0).
__device__ __forceinline__ void kv_tiles(const Params& p, int q_first,
                                         int q_last, int* t_lo, int* t_hi) {
  const int lo = p.window >= 0 ? max(0, q_first - p.window + 1) : 0;
  const int hi = !p.causal ? p.skv : p.window == 0 ? 0
                                                   : min(p.skv, q_last + 1);
  *t_lo = lo / kTileK;
  *t_hi = lo < hi ? (hi + kTileK - 1) / kTileK : *t_lo;
}

// =========================================================================
// f32: FMA from shared memory
// =========================================================================
namespace fma_path {

constexpr int kTileQ = 64;      // query rows per CUDA block
constexpr int kThreads = 256;   // 16 × 16: 4 rows × 4 score columns each
constexpr int kLdP = kTileK + 4;
static_assert(kTileQ == kTileK, "stage() copies kTileK rows of Q too");

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage rows [row0, row0 + kTileK) of a [*, n_cols] operand (row stride
// `stride` floats) into `dst` (row stride `ld`), zero past the last row
// and past n_cols up to `width`.
__device__ void stage(float* dst, int ld, int width, const float* src,
                      size_t stride, int row0, int n_rows, int n_cols) {
  for (int i = threadIdx.x; i < kTileK * width; i += kThreads) {
    const int r = i / width;
    const int c = i - r * width;
    float x = 0.f;
    if (row0 + r < n_rows && c < n_cols)
      x = src[(size_t)(row0 + r) * stride + c];
    dst[r * ld + c] = x;
  }
}

// NG: groups of 64 value columns (Dv <= 64 · NG); ld: shared row stride
// of the Q and K tiles, in floats
template <int NG>
__global__ void __launch_bounds__(kThreads)
flash_kernel(Params p, int ld) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLdV = NG * 64;
  float* qs = smem;                                   // [kTileQ][ld]
  float* kv = qs + kTileQ * ld;                       // K [kTileK][ld], V [kTileK][kLdV]
  float* ps = kv + kTileK * max(ld, kLdV);            // [kTileQ][kLdP]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int d4 = (p.d + 3) & ~3;

  const float* qg = (const float*)p.q + ((size_t)b * p.sq * p.hq + h) * p.d;
  const float* kg = (const float*)p.k + ((size_t)b * p.skv * p.hkv + hk) * p.d;
  const float* vg = (const float*)p.v + ((size_t)b * p.skv * p.hkv + hk) * p.dv;
  float* og = (float*)p.o + ((size_t)b * p.sq * p.hq + h) * p.dv;

  stage(qs, ld, d4, qg, (size_t)p.hq * p.d, q0, p.sq, p.d);

  float m[4], l[4], acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  int t_lo, t_hi;
  kv_tiles(p, q0, min(q0 + kTileQ, p.sq) - 1, &t_lo, &t_hi);
  for (int k0 = t_lo * kTileK; k0 < t_hi * kTileK; k0 += kTileK) {
    __syncthreads();   // the last tile's P·V is done with kv and ps
    stage(kv, ld, d4, kg, (size_t)p.hkv * p.d, k0, p.skv, p.d);
    __syncthreads();

    // s = Q · Kᵀ: rows ty + 16 i, key columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d4; c += 4) {
      float4 qv[4], kw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * ld + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kw[j] = *reinterpret_cast<const float4*>(&kv[(tx + 16 * j) * ld + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kw[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kw[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kw[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kw[j].w, s[i][j]);
        }
    }
    __syncthreads();   // every thread is done reading K
    stage(kv, kLdV, kLdV, vg, (size_t)p.hkv * p.dv, k0, p.skv, p.dv);

    // the online softmax, in the reference's order
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool keep = kpos < p.skv;
        if (p.causal) keep = keep && qpos >= kpos;
        if (p.window >= 0) keep = keep && qpos - kpos < p.window;
        s[i][j] = keep ? x : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pv = expf(s[i][j] - m_new);
        if (s[i][j] <= kNegInf / 2) pv = 0.f;   // fully-masked row guard
        row_sum += pv;
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = pv;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr;
    }
    __syncthreads();   // V and P are staged

    // acc += P · V: rows ty + 16 i, value columns g · 64 + tx · 4 + e
    for (int j = 0; j < kTileK; j += 4) {
      float4 pw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pw[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * kLdP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &kv[(j + jj) * kLdV + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pij = jj == 0 ? pw[i].x : jj == 1 ? pw[i].y
                            : jj == 2 ? pw[i].z : pw[i].w;
            acc[i][g][0] = fmaf(pij, vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(pij, vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(pij, vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(pij, vv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (p.lse != nullptr && tx == 0)
      p.lse[((size_t)b * p.hq + h) * p.sq + qpos] = m[i] + logf(denom);
    float* orow = og + (size_t)qpos * p.hq * p.dv;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g * 64 + tx * 4 + e;
        if (col < p.dv) orow[col] = acc[i][g][e] / denom;
      }
  }
}

template <int NG>
int launch(const Params& p, int batch, cudaStream_t stream) {
  // an odd multiple of 4 floats: the 16 key rows a half-warp reads as
  // float4 fall on distinct banks
  int words = (p.d + 3) / 4;
  if (words % 2 == 0) ++words;
  const int ld = 4 * words;
  const int ldv = NG * 64;
  const size_t bytes = sizeof(float) *
      ((size_t)kTileQ * ld + (size_t)kTileK * (ld > ldv ? ld : ldv) +
       (size_t)kTileQ * kLdP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kTileQ - 1) / kTileQ, p.hq, batch);
  flash_kernel<NG><<<grid, kThreads, bytes, stream>>>(p, ld);
  return (int)cudaGetLastError();
}

int run(const Params& p, int batch, cudaStream_t s) {
  switch ((p.dv + 63) / 64) {
    case 1: return launch<1>(p, batch, s);
    case 2: return launch<2>(p, batch, s);
    case 3: return launch<3>(p, batch, s);
    default: return launch<4>(p, batch, s);
  }
}

}  // namespace fma_path

// =========================================================================
// bf16: tensor cores (mma.sync m16n8k16)
// =========================================================================
namespace mma_path {

constexpr int kTileQ = 128;     // query rows per CUDA block
constexpr int kWarps = kTileQ / 16;
constexpr int kThreads = 32 * kWarps;
// the reference's -1e30 mask and -5e29 guard, in units of log2 e
constexpr float kMaskedL = kNegInf * kLog2e;
constexpr float kGuardL = kNegInf / 2 * kLog2e;

struct Shape {
  int d16, dv16;     // D and Dv rounded up to 16
  int ldq, ldv;      // shared row strides (elements) of Q/K and of V
  int vec;           // 16-byte cp.async staging (else element by element)
  float scale_l;     // scale · log2 e
  float cap_k;       // 2 · log2 e · scale / softcap
  float cap_l;       // softcap · log2 e
};

// Stage rows [row0, row0 + rows) of a [*, n_cols] bf16 operand (row
// stride `stride` elements) into `dst` (row stride `ld`), zero past the
// last row and from n_cols up to `width` (a multiple of 16).  The vector
// form issues 16-byte cp.async copies (n_cols a multiple of 8, 16-byte
// aligned rows) and returns before they land; the element form stores
// synchronously.
__device__ __forceinline__ void stage(bf16* dst, int ld, int width,
                                      const bf16* src, size_t stride,
                                      int row0, int rows, int n_rows,
                                      int n_cols, bool vec) {
  if (vec) {
    // thread t copies the 16-byte chunk t % 32 (width <= 256) of rows
    // t / 32 + 8 j: no division by the runtime width
    const int c = (threadIdx.x % 32) * 8;
    if (c >= width) return;
    const bool col_ok = c < n_cols;
#pragma unroll
    for (int r = threadIdx.x / 32; r < rows; r += kThreads / 32) {
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

// NV: n8 tiles of the value accumulator (8 · NV >= Dv rounded up to 16)
template <int NV>
__global__ void __launch_bounds__(kThreads, 1)
flash_mma_kernel(Params p, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTileQ][ldq]
  bf16* ks = qs + kTileQ * sh.ldq;               // [2][kTileK][ldq]
  bf16* vs = ks + 2 * kTileK * sh.ldq;           // [2][kTileK][ldv]

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileQ;  // latest first
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const bf16* qg = (const bf16*)p.q + ((size_t)b * p.sq * p.hq + h) * p.d;
  const bf16* kg = (const bf16*)p.k + ((size_t)b * p.skv * p.hkv + hk) * p.d;
  const bf16* vg = (const bf16*)p.v + ((size_t)b * p.skv * p.hkv + hk) * p.dv;
  bf16* og = (bf16*)p.o + ((size_t)b * p.sq * p.hq + h) * p.dv;
  const size_t q_stride = (size_t)p.hq * p.d;
  const size_t k_stride = (size_t)p.hkv * p.d;
  const size_t v_stride = (size_t)p.hkv * p.dv;
  const bool vec = sh.vec != 0;

  int t_lo, t_hi;
  kv_tiles(p, q0, min(q0 + kTileQ, p.sq) - 1, &t_lo, &t_hi);

  stage(qs, sh.ldq, sh.d16, qg, q_stride, q0, kTileQ, p.sq, p.d, vec);
  if (t_lo < t_hi) {
    const int k0 = t_lo * kTileK;
    stage(ks, sh.ldq, sh.d16, kg, k_stride, k0, kTileK, p.skv, p.d, vec);
    stage(vs, sh.ldv, sh.dv16, vg, v_stride, k0, kTileK, p.skv, p.dv, vec);
  }
  cp_async_commit();

  // this warp's query rows, and the two rows this thread's fragments hold
  const int wq0 = q0 + warp * 16;
  const int wq1 = min(wq0 + 15, p.sq - 1);
  const int row_a = wq0 + lane / 4;
  const int row_b = row_a + 8;
  const int col_t = 2 * (lane % 4);   // a thread's first column in an n8 tile

  // per-lane ldmatrix offsets (elements): Q as the A operand (rows
  // lane % 16, k half lane / 16); K as two n8 B tiles (key rows lane % 8
  // + 8 · (lane / 16), k half (lane / 8) % 2); V transposed (key rows
  // lane % 8 + 8 · ((lane / 8) % 2), value columns 8 · (lane / 16))
  const uint32_t q_base = smem_addr(
      qs + (warp * 16 + lane % 16) * sh.ldq + (lane / 16) * 8);
  const int k_off = (lane % 8 + (lane / 16) * 8) * sh.ldq + ((lane / 8) % 2) * 8;
  const int v_off = (lane % 8 + ((lane / 8) % 2) * 8) * sh.ldv + (lane / 16) * 8;

  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kMaskedL, kMaskedL};  // running row max, log2 units
  float l[2] = {0.f, 0.f};            // this thread's share of the row sums

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    cp_async_wait_all();   // tile t (and Q) landed, for this thread's copies
    __syncthreads();       // ... for every thread's; tile t - 1 is consumed
    if (t + 1 < t_hi) {
      const int k1 = (t + 1) * kTileK;
      stage(ks + (st ^ 1) * kTileK * sh.ldq, sh.ldq, sh.d16, kg, k_stride,
            k1, kTileK, p.skv, p.d, vec);
      stage(vs + (st ^ 1) * kTileK * sh.ldv, sh.ldv, sh.dv16, vg, v_stride,
            k1, kTileK, p.skv, p.dv, vec);
    }
    cp_async_commit();

    const int k0 = t * kTileK;
    // a warp none of whose rows sees a key of this tile skips it (exact:
    // an all-masked tile adds nothing)
    bool dead = wq0 >= p.sq;
    if (p.causal) dead = dead || k0 > wq1;
    if (p.window >= 0) dead = dead || wq0 - (k0 + kTileK - 1) >= p.window;
    if (dead) continue;
    const bool edge = k0 + kTileK > p.skv ||
                      (p.causal && k0 + kTileK - 1 > wq0) ||
                      (p.window >= 0 && wq1 - k0 >= p.window);

    // s = Q · Kᵀ: 16 rows × kTileK keys, kTileK / 8 n8 tiles
    const uint32_t k_base = smem_addr(ks + st * kTileK * sh.ldq + k_off);
    float s[kTileK / 8][4];
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int kk = 0; kk < sh.d16 / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(q_base + kk * 32, a);
#pragma unroll
      for (int np = 0; np < kTileK / 16; ++np) {
        uint32_t bq[4];
        ldsm_x4(k_base + (np * 16 * sh.ldq + kk * 16) * 2, bq);
        mma16816(s[2 * np], a, bq[0], bq[1]);
        mma16816(s[2 * np + 1], a, bq[2], bq[3]);
      }
    }

    // scale, softcap and mask, in log2 units; the row max
    float mx[2] = {kMaskedL, kMaskedL};
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        if (p.softcap > 0.f)
          x = fmaf(-2.f * sh.cap_l, rcp(1.f + ex2(x * sh.cap_k)), sh.cap_l);
        else
          x *= sh.scale_l;
        if (edge) {
          const int qpos = e < 2 ? row_a : row_b;
          const int kpos = k0 + n * 8 + col_t + (e & 1);
          bool keep = kpos < p.skv;
          if (p.causal) keep = keep && qpos >= kpos;
          if (p.window >= 0) keep = keep && qpos - kpos < p.window;
          if (!keep) x = kMaskedL;
        }
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // p = exp(s - m_new), zeroed where s <= -5e29; l sums it unrounded
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float pv = x <= kGuardL ? 0.f : ex2(x - m[e / 2]);
        l[e / 2] += pv;
        s[n][e] = pv;
      }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P · V: p rounded to bf16, the score C fragments of keys
    // 16 kk .. 16 kk + 15 reused as the A fragment of one k16 step
    const uint32_t v_base = smem_addr(vs + st * kTileK * sh.ldv + v_off);
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NV / 2; ++np) {
        if (np * 16 >= sh.dv16) break;
        uint32_t bv[4];
        ldsm_x4_trans(v_base + (kk * 16 * sh.ldv + np * 16) * 2, bv);
        mma16816(acc[2 * np], a, bv[0], bv[1]);
        mma16816(acc[2 * np + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();   // nothing in flight when the block exits

  // the row sums over the 4 threads of a row; out = acc / max(l, 1e-30)
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    denom[r] = fmaxf(lr, 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r == 0 ? row_a : row_b;
    if (qpos >= p.sq) continue;
    if (p.lse != nullptr && lane % 4 == 0)   // m and l in log2 units
      p.lse[((size_t)b * p.hq + h) * p.sq + qpos] =
          (m[r] + log2f(denom[r])) * kLn2;
    bf16* orow = og + (size_t)qpos * p.hq * p.dv;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int col = n * 8 + col_t;
      const float x0 = acc[n][2 * r] / denom[r];
      const float x1 = acc[n][2 * r + 1] / denom[r];
      if (p.dv % 2 == 0 && col < p.dv) {   // an aligned pair
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < p.dv) orow[col] = __float2bfloat16(x0);
        if (col + 1 < p.dv) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int NV>
int launch(const Params& p, const Shape& sh, int batch, cudaStream_t stream) {
  const size_t bytes = sizeof(bf16) * ((size_t)(kTileQ + 2 * kTileK) * sh.ldq +
                                       (size_t)2 * kTileK * sh.ldv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.hq, (p.sq + kTileQ - 1) / kTileQ, batch);
  flash_mma_kernel<NV><<<grid, kThreads, bytes, stream>>>(p, sh);
  return (int)cudaGetLastError();
}

Shape shape_of(const Params& p) {
  Shape sh;
  sh.d16 = (p.d + 15) & ~15;
  sh.dv16 = (p.dv + 15) & ~15;
  sh.ldq = sh.d16 + 8;     // + 16 bytes: an odd number of 16-byte units
  sh.ldv = sh.dv16 + 8;
  const uintptr_t addr = (uintptr_t)p.q | (uintptr_t)p.k | (uintptr_t)p.v;
  sh.vec = p.d % 8 == 0 && p.dv % 8 == 0 && addr % 16 == 0;
  sh.scale_l = p.scale * kLog2e;
  sh.cap_k = p.softcap > 0.f ? 2.f * kLog2e * p.scale / p.softcap : 0.f;
  sh.cap_l = p.softcap * kLog2e;
  return sh;
}

int run(const Params& p, int batch, cudaStream_t s) {
  const Shape sh = shape_of(p);
  switch ((sh.dv16 + 63) / 64) {
    case 1: return launch<8>(p, sh, batch, s);
    case 2: return launch<16>(p, sh, batch, s);
    case 3: return launch<24>(p, sh, batch, s);
    default: return launch<32>(p, sh, batch, s);
  }
}

}  // namespace mma_path

// =========================================================================
// bf16, the main path: warpgroup wgmma products on a TMA ring
// =========================================================================
namespace wg_path {

constexpr int kRows = 64;   // query rows a consumer owns, key rows a tile
constexpr int kWG = 128;    // threads of a warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// named barrier kTurn + c: consumer c's turn to issue its products (id 0
// is __syncthreads)
constexpr int kTurn = 1;
// the reference's -1e30 mask and -5e29 guard, in units of log2 e
constexpr float kMaskedL = mma_path::kMaskedL;
constexpr float kGuardL = mma_path::kGuardL;

using mma_path::Shape;

// Whether the route takes the problem: TMA tensor maps can describe q, k
// and v (tma_takes_bf16), and there is a key to map
bool takes(const Params& p) {
  return p.skv > 0 &&
         tma_takes_bf16(p.d, p.dv,
                        (uintptr_t)p.q | (uintptr_t)p.k | (uintptr_t)p.v);
}

// The dynamic shared memory of a block: the query tile (two 64-row
// tiles, one a consumer), a ring of kStages K tiles and one of kStages V
// tiles, then the mbarriers (Q's, each K stage's full and empty, each V
// stage's full and empty).  A tile is NS slabs of 64 rows × 128 bytes,
// every tile 1024-byte aligned (the swizzle's period).
template <int NS>
struct Smem {
  static constexpr int kStages = NS == 4 ? 2 : NS == 3 ? 3 : 4;
  static constexpr int kTile = NS * kSlabBytes;
  static constexpr int kTiles = 2 + 2 * kStages;
  static constexpr int kBars = 8 * (1 + 4 * kStages);
  static constexpr size_t kBytes = 1024 + (size_t)kTiles * kTile + kBars;

  uint32_t base;        // shared address of tile 0
  unsigned char* ptr;   // its generic address

  __device__ explicit Smem(unsigned char* raw) {
    const uint32_t a = smem_addr(raw);
    base = (a + 1023) & ~1023u;
    ptr = raw + (base - a);
  }
  __device__ uint32_t q(int c) const { return base + c * kTile; }
  __device__ uint32_t k(int st) const { return base + (2 + st) * kTile; }
  __device__ uint32_t v(int st) const {
    return base + (2 + kStages + st) * kTile;
  }
  __device__ uint32_t q_full() const { return base + kTiles * kTile; }
  __device__ uint32_t k_full(int st) const { return q_full() + 8 * (1 + st); }
  __device__ uint32_t k_empty(int st) const {
    return q_full() + 8 * (1 + kStages + st);
  }
  __device__ uint32_t v_full(int st) const {
    return q_full() + 8 * (1 + 2 * kStages + st);
  }
  __device__ uint32_t v_empty(int st) const {
    return q_full() + 8 * (1 + 3 * kStages + st);
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// One kv tile of the online softmax on a 64 × 64 score fragment s (the
// m64n64 accumulator layout: element i of this thread is row row_a + 8 ·
// ((i / 2) % 2), key k0 + 8 · (i / 4) + col_t + (i % 2)), in the
// reference's order and in log2 units: scale and softcap, the mask where
// the tile straddles an edge (`edge`), the row max over the 4 threads of
// a row, corr = exp(m_prev - m_new), then s := exp(s - m_new), zeroed
// where s <= -5e29, and l := l · corr + Σ s (unrounded)
__device__ __forceinline__ void softmax_tile(const Params& p, const Shape& sh,
                                             float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int row_a, int col_t,
                                             bool edge) {
  float mx[2] = {kMaskedL, kMaskedL};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = s[i];
    if (p.softcap > 0.f)
      x = fmaf(-2.f * sh.cap_l, rcp(1.f + ex2(x * sh.cap_k)), sh.cap_l);
    else
      x *= sh.scale_l;
    if (edge) {
      const int qpos = row_a + 8 * ((i / 2) % 2);
      const int kpos = k0 + (i / 4) * 8 + col_t + (i % 2);
      bool keep = kpos < p.skv;
      if (p.causal) keep = keep && qpos >= kpos;
      if (p.window >= 0) keep = keep && qpos - kpos < p.window;
      if (!keep) x = kMaskedL;
    }
    s[i] = x;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i / 2) % 2;
    const float x = s[i];
    const float pv = x <= kGuardL ? 0.f : ex2(x - m[r]);
    l[r] += pv;
    s[i] = pv;
  }
}

// Kv tile `it` of consumer c (see flash_wg_kernel): wait for K_it (and
// V_{it-1}), in its turn issue S = Q·K_itᵀ (and, kPV, O += P·V_{it-1}
// from the last tile's P fragments pw), hand the turn over, release K_it
// once S is in, the softmax, release V_{it-1} once O is in, rescale O by
// corr and pack this tile's P into pw.  kPV is false for the first tile
// only, so no product is issued under a runtime branch.
template <int NS, bool kPV>
__device__ __forceinline__ void consume_tile(
    const Smem<NS>& sm, const Params& p, const Shape& sh, int c, int it,
    int t_lo, int rq0, int wq1, int row_a, int col_t, float (&acc)[32 * NS],
    float (&s)[32], uint32_t (&pw)[16], float (&m)[2], float (&l)[2]) {
  constexpr int S = Smem<NS>::kStages;
  const int st = it % S;
  const int pst = (it + S - 1) % S;   // the last tile's stage
  const int k0 = (t_lo + it) * kRows;
  mbar_wait(sm.k_full(st), (it / S) & 1);
  if (kPV) mbar_wait(sm.v_full(pst), ((it - 1) / S) & 1);
  reg_fence(s);
  reg_fence(acc);
  bar_sync(kTurn + c, 2 * kWG);
  wg_fence();
  product_ss<NS>(s, sm.q(c), sm.k(st));   // S = Q·K_itᵀ
  wg_commit();
  if (kPV) {
    product_rs<NS>(acc, pw, sm.v(pst));    // O += P·V_{it-1}
    wg_commit();
  }
  bar_arrive(kTurn + (c ^ 1), 2 * kWG);
  if (kPV)
    wg_wait<1>();
  else
    wg_wait<0>();
  reg_fence(s);
  mbar_arrive(sm.k_empty(st));

  const bool edge = k0 + kRows > p.skv ||
                    (p.causal && k0 + kRows - 1 > rq0) ||
                    (p.window >= 0 && wq1 - k0 >= p.window);
  float corr[2];
  softmax_tile(p, sh, s, m, l, corr, k0, row_a, col_t, edge);

  if (kPV) {
    wg_wait<0>();
    reg_fence(acc);
    mbar_arrive(sm.v_empty(pst));
  }
#pragma unroll
  for (int i = 0; i < 32 * NS; ++i) acc[i] *= corr[(i / 2) % 2];
  pack_weights(s, pw);   // p rounded to bf16: the A fragments of P·V
}

// The block: one (q head, 128-row query tile, batch), heads fastest and
// the latest query tiles first; warpgroup 0 the producer (one thread
// issues every TMA load), warpgroups 1 and 2 the consumers of query rows
// q0 .. q0 + 63 and q0 + 64 .. q0 + 127.  Each consumer, for kv tile j:
//   S_j = Q·K_jᵀ (m64n64k16, both K-major from shared memory) and
//   O += P_{j-1}·V_{j-1} (m64nNk16, P in registers, V MN-major) issued
//   together in its turn, then the softmax of S_j while the products of
//   the other consumer run, then O's rescale by corr_j and P_j packed to
//   bf16 for the next tile; the last tile's P·V after the loop.
template <int NS>
__global__ void __launch_bounds__(3 * kWG, 1)
flash_wg_kernel(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, Params p,
                Shape sh) {
  using SM = Smem<NS>;
  constexpr int S = SM::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SM sm(smem_raw);
  const int na = (p.d + 63) / 64, nb = (p.dv + 63) / 64;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 2 * kRows;  // latest first
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  int t_lo, t_hi;
  kv_tiles(p, q0, min(q0 + 2 * kRows, p.sq) - 1, &t_lo, &t_hi);
  const int total = t_hi - t_lo;

  // zero the slabs past D (Q, K) and Dv (V), which no load writes and
  // the products read; the barriers: Q's and each full one complete on
  // the loader's arrival and its bytes, each empty one on both
  // consumers' 256 threads
  for (int t = 0; t < SM::kTiles; ++t) {
    const int n = t >= 2 + S ? nb : na;
    uint4* z = reinterpret_cast<uint4*>(sm.ptr + t * SM::kTile +
                                        n * kSlabBytes);
    for (int i = threadIdx.x; i < (NS - n) * kSlabBytes / 16;
         i += blockDim.x)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(sm.k_full(st), 1);
      mbar_init(sm.k_empty(st), 2 * kWG);
      mbar_init(sm.v_full(st), 1);
      mbar_init(sm.v_empty(st), 2 * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {   // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    // rows past Sq and columns past D are zero filled
    mbar_arrive_expect_tx(sm.q_full(), 2 * na * kSlabBytes);
    load_tile(sm.q(0), &mq, sm.q_full(), na, h, q0, b);
    load_tile(sm.q(1), &mq, sm.q_full(), na, h, q0 + kRows, b);
    // K of tile it waits for the consumers' S_{it-S}, V for their
    // P_{it-S}·V_{it-S}, which they issue one tile later
    for (int it = 0; it < total; ++it) {
      const int st = it % S, parity = ((it / S) & 1) ^ 1;
      const int k0 = (t_lo + it) * kRows;
      mbar_wait(sm.k_empty(st), parity);
      mbar_arrive_expect_tx(sm.k_full(st), na * kSlabBytes);
      load_tile(sm.k(st), &mk, sm.k_full(st), na, hk, k0, b);
      mbar_wait(sm.v_empty(st), parity);
      mbar_arrive_expect_tx(sm.v_full(st), nb * kSlabBytes);
      load_tile(sm.v(st), &mv, sm.v_full(st), nb, hk, k0, b);
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // a consumer: rows rq0 .. rq0 + 63 (the valid ones up to wq1); this
  // thread's rows row_a and row_a + 8, and its first column in each n8
  // column group
  const int c = wg - 1;
  const int tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32;
  const int rq0 = q0 + c * kRows;
  const int wq1 = min(rq0 + kRows, p.sq) - 1;
  const int row_a = rq0 + warp * 16 + lane / 4;
  const int col_t = 2 * (lane % 4);

  float acc[32 * NS];
  zero(acc);
  float m[2] = {kMaskedL, kMaskedL};   // running row max, log2 units
  float l[2] = {0.f, 0.f};             // this thread's share of the row sums
  float s[32];                         // the first k step overwrites
  uint32_t pw[16];                     // P of the last tile, A fragments

  // Every consumer waits on every full barrier, in order, and arrives on
  // every empty one: a barrier is never two phases ahead of a waiter, so
  // each parity wait is exact, and neither consumer can add a second
  // arrival to an empty phase before the other's first.  Turns: consumer
  // 0 issues first (consumer 1's arrival below), each hands the turn over
  // right after issuing, and consumer 0 takes the last hand-over after its
  // loop, so both named barriers end balanced.
  mbar_wait(sm.q_full(), 0);
  if (c == 1) bar_arrive(kTurn, 2 * kWG);
  if (total > 0)
    consume_tile<NS, false>(sm, p, sh, c, 0, t_lo, rq0, wq1, row_a, col_t,
                            acc, s, pw, m, l);
  for (int it = 1; it < total; ++it)
    consume_tile<NS, true>(sm, p, sh, c, it, t_lo, rq0, wq1, row_a, col_t,
                           acc, s, pw, m, l);
  if (total > 0) {   // the last tile's P·V
    const int pst = (total - 1) % S;
    mbar_wait(sm.v_full(pst), ((total - 1) / S) & 1);
    reg_fence(acc);
    wg_fence();
    product_rs<NS>(acc, pw, sm.v(pst));
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
  }
  if (c == 0) bar_sync(kTurn, 2 * kWG);

  // the row sums over the 4 threads of a row; out = acc / max(l, 1e-30)
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    denom[r] = fmaxf(lr, 1e-30f);
  }
  bf16* og = (bf16*)p.o + ((size_t)b * p.sq * p.hq + h) * p.dv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row_a + 8 * r;
    if (qpos >= p.sq) continue;
    if (p.lse != nullptr && lane % 4 == 0)   // m and l in log2 units
      p.lse[((size_t)b * p.hq + h) * p.sq + qpos] =
          (m[r] + log2f(denom[r])) * kLn2;
    bf16* orow = og + (size_t)qpos * p.hq * p.dv;
#pragma unroll
    for (int j = 0; j < 8 * NS; ++j) {
      const int col = 8 * j + col_t;
      if (col < p.dv)   // Dv a multiple of 8: whole aligned pairs
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / denom[r],
                                  acc[4 * j + 2 * r + 1] / denom[r]);
    }
  }
}

template <int NS>
int launch(const Params& p, const Shape& sh, int batch, const CUtensorMap& mq,
           const CUtensorMap& mk, const CUtensorMap& mv,
           cudaStream_t stream) {
  const size_t bytes = Smem<NS>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wg_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.hq, (p.sq + 2 * kRows - 1) / (2 * kRows), batch);
  flash_wg_kernel<NS><<<grid, 3 * kWG, bytes, stream>>>(mq, mk, mv, p, sh);
  return (int)cudaGetLastError();
}

int run(const Params& p, int batch, cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, p.q, batch, p.sq, p.hq, p.d);
  if (err == 0) err = make_map(&mk, p.k, batch, p.skv, p.hkv, p.d);
  if (err == 0) err = make_map(&mv, p.v, batch, p.skv, p.hkv, p.dv);
  if (err != 0) return err;
  const Shape sh = mma_path::shape_of(p);
  switch (((p.d > p.dv ? p.d : p.dv) + 63) / 64) {
    case 1: return launch<1>(p, sh, batch, mq, mk, mv, s);
    case 2: return launch<2>(p, sh, batch, mq, mk, mv, s);
    case 3: return launch<3>(p, sh, batch, mq, mk, mv, s);
    default: return launch<4>(p, sh, batch, mq, mk, mv, s);
  }
}

// The register-A check of the P·V product: c[64, 64·NS] (f32) =
// bf16(q · kᵀ) · v for q, k [64, 256] and v [64, 64·NS] bf16 — the
// score product (both K-major from TMA-loaded tiles), its accumulator
// rounded and packed as the A fragments (pack_weights), and the sum
// product with v MN-major, exactly as flash_wg_kernel chains them
template <int NS>
__global__ void __launch_bounds__(kWG, 1)
wgmma_pv_tile_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, float* c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bar;
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_tile = base, k_tile = base + 4 * kSlabBytes;
  const uint32_t v_tile = base + 8 * kSlabBytes;
  const uint32_t bar_addr = smem_addr(&bar);
  if (threadIdx.x == 0) {
    mbar_init(bar_addr, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar_addr, (8 + NS) * kSlabBytes);
    load_tile(q_tile, &mq, bar_addr, 4, 0, 0, 0);
    load_tile(k_tile, &mk, bar_addr, 4, 0, 0, 0);
    load_tile(v_tile, &mv, bar_addr, NS, 0, 0, 0);
  }
  mbar_wait(bar_addr, 0);
  float s[32], acc[32 * NS];
  uint32_t pw[16];
  zero(acc);
  wg_fence();
  product_ss<4>(s, q_tile, k_tile);
  wg_commit();
  wg_wait<0>();
  reg_fence(s);
  pack_weights(s, pw);
  reg_fence(acc);
  wg_fence();
  product_rs<NS>(acc, pw, v_tile);
  wg_commit();
  wg_wait<0>();
  reg_fence(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16 + lane / 4, col_t = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 32 * NS; ++i) {
    const int row = row0 + 8 * ((i / 2) % 2);
    const int col = (i / 4) * 8 + col_t + (i % 2);
    c[row * 64 * NS + col] = acc[i];
  }
}

template <int NS>
int pv_tile(const void* q, const void* k, const void* v, float* c,
            cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, 1, 64, 1, 256);
  if (err == 0) err = make_map(&mk, k, 1, 64, 1, 256);
  if (err == 0) err = make_map(&mv, v, 1, 64, 1, 64 * NS);
  if (err != 0) return err;
  const size_t bytes = 1024 + (8 + NS) * kSlabBytes;
  const cudaError_t set = cudaFuncSetAttribute(
      wgmma_pv_tile_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (set != cudaSuccess) return (int)set;
  wgmma_pv_tile_kernel<NS><<<1, kWG, bytes, s>>>(mq, mk, mv, c);
  return (int)cudaGetLastError();
}

}  // namespace wg_path

// calls of the forward by route: wg_path, mma_path (bf16), fma_path (f32)
long long routes[3] = {0, 0, 0};

int check(const Params& p, int batch) {
  if (p.d < 1 || p.d > 256 || p.dv < 1 || p.dv > 256 || p.hkv < 1 ||
      p.hq % p.hkv)
    return (int)cudaErrorInvalidValue;
  return batch == 0 || p.sq == 0 ? -1 : 0;
}

}  // namespace

// q[B, Sq, Hq, D], k[B, Skv, Hkv, D], v[B, Skv, Hkv, Dv] → o[B, Sq, Hq, Dv],
// all contiguous; D, Dv <= 256, Hq a multiple of Hkv.  softcap 0 means
// none, window < 0 means none.  lse, when not null, receives each row's
// log-sum-exp of its (scaled, capped, masked) scores [B, Hq, Sq], which
// the backward (flash_attention_bwd.cu) recomputes the probabilities
// from; a row that sees no key gets about -1e30.
extern "C" int repro_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int batch, int sq, int skv, int hq, int hkv, int d, int dv, float scale,
    float softcap, int causal, int window, void* stream) {
  const Params p = {q, k, v, o, lse, sq, skv, hq, hkv, d, dv, scale,
                    softcap, causal, window};
  const int c = check(p, batch);
  if (c != 0) return c < 0 ? (int)cudaSuccess : c;
  ++routes[2];
  return fma_path::run(p, batch, (cudaStream_t)stream);
}

// bf16: the wgmma route where TMA tensor maps can describe the operands
// (wg_path::takes), else the mma.sync route
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int batch, int sq, int skv, int hq, int hkv, int d, int dv, float scale,
    float softcap, int causal, int window, void* stream) {
  const Params p = {q, k, v, o, lse, sq, skv, hq, hkv, d, dv, scale,
                    softcap, causal, window};
  const int c = check(p, batch);
  if (c != 0) return c < 0 ? (int)cudaSuccess : c;
  if (wg_path::takes(p)) {
    ++routes[0];
    return wg_path::run(p, batch, (cudaStream_t)stream);
  }
  ++routes[1];
  return mma_path::run(p, batch, (cudaStream_t)stream);
}

// The bf16 forward on the mma.sync route whatever the operands, to time
// and check the route the dispatch above leaves to the shapes TMA cannot
// describe; the same arguments
extern "C" int repro_flash_attention_bf16_mma(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int batch, int sq, int skv, int hq, int hkv, int d, int dv, float scale,
    float softcap, int causal, int window, void* stream) {
  const Params p = {q, k, v, o, lse, sq, skv, hq, hkv, d, dv, scale,
                    softcap, causal, window};
  const int c = check(p, batch);
  if (c != 0) return c < 0 ? (int)cudaSuccess : c;
  ++routes[1];
  return mma_path::run(p, batch, (cudaStream_t)stream);
}

// The forward's calls by route since the library loaded: out[0] wgmma,
// out[1] mma.sync, out[2] FMA (f32)
extern "C" int repro_flash_attention_routes(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = routes[i];
  return 0;
}

// The register-A check of the forward's P·V (wg_path::wgmma_pv_tile_kernel):
// c[64, n] f32 = bf16(q[64, 256] · k[64, 256]ᵀ) · v[64, n], n = 64, 128, 192
// or 256, all contiguous bf16, 16-byte aligned
extern "C" int repro_wgmma_pv_tile_bf16(const void* q, const void* k,
                                        const void* v, float* c, int n,
                                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 64: return wg_path::pv_tile<1>(q, k, v, c, s);
    case 128: return wg_path::pv_tile<2>(q, k, v, c, s);
    case 192: return wg_path::pv_tile<3>(q, k, v, c, s);
    case 256: return wg_path::pv_tile<4>(q, k, v, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
