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
// mask runs only where a warp's rows straddle an edge (causal diagonal,
// window edge, ragged Skv); a warp whose 16 rows see none of a tile skips
// it, for the same reason.
//
// bf16 (the timed path), FlashAttention-2 style on the tensor cores: a
// 128-row query tile, eight warps of 16 rows each.  Q·Kᵀ and P·V are
// mma.sync.m16n8k16 (bf16 operands, f32 accumulation), fed by ldmatrix
// (.trans for V).  The score fragment stays in registers: scale, softcap,
// mask and the online softmax run on it, the row max by shuffles across
// the 4 threads that share a row (the row sum l is kept per thread and
// reduced once at the end).  p is rounded to bf16 in registers and used
// directly as P·V's A operand — the C layout of two adjacent n8 score
// tiles is the A layout of one k16 step — while l sums the unrounded p,
// as the reference's p.astype(v.dtype) and sum(p) do.  K and V tiles are
// staged with 16-byte cp.async into a two-stage ring (tile t+1 loads
// while tile t is computed; one barrier per tile).  D and Dv are
// zero-padded to a multiple of 16 in shared memory, and every row is
// padded by 16 bytes, an odd number of 16-byte units, so the 8 rows an
// ldmatrix reads fall on distinct bank groups (a 512-byte stride would put
// them all on one).  Q, plus two stages of K and V, at D = Dv = 256 is
// 198 KB, one block per SM.  The Dv = 256 accumulator is 128 f32
// registers a thread; Q's fragments (64 more) do not fit beside it, so Q
// stays in shared memory and is re-read by ldmatrix on every kv tile.
// Blocks are ordered heads fastest — the G query heads of one kv head
// adjacent, sharing K and V in L2 — and the latest (heaviest, under a
// causal mask) query tiles first, to cut the tail.
//
// exp is exp2 of arguments pre-scaled by log2 e (ex2.approx, relative
// error ~2^-22).  The softcap c·tanh(s/c) is c·(1 - 2/(1 + e^{2s/c})):
// one ex2 and one rcp.approx, exact at both ends (e^{2s/c} = inf gives 1,
// 0 gives -1), absolute error ~1e-7·c — tanhf's long software sequence
// would cost about as much as the bound at ~540 M scores a layer.
//
// f32 (not timed at real size) keeps the FMA design: a 64-row query tile,
// scores and P·V as f32 FMA from shared memory with Q, one K-then-V buffer
// and the probabilities staged there (TF32 would not hold rtol 2e-4
// against float64), plus the same tile skip.
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

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTileK = 64;      // key/value rows per inner step (both paths)

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

int run(const Params& p, int batch, cudaStream_t s) {
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
  switch ((sh.dv16 + 63) / 64) {
    case 1: return launch<8>(p, sh, batch, s);
    case 2: return launch<16>(p, sh, batch, s);
    case 3: return launch<24>(p, sh, batch, s);
    default: return launch<32>(p, sh, batch, s);
  }
}

}  // namespace mma_path

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
  return fma_path::run(p, batch, (cudaStream_t)stream);
}

extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int batch, int sq, int skv, int hq, int hkv, int d, int dv, float scale,
    float softcap, int causal, int window, void* stream) {
  const Params p = {q, k, v, o, lse, sq, skv, hq, hkv, d, dv, scale,
                    softcap, causal, window};
  const int c = check(p, batch);
  if (c != 0) return c < 0 ? (int)cudaSuccess : c;
  return mma_path::run(p, batch, (cudaStream_t)stream);
}
