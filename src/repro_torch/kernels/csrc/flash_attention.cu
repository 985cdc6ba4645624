// Streaming-softmax (flash) attention for sm_90a: causal, GQA (kv head
// h / G), sliding window and tanh logit soft-capping, f32 or bf16 operands.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the
// pallas_call at flash_attention.py:109).
//
// What bounds it on an H100: per (query, key) pair D + Dv multiply-adds
// against (D + Dv) · elem bytes read once per key row: at the gemma2-9b
// widths (D = Dv = 256, 16 query heads over 8 kv heads, S = 8192) that
// is thousands of operations per byte, so operations bound it — in bf16
// the tensor cores' 989 TFLOP/s, in f32 the 67 TFLOP/s of plain FMA.
//
// What the design does about it: the TPU grid (B, Hq, Sq/bq, Skv/bk)
// walked the kv axis sequentially with m, l and the accumulator in VMEM
// scratch; here one CUDA block owns a 64-row query tile of one (batch,
// head) and loops over the keys in 64-row tiles itself, with m, l and the
// 64 × Dv accumulator in registers (4 rows × up to 64 columns a thread),
// so score tiles never leave the SM.  At D = 256 a 128-row f32 K and V
// tile pair alone would be 256 KB, over the 227 KB a block may have, so
// the inner tiles are 64 × 64 whatever block_q/block_k are (the
// reference's blocks only set its grid; the result does not depend on
// them): Q stays staged in shared memory, one buffer holds first the K
// tile, then the V tile, and a third holds the probabilities — 150 KB at
// D = Dv = 256, one block per SM.  Scores and P·V are f32 FMA from shared
// memory (bf16 is widened when staged, p rounded to bf16 before P·V as
// the reference's p.astype(v.dtype) does); no mma.sync, wgmma or TMA yet,
// and every kv tile is visited, masked or not, as the reference visits
// them.  The reference's order is kept: scale, softcap c·tanh(s/c), mask
// to -1e30 (not -inf: an all-masked row would compute -inf - -inf = NaN),
// exp(s - m_new) zeroed where s <= -5e29, corr = exp(m_prev - m_new).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTileQ = 64;      // query rows per CUDA block
constexpr int kTileK = 64;      // key/value rows per inner step
constexpr int kThreads = 256;   // 16 × 16: 4 rows × 4 score columns each
constexpr int kLdP = kTileK + 4;
constexpr float kNegInf = -1e30f;
static_assert(kTileQ == kTileK, "stage() copies kTileK rows of Q too");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// p as the P·V product sees it: rounded to the operands' type
template <typename T> __device__ __forceinline__ float as_operand(float x) {
  return widen(narrow<T>(x));
}

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, skv, hq, hkv, d, dv;
  int ld;          // shared row stride of the Q and K tiles, in floats
  float scale;
  float softcap;   // 0: none
  int causal;
  int window;      // < 0: none
};

// Stage rows [row0, row0 + kTileK) of a [*, n_cols] operand (row stride
// `stride` elements) as f32 into `dst` (row stride `ld`), zero past the
// last row and past n_cols up to `width`.
template <typename T>
__device__ void stage(float* dst, int ld, int width, const T* src,
                      size_t stride, int row0, int n_rows, int n_cols) {
  for (int i = threadIdx.x; i < kTileK * width; i += kThreads) {
    const int r = i / width;
    const int c = i - r * width;
    float x = 0.f;
    if (row0 + r < n_rows && c < n_cols)
      x = widen(src[(size_t)(row0 + r) * stride + c]);
    dst[r * ld + c] = x;
  }
}

// NG: groups of 64 value columns (Dv <= 64 · NG)
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
flash_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLdV = NG * 64;
  float* qs = smem;                                   // [kTileQ][ld]
  float* kv = qs + kTileQ * p.ld;                     // K [kTileK][ld], V [kTileK][kLdV]
  float* ps = kv + kTileK * max(p.ld, kLdV);          // [kTileQ][kLdP]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int d4 = (p.d + 3) & ~3;

  const T* qg = (const T*)p.q + ((size_t)b * p.sq * p.hq + h) * p.d;
  const T* kg = (const T*)p.k + ((size_t)b * p.skv * p.hkv + hk) * p.d;
  const T* vg = (const T*)p.v + ((size_t)b * p.skv * p.hkv + hk) * p.dv;
  T* og = (T*)p.o + ((size_t)b * p.sq * p.hq + h) * p.dv;

  stage(qs, p.ld, d4, qg, (size_t)p.hq * p.d, q0, p.sq, p.d);

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

  for (int k0 = 0; k0 < p.skv; k0 += kTileK) {
    __syncthreads();   // the last tile's P·V is done with kv and ps
    stage(kv, p.ld, d4, kg, (size_t)p.hkv * p.d, k0, p.skv, p.d);
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
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * p.ld + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kw[j] = *reinterpret_cast<const float4*>(&kv[(tx + 16 * j) * p.ld + c]);
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
        if (s[i][j] <= kNegInf / 2) pv = 0.f;   // fully-masked tile guard
        row_sum += pv;
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = as_operand<T>(pv);
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
    T* orow = og + (size_t)qpos * p.hq * p.dv;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g * 64 + tx * 4 + e;
        if (col < p.dv) orow[col] = narrow<T>(acc[i][g][e] / denom);
      }
  }
}

template <typename T, int NG>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int ldv = NG * 64;
  const size_t bytes = sizeof(float) *
      ((size_t)kTileQ * p.ld + (size_t)kTileK * (p.ld > ldv ? p.ld : ldv) +
       (size_t)kTileQ * kLdP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kTileQ - 1) / kTileQ, p.hq, batch);
  flash_kernel<T, NG><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int batch,
        int sq, int skv, int hq, int hkv, int d, int dv, float scale,
        float softcap, int causal, int window, void* stream) {
  if (d < 1 || d > 256 || dv < 1 || dv > 256 || hkv < 1 || hq % hkv)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return (int)cudaSuccess;
  // an odd multiple of 4 floats: the 16 key rows a half-warp reads as
  // float4 fall on distinct banks
  int words = (d + 3) / 4;
  if (words % 2 == 0) ++words;
  const Params p = {q, k, v, o, sq, skv, hq, hkv, d, dv, 4 * words, scale,
                    softcap, causal, window};
  cudaStream_t s = (cudaStream_t)stream;
  switch ((dv + 63) / 64) {
    case 1: return launch<T, 1>(p, batch, s);
    case 2: return launch<T, 2>(p, batch, s);
    case 3: return launch<T, 3>(p, batch, s);
    default: return launch<T, 4>(p, batch, s);
  }
}

}  // namespace

// q[B, Sq, Hq, D], k[B, Skv, Hkv, D], v[B, Skv, Hkv, Dv] → o[B, Sq, Hq, Dv],
// all contiguous; D, Dv <= 256, Hq a multiple of Hkv.  softcap 0 means
// none, window < 0 means none.
extern "C" int repro_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int batch, int sq,
    int skv, int hq, int hkv, int d, int dv, float scale, float softcap,
    int causal, int window, void* stream) {
  return run<float>(q, k, v, o, batch, sq, skv, hq, hkv, d, dv, scale,
                    softcap, causal, window, stream);
}

extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int batch, int sq,
    int skv, int hq, int hkv, int d, int dv, float scale, float softcap,
    int causal, int window, void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, batch, sq, skv, hq, hkv, d, dv,
                            scale, softcap, causal, window, stream);
}
