// The gradient of the Mamba-2 SSD chunked scan (mamba2_ssd.cu) for
// sm_90a: dx, d(dt·A), dB and dC from the output gradient dy, chunk by
// chunk in the forward's layout and at the kernel's own chunk.
//
// Replaces: nothing of the TPU kernel, which has no backward body — the
// reference differentiates its jnp scan (src/repro/models/ssm.py
// _ssd_chunked under jax.value_and_grad); the forward it differentiates
// is src/repro/kernels/mamba2_ssd.py::_ssd_kernel (pallas_call at :78).
//
// The algorithm (Dao & Gu 2024, arXiv:2405.21060, §6–7, run backwards).
// Within chunk c of L tokens, la the cumsum of dt·A, S_c the state before
// the chunk and w_j = exp(la_L − la_j):
//   y_i     = exp(la_i)·C_i·S_cᵀ + Σ_{j<=i} (C_i·B_j)·exp(la_i − la_j)·x_j
//   S_{c+1} = exp(la_L)·S_c + Σ_j w_j·x_j ⊗ B_j.
// With G_{c+1} the gradient of the state after chunk c,
//   G_c = Σ_i exp(la_i)·dy_i ⊗ C_i + exp(la_L)·G_{c+1},
// so the backward runs, after the forward's passes (a) and (b) again
// into scratch (the forward keeps no state: under remat it would be
// recomputed anyway, and kept it is B·(S/64)·H·P·N f32 a layer):
//   (a′) chunk_state_kernel<true> (ssd_common.cuh): each chunk's own
//        Σ_i exp(la_i)·dy_i ⊗ C_i, the transpose of pass (c)'s inter term;
//   (b′) state_pass_kernel<true>: the reverse pass, one thread per state
//        element, slot c getting G_{c+1};
//   (c′) chunk_grad_kernel, one block per (head, chunk, batch), with
//        M = (C·Bᵀ)∘E, Q = (dy·xᵀ)∘E, E_ij = exp(la_i − la_j) for j <= i:
//          dx = Mᵀ·dy + w∘(B·G_{c+1}ᵀ)
//          dB = Qᵀ·C  + w∘(x·G_{c+1})
//          dC = Q·B   + exp(la)∘(dy·S_c)
//        and d la from four terms — the pairs (+ row sums, − column sums
//        of M∘(dy·xᵀ)), the inter term (C_i·dC_inter_i), the chunk's
//        contribution to the next state (− u_j at j, + Σ u_j at L, u_j =
//        w_j·B_j·(x·G)_j) and the decay of the carried state (+
//        exp(la_L)·Σ S_c∘G_{c+1} at L) — then d(dt·A) as d la's reverse
//        cumsum within the chunk.  Dropping any one term leaves only
//        d(dt·A) wrong.
//
// What bounds it on an H100: per chunk five L × L products (over N or P,
// half of each masked) and four of L·P·N (with (a′) and the recomputed
// (a)), against (3·P + 4·N + 2)·4 bytes a token moved once: operations,
// at the 67 TFLOP/s of f32 FMA.
//
// What the design does about it: as the forward's pass (c), the eight
// 64 × 64 products of (c′) run on the tensor cores in error-compensated
// TF32 (warp_mma3, ~2^-21 of each product lost), 8 warps of 16 × 32, the
// masked halves skipped where a warp's rows or keys allow.  exp(la_i −
// la_j) is computed only where j <= i and selected (an overflow times a
// mask would be NaN).  The chunk's eight operand and product tiles (C, B,
// x, dy, S_c, G_{c+1}, M, Q) take 140 KB of shared memory, one block a
// SM.  Every sum is taken in a fixed order (row and column sums by
// shuffles, then across warps through shared memory): the gradient is
// the same run to run.
#include "ssd_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct GradParams {
  const float* x;        // [B, S, H, P]
  const float* da;       // [B, S, H]
  const float* bm;       // [B, S, H, N]
  const float* cm;       // [B, S, H, N]
  const float* dy;       // [B, S, H, P]
  const float* states;   // [B, S/chunk, H, P, N]: the state before chunk c
  const float* grads;    // [B, S/chunk, H, P, N]: G_{c+1}
  float* dx;             // [B, S, H, P]
  float* dda;            // [B, S, H]
  float* dbm;            // [B, S, H, N]
  float* dcm;            // [B, S, H, N]
  int s, h, p, n, chunk;
};

// a row of a 16 × 32 warp tile (d[nt][e] at row g + 8·(e >> 1)): the sum
// of its 32 columns, in every lane of the row's quad
__device__ __forceinline__ float row_sum(const float (&v)[4][4], int half) {
  float s = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) s += v[nt][2 * half] + v[nt][2 * half + 1];
  s += __shfl_xor_sync(kFull, s, 1);
  return s + __shfl_xor_sync(kFull, s, 2);
}

// (c′): one chunk's dx, dB, dC and d(dt·A).  Warp w owns rows 16·(w % 4)
// and columns 32·(w / 4) of each 64 × 64 product.
__global__ void __launch_bounds__(kThreads, 1)
chunk_grad_kernel(GradParams prm) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                 // [kTile][kLd]: C rows
  float* bs = cs + kTile * kLd;     // B rows
  float* xs = bs + kTile * kLd;     // x rows
  float* ys = xs + kTile * kLd;     // dy rows
  float* ss = ys + kTile * kLd;     // [kMaxDim][kLd]: S_c, [p][n]
  float* gsm = ss + kMaxDim * kLd;  // G_{c+1}, [p][n]
  float* ms = gsm + kMaxDim * kLd;  // [kTile][kLd]: M, [i][j]
  float* qs = ms + kTile * kLd;     // Q, [i][j]
  float* la = qs + kTile * kLd;     // [kTile]
  float* roww = la + kTile;         // [2][kTile]: row sums of M∘(dy·xᵀ)
  float* colw = roww + 2 * kTile;   // [4][kTile]: its column sums
  float* upart = colw + 4 * kTile;  // [2][kTile]: u_j
  float* vpart = upart + 2 * kTile; // [2][kTile]: C_i·dC_inter_i
  float* red = vpart + 2 * kTile;   // [8 + 2]: Σ S∘G per warp, scan carry

  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int L = prm.chunk, nc = prm.s / L;
  const size_t tok0 = (size_t)b * prm.s + (size_t)c * L;
  const size_t xstride = (size_t)prm.h * prm.p;
  const size_t bstride = (size_t)prm.h * prm.n;
  const size_t slot = (((size_t)b * nc + c) * prm.h + hh) * prm.p * prm.n;
  const bool xvec = (prm.p & 3) == 0, bvec = (prm.n & 3) == 0;

  stage(cs, prm.cm + (tok0 * prm.h + hh) * prm.n, bstride, prm.n, L, bvec);
  stage(bs, prm.bm + (tok0 * prm.h + hh) * prm.n, bstride, prm.n, L, bvec);
  stage(xs, prm.x + (tok0 * prm.h + hh) * prm.p, xstride, prm.p, L, xvec);
  stage(ys, prm.dy + (tok0 * prm.h + hh) * prm.p, xstride, prm.p, L, xvec);
  stage(ss, prm.states + slot, prm.n, prm.n, prm.p, bvec);
  stage(gsm, prm.grads + slot, prm.n, prm.n, prm.p, bvec);
  cp_commit();
  chunk_cumsum(la, prm.da + tok0 * prm.h + hh, prm.h, L);
  cp_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int g = lane >> 2, t = lane & 3;
  const int kn = (prm.n + 7) & ~7, kp = (prm.p + 7) & ~7;
  const int kl = (L + 7) & ~7;
  const float la_last = la[L - 1];

  // ---- C·Bᵀ and dy·xᵀ at (i, j); keys past this warp's rows are masked
  {
    float cb[4][4] = {}, dxm[4][4] = {};
    if (n0 <= m0 + 15) {
      warp_mma3<false>(cb, cs, kLd, m0, bs, kLd, n0, kn);
      warp_mma3<false>(dxm, ys, kLd, m0, xs, kLd, n0, kp);
    }
    float w[4][4];   // M∘(dy·xᵀ), the pairs' d la
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + g + 8 * (e >> 1);
        const int j = n0 + 8 * nt + 2 * t + (e & 1);
        const float E = (j <= i && i < L) ? expf(la[i] - la[j]) : 0.f;
        const float mv = cb[nt][e] * E;
        ms[i * kLd + j] = mv;
        qs[i * kLd + j] = dxm[nt][e] * E;
        w[nt][e] = mv * dxm[nt][e];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float s = row_sum(w, half);
      if (t == 0) roww[(warp >> 2) * kTile + m0 + g + 8 * half] = s;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        float s = w[nt][e1] + w[nt][2 + e1];
        s += __shfl_xor_sync(kFull, s, 4);
        s += __shfl_xor_sync(kFull, s, 8);
        s += __shfl_xor_sync(kFull, s, 16);
        if (g == 0) colw[(warp & 3) * kTile + n0 + 8 * nt + 2 * t + e1] = s;
      }
  }
  // Σ S_c∘G_{c+1} (zero past P and N), per warp
  {
    float s = 0.f;
    for (int i = threadIdx.x; i < kMaxDim * kMaxDim; i += kThreads) {
      const int r = i / kMaxDim, col = i - r * kMaxDim;
      s = fmaf(ss[r * kLd + col], gsm[r * kLd + col], s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) red[warp] = s;
  }
  __syncthreads();   // M and Q are whole

  // rows of this warp in the fragments, and their weights
  const int r0 = m0 + g, r1 = m0 + g + 8;
  const float wr[2] = {r0 < L ? expf(la_last - la[r0]) : 0.f,
                       r1 < L ? expf(la_last - la[r1]) : 0.f};
  const float er[2] = {expf(la[min(r0, L - 1)]), expf(la[min(r1, L - 1)])};

  // store a 16 × 32 warp tile's rows < L and columns < width to a
  // token-major [., stride] operand
  auto store = [&](float* dst, size_t stride, int width,
                   const float (&v)[4][4]) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int ri = m0 + g + 8 * e2;
      if (ri >= L) continue;
      float* row = dst + (tok0 + ri) * stride;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int col = n0 + 8 * nt + 2 * t + e1;
          if (col < width) row[col] = v[nt][2 * e2 + e1];
        }
    }
  };

  // ---- dx = Mᵀ·dy + w∘(B·Gᵀ): rows j, columns p; pairs i >= j
  {
    float a1[4][4] = {}, a2[4][4] = {};
    if (n0 < kp) {
      warp_mma3<true, true>(a1, ms, kLd, m0, ys, kLd, n0, kl, m0);
      warp_mma3<false>(a2, bs, kLd, m0, gsm, kLd, n0, kn);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) a1[nt][e] += wr[e >> 1] * a2[nt][e];
    store(prm.dx + hh * prm.p, xstride, prm.p, a1);
  }
  // ---- dB = Qᵀ·C + w∘(x·G): rows j, columns n; u_j = w_j·B_j·(x·G)_j
  {
    float a1[4][4] = {}, a2[4][4] = {};
    if (n0 < kn) {
      warp_mma3<true, true>(a1, qs, kLd, m0, cs, kLd, n0, kl, m0);
      warp_mma3<true>(a2, xs, kLd, m0, gsm, kLd, n0, kp);
    }
    float u[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = m0 + g + 8 * (e >> 1);
        const int col = n0 + 8 * nt + 2 * t + (e & 1);
        const float xg = wr[e >> 1] * a2[nt][e];
        u[nt][e] = xg * bs[ri * kLd + col];
        a1[nt][e] += xg;
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float s = row_sum(u, half);
      if (t == 0) upart[(warp >> 2) * kTile + m0 + g + 8 * half] = s;
    }
    store(prm.dbm + hh * prm.n, bstride, prm.n, a1);
  }
  // ---- dC = Q·B + exp(la)∘(dy·S): rows i, columns n; pairs j <= i;
  // v_i = C_i·(the inter term)
  {
    float a1[4][4] = {}, a2[4][4] = {};
    if (n0 < kn) {
      warp_mma3<true>(a1, qs, kLd, m0, bs, kLd, n0, min(m0 + 16, kl));
      warp_mma3<true>(a2, ys, kLd, m0, ss, kLd, n0, kp);
    }
    float v[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = m0 + g + 8 * (e >> 1);
        const int col = n0 + 8 * nt + 2 * t + (e & 1);
        const float inter = er[e >> 1] * a2[nt][e];
        v[nt][e] = inter * cs[ri * kLd + col];
        a1[nt][e] += inter;
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float s = row_sum(v, half);
      if (t == 0) vpart[(warp >> 2) * kTile + m0 + g + 8 * half] = s;
    }
    store(prm.dcm + hh * prm.n, bstride, prm.n, a1);
  }
  __syncthreads();

  // ---- d la per token, then d(dt·A) = its reverse cumsum in the chunk
  if (threadIdx.x < kTile) {
    const int k = threadIdx.x;
    float d = 0.f;
    if (k < L) {
      d = roww[k] + roww[kTile + k]
          - (colw[k] + colw[kTile + k] + colw[2 * kTile + k]
             + colw[3 * kTile + k])
          + vpart[k] + vpart[kTile + k] - (upart[k] + upart[kTile + k]);
      if (k == L - 1) {   // the carried state's decay and Σ_j u_j
        float sg = 0.f, su = 0.f;
        for (int i = 0; i < kThreads / 32; ++i) sg += red[i];
        for (int j = 0; j < L; ++j) su += upart[j] + upart[kTile + j];
        d += expf(la_last) * sg + su;
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(kFull, d, off);
      if (lane + off < 32) d += o;
    }
    if (k == 32) red[8] = d;   // the second warp's total
    __syncwarp();
    asm volatile("bar.sync 1, 64;\n" ::: "memory");
    if (k < 32) d += red[8];
    if (k < L) prm.dda[(tok0 + k) * prm.h + hh] = d;
  }
}

constexpr size_t kGradSmem =
    sizeof(float) * (6 * kTile * kLd + 2 * kMaxDim * kLd + 11 * kTile + 10);

}  // namespace

// The backward's passes over the forward's operands and the output
// gradient dy[B, S, H, P], all f32 and contiguous, at the forward's
// chunk (<= 64, dividing S).  Before them, the forward's passes (a) and
// (b) (repro_ssd_chunk_state_f32, repro_ssd_state_pass_f32) fill
// states[B, S/chunk, H, P, N] with the state before each chunk and
// decay[B, S/chunk, H] with exp(la_L).  Launch in order on one stream.

// (a′) each chunk's own Σ_i exp(la_i)·dy_i ⊗ C_i into grads[B, S/chunk,
// H, P, N]
extern "C" int repro_ssd_chunk_state_grad_f32(const void* dy, const void* da,
                                              const void* cm, void* grads,
                                              int batch, int s, int h, int p,
                                              int n, int chunk,
                                              void* stream) {
  if (!shape_ok(p, n, chunk, s)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || s == 0 || h == 0) return (int)cudaSuccess;
  const Params prm = {(const float*)dy, (const float*)da, (const float*)cm,
                      nullptr, nullptr, (float*)grads, nullptr,
                      s, h, p, n, chunk};
  return (int)launch_chunk_state<true>(prm, batch, (cudaStream_t)stream);
}

// (b′) slot c of `grads` becomes G_{c+1}, the gradient of the state after
// chunk c
extern "C" int repro_ssd_state_grad_pass_f32(void* grads, const void* decay,
                                             int batch, int s, int h, int p,
                                             int n, int chunk,
                                             void* stream) {
  if (!shape_ok(p, n, chunk, s)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || s == 0 || h == 0) return (int)cudaSuccess;
  return (int)launch_state_pass<true>((float*)grads, (const float*)decay,
                                      nullptr, batch, s, h, p, n, chunk,
                                      (cudaStream_t)stream);
}

// (c′) dx, dda, dB, dC from x, da, B, C, dy, the states and the state
// gradients
extern "C" int repro_ssd_chunk_grad_f32(
    const void* xdt, const void* da, const void* bm, const void* cm,
    const void* dy, const void* states, const void* grads, void* dx,
    void* dda, void* dbm, void* dcm, int batch, int s, int h, int p, int n,
    int chunk, void* stream) {
  if (!shape_ok(p, n, chunk, s)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || s == 0 || h == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kGradSmem);
  if (err != cudaSuccess) return (int)err;
  const GradParams prm = {
      (const float*)xdt, (const float*)da, (const float*)bm,
      (const float*)cm, (const float*)dy, (const float*)states,
      (const float*)grads, (float*)dx, (float*)dda, (float*)dbm,
      (float*)dcm, s, h, p, n, chunk};
  chunk_grad_kernel<<<dim3(h, s / chunk, batch), kThreads, kGradSmem,
                      (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}
