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
//   G_c = Σ_i exp(la_i)·dy_i ⊗ C_i + exp(la_L)·G_{c+1}.
// The backward takes one of two routes (mamba2_ssd.bwd_route).  Where
// the kernel's chunk is 64 and P, N are multiples of 8, the chained-scan
// route below: two launches.  Elsewhere the five passes, which after the
// forward's passes (a) and (b) again into scratch (the forward keeps no
// state: under remat it would be recomputed anyway, and kept it is
// B·(S/64)·H·P·N f32 a layer) run:
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
// half of each masked) and four of L·P·N, against (3·P + 4·N + 2)·4
// bytes a token moved once.  At three TF32 tensor-core products an
// operation (the error compensation, 165 TFLOP/s) the bytes bound it at
// zamba2-7b's layer.
//
// What the five passes' design does about it: as the forward's pass (c),
// the eight 64 × 64 products of (c′) run on the tensor cores in
// error-compensated TF32 (warp_mma3, ~2^-21 of each product lost), 8 warps
// of 16 × 32, the masked halves skipped where a warp's rows or keys allow.  exp(la_i −
// la_j) is computed only where j <= i and selected (an overflow times a
// mask would be NaN).  The chunk's eight operand and product tiles (C, B,
// x, dy, S_c, G_{c+1}, M, Q) take 140 KB of shared memory, one block a
// SM.  Every sum is taken in a fixed order (row and column sums by
// shuffles, then across warps through shared memory): the gradient is
// the same run to run.
#include "ssd_common.cuh"
#include "wgmma_sm90.cuh"

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

// ---------------------------------------------------------------------------
// The chained-scan route: two launches instead of five, where the kernel's
// chunk is 64 tokens and P and N are multiples of 8 up to 64 (the operands'
// rows then suit TMA; the wrapper also asks for 16-byte aligned operands).
//
//   Pass F (ssd_chain_state_kernel): each block takes a ticket (four
//     chunks of one batch row and head) from an atomic counter, forwards:
//     it computes each chunk's own state ds_c = Σ_j w_j·x_j ⊗ B_j, waits
//     for the previous group of its head to publish S_c0, writes S_{c+1} =
//     exp(la_L)·S_c + ds_c for its chunks to `states` and publishes (the
//     first group also writes S_0 = 0).
//   Pass R (ssd_chain_grad_kernel): tickets walk the chunks from the last,
//     one a block.  It computes the chunk's own Σ_i exp(la_i)·dy_i ⊗ C_i
//     and hands it to its chain warpgroup, which waits for G_{c+1} from
//     chunk c + 1 and publishes G_c = local + exp(la_L)·G_{c+1}, while the
//     consumer warpgroups go on with the products that need no G; then
//     they finish (c′)'s body with S_c and G_{c+1}.  G travels through a
//     ring of two slots per (batch, head) (`gring`, 16 KB a slot, resident
//     in L2): chunk c reads slot (c + 1) % 2 and writes slot c % 2, which
//     chunk c + 2 wrote; by then chunk c + 1 has read it, since it
//     published G_{c+1} after reading G_{c+2}.
//   A block only waits for a ticket handed out before its own, whose block
//   is running: progress does not depend on the order blocks start in.
//   Publishing: the writers store, meet at a barrier, and one stores the
//   count with release at GPU scope; the waiting block's one thread polls
//   with acquire, its threads meet at a barrier, and reads go to L2
//   (ld.global.cg: the ring's slots come back to an SM whose L1 may hold an
//   old copy).  Each link is a fixed formula: two runs agree bit for bit.
//
// Products: all ten (pass R's eight of (c′), its own state gradient and
// pass F's chunk state) are 64 × 64 × 64 warpgroup wgmma.mma_async
// m64n32k8 products in TF32, error-compensated as warp_mma3 is (per k8
// step lo·hi, hi·lo, hi·hi, ~2^-21 of each product lost), two consumer
// warpgroups each taking 32 of the 64 output columns.  wgmma reads a TF32
// operand from shared memory only K-major (it transposes no 32-bit
// operand); A may come from registers, loaded from any layout.  So every
// product is written with a K-major B: a TMA tile whose rows run along
// the output columns (C·Bᵀ reads B, dy·xᵀ reads x), or a tile the block
// writes itself (the chunk's M and Q, and the transposes that a sum over
// tokens of two loaded operands needs):
//   Glocᵀ = Cᵀ·(e∘dy)        B: (e∘dy)ᵀ written as [p][i]
//   C·Bᵀ, dy·xᵀ              B: B, x as loaded
//   (dy·S)ᵀ = Sᵀ·dyᵀ          B: dy as loaded
//   dCᵀ  += Bᵀ·Qᵀ             B: Q written as [i][j]
//   dxᵀ   = dyᵀ·M             B: M written as [j][i]
//   dBᵀ   = Cᵀ·Q              B: Q written as [j][i]
//   (B·Gᵀ)ᵀ = G·Bᵀ            B: B as loaded
//   (x·G)ᵀ  = Gᵀ·xᵀ           B: x as loaded
//   ds    = (w∘x)ᵀ·B          B: Bᵀ written as [n][j] (pass F)
// so dx, dB and dC come out transposed in registers and are stored so.
// M, Q (zero above the diagonal) let the products into dx, dB and dC skip
// the half of the reduction a warpgroup's columns never meet.  An operand
// in shared memory is held as its TF32 hi (rounded in place over the
// loaded tile, so the design does not rest on what the tensor cores make
// of f32 bits) and its lo in a tile of its own; an A operand from
// registers is split as it is loaded, or read from the hi and lo tiles,
// half the reduction at a time (32 registers).  TF32 rounding is two
// integer operations (cvt.rna's result at the ALU's full rate).
//
// Shared memory of pass R, 64 × 64 f32 tiles of 16 KB: dy and S_c, then
// B, C and x by TMA on two mbarriers (128-byte swizzle, zero filled past
// P, N); the lo of dy, B and x; G_{c+1} and the chunk's own gradient
// handed to the chain warpgroup; one written operand's hi and lo, reused
// in turn ((e∘dy)ᵀ, Q as [i][j], then per warpgroup M and Q as [j][i]) —
// twelve tiles, 192 KB, plus 4 KB of sums: one block an SM, so a second
// stage of the loaded tiles (80 KB) does not fit the 227 KB a block may
// have.  The block's three warpgroups overlap instead: the chain
// warpgroup (48 registers by setmaxnreg) splits B and x while the
// consumers (224) split dy and write (e∘dy)ᵀ, and waits for and moves G
// while they compute.  Pass F: a ring of two stages of x and B and the
// written Bᵀ's hi and lo, 96 KB, two blocks an SM.
//
// What bounds it: per chunk ten 64³ products × 3 for the compensation on
// the TF32 tensor cores, their operands read from shared memory (a B
// operand twice for hi and once for lo, 48 KB a product), against the
// operands' bytes once; the measured split lives in PERF.md.

namespace chain {

constexpr int kWG = 128;                     // threads of a warpgroup
constexpr int kThreads2 = 2 * kWG;           // two consumer warpgroups
constexpr int kL = 64;                       // the route's chunk
constexpr int kTileBytes = 2 * kSlabBytes;   // 64 × 64 f32, two slabs

struct Params {
  const float* x;    // [B, S, H, P]
  const float* da;   // [B, S, H]
  const float* bm;   // [B, S, H, N]
  const float* cm;   // [B, S, H, N]
  const float* dy;   // [B, S, H, P]
  float* states;     // [B, S/64, H, P, N]: the state before each chunk
  float* gring;      // [B·H, 2, 64·64]: two slots of G, each the bytes of
                     // a swizzled [n][p] tile
  int* sync;         // [2 + 2·B·H]: pass F's and R's ticket counters, then
                     // per (batch, head) the states F has published and
                     // the gradients R has published
  float* dx;         // [B, S, H, P]
  float* dda;        // [B, S, H]
  float* dbm;        // [B, S, H, N]
  float* dcm;        // [B, S, H, N]
  int batch, s, h, p, n;
};

__device__ __forceinline__ int ld_acquire(const int* f) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(f) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* f, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(f), "r"(v)
               : "memory");
}
// one thread: spin until *f >= want; after ~2^26 polls (seconds) the
// publisher is lost, and the kernel traps rather than hang the card
__device__ __forceinline__ void wait_at_least(const int* f, int want) {
  for (long long spins = 0; ld_acquire(f) < want; ++spins)
    if (spins > (1ll << 26)) __trap();
}
// all threads of the block have stored what `f` announces: they meet,
// and one releases v (st.release.gpu orders every write the barrier
// ordered before it, as fence.acq_rel would)
__device__ __forceinline__ void publish(int* f, int v) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(f, v);
}

__device__ __forceinline__ float& at(unsigned char* tile, int r, int c) {
  return *reinterpret_cast<float*>(tile + sw_f32(r, c));
}
__device__ __forceinline__ float at(const unsigned char* tile, int r,
                                    int c) {
  return *reinterpret_cast<const float*>(tile + sw_f32(r, c));
}
// v split into the written operand's hi and lo tiles at (r, c)
__device__ __forceinline__ void put(unsigned char* hi, unsigned char* lo,
                                    int r, int c, float v) {
  uint32_t h, l;
  split_tf32(v, h, l);
  *reinterpret_cast<uint32_t*>(hi + sw_f32(r, c)) = h;
  *reinterpret_cast<uint32_t*>(lo + sw_f32(r, c)) = l;
}
// The transpose of a loaded tile as a written B operand: (r, c) of the
// hi and lo tiles gets the split of s_c·src(c, r) (src = src_hi + src_lo
// where src_lo is given, s = 1 where scale is null), by thread `me` of
// `count`.  A thread reads four rows c..c+3 of one column r and stores
// them as one 16-byte chunk of row r in each tile; a warp covers 8 rows r
// × 4 chunks, so its stores take the fewest wavefronts 512 bytes can and
// its reads meet each bank at most twice.
__device__ __forceinline__ void put_transposed(
    unsigned char* hi, unsigned char* lo, const unsigned char* src_hi,
    const unsigned char* src_lo, const float* scale, int me, int count) {
  for (int i = me; i < kL * 64 / 4; i += count) {
    const int wt = i >> 5, ln = i & 31;
    const int r = 8 * (wt & 7) + (ln & 7), c0 = 4 * ((ln >> 3) + 4 * (wt >> 3));
    uint4 h, l;
    uint32_t* hv = &h.x;
    uint32_t* lv = &l.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = at(src_hi, c0 + e, r);
      if (src_lo != nullptr) v += at(src_lo, c0 + e, r);
      if (scale != nullptr) v *= scale[c0 + e];
      split_tf32(v, hv[e], lv[e]);
    }
    *reinterpret_cast<uint4*>(hi + sw_f32(r, c0)) = h;
    *reinterpret_cast<uint4*>(lo + sw_f32(r, c0)) = l;
  }
}

// a loaded tile's TF32 hi in place and its lo into `lo`, thread `me` of
// `count`
__device__ __forceinline__ void split_tile(unsigned char* tile,
                                           unsigned char* lo, int me,
                                           int count) {
  for (int i = me; i < kTileBytes / 16; i += count) {
    uint4 v = reinterpret_cast<uint4*>(tile)[i], l;
    split_tf32(__uint_as_float(v.x), v.x, l.x);
    split_tf32(__uint_as_float(v.y), v.y, l.y);
    split_tf32(__uint_as_float(v.z), v.z, l.z);
    split_tf32(__uint_as_float(v.w), v.w, l.w);
    reinterpret_cast<uint4*>(tile)[i] = v;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// The A fragments of half a 64 × 64 operand's reduction (four of its
// eight k8 steps, 32 columns), as hi and lo: a product runs in two
// halves, so an A fragment holds 32 registers, not 64
struct AFrag {
  uint32_t hi[16], lo[16];
};
// A(m, k) = tile(m, k), or tile(k, m) with kT, for k in [k0, k0 + 32),
// times kscale[k] where given, split in registers; this thread's rows
// row0 and row0 + 8, columns t and t + 4 of each step
template <bool kT>
__device__ __forceinline__ void a_split(AFrag& a, const unsigned char* tile,
                                        int row0, int t, int k0,
                                        const float* kscale) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = row0 + 8 * (e & 1), k = k0 + 8 * kk + t + 4 * (e >> 1);
      float v = kT ? at(tile, k, m) : at(tile, m, k);
      if (kscale != nullptr) v *= kscale[k];
      split_tf32(v, a.hi[4 * kk + e], a.lo[4 * kk + e]);
    }
}
// the same from a tile already split (hi at `hi`, lo at `lo`)
template <bool kT>
__device__ __forceinline__ void a_pair(AFrag& a, const unsigned char* hi,
                                       const unsigned char* lo, int row0,
                                       int t, int k0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = row0 + 8 * (e & 1), k = k0 + 8 * kk + t + 4 * (e >> 1);
      const uint32_t off = kT ? sw_f32(k, m) : sw_f32(m, k);
      a.hi[4 * kk + e] = *reinterpret_cast<const uint32_t*>(hi + off);
      a.lo[4 * kk + e] = *reinterpret_cast<const uint32_t*>(lo + off);
    }
}

// issue acc (64 × 32) += A · B over half `half` of the reduction in
// error-compensated TF32, per k8 step lo·hi, hi·lo, hi·hi, as one wgmma
// group: B the 32 rows at shared addresses b_hi, b_lo (K-major, 128-byte
// swizzled; the half is a slab) of its hi and lo tiles
__device__ __forceinline__ void issue3(float (&acc)[16], const AFrag& a,
                                       uint32_t b_hi, uint32_t b_lo,
                                       int half) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t off = half * kSlabBytes + kk * 32;
    const uint64_t dh = kmajor_desc(b_hi + off), dl = kmajor_desc(b_lo + off);
    wgmma_tf32_n32(acc, a.lo + 4 * kk, dh);
    wgmma_tf32_n32(acc, a.hi + 4 * kk, dl);
    wgmma_tf32_n32(acc, a.hi + 4 * kk, dh);
  }
  wg_commit();
}

// acc += A · B over the halves [h0, h1) of the reduction (the others
// being zero in the chunk's causal mask), A split from the f32 tile (see
// a_split), one half's fragments at a time
template <bool kT>
__device__ __forceinline__ void product_split(
    float (&acc)[16], const unsigned char* tile, int row0, int t,
    uint32_t b_hi, uint32_t b_lo, const float* kscale = nullptr, int h0 = 0,
    int h1 = 2) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half < h0 || half >= h1) continue;
    AFrag a;
    a_split<kT>(a, tile, row0, t, 32 * half, kscale);
    issue3(acc, a, b_hi, b_lo, half);
    wg_wait<0>();
  }
  reg_fence(acc);
}
// the same with A from split tiles (see a_pair)
template <bool kT>
__device__ __forceinline__ void product_pair(
    float (&acc)[16], const unsigned char* hi, const unsigned char* lo,
    int row0, int t, uint32_t b_hi, uint32_t b_lo, int h0 = 0, int h1 = 2) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half < h0 || half >= h1) continue;
    AFrag a;
    a_pair<kT>(a, hi, lo, row0, t, 32 * half);
    issue3(acc, a, b_hi, b_lo, half);
    wg_wait<0>();
  }
  reg_fence(acc);
}

// the accumulator's element q: row (rows row0, row0 + 8) and column
// (n0 + 8·jj + 2·t, + 1) of the 64 × 64 product
__device__ __forceinline__ int acc_row(int q, int row0) {
  return row0 + 8 * ((q & 3) >> 1);
}
__device__ __forceinline__ int acc_col(int q, int n0, int t) {
  return n0 + 8 * (q >> 2) + 2 * t + (q & 1);
}

// per-column sums over the 64 rows of a warpgroup's 64 × 32 values
// (v[q] at acc_row, acc_col): over this thread's two rows, the warp's
// eight row pairs by shuffles, then out[warp][column] for the 4 warps
__device__ __forceinline__ void column_sums(const float (&v)[16],
                                            float (*out)[kL], int warp,
                                            int g, int n0, int t) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      float s = v[4 * jj + e1] + v[4 * jj + 2 + e1];
      s += __shfl_xor_sync(kFull, s, 4);
      s += __shfl_xor_sync(kFull, s, 8);
      s += __shfl_xor_sync(kFull, s, 16);
      if (g == 0) out[warp][n0 + 8 * jj + 2 * t + e1] = s;
    }
}

__device__ __forceinline__ unsigned char* tile_base(unsigned char* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

// Pass F: one ticket per block, kFChunks chunks of one head, groups
// forwards (see above).  The group's x and B tiles stream through a ring
// of two stages, chunk k + 2 loading once chunk k is read; each chunk's
// own state ds stays in registers, and once the previous group of the
// head has published S_c0 the block writes S_{c+1} = exp(la_L)·S_c +
// ds_c for its chunks: one chain link a group.
constexpr int kFChunks = 4;

__global__ void __launch_bounds__(kThreads2, 2)
ssd_chain_state_kernel(const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mb, Params prm) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float la[kFChunks][kL], wj[kFChunks][kL];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ int ticket;
  // stage s: x and B tiles at base + 2·s tiles; then the written Bᵀ
  unsigned char* const base = tile_base(smem_raw);
  unsigned char* const wh = base + 4 * kTileBytes;
  unsigned char* const wl = wh + kTileBytes;
  const int tid = threadIdx.x, nc = prm.s / kL, nbh = prm.batch * prm.h;
  // chunk k of the group into stage k % 2 (thread 0)
  auto load = [&](int k, int c0, int b, int hh) {
    const uint32_t bar = smem_addr(&bars[k & 1]);
    const uint32_t tx = smem_addr(base) + 2 * (k & 1) * kTileBytes;
    mbar_arrive_expect_tx(bar, 2 * kTileBytes);
    for (int sl = 0; sl < 2; ++sl) {
      tma_load_4d(tx + sl * kSlabBytes, &mx, bar, 32 * sl, hh,
                  (c0 + k) * kL, b);
      tma_load_4d(tx + kTileBytes + sl * kSlabBytes, &mb, bar, 32 * sl, hh,
                  (c0 + k) * kL, b);
    }
  };
  // chunk c's state is needed before chunk c + 1 only: the last chunk's
  // ds is not computed; kc chunks of the group are
  if (tid == 0) {
    const int tk = atomicAdd(prm.sync, 1);
    ticket = tk;
    const int c0 = tk / nbh * kFChunks, bh = tk % nbh, b = bh / prm.h;
    const int kc = min(kFChunks, nc - 1 - c0);
    mbar_init(smem_addr(&bars[0]), 1);
    mbar_init(smem_addr(&bars[1]), 1);
    mbar_fence_init();
    for (int k = 0; k < min(kc, 2); ++k) load(k, c0, b, bh - b * prm.h);
  }
  __syncthreads();
  const int c0 = ticket / nbh * kFChunks, bh = ticket % nbh, b = bh / prm.h;
  const int hh = bh - b * prm.h;
  const int kc = min(kFChunks, nc - 1 - c0);
  const size_t slab = (size_t)prm.p * prm.n, cstride = (size_t)prm.h * slab;
  float* const st = prm.states + ((size_t)b * nc * prm.h + hh) * slab;
  if (c0 == 0)
    for (int i = tid; i < (int)slab; i += kThreads2) st[i] = 0.f;
  if (kc <= 0) return;   // the state after the last chunk is not needed

  for (int k = 0; k < kc; ++k) {
    chunk_cumsum(la[k], prm.da + ((size_t)b * prm.s + (size_t)(c0 + k) * kL) *
                                     prm.h + hh, prm.h, kL);
    if (tid < kL) wj[k][tid] = expf(la[k][kL - 1] - la[k][tid]);
  }
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, row0 = 16 * warp + g, n0 = 32 * wg;
  float ds[kFChunks][16] = {};
#pragma unroll
  for (int k = 0; k < kFChunks; ++k) {
    if (k < kc) {
      unsigned char* const tx = base + 2 * (k & 1) * kTileBytes;
      mbar_wait(smem_addr(&bars[k & 1]), (k >> 1) & 1);
      __syncthreads();   // the previous chunk's product has read W; and wj
      // Bᵀ as the B operand: (n, j) = B(j, n)
      put_transposed(wh, wl, tx + kTileBytes, nullptr, nullptr, tid,
                     kThreads2);
      fence_proxy_async();
      __syncthreads();
      // A(p, j) = w_j·x(j, p)
      product_split<true>(ds[k], tx, row0, t, smem_addr(wh) + 128 * n0,
                          smem_addr(wl) + 128 * n0, wj[k]);
      __syncthreads();   // the stage is read: chunk k + 2 may land there
      if (tid == 0 && k + 2 < kc) load(k + 2, c0, b, hh);
    }
  }

  // S_{c+1} = exp(la_L)·S_c + ds_c along the group, S_0 = 0
  int* const done = prm.sync + 2 + bh;
  if (c0 > 0) {
    if (tid == 0) wait_at_least(done, c0);
    __syncthreads();
  }
  const float* cur = st + c0 * cstride;
#pragma unroll
  for (int q = 0; q < 16; q += 2) {
    const int pp = acc_row(q, row0), nn = acc_col(q, n0, t);
    if (pp >= prm.p || nn >= prm.n) continue;
    const size_t o = (size_t)pp * prm.n + nn;
    float2 s = c0 > 0 ? __ldcg(reinterpret_cast<const float2*>(cur + o))
                      : make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kFChunks; ++k) {
      if (k < kc) {
        const float decay = expf(la[k][kL - 1]);
        s = make_float2(fmaf(decay, s.x, ds[k][q]),
                        fmaf(decay, s.y, ds[k][q + 1]));
        __stcg(reinterpret_cast<float2*>(st + (c0 + k + 1) * cstride + o),
               s);
      }
    }
  }
  publish(done, c0 + kc);
}

enum { kC, kDY, kB, kX, kS, kLDY, kLB, kLX, kG, kGL, kWH, kWL, kGradTiles };
// pass R: the two consumer warpgroups and the chain warpgroup; registers
// moved from the third to the consumers
constexpr int kGradThreads = kThreads2 + kWG;
constexpr int kChainRegs = 48, kConsumerRegs = 224;
// a block of 384 threads starts with 65536 / 384 → 168 registers a
// thread; setmaxnreg.inc waits until the chain warpgroup's release covers
// the consumers' request, so the budget must balance or the block hangs
static_assert(kChainRegs + 2 * kConsumerRegs <= 3 * 168,
              "pass R's register budget");
// named barriers of pass R (0 is __syncthreads): each consumer warpgroup
// alone (1 + wg), d la's two warps, the hand-offs between the chain
// warpgroup and the consumers (B and x split, the chunk's own state
// gradient, G_{c+1}), the consumers alone, the chain warpgroup alone
enum { kBarCum = 3, kBarSplit = 4, kBarLocal = 5, kBarG = 6,
       kBarConsumers = 7, kBarChain = 8 };

__device__ __forceinline__ void consumers_sync() {
  bar_sync(kBarConsumers, kThreads2);
}

// Pass R: one ticket per block, chunks from the last (see above).  The
// chain warpgroup takes the ticket, issues the loads and splits B and x
// into hi and lo while the consumers split dy and write (e∘dy)ᵀ; once
// they hand it the chunk's own state gradient Glocᵀ it waits for
// G_{c+1}, copies it in, writes G_c = Glocᵀ + exp(la_L)·G_{c+1} to the
// ring and publishes it, while the consumers go on with the products
// that need no G.  The ring's slots hold G in the swizzled tile layout,
// so it moves 16-byte chunks without index arithmetic.
__global__ void __launch_bounds__(kGradThreads, 1)
ssd_chain_grad_kernel(const __grid_constant__ CUtensorMap mc,
                      const __grid_constant__ CUtensorMap mdy,
                      const __grid_constant__ CUtensorMap mb,
                      const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap ms, Params prm) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float la[kL], ev[kL], wv[kL];
  __shared__ float rows_s[2][kL];   // row sums of M∘(dy·xᵀ), per warpgroup
  __shared__ float cols_s[4][kL];   // its column sums, per warp
  __shared__ float v_s[4][kL];      // C_i·(dC's inter term)_i, per warp
  __shared__ float u_s[4][kL];      // u_j, per warp
  __shared__ float sg_s[4], tot_s;  // Σ S_c∘G_{c+1} per chain warp; d la
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ int ticket;
  unsigned char* const base = tile_base(smem_raw);
  auto T = [&](int k) { return base + k * kTileBytes; };
  auto A = [&](int k) { return smem_addr(base) + k * kTileBytes; };
  const int tid = threadIdx.x, nc = prm.s / kL, nbh = prm.batch * prm.h;
  if (tid == kThreads2) {
    const int tk = atomicAdd(prm.sync + 1, 1);
    ticket = tk;
    const int c = nc - 1 - tk / nbh, bh = tk % nbh, b = bh / prm.h;
    const int hh = bh - b * prm.h;
    const uint32_t b0 = smem_addr(&bars[0]), b1 = smem_addr(&bars[1]);
    mbar_init(b0, 1);
    mbar_init(b1, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(b0, 2 * kTileBytes);
    mbar_arrive_expect_tx(b1, 3 * kTileBytes);
    for (int sl = 0; sl < 2; ++sl) {
      const uint32_t o = sl * kSlabBytes;
      tma_load_4d(A(kDY) + o, &mdy, b0, 32 * sl, hh, c * kL, b);
      tma_load_3d(A(kS) + o, &ms, b0, 32 * sl, 0,
                  ((b * nc) + c) * prm.h + hh);
    }
    for (int sl = 0; sl < 2; ++sl) {
      const uint32_t o = sl * kSlabBytes;
      tma_load_4d(A(kB) + o, &mb, b1, 32 * sl, hh, c * kL, b);
      tma_load_4d(A(kC) + o, &mc, b1, 32 * sl, hh, c * kL, b);
      tma_load_4d(A(kX) + o, &mx, b1, 32 * sl, hh, c * kL, b);
    }
  }
  __syncthreads();
  const int c = nc - 1 - ticket / nbh, bh = ticket % nbh, b = bh / prm.h;
  const int hh = bh - b * prm.h;
  const size_t tok0 = (size_t)b * prm.s + (size_t)c * kL;
  chunk_cumsum(la, prm.da + tok0 * prm.h + hh, prm.h, kL);
  const float la_last = la[kL - 1];
  if (tid < kL) {
    ev[tid] = expf(la[tid]);
    wv[tid] = expf(la_last - la[tid]);
  }
  __syncthreads();   // the last barrier of every thread
  const int lane = tid & 31;

  if (tid >= kThreads2) {   // the chain warpgroup
    setmaxnreg_dec<kChainRegs>();
    const int ct = tid - kThreads2;
    // B and x into hi in place and lo, while the consumers split dy and
    // write (e∘dy)ᵀ
    mbar_wait(smem_addr(&bars[1]), 0);
    split_tile(T(kB), T(kLB), ct, kWG);
    split_tile(T(kX), T(kLX), ct, kWG);
    fence_proxy_async();
    bar_arrive(kBarSplit, kGradThreads);

    const float decay = expf(la_last);
    int* const done = prm.sync + 2 + nbh + bh;
    bar_sync(kBarLocal, kGradThreads);   // Glocᵀ is in T(kGL)
    if (ct == 0 && c < nc - 1) wait_at_least(done, nc - 1 - c);
    bar_sync(kBarChain, kWG);
    const float4* gin = reinterpret_cast<const float4*>(
        prm.gring + ((size_t)bh * 2 + ((c + 1) & 1)) * 4096);
    float4* gout = reinterpret_cast<float4*>(
        prm.gring + ((size_t)bh * 2 + (c & 1)) * 4096);
    float4* tg = reinterpret_cast<float4*>(T(kG));
    const float4* tgl = reinterpret_cast<const float4*>(T(kGL));
    // each thread 8 of the 1024 16-byte chunks, 4 loads in flight
    constexpr int kPer = kTileBytes / 16 / kWG, kBatch = 4;
#pragma unroll
    for (int i0 = 0; i0 < kPer; i0 += kBatch) {
      float4 g[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e)
        g[e] = c < nc - 1 ? __ldcg(gin + (i0 + e) * kWG + ct)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int i = (i0 + e) * kWG + ct;
        tg[i] = g[e];
        if (c > 0) {
          const float4 l = tgl[i];
          __stcg(gout + i, make_float4(fmaf(decay, g[e].x, l.x),
                                       fmaf(decay, g[e].y, l.y),
                                       fmaf(decay, g[e].z, l.z),
                                       fmaf(decay, g[e].w, l.w)));
        }
      }
    }
    // Σ S_c∘G_{c+1}: chunk i of T(kG) holds G(n, p..p+3), n its row (the
    // inverse of sw_f32), against S(p, n) of the [p][n] tile
    float sg = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = k * kWG + ct, r = (i >> 3) & 63;
      const int p0 = 32 * (i >> 9) + 4 * ((i & 7) ^ (r & 7));
      const float4 g = tg[i];
      sg = fmaf(at(T(kS), p0, r), g.x, sg);
      sg = fmaf(at(T(kS), p0 + 1, r), g.y, sg);
      sg = fmaf(at(T(kS), p0 + 2, r), g.z, sg);
      sg = fmaf(at(T(kS), p0 + 3, r), g.w, sg);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sg += __shfl_xor_sync(kFull, sg, o);
    if (lane == 0) sg_s[ct >> 5] = sg;
    bar_arrive(kBarG, kGradThreads);   // T(kG) and sg_s are in place
    if (c > 0) {   // publish G_c
      __threadfence();
      bar_sync(kBarChain, kWG);
      if (ct == 0) st_release(done, nc - c);
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3, row0 = 16 * warp + g, n0 = 32 * wg;
  const uint32_t off = 128 * n0;   // this warpgroup's B-operand rows
  const size_t xrow = (size_t)prm.h * prm.p, brow = (size_t)prm.h * prm.n;

  // dy → hi in place and lo; (e∘dy)ᵀ written as [p][i] from its hi + lo
  mbar_wait(smem_addr(&bars[0]), 0);
  split_tile(T(kDY), T(kLDY), tid, kThreads2);
  consumers_sync();
  put_transposed(T(kWH), T(kWL), T(kDY), T(kLDY), ev, tid, kThreads2);
  fence_proxy_async();
  consumers_sync();
  // the chunk's own state gradient, transposed: Glocᵀ = Cᵀ·(e∘dy), handed
  // to the chain warpgroup
  bar_sync(kBarSplit, kGradThreads);   // and B, x split
  {
    float gl[16] = {};   // A(n, i) = C(i, n)
    product_split<true>(gl, T(kC), row0, t, A(kWH) + off, A(kWL) + off);
#pragma unroll
    for (int q = 0; q < 16; q += 2)
      *reinterpret_cast<float2*>(&at(T(kGL), acc_row(q, row0),
                                     acc_col(q, n0, t))) =
          make_float2(gl[q], gl[q + 1]);
  }
  bar_arrive(kBarLocal, kGradThreads);
  // M = (C·Bᵀ)∘E and Q = (dy·xᵀ)∘E, E_ij = exp(la_i − la_j) for j <= i
  float mm[16] = {}, qq[16] = {};
  product_split<false>(mm, T(kC), row0, t, A(kB) + off, A(kLB) + off);
  product_pair<false>(qq, T(kDY), T(kLDY), row0, t, A(kX) + off,
                      A(kLX) + off);
  {
    float rs[2] = {0.f, 0.f}, w[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int i = acc_row(q, row0), j = acc_col(q, n0, t);
      const float E = j <= i ? expf(la[i] - la[j]) : 0.f;
      mm[q] *= E;
      w[q] = mm[q] * qq[q];   // the pairs' d la
      qq[q] *= E;
      rs[(q & 3) >> 1] += w[q];
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float sum = rs[h2];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      if (t == 0) rows_s[wg][row0 + 8 * h2] = sum;
    }
    column_sums(w, cols_s, warp, g, n0, t);
  }
  consumers_sync();   // every warpgroup is done with (e∘dy)ᵀ
  // dCᵀ = e∘(Sᵀ·dyᵀ) + Bᵀ·Qᵀ: Q as [i][j]; v_i = C_i·(the inter term)_i
#pragma unroll
  for (int q = 0; q < 16; ++q)
    put(T(kWH), T(kWL), acc_row(q, row0), acc_col(q, n0, t), qq[q]);
  fence_proxy_async();
  consumers_sync();
  {
    float dc[16] = {}, v[16];   // A(n, p) = S(p, n)
    product_split<true>(dc, T(kS), row0, t, A(kDY) + off, A(kLDY) + off);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int nn = acc_row(q, row0), i = acc_col(q, n0, t);
      dc[q] *= ev[i];
      v[q] = dc[q] * at(T(kC), i, nn);
    }
    column_sums(v, v_s, warp, g, n0, t);
    // A(n, j) = B(j, n); Q(i, j) = 0 for j > i: the first warpgroup's
    // rows i < 32 need the first half of j only
    product_pair<true>(dc, T(kB), T(kLB), row0, t, A(kWH) + off,
                       A(kWL) + off, 0, 1 + wg);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int nn = acc_row(q, row0), i = acc_col(q, n0, t);
      if (nn < prm.n) prm.dcm[(tok0 + i) * brow + hh * prm.n + nn] = dc[q];
    }
  }
  consumers_sync();   // every warpgroup is done with Q as [i][j]
  // dxᵀ = dyᵀ·M + w∘(G·Bᵀ): M as [j][i], this warpgroup's rows j
#pragma unroll
  for (int q = 0; q < 16; ++q)
    put(T(kWH), T(kWL), acc_col(q, n0, t), acc_row(q, row0), mm[q]);
  fence_proxy_async();
  bar_sync(1 + wg, kWG);
  {
    // A(p, i) = dy(i, p); M(i, j) = 0 for i < j: the second warpgroup's
    // columns j >= 32 need the second half of i only
    float dxa[16] = {}, t3[16] = {};
    product_pair<true>(dxa, T(kDY), T(kLDY), row0, t, A(kWH) + off,
                       A(kWL) + off, wg);
    // G_{c+1}, from the chain warpgroup, in T(kG) as [n][p]
    bar_sync(kBarG, kGradThreads);
    // A(p, n) = G(p, n)
    product_split<true>(t3, T(kG), row0, t, A(kB) + off, A(kLB) + off);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int pp = acc_row(q, row0), j = acc_col(q, n0, t);
      if (pp < prm.p)
        prm.dx[(tok0 + j) * xrow + hh * prm.p + pp] = dxa[q] + wv[j] * t3[q];
    }
  }
  bar_sync(1 + wg, kWG);   // this warpgroup is done with M
  // dBᵀ = Cᵀ·Q + w∘(Gᵀ·xᵀ): Q as [j][i]; u_j = w_j·B_j·(x·G)_j
#pragma unroll
  for (int q = 0; q < 16; ++q)
    put(T(kWH), T(kWL), acc_col(q, n0, t), acc_row(q, row0), qq[q]);
  fence_proxy_async();
  bar_sync(1 + wg, kWG);
  {
    // A(n, i) = C(i, n); as M, Q(i, j) = 0 for i < j
    float dba[16] = {}, t4[16] = {}, u[16];
    product_split<true>(dba, T(kC), row0, t, A(kWH) + off, A(kWL) + off,
                        nullptr, wg);
    // A(n, p) = G(p, n)
    product_split<false>(t4, T(kG), row0, t, A(kX) + off, A(kLX) + off);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int nn = acc_row(q, row0), j = acc_col(q, n0, t);
      const float xg = wv[j] * t4[q];
      u[q] = xg * (at(T(kB), j, nn) + at(T(kLB), j, nn));
      if (nn < prm.n)
        prm.dbm[(tok0 + j) * brow + hh * prm.n + nn] = dba[q] + xg;
    }
    column_sums(u, u_s, warp, g, n0, t);
  }
  consumers_sync();

  // d la per token, then d(dt·A) = its reverse cumsum in the chunk
  if (tid < kL) {
    const int k = tid;
    float d = rows_s[0][k] + rows_s[1][k] -
              (cols_s[0][k] + cols_s[1][k] + cols_s[2][k] + cols_s[3][k]) +
              (v_s[0][k] + v_s[1][k] + v_s[2][k] + v_s[3][k]) -
              (u_s[0][k] + u_s[1][k] + u_s[2][k] + u_s[3][k]);
    if (k == kL - 1) {   // the carried state's decay and Σ_j u_j
      float su = 0.f;
      for (int j = 0; j < kL; ++j)
        su += u_s[0][j] + u_s[1][j] + u_s[2][j] + u_s[3][j];
      d += expf(la_last) * (sg_s[0] + sg_s[1] + sg_s[2] + sg_s[3]) + su;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(kFull, d, o);
      if (lane + o < 32) d += v;
    }
    if (k == 32) tot_s = d;   // the second warp's total
    bar_sync(kBarCum, kL);
    if (k < 32) d += tot_s;
    prm.dda[(tok0 + k) * prm.h + hh] = d;
  }
}

// The TF32 descriptor and swizzle check: c[64, 64] = A·bᵀ, b [64 n][64 k]
// f32 read K-major by TMA (each warpgroup its 32 rows of n), A from
// registers out of a TMA-loaded tile a [64][64] (A(m, k) = a(m, k), or
// a(k, m) with kT): split (kSplit: the three products of the kernels) or
// its raw f32 bits against raw f32 B bits (one product: what the tensor
// cores make of f32 bits)
template <bool kT, bool kSplit>
__global__ void __launch_bounds__(kThreads2, 1)
wgmma_tf32_tile_kernel(const __grid_constant__ CUtensorMap ma,
                       const __grid_constant__ CUtensorMap mb, float* c) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  unsigned char* const ta = tile_base(smem_raw);
  unsigned char* const tb = ta + kTileBytes;
  unsigned char* const tl = ta + 2 * kTileBytes;
  const uint32_t sbar = smem_addr(&bar);
  if (threadIdx.x == 0) {
    mbar_init(sbar, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(sbar, 2 * kTileBytes);
    for (int sl = 0; sl < 2; ++sl) {
      tma_load_4d(smem_addr(ta) + sl * kSlabBytes, &ma, sbar, 32 * sl, 0, 0,
                  0);
      tma_load_4d(smem_addr(tb) + sl * kSlabBytes, &mb, sbar, 32 * sl, 0, 0,
                  0);
    }
  }
  __syncthreads();
  mbar_wait(sbar, 0);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp + g, n0 = 32 * wg;
  float acc[16] = {};
  if (kSplit) {
    split_tile(tb, tl, threadIdx.x, kThreads2);
    fence_proxy_async();
    __syncthreads();
    product_split<kT>(acc, ta, row0, t, smem_addr(tb) + 128 * n0,
                      smem_addr(tl) + 128 * n0);
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      AFrag a;
      a_pair<kT>(a, ta, ta, row0, t, 32 * half);   // raw bits as hi
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tf32_n32(acc, a.hi + 4 * kk,
                       kmajor_desc(smem_addr(tb) + 128 * n0 +
                                   half * kSlabBytes + kk * 32));
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
    }
  }
#pragma unroll
  for (int q = 0; q < 16; ++q)
    c[acc_row(q, row0) * 64 + acc_col(q, n0, t)] = acc[q];
}

// tensor maps of a token-major [B, S, H, width] operand (64-token boxes of
// one head) and of the states [B·S/64·H, P, N] (one P × N state a box)
int token_map(CUtensorMap* map, const void* ptr, int batch, int s, int h,
              int width) {
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)h,
                              (cuuint64_t)s, (cuuint64_t)batch};
  return make_map_f32(map, ptr, 4, dims, 2, kL);
}
int state_map(CUtensorMap* map, const void* ptr, int count, int p, int n) {
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)p,
                              (cuuint64_t)count};
  return make_map_f32(map, ptr, 3, dims, 1, 64);
}

constexpr size_t kStateSmemBytes = 1024 + 6 * kTileBytes;
constexpr size_t kGradSmemBytes = 1024 + kGradTiles * kTileBytes;

bool takes(int p, int n, int chunk) {
  return chunk == kL && p >= 8 && p <= 64 && p % 8 == 0 && n >= 8 &&
         n <= 64 && n % 8 == 0;
}

int run(const Params& prm, int chunk, cudaStream_t stream) {
  if (!takes(prm.p, prm.n, chunk) || prm.s % kL)
    return (int)cudaErrorInvalidValue;
  if (prm.batch == 0 || prm.s == 0 || prm.h == 0) return (int)cudaSuccess;
  const int nc = prm.s / kL;
  CUtensorMap mx, mdy, mb, mc, ms;
  int err = token_map(&mx, prm.x, prm.batch, prm.s, prm.h, prm.p);
  if (err == 0) err = token_map(&mdy, prm.dy, prm.batch, prm.s, prm.h, prm.p);
  if (err == 0) err = token_map(&mb, prm.bm, prm.batch, prm.s, prm.h, prm.n);
  if (err == 0) err = token_map(&mc, prm.cm, prm.batch, prm.s, prm.h, prm.n);
  if (err == 0)
    err = state_map(&ms, prm.states, prm.batch * nc * prm.h, prm.p, prm.n);
  if (err != 0) return err;
  // the kernels' shared memory, set once a device
  static bool attrs_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !attrs_set[dev & 63]) {
    e = cudaFuncSetAttribute(ssd_chain_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kStateSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chain_grad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kGradSmemBytes);
    attrs_set[dev & 63] = e == cudaSuccess;
  }
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(
      prm.sync, 0, sizeof(int) * (2 + 2 * (size_t)prm.batch * prm.h), stream);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(prm.batch * prm.h * nc);
  const unsigned groups = (unsigned)(prm.batch * prm.h *
                                     ((nc + kFChunks - 1) / kFChunks));
  ssd_chain_state_kernel<<<groups, kThreads2, kStateSmemBytes, stream>>>(
      mx, mb, prm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chain_grad_kernel<<<blocks, kGradThreads, kGradSmemBytes, stream>>>(
      mc, mdy, mb, mx, ms, prm);
  return (int)cudaGetLastError();
}

template <bool kT, bool kSplit>
int tile_check(const void* a, const void* b, float* c, cudaStream_t s) {
  CUtensorMap ma, mb;
  int err = token_map(&ma, a, 1, 64, 1, 64);
  if (err == 0) err = token_map(&mb, b, 1, 64, 1, 64);
  if (err != 0) return err;
  const size_t bytes = 1024 + 3 * kTileBytes;
  const cudaError_t set = cudaFuncSetAttribute(
      wgmma_tf32_tile_kernel<kT, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (set != cudaSuccess) return (int)set;
  wgmma_tf32_tile_kernel<kT, kSplit><<<1, kThreads2, bytes, s>>>(ma, mb, c);
  return (int)cudaGetLastError();
}

}  // namespace chain

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

// The chained-scan route (the kernel's chunk 64; P and N multiples of 8 up
// to 64; every operand 16-byte aligned): x, da, B, C, dy → dx, dda, dB,
// dC in two launches, after zeroing `sync`.  Scratch: states [B, S/64, H,
// P, N] f32, gring [B·H, 2, 4096] f32, sync [2 + 2·B·H] int32.
extern "C" int repro_ssd_bwd_chain_f32(
    const void* xdt, const void* da, const void* bm, const void* cm,
    const void* dy, void* states, void* gring, void* sync, void* dx,
    void* dda, void* dbm, void* dcm, int batch, int s, int h, int p, int n,
    int chunk, void* stream) {
  const chain::Params prm = {
      (const float*)xdt, (const float*)da, (const float*)bm,
      (const float*)cm,  (const float*)dy, (float*)states, (float*)gring,
      (int*)sync,        (float*)dx,       (float*)dda,    (float*)dbm,
      (float*)dcm,       batch, s, h, p, n};
  return chain::run(prm, chunk, (cudaStream_t)stream);
}

// The TF32 wgmma descriptor and swizzle check (chain::wgmma_tf32_tile_kernel):
// c[64, 64] f32 = A · b[64, 64]ᵀ, A = a[64, 64] (a_trans 0) or aᵀ (1),
// split into TF32 hi and lo (split 1) or as raw f32 bits (0); a, b, c
// contiguous f32, 16-byte aligned
extern "C" int repro_wgmma_tile_tf32(const void* a, const void* b, float* c,
                                     int a_trans, int split, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (a_trans)
    return split ? chain::tile_check<true, true>(a, b, c, st)
                 : chain::tile_check<true, false>(a, b, c, st);
  return split ? chain::tile_check<false, true>(a, b, c, st)
               : chain::tile_check<false, false>(a, b, c, st);
}
