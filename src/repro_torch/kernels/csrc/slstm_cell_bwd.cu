// The gradient of the sLSTM recurrent cell (slstm_cell.cu) for sm_90a:
// the reverse recurrence through the stabilized exponential gating, one
// thread-block cluster per (batch row, head) walking the steps from the
// last, as the forward walks them from the first, and the parameter
// gradients dR and db summed on the way.
//
// Replaces: nothing of the TPU kernel, which has no backward body — the
// reference differentiates its jnp cell under lax.scan
// (src/repro/models/xlstm.py _slstm_cell); the forward it differentiates
// is src/repro/kernels/slstm_cell.py::_slstm_kernel (pallas_call at :77).
//
// The forward under autograd keeps, per step and hidden unit, the gate
// pre-activations gg = (i, f, z, o) and c, n, m after the step
// (traj [B, S, 7, H, dh]), and its output h [B, S, H, dh].  Per step t,
// from the last, each unit's gating backward takes dh_t = dy_t +
// Σ_{g,e} R[unit, g, e]·dgg_{t+1}[g, e] and the carried gradients of c_t,
// n_t, m_t, and gives dgg_t and the carries of step t − 1.  It recomputes
// lf = log_sigmoid(f), ip and fp from the stored gg and m with the
// forward's own instructions (__expf, __fdividef), so they equal the
// forward's values bit for bit and the 4096-step chain does not drift;
// it follows each op's derivative as the plain version's autograd has
// it: n's floor max(n, 1e-6) passes its gradient where n >= 1e-6, and
// m = max(lf + m_prev, i) splits it in half at a tie.  dgg is dg_in;
// dR[h] = Σ_{b,t} h_{t−1} ⊗ dgg_t and db = Σ_{b,t} dgg_t.
//
// What bounds it on an H100: per step, head and batch row the transposed
// recurrence R·dgg_t and dR's h_t ⊗ dgg_{t+1}, dh·4dh multiply-adds
// each, and ~50 gating operations a unit, against reading traj, h, dy
// and writing dgg once: operations at the 67 TFLOP/s of f32 FMA — but,
// as the forward, the S steps are a chain, and one step's latency (the
// dot, its reduction, the gating backward, the exchange of dgg) times S
// is the floor.
//
// What the design does about it.  Block q owns rows d of R — units
// [q·Q, (q+1)·Q), R[d, :, :] in registers (the same 4·dh·Q f32 a block
// as the forward) — so the dot for unit d stays in its block.  64
// threads (two warps) share a group of 8 units: thread k of a group
// holds the 8 units' weights of all four gates for the columns
// e = 64·c + k, c < dh / 64 (96 registers at dh 192), and reads
// dgg_{t+1}[e][0..3] as one float4, which feeds 8 FMAs a value, as h does
// in the forward; the warp reduces its 8 partial sums by shuffles
// (lane l keeps unit l / 4) and the gating thread adds the group's two
// warps' sums.  Shared-memory loads a thread and step, at dh 192 and 2
// batch rows a cluster: the dot 6 LDS.128 (3 columns × 2 rows; 192
// wavefronts a block of 8 warps, the forward's count), dR 6 LDS.128
// more of the same dgg and 4 broadcast LDS.128 of h (224 wavefronts).
// The gating backward of unit d produces dgg_t[:, d], which its thread
// writes as one 16-byte st.async into the shared memory of every block
// of the cluster, counted on that block's mbarrier: 4·dh values a step,
// in three buffers by step (so a block still reading step t + 1's dgg for
// dR never meets step t + 3's), with no cluster barrier in the loop.
// Every thread adds h_t[u] · dgg_{t+1}[g, e] into its dR registers (R's
// layout, over the cluster's batch rows) off the chain: the warps
// without gating threads right after the block barrier, while the gating
// runs; the gating warps after their send, while the peers' dgg comes
// in.  At dh > 192 R alone takes 128 registers, so dR sums in shared
// memory (128 KB a block) instead.  Each gating thread sums db in 4
// registers.  The step inputs of the gating (traj, dy, and h for dR) are
// copied four steps ahead into a shared ring with cp.async by threads of
// the warps after the gating ones, after their dR: no registers held,
// and no copies queued in the gating warps (issued there, before or
// after the gating, they lengthened every step).  At the end each
// cluster writes its dR and db partial sums, which the wrapper adds over
// the clusters: no atomics, so two runs agree bit for bit.  The same
// instances (clusters of 6 or 8, 1 or 2 batch rows a cluster) and launch
// plan machinery as the forward.
#include "slstm_common.cuh"

namespace {

constexpr int kAhead = 4;            // steps of traj, dy, h copied ahead
constexpr int kRing = kAhead + 2;    // their slots (see the loop)
constexpr int kSlots = 3;            // dgg buffers, by step
constexpr int kTraj = 7;             // traj rows a step: i, f, z, o, c, n, m
constexpr int kIn = 8;               // ring rows: gg, (c, n, m)_{t−1}, dy
constexpr int kGroupUnits = 8;       // units a thread holds
constexpr int kGroupThreads = 64;    // threads sharing them: two warps

// DPT: the forward's inputs per thread (dh <= 16·DPT); CS: blocks of a
// cluster
template <int DPT, int CS>
struct BwdDims {
  static constexpr int kW = kSlices * DPT;   // dgg rows, zero past dh
  static constexpr int kCols = kW / kGroupThreads;
  static constexpr int kUnits = (kW + CS - 1) / CS;
  static constexpr int kGroups = (kUnits + kGroupUnits - 1) / kGroupUnits;
  static constexpr int kThreads = kGroups * kGroupThreads;
  // R and dR together fit the registers up to 3 columns a thread
  static constexpr bool kDrInRegs = kCols <= 3;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a warp's partial sums a[v] of its group's 8 units → lane l holds the
// warp's total of unit l >> 2 (9 shuffles)
__device__ __forceinline__ float reduce_units(const float (&a)[kGroupUnits],
                                              int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float s4[4], s2[2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    s4[j] = (b4 ? a[j + 4] : a[j]) +
            __shfl_xor_sync(kFull, b4 ? a[j] : a[j + 4], 16);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    s2[j] = (b3 ? s4[j + 2] : s4[j]) +
            __shfl_xor_sync(kFull, b3 ? s4[j] : s4[j + 2], 8);
  float s = (b2 ? s2[1] : s2[0]) +
            __shfl_xor_sync(kFull, b2 ? s2[0] : s2[1], 4);
  s += __shfl_xor_sync(kFull, s, 2);
  return s + __shfl_xor_sync(kFull, s, 1);
}

// CS: blocks of a cluster; ROWS: batch rows per cluster.  dr_part and
// db_part null: dg_in alone (no h read, no dR, no db).
template <int DPT, int CS, int ROWS>
__global__ void __launch_bounds__(BwdDims<DPT, CS>::kThreads, 1)
slstm_bwd_cluster_kernel(const float* __restrict__ traj,
                         const float* __restrict__ hseq,
                         const float* __restrict__ r,
                         const float* __restrict__ dy,
                         float* __restrict__ dgg, float* __restrict__ dr_part,
                         float* __restrict__ db_part, int batch, int steps,
                         int heads, int dh) {
  using D = BwdDims<DPT, CS>;
  constexpr int kW = D::kW, kCols = D::kCols, kUnits = D::kUnits;
  constexpr int kUnitsP = D::kGroups * kGroupUnits;
  // gbuf[s][b][e][g]: dgg of a step (in walking order), step τ in τ mod 3
  __shared__ __align__(16) float gbuf[kSlots][ROWS][kW][4];
  __shared__ float part[2 * D::kGroups][ROWS][kGroupUnits];  // per warp
  // the ring of the gating's step inputs, step t in slot t mod kRing:
  // rin[.][j][τ] for gating thread τ, rh[.][b][u] = h_{t−1} of unit u
  __shared__ float rin[kRing][kIn][ROWS * kUnits];
  __shared__ __align__(16) float rh[kRing][ROWS][kUnitsP];
  __shared__ float dbs[ROWS][4][kUnits];   // each row's db, added at the end
  __shared__ __align__(8) unsigned long long full[ROWS][kSlots];
  extern __shared__ float4 drs[];   // [kUnitsP][kW] where dR is not in regs
  cg::cluster_group cluster = cg::this_cluster();
  const int q = blockIdx.x;               // rank in the cluster
  const int h = blockIdx.y;
  const int row0 = blockIdx.z * ROWS;
  const int units = (dh + CS - 1) / CS;   // this block's: [q·units, ...)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = threadIdx.x / kGroupThreads;
  const int k = threadIdx.x % kGroupThreads;
  const bool params = dr_part != nullptr;

  // the dot: thread k of group p holds its 8 units' weights,
  // rr[v][c][g] = r[h, u_v, g, 64c + k], u_v = q·units + 8p + v; dR the
  // same way
  float rr[kGroupUnits][kCols][4];
  constexpr int kRegUnits = D::kDrInRegs ? kGroupUnits : 1;
  constexpr int kRegCols = D::kDrInRegs ? kCols : 1;
  float dr[kRegUnits][kRegCols][4];
#pragma unroll
  for (int v = 0; v < kGroupUnits; ++v) {
    const int ul = kGroupUnits * grp + v, u = q * units + ul;
    const bool ok = ul < units && u < dh;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int e = kGroupThreads * c + k;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        rr[v][c][g] = ok && e < dh
            ? r[(((size_t)h * dh + u) * 4 + g) * dh + e] : 0.f;
    }
  }
#pragma unroll
  for (int v = 0; v < kRegUnits; ++v)
#pragma unroll
    for (int c = 0; c < kRegCols; ++c)
#pragma unroll
      for (int g = 0; g < 4; ++g) dr[v][c][g] = 0.f;

  // the gating: thread τ < ROWS·units owns (row τ / units, unit τ % units)
  const int row = threadIdx.x / units, gu = threadIdx.x - row * units;
  const int my_u = q * units + gu;
  const bool gating = row < ROWS && my_u < dh;
  const bool row_ok = gating && row0 + row < batch;
  const int pairs = ROWS * units;
  const bool gate_warp = warp * 32 < pairs;   // warp-uniform
  const size_t gate_stride = (size_t)heads * dh;

  // the copies: thread copy0 + τ, in the warps after the gating ones,
  // copies pair τ's inputs of step t into ring slot t mod kRing — gg_t,
  // (c, n, m)_{t−1}, dy_t and h_{t−1} (zeros before step 0, and past the
  // batch) — one commit group a step, empty past step 0
  const int copy0 = (pairs + 31) / 32 * 32;
  const int tc = (int)threadIdx.x - copy0;
  const int crow = tc / units, cgu = tc - crow * units;
  const bool copier = tc >= 0 && tc < pairs && q * units + cgu < dh;
  const bool copy_ok = copier && row0 + crow < batch;
  // pair τ's element of step 0 in h and dy [B, S, H, dh]
  const size_t at0 = ((size_t)(row0 + crow) * steps) * gate_stride +
                     (size_t)h * dh + q * units + cgu;
  auto issue = [&](int t) {
    if (!copier) return;
    if (t >= 0) {
      const int s = t % kRing;
      const size_t step = at0 + (size_t)t * gate_stride;   // in h and dy
      // traj[b, t, j, h, u] = traj[(b·S + t)·7·H·dh + j·H·dh + h·dh + u]
      const size_t tj = at0 + (size_t)t * gate_stride +
                        ((size_t)(row0 + crow) * steps + t) * (kTraj - 1) *
                            gate_stride;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        cp_async4(&rin[s][g][tc],
                  copy_ok ? traj + tj + g * gate_stride : traj, copy_ok);
      const bool prev = copy_ok && t > 0;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        cp_async4(&rin[s][4 + j][tc],
                  prev ? traj + tj - (kTraj - 4 - j) * gate_stride : traj,
                  prev);
      cp_async4(&rin[s][7][tc], copy_ok ? dy + step : dy, copy_ok);
      const bool hp = prev && params;
      cp_async4(&rh[s][crow][cgu], hp ? hseq + step - gate_stride : dy, hp);
    }
    cp_commit();
  };

  // c, n, m after the step being walked, the carried gradients, db
  float cur[3] = {0.f, 0.f, 0.f};
  if (row_ok)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      cur[j] = traj[((size_t)(row0 + row) * steps + steps - 1) * kTraj *
                        gate_stride + (4 + j) * gate_stride + (size_t)h * dh +
                    my_u];
  float dc = 0.f, dn = 0.f, dm = 0.f;
  float db[4] = {0.f, 0.f, 0.f, 0.f};

  const unsigned bytes = (unsigned)(dh * 4 * sizeof(float));
  for (int i = threadIdx.x; i < kSlots * ROWS * kW * 4; i += blockDim.x)
    (&gbuf[0][0][0][0])[i] = 0.f;
  for (int i = threadIdx.x; i < kRing * ROWS * kUnitsP; i += blockDim.x)
    (&rh[0][0][0])[i] = 0.f;   // units without a gating thread stay 0
  if (!D::kDrInRegs && params)
    for (int i = threadIdx.x; i < kUnitsP * kW; i += blockDim.x)
      drs[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots * ROWS; ++i)
      mbar_init(smem_addr(&full[0][0] + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();   // every block runs, has zeroed dgg and set its barriers
#pragma unroll
  for (int a = 0; a < kAhead; ++a) issue(steps - 1 - a);

  for (int tau = 0; tau < steps; ++tau) {
    const int t = steps - 1 - tau, sl = tau % kSlots;
    float acc[ROWS][kGroupUnits];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      // dgg of step t + 1 has come from every block (the last step reads
      // zeros)
      if (tau > 0)
        mbar_wait(smem_addr(&full[i][sl]), ((tau - 1) / kSlots) & 1);
#pragma unroll
      for (int v = 0; v < kGroupUnits; ++v) acc[i][v] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 gv = *reinterpret_cast<const float4*>(
            &gbuf[sl][i][kGroupThreads * c + k][0]);
#pragma unroll
        for (int v = 0; v < kGroupUnits; ++v)
          acc[i][v] = fmaf(gv.x, rr[v][c][0],
                      fmaf(gv.y, rr[v][c][1],
                      fmaf(gv.z, rr[v][c][2],
                      fmaf(gv.w, rr[v][c][3], acc[i][v]))));
      }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float s = reduce_units(acc[i], lane);
      if (!(lane & 3)) part[warp][i][lane >> 2] = s;
    }
    cp_wait<kAhead - 1>();   // a copier's copies of step t are in
    // every unit's two sums are in part; every dgg read of the dot and
    // every dR read of the step before is done; step t's inputs are in
    // the ring
    __syncthreads();

    // the buffer of step τ + 1 was last read at step τ − 2, by every
    // block before it gated step τ − 1, so all of them are done with it
    if (threadIdx.x == 0 && tau + 1 < steps) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        mbar_expect(smem_addr(&full[i][(tau + 1) % kSlots]), bytes);
    }
    // dR += h_t ⊗ dgg_{t+1}: h_t came with step t + 1's copies, complete
    // before this step's barrier; dgg_{t+1} is in slot sl until peers
    // gate step τ + 2, after this block sent step τ + 1's
    auto add_dr = [&]() {
      if (!params || tau == 0) return;
      const int hs = (t + 1) % kRing;
      float hv[ROWS][kGroupUnits];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(
            &rh[hs][i][kGroupUnits * grp]);
        const float4 b = *reinterpret_cast<const float4*>(
            &rh[hs][i][kGroupUnits * grp + 4]);
        hv[i][0] = a.x; hv[i][1] = a.y; hv[i][2] = a.z; hv[i][3] = a.w;
        hv[i][4] = b.x; hv[i][5] = b.y; hv[i][6] = b.z; hv[i][7] = b.w;
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float4 gv[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          gv[i] = *reinterpret_cast<const float4*>(
              &gbuf[sl][i][kGroupThreads * c + k][0]);
#pragma unroll
        for (int v = 0; v < kGroupUnits; ++v) {
          float a[4];
          float4* sp = nullptr;
          if constexpr (D::kDrInRegs) {
#pragma unroll
            for (int g = 0; g < 4; ++g) a[g] = dr[v][c][g];
          } else {
            sp = &drs[(kGroupUnits * grp + v) * kW + kGroupThreads * c + k];
            const float4 x = *sp;
            a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
          }
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            a[0] = fmaf(hv[i][v], gv[i].x, a[0]);
            a[1] = fmaf(hv[i][v], gv[i].y, a[1]);
            a[2] = fmaf(hv[i][v], gv[i].z, a[2]);
            a[3] = fmaf(hv[i][v], gv[i].w, a[3]);
          }
          if constexpr (D::kDrInRegs) {
#pragma unroll
            for (int g = 0; g < 4; ++g) dr[v][c][g] = a[g];
          } else {
            *sp = make_float4(a[0], a[1], a[2], a[3]);
          }
        }
      }
    };

    if (!gate_warp) {   // the dR FMAs fill the gating warps' latency
      add_dr();
      // slot (t − kAhead) mod kRing = (t + 2) mod kRing: read by its
      // gating at step τ − 2 and by every thread's dR at τ − 1, before
      // this step's barrier
      issue(t - kAhead);
      continue;
    }
    // a warp holding gating threads: every lane runs the gating (lanes
    // past ROWS·units on thread 0's inputs, their results dropped), the
    // gating threads send, then every lane adds its dR while the peers'
    // dgg comes in
    const int s = t % kRing, me = gating ? threadIdx.x : 0;
    const float li = rin[s][0][me], fr = rin[s][1][me];
    const float z = rin[s][2][me], o = rin[s][3][me];
    const float c_new = cur[0], n_new = cur[1], m_new = cur[2];
    const float c_prev = rin[s][4][me], n_prev = rin[s][5][me];
    const float m_prev = rin[s][6][me];
    const float dyv = rin[s][7][me];
    const int pw = 2 * (gu / kGroupUnits), pv = gu % kGroupUnits;
    const float drec = gating ? part[pw][row][pv] + part[pw + 1][row][pv]
                              : 0.f;
    // the forward's gating, recomputed with its own instructions
    const float lf = log_sigmoid(fr);
    const float a_arg = lf + m_prev;
    const float ip = __expf(li - m_new);
    const float fp = __expf(a_arg - m_new);
    const float tz = 1.f - __fdividef(2.f, 1.f + __expf(2.f * z));
    const float so = __fdividef(1.f, 1.f + __expf(-o));
    const float nf = fmaxf(n_new, 1e-6f);
    const float inv = __fdividef(1.f, nf);
    // h = so·c / max(n, 1e-6)
    const float dht = dyv + drec;
    const float hc = so * inv;
    const float d_o = dht * c_new * hc * (1.f - so);
    const float dcn = dc + dht * hc;
    const float dnn = dn + (n_new >= 1e-6f ? -dht * c_new * hc * inv : 0.f);
    // c = fp·c_prev + ip·tanh(z), n = fp·n_prev + ip
    const float dfp = dcn * c_prev + dnn * n_prev;
    const float dip = dcn * tz + dnn;
    const float dz = dcn * ip * (1.f - tz * tz);
    // ip = exp(i − m), fp = exp(lf + m_prev − m), m = max(lf + m_prev, i)
    const float dmn = dm - dip * ip - dfp * fp;
    const float dmax = dmn * (a_arg > li ? 1.f : a_arg == li ? 0.5f : 0.f);
    const float dli = dip * ip + (dmn - dmax);
    const float da = dfp * fp + dmax;   // of lf + m_prev
    const float dfr = da * __fdividef(1.f, 1.f + __expf(fr));
    dc = dcn * fp;
    dn = dnn * fp;
    dm = da;
    if (gating && tau + 1 < steps) {
      const int nx = (tau + 1) % kSlots;
      const unsigned at = smem_addr(&gbuf[nx][row][my_u][0]);
      const unsigned bar = smem_addr(&full[row][nx]);
#pragma unroll
      for (int rank = 0; rank < CS; ++rank)
        st_async4(peer_addr(at, rank), dli, dfr, dz, d_o,
                  peer_addr(bar, rank));
    }
    add_dr();
    if (row_ok) {
      float* o_t = dgg + ((size_t)(row0 + row) * steps + t) * 4 *
                             gate_stride + (size_t)h * dh + my_u;
      o_t[0] = dli;
      o_t[gate_stride] = dfr;
      o_t[2 * gate_stride] = dz;
      o_t[3 * gate_stride] = d_o;
    }
    db[0] += dli;
    db[1] += dfr;
    db[2] += dz;
    db[3] += d_o;
    cur[0] = c_prev;
    cur[1] = n_prev;
    cur[2] = m_prev;
  }
  cp_wait<0>();

  if (params) {
    // this cluster's dR partial, dr_part[z, h, u, g, e]
    float* dst = dr_part + (size_t)blockIdx.z * heads * dh * 4 * dh;
#pragma unroll
    for (int v = 0; v < kGroupUnits; ++v) {
      const int ul = kGroupUnits * grp + v, u = q * units + ul;
      if (ul >= units || u >= dh) continue;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int e = kGroupThreads * c + k;
        if (e >= dh) continue;
        float a[4];
        if constexpr (D::kDrInRegs) {
#pragma unroll
          for (int g = 0; g < 4; ++g) a[g] = dr[v][c][g];
        } else {
          const float4 x = drs[ul * kW + e];
          a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
          dst[(((size_t)h * dh + u) * 4 + g) * dh + e] = a[g];
      }
    }
    // its db partial, db_part[z, g, h, u]: the rows added in order
    if (gating)
#pragma unroll
      for (int g = 0; g < 4; ++g) dbs[row][g][gu] = db[g];
    __syncthreads();
    if (gating && row == 0)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = dbs[0][g][gu];
#pragma unroll
        for (int i = 1; i < ROWS; ++i) s += dbs[i][g][gu];
        db_part[(((size_t)blockIdx.z * 4 + g) * heads + h) * dh + my_u] = s;
      }
  }
  cluster.sync();   // no block leaves while a peer may still write to it
}

auto bwd_kernel_of = [](auto inst) {
  using I = decltype(inst);
  return slstm_bwd_cluster_kernel<I::dpt, I::cs, I::rows>;
};

// the backward's block of the instance for dh: 64 threads a group of 8
// of the block's units, and (dh > 192) the dR sums in dynamic shared
// memory
struct BackwardShape {
  template <typename I>
  BlockShape operator()(I, int dh) const {
    using D = BwdDims<I::dpt, I::cs>;
    const int units = (dh + I::cs - 1) / I::cs;
    const int groups = (units + kGroupUnits - 1) / kGroupUnits;
    return {groups * kGroupThreads,
            D::kDrInRegs ? 0
                         : sizeof(float4) * D::kGroups * kGroupUnits * D::kW};
  }
};

}  // namespace

// The backward's launch plan for [B, ·, ·, H, dh] operands on clusters
// of `cs` blocks, as repro_slstm_cell_plan gives the forward's.
extern "C" int repro_slstm_cell_bwd_plan(int batch, int heads, int dh,
                                         int cs, int* out) {
  return cluster_plan(batch, heads, dh, cs, out, bwd_kernel_of,
                      BackwardShape{});
}

// traj[B, S, 7, H, dh] (the forward's, under autograd), h[B, S, H, dh]
// (its output), r_gates[H, dh, 4, dh], dy[B, S, H, dh] → dgg[B, S, 4, H,
// dh] (= dg_in), and each cluster's partial sums of dR, dr_part[Z, H, dh,
// 4, dh], and of db, db_part[Z, 4, H, dh], Z = ceil(B / rows); all f32
// and contiguous; dh <= 256; clusters of `cs` blocks, `rows` batch rows a
// cluster (the plan's).  With dr_part and db_part null, dg_in alone (h
// may be null).
extern "C" int repro_slstm_cell_bwd_f32(const void* traj, const void* h,
                                        const void* r_gates, const void* dy,
                                        void* dgg, void* dr_part,
                                        void* db_part, int batch, int steps,
                                        int heads, int dh, int cs, int rows,
                                        void* stream) {
  if ((dr_part == nullptr) != (db_part == nullptr) ||
      (dr_part != nullptr && h == nullptr))
    return (int)cudaErrorInvalidValue;
  return cluster_launch(batch, steps, heads, dh, cs, rows,
                        (cudaStream_t)stream, bwd_kernel_of, BackwardShape{},
                        (const float*)traj, (const float*)h,
                        (const float*)r_gates, (const float*)dy, (float*)dgg,
                        (float*)dr_part, (float*)db_part, batch, steps, heads,
                        dh);
}
