// The gradient of the sLSTM recurrent cell (slstm_cell.cu) for sm_90a:
// the reverse recurrence through the stabilized exponential gating, one
// thread-block cluster per (batch row, head) walking the steps from the
// last, as the forward walks them from the first.
//
// Replaces: nothing of the TPU kernel, which has no backward body — the
// reference differentiates its jnp cell under lax.scan
// (src/repro/models/xlstm.py _slstm_cell); the forward it differentiates
// is src/repro/kernels/slstm_cell.py::_slstm_kernel (pallas_call at :77).
//
// The forward under autograd keeps, per step and hidden unit, the gate
// pre-activations gg = (i, f, z, o) and c, n, m after the step
// (traj [B, S, 7, H, dh]).  Per step t, from the last, each unit's
// gating backward takes dh_t = dy_t + Σ_{g,e} R[unit, g, e]·dgg_{t+1}[g, e]
// and the carried gradients of c_t, n_t, m_t, and gives dgg_t and the
// carries of step t − 1.  It recomputes lf = log_sigmoid(f), ip and fp
// from the stored gg and m with the forward's own instructions (__expf,
// __fdividef), so they equal the forward's values bit for bit and the
// 4096-step chain does not drift; it follows each op's derivative as the
// plain version's autograd has it: n's floor max(n, 1e-6) passes its
// gradient where n >= 1e-6, and m = max(lf + m_prev, i) splits it in
// half at a tie.  dgg is dg_in.  dR[h] = Σ_{b,t} h_{t-1} ⊗ dgg_t and db =
// Σ_{b,t} dgg_t are one product and one sum over the whole trajectory:
// the wrapper leaves them to torch.matmul and sum, as the reference
// leaves them to XLA.
//
// What bounds it on an H100: per step and head the transposed recurrence
// R·dgg_t (dh·4dh multiply-adds) and ~50 gating operations a unit,
// against reading traj, dy and writing dgg once: operations at the 67
// TFLOP/s of f32 FMA — but, as the forward, the S steps are a chain, and
// one step's latency (the dot, its reduction, the gating backward, the
// exchange of dgg) times S is the floor.
//
// What the design does about it: the forward's blocks own output units
// e with R[:, :, e] in registers; used as they are, the transposed
// product would need a reduce-scatter of partial sums every step.  Here
// block q owns rows d of R instead — units [q·Q, (q+1)·Q), R[d, :, :] in
// registers (the same 4·dh·Q f32 a block as the forward) — so the dot
// for unit d stays in its block: 16 threads share a pair of units,
// thread k holding both units' weights of all four gates for the columns
// e = 16·i + k, reading dgg_{t+1}[e][0..3] as one float4 (the 16 threads
// read 256 consecutive bytes), and a shuffle reduction leaves each
// unit's sum in one thread.  The gating backward of unit d produces
// dgg_t[:, d], which its thread writes as one 16-byte st.async into the
// shared memory of every block of the cluster, counted on that block's
// mbarrier: 4·dh values a step (4× the forward's h), double-buffered by
// step parity, with no cluster barrier in the loop — the forward's
// exchange.  The gating thread keeps each step's traj and dy two steps
// ahead in registers.  The same instances (clusters of 6 or 8, 1 or 2
// batch rows a cluster) and launch plan as the forward.
#include "slstm_common.cuh"

namespace {

constexpr int kAhead = 2;   // steps of traj and dy loaded ahead
constexpr int kTraj = 7;    // traj rows a step: i, f, z, o, c, n, m

// one step's loads of a gating thread: gg_t, (c, n, m)_{t−1}, dy_t
struct StepIn {
  float gg[4], prev[3], dy;
};

// DPT: columns e per thread (16·DPT >= dh); CS: blocks of a cluster;
// ROWS: batch rows per cluster
template <int DPT, int CS, int ROWS>
__global__ void __launch_bounds__(max_threads(DPT, CS), 1)
slstm_bwd_cluster_kernel(const float* __restrict__ traj,
                         const float* __restrict__ r,
                         const float* __restrict__ dy,
                         float* __restrict__ dgg, int batch, int steps,
                         int heads, int dh) {
  constexpr int kW = kSlices * DPT;       // dgg rows, zero-padded past dh
  constexpr int kUnits = (kW + CS - 1) / CS;
  // gbuf[b][i][e][g]: dgg of the step before (in walking order)
  __shared__ __align__(16) float gbuf[2][ROWS][kW][4];
  __shared__ float drec[ROWS][kUnits];    // Σ R[d]·dgg of each unit d
  __shared__ __align__(8) unsigned long long full[ROWS][2];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = blockIdx.x;               // rank in the cluster
  const int h = blockIdx.y;
  const int row0 = blockIdx.z * ROWS;
  const int units = (dh + CS - 1) / CS;   // this block's: [q·units, ...)
  const int k = threadIdx.x & (kSlices - 1);
  const int pair = threadIdx.x / kSlices;

  // the dot: thread k of unit pair p holds both units' weights,
  // rr[v][i][g] = r[h, u_v, g, 16i + k]
  float rr[2][DPT][4];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int ul = 2 * pair + v, u = q * units + ul;
    const bool ok = ul < units && u < dh;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int e = kSlices * i + k;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        rr[v][i][g] = ok && e < dh
            ? r[(((size_t)h * dh + u) * 4 + g) * dh + e] : 0.f;
    }
  }

  // the gating: thread τ < ROWS·units owns (row τ / units, unit τ % units)
  const int row = threadIdx.x / units, gu = threadIdx.x - row * units;
  const int my_u = q * units + gu;
  const bool gating = row < ROWS && my_u < dh;
  const bool row_ok = gating && row0 + row < batch;
  const size_t gate_stride = (size_t)heads * dh;
  const size_t unit = (size_t)h * dh + my_u;
  const float* tr = traj + (size_t)(row0 + row) * steps * kTraj * gate_stride
                    + unit;
  const float* dyr = dy + (size_t)(row0 + row) * steps * gate_stride + unit;
  float* out = dgg + (size_t)(row0 + row) * steps * 4 * gate_stride + unit;

  auto load = [&](int t) {
    StepIn s = {};
    if (row_ok && t >= 0) {
      const float* at = tr + (size_t)t * kTraj * gate_stride;
#pragma unroll
      for (int g = 0; g < 4; ++g) s.gg[g] = at[g * gate_stride];
      if (t > 0)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          s.prev[j] = at[(j + 4 - (int)kTraj) * (long long)gate_stride];
      s.dy = dyr[(size_t)t * gate_stride];
    }
    return s;
  };
  StepIn ahead[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) ahead[a] = load(steps - 1 - a);
  // c, n, m after the step being walked, and the carried gradients
  float cur[3] = {0.f, 0.f, 0.f};
  if (row_ok)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      cur[j] = tr[((size_t)(steps - 1) * kTraj + 4 + j) * gate_stride];
  float dc = 0.f, dn = 0.f, dm = 0.f;

  const unsigned bytes = (unsigned)(dh * 4 * sizeof(float));
  for (int i = threadIdx.x; i < 2 * ROWS * kW * 4; i += blockDim.x)
    (&gbuf[0][0][0][0])[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * ROWS; ++i)
      mbar_init(smem_addr(&full[0][0] + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();   // every block runs, has zeroed dgg and set its barriers

  for (int tau = 0; tau < steps; ++tau) {
    const int t = steps - 1 - tau, par = tau & 1;
    float acc[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      // dgg of step t + 1 has come from every block (the last step reads
      // zeros)
      if (tau > 0) mbar_wait(smem_addr(&full[i][par]), ((tau - 1) >> 1) & 1);
      acc[i][0] = acc[i][1] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < DPT; ++j)
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 gv = *reinterpret_cast<const float4*>(
            &gbuf[par][i][kSlices * j + k][0]);
#pragma unroll
        for (int v = 0; v < 2; ++v)
          acc[i][v] = fmaf(gv.x, rr[v][j][0],
                      fmaf(gv.y, rr[v][j][1],
                      fmaf(gv.z, rr[v][j][2],
                      fmaf(gv.w, rr[v][j][3], acc[i][v]))));
      }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      // 16 threads → thread k holds the total of unit 2·pair + (k >> 3)
      const bool v1 = k & 8;
      float s = (v1 ? acc[i][1] : acc[i][0]) +
                __shfl_xor_sync(kFull, v1 ? acc[i][0] : acc[i][1], 8);
      s += __shfl_xor_sync(kFull, s, 4);
      s += __shfl_xor_sync(kFull, s, 2);
      s += __shfl_xor_sync(kFull, s, 1);
      const int ul = 2 * pair + (k >> 3);
      if (!(k & 7) && ul < kUnits) drec[i][ul] = s;
    }
    __syncthreads();   // every unit's sum is in drec; every dgg read done

    // gbuf[par ^ 1] was last read the step before, by every block before
    // it gated that step, so all of them are done with it
    if (threadIdx.x == 0 && tau + 1 < steps) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        mbar_expect(smem_addr(&full[i][par ^ 1]), bytes);
    }
    if (gating) {
      const StepIn& in = ahead[0];
      const float li = in.gg[0], fr = in.gg[1], z = in.gg[2], o = in.gg[3];
      const float c_new = cur[0], n_new = cur[1], m_new = cur[2];
      const float c_prev = in.prev[0], n_prev = in.prev[1];
      // the forward's gating, recomputed with its own instructions
      const float lf = log_sigmoid(fr);
      const float a_arg = lf + in.prev[2];
      const float ip = __expf(li - m_new);
      const float fp = __expf(a_arg - m_new);
      const float tz = 1.f - __fdividef(2.f, 1.f + __expf(2.f * z));
      const float so = __fdividef(1.f, 1.f + __expf(-o));
      const float nf = fmaxf(n_new, 1e-6f);
      const float inv = __fdividef(1.f, nf);
      // h = so·c / max(n, 1e-6)
      const float dht = in.dy + drec[row][gu];
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
      if (tau + 1 < steps) {
        const unsigned at = smem_addr(&gbuf[par ^ 1][row][my_u][0]);
        const unsigned bar = smem_addr(&full[row][par ^ 1]);
#pragma unroll
        for (int rank = 0; rank < CS; ++rank)
          st_async4(peer_addr(at, rank), dli, dfr, dz, d_o,
                    peer_addr(bar, rank));
      }
      if (row_ok) {
        float* o_t = out + (size_t)t * 4 * gate_stride;
        o_t[0] = dli;
        o_t[gate_stride] = dfr;
        o_t[2 * gate_stride] = dz;
        o_t[3 * gate_stride] = d_o;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) cur[j] = in.prev[j];
#pragma unroll
      for (int a = 0; a + 1 < kAhead; ++a) ahead[a] = ahead[a + 1];
      ahead[kAhead - 1] = load(t - kAhead);
    }
  }
  cluster.sync();   // no block leaves while a peer may still write to it
}

auto bwd_kernel_of = [](auto inst) {
  using I = decltype(inst);
  return slstm_bwd_cluster_kernel<I::dpt, I::cs, I::rows>;
};

}  // namespace

// The backward's launch plan for [B, ·, ·, H, dh] operands on clusters
// of `cs` blocks, as repro_slstm_cell_plan gives the forward's.
extern "C" int repro_slstm_cell_bwd_plan(int batch, int heads, int dh,
                                         int cs, int* out) {
  return cluster_plan(batch, heads, dh, cs, out, bwd_kernel_of);
}

// traj[B, S, 7, H, dh] (the forward's, under autograd), r_gates[H, dh, 4,
// dh], dy[B, S, H, dh] → dgg[B, S, 4, H, dh] (= dg_in), all f32 and
// contiguous; dh <= 256; clusters of `cs` blocks, `rows` batch rows a
// cluster (the plan's).
extern "C" int repro_slstm_cell_bwd_f32(const void* traj, const void* r_gates,
                                        const void* dy, void* dgg, int batch,
                                        int steps, int heads, int dh, int cs,
                                        int rows, void* stream) {
  return cluster_launch(batch, steps, heads, dh, cs, rows,
                        (cudaStream_t)stream, bwd_kernel_of,
                        (const float*)traj, (const float*)r_gates,
                        (const float*)dy, (float*)dgg, batch, steps, heads,
                        dh);
}
