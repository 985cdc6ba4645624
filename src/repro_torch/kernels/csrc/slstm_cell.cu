// sLSTM recurrent cell for sm_90a: the whole time loop of one (batch row,
// head) in one thread-block cluster, the recurrent weights held in
// registers for the whole sequence, stabilized exponential gating.
//
// Replaces: src/repro/kernels/slstm_cell.py::_slstm_kernel (the
// pallas_call at slstm_cell.py:77).
//
// What bounds it on an H100: per step and head dh·4dh multiply-adds of the
// block-diagonal recurrence h·r[h] plus ~40 gating operations per hidden
// unit, against one read of g_in and one write of h per step: by the
// roofline, operations at the 67 TFLOP/s of f32 FMA (xlstm-125m, dh = 192,
// H = 4, batch 8: 0.58 ms for 4096 steps).  But the S steps are a chain:
// each needs the last step's h, so the latency of one step (the dot, a
// reduction, the gating, the exchange of h) times S is a floor the
// roofline does not show.
//
// What the design does about it: the TPU ran one program per batch row
// with all of r pinned in VMEM.  The recurrence is block-diagonal per head
// (einsum "bhd,hdge->bghe"), so (batch row, head) pairs are independent.
// r[h] is 4·dh² f32 (590 KB at dh = 192), over the 227 KB of shared memory
// one block may have, so one (batch row, head) takes a cluster of CS
// blocks (6; 8 when dh > 192: the caller's choice, one of the two sizes
// built) on CS SMs.  Block q owns the hidden units
// [q·Q, (q+1)·Q), Q = ceil(dh / CS), with all four gate columns of each,
// so the gating of a unit never leaves its block; its slice of r
// (dh × 4Q f32, 98 KB at dh = 192) is loaded once into registers and
// stays there for the whole loop.
//
// A step, per block:
//   * the dot: 16 threads share a pair of units, thread k holding both
//     units' weights of all four gates for the inputs d = 4·(16j + k) + e,
//     so it reads h as float4 from shared memory (the 16 threads read 256
//     consecutive bytes) and each value feeds eight FMAs; a shuffle
//     reduction over the 16 leaves each gate sum in one pair of threads,
//     which write it to shared memory;
//   * one block barrier, then the gating in as few warps as there are
//     (row, unit) pairs to gate (two at xlstm-125m), each thread owning
//     one pair's c, n, m and its g_in four steps ahead in registers:
//     log_sigmoid as the stable min(x, 0) − log(1 + exp(−|x|)),
//     m = max(lf + m, li), n floored at 1e-6, m starting at 0, as the
//     reference's step, with the hardware's exp2 and divide (__expf,
//     __fdividef; tanh from exp), a few ulps each: the gating's latency
//     is much of a step's floor;
//   * the exchange: the gating thread writes its new h into the shared
//     memory of every block of the cluster with st.async, which counts the
//     bytes on that block's mbarrier (distributed shared memory); a block
//     starts its next dot when its barrier has seen all dh values.  h is
//     double-buffered by step parity, and a block writes a buffer of a peer
//     only after that peer's h of the last step came in, which it sent
//     after its last read of that buffer; so no cluster barrier runs in
//     the loop, and no fence waits on the global loads and stores of g_in
//     and y (a cluster barrier's release did: ~0.3 µs a step on an H100).
// Grid (CS, H, ceil(B / ROWS)), one block of 256 threads a SM at
// xlstm-125m widths.  When fewer clusters than B·H can be resident at once
// (cudaOccupancyMaxActiveClusters on an H100: 17 of 6 blocks, 30 of 4,
// against the 32 that xlstm-125m's B·H = 8·4 need), ROWS = 2 batch rows
// share a cluster: each weight read from registers then serves both
// rows, and no cluster waits for a second wave.  Clusters of 6 then
// spread those 16 clusters over 96 SMs where clusters of 4 would take 64
// (~10% faster at xlstm-125m).
// After the last step the gating threads store their c, n, m into
// `state` [3, B, H, dh] when it is not null: a served prefill leaves the
// recurrent state in the cache (h after the last step is y's last row).
// Under autograd they also store, each step, what the backward
// (slstm_cell_bwd.cu) reads into `traj` [B, S, 7, H, dh] when it is not
// null: the pre-activations (i, f, z, o) as gated and c, n, m after the
// step.
#include "slstm_common.cuh"

namespace {

constexpr int kAhead = 4;       // steps of g_in loaded ahead

// 16 threads of a unit pair hold partial sums a[v][g] of gate g of unit v
// over their inputs; afterwards thread k holds the total of gate
// (k >> 1) & 3 of unit k >> 3 (and k, k ^ 1 the same)
__device__ __forceinline__ float reduce_gates(const float (&a)[2][4], int k) {
  const bool v1 = k & 8;
  float s4[4];   // the four gates of this thread's unit
#pragma unroll
  for (int g = 0; g < 4; ++g)
    s4[g] = (v1 ? a[1][g] : a[0][g]) +
            __shfl_xor_sync(kFull, v1 ? a[0][g] : a[1][g], 8);
  const bool hi = k & 4;
  float k0 = hi ? s4[2] : s4[0], k1 = hi ? s4[3] : s4[1];
  k0 += __shfl_xor_sync(kFull, hi ? s4[0] : s4[2], 4);
  k1 += __shfl_xor_sync(kFull, hi ? s4[1] : s4[3], 4);
  const bool mid = k & 2;
  float keep = mid ? k1 : k0;
  keep += __shfl_xor_sync(kFull, mid ? k0 : k1, 2);
  return keep + __shfl_xor_sync(kFull, keep, 1);
}

// DPT: inputs d per thread (a multiple of 4, 16·DPT >= dh); CS: blocks
// of a cluster; ROWS: batch rows per cluster
template <int DPT, int CS, int ROWS>
__global__ void __launch_bounds__(max_threads(DPT, CS), 1)
slstm_cluster_kernel(const float* __restrict__ g_in,
                     const float* __restrict__ r,
                     const float* __restrict__ bias, float* __restrict__ y,
                     float* __restrict__ state, float* __restrict__ traj,
                     int batch, int steps, int heads, int dh) {
  constexpr int kW = kSlices * DPT;       // h row, zero-padded past dh
  constexpr int kUnits = (kW + CS - 1) / CS;
  __shared__ __align__(16) float hbuf[2][ROWS][kW];
  __shared__ float pre[ROWS][4][kUnits];  // the step's gate sums
  // hbuf[b][i] is complete when full[i][b] has seen every block's h of
  // row i for it
  __shared__ __align__(8) unsigned long long full[ROWS][2];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = blockIdx.x;               // rank in the cluster
  const int h = blockIdx.y;
  const int row0 = blockIdx.z * ROWS;
  const int units = (dh + CS - 1) / CS;   // this block's: [q·units, ...)
  const int k = threadIdx.x & (kSlices - 1);
  const int pair = threadIdx.x / kSlices;

  // the dot: thread k of unit pair p holds both units' weights,
  // rr[v][g][4j + e] = r[h, d, g, u_v], d = 4(16j + k) + e
  float rr[2][4][DPT];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int ul = 2 * pair + v, u = q * units + ul;
    const bool ok = ul < units && u < dh;
#pragma unroll
    for (int j = 0; j < DPT / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (kSlices * j + k) + e;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          rr[v][g][4 * j + e] = ok && d < dh
              ? r[(((size_t)h * dh + d) * 4 + g) * dh + u] : 0.f;
      }
  }

  // the gating: thread τ < ROWS·units owns (row τ / units, unit τ % units)
  const int row = threadIdx.x / units, gu = threadIdx.x - row * units;
  const int my_u = q * units + gu;
  const bool gating = row < ROWS && my_u < dh;
  const bool row_ok = gating && row0 + row < batch;
  // g_in[b, t, gate, h, u]: one step of one row is 4·H·dh floats
  const size_t step_stride = (size_t)4 * heads * dh;
  const size_t gate_stride = (size_t)heads * dh;
  const float* gin = g_in + (size_t)(row0 + row) * steps * step_stride +
                     (size_t)h * dh + my_u;
  float bg[4], gq[kAhead][4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bg[g] = gating ? bias[((size_t)g * heads + h) * dh + my_u] : 0.f;
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
      gq[a][g] = row_ok && a < steps
          ? gin[a * step_stride + g * gate_stride] : 0.f;
  }
  float c = 0.f, n = 0.f, m = 0.f;

  const unsigned bytes = (unsigned)(dh * sizeof(float));
  for (int i = threadIdx.x; i < 2 * ROWS * kW; i += blockDim.x)
    (&hbuf[0][0][0])[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * ROWS; ++i)
      mbar_init(smem_addr(&full[0][0] + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();   // every block runs, has zeroed h and set its barriers

  for (int t = 0; t < steps; ++t) {
    const int par = t & 1;
    float acc[ROWS][2][4];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      // h of step t − 1 has come from every block (step 0 reads zeros)
      if (t > 0) mbar_wait(smem_addr(&full[i][par]), ((t - 1) >> 1) & 1);
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][v][g] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < DPT / 4; ++j)
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(
            &hbuf[par][i][4 * (kSlices * j + k)]);
        const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int v = 0; v < 2; ++v)
#pragma unroll
            for (int g = 0; g < 4; ++g)
              acc[i][v][g] = fmaf(hs[e], rr[v][g][4 * j + e], acc[i][v][g]);
      }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float tot = reduce_gates(acc[i], k);
      const int ul = 2 * pair + (k >> 3);
      if (!(k & 1) && ul < kUnits) pre[i][(k >> 1) & 3][ul] = tot;
    }
    __syncthreads();   // every gate sum is in pre; every h read is done

    // hbuf[par ^ 1] was last read at step t − 1, by every block before it
    // gated that step, so all of them are done with it; its barriers'
    // last phases ended before this thread passed them at step t − 1
    if (threadIdx.x == 0 && t + 1 < steps) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        mbar_expect(smem_addr(&full[i][par ^ 1]), bytes);
    }
    if (gating) {
      const float li = pre[row][0][gu] + gq[0][0] + bg[0];
      const float fr = pre[row][1][gu] + gq[0][1] + bg[1];
      const float lf = log_sigmoid(fr);
      const float z = pre[row][2][gu] + gq[0][2] + bg[2];
      const float o = pre[row][3][gu] + gq[0][3] + bg[3];
      const float m_new = fmaxf(lf + m, li);
      const float ip = __expf(li - m_new);
      const float fp = __expf(lf + m - m_new);
      c = fp * c + ip * (1.f - __fdividef(2.f, 1.f + __expf(2.f * z)));
      n = fp * n + ip;
      const float h_new =
          __fdividef(c, (1.f + __expf(-o)) * fmaxf(n, 1e-6f));
      m = m_new;
      if (traj != nullptr && row_ok) {   // for the backward: gg, c, n, m
        float* tp = traj + ((size_t)(row0 + row) * steps + t) * 7 * gate_stride
                    + (size_t)h * dh + my_u;
        const float keep[7] = {li, fr, z, o, c, n, m};
#pragma unroll
        for (int g = 0; g < 7; ++g) tp[g * gate_stride] = keep[g];
      }
      if (t + 1 < steps) {
        const unsigned at =
            smem_addr(&hbuf[par ^ 1][row][0]) + (unsigned)my_u * 4;
        const unsigned bar = smem_addr(&full[row][par ^ 1]);
#pragma unroll
        for (int rank = 0; rank < CS; ++rank)
          st_async(peer_addr(at, rank), h_new, peer_addr(bar, rank));
      }
      if (row_ok)
        y[((size_t)(row0 + row) * steps + t) * heads * dh +
          (size_t)h * dh + my_u] = h_new;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int a = 0; a + 1 < kAhead; ++a) gq[a][g] = gq[a + 1][g];
        gq[kAhead - 1][g] = row_ok && t + kAhead < steps
            ? gin[(size_t)(t + kAhead) * step_stride + g * gate_stride]
            : 0.f;
      }
    }
  }
  if (state != nullptr && row_ok) {
    const size_t plane = (size_t)batch * heads * dh;
    const size_t at = ((size_t)(row0 + row) * heads + h) * dh + my_u;
    state[at] = c;
    state[plane + at] = n;
    state[2 * plane + at] = m;
  }
  cluster.sync();   // no block leaves while a peer may still write to it
}

}  // namespace

// The launch plan for [B, ·, 4, H, dh] operands on clusters of `cs`
// blocks: out = {batch rows per cluster, resident clusters at most
// (cudaOccupancyMaxActiveClusters), threads per block}.  Batch rows per
// cluster: 1 if all B·H clusters can be resident at once, else 2.
extern "C" int repro_slstm_cell_plan(int batch, int heads, int dh, int cs,
                                     int* out) {
  return cluster_plan(
      batch, heads, dh, cs, out,
      [](auto inst) {
        using I = decltype(inst);
        return slstm_cluster_kernel<I::dpt, I::cs, I::rows>;
      },
      ForwardShape{});
}

// g_in[B, S, 4, H, dh], r_gates[H, dh, 4, dh], b_gates[4, H, dh] →
// y[B, S, H, dh], all f32 and contiguous; dh <= 256; clusters of `cs`
// blocks, `rows` batch rows a cluster (the plan's).  Unless `state` is
// null, c, n, m after the last step go to state[3, B, H, dh]; unless
// `traj` is null, each step's (i, f, z, o) pre-activations and c, n, m
// go to traj[B, S, 7, H, dh].
extern "C" int repro_slstm_cell_f32(const void* g_in, const void* r_gates,
                                    const void* b_gates, void* y, void* state,
                                    void* traj, int batch, int steps,
                                    int heads, int dh, int cs, int rows,
                                    void* stream) {
  return cluster_launch(
      batch, steps, heads, dh, cs, rows, (cudaStream_t)stream,
      [](auto inst) {
        using I = decltype(inst);
        return slstm_cluster_kernel<I::dpt, I::cs, I::rows>;
      },
      ForwardShape{}, (const float*)g_in, (const float*)r_gates, (const float*)b_gates,
      (float*)y, (float*)state, (float*)traj, batch, steps, heads, dh);
}
