"""Closed-form cost rules of the hand-written kernels — the counterpart
of ``repro.analysis.pallascost`` for the port's CUDA kernels.

The reference derives a Pallas kernel's cost from its ``pallas_call``
parameters; a CUDA kernel carries none, so each ``repro_torch::*``
custom op gets a rule written from its grid and blocks, in the
reference's feature vocabulary and by the reference's traffic rule:

* grid programs: the reference kernel's grid, in its order (last axis
  fastest); ``f_sync_grid_programs`` is their number;
* block traffic: an operand's block is fetched once, plus once more each
  time its block index changes from one program to the next — the Pallas
  pipeline's revisit elision.  ``fetches × block elements`` lands in
  ``f_mem_contig_<dtype>_load``/``_store`` and, in bytes, in
  ``f_mem_hbm_bytes_in``/``_out``;
* body work: the arithmetic the kernel does, by (kind, dtype) — for the
  model-layer kernels, the reference counter's count of one program's
  body (nested ``jit``s opened) times the grid;
* ``f_vmem_contig_<dtype>_store``: elements the CUDA kernel stages into
  shared memory (the port's on-chip class, see
  :mod:`repro_torch.core.counting`).

The rules are registered with the counter on import, so
:func:`repro_torch.core.counting.count_fn` prices ``kernels.ops`` calls
without running them.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core.counting import (
    FeatureCounts,
    dtype_name,
    register_op_cost_rule,
)
from repro_torch.kernels.dg_diff import slab_width as dg_slab_width
from repro_torch.kernels.flash_attention import TILE_K as FLASH_TILE_K
from repro_torch.kernels.flash_attention import BWD_TILES as FLASH_BWD_TILES
from repro_torch.kernels.flash_attention import TILE_Q as FLASH_TILE_Q
from repro_torch.kernels.flash_attention import bwd_route as flash_bwd_route
from repro_torch.kernels.flash_attention import bwd_steps as flash_bwd_steps
from repro_torch.kernels.flash_attention import kv_tiles_visited
from repro_torch.kernels.mamba2_ssd import INNER_CHUNK as SSD_TILE
from repro_torch.kernels.mamba2_ssd import inner_chunk as ssd_inner_chunk
from repro_torch.kernels.matmul_tiled import STAGE_K as MATMUL_STAGE_K
from repro_torch.kernels.matmul_tiled import TILE as MATMUL_TILE
from repro_torch.kernels.slstm_cell import (
    cluster_blocks as slstm_cluster_blocks)
from repro_torch.kernels.stencil5 import STRIP_ROWS as STENCIL_STRIP_ROWS

BYTES_IN_FEATURE = "f_mem_hbm_bytes_in"
BYTES_OUT_FEATURE = "f_mem_hbm_bytes_out"


def block_fetches(grid: Sequence[int], axes: Sequence[int]) -> int:
    """Fetches of a block whose index depends on grid ``axes``, walking
    ``grid`` in lexicographic order (last axis fastest): one, plus one
    per step that changes an axis the index reads.

    A step whose incrementing axis is ``d`` (and which resets every axis
    after ``d``) occurs ``prod(grid[:d]) · (grid[d] − 1)`` times; it
    changes the index when ``d`` is read, or when a later axis that is
    read has extent > 1 (it wraps to 0)."""
    used = set(axes)
    total = 1
    for d, g in enumerate(grid):
        changes = d in used or any(a in used and grid[a] > 1
                                   for a in range(d + 1, len(grid)))
        if changes:
            total += math.prod(grid[:d]) * (g - 1)
    return total


def _traffic(counts: FeatureCounts, role: str, dtype: torch.dtype,
             block_elems: int, fetches: int) -> None:
    elems = block_elems * fetches
    kind = "load" if role == "in" else "store"
    counts.add(f"f_mem_contig_{dtype_name(dtype)}_{kind}", elems)
    counts.add(BYTES_IN_FEATURE if role == "in" else BYTES_OUT_FEATURE,
               elems * dtype.itemsize)


def matmul_tiled_cost(a: torch.Tensor, b: torch.Tensor, block_m: int,
                      block_n: int, block_k: int) -> FeatureCounts:
    """Grid (M/bm, N/bn, K/bk); A block (bm, bk) at (i, k), B (bk, bn)
    at (k, j), C (bm, bn) at (i, j); f32 accumulation, one ``acc +=``
    per program as the reference counts it (the CUDA kernel's finer
    16-deep partial sums are register work the rule leaves out)."""
    (m, k), n = a.shape, b.shape[1]
    grid = (m // block_m, n // block_n, k // block_k)
    programs = math.prod(grid)
    c = FeatureCounts()
    c.add("f_op_float32_madd", m * n * k)
    c.add("f_op_float32_add", programs * block_m * block_n)  # acc += dot
    _traffic(c, "in", a.dtype, block_m * block_k, block_fetches(grid, (0, 2)))
    _traffic(c, "in", b.dtype, block_k * block_n, block_fetches(grid, (2, 1)))
    _traffic(c, "out", a.dtype, block_m * block_n, block_fetches(grid, (0, 1)))
    # the CUDA kernel's own grid: each 128 × 128 output tile stages its
    # A rows and B columns (as f32) once, 32 k deep a stage, zero-filled
    # past the matrices (csrc/matmul_tiled.cu)
    tiles = -(-m // MATMUL_TILE[0]) * -(-n // MATMUL_TILE[1])
    depth = -(-k // MATMUL_STAGE_K) * MATMUL_STAGE_K
    c.add("f_vmem_contig_float32_store",
          tiles * depth * (MATMUL_TILE[0] + MATMUL_TILE[1]))
    c.add("f_sync_grid_programs", programs)
    return c


def stencil5_cost(u: torch.Tensor, block_m: int,
                  block_n: int) -> FeatureCounts:
    """Grid (M/bm, N/bn); each program reads its (bm+2)×(bn+2) halo
    window of the zero-padded input (the reference's ANY-space read) and
    writes its (bm, bn) block once."""
    m, n = u.shape
    grid = (m // block_m, n // block_n)
    programs = math.prod(grid)
    c = FeatureCounts()
    c.add("f_op_float32_add", 4 * m * n)
    c.add("f_op_float32_mul", m * n)
    _traffic(c, "in", u.dtype, (block_m + 2) * (block_n + 2), programs)
    _traffic(c, "out", u.dtype, block_m * block_n, block_fetches(grid, (0, 1)))
    strips = -(-block_m // STENCIL_STRIP_ROWS)
    c.add("f_vmem_contig_float32_store",
          programs * (block_m + 2 * strips) * (block_n + 2))
    c.add("f_sync_grid_programs", programs)
    return c


def dg_diff_cost(diff_mat: torch.Tensor, ut: torch.Tensor,
                 block_e: int) -> FeatureCounts:
    """Grid (M, K/be); D block (1, N, N) at (m, 0, 0), ut (N, be) at
    (0, e), out (1, N, be) at (m, 0, e)."""
    m, n, _ = diff_mat.shape
    k = ut.shape[1]
    grid = (m, k // block_e)
    programs = math.prod(grid)
    c = FeatureCounts()
    c.add("f_op_float32_madd", m * n * n * k)
    _traffic(c, "in", diff_mat.dtype, n * n, block_fetches(grid, (0,)))
    _traffic(c, "in", ut.dtype, n * block_e, block_fetches(grid, (1,)))
    _traffic(c, "out", ut.dtype, n * block_e, block_fetches(grid, (0, 1)))
    # the CUDA kernel's own grid: one block per slab of dg_slab_width(N)
    # elements stages each element of ut once (the last slab only its
    # part of K) and every D_m once (csrc/dg_diff.cu)
    slabs = -(-k // dg_slab_width(n))
    c.add("f_vmem_contig_float32_store", n * k + slabs * m * n * n)
    c.add("f_sync_grid_programs", programs)
    return c


def stream_strided_cost(arrays: Sequence[torch.Tensor], block: int,
                        stride: int) -> FeatureCounts:
    """Grid (n_out,); every input's block at i·stride, the output's at i;
    the body sums the inputs into an f32 accumulator seeded with the
    first, n_arrays − 1 adds per output element."""
    (s,) = arrays[0].shape
    n_out = s // (block * stride)
    grid = (n_out,)
    c = FeatureCounts()
    c.add("f_op_float32_add", (len(arrays) - 1) * n_out * block)
    for a in arrays:
        _traffic(c, "in", a.dtype, block, block_fetches(grid, (0,)))
    _traffic(c, "out", arrays[0].dtype, block, block_fetches(grid, (0,)))
    c.add("f_sync_grid_programs", n_out)
    return c


def madd_throughput_cost(x: torch.Tensor, iters: int, block: int,
                         a: float, b: float) -> FeatureCounts:
    """Grid (S/block,); x and out blocks at i.  Per element: 8 seeds
    ``x + i``, 8·iters steps of ``y·a + b`` (a mul and an add each, as
    the reference counts them) and 7 adds to sum the chains; each
    program runs the ``iters``-step loop once."""
    (s,) = x.shape
    dt = dtype_name(x.dtype)
    grid = (s // block,)
    c = FeatureCounts()
    c.add(f"f_op_{dt}_mul", 8 * iters * s)
    c.add(f"f_op_{dt}_add", (8 * iters + 8 + 7) * s)
    _traffic(c, "in", x.dtype, block, block_fetches(grid, (0,)))
    _traffic(c, "out", x.dtype, block, block_fetches(grid, (0,)))
    c.add("f_sync_loop_steps", iters * grid[0])
    c.add("f_sync_grid_programs", grid[0])
    return c


def flash_attention_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window, softcap, scale: float,
                         block_q: int, block_k: int) -> FeatureCounts:
    """Grid (B, Hq, Sq/bq, Skv/bk); Q block (bq, D) at (b, iq, h), K and
    V (bk, D*) at (b, ik, h // G), O (bq, Dv) at (b, iq, h).  Every
    visited tile is counted, masked or not, as the reference visits it.

    Per program: ``q·kᵀ`` and ``p·v`` (bq·bk·(D + Dv) madds, f32 as the
    reference counts ``dot_general`` by its output dtype), the scale,
    the online softmax (row max, ``exp(s − m)``, the row sum, the
    ``corr`` rescale of l and acc), two int32 position iotas offset by
    ``program_id · block`` (one more for the window), and the softcap's
    div, ``tanh`` and mul when set; the program with the last kv step
    divides acc by ``max(l, 1e-30)``.  K and V change block every kv
    step, so with more than one kv step they are fetched by every
    program; with one, once per (batch, kv head).  Only the port's
    ``f_vmem_*`` staging term follows the CUDA kernel, which visits just
    the kv tiles a query tile can see."""
    b, sq, hq, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    nq, nk = sq // block_q, skv // block_k
    grid = (b, hq, nq, nk)
    programs = math.prod(grid)
    tile = block_q * block_k
    c = FeatureCounts()
    c.add("f_op_float32_madd", programs * tile * (d + dv))
    c.add("f_op_float32_mul", programs * (tile + block_q + block_q * dv))
    c.add("f_op_float32_add",
          programs * (2 * tile + 2 * block_q + block_q * dv))
    c.add("f_op_float32_cmp", programs * (tile + block_q))
    c.add("f_op_float32_transc", programs * (tile + block_q))
    c.add("f_op_int32_add", programs * tile * (2 + (window is not None)))
    c.add("f_op_int32_mul", programs * 2)
    if softcap is not None:
        c.add("f_op_float32_div", programs * tile)
        c.add("f_op_float32_transc", programs * tile)
        c.add("f_op_float32_mul", programs * tile)
    finals = b * hq * nq
    c.add("f_op_float32_cmp", finals * block_q)
    c.add("f_op_float32_div", finals * block_q * dv)
    qo_fetches = block_fetches(grid, (0, 1, 2))
    kv_fetches = programs if nk > 1 else b * hkv
    _traffic(c, "in", q.dtype, block_q * d, qo_fetches)
    _traffic(c, "in", k.dtype, block_k * d, kv_fetches)
    _traffic(c, "in", v.dtype, block_k * dv, kv_fetches)
    _traffic(c, "out", q.dtype, block_q * dv, qo_fetches)
    # the CUDA kernel stages, per query tile, Q once and per kv tile it
    # visits (only those its rows can see) the K and V tiles — in bf16
    # (tensor cores) as they are, in f32 (FMA) also the probabilities
    tq = FLASH_TILE_Q[q.dtype]
    visited = b * hq * kv_tiles_visited(sq, skv, causal, window, tq)
    staged = b * hq * -(-sq // tq) * tq * d + visited * FLASH_TILE_K * (d + dv)
    if q.dtype == torch.float32:
        staged += visited * tq * FLASH_TILE_K
    c.add(f"f_vmem_contig_{dtype_name(q.dtype)}_store", staged)
    c.add("f_sync_grid_programs", programs)
    return c


def flash_attention_bwd_cost(dout: torch.Tensor, q: torch.Tensor,
                             k: torch.Tensor, v: torch.Tensor, causal: bool,
                             window, softcap, scale: float, block_q: int,
                             block_k: int) -> FeatureCounts:
    """The gradient of :func:`flash_attention_cost`'s function, on the
    forward's grid (B, Hq, Sq/bq, Skv/bk), every tile counted as the
    forward's rule counts it (the reference differentiates jnp; it has
    no backward kernel to follow).

    Per program: the vjp's five products — ``q·kᵀ`` recomputed, ``dO·vᵀ``,
    ``Pᵀ·dO``, ``dSᵀ·q``, ``dS·k``, bq·bk·(3·D + 2·Dv) madds — ``P =
    exp(s − lse)``, ``Δ = rowsum(P∘dP)`` (bq·bk madds), ``dS = P∘(dP −
    Δ)`` and, with a softcap, its ``tanh`` and factor ``1 − t²``; the
    scale of dq and dk once per row.  Reads q, k, v, dO and lse, writes
    dq, dk and dv, each block once per program that changes it, as the
    forward.  The staging term follows the CUDA kernel's passes on its
    route (csrc/flash_attention_bwd.cu, ``flash_attention.bwd_route``,
    which takes the operands as aligned):
    each pass stages its row tile once (queries' q and dO in Δ and dQ,
    keys' k and v in dK or the fused dK+dV, k alone in dV) and each
    column step's tiles (k and v in Δ and dQ, q and dO in dK, dK+dV and
    dV); the bf16 wgmma route runs Δ, dQ and dK+dV with 64-row column
    steps, its mma.sync fallback and f32 run Δ, dQ, dK and dV apart, and
    f32 also stages W in dQ, dK and dV.  The madds stay the vjp's five
    products whatever the route: the counter prices the function, the
    staging term the design."""
    b, sq, hq, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    nq, nk = sq // block_q, skv // block_k
    grid = (b, hq, nq, nk)
    programs = math.prod(grid)
    tile = block_q * block_k
    c = FeatureCounts()
    c.add("f_op_float32_madd", programs * tile * (3 * d + 2 * dv + 1))
    c.add("f_op_float32_mul", programs * tile * 3 + b * sq * hq * d
          + b * skv * hkv * d)
    c.add("f_op_float32_add", programs * tile * 2)
    c.add("f_op_float32_cmp", programs * tile)
    c.add("f_op_float32_transc", programs * tile)
    c.add("f_op_int32_add", programs * tile * (2 + (window is not None)))
    if softcap is not None:
        c.add("f_op_float32_div", programs * tile)
        c.add("f_op_float32_transc", programs * tile)
        c.add("f_op_float32_mul", programs * tile * 3)
        c.add("f_op_float32_add", programs * tile)
    qo_fetches = block_fetches(grid, (0, 1, 2))
    kv_fetches = programs if nk > 1 else b * hkv
    _traffic(c, "in", q.dtype, block_q * d, qo_fetches)
    _traffic(c, "in", dout.dtype, block_q * dv, qo_fetches)
    _traffic(c, "in", torch.float32, block_q, qo_fetches)   # lse
    _traffic(c, "in", k.dtype, block_k * d, kv_fetches)
    _traffic(c, "in", v.dtype, block_k * dv, kv_fetches)
    _traffic(c, "out", q.dtype, block_q * d, qo_fetches)
    _traffic(c, "out", k.dtype, block_k * d, kv_fetches)
    _traffic(c, "out", v.dtype, block_k * dv, kv_fetches)
    route = flash_bwd_route(q.dtype, d, dv)
    rows, cols, fused = FLASH_BWD_TILES[route]
    dq_steps, dkv_steps = flash_bwd_steps(sq, skv, causal, window, route)
    q_rows = b * hq * -(-sq // rows) * rows
    k_rows = b * hkv * -(-skv // rows) * rows
    dkv_passes = 1 if fused else 2
    staged = (2 * q_rows * (d + dv)
              + k_rows * (d + dv + (0 if fused else d))
              + b * hq * (2 * dq_steps + dkv_passes * dkv_steps) * cols
              * (d + dv))
    if q.dtype == torch.float32:   # W, in the passes it feeds
        staged += b * hq * (dq_steps + 2 * dkv_steps) * rows * cols
    c.add(f"f_vmem_contig_{dtype_name(q.dtype)}_store", staged)
    c.add("f_sync_grid_programs", programs)
    return c


def mamba2_ssd_cost(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
                    cm: torch.Tensor, chunk: int) -> FeatureCounts:
    """Grid (B, H, S/chunk); every block — x (L, P), dt·A (L,), B and C
    (L, N), y (L, P) — sits at (b, c, h), so each program fetches its
    own.  Per program (L = chunk): ``cumsum`` (L adds), the L × L decay
    ``exp(la_i − la_j)``, ``C·Bᵀ`` (L·L·N madds), ``(CB∘decay)·x``
    (L·L·P), ``C·stateᵀ`` (L·N·P) scaled by ``exp(la)``, the weights
    ``exp(la_L − la)``, ``(x∘w)ᵀ·B`` (L·P·N) and the state update."""
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    el = chunk
    grid = (b, h, s // chunk)
    programs = math.prod(grid)
    c = FeatureCounts()
    c.add("f_op_float32_madd", programs * (el * el * (n + p)
                                           + 2 * el * p * n))
    c.add("f_op_float32_mul", programs * (el * el + 2 * el * p + p * n))
    c.add("f_op_float32_add",
          programs * (2 * el + el * el + p * n + el * p))
    c.add("f_op_float32_transc", programs * (el * el + 2 * el + 1))
    for t, width in ((xdt, p), (da, 1), (bm, n), (cm, n)):
        _traffic(c, "in", t.dtype, el * width, programs)
    _traffic(c, "out", xdt.dtype, el * p, programs)
    # the CUDA kernel runs at its own chunk (inner_chunk, one tile of at
    # most SSD_TILE rows), per which its passes stage: (a) x and B, x
    # scaled by exp(la_L − la) in place, la and those weights; (c) C, B
    # and x, the state before the chunk, la and one SSD_TILE² tile of
    # (C·Bᵀ)∘decay; (b) nothing.  Its scratch (the chunk states) is HBM
    # traffic the reference does not move, left uncounted
    lk = ssd_inner_chunk(chunk)
    chunk_state = lk * (2 * p + n + 2)
    chunk_out = lk * (2 * n + p + 1) + n * p + SSD_TILE ** 2
    c.add("f_vmem_contig_float32_store",
          b * h * (s // lk) * (chunk_state + chunk_out))
    c.add("f_sync_grid_programs", programs)
    return c


def mamba2_ssd_state_cost(xdt: torch.Tensor, da: torch.Tensor,
                          bm: torch.Tensor, cm: torch.Tensor,
                          chunk: int) -> FeatureCounts:
    """:func:`mamba2_ssd_cost` and the state after the last chunk: one
    P × N float32 block per (batch, head), written by pass (b)."""
    b, _, h, p = xdt.shape
    c = mamba2_ssd_cost(xdt, da, bm, cm, chunk)
    _traffic(c, "out", torch.float32, p * bm.shape[-1], b * h)
    return c


def mamba2_ssd_bwd_cost(xdt: torch.Tensor, da: torch.Tensor,
                        bm: torch.Tensor, cm: torch.Tensor, dy: torch.Tensor,
                        chunk: int) -> FeatureCounts:
    """The gradient of :func:`mamba2_ssd_cost`'s function on the forward's
    grid (B, H, S/chunk), the body counted per program as the forward's
    rule counts it (the reference differentiates jnp; it has no backward
    kernel to follow).  Per program (L = chunk): the state before the
    chunk recomputed (``(x∘w)ᵀ·B``, L·P·N), the chunk's own state
    gradient (``(dy∘exp(la))ᵀ·C``, L·P·N), ``C·Bᵀ`` and ``dy·xᵀ`` with the
    decay (L·L·(N + P)), ``Mᵀ·dy``, ``Qᵀ·C``, ``Q·B`` (L·L·(P + 2N)),
    ``dy·S``, ``x·G``, ``B·Gᵀ`` (3·L·P·N), d la's dot products (L·L + 2·L·N
    + P·N), the two state passes, both cumsums and the combining adds.
    Reads x, dt·A, B, C and dy, writes dx, d(dt·A), dB and dC, each block
    once per program.  The staging term follows the CUDA passes at the
    kernel's chunk: the forward's (a) again, (a′) as (a), and (c′) with
    C, B, x, dy, the state and its gradient and the two SSD_TILE² product
    tiles; the scratch of states and state gradients is HBM traffic the
    reference does not move, left uncounted."""
    b, s, h, p = xdt.shape
    n = bm.shape[-1]
    el = chunk
    grid = (b, h, s // chunk)
    programs = math.prod(grid)
    c = FeatureCounts()
    c.add("f_op_float32_madd", programs * (el * el * (2 * n + 2 * p + n)
                                           + 5 * el * p * n + el * el
                                           + 2 * el * n + p * n))
    c.add("f_op_float32_mul",
          programs * (2 * el * el + 2 * el * p + 3 * el * n + 2 * p * n))
    c.add("f_op_float32_add",
          programs * (4 * el + 2 * el * el + 2 * p * n + el * p + 2 * el * n))
    c.add("f_op_float32_transc", programs * (el * el + 3 * el + 2))
    for t, width in ((xdt, p), (da, 1), (bm, n), (cm, n), (dy, p)):
        _traffic(c, "in", t.dtype, el * width, programs)
    for t, width in ((xdt, p), (da, 1), (bm, n), (cm, n)):
        _traffic(c, "out", t.dtype, el * width, programs)
    lk = ssd_inner_chunk(chunk)
    chunk_state = lk * (2 * p + n + 2)
    chunk_grad = lk * (2 * p + 2 * n + 1) + 2 * n * p + 2 * SSD_TILE ** 2
    c.add("f_vmem_contig_float32_store",
          b * h * (s // lk) * (2 * chunk_state + chunk_grad))
    c.add("f_sync_grid_programs", programs)
    return c


def slstm_cell_cost(g_in: torch.Tensor, r_gates: torch.Tensor,
                    b_gates: torch.Tensor) -> FeatureCounts:
    """Grid (B,); g_in (S, 4, H, dh) and y (S, H, dh) blocks per batch
    row, r (H, dh, 4·dh) and b (4, H, dh) fetched once.  Per program S
    steps (``f_sync_loop_steps``), each the block-diagonal recurrence
    h·r[h] (H·dh·4dh madds) and per hidden unit the gating: the two adds
    of ``g_in + rec + b`` per gate, ``log_sigmoid`` (as the reference's
    ``jax.nn.log_sigmoid`` counts: 7 adds, a cmp, 2 transc), the
    stabilizer max, ``exp``, ``tanh``, ``sigmoid`` and ``n``'s floor."""
    b, s, _, h, dh = g_in.shape
    units = b * s * h * dh
    c = FeatureCounts()
    c.add("f_op_float32_madd", b * s * h * dh * 4 * dh)
    c.add("f_op_float32_add", 21 * units)
    c.add("f_op_float32_mul", 4 * units)
    c.add("f_op_float32_div", units)
    c.add("f_op_float32_cmp", 3 * units)
    c.add("f_op_float32_transc", 6 * units)
    _traffic(c, "in", g_in.dtype, s * 4 * h * dh, b)
    _traffic(c, "in", r_gates.dtype, r_gates.numel(), 1)
    _traffic(c, "in", b_gates.dtype, b_gates.numel(), 1)
    _traffic(c, "out", g_in.dtype, s * h * dh, b)
    # the CUDA kernel's cluster for one (batch row, head) loads r[h]
    # (4·dh² values) into registers once, and each step writes the four
    # gate sums of every hidden unit to shared memory and every new h
    # value into the shared memory of each of its blocks
    c.add("f_vmem_contig_float32_store",
          b * h * 4 * dh * dh
          + b * s * h * dh * (4 + slstm_cluster_blocks(dh)))
    c.add("f_sync_loop_steps", s * b)
    c.add("f_sync_grid_programs", b)
    return c


def slstm_cell_state_cost(g_in: torch.Tensor, r_gates: torch.Tensor,
                          b_gates: torch.Tensor) -> FeatureCounts:
    """:func:`slstm_cell_cost` and the state after the last step: c, n
    and m of every hidden unit, float32, stored by the gating threads."""
    b, _, _, h, dh = g_in.shape
    c = slstm_cell_cost(g_in, r_gates, b_gates)
    _traffic(c, "out", torch.float32, 3 * h * dh, b)
    return c


def slstm_cell_traj_cost(g_in: torch.Tensor, r_gates: torch.Tensor,
                         b_gates: torch.Tensor) -> FeatureCounts:
    """:func:`slstm_cell_cost` and the trajectory the backward reads: per
    step and hidden unit the four gate pre-activations and c, n, m,
    float32, stored by the gating threads."""
    b, s, _, h, dh = g_in.shape
    c = slstm_cell_cost(g_in, r_gates, b_gates)
    _traffic(c, "out", torch.float32, s * 7 * h * dh, b)
    return c


def slstm_cell_bwd_cost(traj: torch.Tensor, h: torch.Tensor,
                        r_gates: torch.Tensor,
                        dy: torch.Tensor) -> FeatureCounts:
    """The gradient of :func:`slstm_cell_cost`'s function on its grid
    (B,): per program S steps (``f_sync_loop_steps``), each the
    transposed recurrence R·dgg (H·dh·4dh madds) and per hidden unit the
    gating's backward — ``log_sigmoid`` again (as the forward's rule
    counts it), ip, fp, tanh, sigmoid (4 transc), the sigmoid of −f for
    log_sigmoid's derivative (2 transc, a div), 1/max(n, 1e-6) (a div),
    the floor's and the maximum's compares, ~18 mul and ~14 add.  Then
    dR = Σ h_{t−1} ⊗ dgg (B·S·H·dh·4dh madds) and db = Σ dgg (B·S·4·H·dh
    adds).  Reads traj, h, dy and r, writes dg_in, dr and db.  The
    staging term follows the CUDA kernel: r[h] into registers once a
    cluster, and each step every unit's recurrent sum into shared memory
    and its four gate gradients into each block of its cluster."""
    b, s, _, hh, dh = traj.shape
    units = b * s * hh * dh
    c = FeatureCounts()
    c.add("f_op_float32_madd", 2 * b * s * hh * dh * 4 * dh)
    c.add("f_op_float32_add", (7 + 14) * units + 4 * units)
    c.add("f_op_float32_mul", 18 * units)
    c.add("f_op_float32_div", 3 * units)
    c.add("f_op_float32_cmp", 4 * units)
    c.add("f_op_float32_transc", (2 + 4 + 2) * units)
    _traffic(c, "in", traj.dtype, s * 7 * hh * dh, b)
    _traffic(c, "in", h.dtype, s * hh * dh, b)
    _traffic(c, "in", dy.dtype, s * hh * dh, b)
    _traffic(c, "in", r_gates.dtype, r_gates.numel(), 1)
    _traffic(c, "out", dy.dtype, s * 4 * hh * dh, b)
    _traffic(c, "out", r_gates.dtype, r_gates.numel(), 1)
    _traffic(c, "out", r_gates.dtype, 4 * hh * dh, 1)
    c.add("f_vmem_contig_float32_store",
          b * hh * 4 * dh * dh + units * (1 + 4 * slstm_cluster_blocks(dh)))
    c.add("f_sync_loop_steps", s * b)
    c.add("f_sync_grid_programs", b)
    return c


register_op_cost_rule("repro_torch::matmul_tiled", matmul_tiled_cost)
register_op_cost_rule("repro_torch::stencil5", stencil5_cost)
register_op_cost_rule("repro_torch::dg_diff", dg_diff_cost)
register_op_cost_rule("repro_torch::stream_strided", stream_strided_cost)
register_op_cost_rule("repro_torch::madd_throughput", madd_throughput_cost)
register_op_cost_rule("repro_torch::flash_attention", flash_attention_cost)
register_op_cost_rule("repro_torch::flash_attention_bwd",
                      flash_attention_bwd_cost)
register_op_cost_rule("repro_torch::mamba2_ssd", mamba2_ssd_cost)
register_op_cost_rule("repro_torch::slstm_cell", slstm_cell_cost)
register_op_cost_rule("repro_torch::mamba2_ssd_state", mamba2_ssd_state_cost)
register_op_cost_rule("repro_torch::slstm_cell_state", slstm_cell_state_cost)
register_op_cost_rule("repro_torch::mamba2_ssd_bwd", mamba2_ssd_bwd_cost)
register_op_cost_rule("repro_torch::slstm_cell_traj", slstm_cell_traj_cost)
register_op_cost_rule("repro_torch::slstm_cell_bwd", slstm_cell_bwd_cost)
