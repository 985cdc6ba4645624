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
* body work: the arithmetic the kernel does, by (kind, dtype);
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
from repro_torch.kernels.matmul_tiled import SUBTILE as MATMUL_SUBTILE
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
    # each k panel of A is staged once per 128-column sub-tile, of B once
    # per 128-row sub-tile (csrc/matmul_tiled.cu)
    sub_m = -(-block_m // MATMUL_SUBTILE[0])
    sub_n = -(-block_n // MATMUL_SUBTILE[1])
    c.add("f_vmem_contig_float32_store",
          programs * (sub_n * block_m * block_k + sub_m * block_k * block_n))
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
    c.add("f_vmem_contig_float32_store", programs * n * n)   # D_m staged
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


register_op_cost_rule("repro_torch::matmul_tiled", matmul_tiled_cost)
register_op_cost_rule("repro_torch::stencil5", stencil5_cost)
register_op_cost_rule("repro_torch::dg_diff", dg_diff_cost)
register_op_cost_rule("repro_torch::stream_strided", stream_strided_cost)
register_op_cost_rule("repro_torch::madd_throughput", madd_throughput_cost)
