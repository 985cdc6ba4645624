"""Code that runs on each rank's local blocks of DTensor operands.

DTensor propagates a sharding op by op.  For some of the ops the models
run it has no rule — the kernels' custom ops — or not in every torch
release: ``roll``, ``flip``, ``log_sigmoid``, a depthwise conv's padding
over several mesh axes, indexing by batch-sharded tokens.  This module
holds the mesh's answer to each, so that the model files keep their
plain code:

* :func:`local_blocks` declares, beside a function independent across
  some dimensions of its operands, the ways it may be sharded.  Called
  with DTensor operands, they are redistributed to the way that moves
  least, the function's own code runs on each rank's local blocks (the
  card's kernels inside it), and its results are DTensors again; under
  autograd the local blocks carry the gradients back, so backward
  kernels run on them too.  Called with plain tensors, it is the
  function as written.  No way gathers a DTensor whole to run a plain
  version in place of a kernel, save the replicated one, which a
  dimension no way shards falls back to.
* :func:`reshape`: a reshape DTensor cannot carry, after the gather it
  needs (logged).
* :func:`embedding_lookup` and :func:`target_logits`: a row lookup and a
  last-dimension gather on a vocabulary-sharded DTensor, each rank on its
  own vocabulary block.

A way is taken only where it splits its dimensions evenly after the
earlier mesh dimensions' choices, so every rank's block has the same
shape and a rank's query heads keep their key/value heads.
"""
from __future__ import annotations

import functools
import logging
from typing import Callable, List, Sequence, Tuple

import torch

_log = logging.getLogger(__name__)

Row = Tuple[list, list]


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


# ---------------------------------------------------------------------------
# local_blocks
# ---------------------------------------------------------------------------


def _rows(args: Sequence, ways: Sequence[Sequence]) -> List[Row]:
    """(outputs' placements, operands' placements) of each way, then the
    replicated one.  A way lists the outputs' entries, then one a
    positional operand: an int, Shard of that dim; "R", Replicate; None,
    not a tensor."""
    from torch.distributed.tensor import Replicate, Shard

    def placement(d):
        if d is None:
            return None
        return Replicate() if d == "R" else Shard(d)

    n_out = len(ways[0]) - len(args)
    rows = [([placement(d) for d in way[:n_out]],
             [placement(d) for d in way[n_out:]]) for way in ways]
    rows.append(([Replicate()] * n_out,
                 [Replicate() if hasattr(a, "shape") else None
                  for a in args]))
    return rows


def _splits_evenly(row: Row, args: Sequence, sizes: Sequence) -> bool:
    """Whether ``row``'s shards divide each tensor operand's dimension d
    into ``sizes[j][d]`` equal blocks."""
    return all(want is None or not want.is_shard()
               or a.shape[want.dim] % sizes[j][want.dim] == 0
               for j, (a, want) in enumerate(zip(args, row[1])))


def _choose(rows: List[Row], args: Sequence, mesh) -> List[Row]:
    """Per mesh dimension, in order, the row that splits every operand
    evenly after the earlier dimensions' choices and redistributes the
    fewest tensor operands from where they lie (the first on a tie; the
    replicated row, last, always splits evenly)."""
    split = [[1] * len(a.shape) if hasattr(a, "shape") else None
             for a in args]
    chosen = []
    for dim in range(mesh.ndim):
        n = mesh.size(dim)
        ok = [row for row in rows if _splits_evenly(
            row, args, [[b * n for b in s] if s is not None else None
                        for s in split])]

        def moves(row):
            return sum(1 for a, want in zip(args, row[1])
                       if want is not None and is_dtensor(a)
                       and a.placements[dim] != want)
        row = min(ok, key=moves)
        for j, want in enumerate(row[1]):
            if want is not None and want.is_shard():
                split[j][want.dim] *= n
        chosen.append(row)
    return chosen


def run_local(ways: Sequence[Sequence], fn: Callable, args: Sequence):
    """``fn(*args)`` for DTensor operands on one mesh: per mesh dimension
    the way (of ``ways``, or replicated) that moves least, each operand
    redistributed to it, ``fn`` on the local blocks, its results (a
    tensor or a tuple tree of them, one entry a way's output) DTensors.
    A replicated operand of a way whose outputs are sharded on a mesh
    dimension gets its gradient summed there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.utils._pytree import tree_flatten, tree_unflatten
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    chosen = _choose(_rows(args, ways), args, mesh)
    local = []
    for j, a in enumerate(args):
        if not is_dtensor(a):
            local.append(a)
            continue
        want = [row[1][j] for row in chosen]
        grad = [Partial() if isinstance(w, Replicate) and any(
                    not isinstance(o, Replicate) for o in row[0]) else w
                for w, row in zip(want, chosen)]
        if tuple(a.placements) != tuple(want):
            a = a.redistribute(mesh, want)
        local.append(a.to_local(grad_placements=grad))
    outs, spec = tree_flatten(fn(*local))
    if len(outs) != len(chosen[0][0]):
        raise ValueError(f"{getattr(fn, '__name__', fn)} gave {len(outs)} "
                         f"tensors; its ways list {len(chosen[0][0])}")
    return tree_unflatten(
        [DTensor.from_local(o, mesh, [row[0][k] for row in chosen],
                            run_check=False) for k, o in enumerate(outs)],
        spec)


def local_blocks(*ways: Sequence) -> Callable:
    """Decorate a function independent across some dimensions of its
    positional tensor operands: each of ``ways`` lists its outputs'
    sharded dims, then each positional operand's (an int: that dim;
    "R": replicated; None: not a tensor).  With a DTensor among the
    positional operands the function runs on local blocks
    (:func:`run_local`), keyword arguments passed as they are; otherwise
    it is called as written."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not any(is_dtensor(a) for a in args):
                return fn(*args, **kwargs)
            return run_local(ways, lambda *t: fn(*t, **kwargs), args)
        return call
    return wrap


def elementwise(fn: Callable) -> Callable:
    """:func:`local_blocks` for an elementwise function of one tensor:
    its block wherever it lies (sharded on the dims it is, partial sums
    reduced first)."""
    @functools.wraps(fn)
    def call(x):
        if not is_dtensor(x):
            return fn(x)
        ways = [[p.dim, p.dim] for p in x.placements if p.is_shard()]
        return run_local(ways or [["R", "R"]], fn, (x,))
    return call


# ---------------------------------------------------------------------------
# reshape
# ---------------------------------------------------------------------------

_gathers_logged: set = set()


def _is_propagation_error(e: RuntimeError) -> bool:
    """DTensor's refusal to propagate a sharding through an op (not an
    out-of-memory error or any other failure)."""
    msg = str(e)
    return not isinstance(e, torch.OutOfMemoryError) and any(
        s in msg for s in ("Sharding propagation failed",
                           "unevenly sharded", "sharded dimension"))


def _gather(t, placements, shape):
    key = (tuple(t.shape), tuple(shape), tuple(t.placements))
    if key not in _gathers_logged:
        _gathers_logged.add(key)
        _log.warning("reshape %s → %s: DTensor cannot carry %s; gathering "
                     "to %s", tuple(t.shape), tuple(shape), t.placements,
                     placements)
    return t.redistribute(t.device_mesh, placements).reshape(shape)


def _reshape(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    from torch.distributed.tensor import Replicate
    try:
        return t.reshape(shape)
    except RuntimeError as e:
        if not _is_propagation_error(e):
            raise
    lead = [Replicate() if p.is_shard() and p.dim != 0 else p
            for p in t.placements]
    try:
        return _gather(t, lead, shape)
    except RuntimeError as e:
        if not _is_propagation_error(e):
            raise
    return _gather(t, [Replicate() if p.is_shard() else p
                       for p in t.placements], shape)


class _Reshape(torch.autograd.Function):
    """:func:`reshape` of a DTensor, its gradient reshaped back the same
    way."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.shape = tuple(t.shape)
        return _reshape(t, shape)

    @staticmethod
    def backward(ctx, grad):
        return _reshape(grad, ctx.shape), None


def reshape(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``t.reshape(shape)``.  A DTensor whose sharding the reshape cannot
    carry (DTensor splits or merges a sharded dimension only where the
    mesh divides it evenly) is first replicated on the mesh dimensions
    that shard anything but its leading dimension, then on all of them,
    as XLA reshards before such a reshape — each such gather logged once
    a process; its gradient goes back the same way.  The result is the
    same tensor."""
    if not is_dtensor(t):
        return t.reshape(shape)
    return _Reshape.apply(t, tuple(shape))


# ---------------------------------------------------------------------------
# The vocabulary-sharded lookup and gather
# ---------------------------------------------------------------------------


def _vocab_block(mesh, dims) -> Tuple[int, int]:
    """(this rank's block, the block count) of a dimension sharded over
    the mesh dimensions ``dims`` (nested shards go in mesh order)."""
    block, n = 0, 1
    for i in dims:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    return block, n


def _as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def embedding_lookup(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``w[tokens]``.  A DTensor table is read on each rank's own
    vocabulary block (the tokens outside it give 0) and summed over the
    ranks that split the vocabulary; the tokens keep their batch
    sharding, and a table replicated where they are sharded gets its
    gradient summed there.  DTensor's own rules for indexing do not take
    batch-sharded tokens in every torch release, and its embedding
    rule's backward does not compose with the table's all-gather."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not is_dtensor(w):
        return w[tokens]
    mesh = w.device_mesh
    vocab = [i for i, p in enumerate(w.placements)
             if p.is_shard() and p.dim == 0]
    tokens = _as_dtensor(tokens, mesh)
    rest = [Replicate() if i in vocab else p
            for i, p in enumerate(tokens.placements)]
    tokens = tokens.redistribute(mesh, rest)
    block, n = _vocab_block(mesh, vocab)
    width = w.shape[0] // n
    local = tokens.to_local() - block * width
    inside = (local >= 0) & (local < width)
    grads = [Partial() if i not in vocab and rest[i].is_shard() else p
             for i, p in enumerate(w.placements)]
    rows = w.to_local(grad_placements=grads)[local.clamp(0, width - 1)]
    rows = rows * inside[..., None].to(rows.dtype)
    shape = (*tokens.shape, w.shape[1])
    part = [Partial() if i in vocab else p for i, p in enumerate(rest)]
    return DTensor.from_local(rows, mesh, part, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride()).redistribute(mesh, rest)


def target_logits(lf: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``lf[..., targets]``: each position's logit of its target.  Logits
    that are a DTensor sharded on the vocabulary are read on each rank's
    own vocabulary block (the targets outside it give 0) and summed over
    those ranks, so no rank gathers the whole vocabulary."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not is_dtensor(lf):
        return torch.gather(lf, -1, targets[..., None])[..., 0]
    mesh, last = lf.device_mesh, lf.ndim - 1
    vocab = [i for i, p in enumerate(lf.placements)
             if p.is_shard() and p.dim == last]
    rest = [Replicate() if i in vocab else p
            for i, p in enumerate(lf.placements)]
    targets = _as_dtensor(targets, mesh).redistribute(mesh, rest)
    if not vocab:
        return torch.gather(lf, -1, targets[..., None])[..., 0]
    block, n = _vocab_block(mesh, vocab)
    width = lf.shape[-1] // n
    local = targets.to_local() - block * width
    inside = (local >= 0) & (local < width)
    ll = torch.gather(lf.to_local(), -1,
                      local.clamp(0, width - 1)[..., None])[..., 0]
    ll = ll * inside.to(ll.dtype)
    part = [Partial() if i in vocab else p for i, p in enumerate(rest)]
    return DTensor.from_local(ll, mesh, part, run_check=False,
                              shape=targets.shape,
                              stride=targets.stride()).redistribute(mesh,
                                                                    rest)
