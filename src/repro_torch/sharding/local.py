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
* :func:`repeat_heads`: a replicated weight's heads repeated and split
  over a mesh dimension, each rank building its own block.
* :func:`searchsorted`: on whole operands (DTensor has no rule for it).
* :func:`matmul`: ``x @ w`` as one GEMM over x's leading dims, whose
  weight gradient is computed in blocks over the mesh axes that neither
  operand splits (the product itself is repeated there), as XLA does.
* :func:`write_position`: a decode step's write into a cache split on
  its positions, on the rank that holds the position (DTensor would
  gather the whole cache to write one slot).
* :func:`embedding_lookup`, :func:`target_logits` and :func:`logsumexp`:
  a row lookup, a last-dimension gather and the loss's normalizer on a
  vocabulary-sharded DTensor, each rank on its own vocabulary block
  (:func:`lookup_table`: the table's layout for a lookup).
* :func:`gated_experts`: the MoE experts' FFN on the reference's
  expert-parallel layout.

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


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (without making
    one: a global-shape tensor, even on ``meta``, counts as memory to
    ``MemTracker``)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= max(d, 1)
    return tuple(reversed(out))


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
        a = redistribute(a, want)
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
# repeat_heads, searchsorted
# ---------------------------------------------------------------------------


def repeat_heads(w: torch.Tensor, dim: int, times: int,
                 mesh_dim: int) -> torch.Tensor:
    """``w.repeat_interleave(times, dim)`` as a DTensor sharded on ``dim``
    over mesh dimension ``mesh_dim``, where ``w`` is replicated there:
    each rank gathers its block's entries from its own copy (no
    collective), so a product with it runs on the rank's share of the
    repeated heads.  The gradient of each rank's block is summed into
    the entries it repeats, then over the ranks of ``mesh_dim`` (a
    partial sum: the reduction ``w``'s own placement asks for)."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = w.device_mesh
    n = mesh.size(mesh_dim)
    width = w.shape[dim] * times
    if not w.placements[mesh_dim].is_replicate() or width % n:
        raise ValueError(f"repeat_heads: {w.placements} on mesh dim "
                         f"{mesh_dim}, {width} heads over {n} ranks")
    grads = [Partial() if i == mesh_dim else p
             for i, p in enumerate(w.placements)]
    local = w.to_local(grad_placements=grads)
    first = mesh.get_local_rank(mesh_dim) * (width // n)
    idx = torch.arange(first, first + width // n,
                       device=local.device) // times
    block = local.index_select(dim, idx)
    shape = list(w.shape)
    shape[dim] = width
    placements = [Shard(dim) if i == mesh_dim else p
                  for i, p in enumerate(w.placements)]
    return DTensor.from_local(block, mesh, placements, run_check=False,
                              shape=tuple(shape),
                              stride=contiguous_strides(shape))


@local_blocks(["R", "R", "R"])
def _searchsorted_whole(sorted_seq, values, *, side):
    return torch.searchsorted(sorted_seq, values, side=side)


def searchsorted(sorted_seq: torch.Tensor, values: torch.Tensor, *,
                 side: str = "left") -> torch.Tensor:
    """``torch.searchsorted``; DTensor operands (it has no rule for the
    op) replicated first, the result replicated."""
    if not (is_dtensor(sorted_seq) or is_dtensor(values)):
        return torch.searchsorted(sorted_seq, values, side=side)
    return _searchsorted_whole(sorted_seq, values, side=side)


class _BlockedWeightGrad(torch.autograd.Function):
    """``x @ w`` (``w`` [..., K, N], batch dims matching ``x``'s leading
    ones); the gradient of ``w`` computed in blocks of K rows, each rank
    of the mesh dimensions ``dims`` its block."""

    @staticmethod
    def forward(ctx, x, w, dims):
        ctx.save_for_backward(x, w)
        ctx.dims = dims
        return x @ w

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Shard
        x, w = ctx.saved_tensors
        k, n = w.shape[-2:]
        lead = w.shape[:-2]
        x2 = x.reshape(*lead, -1, k)
        g2 = g.reshape(*lead, -1, n)
        want = list(x2.placements)
        for i in ctx.dims:
            want[i] = Shard(x2.ndim - 1)
        x2 = x2.redistribute(x2.device_mesh, want)
        return g @ w.transpose(-2, -1), x2.transpose(-2, -1) @ g2, None


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; a batch-sharded ``x`` of 3 or more dims against a 2-D
    ``w`` as one GEMM over its leading dims.  Where ``x`` and ``w`` are
    DTensors that some mesh dimensions leave whole (both replicated:
    every rank there repeats the product), each such rank computes one
    block of ``w``'s rows of its gradient, the block its own, instead of
    the whole of it again, as XLA's partitioner splits it."""
    if not (is_dtensor(x) and is_dtensor(w)) or w.ndim < 2:
        return x @ w
    if x.ndim >= 3 and w.ndim == 2 and all(
            not p.is_shard() or p.dim == 0 for p in x.placements):
        # one GEMM over x's leading dims: torch's matmul may instead
        # expand w over them, and DTensor then splits that expanded
        # weight by copying a block of it for every row
        y = matmul(reshape(x, (-1, x.shape[-1])), w)
        return reshape(y, (*x.shape[:-1], w.shape[-1]))
    k = w.shape[-2]
    dims, n = [], 1
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        if px.is_replicate() and pw.is_replicate() and \
                k % (n * w.device_mesh.size(i)) == 0:
            dims.append(i)
            n *= w.device_mesh.size(i)
    if not dims or not (x.requires_grad or w.requires_grad) or \
            not torch.is_grad_enabled():
        return x @ w
    return _BlockedWeightGrad.apply(x, w, tuple(dims))


def redistribute(t: torch.Tensor, placements: Sequence) -> torch.Tensor:
    """``t.redistribute(t.device_mesh, placements)``; where that gathers
    one dimension split over several mesh dims (or sums a value partial
    over several), as one collective over those dims flattened — the
    reference's one group across (pod, data) — instead of one a dim
    (an all-reduce in two steps moves half as much again)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    want, cur = list(placements), list(t.placements)
    if want == cur:
        return t
    mesh = t.device_mesh
    moved = [i for i, (c, w) in enumerate(zip(cur, want)) if c != w]
    kind = cur[moved[0]]
    n = 1
    for i in moved:
        n *= mesh.size(i)
    merge = (len(moved) > 1 and mesh.mesh_dim_names is not None
             and all(want[i] == Replicate() and cur[i] == kind
                     for i in moved)
             and (type(kind) is Partial or type(kind) is Shard
                  and [i for i, c in enumerate(cur) if c == kind] == moved
                  and t.shape[kind.dim] % n == 0))
    if not merge:
        return t.redistribute(mesh, want)
    flat = mesh[tuple(mesh.mesh_dim_names[i] for i in moved)]._flatten()
    local = DTensor.from_local(t.to_local(), flat, [kind], run_check=False
                               ).redistribute(flat, [Replicate()]).to_local()
    return DTensor.from_local(local, mesh, want, run_check=False,
                              shape=t.shape, stride=t.stride())


def _with(t, dims, placement):
    """``t`` with ``placement`` on the mesh dims ``dims``
    (:func:`redistribute`)."""
    want = list(t.placements)
    for i in dims:
        want[i] = placement
    return redistribute(t, want)


class _GatedExperts(torch.autograd.Function):
    """The experts' FFN on the reference's expert-parallel layout (see
    :func:`gated_experts`); ``split`` / ``idle``: the batch axes' mesh
    dims that do / do not split the capacity; ``gather``: gather the
    weights over ``idle`` too (for the forward's products and ``dh``)."""

    @staticmethod
    def forward(ctx, buf, w_gate, w_up, w_down, act, split, idle, gather):
        from torch.distributed.tensor import Replicate, Shard
        R = Replicate()
        # the buffer's and its gradient's d_model blocks where the
        # weights' d_model is split and the capacity whole
        blk = _with(buf, [i for i in idle if w_up.placements[i] == Shard(1)],
                    Shard(2))
        wg, wu = (_with(w, split, R) for w in (w_gate, w_up))
        if gather:
            gate = buf @ _with(wg, idle, R)
            up = buf @ _with(wu, idle, R)
        else:    # contract over the d_model blocks, sum the partials
            gate = _with(blk @ wg, idle, R)
            up = _with(blk @ wu, idle, R)
        wd = _with(w_down, split + idle, R)
        out = (act(gate) * up) @ wd
        ctx.save_for_backward(blk, wg, wu, wd if gather else
                              _with(w_down, split, R), gate, up)
        ctx.act, ctx.idle, ctx.gather = act, idle, gather
        ctx.buf_placements = list(buf.placements)
        ctx.out_placements = list(out.placements)
        ctx.w_placements = [list(w.placements)
                            for w in (w_gate, w_up, w_down)]
        return out

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate, Shard
        R = Replicate()
        blk, wg, wu, wd, gate, up = ctx.saved_tensors
        idle = ctx.idle
        g = redistribute(g, ctx.out_placements)
        # w_down's gradient: each rank its own d_model block
        g_blk = _with(g, [i for i in idle
                          if ctx.w_placements[2][i] == Shard(2)], Shard(2))
        with torch.enable_grad():
            gate_ = gate.detach().requires_grad_()
            up_ = up.detach().requires_grad_()
            h = ctx.act(gate_) * up_
            # gathered w_down, or its blocks' partial sums
            dh = g @ wd.mT if ctx.gather else _with(g_blk @ wd.mT, idle, R)
            dgate, dup = torch.autograd.grad(h, (gate_, up_), dh)
        dwg, dwu, dwd = (
            redistribute(a.mT @ b, p) for (a, b), p in zip(
                ((blk, dgate), (blk, dup), (h.detach(), g_blk)),
                ctx.w_placements))
        dblk = dgate @ wg.mT + dup @ wu.mT
        dbuf = redistribute(dblk, ctx.buf_placements)
        return dbuf, dwg, dwu, dwd, None, None, None, None


def gated_experts(buf: torch.Tensor, w_gate: torch.Tensor,
                  w_up: torch.Tensor, w_down: torch.Tensor,
                  act: Callable) -> torch.Tensor:
    """The experts' gated FFN ``(act(buf @ w_gate) * (buf @ w_up)) @
    w_down``, batched over the experts (``buf`` [E, C, D], ``w_gate`` and
    ``w_up`` [E, D, F], ``w_down`` [E, F, D]).

    With DTensors, on the reference's expert-parallel layout: each rank
    keeps its own experts (split over the model axis) and nothing moves
    an expert or its activations between the experts' ranks.  On the
    batch axes that split the capacity, the weights are gathered over
    their d_model shards and the products are local (the weights'
    gradients reduce-scattered back).  On the batch axes that leave the
    capacity whole (a capacity they do not divide), ``w_down`` is
    gathered for the forward; ``w_gate`` and ``w_up`` are gathered too
    where a weight is smaller than the hidden's all-reduce (d_model < 2 ×
    capacity), else a rank contracts its d_model block of the buffer and
    the hidden's partial sums are all-reduced, and ``dh`` likewise
    (gathered ``w_down``, or its blocks' partial sums).  The weights'
    gradients are each rank's own d_model blocks, and the buffer's
    gradient comes in d_model blocks, all-gathered — XLA's program for
    the reference's annotations.  Without DTensors, the plain
    products."""
    if not all(is_dtensor(t) for t in (buf, w_gate, w_up, w_down)):
        return (act(buf @ w_gate) * (buf @ w_up)) @ w_down
    from repro_torch.sharding.axes import (_expand_virtual, current_rules,
                                           mesh_shape)
    shape = mesh_shape(buf.device_mesh)
    names = list(shape)
    dp = [names.index(a) for a in _expand_virtual(
        current_rules().get("batch"), shape) if shape[a] > 1]
    split = [i for i in dp if buf.placements[i].is_shard()]
    idle = [i for i in dp if i not in split]
    return _GatedExperts.apply(buf, w_gate, w_up, w_down, act, split, idle,
                               buf.shape[2] < 2 * buf.shape[1])


def write_position(buf: torch.Tensor, pos: int,
                   value: torch.Tensor) -> torch.Tensor:
    """``buf[:, pos] = value`` in place; returns ``buf``.  A DTensor
    buffer split on its positions (dim 1) and its batch only is written
    on the rank whose block holds ``pos``, ``value`` taken there in the
    buffer's batch layout."""
    if not is_dtensor(buf) or not any(p.is_shard() and p.dim == 1
                                      for p in buf.placements) \
            or any(p.is_shard() and p.dim > 1 for p in buf.placements):
        buf[:, pos] = value
        return buf
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    seq = [i for i, p in enumerate(buf.placements)
           if p.is_shard() and p.dim == 1]
    rows = [Shard(0) if p.is_shard() and p.dim == 0 else Replicate()
            for p in buf.placements]
    v = _as_dtensor(value, mesh).redistribute(mesh, rows).to_local()
    block, n = _vocab_block(mesh, seq)
    local = buf.to_local()
    first = block * local.shape[1]
    if first <= pos < first + local.shape[1]:
        local[:, pos - first] = v
    return buf


# ---------------------------------------------------------------------------
# The vocabulary-sharded lookup, gather and logsumexp
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


def lookup_table(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The table ``w`` [V, D] as :func:`embedding_lookup` reads it for
    ``tokens``: gathered over the batch axes that split its d_model
    (FSDP), save where the tokens lie whole there and are fewer than a
    rank's rows of the table — a decode step's token: each rank then
    reads its own d_model block of the rows, and the row's blocks move
    instead of the table's (as XLA's program does).  No-op without a
    mesh."""
    from repro_torch.sharding.axes import current_mesh, dp_placements
    if current_mesh() is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    tok = tokens.placements if is_dtensor(tokens) else \
        [Replicate()] * w.device_mesh.ndim
    few = tokens.numel() <= w.to_local().shape[0]
    want = dp_placements(w)
    keep = [p if p.is_shard() and p.dim == 1 and few and not t.is_shard()
            else q for p, q, t in zip(w.placements, want, tok)]
    return w if keep == list(w.placements) else \
        w.redistribute(w.device_mesh, keep)


def embedding_lookup(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``w[tokens]``.  A DTensor table is read on each rank's own
    vocabulary block (the tokens outside it give 0) and summed over the
    ranks that split the vocabulary; the tokens keep their batch
    sharding, and a table replicated where they are sharded gets its
    gradient summed there.  Where the table's d_model is split (and the
    tokens whole, :func:`lookup_table`), each rank reads its d_model
    block and the rows stay split there.  DTensor's own rules for
    indexing do not take batch-sharded tokens in every torch release, and
    its embedding rule's backward does not compose with the table's
    all-gather."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not is_dtensor(w):
        return w[tokens]
    mesh = w.device_mesh
    vocab = [i for i, p in enumerate(w.placements)
             if p.is_shard() and p.dim == 0]
    cols = [i for i, p in enumerate(w.placements)
            if p.is_shard() and p.dim == 1]
    tokens = _as_dtensor(tokens, mesh)
    rest = [Replicate() if i in vocab + cols else p
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
    last = Shard(len(shape) - 1)
    out = [last if i in cols else p for i, p in enumerate(rest)]
    part = [Partial() if i in vocab else p for i, p in enumerate(out)]
    return DTensor.from_local(rows, mesh, part, run_check=False, shape=shape,
                              stride=contiguous_strides(shape)
                              ).redistribute(mesh, out)


def _vocab_split(lf: torch.Tensor):
    """(the mesh dims that shard the last dimension of a DTensor ``lf``,
    ``lf``'s placements with those replicated)."""
    from torch.distributed.tensor import Replicate
    last = lf.ndim - 1
    vocab = [i for i, p in enumerate(lf.placements)
             if p.is_shard() and p.dim == last]
    rest = [Replicate() if i in vocab else p
            for i, p in enumerate(lf.placements)]
    return vocab, rest


def _over_vocab(local: torch.Tensor, lf: torch.Tensor, vocab, rest,
                op: str = "sum") -> torch.Tensor:
    """A rank's value at each of ``lf``'s positions from its own
    vocabulary block, ``local``, reduced by ``op`` over the ranks of the
    mesh dims ``vocab``: a DTensor laid out as ``rest``."""
    from torch.distributed.tensor import DTensor, Partial
    shape = tuple(lf.shape[:-1])
    part = [Partial(op) if i in vocab else p for i, p in enumerate(rest)]
    return DTensor.from_local(local, lf.device_mesh, part, run_check=False,
                              shape=shape, stride=contiguous_strides(shape)
                              ).redistribute(lf.device_mesh, rest)


def target_logits(lf: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``lf[..., targets]``: each position's logit of its target.  Logits
    that are a DTensor sharded on the vocabulary are read on each rank's
    own vocabulary block (the targets outside it give 0) and summed over
    those ranks, so no rank gathers the whole vocabulary."""
    if not is_dtensor(lf):
        return torch.gather(lf, -1, targets[..., None])[..., 0]
    vocab, rest = _vocab_split(lf)
    targets = _as_dtensor(targets, lf.device_mesh).redistribute(
        lf.device_mesh, rest)
    if not vocab:
        return torch.gather(lf, -1, targets[..., None])[..., 0]
    block, n = _vocab_block(lf.device_mesh, vocab)
    width = lf.shape[-1] // n
    local = targets.to_local() - block * width
    inside = (local >= 0) & (local < width)
    ll = torch.gather(lf.to_local(), -1,
                      local.clamp(0, width - 1)[..., None])[..., 0]
    return _over_vocab(ll * inside.to(ll.dtype), lf, vocab, rest)


def logsumexp(lf: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(lf, dim=-1)``.  Logits that are a DTensor sharded
    on the vocabulary keep their batch and sequence placements: each rank
    takes the max of its own vocabulary block, the maxima are combined
    over the vocabulary's ranks (and held out of the gradient), each rank
    sums ``exp(lf - max)`` over its block, and the sums are combined over
    those ranks — so no rank holds another rank's batch rows (DTensor's
    own rule gathers the batch to reduce the vocabulary whole)."""
    if not is_dtensor(lf):
        return torch.logsumexp(lf, dim=-1)
    vocab, rest = _vocab_split(lf)
    if not vocab:
        return torch.logsumexp(lf, dim=-1)
    local = lf.to_local()
    m = _over_vocab(local.detach().amax(-1), lf, vocab, rest, "max")
    s = _over_vocab(torch.exp(local - m.to_local()[..., None]).sum(-1), lf,
                    vocab, rest)
    return torch.log(s) + m
