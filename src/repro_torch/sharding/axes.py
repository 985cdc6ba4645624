"""Logical-axis sharding: the single place where parallelism is decided —
the counterpart of ``repro.sharding.axes``, on ``torch.distributed``'s
``DeviceMesh`` and ``DTensor``.

Every parameter and activation in the model library is annotated with
*logical* axis names ("embed", "heads", "ff", "experts", "batch", ...).
A ``LogicalRules`` table maps logical names onto mesh dimensions; the
same model code therefore runs on one card, one pod (16×16 data×model)
or two pods (2×16×16 pod×data×model) just by swapping the rules.

Parallelism realized through the default rules:
  * DP  — "batch" → ("pod", "data")        (data parallel across pods too)
  * FSDP— "embed" → ("pod", "data")        (params sharded over the DP axes)
  * TP  — "ff"/"heads"/"vocab" → "model"   (megatron-style tensor parallel)
  * EP  — "experts" → "model"              (expert parallel for MoE)
  * SP  — "kv_seq" → "data"                (sequence/context parallel for
                                            long-context decode cells)

A mapping is *dropped* (axis left unsharded) when the dimension size is not
divisible by the mesh axis size — e.g. 8 KV heads on a 16-way model axis.

The resolved spec is the reference's ``PartitionSpec`` as a tuple
(:class:`PartitionSpec`); :func:`logical_to_placements` turns it into a
DTensor's placements, one per mesh dimension.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

AxisTarget = Union[str, Tuple[str, ...], None]
LogicalRules = Dict[str, AxisTarget]

# ---------------------------------------------------------------------------
# Default rules
# ---------------------------------------------------------------------------

# "fsdp" and "dp" are *virtual* targets expanded to whatever subset of
# ("pod", "data") exists on the current mesh.
DEFAULT_RULES: LogicalRules = {
    # activations
    "batch": "dp",
    "seq": None,
    # Context parallelism for decode caches: whatever DP axes the batch dim
    # left unused, plus the model axis when KV heads cannot shard over it.
    "kv_seq": ("data", "model"),
    "act_embed": None,
    "act_ff": "model",
    "act_heads": "model",
    # parameters
    "embed": "fsdp",
    "vocab": "model",
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qk_dim": None,
    "experts": "model",
    "expert_ff": None,     # per-expert hidden dim stays local to the expert
    "expert_cap": "dp",    # dispatch-buffer capacity dim shards over DP axes
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "slstm_hidden": None,  # "model" under the xlstm_opt preset
    "conv_kernel": None,
    "lora": None,
    "frontend": None,
    "layers": None,        # stacked leading axis is never sharded
    "norm": None,
}

# Pure ZeRO-3 layout: no tensor parallelism — every mesh axis is data
# parallel, parameters are fully sharded along their "embed" axis.
FSDP_ONLY_RULES: LogicalRules = dict(
    DEFAULT_RULES,
    batch=("pod", "data", "model"),
    embed=("pod", "data", "model"),
    vocab=None, ff=None, heads=None, kv_heads=None, experts=None,
    ssm_inner=None, ssm_heads=None,
    act_ff=None, act_heads=None,
    expert_cap=None,
    kv_seq=("data", "model"),
)

# Output-shard the sLSTM recurrence over the model axis.
XLSTM_OPT_RULES: LogicalRules = dict(DEFAULT_RULES, slstm_hidden="model")

# Additionally drop tensor parallelism on the (tiny) mLSTM/FFN projections.
XLSTM_OPT2_RULES: LogicalRules = dict(
    XLSTM_OPT_RULES, ff=None, act_ff=None, vocab=None, heads=None)

RULE_PRESETS: Dict[str, LogicalRules] = {
    "tp_fsdp": DEFAULT_RULES,
    "fsdp_only": FSDP_ONLY_RULES,
    "xlstm_opt": XLSTM_OPT_RULES,
    "xlstm_opt2": XLSTM_OPT2_RULES,
}


class PartitionSpec(tuple):
    """A resolved spec: per tensor dimension ``None``, a mesh axis name or
    a tuple of names, trailing ``None``s trimmed (``P(*entries)``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec on it — the reference's ``NamedSharding``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self):
        return logical_placements_of(self.spec, self.mesh)

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (whole, on every rank) as a DTensor on the mesh's device
        under these placements; each rank keeps its block."""
        from torch.distributed.tensor import distribute_tensor
        kind = self.mesh.device_type
        dev = torch.device(kind, torch.cuda.current_device()) \
            if kind == "cuda" else torch.device(kind)
        return distribute_tensor(t.to(dev), self.mesh, self.placements)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: LogicalRules = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[LogicalRules] = None):
    """Install mesh + logical rules for model code executed in this block."""
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = dict(rules) if rules is not None else dict(DEFAULT_RULES)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old


def current_mesh():
    return _CTX.mesh


def current_rules() -> LogicalRules:
    return _CTX.rules


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name → size, in mesh order, for a ``DeviceMesh`` (its
    ``mesh_dim_names`` and ``shape``) or any object with a ``shape``
    mapping (the reference tests' ``FakeMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _expand_virtual(target: AxisTarget, shape: Mapping[str, int]
                    ) -> Tuple[str, ...]:
    if target is None:
        return ()
    if isinstance(target, str):
        target = (target,)
    out: list = []
    for t in target:
        if t in ("dp", "fsdp"):
            out.extend(a for a in ("pod", "data") if a in shape)
        elif t in shape:
            out.append(t)
    return tuple(out)


def _axis_size(mesh, axes: Tuple[str, ...]) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def logical_to_pspec(
    logical_axes: Sequence[Optional[str]],
    mesh=None,
    rules: Optional[LogicalRules] = None,
    dim_sizes: Optional[Sequence[int]] = None,
) -> PartitionSpec:
    """Resolve a tuple of logical axis names into a PartitionSpec.

    If ``dim_sizes`` is given, mappings whose mesh-axis product does not
    divide the dimension are dropped (left replicated) — the
    "divisibility guard" that lets e.g. 8 KV heads survive a 16-way model
    axis.  A mesh axis is used by one dimension at most: the first.
    """
    mesh = mesh or current_mesh()
    rules = rules or current_rules()
    if mesh is None:
        return P()
    shape = mesh_shape(mesh)
    entries: List[Any] = []
    used: set = set()
    for i, name in enumerate(logical_axes):
        if name is None:
            entries.append(None)
            continue
        target = _expand_virtual(rules.get(name), shape)
        target = tuple(a for a in target if a not in used)
        if not target:
            entries.append(None)
            continue
        if dim_sizes is not None:
            size = dim_sizes[i]
            if size is None or size % _axis_size(mesh, target) != 0:
                entries.append(None)
                continue
        used.update(target)
        entries.append(target if len(target) > 1 else target[0])
    # trim trailing Nones for a tidy spec
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def logical_placements_of(spec: Sequence, mesh) -> list:
    """A resolved spec's DTensor placements, one per mesh dimension in
    mesh order: ``Shard(d)`` where tensor dimension d's entry names the
    mesh axis (on each of its axes, for an entry spread over several),
    else ``Replicate()``.  A mesh axis of size 1 gives ``Replicate()``:
    its one rank holds the whole dimension either way, and DTensor's view
    rules refuse to reshape a dimension sharded there when its size is 1
    (one KV head of a smoke config)."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            dim_of[a] = d
    return [Shard(dim_of[a]) if a in dim_of and n > 1 else Replicate()
            for a, n in mesh_shape(mesh).items()]


def logical_to_placements(
    logical_axes: Sequence[Optional[str]],
    mesh=None,
    rules: Optional[LogicalRules] = None,
    dim_sizes: Optional[Sequence[int]] = None,
) -> list:
    """:func:`logical_to_pspec` as DTensor placements on ``mesh``."""
    mesh = mesh or current_mesh()
    return logical_placements_of(
        logical_to_pspec(logical_axes, mesh, rules, dim_sizes), mesh)


def logical_to_sharding(
    logical_axes: Sequence[Optional[str]],
    mesh=None,
    rules: Optional[LogicalRules] = None,
    dim_sizes: Optional[Sequence[int]] = None,
) -> Optional[NamedSharding]:
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_to_pspec(logical_axes, mesh, rules,
                                                dim_sizes))


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient too —
    the transpose of jax's ``with_sharding_constraint`` is the same
    constraint on the cotangent.  DTensor's own redistribute sends the
    gradient back to the operand's placements, and keeps a gradient that
    arrives ``Partial`` partial where the operand was: the sum then
    reaches the products before the constraint unreduced, and DTensor
    runs them on gathered weights at full width."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def shard_act(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Apply a sharding constraint expressed in logical axes to an
    activation: a DTensor is redistributed to the resolved placements,
    and so is its gradient (:class:`_Constrain`).

    No-op when no mesh is installed (one device), and for a plain tensor,
    which is local to its rank.
    """
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(
            f"shard_act: got {len(logical_axes)} axes for rank-{x.ndim} array"
        )
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    placements = tuple(logical_to_placements(logical_axes, mesh,
                                             dim_sizes=tuple(x.shape)))
    if x.requires_grad and torch.is_grad_enabled():
        return _Constrain.apply(x, placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def gather_dp(tree: Any, meets: Optional[torch.Tensor] = None,
              leave: Sequence[str] = (), transposed: bool = False) -> Any:
    """A parameter tree as a layer uses it: each DTensor leaf replicated
    on the mesh axes the current rules put the batch on (FSDP / ZeRO-3:
    the parameters' shards over the data-parallel axes are all-gathered
    for the layer, and their gradients reduce-scattered back), its
    tensor-parallel shards kept.  XLA reaches this layout from the
    reference's activation constraints; DTensor, choosing op by op, may
    instead gather the activations' batch.  No-op without a mesh.

    ``meets``: the activation the leaves' products take (a decode
    step's, a token a sequence), where XLA's
    partitioner may move it rather than the weights.  This holds for a
    leaf whose batch-axes shards split the dimension a product contracts
    over: its first, or with ``transposed`` (``x @ w.T``) its last (a
    leaf sharded there on its output dimension is gathered).  Such a
    leaf keeps its shards where ``meets`` is replicated on those axes
    and a rank would hold more of the leaf, gathered, than of ``meets``
    (the product contracts over the shards, its partial sums reduced,
    instead of gathering the larger operand); where ``meets`` is sharded
    there, a leaf replicated on a mesh axis as large as the batch axes
    together moves its shards onto that axis (a permutation of the
    blocks) instead of gathering them.  Subtrees under a key in
    ``leave`` are returned as they are: their layer gathers them."""
    if current_mesh() is None:
        return tree
    from torch.distributed.tensor import DTensor

    def one(t):
        if isinstance(t, dict):
            return {k: v if k in leave else one(v) for k, v in t.items()}
        if not isinstance(t, DTensor):
            return t
        want = dp_placements(t, meets, transposed)
        return t if want == list(t.placements) else \
            t.redistribute(t.device_mesh, want)
    return one(tree)


def dp_placements(t, meets: Optional[torch.Tensor] = None,
                  transposed: bool = False) -> list:
    """The placements :func:`gather_dp` gives the DTensor leaf ``t`` (the
    same ``meets`` and ``transposed``), under the current mesh and
    rules."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = current_mesh()
    shape = mesh_shape(mesh)
    dp = _expand_virtual(current_rules().get("batch"), shape)
    names = list(shape)
    idle = isinstance(meets, DTensor) and all(
        not meets.placements[names.index(a)].is_shard() for a in dp)
    held = {p.dim for i, p in enumerate(t.placements)
            if names[i] in dp and p.is_shard()}
    contracted = held == {t.ndim - 1} if transposed else \
        bool(held) and t.ndim - 1 not in held
    if isinstance(meets, DTensor) and contracted:
        if idle:   # the leaf's elements on a rank once gathered
            split = math.prod(shape[names[i]] for i, p in
                              enumerate(t.placements)
                              if names[i] not in dp and p.is_shard())
            if t.numel() // split > meets.to_local().numel():
                return list(t.placements)
        free = [i for i, p in enumerate(t.placements)
                if names[i] not in dp and shape[names[i]] ==
                _axis_size(mesh, dp) and not p.is_shard()]
        if not idle and len(held) == 1 and free:
            want = [Replicate() if names[i] in dp else p
                    for i, p in enumerate(t.placements)]
            want[free[0]] = [p for i, p in enumerate(t.placements)
                             if names[i] in dp and p.is_shard()][0]
            return want
    return [Replicate() if names[i] in dp and p.is_shard() else p
            for i, p in enumerate(t.placements)]


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_shardings(spec_tree, shape_tree, mesh=None, rules=None):
    """Map a tree of logical-axis tuples (+ a matching tree of anything
    with a ``shape``) to NamedShardings, with the divisibility guard
    applied per leaf.  Trees are nested dicts, tuples of subtrees or
    NamedTuples, as the models' and the optimizer's."""
    mesh = mesh or current_mesh()

    def walk(axes, shapes):
        if _is_axes(axes):
            return logical_to_sharding(axes, mesh, rules,
                                       dim_sizes=tuple(shapes.shape))
        if isinstance(axes, dict):
            return {k: walk(v, shapes[k]) for k, v in axes.items()}
        if hasattr(axes, "_fields"):
            return type(axes)(*(walk(a, s) for a, s in zip(axes, shapes)))
        if isinstance(axes, (list, tuple)):
            return type(axes)(walk(a, s) for a, s in zip(axes, shapes))
        raise TypeError(f"tree_shardings: leaf {axes!r}")

    return walk(spec_tree, shape_tree)
