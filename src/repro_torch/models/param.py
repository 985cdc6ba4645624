"""Parameter schemas: shape + logical axes + initializer, as pure data —
the counterpart of ``repro.models.param``.

A layer is described by a *schema*: a nested dict whose leaves are
``ParamSpec``.  From a schema we derive, without ever allocating:

* ``init_tree``  — materialized parameters (torch tensors), drawn from an
  explicit ``torch.Generator`` on an explicit device
* ``axes_tree``  — logical-axis tuples

Stacked (looped) layers carry a leading "layers" axis on every leaf
(``stack_schema``); ``init_stacked`` draws them.  The trees keep the
reference's layout leaf for leaf, so :func:`carry` moves a reference
parameter (or cache) tree, given as numpy arrays, into the port by a
leaf-wise copy.  The port's draws are not ``jax.random``'s: to compare
with the reference, carry its weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

DTypeLike = Union[str, torch.dtype]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | small_normal
    scale: Optional[float] = None  # stddev override; default 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def torch_dtype(dtype: DTypeLike) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16``; a torch dtype passes."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def tree_map(fn: Callable, tree: Any, is_leaf: Callable = None) -> Any:
    """``fn`` over the leaves of a tree of nested dicts."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


#: the most elements one draw takes: a larger leaf is drawn a slice of
#: its leading axis at a time (a stacked leaf one layer at a time, an
#: expert bank one expert at a time), so the f32 draw beside the weights
#: stays at 256 MB however large the leaf
DRAW_ELEMENTS = 1 << 26


def _fill(out: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """Draw ``out`` (any dtype) as N(0, scale²) from ``gen`` in f32,
    rounded to ``out``'s dtype; a leaf of more than ``DRAW_ELEMENTS``
    elements slice by slice along its leading axis, each slice (or block
    of slices) one draw."""
    if out.numel() <= DRAW_ELEMENTS or out.dim() <= 1:
        out.copy_(torch.randn(out.shape, generator=gen, dtype=torch.float32,
                              device=out.device).mul_(scale))
        return
    per = out[0].numel()
    rows = max(1, DRAW_ELEMENTS // per)
    for i in range(0, out.shape[0], rows):
        part = out[i:i + rows]
        _fill(part[0] if rows == 1 else part, gen, scale)


def _leaf_init(spec: ParamSpec, gen: torch.Generator, dtype, device,
               num: Optional[int] = None) -> torch.Tensor:
    """``spec``'s tensor, or ``num`` stacked copies of it drawn one copy
    at a time (each scaled by the spec's own fan-in)."""
    shape = spec.shape if num is None else (num, *spec.shape)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    fan_in = spec.shape[0] if spec.shape else 1
    scale = spec.scale if spec.scale is not None \
        else 1.0 / np.sqrt(max(fan_in, 1))
    if spec.init == "small_normal":
        scale = 0.02
    out = torch.empty(shape, dtype=dtype, device=device)
    for copy in (out,) if num is None else out:
        _fill(copy, gen, float(scale))
    return out


def init_tree(gen: torch.Generator, schema: Any, dtype: DTypeLike,
              device=None) -> Any:
    """Materialize a schema into parameters, drawing from ``gen`` on
    ``device`` (the generator's own device when ``None``)."""
    dtype, device = torch_dtype(dtype), device or gen.device
    return tree_map(lambda s: _leaf_init(s, gen, dtype, device),
                    schema, is_leaf=_is_spec)


def init_stacked(gen: torch.Generator, schema: Any, num: int,
                 dtype: DTypeLike, device=None) -> Any:
    """``num`` stacked copies of ``schema`` (leading "layers" axis), each
    leaf drawn one copy at a time; each copy is scaled by its own fan-in,
    as the reference's vmapped init."""
    dtype, device = torch_dtype(dtype), device or gen.device
    return tree_map(lambda s: _leaf_init(s, gen, dtype, device, num),
                    schema, is_leaf=_is_spec)


def axes_tree(schema: Any) -> Any:
    return tree_map(lambda s: tuple(s.axes), schema, is_leaf=_is_spec)


def stack_schema(schema: Any, num: int) -> Any:
    """Schema for ``num`` stacked copies (leading "layers" axis)."""
    return tree_map(
        lambda s: ParamSpec((num, *s.shape), ("layers", *s.axes),
                            init=s.init, scale=s.scale),
        schema, is_leaf=_is_spec)


def param_count(tree: Any) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def place(tree: Any, axes: Any, mesh) -> Any:
    """Each tensor of ``tree`` as a DTensor on ``mesh``, placed as its
    logical axes in ``axes`` (a tree of the same structure) resolve under
    the current rules, the divisibility guard applied to its shape.  Every
    rank holds the whole tensor; it keeps its own block."""
    from repro_torch.sharding.axes import tree_shardings
    return place_tree(tree, tree_shardings(axes, tree, mesh=mesh))


def place_tree(tree: Any, shardings: Any) -> Any:
    """Each tensor of ``tree`` placed by the ``NamedSharding`` at the same
    place of ``shardings`` (dicts and NamedTuples; a None leaf keeps its
    tensor)."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(place_tree(v, s) for v, s in zip(tree,
                                                              shardings)))
    return tree if shardings is None else shardings.place(tree)


def carry(tree: Any, device, *, axes: Any = None, mesh=None) -> Any:
    """A tree of numpy arrays (a reference parameter or cache tree pulled
    through ``np.asarray``) → the same tree of tensors on ``device``, each
    in its array's dtype.  bfloat16 arrays (numpy's ``ml_dtypes``
    extension) are widened to float32 on the host first, which is exact,
    and narrowed back on the way in.  With a ``mesh``, each leaf becomes a
    DTensor on it, placed as its logical axes in ``axes`` resolve
    (:func:`place`)."""

    def one(a):
        a = np.asarray(a)
        native = None
        if a.dtype.name == "bfloat16":
            a, native = a.astype(np.float32), torch.bfloat16
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=native or t.dtype)
    out = tree_map(one, tree)
    return out if mesh is None else place(out, axes, mesh)
