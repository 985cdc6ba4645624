"""Automatic kernel-statistics gathering at the aten level (paper §5,
Algorithm 1) — the counterpart of ``repro.core.counting``.

The reference walks a jaxpr.  PyTorch runs eagerly, so the port runs the
kernel under :class:`~torch._subclasses.fake_tensor.FakeTensorMode` (no
data, nothing executes) with a :class:`TorchDispatchMode` on top that
sees every aten op the kernel dispatches and classifies it in the
reference's feature vocabulary, so a reference ``Model`` expression and
profile mean the same thing on both sides:

  * arithmetic — ``f_op_<dtype>_<kind>`` by (kind, dtype); ``mm``/``bmm``
    and friends count as *madd* sequences plus contiguous operand loads
    and a contiguous result store, as the reference counts
    ``dot_general``;
  * memory — ``f_mem_<class>_<dtype>_<load|store>`` by access class:
    ``contig`` (copies, fills, padding, ``where``), ``strided``
    (transposes, flips), ``gather``/``scatter`` (indexing), ``concat``;
  * sync — ``f_sync_launch_kernel`` once per counted call,
    ``f_sync_loop_steps`` once per step of a :func:`counted_range` or
    :func:`counted_loop` loop (the port's stand-ins for
    ``scan``/``fori_loop``), and
    ``f_sync_grid_programs`` from the hand kernels' cost rules.

Views (``view``, ``slice``, ``select``, ``expand``, ...) move no data in
PyTorch and count nothing; the reference counts ``reshape``/``slice`` as
contiguous stores, a difference recorded in ROADMAP queue C.

A ``repro_torch::*`` custom op (a hand-written CUDA kernel) is priced by
the cost rule registered for it with :func:`register_op_cost_rule` — the
rules live in :mod:`repro_torch.analysis.kernelcost`, imported on first
use — as the reference opens ``pallas_call`` with a registered handler.

``f_vmem_*`` features are the port's own: on Hopper they mean
shared-memory (or register) traffic inside a hand kernel, the on-chip
class the reference's VMEM block traffic stands for.  The base model has
no term for them; predictions list them as unmodeled.

:class:`SymbolicCounts` (:func:`parametric_counts`,
:func:`parametric_counts_from`) rebuilds counts as polynomials in named
sizes from a ``degree+1`` probe grid, the reference's amortization; the
count engine (:mod:`repro_torch.core.countengine`) builds its symbolic
families with it.
"""
from __future__ import annotations

import contextvars
import importlib
import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_structure

from repro_torch.core.symbolic import ParametricCount, interpolate_polynomial


class FeatureCounts(dict):
    """Mapping feature-id → count (float).  Missing keys read as 0."""

    def __missing__(self, key):
        return 0.0

    def add(self, key: str, value: float):
        self[key] = self.get(key, 0.0) + float(value)


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` → ``"float32"``: the reference's dtype spelling."""
    return str(dtype).removeprefix("torch.")


_ARITH = {
    "add": "add", "sub": "add", "rsub": "add", "neg": "add", "abs": "add",
    "mul": "mul", "square": "mul", "div": "div", "reciprocal": "div",
    "maximum": "cmp", "minimum": "cmp", "clamp": "cmp", "clamp_min": "cmp",
    "clamp_max": "cmp",
    "exp": "transc", "log": "transc", "tanh": "transc", "sigmoid": "transc",
    "rsqrt": "transc", "sqrt": "transc", "erf": "transc", "sin": "transc",
    "cos": "transc", "exp2": "transc", "log1p": "transc", "expm1": "transc",
    "cumsum": "add", "logcumsumexp": "transc", "cummax": "cmp",
}

_REDUCE = {"sum": "add", "mean": "add", "amax": "cmp", "amin": "cmp",
           "prod": "mul", "argmax": "cmp", "argmin": "cmp", "any": "add",
           "all": "add"}

_MATMUL = {"mm", "bmm", "mv", "dot", "addmm", "baddbmm", "addmv"}

_MEM_GATHER = {"index", "gather", "index_select", "take", "embedding"}
_MEM_SCATTER = {"index_put", "scatter", "scatter_add", "scatter_reduce",
                "index_add", "index_copy"}
# transposes/flips are views in PyTorch, but the reference counts its
# `transpose`/`rev` as strided traffic and the consumer reads strided
_MEM_STRIDED = {"t", "transpose", "permute", "flip"}
_MEM_CONCAT = {"cat", "stack"}
_MEM_CONTIG = {"clone", "_to_copy", "copy", "constant_pad_nd", "zeros",
               "ones", "full", "fill", "zeros_like", "ones_like",
               "full_like", "where", "arange", "new_zeros", "new_ones",
               "new_full", "masked_fill", "repeat"}

# Views, aliases and allocations move no data: free by nature.
_VIEW_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "slice", "select",
    "squeeze", "unsqueeze", "expand", "alias", "as_strided", "detach",
    "lift_fresh", "empty", "empty_like", "new_empty", "empty_strided",
    "split", "split_with_sizes", "unbind",
})

# Deliberately free, as the reference's ZERO_COST_PRIMITIVES: predicates
# and bit bookkeeping ride along with the selects and arithmetic they
# gate, and random draws build example inputs rather than kernel work.
_ZERO_COST_WORK = frozenset({
    "lt", "le", "gt", "ge", "eq", "ne", "logical_and", "logical_or",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_not", "sign",
    "isfinite", "isnan", "randn", "rand", "randint", "normal", "uniform",
    "random", "bernoulli",
})

# Moves data yet earns no feature, for parity only: the reference on the
# installed jax counts nothing for jnp.roll (its concatenate sits in a
# nested jit the walker does not open), so neither side's battery
# exercises f_mem_concat — see ROADMAP queue C.  The scope auditor
# reports it as the unmodeled work it is.
_UNPRICED_FOR_PARITY = frozenset({"roll"})

# Ops whose result depends on tensor data the fake-tensor counter does
# not have: a host read (``.item()``) or a data-sized output.  The
# counter cannot count past them.
DATA_DEPENDENT_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "unique",
    "_unique2", "unique_consecutive", "unique_dim",
})

# what _count_op did with one dispatched op — the counter's
# classification, which the scope auditor (repro_torch.analysis.scope)
# reads instead of keeping op lists of its own
ARITH = "arith"          # priced: arithmetic features
MEMORY = "memory"        # priced: memory-traffic features
KERNEL = "kernel"        # priced: a hand kernel's cost rule
FREE = "free"            # no data moved: view, alias, allocation
ZERO = "zero"            # work the counter deliberately leaves free
UNPRICED = "unpriced"    # work that earns no feature
OPAQUE = "opaque"        # an op outside the namespaces the counter reads

# ---------------------------------------------------------------------------
# cost rules of the hand kernels (repro_torch::* custom ops)
# ---------------------------------------------------------------------------

#: op name ("repro_torch::matmul_tiled") → rule(*op_args) -> FeatureCounts
_OP_COST_RULES: Dict[str, Callable[..., FeatureCounts]] = {}
_RULE_MODULE = "repro_torch.analysis.kernelcost"


def register_op_cost_rule(op: str,
                          rule: Callable[..., FeatureCounts]) -> None:
    """Price custom op ``op`` (``"namespace::name"``) with ``rule``,
    called with the op's own arguments (fake tensors and ints) and
    returning the op's whole cost."""
    _OP_COST_RULES[op] = rule


class MissingCostRule(LookupError):
    """A ``repro_torch::*`` op with no registered cost rule."""


def _rule_for(op: str) -> Callable[..., FeatureCounts]:
    if op not in _OP_COST_RULES:
        importlib.import_module(_RULE_MODULE)    # registers on import
    rule = _OP_COST_RULES.get(op)
    if rule is None:
        raise MissingCostRule(
            f"custom op {op!r} has no registered cost rule: the counter "
            f"cannot price a hand kernel it does not know "
            f"(register one in {_RULE_MODULE})")
    return rule


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------


def _first_tensor(tree) -> Optional[torch.Tensor]:
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            return leaf
    return None


def _count_op(func, args, kwargs, out, counts: FeatureCounts) -> str:
    """Add one dispatched op's features to ``counts`` and return what the
    counter made of it: :data:`ARITH`, :data:`MEMORY` or :data:`KERNEL`
    when it priced the op, else :data:`FREE`, :data:`ZERO`,
    :data:`UNPRICED` or :data:`OPAQUE`."""
    if func.namespace == "repro_torch":
        name = f"{func.namespace}::{func.overloadpacket.__name__}"
        for k, v in _rule_for(name)(*args, **kwargs).items():
            counts.add(k, v)
        return KERNEL
    res = _first_tensor(out)
    if res is None:
        return FREE                     # metadata: prim::device, sizes
    if func.namespace != "aten":
        return OPAQUE
    op = func.overloadpacket.__name__.rstrip("_")   # in-place == out-of-place
    if op in _VIEW_OPS:
        return FREE
    if op in _ZERO_COST_WORK:
        return ZERO
    if op in _UNPRICED_FOR_PARITY:
        return UNPRICED
    dt = dtype_name(res.dtype)

    if op in _MATMUL:
        a, b = (args[1], args[2]) if op.startswith(("add", "baddbmm")) \
            else (args[0], args[1])
        counts.add(f"f_op_{dt}_madd", res.numel() * a.shape[-1])
        for x in (a, b):
            counts.add(f"f_mem_contig_{dtype_name(x.dtype)}_load", x.numel())
        counts.add(f"f_mem_contig_{dt}_store", res.numel())
        if op.startswith(("add", "baddbmm")):
            counts.add(f"f_op_{dt}_add", res.numel())
        return ARITH
    if op == "pow":
        exp = args[1] if len(args) > 1 else kwargs.get("exponent")
        if isinstance(exp, int) or (isinstance(exp, float)
                                    and exp.is_integer()):
            # square-and-multiply, as the reference's integer_pow rule
            y = int(exp)
            p = abs(y)
            if p >= 2:
                n_mul = (p.bit_length() - 1) + (bin(p).count("1") - 1)
                counts.add(f"f_op_{dt}_mul", res.numel() * n_mul)
            if y < 0:
                counts.add(f"f_op_{dt}_div", res.numel())
        else:
            counts.add(f"f_op_{dt}_transc", res.numel())
        return ARITH
    if op in ("max", "min"):
        if func._overloadname == "other":       # elementwise
            counts.add(f"f_op_{dt}_cmp", res.numel())
        else:                                   # reduction
            src = args[0]
            counts.add(f"f_op_{dtype_name(src.dtype)}_cmp", src.numel())
        return ARITH
    if op in _ARITH:
        counts.add(f"f_op_{dt}_{_ARITH[op]}", res.numel())
        return ARITH
    if op in _REDUCE:
        src = args[0]
        counts.add(f"f_op_{dtype_name(src.dtype)}_{_REDUCE[op]}", src.numel())
        return ARITH
    if op in _MEM_GATHER:
        counts.add(f"f_mem_gather_{dt}_load", res.numel())
        return MEMORY
    if op in _MEM_SCATTER:
        upd = args[-1] if isinstance(args[-1], torch.Tensor) else res
        counts.add(f"f_mem_scatter_{dtype_name(upd.dtype)}_store",
                   upd.numel())
        return MEMORY
    if op in _MEM_STRIDED:
        counts.add(f"f_mem_strided_{dt}_load", res.numel())
        counts.add(f"f_mem_strided_{dt}_store", res.numel())
        return MEMORY
    if op in _MEM_CONCAT:
        counts.add(f"f_mem_concat_{dt}_store", res.numel())
        return MEMORY
    if op in _MEM_CONTIG:
        counts.add(f"f_mem_contig_{dt}_store", res.numel())
        return MEMORY
    # anything else: ignored, as the reference ignores unlisted primitives
    return UNPRICED


class _CountingMode(TorchDispatchMode):
    def __init__(self, counts: FeatureCounts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        _count_op(func, args, kwargs, out, self.counts)
        return out


#: the FeatureCounts of the count_fn call in progress, if any
_ACTIVE: contextvars.ContextVar[Optional[FeatureCounts]] = \
    contextvars.ContextVar("repro_torch_active_counts", default=None)


def counted_range(n: int) -> Iterator[int]:
    """``range(n)`` for a kernel's loop: while :func:`count_fn` runs it,
    every step adds one ``f_sync_loop_steps`` (the reference's ``scan``
    and ``fori_loop`` trip count); otherwise it is a plain range."""
    counts = _ACTIVE.get()
    for i in range(n):
        if counts is not None:
            counts.add("f_sync_loop_steps", 1.0)
        yield i


def _check_carry(before: Any, after: Any) -> Any:
    """``after`` if it has ``before``'s structure, shapes and dtypes."""
    if tree_structure(before) != tree_structure(after):
        raise ValueError(f"loop body changed the carry's structure: "
                         f"{tree_structure(before)} -> "
                         f"{tree_structure(after)}")
    for a, b in zip(tree_flatten(before)[0], tree_flatten(after)[0]):
        if isinstance(a, torch.Tensor) and (
                not isinstance(b, torch.Tensor) or a.shape != b.shape
                or a.dtype != b.dtype):
            got = (tuple(b.shape), b.dtype) \
                if isinstance(b, torch.Tensor) else type(b)
            raise ValueError(f"loop body changed a carry tensor from "
                             f"{(tuple(a.shape), a.dtype)} to {got}")
    return after


def counted_loop(n: int, body: Callable[[int, Any], Any], carry: Any) -> Any:
    """``for i in range(n): carry = body(i, carry)`` — the reference's
    ``fori_loop``, and ``scan`` with a carry.  On real tensors the body
    runs ``n`` times, eagerly.  While :func:`count_fn` runs it, the body
    runs once on the fake carry, the counts that step added are scaled
    by ``n`` and ``n`` ``f_sync_loop_steps`` are added — the reference
    counts a loop body times its trip count — so counting costs one
    step whatever ``n``.  The body must keep the carry's structure,
    shapes and dtypes (checked on the first step; the later steps see
    the same shapes), and its counts must not depend on ``i``."""
    counts = _ACTIVE.get()
    if counts is None:
        for i in range(n):
            out = body(i, carry)
            carry = _check_carry(carry, out) if i == 0 else out
        return carry
    if n > 0:
        before = dict(counts)
        carry = _check_carry(carry, body(0, carry))
        for key, value in list(counts.items()):
            prev = before.get(key, 0.0)
            counts[key] = prev + (value - prev) * n
    counts.add("f_sync_loop_steps", float(n))
    return carry


def count_fn(fn: Callable, *example_args: Any,
             **example_kwargs: Any) -> FeatureCounts:
    """Count features of ``fn`` at the example inputs' shapes and dtypes
    (Algorithm 1).  Tensors may live on any device, ``meta`` included;
    they are replaced by fake tensors, so nothing executes and no kernel
    launches."""
    counts = FeatureCounts()
    run_fake(fn, example_args, example_kwargs, _CountingMode(counts), counts)
    counts.add("f_sync_launch_kernel", 1.0)
    return counts


def run_fake(fn: Callable, args: tuple, kwargs: Mapping[str, Any],
             mode: TorchDispatchMode, counts: FeatureCounts) -> Any:
    """Run ``fn`` once on fake copies of its tensor arguments under
    ``mode``, with ``counts`` as the active counts of
    :func:`counted_range`/:func:`counted_loop` (a loop runs one step).
    The one trace behind :func:`count_fn` and the scope auditor."""
    fake = FakeTensorMode()

    def to_fake(x):
        return fake.from_tensor(x) if isinstance(x, torch.Tensor) else x

    args = tree_map(to_fake, tuple(args))
    kwargs = tree_map(to_fake, dict(kwargs))
    token = _ACTIVE.set(counts)
    try:
        with fake, mode:
            return fn(*args, **kwargs)
    finally:
        _ACTIVE.reset(token)


# ---------------------------------------------------------------------------
# Parametric (symbolic) counts — cached polynomial reconstruction
# ---------------------------------------------------------------------------


@dataclass
class SymbolicCounts:
    """Feature-id → ParametricCount, reconstructed once, evaluated cheaply."""

    counts: Dict[str, ParametricCount]
    assumptions: Tuple[str, ...]

    def at(self, **sizes) -> FeatureCounts:
        out = FeatureCounts()
        for k, pc in self.counts.items():
            out[k] = pc(**sizes)
        return out

    def at_batch(self, **sizes) -> Dict[str, np.ndarray]:
        """Vectorized evaluation over arrays of size values: one float64
        array per feature (constant features broadcast to the sweep
        shape) — a whole battery's count matrix from flat numpy."""
        shape = np.broadcast_shapes(
            *(np.asarray(v).shape for v in sizes.values())) \
            if sizes else ()
        return {k: np.broadcast_to(pc.eval_batch(**sizes), shape)
                for k, pc in self.counts.items()}


def parametric_counts_from(
    probe: Callable[..., FeatureCounts],
    var_degrees: Mapping[str, int],
    *,
    base: int = 16,
    scale: int = 16,
) -> SymbolicCounts:
    """Reconstruct symbolic counts from a per-size prober.

    ``probe(**sizes) -> FeatureCounts`` counts one concrete instantiation
    (it may build a different callable per size) and is invoked exactly
    once per point of the grid of ``degree+1`` probe values per variable
    (``base + scale·i``); exact Lagrange interpolation over that grid
    recovers each feature's polynomial.  The whole grid is probed before
    the feature set is frozen: a feature absent at the base size may
    appear at a larger probe.
    """
    feature_ids = set()
    cache: Dict[Tuple, FeatureCounts] = {}

    def cached_probe(**sizes) -> FeatureCounts:
        key = tuple(sorted(sizes.items()))
        if key not in cache:
            cache[key] = probe(**sizes)
            feature_ids.update(cache[key].keys())
        return cache[key]

    names = sorted(var_degrees)
    grids = [[base + scale * i for i in range(var_degrees[v] + 1)]
             for v in names]
    for combo in itertools.product(*grids):
        cached_probe(**dict(zip(names, combo)))
    polys: Dict[str, ParametricCount] = {}
    assumptions = tuple(f"{v} % {scale} == 0" for v in var_degrees)
    for fid in sorted(feature_ids):
        p = interpolate_polynomial(
            lambda **sizes: cached_probe(**sizes)[fid], var_degrees,
            base=base, scale=scale)
        polys[fid] = ParametricCount(p, assumptions)
    return SymbolicCounts(polys, assumptions)


def parametric_counts(
    make_args: Callable[..., tuple],
    fn: Callable,
    var_degrees: Mapping[str, int],
    *,
    base: int = 16,
    scale: int = 16,
) -> SymbolicCounts:
    """Symbolic counts of ``fn`` parametric in named size variables:
    ``make_args(**sizes)`` builds example arguments (``meta`` tensors
    will do) at given sizes; counts are probed on a small grid and
    interpolated exactly, then re-evaluate in microseconds for any size
    — the paper's amortization property."""
    return parametric_counts_from(
        lambda **sizes: count_fn(fn, *make_args(**sizes)),
        var_degrees, base=base, scale=scale)
