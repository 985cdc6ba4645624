"""Work-removal code transformation (paper §7.1.1, Algorithm 3) — the
counterpart of ``repro.core.workremoval``.

The paper strips arithmetic and on-chip work from a kernel while keeping
a chosen set of global memory accesses *with their loop environment
intact*, adds the kept loads into ``tgt_read`` and stores it, so the
compiler cannot drop the access.

The reference interprets a jaxpr.  The port's kernels are eager Python
whose loops are :func:`~repro_torch.core.counting.counted_range` and
:func:`~repro_torch.core.counting.counted_loop`, so :func:`remove_work`
re-runs the kernel under a :class:`TorchDispatchMode` that rewrites each
aten op as it dispatches:

  * a **compute op** with a float output (:data:`COMPUTE_OPS`, the aten
    counterparts of the reference's ``COMPUTE_PRIMS``, with their
    in-place and ``out=`` overloads) is replaced by the proxy
    ``Σ sum(kept float operands)`` broadcast to the output's shape (a
    view, or a copy into an in-place or ``out=`` destination), where the
    reference adds it to zeros that XLA fuses away; each kept operand is
    read in full once per execution of the site, the arithmetic is gone,
    and the contribution is added to the accumulator (Algorithm 3's
    ``tgt_read = tgt_read + g_ld``).  Under
    :func:`~repro_torch.core.counting.count_fn` a stripped product keeps
    the contiguous operand loads the counter gives a product, for its
    kept operands only;
  * integer and index arithmetic, views, copies and ``add`` run
    verbatim — they *are* the access patterns of the kept loads;
  * a removed argument becomes a broadcast zero and is marked dead (so
    a kernel that writes live values into it cannot be stripped); an op
    whose tensor inputs are all dead yields dead zeros and contributes
    nothing (a view of them stays a view, and the counter does not see
    it);
  * hand kernels (``repro_torch::*`` custom ops) run verbatim, as the
    reference binds ``pallas_call``;
  * the kernel's own float outputs fold into the accumulator at weight
    1e-30, so every kept chain stays live.

Loops stay loops: on real tensors a ``counted_loop`` body runs ``n``
times, so a kept read inside it repeats ``n`` times and the
access-to-footprint ratio survives; under ``count_fn`` the body is
counted once and scaled, proxies included.  The stripped callable keeps
no state between calls (the dead set and the accumulator are made per
call) and never reads a value back to the host, so it can be captured in
a CUDA graph and timed like any battery kernel.

Two choices the reference did not have to make: ``_softmax`` and
``_log_softmax`` are one aten op each where JAX's softmax is ``exp`` and
``div``, both stripped, so they are stripped too; and the reference also
folds each scan body's outputs at 1e-30 per step, which the port cannot
see inside a Python loop (a pinned count difference,
``tests/test_torch_workremoval.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, FrozenSet, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
)
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.core import counting

#: the reference's ``COMPUTE_PRIMS`` → the aten ops (overload packets,
#: without a trailing ``_``) the port strips in their place
PRIM_TO_ATEN: Dict[str, FrozenSet[str]] = {
    "dot_general": frozenset({"mm", "bmm", "addmm", "baddbmm", "mv", "dot",
                              "addmv"}),
    "conv_general_dilated": frozenset({"convolution", "_convolution"}),
    "exp": frozenset({"exp"}),
    "log": frozenset({"log"}),
    "tanh": frozenset({"tanh"}),
    "logistic": frozenset({"sigmoid"}),
    "pow": frozenset({"pow"}),
    "integer_pow": frozenset({"pow"}),
    "sqrt": frozenset({"sqrt"}),
    "rsqrt": frozenset({"rsqrt"}),
    "erf": frozenset({"erf"}),
    "sin": frozenset({"sin"}),
    "cos": frozenset({"cos"}),
    "mul": frozenset({"mul"}),
    "div": frozenset({"div", "reciprocal"}),
    "rem": frozenset({"remainder", "fmod"}),
    "atan2": frozenset({"atan2"}),
    "expm1": frozenset({"expm1"}),
    "log1p": frozenset({"log1p"}),
    "exp2": frozenset({"exp2"}),
    "cumsum": frozenset({"cumsum"}),
    "cumprod": frozenset({"cumprod"}),
    "cumlogsumexp": frozenset({"logcumsumexp"}),
    "erf_inv": frozenset({"erfinv"}),
    "lgamma": frozenset({"lgamma"}),
    "digamma": frozenset({"digamma"}),
}

#: one aten op where JAX has several stripped primitives (exp and div)
FUSED_COMPUTE_OPS: FrozenSet[str] = frozenset({"_softmax", "_log_softmax"})

#: every aten op whose computation is stripped
COMPUTE_OPS: FrozenSet[str] = frozenset().union(
    *PRIM_TO_ATEN.values(), FUSED_COMPUTE_OPS)

# the products, whose operands the counter prices as contiguous loads
_PRODUCTS = PRIM_TO_ATEN["dot_general"]

#: weight of the kernel's own outputs in the accumulator
OUTPUT_WEIGHT = 1e-30


def _op_name(func) -> str:
    return func.overloadpacket.__name__.rstrip("_")   # in-place == out-of-place


def _out_tensors(func, args: tuple, kwargs: Dict[str, Any]
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The tensors ``func`` writes: (in-place positional arguments,
    ``out=`` arguments)."""
    inplace: List[torch.Tensor] = []
    outs: List[torch.Tensor] = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        value = kwargs.get(a.name) if a.kwarg_only or i >= len(args) \
            else args[i]
        leaves = [x for x in tree_flatten(value)[0]
                  if isinstance(x, torch.Tensor)]
        (outs if a.kwarg_only else inplace).extend(leaves)
    return inplace, outs


def _meta_outputs(func, args: tuple, kwargs: Dict[str, Any]) -> Any:
    """``func``'s outputs on meta copies of its tensors: shapes and
    dtypes, with no mode seeing the call (nothing counted, nothing
    launched)."""
    def to_meta(x):
        if isinstance(x, torch.Tensor):
            return torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                       dtype=x.dtype, device="meta")
        return x

    with _disable_current_modes():
        return func(*tree_map(to_meta, args), **tree_map(to_meta, kwargs))


class _StripMode(TorchDispatchMode):
    """One call's rewriting evaluator: its dead set and its
    accumulator."""

    def __init__(self, acc: torch.Tensor):
        super().__init__()
        self.acc = acc
        # id → tensor: the strong reference keeps the id from being reused
        self.dead: Dict[int, torch.Tensor] = {}

    def is_dead(self, t: torch.Tensor) -> bool:
        return id(t) in self.dead

    def mark_dead(self, tree: Any) -> None:
        for leaf in tree_flatten(tree)[0]:
            if isinstance(leaf, torch.Tensor):
                self.dead[id(leaf)] = leaf

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [x for x in tree_flatten((args, kwargs))[0]
                   if isinstance(x, torch.Tensor)]
        # as the reference, only non-scalar operands decide deadness
        arrays = [x for x in tensors if x.dim() > 0]
        all_dead = bool(arrays) and all(self.is_dead(x) for x in arrays)
        if func.namespace == "aten" and _op_name(func) in COMPUTE_OPS:
            meta = _meta_outputs(func, args, kwargs)
            first = counting._first_tensor(meta)
            if first is not None and first.is_floating_point():
                return self._strip(func, args, kwargs, tensors, meta)
        if all_dead:
            return self._dead(func, args, kwargs, tensors)
        return func(*args, **kwargs)

    def _strip(self, func, args, kwargs, tensors, meta):
        """The additive-read proxy of one compute op."""
        inplace, outs = _out_tensors(func, args, kwargs)
        out_ids = {id(t) for t in outs}
        reads = [x for x in tensors if id(x) not in out_ids]
        dev = tensors[0].device
        contrib = None          # no zero to start from: a graph node less
        counts = counting._ACTIVE.get()
        for x in reads:
            if self.is_dead(x) or not x.is_floating_point():
                continue        # removed lineage and indices read nothing
            s = torch.sum(x, dtype=torch.float32)
            contrib = s if contrib is None else contrib + s
            if counts is not None and _op_name(func) in _PRODUCTS:
                counts.add(f"f_mem_contig_{counting.dtype_name(x.dtype)}"
                           f"_load", x.numel())
        if contrib is None:
            contrib = torch.zeros((), dtype=torch.float32, device=dev)
        else:
            self.acc = self.acc + contrib
        written = inplace + outs
        if written:
            for w in written:
                w.copy_(contrib)
                self.dead.pop(id(w), None)
            return written[0] if len(written) == 1 else tuple(written)

        def proxy(o):
            # a broadcast view of the contribution: it moves no data
            if not isinstance(o, torch.Tensor):
                return o
            v = contrib.to(o.dtype) if o.is_floating_point() else \
                torch.zeros((), dtype=o.dtype, device=dev)
            return v.expand(tuple(o.shape))

        return tree_map(proxy, meta)

    def _dead(self, func, args, kwargs, tensors):
        """An op of a removed argument's access chain: zeros, dead."""
        if func.is_view:
            # a view of zeros is zeros; below every mode, so the counter
            # never sees it (a transpose would count as strided traffic)
            with _disable_current_modes():
                out = func(*args, **kwargs)
            self.mark_dead(out)
            return out
        inplace, outs = _out_tensors(func, args, kwargs)
        if inplace or outs:
            written = inplace + outs    # dead already: left as zeros
            return written[0] if len(written) == 1 else tuple(written)
        dev = tensors[0].device
        out = tree_map(
            lambda o: torch.zeros(tuple(o.shape), dtype=o.dtype, device=dev)
            if isinstance(o, torch.Tensor) else o,
            _meta_outputs(func, args, kwargs))
        self.mark_dead(out)
        return out


def remove_work(fn: Callable, *example_args,
                remove_args: Sequence[int] = ()) -> Callable:
    """Build the stripped kernel for ``fn``.

    ``remove_args``: positional indices of tensor arguments whose
    accesses are removed (the paper's ``remove_vars``).  The returned
    callable has ``fn``'s signature (removed arguments are accepted and
    ignored, so timing harnesses reuse the argument makers) and returns
    the scalar float32 ``tgt_read`` accumulator on the arguments'
    device.  ``example_args`` check the indices; nothing is traced ahead
    of a call."""
    removed = tuple(sorted(set(remove_args)))
    for i in removed:
        if not 0 <= i < len(example_args) or \
                not isinstance(example_args[i], torch.Tensor):
            raise ValueError(f"remove_args index {i} is not a tensor "
                             f"argument of the {len(example_args)} given")

    def stripped(*args):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not tensors:
            raise ValueError("remove_work: the kernel takes no tensor")
        acc = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
        args = list(args)
        dead = []
        for i in removed:
            a = args[i]
            args[i] = torch.zeros((), dtype=a.dtype,
                                  device=a.device).expand(a.shape)
            dead.append(args[i])
        mode = _StripMode(acc)
        mode.mark_dead(dead)
        with mode:
            out = fn(*args)
        acc = mode.acc
        for leaf in tree_flatten(out)[0]:
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                acc = acc + OUTPUT_WEIGHT * torch.sum(leaf,
                                                      dtype=torch.float32)
        return acc

    return stripped
