"""Aten-level scope auditor: classify every op a kernel dispatches with
the counter's own classification — statically.  The counterpart of
``repro.analysis.scope``.

The counter (:mod:`repro_torch.core.counting`) prices the aten ops it
has a rule for and skips the rest without a trace; at predict time that
surfaces (at best) as an unmodeled-feature diagnostic on features the
kernel DOES produce, while work from skipped ops vanishes from the cost
model.  This auditor runs the kernel once under the counter's own
classification (``counting._count_op``'s verdict on each op, so there
is one set of op lists) and makes the gap visible up front:

* ``unmodeled-op`` (error) — an aten op that produces a tensor, is not a
  view, alias or allocation, and earns no feature: an op no rule names,
  and ``aten.roll``, which the counter prices at zero only for parity
  with the reference (ROADMAP queue C);
* ``opaque-op`` (error) — an op from a namespace the counter does not
  read (another library's ``torch.library`` op, a higher-order op): its
  whole cost is invisible to the model;
* ``kernel-unanalyzable`` (error) — a ``repro_torch::*`` hand-kernel op
  with no cost rule, or whose rule raises for these arguments, with the
  precise reason;
* ``data-dependent-control`` (warning) — a host read of tensor data
  (``.item()``, ``aten._local_scalar_dense``) or an op whose output shape
  depends on the data (``nonzero``, ``masked_select``): the counter has
  no data, so :func:`~repro_torch.core.counting.count_fn` cannot count
  past it.  The audit goes on past a host read with the value 1 (one
  path, as the reference charges a ``while`` body once) and stops at a
  data-sized output;
* ``mixed-precision`` (warning) — arithmetic in ≥ 2 float dtypes in one
  kernel: per-dtype features keep them apart, but a model fitted on a
  single-dtype battery has no rate for the others;
* ``data-dependent-access`` (info) — gather and scatter ops: element
  traffic is counted, but access locality is invisible to shape-only
  analysis;
* ``untraceable-kernel`` (error) — the kernel does not run on fake
  tensors at all; reported, never raised.

The reference's ``pallas-averaged-branch`` has no counterpart: the
port's cost rules are closed forms with no branches to average.

Everything runs under ``FakeTensorMode``, as ``count_fn`` does, so
auditing executes nothing, allocates nothing and times nothing; a hand
kernel's wrapper meets its custom op (``kernels/ops.py``) and launches
nothing.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core import counting
from repro_torch.core.counting import (
    DATA_DEPENDENT_OPS,
    FeatureCounts,
    MissingCostRule,
)

_DATA_ACCESS = counting._MEM_GATHER | counting._MEM_SCATTER


def _op_name(func) -> str:
    packet = getattr(func, "overloadpacket", None)
    name = packet.__name__ if packet is not None \
        else getattr(func, "_name", str(func))
    namespace = getattr(func, "namespace", "?")
    if namespace == "aten":
        name = name.rstrip("_")        # in-place == out-of-place
    return f"{namespace}.{name}"


def _host_value(t: torch.Tensor):
    """The stand-in for a host read of ``t``: 1 of its Python type."""
    if t.dtype == torch.bool:
        return True
    return 1.0 if t.is_floating_point() else 1


class _ScopeMode(TorchDispatchMode):
    """One kernel's classification pass: tallies per-op evidence while
    the counter classifies each op into scratch counts."""

    def __init__(self):
        super().__init__()
        self.scratch = FeatureCounts()
        self.unmodeled: Counter = Counter()
        self.opaque: Counter = Counter()
        # (op, reason, message) → occurrences
        self.unanalyzable: Counter = Counter()
        self.data_control: Counter = Counter()
        self.data_access: Counter = Counter()
        self.arith_dtypes: Set[str] = set()
        self.stopped_at: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _op_name(func)
        if getattr(func, "namespace", None) == "aten" \
                and name[len("aten."):] in DATA_DEPENDENT_OPS:
            self.data_control[name] += 1
            if name == "aten._local_scalar_dense":
                return _host_value(args[0])
            self.stopped_at = name      # fake tensors cannot size it
        out = func(*args, **kwargs)
        if getattr(func, "namespace", None) == "repro_torch":
            try:
                cls = counting._count_op(func, args, kwargs, out,
                                         self.scratch)
            except MissingCostRule as why:
                self.unanalyzable[(name, "no-cost-rule", str(why))] += 1
                return out
            except Exception as why:    # noqa: BLE001 — the rule's fault
                self.unanalyzable[(name, "cost-rule-raised",
                                   f"{type(why).__name__}: {why}")] += 1
                return out
        else:
            cls = counting._count_op(func, args, kwargs, out, self.scratch)
        if cls == counting.UNPRICED:
            self.unmodeled[name] += 1
        elif cls == counting.OPAQUE:
            self.opaque[name] += 1
        elif cls == counting.ARITH:
            res = counting._first_tensor(out)
            if res is not None and res.is_floating_point():
                self.arith_dtypes.add(counting.dtype_name(res.dtype))
        elif cls == counting.MEMORY and name[len("aten."):] in _DATA_ACCESS:
            self.data_access[name] += 1
        return out


def _diagnostics(w: _ScopeMode, location: str) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for op in sorted(w.unmodeled):
        why = ("the counter prices it at zero only for parity with the "
               "reference's jnp.roll (ROADMAP queue C), though it moves "
               "data" if op == "aten.roll"
               else "the counter has no rule for it")
        out.append(Diagnostic(
            "error", "unmodeled-op", location,
            f"op {op!r} ({w.unmodeled[op]}×) produces a tensor but earns "
            f"no feature: {why} — its cost silently vanishes from every "
            f"model fitted on these counts",
            details={"op": op, "occurrences": w.unmodeled[op]}))
    for op in sorted(w.opaque):
        out.append(Diagnostic(
            "error", "opaque-op", location,
            f"op {op!r} ({w.opaque[op]}×) is outside the namespaces the "
            f"counter reads — its entire cost is invisible to the model",
            details={"op": op, "occurrences": w.opaque[op]}))
    for (op, reason, message) in sorted(w.unanalyzable):
        n = w.unanalyzable[(op, reason, message)]
        out.append(Diagnostic(
            "error", "kernel-unanalyzable", location,
            f"hand kernel {op!r} ({n}×) cannot be priced [{reason}]: "
            f"{message} — its work is invisible to every model fitted on "
            f"these counts",
            details={"op": op, "reason": reason, "occurrences": n}))
    if w.data_control:
        ops = sorted(w.data_control)
        stop = (f"; the audit stopped at {w.stopped_at!r}, whose output "
                f"size is data" if w.stopped_at else
                "; the audit followed one path, with every host read "
                "taken as 1")
        out.append(Diagnostic(
            "warning", "data-dependent-control", location,
            f"{sum(w.data_control.values())} data-dependent op(s) "
            f"({', '.join(ops)}): the fake-tensor counter has no data, so "
            f"count_fn cannot count this kernel past them{stop}",
            details={"ops": ops,
                     "occurrences": sum(w.data_control.values())}))
    if len(w.arith_dtypes) >= 2:
        dts = sorted(w.arith_dtypes)
        out.append(Diagnostic(
            "warning", "mixed-precision", location,
            f"arithmetic in {len(dts)} float dtypes ({', '.join(dts)}): "
            f"per-dtype features separate the counts, but a model "
            f"calibrated on a single-dtype battery has no rate for the "
            f"others", details={"dtypes": dts}))
    for op in sorted(w.data_access):
        out.append(Diagnostic(
            "info", "data-dependent-access", location,
            f"op {op!r} ({w.data_access[op]}×) indexes with runtime "
            f"values: element traffic is counted, but access locality — "
            f"the actual cost driver — is invisible to shape-only "
            f"analysis",
            details={"op": op, "occurrences": w.data_access[op]}))
    return out


def abstract_args(make_args: Callable[..., Any], *,
                  device: Any = "meta") -> Tuple[Any, ...]:
    """Example arguments from a kernel's ``make_args(device)`` builder
    without materializing them: built on ``device`` (``meta`` by default)
    under ``FakeTensorMode``, so even a builder that ignores its device
    allocates nothing."""
    with FakeTensorMode():
        out = make_args(device)
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def abstract_like(args: Sequence[Any], device: Any) -> Tuple[Any, ...]:
    """Fake tensors on ``device`` with the shapes, strides and dtypes of
    the tensors in ``args`` (other leaves kept): the abstract arguments
    of an audit on the card, where no data exists."""
    fake = FakeTensorMode()

    def move(x):
        if not isinstance(x, torch.Tensor):
            return x
        with fake:
            return torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                       dtype=x.dtype, device=device)

    return tuple(tree_map(move, tuple(args)))


def audit_graph(fn: Callable, args: Sequence[Any], location: str
                ) -> List[Diagnostic]:
    """Scope-audit one callable at ``args`` (any device, ``meta`` and
    fake tensors included): one fake-tensor run under the counter's
    classification.  Raises what the callable raises."""
    w = _ScopeMode()
    try:
        counting.run_fake(fn, tuple(args), {}, w, w.scratch)
    except Exception:
        if w.stopped_at is None:
            raise
    return _diagnostics(w, location)


def audit_callable(fn: Callable, args: Sequence[Any], location: str,
                   *, stats: Optional[Dict[str, int]] = None
                   ) -> List[Diagnostic]:
    """Scope-audit ``fn`` at ``args``; a callable that does not run on
    fake tensors is reported as ``untraceable-kernel``, not raised.
    ``stats`` (when given) has its ``"traces"`` entry incremented — the
    report's evidence that analysis cost N fake-tensor runs and zero
    executions."""
    try:
        return audit_graph(fn, args, location)
    except Exception as e:          # noqa: BLE001 — any trace failure
        return [Diagnostic(
            "error", "untraceable-kernel", location,
            f"the kernel does not run on fake tensors: "
            f"{type(e).__name__}: {e}",
            details={"exception": type(e).__name__})]
    finally:
        if stats is not None:
            stats["traces"] = stats.get("traces", 0) + 1
