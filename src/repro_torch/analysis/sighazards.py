"""Cache-signature hazard detector: which kernels defeat the count
engine's content-addressed dedup — and why.  The counterpart of
``repro.analysis.sighazards``.

:mod:`repro_torch.core.countengine` keys cached counts by a *content signature*
of the kernel callable (source text + digested closure state).  When a
callable cannot be signed — no retrievable source, a closed-over value
with no stable digest, a module-level global smuggled through the code
object — the engine conservatively signs it ``""``: correctness survives
(the conservative key never collides TO a wrong entry... it simply never
matches), but every such kernel re-traces on every run, silently paying
the cost the store exists to avoid.  Worse, *mutable* captured state
(a dict or list the kernel reads at trace time) can change between runs
without changing anything a signature sees — the cached counts go stale
with no invalidation.

Two diagnostics:

* ``unsignable-callable`` (warning) — the engine would sign this kernel
  ``""`` and re-trace it forever; details carry the engine's own
  human-readable reasons (from
  :func:`repro_torch.core.countengine.signature_hazards`);
* ``mutable-captured-state`` (info) — the kernel closes over (or
  defaults to) a mutable container; its signature can go stale without
  changing.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core.countengine import signature_hazards

_MUTABLE = (dict, list, set, bytearray)


def _captured(fn: Callable) -> List[Tuple[str, Any]]:
    """(name, value) pairs for closure cells and argument defaults —
    everything a signature must digest beyond the source text."""
    out: List[Tuple[str, Any]] = []
    code = getattr(fn, "__code__", None)
    closure = getattr(fn, "__closure__", None) or ()
    freevars = getattr(code, "co_freevars", ()) if code else ()
    for name, cell in zip(freevars, closure):
        try:
            out.append((name, cell.cell_contents))
        except ValueError:      # empty cell
            out.append((name, None))
    defaults = getattr(fn, "__defaults__", None) or ()
    if code is not None and defaults:
        argnames = code.co_varnames[:code.co_argcount]
        for name, val in zip(argnames[-len(defaults):], defaults):
            out.append((name, val))
    for name, val in sorted((getattr(fn, "__kwdefaults__", None)
                             or {}).items()):
        out.append((name, val))
    return out


def audit_signature(fn: Callable, location: str) -> List[Diagnostic]:
    """Signature-audit one kernel callable (no tracing, no execution —
    pure reflection over source and closure state)."""
    out: List[Diagnostic] = []
    reasons = signature_hazards(fn)
    if reasons:
        out.append(Diagnostic(
            "warning", "unsignable-callable", location,
            f"the count engine cannot compute a stable content signature "
            f"for this kernel ({reasons[0]}): it falls back to the "
            f"conservative empty signature and re-traces on every run — "
            f"the count store never dedups it",
            details={"reasons": reasons}))
    mutable = sorted(name for name, val in _captured(fn)
                     if isinstance(val, _MUTABLE))
    if mutable:
        out.append(Diagnostic(
            "info", "mutable-captured-state", location,
            f"kernel captures mutable container(s) "
            f"{', '.join(repr(n) for n in mutable)}: mutating them "
            f"changes traced counts without changing the signature, so "
            f"cached counts can go stale with no invalidation",
            details={"names": mutable}))
    return out
