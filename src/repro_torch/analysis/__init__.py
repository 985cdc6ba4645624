"""Static modelability analysis: lint kernels, count families and model
zoos before any timing runs — the counterpart of ``repro.analysis``.

Everything here runs on fake tensors (``FakeTensorMode``, as the counter
does) or pure reflection: auditing never executes a kernel, never
allocates device memory, never times anything.  The CLI entry point is
``python -m repro_torch.lint``; the programmatic one is
:meth:`repro_torch.api.PerfSession.audit`.

Submodules:

* :mod:`~repro_torch.analysis.diagnostics` — typed severity-ranked
  findings, deterministic reports, suppression, baselines;
* :mod:`~repro_torch.analysis.scope` — aten-level scope auditor (the
  counter's own classification of each op: unmodeled, opaque, hand
  kernels without a cost rule, data-dependent control, mixed precision);
* :mod:`~repro_torch.analysis.kernelcost` — the hand kernels' cost
  rules (the counterpart of ``repro.analysis.pallascost``);
* :mod:`~repro_torch.analysis.families` — ``FamilySpec`` degree
  validation by exact finite differencing over the probe lattice;
* :mod:`~repro_torch.analysis.identifiability` — design-matrix rank and
  conditioning of zoo rungs against a battery;
* :mod:`~repro_torch.analysis.sighazards` — cache-signature hazards that
  defeat the count engine's dedup;
* :mod:`~repro_torch.analysis.targets` — the hand-kernel lint and
  prediction targets;
* :mod:`~repro_torch.analysis.cli` — the ``repro_torch.lint`` command
  line.
"""
from repro_torch.analysis.diagnostics import (
    SEVERITIES,
    AnalysisError,
    Diagnostic,
    DiagnosticReport,
    load_baseline,
    save_baseline,
)
from repro_torch.analysis.families import check_lattice, validate_family
from repro_torch.analysis.identifiability import analyze_model, audit_battery
from repro_torch.analysis.scope import (
    abstract_args,
    abstract_like,
    audit_callable,
    audit_graph,
)
from repro_torch.analysis.sighazards import audit_signature

__all__ = [
    "SEVERITIES",
    "AnalysisError",
    "Diagnostic",
    "DiagnosticReport",
    "abstract_args",
    "abstract_like",
    "analyze_model",
    "audit_battery",
    "audit_callable",
    "audit_graph",
    "audit_signature",
    "check_lattice",
    "load_baseline",
    "save_baseline",
    "validate_family",
]
