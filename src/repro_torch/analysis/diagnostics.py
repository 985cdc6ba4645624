"""Typed, severity-ranked diagnostics — the currency of
:mod:`repro_torch.analysis`, the counterpart of
``repro.analysis.diagnostics``.

Every auditor in the package (scope, families, identifiability, signature
hazards) emits :class:`Diagnostic` values into a :class:`DiagnosticReport`;
the report owns the canonical ordering — ``(severity, location, code,
message)`` — so two runs over the same inputs render byte-identically
(the golden-file guarantee of ``repro_torch.lint --json``), plus
suppression and the checked-in baseline.

A diagnostic's stable identity is ``code@location``.  Baselines store the
identities of known *error*-severity diagnostics; a lint run fails only on
errors whose identity is NOT in the baseline, so adopting the linter on a
codebase with pre-existing findings is one ``--write-baseline`` away and
new regressions still fail.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Sequence

#: severity levels, most severe first — the sort leads with this rank
SEVERITIES = ("error", "warning", "info")
_RANK = {s: i for i, s in enumerate(SEVERITIES)}

BASELINE_VERSION = 1


class AnalysisError(RuntimeError):
    """A lint invocation that cannot run (unknown target module, malformed
    baseline file, unloadable LINT_TARGETS) — distinct from diagnostics,
    which describe the *audited* code, not the audit."""


@dataclass(frozen=True)
class Diagnostic:
    """One finding: ``severity`` ∈ :data:`SEVERITIES`, ``code`` a stable
    kebab-case class (e.g. ``unmodeled-op``), ``location`` the
    audited thing (``kernel:...``, ``generator:...``, ``model:...``),
    ``message`` the human sentence, ``details`` machine-readable extras."""

    severity: str
    code: str
    location: str
    message: str
    details: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.severity not in _RANK:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    @property
    def key(self) -> str:
        """Stable identity for baselines and suppression."""
        return f"{self.code}@{self.location}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "severity": self.severity,
            "code": self.code,
            "location": self.location,
            "message": self.message,
            "details": _jsonable(self.details),
        }

    def render(self) -> str:
        return f"{self.severity}: {self.location}: [{self.code}] " \
               f"{self.message}"


def _jsonable(value: Any) -> Any:
    """Deterministic JSON-safe copy of diagnostic details (sorted dicts,
    lists for tuples/sets, str fallback for exotic values)."""
    if isinstance(value, Mapping):
        return {str(k): _jsonable(value[k])
                for k in sorted(value, key=str)}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, (set, frozenset)):
        return sorted(_jsonable(v) for v in value)
    if isinstance(value, (str, int, bool, type(None))):
        return value
    if isinstance(value, float):
        return float(value)
    return str(value)


def sort_key(d: Diagnostic):
    return (_RANK[d.severity], d.location, d.code, d.message)


def _matches(diag: Diagnostic, pattern: str) -> bool:
    """Suppression pattern: a bare ``code`` hits every location, a full
    ``code@location`` hits exactly one."""
    if "@" in pattern:
        return diag.key == pattern
    return diag.code == pattern


@dataclass
class DiagnosticReport:
    """An ordered collection of diagnostics plus the run's zero-execution
    evidence (``stats``: traces performed, timings performed — the latter
    must be 0 by construction)."""

    diagnostics: List[Diagnostic] = field(default_factory=list)
    stats: Dict[str, int] = field(default_factory=dict)
    suppressed: List[Diagnostic] = field(default_factory=list)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def sorted(self) -> List[Diagnostic]:
        return sorted(self.diagnostics, key=sort_key)

    def by_severity(self, severity: str) -> List[Diagnostic]:
        return [d for d in self.sorted() if d.severity == severity]

    @property
    def errors(self) -> List[Diagnostic]:
        return self.by_severity("error")

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for d in self.diagnostics:
            out[d.severity] += 1
        return out

    def codes(self) -> List[str]:
        """Distinct diagnostic classes present, sorted."""
        return sorted({d.code for d in self.diagnostics})

    def suppress(self, patterns: Sequence[str]) -> "DiagnosticReport":
        """A new report with diagnostics matching any pattern (``code`` or
        ``code@location``) moved to ``suppressed`` — they stay visible in
        the JSON artifact but no longer count toward the exit code."""
        if not patterns:
            return self
        keep, dropped = [], list(self.suppressed)
        for d in self.diagnostics:
            (dropped if any(_matches(d, p) for p in patterns)
             else keep).append(d)
        return DiagnosticReport(diagnostics=keep, stats=dict(self.stats),
                                suppressed=dropped)

    # -- baseline ------------------------------------------------------------
    def baseline_keys(self) -> List[str]:
        """Identities of current error-severity diagnostics — what
        ``--write-baseline`` persists."""
        return sorted({d.key for d in self.diagnostics
                       if d.severity == "error"})

    def new_errors(self, baseline: Sequence[str]) -> List[Diagnostic]:
        """Error diagnostics whose identity is not in the baseline — the
        set a CI lint step fails on."""
        known = set(baseline)
        return [d for d in self.errors if d.key not in known]

    # -- rendering -----------------------------------------------------------
    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "counts": self.counts(),
            "diagnostics": [d.to_dict() for d in self.sorted()],
            "suppressed": [d.to_dict()
                           for d in sorted(self.suppressed, key=sort_key)],
            "stats": {k: self.stats[k] for k in sorted(self.stats)},
        }

    def render(self) -> str:
        lines = [d.render() for d in self.sorted()]
        c = self.counts()
        lines.append(
            f"{c['error']} error(s), {c['warning']} warning(s), "
            f"{c['info']} info(s)"
            + (f", {len(self.suppressed)} suppressed"
               if self.suppressed else ""))
        if self.stats:
            lines.append(" ".join(f"{k}={self.stats[k]}"
                                  for k in sorted(self.stats)))
        return "\n".join(lines)


def save_baseline(report: DiagnosticReport, path) -> None:
    payload = {"version": BASELINE_VERSION,
               "errors": report.baseline_keys()}
    Path(path).write_text(json.dumps(payload, indent=2, sort_keys=True)
                          + "\n")


def load_baseline(path) -> List[str]:
    p = Path(path)
    try:
        payload = json.loads(p.read_text())
    except OSError as e:
        raise AnalysisError(f"cannot read baseline {p}: {e}") from e
    except ValueError as e:
        raise AnalysisError(f"baseline {p} is not valid JSON ({e})") from e
    if not isinstance(payload, dict) \
            or payload.get("version") != BASELINE_VERSION \
            or not isinstance(payload.get("errors"), list):
        raise AnalysisError(
            f"baseline {p} is not a v{BASELINE_VERSION} lint baseline "
            f"(expected {{'version': {BASELINE_VERSION}, 'errors': "
            f"[...]}}); regenerate with --write-baseline")
    return [str(k) for k in payload["errors"]]
