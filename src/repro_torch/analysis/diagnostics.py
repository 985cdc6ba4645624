"""Typed, severity-ranked diagnostics — the part of
``repro.analysis.diagnostics`` the study's identifiability guard needs.

A :class:`Diagnostic` names one finding; :func:`sort_key` is the
canonical ordering ``(severity, location, code, message)``, so two runs
over the same inputs render identically.  Reports, suppression and
baselines (the reference's lint workflow) are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

#: severity levels, most severe first — the sort leads with this rank
SEVERITIES = ("error", "warning", "info")
_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclass(frozen=True)
class Diagnostic:
    """One finding: ``severity`` ∈ :data:`SEVERITIES`, ``code`` a stable
    kebab-case class, ``location`` the audited thing (``model:...``),
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
        """Stable identity ``code@location``."""
        return f"{self.code}@{self.location}"

    def render(self) -> str:
        return f"{self.severity}: {self.location}: [{self.code}] " \
               f"{self.message}"


def sort_key(d: Diagnostic):
    return (_RANK[d.severity], d.location, d.code, d.message)
