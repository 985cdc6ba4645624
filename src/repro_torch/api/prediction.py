"""The :class:`Prediction` result object: seconds + why — copied from
``repro.api.prediction``.

The paper's deliverable is a *cost-explanatory* predictor — not just "this
kernel takes 1.3 ms" but which ``p_* × f_*`` products the time is made of.
A :class:`Prediction` therefore carries the per-term cost breakdown (from
:meth:`repro_torch.core.model.Model.batched_breakdown`, so nonlinear overlap
terms are attributed back to their component costs), the aligned feature
values it was computed from, any counted-but-unmodeled features (scope
diagnostics), and the fit diagnostics it relied on.

Invariant: ``sum(prediction.breakdown.values()) == prediction.seconds``
up to float64 summation order — ``seconds`` IS the sum of the parts, both
derived from the one batched model evaluation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping

import numpy as np


@dataclass(frozen=True)
class Prediction:
    """One kernel's predicted cost on one machine, explained."""

    kernel: str                       # kernel / row name
    model: str                        # fit name inside the profile
    seconds: float                    # predicted wall time
    # term label → seconds contribution; sums to ``seconds``
    breakdown: Dict[str, float] = field(default_factory=dict)
    # model feature id → aligned count the prediction consumed
    features: Dict[str, float] = field(default_factory=dict)
    # counted features the model has no term for (out-of-scope work)
    unmodeled: Dict[str, float] = field(default_factory=dict)
    # fitted parameter values used
    params: Dict[str, float] = field(default_factory=dict)
    # fit provenance: residual, convergence, held-out accuracy, machine
    diagnostics: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kernel": self.kernel,
            "model": self.model,
            "seconds": self.seconds,
            "breakdown": dict(self.breakdown),
            "features": dict(self.features),
            "unmodeled": dict(self.unmodeled),
            "params": dict(self.params),
            "diagnostics": dict(self.diagnostics),
        }

    def explain(self, *, top: int = 0) -> str:
        """Human-readable cost attribution (largest contributions first);
        ``top`` truncates to the N largest terms (0 = all)."""
        items = sorted(self.breakdown.items(),
                       key=lambda kv: -abs(kv[1]))
        if top:
            items = items[:top]
        total = self.seconds if self.seconds else float("nan")
        lines = [f"{self.kernel}: {self.seconds:.4g} s "
                 f"({self.model})"]
        for label, v in items:
            lines.append(f"  {v / total * 100:6.2f}%  {v:.4g} s  {label}")
        if self.unmodeled:
            lines.append(f"  out of scope (uncosted): "
                         f"{', '.join(sorted(self.unmodeled))}")
        return "\n".join(lines)


def assemble_predictions(
    *,
    kernel_names: List[str],
    fit_name: str,
    labels: List[str],
    parts: np.ndarray,                 # [n_rows, n_parts] float-like
    feature_names: List[str],
    aligned: np.ndarray,               # [n_rows, n_features] float64
    unmodeled: List[Mapping[str, float]],
    params: Mapping[str, float],
    diagnostics: Mapping[str, Any],
) -> List[Prediction]:
    """Build one :class:`Prediction` per row from the batched evaluation.

    ``seconds`` is computed as the float64 sum of that row's parts, which
    is exactly what the breakdown dict sums back to — the invariant the
    acceptance tests pin.
    """
    parts64 = np.asarray(parts, np.float64)
    out: List[Prediction] = []
    for i, name in enumerate(kernel_names):
        breakdown: Dict[str, float] = {}
        for j, label in enumerate(labels):
            # duplicate labels (repeated identical terms) merge additively
            breakdown[label] = breakdown.get(label, 0.0) \
                + float(parts64[i, j])
        out.append(Prediction(
            kernel=name,
            model=fit_name,
            seconds=float(parts64[i, :].sum()),
            breakdown=breakdown,
            features={f: float(aligned[i, j])
                      for j, f in enumerate(feature_names)},
            unmodeled=dict(unmodeled[i]),
            params=dict(params),
            diagnostics=dict(diagnostics),
        ))
    return out
