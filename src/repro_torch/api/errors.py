"""Typed errors of the prediction facade — copied from
``repro.api.errors`` so both packages fail alike.

The facade's contract is that every failure names what went wrong AND what
to do about it: a model missing from a profile lists the fits the profile
does carry; an out-of-scope kernel names the unmodeled feature and the
UIPiCK filter tags whose measurement kernels would calibrate a term for
it.  ``KeyError`` leaking out of a prediction is a bug.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence


class PredictionError(RuntimeError):
    """A prediction request that cannot be satisfied: unknown model name,
    incomplete fitted parameters, or (in strict-scope mode) a kernel whose
    counted work falls outside the model's scope.

    Strict-scope errors carry ``violations``: one dict per offending
    batch item (``index``, ``kernel``, ``features``, ``tags``) — EVERY
    violating kernel of a batch, not just the first, so a serving daemon's
    reply can name each bad request in one round trip.  Other failure
    modes leave ``violations`` empty.
    """

    def __init__(self, message: str, *,
                 violations: Optional[Sequence[Dict[str, Any]]] = None):
        super().__init__(message)
        self.violations: List[Dict[str, Any]] = list(violations or [])


def scope_violation(index: int, kernel: str,
                    features: Sequence[str]) -> Dict[str, Any]:
    """One strict-scope violation record for :class:`PredictionError`."""
    feats = sorted(features)
    tags = sorted({t for f in feats for t in suggest_calibration_tags(f)})
    return {"index": index, "kernel": kernel, "features": feats,
            "tags": tags}


def scope_violation_error(fit_name: str,
                          violations: Sequence[Dict[str, Any]]
                          ) -> PredictionError:
    """The aggregated strict-scope error: names every violating kernel,
    its unmodeled features, and the UIPiCK tags that would calibrate
    them."""
    lines = []
    for v in violations:
        hint = (f"calibrate with UIPiCK tags {v['tags']}" if v["tags"]
                else "no built-in generator covers this class")
        lines.append(f"kernel {v['kernel']!r} (item {v['index']}): "
                     f"unmodeled feature(s) {v['features']} — {hint}")
    plural = "s" if len(violations) != 1 else ""
    return PredictionError(
        f"{len(violations)} kernel{plural} perform{'' if plural else 's'} "
        f"work outside the scope of model {fit_name!r}: "
        + "; ".join(lines)
        + ". Widen the model, or predict with strict=False to carry "
          "unmodeled features as diagnostics",
        violations=violations)


# feature-id prefix → the UIPiCK filter tags whose generated measurement
# kernels expose that feature class (so the error message for an
# out-of-scope feature can say how to calibrate it).  Ordered: first match
# wins, most-specific first.
_FEATURE_CLASS_TAGS = [
    ("f_op_", "_madd", ["matmul_sq", "flops_dot_pattern"]),
    ("f_op_", "_transc", ["onchip_pattern"]),
    ("f_op_", "", ["flops_madd_pattern", "mem_stream"]),
    ("f_mem_contig", "", ["mem_stream", "pattern:contig"]),
    ("f_mem_strided", "", ["mem_stream", "pattern:strided"]),
    ("f_mem_gather", "", ["mem_stream", "pattern:gather"]),
    ("f_mem_concat", "", ["mem_stream", "pattern:shift"]),
    ("f_mem_scatter", "", ["mem_stream"]),
    ("f_sync_launch", "", ["empty_kernel"]),
    ("f_sync_loop", "", ["sync_loop_pattern"]),
]


def suggest_calibration_tags(feature_id: str) -> List[str]:
    """UIPiCK filter tags whose measurement kernels would exercise (and so
    calibrate a cost for) ``feature_id``; empty when no built-in generator
    covers the class (e.g. collectives)."""
    for prefix, suffix, tags in _FEATURE_CLASS_TAGS:
        if feature_id.startswith(prefix) and feature_id.endswith(suffix):
            return list(tags)
    return []
