"""Model identifiability: can a zoo rung's parameters be determined by a
battery before a single timing is spent on it?  The counterpart of
``repro.analysis.identifiability`` (numpy-only there as here).

A fit solves ``min_p Σ (t_i − g(p; F_i))²``; whether the answer is
unique is a property of the parameter Jacobian ``J = ∂g/∂p`` stacked
over the battery's rows, computable exactly from counts alone.  The
analysis evaluates ``J`` at a few deterministic parameter points (a
linear model's Jacobian is constant, a nonlinear one's is not, and a
rank defect at every probe point is structural), column-normalizes it
and reads the SVD:

* ``underdetermined-battery`` (error) — fewer rows than parameters;
* ``unexercised-parameter`` (error) — an all-zero Jacobian column;
* ``collinear-parameters`` (error) — two parallel columns
  (|cos| > 0.9999), named with the features they share;
* ``unidentifiable-parameters`` (error) — a rank defect not explained
  pair by pair;
* ``ill-conditioned-fit`` (warning) — full rank, condition number > 1e6.

Thresholds, probe points and messages are the reference's, so both
packages give the same codes on the same table.
"""
from __future__ import annotations

import itertools
from typing import List, Sequence

import numpy as np

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core.model import Model

#: parameter probe points per analysis
_N_PROBE_POINTS = 3
#: a column whose norm is below this fraction of the largest is unexercised
_ZERO_COL_REL = 1e-12
#: normalized singular values below this fraction of σ_max are null
_RANK_TOL = 1e-8
#: |cosine| between normalized columns above this is "collinear"
_COS_TOL = 0.9999
#: null-vector components above this magnitude implicate their parameter
_IMPLICATE = 0.3
#: condition number above this draws the ill-conditioned warning
_COND_WARN = 1e6


def _probe_points(n_params: int) -> np.ndarray:
    """Point k sets ``p[i] = 1 + 0.25·((i + k) mod 3)``: distinct,
    strictly positive and reproducible."""
    pts = np.empty((_N_PROBE_POINTS, n_params), np.float64)
    for k in range(_N_PROBE_POINTS):
        for i in range(n_params):
            pts[k, i] = 1.0 + 0.25 * ((i + k) % 3)
    return pts


def analyze_model(model: Model, features: np.ndarray, location: str
                  ) -> List[Diagnostic]:
    """Identifiability-audit one model against one battery's aligned
    feature matrix (``[n_rows, n_features]`` in ``model.feature_names``
    column order — the output of :meth:`Model.align`)."""
    params = list(model.param_names)
    if not params:
        return []
    F = np.asarray(features, np.float64)
    n_rows = F.shape[0]
    out: List[Diagnostic] = []
    if n_rows < len(params):
        out.append(Diagnostic(
            "error", "underdetermined-battery", location,
            f"battery has {n_rows} row(s) for {len(params)} parameters "
            f"({', '.join(params)}): the least-squares problem is "
            f"rank-deficient regardless of which kernels those rows are",
            details={"rows": n_rows, "params": params}))
        return out

    J = np.concatenate([model.param_jacobian(p, F)
                        for p in _probe_points(len(params))], axis=0)
    J = np.nan_to_num(J, nan=0.0, posinf=0.0, neginf=0.0)

    norms = np.linalg.norm(J, axis=0)
    col_scale = float(np.max(norms)) if norms.size else 0.0
    dead = norms <= _ZERO_COL_REL * max(col_scale, 1.0)
    fmap = model.param_feature_map()
    for i in np.flatnonzero(dead):
        p = params[int(i)]
        touched = fmap.get(p, [])
        out.append(Diagnostic(
            "error", "unexercised-parameter", location,
            f"parameter {p!r} has an all-zero design-matrix column over "
            f"this battery: no kernel produces "
            f"{'features ' + ', '.join(touched) if touched else 'any feature it touches'}"
            f", so its fitted value is arbitrary",
            details={"param": p, "features": touched}))
    live = [i for i in range(len(params)) if not dead[i]]
    if len(live) < 2:
        return out
    Jn = J[:, live] / norms[live]
    live_names = [params[i] for i in live]

    collinear_pairs = set()
    for a, b in itertools.combinations(range(len(live)), 2):
        cos = float(abs(Jn[:, a] @ Jn[:, b]))
        if cos > _COS_TOL:
            pa, pb = live_names[a], live_names[b]
            collinear_pairs.update((pa, pb))
            shared = sorted(set(fmap.get(pa, [])) & set(fmap.get(pb, [])))
            out.append(Diagnostic(
                "error", "collinear-parameters", location,
                f"parameters {pa!r} and {pb!r} have parallel "
                f"design-matrix columns over this battery "
                f"(|cos| = {cos:.6f}): only their combination is "
                f"determined"
                + (f"; they share term features {', '.join(shared)}"
                   if shared else "")
                + " — add kernels that separate them or merge the terms",
                details={"params": [pa, pb], "cosine": cos,
                         "features": {pa: fmap.get(pa, []),
                                      pb: fmap.get(pb, [])}}))

    _u, sv, vt = np.linalg.svd(Jn, full_matrices=False)
    null = sv <= _RANK_TOL * float(sv[0])
    for k in np.flatnonzero(null):
        v = vt[int(k)]
        implicated = sorted(live_names[i]
                            for i in np.flatnonzero(np.abs(v) > _IMPLICATE))
        if implicated and set(implicated) <= collinear_pairs:
            continue    # already named by a pairwise diagnostic
        out.append(Diagnostic(
            "error", "unidentifiable-parameters", location,
            f"design matrix is rank-deficient over this battery "
            f"(σ_min/σ_max = {float(sv[int(k)] / sv[0]):.2e}); the null "
            f"direction implicates "
            f"{', '.join(implicated) if implicated else 'a spread combination of parameters'}"
            f" — their fitted values trade off freely",
            details={"params": implicated,
                     "rank": int(np.sum(~null)), "n_params": len(params)}))
    if not np.any(null):
        cond = float(sv[0] / sv[-1])
        if cond > _COND_WARN:
            out.append(Diagnostic(
                "warning", "ill-conditioned-fit", location,
                f"design matrix condition number {cond:.1e} over this "
                f"battery: parameters are identifiable in exact "
                f"arithmetic but unstable under timing noise",
                details={"condition_number": cond}))
    return out


def audit_battery(model: Model, counts_rows: Sequence,
                  location: str,
                  *, missing: str = "zero") -> List[Diagnostic]:
    """Convenience wrapper: align count rows (mappings or a FeatureTable)
    against the model, then :func:`analyze_model`."""
    F = model.align(counts_rows, missing=missing)
    return analyze_model(model, F, location)
