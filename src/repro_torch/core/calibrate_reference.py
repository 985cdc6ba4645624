"""The row-by-row calibration engine, kept as a differential-testing
oracle — the counterpart of ``repro.core.calibrate_reference``.

The residual evaluates the model expression once per measurement row
through a dict environment (:meth:`Model._eval`), the Jacobian is
``torch.autograd.functional.jacobian`` of that loop at every iteration,
and every damping step reads the cost back as a Python float.  It is
deliberately NOT fast — :func:`repro_torch.core.calibrate.fit_model` is
the production engine — but it is simple enough to be obviously
correct, so tests and :mod:`repro_torch.studies.calibration_bench` use it
to check that the batched engine returns the same parameters.

It runs in float64 and starts from the restarts the batched engine draws
(``core/threefry.py``: ``jax.random``'s bits), in raw parameter units,
as the reference under ``jax_enable_x64``.  Nothing on the main path
calls it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.calibrate import _multi_starts
from repro_torch.core.model import DTYPE, Model


def reference_residual_fn(model: Model,
                          feature_table: Sequence[Mapping[str, float]],
                          *, scale_by_output: bool = True):
    """The row-wise residual: ``(resid(p_vec), p0, param_names)``."""
    rows: List[Tuple[Dict[str, float], float]] = []
    for i, row in enumerate(feature_table):
        t = float(row[model.output_feature])
        feats = {n: float(row.get(n, 0.0)) for n in model.feature_names}
        if scale_by_output:
            if not t > 0:
                raise ValueError(
                    f"output feature {model.output_feature!r} must be "
                    f"positive to scale; row {i} has value {t!r}")
            feats = {k: v / t for k, v in feats.items()}
            rows.append((feats, 1.0))
        else:
            rows.append((feats, t))

    pn = model.param_names

    def resid(p_vec: torch.Tensor) -> torch.Tensor:
        outs = []
        for feats, t in rows:
            env = {n: p_vec[i] for i, n in enumerate(pn)}
            env.update({k: torch.as_tensor(v, dtype=DTYPE)
                        for k, v in feats.items()})
            outs.append(t - torch.as_tensor(model._eval(env), dtype=DTYPE))
        return torch.stack(outs)

    p0 = torch.full((len(pn),), 1e-9, dtype=DTYPE)
    return resid, p0, pn


def reference_levenberg_marquardt(
    resid_fn: Callable[[torch.Tensor], torch.Tensor],
    p0: torch.Tensor,
    *,
    max_iters: int = 200,
    lam0: float = 1e-3,
    lam_up: float = 10.0,
    lam_down: float = 0.3,
    tol: float = 1e-12,
    nonneg: bool = False,
) -> Tuple[torch.Tensor, float, int, bool]:
    """Python-loop LM with a host read of the cost at every damping
    step; returns ``(p, residual_norm, iterations, converged)``."""
    p = torch.as_tensor(p0, dtype=DTYPE).clone()
    lam = lam0
    r = resid_fn(p)
    cost = float(torch.sum(r * r))
    it = 0
    converged = False
    for it in range(1, max_iters + 1):
        J = torch.autograd.functional.jacobian(resid_fn, p)
        JTJ = J.T @ J
        JTr = J.T @ r
        stepped = False
        for _ in range(20):  # inner damping search
            A = JTJ + lam * torch.diag(torch.clamp(torch.diag(JTJ),
                                                   min=1e-20))
            dp, info = torch.linalg.solve_ex(A, -JTr)
            if int(info) != 0 or not bool(torch.isfinite(dp).all()):
                lam *= lam_up       # singular: bump the damping
                continue
            p_new = p + dp
            if nonneg:
                p_new = torch.clamp(p_new, min=0.0)
            r_new = resid_fn(p_new)
            cost_new = float(torch.sum(r_new * r_new))
            if np.isfinite(cost_new) and cost_new < cost:
                rel = (cost - cost_new) / max(cost, 1e-30)
                p, r, cost = p_new, r_new, cost_new
                lam = max(lam * lam_down, 1e-12)
                stepped = True
                if rel < tol:
                    converged = True
                break
            lam *= lam_up
        if not stepped or converged:
            converged = converged or not stepped
            break
    return p, float(np.sqrt(cost)), it, converged


def reference_fit_model(
    model: Model,
    feature_table: Sequence[Mapping[str, float]],
    *,
    scale_by_output: bool = True,
    p0: Optional[Mapping[str, float]] = None,
    nonneg: bool = False,
    seeds: int = 3,
    max_iters: int = 200,
) -> Tuple[Dict[str, float], float]:
    """Sequential multi-start fit; the ``(params, residual_norm)`` of the
    best start."""
    resid, p_init, names = reference_residual_fn(
        model, feature_table, scale_by_output=scale_by_output)
    if p0:
        p_init = torch.as_tensor([p0.get(n, 1e-9) for n in names],
                                 dtype=DTYPE)
    best = None
    for s in _multi_starts(p_init, names, max(seeds, 1)):
        p, rn, _it, _conv = reference_levenberg_marquardt(
            resid, s, nonneg=nonneg, max_iters=max_iters)
        if best is None or rn < best[1]:
            best = (p, rn)
    p, rn = best
    return {n: float(v) for n, v in zip(names, p)}, rn
