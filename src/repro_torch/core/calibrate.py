"""Black-box model calibration (paper §7.2) in torch — the counterpart of
``repro.core.calibrate``: nonlinear least squares by Levenberg-Marquardt
with Jacobians from ``torch.func.jacfwd``.

Multi-start restarts are one batched solve: every tensor carries a
leading start dimension, the Jacobians of all starts come from one
``vmap(jacfwd(...))`` call, and each start keeps its own damping,
acceptance and convergence flags — the per-lane semantics of the
reference's ``vmap`` of a ``while_loop``.  Parameters are solved in
start-normalized units (each nominal start is 1), which keeps the normal
equations well conditioned when rates near 1e-12 sit beside smoothing
edges near 1e2.  Everything runs in float64, but a step is accepted
only when it lowers the cost at float32 resolution — the reference's
precision (jax's default) — so both solves stop at the same point.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.model import DTYPE, FeatureTableLike, Model, as_feature_table


@dataclass
class FitResult:
    params: Dict[str, float]
    residual_norm: float
    iterations: int
    converged: bool

    def to_dict(self) -> Dict[str, object]:
        return {"params": dict(self.params),
                "residual_norm": self.residual_norm,
                "iterations": self.iterations,
                "converged": self.converged}

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "FitResult":
        return cls(params={str(k): float(v)
                           for k, v in dict(d["params"]).items()},
                   residual_norm=float(d["residual_norm"]),
                   iterations=int(d["iterations"]),
                   converged=bool(d["converged"]))


def levenberg_marquardt_batched(
    resid_fn: Callable[[torch.Tensor], torch.Tensor],
    starts: torch.Tensor,
    *,
    max_iters: int = 200,
    lam0: float = 1e-3,
    lam_up: float = 10.0,
    lam_down: float = 0.3,
    tol: float = 1e-12,
    nonneg: bool = False,
    inner_tries: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Classic LM with multiplicative damping, run for ``[S, P]`` starts
    at once.  ``nonneg`` clamps parameters at 0 after each trial step
    (negative per-operation costs are not costs, paper §4).  A singular
    system (``solve_ex`` info ≠ 0) or a non-finite step is rejected like
    a step that raises the cost.  Returns per-start
    ``(p, cost, iterations, converged)``."""
    resid_b = torch.func.vmap(resid_fn)
    jac_b = torch.func.vmap(torch.func.jacfwd(resid_fn))
    n_starts = starts.shape[0]
    p = starts.clone()
    r = resid_b(p)
    cost = (r * r).sum(-1)
    lam = torch.full((n_starts,), lam0, dtype=p.dtype)
    it = torch.zeros(n_starts, dtype=torch.int64)
    converged = torch.zeros(n_starts, dtype=torch.bool)
    done = torch.zeros(n_starts, dtype=torch.bool)
    for _ in range(max_iters):
        active = ~done
        if not active.any():
            break
        J = jac_b(p)                                   # [S, R, P]
        JTJ = J.mT @ J
        JTr = (J.mT @ r.unsqueeze(-1)).squeeze(-1)
        diag = torch.clamp(torch.diagonal(JTJ, dim1=-2, dim2=-1), min=1e-20)
        accepted = torch.zeros(n_starts, dtype=torch.bool)
        p_c, r_c, cost_c = p.clone(), r.clone(), cost.clone()
        for _ in range(inner_tries):
            trying = active & ~accepted
            if not trying.any():
                break
            A = JTJ + lam[:, None, None] * torch.diag_embed(diag)
            dp, info = torch.linalg.solve_ex(A, -JTr)
            p_new = p + dp
            if nonneg:
                p_new = torch.clamp(p_new, min=0.0)
            r_new = resid_b(p_new)
            cost_new = (r_new * r_new).sum(-1)
            # a decrease counts where the reference's float32 solve
            # resolves it: in float64 a step along a flat valley lowers
            # the cost by ~1e-9 of itself and the solve creeps on for
            # thousands of iterations where the reference stops
            ok = (trying & (info == 0) & torch.isfinite(dp).all(-1)
                  & torch.isfinite(cost_new)
                  & (cost_new.float() < cost.float()))
            lam = torch.where(
                trying,
                torch.where(ok, torch.clamp(lam * lam_down, min=1e-12),
                            lam * lam_up),
                lam)
            p_c = torch.where(ok[:, None], p_new, p_c)
            r_c = torch.where(ok[:, None], r_new, r_c)
            cost_c = torch.where(ok, cost_new, cost_c)
            accepted = accepted | ok
        rel = (cost - cost_c) / torch.clamp(cost, min=1e-30)
        conv_now = accepted & (rel < tol)
        step = active & accepted
        p = torch.where(step[:, None], p_c, p)
        r = torch.where(step[:, None], r_c, r)
        cost = torch.where(step, cost_c, cost)
        it = torch.where(active, it + 1, it)
        # damping exhausted without an acceptable step → local minimum
        finished = conv_now | ~accepted
        converged = torch.where(active, finished, converged)
        done = done | (active & finished)
    return p, cost, it, converged


def _multi_starts(p_init: torch.Tensor, names: Sequence[str],
                  seeds: int) -> torch.Tensor:
    """``[seeds, n_params]`` deterministic restarts: the nominal start
    plus log-uniform perturbations, drawn as the reference draws them
    (``jax.random`` key 0, one ``split`` a start, ``uniform(-2, 2)`` at
    float64, its x64 draws); ``edge`` parameters start at 100."""
    key = threefry.prng_key(0)
    starts = [p_init]
    for _ in range(seeds - 1):
        key, sub = threefry.split(key)
        u = threefry.uniform(sub, tuple(p_init.shape), minval=-2.0,
                             maxval=2.0, dtype=np.float64)
        starts.append(p_init * torch.exp(torch.as_tensor(u, dtype=DTYPE)))
    out = torch.stack(starts)
    edge_idx = [i for i, n in enumerate(names) if "edge" in n]
    if edge_idx:
        out[:, edge_idx] = 100.0
    return out


def fit_model(
    model: Model,
    feature_table: FeatureTableLike,
    *,
    scale_by_output: bool = True,
    p0: Optional[Mapping[str, float]] = None,
    nonneg: bool = False,
    seeds: int = 3,
    max_iters: int = 200,
    lam0: float = 1e-3,
    lam_up: float = 10.0,
    lam_down: float = 0.3,
    tol: float = 1e-12,
) -> FitResult:
    """Calibrate ``model`` against measurement rows; all restarts solve
    in one batched LM and the lowest-residual start wins."""
    table = as_feature_table(feature_table)
    F_np, target_np = model.design_matrix(
        table, scale_by_output=scale_by_output)
    names = model.param_names
    p_init = torch.full((len(names),), 1e-9, dtype=DTYPE)
    if p0:
        p_init = torch.as_tensor([p0.get(n, 1e-9) for n in names],
                                 dtype=DTYPE)
    starts = _multi_starts(p_init, names, max(seeds, 1))
    # solve where the nominal start is O(1) per parameter; zero starts
    # keep raw units
    scale = torch.where(starts[0] > 0, starts[0], torch.ones_like(starts[0]))
    F = torch.as_tensor(F_np, dtype=DTYPE)
    target = torch.as_tensor(target_np, dtype=DTYPE)

    def resid(p_norm: torch.Tensor) -> torch.Tensor:
        return target - model.batched_eval(p_norm * scale, F)

    p, cost, it, conv = levenberg_marquardt_batched(
        resid, starts / scale, max_iters=max_iters, lam0=lam0,
        lam_up=lam_up, lam_down=lam_down, tol=tol, nonneg=nonneg)
    # the first of the starts tied at float32 resolution, as the
    # reference's argmin picks among its float32 costs
    best = int(torch.argmin(cost.float()))
    params = (p[best] * scale).tolist()
    return FitResult(
        params={n: float(v) for n, v in zip(names, params)},
        residual_norm=float(torch.sqrt(cost[best])),
        iterations=int(it[best]), converged=bool(conv[best]))


def fit_models(
    models: Mapping[str, Model],
    feature_table: FeatureTableLike,
    *,
    scale_by_output: bool = True,
    nonneg: Optional[Mapping[str, bool]] = None,
    seeds: int = 3,
    warm_start: bool = True,
    **solver_opts,
) -> Dict[str, FitResult]:
    """Fit several named models over ONE feature table (the paper's
    one-battery-many-fits workflow).  With ``warm_start`` the fits chain
    in ``models`` order: each model's nominal start takes the values
    earlier (narrower-scope) fits recovered for the parameters they
    share, so a nonlinear form only refines what a linear one found.
    Order ``models`` narrowest first (the zoo's order).  ``nonneg`` maps
    model name → nonnegativity constraint (default True)."""
    table = as_feature_table(feature_table)
    nonneg = dict(nonneg or {})
    fits: Dict[str, FitResult] = {}
    ladder: Dict[str, float] = {}
    for name, model in models.items():
        p0 = {n: ladder[n] for n in model.param_names if n in ladder} \
            if warm_start and ladder else None
        fit = fit_model(model, table, scale_by_output=scale_by_output,
                        nonneg=nonneg.get(name, True), seeds=seeds,
                        p0=p0, **solver_opts)
        fits[name] = fit
        # carry only positive estimates forward: a rate clamped to 0 by a
        # narrow model is a worse start (and a degenerate scale) than an
        # earlier model's coarse positive estimate
        ladder.update({k: v for k, v in fit.params.items() if v > 0})
    return fits


def relative_errors(model: Model, params: Mapping[str, float],
                    table: FeatureTableLike) -> Dict[str, float]:
    """Per-row |pred − meas| / meas against the table's measured output
    column; every feature the model reads must be a column."""
    ft = as_feature_table(table)
    missing = [n for n in (model.output_feature, *model.feature_names)
               if n not in ft.feature_ids]
    if missing:
        raise ValueError(
            f"feature table lacks columns {missing} required by the "
            f"{model.output_feature!r} model; accuracy against it would "
            f"silently read them as 0 — re-gather with these features")
    meas = ft.column(model.output_feature)
    bad = np.flatnonzero(~(np.abs(meas) > 0))
    if bad.size:
        raise ValueError(
            f"measured output {model.output_feature!r} is zero for row "
            f"{ft.row_names[int(bad[0])]!r}; relative error is undefined")
    F = torch.as_tensor(model.align(ft, missing="zero"), dtype=DTYPE)
    p_vec = torch.as_tensor([params[n] for n in model.param_names],
                            dtype=DTYPE)
    pred = model.batched_eval(p_vec, F).numpy()
    rel = np.abs(pred - meas) / np.abs(meas)
    return {name: float(r) for name, r in zip(ft.row_names, rel)}


def _gmre(rel: Sequence[float]) -> float:
    """Geometric mean of relative errors, floored at 1e-12."""
    clamped = [max(float(r), 1e-12) for r in rel]
    return float(np.exp(np.mean(np.log(clamped))))


def geometric_mean_relative_error(pred: Sequence[float],
                                  meas: Sequence[float]) -> float:
    """The paper's headline accuracy metric over paired predictions and
    measurements (Fleming & Wallace 1986)."""
    return _gmre([abs(p - m) / abs(m) for p, m in zip(pred, meas)])


def gmre_of(rel_errors: Mapping[str, float]) -> float:
    """Geometric mean of a per-row relative-error map — the paper's
    headline accuracy metric (Fleming & Wallace 1986)."""
    return _gmre(list(rel_errors.values()))
