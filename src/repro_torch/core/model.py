"""Perflex-style cost models in torch — the counterpart of
``repro.core.model``: user-written arithmetic expressions over kernel
*features* (``f_*``) and machine *parameters* (``p_*``)::

    model = Model("f_wall_time_cpu_host",
                  "p_madd * f_op_float32_madd + p_launch * f_sync_launch_kernel")

Expressions are parsed with Python's ``ast`` against the same safe
grammar as the reference and evaluated over whole feature columns in
float64 torch, so calibration gets exact Jacobians from
``torch.func.jacfwd`` and a whole battery evaluates in one expression.
"""
from __future__ import annotations

import ast
import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import overlap as _ovl
from repro_torch.deprecation import warn_once

DTYPE = torch.float64


def _t(fn: Callable) -> Callable:
    """Lift a unary/binary torch function to accept Python numbers."""
    def lifted(*args):
        return fn(*[a if isinstance(a, torch.Tensor)
                    else torch.as_tensor(a, dtype=DTYPE) for a in args])
    return lifted


_FUNCS: Dict[str, Callable] = {
    "smooth_step": _ovl.smooth_step,
    "overlap2": _ovl.overlap2,
    "overlap2_raw": _ovl.overlap2_raw,
    "overlap3": _ovl.overlap3,
    "smoothmax": lambda *a: _ovl.smoothmax(a[:-1], a[-1]),
    "partial_overlap2": _ovl.partial_overlap2,
    "exp": _t(torch.exp), "log": _t(torch.log), "tanh": _t(torch.tanh),
    "sqrt": _t(torch.sqrt), "maximum": _t(torch.maximum),
    "minimum": _t(torch.minimum), "abs": _t(torch.abs),
}

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.Call, ast.Name, ast.Load,
    ast.Constant, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow, ast.USub,
    ast.UAdd, ast.Tuple,
)


def _parse(expr: str) -> ast.Expression:
    tree = ast.parse(expr, mode="eval")
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(f"disallowed syntax in model expression: "
                             f"{ast.dump(node)[:60]}")
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name) or \
                    node.func.id not in _FUNCS:
                raise ValueError(f"unknown function in model: "
                                 f"{getattr(node.func, 'id', '?')}")
    return tree


def _names(tree: ast.Expression) -> List[str]:
    return sorted({n.id for n in ast.walk(tree)
                   if isinstance(n, ast.Name) and n.id not in _FUNCS})


# cost-combining calls whose value is attributed back to their leading
# cost arguments (None: all but the last argument, smoothmax's tuple)
_ATTRIBUTABLE_CALLS: Dict[str, Optional[int]] = {
    "overlap2": 2, "overlap2_raw": 2, "overlap3": 3,
    "partial_overlap2": 2, "smoothmax": None,
}


def _signed_terms(node: ast.expr, sign: float = 1.0):
    """Split an expression at top-level +/- into (sign, term-node) pairs."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        yield from _signed_terms(node.left, sign)
        yield from _signed_terms(node.right, sign)
    elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
        yield from _signed_terms(node.left, sign)
        yield from _signed_terms(node.right, -sign)
    elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        yield from _signed_terms(node.operand, -sign)
    elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
        yield from _signed_terms(node.operand, sign)
    else:
        yield sign, node


def _compile_node(node: ast.expr):
    expr = ast.Expression(body=node)
    ast.fix_missing_locations(expr)
    return compile(expr, "<perflex-term>", "eval")


def _rows(x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Broadcast a term value (possibly a Python number) to one per row."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=DTYPE)
    return torch.broadcast_to(x, (n_rows,))


# ---------------------------------------------------------------------------
# Dense feature-matrix representation of a measurement table
# ---------------------------------------------------------------------------


@dataclass
class FeatureTable:
    """A measurement table as a dense ``[n_rows, n_features]`` float64
    matrix (host numpy); ``feature_ids`` name the columns and
    ``row_names`` the measurement kernel behind each row.  Same JSON form
    as the reference's, so profiles carry it across packages."""

    feature_ids: List[str]
    values: np.ndarray
    row_names: List[str] = field(default_factory=list)
    row_noise: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def __post_init__(self):
        self.values = np.asarray(self.values, np.float64)
        if self.values.ndim != 2 or \
                self.values.shape[1] != len(self.feature_ids):
            raise ValueError(
                f"values must be [n_rows, {len(self.feature_ids)}], "
                f"got {self.values.shape}")
        self._col = {f: i for i, f in enumerate(self.feature_ids)}
        if not self.row_names:
            self.row_names = [f"row{i}" for i in range(len(self.values))]
        # transient gather provenance (not serialized, not carried through
        # select): rows the noisy-row heuristic re-timed — see
        # gather_feature_table(retime_rel_std=...)
        self.retimed_rows: List[str] = []

    def __len__(self) -> int:
        return self.values.shape[0]

    def column(self, feature_id: str) -> np.ndarray:
        """Column of one feature; zeros if absent (counts semantics)."""
        j = self._col.get(feature_id)
        if j is None:
            return np.zeros((len(self),), np.float64)
        return self.values[:, j]

    def row(self, i: int) -> Dict[str, float]:
        """Row ``i`` as a feature → value dict, its kernel under
        ``"_kernel"``."""
        d = {f: float(self.values[i, j]) for f, j in self._col.items()}
        d["_kernel"] = self.row_names[i]
        return d

    def rows(self) -> List[Dict[str, float]]:
        """Dict-per-row view (the reference's compatibility API)."""
        return [self.row(i) for i in range(len(self))]

    @classmethod
    def from_rows(cls, rows: Sequence[Mapping[str, float]]) -> "FeatureTable":
        ids = sorted({k for r in rows for k in r if not k.startswith("_")})
        vals = np.zeros((len(rows), len(ids)), np.float64)
        for i, r in enumerate(rows):
            for j, f in enumerate(ids):
                vals[i, j] = float(r.get(f, 0.0))
        names = [str(r.get("_kernel", f"row{i}")) for i, r in enumerate(rows)]
        return cls(ids, vals, names)

    def select(self, indices: Sequence[int]) -> "FeatureTable":
        """Sub-table of the given rows (noise metadata follows its rows)."""
        idx = list(indices)
        names = [self.row_names[i] for i in idx]
        return FeatureTable(
            list(self.feature_ids), self.values[idx, :], names,
            {n: dict(self.row_noise[n]) for n in names
             if n in self.row_noise})

    def noise_summary(self) -> Dict[str, float]:
        """Relative wall-clock noise (std / median) over rows that carry
        spread metadata; empty when none do."""
        rel = [d["std"] / d["median"] for d in self.row_noise.values()
               if d.get("std") is not None and d.get("median", 0) > 0]
        if not rel:
            return {}
        return {"max_rel_std": float(np.max(rel)),
                "median_rel_std": float(np.median(rel)),
                "rows": float(len(rel))}

    def to_dict(self) -> Dict[str, object]:
        return {
            "feature_ids": list(self.feature_ids),
            "values": [[float(v) for v in row] for row in self.values],
            "row_names": list(self.row_names),
            "row_noise": {n: {k: float(v) for k, v in d.items()}
                          for n, d in sorted(self.row_noise.items())},
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "FeatureTable":
        return cls(
            [str(f) for f in d["feature_ids"]],
            np.asarray(d["values"], np.float64).reshape(
                len(d["row_names"]), len(d["feature_ids"])),
            [str(n) for n in d["row_names"]],
            {str(n): {str(k): float(v) for k, v in dict(nd).items()}
             for n, nd in dict(d.get("row_noise", {})).items()})


FeatureTableLike = Union[FeatureTable, Sequence[Mapping[str, float]]]


def as_feature_table(table: FeatureTableLike) -> FeatureTable:
    if isinstance(table, FeatureTable):
        return table
    return FeatureTable.from_rows(table)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclass
class Model:
    """output feature ≈ g(input features; parameters)."""

    output_feature: str
    expr: str

    def __post_init__(self):
        self._tree = _parse(self.expr)
        names = _names(self._tree)
        self.param_names: List[str] = [n for n in names if n.startswith("p_")]
        self.feature_names: List[str] = [n for n in names if n.startswith("f_")]
        bad = [n for n in names if not n.startswith(("p_", "f_"))]
        if bad:
            raise ValueError(f"model names must start with p_/f_: {bad}")
        self._code = compile(self._tree, "<perflex-model>", "eval")
        self._breakdown_plan: Optional[List[tuple]] = None

    def all_features(self) -> List[str]:
        return [self.output_feature, *self.feature_names]

    def signature(self) -> str:
        """Content identity (output feature + expression), the same hash
        as the reference's, so fits match across packages."""
        return hashlib.sha256(
            f"{self.output_feature}\n{self.expr}".encode()).hexdigest()[:16]

    # -- feature alignment --------------------------------------------------
    def align(self, counts: Union[FeatureTableLike, Mapping[str, float]],
              *, missing: str = "error") -> np.ndarray:
        """Dense ``[n_rows, n_features]`` float64 matrix with columns in
        ``self.feature_names`` order.  Mappings follow counts semantics
        (absent == 0); a :class:`FeatureTable` lacking a column raises
        unless ``missing="zero"``."""
        if missing not in ("error", "zero"):
            raise ValueError(f"missing must be 'error' or 'zero', "
                             f"got {missing!r}")
        if isinstance(counts, Mapping):
            counts = [counts]
        if isinstance(counts, FeatureTable):
            absent = [n for n in self.feature_names
                      if n not in counts.feature_ids]
            if absent and missing == "error":
                raise ValueError(
                    f"feature table lacks columns {absent} required by the "
                    f"{self.output_feature!r} model (alignment would "
                    f"silently read them as 0) — re-gather with these "
                    f"features")
            if not self.feature_names:
                return np.zeros((len(counts), 0), np.float64)
            return np.stack([counts.column(n) for n in self.feature_names],
                            axis=1)
        rows = list(counts)
        out = np.zeros((len(rows), len(self.feature_names)), np.float64)
        for i, r in enumerate(rows):
            for j, n in enumerate(self.feature_names):
                out[i, j] = float(r.get(n, 0.0))
        return out

    def unmodeled_features(self, counts: Mapping[str, float]
                           ) -> Dict[str, float]:
        """Nonzero counted features this model has no term for."""
        known = set(self.feature_names)
        known.add(self.output_feature)
        return {k: float(v) for k, v in sorted(counts.items())
                if k not in known and not k.startswith("_") and float(v)}

    # -- evaluation ---------------------------------------------------------
    def _eval(self, env: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The expression over ``env`` (every parameter and feature name
        bound to a tensor or number)."""
        return eval(self._code, {"__builtins__": {}}, {**_FUNCS, **env})

    def evaluate(self, param_values: Mapping[str, float],
                 feature_values: Mapping[str, float]) -> torch.Tensor:
        """One prediction from named parameters and features (absent
        features read as 0), as a float64 scalar tensor."""
        env = {n: torch.as_tensor(param_values[n], dtype=DTYPE)
               for n in self.param_names}
        env.update({n: torch.as_tensor(float(feature_values.get(n, 0.0)),
                                       dtype=DTYPE)
                    for n in self.feature_names})
        return self._eval(env)

    def eval_with_counts(self, param_values: Mapping[str, float],
                         counts: Mapping[str, float]) -> float:
        """Deprecated: use :meth:`align` + :meth:`batched_eval`, or the
        :class:`repro_torch.api.PerfSession` facade."""
        warn_once(
            "Model.eval_with_counts",
            "Model.eval_with_counts is deprecated; use Model.align + "
            "Model.batched_eval, or repro_torch.api.PerfSession.predict")
        return float(self.evaluate(param_values, counts))

    def _env(self, p_vec: torch.Tensor, features: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        env = {n: p_vec[i] for i, n in enumerate(self.param_names)}
        env.update({n: features[:, j]
                    for j, n in enumerate(self.feature_names)})
        return env

    def batched_eval(self, p_vec: torch.Tensor, features: torch.Tensor
                     ) -> torch.Tensor:
        """``features`` ``[n_rows, n_features]`` (columns as
        ``self.feature_names``) → ``[n_rows]`` predictions."""
        return _rows(self._eval(self._env(p_vec, features)),
                     features.shape[0])

    def param_feature_map(self) -> Dict[str, List[str]]:
        """Parameter name → the sorted features appearing in the same
        top-level additive terms (the identifiability analysis names the
        features behind a collinear pair with it)."""
        out: Dict[str, set] = {p: set() for p in self.param_names}
        for _sign, node in _signed_terms(self._tree.body):
            names = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
            feats = {n for n in names if n.startswith("f_")}
            for p in names:
                if p.startswith("p_"):
                    out[p] |= feats
        return {p: sorted(fs) for p, fs in out.items()}

    def param_jacobian(self, p_vec, features) -> np.ndarray:
        """``∂ prediction / ∂ parameters``, ``[n_rows, n_params]`` float64
        — the least-squares design matrix linearized at ``p_vec``."""
        F = torch.as_tensor(np.asarray(features), dtype=DTYPE)
        p = torch.as_tensor(np.asarray(p_vec), dtype=DTYPE)
        J = torch.func.jacfwd(lambda q: self.batched_eval(q, F))(p)
        return J.numpy()

    # -- cost-explanatory per-term breakdown --------------------------------
    def _plan(self) -> List[tuple]:
        if self._breakdown_plan is None:
            plan = []
            for sign, node in _signed_terms(self._tree.body):
                prefix = "-" if sign < 0 else ""
                label = prefix + ast.unparse(node)
                comps = None
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id in _ATTRIBUTABLE_CALLS:
                    k = _ATTRIBUTABLE_CALLS[node.func.id]
                    if k is None:
                        k = len(node.args) - 1
                    if 2 <= k <= len(node.args):
                        comps = [(f"{prefix}{node.func.id}"
                                  f"[{ast.unparse(a)}]", _compile_node(a))
                                 for a in node.args[:k]]
                plan.append((sign, label, _compile_node(node), comps))
            self._breakdown_plan = plan
        return self._breakdown_plan

    @property
    def breakdown_labels(self) -> List[str]:
        labels: List[str] = []
        for _sign, label, _code, comps in self._plan():
            if comps is None:
                labels.append(label)
            else:
                labels.extend(cl for cl, _ in comps)
        return labels

    def batched_breakdown(self, p_vec: torch.Tensor, features: torch.Tensor
                          ) -> torch.Tensor:
        """Per-term contributions ``[n_rows, n_parts]`` labeled by
        :attr:`breakdown_labels`; rows sum to :meth:`batched_eval`.  An
        attributable nonlinear term is split in proportion to its
        component costs, the last part taking the remainder, exactly as
        the reference splits it."""
        ns = {**_FUNCS, **self._env(p_vec, features)}
        scope = {"__builtins__": {}}
        n_rows = features.shape[0]
        cols: List[torch.Tensor] = []
        for sign, _label, code, comps in self._plan():
            v = _rows(eval(code, scope, ns), n_rows)
            if sign != 1.0:
                v = v * sign
            if comps is None:
                cols.append(v)
                continue
            cvals = [torch.abs(_rows(eval(c_code, scope, ns), n_rows))
                     for _cl, c_code in comps]
            tot = cvals[0]
            for c in cvals[1:]:
                tot = tot + c
            safe = torch.where(tot > 0, tot, torch.ones_like(tot))
            even = torch.full_like(tot, 1.0 / len(cvals))
            acc = torch.zeros_like(v)
            for c in cvals[:-1]:
                part = v * torch.where(tot > 0, c / safe, even)
                cols.append(part)
                acc = acc + part
            cols.append(v - acc)
        return torch.stack(cols, dim=1)

    # -- design matrix ------------------------------------------------------
    def design_matrix(self, table: FeatureTableLike,
                      *, scale_by_output: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """``(F, target)`` for least squares; with ``scale_by_output``
        (paper §7.2) each row is divided by its measured output, a
        relative-error fit with target 1."""
        ft = as_feature_table(table)
        if self.output_feature not in ft.feature_ids:
            raise KeyError(
                f"output feature {self.output_feature!r} not present in the "
                f"feature table (columns: {ft.feature_ids})")
        t = ft.column(self.output_feature)
        F = self.align(ft, missing="zero")
        if scale_by_output:
            bad = np.flatnonzero(~(t > 0))
            if bad.size:
                i = int(bad[0])
                raise ValueError(
                    f"output feature {self.output_feature!r} must be "
                    f"positive to scale rows by it; row {i} "
                    f"({ft.row_names[i]!r}) has value {t[i]!r}")
            F = F / t[:, None]
            target = np.ones_like(t)
        else:
            target = t
        return F, target
