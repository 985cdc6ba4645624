"""``PredictEngine`` — the pure prediction core: (profile, counts) →
:class:`Prediction`; the counterpart of ``repro.api.engine``.

It resolves a fit by name, aligns counted features against the fitted
model and evaluates the per-term breakdown of a whole batch in one
float64 torch expression.  It owns no timer and never touches the
filesystem.

**Thread safety.**  One engine is shared by every request thread of a
serving daemon: its memos (resolved fits, per-signature evaluators, fit
diagnostics) and its counters are guarded by one lock, and evaluation
itself is functional.  ``eval_calls`` counts batched evaluations and
``trace_count`` the evaluators built, one per distinct model signature
(the counterpart of the reference's jit trace).
"""
from __future__ import annotations

import threading
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import torch

from repro_torch.api.errors import (
    PredictionError,
    scope_violation,
    scope_violation_error,
)
from repro_torch.api.prediction import Prediction, assemble_predictions
from repro_torch.core.calibrate import gmre_of, relative_errors
from repro_torch.core.counting import FeatureCounts
from repro_torch.core.model import DTYPE, Model
from repro_torch.profiles.profile import MachineProfile, ModelFit, ProfileError

#: default fit to predict with when the caller names none and the profile
#: carries several (the reference zoo's widest-scope form)
DEFAULT_MODEL = "ovl_flop_mem"


class PredictEngine:
    """Prediction math over one machine profile: memoized fit resolution
    plus one batched evaluation per call."""

    def __init__(self, profile: MachineProfile):
        self.profile = profile
        self.eval_calls = 0
        self.trace_count = 0
        self._lock = threading.Lock()
        self._evaluators: Dict[str, Callable] = {}
        self._fit_diag: Dict[str, Dict[str, Any]] = {}
        self._resolved: Dict[str, Tuple[ModelFit, Model]] = {}

    def resolve(self, model: Optional[str]
                ) -> Tuple[str, ModelFit, Model]:
        """A fit name (or the default) → validated (name, fit, model)."""
        fits = self.profile.fits
        name = model
        if name is None:
            if DEFAULT_MODEL in fits:
                name = DEFAULT_MODEL
            elif len(fits) == 1:
                name = next(iter(fits))
            else:
                raise PredictionError(
                    f"profile for {self.profile.fingerprint.id!r} carries "
                    f"fits {self.profile.fit_names} and none is the "
                    f"default {DEFAULT_MODEL!r}; pass model=<name>")
        with self._lock:
            cached = self._resolved.get(name)
        if cached is not None:
            return name, *cached
        try:
            mf = self.profile.get_fit(name)
        except ProfileError as e:
            raise PredictionError(str(e)) from e
        m = mf.model()
        missing = [p for p in m.param_names if p not in mf.params]
        if missing:
            raise PredictionError(
                f"fit {name!r} lacks fitted values for parameter(s) "
                f"{missing} of its own expression — the profile was "
                f"edited or corrupted; recalibrate")
        with self._lock:
            self._resolved[name] = (mf, m)
        return name, mf, m

    def predict_rows(self, counts_rows: Sequence[FeatureCounts],
                     kernel_names: Sequence[str], *,
                     model: Optional[str] = None,
                     strict: bool = False) -> List[Prediction]:
        """One prediction per counted kernel, all in one batched
        evaluation.  ``strict=True`` raises one :class:`PredictionError`
        naming every row with work the model has no term for."""
        preds, errors = self._predict(counts_rows, kernel_names,
                                      model=model, strict=strict,
                                      partial=False)
        assert not errors
        return preds

    def try_predict_rows(self, counts_rows: Sequence[FeatureCounts],
                         kernel_names: Sequence[str], *,
                         model: Optional[str] = None,
                         strict: bool = True
                         ) -> List[Union[Prediction, PredictionError]]:
        """Per-item error mode: an out-of-scope row comes back as its own
        :class:`PredictionError` at its position, every other row as its
        :class:`Prediction` — still one batched evaluation."""
        preds, errors = self._predict(counts_rows, kernel_names,
                                      model=model, strict=strict,
                                      partial=True)
        return [errors.get(i, p) for i, p in enumerate(preds)]

    def _predict(self, counts_rows, kernel_names, *, model, strict,
                 partial):
        if len(counts_rows) != len(kernel_names):
            raise ValueError(f"{len(kernel_names)} names for "
                             f"{len(counts_rows)} count rows")
        fit_name, mf, m = self.resolve(model)
        unmodeled = [m.unmodeled_features(c) for c in counts_rows]
        errors: Dict[int, PredictionError] = {}
        if strict:
            violations = [scope_violation(i, kname, extra)
                          for i, (kname, extra)
                          in enumerate(zip(kernel_names, unmodeled))
                          if extra]
            if violations:
                if not partial:
                    raise scope_violation_error(fit_name, violations)
                errors = {v["index"]: scope_violation_error(fit_name, [v])
                          for v in violations}
        aligned = m.align(counts_rows)
        p_vec = torch.as_tensor([mf.params[n] for n in m.param_names],
                                dtype=DTYPE)
        parts = self._evaluator(m)(p_vec, torch.as_tensor(aligned,
                                                          dtype=DTYPE))
        with self._lock:
            self.eval_calls += 1
        preds = assemble_predictions(
            kernel_names=list(kernel_names),
            fit_name=fit_name,
            labels=m.breakdown_labels,
            parts=parts.numpy(),
            feature_names=m.feature_names,
            aligned=aligned,
            unmodeled=unmodeled,
            params=mf.params,
            diagnostics=self.diagnostics_for(fit_name, mf, m),
        )
        return preds, errors

    def _evaluator(self, model: Model) -> Callable:
        """The batched breakdown evaluator of ``model``, built once per
        model signature (each build counts in ``trace_count``)."""
        sig = model.signature()
        with self._lock:
            fn = self._evaluators.get(sig)
            if fn is None:
                fn = model.batched_breakdown
                self._evaluators[sig] = fn
                self.trace_count += 1
        return fn

    def diagnostics_for(self, fit_name: str, mf: ModelFit, m: Model
                        ) -> Dict[str, Any]:
        with self._lock:
            diag = self._fit_diag.get(fit_name)
        if diag is None:
            diag = {
                "fingerprint": self.profile.fingerprint.id,
                "signature": mf.signature,
                "residual_norm": mf.fit.residual_norm,
                "iterations": mf.fit.iterations,
                "converged": mf.fit.converged,
                "trials": self.profile.trials,
                "holdout_gmre": None,
            }
            holdout = self.profile.holdout
            if holdout is not None and len(holdout):
                try:
                    diag["holdout_gmre"] = gmre_of(
                        relative_errors(m, mf.params, holdout))
                    diag["holdout_noise"] = holdout.noise_summary()
                except ValueError:
                    pass        # holdout lacks this model's columns
            with self._lock:
                self._fit_diag[fit_name] = diag
        return diag
