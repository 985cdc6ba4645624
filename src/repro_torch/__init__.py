"""``repro_torch`` — the PyTorch/CUDA port of the black-box performance
modeller, beside the JAX package ``repro`` it is checked against.

The slice ported so far is the paper's core loop on an NVIDIA H100:
time the UIPiCK battery on the card (:mod:`repro_torch.core.uipick`),
count each kernel's features at the aten level
(:mod:`repro_torch.core.counting`), fit the ``p_* × f_*`` models by
Levenberg-Marquardt (:mod:`repro_torch.core.calibrate`), save a
reference-schema :class:`~repro_torch.profiles.MachineProfile`, and
predict the §8 hand kernels (:mod:`repro_torch.kernels.ops`) from it with
zero timings (:mod:`repro_torch.api`); around it the model-zoo study,
the count engine and measurement cache, predictor-guided autotuning
(:mod:`repro_torch.tuning`), the static modelability audit
(:mod:`repro_torch.analysis`), the prediction daemon
(:mod:`repro_torch.serving`) and fleet routing (:mod:`repro_torch.fleet`).

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``"cpu"``; without a card they raise instead of falling back.

The stable surface is the reference's, lazily re-exported so
``import repro_torch`` stays cheap and cycle-free.
"""
from importlib import import_module
from typing import Any

_EXPORTS = {
    # facade
    "PerfSession": "repro_torch.api",
    "Prediction": "repro_torch.api",
    "PredictionError": "repro_torch.api",
    "DEFAULT_MODEL": "repro_torch.api",
    # modeling
    "Model": "repro_torch.core.model",
    "FeatureTable": "repro_torch.core.model",
    "FeatureCounts": "repro_torch.core.counting",
    "count_fn": "repro_torch.core.counting",
    "CountEngine": "repro_torch.core.countengine",
    # measuring
    "gather_feature_table": "repro_torch.core.uipick",
    "CountingTimer": "repro_torch.core.uipick",
    "KernelCollection": "repro_torch.core.uipick",
    "MeasurementKernel": "repro_torch.core.uipick",
    "ALL_GENERATORS": "repro_torch.core.uipick",
    "MatchCondition": "repro_torch.core.uipick",
    # fitting
    "fit_model": "repro_torch.core.calibrate",
    "fit_models": "repro_torch.core.calibrate",
    "FitResult": "repro_torch.core.calibrate",
    # artifacts
    "MachineProfile": "repro_torch.profiles",
    "ModelFit": "repro_torch.profiles",
    "ProfileError": "repro_torch.profiles",
    "load_profile": "repro_torch.profiles",
    "save_profile": "repro_torch.profiles",
    "MeasurementCache": "repro_torch.profiles",
    "DeviceFingerprint": "repro_torch.profiles",
    # tuning
    "TuningSpace": "repro_torch.tuning",
    "TuneResult": "repro_torch.tuning",
    "TunedChoice": "repro_torch.profiles",
    "enumerate_space": "repro_torch.tuning",
    "tune_space": "repro_torch.tuning",
    # static audit
    "Diagnostic": "repro_torch.analysis",
    "DiagnosticReport": "repro_torch.analysis",
    "audit_callable": "repro_torch.analysis",
    # studies
    "MODEL_ZOO": "repro_torch.studies",
    "run_study": "repro_torch.studies",
    "compare_profiles": "repro_torch.studies",
    "scope_accuracy_sweep": "repro_torch.studies",
    "StudyReport": "repro_torch.studies",
    # fleet
    "FleetRouter": "repro_torch.fleet",
    "FleetHealth": "repro_torch.fleet",
    "RoutingDecision": "repro_torch.fleet",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}")
    value = getattr(import_module(target), name)
    globals()[name] = value         # cache for subsequent lookups
    return value


def __dir__():
    return __all__
