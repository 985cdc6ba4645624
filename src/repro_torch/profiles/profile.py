"""Persistent machine profiles — the counterpart of
``repro.profiles.profile``, writing the reference's JSON schema (version
1), so ``repro.profiles.load_profile`` reads a profile calibrated by the
port and the two packages' profiles can be compared side by side.

Saved atomically (tmp + fsync + rename); loading is strict: corrupt
files, missing fields, other schema versions and, when asked, foreign
fingerprints raise :class:`ProfileError`.  :func:`merge_profiles` unions
the fits and tuned choices of same-machine profiles.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from repro_torch.core.calibrate import FitResult
from repro_torch.core.model import FeatureTable, Model
from repro_torch.profiles.fingerprint import DeviceFingerprint

PROFILE_SCHEMA_VERSION = 1


class ProfileError(RuntimeError):
    """A profile file that cannot be trusted (corrupt, wrong schema,
    wrong machine)."""


def atomic_write_json(path: Path, payload: Any) -> None:
    """Crash-safe deterministic JSON write: a private tmp file, fsync,
    then rename, so a reader sees the old file or the new one, never a
    torn document."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name,
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


@dataclass
class ModelFit:
    """One calibrated model: definition, fitted ``p_*`` values and fit
    diagnostics; ``signature`` ties the values to the expression."""

    output_feature: str
    expr: str
    fit: FitResult
    signature: str = ""

    def __post_init__(self):
        expect = Model(self.output_feature, self.expr).signature()
        if not self.signature:
            self.signature = expect
        elif self.signature != expect:
            raise ProfileError(
                f"model fit signature mismatch: stored {self.signature!r} "
                f"but output feature + expression hash to {expect!r} — the "
                f"profile was edited or corrupted")

    @classmethod
    def from_fit(cls, model: Model, fit: FitResult) -> "ModelFit":
        return cls(output_feature=model.output_feature, expr=model.expr,
                   fit=fit, signature=model.signature())

    @property
    def params(self) -> Dict[str, float]:
        return self.fit.params

    def model(self) -> Model:
        return Model(self.output_feature, self.expr)

    def to_dict(self) -> Dict[str, Any]:
        return {"output_feature": self.output_feature, "expr": self.expr,
                "signature": self.signature, **self.fit.to_dict()}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ModelFit":
        return cls(output_feature=str(d["output_feature"]),
                   expr=str(d["expr"]),
                   fit=FitResult.from_dict(d),
                   signature=str(d.get("signature", "")))


@dataclass
class TunedChoice:
    """One autotuning decision, recorded in the profile that made it
    (the reference's ``TunedChoice``, same fields and JSON form).

    The predictor-guided search (:mod:`repro_torch.tuning`) prices a
    whole variant space in one batched evaluation, times only the pruned
    survivors and stores the winner here, keyed by the space's content
    signature, so a warm re-tune on this machine performs zero timings
    and zero counting passes.  ``timings_spent`` is the timing passes
    the search actually ran (cache hits cost nothing).
    """

    space_signature: str
    space_name: str
    model: str                  # fit name the pricing ran under
    winner: str                 # winning variant's kernel name
    predicted_s: float          # winner's predicted seconds
    measured_s: float           # winner's confirmation seconds
    n_variants: int             # enumerated space size
    n_timed: int                # survivors confirmed by measurement
    timings_spent: int          # timing passes actually executed
    trials: int                 # trials per confirmation timing
    margin: float = 0.0         # prune margin the search ran with
    tags: List[str] = field(default_factory=list)
    predicted: Dict[str, float] = field(default_factory=dict)
    measured: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "space_signature": self.space_signature,
            "space_name": self.space_name,
            "model": self.model,
            "winner": self.winner,
            "predicted_s": self.predicted_s,
            "measured_s": self.measured_s,
            "n_variants": self.n_variants,
            "n_timed": self.n_timed,
            "timings_spent": self.timings_spent,
            "trials": self.trials,
            "margin": self.margin,
            "tags": list(self.tags),
            "predicted": {k: float(v)
                          for k, v in sorted(self.predicted.items())},
            "measured": {k: float(v)
                         for k, v in sorted(self.measured.items())},
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TunedChoice":
        return cls(
            space_signature=str(d["space_signature"]),
            space_name=str(d["space_name"]),
            model=str(d["model"]),
            winner=str(d["winner"]),
            predicted_s=float(d["predicted_s"]),
            measured_s=float(d["measured_s"]),
            n_variants=int(d["n_variants"]),
            n_timed=int(d["n_timed"]),
            timings_spent=int(d["timings_spent"]),
            trials=int(d["trials"]),
            margin=float(d.get("margin", 0.0)),
            tags=[str(t) for t in d.get("tags", [])],
            predicted={str(k): float(v)
                       for k, v in dict(d.get("predicted", {})).items()},
            measured={str(k): float(v)
                      for k, v in dict(d.get("measured", {})).items()},
        )


@dataclass
class MachineProfile:
    """Fingerprint, fitted models, measurement provenance and tuned
    choices."""

    fingerprint: DeviceFingerprint
    fits: Dict[str, ModelFit] = field(default_factory=dict)
    trials: int = 0
    kernel_names: List[str] = field(default_factory=list)
    schema_version: int = PROFILE_SCHEMA_VERSION
    holdout: Optional[FeatureTable] = None
    # autotuning decisions keyed by variant-space signature; written only
    # when present, so a profile without them keeps its bytes
    tuning: Dict[str, TunedChoice] = field(default_factory=dict)

    @property
    def fit_names(self) -> List[str]:
        return sorted(self.fits)

    def get_fit(self, name: str) -> ModelFit:
        if name not in self.fits:
            raise ProfileError(
                f"profile for {self.fingerprint.id!r} has no fit named "
                f"{name!r}; it carries {self.fit_names} — recalibrate with "
                f"the model you want to predict with")
        return self.fits[name]

    def fit_for(self, model: Model) -> ModelFit:
        """The stored fit matching ``model`` (by content signature); none
        raises :class:`ProfileError` naming the fits the profile has."""
        sig = model.signature()
        for mf in self.fits.values():
            if mf.signature == sig:
                return mf
        have = {name: mf.output_feature for name, mf in self.fits.items()}
        raise ProfileError(
            f"profile has no fit for model {model.output_feature!r} "
            f"(signature {sig}); stored fits: {have}")

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "schema_version": self.schema_version,
            "fingerprint": self.fingerprint.to_dict(),
            "trials": self.trials,
            "kernel_names": list(self.kernel_names),
            "fits": {name: mf.to_dict() for name, mf in self.fits.items()},
        }
        if self.holdout is not None:
            out["holdout"] = self.holdout.to_dict()
        if self.tuning:
            out["tuning"] = {sig: tc.to_dict()
                             for sig, tc in sorted(self.tuning.items())}
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MachineProfile":
        version = d.get("schema_version")
        if version != PROFILE_SCHEMA_VERSION:
            raise ProfileError(
                f"unsupported profile schema version {version!r} "
                f"(this build reads version {PROFILE_SCHEMA_VERSION}); "
                f"re-run `python -m repro_torch.calibrate` to regenerate")
        try:
            holdout = d.get("holdout")
            return cls(
                fingerprint=DeviceFingerprint.from_dict(d["fingerprint"]),
                fits={str(name): ModelFit.from_dict(mf)
                      for name, mf in dict(d["fits"]).items()},
                trials=int(d.get("trials", 0)),
                kernel_names=[str(n) for n in d.get("kernel_names", [])],
                schema_version=int(version),
                holdout=(FeatureTable.from_dict(holdout)
                         if holdout is not None else None),
                tuning={str(sig): TunedChoice.from_dict(tc)
                        for sig, tc in dict(d.get("tuning", {})).items()},
            )
        except (KeyError, TypeError, ValueError) as e:
            raise ProfileError(f"malformed profile: {e!r}") from e


def _merge_holdouts(tables: List[Optional[FeatureTable]]
                    ) -> Optional[FeatureTable]:
    """Merge the held-out tables of same-machine profiles.  Studies over
    one battery hold out the same rows (the split hashes row names),
    possibly with different feature columns: those merge column-wise.
    Disagreeing row sets, or disagreeing values of a shared column or of
    a row's noise, are conflicts."""
    tables = [t for t in tables if t is not None]
    if not tables:
        return None
    base = tables[0]
    for other in tables[1:]:
        if other.row_names != base.row_names:
            raise ProfileError(
                f"conflicting held-out splits while merging: "
                f"{base.row_names} vs {other.row_names} — profiles from "
                f"different batteries cannot share one holdout")
    feature_ids: List[str] = []
    for t in tables:
        for f in t.feature_ids:
            if f not in feature_ids:
                feature_ids.append(f)
    vals = np.zeros((len(base), len(feature_ids)), np.float64)
    for j, f in enumerate(feature_ids):
        cols = [t.column(f) for t in tables if f in t.feature_ids]
        for c in cols[1:]:
            if not np.array_equal(cols[0], c):
                raise ProfileError(
                    f"conflicting held-out measurements for feature {f!r} "
                    f"while merging — remeasure or merge profiles from "
                    f"the same gather")
        vals[:, j] = cols[0]
    noise: Dict[str, Dict[str, float]] = {}
    for t in tables:
        for name, d in t.row_noise.items():
            if name in noise and noise[name] != dict(d):
                raise ProfileError(
                    f"conflicting noise metadata for held-out row "
                    f"{name!r} while merging")
            noise[name] = dict(d)
    return FeatureTable(feature_ids, vals, list(base.row_names), noise)


def merge_profiles(profiles: List[MachineProfile]) -> MachineProfile:
    """Merge ≥ 2 profiles calibrated on the same machine into one holding
    the union of their fits and tuned choices.  Raises
    :class:`ProfileError` when the fingerprints differ (cross-machine
    collections are fleet bundles, :mod:`repro_torch.studies`), when one
    fit name or one space signature maps to conflicting payloads, or when
    the held-out tables disagree: a merge never silently prefers one
    measurement over another."""
    if len(profiles) < 2:
        raise ProfileError(f"merge needs at least 2 profiles, "
                           f"got {len(profiles)}")
    base = profiles[0]
    for other in profiles[1:]:
        if other.fingerprint != base.fingerprint:
            raise ProfileError(
                f"cannot merge profiles from different machines: "
                f"{base.fingerprint.id!r} vs {other.fingerprint.id!r} "
                f"(use a fleet bundle for cross-machine collections)")
    fits: Dict[str, ModelFit] = {}
    kernel_names: List[str] = []
    tuning: Dict[str, TunedChoice] = {}
    for prof in profiles:
        for name, mf in prof.fits.items():
            if name in fits and fits[name].to_dict() != mf.to_dict():
                raise ProfileError(
                    f"conflicting fit {name!r} while merging: "
                    f"signature/parameters disagree between inputs — "
                    f"recalibrate or rename one of them")
            fits[name] = mf
        for k in prof.kernel_names:
            if k not in kernel_names:
                kernel_names.append(k)
        for sig, tc in prof.tuning.items():
            if sig in tuning and tuning[sig].to_dict() != tc.to_dict():
                raise ProfileError(
                    f"conflicting tuned choice for space "
                    f"{tc.space_name!r} ({sig}) while merging: the inputs "
                    f"disagree on the winner or its measurements — "
                    f"re-tune instead of merging")
            tuning[sig] = tc
    return MachineProfile(
        fingerprint=base.fingerprint, fits=fits,
        trials=max(p.trials for p in profiles),
        kernel_names=kernel_names,
        holdout=_merge_holdouts([p.holdout for p in profiles]),
        tuning=tuning)


def save_profile(profile: MachineProfile, path) -> Path:
    """Atomically write ``profile`` to ``path`` (JSON, deterministic)."""
    path = Path(path)
    atomic_write_json(path, profile.to_dict())
    return path


def load_profile(path, *,
                 expected_fingerprint: Optional[DeviceFingerprint] = None
                 ) -> MachineProfile:
    """Load and validate a profile (either package's)."""
    path = Path(path)
    try:
        raw = path.read_text()
    except OSError as e:
        raise ProfileError(f"cannot read profile {path}: {e}") from e
    try:
        payload = json.loads(raw)
    except ValueError as e:
        raise ProfileError(
            f"profile {path} is not valid JSON ({e}) — the file is "
            f"corrupt or truncated") from e
    if not isinstance(payload, dict):
        raise ProfileError(f"profile {path} is not a JSON object")
    profile = MachineProfile.from_dict(payload)
    if expected_fingerprint is not None \
            and profile.fingerprint != expected_fingerprint:
        raise ProfileError(
            f"profile {path} was calibrated on "
            f"{profile.fingerprint.id!r} but this machine is "
            f"{expected_fingerprint.id!r}; recalibrate with "
            f"`python -m repro_torch.calibrate`")
    return profile
