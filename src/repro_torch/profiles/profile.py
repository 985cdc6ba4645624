"""Persistent machine profiles — the counterpart of
``repro.profiles.profile``, writing the reference's JSON schema (version
1), so ``repro.profiles.load_profile`` reads a profile calibrated by the
port and the two packages' profiles can be compared side by side.

Saved atomically (tmp + fsync + rename); loading is strict: corrupt
files, missing fields, other schema versions and, when asked, foreign
fingerprints raise :class:`ProfileError`.  :func:`merge_profiles` unions
the fits of same-machine profiles.
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
class MachineProfile:
    """Fingerprint, fitted models and measurement provenance."""

    fingerprint: DeviceFingerprint
    fits: Dict[str, ModelFit] = field(default_factory=dict)
    trials: int = 0
    kernel_names: List[str] = field(default_factory=list)
    schema_version: int = PROFILE_SCHEMA_VERSION
    holdout: Optional[FeatureTable] = None

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
    the union of their fits.  Raises :class:`ProfileError` when the
    fingerprints differ (cross-machine collections are fleet bundles,
    :mod:`repro_torch.studies`), when one fit name maps to conflicting
    payloads, or when the held-out tables disagree: a merge never
    silently prefers one measurement over another."""
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
    return MachineProfile(
        fingerprint=base.fingerprint, fits=fits,
        trials=max(p.trials for p in profiles),
        kernel_names=kernel_names,
        holdout=_merge_holdouts([p.holdout for p in profiles]))


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
