"""Cross-machine studies: one battery → many fits → comparable reports;
the counterpart of ``repro.studies.study``.

1. :func:`run_study` gathers ONE timing battery on a machine (the card,
   the host, or a synthetic device through the injectable timer), splits
   it into train/held-out rows deterministically by kernel identity,
   fits every model-zoo form on the train rows and keeps fits AND
   held-out measurements in one :class:`~repro_torch.profiles.MachineProfile`.
2. :func:`compare_profiles` takes ≥ 2 such profiles and produces the
   paper's Tables 3–6 shape: per-model × per-kernel-variant relative
   error on the held-out split, per machine, with geometric-mean
   summaries, as JSON and markdown; :func:`scope_accuracy_sweep` orders
   it by zoo rank.

Because the held-out rows ride inside the profile, a compare run needs
no hardware.  :func:`merge_any` merges same-machine profiles fit by fit
or collects several machines into a fleet bundle
(:func:`fleet_to_dict`), and :func:`load_profiles_any` reads either form.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.analysis.diagnostics import sort_key
from repro_torch.analysis.identifiability import analyze_model
from repro_torch.core.calibrate import fit_models, gmre_of, relative_errors
from repro_torch.core.model import FeatureTable
from repro_torch.core.uipick import (
    ALL_GENERATORS,
    KernelCollection,
    MatchCondition,
    gather_feature_table,
    holdout_split,
)
from repro_torch.profiles.fingerprint import DeviceFingerprint
from repro_torch.profiles.presets import DEFAULT_OUTPUT_FEATURE
from repro_torch.profiles.profile import (
    MachineProfile,
    ModelFit,
    ProfileError,
    load_profile,
    merge_profiles,
)
from repro_torch.studies.zoo import MODEL_ZOO, STUDY_TAGS, ZooEntry

#: version of the report JSON (the reference's fleet schema version)
FLEET_SCHEMA_VERSION = 1


class StudyError(RuntimeError):
    """A study input that cannot be used (missing holdout, duplicate
    machines, an unidentifiable battery)."""


# ---------------------------------------------------------------------------
# Running one machine's study
# ---------------------------------------------------------------------------


def run_study(
    *,
    fingerprint: DeviceFingerprint,
    timer: Optional[Callable] = None,
    cache: Optional[Any] = None,
    entries: Sequence[ZooEntry] = tuple(MODEL_ZOO),
    tags: Sequence[str] = tuple(STUDY_TAGS),
    output_feature: str = DEFAULT_OUTPUT_FEATURE,
    trials: int = 8,
    holdout_fraction: float = 0.25,
    match: MatchCondition = MatchCondition.INTERSECT,
    retime_rel_std: Optional[float] = None,
    engine: Optional[Any] = None,
    force: bool = False,
) -> MachineProfile:
    """One machine's full study: gather once, fit the whole zoo, keep
    fits + held-out rows in a single profile.

    ``timer(kernel, trials)`` is the timing seam (a synthetic device's
    ``timer``); without one each kernel is timed on the card.  ``cache``
    (a :class:`~repro_torch.profiles.cache.MeasurementCache`),
    ``retime_rel_std`` and ``engine`` (a
    :class:`~repro_torch.core.countengine.CountEngine`) are forwarded to
    :func:`~repro_torch.core.uipick.gather_feature_table`; the re-timed
    rows ride on the returned profile as the transient attribute
    ``retimed_rows`` (not serialized).

    Before fitting, every zoo rung's identifiability over the train split
    is analyzed (:mod:`repro_torch.analysis.identifiability`); a rung the
    battery cannot determine aborts the study with :class:`StudyError`
    unless ``force=True`` (CLI ``--force``)."""
    entries = list(entries)
    if not entries:
        raise StudyError("a study needs at least one zoo entry")
    if not 0.0 < holdout_fraction < 1.0:
        raise StudyError(
            f"holdout_fraction must be in (0, 1), got {holdout_fraction}; "
            f"a study without held-out rows cannot report accuracy, and "
            f"holding out (nearly) everything leaves nothing to fit")
    kernels = KernelCollection(ALL_GENERATORS).generate_kernels(
        list(tags), generator_match_cond=match)
    if len(kernels) < 2:
        raise StudyError(
            f"study battery matched {len(kernels)} kernels for tags "
            f"{list(tags)!r}; need ≥ 2 for a train/holdout split")

    models = {e.name: e.model(output_feature) for e in entries}
    features: List[str] = [output_feature]
    for m in models.values():
        for f in m.feature_names:
            if f not in features:
                features.append(f)

    table = gather_feature_table(features, kernels, trials=trials,
                                 timer=timer, cache=cache,
                                 retime_rel_std=retime_rel_std,
                                 engine=engine)
    train, holdout = holdout_split(table, holdout_fraction=holdout_fraction)
    widest = max(len(m.param_names) for m in models.values())
    if len(train) < widest:
        raise StudyError(
            f"train split has {len(train)} rows but the widest zoo model "
            f"has {widest} parameters — an underdetermined fit would "
            f"'converge' to arbitrary values; widen the battery tags")
    if not force:
        structural = []
        for name in sorted(models):
            m = models[name]
            structural += [
                d for d in analyze_model(
                    m, m.align(train, missing="zero"),
                    f"model:{name}[train]")
                if d.severity == "error"]
        if structural:
            raise StudyError(
                "the train split cannot identify every zoo rung's "
                "parameters — fitted values would be arbitrary along the "
                "null space:\n  "
                + "\n  ".join(d.render()
                              for d in sorted(structural, key=sort_key))
                + "\nWiden the battery tags (or pass force=True / "
                  "--force to fit anyway)")
    fits = fit_models(models, train,
                      nonneg={e.name: e.nonneg for e in entries})
    profile = MachineProfile(
        fingerprint=fingerprint,
        fits={name: ModelFit.from_fit(models[name], fit)
              for name, fit in fits.items()},
        trials=trials,
        kernel_names=[k.name for k in kernels],
        holdout=holdout)
    profile.retimed_rows = list(table.retimed_rows)
    return profile


# ---------------------------------------------------------------------------
# Accuracy evaluation + report
# ---------------------------------------------------------------------------


def profile_accuracy(profile: MachineProfile
                     ) -> Dict[str, Dict[str, float]]:
    """Per-fit × per-held-out-variant relative error for one profile."""
    if profile.holdout is None or len(profile.holdout) == 0:
        raise StudyError(
            f"profile for {profile.fingerprint.id!r} carries no held-out "
            f"measurements; re-run the study (run_study / `--zoo`) to "
            f"produce a comparable profile")
    out: Dict[str, Dict[str, float]] = {}
    for name, mf in sorted(profile.fits.items()):
        out[name] = relative_errors(mf.model(), mf.params, profile.holdout)
    return out


def _noise_summary(table: Optional[FeatureTable]) -> Dict[str, float]:
    """Relative wall-clock noise summary of a table (none → empty)."""
    return table.noise_summary() if table is not None else {}


@dataclass
class StudyReport:
    """Cross-machine accuracy report (paper Tables 3–6 shape)."""

    # fingerprint id → fit name → kernel-variant row name → relative error
    per_variant: Dict[str, Dict[str, Dict[str, float]]]
    # fingerprint id → fit name → geometric-mean relative error
    summary: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # fingerprint id → wall-clock noise summary of the held-out rows
    noise: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # fingerprint id → fit name → fitted parameters (fit diagnostics)
    params: Dict[str, Dict[str, Dict[str, float]]] = field(
        default_factory=dict)

    @property
    def machines(self) -> List[str]:
        return sorted(self.per_variant)

    @property
    def model_names(self) -> List[str]:
        return sorted({n for per_fit in self.per_variant.values()
                       for n in per_fit})

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "fleet_schema_version": FLEET_SCHEMA_VERSION,
            "machines": self.machines,
            "models": self.model_names,
            "per_variant": self.per_variant,
            "summary": self.summary,
            "noise": self.noise,
            "params": self.params,
        }

    def to_markdown(self) -> str:
        models = self.model_names
        lines = ["# Cross-machine accuracy report", ""]
        lines.append(f"Machines: {', '.join(self.machines)}")
        lines.append("")
        lines.append("## Held-out geometric-mean relative error")
        lines.append("")
        lines.append("| machine | " + " | ".join(models) + " |")
        lines.append("|---" * (len(models) + 1) + "|")
        for fp in self.machines:
            cells = [_pct(self.summary.get(fp, {}).get(m)) for m in models]
            lines.append(f"| {fp} | " + " | ".join(cells) + " |")
        lines.append("")
        for fp in self.machines:
            lines.append(f"## {fp}")
            lines.append("")
            noise = self.noise.get(fp)
            if noise:
                lines.append(
                    f"wall-clock noise (held-out rows): "
                    f"max rel std {noise['max_rel_std'] * 100:.2f}%, "
                    f"median {noise['median_rel_std'] * 100:.2f}%")
                lines.append("")
            per_fit = self.per_variant[fp]
            variants = sorted({v for errs in per_fit.values() for v in errs})
            lines.append("| kernel variant | " + " | ".join(models) + " |")
            lines.append("|---" * (len(models) + 1) + "|")
            for v in variants:
                cells = [_pct(per_fit.get(m, {}).get(v)) for m in models]
                lines.append(f"| {v} | " + " | ".join(cells) + " |")
            lines.append("")
        return "\n".join(lines)


def _pct(x: Optional[float]) -> str:
    return "—" if x is None else f"{x * 100:.2f}%"


def compare_profiles(profiles: Sequence[MachineProfile]) -> StudyReport:
    """Build the cross-machine accuracy report from ≥ 2 study profiles.

    Each machine may appear only once — two profiles with the same
    fingerprint are ambiguous (which measurements represent the
    machine?).
    """
    profiles = list(profiles)
    if len(profiles) < 2:
        raise StudyError(
            f"compare needs at least 2 profiles, got {len(profiles)}")
    seen: Dict[str, int] = {}
    for p in profiles:
        seen[p.fingerprint.id] = seen.get(p.fingerprint.id, 0) + 1
    dupes = sorted(fp for fp, n in seen.items() if n > 1)
    if dupes:
        raise StudyError(
            f"machine(s) {dupes} appear more than once; compare one "
            f"profile per machine")
    report = StudyReport(per_variant={})
    for p in profiles:
        fp = p.fingerprint.id
        acc = profile_accuracy(p)
        report.per_variant[fp] = acc
        report.summary[fp] = {name: gmre_of(errs)
                              for name, errs in acc.items()}
        report.noise[fp] = _noise_summary(p.holdout)
        report.params[fp] = {name: dict(mf.params)
                             for name, mf in sorted(p.fits.items())}
    return report


# ---------------------------------------------------------------------------
# Scope-vs-accuracy tradeoff curve (the paper's central mechanism, §8)
# ---------------------------------------------------------------------------


def scope_accuracy_sweep(report: StudyReport) -> Dict[str, Any]:
    """Per-zoo-rank held-out accuracy: the paper's accuracy/scope tradeoff
    as one structured artifact.

    Rows are ordered by model scope (zoo ``scope_rank``; fits outside the
    zoo sort last by name) and carry, per model form: its scope rank, its
    parameter count (the scope proxy you pay for), each machine's held-out
    gmre, and the fleet-wide geometric mean — so ``compare --sweep`` can
    answer "what does one more term buy, and what does it cost?" in one
    command.
    """
    rank_of = {e.name: e.scope_rank for e in MODEL_ZOO}
    models = sorted(report.model_names,
                    key=lambda n: (rank_of.get(n, len(MODEL_ZOO)), n))
    rows: List[Dict[str, Any]] = []
    for name in models:
        per_machine = {fp: report.summary[fp][name]
                       for fp in report.machines
                       if name in report.summary.get(fp, {})}
        vals = list(per_machine.values())
        n_params = max((len(report.params.get(fp, {}).get(name, {}))
                        for fp in report.machines), default=0)
        rows.append({
            "model": name,
            "scope_rank": rank_of.get(name),
            "n_params": n_params,
            "per_machine": per_machine,
            "fleet_gmre": gmre_of({fp: v for fp, v
                                   in per_machine.items()}) if vals
            else None,
        })
    return {"fleet_schema_version": FLEET_SCHEMA_VERSION,
            "machines": report.machines, "sweep": rows}


def sweep_to_markdown(sweep: Dict[str, Any]) -> str:
    machines = list(sweep["machines"])
    lines = ["## Scope vs accuracy (held-out gmre by zoo rank)", ""]
    header = ["rank", "model", "params", *machines, "fleet"]
    lines.append("| " + " | ".join(header) + " |")
    lines.append("|---" * len(header) + "|")
    for row in sweep["sweep"]:
        rank = "—" if row["scope_rank"] is None else str(row["scope_rank"])
        cells = [rank, row["model"], str(row["n_params"])]
        cells += [_pct(row["per_machine"].get(fp)) for fp in machines]
        cells.append(_pct(row["fleet_gmre"]))
        lines.append("| " + " | ".join(cells) + " |")
    lines.append("")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Fleet bundles: many machines in one artifact
# ---------------------------------------------------------------------------


def fleet_to_dict(profiles: Sequence[MachineProfile]) -> Dict[str, Any]:
    return {
        "fleet_schema_version": FLEET_SCHEMA_VERSION,
        "profiles": {p.fingerprint.id: p.to_dict() for p in profiles},
    }


def load_profiles_any(path) -> List[MachineProfile]:
    """Load either a single machine-profile JSON or a fleet bundle."""
    path = Path(path)
    try:
        payload = json.loads(path.read_text())
    except OSError as e:
        raise StudyError(f"cannot read {path}: {e}") from e
    except ValueError as e:
        raise StudyError(f"{path} is not valid JSON ({e})") from e
    if isinstance(payload, dict) and "profiles" in payload:
        version = payload.get("fleet_schema_version")
        if version != FLEET_SCHEMA_VERSION:
            raise StudyError(
                f"unsupported fleet schema version {version!r} in {path}")
        try:
            return [MachineProfile.from_dict(d)
                    for d in dict(payload["profiles"]).values()]
        except (ProfileError, TypeError, ValueError) as e:
            raise StudyError(f"malformed fleet bundle {path}: {e}") from e
    return [load_profile(path)]


def merge_any(profiles: Sequence[MachineProfile], *,
              allow_cross_machine: bool = False) -> List[MachineProfile]:
    """Merge a collection of profiles: same-fingerprint profiles merge
    fit by fit (:func:`~repro_torch.profiles.profile.merge_profiles`;
    conflicts raise :class:`ProfileError`); distinct fingerprints are
    legal only with ``allow_cross_machine`` (a fleet bundle), since one
    machine profile must never mix measurements of different hardware."""
    by_fp: Dict[str, List[MachineProfile]] = {}
    for p in profiles:
        by_fp.setdefault(p.fingerprint.id, []).append(p)
    if len(by_fp) > 1 and not allow_cross_machine:
        raise ProfileError(
            f"refusing to merge profiles from different machines "
            f"{sorted(by_fp)} into one profile; pass --fleet to build a "
            f"cross-machine fleet bundle instead")
    return [group[0] if len(group) == 1 else merge_profiles(group)
            for _, group in sorted(by_fp.items())]
