"""``python -m repro_torch.calibrate`` — the once-per-machine calibration
CLI; the counterpart of ``repro.profiles.cli``.

Default command: UIPiCK filter tags → measurement kernels → feature
table (counted on ``meta`` tensors through the count engine, timed on
``--device``, both through the content-addressed measurement cache of
``--cache-dir``) → Levenberg-Marquardt fit → atomic profile save.  A warm
rerun with the same cache directory performs zero timings and zero
counting passes and writes a byte-identical profile;
``--expect-zero-timings`` turns that into an exit code.  ``--zoo`` fits
the whole model-zoo scope ladder over one battery with a held-out split
(the cross-machine study artifact); ``--synthetic`` calibrates a
synthetic ground-truth device instead of real hardware.

Subcommands:

    predict  profile + kernels (UIPiCK ``--tags`` and/or built-in
             ``--kernel`` targets) → runtime predictions with the
             cost-explanatory breakdown; zero kernel timings
    compare  ≥2 study profiles (or fleet bundles) → per-model ×
             per-variant held-out relative-error report (markdown +
             JSON); ``--sweep`` adds the per-zoo-rank accuracy/scope curve
    merge    same-machine profiles → one profile (union of fits;
             conflicts are errors); with --fleet, cross-machine → fleet
             bundle
    gc       evict measurement-cache entries (other device, other schema,
             corrupt, or older than --max-age); --counts also sweeps the
             count store

Examples::

    # the default battery on the card, 8 trials per kernel, cached
    python -m repro_torch.calibrate --out machine_profile.json \\
        --cache-dir ~/.cache/repro-torch-measurements

    # price the hand kernels from it, without running them
    python -m repro_torch.calibrate predict machine_profile.json \\
        --kernel kernels.ops.matmul --kernel kernels.ops.stream_strided \\
        --explain 3 --expect-zero-timings

    # the zoo study on the card and on a synthetic device, compared
    python -m repro_torch.calibrate --zoo --out h100.json
    python -m repro_torch.calibrate --zoo --synthetic apex --out apex.json
    python -m repro_torch.calibrate compare h100.json apex.json --sweep
    python -m repro_torch.calibrate predict h100.json --model lin_flop \\
        --kernel kernels.ops.madd_throughput
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.core.calibrate import fit_model
from repro_torch.core.countengine import CountEngine
from repro_torch.core.model import Model
from repro_torch.core.uipick import (
    ALL_GENERATORS,
    CountingTimer,
    KernelCollection,
    MatchCondition,
    default_timer,
    gather_feature_table,
)
from repro_torch.device import resolve_device
from repro_torch.profiles.cache import MeasurementCache
from repro_torch.profiles.fingerprint import DeviceFingerprint
from repro_torch.profiles.presets import (
    BASE_MODEL_EXPR,
    CALIBRATION_TAGS,
    DEFAULT_OUTPUT_FEATURE,
    SMOKE_MODEL_EXPR,
    SMOKE_TAGS,
)
from repro_torch.profiles.profile import (
    MachineProfile,
    ModelFit,
    ProfileError,
    save_profile,
)

_MATCH = {c.name.lower(): c for c in MatchCondition}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calibrate",
        description="Calibrate this machine's black-box cost model and "
                    "save a reusable profile.  Subcommands: predict, "
                    "compare, merge, gc (see module docstring).")
    ap.add_argument("--out", default="machine_profile.json",
                    help="profile JSON destination (atomic write)")
    ap.add_argument("--cache-dir", default=None,
                    help="content-addressed measurement cache directory; "
                         "warm reruns perform zero timings and zero "
                         "counting passes")
    ap.add_argument("--tags", nargs="+", default=None,
                    help="UIPiCK filter tags (default: the full "
                         "calibration battery)")
    ap.add_argument("--match", choices=sorted(_MATCH), default="intersect",
                    help="generator tag match condition (paper §7.1)")
    ap.add_argument("--expr", default=None,
                    help="model expression to calibrate "
                         "(default: the base linear model)")
    ap.add_argument("--output-feature", default=DEFAULT_OUTPUT_FEATURE,
                    help="measured output feature id")
    ap.add_argument("--name", default="base",
                    help="name of the fit inside the profile")
    ap.add_argument("--trials", type=int, default=8,
                    help="timing trials per measurement kernel")
    ap.add_argument("--smoke", action="store_true",
                    help="use the tiny smoke battery + 2-parameter model")
    ap.add_argument("--zoo", action="store_true",
                    help="fit the whole model zoo over one battery with a "
                         "held-out split (cross-machine study artifact)")
    ap.add_argument("--holdout-fraction", type=float, default=0.25,
                    help="held-out fraction of the battery (with --zoo)")
    ap.add_argument("--synthetic", default=None, metavar="DEVICE",
                    help="calibrate a synthetic ground-truth device "
                         "(apex/bulk/citra) instead of real hardware")
    ap.add_argument("--synthetic-noise", type=float, default=0.0,
                    help="relative timing noise of the synthetic device")
    ap.add_argument("--expect-zero-timings", action="store_true",
                    help="exit 1 unless every kernel came from the cache "
                         "(no timing pass ran)")
    ap.add_argument("--retime-rel-std", type=float, default=None,
                    metavar="FRACTION",
                    help="re-time battery rows whose relative wall-clock "
                         "std exceeds this threshold (one extra pass; the "
                         "steadier one wins)")
    ap.add_argument("--force", action="store_true",
                    help="with --zoo: fit even when the static "
                         "identifiability analysis finds zoo rungs the "
                         "battery cannot determine")
    ap.add_argument("--device", default="cuda",
                    help="device to time the battery on (default cuda; "
                         "'cpu' times the host)")
    return ap


def _retime_line(args, retimed) -> None:
    if args.retime_rel_std is not None:
        print(f"[calibrate] retimed={len(retimed)} rows above "
              f"rel-std {args.retime_rel_std:g}"
              + (f": {sorted(retimed)}" if retimed else ""))


def _noise_line(table) -> str:
    s = table.noise_summary()
    if not s:
        return "wall-clock noise: n/a (no spread metadata)"
    return (f"wall-clock noise: max rel std {s['max_rel_std'] * 100:.2f}% "
            f"median {s['median_rel_std'] * 100:.2f}% "
            f"over {int(s['rows'])} rows")


def _calibrate(argv: Optional[List[str]]) -> int:
    args = build_parser().parse_args(argv)
    if args.synthetic:
        from repro_torch.testing.synthdev import fleet_device
        try:
            synth = fleet_device(args.synthetic, noise=args.synthetic_noise,
                                 output_feature=args.output_feature)
        except (KeyError, ValueError) as e:
            print(f"[calibrate] {e.args[0]}", file=sys.stderr)
            return 2
        fingerprint = synth.fingerprint
        # a synthetic device's counts are traced on meta tensors; nothing
        # runs on --device
        timer = CountingTimer(synth.timer)
    else:
        device = resolve_device(args.device)
        fingerprint = DeviceFingerprint.local(device)
        timer = CountingTimer(functools.partial(default_timer,
                                                device=device))
    cache = MeasurementCache(args.cache_dir, fingerprint) \
        if args.cache_dir else None
    # battery counts from kernel-family polynomials, persisted beside the
    # measurement cache
    engine = CountEngine(
        store=cache.count_store if cache is not None else None)

    if args.zoo:
        from repro_torch.studies import (
            MODEL_ZOO, STUDY_SMOKE_TAGS, STUDY_TAGS, StudyError, run_study,
        )
        tags = args.tags or (STUDY_SMOKE_TAGS if args.smoke else STUDY_TAGS)
        print(f"[calibrate] device={fingerprint.id} zoo="
              f"{[e.name for e in MODEL_ZOO]} trials={args.trials} "
              f"cache={args.cache_dir or 'off'}")
        try:
            profile = run_study(
                fingerprint=fingerprint, timer=timer, cache=cache,
                tags=tags, output_feature=args.output_feature,
                trials=args.trials,
                holdout_fraction=args.holdout_fraction,
                match=_MATCH[args.match],
                retime_rel_std=args.retime_rel_std, engine=engine,
                force=args.force)
        except StudyError as e:
            print(f"[calibrate] {e}", file=sys.stderr)
            return 2
        save_profile(profile, args.out)
        print(f"[calibrate] kernels={len(profile.kernel_names)} "
              f"held-out={len(profile.holdout)}")
        _retime_line(args, profile.retimed_rows)
        print(f"[calibrate] {_noise_line(profile.holdout)}")
        for name, mf in sorted(profile.fits.items()):
            print(f"[calibrate] fit {name}: residual="
                  f"{mf.fit.residual_norm:.6g} converged="
                  f"{mf.fit.converged} params={mf.params}")
    else:
        expr = args.expr or (SMOKE_MODEL_EXPR if args.smoke
                             else BASE_MODEL_EXPR)
        tags = args.tags or (SMOKE_TAGS if args.smoke else CALIBRATION_TAGS)
        model = Model(args.output_feature, expr)
        kernels = KernelCollection(ALL_GENERATORS).generate_kernels(
            tags, generator_match_cond=_MATCH[args.match])
        if not kernels:
            print(f"no measurement kernels match tags {tags!r}",
                  file=sys.stderr)
            return 2
        print(f"[calibrate] device={fingerprint.id} kernels={len(kernels)} "
              f"trials={args.trials} cache={args.cache_dir or 'off'}")
        table = gather_feature_table(model.all_features(), kernels,
                                     trials=args.trials, timer=timer,
                                     cache=cache,
                                     retime_rel_std=args.retime_rel_std,
                                     engine=engine)
        _retime_line(args, table.retimed_rows)
        fit = fit_model(model, table, nonneg=True)
        profile = MachineProfile(
            fingerprint=fingerprint,
            fits={args.name: ModelFit.from_fit(model, fit)},
            trials=args.trials,
            kernel_names=[k.name for k in kernels])
        save_profile(profile, args.out)
        print(f"[calibrate] {_noise_line(table)}")
        print(f"[calibrate] fit residual={fit.residual_norm:.6g} "
              f"converged={fit.converged} iterations={fit.iterations} "
              f"params={fit.params}")
    hits = cache.hits if cache is not None else 0
    print(f"[calibrate] timings_performed={timer.calls} cache_hits={hits}")
    print(f"[calibrate] count_traces={engine.trace_count} "
          f"count_hits={engine.hits}")
    print(f"[calibrate] profile -> {args.out}")
    if args.expect_zero_timings and timer.calls:
        print(f"[calibrate] FAIL: expected a fully warm cache but "
              f"{timer.calls} kernels were timed", file=sys.stderr)
        return 1
    return 0


def _cmd_predict(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calibrate predict",
        description="Predict (and explain) kernel runtimes from a saved "
                    "machine profile; features are counted on fake "
                    "tensors, so no kernel runs and none is timed.")
    ap.add_argument("profile", help="machine-profile JSON path")
    ap.add_argument("--tags", nargs="+", default=None,
                    help="UIPiCK filter tags selecting kernels to predict")
    ap.add_argument("--kernel", action="append", default=[],
                    metavar="NAME",
                    help="built-in hand-kernel target (repeatable; e.g. "
                         "kernels.ops.matmul — see "
                         "repro_torch.analysis.targets), priced by its "
                         "cost rule, never executed")
    ap.add_argument("--match", choices=sorted(_MATCH), default="intersect",
                    help="generator tag match condition")
    ap.add_argument("--model", default=None,
                    help="fit name inside the profile (default: "
                         "ovl_flop_mem, or the profile's only fit)")
    ap.add_argument("--cache-dir", default=None,
                    help="measurement cache; cached and stored counts "
                         "skip the counter")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write predictions (with breakdowns) as JSON")
    ap.add_argument("--explain", type=int, default=0, metavar="N",
                    help="print the top-N breakdown terms per kernel")
    ap.add_argument("--strict-scope", action="store_true",
                    help="error on kernels whose counted work the model "
                         "has no term for")
    ap.add_argument("--audit", action="store_true",
                    help="print the static modelability audit of the "
                         "selected kernels against the fit (scope gaps, "
                         "signature hazards, holdout identifiability) "
                         "before predicting — observability only, never "
                         "changes the exit code")
    ap.add_argument("--expect-zero-timings", action="store_true",
                    help="exit 1 if any kernel timing pass ran")
    ap.add_argument("--device", default="cuda",
                    help="this machine's device, reported beside the "
                         "profile's fingerprint (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.api import PerfSession, PredictionError
    local = DeviceFingerprint.local(args.device)
    try:
        session = PerfSession.open(args.profile, cache=args.cache_dir)
    except ProfileError as e:
        print(f"[predict] {e}", file=sys.stderr)
        return 3
    print(f"[predict] profile={session.profile.fingerprint.id} "
          f"local={local.id}")
    items: List = []
    names: List[str] = []
    if args.tags:
        kernels = KernelCollection(ALL_GENERATORS).generate_kernels(
            args.tags, generator_match_cond=_MATCH[args.match])
        if not kernels:
            print(f"[predict] no measurement kernels match tags "
                  f"{args.tags!r}", file=sys.stderr)
            return 2
        items.extend(kernels)
        names.extend(k.name for k in kernels)
    if args.kernel:
        from repro_torch.analysis.targets import kernel_targets
        targets = {t.name: t for t in kernel_targets()}
        for name in args.kernel:
            t = targets.get(name)
            if t is None:
                print(f"[predict] unknown --kernel {name!r}; built-in "
                      f"targets: {', '.join(sorted(targets))}",
                      file=sys.stderr)
                return 2
            items.append((t.fn, t.args))
            names.append(t.name)
    if not items:
        print("[predict] nothing to predict: pass --tags and/or --kernel",
              file=sys.stderr)
        return 2
    if args.audit:
        report = session.audit(items, model=args.model)
        for line in report.render().splitlines():
            print(f"[audit] {line}")
    try:
        preds = session.predict_batch(items, model=args.model, names=names,
                                      strict=args.strict_scope)
    except PredictionError as e:
        print(f"[predict] {e}", file=sys.stderr)
        return 3
    for p in preds:
        if args.explain:
            print(p.explain(top=args.explain))
        else:
            print(f"[predict] {p.kernel}: {p.seconds:.6g} s")
    if args.json_out:
        payload = {
            "fingerprint": session.profile.fingerprint.id,
            "model": preds[0].model,
            "predictions": [p.to_dict() for p in preds],
        }
        Path(args.json_out).write_text(
            json.dumps(payload, indent=2, sort_keys=True))
        print(f"[predict] json -> {args.json_out}")
    gmre = preds[0].diagnostics.get("holdout_gmre")
    print(f"[predict] kernels={len(preds)} model={preds[0].model} "
          f"held-out gmre="
          f"{'n/a' if gmre is None else f'{gmre * 100:.2f}%'}")
    print(f"[predict] timings_performed={session.timer.calls} "
          f"batched_evals={session.eval_calls} "
          f"count_traces={session.engine.trace_count} "
          f"count_hits={session.engine.hits}")
    if args.expect_zero_timings and session.timer.calls:
        print(f"[predict] FAIL: prediction must never time kernels but "
              f"{session.timer.calls} timing passes ran", file=sys.stderr)
        return 1
    return 0


def _cmd_compare(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calibrate compare",
        description="Cross-machine accuracy report from ≥2 study profiles "
                    "(per-model × per-kernel-variant held-out relative "
                    "error).")
    ap.add_argument("profiles", nargs="+",
                    help="machine-profile or fleet-bundle JSON paths")
    ap.add_argument("--report", default=None,
                    help="markdown report destination (default: stdout)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="JSON report destination")
    ap.add_argument("--sweep", action="store_true",
                    help="append the scope-vs-accuracy curve (held-out "
                         "gmre per zoo rank) to the report and JSON")
    args = ap.parse_args(argv)

    from repro_torch.studies import (
        StudyError,
        compare_profiles,
        load_profiles_any,
        scope_accuracy_sweep,
        sweep_to_markdown,
    )
    try:
        report = compare_profiles([p for path in args.profiles
                                   for p in load_profiles_any(path)])
    except (StudyError, ProfileError, ValueError) as e:
        # ValueError: malformed holdout data (zero outputs, missing
        # feature columns) surfaced by the accuracy evaluation
        print(f"[compare] {e}", file=sys.stderr)
        return 3
    md = report.to_markdown()
    sweep = None
    if args.sweep:
        sweep = scope_accuracy_sweep(report)
        md = md + "\n" + sweep_to_markdown(sweep)
    if args.report:
        Path(args.report).write_text(md)
        print(f"[compare] report -> {args.report}")
    else:
        print(md)
    if args.json_out:
        payload = report.to_json_dict()
        if sweep is not None:
            payload["sweep"] = sweep["sweep"]
        Path(args.json_out).write_text(
            json.dumps(payload, indent=2, sort_keys=True))
        print(f"[compare] json -> {args.json_out}")
    for fp in report.machines:
        summary = " ".join(f"{m}={report.summary[fp][m] * 100:.2f}%"
                           for m in report.model_names
                           if m in report.summary[fp])
        print(f"[compare] {fp}: {summary}")
    if sweep is not None:
        for row in sweep["sweep"]:
            rank = row["scope_rank"]
            fleet = row["fleet_gmre"]
            print(f"[compare] sweep rank="
                  f"{'-' if rank is None else rank} {row['model']} "
                  f"params={row['n_params']} fleet gmre="
                  f"{'n/a' if fleet is None else f'{fleet * 100:.2f}%'}")
    return 0


def _cmd_merge(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calibrate merge",
        description="Merge profiles.  Same machine: union of fits "
                    "(conflicts are errors).  Different machines: "
                    "requires --fleet, producing a fleet bundle.")
    ap.add_argument("profiles", nargs="+",
                    help="machine-profile or fleet-bundle JSON paths")
    ap.add_argument("--out", required=True, help="output JSON path")
    ap.add_argument("--fleet", action="store_true",
                    help="allow cross-machine inputs; write a fleet bundle")
    args = ap.parse_args(argv)

    from repro_torch.profiles.profile import atomic_write_json
    from repro_torch.studies import (
        StudyError, fleet_to_dict, load_profiles_any, merge_any,
    )
    try:
        profiles = [p for path in args.profiles
                    for p in load_profiles_any(path)]
        if len(profiles) < 2:
            print(f"[merge] need ≥ 2 profiles, got {len(profiles)}",
                  file=sys.stderr)
            return 3
        merged = merge_any(profiles, allow_cross_machine=args.fleet)
    except (StudyError, ProfileError, ValueError) as e:
        print(f"[merge] {e}", file=sys.stderr)
        return 3
    if args.fleet:
        atomic_write_json(Path(args.out), fleet_to_dict(merged))
        print(f"[merge] fleet bundle ({len(merged)} machines) -> "
              f"{args.out}")
    else:
        save_profile(merged[0], args.out)
        print(f"[merge] profile ({len(merged[0].fits)} fits) -> {args.out}")
    return 0


def _cmd_gc(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calibrate gc",
        description="Evict measurement-cache entries: corrupt files, "
                    "entries of another schema or device, entries older "
                    "than --max-age.")
    ap.add_argument("--cache-dir", required=True,
                    help="measurement cache directory to sweep")
    ap.add_argument("--max-age", type=float, default=None, metavar="SECONDS",
                    help="also drop entries older than this many seconds")
    ap.add_argument("--keep-foreign", action="store_true",
                    help="keep entries of other device fingerprints")
    ap.add_argument("--counts", action="store_true",
                    help="also sweep the count store (concrete counts and "
                         "symbolic family reconstructions) beside the "
                         "measurement cache")
    ap.add_argument("--device", default="cuda",
                    help="this machine's device, whose entries are kept "
                         "(default cuda)")
    args = ap.parse_args(argv)

    cache = MeasurementCache(args.cache_dir,
                             DeviceFingerprint.local(args.device))
    stats = cache.gc(max_age=args.max_age,
                     drop_foreign=not args.keep_foreign)
    print(f"[gc] kept={stats.kept} dropped_foreign={stats.dropped_foreign} "
          f"dropped_old={stats.dropped_old} "
          f"dropped_corrupt={stats.dropped_corrupt} "
          f"dropped_schema={stats.dropped_schema}")
    if args.counts:
        cstats = CountEngine(store=cache.count_store).gc(
            max_age=args.max_age)
        print(f"[gc] counts: kept={cstats.kept} "
              f"dropped_old={cstats.dropped_old} "
              f"dropped_corrupt={cstats.dropped_corrupt} "
              f"dropped_schema={cstats.dropped_schema}")
    return 0


_SUBCOMMANDS = {"predict": _cmd_predict, "compare": _cmd_compare,
                "merge": _cmd_merge, "gc": _cmd_gc}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _SUBCOMMANDS:
        return _SUBCOMMANDS[argv[0]](argv[1:])
    return _calibrate(argv)


if __name__ == "__main__":
    sys.exit(main())
