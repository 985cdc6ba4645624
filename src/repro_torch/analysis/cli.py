"""``python -m repro_torch.lint`` — the modelability auditor's command
line, the counterpart of ``repro.analysis.cli``.

One run, zero executions: every check below works on fake tensors
(:mod:`repro_torch.analysis.scope`, ``count_fn``) or pure reflection, so
linting an entire kernel zoo costs a few dozen fake-tensor runs and not
one device kernel, not one timing.  The report's ``stats`` line says
exactly that (``timings=0 traces=N``).

Default scope (no arguments):

* every registered UIPiCK generator — aten-level scope audit of a
  representative variant, family-degree validation by finite
  differencing, probe-lattice divisibility, cache-signature hazards;
* every model-zoo rung — identifiability analysis against the smoke
  study battery's counts.

``--kernels`` adds the eight hand-kernel wrappers
(:mod:`repro_torch.analysis.targets`); positional arguments name extra
target modules (dotted import path or a ``.py`` file) exposing
``LINT_TARGETS`` (an iterable) or ``lint_targets()`` — items need
``name`` + ``fn`` plus either already-abstract ``args`` (``meta`` or
fake tensors) or a ``make_args(device)`` builder
(``repro_torch.core.uipick.MeasurementKernel`` and
``repro_torch.core.variantselect.Variant`` both qualify as-is).

The port's own baseline is ``torch_lint_baseline.json`` at the root of
the repository.

``--all-combos`` widens the default generator audit from the first
buildable variant to every distinct fixed-argument combination (scope +
family sweeps; findings deduplicated, ``details["fixed"]`` names the
audited combo).

Exit status is 1 when error-severity diagnostics appear that are not in
the ``--baseline`` file (CI mode: adopt today's findings once with
``--write-baseline``, fail only on regressions), 0 otherwise.  Baselined
errors that NO LONGER occur are reported as stale (``stale_baseline`` in
the JSON payload) and can be dropped from the file with
``--prune-baseline`` — a stale entry would otherwise mask the next
regression at the same ``code@location``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import itertools
import json
import sys
import warnings
from pathlib import Path
from typing import Any, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.diagnostics import (
    BASELINE_VERSION,
    AnalysisError,
    Diagnostic,
    DiagnosticReport,
    load_baseline,
    save_baseline,
)
from repro_torch.analysis.families import check_lattice, validate_family
from repro_torch.analysis.identifiability import analyze_model
from repro_torch.analysis.scope import abstract_args, audit_callable
from repro_torch.analysis.sighazards import audit_signature
from repro_torch.core.counting import count_fn
from repro_torch.core.uipick import (
    ALL_GENERATORS,
    Generator,
    KernelCollection,
    LatticeAssumptionWarning,
    MatchCondition,
    _SkipVariant,
)
from repro_torch.studies.zoo import MODEL_ZOO, STUDY_SMOKE_TAGS


def _first_kernel(gen: Generator):
    """The generator's first buildable variant (argument-space order) —
    the representative its kernel body is scope-audited at."""
    names = sorted(gen.arg_space)
    for combo in itertools.product(*(gen.arg_space[n] for n in names)):
        try:
            return gen.build(**dict(zip(names, combo)))
        except _SkipVariant:
            continue
    return None


def _scope_kernels(gen: Generator, all_combos: bool
                   ) -> List[Tuple[Any, Optional[dict]]]:
    """Kernels to scope-audit: the first buildable variant by default, or
    one representative per distinct fixed-argument combination under
    ``--all-combos`` (non-size arguments select different kernel bodies —
    variant/pattern/dtype switches the single-representative audit never
    sees)."""
    if not all_combos:
        kernel = _first_kernel(gen)
        return [(kernel, None)] if kernel is not None else []
    names = sorted(gen.arg_space)
    var_names = set(gen.family.var_degrees) if gen.family else set()
    seen, out = set(), []
    for combo in itertools.product(*(gen.arg_space[n] for n in names)):
        kw = dict(zip(names, combo))
        fixed = {a: v for a, v in kw.items() if a not in var_names}
        key = tuple(sorted(fixed.items()))
        if key in seen:
            continue
        try:
            kernel = gen.build(**kw)
        except _SkipVariant:
            continue
        seen.add(key)
        out.append((kernel, fixed))
    return out


def audit_generators(report: DiagnosticReport,
                     generators: Sequence[Generator] = tuple(ALL_GENERATORS),
                     *, all_combos: bool = False) -> None:
    """Scope + family + lattice + signature audits of UIPiCK generators.

    ``all_combos`` sweeps every distinct fixed-argument combination per
    generator instead of the first buildable one; findings repeated
    verbatim across combos appear once, with ``details["fixed"]`` naming
    the combo that first surfaced them."""
    for gen in generators:
        loc = f"generator:{gen.name}"
        kernels = _scope_kernels(gen, all_combos)
        if not kernels:
            report.extend([Diagnostic(
                "error", "untraceable-kernel", loc,
                "no argument-space combination builds a kernel")])
            continue
        seen: set = set()
        for kernel, fixed in kernels:
            diags = list(audit_callable(
                kernel.fn, abstract_args(kernel.make_args), loc,
                stats=report.stats))
            diags.extend(audit_signature(kernel.fn, loc))
            for d in diags:
                key = (d.severity, d.code, d.location, d.message)
                if key in seen:
                    continue
                seen.add(key)
                if fixed is not None and "fixed" not in d.details:
                    d = dataclasses.replace(
                        d, details={**dict(d.details), "fixed": fixed})
                report.extend([d])
        report.extend(validate_family(gen, stats=report.stats,
                                      all_combos=all_combos))
        report.extend(check_lattice(gen))


def audit_zoo(report: DiagnosticReport,
              tags: Sequence[str] = tuple(STUDY_SMOKE_TAGS)) -> None:
    """Identifiability of every zoo rung against the battery the given
    tags generate — counted on fake tensors, nothing timed."""
    kernels = KernelCollection(ALL_GENERATORS).generate_kernels(
        list(tags), MatchCondition.INTERSECT)
    rows = []
    for k in kernels:
        rows.append(count_fn(k.fn, *abstract_args(k.make_args)))
        report.stats["traces"] = report.stats.get("traces", 0) + 1
    battery = ",".join(sorted(t for t in tags if ":" not in t))
    for entry in MODEL_ZOO:
        model = entry.model()
        F = model.align(rows, missing="zero")
        report.extend(analyze_model(
            model, F, f"model:{entry.name}[{battery}]"))


def audit_targets(report: DiagnosticReport, targets: Iterable[Any]) -> None:
    """Scope + signature audits of adapted kernel targets."""
    for t in targets:
        name = getattr(t, "name", None) or getattr(
            getattr(t, "fn", t), "__name__", repr(t))
        loc = f"kernel:{name}"
        fn = getattr(t, "fn", None)
        if fn is None and callable(t):
            fn = t
        if fn is None:
            report.extend([Diagnostic(
                "error", "untraceable-kernel", loc,
                f"target {name!r} has no callable `fn`")])
            continue
        if getattr(t, "args", None) is not None:
            args = tuple(t.args)
        elif getattr(t, "make_args", None) is not None:
            args = abstract_args(t.make_args)
        else:
            args = ()
        report.extend(audit_callable(fn, args, loc, stats=report.stats))
        report.extend(audit_signature(fn, loc))


def _load_module(spec: str):
    p = Path(spec)
    if spec.endswith(".py") or p.exists():
        modspec = importlib.util.spec_from_file_location(
            p.stem.replace("-", "_"), p)
        if modspec is None or modspec.loader is None:
            raise AnalysisError(f"cannot load lint-target file {spec!r}")
        mod = importlib.util.module_from_spec(modspec)
        try:
            modspec.loader.exec_module(mod)
        except Exception as e:      # noqa: BLE001
            raise AnalysisError(
                f"lint-target file {spec!r} failed to import: "
                f"{type(e).__name__}: {e}") from e
        return mod
    try:
        return importlib.import_module(spec)
    except ImportError as e:
        raise AnalysisError(
            f"cannot import lint-target module {spec!r}: {e}") from e


def _module_targets(mod) -> List[Any]:
    if hasattr(mod, "LINT_TARGETS"):
        return list(mod.LINT_TARGETS)
    if hasattr(mod, "lint_targets"):
        return list(mod.lint_targets())
    raise AnalysisError(
        f"module {mod.__name__!r} exposes neither LINT_TARGETS nor "
        f"lint_targets()")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Static modelability audit: lint kernels, count "
                    "families, and model zoos without executing or "
                    "timing a single kernel.")
    ap.add_argument("targets", nargs="*",
                    help="extra target modules (dotted path or .py file) "
                         "exposing LINT_TARGETS or lint_targets()")
    ap.add_argument("--kernels", action="store_true",
                    help="also audit the eight hand-kernel wrappers "
                         "(repro_torch.kernels.ops)")
    ap.add_argument("--no-default", action="store_true",
                    help="skip the default generator + model-zoo audits")
    ap.add_argument("--all-combos", action="store_true",
                    help="audit every distinct fixed-argument combination "
                         "per generator (scope + family), not just the "
                         "first buildable one; repeated findings are "
                         "deduplicated, details name the audited combo")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as deterministic JSON")
    ap.add_argument("--baseline", metavar="PATH",
                    help="known-errors baseline file; exit 1 only on "
                         "errors NOT listed in it (stale entries — "
                         "baselined errors that no longer occur — are "
                         "warned about)")
    ap.add_argument("--write-baseline", metavar="PATH",
                    help="write the current error set as the new "
                         "baseline and exit 0")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="with --baseline: rewrite the baseline file "
                         "dropping stale entries (baselined errors that "
                         "no longer occur)")
    ap.add_argument("--suppress", action="append", default=[],
                    metavar="CODE[@LOCATION]",
                    help="suppress diagnostics by code or code@location "
                         "(repeatable); suppressed findings stay in the "
                         "JSON artifact but never fail the run")
    return ap


def run_lint(args: argparse.Namespace) -> int:
    report = DiagnosticReport(stats={"timings": 0, "traces": 0})
    with warnings.catch_warnings():
        # generation-time lattice warnings are the runtime twin of the
        # probe-lattice-divisibility diagnostic; the linter reports the
        # static version and keeps its own output deterministic
        warnings.simplefilter("ignore", LatticeAssumptionWarning)
        if not args.no_default:
            audit_generators(report, all_combos=args.all_combos)
            audit_zoo(report)
        if args.kernels:
            from repro_torch.analysis.targets import kernel_targets
            audit_targets(report, kernel_targets())
        for spec in args.targets:
            audit_targets(report, _module_targets(_load_module(spec)))
    report = report.suppress(args.suppress)

    if args.write_baseline:
        save_baseline(report, args.write_baseline)
        print(f"wrote baseline with {len(report.baseline_keys())} "
              f"error key(s) to {args.write_baseline}")
        return 0

    if args.prune_baseline and not args.baseline:
        raise AnalysisError("--prune-baseline requires --baseline")
    baseline = load_baseline(args.baseline) if args.baseline else []
    new = report.new_errors(baseline)
    # stale entries: baselined identities that no longer occur (not even
    # suppressed) — silently accepting them would let the baseline mask a
    # future regression under the same code@location
    current = {d.key for d in report.errors} \
        | {d.key for d in report.suppressed if d.severity == "error"}
    stale = sorted(k for k in baseline if k not in current)
    if stale and args.prune_baseline:
        kept = sorted(k for k in baseline if k in current)
        Path(args.baseline).write_text(
            json.dumps({"version": BASELINE_VERSION, "errors": kept},
                       indent=2, sort_keys=True) + "\n")
    if args.json:
        payload = report.to_json_dict()
        payload["new_errors"] = sorted(d.key for d in new)
        if args.baseline:
            payload["stale_baseline"] = stale
            payload["pruned_baseline"] = bool(stale and args.prune_baseline)
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        print(report.render())
        if args.baseline:
            print(f"{len(new)} new error(s) vs baseline {args.baseline}")
            for key in stale:
                print(f"warning: baseline entry {key} no longer occurs"
                      + (" (pruned)" if args.prune_baseline else
                         " — prune with --prune-baseline"))
    return 1 if new else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return run_lint(args)
    except AnalysisError as e:
        print(f"repro_torch.lint: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
