"""Family validator: check declared ``FamilySpec`` degrees against actual
symbolic counts by exact finite differencing — before a wrong declaration
poisons the count store.  The counterpart of ``repro.analysis.families``,
over the port's :class:`~repro_torch.core.uipick.FamilySpec`.

A generator declaring ``FamilySpec(var_degrees={"n": d})`` promises that
every feature count of its kernels is a polynomial of degree ≤ d in ``n``
(on the probe lattice ``base + scale·i``).  The count engine trusts that
promise: it probes d+1 lattice points, interpolates, and serves the
polynomial for EVERY size forever.  If the true degree is d+1 the
interpolant is silently wrong at every non-probe size; if the dependence
is not polynomial at all (``isqrt`` shapes, ``log`` factors) it is wrong
almost everywhere.

Polynomials make this checkable exactly: over the lattice, the (d+1)-th
forward difference of a degree-≤ d polynomial is identically zero, and
the (d+1)-th difference of a degree-(d+1) polynomial is a nonzero
constant.  Probing d+3 lattice points per variable (others held at the
lattice base) distinguishes three outcomes per feature:

* Δ^{d+1} ≡ 0                      — declaration holds;
* Δ^{d+1} nonzero constant         — true degree is d+1:
  ``family-degree-mismatch`` (error);
* Δ^{d+1} non-constant             — degree ≥ d+2 or non-polynomial:
  ``family-non-polynomial`` (error).

If EVERY feature has Δ^{d} ≡ 0 the declaration is merely wasteful
(``family-degree-overdeclared``, info): the engine probes more points
than reconstruction needs.

Probes run through :func:`repro_torch.analysis.scope.abstract_args` and
:func:`~repro_torch.core.counting.count_fn` (fake tensors), so validation
never executes a kernel and never allocates device memory.

The probe-lattice divisibility check (``probe-lattice-divisibility``,
warning) flags argument-space size values with ``size % scale != 0`` —
the same condition :class:`repro_torch.core.uipick.LatticeAssumptionWarning`
warns about at generation time, surfaced statically here.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.scope import abstract_args
from repro_torch.core.counting import FeatureCounts, count_fn
from repro_torch.core.uipick import Generator, KernelFamily, _SkipVariant

#: differences at or below this fraction of the feature's magnitude read
#: as zero — counts are float64-exact for every built-in family, but
#: log-factor features (sort) accumulate genuine float noise
_REL_TOL = 1e-9


def iter_families(gen: Generator, *, all_combos: bool = False):
    """Yield ``(family, fixed)`` per distinct buildable fixed-argument
    combination (argument-space order).  By default only the FIRST one —
    a single representative per generator, historically enough because
    the kernel body is the same callable for every fixed combo.  With
    ``all_combos`` the sweep covers EVERY distinct fixed combination:
    per-combo probe geometry (tile shapes, access patterns) can change
    which features exist and at what degree, and a degree lie confined
    to a non-first combo is invisible to the representative audit."""
    if gen.family is None:
        return
    names = sorted(gen.arg_space)
    seen: set = set()
    for combo in itertools.product(*(gen.arg_space[n] for n in names)):
        kw = dict(zip(names, combo))
        fixed = {a: v for a, v in kw.items()
                 if a not in gen.family.var_degrees}
        key = tuple(sorted(fixed.items()))
        if key in seen:
            continue
        try:
            gen.build(**kw)     # builders raise _SkipVariant eagerly
        except _SkipVariant:
            continue
        fam = gen._family_of(kw)
        if fam is None:
            continue
        seen.add(key)
        yield fam, fixed
        if not all_combos:
            return


def _first_family(gen: Generator
                  ) -> Tuple[Optional[KernelFamily], Dict[str, Any]]:
    """The generator's family at its first buildable fixed-argument
    combo, plus that combo's fixed (non-size) arguments."""
    for fam, fixed in iter_families(gen):
        return fam, fixed
    return None, {}


def _diffs(y: np.ndarray, order: int) -> np.ndarray:
    d = np.asarray(y, np.float64)
    for _ in range(order):
        d = d[1:] - d[:-1]
    return d


def _is_zero(d: np.ndarray, magnitude: float) -> bool:
    return bool(np.all(np.abs(d) <= _REL_TOL * max(magnitude, 1.0)))


def validate_family(gen: Generator,
                    *, stats: Optional[Dict[str, int]] = None,
                    all_combos: bool = False) -> List[Diagnostic]:
    """Degree-check one generator's family declaration (abstract probes
    only).  Emits nothing for generators without a ``FamilySpec``.
    With ``all_combos`` every distinct fixed-argument combination is
    audited (``repro_torch.lint --all-combos``); findings repeated verbatim
    across combos are reported once, for the first combo that surfaced
    them — ``details["fixed"]`` names the audited combo as always."""
    out: List[Diagnostic] = []
    seen: set = set()
    for fam, fixed in iter_families(gen, all_combos=all_combos):
        for d in _validate_at(gen, fam, fixed, stats=stats):
            key = (d.severity, d.code, d.location, d.message)
            if key not in seen:
                seen.add(key)
                out.append(d)
    return out


def _validate_at(gen: Generator, fam: KernelFamily, fixed: Dict[str, Any],
                 *, stats: Optional[Dict[str, int]] = None
                 ) -> List[Diagnostic]:
    """The degree check of one family member (one fixed-argument combo)."""
    loc = f"generator:{gen.name}"
    out: List[Diagnostic] = []
    base_sizes = {v: fam.base for v in fam.var_degrees}
    probed: Dict[tuple, FeatureCounts] = {}

    def probe(**sizes) -> FeatureCounts:
        key = tuple(sorted(sizes.items()))
        if key not in probed:
            kernel = fam.build(**sizes)
            probed[key] = count_fn(kernel.fn, *abstract_args(
                kernel.make_args))
            if stats is not None:
                stats["traces"] = stats.get("traces", 0) + 1
        return probed[key]

    any_at_degree = False
    for var in sorted(fam.var_degrees):
        d = int(fam.var_degrees[var])
        points = [fam.base + fam.scale * i for i in range(d + 3)]
        rows = [probe(**{**base_sizes, var: p}) for p in points]
        features = sorted({f for r in rows for f in r})
        for f in features:
            y = np.asarray([r[f] for r in rows], np.float64)
            mag = float(np.max(np.abs(y)))
            dd1 = _diffs(y, d + 1)
            if _is_zero(dd1, mag):
                if d > 0 and not _is_zero(_diffs(y, d), mag):
                    any_at_degree = True
                continue
            if _is_zero(_diffs(y, d + 2), mag):
                out.append(Diagnostic(
                    "error", "family-degree-mismatch", loc,
                    f"feature {f!r} grows with degree {d + 1} in {var!r} "
                    f"but the FamilySpec declares degree {d}: the "
                    f"interpolated count polynomial is wrong at every "
                    f"non-probe size",
                    details={"feature": f, "variable": var,
                             "declared_degree": d,
                             "actual_degree": d + 1, "fixed": fixed}))
            else:
                out.append(Diagnostic(
                    "error", "family-non-polynomial", loc,
                    f"feature {f!r} is not polynomial of degree ≤ {d + 1} "
                    f"in {var!r} on the probe lattice (non-constant "
                    f"Δ^{d + 1}): either the degree is under-declared by "
                    f"≥ 2 or the size dependence is not polynomial at all "
                    f"— this family must opt out via `applies`",
                    details={"feature": f, "variable": var,
                             "declared_degree": d,
                             "lattice": points, "fixed": fixed}))
            any_at_degree = True
    if not any_at_degree and max(fam.var_degrees.values(), default=0) > 0:
        out.append(Diagnostic(
            "info", "family-degree-overdeclared", loc,
            f"at the audited fixed-argument combination "
            f"({fixed or '{}'}) no feature reaches the declared degree "
            f"in any size variable ({dict(fam.var_degrees)}): that "
            f"family member pays more probe traces than its counts need",
            details={"declared": {k: int(v)
                                  for k, v in fam.var_degrees.items()},
                     "fixed": fixed}))
    return out


def check_lattice(gen: Generator) -> List[Diagnostic]:
    """Static probe-lattice divisibility audit of one generator's argument
    space (the declared sizes a user can request by tag)."""
    fam, _fixed = _first_family(gen)
    if fam is None or fam.scale <= 1:
        return []
    out: List[Diagnostic] = []
    for var in sorted(fam.var_degrees):
        allowed = gen.arg_space.get(var, ())
        bad = [int(v) for v in allowed
               if isinstance(v, int) and v % fam.scale]
        if bad:
            out.append(Diagnostic(
                "warning", "probe-lattice-divisibility",
                f"generator:{gen.name}",
                f"argument-space sizes {var}={bad} violate the family's "
                f"probe-lattice assumption {var} % {fam.scale} == 0: the "
                f"count polynomial extrapolates off the verified lattice "
                f"at those sizes",
                details={"variable": var, "sizes": bad,
                         "scale": int(fam.scale)}))
    return out
