"""A minimal polynomial CAS for parametric operation counts — the port's
own copy of ``repro.core.symbolic`` (pure numpy and ``fractions``).

The paper produces *piecewise quasi-polynomial* counts (Barvinok) that are
parametric in problem size, so the (expensive) counting runs once and
re-evaluates cheaply as sizes change.  The port counts at concrete
shapes (fake tensors), so the polynomial dependence is reconstructed by
exact Lagrange interpolation over a handful of probe sizes (counts of
static-control programs are polynomial in each size parameter).
Divisibility conditions ("n % 16 == 0") are carried as *assumptions*,
mirroring ``lp.assume``.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np

Number = Union[int, float, Fraction]

# monomial: tuple of (var, exponent) sorted by var
Monomial = Tuple[Tuple[str, int], ...]


def _mono_mul(a: Monomial, b: Monomial) -> Monomial:
    d: Dict[str, int] = {}
    for v, e in a + b:
        d[v] = d.get(v, 0) + e
    return tuple(sorted((v, e) for v, e in d.items() if e))


class Poly:
    """Multivariate polynomial with Fraction coefficients."""

    __slots__ = ("terms",)

    def __init__(self, terms: Mapping[Monomial, Number] | None = None):
        self.terms: Dict[Monomial, Fraction] = {}
        for m, c in (terms or {}).items():
            c = Fraction(c) if not isinstance(c, float) else Fraction(c).limit_denominator(10**9)
            if c:
                self.terms[m] = self.terms.get(m, Fraction(0)) + c
        self.terms = {m: c for m, c in self.terms.items() if c}

    # -- constructors -----------------------------------------------------
    @staticmethod
    def const(c: Number) -> "Poly":
        return Poly({(): c})

    @staticmethod
    def var(name: str) -> "Poly":
        return Poly({((name, 1),): 1})

    @staticmethod
    def lift(x: Union["Poly", Number]) -> "Poly":
        return x if isinstance(x, Poly) else Poly.const(x)

    # -- arithmetic --------------------------------------------------------
    def __add__(self, other):
        other = Poly.lift(other)
        t = dict(self.terms)
        for m, c in other.terms.items():
            t[m] = t.get(m, Fraction(0)) + c
        return Poly(t)

    __radd__ = __add__

    def __neg__(self):
        return Poly({m: -c for m, c in self.terms.items()})

    def __sub__(self, other):
        return self + (-Poly.lift(other))

    def __rsub__(self, other):
        return Poly.lift(other) + (-self)

    def __mul__(self, other):
        other = Poly.lift(other)
        t: Dict[Monomial, Fraction] = {}
        for m1, c1 in self.terms.items():
            for m2, c2 in other.terms.items():
                m = _mono_mul(m1, m2)
                t[m] = t.get(m, Fraction(0)) + c1 * c2
        return Poly(t)

    __rmul__ = __mul__

    def __pow__(self, k: int):
        out = Poly.const(1)
        for _ in range(k):
            out = out * self
        return out

    def __eq__(self, other):
        return self.terms == Poly.lift(other).terms

    def __hash__(self):
        return hash(tuple(sorted(self.terms.items())))

    # -- evaluation ---------------------------------------------------------
    def subs(self, env: Mapping[str, Number]) -> Union["Poly", float]:
        t: Dict[Monomial, Fraction] = {}
        for m, c in self.terms.items():
            coef = c
            rem: List[Tuple[str, int]] = []
            for v, e in m:
                if v in env:
                    coef *= Fraction(env[v]) ** e
                else:
                    rem.append((v, e))
            mm = tuple(rem)
            t[mm] = t.get(mm, Fraction(0)) + coef
        out = Poly(t)
        if not out.free_vars():
            return float(out.terms.get((), Fraction(0)))
        return out

    def __call__(self, **env) -> float:
        v = self.subs(env)
        assert isinstance(v, float), f"unbound vars {self.free_vars()}"
        return v

    def eval_batch(self, **env) -> np.ndarray:
        """Vectorized evaluation over numpy arrays of variable values.

        ``env`` maps every free variable to an array (or scalar); arrays
        broadcast against each other and the result is a float64 array of
        the broadcast shape.  Evaluation is multivariate Horner — terms
        are grouped by the leading variable's exponent and folded as
        ``acc·x + lower`` — so a degree-d polynomial over an N-point sweep
        costs O(d·N) flat numpy ops, no per-point Python.  This is the
        kernel of the count engine's amortization: one symbolic
        reconstruction, then whole size sweeps in microseconds.
        """
        free = self.free_vars()
        missing = free - set(env)
        if missing:
            raise ValueError(f"eval_batch: unbound variable(s) "
                             f"{sorted(missing)}")
        # every provided grid participates in the broadcast shape, so a
        # constant (or lower-arity) polynomial still returns one value per
        # sweep point — callers build count matrices from mixed-degree
        # feature polynomials over a single sizes env
        arrs = {v: np.asarray(env[v], np.float64) for v in env}
        shape = np.broadcast_shapes(*(a.shape for a in arrs.values())) \
            if arrs else ()
        names = sorted(free)

        def horner(terms: Dict[Monomial, Fraction],
                   rest: List[str]) -> np.ndarray:
            if not rest:
                return np.full(shape, float(terms.get((), Fraction(0))))
            v, tail = rest[0], rest[1:]
            by_exp: Dict[int, Dict[Monomial, Fraction]] = {}
            for m, c in terms.items():
                e = next((ee for name, ee in m if name == v), 0)
                mm = tuple((name, ee) for name, ee in m if name != v)
                by_exp.setdefault(e, {})[mm] = c
            x = arrs[v]
            acc = horner(by_exp[max(by_exp)], tail)
            for e in range(max(by_exp) - 1, -1, -1):
                acc = acc * x
                if e in by_exp:
                    acc = acc + horner(by_exp[e], tail)
            return acc

        return horner(self.terms, names) if self.terms \
            else np.zeros(shape)

    def free_vars(self) -> set:
        return {v for m in self.terms for v, _ in m}

    def degree(self, var: str) -> int:
        return max((e for m in self.terms for v, e in m if v == var),
                   default=0)

    def __repr__(self):
        if not self.terms:
            return "0"
        parts = []
        for m, c in sorted(self.terms.items(), key=lambda kv: (-len(kv[0]), kv[0])):
            mono = "*".join(f"{v}^{e}" if e > 1 else v for v, e in m)
            cs = str(c) if c.denominator != 1 else str(c.numerator)
            parts.append(f"{cs}*{mono}" if mono else cs)
        return " + ".join(parts)


@dataclass(frozen=True)
class ParametricCount:
    """A polynomial count plus the assumptions it was derived under."""

    poly: Poly
    assumptions: Tuple[str, ...] = ()

    def __call__(self, **env) -> float:
        return self.poly(**env)

    def eval_batch(self, **env) -> np.ndarray:
        """Vectorized :meth:`Poly.eval_batch` over the carried polynomial
        (variables the polynomial doesn't use still shape the broadcast,
        so one sizes env drives every feature polynomial of a family)."""
        return self.poly.eval_batch(**env)


def interpolate_polynomial(
    f: Callable[..., float],
    var_degrees: Mapping[str, int],
    *,
    base: int = 16,
    scale: int = 16,
) -> Poly:
    """Reconstruct a polynomial ``f`` exactly from probe evaluations.

    ``f(**sizes) -> count`` is evaluated on a tensor grid of
    ``degree+1`` distinct probe values per variable (multiples of ``scale``
    so divisibility assumptions hold), then fit by iterated Newton/Lagrange
    interpolation.  Exact (up to Fraction arithmetic) when ``f`` is a
    polynomial of the declared degrees — which operation counts of
    static-control programs are.
    """
    names = sorted(var_degrees)
    grids = {v: [base + scale * i for i in range(var_degrees[v] + 1)]
             for v in names}

    def fit_1d(xs: Sequence[int], ys: Sequence[Poly]) -> Poly:
        # Lagrange interpolation with Poly-valued ordinates
        x = Poly.var("_x_")
        out = Poly.const(0)
        for i, (xi, yi) in enumerate(zip(xs, ys)):
            li = Poly.const(1)
            denom = Fraction(1)
            for j, xj in enumerate(xs):
                if i == j:
                    continue
                li = li * (x - xj)
                denom *= Fraction(xi - xj)
            out = out + yi * li * Poly.const(Fraction(1, 1) / denom)
        return out

    def rec(fixed: Dict[str, int], rest: List[str]) -> Poly:
        if not rest:
            return Poly.const(Fraction(f(**fixed)).limit_denominator(1))
        v, tail = rest[0], rest[1:]
        ys = []
        for pv in grids[v]:
            ys.append(rec({**fixed, v: pv}, tail))
        p = fit_1d(grids[v], ys)
        # rename the interpolation variable _x_ → v
        t: Dict[Monomial, Fraction] = {}
        for m, c in p.terms.items():
            mm = tuple(sorted((v if name == "_x_" else name, e)
                              for name, e in m))
            t[mm] = t.get(mm, Fraction(0)) + c
        return Poly(t)

    return rec({}, names)
