"""UIPiCK — parameterized measurement-kernel generators (paper §7.1) in
PyTorch — the counterpart of ``repro.core.uipick``.

Each generator owns a set of filter tags and an argument space; one
kernel is produced per element of the Cartesian product of allowed
values, filtered by the user's tags under one of the paper's four match
conditions.  Generator names, tags, argument spaces and kernel names are
the reference's, so the same tags select the same battery on both sides.

A :class:`MeasurementKernel` is an eager PyTorch callable plus an
argument builder ``make_args(device)``.  It is (a) *timed* on a device —
on the card as one captured CUDA graph replayed between CUDA events (one
dispatch per call, as the reference times one jitted executable),
``perf_counter`` around eager calls for CPU tensors — and (b)
*counted* by :mod:`repro_torch.core.counting` on ``meta`` arguments, so
counting allocates and runs nothing.

All ten of the reference's generators are here, in its order.  A
reference ``fori_loop``/``scan`` is a :func:`counted_loop` (or, for a
short loop over data, a :func:`counted_range`): one XLA loop there, one
or two kernel launches a step here, which a captured graph replays as
one node each.  ``FamilySpec`` (symbolic count families, the
declaration at :class:`FamilySpec`) and ``KernelFamily`` (one concrete
family riding on a measurement kernel, :class:`KernelFamily`) are
ported.
"""
from __future__ import annotations

import enum
import hashlib
import inspect
import itertools
import json
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.counting import (
    FeatureCounts,
    count_fn,
    counted_loop,
    counted_range,
)
from repro_torch.core.model import FeatureTable
from repro_torch.deprecation import warn_once
from repro_torch.device import DeviceLike, resolve_device


def source_signature(fn: Callable) -> str:
    """Cheap source-level identity of a callable: SHA-256 of its
    ``inspect.getsource`` text, truncated.  Computed once at generator
    registration — no tracing — so warm cache runs stay free, yet
    editing a generator's body changes the signature and invalidates its
    cached timings and counts.  Callables without retrievable source
    (REPL/exec) sign as ``""``."""
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError):
        return ""
    return hashlib.sha256(src.encode()).hexdigest()[:16]


class MatchCondition(enum.Enum):
    IDENTICAL = 1   # generator tag set == user tags
    SUBSET = 2      # generator tag set ⊆ user tags
    SUPERSET = 3    # generator tag set ⊇ user tags (paper default)
    INTERSECT = 4   # non-empty intersection


@dataclass(frozen=True)
class TimingStats:
    """One timing measurement: the median drives calibration, ``std`` and
    ``min`` are its noise metadata."""

    median: float
    std: Optional[float] = None
    min: Optional[float] = None

    @classmethod
    def coerce(cls, value: "TimerResult") -> "TimingStats":
        if isinstance(value, TimingStats):
            return value
        return cls(median=float(value))

    def to_dict(self) -> Dict[str, float]:
        d = {"median": float(self.median)}
        if self.std is not None:
            d["std"] = float(self.std)
        if self.min is not None:
            d["min"] = float(self.min)
        return d


TimerResult = Union[float, TimingStats]

#: how :meth:`MeasurementKernel.time_stats` times a call, by fingerprint
#: platform — part of every measurement-cache key, so a timing taken one
#: way is never served as one taken another way
TIMING_METHODS = {"gpu": "cuda-graph-replay-between-cuda-events",
                  "cpu": "eager-call-perf-counter"}


@dataclass(frozen=True)
class FamilySpec:
    """A generator's declaration that its kernels form a *symbolic family*:
    counts are polynomial in the declared size variables with the declared
    degrees, so the count engine rebuilds the family's
    :class:`~repro_torch.core.counting.SymbolicCounts` from a minimal
    probe grid once and evaluates a whole size sweep by vectorized
    polynomial evaluation.

    ``applies(**fixed)`` gates the declaration per fixed (non-size)
    argument combination; ``probe(**fixed)`` overrides the probe grid's
    ``(base, scale)`` (tile-aligned probes for blocked matmuls).
    """

    var_degrees: Mapping[str, int]
    base: int = 16
    scale: int = 16
    applies: Optional[Callable[..., bool]] = None
    probe: Optional[Callable[..., Tuple[int, int]]] = None


@dataclass
class KernelFamily:
    """One concrete symbolic family riding on a measurement kernel: a
    content-stable ``key`` (generator source signature + fixed args +
    degrees + probe geometry) and ``build(**sizes)`` rebuilding the family
    member at any probe size.  Kernels sharing a key share one
    reconstruction in the count engine."""

    key: str
    build: Callable[..., "MeasurementKernel"]
    var_degrees: Dict[str, int]
    base: int = 16
    scale: int = 16


@dataclass
class MeasurementKernel:
    name: str
    fn: Callable
    make_args: Callable[[DeviceLike], tuple]
    tags: Dict[str, Any]
    sizes: Dict[str, int] = field(default_factory=dict)
    # source-level identity of the generator body that built this kernel
    # (part of the measurement-cache and count-store keys); "" for
    # hand-built kernels
    code_sig: str = ""
    # the symbolic family this kernel belongs to (attached by
    # Generator.variants); None for hand-built kernels and argument
    # combinations a family's ``applies`` gate opts out
    family: Optional[KernelFamily] = None
    _counts: Optional[FeatureCounts] = None

    def counts(self) -> FeatureCounts:
        """Feature counts at this kernel's shapes (meta arguments: no
        allocation, no execution); computed once."""
        if self._counts is None:
            self._counts = count_fn(self.fn, *self.make_args("meta"))
        return self._counts

    def capture(self, args: tuple, *, warmup: int = 3
                ) -> Tuple["torch.cuda.CUDAGraph", Any]:
        """``self.fn(*args)`` on CUDA tensors, captured once into a CUDA
        graph after ``warmup`` eager calls on a side stream; returns the
        graph and the output it writes on each replay.  A kernel that
        cannot be captured raises, naming the kernel."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                self.fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with warnings.catch_warnings():
                # empty_kernel launches nothing: its graph is empty by design
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                with torch.cuda.graph(graph):
                    out = self.fn(*args)
        except RuntimeError as e:
            raise RuntimeError(
                f"measurement kernel {self.name!r} cannot be captured in a "
                f"CUDA graph, so it cannot be timed as one dispatch: "
                f"{e}") from e
        return graph, out

    def time_stats(self, *, trials: int = 20, warmup: int = 3,
                   device: DeviceLike = "cuda") -> TimingStats:
        """Seconds per call on ``device``, median/std/min over ``trials``
        calls after ``warmup`` calls.  On the card the kernel is captured
        once into a CUDA graph and each trial is one ``replay()`` between
        two CUDA events — one dispatch per call, as the reference times
        one jitted executable; the graph and its memory pool are released
        before returning."""
        dev = resolve_device(device)
        args = self.make_args(dev)
        ts = []
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                graph, out = self.capture(args, warmup=warmup)
                graph.replay()      # the first replay uploads the graph
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                for _ in range(trials):
                    start.record()
                    graph.replay()
                    end.record()
                    end.synchronize()
                    ts.append(start.elapsed_time(end) * 1e-3)
                del out
                graph.reset()
                del graph, args
                torch.cuda.empty_cache()
        else:
            for _ in range(warmup):
                self.fn(*args)
            for _ in range(trials):
                t0 = time.perf_counter()
                self.fn(*args)
                ts.append(time.perf_counter() - t0)
        return TimingStats(median=float(np.median(ts)),
                           std=float(np.std(ts)), min=float(np.min(ts)))


@dataclass
class Generator:
    name: str
    gen_tags: FrozenSet[str]
    arg_space: Dict[str, Tuple[Any, ...]]
    build: Callable[..., MeasurementKernel]
    code_sig: str = ""
    # symbolic-family declaration; None opts the generator out of
    # symbolic counting
    family: Optional[FamilySpec] = None

    def __post_init__(self):
        # signature of the builder source (which lexically contains the
        # kernel bodies it closes over), computed once
        if not self.code_sig:
            self.code_sig = source_signature(self.build)

    def _family_of(self, kw: Mapping[str, Any]) -> Optional[KernelFamily]:
        spec = self.family
        if spec is None:
            return None
        fixed = {a: v for a, v in kw.items() if a not in spec.var_degrees}
        if spec.applies is not None and not spec.applies(**fixed):
            return None
        base, scale = (spec.probe(**fixed) if spec.probe is not None
                       else (spec.base, spec.scale))
        key = json.dumps({
            "gen": self.name,
            "code": self.code_sig,
            "fixed": {a: repr(v) for a, v in sorted(fixed.items())},
            "degrees": {v: int(d) for v, d
                        in sorted(spec.var_degrees.items())},
            "base": int(base), "scale": int(scale),
        }, sort_keys=True)
        build = self.build

        def build_at(**sizes) -> MeasurementKernel:
            return build(**{**fixed, **sizes})

        return KernelFamily(key=key, build=build_at,
                            var_degrees=dict(spec.var_degrees),
                            base=int(base), scale=int(scale))

    def variants(self, constraints: Mapping[str, Tuple[Any, ...]]
                 ) -> Iterable[MeasurementKernel]:
        space = {}
        for arg, allowed in self.arg_space.items():
            if arg in constraints:
                chosen = tuple(v for v in constraints[arg] if v in allowed)
                if not chosen:
                    return  # constraint excludes this generator entirely
                space[arg] = chosen
            else:
                space[arg] = allowed
        names = sorted(space)
        families: Dict[Tuple, Optional[KernelFamily]] = {}
        warned: set = set()
        for combo in itertools.product(*(space[n] for n in names)):
            kw = dict(zip(names, combo))
            try:
                kernel = self.build(**kw)
            except _SkipVariant:
                continue
            if not kernel.code_sig:
                kernel.code_sig = self.code_sig
            if self.family is not None and kernel.family is None:
                fixed_key = tuple(sorted(
                    (a, v) for a, v in kw.items()
                    if a not in self.family.var_degrees))
                if fixed_key not in families:
                    families[fixed_key] = self._family_of(kw)
                kernel.family = families[fixed_key]
            fam = kernel.family
            if fam is not None and fam.scale > 1:
                for var in fam.var_degrees:
                    size = int(kernel.sizes.get(var, 0))
                    if size % fam.scale and (var, size) not in warned:
                        warned.add((var, size))
                        warnings.warn(
                            f"generator {self.name!r}: requested size "
                            f"{var}={size} violates the symbolic family's "
                            f"probe-lattice assumption "
                            f"{var} % {fam.scale} == 0 — the count "
                            f"polynomial extrapolates off the verified "
                            f"lattice", LatticeAssumptionWarning,
                            stacklevel=2)
            yield kernel


class _SkipVariant(Exception):
    """Raised by builders for incoherent argument combinations."""


class LatticeAssumptionWarning(UserWarning):
    """A requested kernel size violates its symbolic family's probe-lattice
    divisibility assumption (``var % scale == 0``): the family polynomial
    is still evaluated there, but the reconstruction was only verified on
    the lattice."""


def _parse_value(s: str) -> Any:
    if s in ("True", "False"):
        return s == "True"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


def parse_filter_tags(filter_tags: Sequence[str]
                      ) -> Tuple[FrozenSet[str], Dict[str, Tuple[Any, ...]]]:
    gen_tags: set = set()
    variant: Dict[str, Tuple[Any, ...]] = {}
    for t in filter_tags:
        if ":" in t:
            arg, vals = t.split(":", 1)
            variant[arg] = tuple(_parse_value(v) for v in vals.split(","))
        else:
            gen_tags.add(t)
    return frozenset(gen_tags), variant


class KernelCollection:
    def __init__(self, generators: Sequence[Generator]):
        self.generators = list(generators)

    def generate_kernels(
        self,
        filter_tags: Sequence[str],
        generator_match_cond: MatchCondition = MatchCondition.SUPERSET,
    ) -> List[MeasurementKernel]:
        user_tags, constraints = parse_filter_tags(filter_tags)
        out: List[MeasurementKernel] = []
        for g in self.generators:
            gt = g.gen_tags
            if generator_match_cond is MatchCondition.IDENTICAL:
                ok = gt == user_tags
            elif generator_match_cond is MatchCondition.SUBSET:
                ok = gt <= user_tags
            elif generator_match_cond is MatchCondition.SUPERSET:
                ok = gt >= user_tags
            else:
                ok = bool(gt & user_tags)
            if ok:
                out.extend(g.variants(constraints))
        return out


# ---------------------------------------------------------------------------
# Feature-value gathering (paper fig. 3, step 3)
# ---------------------------------------------------------------------------


def default_timer(kernel: MeasurementKernel, trials: int, *,
                  device: DeviceLike = "cuda") -> TimingStats:
    """One real timing pass of ``kernel`` on ``device``."""
    return kernel.time_stats(trials=trials, device=device)


class CountingTimer:
    """Injectable timer wrapper counting the timing passes that ran — the
    observable behind prediction's zero-timing guarantee."""

    def __init__(self, timer: Callable[[MeasurementKernel, int], TimerResult]
                 = default_timer):
        self._timer = timer
        self.calls = 0

    def __call__(self, kernel: MeasurementKernel, trials: int) -> TimerResult:
        self.calls += 1
        return self._timer(kernel, trials)


def _rel_std(stats: TimingStats) -> float:
    """Relative wall-clock spread of one measurement; inf when unknown (a
    spread-less measurement never wins a retime comparison)."""
    if stats.std is None or not stats.median > 0:
        return float("inf")
    return stats.std / stats.median


def gather_feature_table(
    features: Sequence[str],
    kernels: Sequence[MeasurementKernel],
    *,
    trials: int = 20,
    timer: Optional[Callable[[MeasurementKernel, int], TimerResult]] = None,
    cache: Optional[Any] = None,
    retime_rel_std: Optional[float] = None,
    engine: Optional[Any] = None,
) -> FeatureTable:
    """Dense timing table: one row per kernel, one column per feature.
    ``f_wall_time_*`` columns are measured (each kernel timed once
    however many such columns there are); every other column is counted.
    ``timer(kernel, trials)`` is injectable (deterministic tests); it may
    return bare seconds or :class:`TimingStats`.

    ``cache`` is a :class:`~repro_torch.profiles.cache.MeasurementCache`:
    on a hit neither the timer nor the counter runs, so a warm
    recalibration performs zero timings.  ``engine`` is a
    :class:`~repro_torch.core.countengine.CountEngine`: counts of the
    cache-missing rows come from it, kernels of one symbolic family
    sharing one reconstruction and filled by vectorized polynomial
    evaluation.  ``retime_rel_std`` gives rows whose relative wall-clock
    std exceeds it (cached rows included) one extra timing pass; the
    steadier pass wins and replaces the cache entry, and the re-timed row
    names land in the table's ``retimed_rows``."""
    features = list(features)
    timer = timer or default_timer
    wall_cols = [j for j, f in enumerate(features)
                 if f.startswith("f_wall_time")]
    count_cols = [(j, f) for j, f in enumerate(features)
                  if not f.startswith("f_wall_time")]
    values = np.zeros((len(kernels), len(features)), np.float64)
    row_noise: Dict[str, Dict[str, float]] = {}
    retimed: List[str] = []
    entries = [cache.get(k, trials) if cache is not None else None
               for k in kernels]
    # counts of every cache-missing row, resolved up front: the engine
    # batches symbolic families across the whole battery
    need = [i for i, e in enumerate(entries) if e is None]
    if engine is not None and need:
        fresh_counts = dict(zip(
            need, engine.counts_batch([kernels[i] for i in need])))
    else:
        fresh_counts = {i: kernels[i].counts() for i in need}
    # a kernel appearing twice in one cold gather is measured once
    local: Dict[Tuple, Tuple] = {}
    for i, k in enumerate(kernels):
        entry = entries[i]
        kid = (k.name, tuple(sorted(k.sizes.items())), k.code_sig)
        stats: Optional[TimingStats] = None
        duplicate = entry is None and kid in local
        if duplicate:
            counts, wall, stats = local[kid]
        elif entry is not None:
            counts, wall, stats = entry.counts, entry.wall_time, entry.noise
            if wall_cols and wall is None:
                # entry was gathered counts-only; backfill the timing
                stats = TimingStats.coerce(timer(k, trials))
                wall = stats.median
                cache.put(k, trials, wall, counts, noise=stats)
        else:
            counts = fresh_counts[i]
            wall = None
            if wall_cols:
                stats = TimingStats.coerce(timer(k, trials))
                wall = stats.median
            if cache is not None:
                cache.put(k, trials, wall, counts, noise=stats)
        if (not duplicate and retime_rel_std is not None and wall_cols
                and stats is not None and stats.std is not None
                and _rel_std(stats) > retime_rel_std):
            # noisy row: one extra pass; the steadier measurement wins
            fresh = TimingStats.coerce(timer(k, trials))
            retimed.append(k.name)
            if _rel_std(fresh) < _rel_std(stats):
                stats, wall = fresh, fresh.median
                if cache is not None:
                    cache.put(k, trials, wall, counts, noise=stats)
        if entry is None and not duplicate:
            local[kid] = (counts, wall, stats)
        if stats is not None and (stats.std is not None
                                  or stats.min is not None):
            row_noise[k.name] = stats.to_dict()
        for j, f in count_cols:
            values[i, j] = counts[f]
        for j in wall_cols:
            values[i, j] = wall
    table = FeatureTable(features, values, [k.name for k in kernels],
                         row_noise)
    table.retimed_rows = retimed
    return table


def gather_feature_values(
    features: Sequence[str],
    kernels: Sequence[MeasurementKernel],
    *,
    trials: int = 20,
    timer: Optional[Callable[[MeasurementKernel, int], TimerResult]] = None,
    cache: Optional[Any] = None,
) -> List[Dict[str, float]]:
    """Deprecated dict-per-row view of :func:`gather_feature_table`."""
    warn_once(
        "gather_feature_values",
        "gather_feature_values is deprecated; use "
        "gather_feature_table(...).rows() (or the FeatureTable directly)")
    return gather_feature_table(features, kernels, trials=trials,
                                timer=timer, cache=cache).rows()


def unit_hash(*parts: object) -> float:
    """Deterministic draw in [0, 1) from the ':'-joined identity parts
    (the reference's definition, so splits agree across packages)."""
    digest = hashlib.sha256(":".join(str(p) for p in parts).encode())
    return int(digest.hexdigest()[:12], 16) / float(16 ** 12)


def holdout_split(table: FeatureTable, *, holdout_fraction: float = 0.25,
                  salt: str = "holdout") -> Tuple[FeatureTable, FeatureTable]:
    """Deterministic train/held-out split ranked by a hash of each row
    name, holding out ``round(holdout_fraction · n)`` rows (both sides
    non-empty) — the same variant lands on the same side on every
    machine and in both packages."""
    if len(table) < 2:
        raise ValueError(
            f"cannot split a {len(table)}-row table into train + holdout")
    scores = {name: (unit_hash(salt, name), name)
              for name in table.row_names}
    order = sorted(range(len(table)), key=lambda i: scores[table.row_names[i]])
    k = int(round(holdout_fraction * len(table)))
    k = min(max(k, 1), len(table) - 1)
    return table.select(sorted(order[k:])), table.select(sorted(order[:k]))


# ---------------------------------------------------------------------------
# Built-in generators
# ---------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


def _randn(shape: Tuple[int, ...], seed: int, device: DeviceLike,
           dtype: torch.dtype) -> torch.Tensor:
    """Standard normal data from ``seed`` (a ``torch.Generator`` on the
    target device); shape-only on ``meta``."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev,
                       dtype=torch.float32).to(dtype)


# ---- matmul_sq: the paper's running example --------------------------------


def _build_matmul_sq(*, n: int, dtype: str, prefetch: bool,
                     tile: int) -> MeasurementKernel:
    dt = _DTYPES[dtype]
    if prefetch:
        # k loop over [tile]-wide panels, the analogue of the paper's
        # local-memory prefetch variant
        if n % tile:
            raise _SkipVariant
        nk = n // tile

        def fn(a, b):
            acc = torch.zeros((n, n), dtype=a.dtype, device=a.device)
            for i in counted_range(nk):
                s = slice(i * tile, (i + 1) * tile)
                acc = acc + a[:, s] @ b[s]
            return acc
    else:
        def fn(a, b):
            return a @ b

    def make_args(device):
        return _randn((n, n), 1, device, dt), _randn((n, n), 2, device, dt)

    return MeasurementKernel(
        name=f"matmul_sq_n{n}_{dtype}_pf{prefetch}_t{tile}",
        fn=fn, make_args=make_args,
        tags=dict(n=n, dtype=dtype, prefetch=prefetch, tile=tile),
        sizes=dict(n=n))


MATMUL_SQ = Generator(
    "matmul_sq",
    frozenset({"matmul_sq", "matmul"}),
    arg_space=dict(
        n=(256, 384, 512, 640, 768, 1024),
        dtype=("float32", "bfloat16"),
        prefetch=(True, False),
        tile=(16, 32, 64, 128),
    ),
    build=_build_matmul_sq,
    # n³ madds (+ n² traffic); the staged k loop has n / tile steps, so
    # its probes are tile-aligned
    family=FamilySpec(
        var_degrees={"n": 3},
        probe=lambda **fx: (fx["tile"], fx["tile"]) if fx["prefetch"]
        else (16, 16),
    ),
)


# ---- flops_madd_pattern: peak-FLOP microbenchmark ---------------------------


def _build_madd(*, nelements: int, iters: int, dtype: str) -> MeasurementKernel:
    dt = _DTYPES[dtype]

    def fn(x, a, b):
        # 8 independent accumulator streams, 8-way unrolled madd chain —
        # the SHOC MaxFlops pattern (paper §7.1.2), one elementwise launch
        # per op in eager PyTorch
        xs = [x + i for i in range(8)]
        for _ in counted_range(iters):
            xs = [xi * a + b for xi in xs]
        out = xs[0]
        for xi in xs[1:]:
            out = out + xi
        return out

    def make_args(device):
        x = _randn((nelements,), 1, device, dt)
        return (x, torch.tensor(1.000001, dtype=dt, device=device),
                torch.tensor(1e-7, dtype=dt, device=device))

    return MeasurementKernel(
        name=f"madd_n{nelements}_i{iters}_{dtype}",
        fn=fn, make_args=make_args,
        tags=dict(nelements=nelements, iters=iters, dtype=dtype),
        sizes=dict(nelements=nelements, iters=iters))


FLOPS_MADD = Generator(
    "flops_madd_pattern",
    frozenset({"flops_madd_pattern", "flops"}),
    arg_space=dict(
        nelements=(4096, 16384, 65536),
        iters=(64, 128, 256, 512),
        dtype=("float32", "bfloat16"),
    ),
    build=_build_madd,
    # per-element work × loop trips: bilinear in (nelements, iters)
    family=FamilySpec(var_degrees={"nelements": 1, "iters": 1}),
)


# ---- flops_dot_pattern: contraction madd throughput ------------------------


def _build_dot(*, n_dot: int, iters: int, dtype: str) -> MeasurementKernel:
    dt = _DTYPES[dtype]

    def fn(z, w):
        c = z
        for _ in counted_range(iters):
            # renormalize cheaply to avoid overflow across iterations
            c = (c @ w) * 0.999
        return c

    def make_args(device):
        z = _randn((n_dot, n_dot), 1, device, torch.float32)
        w = _randn((n_dot, n_dot), 2, device, torch.float32)
        if w.device.type != "meta":
            w = w / torch.linalg.vector_norm(w, dim=0, keepdim=True)
        return z.to(dt), w.to(dt)

    return MeasurementKernel(
        name=f"dotflops_n{n_dot}_i{iters}_{dtype}",
        fn=fn, make_args=make_args,
        tags=dict(n_dot=n_dot, iters=iters, dtype=dtype),
        sizes=dict(n_dot=n_dot, iters=iters))


FLOPS_DOT = Generator(
    "flops_dot_pattern",
    frozenset({"flops_dot_pattern", "flops"}),
    arg_space=dict(
        n_dot=(128, 256, 384),
        iters=(16, 64, 128),
        dtype=("float32", "bfloat16"),
    ),
    build=_build_dot,
    # n³ madds per chain step × iters steps
    family=FamilySpec(var_degrees={"n_dot": 3, "iters": 1}),
)


# ---- mem_stream: global-memory access patterns ------------------------------


def _build_stream(*, nelements: int, pattern: str, n_arrays: int,
                  dtype: str) -> MeasurementKernel:
    dt = _DTYPES[dtype]
    side = int(np.sqrt(nelements))
    shape: Tuple[int, ...] = (nelements,)

    if pattern == "contig":
        def fn(*arrs):
            out = arrs[0]
            for a in arrs[1:]:
                out = out + a
            return out
    elif pattern == "strided":
        shape = (side, side)

        def fn(*arrs):
            out = arrs[0].T
            for a in arrs[1:]:
                out = out + a.T   # transposed read
            # a transpose is a view in PyTorch: materialize it, as XLA does
            return out.contiguous()
    elif pattern == "gather":
        def fn(idx, *arrs):
            out = arrs[0][idx]
            for a in arrs[1:]:
                out = out + a[idx]
            return out
    elif pattern == "shift":
        # rolled access (the reference's jnp.roll)
        def fn(*arrs):
            out = torch.roll(arrs[0], 1)
            for a in arrs[1:]:
                out = out + torch.roll(a, 1)
            return out
    else:
        raise _SkipVariant

    def make_args(device):
        arrs = tuple(_randn(shape, i, device, dt) for i in range(n_arrays))
        if pattern != "gather":
            return arrs
        dev = torch.device(device)
        if dev.type == "meta":
            idx = torch.empty((nelements,), dtype=torch.int64, device=dev)
        else:
            g = torch.Generator(device=dev).manual_seed(9)
            idx = torch.randint(0, nelements, (nelements,), generator=g,
                                device=dev)
        return (idx,) + arrs

    return MeasurementKernel(
        name=f"stream_{pattern}_n{nelements}_a{n_arrays}_{dtype}",
        fn=fn, make_args=make_args,
        tags=dict(nelements=nelements, pattern=pattern, n_arrays=n_arrays,
                  dtype=dtype),
        sizes=dict(nelements=nelements))


MEM_STREAM = Generator(
    "mem_stream",
    frozenset({"mem_stream", "gmem"}),
    arg_space=dict(
        nelements=(262144, 1048576, 4194304, 16777216),
        pattern=("contig", "strided", "gather", "shift"),
        n_arrays=(1, 2, 4),
        dtype=("float32", "bfloat16"),
    ),
    build=_build_stream,
    # element traffic is linear in nelements — except the strided pattern,
    # whose working shape is (isqrt(n), isqrt(n)): not a polynomial in n,
    # so it is counted per shape
    family=FamilySpec(
        var_degrees={"nelements": 1},
        applies=lambda **fx: fx["pattern"] != "strided",
    ),
)


# ---- onchip_pattern: cache-resident working set ------------------------------


def _build_onchip(*, working_set: int, iters: int, dtype: str
                  ) -> MeasurementKernel:
    dt = _DTYPES[dtype]

    def fn(x):
        # stays in L1/L2, load+store heavy
        return counted_loop(iters, lambda i, x: torch.roll(x, 1) + x, x)

    def make_args(device):
        return (_randn((working_set,), 1, device, dt),)

    return MeasurementKernel(
        name=f"onchip_w{working_set}_i{iters}_{dtype}",
        fn=fn, make_args=make_args,
        tags=dict(working_set=working_set, iters=iters, dtype=dtype),
        sizes=dict(working_set=working_set, iters=iters))


ONCHIP = Generator(
    "onchip_pattern",
    frozenset({"onchip_pattern", "lmem"}),
    arg_space=dict(
        working_set=(2048, 8192, 32768),
        iters=(64, 256, 1024),
        dtype=("float32",),
    ),
    build=_build_onchip,
    # load+store rounds over a resident buffer: bilinear
    family=FamilySpec(var_degrees={"working_set": 1, "iters": 1}),
)


# ---- empty / launch-overhead kernel ----------------------------------------


def _build_empty(*, nelements: int) -> MeasurementKernel:
    def fn(x):
        return x

    def make_args(device):
        return (torch.zeros((nelements,), dtype=torch.float32,
                            device=device),)

    return MeasurementKernel(
        name=f"empty_n{nelements}", fn=fn, make_args=make_args,
        tags=dict(nelements=nelements), sizes=dict(nelements=nelements))


EMPTY = Generator(
    "empty_kernel",
    frozenset({"empty_kernel", "launch"}),
    arg_space=dict(nelements=(16, 1024, 65536)),
    build=_build_empty,
    # identity kernel: counts are size-independent (launch overhead only)
    family=FamilySpec(var_degrees={"nelements": 0}),
)


# ---- sync / loop-step overhead ----------------------------------------------


def _build_loopstep(*, steps: int) -> MeasurementKernel:
    def fn(x):
        return counted_loop(steps, lambda i, c: c + 1.0, x)

    def make_args(device):
        return (torch.zeros((), dtype=torch.float32, device=device),)

    return MeasurementKernel(
        name=f"loopstep_s{steps}", fn=fn, make_args=make_args,
        tags=dict(steps=steps), sizes=dict(steps=steps))


LOOPSTEP = Generator(
    "sync_loop_pattern",
    frozenset({"sync_loop_pattern", "sync"}),
    arg_space=dict(steps=(64, 512, 4096, 32768)),
    build=_build_loopstep,
    family=FamilySpec(var_degrees={"steps": 1}),
)


# ---- overlap kernel (paper §7.4): 1 global read + m on-chip updates ---------


def _build_overlap(*, nelements: int, m: int, dtype: str) -> MeasurementKernel:
    dt = _DTYPES[dtype]

    def fn(x):
        # one pass over the large array (memory-bound part)
        s = torch.sum(x, dtype=torch.float32)
        # m on-chip update rounds over a small resident buffer, filled on
        # the device (no host sync, so the kernel stays capturable)
        buf = s.to(dt).expand(1024).clone()
        buf = counted_loop(m, lambda i, b: b * 0.999 + 1e-5, buf)
        return torch.sum(buf)

    def make_args(device):
        return (_randn((nelements,), 1, device, dt),)

    return MeasurementKernel(
        name=f"overlap_n{nelements}_m{m}_{dtype}",
        fn=fn, make_args=make_args,
        tags=dict(nelements=nelements, m=m, dtype=dtype),
        sizes=dict(nelements=nelements, m=m))


OVERLAP = Generator(
    "overlap_pattern",
    frozenset({"overlap_pattern", "overlap"}),
    arg_space=dict(
        nelements=(4194304, 16777216),
        m=(0, 4, 16, 64, 256, 1024, 4096, 16384, 65536),
        dtype=("float32",),
    ),
    build=_build_overlap,
    # one linear pass over nelements + m fixed-size on-chip rounds
    family=FamilySpec(var_degrees={"nelements": 1, "m": 1}),
)


# ---- DG differentiation (paper §8.4) ----------------------------------------


def _build_dg(*, nelements_dg: int, nunit_nodes: int, nmatrices: int,
              variant: str, dtype: str) -> MeasurementKernel:
    dt = _DTYPES[dtype]
    K, N, M = nelements_dg, nunit_nodes, nmatrices

    if variant == "basic":
        def fn(dmat, u):
            return torch.einsum("mij,kj->mki", dmat, u)
    elif variant == "u_pf":
        # contraction reassociated to reuse u across matrices ("prefetch u")
        def fn(dmat, u):
            d2 = dmat.reshape(M * N, N)
            r = torch.einsum("pj,kj->pk", d2, u)
            # a transpose is a view in PyTorch: materialize it, as XLA does
            return r.reshape(M, N, K).permute(0, 2, 1).contiguous()
    elif variant == "dmat_pf":
        # loop over matrices, each a plain GEMM ("prefetch diff_mat"),
        # each written into its slice of the stacked result as the
        # reference's scan stacks its outputs
        def fn(dmat, u):
            r = u.new_empty((M, K, N))
            for m in counted_range(M):
                torch.matmul(u, dmat[m].T, out=r[m])
            return r
    elif variant == "dmat_pf_T":
        # + transposed element-data layout (the paper's fastest variant)
        def fn(dmat, ut):
            r = ut.new_empty((M, N, K))
            for m in counted_range(M):
                torch.matmul(dmat[m], ut, out=r[m])
            return r
    else:
        raise _SkipVariant

    def make_args(device):
        dmat = _randn((M, N, N), 1, device, dt)
        shape = (N, K) if variant == "dmat_pf_T" else (K, N)
        return dmat, _randn(shape, 2, device, dt)

    return MeasurementKernel(
        name=f"dg_{variant}_k{K}_n{N}_m{M}_{dtype}",
        fn=fn, make_args=make_args,
        tags=dict(nelements_dg=K, nunit_nodes=N, nmatrices=M,
                  variant=variant, dtype=dtype),
        sizes=dict(nelements_dg=K))


DG_DIFF = Generator(
    "dg_diff",
    frozenset({"dg_diff", "dg"}),
    arg_space=dict(
        nelements_dg=(8192, 16384, 32768, 65536),
        nunit_nodes=(64,),
        nmatrices=(3,),
        variant=("basic", "u_pf", "dmat_pf", "dmat_pf_T"),
        dtype=("float32",),
    ),
    build=_build_dg,
    # every variant is one contraction sweep (with the einsum variants'
    # permutes), linear in the element count
    family=FamilySpec(var_degrees={"nelements_dg": 1}),
)


# ---- 2-D five-point stencil (paper §8.5) ------------------------------------


def _build_stencil(*, n_grid: int, variant: str, dtype: str
                   ) -> MeasurementKernel:
    dt = _DTYPES[dtype]

    if variant == "roll":
        def fn(u):
            return (torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
                    + torch.roll(u, 1, 1) + torch.roll(u, -1, 1) - 4.0 * u)
    elif variant == "slice":
        def fn(u):
            c = u[1:-1, 1:-1]
            return (u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2]
                    + u[1:-1, 2:] - 4.0 * c)
    else:
        raise _SkipVariant

    def make_args(device):
        return (_randn((n_grid, n_grid), 1, device, dt),)

    return MeasurementKernel(
        name=f"stencil_{variant}_n{n_grid}_{dtype}",
        fn=fn, make_args=make_args,
        tags=dict(n_grid=n_grid, variant=variant, dtype=dtype),
        sizes=dict(n_grid=n_grid))


STENCIL = Generator(
    "finite_diff",
    frozenset({"finite_diff", "stencil"}),
    arg_space=dict(
        n_grid=(1024, 2048, 4096, 8192),
        variant=("roll", "slice"),
        dtype=("float32",),
    ),
    build=_build_stencil,
    family=FamilySpec(var_degrees={"n_grid": 2}),
)


ALL_GENERATORS: List[Generator] = [
    MATMUL_SQ, FLOPS_MADD, FLOPS_DOT, MEM_STREAM, ONCHIP, EMPTY, LOOPSTEP,
    OVERLAP, DG_DIFF, STENCIL,
]
