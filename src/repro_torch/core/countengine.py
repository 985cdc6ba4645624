"""Amortized symbolic counting engine — the counterpart of
``repro.core.countengine``.

The paper gathers performance-relevant operation counts *symbolically
once* and re-evaluates them "in microseconds for any problem size".
Without this engine the port runs the fake-tensor counter for every
kernel at every size, in calibration and in prediction alike.
:class:`CountEngine` makes counting amortized and observable:

* **content-addressed count cache** — concrete counts keyed by (callable
  signature, argument shapes/dtypes/strides) or (generator ``code_sig``,
  kernel name, sizes), memoized in-process and persisted as JSON beside
  the :class:`~repro_torch.profiles.cache.MeasurementCache`
  (``MeasurementCache.count_store``).  Warm predictions and battery
  gathers perform zero counting passes — ``hits``/``misses``/
  ``trace_count`` make the claim assertable.
* **symbolic kernel families** — a generator declaring a
  :class:`~repro_torch.core.uipick.FamilySpec` gets its
  :class:`~repro_torch.core.counting.SymbolicCounts` rebuilt once from the
  minimal probe grid (``degree+1`` counting passes per size variable), and
  whole size sweeps are filled by batched Horner evaluation.  The
  reconstruction persists too.

Persisted keys carry ``COUNT_STORE_VERSION``, ``torch.__version__`` and a
hash of the counter's own source: another torch build may decompose an op
differently under fake tensors, so a store written under one torch is
never served to another.  A callable reaching a module of the
hand-kernel package (``repro_torch.kernels``) signs it by the kernel
library's hash (:func:`repro_torch.kernels._build.library_path`: every
``.cu`` source and the nvcc flags), the module's source and the signature
of the cost rule of each custom op it reaches, so editing a ``.cu`` file,
a wrapper or a cost rule turns a stored count into a miss.

Kernels with size-non-polynomial structure (no family, such as
``mem_stream``'s strided pattern) are counted per shape through the
concrete cache, and callables whose identity cannot be established (no
retrievable source, large or exotic captured state) are counted on every
call — each such pass is counted in ``trace_count``, never cached under a
weak key.
"""
from __future__ import annotations

import functools
import hashlib
import inspect
import json
import re
import threading
import time
from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._library.custom_ops import CustomOpDef
from torch.utils._pytree import tree_flatten

from repro_torch.core import counting
from repro_torch.core.counting import (
    FeatureCounts,
    SymbolicCounts,
    count_fn,
    parametric_counts_from,
)
from repro_torch.core.symbolic import ParametricCount, Poly
from repro_torch.core.uipick import KernelFamily, MeasurementKernel, \
    source_signature
from repro_torch.profiles.profile import atomic_write_json

# bump when the persisted entry format changes; stale entries read as
# misses, as the measurement cache's do
COUNT_STORE_VERSION = 1

#: captured tensors and arrays above this many elements are not hashed
#: (hashing them per lookup would defeat the cache, shapes alone are
#: unsound): their callable is counted per call
MAX_DIGEST_ELEMENTS = 65536

# the hand-kernel package: its modules sign by the kernel library's hash
_KERNEL_PACKAGE = "repro_torch.kernels"

# memo of source hashes keyed by code object (functions) or by the object
# itself (classes): getsource costs file IO, and serving loops sign the
# same callables over and over
_SRC_MEMO: Dict[Any, str] = {}


def _source_of(fn: Callable) -> str:
    key = getattr(fn, "__code__", None)
    if key is None:
        if not isinstance(fn, type):
            return source_signature(fn)
        key = fn
    sig = _SRC_MEMO.get(key)
    if sig is None:
        sig = source_signature(fn)
        _SRC_MEMO[key] = sig
    return sig


def _note(reasons: Optional[List[str]], why: str) -> None:
    if reasons is not None:
        reasons.append(why)


def _tensor_digest(t: torch.Tensor,
                   reasons: Optional[List[str]]) -> Optional[str]:
    shape = f"{t.dtype}[{','.join(map(str, t.shape))}]"
    if t.device.type == "meta":
        # no values to read, so none can steer the counted ops
        return f"meta:{shape}"
    if t.numel() > MAX_DIGEST_ELEMENTS:
        _note(reasons,
              f"captured tensor {shape} on {t.device} has {t.numel()} "
              f"elements (> {MAX_DIGEST_ELEMENTS}): hashing it per lookup "
              f"would defeat the cache, shapes alone are unsound")
        return None
    data = t.detach().contiguous().cpu().view(-1).view(torch.uint8)
    return f"{shape}:{hashlib.sha256(data.numpy().tobytes()).hexdigest()[:12]}"


def _is_kernel_module(module) -> bool:
    name = module.__name__
    return name == _KERNEL_PACKAGE or name.startswith(_KERNEL_PACKAGE + ".")


def _kernel_module_digest(module, lib: str, seen: frozenset,
                          reasons: Optional[List[str]]) -> Optional[str]:
    """Identity of a module of the hand-kernel package: the kernel
    library's hash ``lib``, the module's source, the signature of the
    cost rule of each custom op it defines, and the digest of each
    kernel module it references (the wrappers of ``ops`` reach their
    kernels through those).  A cost rule is a module-level function, so
    it signs as itself wherever the module was reached from.  None when a
    rule has no stable signature."""
    parts = [lib, source_signature(module)]
    for name, value in sorted(vars(module).items()):
        if isinstance(value, CustomOpDef):
            rule = counting._rule_for(value._qualname)
            sig = _signature(rule, 0, frozenset({id(rule)}), reasons)
            if not sig:
                _note(reasons, f"cost rule of {value._qualname} has no "
                               f"stable signature")
                return None
            parts.append(f"{value._qualname}={sig}")
        elif inspect.ismodule(value) and _is_kernel_module(value) \
                and id(value) not in seen:
            sub = _kernel_module_digest(value, lib, seen | {id(value)},
                                        reasons)
            if sub is None:
                return None
            parts.append(f"{name}={sub}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def _state_digest(value: Any, depth: int, seen: frozenset,
                  reasons: Optional[List[str]] = None) -> Optional[str]:
    """Stable digest of one piece of captured callable state (a closure
    cell, default argument, bound ``self`` or referenced global), or None
    when none exists.  Conservative by design: an undigestable value makes
    the whole callable unsignable (counted per call), never a wrong cache
    key.  ``reasons`` (when given) collects why a digest failed."""
    if depth > 3:
        _note(reasons, "captured state nests deeper than 3 levels")
        return None
    if isinstance(value, (int, float, bool, str, bytes, type(None))):
        return repr(value)
    if isinstance(value, np.dtype):
        return f"dtype:{value.str}"
    if isinstance(value, (torch.dtype, torch.device)):
        return f"{type(value).__name__}:{value}"
    if isinstance(value, torch.Generator):
        # its state bytes: stable across processes for one seed and draw
        # history
        state = value.get_state().numpy().tobytes()
        return (f"generator:{value.device}:"
                f"{hashlib.sha256(state).hexdigest()[:12]}")
    if isinstance(value, (tuple, list)):
        parts = [_state_digest(v, depth + 1, seen, reasons) for v in value]
        if any(p is None for p in parts):
            return None
        return f"{type(value).__name__}({','.join(parts)})"  # type: ignore
    if isinstance(value, dict):
        parts = []
        for k in sorted(value, key=repr):
            dv = _state_digest(value[k], depth + 1, seen, reasons)
            if dv is None:
                return None
            parts.append(f"{k!r}:{dv}")
        return f"dict({','.join(parts)})"
    if inspect.ismodule(value):
        name = value.__name__
        if _is_kernel_module(value):
            from repro_torch.kernels import _build

            digest = _kernel_module_digest(
                value, _build.library_path().name, frozenset({id(value)}),
                reasons)
            return f"kernel:{name}:{digest}" if digest else None
        # a library module: identity by name — its internal edits are
        # invisible, the documented tradeoff (the store key carries the
        # torch version for torch itself)
        return f"module:{name}"
    if isinstance(value, torch.Tensor):
        return _tensor_digest(value, reasons)
    if isinstance(value, (np.ndarray, np.generic)):
        arr = np.asarray(value)
        if arr.dtype.hasobject:
            _note(reasons, "captured object array: its bytes are "
                           "addresses, not content")
            return None
        if arr.size > MAX_DIGEST_ELEMENTS:
            _note(reasons,
                  f"captured array {arr.dtype}{list(arr.shape)} has "
                  f"{arr.size} elements (> {MAX_DIGEST_ELEMENTS}): hashing "
                  f"it per lookup would defeat the cache, shapes alone "
                  f"are unsound")
            return None
        return (f"{arr.dtype}[{','.join(map(str, arr.shape))}]:"
                f"{hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:12]}")
    if value is counting.counted_range or value is counting.counted_loop:
        # the loop helpers read the counter's ContextVar through their
        # globals: they sign as the counter itself, so an edit to it
        # still turns every count of a kernel that loops into a miss
        return f"counter:{value.__name__}:{_counter_signature()}"
    if callable(value):
        if id(value) in seen:
            # a cycle (a self-recursive closure): the callable's own
            # source already identifies it
            return "<cycle>"
        inner = _signature(value, depth + 1, seen | {id(value)}, reasons)
        return inner if inner else None
    _note(reasons,
          f"captured value of type {type(value).__name__!r} has no "
          f"stable content digest")
    return None


def _signature(fn: Callable, depth: int, seen: frozenset,
               reasons: Optional[List[str]] = None) -> str:
    # a partial signs as its target plus a digest of the bound arguments;
    # a sourceless wrapper honoring __wrapped__ signs as what it wraps
    if isinstance(fn, functools.partial):
        if id(fn.func) in seen:
            return ""
        inner = _signature(fn.func, depth, seen | {id(fn.func)}, reasons)
        if not inner:
            return ""
        bound = _state_digest([list(fn.args), dict(fn.keywords)],
                              depth, seen, reasons)
        if bound is None:
            return ""
        return f"partial({inner};{bound})"
    src = _source_of(fn)
    if not src:
        wrapped = getattr(fn, "__wrapped__", None)
        if wrapped is not None and id(wrapped) not in seen:
            inner = _signature(wrapped, depth, seen | {id(wrapped)},
                               reasons)
            return f"wrapped({inner})" if inner else ""
        _note(reasons,
              f"callable {getattr(fn, '__name__', fn)!r} has no "
              f"retrievable source (REPL/exec or builtin)")
        return ""
    parts: List[str] = [src]
    # a bound method depends on instance state: digest self and sign the
    # underlying function (whose closure/defaults are then seen)
    inner = getattr(fn, "__func__", None)
    if inner is not None:
        self_digest = _state_digest(getattr(fn, "__self__", None),
                                    depth, seen, reasons)
        if self_digest is None:
            return ""
        parts.append(f"self:{self_digest}")
        fn = inner
    kwdefaults = getattr(fn, "__kwdefaults__", None) or {}
    state = []
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            state.append(cell.cell_contents)
        except ValueError:       # still-empty cell: no stable identity
            _note(reasons, "closure cell is still empty (recursive "
                           "definition not yet bound)")
            return ""
    state += list(getattr(fn, "__defaults__", None) or ())
    state += [v for _, v in sorted(kwdefaults.items())]
    for value in state:
        digest = _state_digest(value, depth, seen, reasons)
        if digest is None:
            return ""
        parts.append(digest)
    # module-level globals the body references (its own code and nested
    # code objects) are captured state too: editing a referenced helper
    # must change the signature
    code = getattr(fn, "__code__", None)
    fn_globals = getattr(fn, "__globals__", None)
    if code is not None and fn_globals is not None:
        for name in sorted(_referenced_names(code)):
            if name not in fn_globals:
                continue
            digest = _state_digest(fn_globals[name], depth, seen, reasons)
            if digest is None:
                _note(reasons, f"(the undigestable value above is the "
                               f"module-level global {name!r})")
                return ""
            parts.append(f"g:{name}={digest}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def _referenced_names(code) -> set:
    """co_names of a code object and of every nested code object in its
    co_consts."""
    names = set(code.co_names)
    for const in code.co_consts:
        if hasattr(const, "co_names"):
            names |= _referenced_names(const)
    return names


def callable_signature(fn: Callable) -> str:
    """Content identity of a callable for count caching: source hash plus
    a digest of its captured state (closure cells, defaults, bound
    ``self``, referenced globals; hand-kernel modules by library hash and
    cost rules).  ``""`` when no sound identity exists; such callables are
    counted on every call."""
    return _signature(fn, 0, frozenset({id(fn)}))


def signature_hazards(fn: Callable) -> List[str]:
    """Why ``fn`` signs as ``""`` — one reason per undigestable piece of
    captured state; empty when the callable is signable."""
    reasons: List[str] = []
    sig = _signature(fn, 0, frozenset({id(fn)}), reasons)
    if sig:
        return []
    return reasons or ["callable has no stable content identity"]


def args_signature(args: Sequence[Any]) -> str:
    """Canonical signature of example arguments: tensors by dtype, shape,
    stride and device type (``meta`` included), other leaves by type and
    ``repr`` (a Python scalar can steer which ops run)."""
    leaves, spec = tree_flatten(tuple(args))
    parts = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            parts.append(
                f"{leaf.dtype}[{','.join(map(str, leaf.shape))}]"
                f"s({','.join(map(str, leaf.stride()))})"
                f"@{leaf.device.type}")
        else:
            parts.append(f"py:{type(leaf).__name__}:{leaf!r}")
    return f"{spec}|{';'.join(parts)}"


@functools.cache
def _counter_signature() -> str:
    return source_signature(counting)


def _store_identity() -> Dict[str, Any]:
    """What every persisted key carries besides its own identity."""
    return {"version": COUNT_STORE_VERSION, "torch": torch.__version__,
            "counter": _counter_signature()}


# ---------------------------------------------------------------------------
# polynomial (de)serialization for persisted symbolic families
# ---------------------------------------------------------------------------


def _poly_to_json(p: Poly) -> List[Any]:
    return [[[[v, e] for v, e in mono], c.numerator, c.denominator]
            for mono, c in sorted(p.terms.items())]


def _poly_from_json(terms: Any) -> Poly:
    out = {}
    for mono, num, den in terms:
        key = tuple((str(v), int(e)) for v, e in mono)
        out[key] = Fraction(int(num), int(den))
    return Poly(out)


def _symbolic_to_json(sym: SymbolicCounts) -> Dict[str, Any]:
    return {
        "assumptions": list(sym.assumptions),
        "counts": {fid: _poly_to_json(pc.poly)
                   for fid, pc in sorted(sym.counts.items())},
    }


def _symbolic_from_json(payload: Dict[str, Any]) -> SymbolicCounts:
    assumptions = tuple(str(a) for a in payload["assumptions"])
    counts = {str(fid): ParametricCount(_poly_from_json(terms), assumptions)
              for fid, terms in payload["counts"].items()}
    return SymbolicCounts(counts, assumptions)


# ---------------------------------------------------------------------------
# count-store eviction
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CountStoreGCStats:
    """Outcome of one :meth:`CountEngine.gc` sweep.  Counts are
    machine-independent, so there is no foreign class; an entry whose
    embedded key disagrees with its file name counts as corrupt."""

    kept: int = 0
    dropped_old: int = 0
    dropped_corrupt: int = 0
    dropped_schema: int = 0

    @property
    def dropped(self) -> int:
        return self.dropped_old + self.dropped_corrupt + self.dropped_schema


# count-store entries are named by the full SHA-256 of their key
_STORE_ENTRY_NAME = re.compile(r"[0-9a-f]{64}\.json")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class CountEngine:
    """Amortized feature counting with an observable cost.

    ``store`` is the directory of the persistent tier (typically
    ``MeasurementCache.count_store``); ``None`` keeps the engine
    in-process.  Counters:

    * ``trace_count`` — counting passes performed (fake-tensor runs of a
      kernel, symbolic probes included): the number the zero-trace warm
      path is asserted against;
    * ``hits``/``misses`` — lookups (a family reconstruction is one miss
      however many grid points it probes).

    Every public lookup and ``stats()`` serialize on one re-entrant lock,
    held across cold counting passes, so two threads racing a cold key
    perform one pass and ``hits + misses`` equals the lookups made.
    """

    def __init__(self, store: Any = None):
        self.store = Path(store).expanduser() if store is not None else None
        self.hits = 0
        self.misses = 0
        self.trace_count = 0
        self._counts: Dict[str, FeatureCounts] = {}
        self._families: Dict[str, SymbolicCounts] = {}
        self._lock = threading.RLock()

    # -- the counting seam: every counting pass goes through here ----------
    def _trace(self, fn: Callable, args: Sequence[Any]) -> FeatureCounts:
        self.trace_count += 1
        return count_fn(fn, *args)

    # -- concrete counts ---------------------------------------------------
    def counts_for(self, kernel: MeasurementKernel, *,
                   sig: Optional[str] = None) -> FeatureCounts:
        """One measurement kernel's counts.  A kernel of a symbolic family
        evaluates the family's polynomial (no counting pass once it is
        rebuilt, at any size); others are keyed by (generator code
        signature, kernel name, sizes).  ``sig`` lets a caller that
        already signed the kernel pass the signature down."""
        fam = kernel.family
        if fam is not None and set(fam.var_degrees) == set(kernel.sizes):
            return self.counts_batch([kernel])[0]
        if sig is None:
            sig = kernel.code_sig or callable_signature(kernel.fn)
        if not sig:
            # no content identity: (name, sizes) alone could collide two
            # different hand-built kernels — count exactly, every time
            with self._lock:
                self.misses += 1
                return self._trace(kernel.fn, kernel.make_args("meta"))
        key = self._digest({
            "kind": "kernel", "sig": sig, "name": kernel.name,
            "sizes": {k: int(v) for k, v in sorted(kernel.sizes.items())},
        })
        with self._lock:
            return self._concrete(
                key, build=lambda: (kernel.fn, kernel.make_args("meta")))

    def counts_of_callable(self, fn: Callable, args: Sequence[Any] = (),
                           *, sig: Optional[str] = None) -> FeatureCounts:
        """Counts of a bare callable at its example arguments' shapes —
        the path of ad-hoc ``predict`` items.  ``sig`` as in
        :meth:`counts_for`."""
        if sig is None:
            sig = callable_signature(fn)
        if not sig:
            with self._lock:
                self.misses += 1
                return self._trace(fn, args)
        key = self._digest({"kind": "fn", "sig": sig,
                            "args": args_signature(args)})
        with self._lock:
            return self._concrete(key, build=lambda: (fn, args))

    def _concrete(self, key: str,
                  build: Callable[[], Tuple[Callable, Sequence[Any]]]
                  ) -> FeatureCounts:
        found = self._counts.get(key)
        if found is not None:
            self.hits += 1
            return found
        if self.store is not None:
            loaded = self._load_json(self._counts_path(key))
            if loaded is not None and loaded.get("key") == key \
                    and isinstance(loaded.get("counts"), dict):
                fc = FeatureCounts({str(k): float(v)
                                    for k, v in loaded["counts"].items()})
                self._counts[key] = fc
                self.hits += 1
                return fc
        self.misses += 1
        fn, args = build()
        fc = self._trace(fn, args)
        self._counts[key] = fc
        if self.store is not None:
            self._save_json(self._counts_path(key), {
                "version": COUNT_STORE_VERSION, "key": key,
                "counts": {k: float(v) for k, v in sorted(fc.items())},
            })
        return fc

    # -- symbolic families -------------------------------------------------
    def symbolic(self, family: KernelFamily) -> SymbolicCounts:
        """The family's symbolic counts — rebuilt from the minimal probe
        grid on first sight, then memoized and persisted.  Probe passes
        are the only counting a symbolic family ever costs."""
        key = self._digest({"kind": "family", "family": family.key})
        with self._lock:
            sym = self._families.get(key)
            if sym is not None:
                self.hits += 1
                return sym
            if self.store is not None:
                loaded = self._load_json(self._family_path(key))
                if loaded is not None and loaded.get("key") == key \
                        and isinstance(loaded.get("counts"), dict):
                    try:
                        sym = _symbolic_from_json(loaded)
                    except (KeyError, TypeError, ValueError,
                            ZeroDivisionError):
                        sym = None      # a corrupt entry reads as a miss
                    if sym is not None:
                        self._families[key] = sym
                        self.hits += 1
                        return sym
            self.misses += 1

            def probe(**sizes) -> FeatureCounts:
                k = family.build(**sizes)
                return self._trace(k.fn, k.make_args("meta"))

            sym = parametric_counts_from(probe, family.var_degrees,
                                         base=family.base,
                                         scale=family.scale)
            self._families[key] = sym
            if self.store is not None:
                payload = _symbolic_to_json(sym)
                payload.update(version=COUNT_STORE_VERSION, key=key,
                               family=family.key)
                self._save_json(self._family_path(key), payload)
            return sym

    def counts_batch(self, kernels: Sequence[MeasurementKernel]
                     ) -> List[FeatureCounts]:
        """Counts of a whole battery: kernels of one symbolic family share
        one reconstruction and get their rows from vectorized polynomial
        evaluation; the rest go through the concrete cache."""
        with self._lock:
            out: List[Optional[FeatureCounts]] = [None] * len(kernels)
            groups: Dict[str, Tuple[KernelFamily, List[int]]] = {}
            for i, k in enumerate(kernels):
                fam = k.family
                if fam is not None and set(fam.var_degrees) == set(k.sizes):
                    groups.setdefault(fam.key, (fam, []))[1].append(i)
                else:
                    out[i] = self.counts_for(k)
            for fam, idxs in groups.values():
                sym = self.symbolic(fam)
                env = {v: np.asarray([kernels[i].sizes[v] for i in idxs],
                                     np.float64)
                       for v in fam.var_degrees}
                matrix = sym.at_batch(**env)
                for j, i in enumerate(idxs):
                    out[i] = FeatureCounts(
                        {fid: float(col[j]) for fid, col in matrix.items()
                         if col[j] != 0.0})
            return [fc if fc is not None else FeatureCounts()
                    for fc in out]

    # -- persistence --------------------------------------------------------
    @staticmethod
    def _digest(payload: Dict[str, Any]) -> str:
        return hashlib.sha256(json.dumps(
            {**payload, **_store_identity()},
            sort_keys=True).encode()).hexdigest()

    def _counts_path(self, key: str) -> Path:
        return self.store / "counts" / f"{key}.json"

    def _family_path(self, key: str) -> Path:
        return self.store / "families" / f"{key}.json"

    @staticmethod
    def _load_json(path: Path) -> Optional[Dict[str, Any]]:
        try:
            payload = json.loads(path.read_text())
        except (OSError, ValueError):
            return None
        if not isinstance(payload, dict) \
                or payload.get("version") != COUNT_STORE_VERSION:
            return None
        return payload

    @staticmethod
    def _save_json(path: Path, payload: Dict[str, Any]) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_json(path, payload)

    # -- eviction ------------------------------------------------------------
    def gc(self, *, max_age: Optional[float] = None,
           now: Optional[float] = None) -> CountStoreGCStats:
        """Evict stale persisted counts from both tiers (``counts/`` and
        ``families/``): corrupt files (unparseable, not entry-shaped, or
        embedded key ≠ file name), entries of another
        ``COUNT_STORE_VERSION``, and entries older than ``max_age``
        seconds.  Files not named by a 64-hex digest are never touched,
        and the in-process memos are left alone."""
        if now is None:
            now = time.time()
        kept = old = corrupt = stale_schema = 0
        if self.store is None:
            return CountStoreGCStats()
        for sub in ("counts", "families"):
            tier = self.store / sub
            if not tier.is_dir():
                continue
            for path in sorted(tier.glob("*.json")):
                if not _STORE_ENTRY_NAME.fullmatch(path.name):
                    continue
                try:
                    mtime = path.stat().st_mtime
                except OSError:
                    continue    # vanished under a concurrent sweep
                try:
                    payload = json.loads(path.read_text())
                    if not isinstance(payload, dict) \
                            or payload.get("key") != path.stem \
                            or not isinstance(payload.get("counts"), dict):
                        raise ValueError("not a count-store entry")
                except (OSError, ValueError):
                    path.unlink(missing_ok=True)
                    corrupt += 1
                    continue
                if payload.get("version") != COUNT_STORE_VERSION:
                    path.unlink(missing_ok=True)
                    stale_schema += 1
                    continue
                if max_age is not None and now - mtime > max_age:
                    path.unlink(missing_ok=True)
                    old += 1
                    continue
                kept += 1
        return CountStoreGCStats(kept=kept, dropped_old=old,
                                 dropped_corrupt=corrupt,
                                 dropped_schema=stale_schema)

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        """A consistent counter snapshot, taken under the engine lock."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "trace_count": self.trace_count,
                    "families": len(self._families)}
