"""Variant-space enumeration for the predictor-guided autotuner — the
counterpart of ``repro.tuning.space``.

A *tuning space* is the full set of mathematically-equivalent lowerings
of one problem, enumerated from the UIPiCK generators' parameter
lattices (tile sizes, prefetch/layout choices, loop lowerings).  Tags
use the standard filter grammar plus a brace template sugar —

    ["matmul_sq", "n:768", "tile:{32,64,128,256}", "prefetch:{True,False}"]

— which expands to the comma form ``tile:32,64,128,256`` the generators
already cross-product over.

Enumeration is pure construction: kernels are *built* (closures over
sizes), never counted or run, so pricing the whole space stays a
zero-timing operation and a warm re-tune never touches a kernel at all.
The space's :attr:`~TuningSpace.signature` is a content hash over every
variant's (name, sizes, generator source signature) — the key a
:class:`~repro_torch.profiles.TunedChoice` is stored under, so editing a
generator invalidates its recorded winners exactly like it invalidates
its cached timings.  The generator source is the port's, so a choice the
reference recorded never answers a search here; only the JSON form is
shared.

Variants whose behavior is identical are deduplicated: e.g. the
non-prefetch matmul ignores ``tile``, so ``pfFalse_t32`` and
``pfFalse_t64`` are the same program enumerated twice — timing both
would double-bill the confirmation budget for zero information.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.countengine import callable_signature
from repro_torch.core.uipick import (
    ALL_GENERATORS,
    KernelCollection,
    MatchCondition,
    MeasurementKernel,
)

# bumped when the signature recipe changes, so stale TunedChoice keys
# can never collide with fresh ones
SPACE_SIGNATURE_VERSION = 1


def expand_tag_templates(tags: Sequence[str]) -> List[str]:
    """Expand brace templates (``tile:{32,64}``) to the generators'
    comma grammar (``tile:32,64``).  Plain tags pass through; a brace
    that doesn't wrap the whole value is malformed."""
    out: List[str] = []
    for tag in tags:
        if "{" not in tag and "}" not in tag:
            out.append(tag)
            continue
        if ":" not in tag:
            raise ValueError(
                f"tag template {tag!r} has braces but no 'arg:' prefix")
        arg, vals = tag.split(":", 1)
        if not (vals.startswith("{") and vals.endswith("}")
                and "{" not in vals[1:] and "}" not in vals[:-1]):
            raise ValueError(
                f"malformed tag template {tag!r}: braces must wrap the "
                f"whole value list, e.g. {arg}:{{32,64,128}}")
        inner = vals[1:-1].strip()
        if not inner:
            raise ValueError(f"tag template {tag!r} expands to no values")
        out.append(f"{arg}:{inner}")
    return out


def _dedup_equivalent(kernels: Sequence[MeasurementKernel]
                      ) -> List[MeasurementKernel]:
    """Drop variants that are the same program enumerated under
    several parameter points (an unused lattice axis).  Identity is the
    closure-state content signature + concrete sizes; an unsignable
    kernel (sig ``""``) is never deduplicated."""
    seen = set()
    out: List[MeasurementKernel] = []
    for k in kernels:
        sig = callable_signature(k.fn)
        if not sig:
            out.append(k)
            continue
        key = (sig, tuple(sorted(k.sizes.items())))
        if key in seen:
            continue
        seen.add(key)
        out.append(k)
    return out


def space_signature(kernels: Sequence[MeasurementKernel]) -> str:
    """Deterministic content identity of an enumerated space: what the
    variants ARE (names, sizes, generator source), not how they were
    listed.  Computing it builds nothing and counts nothing."""
    variants = [
        {"name": k.name,
         "sizes": {s: int(v) for s, v in sorted(k.sizes.items())},
         "code": k.code_sig}
        for k in kernels
    ]
    variants.sort(key=lambda d: (d["name"],
                                 json.dumps(d["sizes"], sort_keys=True)))
    payload = {"schema": SPACE_SIGNATURE_VERSION, "variants": variants}
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


@dataclass
class TuningSpace:
    """One enumerated variant space: a name for reports, the (expanded)
    tags that enumerate it, and the concrete candidate kernels."""

    name: str
    tags: Tuple[str, ...]
    kernels: List[MeasurementKernel]
    signature: str = field(default="")

    def __post_init__(self):
        if not self.kernels:
            raise ValueError(
                f"tuning space {self.name!r} enumerated no variants from "
                f"tags {list(self.tags)} — nothing to tune")
        names = [k.name for k in self.kernels]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(
                f"tuning space {self.name!r} has duplicate variant "
                f"names {dupes} — winners would be ambiguous")
        if not self.signature:
            self.signature = space_signature(self.kernels)

    def __len__(self) -> int:
        return len(self.kernels)

    @property
    def variant_names(self) -> List[str]:
        return [k.name for k in self.kernels]


def enumerate_space(name: str, tags: Sequence[str], *,
                    collection: Optional[KernelCollection] = None,
                    match: MatchCondition = MatchCondition.SUPERSET,
                    dedup: bool = True) -> TuningSpace:
    """Expand tag templates and enumerate the full variant space."""
    expanded = expand_tag_templates(tags)
    coll = collection or KernelCollection(ALL_GENERATORS)
    kernels = coll.generate_kernels(expanded, generator_match_cond=match)
    if dedup:
        kernels = _dedup_equivalent(kernels)
    return TuningSpace(name=name, tags=tuple(expanded), kernels=kernels)


# the paper's three §8 variant sets, as full tuning spaces (the matmul
# space carries the whole tile × prefetch lattice, not one point)
SECTION8_SPACE_TAGS: List[Tuple[str, List[str]]] = [
    ("dg_diff", ["dg_diff", "dtype:float32", "nelements_dg:32768",
                 "variant:{basic,u_pf,dmat_pf,dmat_pf_T}"]),
    ("stencil", ["finite_diff", "dtype:float32", "n_grid:4096",
                 "variant:{roll,slice}"]),
    ("matmul", ["matmul_sq", "dtype:float32", "n:768",
                "tile:{16,32,64,128}", "prefetch:{True,False}"]),
]


def section8_spaces(*, collection: Optional[KernelCollection] = None
                    ) -> List[TuningSpace]:
    """The three §8 variant sets used by the tests, the autotune study
    and the chip smoke."""
    return [enumerate_space(name, tags, collection=collection)
            for name, tags in SECTION8_SPACE_TAGS]
