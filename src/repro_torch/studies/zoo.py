"""The model zoo: named cost-model expressions at increasing scope — a
copy of ``repro.studies.zoo`` (the expressions and batteries are
identical strings, so both packages fit the same forms to the same
kernels).

The paper's central trade-off (§8) is *accuracy vs scope*: a model with
few terms fitted on a narrow battery predicts its own niche extremely well
but nothing else; adding terms (memory bandwidth) and then nonlinearity
(overlap of compute with memory traffic, via ``smooth_step``) widens the
set of kernels the model explains at some cost in per-niche accuracy.

The zoo pins that ladder as a registry so every machine in a cross-machine
study calibrates the SAME model forms over ONE gathered battery — one
timing pass, many fits — and accuracy tables are comparable across both
machines and model forms.  Entries are ordered by ``scope_rank``; the
closed-loop tests assert the paper's ordering (broader-scope models are no
worse on held-out variants when the underlying truth is nonlinear).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.core.model import Model
from repro_torch.profiles.presets import DEFAULT_OUTPUT_FEATURE

# The "memory bandwidth" feature class, as this repo's counter sees it:
# counted contiguous element traffic (dot operands/results, materializing
# shape ops) PLUS elementwise streamed arithmetic — the counter attributes
# an n-element streaming add as n `f_op_float32_add`, and on a host that
# class is bandwidth-bound (the same mapping as BASE_MODEL_EXPR's p_alu
# term).  mem_stream contig kernels count ONLY the elementwise part.
_MEM = ("(f_mem_contig_float32_load + f_mem_contig_float32_store "
        "+ f_op_float32_add)")


@dataclass(frozen=True)
class ZooEntry:
    """One named model form in the scope ladder.

    ``recoverable`` names the parameters whose ground-truth values a
    closed-loop synthetic study is expected to recover; smoothing shape
    parameters (``p_edge``) are excluded because the likelihood is nearly
    flat along them once the step is sharp enough — they localize the
    crossover, not a physical rate.
    """

    name: str
    scope_rank: int
    expr: str
    nonneg: bool = True
    recoverable: Tuple[str, ...] = field(default=())

    def model(self, output_feature: str = DEFAULT_OUTPUT_FEATURE) -> Model:
        return Model(output_feature, self.expr)


# scope rank 0 — the paper's §2 minimal form: flop cost + launch overhead.
LIN_FLOP = ZooEntry(
    name="lin_flop",
    scope_rank=0,
    expr="p_madd * f_op_float32_madd + p_launch * f_sync_launch_kernel",
    recoverable=("p_madd", "p_launch"),
)

# scope rank 1 — add a memory-bandwidth term (paper §8.1's linear form):
# now stream kernels are in scope, matmuls keep their flop attribution.
LIN_FLOP_MEM = ZooEntry(
    name="lin_flop_mem",
    scope_rank=1,
    expr=("p_madd * f_op_float32_madd "
          f"+ p_mem * {_MEM} "
          "+ p_launch * f_sync_launch_kernel"),
    recoverable=("p_madd", "p_mem", "p_launch"),
)

# scope rank 2 — nonlinear overlap (paper §7.4): compute and memory
# traffic overlap, so total time approaches max(flop term, mem term);
# overlap2 is the smooth_step-gated differentiable form of that max.
OVL_FLOP_MEM = ZooEntry(
    name="ovl_flop_mem",
    scope_rank=2,
    expr=(f"overlap2(p_madd * f_op_float32_madd, p_mem * {_MEM}, p_edge) "
          "+ p_launch * f_sync_launch_kernel"),
    nonneg=False,           # p_edge must float freely (paper §7.4 fits)
    recoverable=("p_madd", "p_mem", "p_launch"),
)

MODEL_ZOO: List[ZooEntry] = [LIN_FLOP, LIN_FLOP_MEM, OVL_FLOP_MEM]

_BY_NAME: Dict[str, ZooEntry] = {e.name: e for e in MODEL_ZOO}


def zoo_entry(name: str) -> ZooEntry:
    if name not in _BY_NAME:
        raise KeyError(f"unknown zoo model {name!r}; "
                       f"available: {sorted(_BY_NAME)}")
    return _BY_NAME[name]


def zoo_models(output_feature: str = DEFAULT_OUTPUT_FEATURE
               ) -> Dict[str, Model]:
    """All zoo model forms instantiated against one output feature."""
    return {e.name: e.model(output_feature) for e in MODEL_ZOO}


# ---------------------------------------------------------------------------
# Study batteries (UIPiCK filter tags, INTERSECT match)
# ---------------------------------------------------------------------------

# flop-heavy (matmuls), memory-heavy (contiguous streams), and
# launch-overhead (empty) kernels: every zoo parameter has rows where its
# term dominates, which is what makes the multi-fit identifiable.
STUDY_TAGS = [
    "matmul_sq", "mem_stream", "empty_kernel",
    "dtype:float32", "prefetch:False", "tile:16", "pattern:contig",
    "n:256,384,512,640,768,1024",
    # `nelements` is shared by mem_stream and empty_kernel; each generator
    # keeps only the values its argument space allows
    "nelements:16,1024,65536,262144,1048576,4194304",
    "n_arrays:1,2,4",
]

# CI-sized battery: same three kernel classes, fewer variants.
STUDY_SMOKE_TAGS = [
    "matmul_sq", "mem_stream", "empty_kernel",
    "dtype:float32", "prefetch:False", "tile:16", "pattern:contig",
    "n:256,384,512",
    "nelements:16,1024,262144,1048576",
    "n_arrays:1,2",
]
