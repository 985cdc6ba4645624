"""Predictor-guided autotuning — the counterpart of ``repro.tuning``:
price a whole variant space in one batched evaluation, time only the
pruned top-k, persist winners per machine (``MachineProfile.tuning``) so
warm re-tunes are pure cache.

* :func:`enumerate_space` / :class:`TuningSpace` — variant-space
  enumeration from UIPiCK generator parameters (brace tag templates)
* :func:`tune_space` / :class:`TuneResult` — the search loop
  (price → prune → confirm → record)
* :func:`prune_candidates` / :func:`derive_margin` — top-k pruning with
  a held-out-gmre near-tie margin
* :func:`exhaustive_search` — the time-everything baseline
* :class:`TunedChoice` — the persisted winner (re-exported from
  ``repro_torch.profiles``)

CLI: ``python -m repro_torch.tune`` (search / report).
"""
from repro_torch.profiles.profile import TunedChoice
from repro_torch.tuning.space import (
    SECTION8_SPACE_TAGS,
    TuningSpace,
    enumerate_space,
    expand_tag_templates,
    section8_spaces,
    space_signature,
)
from repro_torch.tuning.tuner import (
    DEFAULT_MARGIN,
    TuneResult,
    TuningError,
    confirm_time,
    derive_margin,
    exhaustive_search,
    prune_candidates,
    true_optimal_set,
    tune_space,
)

__all__ = [
    "DEFAULT_MARGIN",
    "SECTION8_SPACE_TAGS",
    "TunedChoice",
    "TuneResult",
    "TuningError",
    "TuningSpace",
    "confirm_time",
    "derive_margin",
    "enumerate_space",
    "exhaustive_search",
    "expand_tag_templates",
    "prune_candidates",
    "section8_spaces",
    "space_signature",
    "true_optimal_set",
    "tune_space",
]
