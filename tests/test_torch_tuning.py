"""The port's predictor-guided autotuner (``repro_torch.tuning``) against
the reference's (``repro.tuning``): every case of
``tests/test_tuning.py`` on the port, plus parity cases on the same tags,
the same synthetic device and the same inputs through both packages.

The noisy-margin case keeps the reference test's intent (a near-tie band
wider than the model's separation keeps both stencil lowerings, a
narrower one keeps one) with the band computed from the two predicted
times.  The reference's own case fails under jax 0.9: its counter does
not open ``jnp.roll``'s nested jit, so the roll stencil counts nothing
and the predicted slice/roll ratio at n = 1024 is 2.24, wider than its
margin of 1.0.  The port prices ``aten.roll`` at zero for parity, but
its slices are free views, so its two lowerings are 1.0039 apart and
the slice is the cheaper (ROADMAP queue C).
"""
import json
import math
import warnings

import numpy as np
import pytest
import torch

import repro.tuning as rtuning
from repro.api.session import PerfSession as RefSession
from repro.profiles.profile import load_profile as ref_load_profile
from repro.profiles.profile import save_profile as ref_save_profile
from repro.testing.synthdev import exact_profile as ref_exact_profile
from repro.testing.synthdev import fleet_device as ref_fleet_device
from repro_torch.api.session import PerfSession
from repro_torch.core.countengine import CountEngine
from repro_torch.core.uipick import CountingTimer
from repro_torch.deprecation import reset_warnings
from repro_torch.profiles.cache import MeasurementCache
from repro_torch.profiles.profile import (
    ProfileError,
    TunedChoice,
    load_profile,
    merge_profiles,
    save_profile,
)
from repro_torch.testing.synthdev import exact_profile, fleet_device
from repro_torch.tuning import (
    SECTION8_SPACE_TAGS,
    derive_margin,
    enumerate_space,
    exhaustive_search,
    expand_tag_templates,
    prune_candidates,
    section8_spaces,
    true_optimal_set,
    tune_space,
)

# a small cheap space for most tests: both stencil lowerings at 1024²
SMALL_TAGS = ["finite_diff", "dtype:float32", "n_grid:1024",
              "variant:{roll,slice}"]


def small_session(tmp_path, *, cache=True, noise=0.0):
    """Exact-profile synthetic session: zero calibration cost, known
    ground truth, injectable timer."""
    device = fleet_device("citra", noise=noise)
    profile = exact_profile(device)
    mcache = MeasurementCache(tmp_path / "cache", device.fingerprint) \
        if cache else None
    session = PerfSession.open(profile, cache=mcache, timer=device.timer)
    return session, device


def ref_session(noise=0.0):
    device = ref_fleet_device("citra", noise=noise)
    return RefSession.open(ref_exact_profile(device), timer=device.timer)


# ---------------------------------------------------------------------------
# space enumeration
# ---------------------------------------------------------------------------


def test_expand_tag_templates():
    assert expand_tag_templates(
        ["matmul_sq", "n:768", "tile:{32,64}"]) \
        == ["matmul_sq", "n:768", "tile:32,64"]
    # plain comma grammar passes through untouched
    assert expand_tag_templates(["tile:32,64"]) == ["tile:32,64"]
    with pytest.raises(ValueError):
        expand_tag_templates(["tile:{32,64"])       # unbalanced
    with pytest.raises(ValueError):
        expand_tag_templates(["{32,64}"])           # no arg prefix
    with pytest.raises(ValueError):
        expand_tag_templates(["tile:{}"])           # empty


def test_space_enumeration_deterministic():
    a = enumerate_space("s", SMALL_TAGS)
    b = enumerate_space("s", SMALL_TAGS)
    assert a.variant_names == b.variant_names
    assert a.signature == b.signature
    assert len(a) == 2
    # the signature is content identity: a different space differs
    other = enumerate_space("s", ["finite_diff", "dtype:float32",
                                  "n_grid:2048"])
    assert other.signature != a.signature


def test_space_dedups_equivalent_variants():
    # the non-prefetch matmul ignores `tile`: 4 lattice points, 1 program
    space = enumerate_space(
        "m", ["matmul_sq", "dtype:float32", "n:256",
              "prefetch:{False}", "tile:{16,32,64,128}"])
    assert len(space) == 1
    undeduped = enumerate_space(
        "m", ["matmul_sq", "dtype:float32", "n:256",
              "prefetch:{False}", "tile:{16,32,64,128}"], dedup=False)
    assert len(undeduped) == 4


def test_empty_space_refused():
    with pytest.raises(ValueError, match="no variants"):
        enumerate_space("nope", ["finite_diff", "variant:{bogus}"])


@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "lattice"])
@pytest.mark.parametrize("name", [n for n, _ in SECTION8_SPACE_TAGS])
def test_section8_spaces_enumerate_as_the_reference(name, dedup):
    """The same variant names, in the same order, deduplicated (4/2/5)
    and on the lattice (4/2/8)."""
    tags = dict(SECTION8_SPACE_TAGS)[name]
    assert tags == dict(rtuning.SECTION8_SPACE_TAGS)[name]
    mine = enumerate_space(name, tags, dedup=dedup)
    ref = rtuning.enumerate_space(name, tags, dedup=dedup)
    assert mine.variant_names == ref.variant_names
    assert len(mine) == {("dg_diff", True): 4, ("stencil", True): 2,
                         ("matmul", True): 5, ("dg_diff", False): 4,
                         ("stencil", False): 2,
                         ("matmul", False): 8}[(name, dedup)]
    if name == "matmul" and dedup:
        assert mine.variant_names[-1] == "matmul_sq_n768_float32_pfFalse_t16"


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------


def test_prune_top_k_and_fraction():
    preds = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert prune_candidates(preds, top_k=2) == [1, 3]
    # ceil(0.2 * 5) = 1
    assert prune_candidates(preds, top_fraction=0.2) == [1]
    # never fewer than one survivor
    assert prune_candidates([7.0], top_fraction=0.01) == [0]
    with pytest.raises(ValueError):
        prune_candidates(preds, top_fraction=0.0)
    with pytest.raises(ValueError):
        prune_candidates(preds, margin=-0.1)


def test_prune_margin_keeps_near_ties():
    # candidate 2 is within 5% of the cut line, candidate 4 is not
    preds = [1.0, 1.2, 1.23, 2.0]
    assert prune_candidates(preds, top_k=2, margin=0.0) == [0, 1]
    assert prune_candidates(preds, top_k=2, margin=0.05) == [0, 1, 2]
    # margin=0 drops even EXACT ties beyond k (deterministic budget)
    assert prune_candidates([1.0, 1.0, 1.0], top_k=1, margin=0.0) == [0]
    assert prune_candidates([1.0, 1.0, 1.0], top_k=1, margin=0.01) \
        == [0, 1, 2]


@pytest.mark.parametrize("kw", [
    dict(top_k=2), dict(top_fraction=0.2), dict(top_fraction=0.5),
    dict(top_k=1, margin=0.3), dict(top_fraction=0.25, margin=1.0),
    dict(top_k=20)])
def test_prune_candidates_as_the_reference(kw):
    rng = np.random.default_rng(19)
    preds = [float(v) for v in rng.uniform(1.0, 3.0, 13)]
    preds[7] = preds[2]                     # an exact tie
    assert prune_candidates(preds, **kw) \
        == rtuning.prune_candidates(preds, **kw)


def test_derive_margin():
    assert derive_margin(None) == pytest.approx(0.05)
    assert derive_margin(0.0) == 0.0
    assert derive_margin(0.01) == pytest.approx(0.02)
    assert derive_margin(10.0) == pytest.approx(0.5)    # capped


@pytest.mark.parametrize("gmre", [None, 0.0, 0.013, 0.2, 0.25, 3.0])
def test_derive_margin_as_the_reference(gmre):
    assert derive_margin(gmre) == rtuning.derive_margin(gmre)


# ---------------------------------------------------------------------------
# the search loop
# ---------------------------------------------------------------------------


def test_cold_search_is_one_batched_eval(tmp_path):
    session, _device = small_session(tmp_path)
    space = enumerate_space("stencil", SMALL_TAGS)
    assert session.eval_calls == 0
    res = tune_space(session, space, margin=0.0)
    assert not res.warm
    assert session.eval_calls == 1          # the whole space, one eval
    assert res.choice.n_variants == 2
    assert res.choice.n_timed == 1
    assert res.timings_performed == 1
    assert res.choice.predicted.keys() == set(space.variant_names)


def test_synthetic_truth_top1_recovery(tmp_path):
    """The §8 acceptance loop: on every §8 space the pruned search must
    find the ground-truth optimum while timing within budget."""
    session, device = small_session(tmp_path)
    for space in section8_spaces():
        res = tune_space(session, space, margin=0.0)
        budget = max(1, math.ceil(0.2 * len(space)))
        assert res.choice.n_timed <= budget, space.name
        assert res.choice.winner in true_optimal_set(device, space), \
            space.name


@pytest.mark.parametrize("name", ["dg_diff", "matmul"])
def test_section8_winner_as_the_reference_on_citra(tmp_path, name):
    """The same pruned winner and budget as the reference on the same
    exact-profile synthetic device."""
    session, _device = small_session(tmp_path)
    tags = dict(SECTION8_SPACE_TAGS)[name]
    mine = tune_space(session, enumerate_space(name, tags), margin=0.0)
    ref = rtuning.tune_space(ref_session(),
                             rtuning.enumerate_space(name, tags),
                             margin=0.0)
    assert mine.winner == ref.winner
    assert mine.choice.n_timed == ref.choice.n_timed == 1
    assert mine.choice.n_variants == ref.choice.n_variants
    assert mine.choice.model == ref.choice.model == "ovl_flop_mem"


def test_stencil_winner_follows_each_package_s_slice_counts(tmp_path):
    """The §8 stencil is the one space whose winner differs: the
    reference counts its five slices as contiguous stores, the port's
    are free views (ROADMAP queue C), so the reference prices the slice
    lowering 2.24× the roll and the port 0.996×.  Each package's winner
    is the ground-truth optimum of its own counts."""
    session, device = small_session(tmp_path)
    tags = dict(SECTION8_SPACE_TAGS)["stencil"]
    space = enumerate_space("stencil", tags)
    mine = tune_space(session, space, margin=0.0)
    rdev = ref_fleet_device("citra")
    rspace = rtuning.enumerate_space("stencil", tags)
    ref = rtuning.tune_space(
        RefSession.open(ref_exact_profile(rdev), timer=rdev.timer), rspace,
        margin=0.0)
    assert mine.winner == "stencil_slice_n4096_float32"
    assert ref.winner == "stencil_roll_n4096_float32"
    assert mine.winner in true_optimal_set(device, space)
    assert ref.winner in rtuning.true_optimal_set(rdev, rspace)
    p, r = mine.choice.predicted, ref.choice.predicted
    assert p["stencil_slice_n4096_float32"] \
        / p["stencil_roll_n4096_float32"] == pytest.approx(0.99902, abs=1e-5)
    assert r["stencil_slice_n4096_float32"] \
        / r["stencil_roll_n4096_float32"] == pytest.approx(2.2477, abs=1e-3)


def test_warm_retune_zero_timings_zero_traces(tmp_path):
    session, device = small_session(tmp_path)
    space = enumerate_space("stencil", SMALL_TAGS)
    tune_space(session, space, margin=0.0)
    save_profile(session.profile, tmp_path / "prof.json")

    # a FRESH session (fresh engine, fresh timer) over the saved profile:
    # the recorded winner answers with zero work of any kind
    timer = CountingTimer(device.timer)
    warm = PerfSession.open(str(tmp_path / "prof.json"), timer=timer)
    space2 = enumerate_space("stencil", SMALL_TAGS)
    res = tune_space(warm, space2)
    assert res.warm
    assert res.winner in space2.variant_names
    assert timer.calls == 0
    assert warm.engine.trace_count == 0
    assert warm.eval_calls == 0
    # force=True re-searches despite the record
    forced = tune_space(warm, space2, margin=0.0, force=True)
    assert not forced.warm
    assert warm.eval_calls == 1


def test_confirmation_routed_through_cache(tmp_path):
    """A second cold search of the same space (no recorded winner) pays
    ZERO timing passes: survivors hit the measurement cache."""
    session, device = small_session(tmp_path)
    space = enumerate_space("stencil", SMALL_TAGS)
    first = tune_space(session, space, margin=0.0)
    assert first.timings_performed == 1
    # same cache, fresh profile record
    profile2 = exact_profile(device)
    session2 = PerfSession.open(profile2, cache=session.cache,
                                timer=device.timer)
    second = tune_space(session2, space, margin=0.0)
    assert not second.warm
    assert second.choice.n_timed == 1       # still confirmed a survivor
    assert second.timings_performed == 0    # ...from the cache
    assert second.winner == first.winner


def test_exhaustive_baseline_times_everything(tmp_path):
    session, device = small_session(tmp_path, cache=False)
    space = enumerate_space("stencil", SMALL_TAGS)
    winner, measured, timings = exhaustive_search(session, space)
    assert set(measured) == set(space.variant_names)
    assert timings == len(space)
    assert winner in true_optimal_set(device, space)


def test_noisy_device_margin_widens_confirmation(tmp_path):
    """A near-tie band wider than the model's separation of the two
    stencil lowerings keeps both for confirmation, and the
    measured-fastest wins; a narrower band keeps one.  The band is the
    two predicted times' ratio − 1, pinned beside the reference's."""
    session, _device = small_session(tmp_path, noise=0.05)
    space = enumerate_space("stencil", SMALL_TAGS)
    preds = sorted(p.seconds for p in session.predict_batch(
        list(space.kernels), names=space.variant_names))
    band = preds[1] / preds[0] - 1.0
    assert band == pytest.approx(0.0039115, rel=1e-4)
    rspace = rtuning.enumerate_space("stencil", SMALL_TAGS)
    rpreds = sorted(p.seconds for p in ref_session(noise=0.05)
                    .predict_batch(list(rspace.kernels)))
    # the reference's roll counts nothing under jax 0.9: its slice
    # lowering is priced 2.24× the roll, wider than its test's margin 1.0
    assert rpreds[1] / rpreds[0] == pytest.approx(2.2393, abs=1e-3)

    wide = tune_space(session, space, top_k=1, margin=2.0 * band,
                      record=False)
    assert wide.choice.n_timed == 2         # the tie band kept both
    assert wide.winner == min(wide.choice.measured,
                              key=wide.choice.measured.get)
    narrow = tune_space(session, space, top_k=1, margin=0.5 * band,
                        record=False)
    assert narrow.choice.n_timed == 1


# ---------------------------------------------------------------------------
# TunedChoice persistence
# ---------------------------------------------------------------------------


def test_tuned_choice_profile_roundtrip(tmp_path):
    session, _device = small_session(tmp_path)
    space = enumerate_space("stencil", SMALL_TAGS)
    res = tune_space(session, space, margin=0.0)
    path = save_profile(session.profile, tmp_path / "prof.json")
    loaded = load_profile(path)
    assert set(loaded.tuning) == {space.signature}
    assert loaded.tuning[space.signature].to_dict() \
        == res.choice.to_dict()
    # a profile without tuning still loads (and serializes without the key)
    bare = exact_profile(fleet_device("apex"))
    assert "tuning" not in bare.to_dict()
    assert load_profile(save_profile(bare, tmp_path / "bare.json")).tuning \
        == {}


def test_reference_tuning_section_survives_the_port(tmp_path):
    """A profile the reference wrote with its autotuner's winners goes
    through the port's load and save with its tuning section, and the
    rest of it, unchanged; the reference reads the port's file back."""
    rdev = ref_fleet_device("citra")
    rsession = RefSession.open(ref_exact_profile(rdev), timer=rdev.timer)
    for space in rtuning.section8_spaces():
        rtuning.tune_space(rsession, space, margin=0.0)
    ref_path = ref_save_profile(rsession.profile, tmp_path / "ref.json")
    ported = load_profile(ref_path)
    assert len(ported.tuning) == 3
    out = save_profile(ported, tmp_path / "port.json")
    want = json.loads(ref_path.read_text())
    got = json.loads(out.read_text())
    assert got["tuning"] == want["tuning"]
    assert got == want
    assert {sig: c.to_dict() for sig, c in ref_load_profile(out)
            .tuning.items()} == want["tuning"]


def test_merge_profiles_carries_tuning(tmp_path):
    device = fleet_device("citra")
    a, b = exact_profile(device), exact_profile(device)
    space = enumerate_space("stencil", SMALL_TAGS)
    sa = PerfSession.open(a, timer=device.timer)
    tune_space(sa, space, margin=0.0)
    merged = merge_profiles([a, b])
    assert set(merged.tuning) == {space.signature}
    # conflicting winners for the same space refuse to merge
    conflict = TunedChoice.from_dict(a.tuning[space.signature].to_dict())
    conflict.winner = "someone_else"
    b.tuning[space.signature] = conflict
    with pytest.raises(ProfileError, match="conflicting tuned choice"):
        merge_profiles([a, b])


def test_warm_lookup_respects_model_name(tmp_path):
    """A winner recorded under one fit must not answer a search that
    prices with a different fit."""
    session, device = small_session(tmp_path)
    space = enumerate_space("stencil", SMALL_TAGS)
    tune_space(session, space, margin=0.0)
    choice = session.profile.tuning[space.signature]
    assert choice.model == "ovl_flop_mem"
    stale = TunedChoice.from_dict(choice.to_dict())
    stale.model = "some_other_fit"
    session.profile.tuning[space.signature] = stale
    res = tune_space(session, space, margin=0.0)
    assert not res.warm                     # model mismatch → re-search


# ---------------------------------------------------------------------------
# variantselect compatibility layer
# ---------------------------------------------------------------------------


def _variants():
    from repro_torch.core.variantselect import Variant

    space = enumerate_space("stencil", SMALL_TAGS)
    return [Variant(k.name, k.fn, k.make_args) for k in space.kernels]


def _fit_for(device):
    from repro_torch.core.calibrate import FitResult

    model = device.truth_model()
    return model, FitResult(params=dict(device.p_true), residual_norm=0.0,
                            iterations=1, converged=True)


def test_rank_variants_shim_warns_once_and_ranks():
    from repro_torch.core import variantselect as vs

    assert not hasattr(vs, "_ENGINE")       # no module-level engine
    device = fleet_device("citra")
    model, fit = _fit_for(device)
    reset_warnings()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ranked = vs.rank_variants(model, fit, _variants())
        vs.rank_variants(model, fit, _variants())
    deps = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert len(deps) == 1                   # once per process, not per call
    assert [r.predicted_time for r in ranked] \
        == sorted(r.predicted_time for r in ranked)
    assert all(r.measured_time is None for r in ranked)
    reset_warnings()


def test_select_variant_shim_warns_once():
    from repro_torch.core import variantselect as vs

    device = fleet_device("citra")
    model, fit = _fit_for(device)
    reset_warnings()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        best = vs.select_variant(model, fit.params, _variants())
        vs.select_variant(model, fit.params, _variants())
    deps = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert len(deps) == 1
    assert best.name in true_optimal_set(
        device, enumerate_space("stencil", SMALL_TAGS))
    reset_warnings()


def test_rank_variants_measure_through_cache(tmp_path):
    """measure=True confirmation timings route through the measurement
    cache: a second call with the same cache pays zero timing passes."""
    from repro_torch.core import variantselect as vs

    device = fleet_device("citra")
    model, fit = _fit_for(device)
    cache = MeasurementCache(tmp_path / "cache", device.fingerprint)
    timer = CountingTimer(device.timer)
    reset_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ranked = vs.rank_variants(model, fit, _variants(), measure=True,
                                  trials=3, cache=cache, timer=timer)
        assert timer.calls == len(ranked)
        again = vs.rank_variants(model, fit, _variants(), measure=True,
                                 trials=3, cache=cache, timer=timer)
    assert timer.calls == len(ranked)       # all hits the second time
    assert all(r.measured_time is not None for r in again)
    reset_warnings()


def test_ranking_quality_measured_only_top1():
    from repro_torch.core.variantselect import RankedVariant, ranking_quality

    # the predicted-best entry is UNMEASURED: top-1 must be judged among
    # measured entries
    ranked = [
        RankedVariant("a", 1.0, None),
        RankedVariant("b", 2.0, 5.0),
        RankedVariant("c", 3.0, 4.0),
    ]
    q = ranking_quality(ranked)
    assert q["n_measured"] == 2.0
    assert q["top1_correct"] == 0.0         # b predicted-best, c fastest
    assert q["pairwise_agreement"] == 0.0
    good = ranking_quality([
        RankedVariant("a", 1.0, None),
        RankedVariant("b", 2.0, 4.0),
        RankedVariant("c", 3.0, 5.0),
    ])
    assert good["top1_correct"] == 1.0
    assert good["pairwise_agreement"] == 1.0
    vacuous = ranking_quality([RankedVariant("a", 1.0, 2.0)])
    assert vacuous == {"top1_correct": 1.0, "pairwise_agreement": 1.0,
                       "n_measured": 1.0}


def test_predict_time_threads_engine():
    from repro_torch.core.variantselect import predict_time

    device = fleet_device("citra")
    model, fit = _fit_for(device)
    (v,) = _variants()[:1]
    engine = CountEngine()
    t1 = predict_time(model, fit.params, v, engine=engine)
    assert engine.trace_count >= 1
    traces = engine.trace_count
    t2 = predict_time(model, fit.params, v, engine=engine)
    assert engine.trace_count == traces     # memo hit, no re-count
    assert t1 == pytest.approx(t2)


def test_predict_time_as_the_reference():
    """The same variant priced by the same truth fit: the roll stencil
    counts the same in both packages (queue C: roll is free on both
    sides), so the predictions agree to the reference's float32."""
    from repro.core.calibrate import FitResult as RefFit
    from repro.core.variantselect import Variant as RefVariant
    from repro.core.variantselect import predict_time as ref_predict_time
    from repro_torch.core.variantselect import predict_time

    device = fleet_device("citra")
    model, fit = _fit_for(device)
    (v,) = [x for x in _variants() if "roll" in x.name]
    rdev = ref_fleet_device("citra")
    (rk,) = [k for k in rtuning.enumerate_space("s", SMALL_TAGS).kernels
             if "roll" in k.name]
    ref = ref_predict_time(
        rdev.truth_model(), RefFit(params=dict(rdev.p_true),
                                   residual_norm=0.0, iterations=1,
                                   converged=True).params,
        RefVariant(rk.name, rk.fn, rk.make_args))
    assert predict_time(model, fit.params, v) == pytest.approx(ref,
                                                               rel=1e-6)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_search_report_roundtrip(tmp_path, capsys):
    from repro_torch.tuning.cli import main

    prof = tmp_path / "prof.json"
    cache = tmp_path / "cache"
    base = ["search", "--synthetic", "citra", "--smoke", "--trials", "2",
            "--cache-dir", str(cache), "--profile", str(prof),
            "--space", "stencil", "--margin", "0"]
    assert main(base + ["--save", "--verify-optimum",
                        "--max-timed-fraction", "0.2",
                        "--json", str(tmp_path / "out.json")]) == 0
    assert prof.exists()
    # warm rerun: pure cache, exit-coded
    assert main(base + ["--expect-zero-timings"]) == 0
    assert main(["report", str(prof)]) == 0
    out = capsys.readouterr().out
    assert "stencil" in out and "winner" in out


def test_cli_all_section8_spaces_within_budget_then_warm(tmp_path, capsys):
    """Every §8 space on ``citra``: the winner is the ground-truth
    optimum within a 0.2 budget (margin 0: the four DG lowerings are
    exact ties, which any positive near-tie band keeps), then a warm
    re-tune of the saved profile is pure cache."""
    from repro_torch.tuning.cli import main

    prof = tmp_path / "prof.json"
    base = ["search", "--synthetic", "citra", "--smoke", "--trials", "2",
            "--cache-dir", str(tmp_path / "cache"), "--profile", str(prof),
            "--margin", "0"]
    assert main(base + ["--save", "--verify-optimum",
                        "--max-timed-fraction", "0.2"]) == 0
    assert len(load_profile(prof).tuning) == 3
    assert main(base + ["--expect-zero-timings"]) == 0
    assert "totals: 0 timing passes, 0 count traces, 0 batched " \
        "evaluations" in capsys.readouterr().out


def test_cli_without_a_card_refuses_the_card_default(tmp_path):
    """No --synthetic and no card: the default device is cuda, so the
    CLI raises instead of timing the host."""
    from repro_torch.tuning.cli import main

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["search", "--space", "stencil",
              "--profile", str(tmp_path / "p.json")])


def test_cli_unknown_space():
    from repro_torch.tuning.cli import main

    with pytest.raises(SystemExit):
        main(["search", "--synthetic", "citra", "--space", "bogus"])


def test_section8_space_tags_cover_the_paper_sets():
    names = [n for n, _ in SECTION8_SPACE_TAGS]
    assert names == ["dg_diff", "stencil", "matmul"]


# ---------------------------------------------------------------------------
# the autotune study (the reference's benchmarks/autotune_bench.py)
# ---------------------------------------------------------------------------


def test_autotune_study_on_a_synthetic_device():
    """Pruned against exhaustive on ``citra``'s exact profile: 3 timing
    passes against the 14 lattice points, every winner agreeing, and
    the reference benchmark's rows."""
    from repro_torch.studies.autotune import autotune, rows

    device = fleet_device("citra")
    profile = exact_profile(device)
    profile.fits = {"base": profile.fits["ovl_flop_mem"]}
    out = autotune(profile, trials=1, timer=device.timer)
    assert out["timings"] == {"pruned": 3, "exhaustive": 14}
    assert out["speedup_timings_x"] == pytest.approx(14 / 3)
    assert out["winner_agreement"] == [3, 3]
    for name, s in out["spaces"].items():
        assert s["regret"] == pytest.approx(1.0), name
        assert len(s["measured_us"]) == s["n_lattice"]
        assert len(s["predicted_us"]) == s["n_variants"]
        assert s["pruned"]["replay_s"] > 0
    assert [r.split(",")[0] for r in rows(out)] == [
        "autotune.dg_diff.pruned", "autotune.dg_diff.exhaustive",
        "autotune.stencil.pruned", "autotune.stencil.exhaustive",
        "autotune.matmul.pruned", "autotune.matmul.exhaustive",
        "autotune.winner_agreement", "autotune.speedup_wall_x",
        "autotune.speedup_timings_x"]
