"""The port's facade and profile surface, case by case against the
reference's ``tests/test_api.py`` (20 cases) and ``tests/test_profiles.py``
(10 cases): each test here is named like its reference case and runs on
the CPU port.

Where a case must differ, one line says why; the differences are only
these: the port compiles nothing, so ``trace_count`` counts the
evaluators built (one per model signature), not jit traces; its example
tensors are torch's; its entry points default to the card, so the CLI
calls and ``expected_fingerprint="local"`` name ``cpu``.  The
``_torch`` cases at the end pin the repairs the reference's cases do not
reach on their own.
"""
import json
import warnings

import numpy as np
import pytest
import torch

from repro_torch import deprecation
from repro_torch.api import DEFAULT_MODEL, PerfSession, Prediction, \
    PredictionError
from repro_torch.api.errors import suggest_calibration_tags
from repro_torch.core.calibrate import FitResult, fit_model
from repro_torch.core.model import DTYPE, FeatureTable, Model
from repro_torch.core.uipick import (
    ALL_GENERATORS,
    CountingTimer,
    KernelCollection,
    MatchCondition,
    MeasurementKernel,
    gather_feature_values,
)
from repro_torch.profiles import (
    PROFILE_SCHEMA_VERSION,
    DeviceFingerprint,
    MachineProfile,
    ModelFit,
    ProfileError,
    load_profile,
    save_profile,
)
from repro_torch.profiles.cli import main as cli_main
from repro_torch.studies import STUDY_SMOKE_TAGS, scope_accuracy_sweep
from repro_torch.testing.synthdev import fleet_device

FP = DeviceFingerprint(platform="synth", device_kind="api-test", n_devices=1)

OVL_EXPR = ("overlap2(p_madd * f_op_float32_madd, "
            "p_mem * (f_mem_contig_float32_load "
            "+ f_mem_contig_float32_store + f_op_float32_add), p_edge) "
            "+ p_launch * f_sync_launch_kernel")
PARAMS = {"p_madd": 5e-11, "p_mem": 4e-10, "p_launch": 3e-6, "p_edge": 40.0}


def _profile(expr=OVL_EXPR, params=PARAMS, name="ovl_flop_mem",
             fingerprint=FP, trials=4):
    model = Model("f_wall_time_cpu_host", expr)
    fit = FitResult(params=dict(params), residual_norm=0.0, iterations=1,
                    converged=True)
    return MachineProfile(
        fingerprint=fingerprint,
        fits={name: ModelFit.from_fit(model, fit)},
        trials=trials)


def _tiny_kernels(n):
    kernels = []
    for i in range(n):
        size = 8 * (i + 1)

        def make_args(device, s=size):
            return (torch.ones((s,), dtype=torch.float32, device=device),)

        kernels.append(MeasurementKernel(
            name=f"tiny_{size}", fn=lambda x: x * 2.0 + 1.0,
            make_args=make_args, tags={"n": size}, sizes={"n": size}))
    return kernels


# ---------------------------------------------------------------------------
# tests/test_api.py: zero timings, one batched evaluation, exact breakdowns
# ---------------------------------------------------------------------------


def test_predict_batch_100_kernels_zero_timings_one_compiled_eval():
    session = PerfSession.open(_profile(),
                               timer=CountingTimer(lambda k, t: 0.125))
    kernels = _tiny_kernels(120)
    preds = session.predict_batch(kernels)

    assert len(preds) == 120
    assert session.timer.calls == 0             # prediction NEVER times
    assert session.eval_calls == 1              # one batched dispatch
    # no jit: trace_count is the evaluators built, one per model
    assert session.trace_count == 1
    for p in preds:
        total = sum(p.breakdown.values())
        assert abs(total - p.seconds) <= 1e-6 * max(abs(p.seconds), 1e-300)
        assert p.seconds > 0                    # p_launch floor
    session.predict_batch(kernels)
    assert session.eval_calls == 2 and session.trace_count == 1


def test_breakdown_matches_full_model_evaluation():
    session = PerfSession.open(_profile())
    kernels = _tiny_kernels(7)
    preds = session.predict_batch(kernels)
    mf = session.profile.fits["ovl_flop_mem"]
    m = mf.model()
    F = m.align([k.counts() for k in kernels])
    full = m.batched_eval(
        torch.as_tensor([mf.params[n] for n in m.param_names], dtype=DTYPE),
        torch.as_tensor(F, dtype=DTYPE)).numpy()
    for p, direct in zip(preds, full):
        assert p.seconds == pytest.approx(float(direct), rel=1e-5)


def test_overlap_attribution_splits_and_sums_exactly():
    session = PerfSession.open(_profile())
    pred = session.predict(lambda a, b: a @ b,
                           torch.zeros((64, 64), dtype=torch.float32),
                           torch.zeros((64, 64), dtype=torch.float32))
    labels = list(pred.breakdown)
    assert any(lbl.startswith("overlap2[p_madd") for lbl in labels)
    assert any(lbl.startswith("overlap2[p_mem") for lbl in labels)
    assert any("p_launch" in lbl for lbl in labels)
    assert sum(pred.breakdown.values()) == pytest.approx(pred.seconds,
                                                         rel=1e-9, abs=0)
    madd = next(v for lbl, v in pred.breakdown.items()
                if lbl.startswith("overlap2[p_madd"))
    assert madd > 0.5 * pred.seconds


def test_predict_single_equals_batch_row():
    session = PerfSession.open(_profile())
    (k,) = _tiny_kernels(1)
    single = session.predict(k)
    (batched,) = session.predict_batch([k])
    assert single.seconds == batched.seconds
    assert single.breakdown == batched.breakdown
    assert single.kernel == "tiny_8"


def test_predict_accepts_fn_args_pairs_and_callables():
    session = PerfSession.open(_profile())

    def my_kernel(x):
        return x * 3.0

    preds = session.predict_batch(
        [(my_kernel, (torch.ones((16,), dtype=torch.float32),)),
         lambda: torch.zeros((4,), dtype=torch.float32) + 1.0])
    assert preds[0].kernel == "my_kernel[0]"
    assert preds[1].kernel == "kernel[1]"
    named = session.predict(my_kernel, torch.ones((16,), dtype=torch.float32),
                            name="scaled16")
    assert named.kernel == "scaled16"
    assert named.unmodeled["f_op_float32_mul"] == 16.0


def test_prediction_to_dict_and_explain():
    session = PerfSession.open(_profile())
    pred = session.predict(*_tiny_kernels(1))
    d = pred.to_dict()
    assert json.dumps(d)
    assert d["seconds"] == pred.seconds
    text = pred.explain(top=2)
    assert "tiny_8" in text and "%" in text
    assert isinstance(pred, Prediction)


# ---------------------------------------------------------------------------
# tests/test_api.py: facade error paths (typed, actionable)
# ---------------------------------------------------------------------------


def test_open_rejects_foreign_fingerprint_profile(tmp_path):
    path = save_profile(_profile(), tmp_path / "prof.json")
    other = DeviceFingerprint(platform="synth", device_kind="elsewhere",
                              n_devices=2)
    with pytest.raises(ProfileError, match="api-test"):
        PerfSession.open(path, expected_fingerprint=other)
    # "local" is the fingerprint of `device`, which defaults to the card
    with pytest.raises(ProfileError):
        PerfSession.open(path, expected_fingerprint="local", device="cpu")
    assert PerfSession.open(path).profile.fingerprint == FP


def test_missing_model_is_a_typed_error_listing_available_fits():
    session = PerfSession.open(_profile())
    with pytest.raises(PredictionError, match="ovl_flop_mem"):
        session.predict(*_tiny_kernels(1), model="nope")


def test_default_model_resolution():
    single = PerfSession.open(_profile(
        expr="p_launch * f_sync_launch_kernel",
        params={"p_launch": 1e-6}, name="base"))
    assert single.predict(*_tiny_kernels(1)).model == "base"
    prof = _profile()
    prof.fits["other"] = prof.fits[DEFAULT_MODEL]
    prof.fits = {"a": prof.fits[DEFAULT_MODEL], "b": prof.fits["other"]}
    ambiguous = PerfSession.open(prof)
    with pytest.raises(PredictionError, match="pass model="):
        ambiguous.predict(*_tiny_kernels(1))


def test_strict_scope_names_feature_and_calibration_tags():
    session = PerfSession.open(_profile(
        expr="p_madd * f_op_float32_madd "
             "+ p_launch * f_sync_launch_kernel",
        params={"p_madd": 5e-11, "p_launch": 3e-6}, name="lin_flop"))
    (k,) = _tiny_kernels(1)
    with pytest.raises(PredictionError, match="f_op_float32_") as ei:
        session.predict(k, model="lin_flop", strict=True)
    msg = str(ei.value)
    assert "tiny_8" in msg and "lin_flop" in msg
    assert "flops_madd_pattern" in msg
    pred = session.predict(k, model="lin_flop")
    assert "f_op_float32_mul" in pred.unmodeled


def test_corrupted_fit_params_raise_prediction_error_not_keyerror():
    prof = _profile()
    del prof.fits["ovl_flop_mem"].fit.params["p_mem"]
    session = PerfSession.open(prof)
    with pytest.raises(PredictionError, match="p_mem"):
        session.predict(*_tiny_kernels(1))


def test_suggest_calibration_tags_classes():
    assert "matmul_sq" in suggest_calibration_tags("f_op_float32_madd")
    assert "pattern:gather" in \
        suggest_calibration_tags("f_mem_gather_float32_load")
    assert "empty_kernel" in suggest_calibration_tags("f_sync_launch_kernel")
    assert suggest_calibration_tags("f_coll_psum_bytes") == []


# ---------------------------------------------------------------------------
# tests/test_api.py: open(device) calibrates on demand, persists, reopens
# ---------------------------------------------------------------------------


def test_open_device_calibrates_then_reopen_predicts_truth(tmp_path):
    device = fleet_device("citra")
    session = PerfSession.open(device, tags=STUDY_SMOKE_TAGS, trials=3,
                               cache=tmp_path / "cache",
                               save_to=tmp_path / "prof.json")
    assert session.calibration["timings"] > 0
    assert session.calibration["source"].startswith("calibrated:")

    warm = PerfSession.open(tmp_path / "prof.json",
                            cache=tmp_path / "cache",
                            expected_fingerprint=device.fingerprint)
    kernels = KernelCollection(ALL_GENERATORS).generate_kernels(
        ["matmul_sq", "dtype:float32", "prefetch:False", "tile:16",
         "n:256,384,512"], generator_match_cond=MatchCondition.INTERSECT)
    preds = warm.predict_batch(kernels, model="ovl_flop_mem")
    assert warm.timer.calls == 0
    assert warm.eval_calls == 1
    for k, p in zip(kernels, preds):
        assert p.seconds == pytest.approx(device.true_time(k), rel=1e-3)
        assert p.diagnostics["converged"]
        assert p.diagnostics["holdout_gmre"] is not None


def test_curated_top_level_surface():
    import repro_torch

    assert repro_torch.PerfSession is PerfSession
    assert repro_torch.Model is Model
    assert "PerfSession" in repro_torch.__all__
    assert "run_study" in repro_torch.__all__
    with pytest.raises(AttributeError, match="no attribute"):
        repro_torch.does_not_exist


# ---------------------------------------------------------------------------
# tests/test_api.py: deprecation shims warn exactly once
# ---------------------------------------------------------------------------


def test_gather_feature_values_shim_warns_once_and_works():
    deprecation.reset_warnings("gather_feature_values")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rows = gather_feature_values(
            ["f_op_float32_mul"], _tiny_kernels(2),
            timer=CountingTimer(lambda k, t: 0.125))
        gather_feature_values(
            ["f_op_float32_mul"], _tiny_kernels(2),
            timer=CountingTimer(lambda k, t: 0.125))
    deps = [w for w in caught
            if issubclass(w.category, DeprecationWarning)
            and "gather_feature_values" in str(w.message)]
    assert len(deps) == 1
    assert rows[0]["f_op_float32_mul"] == 8.0


def test_eval_with_counts_shim_warns_once_and_works():
    deprecation.reset_warnings("Model.eval_with_counts")
    m = Model("f_wall_time_cpu_host", "p_a * f_x")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        v1 = m.eval_with_counts({"p_a": 2.0}, {"f_x": 3.0})
        v2 = m.eval_with_counts({"p_a": 2.0}, {"f_x": 5.0})
    deps = [w for w in caught
            if issubclass(w.category, DeprecationWarning)
            and "eval_with_counts" in str(w.message)]
    assert len(deps) == 1
    assert (v1, v2) == (6.0, 10.0)


# ---------------------------------------------------------------------------
# tests/test_api.py: the CLI's predict subcommand
# ---------------------------------------------------------------------------

# the CLI targets the card unless told otherwise
CAL_ARGS = ["--tags", "empty_kernel", "nelements:16,1024",
            "--match", "intersect",
            "--expr", "p_launch * f_sync_launch_kernel",
            "--trials", "2", "--device", "cpu"]


def test_cli_predict_zero_timings_and_json(tmp_path):
    prof = tmp_path / "prof.json"
    assert cli_main(CAL_ARGS + ["--out", str(prof)]) == 0
    out = tmp_path / "preds.json"
    rc = cli_main(["predict", str(prof),
                   "--tags", "empty_kernel", "nelements:16,1024",
                   "--expect-zero-timings", "--json", str(out),
                   "--device", "cpu"])
    assert rc == 0
    payload = json.loads(out.read_text())
    assert len(payload["predictions"]) == 2
    for p in payload["predictions"]:
        assert sum(p["breakdown"].values()) == \
            pytest.approx(p["seconds"], rel=1e-9)


def test_cli_predict_error_exit_codes(tmp_path):
    prof = tmp_path / "prof.json"
    assert cli_main(CAL_ARGS + ["--out", str(prof)]) == 0
    cpu = ["--device", "cpu"]
    assert cli_main(["predict", str(prof), "--tags", "empty_kernel",
                     "--model", "nope"] + cpu) == 3
    assert cli_main(["predict", str(prof), "--tags", "no_such_generator",
                     "--match", "identical"] + cpu) == 2
    assert cli_main(["predict", str(tmp_path / "missing.json"),
                     "--tags", "empty_kernel"] + cpu) == 3


# ---------------------------------------------------------------------------
# tests/test_api.py: scope-vs-accuracy sweep
# ---------------------------------------------------------------------------


def test_scope_accuracy_sweep_orders_by_rank_and_averages():
    from repro_torch.studies import StudyReport

    report = StudyReport(
        per_variant={"m1": {}, "m2": {}},
        summary={"m1": {"ovl_flop_mem": 0.04, "lin_flop": 0.01,
                        "custom": 0.5},
                 "m2": {"ovl_flop_mem": 0.01, "lin_flop": 0.04}},
        params={"m1": {"ovl_flop_mem": {"p_a": 1, "p_b": 2, "p_c": 3,
                                        "p_d": 4},
                       "lin_flop": {"p_a": 1, "p_b": 2}, "custom": {}},
                "m2": {"ovl_flop_mem": {"p_a": 1, "p_b": 2, "p_c": 3,
                                        "p_d": 4},
                       "lin_flop": {"p_a": 1, "p_b": 2}}})
    report.per_variant = {"m1": {n: {} for n in report.summary["m1"]},
                          "m2": {n: {} for n in report.summary["m2"]}}
    sweep = scope_accuracy_sweep(report)
    names = [r["model"] for r in sweep["sweep"]]
    assert names == ["lin_flop", "ovl_flop_mem", "custom"]
    ranks = [r["scope_rank"] for r in sweep["sweep"]]
    assert ranks == [0, 2, None]
    lin = sweep["sweep"][0]
    assert lin["n_params"] == 2
    assert lin["fleet_gmre"] == pytest.approx(np.exp(np.mean(
        np.log([0.01, 0.04]))))
    custom = sweep["sweep"][2]
    assert custom["per_machine"] == {"m1": 0.5}


def test_cli_compare_sweep_emits_json_and_markdown(tmp_path):
    for name in ("apex", "bulk"):
        rc = cli_main(["--zoo", "--smoke", "--synthetic", name,
                       "--synthetic-noise", "0.02", "--trials", "2",
                       "--out", str(tmp_path / f"{name}.json")])
        assert rc == 0
    md = tmp_path / "report.md"
    js = tmp_path / "report.json"
    rc = cli_main(["compare", str(tmp_path / "apex.json"),
                   str(tmp_path / "bulk.json"), "--sweep",
                   "--report", str(md), "--json", str(js)])
    assert rc == 0
    assert "Scope vs accuracy" in md.read_text()
    payload = json.loads(js.read_text())
    assert [r["model"] for r in payload["sweep"]] == \
        ["lin_flop", "lin_flop_mem", "ovl_flop_mem"]
    assert all(r["fleet_gmre"] is not None for r in payload["sweep"])


# ---------------------------------------------------------------------------
# tests/test_profiles.py: save → load, strict validation, atomic writes
# ---------------------------------------------------------------------------

PFP = DeviceFingerprint(platform="cpu", device_kind="Test CPU", n_devices=1)


def _fitted_model():
    model = Model("f_wall_time_x", "p_a * f_x + p_b * f_y")
    rows = [{"f_x": float(n ** 3), "f_y": float(n ** 2),
             "f_wall_time_x": 3e-9 * n ** 3 + 7e-10 * n ** 2}
            for n in (64, 96, 128, 192)]
    return model, fit_model(model, rows, nonneg=True)


def _machine_profile(model, fit):
    return MachineProfile(fingerprint=PFP,
                          fits={"base": ModelFit.from_fit(model, fit)},
                          trials=8, kernel_names=["k0", "k1"])


def test_roundtrip_reproduces_parameters_exactly(tmp_path):
    model, fit = _fitted_model()
    path = save_profile(_machine_profile(model, fit), tmp_path / "prof.json")
    loaded = load_profile(path, expected_fingerprint=PFP)
    mf = loaded.fit_for(model)
    assert mf.params == fit.params
    assert mf.fit.residual_norm == fit.residual_norm
    assert mf.fit.iterations == fit.iterations
    assert mf.fit.converged == fit.converged
    feats = {"f_x": 1e6, "f_y": 1e4}
    assert float(model.evaluate(mf.params, feats)) \
        == float(model.evaluate(fit.params, feats))
    assert loaded.trials == 8
    assert loaded.kernel_names == ["k0", "k1"]


def test_save_is_deterministic_and_atomic(tmp_path):
    model, fit = _fitted_model()
    p1 = save_profile(_machine_profile(model, fit), tmp_path / "a.json")
    p2 = save_profile(_machine_profile(model, fit), tmp_path / "b.json")
    assert p1.read_text() == p2.read_text()
    assert not list(tmp_path.glob("*.tmp"))


def test_fit_for_unknown_model_names_available_fits(tmp_path):
    model, fit = _fitted_model()
    path = save_profile(_machine_profile(model, fit), tmp_path / "prof.json")
    other = Model("f_wall_time_x", "p_c * f_z")
    with pytest.raises(ProfileError, match="no fit for model"):
        load_profile(path).fit_for(other)


def test_corrupt_profile_fails_with_clear_error(tmp_path):
    path = tmp_path / "prof.json"
    path.write_text("{ this is not json")
    with pytest.raises(ProfileError, match="not valid JSON"):
        load_profile(path)
    path.write_text("[1, 2, 3]")
    with pytest.raises(ProfileError, match="not a JSON object"):
        load_profile(path)


def test_missing_file_raises_profile_error(tmp_path):
    with pytest.raises(ProfileError, match="cannot read profile"):
        load_profile(tmp_path / "nope.json")


def test_old_schema_rejected(tmp_path):
    model, fit = _fitted_model()
    payload = _machine_profile(model, fit).to_dict()
    payload["schema_version"] = PROFILE_SCHEMA_VERSION - 1
    path = tmp_path / "old.json"
    path.write_text(json.dumps(payload))
    with pytest.raises(ProfileError, match="schema version"):
        load_profile(path)


def test_malformed_fields_rejected(tmp_path):
    model, fit = _fitted_model()
    payload = _machine_profile(model, fit).to_dict()
    del payload["fingerprint"]
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(payload))
    with pytest.raises(ProfileError, match="malformed profile"):
        load_profile(path)


def test_edited_expression_breaks_signature(tmp_path):
    model, fit = _fitted_model()
    payload = _machine_profile(model, fit).to_dict()
    payload["fits"]["base"]["expr"] = "p_a * f_x"
    path = tmp_path / "tampered.json"
    path.write_text(json.dumps(payload))
    with pytest.raises(ProfileError, match="signature mismatch"):
        load_profile(path)


def test_foreign_fingerprint_rejected(tmp_path):
    model, fit = _fitted_model()
    path = save_profile(_machine_profile(model, fit), tmp_path / "prof.json")
    other = DeviceFingerprint(platform="tpu", device_kind="TPU v4",
                              n_devices=8)
    with pytest.raises(ProfileError, match="this machine"):
        load_profile(path, expected_fingerprint=other)
    assert load_profile(path).fingerprint == PFP


def test_fingerprint_id_is_filename_safe():
    fp = DeviceFingerprint(platform="gpu",
                           device_kind="NVIDIA A100-SXM4/40GB",
                           n_devices=4)
    assert "/" not in fp.id and " " not in fp.id
    assert fp.id.startswith("gpu_")


# ---------------------------------------------------------------------------
# the repairs, beyond the reference's cases
# ---------------------------------------------------------------------------


def test_open_checks_an_in_memory_profile_too_torch():
    with pytest.raises(ProfileError, match="api-test"):
        PerfSession.open(_profile(), expected_fingerprint=DeviceFingerprint(
            platform="synth", device_kind="elsewhere", n_devices=1))
    assert PerfSession.open(_profile(), expected_fingerprint=FP).profile \
        .fingerprint == FP


def test_routing_decision_is_on_the_top_level_surface_torch():
    import repro_torch
    from repro_torch.fleet import RoutingDecision

    assert "RoutingDecision" in repro_torch.__all__
    assert repro_torch.RoutingDecision is RoutingDecision


def test_feature_table_rows_and_evaluate_match_the_reference_torch():
    from repro.core.model import FeatureTable as JFeatureTable
    from repro.core.model import Model as JModel

    rows = [{"f_x": 2.0, "f_y": 3.0, "_kernel": "a"},
            {"f_x": 5.0, "_kernel": "b"}]
    assert FeatureTable.from_rows(rows).rows() == \
        JFeatureTable.from_rows(rows).rows()
    assert FeatureTable.from_rows(rows).row(1) == \
        JFeatureTable.from_rows(rows).row(1)
    expr = "overlap2(p_a * f_x, p_b * f_y, p_edge) + p_c"
    params = {"p_a": 1e-9, "p_b": 3e-9, "p_edge": 40.0, "p_c": 2e-6}
    feats = {"f_x": 1e6, "f_y": 4e5}
    got = float(Model("f_t", expr).evaluate(params, feats))
    want = float(JModel("f_t", expr).evaluate(params, feats))
    assert got == pytest.approx(want, rel=1e-6)


def test_fleet_truth_law_evaluates_the_model_torch():
    """``fleet/sim.py`` prices a job with ``Model.evaluate``: the same
    seconds as the batched evaluation of the same counts."""
    from repro_torch.fleet.sim import _truth_law
    from repro_torch.testing.synthdev import default_fleet

    device = default_fleet()[0]
    law = _truth_law(device)
    model = device.truth_model()
    for k in _tiny_kernels(3):
        F = torch.as_tensor(model.align(k.counts()), dtype=DTYPE)
        p = torch.as_tensor([device.p_true[n] for n in model.param_names],
                            dtype=DTYPE)
        assert law(k) == float(model.batched_eval(p, F)[0])
