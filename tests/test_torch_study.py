"""The port's model-zoo study against the reference, on the CPU.

Both packages run ``run_study`` on the same synthetic device (``apex``,
noiseless and at 2% noise) over ``STUDY_SMOKE_TAGS``; the device's
timings are a hash of the kernel's identity, so both fit the same
table.  Held to: identical battery and train/held-out names, fitted
rates per rung within rtol 1e-4, held-out gmre and ``compare --sweep``
numbers within 1e-4 absolute, closed-loop recovery (rtol ≤ 1e-5
noiseless, ≤ 5e-2 at 2% noise, the reference's own bounds), the
reference's
identifiability codes on the same tables, ``PerfSession.open(None)``
through a synthetic timer, and the ``--zoo --synthetic`` CLI.

``p_edge`` (the overlap's smoothing sharpness) is compared nowhere: the
likelihood is nearly flat along it, so both packages leave it wherever
their multi-starts land (``ZooEntry.recoverable`` excludes it).
"""
import json

import numpy as np
import pytest

from repro.analysis.identifiability import analyze_model as janalyze
from repro.core.model import Model as JModel
from repro.profiles import load_profile as jload_profile
from repro.studies import compare_profiles as jcompare
from repro.studies import run_study as jrun_study
from repro.studies import scope_accuracy_sweep as jsweep
from repro.studies import zoo as jzoo
from repro.testing.synthdev import fleet_device as jfleet_device
from repro_torch.analysis.identifiability import analyze_model
from repro_torch.analysis.targets import kernel_targets
from repro_torch.api import PerfSession
from repro_torch.core import uipick as tuipick
from repro_torch.core.calibrate import fit_models
from repro_torch.core.model import Model
from repro_torch.profiles import load_profile
from repro_torch.profiles.cli import main as cli_main
from repro_torch.studies import (
    MODEL_ZOO,
    STUDY_SMOKE_TAGS,
    STUDY_TAGS,
    StudyError,
    compare_profiles,
    run_study,
    scope_accuracy_sweep,
    zoo,
)
from repro_torch.testing.synthdev import exact_profile, fleet_device

NOISELESS_RTOL = 1e-5
NOISY_RTOL = 5e-2
PARITY_RTOL = 1e-4
GMRE_ATOL = 1e-4
NOISES = (0.0, 0.02)


@pytest.fixture(scope="module")
def studies():
    """noise → (port profile, reference profile), apex, smoke battery."""
    out = {}
    for noise in NOISES:
        dev, jdev = fleet_device("apex", noise=noise), \
            jfleet_device("apex", noise=noise)
        out[noise] = (
            run_study(fingerprint=dev.fingerprint, timer=dev.timer,
                      tags=STUDY_SMOKE_TAGS, trials=3),
            jrun_study(fingerprint=jdev.fingerprint, timer=jdev.timer,
                       tags=STUDY_SMOKE_TAGS, trials=3))
    return out


def test_zoo_is_the_reference_zoo():
    assert [(e.name, e.scope_rank, e.expr, e.nonneg, e.recoverable)
            for e in MODEL_ZOO] == \
        [(e.name, e.scope_rank, e.expr, e.nonneg, e.recoverable)
         for e in jzoo.MODEL_ZOO]
    assert (STUDY_TAGS, STUDY_SMOKE_TAGS) == \
        (jzoo.STUDY_TAGS, jzoo.STUDY_SMOKE_TAGS)
    assert zoo.zoo_entry("lin_flop_mem").expr == \
        jzoo.zoo_entry("lin_flop_mem").expr
    with pytest.raises(KeyError):
        zoo.zoo_entry("quadratic")


@pytest.mark.parametrize("tags", [STUDY_TAGS, STUDY_SMOKE_TAGS],
                         ids=["full", "smoke"])
def test_study_battery_and_counts_match_reference(tags):
    from repro.core import uipick as juipick
    t = tuipick.KernelCollection(tuipick.ALL_GENERATORS).generate_kernels(
        tags, tuipick.MatchCondition.INTERSECT)
    j = juipick.KernelCollection(juipick.ALL_GENERATORS).generate_kernels(
        tags, juipick.MatchCondition.INTERSECT)
    assert [k.name for k in t] == [k.name for k in j]
    assert len(t) == (18 if tags is STUDY_TAGS else 9)
    feats = sorted({f for e in MODEL_ZOO for f in e.model().feature_names})
    for tk, jk in zip(t, j):
        assert {f: tk.counts()[f] for f in feats} == \
            {f: jk.counts()[f] for f in feats}, tk.name


@pytest.mark.parametrize("noise", NOISES)
def test_run_study_matches_reference(studies, noise):
    port, ref = studies[noise]
    assert port.kernel_names == ref.kernel_names
    assert port.holdout.row_names == ref.holdout.row_names
    assert port.fingerprint.to_dict() == ref.fingerprint.to_dict()
    for e in MODEL_ZOO:
        got, want = port.fits[e.name], ref.fits[e.name]
        assert got.signature == want.signature
        for p in e.recoverable:
            np.testing.assert_allclose(got.params[p], want.params[p],
                                       rtol=PARITY_RTOL, err_msg=p)


@pytest.mark.parametrize("noise,rtol", [(0.0, NOISELESS_RTOL),
                                        (0.02, NOISY_RTOL)])
def test_closed_loop_recovery(studies, noise, rtol):
    port, _ = studies[noise]
    dev = fleet_device("apex", noise=noise)
    mf = port.fits[dev.truth.name]
    errs = {p: abs(mf.params[p] - dev.p_true[p]) / dev.p_true[p]
            for p in dev.truth.recoverable}
    assert max(errs.values()) <= rtol, errs


@pytest.mark.parametrize("truth", MODEL_ZOO, ids=lambda e: e.name)
def test_noiseless_recovery_every_rung(truth):
    dev = fleet_device("citra", truth=truth)
    profile = run_study(fingerprint=dev.fingerprint, timer=dev.timer,
                        tags=STUDY_SMOKE_TAGS, trials=2)
    mf = profile.fits[truth.name]
    for p in truth.recoverable:
        assert abs(mf.params[p] - dev.p_true[p]) / dev.p_true[p] \
            <= NOISELESS_RTOL, (p, mf.params)


def test_synthetic_timer_matches_reference():
    """Equal counts give equal timings, up to the reference's float32
    evaluation of the truth model."""
    dev, jdev = fleet_device("bulk", noise=0.1), \
        jfleet_device("bulk", noise=0.1)
    from repro.core import uipick as juipick
    t = tuipick.KernelCollection(tuipick.ALL_GENERATORS).generate_kernels(
        STUDY_SMOKE_TAGS, tuipick.MatchCondition.INTERSECT)
    j = juipick.KernelCollection(juipick.ALL_GENERATORS).generate_kernels(
        STUDY_SMOKE_TAGS, juipick.MatchCondition.INTERSECT)
    for tk, jk in zip(t, j):
        np.testing.assert_allclose(dev.timer(tk, 3).median,
                                   jdev.timer(jk, 3).median, rtol=1e-6)
    assert exact_profile(dev).fits["ovl_flop_mem"].params == dev.p_true


def test_fit_models_warm_start_matches_reference():
    """The ladder on one table: both packages' ``fit_models`` over the
    smoke battery of a noisy synthetic device, the two linear rungs in
    zoo order (the second starts from the first's rates)."""
    from repro.core.calibrate import fit_models as jfit_models
    from repro.core.model import FeatureTable as JTable
    entries = MODEL_ZOO[:2]
    models = {e.name: e.model() for e in entries}
    jmodels = {e.name: JModel(e.model().output_feature, e.expr)
               for e in entries}
    features = sorted({f for m in models.values()
                       for f in m.all_features()})
    dev = fleet_device("apex", noise=0.02)
    table = tuipick.gather_feature_table(
        features, tuipick.KernelCollection(tuipick.ALL_GENERATORS)
        .generate_kernels(STUDY_SMOKE_TAGS, tuipick.MatchCondition.INTERSECT),
        trials=3, timer=dev.timer)
    rows = [dict(zip(table.feature_ids, r)) for r in table.values]
    got = fit_models(models, table)
    want = jfit_models(jmodels, JTable.from_rows(rows))
    for name in models:
        for p, v in want[name].params.items():
            np.testing.assert_allclose(got[name].params[p], v,
                                       rtol=PARITY_RTOL, err_msg=(name, p))


def _rows_models():
    """Under-determined tables: (expression, rows) pairs."""
    return [
        ("p_a * f_x + p_b * f_x", [{"f_x": 1.0}, {"f_x": 2.0},
                                   {"f_x": 3.0}]),
        ("p_a * f_x + p_b * f_y", [{"f_x": 1.0}, {"f_x": 2.0}]),
        ("p_a * f_x + p_b * f_y", [{"f_x": 1.0, "f_y": 2.0}]),
        ("p_a * f_x + p_b * f_y + p_c * f_z",
         [{"f_x": 1.0, "f_y": 0.0, "f_z": 1.0 + 1e-6},
          {"f_x": 0.0, "f_y": 1.0, "f_z": 1.0 + 1e-6},
          {"f_x": 1.0, "f_y": 1.0, "f_z": 2.0 - 1e-6}]),
        ("p_a * f_x + p_b * f_y", [{"f_x": 1.0, "f_y": 0.0},
                                   {"f_x": 0.0, "f_y": 1.0},
                                   {"f_x": 2.0, "f_y": 3.0}]),
        (MODEL_ZOO[2].expr.replace("f_op_float32_add", "f_op_float32_madd"),
         None),
    ]


@pytest.mark.parametrize("case", range(6))
def test_identifiability_codes_match_reference(case):
    expr, rows = _rows_models()[case]
    out = "f_wall_time_cpu_host"
    m, jm = Model(out, expr), JModel(out, expr)
    if rows is None:    # the study battery's train split, zoo-like rung
        kernels = tuipick.KernelCollection(tuipick.ALL_GENERATORS) \
            .generate_kernels(["matmul_sq", "dtype:float32", "n:256,512",
                               "prefetch:False", "tile:16"],
                              tuipick.MatchCondition.INTERSECT)
        rows = [k.counts() for k in kernels]
    F = m.align(rows, missing="zero")
    np.testing.assert_array_equal(F, jm.align(rows, missing="zero"))
    got = analyze_model(m, F, "model:x")
    want = janalyze(jm, F, "model:x")
    assert [(d.severity, d.code, d.location) for d in got] == \
        [(d.severity, d.code, d.location) for d in want]
    assert [d.details.get("params") for d in got] == \
        [d.details.get("params") for d in want]


def test_run_study_refuses_unidentifiable_rung_unless_forced():
    dev = fleet_device("citra")
    twin = zoo.ZooEntry(
        name="twin_madd", scope_rank=0,
        expr="p_a * f_op_float32_madd + p_b * f_op_float32_madd "
             "+ p_launch * f_sync_launch_kernel")
    with pytest.raises(StudyError, match="collinear-parameters"):
        run_study(fingerprint=dev.fingerprint, timer=dev.timer,
                  tags=STUDY_SMOKE_TAGS, trials=2, entries=[twin])
    profile = run_study(fingerprint=dev.fingerprint, timer=dev.timer,
                        tags=STUDY_SMOKE_TAGS, trials=2, entries=[twin],
                        force=True)
    assert "twin_madd" in profile.fits
    with pytest.raises(StudyError, match="holdout_fraction"):
        run_study(fingerprint=dev.fingerprint, timer=dev.timer,
                  holdout_fraction=1.0)


def test_compare_and_sweep_match_reference(studies):
    port = compare_profiles([studies[n][0] for n in NOISES])
    ref = jcompare([studies[n][1] for n in NOISES])
    assert port.machines == ref.machines
    for fp in ref.machines:
        assert port.summary[fp].keys() == ref.summary[fp].keys()
        for name, v in ref.summary[fp].items():
            # gmre is a fraction: within 1e-4 absolute (0.01 points of
            # percent); rates agree to ~1e-5, which moves a 0.4% held-out
            # error by ~1e-3 of itself
            np.testing.assert_allclose(port.summary[fp][name], v,
                                       rtol=0, atol=GMRE_ATOL)
        for name, errs in ref.per_variant[fp].items():
            assert port.per_variant[fp][name].keys() == errs.keys()
    sweep, jsw = scope_accuracy_sweep(port), jsweep(ref)
    assert [(r["model"], r["scope_rank"], r["n_params"])
            for r in sweep["sweep"]] == \
        [(r["model"], r["scope_rank"], r["n_params"]) for r in jsw["sweep"]]
    for row, jrow in zip(sweep["sweep"], jsw["sweep"]):
        for fp, v in jrow["per_machine"].items():
            np.testing.assert_allclose(row["per_machine"][fp], v,
                                       rtol=0, atol=GMRE_ATOL)
    json.dumps(port.to_json_dict())
    assert "Scope vs accuracy" not in port.to_markdown()
    with pytest.raises(StudyError, match="more than once"):
        compare_profiles([studies[0.0][0], studies[0.0][0]])
    with pytest.raises(StudyError, match="at least 2"):
        compare_profiles([studies[0.0][0]])


def test_open_none_calibrates_through_a_timer_and_predicts_free(tmp_path):
    dev = fleet_device("apex")
    session = PerfSession.open(None, timer=dev.timer, device="cpu",
                               tags=STUDY_SMOKE_TAGS, trials=2,
                               save_to=tmp_path / "cpu.json")
    assert session.profile.fingerprint.platform == "cpu"
    assert load_profile(tmp_path / "cpu.json").to_dict() == \
        session.profile.to_dict()
    assert sorted(session.profile.fits) == sorted(e.name for e in MODEL_ZOO)
    timed = session.timer.calls
    assert timed == 9
    targets = kernel_targets()
    preds = session.predict_batch([(t.fn, t.args) for t in targets],
                                  names=[t.name for t in targets])
    assert session.timer.calls == timed and session.eval_calls == 1
    assert all(p.seconds > 0 for p in preds)
    # a device object calibrates that device, as in the reference
    synth = PerfSession.open(dev, tags=STUDY_SMOKE_TAGS, trials=2)
    assert synth.profile.fingerprint == dev.fingerprint
    with pytest.raises(TypeError):
        PerfSession.open(3.5)


def test_cli_zoo_synthetic_round_trip(tmp_path, capsys):
    out_a, out_b = tmp_path / "apex.json", tmp_path / "bulk.json"
    for name, out in (("apex", out_a), ("bulk", out_b)):
        assert cli_main(["--zoo", "--smoke", "--synthetic", name,
                         "--synthetic-noise", "0.02", "--trials", "2",
                         "--device", "cpu", "--out", str(out)]) == 0
    profile = load_profile(out_a)
    assert sorted(profile.fits) == sorted(e.name for e in MODEL_ZOO)
    assert len(profile.holdout) == 2 and len(profile.kernel_names) == 9
    # the reference reads the port's study profile unchanged
    assert jload_profile(out_a).to_dict() == profile.to_dict()
    capsys.readouterr()
    sweep_json = tmp_path / "cmp.json"
    assert cli_main(["compare", str(out_a), str(out_b), "--sweep",
                     "--json", str(sweep_json)]) == 0
    stdout = capsys.readouterr().out
    assert "Scope vs accuracy" in stdout and "sweep rank=2" in stdout
    payload = json.loads(sweep_json.read_text())
    assert [r["model"] for r in payload["sweep"]] == \
        [e.name for e in MODEL_ZOO]
    assert cli_main(["compare", str(out_a)]) == 3
    for rung in ("lin_flop", "lin_flop_mem", "ovl_flop_mem"):
        assert cli_main(["predict", str(out_a), "--model", rung,
                         "--kernel", "kernels.ops.stream_strided",
                         "--device", "cpu", "--expect-zero-timings"]) == 0
        assert f"model={rung} held-out gmre=" in capsys.readouterr().out
    assert cli_main(["--zoo", "--synthetic", "nowhere",
                     "--out", str(tmp_path / "x.json")]) == 2
