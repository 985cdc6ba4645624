"""The row-by-row reference fit and the four benches the port adds
(``studies/{calibration,counting,predict,study}_bench.py``) with their
harness ``studies/run.py``.

* The port's ``reference_fit_model`` against the reference's on the two
  fixtures of ``tests/test_perflex.py`` (rel 1e-4; the reference under
  ``jax_enable_x64``, as the port solves in float64 from its x64
  restarts), and the port's batched ``fit_model`` against the port's
  reference engine, as ``test_batched_fit_matches_reference_engine``
  holds the reference's.
* Each bench's rows at a reduced size: the reference's names, three CSV
  fields, a number in the second; the calibration bench at full size
  agrees with its reference arm to 1e-4.
* The harness: the reference's bench names (``roofline`` among them),
  subset selection, a ``.FAILED`` row, its error on an unknown bench,
  and ``roofline``'s note row without dry-run records.
"""
import re
from pathlib import Path

import jax
import pytest

from repro.core.calibrate_reference import reference_fit_model as \
    jreference_fit_model
from repro.core.model import Model as JModel
from repro_torch.core.calibrate import fit_model
from repro_torch.core.calibrate_reference import reference_fit_model
from repro_torch.core.model import Model
from repro_torch.studies import run
from repro_torch.studies.zoo import STUDY_SMOKE_TAGS

ROOT = Path(__file__).resolve().parents[1]


def _linear_fixture():
    expr = "p_a * f_x + p_b * f_y"
    true_p = (3e-9, 7e-10)
    rows = []
    for n in (64, 96, 128, 192, 256):
        fx, fy = float(n ** 3), float(n ** 2)
        rows.append({"f_x": fx, "f_y": fy,
                     "f_wall_time_x": true_p[0] * fx + true_p[1] * fy})
    return expr, rows


def _overlap_fixture():
    expr = "overlap2(p_g * f_g, p_c * f_c, p_edge)"
    pg, pc = 1e-9, 4e-9
    rows = []
    for fg, fc in [(1e6, 0), (2e6, 0), (4e6, 1e4), (1e6, 1e5), (2e6, 1e5),
                   (1e6, 5e5), (1e6, 1e6), (1e6, 4e6), (1e6, 1e7),
                   (1e6, 4e7), (2e6, 4e7)]:
        rows.append({"f_g": fg, "f_c": fc,
                     "f_wall_time_x": max(pg * fg, pc * fc)})
    return expr, rows


FIXTURES = [(_linear_fixture, True), (_overlap_fixture, False)]


@pytest.fixture
def reference_x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("fixture,nonneg", FIXTURES)
def test_reference_fit_matches_the_jax_reference_engine(fixture, nonneg,
                                                        reference_x64):
    expr, rows = fixture()
    want, want_rn = jreference_fit_model(JModel("f_wall_time_x", expr), rows,
                                         nonneg=nonneg)
    got, got_rn = reference_fit_model(Model("f_wall_time_x", expr), rows,
                                      nonneg=nonneg)
    assert set(got) == set(want)
    for n, v in want.items():
        assert got[n] == pytest.approx(v, rel=1e-4, abs=1e-30), n


@pytest.mark.parametrize("fixture,nonneg", FIXTURES)
def test_batched_fit_matches_reference_engine(fixture, nonneg):
    expr, rows = fixture()
    model = Model("f_wall_time_x", expr)
    ref_params, _ = reference_fit_model(model, rows, nonneg=nonneg)
    fit = fit_model(model, rows, nonneg=nonneg)
    for n, v in ref_params.items():
        assert fit.params[n] == pytest.approx(v, rel=1e-4, abs=1e-30), n


def _check_rows(rows, names):
    assert [r.split(",", 1)[0] for r in rows] == names
    for r in rows:
        fields = r.split(",")
        assert len(fields) == 3, r
        float(fields[1])


def test_calibration_bench_rows_and_agreement():
    """At the reference's size (64 rows, 3 seeds) the batched fit is
    within 1e-4 of the row-by-row engine on every parameter."""
    from repro_torch.studies import calibration_bench as b

    result = b.calibration_bench()
    _check_rows(b.rows(result), [
        "calibration.fit64x3_reference", "calibration.fit64x3_batched_cold",
        "calibration.fit64x3_batched_warm",
        "calibration.param_max_rel_diff"])
    assert result["param_max_rel_diff"] < 1e-4
    assert set(result["params"]) == set(b.TRUE_PARAMS)


def test_calibration_bench_table_is_the_reference_s():
    """The same 64 rows from ``RandomState(20190417)`` as the
    reference's bench."""
    import numpy as np

    from benchmarks.calibration_bench import synthetic_table as jtable
    from repro_torch.studies.calibration_bench import synthetic_table

    got, want = synthetic_table(), jtable()
    assert got.feature_ids == want.feature_ids
    assert got.row_names == want.row_names
    np.testing.assert_array_equal(got.values, want.values)


def test_counting_bench_rows():
    from repro_torch.studies import counting_bench as b

    result = b.counting_bench(n_sizes=4, batch=16, unique=4)
    _check_rows(b.rows(result), [
        "counting.trace_per_size_us", "counting.family_cold_us",
        "counting.family_warm_us", "counting.predict_no_dedup_us",
        "counting.predict_dedup_us", "counting.engine_traces",
        "counting.breakdown_residual"])
    assert result["family_cold_traces"] == 4      # degree 3: 4 probes
    assert result["breakdown_residual_s"] <= 1e-12


def test_predict_bench_rows():
    from repro_torch.studies import predict_bench as b

    result = b.predict_bench(n_kernels=16, repeats=1)
    _check_rows(b.rows(result), [
        "predict.single_us_per_kernel", "predict.batched_us_per_kernel",
        "predict.batch_size", "predict.breakdown_residual"])
    assert result["timings"] == 0
    assert result["batch_size"] == 16


def test_study_bench_rows():
    from repro_torch.studies import study_bench as b

    result = b.study_bench(tags=STUDY_SMOKE_TAGS)
    _check_rows(b.rows(result), [
        "study.fleet_cold_3dev", "study.fleet_warm_3dev",
        "study.compare_3dev", "study.recovery_apex", "study.recovery_bulk",
        "study.recovery_citra"])


def test_harness_names_every_reference_bench_in_its_order():
    """The harness lists every one of the reference's benches,
    ``roofline`` too, in the reference's order."""
    src = (ROOT / "benchmarks" / "run.py").read_text()
    body = src[src.index("benches = {"):src.index("only = ")]
    reference = re.findall(r'"(\w+)":', body)
    assert "roofline" in reference
    assert list(run.BENCHES) == reference


def test_harness_runs_a_subset_and_turns_a_failure_into_a_row(
        monkeypatch, capsys):
    seen = []

    def ok(ctx):
        seen.append(ctx.device.type)
        return ["good.row,1.5,x"]

    def broken(ctx):
        raise KeyError("boom")

    monkeypatch.setattr(run, "BENCHES", {"good": ok, "bad": broken,
                                         "other": ok})
    assert run.main(["bad", "good", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[1] == "good.row,1.5,x"
    assert re.fullmatch(r"good\.bench_wall_s,\d+,", lines[2])
    assert lines[3] == "bad.FAILED,0,KeyError:'boom'"
    assert re.fullmatch(r"bad\.bench_wall_s,\d+,", lines[4])
    assert len(lines) == 5 and seen == ["cpu"]


def test_harness_refuses_an_unknown_bench():
    with pytest.raises(SystemExit, match="unknown bench"):
        run.main(["fig3", "--device", "cpu"])


def test_harness_roofline_without_records_prints_the_note_row(
        tmp_path, monkeypatch, capsys):
    """With no ``runs/dryrun_torch`` under the working directory the
    roofline bench prints the reference's one note row."""
    monkeypatch.chdir(tmp_path)
    assert run.main(["roofline", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["name,us_per_call,derived",
                         "roofline.skipped_no_dryrun_artifacts,0,"]
    assert re.fullmatch(r"roofline\.bench_wall_s,\d+,", lines[2])
    assert len(lines) == 3


def test_harness_runs_a_real_bench_on_the_host(capsys):
    assert run.main(["predict", "--device", "cpu"]) == 0
    names = [line.split(",", 1)[0]
             for line in capsys.readouterr().out.splitlines()]
    assert names == ["name", "predict.single_us_per_kernel",
                     "predict.batched_us_per_kernel", "predict.batch_size",
                     "predict.breakdown_residual", "predict.bench_wall_s"]
