"""The paper's figures in the port (``repro_torch.studies.paper_figures``)
against the reference's own figure functions (``benchmarks/paper_figures.py``),
on the CPU, with synthetic devices in place of timing.

Both packages' figures run with every timing drawn from the same
noiseless synthetic device — ``apex``, and for Fig 5 a device whose
truth is Fig 5's own overlap model — and Figs 7–9 and Table 3 from one
base fit.  Held to: each figure times the kernels the reference's tags
select, in its order; it returns the reference's row names; a row whose
kernel counts the model's features as the reference does carries the
reference's numbers (rtol 1e-3: the rows print 2–4 significant
decimals); and the reference's ``fit_model`` on the port's Fig 2 table
gives the port's fitted parameters within rtol 1e-4, as it does on Fig
5's at the port's float64 precision.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))       # the reference's benchmarks folder

from benchmarks import paper_figures as jfigures  # noqa: E402
from repro.core import uipick as juipick  # noqa: E402
from repro.core.calibrate import FitResult as JFitResult  # noqa: E402
from repro.core.calibrate import fit_model as jfit_model  # noqa: E402
from repro.core.model import FeatureTable as JFeatureTable  # noqa: E402
from repro.core.model import Model as JModel  # noqa: E402
from repro.studies.zoo import ZooEntry as JZooEntry  # noqa: E402
from repro.testing.synthdev import SyntheticDevice as JSyntheticDevice  # noqa: E402
from repro.testing.synthdev import fleet_device as jfleet_device  # noqa: E402
from repro_torch.core import uipick as tuipick  # noqa: E402
from repro_torch.core.calibrate import FitResult, fit_model  # noqa: E402
from repro_torch.core.model import Model  # noqa: E402
from repro_torch.profiles import (  # noqa: E402
    DeviceFingerprint,
    MachineProfile,
    ModelFit,
    save_profile,
)
from repro_torch.profiles.presets import (  # noqa: E402
    BASE_MODEL_EXPR,
    DEFAULT_OUTPUT_FEATURE,
)
from repro_torch.studies import paper_figures  # noqa: E402
from repro_torch.studies.zoo import ZooEntry  # noqa: E402
from repro_torch.testing.synthdev import SyntheticDevice, fleet_device  # noqa: E402

FIGURES = ("fig1", "fig2", "fig5", "fig7", "fig8", "fig9", "table3")
# a base fit of the kind phase 3 gives on the card
BASE_FIT = dict(params={"p_madd": 2.6e-14, "p_alu": 2.1e-12,
                        "p_mem": 1.9e-12, "p_strided": 5.5e-12,
                        "p_gather": 8.0e-12, "p_concat": 1e-9,
                        "p_launch": 1.6e-5},
                residual_norm=2.6, iterations=200, converged=False)
# Fig 5's overlap model as the device's truth: the global term rules
# the small m, the on-chip term the large (crossover near m = 16384)
FIG5_TRUTH = {"p_g": 1.5e-11, "p_c": 1.0e-11, "p_edge": 40.0,
              "p_launch": 5e-6}


def _fig5_device(pkg):
    entry, device = ((ZooEntry, SyntheticDevice) if pkg == "port"
                     else (JZooEntry, JSyntheticDevice))
    return device(name="fig5", p_true=FIG5_TRUTH, truth=entry(
        name="fig5", scope_rank=3, expr=paper_figures.FIG5_MODEL_EXPR,
        nonneg=False))


def _device(pkg, figure):
    if figure == "fig5":
        return _fig5_device(pkg)
    return (fleet_device if pkg == "port" else jfleet_device)("apex")


def _run_port(figure):
    timed = []
    dev = _device("port", figure)

    def timer(kernel, trials):
        timed.append(kernel.name)
        return dev.timer(kernel, trials)

    profile = MachineProfile(
        fingerprint=DeviceFingerprint("cpu", "cpu", 1),
        fits={"base": ModelFit.from_fit(
            Model(DEFAULT_OUTPUT_FEATURE, BASE_MODEL_EXPR),
            FitResult(**BASE_FIT))})
    rows = paper_figures.run_figure(figure, profile, device="cpu", trials=1,
                                    timer=timer)
    return rows, timed


@pytest.fixture(scope="module")
def reference():
    """figure → (rows, kernels timed) from the reference's own figure
    functions, their timing and base calibration swapped for the same
    synthetic devices and base fit.  Fig 5 runs under x64: the port
    solves in float64 from the reference's x64 multi-starts
    (``test_torch_calibrate_draws.py``), and Fig 5's overlap fit lands in
    another basin from the float32 draws (ROADMAP queue C)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for figure in FIGURES:
            jax.config.update("jax_enable_x64", figure == "fig5")
            timed = []
            dev = _device("ref", figure)

            def gather(model, kernels, *, trials=1):
                timed.extend(k.name for k in kernels)
                return juipick.gather_feature_table(
                    model.all_features(), kernels, trials=trials,
                    timer=dev.timer)

            def time(kernel, *, trials=1, warmup=0):
                timed.append(kernel.name)
                return dev.timer(kernel, trials).median

            mp.setattr(jfigures, "gather", gather)
            mp.setattr(juipick.MeasurementKernel, "time", time)
            mp.setattr(jfigures, "calibrated_base_model", lambda: (
                JModel(DEFAULT_OUTPUT_FEATURE, BASE_MODEL_EXPR),
                JFitResult(**BASE_FIT)))
            try:
                out[figure] = (getattr(jfigures, paper_figures.FIGURES[
                    figure].__name__)(), timed)
            finally:
                jax.config.update("jax_enable_x64", False)
    return out


@pytest.fixture(scope="module")
def port():
    return {figure: _run_port(figure) for figure in FIGURES}


def _alike(figure, names):
    """The kernels both counters count alike on the figure's model."""
    expr = {"fig1": paper_figures.MADD_MODEL_EXPR,
            "fig2": paper_figures.MADD_MODEL_EXPR,
            "fig5": paper_figures.FIG5_MODEL_EXPR}.get(figure,
                                                        BASE_MODEL_EXPR)
    features = Model(DEFAULT_OUTPUT_FEATURE, expr).feature_names
    counts = {}
    for mod in (tuipick, juipick):
        kerns = mod.KernelCollection(mod.ALL_GENERATORS).generate_kernels(
            ["matmul_sq", "flops", "overlap", "dg", "stencil"],
            mod.MatchCondition.INTERSECT)
        by_name = {k.name: k for k in kerns}
        counts[mod] = {n: by_name[n].counts() for n in names}
    return {n for n in names
            if all(counts[tuipick][n][f] == counts[juipick][n][f]
                   for f in features)}


def _row_kernel(name, timed):
    """The kernel a row reports on, or None for a summary row."""
    stat = name.split(".", 1)[1]
    if stat in timed:
        return stat
    m = re.fullmatch(r"m(\d+)", stat)      # fig5.m<m>
    return next((k for k in timed if m and f"_m{m[1]}_" in k), None)


@pytest.mark.parametrize("figure", FIGURES)
def test_figure_times_the_reference_kernels(figure, port, reference):
    assert port[figure][1] == reference[figure][1]
    assert len(port[figure][1]) == {
        "fig1": 6, "fig2": 6, "fig5": 7, "fig7": 4, "fig8": 8, "fig9": 4,
        "table3": 0}[figure]


@pytest.mark.parametrize("figure", FIGURES)
def test_figure_rows_are_the_reference_rows(figure, port, reference):
    """Same row names; a row on a kernel both counters count alike, and
    a summary row over such kernels only, carries the same numbers.
    ``fig5.p_edge`` is compared nowhere: the likelihood is nearly flat
    along it (``ZooEntry.recoverable`` leaves it out too)."""
    rows, timed = port[figure]
    jrows, _ = reference[figure]
    assert [r.split(",")[0] for r in rows] == \
        [r.split(",")[0] for r in jrows]
    alike = _alike(figure, timed)
    for row, jrow in zip(rows, jrows):
        name, *values = row.split(",")
        kernel = _row_kernel(name, timed)
        if name == "fig5.p_edge" or (
                kernel not in alike if kernel else alike != set(timed)):
            continue
        for v, jv in zip(values, jrow.split(",")[1:]):
            if v or jv:
                np.testing.assert_allclose(float(v), float(jv), rtol=1e-3,
                                           atol=0.01, err_msg=row)


def test_fig2_fit_is_the_reference_fit():
    """Fig 2 on the port's table: the reference's ``fit_model`` gives the
    port's parameters.  ``p_madd`` is not identified (the madd pattern
    counts mul and add, never madd), so both keep the nominal start."""
    model = Model(DEFAULT_OUTPUT_FEATURE, paper_figures.MADD_MODEL_EXPR)
    table, fit = paper_figures.calibrate(
        model, paper_figures.kernels(paper_figures.FIG2_CAL_TAGS), trials=1,
        timer=_device("port", "fig2").timer, nonneg=True)
    jfit = jfit_model(JModel(DEFAULT_OUTPUT_FEATURE,
                             paper_figures.MADD_MODEL_EXPR),
                      JFeatureTable.from_dict(table.to_dict()), nonneg=True)
    assert fit.params.keys() == jfit.params.keys()
    for name, value in fit.params.items():
        np.testing.assert_allclose(value, jfit.params[name], rtol=1e-4,
                                   err_msg=name)
    assert fit.params["p_madd"] == pytest.approx(1e-9, rel=1e-6)


def test_fig5_fit_is_the_reference_solver_at_float64():
    """Fig 5's overlap fit on the port's table, from the nominal start:
    the reference's ``fit_model`` run in float64 (x64) gives the port's
    parameters, ``p_edge`` included.  At jax's default float32 the
    reference's path leaves this start for another basin (here the
    truth); a float32 torch solve lands in a third, so the LM's basin
    depends on its rounding, not on the port (ROADMAP queue C)."""
    model = Model(DEFAULT_OUTPUT_FEATURE, paper_figures.FIG5_MODEL_EXPR)
    table = paper_figures.calibrate(
        model, paper_figures.kernels(paper_figures.FIG5_TAGS), trials=1,
        timer=_device("port", "fig5").timer, nonneg=False)[0]
    fit = fit_model(model, table, nonneg=False, seeds=1)
    jax.config.update("jax_enable_x64", True)
    try:
        jfit = jfit_model(JModel(DEFAULT_OUTPUT_FEATURE,
                                 paper_figures.FIG5_MODEL_EXPR),
                          JFeatureTable.from_dict(table.to_dict()),
                          nonneg=False, seeds=1)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert fit.params.keys() == jfit.params.keys()
    for name, value in fit.params.items():
        np.testing.assert_allclose(value, jfit.params[name], rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(fit.residual_norm, jfit.residual_norm,
                               rtol=1e-4)


def test_cli_prints_the_reference_rows_on_the_host(tmp_path, reference):
    """``python -m repro_torch.studies.paper_figures fig9 --device cpu``
    from a saved profile prints Fig 9's rows; without ``--device cpu``
    it targets the card and, with none visible, fails rather than time
    the host."""
    path = tmp_path / "cpu_profile.json"
    save_profile(MachineProfile(
        fingerprint=DeviceFingerprint.local("cpu"),
        fits={"base": ModelFit.from_fit(
            Model(DEFAULT_OUTPUT_FEATURE, BASE_MODEL_EXPR),
            FitResult(**BASE_FIT))}), path)
    cmd = [sys.executable, "-m", "repro_torch.studies.paper_figures", "fig9",
           "--trials", "1", "--profile", str(path)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [r.split(",")[0] for r in lines[1:]] == \
        [r.split(",")[0] for r in reference["fig9"][0]]
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=300)
        assert out.returncode != 0 and "no CUDA device" in out.stderr
