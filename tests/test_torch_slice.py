"""The port's main path end to end on the CPU, against the reference.

Calibrate the smoke battery through an injected deterministic timer,
save the profile, read it with the reference's ``load_profile``, and
price the port's counts with the reference ``PredictEngine``: both
packages must give the same seconds.  Also pinned here: the battery the
presets select (same kernel names as the reference), the deterministic
holdout split, the ``predict`` CLI on the host, the refusal to fall back
to the CPU unasked, and import hygiene (the port never imports ``jax``
or ``repro``).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api.engine import PredictEngine as JPredictEngine
from repro.core import uipick as juipick
from repro.profiles import load_profile as jload_profile
from repro.profiles import presets as jpresets
from repro_torch.analysis.targets import kernel_targets
from repro_torch.api import PerfSession
from repro_torch.core import uipick as tuipick
from repro_torch.core.calibrate import fit_model
from repro_torch.core.counting import count_fn
from repro_torch.core.model import Model
from repro_torch.device import resolve_device
from repro_torch.profiles import (
    DeviceFingerprint,
    MachineProfile,
    ModelFit,
    load_profile,
    save_profile,
)
from repro_torch.profiles import presets as tpresets

ROOT = Path(__file__).resolve().parents[1]
TRUTH = {"p_madd": 2.5e-12, "p_launch": 7e-6}


def _truth_timer(kernel, trials):
    """Deterministic device: seconds = Σ p · f over the smoke model."""
    c = kernel.counts()
    return tuipick.TimingStats(
        median=TRUTH["p_madd"] * c["f_op_float32_madd"]
        + TRUTH["p_launch"] * c["f_sync_launch_kernel"],
        std=0.0, min=0.0)


@pytest.fixture(scope="module")
def smoke_profile(tmp_path_factory):
    model = Model(tpresets.DEFAULT_OUTPUT_FEATURE, tpresets.SMOKE_MODEL_EXPR)
    kernels = tuipick.KernelCollection(tuipick.ALL_GENERATORS) \
        .generate_kernels(tpresets.SMOKE_TAGS,
                          tuipick.MatchCondition.INTERSECT)
    timer = tuipick.CountingTimer(_truth_timer)
    table = tuipick.gather_feature_table(model.all_features(), kernels,
                                         trials=3, timer=timer)
    assert timer.calls == len(kernels) == 5
    fit = fit_model(model, table, nonneg=True)
    profile = MachineProfile(
        fingerprint=DeviceFingerprint.local("cpu"),
        fits={"smoke": ModelFit.from_fit(model, fit)}, trials=3,
        kernel_names=[k.name for k in kernels],
        holdout=tuipick.holdout_split(table)[1])
    path = tmp_path_factory.mktemp("prof") / "cpu_profile.json"
    save_profile(profile, path)
    return path, fit


def test_smoke_calibration_recovers_truth(smoke_profile):
    _, fit = smoke_profile
    assert fit.converged
    for n, v in TRUTH.items():
        np.testing.assert_allclose(fit.params[n], v, rtol=1e-5)


def test_reference_reads_port_profile_and_agrees_on_seconds(smoke_profile):
    path, fit = smoke_profile
    jprof = jload_profile(path)
    port = load_profile(path)
    assert jprof.to_dict() == port.to_dict()
    assert jprof.fingerprint.platform == "cpu"
    session = PerfSession.open(path)
    targets = kernel_targets()
    preds = session.predict_batch([(t.fn, t.args) for t in targets],
                                  names=[t.name for t in targets])
    assert session.timer.calls == 0 and session.eval_calls == 1
    rows = [count_fn(t.fn, *t.args) for t in targets]
    jpreds = JPredictEngine(jprof).predict_rows(rows,
                                                [t.name for t in targets])
    for p, jp in zip(preds, jpreds):
        np.testing.assert_allclose(p.seconds, jp.seconds, rtol=1e-5)
        assert p.breakdown.keys() == jp.breakdown.keys()
        assert p.seconds > 0
        assert abs(sum(p.breakdown.values()) - p.seconds) \
            <= 1e-12 * p.seconds
    # held-out rows of a noiseless device: exact up to each package's
    # evaluation precision (float64 here, float32 in the reference)
    assert preds[0].diagnostics["holdout_gmre"] < 1e-6
    assert jpreds[0].diagnostics["holdout_gmre"] < 1e-6


def test_predict_cli_on_host_performs_zero_timings(smoke_profile):
    path, _ = smoke_profile
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.calibrate", "predict",
         str(path), "--kernel", "kernels.ops.matmul",
         "--kernel", "kernels.ops.stencil5", "--kernel",
         "kernels.ops.dg_diff", "--explain", "3", "--expect-zero-timings",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "timings_performed=0 batched_evals=1" in out.stdout
    assert "kernels.ops.dg_diff:" in out.stdout


def test_no_silent_fallback_to_the_host():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        DeviceFingerprint.local()
    k = tuipick.KernelCollection(tuipick.ALL_GENERATORS).generate_kernels(
        ["empty_kernel", "nelements:16"])[0]
    with pytest.raises(RuntimeError):
        k.time_stats(trials=1)


def test_open_without_profile_names_the_missing_study():
    """``open(None)`` runs the zoo study on this machine — on the card by
    default, so without one it raises instead of studying the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PerfSession.open(None)


def test_port_reads_reference_profile(tmp_path):
    from repro.core.calibrate import FitResult as JFit
    from repro.core.model import Model as JModel
    from repro.profiles import DeviceFingerprint as JFp
    from repro.profiles import MachineProfile as JProf
    from repro.profiles import ModelFit as JModelFit
    from repro.profiles import save_profile as jsave

    jm = JModel(jpresets.DEFAULT_OUTPUT_FEATURE, jpresets.SMOKE_MODEL_EXPR)
    jprof = JProf(fingerprint=JFp("tpu", "TPU v5e", 1),
                  fits={"smoke": JModelFit.from_fit(jm, JFit(
                      TRUTH, 0.0, 1, True))}, trials=2)
    jsave(jprof, tmp_path / "ref.json")
    port = load_profile(tmp_path / "ref.json")
    assert port.to_dict() == jprof.to_dict()


def _names(mod, tags):
    return [k.name for k in mod.KernelCollection(mod.ALL_GENERATORS)
            .generate_kernels(tags, mod.MatchCondition.INTERSECT)]


def test_presets_select_the_reference_battery():
    for attr in ("DEFAULT_OUTPUT_FEATURE", "BASE_MODEL_EXPR",
                 "CALIBRATION_TAGS", "SMOKE_MODEL_EXPR", "SMOKE_TAGS"):
        assert getattr(tpresets, attr) == getattr(jpresets, attr)
    full = _names(tuipick, tpresets.CALIBRATION_TAGS)
    assert full == _names(juipick, jpresets.CALIBRATION_TAGS)
    assert len(full) == 43
    assert _names(tuipick, tpresets.SMOKE_TAGS) == \
        _names(juipick, jpresets.SMOKE_TAGS)
    ref = {g.name: g for g in juipick.ALL_GENERATORS}
    for g in tuipick.ALL_GENERATORS:
        assert (g.gen_tags, g.arg_space) == \
            (ref[g.name].gen_tags, ref[g.name].arg_space)


def test_holdout_split_matches_reference(smoke_profile):
    rows = [{"f_x": float(i), "_kernel": f"kern{i}"} for i in range(20)]
    from repro.core.model import FeatureTable as JTable
    from repro_torch.core.model import FeatureTable as TTable
    for frac in (0.25, 0.5):
        t_tr, t_ho = tuipick.holdout_split(TTable.from_rows(rows),
                                           holdout_fraction=frac)
        j_tr, j_ho = juipick.holdout_split(JTable.from_rows(rows),
                                           holdout_fraction=frac)
        assert (t_tr.row_names, t_ho.row_names) == \
            (j_tr.row_names, j_ho.row_names)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "tools").glob("*.py"))
    assert len(files) > 20
    # the language models and their launcher are scanned too
    for sub in ("models", "launch"):
        assert any(f.parent.name == sub for f in files), sub
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
