"""``python -m repro_torch.lint`` — the port's auditor CLI, held to the
cases of ``tests/test_lint_cli.py``.

Every test in this module runs with kernel execution POISONED: timing,
capturing or launching any :class:`MeasurementKernel` raises at once.
The whole CLI — default generator + zoo scope included — must pass
under that regime, with the report's own ``timings=0`` stats line.

The reference's cases that fail under jax 0.9 (its walker does not open
nested jits, ROADMAP queue C) pass here, except that the default scope
is not clean: it pins its exact findings.  Its two errors are
``aten.roll`` (priced at zero for parity, data moved all the same) in
``finite_diff``'s roll lowering and in ``onchip_pattern``; they are the
port's baseline, ``torch_lint_baseline.json``.  The eight hand-kernel
wrappers lint clean against an empty baseline.
"""
import json
from pathlib import Path

import pytest

from repro_torch.analysis.cli import main
from repro_torch.core.uipick import MeasurementKernel

REPO = Path(__file__).resolve().parents[1]
BASELINE = REPO / "torch_lint_baseline.json"

FIXTURE_MODULE = '''\
"""Lint fixtures: one kernel per defect class (audited on fake tensors)."""
import types

import torch

X = torch.empty((64,), dtype=torch.float32, device="meta")


def unmodeled(x):
    return torch.cumprod(x, 0)


def control(x):
    n = int((x.sum() > 0).item())
    return x * 2.0 if n else x * 3.0


def mixed(x):
    return (x.to(torch.bfloat16) * 2).to(torch.float32) + x * 3


def take(x):
    return torch.index_select(
        x, 0, torch.zeros((4,), dtype=torch.int64, device=x.device))


LINT_TARGETS = [
    types.SimpleNamespace(name=f.__name__, fn=f, args=(X,))
    for f in (unmodeled, control, mixed, take)
]
'''

# what the default scope finds — (severity, code, location) — each named
# with its reason in ROADMAP queue C
DEFAULT_FINDINGS = sorted([
    ("error", "unmodeled-op", "generator:finite_diff"),
    ("error", "unmodeled-op", "generator:onchip_pattern"),
    ("warning", "probe-lattice-divisibility", "generator:overlap_pattern"),
    ("info", "family-degree-overdeclared", "generator:mem_stream"),
])


@pytest.fixture(autouse=True)
def no_execution(monkeypatch):
    def boom(self, *a, **k):
        raise AssertionError("repro_torch.lint must never execute a kernel")

    monkeypatch.setattr(MeasurementKernel, "time_stats", boom)
    monkeypatch.setattr(MeasurementKernel, "capture", boom)


@pytest.fixture()
def fixture_module(tmp_path):
    path = tmp_path / "lint_fixtures.py"
    path.write_text(FIXTURE_MODULE)
    return str(path)


def _run_json(capsys, argv):
    code = main(argv)
    return code, json.loads(capsys.readouterr().out)


def _findings(payload):
    return sorted((d["severity"], d["code"], d["location"])
                  for d in payload["diagnostics"])


def test_fixture_kernels_surface_four_diagnostic_classes(
        capsys, fixture_module):
    code, payload = _run_json(
        capsys, ["--no-default", "--json", fixture_module])
    codes = {d["code"] for d in payload["diagnostics"]}
    assert {"unmodeled-op", "data-dependent-control", "mixed-precision",
            "data-dependent-access"} <= codes
    assert payload["stats"] == {"timings": 0, "traces": 4}
    assert code == 1                    # un-baselined error → fail


def test_json_output_is_byte_identical_across_runs(capsys, fixture_module):
    main(["--no-default", "--json", fixture_module])
    first = capsys.readouterr().out
    main(["--no-default", "--json", fixture_module])
    second = capsys.readouterr().out
    assert first == second


def test_diagnostics_sorted_by_severity_then_location(
        capsys, fixture_module):
    _code, payload = _run_json(
        capsys, ["--no-default", "--json", fixture_module])
    rank = {"error": 0, "warning": 1, "info": 2}
    keys = [(rank[d["severity"]], d["location"], d["code"], d["message"])
            for d in payload["diagnostics"]]
    assert keys == sorted(keys)
    assert len(keys) >= 4


def test_baseline_workflow_write_pass_regress(capsys, tmp_path,
                                              fixture_module):
    baseline = tmp_path / "baseline.json"
    assert main(["--no-default", fixture_module,
                 "--write-baseline", str(baseline)]) == 0
    capsys.readouterr()
    # adopted errors no longer fail the run
    code, payload = _run_json(
        capsys, ["--no-default", "--json", fixture_module,
                 "--baseline", str(baseline)])
    assert code == 0 and payload["new_errors"] == []
    # an emptied baseline turns them back into regressions
    baseline.write_text(json.dumps({"version": 1, "errors": []}))
    code, payload = _run_json(
        capsys, ["--no-default", "--json", fixture_module,
                 "--baseline", str(baseline)])
    assert code == 1
    assert payload["new_errors"] == ["unmodeled-op@kernel:unmodeled"]


def test_suppress_moves_findings_out_of_the_exit_code(
        capsys, fixture_module):
    code, payload = _run_json(
        capsys, ["--no-default", "--json", fixture_module,
                 "--suppress", "unmodeled-op"])
    assert code == 0
    assert all(d["code"] != "unmodeled-op"
               for d in payload["diagnostics"])
    assert any(d["code"] == "unmodeled-op"
               for d in payload["suppressed"])


def test_unknown_module_exits_2(capsys):
    assert main(["--no-default", "no_such_module_xyz"]) == 2
    assert "repro_torch.lint" in capsys.readouterr().err


def test_module_without_targets_exits_2(tmp_path, capsys):
    empty = tmp_path / "empty_mod.py"
    empty.write_text("VALUE = 1\n")
    assert main(["--no-default", str(empty)]) == 2
    assert "lint_targets" in capsys.readouterr().err


def test_default_scope_pins_its_findings_and_is_execution_free(capsys):
    """The repo's own generators + zoo through their own linter, with
    execution poisoned: exactly the pinned findings, whose two errors are
    the port's baseline — against it the run passes."""
    code, payload = _run_json(capsys, ["--json"])
    assert code == 1
    assert _findings(payload) == DEFAULT_FINDINGS
    assert payload["stats"]["timings"] == 0
    assert payload["stats"]["traces"] > 0
    roll = [d for d in payload["diagnostics"] if d["code"] == "unmodeled-op"]
    assert {d["details"]["op"] for d in roll} == {"aten.roll"}
    assert sorted(payload["new_errors"]) == json.loads(
        BASELINE.read_text())["errors"]
    code, payload = _run_json(capsys, ["--json", "--baseline",
                                       str(BASELINE)])
    assert code == 0 and payload["new_errors"] == []
    assert payload["stale_baseline"] == []


def test_kernel_wrappers_lint_clean_against_empty_baseline(capsys,
                                                          tmp_path):
    """Every hand-kernel wrapper is priced by its cost rule: zero
    findings against an empty baseline — no ``opaque-op``, no
    ``kernel-unanalyzable``."""
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"version": 1, "errors": []}))
    code, payload = _run_json(
        capsys, ["--kernels", "--no-default", "--json",
                 "--baseline", str(empty)])
    assert code == 0 and payload["new_errors"] == []
    assert payload["diagnostics"] == []
    assert payload["stats"] == {"timings": 0, "traces": 8}


def test_stale_baseline_entries_warn_and_prune(capsys, tmp_path,
                                               fixture_module):
    """A baseline entry whose finding no longer occurs is reported as
    stale; ``--prune-baseline`` rewrites the file without it."""
    baseline = tmp_path / "baseline.json"
    assert main(["--no-default", fixture_module,
                 "--write-baseline", str(baseline)]) == 0
    capsys.readouterr()
    ghost = "unmodeled-op@kernel:deleted_kernel"
    payload = json.loads(baseline.read_text())
    payload["errors"].append(ghost)
    baseline.write_text(json.dumps(payload))

    code, out = _run_json(
        capsys, ["--no-default", "--json", fixture_module,
                 "--baseline", str(baseline)])
    assert code == 0                        # stale entries never fail a run
    assert out["stale_baseline"] == [ghost]
    assert out["pruned_baseline"] is False
    assert ghost in json.loads(baseline.read_text())["errors"]

    code, out = _run_json(
        capsys, ["--no-default", "--json", fixture_module,
                 "--baseline", str(baseline), "--prune-baseline"])
    assert code == 0
    assert out["stale_baseline"] == [ghost]
    assert out["pruned_baseline"] is True
    kept = json.loads(baseline.read_text())
    assert ghost not in kept["errors"] and kept["errors"]
    # a second run against the pruned file sees nothing stale
    code, out = _run_json(
        capsys, ["--no-default", "--json", fixture_module,
                 "--baseline", str(baseline)])
    assert code == 0 and out["stale_baseline"] == []


def test_prune_baseline_requires_baseline(capsys):
    assert main(["--no-default", "--kernels", "--prune-baseline"]) == 2
    assert "--baseline" in capsys.readouterr().err


def test_all_combos_sweeps_beyond_first_fixed_combo(capsys):
    """``--all-combos`` audits every buildable fixed-argument combination
    of the default generators: still execution-free, strictly more
    fake-tensor runs than the representative sweep, and one error more —
    ``mem_stream``'s shift pattern rolls too."""
    _code, first = _run_json(capsys, ["--json"])
    code, swept = _run_json(capsys, ["--json", "--all-combos",
                                     "--baseline", str(BASELINE)])
    assert code == 1
    # one diagnostic per input count (1, 2, 4 rolled arrays), one key
    assert swept["new_errors"] == ["unmodeled-op@generator:mem_stream"] * 3
    assert swept["stats"]["timings"] == 0
    assert swept["stats"]["traces"] > first["stats"]["traces"]


def test_user_module_of_tuning_variants(capsys, tmp_path):
    """A user module exposing ``lint_targets()`` — every variant of the
    three §8 tuning spaces, as the reference's autotune example does —
    audits on fake tensors: the one error is the roll stencil's."""
    mod = tmp_path / "tuning_targets.py"
    mod.write_text(
        "from repro_torch.tuning import section8_spaces\n\n\n"
        "def lint_targets():\n"
        "    return [k for s in section8_spaces() for k in s.kernels]\n")
    code, payload = _run_json(capsys, ["--no-default", "--json", str(mod)])
    assert code == 1
    assert payload["new_errors"] == [
        "unmodeled-op@kernel:stencil_roll_n4096_float32"]
    assert payload["stats"] == {"timings": 0, "traces": 11}
