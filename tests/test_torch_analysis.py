"""The port's static modelability auditor (``repro_torch.analysis``)
against the reference's (``repro.analysis``): the scope, family,
signature-hazard, report, baseline and session-audit cases of
``tests/test_analysis.py`` on torch counterparts of each fixture kernel,
plus parity cases where both packages take the same input.

Fixture kernels with KNOWN defects must each draw exactly the diagnostic
class built for that defect, and drawing it costs fake-tensor runs only:
no kernel executes, nothing is allocated, nothing is timed.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.analysis as ranalysis
from repro.core.uipick import FamilySpec as RefFamilySpec
from repro.core.uipick import Generator as RefGenerator
from repro.core.uipick import MeasurementKernel as RefKernel
from repro_torch.analysis import (
    AnalysisError,
    Diagnostic,
    DiagnosticReport,
    abstract_args,
    abstract_like,
    audit_battery,
    audit_callable,
    audit_signature,
    check_lattice,
    load_baseline,
    save_baseline,
    validate_family,
)
from repro_torch.analysis.diagnostics import sort_key
from repro_torch.core.counting import FeatureCounts, register_op_cost_rule
from repro_torch.core.model import Model
from repro_torch.core.uipick import (
    FamilySpec,
    Generator,
    LatticeAssumptionWarning,
    MeasurementKernel,
)

X64 = torch.empty((64,), dtype=torch.float32, device="meta")


def _codes(diags):
    return sorted({d.code for d in diags})


# a library op from another namespace: the counter does not read it
@torch.library.custom_op("repro_torch_audit_fixture::sin", mutates_args=())
def _foreign_sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x)


@_foreign_sin.register_fake
def _(x):
    return torch.empty_like(x)


# hand-kernel ops: one without a cost rule, one whose rule raises
@torch.library.custom_op("repro_torch::audit_fixture_norule",
                         mutates_args=())
def _norule(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_norule.register_fake
def _(x):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::audit_fixture_badrule",
                         mutates_args=())
def _badrule(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_badrule.register_fake
def _(x):
    return torch.empty_like(x)


def _rule_that_refuses(x):
    raise ValueError(f"no closed form for {tuple(x.shape)}")


register_op_cost_rule("repro_torch::audit_fixture_badrule",
                      _rule_that_refuses)


# ---------------------------------------------------------------------------
# scope auditor
# ---------------------------------------------------------------------------


def test_unmodeled_op_is_an_error():
    diags = audit_callable(lambda x: torch.cumprod(x, 0), (X64,),
                           "kernel:cp")
    assert _codes(diags) == ["unmodeled-op"]
    d = diags[0]
    assert d.severity == "error"
    assert d.details["op"] == "aten.cumprod"


def test_roll_is_reported_as_unmodeled_data_movement():
    """``aten.roll`` moves data but the counter prices it at zero for
    parity with the reference (queue C): the audit says so."""
    diags = audit_callable(lambda x: torch.roll(x, 1) + x, (X64,),
                           "kernel:roll")
    assert _codes(diags) == ["unmodeled-op"]
    assert diags[0].details == {"op": "aten.roll", "occurrences": 1}
    assert "parity" in diags[0].message


def test_opaque_op_from_another_library_is_an_error():
    diags = audit_callable(lambda x: _foreign_sin(x) * 2.0, (X64,),
                           "kernel:lib")
    assert _codes(diags) == ["opaque-op"]
    assert diags[0].severity == "error"
    assert diags[0].details["op"] == "repro_torch_audit_fixture.sin"


@pytest.mark.parametrize("op, reason", [
    (_norule, "no-cost-rule"), (_badrule, "cost-rule-raised")])
def test_hand_kernel_without_a_usable_cost_rule_is_unanalyzable(op, reason):
    diags = audit_callable(lambda x: op(x), (X64,), "kernel:hk")
    assert _codes(diags) == ["kernel-unanalyzable"]
    assert diags[0].severity == "error"
    assert diags[0].details["reason"] == reason
    if reason == "cost-rule-raised":
        assert "ValueError: no closed form for (64,)" in diags[0].message


def test_data_dependent_control_is_a_warning():
    def fn(x):
        n = int((x.sum() > 0).item())
        return x * 2.0 if n else x * 3.0

    diags = audit_callable(fn, (X64,), "kernel:item")
    assert _codes(diags) == ["data-dependent-control"]
    assert diags[0].severity == "warning"
    assert diags[0].details["ops"] == ["aten._local_scalar_dense"]


def test_data_sized_output_is_data_dependent_control():
    diags = audit_callable(lambda x: torch.nonzero(x > 0), (X64,),
                           "kernel:nz")
    assert _codes(diags) == ["data-dependent-control"]
    assert "stopped at 'aten.nonzero'" in diags[0].message


def test_mixed_precision_is_a_warning_naming_both_dtypes():
    def fn(x):
        return (x.to(torch.bfloat16) * 2).to(torch.float32) + x * 3

    diags = audit_callable(fn, (X64,), "kernel:mp")
    assert _codes(diags) == ["mixed-precision"]
    assert diags[0].details["dtypes"] == ["bfloat16", "float32"]


def test_runtime_indexing_is_an_info():
    def fn(x):
        return torch.index_select(
            x, 0, torch.zeros((4,), dtype=torch.int64, device=x.device))

    diags = audit_callable(fn, (X64,), "kernel:tk")
    assert _codes(diags) == ["data-dependent-access"]
    assert diags[0].severity == "info"


def test_untraceable_kernel_is_reported_not_raised():
    stats = {"traces": 0}
    diags = audit_callable(lambda x: x.no_such_attr(), (X64,),
                           "kernel:boom", stats=stats)
    assert _codes(diags) == ["untraceable-kernel"]
    assert stats["traces"] == 1     # the failed attempt still counts


def test_clean_kernel_draws_nothing():
    assert audit_callable(lambda x: torch.tanh(x) + 1.0, (X64,),
                          "kernel:ok") == []


@pytest.mark.parametrize("case", ["mixed", "clean"])
def test_scope_codes_as_the_reference(case):
    """The same kernel in jnp and in torch draws the same codes in each
    package.  (``jnp.cumprod`` and ``jnp.take`` sit in a nested jit that
    the reference's walker does not open under jax 0.9 — ROADMAP queue C
    — so only these two compare.)"""
    torch_fn, jax_fn = {
        "mixed": (lambda x: (x.to(torch.bfloat16) * 2).to(torch.float32)
                  + x * 3,
                  lambda x: (x.astype(jnp.bfloat16) * 2).astype(jnp.float32)
                  + x * 3),
        "clean": (lambda x: torch.tanh(x) + 1.0,
                  lambda x: jnp.tanh(x) + 1.0),
    }[case]
    ref = ranalysis.audit_callable(
        jax_fn, (jax.ShapeDtypeStruct((64,), jnp.float32),), "kernel:x")
    mine = audit_callable(torch_fn, (X64,), "kernel:x")
    assert [(d.severity, d.code, dict(d.details)) for d in mine] \
        == [(d.severity, d.code, dict(d.details)) for d in ref]


def test_abstract_args_never_materializes_the_arrays():
    """Both builders below would allocate 4 TiB if they ever ran
    concretely, the second even ignoring its device; under fake tensors
    they hand back shapes and dtypes only."""
    def make_args(device):
        return (torch.zeros((1 << 20, 1 << 20), device=device),)

    def careless(device):
        return (torch.zeros((1 << 20, 1 << 20)),)

    for builder in (make_args, careless):
        (a,) = abstract_args(builder)
        assert a.shape == (1 << 20, 1 << 20) and a.dtype == torch.float32
        assert audit_callable(lambda x: x * 2.0, (a,), "kernel:huge") == []


def test_abstract_like_builds_fake_tensors_on_the_card_device():
    """The audit of a hand kernel on the card takes fake ``cuda`` tensors:
    the wrapper meets its custom op and its cost rule, and nothing
    launches (this host has no card at all)."""
    from repro_torch.analysis.targets import kernel_targets

    for t in kernel_targets():
        args = abstract_like(t.args, "cuda")
        leaves = [a for arg in args
                  for a in (arg if isinstance(arg, list) else [arg])]
        assert all(a.is_cuda for a in leaves), t.name
        assert audit_callable(t.fn, args, f"kernel:{t.name}") == []


# ---------------------------------------------------------------------------
# family validator
# ---------------------------------------------------------------------------


def _fixture_kernel(n, shape):
    def fn(x):
        return x * 2.0

    def make_args(device):
        return (torch.ones(shape, dtype=torch.float32, device=device),)

    return MeasurementKernel(name=f"fx_{n}", fn=fn, make_args=make_args,
                             tags={}, sizes={"n": n})


def _fixture_gen(shape_of, degree, sizes=(16, 32)):
    return Generator("fixture", frozenset({"fx"}),
                     arg_space=dict(n=tuple(sizes)),
                     build=lambda *, n: _fixture_kernel(n, shape_of(n)),
                     family=FamilySpec(var_degrees={"n": degree}))


def _ref_fixture_gen(shape_of, degree, sizes=(16, 32)):
    def build(*, n):
        return RefKernel(name=f"fx_{n}", fn=lambda x: x * 2.0,
                         make_args=lambda: (jnp.ones(shape_of(n),
                                                     jnp.float32),),
                         tags={}, sizes={"n": n})

    return RefGenerator("fixture", frozenset({"fx"}),
                        arg_space=dict(n=tuple(sizes)), build=build,
                        family=RefFamilySpec(var_degrees={"n": degree}))


def test_family_degree_mismatch_quadratic_declared_linear():
    gen = _fixture_gen(lambda n: (n, n), degree=1)
    stats = {"traces": 0}
    diags = validate_family(gen, stats=stats)
    assert "family-degree-mismatch" in _codes(diags)
    d = next(d for d in diags if d.code == "family-degree-mismatch")
    assert d.severity == "error"
    assert d.details["declared_degree"] == 1
    assert d.details["actual_degree"] == 2
    assert stats["traces"] == 4     # d+3 lattice points, memoized


def test_family_non_polynomial_log_factor():
    # element count n·bit_length(n): no polynomial of any degree fits the
    # lattice, so Δ^{d+1} is non-constant
    gen = _fixture_gen(lambda n: (n * int(n).bit_length(),), degree=1)
    diags = validate_family(gen)
    assert "family-non-polynomial" in _codes(diags)
    d = next(d for d in diags if d.code == "family-non-polynomial")
    assert d.severity == "error"
    assert d.details["lattice"] == [16, 32, 48, 64]


def test_family_degree_overdeclared_is_an_info():
    gen = _fixture_gen(lambda n: (n,), degree=2)
    diags = validate_family(gen)
    assert _codes(diags) == ["family-degree-overdeclared"]
    assert diags[0].severity == "info"


def test_family_correct_degree_is_silent():
    assert validate_family(_fixture_gen(lambda n: (n,), degree=1)) == []
    assert validate_family(_fixture_gen(lambda n: (n, n), degree=2)) == []


@pytest.mark.parametrize("shape_of, degree", [
    (lambda n: (n, n), 1), (lambda n: (n * int(n).bit_length(),), 1),
    (lambda n: (n,), 2), (lambda n: (n,), 1), (lambda n: (n, n), 2)],
    ids=["mismatch", "non-polynomial", "overdeclared", "linear",
         "quadratic"])
def test_family_findings_as_the_reference(shape_of, degree):
    mine = validate_family(_fixture_gen(shape_of, degree))
    ref = ranalysis.validate_family(_ref_fixture_gen(shape_of, degree))
    assert [(d.severity, d.code, d.location, dict(d.details))
            for d in mine] == [(d.severity, d.code, d.location,
                                dict(d.details)) for d in ref]


def test_family_validator_skips_familyless_generators():
    gen = Generator("plain", frozenset({"p"}), arg_space=dict(n=(16,)),
                    build=lambda *, n: _fixture_kernel(n, (n,)))
    assert validate_family(gen) == []
    assert check_lattice(gen) == []


def test_check_lattice_flags_off_lattice_argument_sizes():
    gen = _fixture_gen(lambda n: (n,), degree=1, sizes=(16, 20, 32))
    diags = check_lattice(gen)
    assert _codes(diags) == ["probe-lattice-divisibility"]
    assert diags[0].severity == "warning"
    assert diags[0].details == {"variable": "n", "sizes": [20], "scale": 16}
    ref = ranalysis.check_lattice(
        _ref_fixture_gen(lambda n: (n,), degree=1, sizes=(16, 20, 32)))
    assert [d.to_dict() for d in diags] == [d.to_dict() for d in ref]


def test_generation_time_lattice_warning_matches_static_diagnostic():
    """The runtime twin: actually generating the off-lattice variant warns
    LatticeAssumptionWarning once."""
    gen = _fixture_gen(lambda n: (n,), degree=1, sizes=(16, 20))
    with pytest.warns(LatticeAssumptionWarning):
        kernels = list(gen.variants({}))
    assert len(kernels) == 2


# ---------------------------------------------------------------------------
# identifiability over count rows
# ---------------------------------------------------------------------------


def test_audit_battery_aligns_rows_then_analyzes():
    m = Model("f_t", "p_a * f_x + p_b * f_x")
    rows = [FeatureCounts({"f_x": float(i)}) for i in (1, 2, 3)]
    diags = audit_battery(m, rows, "model:twin")
    assert _codes(diags) == ["collinear-parameters"]
    ref = ranalysis.audit_battery(
        __import__("repro.core.model", fromlist=["Model"]).Model(
            "f_t", "p_a * f_x + p_b * f_x"),
        [{"f_x": float(i)} for i in (1, 2, 3)], "model:twin")
    assert _codes(ref) == _codes(diags)


# ---------------------------------------------------------------------------
# cache-signature hazards
# ---------------------------------------------------------------------------


def test_sourceless_callable_is_unsignable():
    ns = {}
    exec("def nosrc(x):\n    return x * 2.0", ns)
    diags = audit_signature(ns["nosrc"], "kernel:nosrc")
    assert _codes(diags) == ["unsignable-callable"]
    assert diags[0].severity == "warning"
    assert any("source" in r for r in diags[0].details["reasons"])


def test_mutable_captured_state_is_an_info():
    cfg = {"k": 2.0}

    def kern(x, opts=[1.0]):            # noqa: B006 — the defect under test
        return x * cfg["k"] * opts[0]

    diags = audit_signature(kern, "kernel:mut")
    assert "mutable-captured-state" in _codes(diags)
    d = next(d for d in diags if d.code == "mutable-captured-state")
    assert d.details["names"] == ["cfg", "opts"]
    ref = ranalysis.audit_signature(kern, "kernel:mut")
    assert next(d for d in ref if d.code == "mutable-captured-state") \
        .details["names"] == ["cfg", "opts"]


def test_plain_closure_over_scalars_is_clean():
    c = 3.0

    def kern(x):
        return x * c

    assert audit_signature(kern, "kernel:ok") == []


def test_counted_loop_helpers_make_a_kernel_unsignable():
    """A kernel looping with ``counted_range`` or ``counted_loop`` reaches
    the counter's active-counts ContextVar through that helper's
    globals.  The helpers once made it unsignable; they now sign as the
    counter itself, so the kernel signs and the audit finds nothing,
    while a ContextVar the kernel captures itself still leaves it
    unsignable."""
    import contextvars

    from repro_torch.core.counting import counted_loop, counted_range

    def kern(x):
        for _ in counted_range(2):
            x = x + 1.0
        return counted_loop(2, lambda i, y: y * 2.0, x)

    assert audit_signature(kern, "kernel:loop") == []
    var = contextvars.ContextVar("state", default=None)

    def own(x):
        return x if var.get() is None else x + 1.0

    diags = audit_signature(own, "kernel:own")
    assert _codes(diags) == ["unsignable-callable"]
    assert "ContextVar" in diags[0].details["reasons"][0]


# ---------------------------------------------------------------------------
# diagnostics: ordering, suppression, baseline
# ---------------------------------------------------------------------------


def _diag(sev, code, loc, msg="m"):
    return Diagnostic(sev, code, loc, msg)


def test_report_sorts_by_severity_then_location_then_code():
    report = DiagnosticReport()
    report.extend([
        _diag("info", "c", "z"),
        _diag("error", "b", "kernel:b"),
        _diag("warning", "a", "kernel:a"),
        _diag("error", "a", "kernel:b"),
        _diag("error", "a", "kernel:a"),
    ])
    got = [(d.severity, d.location, d.code) for d in report.sorted()]
    assert got == [("error", "kernel:a", "a"), ("error", "kernel:b", "a"),
                   ("error", "kernel:b", "b"), ("warning", "kernel:a", "a"),
                   ("info", "z", "c")]
    assert got == [(d.severity, d.location, d.code)
                   for d in sorted(report.diagnostics, key=sort_key)]


def test_report_json_and_render_as_the_reference():
    specs = [("info", "c", "z", "m"), ("error", "b", "kernel:b", "x"),
             ("warning", "a", "kernel:a", "y"), ("error", "a", "kernel:b",
                                                 "w")]
    mine = DiagnosticReport(stats={"timings": 0, "traces": 3})
    mine.extend([Diagnostic(*s, details={"k": (1, 2)}) for s in specs])
    ref = ranalysis.DiagnosticReport(stats={"timings": 0, "traces": 3})
    ref.extend([ranalysis.Diagnostic(*s, details={"k": (1, 2)})
                for s in specs])
    assert mine.suppress(["a"]).to_json_dict() \
        == ref.suppress(["a"]).to_json_dict()
    assert mine.render() == ref.render()
    assert mine.codes() == ref.codes()


def test_invalid_severity_is_rejected():
    with pytest.raises(ValueError, match="severity"):
        Diagnostic("fatal", "c", "l", "m")


def test_suppress_by_code_and_by_key():
    report = DiagnosticReport()
    report.extend([_diag("error", "a", "k:1"), _diag("error", "a", "k:2"),
                   _diag("error", "b", "k:1")])
    by_code = report.suppress(["a"])
    assert [d.code for d in by_code.diagnostics] == ["b"]
    assert len(by_code.suppressed) == 2
    by_key = report.suppress(["a@k:1"])
    assert sorted(d.key for d in by_key.diagnostics) == ["a@k:2", "b@k:1"]
    # suppressed findings never fail the run
    assert by_code.new_errors([]) == by_code.diagnostics


def test_baseline_round_trip_and_regression(tmp_path):
    report = DiagnosticReport()
    report.extend([_diag("error", "a", "k:1"), _diag("warning", "w", "k:1")])
    path = tmp_path / "baseline.json"
    save_baseline(report, path)
    assert load_baseline(path) == ["a@k:1"]     # warnings never baseline
    assert ranalysis.load_baseline(path) == ["a@k:1"]   # same file format
    assert report.new_errors(load_baseline(path)) == []
    report.extend([_diag("error", "a", "k:2")])
    assert [d.key for d in report.new_errors(load_baseline(path))] \
        == ["a@k:2"]


def test_malformed_baseline_is_a_typed_error(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2, 3]")
    with pytest.raises(AnalysisError, match="lint baseline"):
        load_baseline(bad)
    with pytest.raises(AnalysisError, match="cannot read"):
        load_baseline(tmp_path / "missing.json")
    bad.write_text("{not json")
    with pytest.raises(AnalysisError, match="not valid JSON"):
        load_baseline(bad)


# ---------------------------------------------------------------------------
# the session facade's audit
# ---------------------------------------------------------------------------


def _audit_session():
    from repro_torch.api import PerfSession
    from repro_torch.core.calibrate import FitResult
    from repro_torch.profiles import (
        DeviceFingerprint,
        MachineProfile,
        ModelFit,
    )

    model = Model("f_wall_time_cpu_host",
                  "p_madd * f_op_float32_madd "
                  "+ p_launch * f_sync_launch_kernel")
    fit = FitResult(params={"p_madd": 1e-10, "p_launch": 1e-6},
                    residual_norm=0.0, iterations=1, converged=True)
    profile = MachineProfile(
        fingerprint=DeviceFingerprint(platform="synth",
                                      device_kind="audit-test", n_devices=1),
        fits={"lin": ModelFit.from_fit(model, fit)}, trials=2)
    return PerfSession.open(profile)


def test_session_audit_flags_out_of_scope_and_unmodeled():
    session = _audit_session()
    x = torch.empty((32,), device="meta")
    report = session.audit([
        (lambda x: torch.tanh(x) * 2.0, (x,)),     # transc: out of scope
        (lambda x: torch.cumprod(x, 0), (x,)),     # unmodeled op
    ])
    codes = report.codes()
    assert "out-of-scope-feature" in codes
    assert "unmodeled-op" in codes
    assert report.stats["timings"] == 0
    assert report.stats["traces"] >= 2
    assert session.timer.calls == 0


def test_session_audit_of_hand_kernels_launches_and_times_nothing():
    """The eight wrappers on fake ``cuda`` tensors and a measurement
    kernel from its builder: priced by their cost rules and counted,
    four fake-tensor runs an item at most, no timing."""
    from repro_torch.analysis.targets import kernel_targets
    from repro_torch.core.uipick import ALL_GENERATORS, KernelCollection

    session = _audit_session()
    items = [(t.fn, abstract_like(t.args, "cuda")) for t in kernel_targets()]
    items += KernelCollection(ALL_GENERATORS).generate_kernels(
        ["matmul_sq", "n:256", "dtype:float32", "prefetch:False",
         "tile:16"])
    report = session.audit(items)
    assert report.stats == {"timings": 0, "traces": 2 * len(items)}
    assert "out-of-scope-feature" in report.codes()
    assert not report.errors
