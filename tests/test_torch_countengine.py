"""The port's count engine (``repro_torch.core.countengine``) — the cases of
the reference's ``tests/test_countengine.py``, plus what the port adds:

* for every kernel that ``CALIBRATION_TAGS``, ``STUDY_TAGS`` and the seven
  figures' tags select, at its real sizes on ``meta``, the engine's counts
  are ``count_fn``'s, feature for feature;
* each generator's family costs exactly its probe grid of counting passes;
* the hand-kernel targets sign by the kernel library's hash and their cost
  rules, and count the cost rules' closed forms through the engine;
* torch state (dtypes, devices, generators, tensors) signs by content,
  and the persisted store is keyed by the torch version.
"""
import functools
import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import uipick as juipick
from repro_torch.analysis.targets import f32, kernel_targets
from repro_torch.api import PerfSession
from repro_torch.core import countengine
from repro_torch.core import counting
from repro_torch.core.calibrate import FitResult
from repro_torch.core.countengine import (
    CountEngine,
    args_signature,
    callable_signature,
    signature_hazards,
)
from repro_torch.core.counting import count_fn
from repro_torch.core.model import Model
from repro_torch.core.uipick import (
    ALL_GENERATORS,
    CountingTimer,
    FamilySpec,
    Generator,
    KernelCollection,
    MatchCondition,
    MeasurementKernel,
    gather_feature_table,
)
from repro_torch.kernels import _build
from repro_torch.profiles import (
    DeviceFingerprint,
    MachineProfile,
    MeasurementCache,
    ModelFit,
)
from repro_torch.profiles.presets import CALIBRATION_TAGS
from repro_torch.studies import paper_figures
from repro_torch.studies.zoo import STUDY_TAGS
from test_torch_kernels import REFERENCE_FEATURES

ROOT = Path(__file__).resolve().parents[1]
FP = DeviceFingerprint(platform="synth", device_kind="countengine-test",
                       n_devices=1)


def _ones(n, device="cpu"):
    return torch.ones((n,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# callable / args signatures
# ---------------------------------------------------------------------------


def test_callable_signature_distinguishes_closure_state():
    def make(c):
        return lambda x: x * c

    f2, f3 = make(2.0), make(3.0)
    s2, s3 = callable_signature(f2), callable_signature(f3)
    assert s2 and s3 and s2 != s3          # same source, different capture
    assert callable_signature(make(2.0)) == s2     # deterministic

    def plain(x):
        return x + 1.0

    assert callable_signature(plain)
    ns = {}
    exec("def nosrc(x):\n    return x", ns)
    assert callable_signature(ns["nosrc"]) == ""   # no retrievable source


def test_callable_signature_covers_kwdefaults_and_bound_methods():
    """Keyword-only defaults and bound-method self state steer the counted
    ops, so they are part of the content identity."""
    def make(p):
        return lambda x, *, _p=p: x ** _p

    s2, s8 = callable_signature(make(2)), callable_signature(make(8))
    assert s2 and s8 and s2 != s8

    class Pow:
        def __init__(self, p):
            self.p = p

        def apply(self, x):
            return x ** self.p

    m2, m8 = callable_signature(Pow(2).apply), callable_signature(Pow(8).apply)
    assert m2 != m8 or m2 == ""

    session = PerfSession.open(_profile())
    x = f32(16)
    p2, p8 = session.predict_batch([(make(2), (x,)), (make(8), (x,))])
    assert session.engine.trace_count == 2
    assert p2.unmodeled["f_op_float32_mul"] == 16      # x**2: 1 mul/elt
    assert p8.unmodeled["f_op_float32_mul"] == 48      # x**8: 3 muls/elt


def test_callable_signature_survives_self_recursive_closures():
    def outer():
        def f(x, n=3):
            return x if n == 0 else f(x * 2.0, n - 1)

        return f

    sig = callable_signature(outer())          # must not RecursionError
    assert sig == callable_signature(outer())  # and stays deterministic
    session = PerfSession.open(_profile())
    pred = session.predict(outer(), f32(8))
    assert pred.unmodeled["f_op_float32_mul"] == 24


def test_callable_signature_covers_referenced_globals():
    """Editing a module-level helper a callable references changes the
    signature — otherwise a warm store serves the old helper's counts."""
    def outer(helper):
        return lambda x: helper(x)

    def h_mul(x):
        return x * 2.0

    def h_tanh(x):
        return torch.tanh(x) + x

    s_mul, s_tanh = (callable_signature(outer(h_mul)),
                     callable_signature(outer(h_tanh)))
    assert s_mul and s_tanh and s_mul != s_tanh

    def uses_global(x):
        return _GLOBAL_HELPER(x)

    def uses_global_nested(x):
        def inner(y):
            return _GLOBAL_HELPER(y)

        return inner(x) * 2.0

    try:
        globals()["_GLOBAL_HELPER"] = h_mul
        g1 = callable_signature(uses_global)
        n1 = callable_signature(uses_global_nested)
        globals()["_GLOBAL_HELPER"] = h_tanh
        g2 = callable_signature(uses_global)
        n2 = callable_signature(uses_global_nested)
    finally:
        globals().pop("_GLOBAL_HELPER", None)
    assert g1 and g2 and g1 != g2
    assert n1 and n2 and n1 != n2


def test_callable_signature_bails_on_exotic_capture():
    big = np.zeros((1024, 1024), np.float32)       # > digest size limit

    def f(x):
        return x + big[0, 0]

    assert callable_signature(f) == ""
    assert any("65536" in r for r in signature_hazards(f))
    assert signature_hazards(lambda x: x) == []


def _capturing(value):
    return lambda x: x * 2.0 if value is not None else x


@pytest.mark.parametrize("a,b,same", [
    (torch.float32, torch.float32, True),
    (torch.float32, torch.bfloat16, False),
    (torch.device("cpu"), torch.device("meta"), False),
    (torch.zeros(4), torch.zeros(4), True),
    (torch.zeros(4), torch.ones(4), False),
    (torch.zeros(4, dtype=torch.bfloat16), torch.zeros(4), False),
    (torch.empty(8, 8, device="meta"), torch.empty(8, 8, device="meta"),
     True),
    (torch.empty(8, 8, device="meta"), torch.empty(8, 4, device="meta"),
     False),
    (torch.Generator().manual_seed(3), torch.Generator().manual_seed(3),
     True),
    (torch.Generator().manual_seed(3), torch.Generator().manual_seed(4),
     False),
], ids=["dtype", "dtype-other", "device-other", "tensor", "tensor-values",
        "tensor-dtype", "meta", "meta-shape", "generator",
        "generator-seed"])
def test_torch_state_signs_by_content(a, b, same):
    """Captured torch state signs by content, stably across objects (and
    so across processes): a dtype or device by name, a small tensor by
    its bytes, a meta tensor by shape (it has no values), a generator by
    its state."""
    sa, sb = callable_signature(_capturing(a)), callable_signature(
        _capturing(b))
    assert sa and sb
    assert (sa == sb) is same


def test_generator_signs_by_its_draw_history_and_large_tensors_bail():
    g = torch.Generator().manual_seed(7)
    before = callable_signature(_capturing(g))
    torch.randn(3, generator=g)
    assert callable_signature(_capturing(g)) != before
    big = torch.zeros(300, 300)
    assert callable_signature(_capturing(big)) == ""
    assert any("tensor" in r for r in signature_hazards(_capturing(big)))
    # a meta tensor of any size has no values to hash: it signs by shape
    assert callable_signature(_capturing(torch.empty(
        4096, 4096, device="meta")))


def test_args_signature_shapes_dtypes_strides_and_scalars():
    a = f32(4, 8)
    b = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    assert args_signature((a,)) != args_signature((b,))
    assert args_signature((a, 2)) != args_signature((a, 3))
    assert args_signature((a,)) == args_signature((f32(4, 8),))
    assert args_signature((a,)) != args_signature((f32(8, 4).T,))
    assert args_signature((a,)) != args_signature((torch.ones(4, 8),))
    assert args_signature(([a, a],)) != args_signature(((a, a),))


# ---------------------------------------------------------------------------
# concrete count cache
# ---------------------------------------------------------------------------


def _kern(i, sig="kern_sig_v1"):
    size = 8 * (i + 1)

    def make_args(device, s=size):
        return (_ones(s, device),)

    return MeasurementKernel(
        name=f"ck_{size}", fn=lambda x: x * 2.0 + 1.0,
        make_args=make_args, tags={"n": size}, sizes={"n": size},
        code_sig=f"{sig}_{i}")


def test_concrete_counts_cached_in_process_and_persisted(tmp_path):
    eng = CountEngine(store=tmp_path)
    c1 = eng.counts_for(_kern(0))
    assert eng.stats() == {"hits": 0, "misses": 1, "trace_count": 1,
                           "families": 0}
    c2 = eng.counts_for(_kern(0))          # fresh kernel object, same key
    assert c2 == c1 and eng.hits == 1 and eng.trace_count == 1

    warm = CountEngine(store=tmp_path)     # fresh engine, same store
    assert warm.counts_for(_kern(0)) == c1
    assert warm.trace_count == 0 and warm.hits == 1


def test_unsignable_kernels_are_traced_not_poisoned(tmp_path):
    eng = CountEngine(store=tmp_path)
    k = _kern(0, sig="x")
    k.code_sig = ""
    ns = {}
    exec("def nosrc(x):\n    return x", ns)
    k.fn = ns["nosrc"]                     # unsignable: no source at all
    eng.counts_for(k)
    eng.counts_for(k)
    assert eng.trace_count == 2 and eng.hits == 0
    assert not (tmp_path / "counts").is_dir() \
        or not list((tmp_path / "counts").glob("*.json"))


def test_corrupt_store_entry_reads_as_miss(tmp_path):
    eng = CountEngine(store=tmp_path)
    eng.counts_for(_kern(0))
    (entry,) = (tmp_path / "counts").glob("*.json")
    entry.write_text("{ torn")
    warm = CountEngine(store=tmp_path)
    warm.counts_for(_kern(0))
    assert warm.trace_count == 1           # miss → count again → heal
    again = CountEngine(store=tmp_path)
    again.counts_for(_kern(0))
    assert again.trace_count == 0


def test_store_is_keyed_by_the_torch_version(tmp_path, monkeypatch):
    """A store written under one torch build is never served to another:
    its fake-tensor decompositions may count differently."""
    CountEngine(store=tmp_path).counts_for(_kern(0))
    monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    other = CountEngine(store=tmp_path)
    other.counts_for(_kern(0))
    assert other.trace_count == 1 and other.hits == 0


def test_count_store_gc(tmp_path):
    import time
    eng = CountEngine(store=tmp_path)
    for i in range(4):
        eng.counts_for(_kern(i))
    entries = sorted((tmp_path / "counts").glob("*.json"))
    entries[0].write_text("{ torn")
    payload = json.loads(entries[1].read_text())
    payload["version"] = -1
    entries[1].write_text(json.dumps(payload))
    old = time.time() - 3600
    os.utime(entries[2], (old, old))
    stray = tmp_path / "counts" / "notes.json"
    stray.write_text("{}")
    stats = eng.gc(max_age=600)
    assert (stats.kept, stats.dropped_corrupt, stats.dropped_schema,
            stats.dropped_old) == (1, 1, 1, 1)
    assert stats.dropped == 3 and stray.exists()
    assert CountEngine().gc().kept == 0     # no store: nothing to sweep


def test_cold_key_raced_by_threads_is_counted_once():
    """Threads racing one cold key: one counting pass, and every lookup
    is a hit or a miss."""
    eng = CountEngine()
    x = f32(64)

    def fn(v):
        return v * 2.0

    errors = []

    def work():
        try:
            for _ in range(5):
                eng.counts_of_callable(fn, (x,))
        except Exception as e:     # noqa: BLE001 — surfaced below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert eng.trace_count == 1
    assert eng.hits + eng.misses == 80 and eng.misses == 1


# ---------------------------------------------------------------------------
# symbolic kernel families
# ---------------------------------------------------------------------------


def _build_fam(*, n: int) -> MeasurementKernel:
    def fn(a, b):
        return torch.tanh(a @ b)

    def make_args(device):
        x = torch.ones((n, n), dtype=torch.float32, device=device)
        return x, x

    return MeasurementKernel(name=f"fam_{n}", fn=fn, make_args=make_args,
                             tags={"n": n}, sizes={"n": n})


def _fam_gen(sizes=(64, 128, 256, 512)):
    return Generator("fam_gen", frozenset({"fam"}),
                     arg_space=dict(n=tuple(sizes)), build=_build_fam,
                     family=FamilySpec(var_degrees={"n": 3}))


def test_family_probe_grid_is_the_only_tracing(tmp_path):
    kernels = list(_fam_gen().variants({}))
    assert all(k.family is not None for k in kernels)
    assert len({k.family.key for k in kernels}) == 1
    eng = CountEngine(store=tmp_path)
    rows = eng.counts_batch(kernels)
    assert eng.trace_count == 4
    for k, row in zip(kernels, rows):
        direct = count_fn(k.fn, *k.make_args("meta"))
        for fid, v in direct.items():
            assert row[fid] == pytest.approx(v), (k.name, fid)
        assert all(fid in direct for fid, v in row.items() if v)

    warm = CountEngine(store=tmp_path)
    rows2 = warm.counts_batch(kernels)
    assert warm.trace_count == 0 and warm.hits == 1
    assert [dict(r) for r in rows2] == [dict(r) for r in rows]


def test_counts_for_uses_family_polynomial_at_unseen_sizes(tmp_path):
    """The serving path reuses a reconstructed family for sizes never
    probed or gathered — zero counting passes, not one per new size."""
    gen = _fam_gen()
    eng = CountEngine(store=tmp_path)
    eng.counts_batch(list(gen.variants({})))
    assert eng.trace_count == 4

    warm = CountEngine(store=tmp_path)
    (unseen,) = gen.variants({"n": (512,)})
    unseen.sizes = {"n": 768}                  # a size no probe ever saw
    unseen.name = "fam_768"
    unseen.fn, unseen.make_args = _build_fam(n=768).fn, \
        _build_fam(n=768).make_args
    c = warm.counts_for(unseen)
    assert warm.trace_count == 0
    assert c["f_op_float32_madd"] == 768 ** 3
    assert c["f_op_float32_transc"] == 768 ** 2


def test_family_applies_gate_falls_back_to_concrete_counting():
    gen = Generator("gated", frozenset({"g"}),
                    arg_space=dict(n=(16, 32), kind=("a", "b")),
                    build=lambda *, n, kind: _build_fam(n=n),
                    family=FamilySpec(var_degrees={"n": 3},
                                      applies=lambda **fx:
                                      fx["kind"] == "a"))
    kernels = list(gen.variants({}))
    assert len([k for k in kernels if k.family is not None]) == 2
    assert len([k for k in kernels if k.family is None]) == 2
    eng = CountEngine()
    eng.counts_batch(kernels)
    assert eng.trace_count == 6             # one family (4) + 2 concrete


def _first_family(gen):
    return next(k.family for k in gen.variants({}) if k.family is not None)


@pytest.mark.parametrize("gen", ALL_GENERATORS, ids=lambda g: g.name)
def test_each_generator_family_costs_its_probe_grid(gen, tmp_path):
    """A family costs ``∏(degree + 1)`` counting passes, once: a fresh
    engine on the same store costs none."""
    fam = _first_family(gen)
    eng = CountEngine(store=tmp_path)
    eng.symbolic(fam)
    assert eng.trace_count == math.prod(d + 1
                                        for d in fam.var_degrees.values())
    eng.symbolic(fam)
    warm = CountEngine(store=tmp_path)
    warm.symbolic(fam)
    assert eng.trace_count == math.prod(d + 1
                                        for d in fam.var_degrees.values())
    assert warm.trace_count == 0 and warm.hits == 1


def test_declared_degrees_are_the_references_where_the_reference_declares():
    """The port declares the reference's degrees and gates; only
    ``mem_stream`` strided opts out, and ``matmul_sq`` staged probes on
    its tile."""
    ref = {g.name: g.family for g in juipick.ALL_GENERATORS}
    for g in ALL_GENERATORS:
        assert dict(g.family.var_degrees) == dict(ref[g.name].var_degrees)
    strided = [k for k in ALL_GENERATORS[3].variants(
        {"pattern": ("strided", "contig")})]
    assert {k.tags["pattern"] for k in strided if k.family is None} \
        == {"strided"}
    (staged,) = ALL_GENERATORS[0].variants(
        {"n": (512,), "dtype": ("float32",), "prefetch": (True,),
         "tile": (64,)})
    assert (staged.family.base, staged.family.scale) == (64, 64)


SELECTIONS = [
    (CALIBRATION_TAGS, MatchCondition.INTERSECT),
    (STUDY_TAGS, MatchCondition.INTERSECT),
    *((tags, MatchCondition.SUPERSET) for tags in (
        paper_figures.FIG1_CAL_TAGS, paper_figures.FIG12_TEST_TAGS,
        paper_figures.FIG2_CAL_TAGS, paper_figures.FIG5_TAGS,
        paper_figures.FIG7_TAGS, paper_figures.FIG8_TAGS,
        paper_figures.FIG9_TAGS)),
]


def test_every_selected_kernel_is_a_generator_variant():
    """The calibration, study and seven figures' selections (94 kernels)
    are all among the variants the next test counts."""
    coll = KernelCollection(ALL_GENERATORS)
    selected = {k.name for tags, match in SELECTIONS
                for k in coll.generate_kernels(list(tags), match)}
    every = {k.name for g in ALL_GENERATORS for k in g.variants({})}
    assert len(selected) > 60 and selected <= every


@pytest.mark.parametrize("gen", ALL_GENERATORS, ids=lambda g: g.name)
def test_engine_counts_are_count_fn_at_real_sizes(gen):
    """Every variant of every generator (the reference's whole argument
    space, 292 kernels), at its real sizes on ``meta``: the engine's
    counts — family polynomials at the declared degrees, or per-shape
    counting where a family's gate opts out — are ``count_fn``'s,
    exactly, feature for feature."""
    kernels = list(gen.variants({}))
    rows = CountEngine().counts_batch(kernels)
    for k, row in zip(kernels, rows):
        direct = count_fn(k.fn, *k.make_args("meta"))
        for fid in set(direct) | set(row):
            assert row[fid] == direct[fid], (k.name, fid)


# ---------------------------------------------------------------------------
# the hand kernels: signed by the library hash and their cost rules
# ---------------------------------------------------------------------------

TARGETS = {t.name: t for t in kernel_targets()}


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_hand_kernel_targets_sign_by_library_and_cost_rule(name,
                                                           monkeypatch):
    """Editing a ``.cu`` source (the library hash) or a cost rule turns
    every stored count of a hand kernel into a miss.  Signing needs no
    ``nvcc``."""
    fn = TARGETS[name].fn
    base = callable_signature(fn)
    assert base and callable_signature(fn) == base
    lib = _build.library_path()
    monkeypatch.setattr(_build, "library_path",
                        lambda: lib.with_name("librepro_torch_kernels_"
                                              "edited.so"))
    assert callable_signature(fn) not in ("", base)
    monkeypatch.undo()
    assert callable_signature(fn) == base
    op = {"kernels.ops.matmul": "matmul_tiled",
          "kernels.ops.stream_strided": "stream_strided",
          "kernels.ops.madd_throughput": "madd_throughput"}.get(
        name, name.rsplit(".", 1)[1])
    def edited_rule(*args, **kwargs):
        return counting.FeatureCounts(f_sync_launch_kernel=1.0)

    monkeypatch.setitem(counting._OP_COST_RULES, f"repro_torch::{op}",
                        edited_rule)
    assert callable_signature(fn) not in ("", base)


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_hand_kernel_targets_count_their_cost_rules_through_the_engine(
        name, tmp_path):
    """Each built-in target: the engine's counts are its cost rule's
    (``count_fn`` meets the custom op and calls the rule), cold and from
    the persisted store with no counting pass."""
    t = TARGETS[name]
    want = count_fn(t.fn, *t.args)
    assert want["f_sync_grid_programs"] > 0
    for engine, traces in ((CountEngine(store=tmp_path), 1),
                           (CountEngine(store=tmp_path), 0)):
        assert engine.counts_of_callable(t.fn, t.args) == want
        assert engine.trace_count == traces


@pytest.mark.parametrize("case", sorted(REFERENCE_FEATURES))
def test_hand_kernels_count_their_closed_forms_through_the_engine(
        case, tmp_path):
    """Each cost-rule case of ``test_torch_kernels.py``: the engine's
    counts are the pinned closed form, cold, then from the persisted store
    with no counting pass."""
    fn, args, want = REFERENCE_FEATURES[case]
    for engine, traces in ((CountEngine(store=tmp_path), 1),
                           (CountEngine(store=tmp_path), 0)):
        got = engine.counts_of_callable(fn, args)
        assert engine.trace_count == traces
        assert {k: v for k, v in got.items()
                if v and not k.startswith("f_vmem_")} == want


# ---------------------------------------------------------------------------
# gather_feature_table through the engine
# ---------------------------------------------------------------------------

FEATURES = ["f_wall_time_cpu_host", "f_op_float32_madd",
            "f_op_float32_transc"]


def test_gather_with_engine_fills_counts_from_family(tmp_path):
    kernels = list(_fam_gen().variants({}))
    eng = CountEngine(store=tmp_path / "counts")
    timer = CountingTimer(lambda k, t: 0.125)
    cache = MeasurementCache(tmp_path / "cache", FP)
    table = gather_feature_table(FEATURES, kernels, trials=4, timer=timer,
                                 cache=cache, engine=eng)
    assert eng.trace_count == 4            # probes only, not per kernel
    assert timer.calls == len(kernels)
    for k, row in zip(kernels, table.values):
        assert row[1] == k.sizes["n"] ** 3
        assert row[2] == k.sizes["n"] ** 2

    eng2 = CountEngine(store=tmp_path / "counts")
    timer2 = CountingTimer(lambda k, t: 0.125)
    table2 = gather_feature_table(FEATURES, list(_fam_gen().variants({})),
                                  trials=4, timer=timer2,
                                  cache=MeasurementCache(tmp_path / "cache",
                                                         FP),
                                  engine=eng2)
    assert timer2.calls == 0 and eng2.trace_count == 0
    np.testing.assert_array_equal(table.values, table2.values)


def test_gather_times_in_gather_duplicates_once(tmp_path):
    k1, k2 = _kern(0), _kern(0)                # same identity, two objects
    timer = CountingTimer(lambda k, t: 0.125)
    table = gather_feature_table(
        ["f_wall_time_cpu_host", "f_op_float32_mul"], [k1, k2],
        trials=4, timer=timer, cache=MeasurementCache(tmp_path, FP))
    assert timer.calls == 1
    np.testing.assert_array_equal(table.values[0], table.values[1])


# ---------------------------------------------------------------------------
# predict_batch dedup
# ---------------------------------------------------------------------------

OVL_EXPR = ("overlap2(p_madd * f_op_float32_madd, "
            "p_mem * (f_mem_contig_float32_load "
            "+ f_mem_contig_float32_store + f_op_float32_add), p_edge) "
            "+ p_launch * f_sync_launch_kernel")


def _profile():
    model = Model("f_wall_time_cpu_host", OVL_EXPR)
    fit = FitResult(params={"p_madd": 5e-11, "p_mem": 4e-10,
                            "p_launch": 3e-6, "p_edge": 40.0},
                    residual_norm=0.0, iterations=1, converged=True)
    return MachineProfile(fingerprint=FP,
                          fits={"ovl_flop_mem": ModelFit.from_fit(model,
                                                                  fit)},
                          trials=4)


def test_predict_batch_dedupes_unique_signature_shapes(tmp_path):
    engine = CountEngine(store=tmp_path)
    session = PerfSession.open(_profile(), engine=engine)
    unique = [_kern(i) for i in range(8)]
    preds = session.predict_batch([unique[i % 8] for i in range(64)])
    assert len(preds) == 64
    assert engine.trace_count == 8         # one pass per unique item
    assert session.timer.calls == 0
    assert session.eval_calls == 1
    for i, p in enumerate(preds):
        assert p.seconds == preds[i % 8].seconds
        assert p.breakdown == preds[i % 8].breakdown
        assert sum(p.breakdown.values()) == pytest.approx(p.seconds,
                                                          rel=1e-6)

    warm_engine = CountEngine(store=tmp_path)
    warm = PerfSession.open(_profile(), engine=warm_engine)
    preds2 = warm.predict_batch([_kern(i % 8) for i in range(64)])
    assert warm_engine.trace_count == 0
    assert [p.seconds for p in preds2] == [p.seconds for p in preds]


def test_predict_batch_never_dedupes_distinct_closure_state():
    def make(c):
        return lambda x: x * c

    session = PerfSession.open(_profile())
    x = f32(16)
    session.predict_batch([(make(2.0), (x,)), (make(3.0), (x,))])
    assert session.engine.trace_count == 2
    f = make(2.0)
    session2 = PerfSession.open(_profile())
    session2.predict_batch([(f, (x,)), (f, (x,)), (f, (x,))])
    assert session2.engine.trace_count == 1


def test_predict_batch_dedup_respects_names_and_indices():
    session = PerfSession.open(_profile())

    def my_kernel(x):
        return x * 3.0

    x = f32(16)
    preds = session.predict_batch([(my_kernel, (x,)), (my_kernel, (x,))])
    assert [p.kernel for p in preds] == ["my_kernel[0]", "my_kernel[1]"]
    assert session.engine.trace_count == 1


def test_try_predict_batch_returns_per_item_errors():
    """One out-of-scope item comes back as its own PredictionError, its
    batch-mates as predictions, in one batched evaluation."""
    from repro_torch.api import PredictionError
    session = PerfSession.open(_profile())
    x = f32(16)
    out = session.try_predict_batch([
        (lambda v: v @ v, (f32(16, 16),)), (lambda v: torch.exp(v), (x,)),
        (lambda v: v + 1.0, (x,))])
    assert isinstance(out[1], PredictionError)
    assert [v["index"] for v in out[1].violations] == [1]
    assert not isinstance(out[0], PredictionError)
    assert not isinstance(out[2], PredictionError)
    assert session.eval_calls == 1
    assert session.try_predict_batch([]) == []


def test_hand_kernel_predictions_are_warm_across_sessions(tmp_path):
    """All eight hand-kernel targets priced twice through one cache: the
    second session counts nothing."""
    items = [(t.fn, t.args) for t in TARGETS.values()]
    cold = PerfSession.open(_profile(), cache=tmp_path)
    first = cold.predict_batch(items)
    assert cold.engine.trace_count == len(items)
    again = cold.predict_batch(items)
    assert cold.engine.trace_count == len(items)
    warm = PerfSession.open(_profile(), cache=tmp_path)
    second = warm.predict_batch(items)
    assert warm.engine.trace_count == 0
    assert [p.seconds for p in second] == [p.seconds for p in first] \
        == [p.seconds for p in again]


def test_session_default_engine_persists_beside_cache(tmp_path):
    session = PerfSession.open(_profile(), cache=tmp_path / "cache")
    assert session.engine.store == (tmp_path / "cache" / "countengine")
    assert PerfSession.open(_profile()).engine.store is None


def test_count_store_is_not_a_cache_entry(tmp_path):
    """Engine files live in a subdirectory the measurement cache's GC and
    entry census never touch."""
    cache = MeasurementCache(tmp_path, FP)
    eng = CountEngine(store=cache.count_store)
    eng.counts_for(_kern(0))
    kernels = list(_fam_gen().variants({}))
    eng.counts_batch(kernels)
    assert len(cache) == 0
    assert cache.gc().dropped == 0
    warm = CountEngine(store=cache.count_store)
    warm.counts_for(_kern(0))
    warm.counts_batch(kernels)
    assert warm.trace_count == 0


def test_partial_of_a_wrapper_signs_its_bound_blocks():
    from repro_torch.kernels import ops
    a = functools.partial(ops.matmul, block_m=128, block_n=128,
                          block_k=128)
    b = functools.partial(ops.matmul, block_m=64, block_n=64, block_k=64)
    assert callable_signature(a) and callable_signature(a) != \
        callable_signature(b)
    assert countengine.callable_signature(ops.matmul)


def test_signatures_and_store_are_stable_across_processes(tmp_path):
    """A fresh process signs the hand-kernel targets alike and is served
    by the store another process wrote: zero counting passes (a signature
    built from addresses would count again in every process)."""
    script = (
        "import json, sys\n"
        "from repro_torch.analysis.targets import kernel_targets\n"
        "from repro_torch.core.countengine import CountEngine, "
        "callable_signature\n"
        "eng = CountEngine(store=sys.argv[1])\n"
        "ts = kernel_targets()\n"
        "for t in ts:\n"
        "    eng.counts_of_callable(t.fn, t.args)\n"
        "print(json.dumps([[callable_signature(t.fn) for t in ts], "
        "eng.trace_count]))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    runs = [json.loads(subprocess.run(
        [sys.executable, "-c", script, str(tmp_path)], check=True,
        capture_output=True, text=True, env=env).stdout) for _ in range(2)]
    here = [callable_signature(t.fn) for t in kernel_targets()]
    assert runs[0][0] == runs[1][0] == here and all(here)
    assert runs[0][1] == len(here) and runs[1][1] == 0


# ---------------------------------------------------------------------------
# the loop helpers sign by the counter's own signature
# ---------------------------------------------------------------------------

#: the generators whose kernels loop with counted_range / counted_loop
LOOPING_GENERATORS = ("flops_dot_pattern", "flops_madd_pattern",
                      "matmul_sq", "onchip_pattern", "overlap_pattern",
                      "sync_loop_pattern")


def _looping_kernel(name):
    gen = next(g for g in ALL_GENERATORS if g.name == name)
    for k in gen.variants({}):
        code = k.fn.__code__
        if {"counted_range", "counted_loop"} & \
                countengine._referenced_names(code):
            return k
    raise AssertionError(f"no variant of {name} loops")


@pytest.mark.parametrize("name", LOOPING_GENERATORS)
def test_looping_generator_kernels_sign(name):
    """A kernel reaching ``counted_range``/``counted_loop`` (whose
    globals hold the counter's ContextVar) signs by content, and the
    engine counts it once."""
    k = _looping_kernel(name)
    assert callable_signature(k.fn)
    assert signature_hazards(k.fn) == []
    engine = CountEngine()
    args = k.make_args("meta")
    first = engine.counts_of_callable(k.fn, args)
    assert (engine.trace_count, engine.misses, engine.hits) == (1, 1, 0)
    assert engine.counts_of_callable(k.fn, args) == first
    assert (engine.trace_count, engine.misses, engine.hits) == (1, 1, 1)


def test_an_edit_to_the_counter_changes_a_looping_kernel_s_signature(
        monkeypatch):
    """The loop helpers sign as the counter: editing ``counting.py``
    turns every stored count of a looping kernel into a miss."""
    k = _looping_kernel("matmul_sq")
    before = callable_signature(k.fn)
    source = countengine.source_signature

    def edited(obj):
        if obj is counting:
            import hashlib
            import inspect
            text = inspect.getsource(counting) + "\n# an edit\n"
            return hashlib.sha256(text.encode()).hexdigest()[:16]
        return source(obj)

    countengine._counter_signature.cache_clear()
    monkeypatch.setattr(countengine, "source_signature", edited)
    try:
        after = callable_signature(k.fn)
    finally:
        countengine._counter_signature.cache_clear()
    assert after and after != before


def test_another_undigestable_global_still_leaves_a_looper_unsignable():
    """Only the two helpers sign by the counter: a looping callable that
    also reaches captured state without a digest stays ``""``."""
    opaque = object()

    def fn(x):
        for _ in counting.counted_range(2):
            x = x + 1.0
        return x if opaque else x

    assert callable_signature(fn) == ""
    assert any("object" in r for r in signature_hazards(fn))
