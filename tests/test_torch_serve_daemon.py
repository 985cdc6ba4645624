"""The port's prediction daemon (``repro_torch.serving``) against the
reference's (``repro.serving``): a counterpart of every case of
``tests/test_serve_daemon.py``, the thread-safety repair of the port's
``PredictEngine`` (exact ``eval_calls`` and ``trace_count`` under 16
threads), the serving CLI's smoke on a profile calibrated on the host,
and a parity case in which both packages serve one profile file over
HTTP through their own daemons.

The guarantees are asserted through the same probes the CLI smoke uses:
zero timings (``session.timer.calls``), one batched evaluation for K
concurrent requests (``session.eval_calls``) with at most one count
lookup per unique kernel, and consistent count-engine ledgers under
races.

Tolerances: the parity case holds ``seconds`` and every ``breakdown``
term to rtol 1e-6 (the reference evaluates in float32 under its default
x64 setting, the port in float64; the float32 rounding of a sum of four
terms stays below 1e-6 of it) and the rest exactly.
"""
from __future__ import annotations

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import PerfSession, Prediction, PredictionError
from repro_torch.core.calibrate import FitResult
from repro_torch.core.countengine import CountEngine
from repro_torch.profiles import DeviceFingerprint, MachineProfile, ModelFit
from repro_torch.serving import (
    BatcherClosed,
    CoalescingBatcher,
    PredictionDaemon,
    SessionPool,
)
from repro_torch.studies.zoo import LIN_FLOP_MEM, OVL_FLOP_MEM

N_UNIQUE = 8
# the reference test's fit (tests/test_serve_daemon.py::_profile)
PARAMS = {"p_madd": 5e-11, "p_mem": 4e-10, "p_launch": 3e-6, "p_edge": 40.0}
PARITY_RTOL = 1e-6


def _profile(*, two_fits: bool = False) -> MachineProfile:
    fits = {OVL_FLOP_MEM.name: ModelFit.from_fit(
        OVL_FLOP_MEM.model(),
        FitResult(params=dict(PARAMS), residual_norm=0.0, iterations=1,
                  converged=True))}
    if two_fits:
        lin = {p: PARAMS[p] for p in ("p_madd", "p_mem", "p_launch")}
        fits[LIN_FLOP_MEM.name] = ModelFit.from_fit(
            LIN_FLOP_MEM.model(),
            FitResult(params=lin, residual_norm=0.0, iterations=1,
                      converged=True))
    return MachineProfile(
        fingerprint=DeviceFingerprint(platform="synth",
                                      device_kind="serve-test",
                                      n_devices=1),
        fits=fits, trials=3)


def _ones(size: int) -> torch.Tensor:
    return torch.from_numpy(np.ones((size,), np.float32))


def _targets(n: int = N_UNIQUE):
    """n unique in-scope (fn, args) predict items (adds + contiguous
    memory — inside the ovl_flop_mem model's scope)."""
    out = {}
    for i in range(n):
        size = 32 * (i + 1)
        out[f"t{i}"] = ((lambda x: x + 1.0), (_ones(size),))
    return out


def _session(**kw) -> PerfSession:
    return PerfSession.open(_profile(), **kw)


# ---------------------------------------------------------------------------
# the PredictEngine's thread-safety contract
# ---------------------------------------------------------------------------


def test_predict_engine_counters_are_exact_under_16_threads():
    """Every predict is one batched evaluation: 16 threads × 40 calls
    must count 640 of them, and the two fits used build two evaluators.
    A tiny switch interval makes the interpreter preempt between the
    read and the write of an unguarded ``+=``."""
    session = PerfSession.open(_profile(two_fits=True))
    items = list(_targets(4).values())
    session.predict_batch(items)            # counts warm, off the race
    evals0 = session.eval_calls
    n_threads, n_calls = 16, 40
    fits = (OVL_FLOP_MEM.name, LIN_FLOP_MEM.name)
    barrier = threading.Barrier(n_threads)

    def hammer(tid: int):
        barrier.wait()
        out = []
        for i in range(n_calls):
            fn, args = items[(tid + i) % len(items)]
            out.append(session.predict(fn, *args,
                                       model=fits[(tid + i) % 2]))
        return out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            preds = [p for f in [pool.submit(hammer, t)
                                 for t in range(n_threads)]
                     for p in f.result(timeout=120)]
    finally:
        sys.setswitchinterval(old)
    assert len(preds) == n_threads * n_calls
    assert all(p.seconds > 0 for p in preds)
    assert {p.model for p in preds} == set(fits)
    assert session.eval_calls - evals0 == n_threads * n_calls
    assert session.trace_count == len(fits)
    assert session.timer.calls == 0


# ---------------------------------------------------------------------------
# CountEngine under contention
# ---------------------------------------------------------------------------


def test_cold_race_traces_each_kernel_exactly_once():
    engine = CountEngine()
    targets = list(_targets().values())
    n_threads = 16
    barrier = threading.Barrier(n_threads)

    def hammer(tid: int):
        barrier.wait()      # maximal contention on the cold path
        for i in range(len(targets) * 4):
            fn, args = targets[(tid + i) % len(targets)]
            c = engine.counts_of_callable(fn, args)
            assert c["f_op_float32_add"] == args[0].shape[0]

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        for f in [pool.submit(hammer, t) for t in range(n_threads)]:
            f.result(timeout=60)

    stats = engine.stats()
    # two threads racing one cold kernel perform exactly one counting pass
    assert stats["trace_count"] == N_UNIQUE
    assert stats["misses"] == N_UNIQUE
    lookups = n_threads * len(targets) * 4
    assert stats["hits"] + stats["misses"] == lookups


def _store_bytes(store: Path) -> dict:
    return {p.relative_to(store).as_posix(): p.read_bytes()
            for p in sorted(store.rglob("*")) if p.is_file()}


def test_contended_store_is_byte_identical_to_serial(tmp_path):
    targets = list(_targets().values())

    serial = CountEngine(store=tmp_path / "serial")
    for fn, args in targets:
        serial.counts_of_callable(fn, args)

    racy = CountEngine(store=tmp_path / "racy")
    with ThreadPoolExecutor(max_workers=16) as pool:
        futs = [pool.submit(racy.counts_of_callable, fn, args)
                for _ in range(8) for fn, args in targets]
        for f in futs:
            f.result(timeout=60)

    assert _store_bytes(tmp_path / "racy") \
        == _store_bytes(tmp_path / "serial")

    # a third engine reading the racy store serves all counts passlessly
    warm = CountEngine(store=tmp_path / "racy")
    for fn, args in targets:
        warm.counts_of_callable(fn, args)
    assert warm.trace_count == 0


def test_threaded_predict_zero_traces_and_timings_after_warmup(tmp_path):
    session = _session(engine=CountEngine(store=tmp_path / "store"))
    targets = list(_targets().values())
    session.predict_batch(targets)                      # warmup
    traces0 = session.engine.trace_count

    def burst(tid: int):
        fn, args = targets[tid % len(targets)]
        return session.predict(fn, *args)

    with ThreadPoolExecutor(max_workers=12) as pool:
        preds = [f.result(timeout=60)
                 for f in [pool.submit(burst, t) for t in range(24)]]

    assert all(isinstance(p, Prediction) and p.seconds > 0 for p in preds)
    assert session.engine.trace_count == traces0        # all warm
    assert session.timer.calls == 0
    stats = session.engine.stats()
    assert stats["hits"] + stats["misses"] \
        == len(targets) + 24                            # balanced ledger


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------


def test_concurrent_requests_coalesce_into_one_batched_eval():
    session = _session()
    batcher = CoalescingBatcher(session, max_wait_s=0.001)
    try:
        batcher.hold()
        futs = [batcher.submit(item, name=name)
                for name, item in _targets().items()
                for _ in range(4)]                      # 32 requests
        assert batcher.pending_count() == 32
        batcher.release()
        preds = [f.result(timeout=60) for f in futs]
        assert all(p.seconds > 0 for p in preds)
        # one drained batch → one batched evaluation, and dedup kept
        # count lookups at one per unique kernel
        assert session.eval_calls == 1
        eng = session.engine
        assert eng.hits + eng.misses == N_UNIQUE
        assert batcher.stats()["batches"] == 1
        assert batcher.stats()["max_batch_size"] == 32
    finally:
        batcher.close()


def test_batcher_maps_per_item_errors_to_the_right_caller():
    session = _session()
    batcher = CoalescingBatcher(session, max_wait_s=0.001)
    try:
        batcher.hold()
        good = batcher.submit((lambda x: x + 1.0, (_ones(64),)),
                              name="good", strict=True)
        bad = batcher.submit((lambda x: torch.exp(x), (_ones(64),)),
                             name="bad", strict=True)
        batcher.release()
        # the in-scope batch-mate is unaffected...
        assert good.result(timeout=60).seconds > 0
        # ...while the out-of-scope item gets its own typed error
        with pytest.raises(PredictionError) as exc:
            bad.result(timeout=60)
        (v,) = exc.value.violations
        assert v["kernel"] == "bad"
        assert "f_op_float32_transc" in v["features"]
        # and the mixed batch still cost one batched evaluation
        assert session.eval_calls == 1
    finally:
        batcher.close()


def test_closed_batcher_rejects_submits_but_drains_queue():
    session = _session()
    batcher = CoalescingBatcher(session, max_wait_s=0.001)
    batcher.hold()
    fut = batcher.submit((lambda x: x + 1.0, (_ones(32),)))
    batcher.close()                     # queued work drains before exit
    assert fut.result(timeout=60).seconds > 0
    with pytest.raises(BatcherClosed):
        batcher.submit((lambda x: x + 1.0, (_ones(32),)))


def test_strict_batch_collects_every_violation():
    session = _session()
    with pytest.raises(PredictionError) as exc:
        session.predict_batch(
            [(lambda x: x + 1.0, (_ones(32),)),
             (lambda x: torch.exp(x), (_ones(32),)),
             (lambda x: torch.sin(x), (_ones(64),))],
            names=["ok", "bad_exp", "bad_sin"], strict=True)
    vs = exc.value.violations
    # both offenders reported in one error, mapped to their indices
    assert [(v["index"], v["kernel"]) for v in vs] \
        == [(1, "bad_exp"), (2, "bad_sin")]
    assert all("f_op_float32_transc" in v["features"] for v in vs)
    assert "bad_exp" in str(exc.value) and "bad_sin" in str(exc.value)


# ---------------------------------------------------------------------------
# the LRU session pool
# ---------------------------------------------------------------------------


def test_session_pool_lru_eviction_and_reopen(tmp_path):
    opened = []

    def factory(path, *, cache=None):
        opened.append(path)
        return _session()

    pool = SessionPool(max_open=2, session_factory=factory)
    try:
        s1, b1 = pool.get("p1")
        s2, _ = pool.get("p2")
        assert pool.get("p1") == (s1, b1)               # LRU refresh: hit
        pool.get("p3")                                  # evicts p2 (LRU)
        assert pool.stats() == {"open": 2, "opens": 3, "hits": 1,
                                "evictions": 1}
        s2b, _ = pool.get("p2")                         # reopen evicts p1
        assert s2b is not s2
        assert opened == ["p1", "p2", "p3", "p2"]
        # the evicted entry's batcher was closed on the way out
        with pytest.raises(BatcherClosed):
            b1.submit((lambda x: x + 1.0, (_ones(16),)))
    finally:
        pool.close()


def test_session_pool_serves_through_fresh_batcher_after_eviction():
    def factory(path, *, cache=None):
        return _session()

    pool = SessionPool(max_open=1, session_factory=factory,
                       max_wait_s=0.001)
    try:
        _, b1 = pool.get("p1")
        _, b2 = pool.get("p2")                          # evicts + closes b1
        with pytest.raises(BatcherClosed):
            b1.submit((lambda x: x + 1.0, (_ones(16),)))
        pred = b2.predict((lambda x: x + 1.0, (_ones(16),)), timeout=60)
        assert pred.seconds > 0
        assert pool.stats()["evictions"] == 1
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# the HTTP daemon
# ---------------------------------------------------------------------------


@pytest.fixture
def daemon():
    d = PredictionDaemon(_session(), port=0, targets=_targets(4),
                         max_wait_s=0.001).start()
    yield d
    d.close()


def _post(url: str, body: dict, timeout: float = 60.0):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url: str):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _held_burst(daemon, names, burst):
    """``burst`` concurrent ``/predict`` requests cycling over ``names``,
    parked on the held batcher and released as one batch."""
    daemon.batcher.hold()
    with ThreadPoolExecutor(max_workers=burst) as pool:
        futs = [pool.submit(_post, f"{daemon.url}/predict",
                            {"kernel": names[i % len(names)]})
                for i in range(burst)]
        deadline = time.monotonic() + 30.0
        while daemon.batcher.pending_count() < burst:
            assert time.monotonic() < deadline, \
                f"only {daemon.batcher.pending_count()}/{burst} parked"
            time.sleep(0.005)
        daemon.batcher.release()
        return [f.result(timeout=60) for f in futs]


def test_daemon_serves_concurrent_burst_with_one_eval(daemon):
    burst = 16
    replies = _held_burst(daemon, [f"t{i}" for i in range(4)], burst)
    assert all(status == 200 for status, _ in replies)
    assert all(body["seconds"] > 0 and body["model"] == "ovl_flop_mem"
               for _, body in replies)
    stats = daemon.stats()
    assert stats["timings"] == 0
    assert stats["eval_calls"] == 1
    assert stats["count_lookups"] <= 4
    assert stats["batcher"]["max_batch_size"] == burst


def test_daemon_http_error_codes(daemon):
    status, body = _post(f"{daemon.url}/predict", {"kernel": "nope"})
    assert status == 404 and "t0" in body["known"]
    status, body = _post(f"{daemon.url}/predict", {})
    assert status == 400
    # strict + out-of-scope → 422 carrying the violation record
    daemon.targets["exp"] = ((lambda x: torch.exp(x)), (_ones(64),))
    status, body = _post(f"{daemon.url}/predict",
                         {"kernel": "exp", "strict": True})
    assert status == 422
    (v,) = body["violations"]
    assert v["features"] == ["f_op_float32_transc"]


def test_daemon_stats_and_shutdown_routes(daemon):
    assert _get(f"{daemon.url}/healthz") == {"ok": True}
    _post(f"{daemon.url}/predict", {"kernel": "t0"})
    stats = _get(f"{daemon.url}/stats")
    assert stats["timings"] == 0 and stats["batcher"]["requests"] == 1
    status, body = _post(f"{daemon.url}/shutdown", {})
    assert status == 200 and body == {"ok": True}
    # the listener actually stopped
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        try:
            urllib.request.urlopen(f"{daemon.url}/healthz", timeout=1)
            time.sleep(0.02)
        except (urllib.error.URLError, ConnectionError, OSError):
            break
    else:
        pytest.fail("daemon kept answering after /shutdown")


# ---------------------------------------------------------------------------
# the CLI smoke, on a profile calibrated on the host
# ---------------------------------------------------------------------------


def test_serve_smoke_cli_on_a_host_profile(tmp_path, capsys):
    """``python -m repro_torch.serve --smoke --burst 64
    --expect-zero-timings`` over the eight built-in hand-kernel targets
    (meta tensors), from a profile made by ``python -m
    repro_torch.calibrate --smoke --device cpu``; the daemon itself takes
    no device.  Also routes over a two-machine fleet."""
    from repro_torch.profiles.cli import main as calibrate_main
    from repro_torch.profiles.profile import save_profile
    from repro_torch.serving.cli import main as serve_main
    from repro_torch.testing.synthdev import exact_profile, fleet_device

    profile = tmp_path / "host.json"
    assert calibrate_main(["--smoke", "--device", "cpu", "--trials", "1",
                           "--out", str(profile)]) == 0
    fleet = []
    for name in ("bulk", "citra"):
        fleet += ["--fleet", str(tmp_path / f"{name}.json")]
        save_profile(exact_profile(fleet_device(name)), fleet[-1])
    capsys.readouterr()
    assert serve_main(["--profile", str(profile), "--smoke", "--burst",
                       "64", "--expect-zero-timings", *fleet]) == 0
    out = capsys.readouterr().out
    assert "8 kernel targets, burst 64" in out
    assert "routed 4 kernels over 2 machines" in out
    stats = json.loads(out.split("serve smoke: stats ", 1)[1]
                       .splitlines()[0])
    assert stats["timings"] == 0 and stats["eval_calls"] == 1
    assert stats["count_lookups"] == 8 and stats["count_traces"] == 8
    assert stats["batcher"]["max_batch_size"] == 64
    assert stats["trace_count"] == 1


# ---------------------------------------------------------------------------
# parity with the reference daemon
# ---------------------------------------------------------------------------


def test_daemon_parity_with_reference_over_http(tmp_path):
    """One profile file, written by the reference's ``MachineProfile``
    with the reference test's ``ovl_flop_mem`` fit, served by both
    daemons over the same lambda vocabulary (inputs from numpy): a held
    64-request burst gives equal ``/predict`` payloads (``seconds`` and
    every breakdown term to rtol 1e-6, ``unmodeled`` equal) and equal
    ``/stats`` counters."""
    import jax.numpy as jnp

    from repro.api import PerfSession as RefSession
    from repro.core.calibrate import FitResult as RefFit
    from repro.profiles import DeviceFingerprint as RefFingerprint
    from repro.profiles import MachineProfile as RefProfile
    from repro.profiles import ModelFit as RefModelFit
    from repro.profiles.profile import save_profile as ref_save_profile
    from repro.serving import PredictionDaemon as RefDaemon
    from repro.studies.zoo import OVL_FLOP_MEM as REF_OVL

    path = tmp_path / "profile.json"
    ref_save_profile(RefProfile(
        fingerprint=RefFingerprint(platform="synth",
                                   device_kind="serve-test", n_devices=1),
        fits={REF_OVL.name: RefModelFit.from_fit(
            REF_OVL.model(),
            RefFit(params=dict(PARAMS), residual_norm=0.0, iterations=1,
                   converged=True))},
        trials=3), path)

    sizes = [32 * (i + 1) for i in range(N_UNIQUE)]
    arrays = {s: np.ones((s,), np.float32) for s in sizes}
    ref_targets = {f"t{i}": ((lambda x: x + 1.0),
                             (jnp.asarray(arrays[s]),))
                   for i, s in enumerate(sizes)}
    port_targets = {f"t{i}": ((lambda x: x + 1.0),
                              (torch.from_numpy(arrays[s]),))
                    for i, s in enumerate(sizes)}
    names = sorted(port_targets)
    burst = 64

    results = {}
    for pkg, session, targets, cls in (
            ("ref", RefSession.open(path), ref_targets, RefDaemon),
            ("port", PerfSession.open(path), port_targets,
             PredictionDaemon)):
        d = cls(session, port=0, targets=targets,
                max_wait_s=0.001).start()
        try:
            replies = _held_burst(d, names, burst)
            stats = _get(f"{d.url}/stats")
        finally:
            d.close()
        assert all(status == 200 for status, _ in replies), pkg
        by_kernel = {}
        for _, body in replies:
            # every reply for one kernel is the same payload
            assert by_kernel.setdefault(body["kernel"], body) == body
        results[pkg] = (by_kernel, stats)

    (ref_payloads, ref_stats), (port_payloads, port_stats) = \
        results["ref"], results["port"]
    assert sorted(port_payloads) == sorted(ref_payloads) == names
    for name in names:
        r, p = ref_payloads[name], port_payloads[name]
        assert p["model"] == r["model"] == "ovl_flop_mem"
        assert p["unmodeled"] == r["unmodeled"]
        assert p["seconds"] == pytest.approx(r["seconds"], rel=PARITY_RTOL)
        assert sorted(p["breakdown"]) == sorted(r["breakdown"])
        for term, value in r["breakdown"].items():
            assert p["breakdown"][term] == pytest.approx(
                value, rel=PARITY_RTOL, abs=1e-30), (name, term)
    assert sorted(port_stats) == sorted(ref_stats)
    for key in ("timings", "eval_calls", "count_lookups", "batcher"):
        assert port_stats[key] == ref_stats[key], key
    assert port_stats["batcher"] == {"requests": burst, "batches": 1,
                                     "max_batch_size": burst,
                                     "coalesced": burst - 1}
    assert port_stats["eval_calls"] == 1
    assert port_stats["count_lookups"] == N_UNIQUE


def test_serve_bench_rows_and_zero_timings():
    """The serving bench: every coalesced round is one batched
    evaluation, nothing is timed, and the reference's six rows come
    out."""
    from repro_torch.studies import serve_bench

    res = serve_bench.serve_bench()
    assert res["timings"] == 0
    assert res["burst_evals"] == serve_bench.ROUNDS
    assert res["requests"] == serve_bench.ROUNDS * serve_bench.BURST
    assert 0 < res["serial_p50_s"] <= res["serial_p99_s"]
    assert 0 < res["coalesced_p50_s"] <= res["coalesced_p99_s"]
    rows = serve_bench.rows(res)
    assert [r.split(",")[0] for r in rows] == [
        "serve.serial_p50_us", "serve.serial_p99_us",
        "serve.coalesced_p50_us", "serve.coalesced_p99_us",
        "serve.burst_us_per_request", "serve.burst_evals"]
