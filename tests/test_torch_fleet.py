"""The port's fleet routing (``repro_torch.fleet``) against the
reference's (``repro.fleet``): a counterpart of every case of
``tests/test_fleet.py`` — the health skew loop, router policies and
ledgers, the deterministic scheduler simulation and the daemon's fleet
endpoints — plus the fleet CLI's gates, the router's device rule, and
parity cases in which both packages play the same scenario.

The routing guarantees are asserted through the same probes as the
reference's: zero timings (``router.timings()``), one batched
evaluation per machine per ``route_batch``, and bit-identical replays.

Parity tolerances: the reference runs under ``jax_enable_x64`` (its
float32 default would round the truth laws and the predictions the port
evaluates in float64, and a near-tie could flip a placement), job
arrivals agree to rtol 1e-12 and makespans to rtol 1e-9; kernel names,
per-machine job counts and flagged machines agree exactly.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Dict

import numpy as np
import pytest
import torch

from repro_torch.fleet import (
    Degradation,
    FleetHealth,
    FleetRouter,
    HealthEvent,
    heavy_tailed_jobs,
    simulate_fleet,
)
from repro_torch.testing.synthdev import (
    exact_profile,
    fleet_device,
    synthetic_fleet,
)

ARRIVAL_RTOL = 1e-12
MAKESPAN_RTOL = 1e-9


def _fleet_profiles(n: int = 3):
    fleet = synthetic_fleet(n)
    return fleet, [exact_profile(d) for d in fleet]


def _router(n: int = 3, **kw) -> FleetRouter:
    _fleet, profiles = _fleet_profiles(n)
    return FleetRouter.from_profiles(profiles, **kw)


def _ones(size: int) -> torch.Tensor:
    return torch.from_numpy(np.ones((size,), np.float32))


def _item(size: int = 64):
    return ((lambda x: x + 1.0), (_ones(size),))


# ---------------------------------------------------------------------------
# FleetHealth: skew EWMA → demotion → recalibration flag
# ---------------------------------------------------------------------------


def test_health_first_observation_sets_skew():
    h = FleetHealth(alpha=0.25)
    snap = h.observe("m", observed_s=2.0, predicted_s=1.0)
    assert snap.skew == pytest.approx(2.0)
    assert snap.n_obs == 1


def test_health_ewma_converges_to_ratio():
    h = FleetHealth(alpha=0.5)
    for _ in range(20):
        snap = h.observe("m", observed_s=3.0, predicted_s=1.0)
    assert snap.skew == pytest.approx(3.0, rel=1e-4)
    assert snap.degradation == pytest.approx(2.0, rel=1e-4)


def test_health_weight_needs_min_obs():
    h = FleetHealth(min_obs=3)
    h.observe("m", observed_s=10.0, predicted_s=1.0)
    h.observe("m", observed_s=10.0, predicted_s=1.0)
    assert h.weight("m") == 1.0             # under-observed: no demotion
    h.observe("m", observed_s=10.0, predicted_s=1.0)
    assert h.weight("m") == pytest.approx(0.1)


def test_health_healthy_machine_keeps_full_weight():
    h = FleetHealth()
    for _ in range(10):
        h.observe("m", observed_s=1.05, predicted_s=1.0)
    assert h.weight("m") == 1.0             # below demote_skew
    assert h.weight("unknown") == 1.0
    assert h.needs_recalibration() == []


def test_health_weight_floors_at_min_weight():
    h = FleetHealth(min_weight=0.2)
    for _ in range(10):
        h.observe("m", observed_s=100.0, predicted_s=1.0)
    assert h.weight("m") == pytest.approx(0.2)


def test_health_min_weight_one_disables_demotion_keeps_flags():
    h = FleetHealth(min_weight=1.0)
    for _ in range(10):
        h.observe("m", observed_s=4.0, predicted_s=1.0)
    assert h.weight("m") == 1.0
    assert h.needs_recalibration() == ["m"]


def test_health_flag_latches_and_callback_fires_once():
    events = []
    h = FleetHealth(on_recalibrate=events.append)
    for _ in range(10):
        h.observe("m", observed_s=5.0, predicted_s=1.0)
    assert h.needs_recalibration() == ["m"]
    assert len(events) == 1                 # latched: fires exactly once
    assert isinstance(events[0], HealthEvent)
    assert events[0].machine == "m"
    assert "recalibrate" in events[0].hint
    assert "python -m repro_torch.calibrate" in events[0].hint
    assert h.events == events


def test_health_clear_resets_machine_state():
    h = FleetHealth()
    for _ in range(5):
        h.observe("m", observed_s=5.0, predicted_s=1.0)
    assert h.needs_recalibration() == ["m"]
    h.clear("m")
    assert h.needs_recalibration() == []
    assert h.weight("m") == 1.0
    assert h.skew("m") == 1.0


def test_health_report_is_json_ready():
    h = FleetHealth()
    for _ in range(4):
        h.observe("b", observed_s=3.0, predicted_s=1.0)
        h.observe("a", observed_s=1.0, predicted_s=1.0)
    report = h.report()
    assert list(report) == ["a", "b"]       # deterministic order
    assert report["b"]["flagged"] is True
    assert report["a"]["weight"] == 1.0
    json.dumps(report)                      # must serialize


def test_health_validation():
    with pytest.raises(ValueError):
        FleetHealth(alpha=0.0)
    with pytest.raises(ValueError):
        FleetHealth(min_weight=0.0)
    with pytest.raises(ValueError):
        FleetHealth(demote_skew=2.0, recalibrate_skew=1.5)
    h = FleetHealth()
    with pytest.raises(ValueError):
        h.observe("m", observed_s=1.0, predicted_s=0.0)


# ---------------------------------------------------------------------------
# FleetRouter: construction, policies, ledger
# ---------------------------------------------------------------------------


def test_router_rejects_duplicate_machines():
    _fleet, profiles = _fleet_profiles(2)
    with pytest.raises(ValueError, match="same machine"):
        FleetRouter.from_profiles([profiles[0], profiles[0]])


def test_router_rejects_unknown_policy():
    with pytest.raises(ValueError, match="unknown routing policy"):
        _router(2, policy="coin_flip")
    r = _router(2)
    with pytest.raises(ValueError, match="unknown routing policy"):
        r.route(_item(), policy="coin_flip")


def test_round_robin_cycles_in_fleet_order():
    r = _router(3, policy="round_robin")
    placed = [r.route(_item()).machine for _ in range(6)]
    assert placed == r.machines * 2


def test_cheapest_picks_min_predicted_machine():
    r = _router(3, policy="cheapest")
    d = r.route(_item(4096))
    assert d.machine == min(d.predicted, key=d.predicted.get)
    assert d.predicted_s == d.predicted[d.machine]
    assert set(d.predicted) == set(r.machines)


def test_predicted_makespan_spreads_identical_jobs():
    # repeated identical jobs must spread: the ledger charges the chosen
    # machine, so the next copy sees its backlog and goes elsewhere
    r = _router(3)
    placed = [r.route(_item(4096)).machine for _ in range(12)]
    assert len(set(placed)) == 3
    out = r.outstanding()
    assert all(v > 0 for v in out.values())


def test_least_loaded_ignores_job_cost():
    r = _router(3, policy="least_loaded")
    first = r.route(_item(4096))
    second = r.route(_item(4096))
    assert second.machine != first.machine  # first now has backlog


def test_complete_drains_ledger_and_feeds_health():
    r = _router(2)
    d = r.route(_item(4096))
    assert r.outstanding()[d.machine] == pytest.approx(d.predicted_s)
    r.complete(d, observed_s=d.predicted_s * 3.0)
    assert r.outstanding()[d.machine] == 0.0
    assert r.health.skew(d.machine) == pytest.approx(3.0)
    # by-name completion needs the predicted cost
    with pytest.raises(ValueError, match="predicted_s"):
        r.complete(d.machine)
    with pytest.raises(KeyError):
        r.complete("nope", predicted_s=1.0)


def test_demoted_machine_loses_cheapest_routing():
    r = _router(3, policy="cheapest")
    best = r.route(_item(4096), dispatch=False).machine
    for _ in range(5):                      # best machine runs 100x slow
        r.health.observe(best, observed_s=100.0, predicted_s=1.0)
    d = r.route(_item(4096), dispatch=False)
    assert d.machine != best
    assert d.weights[best] < 1.0


def test_route_batch_one_eval_per_machine_zero_timings():
    r = _router(3)
    items = [_item(32 * (i + 1)) for i in range(8)]
    evals_before = {m: r.session(m).eval_calls for m in r.machines}
    decisions = r.route_batch(items)
    assert len(decisions) == 8
    for m in r.machines:
        assert r.session(m).eval_calls - evals_before[m] == 1
    assert r.timings() == 0
    assert [d.seq for d in decisions] == list(range(8))


def test_router_reset_restores_fresh_ledgers():
    r = _router(2)
    d = r.route(_item(4096))
    r.complete(d, observed_s=d.predicted_s * 50)
    r.reset(policy="cheapest")
    assert r.policy == "cheapest"
    assert all(v == 0.0 for v in r.outstanding().values())
    assert r.decisions == 0
    assert r.health.skew(d.machine) == 1.0


def test_router_stats_and_score():
    r = _router(2)
    prices = r.score(_item(4096))
    assert set(prices) == set(r.machines)
    assert all(p > 0 for p in prices.values())
    stats = r.stats()
    assert stats["timings"] == 0
    assert stats["decisions"] == 1          # score() = dispatch=False route
    json.dumps(stats)


def test_router_open_pools_profiles_and_shares_count_engine(tmp_path):
    from repro_torch.profiles.profile import save_profile

    fleet, profiles = _fleet_profiles(3)
    paths = []
    for dev, prof in zip(fleet, profiles):
        p = tmp_path / f"{dev.name}.json"
        save_profile(prof, p)
        paths.append(p)
    r = FleetRouter.open(paths, cache=tmp_path / "cache")
    try:
        assert len(r.machines) == 3
        engines = {id(r.session(m).engine) for m in r.machines}
        assert len(engines) == 1            # one count engine, shared
        r.route(_item(64), name="shared")
        # the shared engine counted the workload once for the whole fleet
        assert r.session(r.machines[0]).engine.trace_count == 1
        assert r.timings() == 0
    finally:
        r.close()


def test_router_replace_session_clears_health():
    from repro_torch.api import PerfSession

    fleet, profiles = _fleet_profiles(2)
    r = FleetRouter.from_profiles(profiles)
    m = r.machines[0]
    for _ in range(5):
        r.health.observe(m, observed_s=10.0, predicted_s=1.0)
    assert r.health.needs_recalibration() == [m]
    r.replace_session(m, PerfSession.open(profiles[0]))
    assert r.health.needs_recalibration() == []
    with pytest.raises(KeyError):
        r.replace_session("nope", PerfSession.open(profiles[0]))


def test_router_recalibrate_on_this_machine_needs_a_card(monkeypatch):
    """``recalibrate(machine, None)`` studies the local card: without one
    it raises (no quiet fallback to the host), and the slot keeps its
    session."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = _router(2)
    m = r.machines[0]
    before = r.session(m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        r.recalibrate(m, None, trials=1, cache=None)
    assert r.session(m) is before


def test_router_recalibrate_refuses_another_machine():
    from repro_torch.studies.zoo import STUDY_SMOKE_TAGS

    r = _router(2)
    with pytest.raises(ValueError, match="wrong hardware"):
        r.recalibrate(r.machines[0], fleet_device("bulk"),
                      tags=STUDY_SMOKE_TAGS, trials=1, cache=None)


# ---------------------------------------------------------------------------
# workload synthesis + synthetic fleet helpers
# ---------------------------------------------------------------------------


def test_heavy_tailed_jobs_deterministic_and_ordered():
    a = heavy_tailed_jobs(40, seed="t")
    b = heavy_tailed_jobs(40, seed="t")
    assert [(j.kernel.name, j.arrival_s) for j in a] \
        == [(j.kernel.name, j.arrival_s) for j in b]
    arrivals = [j.arrival_s for j in a]
    assert arrivals == sorted(arrivals)
    assert all(t > 0 for t in arrivals)
    # a different seed reshuffles the stream
    c = heavy_tailed_jobs(40, seed="u")
    assert [(j.kernel.name, j.arrival_s) for j in c] \
        != [(j.kernel.name, j.arrival_s) for j in a]


def test_heavy_tailed_jobs_n_machines_scales_pressure():
    # the default inter-arrival targets ~2x the aggregate capacity of
    # n_machines reference machines: a bigger fleet gets a denser stream
    # (same kernels, compressed arrivals), so queues still form
    one = heavy_tailed_jobs(30, seed="t")
    four = heavy_tailed_jobs(30, seed="t", n_machines=4)
    assert [j.kernel.name for j in four] == [j.kernel.name for j in one]
    assert four[-1].arrival_s == pytest.approx(one[-1].arrival_s / 4.0)
    with pytest.raises(ValueError):
        heavy_tailed_jobs(5, n_machines=0)


def test_heavy_tailed_jobs_mixes_cheap_and_expensive():
    jobs = heavy_tailed_jobs(60, seed="mix")
    ref = fleet_device("apex")
    costs = sorted(ref.true_time(j.kernel) for j in jobs)
    assert costs[-1] / costs[0] > 50        # genuinely heavy-tailed
    assert costs[len(costs) // 2] < sum(costs) / len(costs)  # skewed


def test_synthetic_fleet_extends_default_and_is_deterministic():
    f3 = synthetic_fleet(3)
    f5 = synthetic_fleet(5)
    assert [d.name for d in f3] == ["apex", "bulk", "citra"]
    assert [d.name for d in f5][:3] == [d.name for d in f3]
    assert [d.name for d in f5][3:] == ["gen3", "gen4"]
    again = synthetic_fleet(5)
    assert [d.p_true for d in again] == [d.p_true for d in f5]
    for d in f5:
        assert all(v > 0 for v in d.p_true.values())
    with pytest.raises(ValueError):
        synthetic_fleet(0)


def test_degraded_device_same_fingerprint_scaled_rates():
    d = fleet_device("apex")
    slow = d.degraded(4.0)
    assert slow.fingerprint == d.fingerprint     # same machine identity
    assert slow.p_true["p_madd"] == pytest.approx(4 * d.p_true["p_madd"])
    assert slow.p_true["p_edge"] == d.p_true["p_edge"]  # shape untouched
    with pytest.raises(ValueError):
        d.degraded(0.0)


def test_degraded_device_matches_the_reference():
    from repro.testing.synthdev import fleet_device as ref_fleet_device

    for name in ("apex", "bulk", "citra"):
        for factor in (0.5, 4.0):
            assert dict(fleet_device(name).degraded(factor).p_true) == \
                dict(ref_fleet_device(name).degraded(factor).p_true)


def test_exact_profile_predicts_truth_exactly():
    from repro_torch.api import PerfSession

    d = fleet_device("bulk")
    session = PerfSession.open(exact_profile(d))
    jobs = heavy_tailed_jobs(5, seed="x")
    for j in jobs:
        pred = session.predict(j.kernel)
        truth = d.true_time(j.kernel)
        assert pred.seconds == pytest.approx(truth, rel=1e-5)
    assert session.timer.calls == 0


# ---------------------------------------------------------------------------
# the scheduler simulation (the CI gate's claims, at test scale)
# ---------------------------------------------------------------------------


def _sim_setup(n: int = 4, n_jobs: int = 60):
    fleet, profiles = _fleet_profiles(n)
    devices = {d.fingerprint.id: d for d in fleet}
    jobs = heavy_tailed_jobs(n_jobs, seed="test-sim", n_machines=n)
    return profiles, devices, jobs


def test_predictive_routing_beats_round_robin():
    profiles, devices, jobs = _sim_setup()
    r = FleetRouter.from_profiles(profiles, policy="round_robin")
    rr = simulate_fleet(r, devices, jobs)
    r.reset(policy="predicted_makespan")
    pm = simulate_fleet(r, devices, jobs)
    assert pm.makespan_s < rr.makespan_s
    assert rr.routing_timings == 0 and pm.routing_timings == 0
    assert pm.decisions == len(jobs)
    assert sum(int(v["jobs"]) for v in pm.per_machine.values()) == len(jobs)


def test_simulation_is_bit_deterministic():
    profiles, devices, jobs = _sim_setup(3, 40)
    r = FleetRouter.from_profiles(profiles)
    first = simulate_fleet(r, devices, jobs)
    r.reset()
    second = simulate_fleet(r, devices, jobs)
    assert json.dumps(first.to_dict(), sort_keys=True) \
        == json.dumps(second.to_dict(), sort_keys=True)


def test_oracle_is_the_clairvoyant_reference():
    # the oracle is greedy with perfect information (true service times
    # and queue states) — not a makespan optimum; it must beat the
    # model-blind baseline and land in the predictive policy's regime
    profiles, devices, jobs = _sim_setup(3, 40)
    r = FleetRouter.from_profiles(profiles)
    pm = simulate_fleet(r, devices, jobs)
    r.reset(policy="round_robin")
    rr = simulate_fleet(r, devices, jobs)
    oracle = simulate_fleet(None, devices, jobs, oracle=True)
    assert oracle.policy == "oracle"
    assert oracle.makespan_s < rr.makespan_s
    assert abs(oracle.makespan_s - pm.makespan_s) \
        < 0.5 * (rr.makespan_s - min(oracle.makespan_s, pm.makespan_s))
    assert oracle.routing_timings == 0
    assert oracle.decisions == len(jobs)


def test_degraded_device_flags_demotes_and_recovers_makespan():
    profiles, devices, jobs = _sim_setup(4, 80)
    # find the machine predictive routing leans on hardest, degrade it
    probe = FleetRouter.from_profiles(profiles)
    busiest = max(sorted(simulate_fleet(probe, devices, jobs)
                         .per_machine.items()),
                  key=lambda kv: kv[1]["jobs"])[0]
    degradations = [Degradation(machine=busiest, factor=4.0)]

    control = FleetRouter.from_profiles(profiles,
                                        health=FleetHealth(min_weight=1.0))
    undemoted = simulate_fleet(control, devices, jobs,
                               degradations=degradations)
    health = FleetRouter.from_profiles(profiles)
    demoted = simulate_fleet(health, devices, jobs,
                             degradations=degradations)

    assert busiest in demoted.recalibration_flagged
    assert demoted.weights[busiest] < 1.0
    assert demoted.makespan_s <= undemoted.makespan_s
    assert demoted.routing_timings == 0


def test_recalibration_closes_the_loop():
    from repro_torch.api import PerfSession
    from repro_torch.studies.zoo import STUDY_SMOKE_TAGS

    profiles, devices, jobs = _sim_setup(3, 60)
    probe = FleetRouter.from_profiles(profiles)
    busiest = max(sorted(simulate_fleet(probe, devices, jobs)
                         .per_machine.items()),
                  key=lambda kv: kv[1]["jobs"])[0]

    def recalibrate(machine: str):
        # fresh study against the degraded truth, no stale cache
        return PerfSession.open(devices[machine].degraded(4.0),
                                cache=None, tags=STUDY_SMOKE_TAGS,
                                trials=2)

    r = FleetRouter.from_profiles(profiles)
    report = simulate_fleet(
        r, devices, jobs,
        degradations=[Degradation(machine=busiest, factor=4.0)],
        recalibrate_fn=recalibrate)
    assert report.recalibrated == [busiest]
    # the fresh profile describes the degraded machine: flag cleared and
    # post-swap skew settles back toward 1
    assert busiest not in report.recalibration_flagged
    assert report.health.get(busiest, {}).get("skew", 1.0) < 2.0


# ---------------------------------------------------------------------------
# the fleet CLI's gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["simulate", "--synthetic", "4", "--jobs", "120",
     "--expect-zero-timings"],
    ["health", "--synthetic", "4", "--degrade-factor", "4",
     "--recalibrate"],
])
def test_fleet_cli_gates_pass_on_the_host(argv, capsys):
    from repro_torch.fleet.cli import main

    assert main(argv) == 0
    out = capsys.readouterr().out
    assert ("fleet sim OK" if argv[0] == "simulate"
            else "fleet health OK") in out


def test_fleet_cli_route_prices_every_machine(tmp_path, capsys):
    from repro_torch.fleet.cli import main
    from repro_torch.profiles.profile import save_profile

    fleet, profiles = _fleet_profiles(3)
    paths = []
    for dev, prof in zip(fleet, profiles):
        paths.append(str(tmp_path / f"{dev.name}.json"))
        save_profile(prof, paths[-1])
    assert main(["route", *paths, "--kernel", "kernels.ops.dg_diff",
                 "--repeat", "6"]) == 0
    out = capsys.readouterr().out
    assert "fleet of 3 machine(s)" in out and "<- routed" in out
    assert "6 copies spread" in out
    assert "routing timings: 0" in out
    assert main(["route", *paths, "--kernel", "nope"]) == 2


# ---------------------------------------------------------------------------
# daemon fleet endpoints
# ---------------------------------------------------------------------------


def _tiny_targets(n: int = 4) -> Dict:
    out = {}
    for i in range(n):
        size = 32 * (i + 1)
        out[f"t{i}"] = ((lambda x: x + 1.0), (_ones(size),))
    return out


@pytest.fixture
def fleet_daemon():
    from repro_torch.api import PerfSession
    from repro_torch.serving import PredictionDaemon

    _fleet, profiles = _fleet_profiles(2)
    d = PredictionDaemon(PerfSession.open(profiles[0]), port=0,
                         targets=_tiny_targets(),
                         router=FleetRouter.from_profiles(profiles)).start()
    yield d
    d.close()


def _post(url: str, body: dict):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60.0) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_daemon_route_complete_fleet_endpoints(fleet_daemon):
    d = fleet_daemon
    status, body = _post(f"{d.url}/route", {"kernel": "t1"})
    assert status == 200
    assert body["machine"] in d.router.machines
    assert set(body["predicted"]) == set(d.router.machines)
    assert body["predicted_s"] > 0

    status, done = _post(f"{d.url}/complete",
                         {"machine": body["machine"],
                          "predicted_s": body["predicted_s"],
                          "observed_s": body["predicted_s"]})
    assert status == 200 and done["ok"] is True
    assert all(v == 0.0 for v in done["outstanding"].values())

    with urllib.request.urlopen(f"{d.url}/fleet", timeout=30.0) as resp:
        fleet = json.loads(resp.read())
    assert fleet["timings"] == 0
    assert fleet["decisions"] == 1
    assert set(fleet["machines"]) == set(d.router.machines)

    stats = d.stats()
    assert stats["fleet"]["decisions"] == 1


def test_daemon_route_error_codes(fleet_daemon):
    d = fleet_daemon
    assert _post(f"{d.url}/route", {"kernel": "nope"})[0] == 404
    assert _post(f"{d.url}/route", {})[0] == 400
    assert _post(f"{d.url}/route",
                 {"kernel": "t0", "policy": "coin_flip"})[0] == 400
    assert _post(f"{d.url}/complete",
                 {"machine": "nope", "predicted_s": 1.0})[0] == 404
    assert _post(f"{d.url}/complete", {"machine": "x"})[0] == 400


def test_daemon_without_router_returns_503():
    from repro_torch.api import PerfSession
    from repro_torch.serving import PredictionDaemon

    _fleet, profiles = _fleet_profiles(1)
    d = PredictionDaemon(PerfSession.open(profiles[0]), port=0,
                         targets=_tiny_targets()).start()
    try:
        assert _post(f"{d.url}/route", {"kernel": "t0"})[0] == 503
        assert _post(f"{d.url}/complete",
                     {"machine": "m", "predicted_s": 1.0})[0] == 503
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{d.url}/fleet", timeout=30.0)
        assert err.value.code == 503
        assert "fleet" not in d.stats()
    finally:
        d.close()


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


@pytest.fixture
def reference_x64():
    """The reference evaluates in float64 for the parity cases."""
    import jax

    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _reference_scenario(n: int, n_jobs: int, seed: str):
    from repro.fleet import heavy_tailed_jobs as ref_jobs
    from repro.testing.synthdev import exact_profile as ref_exact
    from repro.testing.synthdev import synthetic_fleet as ref_fleet

    fleet = ref_fleet(n)
    return ([ref_exact(d) for d in fleet],
            {d.fingerprint.id: d for d in fleet},
            ref_jobs(n_jobs, seed=seed, n_machines=n))


def test_job_stream_parity_with_reference(reference_x64):
    _p, _d, ref = _reference_scenario(4, 120, "fleet-sim")
    port = heavy_tailed_jobs(120, n_machines=4)
    assert [j.kernel.name for j in port] == [j.kernel.name for j in ref]
    assert [j.index for j in port] == [j.index for j in ref]
    np.testing.assert_allclose([j.arrival_s for j in port],
                               [j.arrival_s for j in ref],
                               rtol=ARRIVAL_RTOL, atol=0)


def test_simulation_parity_with_reference(reference_x64):
    """``synthetic_fleet(4)`` under ``heavy_tailed_jobs(120)``: the same
    per-machine job counts under round-robin, predicted-makespan and the
    oracle, makespans to rtol 1e-9, and zero routing timings."""
    from repro.fleet import FleetRouter as RefRouter
    from repro.fleet import simulate_fleet as ref_simulate

    ref_profiles, ref_devices, ref_jobs = _reference_scenario(
        4, 120, "fleet-sim")
    fleet = synthetic_fleet(4)
    profiles = [exact_profile(d) for d in fleet]
    devices = {d.fingerprint.id: d for d in fleet}
    jobs = heavy_tailed_jobs(120, n_machines=4)
    assert sorted(devices) == sorted(ref_devices)

    def run(router_cls, sim, profs, devs, js):
        out = {}
        r = router_cls.from_profiles(profs, policy="round_robin")
        out["round_robin"] = sim(r, devs, js)
        r.reset(policy="predicted_makespan")
        out["predicted_makespan"] = sim(r, devs, js)
        out["oracle"] = sim(None, devs, js, oracle=True)
        return out

    port = run(FleetRouter, simulate_fleet, profiles, devices, jobs)
    ref = run(RefRouter, ref_simulate, ref_profiles, ref_devices, ref_jobs)
    for policy in ("round_robin", "predicted_makespan", "oracle"):
        p, r = port[policy], ref[policy]
        assert p.policy == r.policy == policy
        assert {m: v["jobs"] for m, v in p.per_machine.items()} == \
            {m: v["jobs"] for m, v in r.per_machine.items()}, policy
        assert p.makespan_s == pytest.approx(r.makespan_s,
                                             rel=MAKESPAN_RTOL)
        assert p.routing_timings == r.routing_timings == 0
        assert p.decisions == r.decisions == 120
    assert port["predicted_makespan"].makespan_s < \
        port["round_robin"].makespan_s


def test_health_scenario_parity_with_reference(reference_x64, tmp_path,
                                              capsys):
    """``fleet health --synthetic 4 --degrade-factor 4`` flags the same
    machine in both packages, with the same per-machine job counts and
    makespans in both arms."""
    from repro.fleet.cli import main as ref_main
    from repro_torch.fleet.cli import main

    reports = {}
    for pkg, fn in (("ref", ref_main), ("port", main)):
        out = tmp_path / f"{pkg}.json"
        assert fn(["health", "--synthetic", "4", "--degrade-factor", "4",
                   "--json", str(out)]) == 0, pkg
        reports[pkg] = json.loads(out.read_text())
    capsys.readouterr()
    for arm in ("control", "health"):
        p, r = reports["port"][arm], reports["ref"][arm]
        assert p["recalibration_flagged"] == r["recalibration_flagged"]
        assert {m: v["jobs"] for m, v in p["per_machine"].items()} == \
            {m: v["jobs"] for m, v in r["per_machine"].items()}, arm
        assert p["makespan_s"] == pytest.approx(r["makespan_s"],
                                                rel=MAKESPAN_RTOL)
        assert p["weights"] == pytest.approx(r["weights"],
                                             rel=MAKESPAN_RTOL)
    flagged = reports["port"]["health"]["recalibration_flagged"]
    assert len(flagged) == 1 and flagged[0].startswith("synth_")


def test_fleet_bench_rows_and_zero_timings():
    """The fleet bench: routing times nothing, predicted-makespan beats
    round-robin, and the reference's five rows come out."""
    from repro_torch.studies import fleet_bench

    res = fleet_bench.fleet_bench()
    assert res["route_timings"] == 0 and res["sim_timings"] == 0
    ms = res["makespan_s"]
    assert ms["predicted_makespan"] < ms["round_robin"]
    assert ms["oracle"] < ms["round_robin"]
    assert all(sum(jobs.values()) == fleet_bench.N_JOBS
               for jobs in res["per_machine_jobs"].values())
    assert [r.split(",")[0] for r in fleet_bench.rows(res)] == [
        "fleet.route_us_per_decision", "fleet.route_timings",
        "fleet.makespan_round_robin_us", "fleet.makespan_predicted_us",
        "fleet.makespan_oracle_us"]
