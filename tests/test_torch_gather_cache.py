"""One-pass gather semantics, the measurement cache and its CLI in the
port — the cases of the reference's ``tests/test_gather_cache.py`` and
the ``gc`` cases of ``tests/test_studies_cli.py``, plus the port's cache
key (torch and CUDA versions, timing method) and the warm ``calibrate``
runs: zero timings, zero counting passes, a byte-identical profile."""
import contextlib
import io
import json
import os
import re
import time

import numpy as np
import pytest
import torch

from repro.profiles.cache import MeasurementCache as JMeasurementCache
from repro_torch.core.uipick import (
    TIMING_METHODS,
    CountingTimer,
    MeasurementKernel,
    TimingStats,
    gather_feature_table,
)
from repro_torch.profiles import DeviceFingerprint, MeasurementCache
from repro_torch.profiles.cache import CACHE_SCHEMA_VERSION
from repro_torch.profiles.cli import main as calibrate_main
from repro_torch.profiles.profile import atomic_write_json

FP = DeviceFingerprint(platform="cpu", device_kind="Test CPU", n_devices=1)
OTHER_FP = DeviceFingerprint(platform="cpu", device_kind="Other CPU",
                             n_devices=2)


def _tiny_kernels(n=3):
    kernels = []
    for i in range(n):
        size = 8 * (i + 1)

        def make_args(device, s=size):
            return (torch.ones((s,), dtype=torch.float32, device=device),)

        kernels.append(MeasurementKernel(
            name=f"tiny_{size}", fn=lambda x: x * 2.0 + 1.0,
            make_args=make_args, tags={"n": size}, sizes={"n": size}))
    return kernels


def _fake_timer():
    return CountingTimer(lambda k, trials: 0.125)


FEATURES = ["f_wall_time_cpu_host", "f_op_float32_mul", "f_op_float32_add"]


def test_multiple_wall_time_columns_time_each_kernel_once():
    kernels = _tiny_kernels(3)
    timer = _fake_timer()
    features = ["f_wall_time_a", "f_wall_time_b", "f_wall_time_c",
                "f_op_float32_mul"]
    table = gather_feature_table(features, kernels, trials=4, timer=timer)
    assert timer.calls == len(kernels)
    vals = table.values
    np.testing.assert_array_equal(vals[:, 0], vals[:, 1])
    np.testing.assert_array_equal(vals[:, 0], vals[:, 2])
    assert list(vals[:, 3]) == [8.0, 16.0, 24.0]


def test_counts_only_gather_never_times():
    timer = _fake_timer()
    gather_feature_table(["f_op_float32_mul"], _tiny_kernels(2), timer=timer)
    assert timer.calls == 0


def test_warm_cache_performs_zero_timings(tmp_path):
    cache = MeasurementCache(tmp_path, FP)
    cold = _fake_timer()
    t1 = gather_feature_table(FEATURES, _tiny_kernels(3), trials=4,
                              timer=cold, cache=cache)
    assert cold.calls == 3 and cache.misses == 3 and cache.hits == 0

    warm_cache = MeasurementCache(tmp_path, FP)
    warm = _fake_timer()
    t2 = gather_feature_table(FEATURES, _tiny_kernels(3), trials=4,
                              timer=warm, cache=warm_cache)
    assert warm.calls == 0 and warm_cache.hits == 3
    np.testing.assert_array_equal(t1.values, t2.values)
    assert t1.feature_ids == t2.feature_ids


def test_warm_cache_never_counts(tmp_path, monkeypatch):
    """A cache hit runs neither the timer nor the counter."""
    gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                         timer=_fake_timer(),
                         cache=MeasurementCache(tmp_path, FP))

    def no_counting(self):
        raise AssertionError("a warm gather counted a kernel")

    monkeypatch.setattr(MeasurementKernel, "counts", no_counting)
    gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                         timer=_fake_timer(),
                         cache=MeasurementCache(tmp_path, FP))


def test_cache_incremental_only_new_kernels_timed(tmp_path):
    gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                         timer=_fake_timer(),
                         cache=MeasurementCache(tmp_path, FP))
    timer = _fake_timer()
    gather_feature_table(FEATURES, _tiny_kernels(4), trials=4, timer=timer,
                         cache=MeasurementCache(tmp_path, FP))
    assert timer.calls == 2


@pytest.mark.parametrize("change", ["trials", "fingerprint", "torch",
                                    "timing"])
def test_cache_invalidates_on_a_key_change(tmp_path, monkeypatch, change):
    """Another trials count or device misses (the reference's key), and so
    does another torch build or timing method (the port's): an eager or
    other-torch timing is never served as a CUDA-graph timing."""
    gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                         timer=_fake_timer(),
                         cache=MeasurementCache(tmp_path, FP))
    trials, fp = 4, FP
    if change == "trials":
        trials = 8
    elif change == "fingerprint":
        fp = OTHER_FP
    elif change == "torch":
        monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    else:
        monkeypatch.setitem(TIMING_METHODS, "cpu", "other-timer")
    timer = _fake_timer()
    gather_feature_table(FEATURES, _tiny_kernels(2), trials=trials,
                         timer=timer, cache=MeasurementCache(tmp_path, fp))
    assert timer.calls == 2


def test_key_carries_versions_and_timing_method_and_reference_shape(tmp_path):
    """The entry is the reference's JSON shape; the port's key is the
    reference's plus torch, CUDA and the timing method (one CUDA-graph
    replay between CUDA events on the card)."""
    cache = MeasurementCache(tmp_path, FP)
    gather_feature_table(FEATURES, _tiny_kernels(1), trials=4,
                         timer=CountingTimer(lambda k, t: TimingStats(
                             0.125, 0.01, 0.11)), cache=cache)
    (entry,) = tmp_path.glob("*.json")
    payload = json.loads(entry.read_text())
    assert set(payload) == {"key", "wall_time", "counts", "noise"}
    ref_key = JMeasurementCache(tmp_path, FP)._key_payload(
        "tiny_8", {"n": 8}, 4, "")
    assert set(payload["key"]) == set(ref_key) | {"torch", "cuda",
                                                  "timing"}
    assert payload["key"]["torch"] == torch.__version__
    assert payload["key"]["cuda"] == torch.version.cuda
    assert payload["key"]["timing"] == TIMING_METHODS["cpu"]
    gpu = MeasurementCache(tmp_path, DeviceFingerprint("gpu", "H100", 1))
    assert gpu._key_payload("k", {}, 3)["timing"] \
        == "cuda-graph-replay-between-cuda-events"
    synth = MeasurementCache(tmp_path, DeviceFingerprint("synth", "apex", 1))
    assert synth._key_payload("k", {}, 3)["timing"] == "injected-timer"


def test_corrupt_cache_entry_is_a_miss_and_heals(tmp_path):
    gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                         timer=_fake_timer(),
                         cache=MeasurementCache(tmp_path, FP))
    sorted(tmp_path.glob("*.json"))[0].write_text("{ torn write")
    timer = _fake_timer()
    gather_feature_table(FEATURES, _tiny_kernels(2), trials=4, timer=timer,
                         cache=MeasurementCache(tmp_path, FP))
    assert timer.calls == 1
    timer2 = _fake_timer()
    gather_feature_table(FEATURES, _tiny_kernels(2), trials=4, timer=timer2,
                         cache=MeasurementCache(tmp_path, FP))
    assert timer2.calls == 0


@pytest.mark.parametrize("junk", ["null", "[]", "42",
                                  '{"key": {}, "counts": "nope"}'])
def test_valid_json_but_wrong_shape_entry_is_a_miss(tmp_path, junk):
    gather_feature_table(FEATURES, _tiny_kernels(1), trials=4,
                         timer=_fake_timer(),
                         cache=MeasurementCache(tmp_path, FP))
    (entry,) = tmp_path.glob("*.json")
    entry.write_text(junk)
    timer = _fake_timer()
    gather_feature_table(FEATURES, _tiny_kernels(1), trials=4, timer=timer,
                         cache=MeasurementCache(tmp_path, FP))
    assert timer.calls == 1


def test_counts_only_entry_backfills_wall_time(tmp_path):
    gather_feature_table(["f_op_float32_mul"], _tiny_kernels(2),
                         timer=_fake_timer(),
                         cache=MeasurementCache(tmp_path, FP))
    timer = _fake_timer()
    gather_feature_table(FEATURES, _tiny_kernels(2), trials=20, timer=timer,
                         cache=MeasurementCache(tmp_path, FP))
    assert timer.calls == 2
    timer2 = _fake_timer()
    gather_feature_table(FEATURES, _tiny_kernels(2), trials=20, timer=timer2,
                         cache=MeasurementCache(tmp_path, FP))
    assert timer2.calls == 0


# ---------------------------------------------------------------------------
# wall-time noise metadata
# ---------------------------------------------------------------------------


def _stats_timer():
    return CountingTimer(
        lambda k, trials: TimingStats(median=0.125, std=0.01, min=0.11))


def test_noise_metadata_lands_in_table_and_cache(tmp_path):
    table = gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                                 timer=_stats_timer(),
                                 cache=MeasurementCache(tmp_path, FP))
    assert set(table.row_noise) == set(table.row_names)
    for d in table.row_noise.values():
        assert d == {"median": 0.125, "std": 0.01, "min": 0.11}
    warm = _stats_timer()
    table2 = gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                                  timer=warm,
                                  cache=MeasurementCache(tmp_path, FP))
    assert warm.calls == 0
    assert table2.row_noise == table.row_noise


def test_float_returning_timers_still_work_without_noise():
    table = gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                                 timer=_fake_timer())
    assert table.row_noise == {}
    assert list(table.values[:, 0]) == [0.125, 0.125]


def test_entry_without_noise_still_reads_as_hit(tmp_path):
    gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                         timer=_stats_timer(),
                         cache=MeasurementCache(tmp_path, FP))
    for path in tmp_path.glob("*.json"):
        payload = json.loads(path.read_text())
        payload.pop("noise")
        path.write_text(json.dumps(payload))
    timer = _stats_timer()
    table = gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                                 timer=timer,
                                 cache=MeasurementCache(tmp_path, FP))
    assert timer.calls == 0
    assert table.row_noise == {}
    assert list(table.values[:, 0]) == [0.125, 0.125]


def test_malformed_noise_metadata_never_blocks_a_hit(tmp_path):
    gather_feature_table(FEATURES, _tiny_kernels(1), trials=4,
                         timer=_stats_timer(),
                         cache=MeasurementCache(tmp_path, FP))
    (entry,) = tmp_path.glob("*.json")
    payload = json.loads(entry.read_text())
    payload["noise"] = {"median": "not-a-number"}
    entry.write_text(json.dumps(payload))
    timer = _stats_timer()
    gather_feature_table(FEATURES, _tiny_kernels(1), trials=4, timer=timer,
                         cache=MeasurementCache(tmp_path, FP))
    assert timer.calls == 0


def test_time_stats_reports_spread():
    (k,) = _tiny_kernels(1)
    stats = k.time_stats(trials=5, warmup=1, device="cpu")
    assert stats.median > 0
    assert stats.std is not None and stats.std >= 0
    assert stats.min is not None and 0 < stats.min <= stats.median


def test_timing_stats_coerce():
    s = TimingStats.coerce(0.5)
    assert s == TimingStats(median=0.5)
    assert TimingStats.coerce(s) is s
    assert s.to_dict() == {"median": 0.5}
    full = TimingStats(median=1.0, std=0.1, min=0.9)
    assert full.to_dict() == {"median": 1.0, "std": 0.1, "min": 0.9}


# ---------------------------------------------------------------------------
# kernel-code signatures in cache keys
# ---------------------------------------------------------------------------


def _sig_kernels(n, code_sig):
    kernels = _tiny_kernels(n)
    for k in kernels:
        k.code_sig = code_sig
    return kernels


def test_code_signature_change_invalidates_cache_entries(tmp_path):
    gather_feature_table(FEATURES, _sig_kernels(2, "sig_v1"), trials=4,
                         timer=_fake_timer(),
                         cache=MeasurementCache(tmp_path, FP))
    same = _fake_timer()
    gather_feature_table(FEATURES, _sig_kernels(2, "sig_v1"), trials=4,
                         timer=same, cache=MeasurementCache(tmp_path, FP))
    assert same.calls == 0
    edited = _fake_timer()
    gather_feature_table(FEATURES, _sig_kernels(2, "sig_v2"), trials=4,
                         timer=edited, cache=MeasurementCache(tmp_path, FP))
    assert edited.calls == 2


def test_old_format_entry_without_code_key_reads_as_miss(tmp_path):
    cache = MeasurementCache(tmp_path, FP)
    (k,) = _tiny_kernels(1)
    old_key = {kk: v for kk, v in
               cache._key_payload(k.name, k.sizes, 4, k.code_sig).items()
               if kk != "code"}
    atomic_write_json(cache._path(old_key), {
        "key": old_key, "wall_time": 0.5,
        "counts": {"f_op_float32_mul": 8.0, "f_op_float32_add": 8.0}})
    timer = _fake_timer()
    table = gather_feature_table(FEATURES, [k], trials=4, timer=timer,
                                 cache=cache)
    assert timer.calls == 1
    assert table.values[0, 0] == 0.125


def test_generators_compute_and_propagate_code_signatures():
    from repro_torch.core.uipick import MATMUL_SQ, source_signature

    assert MATMUL_SQ.code_sig
    kernels = list(MATMUL_SQ.variants(
        {"n": (256,), "dtype": ("float32",), "prefetch": (False,),
         "tile": (16,)}))
    assert kernels and all(k.code_sig == MATMUL_SQ.code_sig
                           for k in kernels)

    def f1(x):
        return x + 1

    def f2(x):
        return x + 2

    assert source_signature(f1) != source_signature(f2)
    ns = {}
    exec("def no_source(x):\n    return x", ns)
    assert source_signature(ns["no_source"]) == ""
    assert source_signature(f1) == source_signature(f1)


# ---------------------------------------------------------------------------
# noisy-row re-measurement (retime_rel_std)
# ---------------------------------------------------------------------------


def _flaky_then_steady_timer():
    """First pass per kernel: 40% rel std; later passes: 0.8%."""
    seen = {}

    def timer(k, trials):
        n = seen.get(k.name, 0)
        seen[k.name] = n + 1
        std = 0.05 if n == 0 else 0.001
        return TimingStats(median=0.125, std=std, min=0.11)

    return CountingTimer(timer)


def test_retime_heuristic_retimes_noisy_rows_and_keeps_steadier():
    timer = _flaky_then_steady_timer()
    table = gather_feature_table(FEATURES, _tiny_kernels(3), trials=4,
                                 timer=timer, retime_rel_std=0.1)
    assert timer.calls == 6
    assert sorted(table.retimed_rows) == sorted(table.row_names)
    for d in table.row_noise.values():
        assert d["std"] == 0.001


def test_retime_ignores_timers_without_spread_metadata():
    timer = _fake_timer()
    table = gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                                 timer=timer, retime_rel_std=0.1)
    assert timer.calls == 2
    assert table.retimed_rows == []


def test_retime_below_threshold_is_a_noop():
    timer = _flaky_then_steady_timer()
    table = gather_feature_table(FEATURES, _tiny_kernels(3), trials=4,
                                 timer=timer, retime_rel_std=0.5)
    assert timer.calls == 3
    assert table.retimed_rows == []


def test_retime_keeps_original_when_fresh_pass_is_noisier():
    timer = CountingTimer(
        lambda k, t: TimingStats(median=0.125, std=0.05, min=0.11))
    table = gather_feature_table(FEATURES, _tiny_kernels(1), trials=4,
                                 timer=timer, retime_rel_std=0.1)
    assert timer.calls == 2
    assert table.retimed_rows == ["tiny_8"]
    assert table.values[0, 0] == 0.125


def test_retime_applies_to_cached_rows_and_updates_cache(tmp_path):
    noisy = CountingTimer(
        lambda k, t: TimingStats(median=0.2, std=0.08, min=0.1))
    gather_feature_table(FEATURES, _tiny_kernels(2), trials=4, timer=noisy,
                         cache=MeasurementCache(tmp_path, FP))
    steady = CountingTimer(
        lambda k, t: TimingStats(median=0.125, std=0.001, min=0.124))
    table = gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                                 timer=steady,
                                 cache=MeasurementCache(tmp_path, FP),
                                 retime_rel_std=0.1)
    assert steady.calls == 2
    assert list(table.values[:, 0]) == [0.125, 0.125]
    after = CountingTimer(
        lambda k, t: TimingStats(median=0.3, std=0.09, min=0.2))
    table2 = gather_feature_table(FEATURES, _tiny_kernels(2), trials=4,
                                  timer=after,
                                  cache=MeasurementCache(tmp_path, FP),
                                  retime_rel_std=0.1)
    assert after.calls == 0
    assert table2.retimed_rows == []
    assert list(table2.values[:, 0]) == [0.125, 0.125]


def test_retime_on_the_host_times_a_noisy_row_again():
    """The default timer on the host, a threshold every row exceeds: each
    row gets exactly one extra real timing pass."""
    from repro_torch.core.uipick import default_timer
    calls = []

    def timer(k, trials):
        calls.append(k.name)
        return default_timer(k, trials, device="cpu")

    table = gather_feature_table(FEATURES, _tiny_kernels(2), trials=3,
                                 timer=timer, retime_rel_std=-1.0)
    assert sorted(calls) == sorted(2 * table.row_names)
    assert sorted(table.retimed_rows) == sorted(table.row_names)


# ---------------------------------------------------------------------------
# cache eviction (gc)
# ---------------------------------------------------------------------------


def _populate(tmp_path, fp, n=2):
    cache = MeasurementCache(tmp_path, fp)
    gather_feature_table(["f_wall_time_x", "f_op_float32_mul"],
                         _tiny_kernels(n), trials=4,
                         timer=CountingTimer(lambda k, t: 0.125),
                         cache=cache)
    return cache


def test_gc_drops_foreign_keeps_own_and_warm_gather_unchanged(tmp_path):
    _populate(tmp_path, FP, n=3)
    _populate(tmp_path, OTHER_FP, n=2)
    stats = MeasurementCache(tmp_path, FP).gc()
    assert stats.kept == 3 and stats.dropped_foreign == 2
    assert stats.dropped == 2
    timer = CountingTimer(lambda k, t: 0.125)
    gather_feature_table(["f_wall_time_x", "f_op_float32_mul"],
                         _tiny_kernels(3), trials=4, timer=timer,
                         cache=MeasurementCache(tmp_path, FP))
    assert timer.calls == 0


def test_gc_max_age_drops_old_entries(tmp_path):
    _populate(tmp_path, FP, n=2)
    victim = sorted(tmp_path.glob("*.json"))[0]
    old = time.time() - 3600
    os.utime(victim, (old, old))
    stats = MeasurementCache(tmp_path, FP).gc(max_age=600)
    assert stats.dropped_old == 1 and stats.kept == 1


def test_gc_drops_corrupt_entries_but_never_foreign_files(tmp_path):
    _populate(tmp_path, FP, n=2)
    sorted(tmp_path.glob("*.json"))[0].write_text("{ torn")
    stray = tmp_path / "machine_profile.json"
    stray.write_text('{"valid": "json"}')
    stats = MeasurementCache(tmp_path, FP).gc()
    assert stats.dropped_corrupt == 1 and stats.kept == 1
    assert stray.exists()


def test_gc_drops_stale_schema_entries(tmp_path):
    _populate(tmp_path, FP, n=2)
    victim = sorted(tmp_path.glob("*.json"))[0]
    payload = json.loads(victim.read_text())
    payload["key"]["schema"] = CACHE_SCHEMA_VERSION - 1
    victim.write_text(json.dumps(payload))
    stats = MeasurementCache(tmp_path, FP).gc()
    assert stats.dropped_schema == 1 and stats.kept == 1
    assert stats.dropped == 1


def test_gc_on_missing_dir_is_a_noop(tmp_path):
    stats = MeasurementCache(tmp_path / "nope", FP).gc()
    assert stats.kept == 0 and stats.dropped == 0


def test_gc_cli(tmp_path):
    local = DeviceFingerprint.local("cpu")
    _populate(tmp_path, local, n=2)
    _populate(tmp_path, OTHER_FP, n=1)
    assert calibrate_main(["gc", "--cache-dir", str(tmp_path),
                           "--device", "cpu", "--counts"]) == 0
    assert len(MeasurementCache(tmp_path, local)) == 2


# ---------------------------------------------------------------------------
# CLI: cold run measures and writes the profile; the warm run performs no
# timing and no counting pass and writes the same bytes
# ---------------------------------------------------------------------------


CLI_ARGS = ["--tags", "empty_kernel", "nelements:16,1024",
            "--match", "intersect",
            "--expr", "p_launch * f_sync_launch_kernel",
            "--trials", "2", "--device", "cpu"]


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = calibrate_main(argv)
    text = out.getvalue()
    counters = {k: int(v) for k, v in re.findall(
        r"(timings_performed|cache_hits|count_traces)=(\d+)", text)}
    return rc, counters


def test_cli_cold_then_warm_zero_timings_identical_profile(tmp_path):
    cache_dir = str(tmp_path / "cache")
    p1, p2 = tmp_path / "prof1.json", tmp_path / "prof2.json"
    rc, cold = _run(CLI_ARGS + ["--cache-dir", cache_dir, "--out", str(p1)])
    assert rc == 0 and cold["timings_performed"] == 2
    rc, warm = _run(CLI_ARGS + ["--cache-dir", cache_dir, "--out", str(p2),
                                "--expect-zero-timings"])
    assert rc == 0
    assert warm == {"timings_performed": 0, "cache_hits": 2,
                    "count_traces": 0}
    assert p1.read_bytes() == p2.read_bytes()


def test_cli_expect_zero_timings_fails_on_cold_cache(tmp_path):
    rc, _ = _run(CLI_ARGS + ["--cache-dir", str(tmp_path / "c"),
                             "--out", str(tmp_path / "p.json"),
                             "--expect-zero-timings"])
    assert rc == 1


def test_cli_no_matching_kernels_is_an_error(tmp_path):
    assert calibrate_main(["--tags", "no_such_generator",
                           "--match", "identical", "--device", "cpu",
                           "--out", str(tmp_path / "p.json")]) == 2


@pytest.mark.parametrize("argv", [
    ["--smoke", "--device", "cpu"],
    ["--smoke", "--zoo", "--synthetic", "apex"],
], ids=["smoke-host", "zoo-synthetic-apex"])
def test_cli_warm_calibration_counts_and_times_nothing(tmp_path, argv):
    """``calibrate --cache-dir`` cold, then warm with
    ``--expect-zero-timings``: the warm run times nothing, counts nothing
    (every row and every count comes from the cache) and writes the cold
    run's profile byte for byte."""
    cache_dir = str(tmp_path / "cache")
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    rc, cold = _run(argv + ["--trials", "2", "--cache-dir", cache_dir,
                            "--out", str(a)])
    assert rc == 0 and cold["timings_performed"] > 0
    assert cold["count_traces"] > 0
    rc, warm = _run(argv + ["--trials", "2", "--cache-dir", cache_dir,
                            "--out", str(b), "--expect-zero-timings"])
    assert rc == 0
    assert warm["timings_performed"] == 0 and warm["count_traces"] == 0
    assert warm["cache_hits"] == cold["timings_performed"]
    assert a.read_bytes() == b.read_bytes()


def test_cli_retime_rel_std_prints_the_retimed_rows(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = calibrate_main(["--smoke", "--zoo", "--synthetic", "apex",
                             "--synthetic-noise", "0.2", "--trials", "2",
                             "--retime-rel-std", "0.05",
                             "--out", str(tmp_path / "p.json")])
    assert rc == 0
    (line,) = [ln for ln in out.getvalue().splitlines()
               if "retimed=" in ln]
    assert re.search(r"retimed=(\d+) rows above rel-std 0.05", line)
    assert int(re.search(r"retimed=(\d+)", line)[1]) > 0


def test_session_open_calibrates_through_the_cache(tmp_path):
    """``PerfSession.open(device, cache=...)`` twice: the second study is
    served whole by the cache — its ``calibration`` counters read 0
    timings and 0 counting passes — and fits the same models."""
    from repro_torch.api import PerfSession
    from repro_torch.studies import STUDY_SMOKE_TAGS
    from repro_torch.testing.synthdev import fleet_device

    device = fleet_device("apex", noise=0.05)
    cold = PerfSession.open(device, cache=tmp_path, tags=STUDY_SMOKE_TAGS,
                            trials=2, retime_rel_std=0.5)
    warm = PerfSession.open(device, cache=tmp_path, tags=STUDY_SMOKE_TAGS,
                            trials=2, retime_rel_std=0.5)
    n = len(cold.profile.kernel_names)
    assert cold.calibration["timings"] == n
    assert cold.calibration["count_traces"] > 0
    assert warm.calibration == {
        "source": cold.calibration["source"], "timings": 0,
        "cache_hits": n, "count_traces": 0, "retimed": 0}
    assert warm.profile.to_dict() == cold.profile.to_dict()
    assert warm.engine.store == tmp_path / "countengine"
