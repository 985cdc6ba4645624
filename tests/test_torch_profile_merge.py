"""Profile merge and fleet bundles in the port — the merge cases of the
reference's ``tests/test_studies_cli.py`` (``merge_profiles``,
``merge_any``, fleet bundles, the ``merge`` and ``compare`` CLI), each
also held against the reference: the same profiles merge to the same
JSON in both packages."""
import json

import numpy as np
import pytest

from repro.profiles import MachineProfile as JMachineProfile
from repro.profiles import merge_profiles as jmerge_profiles
from repro.studies import fleet_to_dict as jfleet_to_dict
from repro.studies import load_profiles_any as jload_profiles_any
from repro_torch.core.model import FeatureTable
from repro_torch.profiles import (
    MachineProfile,
    ProfileError,
    load_profile,
    merge_profiles,
    save_profile,
)
from repro_torch.profiles.cli import main as cli_main
from repro_torch.profiles.profile import atomic_write_json
from repro_torch.studies import (
    LIN_FLOP,
    LIN_FLOP_MEM,
    STUDY_SMOKE_TAGS,
    fleet_to_dict,
    load_profiles_any,
    merge_any,
    run_study,
)
from repro_torch.testing.synthdev import fleet_device

NOISE = 0.02


def _study_profile(name, **kw):
    device = fleet_device(name, noise=NOISE)
    return device, run_study(fingerprint=device.fingerprint,
                             timer=device.timer, tags=STUDY_SMOKE_TAGS,
                             trials=3, **kw)


def _two_rungs():
    device = fleet_device("apex", noise=NOISE)
    a = run_study(fingerprint=device.fingerprint, timer=device.timer,
                  tags=STUDY_SMOKE_TAGS, trials=3, entries=[LIN_FLOP])
    b = run_study(fingerprint=device.fingerprint, timer=device.timer,
                  tags=STUDY_SMOKE_TAGS, trials=3, entries=[LIN_FLOP_MEM])
    return device, a, b


def _as_reference(profile):
    return JMachineProfile.from_dict(
        json.loads(json.dumps(profile.to_dict())))


# ---------------------------------------------------------------------------
# merge semantics (API)
# ---------------------------------------------------------------------------


def test_merge_same_machine_unions_fits():
    device, a, b = _two_rungs()
    merged = merge_profiles([a, b])
    assert sorted(merged.fits) == ["lin_flop", "lin_flop_mem"]
    assert merged.fits["lin_flop"].params == a.fits["lin_flop"].params
    assert merged.fingerprint == device.fingerprint
    assert merged.holdout is not None
    # the reference merges the same two profiles to the same document
    assert merged.to_dict() == jmerge_profiles(
        [_as_reference(a), _as_reference(b)]).to_dict()


def test_merge_identical_fits_are_not_conflicts():
    _, p = _study_profile("citra")
    merged = merge_profiles([p, p])
    assert sorted(merged.fits) == sorted(p.fits)
    assert merged.to_dict() == jmerge_profiles(
        [_as_reference(p), _as_reference(p)]).to_dict()


def test_merge_conflicting_fit_payload_raises():
    device = fleet_device("apex", noise=NOISE)
    a = run_study(fingerprint=device.fingerprint, timer=device.timer,
                  tags=STUDY_SMOKE_TAGS, trials=3)
    b = run_study(fingerprint=device.fingerprint, timer=device.timer,
                  tags=STUDY_SMOKE_TAGS, trials=4)   # new noise draws
    assert a.fits["lin_flop"].params != b.fits["lin_flop"].params
    with pytest.raises(ProfileError, match="conflicting fit"):
        merge_profiles([a, b])


def test_merge_needs_two_same_machine_profiles():
    _, a = _study_profile("apex")
    _, b = _study_profile("bulk")
    with pytest.raises(ProfileError, match="at least 2"):
        merge_profiles([a])
    with pytest.raises(ProfileError, match="different machines"):
        merge_profiles([a, b])


def test_merge_cross_machine_requires_fleet():
    _, a = _study_profile("apex")
    _, b = _study_profile("bulk")
    with pytest.raises(ProfileError, match="different machines"):
        merge_any([a, b])
    merged = merge_any([a, b], allow_cross_machine=True)
    assert len(merged) == 2


def test_merge_unions_holdout_columns_and_rejects_conflicts():
    device, a, b = _two_rungs()
    merged = merge_profiles([a, b])
    assert merged.holdout.row_names == a.holdout.row_names
    assert set(merged.holdout.feature_ids) \
        == set(a.holdout.feature_ids) | set(b.holdout.feature_ids)

    c = MachineProfile(
        fingerprint=device.fingerprint, fits=dict(b.fits),
        holdout=FeatureTable(list(b.holdout.feature_ids),
                             b.holdout.values[:1], ["other_kernel"]))
    with pytest.raises(ProfileError, match="held-out splits"):
        merge_profiles([a, c])

    tampered_vals = np.array(a.holdout.values)
    tampered_vals[0, 0] *= 2.0
    d = MachineProfile(
        fingerprint=device.fingerprint, fits={},
        holdout=FeatureTable(list(a.holdout.feature_ids), tampered_vals,
                             list(a.holdout.row_names)))
    with pytest.raises(ProfileError, match="held-out measurements"):
        merge_profiles([a, d])


def test_fleet_bundle_roundtrip(tmp_path):
    _, a = _study_profile("apex")
    _, b = _study_profile("bulk")
    path = tmp_path / "fleet.json"
    atomic_write_json(path, fleet_to_dict([a, b]))
    loaded = load_profiles_any(path)
    assert sorted(p.fingerprint.id for p in loaded) \
        == sorted([a.fingerprint.id, b.fingerprint.id])
    for orig in (a, b):
        (match,) = [p for p in loaded
                    if p.fingerprint == orig.fingerprint]
        for name in orig.fits:
            assert match.fits[name].params == orig.fits[name].params
    save_profile(a, tmp_path / "one.json")
    (single,) = load_profiles_any(tmp_path / "one.json")
    assert single.fingerprint == a.fingerprint
    # the bundle is the reference's format, both ways
    assert fleet_to_dict([a, b]) == jfleet_to_dict(
        [_as_reference(a), _as_reference(b)])
    assert len(jload_profiles_any(path)) == 2


@pytest.mark.parametrize("payload,match", [
    ("{ torn", "not valid JSON"),
    ('{"profiles": {}, "fleet_schema_version": 99}', "schema version"),
    ('{"profiles": {"x": {"schema_version": 1}}, '
     '"fleet_schema_version": 1}', "malformed fleet bundle"),
])
def test_load_profiles_any_rejects_bad_bundles(tmp_path, payload, match):
    from repro_torch.studies import StudyError
    path = tmp_path / "bad.json"
    path.write_text(payload)
    with pytest.raises(StudyError, match=match):
        load_profiles_any(path)


# ---------------------------------------------------------------------------
# CLI flows
# ---------------------------------------------------------------------------


def _zoo_args(dev, out, cache_dir, extra=()):
    return ["--smoke", "--zoo", "--synthetic", dev,
            "--synthetic-noise", str(NOISE), "--trials", "2",
            "--cache-dir", str(cache_dir), "--out", str(out), *extra]


def test_cli_two_device_study_compare_merge_happy_path(tmp_path):
    cache = tmp_path / "mc"
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    assert cli_main(_zoo_args("apex", a, cache)) == 0
    assert cli_main(_zoo_args("bulk", b, cache)) == 0
    report_json = tmp_path / "report.json"
    assert cli_main(["compare", str(a), str(b),
                     "--report", str(tmp_path / "report.md"),
                     "--json", str(report_json)]) == 0
    payload = json.loads(report_json.read_text())
    assert len(payload["machines"]) == 2

    fleet = tmp_path / "fleet.json"
    assert cli_main(["merge", str(a), str(b), "--fleet",
                     "--out", str(fleet)]) == 0
    assert len(load_profiles_any(fleet)) == 2
    # comparing straight from the bundle gives the same report
    report2 = tmp_path / "r2.json"
    assert cli_main(["compare", str(fleet),
                     "--report", str(tmp_path / "r2.md"),
                     "--json", str(report2)]) == 0
    assert json.loads(report2.read_text()) == payload


def test_cli_warm_zoo_study_zero_timings_byte_identical(tmp_path):
    cache = tmp_path / "mc"
    a, a2 = tmp_path / "a.json", tmp_path / "a2.json"
    assert cli_main(_zoo_args("citra", a, cache)) == 0
    assert cli_main(_zoo_args("citra", a2, cache,
                              ["--expect-zero-timings"])) == 0
    assert a.read_text() == a2.read_text()


def test_cli_merge_mismatched_fingerprints_exits_nonzero(tmp_path):
    cache = tmp_path / "mc"
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    assert cli_main(_zoo_args("apex", a, cache)) == 0
    assert cli_main(_zoo_args("bulk", b, cache)) == 0
    assert cli_main(["merge", str(a), str(b),
                     "--out", str(tmp_path / "nope.json")]) == 3
    assert not (tmp_path / "nope.json").exists()
    assert cli_main(["merge", str(a),
                     "--out", str(tmp_path / "one.json")]) == 3
    assert cli_main(["compare", str(a), str(a),
                     "--report", str(tmp_path / "r.md")]) == 3


def test_cli_merge_same_machine_profile(tmp_path):
    _, a, b = _two_rungs()
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    save_profile(a, pa)
    save_profile(b, pb)
    out = tmp_path / "merged.json"
    assert cli_main(["merge", str(pa), str(pb), "--out", str(out)]) == 0
    assert sorted(load_profile(out).fits) == ["lin_flop", "lin_flop_mem"]
