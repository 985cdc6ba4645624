"""Synthetic ground-truth devices: fake machines with KNOWN ``p_*``
vectors — the counterpart of ``repro.testing.synthdev``.

A :class:`SyntheticDevice` has a designated *truth* model (a zoo rung)
and a known parameter vector; its injectable timer (the
``gather_feature_table`` seam) returns ``truth(features(kernel),
p_true)`` plus seeded multiplicative noise.  A whole study — gather,
multi-fit, profile save, compare — then runs on the CPU in seconds, and
tests assert that calibration recovers the ground truth.

The noise draw is a hash of (device name, kernel name, trials) through
the port's :func:`~repro_torch.core.uipick.unit_hash`, the reference's
definition — so for equal counts a synthetic device gives the port the
timings it gives the reference, up to the reference's float32
evaluation of the truth model (the port evaluates in float64).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Tuple

import torch

from repro_torch.core.model import DTYPE, Model
from repro_torch.core.uipick import MeasurementKernel, TimingStats, unit_hash
from repro_torch.profiles.fingerprint import DeviceFingerprint
from repro_torch.profiles.presets import DEFAULT_OUTPUT_FEATURE
from repro_torch.studies.zoo import OVL_FLOP_MEM, ZooEntry


def _unit_hash(*parts: object) -> float:
    """Deterministic uniform draw in [-1, 1) from the given identity
    (the calibration subsystem's shared :func:`unit_hash`, recentered)."""
    return unit_hash(*parts) * 2.0 - 1.0


@dataclass(frozen=True)
class SyntheticDevice:
    """A fake machine whose timing law is a known model + known parameters.

    ``noise`` is the relative (multiplicative) wall-clock noise scale: a
    timing for kernel ``k`` is ``t_true · (1 + noise · u(k))`` with ``u``
    a deterministic per-kernel draw in [-1, 1).
    """

    name: str
    truth: ZooEntry = OVL_FLOP_MEM
    p_true: Mapping[str, float] = field(default_factory=dict)
    noise: float = 0.0
    output_feature: str = DEFAULT_OUTPUT_FEATURE

    def __post_init__(self):
        model = self.truth.model(self.output_feature)
        missing = [p for p in model.param_names if p not in self.p_true]
        if missing:
            raise ValueError(
                f"synthetic device {self.name!r}: truth model "
                f"{self.truth.name!r} needs values for {missing}")
        if not 0.0 <= self.noise < 0.5:
            raise ValueError(f"noise must be in [0, 0.5), got {self.noise}")

    @property
    def fingerprint(self) -> DeviceFingerprint:
        """Identity of this fake machine; the truth model and noise level
        are part of it (the reference's identity, so profiles match)."""
        kind = f"SynthDev {self.name} {self.truth.name}"
        if self.noise:
            kind += f" noise{self.noise:g}"
        return DeviceFingerprint(platform="synth", device_kind=kind,
                                 n_devices=1)

    def truth_model(self) -> Model:
        return self.truth.model(self.output_feature)

    def true_time(self, kernel: MeasurementKernel) -> float:
        """Noise-free ground-truth wall time for ``kernel``."""
        model = self.truth_model()
        p_vec = torch.as_tensor([self.p_true[n] for n in model.param_names],
                                dtype=DTYPE)
        F = torch.as_tensor(model.align(kernel.counts()), dtype=DTYPE)
        t = float(model.batched_eval(p_vec, F)[0])
        if not t > 0.0:
            raise ValueError(
                f"synthetic device {self.name!r} produced nonpositive time "
                f"{t!r} for kernel {kernel.name!r}; choose p_true so every "
                f"kernel has positive cost (p_launch > 0 suffices)")
        return t

    def timer(self, kernel: MeasurementKernel, trials: int) -> TimingStats:
        """Injectable timer: ground truth + seeded relative noise.

        Usable directly as ``gather_feature_table(..., timer=device.timer)``.
        """
        t = self.true_time(kernel)
        u = _unit_hash(self.name, kernel.name, trials)
        median = t * (1.0 + self.noise * u)
        return TimingStats(median=median, std=self.noise * t,
                           min=t * (1.0 - self.noise))

    def degraded(self, factor: float) -> "SyntheticDevice":
        """The same machine running ``factor``× slower than when it was
        calibrated (thermal throttling, a sick memory stack): every rate
        parameter scales by ``factor``, while the shape parameter
        ``p_edge`` and the fingerprint stay put.  The unchanged
        fingerprint is the point: the fleet health layer exists because
        identity checks cannot see a machine whose behaviour drifted.  A
        measurement cache warmed before the degradation must therefore
        not serve a recalibration after it (pass ``cache=None``)."""
        if not factor > 0.0:
            raise ValueError(f"degradation factor must be positive, "
                             f"got {factor}")
        shape_params = {"p_edge"}
        scaled = {p: (v if p in shape_params else v * factor)
                  for p, v in self.p_true.items()}
        return dataclasses.replace(self, p_true=scaled)


# ---------------------------------------------------------------------------
# The default fleet: three machines spanning the balance regimes
# ---------------------------------------------------------------------------

# per-device true rates: (p_madd, p_mem, p_launch); p_edge is the shared
# overlap sharpness.  The three machines span distinct rate balances, and
# every rate is chosen to DOMINATE some battery rows on every device
# (madd on large matmuls, mem on large streams, launch on empty kernels)
# — the identifiability condition that makes closed-loop parameter
# recovery a fair assertion even for the max-like overlap truth, where a
# never-dominant term is unrecoverable by construction.
_FLEET_RATES: Dict[str, Tuple[float, float, float]] = {
    "apex": (5.0e-11, 4.0e-10, 3.0e-6),
    "bulk": (1.0e-11, 6.0e-10, 8.0e-6),
    "citra": (2.0e-11, 1.5e-10, 1.0e-6),
}
_P_EDGE_TRUE = 40.0


def fleet_device(name: str, *, truth: ZooEntry = OVL_FLOP_MEM,
                 noise: float = 0.0,
                 output_feature: str = DEFAULT_OUTPUT_FEATURE
                 ) -> SyntheticDevice:
    """One named device of the default fleet, with any truth model form."""
    if name not in _FLEET_RATES:
        raise KeyError(f"unknown synthetic device {name!r}; "
                       f"available: {sorted(_FLEET_RATES)}")
    p_madd, p_mem, p_launch = _FLEET_RATES[name]
    full = {"p_madd": p_madd, "p_mem": p_mem, "p_launch": p_launch,
            "p_edge": _P_EDGE_TRUE}
    params = {p: full[p]
              for p in truth.model(output_feature).param_names if p in full}
    return SyntheticDevice(name=name, truth=truth, p_true=params,
                           noise=noise, output_feature=output_feature)


def default_fleet(*, truth: ZooEntry = OVL_FLOP_MEM, noise: float = 0.0,
                  output_feature: str = DEFAULT_OUTPUT_FEATURE
                  ) -> List[SyntheticDevice]:
    """The three-machine synthetic fleet used by tests, CI, and examples."""
    return [fleet_device(n, truth=truth, noise=noise,
                         output_feature=output_feature)
            for n in sorted(_FLEET_RATES)]


def synthetic_fleet(n: int, *, truth: ZooEntry = OVL_FLOP_MEM,
                    noise: float = 0.0,
                    output_feature: str = DEFAULT_OUTPUT_FEATURE
                    ) -> List[SyntheticDevice]:
    """A heterogeneous fleet of ``n`` devices for routing scenarios.

    The first three are the named :func:`default_fleet` machines; beyond
    that, generated machines (``gen3``, ``gen4``, …) take the ``apex``
    rates scaled per-parameter by deterministic factors in [1/4, 4) —
    hash-of-identity draws, so fleet ``n`` is always byte-identical and
    fleet ``n+1`` extends fleet ``n`` without renaming anyone.  The
    spread keeps every fleet genuinely heterogeneous: no two machines
    share a rate balance, which is what makes routing decisions
    non-trivial."""
    if n < 1:
        raise ValueError(f"a fleet needs at least one device, got {n}")
    fleet = default_fleet(truth=truth, noise=noise,
                          output_feature=output_feature)[:n]
    base = _FLEET_RATES["apex"]
    for i in range(len(fleet), n):
        name = f"gen{i}"
        rates = {
            p: base[j] * 4.0 ** _unit_hash("synthetic-fleet", name, p)
            for j, p in enumerate(("p_madd", "p_mem", "p_launch"))
        }
        rates["p_edge"] = _P_EDGE_TRUE
        params = {p: rates[p]
                  for p in truth.model(output_feature).param_names
                  if p in rates}
        fleet.append(SyntheticDevice(name=name, truth=truth, p_true=params,
                                     noise=noise,
                                     output_feature=output_feature))
    return fleet


def exact_profile(device: SyntheticDevice) -> "MachineProfile":
    """A :class:`~repro_torch.profiles.MachineProfile` whose fit for the
    device's truth model IS ``p_true`` (residual exactly zero) — the
    profile a perfect calibration run would produce, minus the run.
    Routing tests and benchmarks use this to study placement quality in
    isolation from calibration quality (and to skip the study's cost)."""
    from repro_torch.core.calibrate import FitResult
    from repro_torch.profiles.profile import MachineProfile, ModelFit

    model = device.truth_model()
    fit = FitResult(params=dict(device.p_true), residual_norm=0.0,
                    iterations=1, converged=True)
    return MachineProfile(
        fingerprint=device.fingerprint,
        fits={device.truth.name: ModelFit.from_fit(model, fit)},
        trials=1)
