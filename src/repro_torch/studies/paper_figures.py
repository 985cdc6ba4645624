"""The paper's own evaluation — §2 Figs 1–2, §7.4 Fig 5, the §8.3–8.5
matmul, DG and stencil variants (Figs 7–9) and Table 3 — on the card;
the counterpart of the reference's ``benchmarks/paper_figures.py`` and
``benchmarks/common.py``.

Each figure function returns the reference's CSV rows
``name,us_per_call,derived``: ``derived`` carries the model's prediction
(µs) or a derived statistic, and the figures the reference summarizes end
with its ``gmre_percent`` and ``top1_rank_correct`` rows.  The filter
tags, model expressions and ``nonneg`` choices are the reference's.
Every kernel is timed through ``timer(kernel, trials)`` — the
:func:`~repro_torch.core.uipick.gather_feature_table` seam; by default
one CUDA-graph replay per trial on ``device`` — and predicted from its
counts alone.  Figs 7–9 and Table 3 read the ``base`` fit of a machine
profile (the reference's ``REPRO_PROFILE``) and do not recalibrate.

CLI (rows on stdout)::

    python -m repro_torch.studies.paper_figures fig7 fig9 --profile h100.json
    python -m repro_torch.studies.paper_figures fig9 --device cpu --trials 1

Without ``--profile``, or with a path that does not exist yet, the CLI
first calibrates the base battery on ``--device`` (and saves the profile
to that path when one is given), as the reference's
``calibrated_base_model`` does.
"""
from __future__ import annotations

import argparse
import functools
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.calibrate import (
    FitResult,
    fit_model,
    geometric_mean_relative_error,
)
from repro_torch.core.model import DTYPE, FeatureTable, Model
from repro_torch.core.uipick import (
    ALL_GENERATORS,
    KernelCollection,
    MatchCondition,
    MeasurementKernel,
    TimerResult,
    TimingStats,
    default_timer,
    gather_feature_table,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.profiles.fingerprint import DeviceFingerprint
from repro_torch.profiles.presets import (
    BASE_MODEL_EXPR,
    CALIBRATION_TAGS,
    DEFAULT_OUTPUT_FEATURE,
)
from repro_torch.profiles.profile import (
    MachineProfile,
    ModelFit,
    load_profile,
    save_profile,
)

Timer = Callable[[MeasurementKernel, int], TimerResult]

COLLECTION = KernelCollection(ALL_GENERATORS)

# §2: one madd parameter plus launch overhead
MADD_MODEL_EXPR = ("p_madd * f_op_float32_madd "
                   "+ p_launch * f_sync_launch_kernel")
FIG1_CAL_TAGS = ["matmul_sq", "dtype:float32", "prefetch:False", "tile:16",
                 "n:256,384,640,1024"]
FIG12_TEST_TAGS = ["matmul_sq", "dtype:float32", "prefetch:False",
                   "tile:16", "n:512,768"]
FIG2_CAL_TAGS = ["flops_madd_pattern", "dtype:float32",
                 "nelements:65536", "iters:64,128,256,512"]
# §7.4: global traffic overlapped with on-chip rounds
FIG5_MODEL_EXPR = (
    "overlap2(p_g * (f_mem_contig_float32_load + f_op_float32_add), "
    "p_c * (f_op_float32_mul + f_op_float32_add), p_edge) "
    "+ p_launch * f_sync_launch_kernel")
FIG5_TAGS = ["overlap_pattern", "dtype:float32", "nelements:16777216",
             "m:0,16,256,1024,4096,16384,65536"]
# §8.3–8.5: variants priced by the base fit
FIG7_TAGS = ["matmul_sq", "dtype:float32", "tile:64", "n:512,768"]
FIG8_TAGS = ["dg_diff", "dtype:float32", "nelements_dg:16384,65536"]
FIG9_TAGS = ["finite_diff", "dtype:float32", "n_grid:2048,4096"]


def kernels(tags: Sequence[str]) -> List[MeasurementKernel]:
    """The measurement kernels ``tags`` select (SUPERSET match, as the
    reference's figures select them)."""
    return COLLECTION.generate_kernels(list(tags))


def seconds(kernel: MeasurementKernel, trials: int, timer: Timer) -> float:
    """Median seconds of one call of ``kernel`` through ``timer``."""
    return TimingStats.coerce(timer(kernel, trials)).median


def predict(model: Model, params: Dict[str, float],
            kerns: Sequence[MeasurementKernel]) -> List[float]:
    """Predicted seconds of each kernel from its counts alone, in one
    batched evaluation: nothing runs and nothing is timed."""
    F = torch.as_tensor(model.align([k.counts() for k in kerns]),
                        dtype=DTYPE)
    p = torch.as_tensor([params[n] for n in model.param_names], dtype=DTYPE)
    return [float(v) for v in model.batched_eval(p, F)]


def calibrate(model: Model, kerns: Sequence[MeasurementKernel], *,
              trials: int, timer: Timer, nonneg: bool
              ) -> Tuple[FeatureTable, FitResult]:
    """Time ``kerns``, count them and fit ``model`` to the table."""
    table = gather_feature_table(model.all_features(), kerns,
                                 trials=trials, timer=timer)
    return table, fit_model(model, table, nonneg=nonneg)


def _timer(device: DeviceLike, timer: Optional[Timer]) -> Timer:
    return timer or functools.partial(default_timer,
                                      device=resolve_device(device))


def evaluate_kernels(model: Model, params: Dict[str, float],
                     kerns: Sequence[MeasurementKernel], prefix: str, *,
                     trials: int, timer: Timer) -> List[str]:
    """Predict, then measure, each kernel; one row each plus the gmre and
    whether the model picked the fastest variant."""
    preds = predict(model, params, kerns)
    meas = [seconds(k, trials, timer) for k in kerns]
    rows = [f"{prefix}.{k.name},{t * 1e6:.2f},{p * 1e6:.2f}"
            for k, t, p in zip(kerns, meas, preds)]
    gmre = geometric_mean_relative_error(preds, meas)
    rows.append(f"{prefix}.gmre_percent,{gmre * 100:.2f},")
    top_pred = min(range(len(kerns)), key=lambda i: preds[i])
    top_meas = min(range(len(kerns)), key=lambda i: meas[i])
    rows.append(f"{prefix}.top1_rank_correct,{int(top_pred == top_meas)},")
    return rows


def _base(profile: MachineProfile) -> Tuple[Model, FitResult]:
    mf = profile.get_fit("base")
    return mf.model(), mf.fit


# ---------------------------------------------------------------------------
# the figures
# ---------------------------------------------------------------------------


def fig1_matmul_simple(*, device: DeviceLike = "cuda", trials: int = 8,
                       timer: Optional[Timer] = None) -> List[str]:
    """§2 Fig 1: a one-parameter madd model calibrated on the same matmul
    variant at other sizes — maximal accuracy, minimal scope."""
    timer = _timer(device, timer)
    model = Model(DEFAULT_OUTPUT_FEATURE, MADD_MODEL_EXPR)
    _, fit = calibrate(model, kernels(FIG1_CAL_TAGS), trials=trials,
                       timer=timer, nonneg=True)
    return evaluate_kernels(model, fit.params, kernels(FIG12_TEST_TAGS),
                            "fig1", trials=trials, timer=timer)


def fig2_madd_component(*, device: DeviceLike = "cuda", trials: int = 8,
                        timer: Optional[Timer] = None) -> List[str]:
    """§2 Fig 2: ``p_madd`` calibrated on peak-FLOP microbenchmarks
    instead; ``derived`` is the madd share of each matmul's time."""
    timer = _timer(device, timer)
    model = Model(DEFAULT_OUTPUT_FEATURE, MADD_MODEL_EXPR)
    _, fit = calibrate(model, kernels(FIG2_CAL_TAGS), trials=trials,
                       timer=timer, nonneg=True)
    test = kernels(FIG12_TEST_TAGS)
    preds = predict(model, fit.params, test)
    rows = []
    for k, p in zip(test, preds):
        t = seconds(k, trials, timer)
        rows.append(f"fig2.{k.name},{t * 1e6:.2f},{p / t:.3f}")
    rows.append("fig2.note_derived_is_madd_fraction,0,")
    return rows


def fig5_overlap(*, device: DeviceLike = "cuda", trials: int = 8,
                 timer: Optional[Timer] = None) -> List[str]:
    """§7.4 Fig 5: vary the on-chip/global ratio m and fit the nonlinear
    overlapped model t ≈ overlap2(c_gmem, c_onchip)."""
    timer = _timer(device, timer)
    model = Model(DEFAULT_OUTPUT_FEATURE, FIG5_MODEL_EXPR)
    kerns = kernels(FIG5_TAGS)
    table, fit = calibrate(model, kerns, trials=trials, timer=timer,
                           nonneg=False)
    preds = predict(model, fit.params, kerns)
    meas = list(table.column(DEFAULT_OUTPUT_FEATURE))
    rows = [f"fig5.m{k.tags['m']},{t * 1e6:.2f},{p * 1e6:.2f}"
            for k, t, p in zip(kerns, meas, preds)]
    gmre = geometric_mean_relative_error(preds, meas)
    rows.append(f"fig5.gmre_percent,{gmre * 100:.2f},")
    rows.append(f"fig5.p_edge,{fit.params.get('p_edge', 0):.3e},")
    return rows


def fig7_matmul_variants(profile: MachineProfile, *,
                         device: DeviceLike = "cuda", trials: int = 8,
                         timer: Optional[Timer] = None) -> List[str]:
    """§8.3: staged-tile and plain matmul variants priced by the base fit,
    which calibrated on none of them."""
    model, fit = _base(profile)
    return evaluate_kernels(model, fit.params, kernels(FIG7_TAGS), "fig7",
                            trials=trials, timer=_timer(device, timer))


def fig8_dg_variants(profile: MachineProfile, *, device: DeviceLike = "cuda",
                     trials: int = 8, timer: Optional[Timer] = None
                     ) -> List[str]:
    """§8.4: four DG differentiation variants at two sizes."""
    model, fit = _base(profile)
    return evaluate_kernels(model, fit.params, kernels(FIG8_TAGS), "fig8",
                            trials=trials, timer=_timer(device, timer))


def fig9_stencil_variants(profile: MachineProfile, *,
                          device: DeviceLike = "cuda", trials: int = 8,
                          timer: Optional[Timer] = None) -> List[str]:
    """§8.5: two five-point stencil variants (roll vs slice)."""
    model, fit = _base(profile)
    return evaluate_kernels(model, fit.params, kernels(FIG9_TAGS), "fig9",
                            trials=trials, timer=_timer(device, timer))


def table3_parameters(profile: MachineProfile) -> List[str]:
    """Table 3: the base fit's per-feature costs (µs) and implied rates
    (per second), with the fit's residual and convergence."""
    _, fit = _base(profile)
    rows = []
    for name, val in sorted(fit.params.items()):
        rate = (1.0 / val) if val > 0 else float("inf")
        rows.append(f"table3.{name},{val * 1e6:.6g},{rate:.4g}")
    rows.append(f"table3.residual_norm,{fit.residual_norm:.4g},")
    rows.append(f"table3.converged,{int(fit.converged)},")
    return rows


FIGURES: Dict[str, Callable[..., List[str]]] = {
    "fig1": fig1_matmul_simple,
    "fig2": fig2_madd_component,
    "fig5": fig5_overlap,
    "fig7": fig7_matmul_variants,
    "fig8": fig8_dg_variants,
    "fig9": fig9_stencil_variants,
    "table3": table3_parameters,
}
#: the figures that read the base profile (Table 3 times nothing)
PROFILE_FIGURES = ("fig7", "fig8", "fig9", "table3")


def run_figure(name: str, profile: Optional[MachineProfile] = None, *,
               device: DeviceLike = "cuda", trials: int = 8,
               timer: Optional[Timer] = None) -> List[str]:
    """The rows of figure ``name``; Figs 7–9 and Table 3 read
    ``profile``'s base fit."""
    fn = FIGURES[name]
    if name == "table3":
        return fn(profile)
    if name in PROFILE_FIGURES:
        return fn(profile, device=device, trials=trials, timer=timer)
    return fn(device=device, trials=trials, timer=timer)


def calibrate_base(*, device: DeviceLike = "cuda", trials: int = 8,
                   timer: Optional[Timer] = None) -> MachineProfile:
    """The base battery (``CALIBRATION_TAGS``, INTERSECT) fitted with the
    base model on ``device``: the profile Figs 7–9 and Table 3 read."""
    model = Model(DEFAULT_OUTPUT_FEATURE, BASE_MODEL_EXPR)
    kerns = COLLECTION.generate_kernels(
        CALIBRATION_TAGS, generator_match_cond=MatchCondition.INTERSECT)
    _, fit = calibrate(model, kerns, trials=trials,
                       timer=_timer(device, timer), nonneg=True)
    return MachineProfile(fingerprint=DeviceFingerprint.local(device),
                          fits={"base": ModelFit.from_fit(model, fit)},
                          trials=trials,
                          kernel_names=[k.name for k in kerns])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.studies.paper_figures",
        description="Run the paper's figures on this machine and print "
                    "their CSV rows (name,us_per_call,derived).")
    ap.add_argument("figures", nargs="*", default=list(FIGURES),
                    choices=list(FIGURES), metavar="FIGURE",
                    help=f"figures to run (default all: {list(FIGURES)})")
    ap.add_argument("--device", default="cuda",
                    help="device to time on (default cuda; 'cpu' times "
                         "the host)")
    ap.add_argument("--trials", type=int, default=8,
                    help="timing trials per kernel")
    ap.add_argument("--profile", default=None,
                    help="machine profile whose 'base' fit Figs 7-9 and "
                         "Table 3 read; calibrated first (and saved here) "
                         "when the file does not exist")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    profile = None
    if any(f in PROFILE_FIGURES for f in args.figures):
        if args.profile and Path(args.profile).exists():
            profile = load_profile(
                args.profile,
                expected_fingerprint=DeviceFingerprint.local(device))
        else:
            profile = calibrate_base(device=device, trials=args.trials)
            if args.profile:
                save_profile(profile, args.profile)
    print("name,us_per_call,derived")
    for name in args.figures:
        for row in run_figure(name, profile, device=device,
                              trials=args.trials):
            print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
