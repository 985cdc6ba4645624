"""Operation-overlap modeling (paper §7.4) in torch — the counterpart of
``repro.core.overlap``, with the same formulas and the same guards.

``smooth_step`` is the paper's differentiable step
ŝ(x) = (tanh(p_edge · x) + 1) / 2; ``overlap2``/``overlap3``/
``smoothmax`` express fully overlapped costs (see the reference module
for the derivations, including why the step argument is normalized by
the total cost).
"""
from __future__ import annotations

import torch


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) \
        else torch.as_tensor(x, dtype=torch.float64)


def smooth_step(x, p_edge):
    """ŝ(x) = (tanh(p_edge·x)+1)/2 — differentiable step (paper eq. 6)."""
    return (torch.tanh(_t(p_edge * x)) + 1.0) / 2.0


def overlap2(c_a, c_b, p_edge):
    """Fully-overlapped two-component cost with the step argument
    normalized by the total cost (homogeneous of degree 1)."""
    # the guard must survive squaring in autodiff (see the reference):
    # all-zero rows would otherwise give NaN Jacobians
    tot = torch.abs(_t(c_a)) + torch.abs(_t(c_b)) + 1e-15
    return c_a * smooth_step((c_a - c_b) / tot, p_edge) \
        + c_b * smooth_step((c_b - c_a) / tot, p_edge)


def overlap2_raw(c_a, c_b, p_edge):
    """Paper eq. (5) verbatim (unnormalized step argument)."""
    return c_a * smooth_step(c_a - c_b, p_edge) \
        + c_b * smooth_step(c_b - c_a, p_edge)


def overlap3(c_a, c_b, c_c, p_edge):
    """Pairwise generalization: each term gated on being the max."""
    tot = torch.abs(_t(c_a)) + torch.abs(_t(c_b)) + torch.abs(_t(c_c)) \
        + 1e-15
    sa = smooth_step((c_a - c_b) / tot, p_edge) * \
        smooth_step((c_a - c_c) / tot, p_edge)
    sb = smooth_step((c_b - c_a) / tot, p_edge) * \
        smooth_step((c_b - c_c) / tot, p_edge)
    sc = smooth_step((c_c - c_a) / tot, p_edge) * \
        smooth_step((c_c - c_b) / tot, p_edge)
    return c_a * sa + c_b * sb + c_c * sc


def smoothmax(cs, p_edge):
    """Scale-normalized log-sum-exp smooth maximum (→ max as p_edge → ∞)."""
    cs = torch.stack(torch.broadcast_tensors(*[_t(c) for c in cs]))
    m = torch.amax(cs, dim=0)
    return m + torch.log(torch.sum(torch.exp(p_edge * (cs - m)),
                                   dim=0)) / p_edge


def partial_overlap2(c_a, c_b, p_edge, alpha):
    """Partial overlap: the smaller cost is hidden by fraction alpha."""
    full = overlap2(c_a, c_b, p_edge)
    return alpha * full + (1.0 - alpha) * (c_a + c_b)
