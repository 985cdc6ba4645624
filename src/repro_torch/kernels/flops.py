"""FLOP formulas of the model-layer kernels' custom ops for
``torch.utils.flop_counter.FlopCounterMode``, which otherwise counts them
as zero (the dry-run's ``cost.flops``).  Each is 2 × the multiply-adds
the op's algorithm does on its operands' shapes:

* attention: the full score rectangle, Sq·Skv·(D + Dv) a query head
  (the mask is not discounted); its backward recomputes the scores and
  forms dP, dQ, dK, dV: Sq·Skv·(3·D + 2·Dv);
* SSD, a chunk of L tokens a (batch, head): L·L·(N + P)/2 for the masked
  quadratic form and 2·L·P·N for the state terms; the backward twice;
* sLSTM: 4·dh·dh a (batch, step, head) for the recurrent gates; the
  backward twice.

Importing the module registers them.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import flash_attention, mamba2_ssd, slstm_cell  # noqa: F401 (define the ops)

_ops = torch.ops.repro_torch


def _attention(q_shape, k_shape, v_shape, backward: bool = False) -> int:
    b, sq, hq, d = q_shape
    skv, dv = k_shape[1], v_shape[3]
    return 2 * b * hq * sq * skv * ((3 * d + 2 * dv) if backward
                                    else (d + dv))


@register_flop_formula(_ops.flash_attention)
def _flash_attention_flop(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    return _attention(q_shape, k_shape, v_shape)


@register_flop_formula(_ops.flash_attention_bwd)
def _flash_attention_bwd_flop(dout_shape, q_shape, k_shape, v_shape, *args,
                              **kwargs) -> int:
    return _attention(q_shape, k_shape, v_shape, backward=True)


def _ssd(x_shape, b_shape, chunk: int) -> int:
    b, s, h, p = x_shape
    n = b_shape[-1]
    el = min(chunk, s)
    return 2 * b * h * s * (el * (n + p) // 2 + 2 * p * n)


@register_flop_formula([_ops.mamba2_ssd, _ops.mamba2_ssd_state])
def _mamba2_ssd_flop(x_shape, da_shape, b_shape, c_shape, chunk, *args,
                     **kwargs) -> int:
    return _ssd(x_shape, b_shape, chunk)


@register_flop_formula(_ops.mamba2_ssd_bwd)
def _mamba2_ssd_bwd_flop(x_shape, da_shape, b_shape, c_shape, dy_shape,
                         chunk, *args, **kwargs) -> int:
    return 2 * _ssd(x_shape, b_shape, chunk)


def _slstm(g_shape) -> int:
    b, s, _, h, dh = g_shape
    return 2 * b * s * h * 4 * dh * dh


@register_flop_formula([_ops.slstm_cell, _ops.slstm_cell_state,
                        _ops.slstm_cell_traj])
def _slstm_flop(g_shape, r_shape, b_shape, *args, **kwargs) -> int:
    return _slstm(g_shape)


@register_flop_formula(_ops.slstm_cell_bwd)
def _slstm_bwd_flop(traj_shape, h_shape, r_shape, dy_shape, *args,
                    **kwargs) -> int:
    b, s, _, h, dh = traj_shape
    return 2 * _slstm((b, s, 4, h, dh))
