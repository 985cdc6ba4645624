"""Built-in prediction targets: the port's hand kernels
(:mod:`repro_torch.kernels.ops`) at the reference's canonical shapes
(``repro.analysis.targets``).

Arguments are ``meta`` tensors — shapes and dtypes without storage — so
pricing a target allocates nothing and runs nothing.  The names feed
``python -m repro_torch.calibrate predict --kernel NAME``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, List, Tuple

import torch


@dataclass(frozen=True)
class KernelTarget:
    """A callable plus abstract (``meta``) example arguments."""

    name: str
    fn: Callable = field(repr=False)
    args: Tuple[Any, ...] = field(repr=False)


def f32(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device="meta")


def kernel_targets() -> List[KernelTarget]:
    from repro_torch.kernels import ops

    return [
        KernelTarget(
            "kernels.ops.matmul",
            functools.partial(ops.matmul, block_m=128, block_n=128,
                              block_k=128),
            (f32(128, 128), f32(128, 128))),
        KernelTarget(
            "kernels.ops.flash_attention",
            functools.partial(ops.flash_attention, causal=True, block_q=64,
                              block_k=64),
            (f32(2, 256, 8, 64), f32(2, 256, 2, 64), f32(2, 256, 2, 64))),
        KernelTarget(
            "kernels.ops.mamba2_ssd",
            functools.partial(ops.mamba2_ssd, chunk=32),
            (f32(2, 128, 4, 32), f32(2, 128, 4), f32(2, 128, 4, 16),
             f32(2, 128, 4, 16))),
        KernelTarget(
            "kernels.ops.stencil5",
            functools.partial(ops.stencil5, block_m=128, block_n=128),
            (f32(256, 256),)),
        KernelTarget(
            "kernels.ops.dg_diff",
            functools.partial(ops.dg_diff, block_e=256),
            (f32(3, 64, 64), f32(64, 1024))),
        KernelTarget(
            "kernels.ops.stream_strided",
            functools.partial(ops.stream_strided, block=256, stride=2),
            ([f32(8192), f32(8192)],)),
        KernelTarget(
            "kernels.ops.madd_throughput",
            functools.partial(ops.madd_throughput, iters=32, block=1024),
            (f32(4096),)),
        KernelTarget(
            "kernels.ops.slstm_cell",
            ops.slstm_cell,
            (f32(2, 24, 4, 4, 16), f32(4, 16, 4, 16), f32(4, 4, 16))),
    ]
