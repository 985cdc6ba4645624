"""Input stand-ins + sharding resolution for every cell — the counterpart
of ``repro.launch.specs``.

The stand-ins are ``meta`` tensors (shape and dtype, never an
allocation); the dry-run turns them into fake DTensors on its fake mesh.
:func:`per_device_bytes` is the arithmetic of what one device holds of a
tree under the resolved specs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.param import torch_dtype
from repro_torch.sharding import NamedSharding, mesh_shape, tree_shardings


def text_len(cfg: ModelConfig, shape: InputShape) -> int:
    """Text-token length: frontend positions count toward seq_len for
    prefix-decoder VLMs (the frontend embeddings occupy sequence slots)."""
    if cfg.frontend.kind != "none" and cfg.encdec is None:
        return shape.seq_len - cfg.frontend.num_positions
    return shape.seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape
                      ) -> Dict[str, torch.Tensor]:
    """Token arrays are int64 in the port (torch's index dtype), as its
    data pipeline gives them; the reference's are int32."""
    B = shape.global_batch
    St = text_len(cfg, shape)
    out = {"tokens": _meta((B, St), torch.long),
           "targets": _meta((B, St), torch.long)}
    if cfg.frontend.kind != "none":
        out["frontend"] = _meta(
            (B, cfg.frontend.num_positions, cfg.frontend.d_frontend),
            torch_dtype(cfg.activation_dtype))
    return out


def batch_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    out = {"tokens": ("batch", "seq"), "targets": ("batch", "seq")}
    if cfg.frontend.kind != "none":
        out["frontend"] = ("batch", "seq", "frontend")
    return out


def prefill_specs(cfg: ModelConfig, shape: InputShape):
    b = train_batch_specs(cfg, shape)
    del b["targets"]
    return b


def decode_specs(cfg: ModelConfig, shape: InputShape
                 ) -> Dict[str, torch.Tensor]:
    return {"tokens": _meta((shape.global_batch, 1), torch.long),
            "cur_index": _meta((), torch.long)}


def shardings_for(tree_axes, tree_specs, mesh):
    """Resolve logical-axis trees to NamedShardings (divisibility-guarded)."""
    return tree_shardings(tree_axes, tree_specs, mesh=mesh)


def scalar_sharding(mesh) -> NamedSharding:
    from repro_torch.sharding import PartitionSpec
    return NamedSharding(mesh, PartitionSpec())


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """One device's block of a ``shape`` laid out by ``spec``: each
    dimension over the product of its mesh axes' sizes (the divisibility
    guard made it exact)."""
    sizes = mesh_shape(mesh)
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = (entry,) if isinstance(entry, str) else entry or ()
        out.append(n // math.prod(sizes[a] for a in axes))
    return tuple(out)


def per_device_bytes(shardings: Any, specs: Any) -> int:
    """Bytes one device holds of the tree ``specs`` (tensors; a Python
    scalar counts 0) under ``shardings`` (the tree :func:`shardings_for`
    gives; None: whole)."""
    def walk(sh, sp):
        if isinstance(sp, dict):
            return sum(walk(sh[k] if sh is not None else None, v)
                       for k, v in sp.items())
        if isinstance(sp, tuple):   # a NamedTuple or the step's arguments
            return sum(walk(s, v) for s, v in zip(
                sh if sh is not None else (None,) * len(sp), sp))
        if not isinstance(sp, torch.Tensor):   # a Python scalar argument
            return 0
        shape = tuple(sp.shape) if sh is None else local_shape(
            tuple(sp.shape), sh.spec, sh.mesh)
        return math.prod(shape) * sp.dtype.itemsize
    return walk(shardings, specs)
