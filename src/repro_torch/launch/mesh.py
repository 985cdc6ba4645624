"""Mesh construction — the counterpart of ``repro.launch.mesh``, as a
``torch.distributed`` ``DeviceMesh`` over the current process group.

Defined as FUNCTIONS (never module-level constants): importing this
module starts no process group.  Where none exists, the functions start
one for this process alone:

* on the card, NCCL on a ``HashStore``, rank 0 of 1 (one H100 is a 1 × 1
  mesh; NCCL takes one rank a card);
* on the host, gloo on a ``HashStore``, rank 0 of 1;
* for the production meshes (16 × 16 or 2 × 16 × 16, 256 or 512 ranks),
  torch's ``fake`` backend: one process stands for every rank, its
  collectives return at once, and tensors under ``FakeTensorMode`` hold
  no data — the dry-run's mesh (``launch/dryrun.py``).

Several processes (the CPU tests' gloo ranks) start their own group
first; the functions then lay the mesh over it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device

PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}


def _one_rank_group(dev: torch.device) -> None:
    """A process group of this process alone: NCCL on the card, gloo on
    the host."""
    store = dist.HashStore()
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=torch.device("cuda", index))
    else:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: DeviceLike = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the current process group
    (a one-rank group of ``device``'s kind when none exists); its size
    must be the group's."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        _one_rank_group(dev)
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"make_mesh: a {shape} mesh needs "
                         f"{math.prod(shape)} devices, the process group "
                         f"has {n}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(model: Optional[int] = None,
                   device: DeviceLike = "cuda") -> DeviceMesh:
    """A (data, model) mesh over whatever devices the process group has
    (tests / examples); ``model`` must divide their count."""
    dev = resolve_device(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = model or 1
    if n % model:
        raise ValueError(f"make_host_mesh: model={model} does not divide "
                         f"the {n} device(s) of the process group")
    return make_mesh((n // model, model), ("data", "model"), dev)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16×16 = 256 chips per pod; 2 pods = 512 chips when ``multi_pod`` —
    on torch's fake process group (started here when no group exists),
    for tracing under ``FakeTensorMode`` on the host."""
    shape, axes = PRODUCTION_SHAPE[multi_pod]
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
    return make_mesh(shape, axes, "cpu")
