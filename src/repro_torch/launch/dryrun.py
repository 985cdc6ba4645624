"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on a fake mesh
— the counterpart of ``repro.launch.dryrun``.

For each cell this driver:
  1. builds the production mesh (16×16 single-pod or 2×16×16 multi-pod)
     on torch's ``fake`` process group — one process stands for its 256
     or 512 ranks,
  2. resolves logical-axis shardings for params / optimizer / cache /
     batch (``launch/specs.py``),
  3. makes every input a DTensor whose local block is a ``meta`` tensor
     (shape and dtype, no data) and runs the train, prefill or decode
     step once — the model's ops, their DTensor sharding propagation and
     redistributions (collectives on ``meta`` blocks move nothing), the
     kernels' custom ops on each rank's local blocks through their fake
     impls,
  4. writes a JSON record: the reference's file name,
     ``{arch}__{shape}__{mesh}.json``, and its keys ``arch``, ``shape``,
     ``mesh``, ``mesh_shape``, ``status``, ``overrides``, ``total_s``
     (``error`` and ``traceback`` on failure).

There is no XLA here, so no ``memory_analysis`` or ``cost_analysis``.
The record fills, per device (rank 0's blocks; the layout is even):
  * ``memory.argument_bytes`` — the step's inputs' local blocks, exact
    (checked against ``specs.per_device_bytes``, the arithmetic of the
    resolved specs);
  * ``memory.output_bytes`` — the step's outputs' local blocks (a train
    step's new parameters and moments are its arguments, updated in
    place: the reference's donated aliases);
  * ``memory.temp_bytes`` — the peak of the local blocks that
    ``torch.distributed._tools.mem_tracker.MemTracker`` sees the step
    allocate (not DTensor's propagation, which runs on fake tensors of
    the global shapes: the local blocks are ``meta`` tensors so that the
    two differ), the arguments made inside it, less the arguments;
  * ``memory.total_per_device_bytes`` — arguments + temp, the tracker's
    peak;
  * ``cost.flops`` — ``torch.utils.flop_counter.FlopCounterMode`` over
    the same step run once more on one device without a mesh, on
    ``meta`` tensors of the global shapes (:func:`step_flops`): each op
    counted once at its global shape, the kernels' custom ops by the
    formulas in ``kernels/flops.py``; ``cost.flops_by_op`` splits it by
    op, and ``cost.flops_per_device`` is it over the device count (an
    even split; work that replicated ranks repeat is not in it; an
    ``moe_impl="a2a"`` override counts as the scatter dispatch it falls
    back to without a mesh).  Under
    the mesh the count would miss most of the kernels' work: they run on
    each rank's local blocks (``sharding.local_blocks``), where
    ``FlopCounterMode`` sees their local shapes.
It leaves out the reference's ``alias_bytes`` (no donation in eager
PyTorch: the train step's in-place update is the alias, counted once in
the arguments), ``code_bytes`` (no compiled executable), ``lower_s`` and
``compile_s`` (no lowering or compiling); ``trace_s`` is the step's
traced run.

In place of the reference's post-SPMD HLO (``hlo_path``, ``hlo_chars``)
the same traced run records rank 0's per-device program with
:class:`repro_torch.core.opcost.OpRecorder`: every aten op, kernel custom
op and functional collective it dispatches on its local blocks (not
DTensor's global-shape propagation), as (op, operand and result dtypes
and shapes, written operands, collective group size) → calls, with the
FLOPs of each op the flop registry knows.  It is written beside the
record as ``{arch}__{shape}__{mesh}.ops.json``; ``ops_path`` names it and
``ops_count`` is the calls recorded.  ``core/roofline.py`` prices it
(``--no-ops`` leaves it out, as the reference's ``--no-hlo``).

Usage (one cell a process: the fake group is per process):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k --mesh single --out runs/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import time
import traceback
from pathlib import Path
from typing import Any

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.presets import make_run_config
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.sharding import logical_to_pspec, use_mesh
from repro_torch.sharding.axes import RULE_PRESETS, NamedSharding
from repro_torch.sharding.local import contiguous_strides

DEFAULT_OUT = "runs/dryrun_torch"


def _shard_tree(axes_tree, spec_tree, mesh):
    return S.shardings_for(axes_tree, spec_tree, mesh)


def build_cell(arch: str, shape_name: str, mesh, overrides=None, *,
               smoke: bool = False, model_config=None):
    """Returns (fn, arg_specs, in_shardings, out_shardings): ``arg_specs``
    ``meta`` tensors, the shardings trees of ``NamedSharding`` (None: a
    plain value).  ``smoke`` takes the architecture's reduced config,
    ``model_config`` a given one (e.g. the full width at fewer layers)."""
    if smoke:
        model_config = get_smoke_config(arch)
    run = make_run_config(arch, shape_name, overrides=overrides,
                          model_config=model_config)
    cfg, shape = run.model, run.shape
    rep = S.scalar_sharding(mesh)

    params_abs = lm.abstract_params(cfg)
    params_sh = _shard_tree(lm.param_axes(cfg), params_abs, mesh)
    logits_sh = NamedSharding(mesh, logical_to_pspec(
        ("batch", "seq", "vocab"), mesh,
        dim_sizes=(shape.global_batch, 1, lm.padded_vocab(cfg))))

    if shape.kind == "train":
        fn = make_train_step(run)
        opt_abs = adamw.abstract_opt_state(params_abs, run.optimizer)
        opt_sh = adamw.opt_state_axes(params_sh)._replace(count=None)
        batch_abs = S.train_batch_specs(cfg, shape)
        batch_sh = _shard_tree(S.batch_axes(cfg), batch_abs, mesh)
        args = (params_abs, opt_abs, batch_abs)
        in_sh = (params_sh, opt_sh, batch_sh)
        out_sh = (params_sh, opt_sh, rep)
    elif shape.kind == "prefill":
        fn = make_prefill_step(run)
        cache_abs = lm.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        cache_sh = _shard_tree(
            lm.cache_axes(cfg, shape.global_batch, shape.seq_len),
            cache_abs, mesh)
        batch_abs = S.prefill_specs(cfg, shape)
        batch_sh = _shard_tree(
            {k: v for k, v in S.batch_axes(cfg).items() if k in batch_abs},
            batch_abs, mesh)
        args = (params_abs, cache_abs, batch_abs)
        in_sh = (params_sh, cache_sh, batch_sh)
        out_sh = (cache_sh, logits_sh)
    else:  # decode
        fn = make_decode_step(run)
        cache_abs = lm.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        cache_sh = _shard_tree(
            lm.cache_axes(cfg, shape.global_batch, shape.seq_len),
            cache_abs, mesh)
        tok_abs = S.decode_specs(cfg, shape)["tokens"]
        tok_sh = NamedSharding(mesh, logical_to_pspec(
            ("batch", "seq"), mesh, dim_sizes=(shape.global_batch, 1)))
        # the position the token writes: the cache's last, all of it valid
        args = (params_abs, cache_abs, tok_abs, shape.seq_len - 1)
        in_sh = (params_sh, cache_sh, tok_sh, None)
        out_sh = (cache_sh, logits_sh)
    return fn, args, in_sh, out_sh


def _meta_dtensor(spec: torch.Tensor, sharding, *, grad: bool = False):
    """A DTensor of a ``meta`` local block under ``sharding``, shaped and
    typed as the ``meta`` tensor ``spec``; ``spec`` itself where
    ``sharding`` is None."""
    from torch.distributed.tensor import DTensor
    if sharding is None:
        return spec
    shape = tuple(spec.shape)
    local = torch.empty(S.local_shape(shape, sharding.spec, sharding.mesh),
                        dtype=spec.dtype, device="meta")
    out = DTensor.from_local(local, sharding.mesh, sharding.placements,
                             run_check=False, shape=shape,
                             stride=contiguous_strides(shape))
    return out.requires_grad_() if grad else out


def _materialize(specs: Any, shardings: Any, *, grad: bool = False) -> Any:
    if isinstance(specs, dict):
        return {k: _materialize(v, shardings[k], grad=grad)
                for k, v in specs.items()}
    if hasattr(specs, "_fields"):
        return type(specs)(*(_materialize(v, s, grad=grad)
                             for v, s in zip(specs, shardings)))
    if not isinstance(specs, torch.Tensor):
        return specs
    return _meta_dtensor(specs, shardings, grad=grad)


def _fresh(tree: Any, *, grad: bool) -> Any:
    """Each ``meta`` tensor of ``tree`` anew (a leaf for autograd where
    ``grad``), so the step may update it in place."""
    if isinstance(tree, dict):
        return {k: _fresh(v, grad=grad) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_fresh(v, grad=grad) for v in tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    return torch.empty_like(tree).requires_grad_(grad and
                                                 tree.is_floating_point())


def step_flops(fn, args, *, train: bool) -> dict:
    """{op: FLOPs} of one run of ``fn`` on one device without a mesh, on
    fresh ``meta`` tensors shaped as ``args`` (the global shapes), under
    ``FlopCounterMode`` — the kernels' custom ops by ``kernels/flops.py``.
    A train step's parameters (``args[0]``) are what autograd
    differentiates."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flops  # noqa: F401 (custom op formulas)
    with FlopCounterMode(display=False) as fc:
        fn(*(_fresh(a, grad=(i == 0 and train))
             for i, a in enumerate(args)))
    return {str(op): int(n)
            for op, n in fc.get_flop_counts().get("Global", {}).items()}


def _local_bytes(tree: Any) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in _leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


#: the buffers a record lists at the peak (``peak_buffers``)
PEAK_BUFFERS = 12


def _local_mem_tracker():
    """A ``MemTracker`` that counts the local blocks only: DTensor's
    sharding propagation runs each op once more on fake tensors of the
    global shapes, which some torch releases let the tracker see (the
    local blocks here are ``meta`` tensors, never fake).  It also keeps
    the largest live buffers near its peak (:meth:`peak_buffers`): each
    time the peak grows by a thousandth, the :data:`PEAK_BUFFERS` largest
    storages alive with the op, dtype and shape that made each."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils._pytree import tree_leaves
    from torch.utils.weak import WeakIdKeyDictionary

    class LocalMemTracker(MemTracker):
        def __init__(self):
            super().__init__()
            self._made = WeakIdKeyDictionary()
            self._at, self._buffers = 0, []

        def _track(self, reftype, t):
            if not isinstance(t, FakeTensor):
                super()._track(reftype, t)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = super().__torch_dispatch__(func, types, args, kwargs)
            if res is NotImplemented:
                return res
            for t in tree_leaves(res):
                if isinstance(t, torch.Tensor) and \
                        not isinstance(t, FakeTensor):
                    st = t.untyped_storage()
                    if st not in self._made:
                        self._made[st] = (str(func.overloadpacket),
                                          str(t.dtype).split(".")[-1],
                                          list(t.shape))
            return res

        def _update_peak_stats(self, peak_state) -> None:
            super()._update_peak_stats(peak_state)
            peak = max(getattr(self, "_peak_mem", {}).values(), default=0)
            if peak <= self._at * 1.001:
                return
            self._at = peak
            live = []
            for st, (winfo, _) in list(getattr(self, "_WINFO", {}).items()):
                op, dt, shape = self._made.get(st, (None, None, None))
                live.append({"bytes": int(winfo.mem_consumed),
                             "kind": winfo.reftype.name, "op": op,
                             "dtype": dt, "shape": shape})
            live.sort(key=lambda b: -b["bytes"])
            self._buffers = live[:PEAK_BUFFERS]

        def peak_buffers(self) -> list:
            """The largest buffers alive when the peak last grew by a
            thousandth, largest first."""
            return self._buffers
    return LocalMemTracker()


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             overrides=None, *, smoke: bool = False,
             save_ops: bool = True, model_config=None):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.opcost import OpRecorder

    out_dir.mkdir(parents=True, exist_ok=True)
    # DTensor warns at every multi-axis gather; the record keeps the result
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "pod2"))
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "status": "start", "overrides": overrides or {},
    }
    if smoke:
        rec["smoke"] = True
    if model_config is not None:
        rec["num_layers"] = model_config.num_layers
    t0 = time.time()
    try:
        preset = (overrides or {}).get("sharding_preset", "tp_fsdp")
        with use_mesh(mesh, RULE_PRESETS[preset]):
            fn, args, in_sh, out_sh = build_cell(
                arch, shape_name, mesh, overrides, smoke=smoke,
                model_config=model_config)
            train = SHAPES_BY_NAME[shape_name].kind == "train"
            t1 = time.time()
            mt = _local_mem_tracker()
            recorder = (OpRecorder() if save_ops
                        else contextlib.nullcontext())
            with mt, implicit_replication(), recorder:
                # a train step's parameters are what autograd differentiates
                fargs = tuple(_materialize(a, s, grad=(i == 0 and train))
                              for i, (a, s) in enumerate(zip(args, in_sh)))
                arg_bytes = _local_bytes(fargs)
                out = fn(*fargs)
                out_bytes = _local_bytes(out)
            rec["trace_s"] = round(time.time() - t1, 2)
        if arg_bytes != S.per_device_bytes(in_sh, args):
            raise RuntimeError(
                f"the inputs hold {arg_bytes} bytes a device, the "
                f"resolved specs {S.per_device_bytes(in_sh, args)}")
        peak = mt.get_tracker_snapshot("peak")
        dev_peak = max(v["Total"] for v in peak.values())
        mem = {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(max(dev_peak - arg_bytes, 0)),
        }
        mem["total_per_device_bytes"] = mem["argument_bytes"] + \
            mem["temp_bytes"]
        rec["memory"] = mem
        rec["peak_buffers"] = mt.peak_buffers()
        if save_ops:
            ops_path = out_dir / \
                f"{arch}__{shape_name}__{mesh_kind}.ops.json"
            rec["ops_count"] = recorder.save(ops_path)
            rec["ops_path"] = str(ops_path)
        print(mem)
        t1 = time.time()
        by_op = step_flops(fn, args, train=train)
        total_flops = float(sum(by_op.values()))
        rec["cost"] = {"flops": total_flops,
                       "flops_per_device": total_flops / mesh.size(),
                       "flops_by_op": by_op,
                       "source": "FlopCounterMode over the step on one "
                                 "device without a mesh, meta tensors of "
                                 "the global shapes",
                       "count_s": round(time.time() - t1, 2)}
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, don't crash the sweep
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-20000:]
    rec["total_s"] = round(time.time() - t0, 2)
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_kind}.json"
    out_path.write_text(json.dumps(rec, indent=2))
    print(f"[dryrun] {arch} × {shape_name} × {mesh_kind}: {rec['status']} "
          f"({rec['total_s']}s)")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "pod2"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced config (tests)")
    ap.add_argument("--no-ops", action="store_true",
                    help="do not record the per-device op program")
    ap.add_argument("--override", action="append", default=[],
                    help="key=value run-config overrides (repeatable)")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the model to this depth at full width")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    model_config = None
    if args.num_layers is not None:
        from repro_torch.configs import get_config, get_smoke_config
        base = (get_smoke_config if args.smoke else get_config)(args.arch)
        model_config = dataclasses.replace(base, num_layers=args.num_layers)
    rec = run_cell(args.arch, args.shape, args.mesh, Path(args.out),
                   overrides=overrides or None, smoke=args.smoke,
                   save_ops=not args.no_ops, model_config=model_config)
    raise SystemExit(0 if rec["status"] == "ok" else 1)


if __name__ == "__main__":
    main()
