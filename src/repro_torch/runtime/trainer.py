"""Fault-tolerant training runtime — the counterpart of
``repro.runtime.trainer``.

Responsibilities
  * run the train step eagerly on the trainer's device (the reference jits
    and donates; here the optimizer updates its tensors in place) — under
    a mesh (``torch.distributed`` ``DeviceMesh``) with parameters,
    optimizer state and batches as DTensors placed by the logical-axis
    rules,
  * checkpoint/restart: async checkpoints every N steps; on a step failure
    the trainer restores the latest complete checkpoint and *replays* —
    the data pipeline is deterministic per step, so recovery is exact,
  * straggler mitigation: per-step wall time vs the perf-model prediction,
  * elastic scaling: ``reshard(state, new_mesh)`` re-lays-out parameters
    and optimizer state under another mesh (or none).  A DTensor cannot
    be redistributed across meshes, so each leaf goes through its whole
    tensor.

Failure injection for tests: pass ``failure_hook(step) -> bool``; a True
return raises a simulated device failure *after* the step executed, which
exercises the restore path deterministically.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import make_batch_iterator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.param import place_tree, tree_map
from repro_torch.optim import adamw
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.sharding import tree_shardings, use_mesh


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


class Trainer:
    def __init__(self, run: RunConfig, mesh=None, *,
                 predicted_step_s: Optional[float] = None,
                 failure_hook: Optional[Callable[[int], bool]] = None,
                 device: DeviceLike = "cuda"):
        self.run = run
        self.cfg = run.model
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None
                                     else mesh.device_type)
        self.ckpt = CheckpointManager(run.checkpoint_dir,
                                      keep=run.keep_checkpoints)
        self.monitor = StragglerMonitor(
            slack=run.straggler_slack, predicted_step_s=predicted_step_s)
        self.failure_hook = failure_hook
        self.metrics_log: List[Dict[str, float]] = []
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        self._abs_params = lm.abstract_params(self.cfg)
        if self.mesh is not None:
            self._param_sh = tree_shardings(
                lm.param_axes(self.cfg), self._abs_params, mesh=self.mesh)
            self._opt_sh = adamw.opt_state_axes(self._param_sh)._replace(
                count=None)
        else:
            self._param_sh = self._opt_sh = None
        step = make_train_step(self.run)
        if self.mesh is None:
            self._train_step = step
        else:
            def sharded_step(params, opt_state, batch):
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                # tensors the model makes itself (positions, masks) are
                # the same on every rank: replicated
                with use_mesh(self.mesh), implicit_replication():
                    params, opt_state, metrics = step(params, opt_state,
                                                      batch)
                return params, opt_state, {k: _whole(v)
                                           for k, v in metrics.items()}
            self._train_step = sharded_step

    @staticmethod
    def _trainable(params: Any) -> Any:
        return tree_map(lambda p: p.requires_grad_(), params)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = lm.init(gen, self.cfg, self.device)
        if self._param_sh is not None:
            params = place_tree(params, self._param_sh)
        params = self._trainable(params)
        opt = adamw.init_opt_state(params, self.run.optimizer)
        return TrainState(params, opt, 0)

    def restore_or_init(self, seed: int = 0) -> TrainState:
        latest = self.ckpt.latest_step()
        if latest is None:
            return self.init_state(seed)
        return self.load(latest)

    # ------------------------------------------------------------------
    @staticmethod
    def _sync(value: Any) -> None:
        """Wait for the card to finish the step (the reference's
        ``block_until_ready``)."""
        value = _whole(value)
        if isinstance(value, torch.Tensor) and value.is_cuda:
            torch.cuda.synchronize(value.device)

    def train(self, state: TrainState, num_steps: int,
              *, log_every: int = 10) -> TrainState:
        run = self.run
        it_step = state.step
        batches = make_batch_iterator(self.cfg, run.shape, self.mesh,
                                      seed=run.seed, start_step=it_step,
                                      device=self.device)
        retries = 0
        while state.step < num_steps:
            batch = next(batches)
            t0 = time.perf_counter()
            try:
                params, opt, metrics = self._train_step(
                    state.params, state.opt_state, batch)
                self._sync(metrics["loss"])
                if self.failure_hook and self.failure_hook(state.step):
                    raise SimulatedFailure(f"injected at step {state.step}")
            except Exception as e:  # noqa: BLE001 — fault-tolerant path
                retries += 1
                if retries > run.max_step_retries:
                    raise
                latest = self.ckpt.latest_step()
                if latest is None:
                    state = self.init_state(run.seed)
                else:
                    state = self.load(latest)
                batches = make_batch_iterator(
                    self.cfg, run.shape, self.mesh, seed=run.seed,
                    start_step=state.step, device=self.device)
                self.metrics_log.append(
                    {"step": state.step, "event": "restored",
                     "error": str(e)[:80]})
                continue
            wall = time.perf_counter() - t0
            state = TrainState(params, opt, state.step + 1)
            self.monitor.observe(state.step, wall)
            row = {"step": state.step, "wall_s": wall,
                   **{k: float(v) for k, v in metrics.items()}}
            self.metrics_log.append(row)
            if log_every and state.step % log_every == 0:
                print(f"[train] step={state.step} "
                      f"loss={row.get('loss', float('nan')):.4f} "
                      f"wall={wall:.3f}s", flush=True)
            if run.checkpoint_every and \
                    state.step % run.checkpoint_every == 0:
                self.save(state)
        return state

    # ------------------------------------------------------------------
    def save(self, state: TrainState, *, blocking: bool = False):
        tree = {"params": state.params, "opt": state.opt_state}
        self.ckpt.save(state.step, tree, extra={"step": state.step},
                       blocking=blocking)

    def load(self, step: int) -> TrainState:
        opt_abs = adamw.abstract_opt_state(self._abs_params,
                                           self.run.optimizer)
        abs_tree = {"params": self._abs_params, "opt": opt_abs}
        sh_tree = {"params": self._param_sh, "opt": self._opt_sh} \
            if self._param_sh is not None else None
        tree = self.ckpt.restore(step, abs_tree, sh_tree, device=self.device)
        return TrainState(self._trainable(tree["params"]), tree["opt"], step)

    # ------------------------------------------------------------------
    def reshard(self, state: TrainState, new_mesh) -> TrainState:
        """Elastic scaling: move the state onto another mesh (None: one
        device, plain tensors) and rebuild the step for it.  Each leaf
        goes through its whole tensor, bit for bit."""
        whole = _map(lambda t: _whole(t.detach()),
                     {"params": state.params, "opt": state.opt_state})
        self.mesh = new_mesh
        if new_mesh is not None:
            self.device = resolve_device(new_mesh.device_type)
        self._build()
        moved = _map(lambda t: t.to(self.device).contiguous(), whole)
        if new_mesh is not None:
            moved = place_tree(moved, {"params": self._param_sh,
                                       "opt": self._opt_sh})
        return TrainState(self._trainable(moved["params"]), moved["opt"],
                          state.step)


def _map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the tensors of a tree of dicts and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    return fn(tree)


def _whole(t: Any) -> Any:
    """A DTensor gathered whole (every rank of its mesh calls this); any
    other value itself."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t
