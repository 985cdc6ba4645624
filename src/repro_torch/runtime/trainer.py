"""Fault-tolerant training runtime — the counterpart of
``repro.runtime.trainer``.

Responsibilities
  * run the train step eagerly on the trainer's device (the reference jits
    and donates; here the optimizer updates its tensors in place),
  * checkpoint/restart: async checkpoints every N steps; on a step failure
    the trainer restores the latest complete checkpoint and *replays* —
    the data pipeline is deterministic per step, so recovery is exact,
  * straggler mitigation: per-step wall time vs the perf-model prediction.

Elastic scaling (``reshard``) and any mesh wait for ROADMAP queue A item 5.

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
from repro_torch.models.param import tree_map
from repro_torch.optim import adamw
from repro_torch.runtime.straggler import StragglerMonitor

_MESH = "training over a mesh (sharded params, reshard): ROADMAP queue A " \
        "item 5"


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
        if mesh is not None:
            raise NotImplementedError(_MESH)
        self.run = run
        self.cfg = run.model
        self.device = resolve_device(device)
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
        self._train_step = make_train_step(self.run)

    @staticmethod
    def _trainable(params: Any) -> Any:
        return tree_map(lambda p: p.requires_grad_(), params)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self._trainable(lm.init(gen, self.cfg, self.device))
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
        if isinstance(value, torch.Tensor) and value.is_cuda:
            torch.cuda.synchronize(value.device)

    def train(self, state: TrainState, num_steps: int,
              *, log_every: int = 10) -> TrainState:
        run = self.run
        it_step = state.step
        batches = make_batch_iterator(self.cfg, run.shape, seed=run.seed,
                                      start_step=it_step, device=self.device)
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
                    self.cfg, run.shape, seed=run.seed,
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
        tree = self.ckpt.restore(step, abs_tree, device=self.device)
        return TrainState(self._trainable(tree["params"]), tree["opt"], step)

    # ------------------------------------------------------------------
    def reshard(self, state: TrainState, new_mesh) -> TrainState:
        """Elastic scaling onto another mesh: not yet in the port."""
        raise NotImplementedError(_MESH)
