"""Synthetic-but-learnable data pipeline — the counterpart of
``repro.data.pipeline``.

Deterministic per (seed, step) — restart-safe: after a checkpoint restore at
step k the iterator regenerates exactly the batches ≥ k, so fault recovery
replays no data and skips none.  :meth:`SyntheticLMDataset.batch_at` is the
reference's numpy stream, bit for bit; :func:`make_batch_iterator` moves
each batch onto the caller's device.

The token stream has learnable structure (a noisy affine-bigram process:
x_{t+1} = (a·x_t + b + ε) mod V with zipf-ish resets) so the end-to-end
training example shows a genuinely decreasing loss.  Under a mesh
:func:`shard_batch` makes each array a DTensor sharded on its batch
dimension over the data-parallel axes (the reference's ``shard_batch``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class SyntheticLMDataset:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    a: int = 5
    b: int = 131

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Generate batch for a given step (host-side numpy, deterministic)."""
        V = self.cfg.vocab_size
        rng = np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        B, S = self.global_batch, self.seq_len
        if self.cfg.frontend.kind != "none" and self.cfg.encdec is None:
            S = S - self.cfg.frontend.num_positions
        x = np.empty((B, S + 1), np.int32)
        x[:, 0] = rng.integers(0, V, size=B)
        noise = (rng.random((B, S)) < 0.1)
        jumps = rng.integers(0, V, size=(B, S))
        for t in range(S):
            nxt = (self.a * x[:, t] + self.b) % V
            x[:, t + 1] = np.where(noise[:, t], jumps[:, t], nxt)
        out = {"tokens": x[:, :-1], "targets": x[:, 1:]}
        if self.cfg.frontend.kind != "none":
            out["frontend"] = rng.standard_normal(
                (B, self.cfg.frontend.num_positions,
                 self.cfg.frontend.d_frontend)).astype(np.float32)
        return out


def _tensor(v: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A batch array on ``dev``: token arrays as int64 (torch's index
    dtype), the frontend's as float32."""
    return torch.from_numpy(np.ascontiguousarray(v)).to(
        dev, dtype=torch.long if v.dtype.kind == "i" else None)


def shard_batch(batch: Dict[str, np.ndarray], mesh) -> Dict[str,
                                                             torch.Tensor]:
    """Each array as a DTensor on ``mesh``'s device, placed as ("batch",
    None, ...) resolves (the divisibility guard applied); every rank
    holds the whole batch and keeps its block."""
    from repro_torch.sharding import logical_to_sharding
    return {k: logical_to_sharding(("batch",) + (None,) * (v.ndim - 1), mesh,
                                   dim_sizes=v.shape).place(
                                       _tensor(v, torch.device("cpu")))
            for k, v in batch.items()}


def make_batch_iterator(
    cfg: ModelConfig,
    shape: InputShape,
    mesh=None,
    *,
    seed: int = 0,
    start_step: int = 0,
    device: DeviceLike = "cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches ``start_step``, ``start_step + 1``, … on ``device``, or
    sharded over ``mesh`` (:func:`shard_batch`, on the mesh's device):
    token arrays as int64 (torch's index dtype), the frontend's as
    float32."""
    dev = resolve_device(device)
    ds = SyntheticLMDataset(cfg, shape.seq_len, shape.global_batch, seed=seed)
    step = start_step
    while True:
        b = ds.batch_at(step)
        yield shard_batch(b, mesh) if mesh is not None else \
            {k: _tensor(v, dev) for k, v in b.items()}
        step += 1
