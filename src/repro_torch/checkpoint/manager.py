"""Checkpointing: atomic, async — the counterpart of
``repro.checkpoint.manager``, in its on-disk format.

* **Atomic** — each checkpoint is written to ``step_<k>.tmp/`` and renamed
  only after its manifest is fsynced; a crash mid-write can never corrupt
  the latest checkpoint (restore scans for the newest *complete* step).
* **Async** — ``save()`` snapshots the tensors to host memory and hands the
  file I/O to a background thread; training continues immediately.
* **The reference's format** — one ``.npy`` per leaf, keyed by the
  flattened tree path the reference's ``jax.tree_util`` gives (``params/
  embed``, ``opt/.mu/body/b0/w``, ``opt/.count``: a NamedTuple's field is
  ``.<name>``), and a ``manifest.json``; bfloat16 is stored as its bits
  (``bits:<u2``).  A checkpoint written by either package restores in the
  other, bit for bit.

On restore each leaf goes to the device the caller names.  Restoring
under another mesh's shardings waits for ROADMAP queue A item 5.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.profiles.profile import atomic_write_json

#: dtypes numpy has no type for, stored as unsigned bits of their width
_BIT_DTYPES = {"bfloat16": (torch.int16, "<u2"),
               "float8_e4m3fn": (torch.int8, "<u1"),
               "float8_e5m2": (torch.int8, "<u1")}


def _paths(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the reference's flattening order and naming:
    dict keys sorted, NamedTuple fields as ``.name`` in field order,
    sequence entries by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name in tree._fields
                for kv in _paths(getattr(tree, name), prefix + (f".{name}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _paths(x, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _rebuild(tree: Any, leaves: Dict[str, Any],
             prefix: Tuple[str, ...] = ()) -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[key]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), leaves,
                                     prefix + (f".{n}",))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves, prefix + (str(i),))
                          for i, x in enumerate(tree))
    return leaves["/".join(prefix)]


def _to_numpy(x: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the array to store and its dtype's name."""
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        return arr, str(arr.dtype)
    t = x.detach().cpu()
    name = str(t.dtype).split(".")[1]
    if name in _BIT_DTYPES:
        bits, view = _BIT_DTYPES[name]
        return t.contiguous().view(bits).numpy().view(view), name
    return t.numpy(), name


def save_tree(tree: Any, directory: Path, *, extra: Optional[Dict] = None):
    directory = Path(directory)
    tmp = directory.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"keys": [], "extra": extra or {}}
    for i, (k, v) in enumerate(sorted(_paths(tree))):
        arr, dtype = _to_numpy(v)
        fname = f"leaf_{i:05d}.npy"
        stored_as = f"bits:{arr.dtype.str}" if dtype in _BIT_DTYPES \
            else dtype
        np.save(tmp / fname, arr)
        manifest["keys"].append({"key": k, "file": fname, "dtype": dtype,
                                 "stored_as": stored_as,
                                 "shape": list(arr.shape)})
    atomic_write_json(tmp / "manifest.json", manifest)
    if directory.exists():
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def _load_leaf(directory: Path, e: Dict) -> torch.Tensor:
    arr = np.load(directory / e["file"])
    if str(e.get("stored_as", "")).startswith("bits:"):
        bits, _ = _BIT_DTYPES[e["dtype"]]
        signed = arr.view(np.dtype(str(bits).split(".")[1]))
        return torch.from_numpy(signed.copy()).view(getattr(torch,
                                                            e["dtype"]))
    return torch.from_numpy(np.ascontiguousarray(arr))


def restore_tree(directory: Path, abstract_tree: Any, shardings: Any = None,
                 *, device=None) -> Any:
    """The tree saved in ``directory``, in the structure, shapes and
    dtypes of ``abstract_tree`` (tensors, ``meta`` ones included, or
    anything with ``shape`` and ``dtype``), each leaf on ``device`` (the
    host when ``None``)."""
    if shardings is not None:
        raise NotImplementedError("restoring under a mesh's shardings: "
                                  "ROADMAP queue A item 5")
    directory = Path(directory)
    manifest = json.loads((directory / "manifest.json").read_text())
    by_key = {e["key"]: e for e in manifest["keys"]}
    leaves = {}
    for k, spec in _paths(abstract_tree):
        t = _load_leaf(directory, by_key[k])
        dtype = spec.dtype if isinstance(spec.dtype, torch.dtype) \
            else getattr(torch, str(spec.dtype))
        leaves[k] = t.to(dtype).reshape(tuple(spec.shape)).to(device)
    return _rebuild(abstract_tree, leaves)


class CheckpointManager:
    """Async checkpointer with retention and resume support."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._pending = 0
        self._lock = threading.Lock()

    # ---- write path -------------------------------------------------------
    def save(self, step: int, tree: Any, *, extra: Optional[Dict] = None,
             blocking: bool = False):
        # snapshot: a host copy of every tensor (the caller's may be
        # updated in place while the worker writes)
        host_tree = _rebuild(tree, {
            k: v.detach().to("cpu", copy=True)
            if isinstance(v, torch.Tensor) else np.array(v)
            for k, v in _paths(tree)})
        with self._lock:
            self._pending += 1
        self._q.put((step, host_tree, extra))
        if blocking:
            self.wait()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, extra = item
            try:
                save_tree(tree, self.root / f"step_{step:08d}",
                          extra={"step": step, **(extra or {})})
                self._gc()
            finally:
                with self._lock:
                    self._pending -= 1

    def wait(self):
        while True:
            with self._lock:
                if self._pending == 0:
                    return
            time.sleep(0.01)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    # ---- read path ---------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.root.glob("step_*"):
            if p.name.endswith(".tmp"):
                continue  # in-progress atomic write (or a crashed one)
            if p.is_dir() and (p / "manifest.json").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, abstract_tree: Any, shardings: Any = None,
                *, device=None):
        return restore_tree(self.root / f"step_{step:08d}", abstract_tree,
                            shardings, device=device)
