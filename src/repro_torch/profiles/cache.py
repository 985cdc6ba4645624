"""Content-addressed measurement cache — the counterpart of
``repro.profiles.cache``, with the reference's entry format.

Timing a measurement-kernel battery is the expensive, noisy part of
calibration; counts are deterministic and timings are reusable as long as
nothing they depend on changed.  Each entry is one JSON file named by the
SHA-256 of its *key* — kernel name, sizes, generator code signature,
device fingerprint, trials, cache schema, and, in the port, the torch and
CUDA versions and the timing method — so:

* a warm :func:`repro_torch.core.uipick.gather_feature_table` run performs
  zero kernel timings and zero counting passes,
* another device, trials count, kernel size, generator source, torch
  build or timing method misses naturally (different key, different
  file): an eager or other-torch timing is never served as a CUDA-graph
  timing, and
* the store is incremental: adding kernels only measures the new ones.

Corrupt or foreign entries read as misses and are overwritten, never
trusted.  The code signature sees only the generator's own source: after
editing a shared helper it calls, bump ``CACHE_SCHEMA_VERSION`` or clear
the directory.
"""
from __future__ import annotations

import hashlib
import json
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch.core.counting import FeatureCounts
from repro_torch.core.uipick import TIMING_METHODS, TimingStats
from repro_torch.profiles.profile import atomic_write_json

# the port's own key history (its keys carry fields the reference's lack)
CACHE_SCHEMA_VERSION = 1

# files the cache owns are named by a 64-hex SHA-256 digest — anything
# else in the directory is not ours to count or delete
_ENTRY_NAME = re.compile(r"[0-9a-f]{64}\.json")


@dataclass
class CacheEntry:
    """One kernel's reusable measurement: its counted features and
    (median) wall time, None for counts-only gathers; ``noise`` carries
    the measurement's spread when the timer reported it."""

    counts: FeatureCounts
    wall_time: Optional[float]
    noise: Optional[TimingStats] = None


@dataclass(frozen=True)
class GCStats:
    """Outcome of one :meth:`MeasurementCache.gc` sweep."""

    kept: int = 0
    dropped_foreign: int = 0
    dropped_old: int = 0
    dropped_corrupt: int = 0
    dropped_schema: int = 0

    @property
    def dropped(self) -> int:
        return (self.dropped_foreign + self.dropped_old
                + self.dropped_corrupt + self.dropped_schema)


class MeasurementCache:
    """File-per-entry content-addressed store under ``root``, duck-typed
    against ``gather_feature_table``'s ``cache``: ``get(kernel, trials)``
    and ``put(kernel, trials, wall_time, counts)``; ``hits``/``misses``
    make its behaviour observable."""

    def __init__(self, root, fingerprint):
        self.root = Path(root).expanduser()
        self.fingerprint = fingerprint
        self.hits = 0
        self.misses = 0

    @property
    def count_store(self) -> Path:
        """Directory of the count engine's persistent tier, beside the
        timing entries (``<root>/countengine/``): counts are
        machine-independent, and a subdirectory keeps them out of
        :meth:`gc`'s flat sweep."""
        return self.root / "countengine"

    # -- keying --------------------------------------------------------------
    def _key_payload(self, kernel_name: str, sizes: Mapping[str, int],
                     trials: int, code_sig: str = "") -> Dict[str, Any]:
        return {
            "schema": CACHE_SCHEMA_VERSION,
            "kernel": kernel_name,
            "sizes": {k: int(v) for k, v in sorted(sizes.items())},
            "fingerprint": self.fingerprint.id,
            "trials": int(trials),
            "code": str(code_sig),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "timing": TIMING_METHODS.get(self.fingerprint.platform,
                                         "injected-timer"),
        }

    def _path(self, key_payload: Dict[str, Any]) -> Path:
        digest = hashlib.sha256(
            json.dumps(key_payload, sort_keys=True).encode()).hexdigest()
        return self.root / f"{digest}.json"

    # -- store ---------------------------------------------------------------
    def get(self, kernel, trials: int) -> Optional[CacheEntry]:
        key = self._key_payload(kernel.name, kernel.sizes, trials,
                                getattr(kernel, "code_sig", ""))
        try:
            payload = json.loads(self._path(key).read_text())
        except (OSError, ValueError):
            self.misses += 1
            return None
        # never trust an entry whose shape is wrong or whose embedded key
        # does not match the request
        if not isinstance(payload, dict) \
                or payload.get("key") != key \
                or not isinstance(payload.get("counts"), dict):
            self.misses += 1
            return None
        self.hits += 1
        counts = FeatureCounts(
            {str(k): float(v) for k, v in payload["counts"].items()})
        wall = payload.get("wall_time")
        noise = None
        raw_noise = payload.get("noise")
        if isinstance(raw_noise, dict) and "median" in raw_noise:
            try:
                noise = TimingStats(
                    median=float(raw_noise["median"]),
                    std=(float(raw_noise["std"])
                         if raw_noise.get("std") is not None else None),
                    min=(float(raw_noise["min"])
                         if raw_noise.get("min") is not None else None))
            except (TypeError, ValueError):
                noise = None            # malformed noise never blocks a hit
        return CacheEntry(counts, float(wall) if wall is not None else None,
                          noise)

    def put(self, kernel, trials: int, wall_time: Optional[float],
            counts: Mapping[str, float], *,
            noise: Optional[TimingStats] = None) -> None:
        key = self._key_payload(kernel.name, kernel.sizes, trials,
                                getattr(kernel, "code_sig", ""))
        payload: Dict[str, Any] = {
            "key": key,
            "wall_time": wall_time,
            "counts": {k: float(v) for k, v in sorted(counts.items())},
        }
        if noise is not None and (noise.std is not None
                                  or noise.min is not None):
            payload["noise"] = noise.to_dict()
        atomic_write_json(self._path(key), payload)

    def __len__(self) -> int:
        if not self.root.is_dir():
            return 0
        return sum(1 for p in self.root.glob("*.json")
                   if _ENTRY_NAME.fullmatch(p.name))

    # -- eviction ------------------------------------------------------------
    def gc(self, *, max_age: Optional[float] = None,
           drop_foreign: bool = True, now: Optional[float] = None) -> GCStats:
        """Evict stale entries.  Drops, in this order of precedence:
        corrupt files (unparseable or not entry-shaped), entries of
        another ``CACHE_SCHEMA_VERSION``, entries of another device
        fingerprint (``drop_foreign``), and entries older than
        ``max_age`` seconds by file mtime.  Files not named by a 64-hex
        digest are never touched."""
        if now is None:
            now = time.time()
        kept = foreign = old = corrupt = stale_schema = 0
        if not self.root.is_dir():
            return GCStats()
        for path in sorted(self.root.glob("*.json")):
            if not _ENTRY_NAME.fullmatch(path.name):
                continue
            try:
                mtime = path.stat().st_mtime
            except OSError:
                continue        # vanished under a concurrent sweep
            try:
                payload = json.loads(path.read_text())
                key = payload["key"] if isinstance(payload, dict) else None
                fp = key["fingerprint"] if isinstance(key, dict) else None
                if not isinstance(fp, str):
                    raise ValueError("entry has no fingerprint")
            except (OSError, ValueError, KeyError, TypeError):
                path.unlink(missing_ok=True)
                corrupt += 1
                continue
            if key.get("schema") != CACHE_SCHEMA_VERSION:
                path.unlink(missing_ok=True)
                stale_schema += 1
                continue
            if drop_foreign and fp != self.fingerprint.id:
                path.unlink(missing_ok=True)
                foreign += 1
                continue
            if max_age is not None and now - mtime > max_age:
                path.unlink(missing_ok=True)
                old += 1
                continue
            kept += 1
        return GCStats(kept=kept, dropped_foreign=foreign, dropped_old=old,
                       dropped_corrupt=corrupt, dropped_schema=stale_schema)
