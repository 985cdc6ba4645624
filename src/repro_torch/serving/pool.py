"""LRU pool of open prediction sessions for multi-tenant serving; the
counterpart of ``repro.serving.pool``.

One daemon answers for many machines: each request may name a
different profile, and an open :class:`PerfSession` carries state worth
keeping (resolved fits and evaluators, a warm count engine, an open
measurement cache).  :class:`SessionPool` keeps the ``max_open``
most-recently-used profiles open, each behind its own
:class:`CoalescingBatcher`, and evicts the coldest (closing its batcher,
which drains in-flight work) when a new profile would exceed the budget.

Reopening an evicted profile performs no measurement, and its counts
come back from the persistent count store when the pool has a cache.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union

from repro_torch.api import PerfSession
from repro_torch.serving.coalesce import CoalescingBatcher


class SessionPool:
    """LRU cache of (profile path → hot session + batcher) entries."""

    def __init__(self, *, max_open: int = 4,
                 cache: Union[None, str, Path] = None,
                 session_factory: Optional[Callable[..., PerfSession]]
                 = None,
                 max_batch: int = 256,
                 max_wait_s: float = 0.002):
        if max_open < 1:
            raise ValueError(f"max_open must be >= 1, got {max_open}")
        self.max_open = int(max_open)
        self.cache = cache
        # injectable for tests: (profile_path, cache=...) -> PerfSession
        self._factory = session_factory or self._default_factory
        self._max_batch = max_batch
        self._max_wait_s = max_wait_s
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, Tuple[PerfSession, CoalescingBatcher]]" \
            = OrderedDict()
        self.opens = 0
        self.hits = 0
        self.evictions = 0

    @staticmethod
    def _default_factory(profile_path: str, *, cache=None) -> PerfSession:
        return PerfSession.open(profile_path, cache=cache)

    def get(self, profile_path: Union[str, Path]
            ) -> Tuple[PerfSession, CoalescingBatcher]:
        """The hot (session, batcher) pair for ``profile_path``, opening
        (and possibly evicting the LRU entry) on miss."""
        key = str(profile_path)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry
            session = self._factory(key, cache=self.cache)
            batcher = CoalescingBatcher(session,
                                        max_batch=self._max_batch,
                                        max_wait_s=self._max_wait_s)
            self._entries[key] = (session, batcher)
            self.opens += 1
            evicted = []
            while len(self._entries) > self.max_open:
                _, old = self._entries.popitem(last=False)
                evicted.append(old)
                self.evictions += 1
        # close outside the lock: the evicted batcher drains its queue
        # before its drainer exits, and in-flight futures must not wait
        # on a thread that is itself waiting on our lock
        for _sess, old_batcher in evicted:
            old_batcher.close()
        return session, batcher

    def close(self) -> None:
        """Close every open batcher (draining queued work)."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for _sess, batcher in entries:
            batcher.close()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"open": len(self._entries), "opens": self.opens,
                    "hits": self.hits, "evictions": self.evictions}
