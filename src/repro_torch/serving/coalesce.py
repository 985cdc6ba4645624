"""Request coalescing: many concurrent ``predict`` calls → one
``predict_batch``; the counterpart of ``repro.serving.coalesce``.

The batched path dedupes identical (signature, shapes) items before
counting and evaluates every row in one expression, so the cheapest way
to serve a burst is not to serve its requests one by one.
:class:`CoalescingBatcher` parks incoming requests on a queue; a single
drainer thread wakes, lingers one ``max_wait_s`` beat so the rest of the
burst can arrive, then drains everything pending into one
``PerfSession.try_predict_batch`` call per (model, strict) group and
resolves each caller's future with its own :class:`Prediction` — or its
own :class:`PredictionError` (one out-of-scope request never fails its
batch-mates).

``requests`` / ``batches`` / ``max_batch_size`` on the batcher, plus the
session's ``eval_calls``, make the claim assertable: K concurrent
requests through one batcher cost one batched evaluation.

``hold()`` / ``release()`` make coalescing deterministic for tests and
smokes: while held, the drainer sleeps and requests pile up;
``release()`` lets the whole accumulated burst drain as one batch.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.api import PerfSession, Prediction, PredictionError


@dataclass
class _Request:
    item: Any
    name: Optional[str]
    model: Optional[str]
    strict: bool
    future: "Future" = field(default_factory=Future)


class BatcherClosed(RuntimeError):
    """Submit after ``close()`` — the daemon is shutting down."""


class CoalescingBatcher:
    """Funnel concurrent predict requests into single batched calls
    against one hot :class:`PerfSession`."""

    def __init__(self, session: PerfSession, *,
                 max_batch: int = 256,
                 max_wait_s: float = 0.002):
        self.session = session
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._pending: List[_Request] = []
        self._held = False
        self._closed = False
        # counters (mutated under _lock only)
        self.requests = 0
        self.batches = 0
        self.max_batch_size = 0
        self._thread = threading.Thread(
            target=self._drain_loop, daemon=True,
            name="repro-torch-serve-drainer")
        self._thread.start()

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------

    def submit(self, item, *, name: Optional[str] = None,
               model: Optional[str] = None,
               strict: bool = False) -> "Future":
        """Enqueue one predict item; returns a future resolving to its
        :class:`Prediction` (or raising its per-item error)."""
        req = _Request(item=item, name=name, model=model, strict=strict)
        with self._wake:
            if self._closed:
                raise BatcherClosed("batcher is closed")
            self._pending.append(req)
            self.requests += 1
            self._wake.notify_all()
        return req.future

    def predict(self, item, *, name: Optional[str] = None,
                model: Optional[str] = None, strict: bool = False,
                timeout: Optional[float] = None) -> Prediction:
        """Blocking convenience: submit + wait (the HTTP handler's
        path — each handler thread blocks here while the drainer
        coalesces)."""
        return self.submit(item, name=name, model=model,
                           strict=strict).result(timeout=timeout)

    # ------------------------------------------------------------------
    # deterministic-coalescing seam (tests, CI smokes, benchmarks)
    # ------------------------------------------------------------------

    def hold(self) -> None:
        """Pause draining; submitted requests accumulate."""
        with self._wake:
            self._held = True

    def release(self) -> None:
        """Resume draining — everything accumulated goes in one batch
        (up to ``max_batch``)."""
        with self._wake:
            self._held = False
            self._wake.notify_all()

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting work, drain what is queued, join the drainer."""
        with self._wake:
            self._closed = True
            self._held = False
            self._wake.notify_all()
        self._thread.join(timeout=timeout)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"requests": self.requests, "batches": self.batches,
                    "max_batch_size": self.max_batch_size,
                    "coalesced": self.requests - self.batches
                    if self.batches else 0}

    # ------------------------------------------------------------------
    # drainer
    # ------------------------------------------------------------------

    def _drain_loop(self) -> None:
        while True:
            with self._wake:
                while not self._closed \
                        and (self._held or not self._pending):
                    self._wake.wait()
                if self._closed and not self._pending:
                    return
                linger = self.max_wait_s if not self._closed else 0.0
            if linger > 0:
                # the coalescing window: the first request of a burst is
                # in; give its siblings one beat to arrive
                time.sleep(linger)
            with self._wake:
                if self._held and not self._closed:
                    continue    # held mid-linger: park again
                batch = self._pending[:self.max_batch]
                del self._pending[:len(batch)]
            if batch:
                self._execute(batch)

    def _execute(self, batch: Sequence[_Request]) -> None:
        # group by (model, strict): each group is one batched call
        groups: Dict[Tuple[Optional[str], bool], List[_Request]] = {}
        for req in batch:
            groups.setdefault((req.model, req.strict), []).append(req)
        for (model, strict), reqs in groups.items():
            try:
                results = self.session.try_predict_batch(
                    [r.item for r in reqs],
                    names=[r.name for r in reqs]
                    if all(r.name is not None for r in reqs) else None,
                    model=model, strict=strict)
            except Exception as e:  # noqa: BLE001 — fan the failure out
                for r in reqs:
                    if not r.future.set_running_or_notify_cancel():
                        continue
                    r.future.set_exception(e)
                continue
            with self._lock:
                self.batches += 1
                self.max_batch_size = max(self.max_batch_size, len(reqs))
            for r, res in zip(reqs, results):
                if not r.future.set_running_or_notify_cancel():
                    continue
                if isinstance(res, PredictionError):
                    r.future.set_exception(res)
                else:
                    r.future.set_result(res)
