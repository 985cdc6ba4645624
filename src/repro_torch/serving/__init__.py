"""``repro_torch.serving`` — the long-lived prediction daemon; the
counterpart of ``repro.serving``.

Calibration is once per machine; prediction is the steady state.  This
package keeps that steady state hot: one open :class:`PerfSession` per
profile (resolved fits, a warm count engine) parked behind an HTTP
endpoint, concurrent in-flight requests coalesced into single
``predict_batch`` evaluations, and an LRU of open profiles for
multi-tenant fleets.

* :class:`CoalescingBatcher` — concurrent ``predict`` calls → one
  batched evaluation, with per-item error mapping.
* :class:`SessionPool` — LRU of (profile → open session + batcher).
* :class:`PredictionDaemon` — the HTTP surface (``/predict`` ``/stats``
  ``/healthz`` ``/shutdown``, and ``/route`` ``/complete`` ``/fleet``
  when a fleet router is mounted).
* ``python -m repro_torch.serve`` — the CLI (:mod:`.cli`), with a
  ``--smoke`` mode that turns the serving guarantees into an exit code.

Serving prices kernels from counts on fake tensors and launches none.
Everything rides the thread-safety contract of :mod:`repro_torch.api`:
the predict engine and the count engine serialize internally, so one
session is safely shared across every request thread.
"""
from repro_torch.serving.coalesce import BatcherClosed, CoalescingBatcher
from repro_torch.serving.daemon import PredictionDaemon, prediction_payload
from repro_torch.serving.pool import SessionPool

__all__ = [
    "BatcherClosed",
    "CoalescingBatcher",
    "PredictionDaemon",
    "SessionPool",
    "prediction_payload",
]
