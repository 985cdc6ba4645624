"""The prediction daemon: a long-lived HTTP endpoint over open sessions;
the counterpart of ``repro.serving.daemon``.

Request/response protocol (JSON over the standard library's HTTP server):

* ``POST /predict`` — body ``{"kernel": <name>, "model"?: <fit>,
  "profile"?: <path>, "strict"?: bool}``.  The kernel name is resolved
  against the registered target vocabulary (by default
  :func:`repro_torch.analysis.targets.kernel_targets` — the eight hand
  kernels on ``meta`` tensors, as the lint CLI audits them); the request
  parks on the profile's :class:`CoalescingBatcher` and the reply
  carries seconds and the per-term breakdown.  An out-of-scope strict
  request gets its own 422 (batch-mates are unaffected); an unknown
  kernel 404; a malformed body 400.
* ``GET /stats`` — kernel timings performed (0 on the serving path),
  batched evaluations, evaluators built, count lookups, counting
  passes, the batcher's coalescing counters and the pool's
  opens/evictions.
* ``GET /healthz`` — liveness.
* ``POST /shutdown`` — clean stop (drains in-flight batches).

A daemon constructed with a :class:`~repro_torch.fleet.FleetRouter` also
speaks the fleet protocol:

* ``POST /route`` — body ``{"kernel": <name>, "model"?: <fit>,
  "policy"?: <policy>, "dispatch"?: bool}``.  Prices the kernel on every
  fleet machine (zero timings) and replies with the chosen machine, the
  per-machine price table, and the ledger/health snapshots the decision
  used.  ``dispatch`` (default true) charges the chosen machine's
  outstanding-load ledger.
* ``POST /complete`` — body ``{"machine": <id>, "predicted_s": <s>,
  "observed_s"?: <s>}``.  Drains the ledger; an observed time feeds the
  health layer's observed-vs-predicted skew (demotion/recalibration).
* ``GET /fleet`` — the router's ledger: machines, outstanding load,
  per-machine health/weights, and machines flagged for recalibration.

Each handler thread blocks on its own future while the drainer thread
coalesces the burst into one batched evaluation — concurrency is what
creates the batch.  Serving runs no kernel: prices come from counts on
fake tensors.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from repro_torch.api import PerfSession, Prediction, PredictionError
from repro_torch.serving.coalesce import CoalescingBatcher
from repro_torch.serving.pool import SessionPool


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # a coalescing daemon's whole point is simultaneous connects: the
    # stdlib default backlog of 5 RESETS the rest of a 64-way burst
    request_queue_size = 128


def _target_vocabulary() -> Dict[str, Tuple[Any, tuple]]:
    """name → (fn, abstract args) for every built-in kernel target."""
    from repro_torch.analysis.targets import kernel_targets
    return {t.name: (t.fn, t.args) for t in kernel_targets()}


def prediction_payload(pred: Prediction) -> Dict[str, Any]:
    """The JSON body of a successful prediction reply."""
    return {
        "kernel": pred.kernel,
        "model": pred.model,
        "seconds": float(pred.seconds),
        "breakdown": {k: float(v) for k, v in pred.breakdown.items()},
        "unmodeled": sorted(pred.unmodeled),
    }


class PredictionDaemon:
    """A :class:`ThreadingHTTPServer` wrapping one default hot session
    (plus an LRU :class:`SessionPool` for requests naming other
    profiles)."""

    def __init__(self, session: PerfSession, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 256, max_wait_s: float = 0.002,
                 max_open: int = 4,
                 targets: Optional[Dict[str, Tuple[Any, tuple]]] = None,
                 pool: Optional[SessionPool] = None,
                 router: Optional[Any] = None):
        self.session = session
        # optional fleet router: mounts /route, /complete, and /fleet
        self.router = router
        # injectable vocabulary: tests serve tiny lambdas, production
        # serves the built-in kernel targets
        self.targets = dict(targets) if targets is not None \
            else _target_vocabulary()
        self.batcher = CoalescingBatcher(session, max_batch=max_batch,
                                         max_wait_s=max_wait_s)
        self.pool = pool if pool is not None else SessionPool(
            max_open=max_open, cache=session.cache,
            max_batch=max_batch, max_wait_s=max_wait_s)
        self._server = _Server((host, port), self._handler_class())
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._server.server_address[:2]
        return str(host), int(port)

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "PredictionDaemon":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="repro-torch-serve-http")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Foreground mode (the CLI's non-smoke path)."""
        try:
            self._server.serve_forever()
        finally:
            self.close()

    def shutdown(self) -> None:
        self._server.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def close(self) -> None:
        self.shutdown()
        self.batcher.close()
        self.pool.close()
        if self.router is not None:
            self.router.close()
        self._server.server_close()

    # ------------------------------------------------------------------
    # request handling (thread-per-request; blocking on batcher futures)
    # ------------------------------------------------------------------

    def _resolve_batcher(self, profile: Optional[str]
                         ) -> CoalescingBatcher:
        if profile is None:
            return self.batcher
        _session, batcher = self.pool.get(profile)
        return batcher

    def handle_predict(self, body: Dict[str, Any]
                       ) -> Tuple[int, Dict[str, Any]]:
        kernel = body.get("kernel")
        if not isinstance(kernel, str):
            return 400, {"error": "body must carry a 'kernel' name"}
        target = self.targets.get(kernel)
        if target is None:
            return 404, {"error": f"unknown kernel {kernel!r}",
                         "known": sorted(self.targets)}
        fn, args = target
        batcher = self._resolve_batcher(body.get("profile"))
        try:
            pred = batcher.predict(
                (fn, tuple(args)), name=kernel,
                model=body.get("model"),
                strict=bool(body.get("strict", False)))
        except PredictionError as e:
            return 422, {"error": str(e), "violations": e.violations}
        return 200, prediction_payload(pred)

    def handle_route(self, body: Dict[str, Any]
                     ) -> Tuple[int, Dict[str, Any]]:
        if self.router is None:
            return 503, {"error": "no fleet router mounted; start the "
                                  "daemon with --fleet PROFILE..."}
        kernel = body.get("kernel")
        if not isinstance(kernel, str):
            return 400, {"error": "body must carry a 'kernel' name"}
        target = self.targets.get(kernel)
        if target is None:
            return 404, {"error": f"unknown kernel {kernel!r}",
                         "known": sorted(self.targets)}
        fn, args = target
        try:
            decision = self.router.route(
                (fn, tuple(args)), name=kernel,
                model=body.get("model"), policy=body.get("policy"),
                dispatch=bool(body.get("dispatch", True)))
        except ValueError as e:
            return 400, {"error": str(e)}
        except PredictionError as e:
            return 422, {"error": str(e), "violations": e.violations}
        return 200, decision.to_dict()

    def handle_complete(self, body: Dict[str, Any]
                        ) -> Tuple[int, Dict[str, Any]]:
        if self.router is None:
            return 503, {"error": "no fleet router mounted; start the "
                                  "daemon with --fleet PROFILE..."}
        machine = body.get("machine")
        predicted_s = body.get("predicted_s")
        if not isinstance(machine, str) \
                or not isinstance(predicted_s, (int, float)):
            return 400, {"error": "body must carry 'machine' and a "
                                  "numeric 'predicted_s'"}
        observed = body.get("observed_s")
        if observed is not None and not isinstance(observed, (int, float)):
            return 400, {"error": "'observed_s' must be numeric"}
        try:
            self.router.complete(machine, predicted_s=float(predicted_s),
                                 observed_s=(float(observed)
                                             if observed is not None
                                             else None))
        except (KeyError, ValueError) as e:
            return 404 if isinstance(e, KeyError) else 400, \
                {"error": str(e).strip("'\""),
                 "machines": self.router.machines}
        return 200, {"ok": True,
                     "outstanding": self.router.outstanding(),
                     "health": self.router.health.report().get(machine)}

    def stats(self) -> Dict[str, Any]:
        eng = self.session.engine
        out = {
            "timings": self.session.timer.calls,
            "eval_calls": self.session.eval_calls,
            "trace_count": self.session.trace_count,
            "count_lookups": eng.hits + eng.misses,
            "count_traces": eng.trace_count,
            "batcher": self.batcher.stats(),
            "pool": self.pool.stats(),
        }
        if self.router is not None:
            out["fleet"] = self.router.stats()
        return out

    def _handler_class(self):
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):    # noqa: D102 — quiet
                pass

            def _reply(self, status: int, payload: Dict[str, Any]):
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):                     # noqa: N802 — stdlib
                if self.path == "/healthz":
                    self._reply(200, {"ok": True})
                elif self.path == "/stats":
                    self._reply(200, daemon.stats())
                elif self.path == "/fleet":
                    if daemon.router is None:
                        self._reply(503, {"error": "no fleet router "
                                                   "mounted"})
                    else:
                        self._reply(200, daemon.router.stats())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):                    # noqa: N802 — stdlib
                if self.path == "/shutdown":
                    self._reply(200, {"ok": True})
                    # shut down from another thread: shutdown() blocks
                    # until serve_forever returns, which waits on THIS
                    # handler otherwise
                    threading.Thread(target=daemon._server.shutdown,
                                     daemon=True).start()
                    return
                handlers = {"/predict": daemon.handle_predict,
                            "/route": daemon.handle_route,
                            "/complete": daemon.handle_complete}
                handler = handlers.get(self.path)
                if handler is None:
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"bad request body: {e}"})
                    return
                try:
                    status, payload = handler(body)
                except Exception as e:  # noqa: BLE001 — typed reply
                    status, payload = 500, {"error": str(e)}
                self._reply(status, payload)

        return Handler
