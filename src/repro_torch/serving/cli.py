"""``python -m repro_torch.serve`` — the prediction-serving daemon CLI;
the counterpart of ``repro.serving.cli``.

Serve mode::

    python -m repro_torch.serve --profile machine_profile.json \
        --cache-dir ~/.cache/repro-measurements --port 8787

opens the profile once (zero measurements, on no device), parks an open
:class:`PerfSession` behind HTTP, and answers ``POST /predict`` bodies
like ``{"kernel": "kernels.ops.matmul"}`` — concurrent requests coalesce
into single batched model evaluations (see :mod:`repro_torch.serving`).

Smoke mode::

    python -m repro_torch.serve --profile profile.json --smoke --burst 64 \
        --expect-zero-timings [--fleet P1.json --fleet P2.json ...]

starts an in-process daemon on an ephemeral port, holds the batcher,
fires a ``--burst``-request concurrent HTTP burst cycling over the
built-in kernel targets, releases, and turns the serving guarantees into
an exit code: every reply 200, zero kernel timings, at most one count
lookup per unique kernel, fewer batched evaluations than requests, the
whole burst in one batch, and a clean ``POST /shutdown``; with
``--fleet``, ``/route`` over every machine with zero timings and no
outstanding load left after ``/complete``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from repro_torch.api import PerfSession
from repro_torch.serving.daemon import PredictionDaemon


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Serve runtime predictions from a calibrated machine "
                    "profile over HTTP, coalescing concurrent requests "
                    "into single batched model evaluations.")
    ap.add_argument("--profile", required=True,
                    help="calibrated machine-profile JSON to serve")
    ap.add_argument("--cache-dir", default=None,
                    help="measurement-cache directory (persistent count "
                         "store; a warm store serves counts with zero "
                         "counting passes)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787,
                    help="listen port (0 = ephemeral)")
    ap.add_argument("--max-open", type=int, default=4,
                    help="LRU budget of concurrently hot profiles")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="largest coalesced batch")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="coalescing window: how long the drainer lingers "
                         "for a burst's siblings")
    ap.add_argument("--fleet", action="append", default=[],
                    metavar="PROFILE",
                    help="mount a fleet router over these machine "
                         "profiles (repeatable): adds POST /route, "
                         "POST /complete, GET /fleet")
    ap.add_argument("--fleet-policy", default="predicted_makespan",
                    help="routing policy for the mounted fleet router")
    ap.add_argument("--smoke", action="store_true",
                    help="self-driving CI smoke: concurrent burst against "
                         "an in-process daemon, guarantees as exit code")
    ap.add_argument("--burst", type=int, default=64,
                    help="concurrent requests in the smoke burst")
    ap.add_argument("--expect-zero-timings", action="store_true",
                    help="(smoke) exit 1 if serving timed ANY kernel")
    return ap


def _open_daemon(args) -> PredictionDaemon:
    session = PerfSession.open(args.profile, cache=args.cache_dir)
    router = None
    if args.fleet:
        from repro_torch.fleet import FleetRouter
        router = FleetRouter.open(args.fleet, cache=args.cache_dir,
                                  policy=args.fleet_policy)
    return PredictionDaemon(
        session, host=args.host,
        port=0 if args.smoke else args.port,
        max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1e3,
        max_open=args.max_open, router=router)


def _post(url: str, body: Dict[str, Any], timeout: float = 60.0
          ) -> Dict[str, Any]:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return {"status": resp.status,
                    "body": json.loads(resp.read() or b"{}")}
    except urllib.error.HTTPError as e:
        return {"status": e.code,
                "body": json.loads(e.read() or b"{}")}


def _get(url: str, timeout: float = 10.0) -> Dict[str, Any]:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def run_smoke(args) -> int:
    daemon = _open_daemon(args).start()
    names = sorted(daemon.targets)
    print(f"serve smoke: daemon at {daemon.url}, "
          f"{len(names)} kernel targets, burst {args.burst}")
    failures: List[str] = []
    try:
        if _get(f"{daemon.url}/healthz").get("ok") is not True:
            failures.append("healthz did not answer ok")

        # hold the drainer so the WHOLE burst coalesces into one batch —
        # the deterministic version of what the linger window does live
        daemon.batcher.hold()
        burst = [{"kernel": names[i % len(names)]}
                 for i in range(args.burst)]
        with ThreadPoolExecutor(max_workers=args.burst) as pool:
            futs = [pool.submit(_post, f"{daemon.url}/predict", b)
                    for b in burst]
            deadline = time.monotonic() + 30.0
            while daemon.batcher.pending_count() < args.burst:
                if time.monotonic() > deadline:
                    failures.append(
                        f"burst never fully parked: "
                        f"{daemon.batcher.pending_count()}/{args.burst} "
                        f"pending")
                    break
                time.sleep(0.005)
            daemon.batcher.release()
            replies = [f.result(timeout=120.0) for f in futs]

        bad = [r for r in replies if r["status"] != 200]
        if bad:
            failures.append(f"{len(bad)} non-200 replies, first: {bad[0]}")
        for r in replies:
            if r["status"] == 200 and r["body"]["seconds"] <= 0:
                failures.append(f"non-positive prediction: {r['body']}")
                break

        if daemon.router is not None:
            # fleet leg: /route must price every machine, dispatch, and
            # never time a kernel; /complete drains; /fleet reports
            routed = [_post(f"{daemon.url}/route", {"kernel": n})
                      for n in names[:4]]
            bad = [r for r in routed if r["status"] != 200]
            if bad:
                failures.append(f"/route failed: {bad[0]}")
            else:
                spread = {r["body"]["machine"] for r in routed}
                for r in routed:
                    _post(f"{daemon.url}/complete",
                          {"machine": r["body"]["machine"],
                           "predicted_s": r["body"]["predicted_s"],
                           "observed_s": r["body"]["predicted_s"]})
                fleet = _get(f"{daemon.url}/fleet")
                if fleet["timings"] != 0:
                    failures.append(f"fleet routing timed a kernel "
                                    f"({fleet['timings']} timer calls)")
                if any(v > 1e-12 for v in fleet["outstanding"].values()):
                    failures.append(f"/complete left outstanding load: "
                                    f"{fleet['outstanding']}")
                print(f"serve smoke: routed {len(routed)} kernels over "
                      f"{len(fleet['machines'])} machines "
                      f"({len(spread)} distinct), 0 timings")

        stats = _get(f"{daemon.url}/stats")
        n_unique = len({b["kernel"] for b in burst})
        if args.expect_zero_timings and stats["timings"] != 0:
            failures.append(f"serving timed a kernel "
                            f"({stats['timings']} timer calls)")
        if stats["count_lookups"] > n_unique:
            failures.append(
                f"{stats['count_lookups']} count lookups for "
                f"{n_unique} unique kernels — batch dedup broke")
        if not (0 < stats["eval_calls"] < args.burst):
            failures.append(
                f"{stats['eval_calls']} batched evaluations for "
                f"{args.burst} requests — coalescing broke")
        if stats["batcher"]["max_batch_size"] < args.burst:
            failures.append(
                f"largest coalesced batch was "
                f"{stats['batcher']['max_batch_size']}, "
                f"expected the full {args.burst}-request burst")
        print(f"serve smoke: stats {json.dumps(stats)}")

        if _post(f"{daemon.url}/shutdown", {})["body"].get("ok") \
                is not True:
            failures.append("shutdown did not answer ok")
    finally:
        daemon.close()

    if failures:
        for f in failures:
            print(f"serve smoke FAILED: {f}", file=sys.stderr)
        return 1
    print(f"serve smoke OK: {args.burst} concurrent requests, "
          f"{stats['eval_calls']} batched evaluation(s), "
          f"{stats['count_lookups']} count lookups, "
          f"{stats['timings']} kernel timings")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.smoke:
        return run_smoke(args)
    daemon = _open_daemon(args)
    host, port = daemon.address
    fits = ", ".join(daemon.session.profile.fit_names)
    print(f"serving profile {args.profile} "
          f"({daemon.session.profile.fingerprint.id}; fits: {fits}) "
          f"on http://{host}:{port} — POST /predict, GET /stats")
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
        daemon.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
