"""Router load generator: drive a mixed workload, verify exactly-once
(counterpart of ``repro/router/loadgen.py``).

  PYTHONPATH=src python -m repro_torch.router.loadgen --router http://127.0.0.1:PORT \\
      --requests 200 --concurrency 8 --verify-synthetic --json out.json

Builds a deterministic request mix (seeded prompt lengths × decode lengths),
fires it through worker threads, and accounts every submitted request into
exactly one bucket: ``ok`` / ``retried`` (completed), ``rejected`` (shed by
admission control), or ``error``.  ``--verify-synthetic`` recomputes
:func:`repro_torch.router.replica.expected_synthetic_tokens` for every completed
response — the proof that a request retried after a replica SIGKILL produced
the *same* answer it would have on the dead replica, i.e. that drain-retry
is invisible to clients.  ``run()`` is importable for tests and benchmarks.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Optional

from repro_torch.router.replica import expected_synthetic_tokens


def _percentile(xs: list[float], q: float) -> Optional[float]:
    if not xs:
        return None
    xs = sorted(xs)
    i = min(len(xs) - 1, int(q * len(xs)))
    return xs[i]


def build_specs(n: int, prompt_lens: list[int], max_new: int,
                seed: int = 0) -> list[dict[str, Any]]:
    """Deterministic mixed workload: n requests cycling the prompt lengths."""
    rng = random.Random(seed)
    specs = []
    for i in range(n):
        plen = prompt_lens[i % len(prompt_lens)]
        specs.append({
            "prompt": [rng.randrange(0, 50257) for _ in range(plen)],
            "max_new": max_new,
        })
    return specs


def run(router_url: str, specs: list[dict[str, Any]], *, concurrency: int = 4,
        timeout_s: float = 120.0, verify_synthetic: bool = False,
        keep_tokens: bool = False) -> dict[str, Any]:
    """Fire ``specs`` at the router; return the full accounting report.
    ``keep_tokens`` adds ``tokens``: each spec's reply tokens (None where it
    got no reply), for callers that hold replies against a reference, and
    beside them each reply's ``traces`` id and its ``client_ms``, the
    latency this client measured, for callers that hold the front door's
    trace against it.  The latencies also give ``p99`` (not in the JAX
    report)."""
    lock = threading.Lock()
    idx = [0]
    outcomes = {"ok": 0, "retried": 0, "rejected": 0, "error": 0}
    by_replica: dict[str, int] = {}
    latencies: list[float] = []
    route_ms: list[float] = []
    hop_ms: dict[str, list[float]] = {}  # frontdoor's per-hop decomposition
    responses: dict[int, int] = {}  # spec index -> completion count
    verify_failures = 0
    verified = 0
    tokens: list[Optional[list[int]]] = [None] * len(specs)
    traces: list[Optional[str]] = [None] * len(specs)
    client_ms: list[Optional[float]] = [None] * len(specs)

    def one(i: int, spec: dict[str, Any]) -> None:
        nonlocal verify_failures, verified
        body = json.dumps(spec).encode()
        req = urllib.request.Request(
            f"{router_url}/v1/generate", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                doc = json.loads(resp.read())
            outcome = doc.get("outcome", "ok")
            ok = True
        except urllib.error.HTTPError as exc:
            try:
                doc = json.loads(exc.read())
            except Exception:
                doc = {}
            outcome = doc.get("outcome",
                              "rejected" if exc.code == 429 else "error")
            ok = False
        except Exception:
            doc, outcome, ok = {}, "error", False
        wall_ms = (time.perf_counter() - t0) * 1e3
        good_tokens = None
        if ok and verify_synthetic:
            expected = expected_synthetic_tokens(spec["prompt"], spec["max_new"])
            good_tokens = doc.get("tokens") == expected
        with lock:
            outcomes[outcome] = outcomes.get(outcome, 0) + 1
            if ok:
                responses[i] = responses.get(i, 0) + 1
                tokens[i] = doc.get("tokens")
                traces[i], client_ms[i] = doc.get("trace"), wall_ms
                latencies.append(wall_ms)
                rep = doc.get("routed_to") or doc.get("replica") or "?"
                by_replica[rep] = by_replica.get(rep, 0) + 1
                if isinstance(doc.get("route_ms"), (int, float)):
                    route_ms.append(float(doc["route_ms"]))
                if isinstance(doc.get("hops"), dict):
                    for hop, v in doc["hops"].items():
                        if isinstance(v, (int, float)):
                            hop_ms.setdefault(hop, []).append(float(v))
                if good_tokens is not None:
                    verified += 1
                    if not good_tokens:
                        verify_failures += 1

    def worker() -> None:
        while True:
            with lock:
                if idx[0] >= len(specs):
                    return
                i = idx[0]
                idx[0] += 1
            one(i, specs[i])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, concurrency))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    completed = outcomes["ok"] + outcomes["retried"]
    report = {
        "submitted": len(specs),
        "completed": completed,
        "outcomes": outcomes,
        # any spec index answered twice would be a duplicate delivery —
        # impossible over one HTTP round-trip each, asserted anyway
        "duplicates": sum(1 for c in responses.values() if c > 1),
        "lost": len(specs) - sum(outcomes.values()),
        "by_replica": dict(sorted(by_replica.items())),
        "latency_ms": {
            "p50": _percentile(latencies, 0.50),
            "p95": _percentile(latencies, 0.95),
            "p99": _percentile(latencies, 0.99),
            "max": max(latencies) if latencies else None,
        },
        "route_ms": {
            "mean": (round(sum(route_ms) / len(route_ms), 4)
                     if route_ms else None),
            "p95": _percentile(route_ms, 0.95),
        },
        "hop_ms": {
            hop: {"mean": round(sum(vs) / len(vs), 4),
                  "p95": _percentile(vs, 0.95)}
            for hop, vs in sorted(hop_ms.items())
        },
        "wall_s": round(wall_s, 3),
    }
    if verify_synthetic:
        report["verified"] = verified
        report["verify_failures"] = verify_failures
    if keep_tokens:
        report.update(tokens=tokens, traces=traces, client_ms=client_ms)
    return report


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.router.loadgen", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--router", required=True, metavar="URL")
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--prompt-lens", default="8,16,32",
                    help="comma-separated prompt lengths to cycle through")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--timeout-s", type=float, default=120.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify-synthetic", action="store_true",
                    help="recompute expected synthetic tokens per response")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the report JSON here")
    args = ap.parse_args(argv)

    specs = build_specs(args.requests,
                        [int(x) for x in args.prompt_lens.split(",") if x],
                        args.max_new, seed=args.seed)
    report = run(args.router.rstrip("/"), specs,
                 concurrency=args.concurrency, timeout_s=args.timeout_s,
                 verify_synthetic=args.verify_synthetic)
    print(json.dumps(report), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    ok = (report["completed"] + report["outcomes"]["rejected"]
          + report["outcomes"]["error"] == report["submitted"]
          and report["duplicates"] == 0
          and report.get("verify_failures", 0) == 0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
