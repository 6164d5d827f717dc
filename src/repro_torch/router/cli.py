"""Router driver: spawn a replica fleet behind one cost-routed front door
(counterpart of ``repro/router/cli.py``, with its flags).

  PYTHONPATH=src python -m repro_torch.router --replicas 2 --synthetic \\
      --port 0 --ready-file router.ready --trace-dir router_trace
  PYTHONPATH=src python -m repro_torch.router --replicas 2 --arch qwen2-0.5b \\
      --max-batch 8 --max-seq 1024 --dispatch profiled --fleet http://127.0.0.1:8377

Everything after the router's own flags configures the replicas (they all
get the same engine flags): ``--synthetic`` for the deterministic engine,
or ``--arch``/``--reduced``/``--dispatch`` for real replicas serving the
port's compiled engine on ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch versions).  The router process itself never imports
``torch``.

Observability mirrors the single-process drivers: ``--trace-dir`` streams
the router's events (request spans, route decisions, replica lifecycle)
durably; ``--metrics-port`` serves the router metrics plane on a dedicated
listener (the front door also exposes ``/metrics`` on its own port).

``--fleet`` seeds the cost model: for each replica's announced
(git SHA, chip) the router pulls that bucket's ProfileStore and prices
per-class a-priori costs from its ``serve_prefill``/``serve_decode``
entries — so a heterogeneous fleet starts routing each request class toward
the chip where it measured fastest, before a single live sample exists.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from typing import Optional

from repro_torch.metrics import MetricsPlane, serve_metrics
from repro_torch.router.cost import CostRouter
from repro_torch.router.frontdoor import make_frontdoor
from repro_torch.router.manager import ReplicaManager
from repro_torch.trace.collector import TraceCollector
from repro_torch.trace.stream import StreamingSession
from repro_torch.utils.ready import write_ready_file


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.router", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--replicas", type=int, default=2, metavar="N")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="front-door port (0 picks a free one)")
    ap.add_argument("--ready-file", default=None, metavar="PATH",
                    help="announce the front-door URL here once routable")
    ap.add_argument("--workdir", default="router_work", metavar="DIR",
                    help="replica ready files + per-replica logs land here")
    ap.add_argument("--queue-depth", type=int, default=16,
                    help="admission control: max in-flight per replica")
    ap.add_argument("--ewma-alpha", type=float, default=0.25,
                    help="live latency EWMA weight for new samples")
    ap.add_argument("--request-timeout-s", type=float, default=30.0,
                    help="budget for finding a live replica before 503")
    ap.add_argument("--forward-timeout-s", type=float, default=120.0,
                    help="per-attempt replica response timeout")
    ap.add_argument("--fleet", default=None, metavar="URL|DIR",
                    help="seed per-replica routing costs from this fleet's "
                         "(git SHA, chip) profile buckets")
    ap.add_argument("--fleet-token", default=None)
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="dedicated Prometheus listener for the router plane")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="stream router events as durable JSONL segments")
    ap.add_argument("--trace-rotate", type=int, default=2048, metavar="N")
    ap.add_argument("--trace-rotate-keep", type=int, default=None, metavar="N")
    ap.add_argument("--startup-timeout-s", type=float, default=120.0)
    # replica engine flags (forwarded verbatim to every replica)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthetic-ms-per-token", type=float, default=2.0)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--dispatch",
                    choices=("off", "static", "roofline", "profiled"),
                    default="off")
    ap.add_argument("--dispatch-backend", default="kernel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.synthetic and not args.arch:
        ap.error("--arch is required unless --synthetic")

    replica_argv = ["--max-batch", str(args.max_batch),
                    "--max-seq", str(args.max_seq),
                    "--seed", str(args.seed)]
    if args.synthetic:
        replica_argv += ["--synthetic", "--synthetic-ms-per-token",
                         str(args.synthetic_ms_per_token)]
    else:
        replica_argv += ["--arch", args.arch,
                         "--dispatch", args.dispatch,
                         "--dispatch-backend", args.dispatch_backend,
                         "--device", args.device]
        if args.reduced:
            replica_argv.append("--reduced")
        if args.fleet:
            replica_argv += ["--fleet", args.fleet]
            if args.fleet_token:
                replica_argv += ["--fleet-token", args.fleet_token]
    if args.trace_dir:
        # every replica streams its own session under <trace-dir>/replicas/
        # (each picks a fresh <name>-<pid> subdir per incarnation, so
        # supervisor restarts never collide); the frontdoor manifest lists
        # the announced dirs so `repro_torch.trace stitch <trace-dir>` finds the
        # whole fleet from one path
        replica_argv += ["--trace-dir-root",
                         os.path.join(args.trace_dir, "replicas"),
                         "--trace-rotate", str(args.trace_rotate)]

    log = TraceCollector()
    plane = MetricsPlane(log)
    router = CostRouter(queue_depth=args.queue_depth,
                        ewma_alpha=args.ewma_alpha,
                        registry=plane.registry)
    stream = None
    if args.trace_dir:
        stream = StreamingSession(
            args.trace_dir,
            rotate_events=args.trace_rotate,
            max_segments=args.trace_rotate_keep,
            meta={"driver": "router", "replicas": args.replicas,
                  "origin": f"frontdoor:{os.getpid()}"},
            metrics_provider=plane.snapshot,
        ).attach(log)

    fleet_client = None
    seed_cache: dict[tuple[str, str], tuple] = {}
    if args.fleet:
        from repro_torch.fleet.client import FleetClient, FleetError

        fleet_client = FleetClient(args.fleet, token=args.fleet_token)

    def seed_from_fleet(name: str, info: dict) -> None:
        """Pull the replica's (git SHA, chip) bucket and price routing costs.

        One pull per distinct identity — homogeneous fleets hit the fleet
        service once, not N times."""
        if fleet_client is None:
            return
        key = (str(info.get("git_sha") or ""), str(info.get("chip") or ""))
        if key not in seed_cache:
            try:
                pulled = fleet_client.pull(*key)
                seed_cache[key] = (pulled["store"], pulled["match"])
            except FleetError as exc:
                print(f"router: fleet seed pull failed for {key}: {exc}",
                      file=sys.stderr)
                seed_cache[key] = (None, "error")
        store, match = seed_cache[key]
        priced = router.seed_replica(name, store, match=match)
        print(f"router: {name} fleet seed ({key[0]}, {key[1]}) -> {match}"
              f"{' (priced)' if priced else ''}", file=sys.stderr)

    replica_sessions: list[dict] = []

    def on_up(name: str, url: str, info: dict) -> None:
        router.add_replica(name)
        seed_from_fleet(name, info)
        router.mark_up(name, url)
        td = info.get("trace_dir")
        if stream is not None and td and not any(
                r["trace_dir"] == td for r in replica_sessions):
            replica_sessions.append({"replica": name, "trace_dir": td})
            stream.set_meta("replica_sessions", list(replica_sessions))

    def on_down(name: str, reason: str) -> None:
        router.mark_down(name)

    manager = ReplicaManager(
        args.replicas, replica_argv, args.workdir,
        log=log, registry=plane.registry,
        on_up=on_up, on_down=on_down,
        startup_timeout_s=args.startup_timeout_s)

    # root span of the router's whole life: request spans and replica
    # lifecycle marks nest under it in report --tree and the exporters
    from repro_torch.core.events import next_span_id

    run_span = next_span_id()
    log.record("spawn", "router_run",
               {"replicas": args.replicas, "synthetic": args.synthetic},
               span=run_span)
    try:
        manager.start()
    except Exception as exc:
        print(f"router: replica startup failed: {exc}", file=sys.stderr)
        manager.stop()
        return 1

    front = make_frontdoor(args.host, args.port)
    front.log = log
    front.router = router
    front.manager = manager
    front.plane = plane
    front.run_span = run_span
    front.origin = f"frontdoor:{os.getpid()}"
    front.request_timeout_s = args.request_timeout_s
    front.forward_timeout_s = args.forward_timeout_s
    threading.Thread(target=front.serve_forever, name="frontdoor",
                     daemon=True).start()

    mserver = None
    if args.metrics_port is not None:
        mserver = serve_metrics(plane, port=args.metrics_port)
        print(f"router metrics: {mserver.url}/metrics", file=sys.stderr)

    print(json.dumps({"router": front.url, "replicas": manager.status()}),
          flush=True)
    if args.ready_file:
        write_ready_file(args.ready_file,
                         {"url": front.url, "replicas": args.replicas})

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    while not stop.is_set():
        stop.wait(0.2)

    front.stop()
    manager.stop()
    log.record("exit", "router_run",
               {"requests": front.requests_seen}, span=run_span)
    rec = {
        "router": front.url,
        "requests": front.requests_seen,
        "routing": router.snapshot(),
        "replicas": manager.status(),
    }
    trace_stats = log.stats()
    rec["trace"] = trace_stats
    if stream is not None:
        rec["trace_dir"] = stream.close(stats=trace_stats)
    if mserver is not None:
        mserver.stop()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
