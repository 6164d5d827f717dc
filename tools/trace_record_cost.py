#!/usr/bin/env python3
"""Host cost of the port's trace record path, per event.

    PYTHONPATH=src python3 tools/trace_record_cost.py [--events N] [--out PATH]

Records N events (spawn / exit pairs of ``decode_tick``, and a ``dispatch``
event after each, the mix a compiled serving tick records) into a
:class:`repro_torch.trace.collector.TraceCollector` three ways: bare, with
the metrics plane attached (as the drivers always run), and with the
metrics plane and a :class:`~repro_torch.trace.stream.StreamingSession`
writing fsynced segments under a temporary directory (``--trace-dir``).
Prints one JSON line: microseconds an event for each way (the median of 5
rounds), with the host it ran on.  ``chip_smoke.py`` phase 8 runs it on the
card's host; it needs no card.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _record(col, n: int) -> float:
    """Seconds an event over ``n`` events of the serving tick's mix."""
    t0 = time.perf_counter()
    for i in range(n // 3):
        sid = 1_000_000 + 2 * i
        col.record("spawn", "decode_tick", 8, span=sid, parent=1)
        col.record("dispatch", "serve_decode",
                   {"op": "serve_decode", "backend": "kernel", "source": "static",
                    "measured_s": 0.004, "est_s": 0.0}, span=sid + 1, parent=sid)
        col.record("exit", "decode_tick", 8, span=sid, parent=1)
    return (time.perf_counter() - t0) / (3 * (n // 3))


def record_cost(events: int = 30_000, rounds: int = 5) -> dict:
    from repro_torch.metrics import MetricsPlane
    from repro_torch.trace.collector import TraceCollector
    from repro_torch.trace.stream import StreamingSession

    out = {}
    for way in ("bare", "metrics", "metrics_stream"):
        costs = []
        for _ in range(rounds):
            col = TraceCollector()
            with tempfile.TemporaryDirectory(prefix="repro_torch_trace_cost_") as d:
                stream = None
                if way != "bare":
                    MetricsPlane(col)
                if way == "metrics_stream":
                    stream = StreamingSession(os.path.join(d, "s")).attach(col)
                costs.append(_record(col, events))
                if stream is not None:
                    stream.close()
        out[f"{way}_us"] = 1e6 * statistics.median(costs)
    return {"events": events, "rounds": rounds, "host": platform.node(),
            "cpu": platform.processor() or platform.machine(), **out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--events", type=int, default=30_000)
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON line here")
    args = ap.parse_args()
    rec = record_cost(args.events)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out is not None:
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
