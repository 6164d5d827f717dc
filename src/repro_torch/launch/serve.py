"""Serving driver: continuous-batching engine over synthetic requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --prompt-len 512 --max-seq 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --dispatch profiled \
      --profile-out /tmp/p.json

Counterpart of ``repro/launch/serve.py``.  Weights are random, drawn from
``--seed`` on the device; prompts are uniform random token ids from the same
seed.  Prints one JSON line with the JAX driver's fields (``arch``,
``requests``, ``generated_tokens``, ``tokens_per_s``, ``mean_prefill_ms``,
``wall_s``, ``sample``) plus ``device`` and ``kernels``, the launch count of
each Hopper kernel in the run (all 0 on the CPU, where the plain versions
run).  On the card the engine runs compiled, as the JAX driver's engine
jits its steps (no flag, as there is none for ``jit``): the first prefill
of each prompt length and the first decode tick run eagerly, the second
captures a CUDA graph, and every later one replays it; ``kernels`` counts
the launches of the replays too.  An RWKV6 or Mamba model's prompt longer
than its scan chunk (16 reduced; 128 for RWKV6 and 256 for Mamba at full
width) must be a multiple of it.  Full-depth jamba-1.5-large (796 GB in
bf16) does not fit one card.

``--dispatch {static,roofline,profiled}`` routes every prefill and decode
tick through ``dispatch/`` between the tiers that run on ``--device``: the
Hopper kernels (``kernel``) and their plain PyTorch versions (``plain``)
on the card, ``plain`` alone on the CPU (``--dispatch-backend``, the tier
``static`` pins, defaults to ``kernel``, the production tier; on the CPU
it falls back to ``plain``, recorded as ``static-fallback``).  On the card
a compiled step's first call runs eagerly and its second captures, so the
dispatcher warms a tier after 3 samples there (``min_samples=3``: every
warm set holds a replay), after 2 on the CPU.  ``--profile-in`` (repeatable)
warm-starts the store from earlier runs' ``--profile-out`` files (either
package's), merged, with the entries of other code or another chip aged
out first.  The JSON line then gains ``dispatch`` (the dispatcher's
summary), ``dispatch_events``, ``profile_in``, ``profile_aged_out`` and
``profile_out``, as the JAX driver's; ``--profile-in`` also takes a trace
session (``--trace-out``) of either package.

Observability (``trace/``, ``metrics/``), the JAX driver's flags: the log
is a bounded :class:`~repro_torch.trace.collector.TraceCollector`
(``--trace-capacity``) with a metrics plane always attached.
``--trace-out PATH`` writes a session of the run (events, dispatch
decisions, profiles, chip, provenance) for ``python -m repro_torch.trace
{report,export,diff}``; ``--trace-dir DIR`` streams the events as rotated,
fsynced JSONL segments (``--trace-rotate`` events a segment,
``--trace-rotate-keep`` segments kept; ``python -m repro_torch.trace
compact DIR`` recovers a session after a crash); ``--metrics-port P`` serves
Prometheus text on ``http://127.0.0.1:P/metrics`` while the run is live
(0 picks a port; ``--ready-file`` announces the URL, ``--metrics-linger-s``
keeps it up after the run); ``--trace-overhead-budget-pct B`` (or
``--metrics-port``) starts the adaptive controller, which duty-cycles span
capture to hold the record path's measured cost under B %.
``--torch-profile DIR`` opens duty-cycled ``torch.profiler`` windows under
the same budget (``--torch-profile-period-s``), at step boundaries on the
serving thread, and merges each window's kernels under the host span that
launched them (``trace/liveprof.py``); ``--torch-profile-backend
synthetic`` runs that path without a card (CPU only; ``auto`` means
``torch``).  With any of these flags the JSON line gains ``trace``,
``metrics`` and, as they apply, ``trace_controller``, ``device_capture``,
``trace_dir`` and ``trace_out``; without them it is what it was, and
the run launches the same kernels.

Fleet mode (``fleet/``), the JAX driver's flags: ``--fleet <url|dir>``
(with ``--dispatch``) pulls the best matching profile snapshot at startup
(exact (git SHA, chip) match, then the freshest bucket of the same chip,
whose entries of other code age out and re-explore, then nothing), pushes
the measured delta at the end and, with ``--trace-dir``, at every
streaming rotation; ``--fleet-token`` authenticates the pushes.  The JSON
line gains ``fleet`` (the pull's match and the pushed samples), and a
``--profile-out`` store is marked as already fed, so ``fleet push`` refuses
to count it twice.

Kernel autotuning (``tune/``), the JAX driver's flags: ``--tune cached``
installs the winners already in the dispatcher's store (a fleet pull or a
``--profile-in`` file) at no sweep cost; ``--tune sweep`` first measures
the design-space points the store lacks (``--tune-ops`` restricts the
ops; ``--tune-mode real`` times them on the card, the default there,
``interpret`` the plain spaces on the CPU, the default there,
``synthetic`` prices them; ``--tune-workers`` runs interpret / synthetic
points in processes, and is refused with ``real``, ROADMAP R16).  Tuning
needs ``--dispatch`` (the winners live in its store), runs after the fleet
pull and before the engine is built (a captured step refuses other tuned
configs, ``serving/compiled.py``), and its samples ride the fleet push.
The JSON line gains ``tune`` (``sweep_points``, ``pruned``, ``applied``,
``configs``, and a sweep's ``winners``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core.events import EventLog
from repro_torch.dispatch import DispatchConfig, Dispatcher, host_registry
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.metrics import (DEFAULT_BUDGET_PCT, AdaptiveController, MetricsPlane,
                                 serve_metrics)
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.trace.collector import DEFAULT_CAPACITY, TraceCollector
from repro_torch.trace.liveprof import BACKENDS, DEFAULT_PERIOD_S, LiveDeviceProfiler
from repro_torch.trace.session import Session, age_out_profiles, load_profile_stores
from repro_torch.trace.stream import StreamingSession
from repro_torch.utils.ready import write_ready_file


def make_dispatcher(args: argparse.Namespace, device: torch.device, log: EventLog):
    """The drivers' dispatcher from ``--dispatch`` / ``--dispatch-backend`` /
    ``--profile-in`` (None for ``off``), and the entries aged out of the
    loaded profiles."""
    if args.dispatch == "off":
        return None, []
    store = load_profile_stores(args.profile_in) if args.profile_in else None
    dispatcher = Dispatcher(
        # on the card a tier's third call is its first plain replay
        DispatchConfig(policy=args.dispatch, static_backend=args.dispatch_backend,
                       min_samples=3 if device.type == "cuda" else 2),
        registry=host_registry(device=device), store=store, log=log,
    )
    aged = age_out_profiles(dispatcher.store, dispatcher.chip.name) if args.profile_in else []
    return dispatcher, aged


def add_dispatch_args(ap: argparse.ArgumentParser, what: str) -> None:
    ap.add_argument("--dispatch", choices=("off", "static", "roofline", "profiled"),
                    default="off", help=f"profile-guided tier placement of {what}")
    ap.add_argument("--dispatch-backend", default="kernel",
                    help="tier pinned by --dispatch static (kernel or plain)")
    ap.add_argument("--profile-in", action="append", default=None, metavar="PATH",
                    help="warm-start dispatch profiles from a --profile-out file or a "
                         "--trace-out session (repeatable; merged)")
    ap.add_argument("--profile-out", default=None, metavar="PATH",
                    help="write the dispatcher's ProfileStore JSON here at the end")


def dispatch_record(args: argparse.Namespace, dispatcher, aged: list, log: EventLog) -> dict:
    """The JSON line's dispatch fields; writes ``--profile-out``."""
    if dispatcher is None:
        return {}
    rec = {"dispatch": dispatcher.summary(),
           "dispatch_events": len(log.events(kind="dispatch"))}
    if args.profile_in:
        rec["profile_in"] = args.profile_in
        rec["profile_aged_out"] = len(aged)
    if args.profile_out:
        text = dispatcher.store.to_json()
        if getattr(args, "fleet", None):
            # marks the store as already fed to a fleet live, so `fleet push`
            # refuses to count its samples twice
            text = json.dumps({**json.loads(text), "fleet": args.fleet}, indent=1)
        with open(args.profile_out, "w") as f:
            f.write(text)
        rec["profile_out"] = args.profile_out
    return rec


def add_fleet_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--fleet", default=None, metavar="URL|DIR",
                    help="central profile service (fleet/): pull the best matching "
                         "snapshot at startup, push measured deltas while running and "
                         "at the end (daemon URL or store directory)")
    ap.add_argument("--fleet-token", default=None, metavar="TOKEN",
                    help="bearer token for a --token-protected fleet daemon")


def warm_start(args: argparse.Namespace, dispatcher, run_meta: dict):
    """``--fleet``: the pull's record and the delta pusher (both None without
    it); the run's metadata is marked as feeding that fleet."""
    if not args.fleet or dispatcher is None:
        return None, None
    from repro_torch.fleet import warm_start_from_fleet

    fleet_rec, pusher = warm_start_from_fleet(args.fleet, dispatcher, token=args.fleet_token)
    # recorded in session and manifest metadata: push-profiles refuses to
    # push an artifact of a run that already fed a fleet live
    run_meta["fleet"] = args.fleet
    return fleet_rec, pusher


def add_tune_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--tune", choices=("off", "cached", "sweep"), default="off",
                    help="kernel autotuning (tune/): cached installs winners already in the "
                         "profile store (e.g. fleet-pulled) at no sweep cost; sweep measures "
                         "missing design-space points first")
    ap.add_argument("--tune-ops", default=None, metavar="OP[,OP]",
                    help="restrict --tune sweep to these ops")
    ap.add_argument("--tune-mode", choices=("real", "interpret", "synthetic"), default=None,
                    help="sweep measurement mode (default: real on a CUDA device, interpret "
                         "on the CPU; synthetic = model-only)")
    ap.add_argument("--tune-workers", type=int, default=0, metavar="N",
                    help="sweep worker processes (0 = in-process; real: 0 only)")


def check_tune_args(args: argparse.Namespace, ap: argparse.ArgumentParser) -> None:
    """``--tune`` needs ``--dispatch``; the mode defaults by ``--device``;
    a real sweep with workers is refused before anything touches a card."""
    if args.tune != "off" and args.dispatch == "off":
        # tune winners live in the dispatcher's profile store
        ap.error("--tune requires --dispatch (static|roofline|profiled)")
    if args.tune_mode is None:
        args.tune_mode = "real" if str(args.device).startswith("cuda") else "interpret"
    from repro_torch.tune.explore import check_sweep

    try:
        check_sweep(args.tune_mode, args.tune_workers)
    except ValueError as exc:
        ap.error(f"--tune-mode real --tune-workers {args.tune_workers}: {exc}")


def tune(args: argparse.Namespace, dispatcher, log: EventLog) -> dict | None:
    """``--tune``: after the fleet pull, before any step is built."""
    if args.tune == "off" or dispatcher is None:
        return None
    from repro_torch.tune import driver_tune

    return driver_tune(args.tune, dispatcher, log,
                       ops_filter=args.tune_ops.split(",") if args.tune_ops else None,
                       mode=args.tune_mode, workers=args.tune_workers)


def add_trace_args(ap: argparse.ArgumentParser) -> None:
    """The trace and metrics flags of both drivers (the JAX drivers')."""
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a trace session of this run")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="stream events durably as rotated JSONL segments (a crash loses at "
                         "most the open segment; recover with `python -m repro_torch.trace "
                         "compact DIR`)")
    ap.add_argument("--trace-rotate", type=int, default=2048, metavar="N",
                    help="events per streaming segment before rotation + fsync")
    ap.add_argument("--trace-rotate-keep", type=int, default=None, metavar="N",
                    help="keep only the newest N closed segments")
    ap.add_argument("--trace-capacity", type=int, default=DEFAULT_CAPACITY,
                    help="trace ring capacity (events); evictions are counted")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve Prometheus /metrics on this port while the run is live "
                         "(0 picks a free port)")
    ap.add_argument("--trace-overhead-budget-pct", type=float, default=None, metavar="PCT",
                    help="adaptive tracing: duty-cycle span capture to keep the measured "
                         "record-path overhead under PCT%% (0 = measure, never shed; "
                         f"default {DEFAULT_BUDGET_PCT:g} when --metrics-port is given); "
                         "also the device-capture budget of --torch-profile")
    ap.add_argument("--ready-file", default=None, metavar="PATH",
                    help="announce the /metrics URL here once the listener is up "
                         "(requires --metrics-port)")
    ap.add_argument("--metrics-linger-s", type=float, default=0.0, metavar="S",
                    help="keep the /metrics listener up S seconds after the run")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="live device profiling: duty-cycled torch.profiler windows under "
                         "DIR, merged into the live trace under the overhead budget")
    ap.add_argument("--torch-profile-backend", default="auto", choices=BACKENDS,
                    help="torch.profiler (auto, torch) or the synthetic stub (CPU only)")
    ap.add_argument("--torch-profile-period-s", type=float, default=DEFAULT_PERIOD_S,
                    metavar="S", help="device capture window period (on + off)")


class TracePlane:
    """The drivers' trace and metrics plane, from the flags of
    :func:`add_trace_args`: the collector (always), the metrics plane
    (always), the adaptive controller and the scrape listener, the live
    device profiler and the streaming session (each when asked for)."""

    def __init__(self, args: argparse.Namespace, ap: argparse.ArgumentParser,
                 device: torch.device) -> None:
        if args.ready_file and args.metrics_port is None:
            ap.error("--ready-file requires --metrics-port (nothing to announce)")
        self.args = args
        self.traced = bool(args.trace_out or args.trace_dir or args.torch_profile
                           or args.metrics_port is not None
                           or args.trace_overhead_budget_pct is not None)
        self.log = TraceCollector(capacity=args.trace_capacity)
        # always attached: exact counts even while capture is shed
        self.plane = MetricsPlane(self.log)
        budget = (DEFAULT_BUDGET_PCT if args.trace_overhead_budget_pct is None
                  else args.trace_overhead_budget_pct)
        self.controller = self.server = self.prof = self.stream = None
        if args.metrics_port is not None or args.trace_overhead_budget_pct is not None:
            self.controller = AdaptiveController(self.log, self.plane.registry,
                                                 budget_pct=budget)
        if args.metrics_port is not None:
            self.server = serve_metrics(self.plane, port=args.metrics_port)
            print(f"metrics: {self.server.url}/metrics", file=sys.stderr)
            if args.ready_file:
                write_ready_file(args.ready_file, self.server.url)
        if args.torch_profile:
            self.prof = LiveDeviceProfiler(
                self.log, args.torch_profile, device=device, registry=self.plane.registry,
                backend=args.torch_profile_backend, budget_pct=budget,
                period_s=args.torch_profile_period_s)

    def open_stream(self, meta: dict, dispatcher, pusher=None) -> None:
        """The ``--trace-dir`` session, attached to the log (a fleet pusher
        pushes at each rotation)."""
        if not self.args.trace_dir:
            return
        self.stream = StreamingSession(
            self.args.trace_dir, rotate_events=self.args.trace_rotate,
            max_segments=self.args.trace_rotate_keep, meta=meta,
            store_provider=(lambda: dispatcher.store) if dispatcher is not None else None,
            fleet_push=pusher.push if pusher is not None else None,
            metrics_provider=self.plane.snapshot,
            device_provider=self.prof.snapshot if self.prof is not None else None,
        ).attach(self.log)

    def start(self) -> None:
        """Start the controller and the device profiler (after the stream is
        attached: the stream then holds every event of the session)."""
        if self.controller is not None:
            self.controller.start()
        if self.prof is not None:
            self.prof.start()

    def stop_capture(self) -> None:
        """Close the last device window (raises if capture failed on the card)."""
        if self.prof is not None:
            self.prof.stop()

    def record(self, dispatcher, meta: dict) -> dict:
        """The JSON line's trace fields (none for an untraced run); closes the
        stream and writes ``--trace-out``."""
        out: dict = {}
        if self.controller is not None:
            self.controller.stop()  # the final overhead reading lands in the gauges
            out["trace_controller"] = self.controller.snapshot()
        if self.prof is not None:
            out["device_capture"] = meta["device_capture"] = self.prof.snapshot()
        if not self.traced:
            return out
        out["metrics"] = self.plane.summary()
        stats = out["trace"] = self.log.stats()  # resolves spans: once
        if self.stream is not None:
            out["trace_dir"] = self.stream.close(stats=stats)
        if self.args.trace_out:
            sess = Session.capture(self.log, dispatcher=dispatcher,
                                   meta={**meta, "metrics": self.plane.snapshot(),
                                         "drops": self.log.drop_counters()},
                                   collector_stats=stats)
            out["trace_out"] = sess.save(self.args.trace_out)
        return out

    def close(self) -> None:
        """After the JSON line: linger for scrapers, then stop the listener."""
        if self.server is not None:
            if self.args.metrics_linger_s > 0:
                time.sleep(self.args.metrics_linger_s)
            self.server.stop()


def main(argv: list[str] | None = None) -> dict:
    return run(argv)[0]


def run(argv: list[str] | None = None) -> tuple[dict, dict[int, list[int]]]:
    """:func:`main`, also returning every request's tokens by request id."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch versions")
    add_dispatch_args(ap, "prefill and decode")
    add_fleet_args(ap)
    add_tune_args(ap)
    add_trace_args(ap)
    args = ap.parse_args(argv)
    if args.fleet and args.dispatch == "off":
        # a fleet-less run would silently neither warm-start nor push
        ap.error("--fleet requires --dispatch (static|roofline|profiled)")
    check_tune_args(args, ap)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = lm.init_params(cfg, args.seed, device)
    trace = TracePlane(args, ap, device)
    log = trace.log
    dispatcher, aged = make_dispatcher(args, device, log)
    run_meta = {"driver": "serve", "arch": cfg.name, "requests": args.requests}
    fleet_rec, pusher = warm_start(args, dispatcher, run_meta)
    # after the fleet pull (pulled config points make sweep points warm: a
    # fed fleet means sweep_points == 0) and before the engine captures its
    # steps; sweep samples land in the dispatcher's store, so the pusher
    # delta-pushes tuned winners like any other measurement
    tune_rec = tune(args, dispatcher, log)
    trace.open_stream(run_meta, dispatcher, pusher)
    eng = Engine(
        cfg, params,
        ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                    temperature=args.temperature, seed=args.seed),
        log=log, dispatcher=dispatcher, metrics=trace.plane.registry,
    )
    rng = np.random.default_rng(args.seed)
    reset_launches()
    trace.start()
    t0 = time.time()
    with log.lifecycle("serve_run", {"arch": cfg.name, "requests": args.requests}):
        for _ in range(args.requests):
            eng.submit(rng.integers(0, cfg.vocab_size, args.prompt_len).tolist(),
                       max_new=args.max_new)
        results = eng.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    trace.stop_capture()
    total_new = sum(len(v) for v in results.values())
    durations = log.durations("prefill")
    rec = {
        "arch": cfg.name,
        "requests": len(results),
        "generated_tokens": total_new,
        "tokens_per_s": round(total_new / wall, 1),
        "mean_prefill_ms": round(1e3 * float(np.mean(durations)), 2) if durations else None,
        "wall_s": round(wall, 2),
        "sample": results[min(results)][:8],
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "kernels": launch_counts(),
        **dispatch_record(args, dispatcher, aged, log),
    }
    if tune_rec is not None:
        rec["tune"] = tune_rec
    rec.update(trace.record(dispatcher, run_meta))
    if pusher is not None:
        final = pusher.push()  # the rest of the delta (none if a rotation sent it)
        fleet_rec["push"] = {"pushed_samples": pusher.pushed_samples}
        if "error" in final:
            fleet_rec["push"]["error"] = final["error"]
        rec["fleet"] = fleet_rec
    print(json.dumps(rec), flush=True)
    trace.close()
    return rec, results


if __name__ == "__main__":
    main()
