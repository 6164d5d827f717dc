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
``profile_out``, as the JAX driver's.  Not here yet: the trace and
metrics flags (ROADMAP M11), ``--fleet`` and ``--tune`` (M12).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core.events import EventLog
from repro_torch.dispatch import DispatchConfig, Dispatcher, host_registry
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.trace.session import age_out_profiles, load_profile_stores


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
                    help="warm-start dispatch profiles from a --profile-out file "
                         "(repeatable; merged)")
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
        with open(args.profile_out, "w") as f:
            f.write(dispatcher.store.to_json())
        rec["profile_out"] = args.profile_out
    return rec


def main(argv: list[str] | None = None) -> dict:
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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = lm.init_params(cfg, args.seed, device)
    log = EventLog()
    dispatcher, aged = make_dispatcher(args, device, log)
    eng = Engine(
        cfg, params,
        ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                    temperature=args.temperature, seed=args.seed),
        log=log, dispatcher=dispatcher,
    )
    rng = np.random.default_rng(args.seed)
    reset_launches()
    t0 = time.time()
    with log.lifecycle("serve_run", {"arch": cfg.name, "requests": args.requests}):
        for _ in range(args.requests):
            eng.submit(rng.integers(0, cfg.vocab_size, args.prompt_len).tolist(),
                       max_new=args.max_new)
        results = eng.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
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
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
