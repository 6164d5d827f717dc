"""Serving driver: continuous-batching engine over synthetic requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --prompt-len 512 --max-seq 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large --reduced --device cpu

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
width) must be a multiple of it.  Full-depth jamba-1.5-large (796 GB in bf16) does not fit one card.  Dispatch, trace, fleet, metrics
and tune flags arrive with ROADMAP items M7, M8, M11 and M12.
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
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, ServeConfig


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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = lm.init_params(cfg, args.seed, device)
    log = EventLog()
    eng = Engine(
        cfg, params,
        ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                    temperature=args.temperature, seed=args.seed),
        log=log,
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
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
