"""Training driver: a plain step loop over synthetic data.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced --device cpu

Counterpart of ``repro/launch/train.py``.  Weights are random, drawn from
``--seed`` on the device; batch ``i`` is ``SyntheticLM`` batch ``i`` (the
same arrays as the JAX driver's for the same seed).  The schedule is the
JAX driver's: warmup over max(10, steps // 10) steps, cosine decay over
``--steps``.  Prints one JSON line with ``arch``, ``steps``,
``first_loss``, ``last_loss``, ``tokens_per_s`` and ``wall_s`` (the JAX
driver's fields), plus ``device``, ``step_ms`` (the median step) and
``kernels``, the launch count of each Hopper kernel in the run (all 0 on
the CPU, where the plain versions run).

On the card attention and RMSNorm differentiate through their kernels
(K1 + K1b, K3 + K3b).  An arch whose path reaches the grouped matmul, the
Mamba scan or the RWKV6 scan (K4, K5, K6) has no backward kernel there yet:
the driver stops with the ROADMAP item that brings it (K4b, K5b, K6b).

Not here yet: ``--mesh`` (ROADMAP M13), ``--dispatch`` (M8), ``--tune`` /
``--fleet`` (M12), the trace and metrics flags (M11), the supervisor with
its restarts and ``--ckpt-*`` / ``--fail-at`` (M9c).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.training import optim
from repro_torch.training.step import TrainConfig, init_train_state, make_train_step


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tcfg = TrainConfig(
        opt=optim.AdamWConfig(peak_lr=args.lr, warmup_steps=max(10, args.steps // 10),
                              total_steps=args.steps),
        microbatches=args.microbatches,
    )
    state = init_train_state(cfg, tcfg, args.seed, device)
    step = make_train_step(cfg, tcfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed))

    reset_launches()
    losses, step_ms = [], []
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(i).items()}
        ts = time.perf_counter()
        try:
            state, metrics = step(state, batch)
        except RuntimeError as e:
            if "ROADMAP" not in str(e):
                raise
            raise SystemExit(f"{cfg.name} cannot train on {device} yet: {e}") from e
        losses.append(float(metrics["loss"]))  # waits for the step
        step_ms.append(1e3 * (time.perf_counter() - ts))
    wall = time.time() - t0
    rec = {
        "arch": cfg.name,
        "steps": args.steps,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "tokens_per_s": round(args.steps * args.batch * args.seq / wall, 1),
        "wall_s": round(wall, 2),
        "step_ms": round(statistics.median(step_ms), 2),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "kernels": launch_counts(),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
