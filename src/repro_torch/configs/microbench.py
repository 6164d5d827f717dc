"""The paper's own workload: the counterpart of ``repro/configs/microbench.py``.

Section III: "a lightweight yet sufficiently complex C program that computes
approximate square roots of integers from 1 to 100", the serial target of
the instrumentation-overhead study (100 warm-up runs + 1000 measured runs,
hyperfine; ``core/overhead.py``).

Here it is Newton-iteration approximate sqrt of 1..100 repeated N_REPEAT
times, with static tracepoints at the program points the paper
instruments (entry and exit).  The JAX package's sizes carry over, so the
two programs compute the same values; the iterations run as a Python loop
of elementwise ops (``lax.scan`` in JAX), 3 kernels an iteration on the
card.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import tracepoints as tp

N_VALUES = 100
N_REPEAT = 2048
NEWTON_ITERS = 24


def approx_sqrt_workload(x: torch.Tensor) -> torch.Tensor:
    """Newton-iteration approximate sqrt, instrumented with static
    tracepoints; disabled, they dispatch no op."""
    tp.point("workload.enter", float(x.shape[0]))
    guess = torch.clamp_min(x * 0.5, 1.0)
    for _ in range(NEWTON_ITERS):
        guess = 0.5 * (guess + x / guess)
    tp.point("workload.exit", lambda: guess[0])
    return guess


def make_inputs(device: str | torch.device = "cuda") -> torch.Tensor:
    """1..N_VALUES in f32, tiled N_REPEAT times, on ``device``."""
    one = torch.arange(1, N_VALUES + 1, dtype=torch.float32)
    return one.repeat(N_REPEAT).to(resolve_device(device))
