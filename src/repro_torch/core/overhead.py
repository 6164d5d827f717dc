"""Instrumentation-overhead harness: the hyperfine methodology of the paper's
Table I and Fig. 2, counterpart of ``repro/core/overhead.py``.

``hyperfine`` runs N warm-up and M measured calls and reports mean,
stddev, median, min and max wall time with the process's user and system
CPU time over the measured calls (``getrusage``).  A call whose result is
on the card ends in ``torch.cuda.synchronize()``, so a sample is the time
from the call to its last kernel's end.  On the card the host issues the
kernels: user time is Python, the dispatcher and launches, and system time
is what the operating system does for the process, the split the paper's
Fig. 2 reads.  A trap's sync with the card spins in user space under CUDA's
default scheduling, so it shows as user time, not as system time.

Beside the harness, the port's counterparts of the JAX package's
``benchmarks/overhead_table1.py`` (``bench_microbench``,
``bench_model_step``) and ``benchmarks/breakdown_fig2.py``
(``breakdown_fig2``, ``fig2_table``).  The arms are:

* ``baseline``: the uninstrumented call;
* ``usdt``: static tracepoints in tape mode (``core/tracepoints.py``): a
  few 0-dim ops on the card, the tape an extra output;
* ``uprobes``: ``core/uprobes.inject_probes`` in callback mode with a
  matcher that hits once a call (the JAX harness's ``by_primitive("scan")``
  on the microbench): every call runs under the dispatch mode and reads
  its probe's value to the host.

On the card ``bench_microbench`` also times ``baseline`` and ``usdt`` as
CUDA graph replays (``baseline_graph``, ``usdt_graph``: compiled steps,
``serving/compiled.py``, whose warm-up calls run eagerly and capture); the
uprobes arm cannot be captured, since its trap syncs.  The JAX harness's record-path
and device-capture benchmarks need ``trace/`` and ``metrics/`` and wait for
them (ROADMAP M11).
"""
from __future__ import annotations

import dataclasses
import math
import resource
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import tracepoints as tp
from repro_torch.core import uprobes
from repro_torch.core.events import EventLog
from repro_torch.serving.compiled import Graphs


@dataclasses.dataclass(frozen=True)
class TimingStats:
    label: str
    runs: int
    mean_ms: float
    stddev_ms: float
    median_ms: float
    min_ms: float
    max_ms: float
    user_s: float  # user CPU time over the measured calls
    system_s: float  # system CPU time over the measured calls

    def row(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def overhead_vs(self, base: "TimingStats") -> float:
        """Relative mean wall-time overhead (the paper's Table I column)."""
        return self.mean_ms / base.mean_ms - 1.0


def stats_from_samples(
    label: str,
    samples_ms: list[float],
    *,
    user_s: float = 0.0,
    system_s: float = 0.0,
) -> TimingStats:
    """Fold raw wall-time samples (ms) into a :class:`TimingStats` row."""
    s = sorted(samples_ms)
    n = len(s)
    if n == 0:
        raise ValueError("stats_from_samples needs at least one sample")
    mean = sum(s) / n
    var = sum((x - mean) ** 2 for x in s) / max(n - 1, 1)
    median = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    return TimingStats(label=label, runs=n, mean_ms=mean, stddev_ms=math.sqrt(var),
                       median_ms=median, min_ms=s[0], max_ms=s[-1], user_s=user_s,
                       system_s=system_s)


def _on_card(out: Any) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(out))


def hyperfine(
    fn: Callable[[], Any],
    *,
    label: str = "",
    warmup: int = 100,
    runs: int = 1000,
) -> TimingStats:
    """Benchmark ``fn`` (the hyperfine protocol: 100 warm-up + 1000
    measured calls), each call waited for to its end."""

    def once():
        out = fn()
        if _on_card(out):
            torch.cuda.synchronize()

    for _ in range(warmup):
        once()
    samples: list[float] = []
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    for _ in range(runs):
        t0 = time.perf_counter()
        once()
        samples.append((time.perf_counter() - t0) * 1e3)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    return stats_from_samples(label, samples, user_s=ru1.ru_utime - ru0.ru_utime,
                              system_s=ru1.ru_stime - ru0.ru_stime)


def table(rows: list[TimingStats], baseline: str = "baseline") -> str:
    """Render the Table-I-style report (+ Fig-2 sys/user columns)."""
    base = next((r for r in rows if r.label == baseline), rows[0])
    header = (
        f"{'type':<12} {'mean(ms)':>9} {'stddev':>8} {'median':>8} {'min':>8} "
        f"{'max':>8} {'overhead':>9} {'user(s)':>8} {'sys(s)':>8}"
    )
    lines = [header, "-" * len(header)]
    for r in rows:
        ov = r.overhead_vs(base)
        lines.append(
            f"{r.label:<12} {r.mean_ms:>9.3f} {r.stddev_ms:>8.3f} {r.median_ms:>8.3f} "
            f"{r.min_ms:>8.3f} {r.max_ms:>8.3f} {ov:>8.1%} {r.user_s:>8.2f} {r.system_s:>8.2f}"
        )
    return "\n".join(lines)


def run_arms(arms: list[tuple[str, Callable[[], Any]]], *, warmup: int, runs: int,
             rounds: int = 1) -> list[TimingStats]:
    """``hyperfine`` over each (label, fn) arm in turn, ``rounds`` times
    over (a label gains ``#2``, ``#3`` in the later rounds): a drift of the
    host between arms shows as a difference between rounds."""
    return [hyperfine(fn, label=label if r == 0 else f"{label}#{r + 1}", warmup=warmup,
                      runs=runs) for r in range(rounds) for label, fn in arms]


# ---------------------------------------------------------------------------
# Table I and Fig. 2
# ---------------------------------------------------------------------------


def _taped(fn: Callable[..., Any]) -> Callable[..., Any]:
    """``fn`` with tape-mode tracepoints on for each call: ``(out, tape)``."""
    collected = tp.collect(fn)

    def call(*args: Any) -> Any:
        with tp.enable("tape"):
            return collected(*args)

    return call


def bench_microbench(warmup: int = 100, runs: int = 1000, device: str | torch.device = "cuda",
                     rounds: int = 1) -> list[TimingStats]:
    """Table I on the paper's workload (``configs/microbench.py``): baseline,
    usdt and uprobes eagerly, and on the card baseline and usdt again as
    CUDA graph replays."""
    from repro_torch.configs import microbench

    dev = resolve_device(device)
    x = microbench.make_inputs(dev)
    work = microbench.approx_sqrt_workload
    log = EventLog(maxlen=1 << 16)
    probed = uprobes.inject_probes(work, uprobes.by_primitive("clamp_min"), mode="callback",
                                   log=log)
    tape_fn = _taped(work)
    arms = [("baseline", lambda: work(x)), ("usdt", lambda: tape_fn(x)),
            ("uprobes", lambda: probed(x))]
    if dev.type == "cuda":  # compiled steps: eager, captured, then replays
        graphs = Graphs(dev)
        arms += [("baseline_graph", lambda s=graphs.step(work): s(x)),
                 ("usdt_graph", lambda s=graphs.step(tape_fn): s(x))]
    return run_arms(arms, warmup=warmup, runs=runs, rounds=rounds)


def model_step_inputs(cfg: ModelConfig, batch: int, seq: int, device: torch.device,
                      seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Tokens drawn from a numpy seed and their next-token labels."""
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))
    tokens = torch.from_numpy(tokens).to(device)
    return tokens, torch.roll(tokens, -1, 1)


def bench_model_step(cfg: Optional[ModelConfig] = None, params: Optional[dict] = None, *,
                     batch: int = 8, seq: int = 128, warmup: int = 10, runs: int = 60,
                     device: str | torch.device = "cuda", rounds: int = 1) -> list[TimingStats]:
    """The same three arms on the loss forward of a model (full-width,
    full-depth qwen2-0.5b unless ``cfg`` says otherwise; random weights
    from seed 0 unless ``params`` are given) at tokens (batch, seq), where
    the per-hit trap cost amortises.  The uprobes arm's matcher hits the
    token embedding, once a call."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    dev = resolve_device(device)
    cfg = cfg or get_config("qwen2-0.5b")
    if params is None:
        params = lm.init_params(cfg, 0, dev)
    tokens, labels = model_step_inputs(cfg, batch, seq, dev)

    def loss(p: dict, t: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return lm.loss_fn(p, cfg, t, lab)[0]

    log = EventLog(maxlen=1 << 16)
    probed = uprobes.inject_probes(loss, uprobes.by_primitive("embedding"), mode="callback",
                                   log=log)
    tape_fn = _taped(loss)
    arms = [(label, lambda f=fn: f(params, tokens, labels))
            for label, fn in (("baseline", loss), ("usdt", tape_fn), ("uprobes", probed))]
    return run_arms(arms, warmup=warmup, runs=runs, rounds=rounds)


def breakdown_fig2(rows: list[TimingStats], baseline: str = "baseline") -> list[dict[str, Any]]:
    """Fig. 2: each arm's user and system CPU time over its measured calls,
    and their differences from the baseline row's."""
    base = next((r for r in rows if r.label == baseline), rows[0])
    return [{"label": r.label, "user_s": r.user_s, "system_s": r.system_s,
             "delta_user_s": r.user_s - base.user_s,
             "delta_system_s": r.system_s - base.system_s} for r in rows]


def fig2_table(rows: list[TimingStats], baseline: str = "baseline") -> str:
    lines = [f"{'type':<14} {'user(s)':>8} {'sys(s)':>8} {'Δuser':>8} {'Δsys':>8}"]
    for r in breakdown_fig2(rows, baseline):
        lines.append(f"{r['label']:<14} {r['user_s']:>8.2f} {r['system_s']:>8.2f} "
                     f"{r['delta_user_s']:>+8.2f} {r['delta_system_s']:>+8.2f}")
    return "\n".join(lines)
