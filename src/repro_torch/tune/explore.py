"""The Explorer: design-space sweeps feeding the ProfileStore.

Counterpart of ``repro/tune/explore.py``.  A sweep enumerates candidate
config points per kernel (:mod:`repro_torch.tune.space`), cuts the
obviously bad ones with the roofline model (:mod:`repro_torch.tune.prune`),
then times the survivors with per-point warmup / repeat control.  Every
measurement lands in the :class:`~repro_torch.dispatch.profiles.ProfileStore`
as an ordinary sample under the point's ``(op, tier, sig, config)`` key, so
a driver-attached :class:`~repro_torch.fleet.client.FleetPusher`
delta-pushes tuned winners with no tuner-specific fleet plumbing, and a
later run's fleet pull makes every already-measured point *warm*, which the
Explorer skips (``--tune sweep`` on a warm-started run reports
``sweep_points == 0``).

Sweep modes:

* ``real``       each point on the card: CUDA events around each call, the
                 L2 flushed before it (``chip_smoke.time_ms``'s method),
                 after ``warmup`` calls.  Every point of a ``kernel`` space
                 is first held against the plain version at its workload
                 (relative tolerance 2e-2, bf16): a point that disagrees
                 gets no sample, so it can never win, and is recorded as a
                 ``tune`` event with ``failed: true``;
* ``interpret``  on the CPU, host clock: only ``plain`` spaces are
                 measured, and no ``kernel`` winner is published (the JAX
                 rule that a ``real`` sweep off the TPU drops its Pallas
                 spaces);
* ``synthetic``  deterministic analytic pseudo-measurements, no torch
                 import: CI smoke and the determinism tests.

``workers > 0`` runs points in spawned processes, for ``interpret`` and
``synthetic`` only: processes that time each other on one card measure
nothing, so ``real`` with workers is refused (ROADMAP R16; the JAX package
allows it).

The whole sweep is one ``tune_run`` lifecycle span; each pruned, measured
or failed point is a ``tune`` event under it, and each per-space winner a
``tune`` event with ``winner: true``: the metrics sink derives
``repro_tune_points_total{op,pruned}`` and ``repro_tune_best_speedup{op}``
from exactly these.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Mapping, Optional

from repro_torch.core.events import GLOBAL_LOG, EventLog
from repro_torch.dispatch.profiles import ProfileStore, decode_config, encode_config
from repro_torch.hw.specs import ChipSpec, default_chip
from repro_torch.tune.prune import DEFAULT_PRUNE_RATIO, RooflinePruner
from repro_torch.tune.space import KernelSpace, default_spaces

MODES = ("real", "interpret", "synthetic")
CHECK_TOL = 2e-2  # a kernel point against the plain version, relative to max |plain|, bf16


def check_sweep(mode: str, workers: int) -> None:
    """Refuse ``real`` with workers: it times on the card, and processes
    that time each other on one card measure nothing (ROADMAP R16)."""
    if mode == "real" and workers > 0:
        raise ValueError("a real sweep times points on the card one at a time: "
                         f"workers must be 0, got {workers} (ROADMAP R16)")


@dataclasses.dataclass(frozen=True)
class SweepSettings:
    mode: str = "interpret"
    warmup: int = 1
    repeats: int = 3
    workers: int = 0  # 0 = in-process (deterministic single stream)
    prune_ratio: float = DEFAULT_PRUNE_RATIO

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        check_sweep(self.mode, self.workers)


# ---------------------------------------------------------------------------
# Measurement (runs in-process or inside spawn workers; torch imported here)
# ---------------------------------------------------------------------------

_INPUTS: dict[tuple[str, str], tuple[list, Any]] = {}  # (space, device): (args, plain out)


def _arr(shape: tuple[int, ...], seed: int, dtype: str, device):
    """Seeded uniform inputs in [-0.5, 0.5), as the JAX package's ``_arr``
    spans, drawn on ``device`` in ``dtype``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(shape, generator=gen, device=device, dtype=torch.float32) - 0.5
    return x.to(getattr(torch, dtype))


def _inputs(space: KernelSpace, device) -> list:
    """The workload's arguments, as the JAX package's runners make them:
    every slot of the decode cache live, decays in (0.275, 0.725) for RWKV6,
    positive steps and negative A for Mamba."""
    import torch

    args = [_arr(shape, i + 1, dtype, device) for i, (dtype, shape) in enumerate(space.inputs)]
    if space.op == "decode_attention":
        B, S = space.workload["B"], space.workload["S"]
        args[3] = torch.arange(S, dtype=torch.int32, device=device).expand(B, S).contiguous()
        args[4] = torch.full((B,), S - 1, dtype=torch.int32, device=device)
    elif space.op == "rwkv6_scan":
        args[3] = 0.5 + 0.45 * args[3]
    elif space.op == "mamba_scan":
        args[1] = (0.01 + 0.1 * args[1].float().abs()).to(args[1].dtype)
        args[2] = -0.1 - args[2].abs()
    return args


def _call(space: KernelSpace, impl: str, args: list) -> Callable[[], Any]:
    from repro_torch.kernels import ops

    fn = getattr(ops, "gmm" if space.op == "moe_gmm" else space.op)
    return lambda: fn(*args, impl=impl)


def _rel_err(got, want) -> float:
    """Max |got - want| over max |want|, over every output (inf if not finite)."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not bool(torch.isfinite(g).all()):
            return math.inf
        worst = max(worst, float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    return worst


def _flush_buffer(device):
    import torch

    key = ("flush", str(device))
    if key not in _INPUTS:
        _INPUTS[key] = ([torch.empty(64 << 20, dtype=torch.uint8, device=device)], None)
    return _INPUTS[key][0][0]


def _time_card(thunk: Callable[[], Any], warmup: int, repeats: int, device) -> list[float]:
    """Seconds of each of ``repeats`` calls between CUDA events, the L2
    flushed before each; a sleep kernel holds the card while the host
    queues them, so the events bracket device work only."""
    import torch

    flush = _flush_buffer(device)
    for _ in range(max(warmup, 1)):  # the first call builds and opts in
        thunk()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(max(repeats, 1))]
    torch.cuda.synchronize(device)
    torch.cuda._sleep(50_000_000)
    for s, e in evs:
        flush.zero_()
        s.record()
        thunk()
        e.record()
    torch.cuda.synchronize(device)
    return [s.elapsed_time(e) / 1e3 for s, e in evs]


def _time_host(thunk: Callable[[], Any], warmup: int, repeats: int) -> list[float]:
    for _ in range(max(warmup, 0)):
        thunk()
    out: list[float] = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        thunk()
        out.append(time.perf_counter() - t0)
    return out


def _measure(space: KernelSpace, chip: ChipSpec, params: Mapping[str, int], mode: str,
             warmup: int, repeats: int) -> tuple[list[float], Optional[dict]]:
    """Per-rep seconds of one config point (synthetic: analytic, exact) and,
    for a ``real`` point of a ``kernel`` space, its check against the plain
    version: ``{"rel_err", "tol", "ok"}`` (no reps when it fails)."""
    if mode == "synthetic":
        return [space.synthetic_s(params, chip)] * max(repeats, 1), None
    import torch

    from repro_torch.kernels import ops

    device = torch.device("cuda" if mode == "real" else "cpu")
    if mode == "real" and not torch.cuda.is_available():
        raise RuntimeError("a real sweep times points on the card, and "
                           "torch.cuda.is_available() is False: use interpret or synthetic")
    key = (space.key, str(device))
    if key not in _INPUTS:
        args = _inputs(space, device)
        want = None
        if space.backend == "kernel" and mode == "real":
            with torch.no_grad():
                want = _call(space, "plain", args)()
        _INPUTS[key] = (args, want)
    args, want = _INPUTS[key]
    # the override table must be live while the point runs
    with torch.no_grad(), ops.tuned_scope({space.op: {space.backend: dict(params)}}):
        thunk = _call(space, space.impl, args)
        check = None
        if want is not None:
            err = _rel_err(thunk(), want)
            check = {"rel_err": err, "tol": CHECK_TOL, "ok": err <= CHECK_TOL}
            if not check["ok"]:
                return [], check
        if mode == "real":
            return _time_card(thunk, warmup, repeats, device), check
        return _time_host(thunk, warmup, repeats), check


def release_inputs() -> None:
    """Drop the cached workloads (the card's memory comes back)."""
    _INPUTS.clear()


def _worker_measure(task: tuple) -> tuple[str, str, list[float], Optional[dict]]:
    """Pool entry point (module-level: spawn workers pickle by reference;
    the space and the chip travel in the task)."""
    space, chip, params, mode, warmup, repeats = task
    reps, check = _measure(space, chip, params, mode, warmup, repeats)
    return space.key, encode_config(params), reps, check


def card_ptxas() -> dict[str, dict[str, int]]:
    """ptxas' registers and spills of the kernel instances a space's points
    launch (K4's ``gmm_mma<MT>``), from the libraries built on the card."""
    from repro_torch.kernels import moe_gmm

    return {f"gmm_mma<{mt}>": rep for mt, rep in moe_gmm.ptxas_report().items()}


# ---------------------------------------------------------------------------
# Explorer
# ---------------------------------------------------------------------------


class Explorer:
    """Sweep design spaces, feed the store, report winners."""

    def __init__(
        self,
        store: ProfileStore,
        *,
        chip: Optional[ChipSpec] = None,
        spaces: Optional[dict[str, KernelSpace]] = None,
        log: Optional[EventLog] = None,
        settings: Optional[SweepSettings] = None,
        ptxas: Optional[Mapping[str, Mapping[str, int]]] = None,
    ) -> None:
        self.store = store
        self.chip = chip or default_chip()
        self.spaces = spaces if spaces is not None else default_spaces()
        self.log = GLOBAL_LOG if log is None else log
        self.settings = settings or SweepSettings()
        self.ptxas = ptxas
        # sweep samples carry the same provenance stamps dispatcher samples
        # do, so age_out treats tuned points identically
        from repro_torch.trace.session import git_sha

        self.store.set_stamp(git_sha=git_sha(), chip=self.chip.name)

    def _selected(self, ops_filter: Optional[list[str]]) -> list[KernelSpace]:
        spaces = [
            s for s in self.spaces.values()
            if ops_filter is None or s.op in ops_filter
        ]
        if self.settings.mode == "interpret":
            # the kernels run only on the card: a CPU sweep must not publish
            # plain-version timings as kernel winners
            spaces = [s for s in spaces if s.backend != "kernel"]
        return spaces

    def sweep(self, ops_filter: Optional[list[str]] = None) -> dict[str, Any]:
        st = self.settings
        # a point is only usable by the dispatcher once warm; never measure
        # fewer reps than the warmth threshold
        repeats = max(st.repeats, self.store.min_samples)
        spaces = self._selected(ops_filter)
        pruner = RooflinePruner(self.chip, st.prune_ratio)
        ptxas = self.ptxas
        if ptxas is None and st.mode == "real" and any(s.backend == "kernel" for s in spaces):
            ptxas = card_ptxas()

        summary: dict[str, Any] = {
            "mode": st.mode, "workers": st.workers, "prune_ratio": st.prune_ratio,
            "spaces": len(spaces), "points_total": 0, "pruned": 0,
            "skipped_warm": 0, "sweep_points": 0, "winners": {},
        }
        if st.mode == "real":
            summary["failed"] = 0
        tasks: list[tuple] = []
        by_key = {s.key: s for s in spaces}
        with self.log.lifecycle("tune_run", {
            "mode": st.mode, "spaces": sorted(by_key), "workers": st.workers,
        }):
            for space in spaces:
                points = space.points(self.chip, ptxas)
                kept, cut = pruner.prune(space, points)
                summary["points_total"] += len(points)
                summary["pruned"] += len(cut)
                for c in cut:
                    self.log.record("tune", space.op, {
                        "op": space.op, "backend": space.backend,
                        "sig": space.sig, "config": c.point.config,
                        "pruned": True, "predicted_s": c.predicted_s,
                        "bound_s": c.bound_s,
                    })
                for p in kept:
                    if self.store.warm(space.op, space.backend, space.sig, p.config):
                        summary["skipped_warm"] += 1
                    else:
                        tasks.append((space, self.chip, dict(p.params), st.mode,
                                      st.warmup, repeats))
            summary["sweep_points"] = len(tasks)

            if st.workers > 0 and len(tasks) > 1:
                import multiprocessing

                ctx = multiprocessing.get_context("spawn")
                with ctx.Pool(min(st.workers, len(tasks))) as pool:
                    results = pool.map(_worker_measure, tasks)
            else:
                results = [_worker_measure(t) for t in tasks]
                release_inputs()

            # record in sorted (space, config) order: the store's content must
            # not depend on worker scheduling
            for space_key, config, reps, check in sorted(results, key=lambda r: (r[0], r[1])):
                space = by_key[space_key]
                if check is not None and not check["ok"]:
                    summary["failed"] += 1
                    self.log.record("tune", space.op, {
                        "op": space.op, "backend": space.backend, "sig": space.sig,
                        "config": config, "pruned": False, "failed": True, **check,
                    })
                    continue
                for s in reps:
                    self.store.record(space.op, space.backend, space.sig, s,
                                      config=config)
                payload = {
                    "op": space.op, "backend": space.backend, "sig": space.sig,
                    "config": config, "pruned": False, "reps": len(reps),
                    "min_s": min(reps),
                }
                if check is not None:
                    payload["rel_err"] = check["rel_err"]
                self.log.record("tune", space.op, payload)

            for space in spaces:
                win = self._winner(space)
                if win is not None:
                    summary["winners"][space.key] = win
                    self.log.record("tune", space.op, {"winner": True, **win})
        return summary

    def _winner(self, space: KernelSpace) -> Optional[dict[str, Any]]:
        best = self.store.best_config(space.op, space.backend, space.sig)
        if best is None:
            return None
        config, best_s = best
        default_e = self.store.entry(space.op, space.backend, space.sig,
                                     space.default_config)
        default_s = default_e.min_s if default_e and default_e.count else None
        win: dict[str, Any] = {
            "op": space.op, "backend": space.backend, "sig": space.sig,
            "config": config, "best_s": best_s,
        }
        if default_s is not None:
            win["default_s"] = default_s
            # >= 1.0 by construction: the default point is always enumerated,
            # never pruned, and competes in the same argmin
            win["speedup"] = default_s / best_s if best_s > 0 else 1.0
        return win


# ---------------------------------------------------------------------------
# Winner application (the consumer side)
# ---------------------------------------------------------------------------


def winners_from_store(
    store: ProfileStore, spaces: Optional[dict[str, KernelSpace]] = None
) -> tuple[dict[str, dict[str, dict[str, Any]]], dict[str, dict[str, Any]]]:
    """Argmin config per space from whatever the store holds (this run's
    sweep, a ``--profile-in`` file, or a fleet pull).

    Returns ``(table, details)``: ``table`` is the ``kernels.ops`` override
    table ``{op: {tier: params}}`` (empty-config winners — the untuned
    bucket won — contribute nothing), ``details`` records per-space
    provenance for driver JSON.
    """
    spaces = spaces if spaces is not None else default_spaces()
    table: dict[str, dict[str, dict[str, Any]]] = {}
    details: dict[str, dict[str, Any]] = {}
    for space in spaces.values():
        best = store.best_config(space.op, space.backend, space.sig)
        if best is None:
            continue
        config, best_s = best
        details[space.key] = {"config": config, "best_s": best_s}
        if not config:
            continue  # legacy/default point won: nothing to override
        table.setdefault(space.op, {})[space.impl] = decode_config(config)
    return table, details


def apply_winners(table: Mapping[str, Mapping[str, Mapping[str, Any]]]) -> int:
    """Install winners into ``kernels.ops`` (before any step is captured).

    Returns the number of (op, tier) overrides applied.  Imports ops lazily:
    torch-free callers (CLI summaries) can compute winners without applying.
    """
    from repro_torch.kernels import ops

    ops.set_tuned_configs(table)
    return sum(len(impls) for impls in table.values())


def driver_tune(
    policy: str,
    dispatcher: Any,
    log: EventLog,
    *,
    ops_filter: Optional[list[str]] = None,
    mode: str = "interpret",
    workers: int = 0,
    warmup: int = 1,
    repeats: int = 3,
    prune_ratio: float = DEFAULT_PRUNE_RATIO,
) -> dict[str, Any]:
    """The ``--tune {cached,sweep}`` wiring shared by both launch drivers.

    Call after the fleet warm-start (pulled config points make sweep points
    warm — a fed fleet means ``sweep_points == 0``) and before the engine /
    train-step variants are built (winners must be installed before a step
    is captured: ``serving/compiled.py`` refuses a replay under other
    configs).  ``cached`` only applies winners already in the store;
    ``sweep`` measures what's missing first.  Sweep samples land in the
    dispatcher's own store, so the driver's FleetPusher delta-pushes tuned
    winners with no extra plumbing.
    """
    rec: dict[str, Any] = {"mode": policy, "sweep_points": 0, "pruned": 0}
    if policy == "sweep":
        explorer = Explorer(
            dispatcher.store, chip=dispatcher.chip, log=log,
            settings=SweepSettings(mode=mode, warmup=warmup, repeats=repeats,
                                   workers=workers, prune_ratio=prune_ratio),
        )
        summary = explorer.sweep(ops_filter)
        rec["sweep_points"] = summary["sweep_points"]
        rec["pruned"] = summary["pruned"]
        rec["skipped_warm"] = summary["skipped_warm"]
        rec["winners"] = summary["winners"]
        if "failed" in summary:
            rec["failed"] = summary["failed"]
    table, _ = winners_from_store(dispatcher.store)
    rec["applied"] = apply_winners(table)
    rec["configs"] = {
        op: {impl: encode_config(params) for impl, params in impls.items()}
        for op, impls in table.items()
    }
    return rec
