"""Kernel autotuning CLI (counterpart of ``repro/tune/cli.py``).

  PYTHONPATH=src python -m repro_torch.tune spaces
  PYTHONPATH=src python -m repro_torch.tune sweep --mode synthetic --workers 4
  PYTHONPATH=src python -m repro_torch.tune sweep --mode interpret --ops rwkv6_scan \\
      --fleet fleet_store --out tuned.json
  PYTHONPATH=src python -m repro_torch.tune sweep --mode real     # on the card
  PYTHONPATH=src python -m repro_torch.tune show --profile-in tuned.json

``sweep`` enumerates + prunes + times the design spaces and records every
point into a ProfileStore; ``--fleet`` pulls matching profiles first (warm
points are skipped — a second sweep against a fed fleet measures nothing)
and delta-pushes the new samples when done, stamped with this checkout's
SHA and the card's name (``h100_sxm``).  ``show`` prints the measured
config points of each space from a profile artifact or a fleet pull.
``spaces`` lists the candidate grids and what the roofline pruner would
cut, and (``--json``) each grid point's launch: shared memory, threads,
instance, feasibility; on a machine with the built kernels also ptxas'
registers and spills of each instance (``--ptxas``).  ``real`` times on
the card; ``interpret`` runs the plain spaces on the CPU.  Nothing here
imports ``torch`` until a point is measured.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from repro_torch.dispatch.profiles import ProfileStore
from repro_torch.fleet.client import FleetClient, FleetError, FleetPusher
from repro_torch.tune.explore import MODES, Explorer, SweepSettings, winners_from_store
from repro_torch.tune.prune import DEFAULT_PRUNE_RATIO
from repro_torch.tune.space import NOT_SWEPT, default_spaces, space_report


def _env_key() -> tuple[str, str]:
    from repro_torch.hw.specs import default_chip
    from repro_torch.trace.session import git_sha

    return git_sha(), default_chip().name


def _load_store(args: argparse.Namespace) -> ProfileStore:
    store = ProfileStore(min_samples=2)
    if getattr(args, "profile_in", None):
        from repro_torch.trace.session import load_profile_store

        store.merge(load_profile_store(args.profile_in))
    return store


def _fleet_pull(store: ProfileStore, target: str,
                token: Optional[str]) -> tuple[Optional[FleetPusher], dict]:
    """Pull + merge matching fleet profiles, return a delta pusher.

    Mirrors the drivers' warm-start: stale-stamped entries are aged out
    *before* the merge, and the pusher baseline is taken after it, so a
    sweep only ever pushes its own new samples.
    """
    from repro_torch.trace.session import age_out_profiles

    sha, chip = _env_key()
    client = FleetClient(target, token=token)
    rec: dict = {"target": target}
    try:
        pulled = client.pull(sha, chip)
        rec["match"] = pulled["match"]
        if pulled["store"] is not None:
            pulled["store"].age_out(git_sha=sha, chip=chip)
            rec["merged_samples"] = store.merge(pulled["store"])
            age_out_profiles(store, chip)
    except FleetError as exc:
        rec["match"] = "error"
        rec["error"] = str(exc)
        print(f"fleet: pull failed, sweeping cold: {exc}", file=sys.stderr)
    return FleetPusher(client, store, sha, chip), rec


def cmd_sweep(args: argparse.Namespace) -> int:
    store = _load_store(args)
    pusher, fleet_rec = (None, None)
    if args.fleet:
        pusher, fleet_rec = _fleet_pull(store, args.fleet, args.token)
    settings = SweepSettings(
        mode=args.mode, warmup=args.warmup, repeats=args.repeats,
        workers=args.workers, prune_ratio=args.prune_ratio,
    )
    explorer = Explorer(store, settings=settings)
    summary = explorer.sweep(args.ops or None)
    if fleet_rec is not None:
        summary["fleet"] = fleet_rec
    if pusher is not None:
        push = pusher.push()
        summary["fleet"]["push"] = {
            "pushed": push.get("pushed", False),
            "samples": pusher.pushed_samples,
        }
        if "error" in push:
            print(f"fleet: push failed (samples ride a retry): {push['error']}",
                  file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            f.write(store.to_json())
        print(f"wrote {args.out} ({len(store)} entries)", file=sys.stderr)
    if args.json:
        print(json.dumps(summary, indent=1))
        return 0
    print(f"sweep[{summary['mode']}]: {summary['spaces']} spaces, "
          f"{summary['points_total']} points "
          f"({summary['pruned']} pruned, {summary['skipped_warm']} warm, "
          f"{summary['sweep_points']} measured)")
    for key, win in sorted(summary["winners"].items()):
        speed = (f"  {win['speedup']:.2f}x vs default"
                 if "speedup" in win else "")
        print(f"  {key:<28} best={win['config'] or '<default>'} "
              f"min={win['best_s']:.3e}s{speed}")
    return 0


def cmd_show(args: argparse.Namespace) -> int:
    store = _load_store(args)
    if args.fleet:
        sha, chip = _env_key()
        try:
            pulled = FleetClient(args.fleet, token=args.token).pull(sha, chip)
        except FleetError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        if pulled["store"] is not None:
            store.merge(pulled["store"])
    spaces = default_spaces()
    _, details = winners_from_store(store, spaces)
    out: dict = {}
    for key, space in sorted(spaces.items()):
        points = store.config_points(space.op, space.backend, space.sig)
        if not points:
            continue
        best = details.get(key, {}).get("config")
        out[key] = {
            "points": {
                cfg or "<default>": {"count": e.count, "min_s": e.min_s}
                for cfg, e in sorted(points.items())
            },
            "best": best if best is not None else "<none warm>",
            "default": space.default_config,
        }
    if args.json:
        print(json.dumps(out, indent=1))
        return 0
    if not out:
        print("(no measured config points)")
        return 0
    for key, rec in out.items():
        print(f"{key}  (default {rec['default']})")
        for cfg, row in rec["points"].items():
            mark = " *" if cfg == (rec["best"] or "<default>") else ""
            print(f"  {cfg:<40} n={row['count']:<4} min={row['min_s']:.3e}s{mark}")
    return 0


def cmd_spaces(args: argparse.Namespace) -> int:
    ptxas = None
    if args.ptxas:
        from repro_torch.tune.explore import card_ptxas  # builds K4 with nvcc

        ptxas = card_ptxas()
    rows = space_report(ptxas=ptxas, prune_ratio=args.prune_ratio)
    if args.json:
        print(json.dumps({"spaces": rows, "not_swept": NOT_SWEPT}, indent=1))
        return 0
    print(f"{'space':<28}{'feasible':>9}{'pruned':>8}{'sweep':>7}  default")
    for r in rows:
        print(f"{r['space']:<28}{r['feasible']:>9}{r['pruned']:>8}"
              f"{r['sweep']:>7}  {r['default']}")
    for key, why in NOT_SWEPT.items():
        print(f"{key:<28}  not swept: {why}")
    return 0


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--fleet", default=None, metavar="URL|DIR",
                   help="fleet daemon URL or store directory")
    p.add_argument("--token", default=None, metavar="TOKEN",
                   help="bearer token for a --token-protected daemon")
    p.add_argument("--profile-in", default=None, metavar="PATH",
                   help="seed the store from a profile/session artifact")
    p.add_argument("--json", action="store_true")


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sweep", help="enumerate, prune, and time the design spaces")
    _add_common(p)
    p.add_argument("--ops", nargs="*", default=None, metavar="OP",
                   help="restrict to these kernel ops (default: all spaces)")
    p.add_argument("--mode", default="interpret", choices=MODES)
    p.add_argument("--workers", type=int, default=0,
                   help="multiprocessing pool size (0 = in-process; real: 0 only)")
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--prune-ratio", type=float, default=DEFAULT_PRUNE_RATIO,
                   help="drop points predicted worse than RATIO x the bound")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the swept ProfileStore JSON here")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("show", help="print measured config points per space")
    _add_common(p)
    p.set_defaults(fn=cmd_show)

    p = sub.add_parser("spaces", help="list design spaces and prune counts")
    p.add_argument("--prune-ratio", type=float, default=DEFAULT_PRUNE_RATIO)
    p.add_argument("--ptxas", action="store_true",
                   help="also read ptxas' registers and spills of the built kernels "
                        "(builds them; needs nvcc)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_spaces)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, FileNotFoundError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
