"""Fleet profile service CLI (counterpart of ``repro/fleet/cli.py``).

  PYTHONPATH=src python -m repro_torch.fleet serve --root fleet_store [--port 8377]
  PYTHONPATH=src python -m repro_torch.fleet push  profiles.json --fleet http://host:8377
  PYTHONPATH=src python -m repro_torch.fleet pull  --fleet fleet_store -o warm.json
  PYTHONPATH=src python -m repro_torch.fleet ls    --fleet http://host:8377
  PYTHONPATH=src python -m repro_torch.fleet gc    --fleet fleet_store --max-age-s 604800
  PYTHONPATH=src python -m repro_torch.fleet audit --root fleet_store [-n 20] [--json]

``--fleet`` accepts a daemon URL (``http://host:port``) or a store directory
path / ``file://`` URL (single-host direct mode — same on-disk format, no
daemon).  ``push`` takes a bare ProfileStore JSON (``--profile-out``), a
trace session file (``--trace-out``), or a streaming segment directory
(``--trace-dir``); the (git SHA, chip) bucket key defaults to the source's
own provenance and can be overridden with ``--git-sha`` / ``--chip``.

``audit`` tails the daemon's mutation log (``AUDIT.jsonl`` in the store
root): one record per successful push/gc with the source address, a token
digest when the daemon ran with ``--token``, and what changed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Optional

from repro_torch.dispatch.profiles import ProfileStore
from repro_torch.fleet.client import FleetClient, FleetError
from repro_torch.fleet.service import make_server
from repro_torch.fleet.store import declared_stamp

EXIT_MISS = 4  # pull found nothing (distinct from argparse=2, errors=1)


def _default_key(git_sha: Optional[str], chip: Optional[str]) -> tuple[str, str]:
    """Fill missing key halves from the current environment."""
    if not git_sha:
        from repro_torch.trace.session import git_sha as current_sha

        git_sha = current_sha()
    if not chip:
        from repro_torch.hw.specs import default_chip

        chip = default_chip().name
    return git_sha, chip


def load_store_and_provenance(path: str) -> tuple[ProfileStore, dict[str, Any]]:
    """A ProfileStore + its provenance record from any profile artifact.

    Accepts a streaming segment directory, a trace session JSON, or a bare
    ProfileStore JSON (validation shared with ``--profile-in`` via
    :func:`repro_torch.trace.session.load_profile_store`).  The returned dict has
    ``git_sha``/``chip`` (from session/manifest metadata when present, else
    from unanimous entry stamps, else '') and ``fleet`` — the ``--fleet``
    target the run itself fed live, if any (double-count guard).
    """
    if os.path.isdir(path):
        from repro_torch.trace.stream import load_stream

        sess = load_stream(path)
        if sess.store is None or len(sess.store) == 0:
            raise ValueError(f"{path} carries no profile snapshot "
                             "(was the run dispatch-enabled?)")
        return sess.store, {
            "git_sha": sess.meta.get("git_sha", ""),
            "chip": (sess.chip or {}).get("name", ""),
            "fleet": sess.meta.get("fleet"),
        }
    from repro_torch.trace.session import is_session, load_profile_store

    store = load_profile_store(path)  # one place owns format validation
    with open(path) as f:
        raw = json.load(f)
    if is_session(raw):
        return store, {
            "git_sha": raw.get("meta", {}).get("git_sha", ""),
            "chip": (raw.get("dispatch", {}).get("chip") or {}).get("name", ""),
            "fleet": raw.get("meta", {}).get("fleet"),
        }
    sha, chip = declared_stamp(store)
    # bare --profile-out stores written by a --fleet run carry a top-level
    # "fleet" marker (drivers add it) — surface it for the double-count guard
    return store, {"git_sha": sha, "chip": chip, "fleet": raw.get("fleet")}


PUSH_RESULT_KEYS = ("git_sha", "chip", "merged_samples", "samples",
                    "entries", "pushes")


def push_source(source: str, fleet: str, git_sha: Optional[str] = None,
                chip: Optional[str] = None, force: bool = False,
                token: Optional[str] = None) -> dict[str, Any]:
    """Load any profile artifact and push it into a fleet target (shared by
    ``repro_torch.fleet push`` and ``repro_torch.trace push-profiles``).

    Two safety rails, both overridable:

    * a run recorded with ``--fleet`` already fed the fleet live (delta
      pushes) — re-pushing its cumulative snapshot would double-count every
      sample in the bucket's Welford state, so it is refused without
      ``force``;
    * the bucket key must come from the artifact's own provenance or
      explicit flags — silently keying foreign/unstamped samples to *this*
      environment would turn them into a trusted exact-match warm start.
    """
    store, prov = load_store_and_provenance(source)
    fed = prov.get("fleet")
    if fed and fed == fleet and not force:
        # only the fleet the run actually fed live can double-count
        raise ValueError(
            f"{source} was recorded with --fleet {fed} and already fed it "
            "live (delta pushes); re-pushing the cumulative snapshot would "
            "double-count every sample — pass --force to override"
        )
    if fed and fed != fleet:
        import sys

        print(f"warning: {source} already fed {fed} live; pushing its "
              f"cumulative snapshot to {fleet} — make sure the two targets "
              "are not backed by the same store", file=sys.stderr)
    sha = git_sha or prov["git_sha"]
    ch = chip or prov["chip"]
    if not sha or not ch:
        raise ValueError(
            f"{source} carries no unambiguous (git SHA, chip) provenance "
            f"(got {(sha, ch)!r}); pass --git-sha/--chip explicitly — "
            "defaulting to the current environment would disguise foreign "
            "samples as a trusted exact match"
        )
    return FleetClient(fleet, token=token).push(store, sha, ch)


# -- commands -----------------------------------------------------------------


def cmd_serve(args: argparse.Namespace) -> int:
    server = make_server(args.root, host=args.host, port=args.port,
                         quiet=not args.verbose, token=args.token,
                         quota_rps=args.quota_rps, quota_burst=args.quota_burst)
    print(json.dumps({"fleet": server.url, "root": os.path.abspath(args.root),
                      "pid": os.getpid(), "auth": args.token is not None,
                      "quota_rps": args.quota_rps}),
          flush=True)
    if args.ready_file:
        from repro_torch.utils.ready import write_ready_file

        write_ready_file(args.ready_file, server.url)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def cmd_push(args: argparse.Namespace) -> int:
    res = push_source(args.source, args.fleet, args.git_sha, args.chip,
                      force=args.force, token=args.token)
    print(json.dumps(res if args.json else
                     {k: res.get(k) for k in PUSH_RESULT_KEYS}))
    return 0


def cmd_pull(args: argparse.Namespace) -> int:
    git_sha, chip = _default_key(args.git_sha, args.chip)
    res = FleetClient(args.fleet, token=args.token).pull(git_sha, chip)
    store = res.pop("store")
    if args.json:
        print(json.dumps(res))
    else:
        print(f"pull ({git_sha}, {chip}): match={res['match']}"
              + (f"  bucket=({res.get('git_sha')}, {res.get('chip')})  "
                 f"entries={res.get('entries')}  samples={res.get('samples')}"
                 if res["match"] != "miss" else ""))
    if res["match"] == "miss":
        return EXIT_MISS
    if args.out:
        with open(args.out, "w") as f:
            f.write(store.to_json())
        print(f"wrote {args.out} ({len(store)} entries)", file=sys.stderr)
    return 0


def cmd_ls(args: argparse.Namespace) -> int:
    rows = FleetClient(args.fleet, token=args.token).ls()
    if args.json:
        print(json.dumps({"snapshots": rows}, indent=1))
        return 0
    if not rows:
        print("(empty fleet store)")
        return 0
    print(f"{'chip':<16}{'git_sha':<12}{'entries':>8}{'samples':>9}"
          f"{'pushes':>8}  pushed_unix")
    for r in rows:
        print(f"{str(r.get('chip')):<16}{str(r.get('git_sha')):<12}"
              f"{r.get('entries') or 0:>8}{r.get('samples') or 0:>9}"
              f"{r.get('pushes') or 0:>8}  {r.get('pushed_unix')}")
    return 0


def cmd_gc(args: argparse.Namespace) -> int:
    removed = FleetClient(args.fleet, token=args.token).gc(
        max_age_s=args.max_age_s, keep_per_chip=args.keep_per_chip)
    if args.json:
        print(json.dumps({"removed": removed}, indent=1))
    else:
        for r in removed:
            print(f"removed ({r.get('git_sha')}, {r.get('chip')}): {r.get('reason')}")
        print(f"gc: removed {len(removed)} bucket(s)")
    return 0


def cmd_audit(args: argparse.Namespace) -> int:
    from repro_torch.fleet.service import read_audit

    recs = read_audit(args.root, n=args.n if args.n > 0 else None)
    if args.json:
        print(json.dumps({"records": recs}, indent=1))
        return 0
    if not recs:
        print("(no audit records)")
        return 0
    print(f"{'t':>14}  {'verb':<5}{'addr':<16}{'token_sha':<13}detail")
    for r in recs:
        if r.get("verb") == "push":
            detail = (f"({r.get('git_sha')}, {r.get('chip')}) "
                      f"entries={r.get('entries')} "
                      f"merged_samples={r.get('merged_samples')}"
                      + (f" source={r['source']}" if r.get("source") else ""))
        elif r.get("verb") == "gc":
            removed = r.get("removed")
            detail = (f"removed={len(removed) if isinstance(removed, list) else removed}"
                      + (f" max_age_s={r['max_age_s']}"
                         if r.get("max_age_s") is not None else "")
                      + (f" keep_per_chip={r['keep_per_chip']}"
                         if r.get("keep_per_chip") is not None else ""))
        else:
            detail = json.dumps({k: v for k, v in r.items()
                                 if k not in ("t", "verb", "addr", "token_sha")})
        print(f"{r.get('t', 0):>14.3f}  {str(r.get('verb')):<5}"
              f"{str(r.get('addr')):<16}{str(r.get('token_sha', '-')):<13}{detail}")
    return 0


def _add_fleet_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--fleet", required=True, metavar="URL|DIR",
                   help="daemon URL (http://host:port) or store directory")
    p.add_argument("--token", default=None, metavar="TOKEN",
                   help="bearer token for a --token-protected daemon")


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fleet", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="run the fleet profile daemon")
    p.add_argument("--root", required=True, help="store directory")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8377,
                   help="0 picks a free port (printed in the startup JSON)")
    p.add_argument("--ready-file", default=None, metavar="PATH",
                   help="write the bound URL here once listening (for scripts/CI)")
    p.add_argument("--token", default=None, metavar="TOKEN",
                   help="require 'Authorization: Bearer TOKEN' on push/gc "
                        "(pull/ls stay open); 401s are counted in /healthz stats")
    p.add_argument("--quota-rps", type=float, default=None, metavar="R",
                   help="per-source rate quota on push/gc (token bucket, R "
                        "req/s per client address); over-quota gets 429, "
                        "counted as 'throttled', audited per episode")
    p.add_argument("--quota-burst", type=float, default=None, metavar="B",
                   help="quota bucket capacity (default max(1, R))")
    p.add_argument("--verbose", action="store_true", help="log each request to stderr")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("push", help="merge a profile artifact into the fleet")
    p.add_argument("source", help="ProfileStore JSON, session JSON, or segment dir")
    _add_fleet_arg(p)
    p.add_argument("--git-sha", default=None, help="bucket key override")
    p.add_argument("--chip", default=None, help="bucket key override")
    p.add_argument("--force", action="store_true",
                   help="push even if the run already fed this fleet live "
                        "(accepts the double count)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_push)

    p = sub.add_parser("pull", help="fetch the best matching profile snapshot")
    _add_fleet_arg(p)
    p.add_argument("--git-sha", default=None, help="default: current repo SHA")
    p.add_argument("--chip", default=None, help="default: this host's chip")
    p.add_argument("-o", "--out", default=None, help="write the pulled store JSON here")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_pull)

    p = sub.add_parser("ls", help="list fleet buckets")
    _add_fleet_arg(p)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_ls)

    p = sub.add_parser("gc", help="apply the staleness/retention policy")
    _add_fleet_arg(p)
    p.add_argument("--max-age-s", type=float, default=None,
                   help="drop buckets last pushed longer ago than this")
    p.add_argument("--keep-per-chip", type=int, default=None,
                   help="keep only the newest N buckets per chip")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_gc)

    p = sub.add_parser("audit", help="tail the store's push/gc audit log")
    p.add_argument("--root", required=True, help="store directory")
    p.add_argument("-n", type=int, default=20, metavar="N",
                   help="show the last N records (0 = all)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_audit)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (FleetError, ValueError, FileNotFoundError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
