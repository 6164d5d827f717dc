"""Analysis CLI for trace sessions (counterpart of ``repro/trace/cli.py``).

  PYTHONPATH=src python -m repro_torch.trace report  t.json [--tree]
  PYTHONPATH=src python -m repro_torch.trace export  t.json --format chrome -o t.chrome.json
  PYTHONPATH=src python -m repro_torch.trace diff    a.json b.json [--fail-over-pct 25]
  PYTHONPATH=src python -m repro_torch.trace compact run_dir/ -o session.json
  PYTHONPATH=src python -m repro_torch.trace tail    run_dir/ [--once]
  PYTHONPATH=src python -m repro_torch.trace device  run_dir/ [--json]
  PYTHONPATH=src python -m repro_torch.trace metrics run_dir/ [--json]
  PYTHONPATH=src python -m repro_torch.trace stitch  frontdoor_dir/ [replica_dir/...] -o stitched.json
  PYTHONPATH=src python -m repro_torch.trace hops    stitched.json [--json]
  PYTHONPATH=src python -m repro_torch.trace push-profiles run_dir/ --fleet http://host:8377

``report`` prints per-op / per-backend latency tables for one session —
``--tree`` renders the span hierarchy instead (indented parent/child nodes
with inclusive/exclusive times); ``export`` renders it for a standard viewer
(Perfetto / speedscope / flamegraph.pl); both accept ``--device-trace DIR``
to fold a ``torch.profiler`` window (a Chrome trace file, or a directory of
them) under the host spans first (see :mod:`repro_torch.trace.device`).
``diff`` compares two sessions — or two stamped benchmark artifacts — and
with ``--fail-over-pct`` exits 3 on latency/throughput regressions past the
threshold (the CI gate); ``compact`` folds a streaming segment directory
(``--trace-dir``) back into the one-file session format.  ``report``,
``export`` and ``diff`` also accept segment directories directly, and read
sessions and directories written by either package.

``tail`` follows a live ``--trace-dir`` like ``tail -f`` (``--once`` drains
and exits); ``device`` summarises a run's device side — live-capture window
coverage, per-device and per-kernel time, and how the slices were bound to
host spans (``span=`` annotation, launch time, time window; see
:mod:`repro_torch.trace.liveprof`); ``metrics`` prints a run's metric
snapshots.

``stitch`` merges a frontdoor session with its replica sessions into one
cross-process timeline (span-id namespacing, handshake clock-skew
correction, remote-parent re-linking — see :mod:`repro_torch.trace.stitch`);
replica dirs announced in the frontdoor manifest are discovered
automatically, so ``stitch <frontdoor-dir>`` alone stitches the whole
fleet.  ``hops`` prints the per-hop latency decomposition
(frontdoor_queue | network | replica_queue | service) recorded on each
routed request, with the sum-vs-end-to-end consistency check.  ``report``
also accepts several sessions at once — they are stitched first, so span
ids from different processes never collide.  ``push-profiles`` backfills
the fleet profile service (:mod:`repro_torch.fleet`) from a recorded
session or segment directory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

from repro_torch.trace.export import FORMATS
from repro_torch.trace.export import export as render
from repro_torch.trace.session import (
    Session,
    artifact_regressions,
    diff_artifacts,
    diff_sessions,
    is_session,
    path_diff,
    path_regressions,
    session_regressions,
)
from repro_torch.trace.stream import (
    MANIFEST_NAME,
    load_any,
    load_metrics_timeline,
    load_stream,
    tail_stream,
)

EXIT_REGRESSION = 3  # distinct from argparse (2) and generic failure (1)


def _fmt_ms(v: Any) -> str:
    return f"{v:10.3f}" if isinstance(v, (int, float)) else f"{'-':>10}"


def _print_report(rep: dict[str, Any]) -> None:
    m = rep["meta"]
    print(f"session  schema={m.get('schema')}  git={m.get('git_sha')}  "
          f"created={m.get('created_unix')}")
    print(f"events   {rep['events']}  (dropped by ring: {rep['dropped']})"
          + (f"  ({rep['truncated_spans']} truncated spans excluded)"
             if rep.get("truncated_spans") else ""))
    dbt = {k or "main": v for k, v in (rep.get("dropped_by_track") or {}).items() if v}
    if dbt:
        print(f"WARNING: ring drops by track: {dbt}")
    if rep.get("sampled_out"):
        print(f"sampled out (adaptive capture shedding): {rep['sampled_out']} events")
    if rep["latency"]:
        print(f"\n{'track/name':<28}{'count':>7}{'mean_ms':>10}{'min_ms':>10}{'max_ms':>10}")
        for key, row in sorted(rep["latency"].items()):
            print(f"{key:<28}{row['count']:>7}"
                  + _fmt_ms(row["mean_ms"]) + _fmt_ms(row["min_ms"]) + _fmt_ms(row["max_ms"]))
    d = rep["dispatch"]
    if d["decisions"]:
        print(f"\ndispatch: {d['decisions']} decisions, {d['profiled_keys']} profiled keys, "
              f"sources={d['by_source']}")
        print(f"{'op':<22}{'backend':<10}{'count':>7}{'mean_ms':>10}")
        for op, backends in sorted(d["by_op"].items()):
            for b, cell in sorted(backends.items()):
                print(f"{op:<22}{b:<10}{cell['count']:>7}" + _fmt_ms(cell.get("mean_ms")))


def _print_tree(rows: list[dict[str, Any]]) -> None:
    print(f"{'span tree':<44}{'count':>7}{'incl_ms':>11}{'excl_ms':>11}")
    for row in rows:
        label = "  " * row["depth"] + f"{row['track']}/{row['name']}"
        if row["truncated"]:
            label += " …"  # exits evicted / trace cut while open
        print(f"{label:<44}{row['count']:>7}"
              f"{row['inclusive_ms']:>11.3f}{row['exclusive_ms']:>11.3f}")


def _maybe_merge_device(sess: Session, args: argparse.Namespace) -> int:
    """Fold a ``--device-trace`` window into the loaded session.

    Returns 0 on success (or nothing to do), 2 on a bad window — one with
    no device rows, no span= range the session knows, or a missing path
    gets a one-line error instead of a traceback."""
    if not getattr(args, "device_trace", None):
        return 0
    from repro_torch.trace.device import merge_device_trace

    try:
        n = merge_device_trace(sess, args.device_trace,
                               offset_s=args.device_offset_s)
    except (ValueError, FileNotFoundError) as exc:  # NoDeviceRows is a ValueError
        print(f"error: --device-trace {args.device_trace}: {exc}",
              file=sys.stderr)
        return 2
    print(f"merged {n} device events from {args.device_trace}",
          file=sys.stderr)
    return 0


def cmd_report(args: argparse.Namespace) -> int:
    if len(args.session) > 1:
        # several sessions from different processes: merge through the
        # stitcher so their span ids are namespaced (and remote parents
        # re-linked) instead of silently colliding
        from repro_torch.trace.stitch import merge_for_report

        sess = merge_for_report(args.session)
    else:
        sess = load_any(args.session[0])
    rc = _maybe_merge_device(sess, args)
    if rc:
        return rc
    if args.tree:
        rows = sess.tree_report()
        if args.json:
            print(json.dumps(rows, indent=1))
        else:
            _print_tree(rows)
        return 0
    rep = sess.report()
    if args.json:
        print(json.dumps(rep, indent=1))
    else:
        _print_report(rep)
        stream = sess.meta.get("stream")
        if stream:
            print(f"\nstream   {stream['segments']} closed segments"
                  + (f", {stream['open_segments']} open "
                     f"(salvaged {stream['salvaged_events']} events)"
                     if stream["open_segments"] else "")
                  + (f", {stream['skipped_lines']} torn lines skipped"
                     if stream["skipped_lines"] else ""))
    return 0


def cmd_export(args: argparse.Namespace) -> int:
    sess = load_any(args.session)
    rc = _maybe_merge_device(sess, args)
    if rc:
        return rc
    text = render(sess.events, args.format, meta=sess.meta)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out} ({args.format}, {len(sess.events)} events)")
    else:
        sys.stdout.write(text)
    return 0


def cmd_compact(args: argparse.Namespace) -> int:
    sess = load_stream(args.dir)
    path = sess.save(args.out)
    stream = sess.meta["stream"]
    print(f"compacted {stream['segments']} closed + {stream['open_segments']} open "
          f"segments -> {path} ({len(sess.events)} events"
          + (f", {stream['skipped_lines']} torn lines skipped"
             if stream["skipped_lines"] else "") + ")")
    return 0


def cmd_stitch(args: argparse.Namespace) -> int:
    """Merge a frontdoor session with its replica sessions (see
    :mod:`repro_torch.trace.stitch`).  Prints per-input provenance (origin, id
    offset, clock offset, estimated skew) and the cross-process chain
    coverage of the result."""
    from repro_torch.trace.stitch import chain_report, stitch

    try:
        sess = stitch(args.sessions, skew_correct=not args.no_skew_correct)
    except (ValueError, FileNotFoundError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    path = sess.save(args.out)
    prov = sess.meta["stitch"]
    chain = chain_report(sess)
    if args.json:
        print(json.dumps({"out": path, "stitch": prov, "chain": chain}, indent=1))
        return 0
    print(f"stitched {len(prov['inputs'])} session(s) -> {path} "
          f"({prov['events']} events, {prov['relinked_spans']} remote spans "
          f"re-linked"
          + (f", {prov['unmatched_remote']} unmatched"
             if prov["unmatched_remote"] else "") + ")")
    print(f"\n{'origin':<24}{'events':>8}{'id_offset':>11}"
          f"{'clock_off_s':>17}{'skew_ms':>9}  path")
    for r in prov["inputs"]:
        print(f"{r['origin']:<24}{r['events']:>8}{r['id_offset']:>11}"
              f"{r['clock_offset_s']:>17.3f}{r['skew_s'] * 1e3:>9.3f}  {r['path']}")
    for r in prov["skipped"]:
        print(f"skipped {r['path']}: {r['reason']}")
    print(f"\nchain    {chain['chained']}/{chain['completed']} completed "
          f"requests have a full frontdoor->replica chain "
          f"({chain['fraction']:.1%})"
          + (f", {chain['orphaned_remote']} orphaned remote parents"
             if chain["orphaned_remote"] else ""))
    return 0


def cmd_hops(args: argparse.Namespace) -> int:
    """Per-hop latency decomposition table for a (stitched or frontdoor)
    session: where each routed request spent its time."""
    from repro_torch.trace.stitch import HOPS, hop_rows, hop_summary

    try:
        sess = load_any(args.session)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    rows = hop_rows(sess)
    summary = hop_summary(rows)
    if args.json:
        print(json.dumps({"summary": summary, "rows": rows}, indent=1))
        return 0
    if not rows:
        print("no hop decompositions recorded (the frontdoor adds them when "
              "replicas report their handler timings)", file=sys.stderr)
        return 1
    print(f"{'hop':<18}{'count':>7}{'mean_ms':>10}{'p50_ms':>10}"
          f"{'p95_ms':>10}{'max_ms':>10}")
    for hop in HOPS:
        st = summary["hops"][hop]
        print(f"{hop:<18}{st['count']:>7}"
              + _fmt_ms(st.get("mean")) + _fmt_ms(st.get("p50"))
              + _fmt_ms(st.get("p95")) + _fmt_ms(st.get("max")))
    lat = summary["latency_ms"]
    print(f"{'end_to_end':<18}{lat['count']:>7}"
          + _fmt_ms(lat.get("mean")) + _fmt_ms(lat.get("p50"))
          + _fmt_ms(lat.get("p95")) + _fmt_ms(lat.get("max")))
    print(f"\nsum check: {summary['within_5pct']}/{summary['requests']} "
          f"requests' hops sum to end-to-end latency within 5%")
    return 0


def cmd_tail(args: argparse.Namespace) -> int:
    try:
        return tail_stream(args.dir, once=args.once, poll_s=args.poll)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1


def cmd_device(args: argparse.Namespace) -> int:
    """Device-side summary of a recorded run.

    Reports live-capture coverage (windows, captured fraction, measured
    overhead vs budget — from the session/manifest ``device_capture``
    record), per-device time, and how the merged slices aligned to host
    spans (``span=`` annotation vs time-window fallback vs unparented).
    """
    try:
        sess = load_any(args.session)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    rc = _maybe_merge_device(sess, args)
    if rc:
        return rc
    import re as _re

    from repro_torch.trace.device import DEVICE_KIND, alignment_summary

    align = alignment_summary(sess.events)
    by_device: dict[str, dict[str, float]] = {}
    by_op: dict[str, dict[str, float]] = {}
    for e in sess.events:
        if e.kind != DEVICE_KIND or not isinstance(e.payload, dict):
            continue
        dur_ms = 1e3 * float(e.payload.get("dur_s") or 0.0)
        dev = str(e.payload.get("device") or "?")
        row = by_device.setdefault(dev, {"slices": 0, "total_ms": 0.0})
        row["slices"] += 1
        row["total_ms"] += dur_ms
        op = _re.sub(r"\bspan[=:]\d+\s*", "", e.name).strip() or "?"
        row = by_op.setdefault(op, {"slices": 0, "total_ms": 0.0})
        row["slices"] += 1
        row["total_ms"] += dur_ms
    capture = sess.meta.get("device_capture") or (
        sess.meta.get("device_trace"))
    out = {
        "session": args.session,
        "device_events": align["total"],
        "align": align,
        "by_device": {d: {"slices": r["slices"],
                          "total_ms": round(r["total_ms"], 3)}
                      for d, r in sorted(by_device.items())},
        "by_op": {o: {"slices": r["slices"], "total_ms": round(r["total_ms"], 3)}
                  for o, r in sorted(by_op.items())},
        "capture": capture,
    }
    if args.json:
        print(json.dumps(out, indent=1))
        return 0
    if isinstance(capture, dict) and "windows" in capture:
        cov = capture.get("coverage") or {}
        budget = capture.get("budget") or {}
        print(f"capture  backend={capture.get('backend')}  "
              f"windows={capture.get('windows')}  "
              f"coverage={cov.get('fraction', 0):.1%} "
              f"({cov.get('captured_s', 0):g}s of {cov.get('run_s', 0):g}s)")
        print(f"budget   overhead={budget.get('overhead_pct', 0):g}%  "
              f"budget={budget.get('budget_pct', 0):g}%  "
              f"on_fraction={budget.get('on_fraction', 0):g}  "
              f"adjustments={budget.get('adjustments', 0)}")
        if capture.get("no_device_rows"):
            print(f"WARNING: {capture['no_device_rows']} windows saw launches but no "
                  "device rows")
        if capture.get("degraded") or capture.get("failed"):
            print(f"WARNING: capture degraded: {capture.get('degraded') or capture['failed']}")
    elif isinstance(capture, dict):
        print(f"capture  post-hoc merge of {capture.get('path')} "
              f"({capture.get('events')} events)")
    else:
        print("capture  none recorded (run with --torch-profile, or merge a "
              "window with --device-trace)")
    if not align["total"]:
        print("no device events in this session")
        return 0
    print(f"align    span={align['span']}  launch={align['launch']}  "
          f"window={align['window']}  none={align['none']}  "
          f"annotated={align['annotated_fraction']:.1%}")
    print(f"\n{'device':<28}{'slices':>8}{'total_ms':>12}")
    for dev, row in sorted(by_device.items()):
        print(f"{dev:<28}{row['slices']:>8}{row['total_ms']:>12.3f}")
    print(f"\n{'op':<28}{'slices':>8}{'total_ms':>12}")
    top = sorted(by_op.items(), key=lambda kv: -kv[1]["total_ms"])[:20]
    for op, row in top:
        print(f"{op[:27]:<28}{row['slices']:>8}{row['total_ms']:>12.3f}")
    if len(by_op) > 20:
        print(f"... {len(by_op) - 20} more ops")
    return 0


def _fmt_series(m: dict[str, Any]) -> str:
    labels = m.get("labels") or {}
    ltxt = ("{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"
            if labels else "")
    return f"{m.get('name')}{ltxt}"


def _print_snapshot(snap: dict[str, Any]) -> None:
    hists = [m for m in snap.get("metrics", []) if m.get("kind") == "histogram"]
    scalars = [m for m in snap.get("metrics", []) if m.get("kind") != "histogram"]
    if scalars:
        width = max(len(_fmt_series(m)) for m in scalars)
        for m in scalars:
            print(f"  {_fmt_series(m):<{width}}  {m.get('value'):g}")
    if hists:
        print(f"\n  {'histogram':<44}{'count':>8}{'p50_ms':>10}{'p95_ms':>10}"
              f"{'p99_ms':>10}")
        for m in hists:
            print(f"  {_fmt_series(m):<44}{m.get('count', 0):>8}"
                  + _fmt_ms(m.get("p50")) + _fmt_ms(m.get("p95"))
                  + _fmt_ms(m.get("p99")))


def cmd_metrics(args: argparse.Namespace) -> int:
    """Final + per-rotation metric snapshots of a recorded run.

    Reads only the manifest / ``metrics.jsonl`` sidecar (or session meta) —
    never the event stream — so it is cheap even on huge traces.
    """
    final: Any = None
    timeline: list[dict[str, Any]] = []
    drops: Any = None
    if os.path.isdir(args.session):
        mpath = os.path.join(args.session, MANIFEST_NAME)
        manifest: dict[str, Any] = {}
        if os.path.exists(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
        final = manifest.get("metrics")
        drops = manifest.get("drops")
        timeline = load_metrics_timeline(args.session)
    else:
        with open(args.session) as f:
            raw = json.load(f)
        if not is_session(raw):
            print(f"error: {args.session} is not a trace session", file=sys.stderr)
            return 2
        meta = raw.get("meta", {})
        final = meta.get("metrics")
        drops = meta.get("drops")
        timeline = meta.get("metrics_timeline") or []
    if final is None and timeline:
        final = timeline[-1].get("metrics")
    if args.json:
        print(json.dumps({"final": final, "timeline": timeline, "drops": drops},
                         indent=1))
        return 0
    if final is None:
        print("no metric snapshots recorded (run with the metrics plane "
              "enabled: --metrics-port and/or --trace-overhead-budget-pct)",
              file=sys.stderr)
        return 1
    if timeline:
        print(f"timeline  {len(timeline)} rotation snapshot(s)")
        for row in timeline:
            series = row.get("metrics", {}).get("metrics", [])
            events = sum(m.get("value", 0) for m in series
                         if m.get("name") == "repro_trace_events_total")
            overhead = next((m.get("value") for m in series
                             if m.get("name") == "repro_trace_overhead_pct"), None)
            print(f"  t={row.get('t', 0):.3f}  segment={row.get('segment')}"
                  f"  events={events:g}"
                  + (f"  overhead_pct={overhead:g}" if overhead is not None else ""))
    print("\nfinal snapshot:")
    _print_snapshot(final)
    if drops:
        print(f"\nlosses: dropped={drops.get('dropped', 0)} "
              f"sampled_out={drops.get('sampled_out', 0)} "
              f"by_track={drops.get('by_track', {})}")
    return 0


def _load_raw(path: str) -> dict[str, Any]:
    """A session/artifact JSON dict from a file — or a segment directory."""
    if os.path.isdir(path):
        return load_stream(path).to_dict()
    with open(path) as f:
        return json.load(f)


def _gate(regs: list[dict[str, Any]], pct: float) -> int:
    # all gate chatter goes to stderr: with --json, stdout carries exactly one
    # machine-readable document
    if not regs:
        print(f"\nregression gate: OK (no latency/throughput change over {pct:g}%)",
              file=sys.stderr)
        return 0
    print(f"\nregression gate FAILED: {len(regs)} metric(s) worse by more than "
          f"{pct:g}%", file=sys.stderr)
    for r in regs:
        print(f"  REGRESSION {r['kind']:<10} {r['key']}: "
              f"{r['a']:.6g} -> {r['b']:.6g} ({r['delta_pct']:+.1f}%)",
              file=sys.stderr)
    return EXIT_REGRESSION


def cmd_diff(args: argparse.Namespace) -> int:
    raw_a, raw_b = _load_raw(args.a), _load_raw(args.b)
    if is_session(raw_a) != is_session(raw_b):
        which = args.a if is_session(raw_a) else args.b
        other = args.b if is_session(raw_a) else args.a
        ap_err = (f"cannot diff a trace session ({which}) against a non-session "
                  f"JSON ({other}); pass two sessions or two bench artifacts")
        print(ap_err, file=sys.stderr)
        return 2
    if args.by_path and not (is_session(raw_a) and is_session(raw_b)):
        print("--by-path needs two trace sessions (bench artifacts have no "
              "span tree)", file=sys.stderr)
        return 2
    regressions: list[dict[str, Any]] = []
    if is_session(raw_a) and is_session(raw_b):
        sa, sb = Session.from_dict(raw_a), Session.from_dict(raw_b)
        out = diff_sessions(sa, sb)
        if args.by_path:
            out["by_path"] = path_diff(sa, sb, args.path_depth)
        if args.fail_over_pct is not None:
            regressions = session_regressions(out, args.fail_over_pct)
            if args.by_path:
                regressions += path_regressions(out["by_path"], args.fail_over_pct)
        if args.json:
            print(json.dumps({**out, "regressions": regressions}, indent=1))
        else:
            print(f"a: git={out['a'].get('git_sha')}  b: git={out['b'].get('git_sha')}")
            if out["latency"]:
                print(f"\n{'track/name':<28}{'a_mean_ms':>10}{'b_mean_ms':>10}{'delta_%':>9}")
                for key, row in sorted(out["latency"].items()):
                    if "only_in" in row:
                        print(f"{key:<28}  (only in {row['only_in']})")
                    else:
                        d = row["delta_pct"]
                        print(f"{key:<28}" + _fmt_ms(row["a_mean_ms"]) + _fmt_ms(row["b_mean_ms"])
                              + (f"{d:>+9.1f}" if d is not None else f"{'-':>9}"))
            if args.by_path and out["by_path"]:
                print(f"\n{'span-tree path (exclusive)':<44}{'a_mean_ms':>10}"
                      f"{'b_mean_ms':>10}{'delta_%':>9}")
                for row in out["by_path"]:
                    if "only_in" in row:
                        print(f"{row['path']:<44}  (only in {row['only_in']})")
                    else:
                        d = row["delta_pct"]
                        print(f"{row['path']:<44}"
                              + _fmt_ms(row["a_mean_exclusive_ms"])
                              + _fmt_ms(row["b_mean_exclusive_ms"])
                              + (f"{d:>+9.1f}" if d is not None else f"{'-':>9}"))
            changed = {op: r for op, r in out["dispatch_choices"].items() if r["changed"]}
            if out["dispatch_choices"]:
                print(f"\ndispatch choices changed: {len(changed)}/{len(out['dispatch_choices'])}")
                for op, r in sorted(changed.items()):
                    print(f"  {op}: {r['a']} -> {r['b']}")
                print(f"exploration (source counts): a={out['by_source']['a']}  "
                      f"b={out['by_source']['b']}")
    else:
        out = diff_artifacts(raw_a, raw_b)
        if args.fail_over_pct is not None:
            regressions = artifact_regressions(raw_a, raw_b, args.fail_over_pct)
        if args.json:
            print(json.dumps({**out, "regressions": regressions}, indent=1))
        else:
            print(f"a: git={out['a_meta']}  b: git={out['b_meta']}  "
                  f"changed leaves: {out['total_changed']}")
            print(f"{'key':<52}{'a':>12}{'b':>12}{'delta_%':>9}")
            for row in out["changed"]:
                d = row["delta_pct"]
                print(f"{row['key']:<52}{row['a']:>12.4g}{row['b']:>12.4g}"
                      + (f"{d:>+9.1f}" if d is not None else f"{'new':>9}"))
    if args.fail_over_pct is not None:
        return _gate(regressions, args.fail_over_pct)
    return 0


def cmd_push_profiles(args: argparse.Namespace) -> int:
    """Backfill the fleet store from a recorded session / segment directory."""
    from repro_torch.fleet.cli import PUSH_RESULT_KEYS, push_source
    from repro_torch.fleet.client import FleetError

    try:
        res = push_source(args.session, args.fleet, args.git_sha, args.chip,
                          force=args.force, token=args.token)
    except (FleetError, ValueError, FileNotFoundError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({k: res.get(k) for k in PUSH_RESULT_KEYS}))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.trace", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def _add_device_args(p: argparse.ArgumentParser) -> None:
        p.add_argument("--device-trace", default=None, metavar="PATH",
                       help="torch.profiler window (a *.trace.json[.gz] or a "
                            "directory of them) to fold under the host spans "
                            "before rendering")
        p.add_argument("--device-offset-s", type=float, default=None,
                       metavar="S", help="device->host clock offset override "
                       "(default: estimated from the span= ranges)")

    p = sub.add_parser("report", help="per-op / per-backend latency tables for one session")
    p.add_argument("session", nargs="+",
                   help="session JSON or streaming segment directory; several "
                        "sessions are stitched first (span ids namespaced)")
    p.add_argument("--tree", action="store_true",
                   help="render the span hierarchy (indented, with "
                        "inclusive/exclusive times per node)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    _add_device_args(p)
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("export", help="render a session for a standard trace viewer")
    p.add_argument("session", help="session JSON or streaming segment directory")
    p.add_argument("--format", choices=sorted(FORMATS), default="chrome")
    p.add_argument("-o", "--out", default=None, help="output path (default: stdout)")
    _add_device_args(p)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("compact",
                       help="fold a streaming segment directory into one session file")
    p.add_argument("dir", help="directory written by --trace-dir")
    p.add_argument("-o", "--out", default="session.json", help="output session path")
    p.set_defaults(fn=cmd_compact)

    p = sub.add_parser("stitch",
                       help="merge a frontdoor session with its replica "
                            "sessions into one cross-process timeline")
    p.add_argument("sessions", nargs="+",
                   help="frontdoor session first, then replica sessions "
                        "(dirs announced in the frontdoor manifest are "
                        "auto-discovered)")
    p.add_argument("-o", "--out", default="stitched.json",
                   help="output session path")
    p.add_argument("--no-skew-correct", action="store_true",
                   help="skip NTP-style handshake skew estimation (keep "
                        "each session on its own wall clock)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.set_defaults(fn=cmd_stitch)

    p = sub.add_parser("hops",
                       help="per-hop latency decomposition (frontdoor_queue | "
                            "network | replica_queue | service)")
    p.add_argument("session", help="stitched or frontdoor session / segment dir")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.set_defaults(fn=cmd_hops)

    p = sub.add_parser("tail", help="follow a live --trace-dir like tail -f")
    p.add_argument("dir", help="directory written by --trace-dir")
    p.add_argument("--once", action="store_true",
                   help="drain what exists now and exit (tests/scripting)")
    p.add_argument("--poll", type=float, default=0.2, metavar="SECONDS",
                   help="poll interval while following")
    p.set_defaults(fn=cmd_tail)

    p = sub.add_parser("device",
                       help="device-side summary: capture coverage, per-device "
                            "time, annotation alignment ratio")
    p.add_argument("session", help="session JSON or streaming segment directory")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    _add_device_args(p)
    p.set_defaults(fn=cmd_device)

    p = sub.add_parser("diff", help="compare two sessions (or two bench artifacts)")
    p.add_argument("a", help="session JSON, segment directory, or bench artifact")
    p.add_argument("b", help="session JSON, segment directory, or bench artifact")
    p.add_argument("--json", action="store_true")
    p.add_argument("--by-path", action="store_true",
                   help="also diff mean exclusive time per span-tree path, "
                        "attributing a regression to the node that grew "
                        "(sessions only)")
    p.add_argument("--path-depth", type=int, default=4, metavar="N",
                   help="span-tree path depth cap for --by-path (deeper "
                        "nodes fold into their ancestor)")
    p.add_argument("--fail-over-pct", type=float, default=None, metavar="PCT",
                   help="exit non-zero if any latency grew (or throughput "
                        "shrank) by more than PCT%% — the CI regression gate; "
                        "with --by-path, per-path exclusive regressions gate too")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("metrics",
                       help="print a run's final + per-rotation metric snapshots")
    p.add_argument("session", help="session JSON or streaming segment directory")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("push-profiles",
                       help="backfill the fleet profile service from a recorded run")
    p.add_argument("session", help="session JSON or streaming segment directory")
    p.add_argument("--fleet", required=True, metavar="URL|DIR",
                   help="fleet daemon URL (http://host:port) or store directory")
    p.add_argument("--git-sha", default=None,
                   help="bucket key override (default: the session's own SHA)")
    p.add_argument("--chip", default=None,
                   help="bucket key override (default: the session's own chip)")
    p.add_argument("--force", action="store_true",
                   help="push even if the run already fed this fleet live "
                        "(accepts the double count)")
    p.add_argument("--token", default=None, metavar="TOKEN",
                   help="bearer token for a --token-protected fleet daemon")
    p.set_defaults(fn=cmd_push_profiles)

    args = ap.parse_args(argv)
    return args.fn(args)
