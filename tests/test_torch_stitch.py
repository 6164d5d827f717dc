"""The port's cross-process tracing (``repro_torch.trace.stitch``) against
the JAX package's ``repro.trace.stitch``: span propagation, session
stitching, hop analysis.

Every case of ``tests/test_stitch.py`` is held of the port.  Then the two
packages together: both stitchers give the same merged session, chain
report, hop rows and hop summary on the same sessions (the skewed ones
included), and each stitches segment directories the other streamed.

Synthetic two-process sessions are built by hand with known span-id
collisions and injected clock skew, so every stitching transformation
(namespacing, NTP-style skew correction, remote re-linking) is asserted
against exact expected values; the end-to-end test runs a real in-process
:class:`ReplicaServer` behind a hand-driven frontdoor side and stitches the
two collectors' sessions.
"""
import json
import urllib.request

import pytest

pytest.importorskip("torch")

from repro_torch.core.events import Event, SpanContext, TRACEPARENT_HEADER, remote_ref  # noqa: E402
from repro_torch.metrics import MetricsPlane  # noqa: E402
from repro_torch.router.frontdoor import FrontDoorHandler  # noqa: E402
from repro_torch.router.replica import (  # noqa: E402
    ReplicaServer,
    SyntheticEngine,
    expected_synthetic_tokens,
)
from repro_torch.trace.cli import main as trace_main  # noqa: E402
from repro_torch.trace.collector import TraceCollector, resolve_spans, span_tree  # noqa: E402
from repro_torch.trace.session import Session  # noqa: E402
from repro_torch.trace.stitch import (  # noqa: E402
    HOPS,
    chain_report,
    hop_rows,
    hop_summary,
    stitch,
    stitch_sessions,
)


# ---------------------------------------------------------------------------
# SpanContext wire format
# ---------------------------------------------------------------------------


def test_spancontext_inject_extract_roundtrip():
    ctx = SpanContext(trace="abc123", span=42, origin="frontdoor:999",
                      sent_unix=1234.5678)
    back = SpanContext.extract(ctx.inject())
    assert back == ctx


def test_spancontext_extract_tolerates_garbage():
    assert SpanContext.extract(None) is None
    assert SpanContext.extract("") is None
    assert SpanContext.extract("traceparent-w3c;whatever") is None
    assert SpanContext.extract("repro1;trace=x") is None  # missing span/origin
    assert SpanContext.extract("repro1;trace=x;span=NaNope;origin=y") is None


def test_spancontext_origin_sanitized_on_wire():
    ctx = SpanContext(trace="t", span=1, origin="evil;span=9=x")
    back = SpanContext.extract(ctx.inject())
    assert back is not None and back.span == 1
    assert ";" not in back.origin and "=" not in back.origin


def test_remote_ref_validation():
    ok = {"remote": {"trace": "t", "span": 3, "origin": "fd:1"}}
    assert remote_ref(ok) == ok["remote"]
    assert remote_ref(None) is None
    assert remote_ref({"remote": "3"}) is None
    assert remote_ref({"remote": {"span": "3", "origin": "x"}}) is None
    assert remote_ref({"remote": {"span": 3, "origin": ""}}) is None


def test_resolve_spans_lifts_remote():
    ref = {"trace": "t", "span": 7, "origin": "fd:1"}
    events = [
        Event(1.0, "spawn", "rpc", {"replica": "r0", "remote": ref}, span=2,
              parent=1),
        Event(2.0, "exit", "rpc", {"replica": "r0", "remote": ref}, span=2,
              parent=1),
    ]
    spans = resolve_spans(events)
    assert len(spans) == 1
    assert spans[0].remote == ref
    assert spans[0].parent == 1  # local parent untouched


# ---------------------------------------------------------------------------
# Synthetic two-process sessions: exact stitching arithmetic
# ---------------------------------------------------------------------------

# The "true" timeline, in the frontdoor's wall clock: the request is sent at
# T+0.010, served by the replica over [T+0.012, T+0.052], answered at T+0.054.
T = 5000.0


def _frontdoor_session(replica_origin: str, skew_s: float) -> Session:
    """A frontdoor session whose monotonic epoch is wall - 4000, with the
    handshake stamps a replica whose clock runs ``skew_s`` ahead would have
    produced."""
    hs = {
        "origin": replica_origin, "span": 2, "trace": "tr1",
        "sent_unix": T + 0.010, "recv_unix": T + 0.054,
        "replica_recv_unix": T + 0.012 + skew_s,
        "replica_sent_unix": T + 0.052 + skew_s,
    }
    hops = {"frontdoor_queue": 1.0, "network": 4.0, "replica_queue": 1.0,
            "service": 40.0}
    m = T - 4000.0  # monotonic epoch offset
    events = [
        Event(T - m + 0.000, "spawn", "router_run", None, span=1),
        Event(T - m + 0.008, "spawn", "request", {"class": "short"}, span=2,
              parent=1),
        Event(T - m + 0.009, "route", "route", {"replica": "r0", "trace": "tr1"},
              span=3, parent=2),
        Event(T - m + 0.055, "route", "outcome",
              {"replica": "r0", "outcome": "ok", "latency_ms": 46.0,
               "hops": hops, "hs": hs}, parent=2),
        Event(T - m + 0.056, "exit", "request", {"class": "short"}, span=2,
              parent=1),
        Event(T - m + 0.100, "exit", "router_run", None, span=1),
    ]
    meta = {"origin": "frontdoor:100",
            "clock": {"monotonic": 1000.0, "unix": T - 4000.0 + 1000.0}}
    return Session(meta=meta, events=events)


def _replica_session(origin: str, skew_s: float) -> Session:
    """A replica session whose span ids 1..3 collide with the frontdoor's,
    whose monotonic epoch is true-wall - 4500, and whose *wall clock* (and
    therefore its recorded clock anchor) runs ``skew_s`` ahead of true."""
    remote = {"trace": "tr1", "span": 3, "origin": "frontdoor:100"}
    m = T - 4500.0
    events = [
        Event(T - m + 0.000, "spawn", "serve_run", {"replica": "r0"}, span=1),
        Event(T - m + 0.012, "spawn", "rpc",
              {"replica": "r0", "remote": remote}, span=2, parent=1),
        Event(T - m + 0.013, "spawn", "request", 0, span=3, parent=2),
        Event(T - m + 0.050, "exit", "request", 0, span=3, parent=2),
        Event(T - m + 0.052, "exit", "rpc",
              {"replica": "r0", "remote": remote}, span=2, parent=1),
        Event(T - m + 0.090, "exit", "serve_run", {"replica": "r0"}, span=1),
    ]
    meta = {"origin": origin,
            "clock": {"monotonic": 500.0, "unix": 500.0 + m + skew_s}}
    return Session(meta=meta, events=events)


@pytest.mark.parametrize("skew_s", [0.05, -0.05])
def test_stitch_two_process_sessions_with_skew(skew_s):
    fd = _frontdoor_session("r0:200", skew_s)
    rep = _replica_session("r0:200", skew_s)
    out = stitch_sessions([("fd", fd), ("rep", rep)])

    prov = out.meta["stitch"]
    assert [r["origin"] for r in prov["inputs"]] == ["frontdoor:100", "r0:200"]
    # reference keeps its ids; the replica is shifted above the frontdoor max
    assert prov["inputs"][0]["id_offset"] == 0
    assert prov["inputs"][1]["id_offset"] == 3
    assert prov["inputs"][1]["span_ids"] == [4, 6]
    # the estimated skew recovers the injected value
    assert prov["inputs"][1]["skew_s"] == pytest.approx(skew_s, abs=1e-6)
    assert prov["relinked_spans"] == 1
    assert prov["unmatched_remote"] == 0

    spans = {s.span: s for s in resolve_spans(out.events) if s.span}
    # rpc (replica id 2 -> 5) re-linked under the frontdoor route span (3)
    assert spans[5].name == "rpc" and spans[5].parent == 3
    # engine request (replica id 3 -> 6) kept its local parent (rpc)
    assert spans[6].name == "request" and spans[6].parent == 5

    # skew correction puts the replica subtree inside the frontdoor request
    # window on the shared timeline (monotone parent/child containment)
    req, rpc = spans[2], spans[5]
    assert req.t0 <= rpc.t0 <= rpc.t1 <= req.t1
    assert rpc.t0 == pytest.approx(T + 0.012, abs=1e-6)

    chain = chain_report(out)
    assert chain["completed"] == 1 and chain["chained"] == 1
    assert chain["fraction"] == 1.0 and chain["orphaned_remote"] == 0

    # hop decomposition is duration-only, so it is skew-invariant
    rows = hop_rows(out)
    assert len(rows) == 1
    assert rows[0]["hops"]["network"] >= 0.0
    assert rows[0]["sum_ms"] == pytest.approx(rows[0]["latency_ms"])


def test_stitch_without_skew_correction_breaks_containment():
    fd = _frontdoor_session("r0:200", 0.05)
    rep = _replica_session("r0:200", 0.05)
    out = stitch_sessions([("fd", fd), ("rep", rep)], skew_correct=False)
    assert out.meta["stitch"]["inputs"][1]["skew_s"] == 0.0
    spans = {s.span: s for s in resolve_spans(out.events) if s.span}
    # the 50 ms-fast replica clock pushes its rpc exit past the frontdoor
    # request exit — exactly the artifact skew correction removes
    assert spans[5].t1 > spans[2].t1


def test_stitch_skips_duplicate_origin_and_trees_stay_rooted():
    fd = _frontdoor_session("r0:200", 0.0)
    rep = _replica_session("r0:200", 0.0)
    dup = _replica_session("r0:200", 0.0)
    out = stitch_sessions([("fd", fd), ("rep", rep), ("dup", dup)])
    assert [s["path"] for s in out.meta["stitch"]["skipped"]] == ["dup"]
    # span_tree's parent<child invariant survives namespacing: the replica
    # subtree hangs under the frontdoor request, not orphaned at the root
    roots = span_tree(resolve_spans(out.events))
    names = {r.span.name for r in roots}
    assert "rpc" not in names and "request" not in names


def test_stitch_caps_torn_spans_at_their_own_session_end():
    # a SIGKILLed replica: spans opened, no exits, last observed event at
    # T+0.020 — long before the frontdoor session ends (T+0.100)
    fd = _frontdoor_session("r0:200", 0.0)
    rep = _replica_session("r0:200", 0.0)
    m = T - 4500.0
    killed = Session(meta=rep.meta, events=[
        e for e in rep.events if e.kind == "spawn"
    ] + [Event(T - m + 0.020, "mark", "heartbeat", None, parent=1)])
    out = stitch_sessions([("fd", fd), ("killed", killed)])

    assert out.meta["stitch"]["inputs"][0]["torn_spans"] == 0
    assert out.meta["stitch"]["inputs"][1]["torn_spans"] == 3
    spans = {s.span: s for s in resolve_spans(out.events) if s.span}
    # the torn rpc ends at the dead process's own last event, not at the
    # merged session's end, and is flagged for consumers
    assert spans[5].name == "rpc"
    assert spans[5].t1 == pytest.approx(T + 0.020, abs=1e-6)
    assert spans[5].t1 < max(s.t1 for s in spans.values())
    assert spans[5].payload.get("torn") is True
    # the salvaged chain still counts: request -> route -> rpc -> request
    chain = chain_report(out)
    assert chain["completed"] == 1 and chain["chained"] == 1


def test_stitch_unmatched_remote_counted():
    fd = _frontdoor_session("r0:200", 0.0)
    rep = _replica_session("r0:200", 0.0)
    # the rpc names an origin that is not among the stitched inputs
    alien = {"trace": "tr1", "span": 3, "origin": "elsewhere:1"}
    rep = Session(meta=rep.meta, events=[
        Event(e.t, e.kind, e.name,
              {**e.payload, "remote": alien} if isinstance(e.payload, dict)
              and "remote" in e.payload else e.payload,
              span=e.span, parent=e.parent)
        for e in rep.events])
    out = stitch_sessions([("fd", fd), ("rep", rep)])
    assert out.meta["stitch"]["relinked_spans"] == 0
    assert out.meta["stitch"]["unmatched_remote"] == 1
    assert chain_report(out)["orphaned_remote"] >= 1


# ---------------------------------------------------------------------------
# CLI: stitch / hops / multi-session report
# ---------------------------------------------------------------------------


def test_stitch_and_hops_cli(tmp_path, capsys):
    fd_path = _frontdoor_session("r0:200", 0.05).save(str(tmp_path / "fd.json"))
    rep_path = _replica_session("r0:200", 0.05).save(str(tmp_path / "rep.json"))
    out_path = str(tmp_path / "stitched.json")

    rc = trace_main(["stitch", fd_path, rep_path, "-o", out_path, "--json"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["chain"]["fraction"] == 1.0
    assert len(doc["stitch"]["inputs"]) == 2

    rc = trace_main(["hops", out_path, "--json"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["summary"]["requests"] == 1
    assert doc["summary"]["within_5pct"] == 1
    assert set(doc["summary"]["hops"]) == set(HOPS)

    # human-readable paths render without error
    assert trace_main(["stitch", fd_path, rep_path,
                       "-o", str(tmp_path / "s2.json")]) == 0
    assert trace_main(["hops", out_path]) == 0
    capsys.readouterr()


def test_multi_session_report_namespaces_ids(tmp_path, capsys):
    # two sessions with deliberately colliding span ids in one report call
    fd_path = _frontdoor_session("r0:200", 0.0).save(str(tmp_path / "a.json"))
    rep_path = _replica_session("r0:200", 0.0).save(str(tmp_path / "b.json"))
    rc = trace_main(["report", fd_path, rep_path, "--tree", "--json"])
    assert rc == 0
    rows = json.loads(capsys.readouterr().out)
    # the replica's rpc + engine request nest under the frontdoor request
    # (route -> rpc -> request), which is impossible if ids collided
    depths: dict = {}
    for r in rows:
        depths.setdefault(r["name"], set()).add(r["depth"])
    assert max(depths["request"]) > max(depths["rpc"]) > min(depths["request"])
    # single-session report still works through the same entry point
    assert trace_main(["report", fd_path]) == 0
    capsys.readouterr()


def test_stitch_load_and_discovery_fallback(tmp_path):
    # stitch() loads saved session files and appends nothing when the
    # reference is a plain file with no manifest/replicas layout
    fd_path = _frontdoor_session("r0:200", 0.0).save(str(tmp_path / "fd.json"))
    rep_path = _replica_session("r0:200", 0.0).save(str(tmp_path / "rep.json"))
    out = stitch([fd_path, rep_path])
    assert out.meta["stitch"]["relinked_spans"] == 1


# ---------------------------------------------------------------------------
# Hop aggregation
# ---------------------------------------------------------------------------


def _outcome_event(hops, latency_ms, outcome="ok"):
    return Event(1.0, "route", "outcome",
                 {"replica": "r0", "outcome": outcome,
                  "latency_ms": latency_ms, "hops": hops})


def test_hop_rows_and_summary():
    good = {"frontdoor_queue": 1.0, "network": 2.0, "replica_queue": 3.0,
            "service": 4.0}
    bad = {"frontdoor_queue": 1.0, "network": 2.0, "replica_queue": 3.0,
           "service": 40.0}
    sess = Session(meta={}, events=[
        _outcome_event(good, 10.0),
        _outcome_event(bad, 10.0),          # sum 46 vs latency 10: mismatch
        _outcome_event(good, 10.0, "rejected"),  # no hops filter: has hops
        Event(1.0, "route", "outcome", {"outcome": "error"}),  # no hops
        Event(1.0, "route", "route", {"replica": "r0"}),  # not an outcome
    ])
    rows = hop_rows(sess)
    assert len(rows) == 3
    summary = hop_summary(rows)
    assert summary["requests"] == 3
    assert summary["within_5pct"] == 2
    assert summary["hops"]["service"]["max"] == 40.0


def test_metrics_sink_hop_histograms():
    col = TraceCollector()
    plane = MetricsPlane(col)
    good = {"frontdoor_queue": 1.0, "network": 2.0, "replica_queue": 3.0,
            "service": 4.0}
    col.record("route", "outcome",
               {"replica": "r0", "outcome": "ok", "latency_ms": 10.0,
                "route_ms": 0.1, "hops": good})
    col.record("route", "outcome",
               {"replica": "r0", "outcome": "ok", "latency_ms": 100.0,
                "route_ms": 0.1, "hops": good})  # sum 10 vs 100: mismatch
    summary = plane.summary()
    for hop in HOPS:
        assert summary[f"repro_router_hop_ms_count{{hop={hop}}}"] == 2
    assert summary["repro_router_hop_sum_mismatch_total"] == 1


# ---------------------------------------------------------------------------
# End-to-end: real replica server + hand-driven frontdoor side
# ---------------------------------------------------------------------------


def test_replica_traceparent_end_to_end_stitch(tmp_path):
    from repro_torch.core.events import next_span_id
    from repro_torch.trace.session import run_metadata

    rep_col = TraceCollector()
    eng = SyntheticEngine(max_batch=2, ms_per_token=1.0, log=rep_col)
    srv = ReplicaServer(eng, name="r0", log=rep_col).start()

    fd_col = TraceCollector()
    import time as _time
    try:
        run_span = next_span_id()
        fd_col.record("spawn", "router_run", None, span=run_span)
        t_req0 = _time.perf_counter()
        with fd_col.lifecycle("request", {"class": "short"},
                              parent=run_span) as rspan:
            route_span = next_span_id()
            fd_col.record("route", "route", {"replica": "r0", "trace": "tr9"},
                          span=route_span, parent=rspan)
            ctx = SpanContext(trace="tr9", span=route_span,
                              origin="frontdoor:1", sent_unix=_time.time())
            body = json.dumps({"prompt": [1, 2, 3], "max_new": 4}).encode()
            req = urllib.request.Request(
                f"{srv.url}/v1/generate", data=body, method="POST",
                headers={"Content-Type": "application/json",
                         TRACEPARENT_HEADER: ctx.inject()})
            t_fwd = _time.perf_counter()
            with urllib.request.urlopen(req, timeout=10) as resp:
                reply = json.loads(resp.read())
            recv_unix = _time.time()
            fwd_ms = (_time.perf_counter() - t_fwd) * 1e3
            lat_ms = (_time.perf_counter() - t_req0) * 1e3
            extra = FrontDoorHandler._hop_extra(reply, ctx, recv_unix,
                                                fwd_ms=fwd_ms, lat_ms=lat_ms)
            fd_col.record("route", "outcome",
                          {"replica": "r0", "outcome": "ok", **extra},
                          parent=rspan)
        fd_col.record("exit", "router_run", None, span=run_span)
    finally:
        srv.stop()

    assert reply["tokens"] == expected_synthetic_tokens([1, 2, 3], 4)
    # the replica's reply carries its handshake/decomposition context
    assert reply["ctx"]["origin"] == srv.origin
    assert reply["ctx"]["trace"] == "tr9"
    assert "hops" in extra and extra["hops"]["service"] >= 0.0

    fd = Session(meta=run_metadata({"origin": "frontdoor:1"}),
                 events=fd_col.events())
    rep = Session(meta=run_metadata({"origin": srv.origin}),
                  events=rep_col.events())
    out = stitch_sessions([("fd", fd), ("rep", rep)])
    chain = chain_report(out)
    assert chain["completed"] == 1 and chain["fraction"] == 1.0
    assert chain["orphaned_remote"] == 0
    rows = hop_rows(out)
    assert len(rows) == 1
    # the four duration-only hops telescope to the end-to-end latency
    assert rows[0]["sum_ms"] == pytest.approx(rows[0]["latency_ms"], rel=0.01)


# ---------------------------------------------------------------------------
# The two packages together
# ---------------------------------------------------------------------------


def _jax_stitch():
    import importlib

    return importlib.import_module("repro.trace.stitch")


def _as_rows(sess) -> list:
    return [(e.t, e.kind, e.name, e.payload, e.span, e.parent) for e in sess.events]


def _both(paths: list, **kw) -> dict:
    """Each package's stitch of the same files: merged events, provenance,
    chain report, hop rows and hop summary."""
    import repro_torch.trace.stitch as ours

    out = {}
    for name, mod in (("jax", _jax_stitch()), ("port", ours)):
        sess = mod.stitch(paths, **kw)
        rows = mod.hop_rows(sess)
        out[name] = {"events": _as_rows(sess), "stitch": sess.meta["stitch"],
                     "chain": mod.chain_report(sess), "rows": rows,
                     "summary": mod.hop_summary(rows)}
    return out


@pytest.mark.parametrize("case", ["skew+50ms", "skew-50ms", "no-skew-correction",
                                  "duplicate-origin", "torn", "unmatched"])
def test_both_stitchers_agree_on_the_same_sessions(case, tmp_path):
    """The synthetic two-process sessions above (test_stitch.py:149's skewed
    pair and its variants), saved once: the JAX package's and the port's
    stitch give the same merged session and the same hop analysis."""
    skew = {"skew+50ms": 0.05, "skew-50ms": -0.05, "no-skew-correction": 0.05}.get(case, 0.0)
    fd = _frontdoor_session("r0:200", skew)
    rep = _replica_session("r0:200", skew)
    if case == "torn":
        m = T - 4500.0
        rep = Session(meta=rep.meta, events=[e for e in rep.events if e.kind == "spawn"]
                      + [Event(T - m + 0.020, "mark", "heartbeat", None, parent=1)])
    if case == "unmatched":
        alien = {"trace": "tr1", "span": 3, "origin": "elsewhere:1"}
        rep = Session(meta=rep.meta, events=[
            Event(e.t, e.kind, e.name,
                  {**e.payload, "remote": alien} if isinstance(e.payload, dict)
                  and "remote" in e.payload else e.payload, span=e.span, parent=e.parent)
            for e in rep.events])
    paths = [fd.save(str(tmp_path / "fd.json")), rep.save(str(tmp_path / "rep.json"))]
    if case == "duplicate-origin":
        paths.append(rep.save(str(tmp_path / "dup.json")))
    got = _both(paths, skew_correct=case != "no-skew-correction")
    assert got["port"] == got["jax"]
    assert got["port"]["chain"]["completed"] == 1
    if case.startswith("skew"):
        assert got["port"]["stitch"]["inputs"][1]["skew_s"] == pytest.approx(skew, abs=1e-6)


def _serve_and_stream(fd_pkg: str, rep_pkg: str, root) -> str:
    """Two requests through one package's in-process synthetic replica,
    streamed into ``<root>/replicas/``, from a hand-driven front door of the
    other package streamed into ``<root>`` (its manifest announcing the
    replica's directory, as the router's does); returns ``root``."""
    import importlib
    import time as _time

    def mod(pkg, name):
        return importlib.import_module(f"{'repro' if pkg == 'jax' else 'repro_torch'}.{name}")

    rep_col = mod(rep_pkg, "trace.collector").TraceCollector()
    rep_dir = str(root / "replicas" / "r0-1")
    rep_stream = mod(rep_pkg, "trace.stream").StreamingSession(
        rep_dir, meta={"driver": "replica", "origin": "r0:1"}).attach(rep_col)
    replica = mod(rep_pkg, "router.replica")
    srv = replica.ReplicaServer(replica.SyntheticEngine(max_batch=2, ms_per_token=1.0,
                                                        log=rep_col),
                                name="r0", log=rep_col).start()
    srv.origin = "r0:1"
    events = mod(fd_pkg, "core.events")
    fd_col = mod(fd_pkg, "trace.collector").TraceCollector()
    fd_stream = mod(fd_pkg, "trace.stream").StreamingSession(
        str(root), meta={"driver": "router", "origin": "frontdoor:1"}).attach(fd_col)
    fd_stream.set_meta("replica_sessions", [{"replica": "r0", "trace_dir": rep_dir}])
    hop_extra = mod(fd_pkg, "router.frontdoor").FrontDoorHandler._hop_extra
    try:
        run_span = events.next_span_id()
        fd_col.record("spawn", "router_run", None, span=run_span)
        for prompt in ([1, 2, 3], [4, 5]):
            t_req0 = _time.perf_counter()
            with fd_col.lifecycle("request", {"class": "p4/n4"}, parent=run_span) as rspan:
                route_span = events.next_span_id()
                fd_col.record("route", "route", {"replica": "r0", "trace": "tr"},
                              span=route_span, parent=rspan)
                ctx = events.SpanContext(trace="tr", span=route_span, origin="frontdoor:1",
                                         sent_unix=_time.time())
                req = urllib.request.Request(
                    f"{srv.url}/v1/generate",
                    data=json.dumps({"prompt": prompt, "max_new": 4}).encode(), method="POST",
                    headers={"Content-Type": "application/json",
                             events.TRACEPARENT_HEADER: ctx.inject()})
                t_fwd = _time.perf_counter()
                with urllib.request.urlopen(req, timeout=30) as resp:
                    reply = json.loads(resp.read())
                extra = hop_extra(reply, ctx, _time.time(),
                                  fwd_ms=(_time.perf_counter() - t_fwd) * 1e3,
                                  lat_ms=(_time.perf_counter() - t_req0) * 1e3)
                fd_col.record("route", "outcome", {"replica": "r0", "outcome": "ok", **extra},
                              parent=rspan)
        fd_col.record("exit", "router_run", None, span=run_span)
    finally:
        srv.stop()
    rep_stream.close(stats=rep_col.stats())
    fd_stream.close(stats=fd_col.stats())
    return str(root)


@pytest.mark.parametrize("fd_pkg,rep_pkg", [("jax", "port"), ("port", "jax")])
def test_stitchers_read_each_others_streams(fd_pkg, rep_pkg, tmp_path):
    """A front door of one package and a replica of the other, each streaming
    its own segment directory: both stitchers discover the replica from the
    front door's manifest and give the same merged session, every request
    chained front door -> route -> rpc -> engine request, and hops that sum
    to each request's latency."""
    root = _serve_and_stream(fd_pkg, rep_pkg, tmp_path / "trace")
    got = _both([root])
    assert got["port"] == got["jax"]
    chain = got["port"]["chain"]
    assert (chain["completed"], chain["chained"], chain["orphaned_remote"]) == (2, 2, 0)
    assert got["port"]["summary"]["within_5pct"] == 2
    assert [r["origin"] for r in got["port"]["stitch"]["inputs"]] == ["frontdoor:1", "r0:1"]
