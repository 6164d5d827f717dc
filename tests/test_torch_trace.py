"""The port's trace plane (``repro_torch.trace``) against the JAX package's.

The same scripted events, with ``t`` set by hand, go into both packages'
collectors: the event JSON, ``stats()``, the drops, the reserved rings and
the sampling gate agree; the exporters' outputs are the same bytes; a
session written by either package loads, reports and diffs the same in the
other, with the same regression gates; a segment directory written by
either, its open segment torn as a crash leaves it, compacts to the same
session in both.  Then the port's own additions: the reserved device ring,
``--profile-in`` with a session file, both drivers with every trace flag on
the CPU, and ``python -m repro_torch.trace`` on their outputs and on a
JAX-written session.
"""
import importlib
import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core.events import EventLog as JaxEventLog  # noqa: E402
from repro.core.events import SpanContext as JaxSpanContext  # noqa: E402
from repro.dispatch import ProfileStore as JaxProfileStore  # noqa: E402
from repro.trace import collector as jax_collector  # noqa: E402
from repro.trace import session as jax_session  # noqa: E402
from repro.trace import stream as jax_stream  # noqa: E402
from repro_torch.core.events import Event, EventLog, SpanContext, remote_ref  # noqa: E402
from repro_torch.dispatch import ProfileStore  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.trace import collector, export, session, stream  # noqa: E402
from repro_torch.trace.cli import main as trace_main  # noqa: E402
from repro_torch.utils.io import atomic_write  # noqa: E402
from repro_torch.utils.ready import read_ready_info, wait_for_ready_file, write_ready_file  # noqa: E402

# the JAX package's repro.trace re-exports a function named export
jax_export = importlib.import_module("repro.trace.export")
REPO = Path(__file__).resolve().parents[1]
# the JAX collector's reserved rings: both packages get the same mapping
RINGS = {"dispatch": 3, "checkpoint": 2, "controller": 4}


def script(col, n_requests: int = 5, device: bool = False) -> None:
    """A serving run's events with hand-set times and span ids: the run
    span, interleaved requests each with a prefill and its dispatch, decode
    ticks, a checkpoint, a straggler, marks and (``device``) merged device
    slices under the ticks."""
    t = 100.0
    col.record("spawn", "serve_run", {"arch": "x"}, span=1, parent=0, t=t)
    for i in range(n_requests):
        rid, psid, dsid = 10 + 3 * i, 11 + 3 * i, 12 + 3 * i
        col.record("spawn", "request", i, span=rid, parent=1, t=t + 0.01 * i)
        col.record("spawn", "prefill", i, span=psid, parent=rid, t=t + 0.01 * i + 0.001)
        col.record("dispatch", "serve_prefill",
                   {"op": "serve_prefill", "backend": "kernel" if i % 2 else "plain",
                    "source": "explore" if i < 2 else "measured", "measured_s": 0.0004 + 1e-5 * i,
                    "est_s": 0.0005},
                   span=dsid, parent=psid, t=t + 0.01 * i + 0.0016)
        col.record("exit", "prefill", i, span=psid, parent=rid, t=t + 0.01 * i + 0.002)
    for k in range(4):
        tick = 200 + k
        t0 = t + 0.1 + 0.005 * k
        col.record("spawn", "decode_tick", 3, span=tick, parent=1, t=t0)
        if device:
            for j in range(3):
                col.record("device", f"kernel_{j}",
                           {"dur_s": 0.0002, "device": "cuda:0", "align": "span",
                            "args": {"correlation": 7 * k + j}},
                           span=500 + 3 * k + j, parent=tick, t=t0 + 0.0003 * j)
        col.record("exit", "decode_tick", 3, span=tick, parent=1, t=t0 + 0.004)
    col.record("straggler", "step", {"step": 3, "s": 0.5}, span=0, parent=1, t=t + 0.13)
    col.record("mark", "controller", {"rate": 0.5}, span=0, parent=0, t=t + 0.14)
    col.record("spawn", "checkpoint", 8, span=300, parent=1, t=t + 0.15)
    col.record("exit", "checkpoint", 8, span=300, parent=1, t=t + 0.16)
    for i in range(n_requests - 1):  # the last request's exit is lost (truncated span)
        col.record("exit", "request", i, span=10 + 3 * i, parent=1, t=t + 0.17 + 0.001 * i)
    col.record("exit", "serve_run", {"arch": "x"}, span=1, parent=0, t=t + 0.2)


def both_collectors(capacity=1 << 16, rings=None, rate=1.0):
    rings = dict(collector.DEFAULT_TRACK_CAPACITY) if rings is None else rings
    ours = collector.TraceCollector(capacity, track_capacity=rings)
    theirs = jax_collector.TraceCollector(capacity, track_capacity=rings)
    for c in (ours, theirs):
        c.set_sample_rate(rate)
    return ours, theirs


def _norm(obj):
    return json.loads(json.dumps(obj, default=repr))


@pytest.mark.parametrize("case", ["whole", "drops", "sampled"])
def test_collector_matches_jax(case):
    """Event JSON, stats(), drops per track, rings and the sampling gate."""
    kw = {"whole": {}, "drops": {"capacity": 6, "rings": RINGS},
          "sampled": {"rate": 0.3, "rings": RINGS}}[case]
    ours, theirs = both_collectors(**kw)
    script(ours)
    script(theirs)
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())
    assert _norm(ours.stats()) == _norm(theirs.stats())
    assert ours.drop_counters() == theirs.drop_counters()
    assert ours.dropped_by_track() == theirs.dropped_by_track()
    assert [(s.name, s.track, s.t0, s.t1, s.span, s.parent, s.truncated) for s in ours.spans()] \
        == [(s.name, s.track, s.t0, s.t1, s.span, s.parent, s.truncated) for s in theirs.spans()]
    assert ours.timing_snapshot()["records"] == theirs.timing_snapshot()["records"]
    if case == "drops":
        assert ours.dropped > 0 and ours.stats()["dropped_by_track"]["dispatch"] > 0
    if case == "sampled":
        assert 0 < ours.stats()["sampled_out"] < len(theirs.events()) + ours.stats()["sampled_out"]


def test_device_ring_keeps_request_spans():
    """A flood of merged device slices stays in the device ring: the request
    spans of the main ring survive, and the device ring counts its drops."""
    col = collector.TraceCollector(64, track_capacity={**RINGS, "device": 100})
    script(col)
    before = [e for e in col.events() if e.kind != "device"]
    col.timing_snapshot()
    col.record_many(Event(150.0 + 1e-5 * i, "device", "flash_fwd_mma",
                          {"dur_s": 1e-5, "device": "cuda:0", "align": "span"},
                          10_000 + i, 200) for i in range(1000))
    # a merge is the capture machinery's cost: the controller's reading skips it
    assert col.timing_snapshot() == {"timed": 0, "timed_s": 0.0, "records": 0}
    assert [e for e in col.events() if e.kind != "device"] == before
    assert sum(e.kind == "device" for e in col.events()) == 100
    assert col.stats()["dropped_by_track"]["device"] == 900
    assert col.stats()["dropped_by_track"][""] == 0


def test_span_context_and_remote_ref_match_jax():
    ctx = SpanContext(trace="abc", span=42, origin="serve;1=2", sent_unix=12.5)
    jctx = JaxSpanContext(trace="abc", span=42, origin="serve;1=2", sent_unix=12.5)
    assert ctx.inject() == jctx.inject()
    assert SpanContext.extract(jctx.inject()) == ctx.__class__(**{
        **ctx.__dict__, "origin": "serve_1_2"})
    assert SpanContext.extract("garbage") is None and SpanContext.extract(None) is None
    assert ctx.to_payload() == jctx.to_payload()
    assert remote_ref({"remote": ctx.to_payload()}) == ctx.to_payload()
    assert remote_ref({"remote": {"span": "x"}}) is None


def test_eventlog_to_json_and_pairing():
    logs = EventLog(maxlen=5), JaxEventLog(maxlen=5)
    for log in logs:
        for i in range(3):
            log.record("spawn", "unit", i, t=float(i))
        for i in (1, 0, 2):
            log.record("exit", "unit", i, t=10.0 + i)
    raw = json.loads(logs[0].to_json())
    assert raw == json.loads(logs[1].to_json())
    assert raw["dropped"] == 1 and raw["maxlen"] == 5 and len(raw["events"]) == 5
    # paired by payload, whatever the order of the exits
    assert logs[0].durations("unit") == logs[1].durations("unit") == [10.0, 10.0]


@pytest.mark.parametrize("fmt", ["chrome", "speedscope", "folded"])
def test_export_bytes_match_jax(fmt):
    ours, theirs = both_collectors()
    script(ours, device=True)
    script(theirs, device=True)
    meta = {"git_sha": "abc1234", "schema": session.SESSION_SCHEMA}
    a = export.export(ours.events(), fmt, meta=meta)
    b = jax_export.export(theirs.events(), fmt, meta=meta)
    assert a == b and len(a) > 100
    assert export.FORMATS.keys() == jax_export.FORMATS.keys()


def _sessions(writer, tmp_path):
    """Two sessions of the scripted run (b's prefills 30 % slower and its
    dispatch choices moved), written by ``writer``'s package."""
    pkg_col = collector if writer == "torch" else jax_collector
    pkg_sess = session if writer == "torch" else jax_session
    pkg_store = ProfileStore if writer == "torch" else JaxProfileStore
    paths = []
    for label, slow in (("a", 1.0), ("b", 1.3)):
        col = pkg_col.TraceCollector()
        script(col)
        evs = col.events()
        if slow != 1.0:
            evs = [e if e.name != "prefill" or e.kind != "exit" else
                   e.__class__(e.t + 0.0006, e.kind, e.name, e.payload, e.span, e.parent)
                   for e in evs]
        store = pkg_store()
        store.set_stamp(git_sha="abc1234", chip="h100_sxm")
        store.record("serve_prefill", "kernel", "int64[1,512]", 1e-3 * slow)
        decisions = [{"op": "serve_prefill", "backend": "kernel" if label == "a" else "plain",
                      "source": "measured", "measured_s": 1e-3 * slow}] * 3
        sess = pkg_sess.Session(meta={"schema": pkg_sess.SESSION_SCHEMA, "git_sha": label,
                                      "created_unix": 1.0},
                                events=evs, decisions=decisions, store=store,
                                chip={"name": "h100_sxm"},
                                collector_stats=_norm(col.stats()))
        paths.append(sess.save(str(tmp_path / f"{writer}_{label}.json")))
    return paths


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_sessions_load_report_and_diff_in_both(writer, tmp_path):
    pa, pb = _sessions(writer, tmp_path)
    oa, ob = session.Session.load(pa), session.Session.load(pb)
    ja, jb = jax_session.Session.load(pa), jax_session.Session.load(pb)
    assert _norm(oa.to_dict()) == _norm(ja.to_dict())
    assert _norm(oa.report()) == _norm(ja.report())
    assert oa.tree_report() == ja.tree_report()
    assert oa.path_report() == ja.path_report()
    diff = session.diff_sessions(oa, ob)
    assert _norm(diff) == _norm(jax_session.diff_sessions(ja, jb))
    assert diff["dispatch_choices"]["serve_prefill"]["changed"]
    rows = session.path_diff(oa, ob)
    assert rows == jax_session.path_diff(ja, jb)
    for pct in (5.0, 50.0):
        assert session.session_regressions(diff, pct) == jax_session.session_regressions(
            jax_session.diff_sessions(ja, jb), pct)
        assert session.path_regressions(rows, pct) == jax_session.path_regressions(rows, pct)
    assert session.session_regressions(diff, 5.0)  # the slower prefill trips the gate
    raw_a, raw_b = json.loads(Path(pa).read_text()), json.loads(Path(pb).read_text())
    assert session.is_session(raw_a) and jax_session.is_session(raw_a)
    assert session.diff_artifacts(raw_a, raw_b) == jax_session.diff_artifacts(raw_a, raw_b)
    assert session.artifact_regressions(raw_a, raw_b, 5.0) == \
        jax_session.artifact_regressions(raw_a, raw_b, 5.0)
    # the store rides along: either package's loader reads it out of the session
    assert json.loads(session.load_profile_store(pa).to_json()) == \
        json.loads(jax_session.load_profile_store(pa).to_json())


def test_artifact_meta_stamps_the_card():
    meta = session.artifact_meta({"x": 1})
    assert meta["schema"] == jax_session.ARTIFACT_SCHEMA and meta["chip"]["name"] == "h100_sxm"
    assert meta["x"] == 1 and {"git_sha", "clock", "argv"} <= set(meta)


def _write_stream(pkg_col, pkg_stream, path):
    col = pkg_col.TraceCollector()
    st = pkg_stream.StreamingSession(str(path), rotate_events=7, meta={"driver": "test"})
    st.attach(col)
    script(col, device=True)
    for k in range(2):
        col.record("mark", "late", k, t=101.0 + k)
    # a crash: the open segment is never closed, and its last line is torn
    f = st._seg_file
    f.flush()
    open_name = [n for n in os.listdir(path) if n.endswith(pkg_stream.OPEN_SUFFIX)][0]
    full = path / open_name
    text = full.read_text()
    assert text.count("\n") >= 2
    full.write_text(text[:-15])
    return col


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_torn_stream_compacts_to_equal_sessions(writer, tmp_path):
    pkg = (collector, stream) if writer == "torch" else (jax_collector, jax_stream)
    col = _write_stream(*pkg, tmp_path / "d")
    assert stream.is_stream_dir(str(tmp_path / "d")) and jax_stream.is_stream_dir(str(tmp_path / "d"))
    ours = stream.load_stream(str(tmp_path / "d"))
    theirs = jax_stream.load_stream(str(tmp_path / "d"))
    assert _norm(ours.to_dict()) == _norm(theirs.to_dict())
    assert ours.meta["stream"]["open_segments"] == 1 and ours.meta["stream"]["skipped_lines"] == 1
    # every event but the torn one survives
    assert len(ours.events) == len(col.events()) - 1
    assert [e.t for e in ours.events] == [e.t for e in col.events()[:-1]]
    assert _norm(stream.load_any(str(tmp_path / "d")).report()) == _norm(theirs.report())
    assert stream.load_metrics_timeline(str(tmp_path / "d")) == \
        jax_stream.load_metrics_timeline(str(tmp_path / "d"))


def test_batched_merge_streams_what_one_at_a_time_would(tmp_path):
    """record_many: the same rings, segments (rotation included) and sinks
    as record() per event; an untimed sink runs after the primary sink."""
    evs = [Event(150.0 + 1e-3 * i, "device", f"k{i % 3}",
                 {"dur_s": 1e-4, "device": "cuda:0", "align": "span"}, 900 + i, 200)
           for i in range(23)]
    rows = []
    for way in ("one", "batch"):
        col = collector.TraceCollector()
        st = stream.StreamingSession(str(tmp_path / way), rotate_events=5).attach(col)
        seen: list = []
        col.add_sink(lambda e: seen.append(("untimed", e.name)), sampled=False, timed=False)
        col.add_sink(lambda e: seen.append(("timed", e.name)))
        col.record("spawn", "decode_tick", 1, span=200, parent=0, t=149.0)
        if way == "one":
            for e in evs:
                col.record(e.kind, e.name, e.payload, span=e.span, parent=e.parent, t=e.t)
        else:
            col.record_many(evs)
        st.close()
        rows.append(([json.loads(p.read_text()) if p.suffix == ".json" else p.read_text()
                      for p in sorted((tmp_path / way).iterdir()) if p.name != "MANIFEST.json"],
                     sorted(seen), col.stats()["per_track"]))
    assert rows[0][0] == rows[1][0] and rows[0][1] == rows[1][1] and rows[0][2] == rows[1][2]
    assert len(rows[0][0]) >= 5


def test_stream_rotation_retention_and_tail(tmp_path, capsys):
    col = collector.TraceCollector()
    st = stream.StreamingSession(str(tmp_path / "d"), rotate_events=4, max_segments=2,
                                 metrics_provider=lambda: {"metrics": []}).attach(col)
    script(col)
    st.rotate()
    st.close(stats=col.stats())
    manifest = json.loads((tmp_path / "d" / stream.MANIFEST_NAME).read_text())
    assert manifest["closed"] and len(manifest["segments"]) == 2
    assert manifest["pruned_segments"] > 0 and manifest["schema"] == jax_stream.STREAM_SCHEMA
    assert stream.tail_stream(str(tmp_path / "d"), once=True) == 0
    assert "serve_run" in capsys.readouterr().out


def test_io_and_ready_file(tmp_path):
    atomic_write(str(tmp_path / "a.txt"), "hello")
    assert (tmp_path / "a.txt").read_text() == "hello" and not (tmp_path / "a.txt.tmp").exists()
    write_ready_file(str(tmp_path / "r"), "http://127.0.0.1:1")
    assert read_ready_info(str(tmp_path / "r")) == {"url": "http://127.0.0.1:1"}
    write_ready_file(str(tmp_path / "j"), {"url": "u", "pid": 3})
    assert read_ready_info(str(tmp_path / "j"))["pid"] == 3
    assert wait_for_ready_file(str(tmp_path / "r"), timeout_s=1) == "http://127.0.0.1:1"
    with pytest.raises(TimeoutError):
        wait_for_ready_file(str(tmp_path / "none"), timeout_s=0.1)


# -- the drivers and the CLI ----------------------------------------------------

SERVE = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--requests", "6",
         "--max-new", "6"]
TRACE_FLAGS = ["--trace-rotate", "16", "--trace-rotate-keep", "50", "--trace-capacity", "4096",
               "--trace-overhead-budget-pct", "5", "--torch-profile-backend", "synthetic",
               "--torch-profile-period-s", "0.05"]


def _scrape(ready: Path, got: dict) -> None:
    url = wait_for_ready_file(str(ready), timeout_s=120)
    for path in ("/metrics", "/metrics.json", "/healthz"):
        with urllib.request.urlopen(url + path, timeout=10) as r:
            got[path] = r.read().decode()


def test_serve_driver_traced(tmp_path, capsys):
    """Every trace flag on the CPU (the synthetic backend), a scrape during
    the linger, and the same tokens as an untraced run."""
    plain = serve_cli.main(SERVE + ["--dispatch", "static"])
    got: dict = {}
    scraper = threading.Thread(target=_scrape, args=(tmp_path / "ready", got))
    scraper.start()
    rec = serve_cli.main(SERVE + ["--dispatch", "static", "--trace-out", str(tmp_path / "s.json"),
                                  "--trace-dir", str(tmp_path / "d"), "--metrics-port", "0",
                                  "--ready-file", str(tmp_path / "ready"),
                                  "--metrics-linger-s", "1.5",
                                  "--torch-profile", str(tmp_path / "prof"), *TRACE_FLAGS])
    scraper.join(timeout=60)
    assert not scraper.is_alive()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec
    assert rec["sample"] == plain["sample"] and rec["kernels"] == plain["kernels"]
    assert set(rec) - set(plain) == {"trace", "metrics", "trace_controller", "device_capture",
                                     "trace_dir", "trace_out"}
    cap = rec["device_capture"]
    assert cap["windows"] >= 1 and cap["merged_events"] > 0
    assert cap["align"]["annotated_fraction"] == 1.0 and cap["failed"] is None
    assert rec["trace_controller"]["budget_pct"] == 5.0
    assert rec["metrics"]["repro_requests_total"] == 6
    assert "repro_serve_queue_depth" in got["/metrics"]
    assert "repro_device_capture_windows" in got["/metrics"]
    assert json.loads(got["/healthz"])["ok"] is True
    sess = session.Session.load(rec["trace_out"])
    compact = stream.load_stream(rec["trace_dir"])
    assert [e.t for e in sess.events] == [e.t for e in compact.events]
    assert not {k: v for k, v in sess.report()["dropped_by_track"].items() if v}


def test_serve_driver_untraced_line_is_unchanged(capsys):
    rec = serve_cli.main(SERVE)
    capsys.readouterr()
    assert not {"trace", "metrics", "trace_controller", "device_capture", "trace_dir",
                "trace_out"} & set(rec)


def test_serve_driver_refuses_bad_trace_flags(tmp_path, capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(SERVE + ["--ready-file", str(tmp_path / "r")])
    with pytest.raises(SystemExit):
        serve_cli.main(SERVE + ["--torch-profile-backend", "jax"])
    capsys.readouterr()


def test_train_driver_traced(tmp_path, capsys):
    """The stream rotates at every checkpoint and at the end; the restart
    is a span of the session; the losses equal an untraced run's."""
    argv = ["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--steps", "12",
            "--batch", "2", "--seq", "16", "--ckpt-every", "4", "--fail-at", "7"]
    plain = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    rec = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--trace-out", str(tmp_path / "s.json"),
                                 "--trace-dir", str(tmp_path / "d"), "--trace-rotate", "10000",
                                 "--torch-profile", str(tmp_path / "prof"),
                                 "--torch-profile-backend", "synthetic",
                                 "--torch-profile-period-s", "0.05"])
    capsys.readouterr()
    assert rec["losses"] == plain["losses"] and rec["restarts"] == 1
    sess = session.Session.load(rec["trace_out"])
    names = {s.name for s in sess.spans()}
    assert {"train_run", "step", "checkpoint", "restart"} <= names
    # one segment per checkpoint of step 4, 8, 12 and the end's, each ending on it
    manifest = json.loads((tmp_path / "d" / stream.MANIFEST_NAME).read_text())
    ends = []
    for seg in manifest["segments"]:
        last = json.loads((tmp_path / "d" / seg["name"]).read_text().splitlines()[-1])
        ends.append((last["kind"], last["name"]))
    assert ends.count(("exit", "checkpoint")) == 4, ends
    steps = {s.span for s in sess.spans() if s.name == "step"}
    dev = [e for e in sess.events if e.kind == "device"]
    assert dev and all(e.parent in steps for e in dev)


def test_profile_in_takes_a_session(tmp_path, capsys):
    argv = SERVE + ["--dispatch", "profiled"]
    cold = serve_cli.main(argv + ["--trace-out", str(tmp_path / "s.json")])
    warm = serve_cli.main(argv + ["--profile-in", str(tmp_path / "s.json")])
    capsys.readouterr()
    assert cold["dispatch"]["explore_dispatches"] > 0
    assert warm["dispatch"]["explore_dispatches"] == 0 and warm["profile_aged_out"] == 0
    assert warm["sample"] == cold["sample"]
    # a JAX session's TPU store loads from the same flag, and ages out whole
    jcol = jax_collector.TraceCollector()
    script(jcol)
    tpu = JaxProfileStore()
    tpu.set_stamp(git_sha="0000000", chip="tpu_v5e")
    tpu.record("serve_decode", "chunked", "int32[4]", 1e-3)
    jax_session.Session.capture(jcol, store=tpu).save(str(tmp_path / "jax.json"))
    other = serve_cli.main(argv + ["--profile-in", str(tmp_path / "jax.json")])
    capsys.readouterr()
    assert other["profile_aged_out"] == 1
    with pytest.raises(ValueError, match="no profile store"):
        session.load_profile_store(str(_bare_session(tmp_path)))


def _bare_session(tmp_path):
    col = collector.TraceCollector()
    script(col)
    return session.Session.capture(col).save(str(tmp_path / "bare.json"))


def test_cli_on_port_and_jax_sessions(tmp_path, capsys):
    """report (and --tree), export, diff (with the gate), compact, device,
    metrics and tail on a traced run of the port, on a JAX-written session,
    and the M12 commands (stitch, hops, push-profiles, a two-session
    report) on them."""
    rec = serve_cli.main(SERVE + ["--trace-out", str(tmp_path / "s.json"),
                                  "--trace-dir", str(tmp_path / "d"),
                                  "--torch-profile", str(tmp_path / "prof"), *TRACE_FLAGS])
    capsys.readouterr()
    jcol = jax_collector.TraceCollector()
    script(jcol, device=True)
    jpath = jax_session.Session.capture(jcol).save(str(tmp_path / "jax.json"))
    for target in (rec["trace_out"], rec["trace_dir"], jpath):
        assert trace_main(["report", target]) == 0
        assert trace_main(["report", target, "--tree"]) == 0
        assert trace_main(["device", target, "--json"]) == 0
        out = capsys.readouterr().out
        assert "span tree" in out and '"device_events"' in out
        assert trace_main(["export", target, "--format", "chrome",
                           "-o", str(tmp_path / "c.json")]) == 0
        assert json.loads((tmp_path / "c.json").read_text())["traceEvents"]
    assert trace_main(["diff", rec["trace_out"], rec["trace_dir"], "--fail-over-pct", "1000",
                       "--by-path"]) == 0
    assert trace_main(["diff", rec["trace_out"], jpath, "--json"]) == 0
    assert trace_main(["compact", rec["trace_dir"], "-o", str(tmp_path / "k.json")]) == 0
    assert trace_main(["metrics", rec["trace_dir"]]) == 0
    assert trace_main(["metrics", rec["trace_out"]]) == 0
    assert trace_main(["tail", rec["trace_dir"], "--once"]) == 0
    capsys.readouterr()
    # the M12 commands: a lone streamed run stitches to itself, has no routed
    # request to decompose, and (run without --dispatch) no profiles to push
    stitched = str(tmp_path / "st.json")
    assert trace_main(["stitch", rec["trace_dir"], "-o", stitched, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["stitch"]["inputs"][0]["path"] == rec["trace_dir"]
    assert trace_main(["hops", stitched]) == 1
    assert "no hop decompositions" in capsys.readouterr().err
    assert trace_main(["push-profiles", rec["trace_out"], "--fleet", str(tmp_path / "f")]) == 1
    assert "profile" in capsys.readouterr().err
    # several sessions at once are stitched first (span ids namespaced)
    assert trace_main(["report", rec["trace_out"], jpath]) == 0
    # the same through the module entry point, as a user runs it
    proc = subprocess.run([sys.executable, "-m", "repro_torch.trace", "report", jpath, "--json"],
                          capture_output=True, text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == _norm(jax_session.Session.load(jpath).report())
