"""The port's live device profiler and Kineto adapter on the CPU.

``trace/device.py`` on hand-built ``torch.profiler`` (Kineto) traces: a
``cudaGraphLaunch`` whose kernel nodes share its correlation, a
``cuLaunchKernel`` from ctypes, nested ``span=`` ranges, a launch on a
thread with no range (bound by its host time), a row with no launch, the
device-side copies of the ranges, and a window with no device rows, which
raises.  A real CPU ``torch.profiler`` window through the ``torch``
backend pins the file format.  ``trace/liveprof.py``: the synthetic
backend merges the JAX one's slices; windows pause around a CUDA graph
capture; the synthetic backend is refused on a CUDA device; on a strict
backend a window that cannot start, or a run whose windows all come back
without device rows, fails the run.
"""
import gzip
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.trace.collector import TraceCollector as JaxTraceCollector  # noqa: E402
from repro.trace.liveprof import LiveDeviceProfiler as JaxLiveDeviceProfiler  # noqa: E402
from repro_torch.core.events import Event  # noqa: E402
from repro_torch.metrics import MetricsPlane  # noqa: E402
from repro_torch.trace import device, liveprof  # noqa: E402
from repro_torch.trace.collector import TraceCollector  # noqa: E402
from repro_torch.trace.session import Session  # noqa: E402

PID, MAIN, OTHER = 4242, 4242, 99
SHIFT = 5.0  # the hand-built trace's clock runs 5 s ahead of the host's


def us(t_host: float) -> float:
    return (t_host + SHIFT) * 1e6


def host_events() -> list[Event]:
    return [
        Event(9.0, "spawn", "serve_run", None, 1, 0),
        Event(10.000, "spawn", "decode_tick", 8, 100, 1),
        Event(10.008, "dispatch", "serve_decode",
              {"op": "serve_decode", "backend": "kernel", "measured_s": 0.007}, 101, 100),
        Event(10.010, "exit", "decode_tick", 8, 100, 1),
        Event(10.020, "spawn", "prefill", 0, 102, 1),
        Event(10.030, "exit", "prefill", 0, 102, 1),
        Event(11.0, "exit", "serve_run", None, 1, 0),
    ]


def kineto_rows() -> list[dict]:
    def x(cat, name, t, dur_us, pid=PID, tid=MAIN, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": us(t),
                "dur": dur_us, "args": args}

    kernel = dict(pid=0, tid=7, device=0, stream=7)
    return [
        {"ph": "M", "name": "process_name", "pid": PID, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        x("cpu_op", "span=100", 10.000, 10000),
        x("cpu_op", "span=101", 10.001, 7000),
        x("cpu_op", "aten::argmax", 10.0082, 50),
        x("cuda_runtime", "cudaGraphLaunch", 10.002, 20, correlation=10),
        *[x("kernel", name, 10.003 + 0.001 * j, 400, correlation=10, **kernel)
          for j, name in enumerate(("flash_fwd_mma<64>", "decode_split_mma<64>",
                                    "rmsnorm_rows<__nv_bfloat16, 2, true>"))],
        x("cuda_driver", "cuLaunchKernel", 10.0085, 5, correlation=11),
        x("kernel", "decode_combine_kernel", 10.0095, 30, correlation=11, **kernel),
        x("cuda_runtime", "cudaMemcpyAsync", 10.0087, 5, correlation=13),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 10.0099, 2, correlation=13, **kernel),
        x("cuda_runtime", "cudaLaunchKernel", 10.025, 5, tid=OTHER, correlation=12),
        x("kernel", "argmax_kernel", 10.026, 8, correlation=12, **kernel),
        x("kernel", "orphan_kernel", 10.5, 10, correlation=99, **kernel),
        # the device-side copy of a host range is not a host range
        x("gpu_user_annotation", "span=100", 10.004, 9000, pid=0, tid=7),
    ]


def write_trace(path, rows) -> str:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": rows}))
    return str(path)


def test_kineto_trace_binds_each_kernel_through_its_launch(tmp_path):
    win = device.load_window(write_trace(tmp_path / "w" / "seg-00" / "window.trace.json",
                                         kineto_rows()))
    assert win.launches == 4 and len(win.slices) == 7
    assert sorted(win.ranges) == [(100, pytest.approx(15.0)), (101, pytest.approx(15.001))]
    by_name = {s.name: s for s in win.slices}
    assert by_name["flash_fwd_mma<64>"].launch == "cudaGraphLaunch"
    assert by_name["decode_combine_kernel"].launch == "cuLaunchKernel"
    assert by_name["flash_fwd_mma<64>"].device == "cuda:0"
    offset = device.estimate_offset(host_events(), win.ranges)
    assert offset == pytest.approx(-SHIFT, abs=1e-9)
    stats: dict = {}
    merged = device.align_device_slices(host_events(), win.slices, ranges=win.ranges, stats=stats)
    got = {e.name: (e.parent, e.payload["align"]) for e in merged}
    assert got == {
        "flash_fwd_mma<64>": (101, "span"), "decode_split_mma<64>": (101, "span"),
        "rmsnorm_rows<__nv_bfloat16, 2, true>": (101, "span"),  # one graph, one dispatch
        "decode_combine_kernel": (100, "span"),  # ctypes launch after the dispatch closed
        "Memcpy DtoH (Device -> Pinned)": (100, "span"),
        "argmax_kernel": (102, "launch"),  # no range on its thread: by launch time
        "orphan_kernel": (1, "window"),  # no launch: by its own time
    }
    assert stats == {"span": 5, "launch": 1, "window": 1, "total": 7}
    ev = next(e for e in merged if e.name == "flash_fwd_mma<64>")
    assert ev.t == pytest.approx(10.003) and ev.payload["dur_s"] == pytest.approx(4e-4)
    assert ev.payload["args"] == {"correlation": 10, "stream": 7, "span": 101,
                                  "launch": "cudaGraphLaunch"}
    assert all(e.span > 102 for e in merged)  # fresh ids above the host's
    summary = device.alignment_summary(merged)
    assert summary["annotated_fraction"] == pytest.approx(5 / 7)


def test_merge_device_trace_into_a_session(tmp_path):
    path = write_trace(tmp_path / "w.trace.json", kineto_rows())
    sess = Session(meta={}, events=host_events())
    assert device.merge_device_trace(sess, path) == 7
    tree = {r["name"]: r["depth"] for r in sess.tree_report()}
    assert tree["decode_tick"] == 1 and tree["serve_decode"] == 2
    assert tree["flash_fwd_mma<64>"] == 3 and tree["decode_combine_kernel"] == 2
    assert sess.meta["device_trace"]["align"]["span"] == 5


def test_window_without_device_rows_raises(tmp_path):
    rows = [r for r in kineto_rows() if r.get("cat") not in device.DEVICE_CATEGORIES]
    path = write_trace(tmp_path / "w" / "window.trace.json", rows)
    with pytest.raises(device.NoDeviceRows) as info:
        device.load_profiler_trace(str(tmp_path / "w"))
    assert info.value.launches == 4
    with pytest.raises(ValueError, match="offset"):
        device.estimate_offset([Event(1.0, "mark", "x")], [(5, 1.0)])
    with pytest.raises(FileNotFoundError):
        device.load_window(str(tmp_path / "empty_dir_that_does_not_exist"))
    assert os.path.exists(path)


def test_torch_backend_cpu_window_pins_the_format(tmp_path):
    """A real torch.profiler session on the CPU: a Chrome trace whose
    annotated ranges are function-scope cpu_op rows named span=<id>, in
    microseconds; no device rows, so the window is counted empty."""
    backend = liveprof.TorchProfilerBackend(torch.device("cpu"))
    assert not backend.strict
    backend.warm()
    col = TraceCollector()
    liveprof.set_annotations(True)
    try:
        seg = tmp_path / "seg-00"
        seg.mkdir()
        backend.start(str(seg))
        for sid in (7001, 7002):
            col.record("spawn", "decode_tick", sid, span=sid)
            with liveprof.device_annotation(sid):
                torch.ones(8).add_(1)
            col.record("exit", "decode_tick", sid, span=sid)
        backend.stop()
    finally:
        liveprof.set_annotations(False)
    doc = json.loads((seg / "window.trace.json").read_text())
    rows = [r for r in doc["traceEvents"] if r.get("ph") == "X"]
    spans = [r for r in rows if r["name"].startswith("span=")]
    assert [r["name"] for r in spans] == ["span=7001", "span=7002"]
    assert all(r["cat"] == "cpu_op" and isinstance(r["ts"], (int, float)) for r in spans)
    assert any(r["name"].startswith("aten::") and r["tid"] == spans[0]["tid"] for r in rows)
    with pytest.raises(device.NoDeviceRows) as info:
        device.load_window(str(tmp_path))
    assert info.value.launches == 0
    ranges = device._parse_trace_file(str(seg / "window.trace.json")).ranges
    offset = device.estimate_offset(col.events(), ranges)
    spawns = {e.span: e.t for e in col.events(kind="spawn")}
    for sid, t in ranges:  # each range lands on its span's start, within 5 ms
        assert abs(t + offset - spawns[sid]) < 5e-3


def test_device_annotation_is_free_when_off():
    assert not liveprof.annotations_enabled()
    ctx = liveprof.device_annotation(5)
    assert type(ctx).__name__ == "nullcontext"
    liveprof.set_annotations(True)
    try:
        assert type(liveprof.device_annotation(5)).__name__ == "RecordFunctionFast"
        assert type(liveprof.device_annotation(0)).__name__ == "nullcontext"
    finally:
        liveprof.set_annotations(False)


def _drive(col, t0: float) -> None:
    """Two prefills and two ticks with their dispatches, hand-timed."""
    for i in range(2):
        s = 50 + i
        col.record("spawn", "prefill", i, span=s, parent=0, t=t0 + 0.01 * i)
        col.record("dispatch", "serve_prefill", {"op": "serve_prefill", "measured_s": 0.004},
                   span=60 + i, parent=s, t=t0 + 0.01 * i + 0.005)
        col.record("exit", "prefill", i, span=s, parent=0, t=t0 + 0.01 * i + 0.006)
    for k in range(2):
        s = 70 + k
        col.record("spawn", "decode_tick", 2, span=s, parent=0, t=t0 + 0.05 + 0.01 * k)
        col.record("exit", "decode_tick", 2, span=s, parent=0, t=t0 + 0.055 + 0.01 * k)
    col.record("spawn", "prefill", 9, span=90, parent=0, t=t0 + 0.1)  # still open at close


def test_synthetic_profiler_merges_the_jax_ones_slices(tmp_path):
    got = []
    for cls, col in ((liveprof.LiveDeviceProfiler, TraceCollector()),
                     (JaxLiveDeviceProfiler, JaxTraceCollector())):
        ids = iter(range(10_000, 20_000))
        prof = cls(col, str(tmp_path / cls.__module__), backend="synthetic",
                   id_alloc=lambda: next(ids))
        assert prof.open_window()
        _drive(col, 100.0)
        assert prof.close_window() == 6
        got.append(sorted((e.t, e.name, e.parent, json.dumps(e.payload, sort_keys=True))
                          for e in col.events(kind="device")))
        assert prof.snapshot()["align"]["annotated_fraction"] == 1.0
    assert got[0] == got[1] and len(got[0]) == 6


def test_windows_pause_around_a_capture(tmp_path):
    col = TraceCollector()
    plane = MetricsPlane(col)
    prof = liveprof.LiveDeviceProfiler(col, str(tmp_path), backend="synthetic", period_s=10.0,
                                       registry=plane.registry).start()
    assert liveprof.annotations_enabled()
    col.record("spawn", "prefill", 0, span=1, parent=0)
    col.record("exit", "prefill", 0, span=1, parent=0)  # a boundary: the window opens
    assert prof._window_open and prof._session_open
    col.record("spawn", "prefill", 1, span=2, parent=0)
    with liveprof.capture_guard():
        assert not prof._session_open
        col.record("exit", "decode_tick", 0, span=3, parent=0)  # no session during a capture
        assert not prof._session_open
    col.record("exit", "prefill", 1, span=2, parent=0)  # the next boundary resumes it
    assert prof._session_open
    col.record("spawn", "decode_tick", 1, span=4, parent=0)
    col.record("exit", "decode_tick", 1, span=4, parent=0)
    prof.stop()
    assert not liveprof.annotations_enabled()
    (win,) = prof.windows
    assert win["segments"] == 2 and win["events"] == 1  # the tick after the capture
    assert {"start_ms", "stop_ms", "parse_ms", "align_ms"} <= set(win)
    assert sorted(os.listdir(tmp_path / win["dir"])) == ["seg-00", "seg-01"]
    assert prof.snapshot()["windows"] == 1
    assert "repro_device_capture_coverage" in plane.render()


def test_synthetic_backend_is_refused_on_a_cuda_device(tmp_path):
    with pytest.raises(liveprof.DeviceCaptureUnavailable, match="CPU device only"):
        liveprof.LiveDeviceProfiler(TraceCollector(), str(tmp_path), device="cuda",
                                    backend="synthetic")
    with pytest.raises(liveprof.DeviceCaptureUnavailable, match="unknown"):
        liveprof.make_backend("jax", TraceCollector(), torch.device("cpu"))
    assert isinstance(liveprof.make_backend("auto", None, torch.device("cpu")),
                      liveprof.TorchProfilerBackend)


class LaunchesOnly:
    """A strict backend whose sessions see launches but no device rows (the
    card's activity missing), or whose start fails."""

    name, offset_s, strict = "fake", None, True

    def __init__(self, fail_start: bool = False) -> None:
        self.fail_start = fail_start

    def start(self, segment_dir: str) -> None:
        if self.fail_start:
            raise RuntimeError("CUPTI unavailable")
        self.dir = segment_dir

    def stop(self) -> None:
        rows = [r for r in kineto_rows() if r.get("cat") not in device.DEVICE_CATEGORIES]
        with gzip.open(os.path.join(self.dir, "w.trace.json.gz"), "wt") as f:
            json.dump({"traceEvents": rows}, f)


@pytest.mark.parametrize("fail_start", [False, True])
def test_strict_capture_failures_fail_the_run(tmp_path, fail_start):
    col = TraceCollector()
    prof = liveprof.LiveDeviceProfiler(col, str(tmp_path), backend=LaunchesOnly(fail_start),
                                       period_s=0.01).start()
    for i in range(3):
        col.record("spawn", "step", i, span=10 + i, parent=0)
        col.record("exit", "step", i, span=10 + i, parent=0)
    with pytest.raises(RuntimeError, match="device capture failed"):
        prof.stop()
    if not fail_start:
        assert prof.no_device_rows >= 1 and prof.merged_events == 0
        assert not col.events(kind="device")  # nothing host-side merged as device time


def test_torch_backend_on_the_cpu_counts_empty_windows(tmp_path):
    col = TraceCollector()
    prof = liveprof.LiveDeviceProfiler(col, str(tmp_path), backend="torch",
                                       period_s=0.01).start()
    for i in range(3):
        col.record("spawn", "decode_tick", i, span=10 + i, parent=0)
        with liveprof.device_annotation(10 + i):
            torch.ones(4).mul_(2)
        col.record("exit", "decode_tick", i, span=10 + i, parent=0)
    prof.stop()
    snap = prof.snapshot()
    assert snap["windows"] >= 1 and snap["empty_windows"] == snap["windows"]
    assert snap["failed"] is None and snap["merged_events"] == 0
