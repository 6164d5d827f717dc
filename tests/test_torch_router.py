"""The port's router (``repro_torch.router``) against the JAX package's
``repro.router``: cost model, admission control, exactly-once drain-retry.

Everything ``tests/test_router.py`` holds of the JAX package is held of the
port, accelerator-free: unit tests drive the CostRouter and an in-process
synthetic replica directly; the end-to-end test spawns ``python -m
repro_torch.router`` with synthetic replicas and SIGKILLs one mid-run.  Then
the two packages together: both CostRouters make the same decisions on one
scripted signal sequence, and a port replica over a reduced qwen2 engine on
the CPU answers ``/v1/generate`` with the JAX replica's tokens (the same
weights through ``params_from_jax``).  And a real port replica process on
the CPU: it warm-starts from and pushes to a fleet, and reports its launch
counts; asked for the card where there is none, it fails.  Every blocking
call carries its own timeout.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from repro_torch.dispatch.profiles import ProfileStore  # noqa: E402
from repro_torch.metrics import MetricsPlane  # noqa: E402
from repro_torch.router import (  # noqa: E402
    CostRouter,
    NoReplicaAvailable,
    ReplicaServer,
    RouterBusy,
    SyntheticEngine,
    class_of,
    expected_synthetic_tokens,
    seed_costs_from_store,
)
from repro_torch.router.loadgen import build_specs, run as loadgen_run  # noqa: E402
from repro_torch.trace.collector import TraceCollector  # noqa: E402
from repro_torch.utils.ready import read_ready_info, wait_for_ready_file, write_ready_file  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Request classes + fleet-profile seed pricing
# ---------------------------------------------------------------------------


def test_class_of_pow2_buckets():
    assert class_of(8, 16) == "p8/n16"
    assert class_of(9, 16) == "p16/n16"   # rounds up to the next power of two
    assert class_of(16, 17) == "p16/n32"
    assert class_of(1, 1) == "p1/n1"


def _seeded_store(prefill_s: float, decode_s: float, plen: int = 16) -> ProfileStore:
    store = ProfileStore(min_samples=1)
    store.record("serve_prefill", "chunked", f"int32[1,{plen}]", prefill_s)
    store.record("serve_decode", "chunked", "int32[4,1]", decode_s)
    return store


def test_seed_costs_priced_from_profile_store():
    store = _seeded_store(0.010, 0.002, plen=16)
    # a second, slower backend must not win the pricing (min over backends)
    store.record("serve_prefill", "ref", "int32[1,16]", 0.050)
    seed = seed_costs_from_store(store, match="exact")
    assert seed is not None and seed.match == "exact"
    assert seed.prefill_s == {16: pytest.approx(0.010)}
    assert seed.cost("p16/n8") == pytest.approx(0.010 + 8 * 0.002)
    # nearest prompt length is used when the class has no exact entry
    assert seed.cost("p32/n8") == pytest.approx(0.010 + 8 * 0.002)


def test_seed_costs_none_when_unpriceable():
    assert seed_costs_from_store(None) is None
    assert seed_costs_from_store(ProfileStore()) is None
    store = ProfileStore(min_samples=1)
    store.record("serve_prefill", "chunked", "int32[1,16]", 0.01)  # no decode
    assert seed_costs_from_store(store) is None


# ---------------------------------------------------------------------------
# CostRouter: argmin, tie-break, admission, EWMA feedback
# ---------------------------------------------------------------------------


def _router(**kw) -> CostRouter:
    r = CostRouter(**kw)
    for name in ("r0", "r1"):
        r.add_replica(name)
        r.mark_up(name, f"http://{name}")
    return r


def test_route_argmin_over_fleet_seeds():
    r = _router()
    r.seed_replica("r0", _seeded_store(0.010, 0.001))   # cheap chip
    r.seed_replica("r1", _seeded_store(0.040, 0.008))   # slow chip
    picks = {r.route("p16/n16").replica for _ in range(8)}
    assert picks == {"r0"}
    d = r.route("p16/n16")
    assert d.source == "seed" and d.cost_s == pytest.approx(0.010 + 16 * 0.001)


def test_route_least_loaded_tie_break():
    r = _router()  # both cold -> identical default cost -> always a tie
    r.begin("r0")
    r.begin("r0")
    assert all(r.route("p8/n8").replica == "r1" for _ in range(4))
    # balance restored -> round-robin spreads across both again
    r.begin("r1")
    r.begin("r1")
    assert {r.route("p8/n8").replica for _ in range(4)} == {"r0", "r1"}


def test_admission_sheds_when_all_queues_full():
    r = _router(queue_depth=2)
    for _ in range(2):
        r.begin("r0")
        r.begin("r1")
    with pytest.raises(RouterBusy):
        r.route("p8/n8")
    assert r.rejected == 1
    r.end("r1")  # one slot frees -> admits again, onto the freed replica
    assert r.route("p8/n8").replica == "r1"


def test_no_replica_available_when_all_down():
    r = _router()
    r.mark_down("r0")
    r.fail("r1", dead=True)  # dead forward also unroutes the replica
    with pytest.raises(NoReplicaAvailable):
        r.route("p8/n8")
    r.mark_up("r0", "http://r0")
    assert r.route("p8/n8").replica == "r0"


def test_ewma_feedback_overrides_seed():
    r = _router()
    r.seed_replica("r0", _seeded_store(0.001, 0.0001))  # seed says r0 is fast
    r.seed_replica("r1", _seeded_store(0.002, 0.0002))
    # ...but observed service times say the opposite (r0 loaded/thermal)
    for _ in range(4):
        r.complete("r0", "p16/n16", 0.500)
        r.complete("r1", "p16/n16", 0.050)
    d = r.route("p16/n16")
    assert d.replica == "r1" and d.source == "ewma"
    snap = r.snapshot()["replicas"]
    assert snap["r0"]["ewma_ms"]["p16/n16"] > snap["r1"]["ewma_ms"]["p16/n16"]


def test_router_maintains_registry_gauges():
    from repro_torch.metrics.registry import MetricsRegistry

    reg = MetricsRegistry()
    r = CostRouter(registry=reg)
    r.add_replica("r0")
    r.mark_up("r0", "http://r0")
    r.begin("r0")
    text = reg.render()
    assert 'repro_router_replica_queue_depth{replica="r0"} 1' in text
    assert 'repro_router_replica_up{replica="r0"} 1' in text
    r.end("r0")
    r.mark_down("r0")
    text = reg.render()
    assert 'repro_router_replica_queue_depth{replica="r0"} 0' in text
    assert 'repro_router_replica_up{replica="r0"} 0' in text


# ---------------------------------------------------------------------------
# Trace/metrics planes: route events land on the router track and derive
# the repro_router_* series
# ---------------------------------------------------------------------------


def test_route_events_derive_router_metrics():
    col = TraceCollector()
    plane = MetricsPlane(col)
    for outcome, ms in (("ok", 0.2), ("ok", 0.4), ("retried", 0.3)):
        col.record("route", "outcome",
                   {"replica": "r0", "outcome": outcome, "route_ms": ms})
    # per-attempt decision events must NOT count requests (retries overcount)
    col.record("route", "route", {"replica": "r0", "class": "p8/n8"})
    assert all(e.kind == "route" for e in col.tracks()["router"])
    text = plane.render()
    assert 'repro_router_requests_total{outcome="ok",replica="r0"} 2' in text
    assert 'repro_router_requests_total{outcome="retried",replica="r0"} 1' in text
    assert "repro_router_route_ms_count 3" in text


# ---------------------------------------------------------------------------
# Shared ready-file handshake (repro_torch.utils.ready)
# ---------------------------------------------------------------------------


def test_ready_file_roundtrip(tmp_path):
    p = str(tmp_path / "x.ready")
    write_ready_file(p, {"url": "http://127.0.0.1:1234", "pid": 42})
    info = read_ready_info(p)
    assert info["url"] == "http://127.0.0.1:1234" and info["pid"] == 42
    assert json.loads(wait_for_ready_file(p, timeout_s=1.0))["url"] == info["url"]
    # bare-URL form (repro_torch.fleet serve writes this)
    write_ready_file(p, "http://127.0.0.1:9")
    assert read_ready_info(p) == {"url": "http://127.0.0.1:9"}
    with pytest.raises(TimeoutError):
        wait_for_ready_file(str(tmp_path / "never.ready"), timeout_s=0.2)


# ---------------------------------------------------------------------------
# In-process synthetic replica: deterministic tokens over HTTP
# ---------------------------------------------------------------------------


def test_replica_server_roundtrip_and_health():
    col = TraceCollector()
    plane = MetricsPlane(col)
    eng = SyntheticEngine(max_batch=2, ms_per_token=0.0, log=col,
                          metrics=plane.registry)
    srv = ReplicaServer(eng, name="t0", log=col, plane=plane,
                        info={"chip": "test"}).start()
    try:
        body = json.dumps({"prompt": [1, 2, 3], "max_new": 5}).encode()
        req = urllib.request.Request(
            f"{srv.url}/v1/generate", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            doc = json.loads(resp.read())
        assert doc["tokens"] == expected_synthetic_tokens([1, 2, 3], 5)
        assert doc["replica"] == "t0"
        with urllib.request.urlopen(f"{srv.url}/healthz", timeout=10) as resp:
            h = json.loads(resp.read())
        assert h["ok"] and h["completed"] == 1 and h["chip"] == "test"
        with urllib.request.urlopen(f"{srv.url}/metrics", timeout=10) as resp:
            assert b"repro_requests_total" in resp.read()
    finally:
        srv.stop()
    # the engine's request span nests under the handler's rpc span, which
    # nests under the replica's serve_run root
    spawns = {e.span: (e.name, e.parent) for e in col.events() if e.kind == "spawn"}
    req_spans = [s for s, (n, _p) in spawns.items() if n == "request"]
    assert req_spans and all(
        spawns[spawns[s][1]][0] == "rpc" for s in req_spans)
    assert all(
        spawns[spawns[spawns[s][1]][1]][0] == "serve_run" for s in req_spans)


def test_synthetic_engine_concurrent_submit_exactly_once():
    eng = SyntheticEngine(max_batch=4, ms_per_token=0.0)
    rids: list[int] = []
    lock = threading.Lock()

    def submit(i):
        rid = eng.submit([i, i + 1], max_new=3)
        with lock:
            rids.append(rid)

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(rids) == list(range(16))  # no rid reuse under contention
    done = []
    while eng.pending():
        done.extend(eng.step())
    assert len(done) == 16
    for r in done:
        assert r.out == expected_synthetic_tokens(r.prompt, r.max_new)


# ---------------------------------------------------------------------------
# End to end: router subprocess, SIGKILL a replica mid-run, exactly-once
# ---------------------------------------------------------------------------


def test_router_sigkill_replica_exactly_once(tmp_path):
    """The CI router-smoke scenario, as a test: 2 synthetic replicas behind
    the front door, SIGKILL one mid-run, every request completes exactly once
    with verifiably-correct tokens, and the dead replica is restarted."""
    trace_dir = str(tmp_path / "trace")
    ready = str(tmp_path / "router.ready")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.router", "--replicas", "2",
         "--synthetic", "--synthetic-ms-per-token", "5",
         "--port", "0", "--ready-file", ready,
         "--workdir", str(tmp_path / "work"), "--trace-dir", trace_dir],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    report = None
    try:
        wait_for_ready_file(ready, timeout_s=120, proc=proc)
        url = read_ready_info(ready)["url"]

        def healthz():
            with urllib.request.urlopen(f"{url}/healthz", timeout=10) as resp:
                return json.loads(resp.read())

        victim_pid = healthz()["replicas"]["r0"]["pid"]
        specs = build_specs(120, [8, 16, 32], 16, seed=1)
        result: dict = {}

        def drive():
            result["report"] = loadgen_run(url, specs, concurrency=8,
                                           timeout_s=60, verify_synthetic=True)

        t = threading.Thread(target=drive, daemon=True)
        t.start()
        # let some requests land on r0, then kill it mid-run
        deadline = time.time() + 60
        while time.time() < deadline:
            h = healthz()
            if h["router"]["replicas"]["r0"]["completed"] >= 3:
                break
            time.sleep(0.05)
        else:
            pytest.fail("r0 served nothing within 60s")
        os.kill(victim_pid, signal.SIGKILL)
        t.join(timeout=120)
        assert not t.is_alive(), "loadgen did not finish"
        report = result["report"]

        # exactly-once: every request accounted, none duplicated or lost,
        # every completed response carries the deterministic expected tokens
        assert report["completed"] == report["submitted"] == 120
        assert report["duplicates"] == 0 and report["lost"] == 0
        assert report["verify_failures"] == 0 and report["verified"] == 120

        # supervisor restarts the killed replica (new pid, routable again)
        deadline = time.time() + 60
        while time.time() < deadline:
            h = healthz()
            r0 = h["replicas"]["r0"]
            if r0["state"] == "up" and r0["restarts"] >= 1 \
                    and r0["pid"] != victim_pid:
                break
            time.sleep(0.2)
        else:
            pytest.fail(f"r0 not restarted: {healthz()['replicas']}")

        # metrics account for every request: sum over outcomes == submitted
        with urllib.request.urlopen(f"{url}/metrics", timeout=10) as resp:
            text = resp.read().decode()
        total = sum(
            float(line.rsplit(" ", 1)[1])
            for line in text.splitlines()
            if line.startswith("repro_router_requests_total{"))
        assert total == 120
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()

    # the streamed trace survives: route spans parent under request spans
    out = str(tmp_path / "session.json")
    from repro_torch.trace.cli import main as trace_main

    assert trace_main(["compact", trace_dir, "-o", out]) == 0
    doc = json.load(open(out))
    evs = doc["trace"]["events"]
    req_spans = {e["span"] for e in evs
                 if e["kind"] == "spawn" and e["name"] == "request"}
    routes = [e for e in evs if e["kind"] == "route"]
    outcomes = [e for e in routes if e["name"] == "outcome"]
    assert len(outcomes) == 120
    assert routes and all(e["parent"] in req_spans for e in routes)
    assert sum(1 for e in outcomes if e["payload"]["outcome"] == "retried") \
        == report["outcomes"]["retried"]


# ---------------------------------------------------------------------------
# The two packages together
# ---------------------------------------------------------------------------


def _scripted_decisions(cost_mod, profiles_mod) -> list:
    """One scripted signal sequence through a package's CostRouter: fleet
    seeds (two chips' profiles and a replica without one), ties, loads,
    EWMA feedback, a dead forward, a restart and admission control; every
    decision (or the refusal) in order."""
    def seeded(prefill_s: dict, decode_s: float):
        st = profiles_mod.ProfileStore(min_samples=1)
        for plen, sec in prefill_s.items():
            st.record("serve_prefill", "kernel", f"int64[1,{plen}]", sec)
            st.record("serve_prefill", "plain", f"int64[1,{plen}]", 2 * sec)
        st.record("serve_decode", "kernel", "int64[8];int32[8]", decode_s)
        return st

    out: list = []
    r = cost_mod.CostRouter(queue_depth=3, ewma_alpha=0.5, tie_rel=0.1)
    for name in ("r0", "r1", "r2"):
        r.add_replica(name)
    r.seed_replica("r0", seeded({64: 0.010, 512: 0.040}, 0.002), match="exact")
    r.seed_replica("r1", seeded({64: 0.012, 512: 0.030}, 0.0021), match="chip")
    r.seed_replica("r2", None)
    for name in ("r0", "r1", "r2"):
        r.mark_up(name, f"http://{name}")

    def route(cls):
        try:
            d = r.route(cls)
        except (cost_mod.RouterBusy, cost_mod.NoReplicaAvailable) as exc:
            out.append(type(exc).__name__)
            return None
        out.append((d.replica, d.url, d.cls, round(d.cost_s, 12), d.source, d.inflight))
        return d

    classes = [cost_mod.class_of(p, n) for p, n in ((64, 32), (512, 32), (100, 8), (9, 1))]
    for cls in classes * 2:
        route(cls)
    for name in ("r0", "r1") * 3:  # both seeded replicas full: the cold one
        r.begin(name)
    route(classes[0])
    for name in ("r0", "r1") * 3:
        r.end(name)
    for _ in range(3):
        d = route(classes[1])
        r.begin(d.replica)
    for cls in classes:
        route(cls)
    for i, (name, sec) in enumerate((("r0", 0.9), ("r1", 0.05), ("r2", 0.2), ("r1", 0.07))):
        r.end(name) if i < 3 else None
        r.complete(name, classes[i % 2], sec)
    for cls in classes:
        route(cls)
    r.fail("r1", dead=True)
    for cls in classes:
        route(cls)
    for name in ("r0", "r2", "r0", "r2", "r0", "r2"):
        r.begin(name)
    route(classes[0])
    r.mark_down("r0")
    r.mark_down("r2")
    route(classes[0])
    r.mark_up("r1", "http://r1b")
    for cls in classes:
        route(cls)
    snap = r.snapshot()
    out.append((snap["rejected"], sorted((k, v["healthy"], v["inflight"], v["completed"],
                                          v["failed"], v["ewma_ms"], v["seeded"],
                                          v["seed_match"]) for k, v in snap["replicas"].items())))
    return out


def test_cost_routers_of_both_packages_decide_alike():
    from repro.dispatch import profiles as jax_profiles
    from repro.router import cost as jax_cost
    from repro_torch.dispatch import profiles
    from repro_torch.router import cost

    ours = _scripted_decisions(cost, profiles)
    assert ours == _scripted_decisions(jax_cost, jax_profiles)
    sources = {d[4] for d in ours if isinstance(d, tuple) and len(d) == 6}
    assert sources == {"seed", "cold", "ewma", "ewma-any"}
    assert "RouterBusy" in ours and "NoReplicaAvailable" in ours


def _post(url: str, prompt: list, max_new: int) -> dict:
    req = urllib.request.Request(
        f"{url}/v1/generate", data=json.dumps({"prompt": prompt, "max_new": max_new}).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_port_replica_answers_with_the_jax_replicas_tokens():
    """A port ReplicaServer over a reduced qwen2 Engine on the CPU and the
    JAX ReplicaServer over the JAX Engine, the same weights: the same tokens
    for every prompt, one at a time and two at once."""
    import jax
    import numpy as np

    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.metrics import MetricsPlane as JaxMetricsPlane
    from repro.models import lm as jax_lm
    from repro.router.replica import ReplicaServer as JaxReplicaServer
    from repro.serving.engine import Engine as JaxEngine
    from repro.serving.engine import ServeConfig as JaxServeConfig
    from repro.trace import TraceCollector as JaxTraceCollector
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serving.engine import Engine, ServeConfig

    jcfg = jax_reduced(jax_get_config("qwen2-0.5b"))
    jp = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen2-0.5b"))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jlog, log = JaxTraceCollector(), TraceCollector()
    servers = {
        "jax": JaxReplicaServer(
            JaxEngine(jcfg, jp, JaxServeConfig(max_batch=2, max_seq=64), log=jlog),
            name="j0", log=jlog, plane=JaxMetricsPlane(jlog)),
        "port": ReplicaServer(
            Engine(cfg, p, ServeConfig(max_batch=2, max_seq=64), log=log),
            name="t0", log=log, plane=MetricsPlane(log)),
    }
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 12, 12, 20)]
    replies: dict = {}
    try:
        for name, srv in servers.items():
            srv.start()
            alone = [_post(srv.url, pr, 6)["tokens"] for pr in prompts]
            together: list = [None, None]

            def send(i, url=srv.url, out=together):
                out[i] = _post(url, prompts[i], 6)["tokens"]

            threads = [threading.Thread(target=send, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            replies[name] = (alone, together)
    finally:
        for srv in servers.values():
            srv.stop()
    assert replies["port"] == replies["jax"]
    assert all(len(t) == 6 for t in replies["port"][0])
    # the port replica's request spans nest as the JAX replica's do:
    # serve_run -> rpc -> request -> prefill
    spawns = {e.span: (e.name, e.parent) for e in log.events() if e.kind == "spawn"}
    prefills = [s for s, (n, _) in spawns.items() if n == "prefill"]
    assert len(prefills) == 6
    for s in prefills:
        req = spawns[s][1]
        rpc = spawns[req][1]
        assert (spawns[req][0], spawns[rpc][0], spawns[spawns[rpc][1]][0]) == \
            ("request", "rpc", "serve_run")


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _healthz(url: str) -> dict:
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
        return json.loads(resp.read())


def test_real_cpu_replicas_warm_start_from_and_push_to_the_fleet(tmp_path):
    """``python -m repro_torch.router`` with one real replica of reduced
    qwen2 on the CPU (``--dispatch profiled --fleet DIR``): its ``/healthz``
    carries the launch counts, the tiers and the dispatcher's summary and
    stamps the chip and SHA the port's dispatcher stamps; at the router's
    SIGTERM the replica pushes its profiles; a second replica started with
    the same ``--fleet`` pulls an exact match and explores nothing."""
    from repro_torch.fleet import FleetClient
    from repro_torch.hw.specs import default_chip
    from repro_torch.trace.session import git_sha

    fleet = str(tmp_path / "fleet")
    ready = str(tmp_path / "router.ready")
    engine_flags = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                    "--max-batch", "2", "--max-seq", "64", "--dispatch", "profiled"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.router", "--replicas", "1", "--port", "0",
         "--ready-file", ready, "--workdir", str(tmp_path / "work"), "--fleet", fleet,
         *engine_flags],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        wait_for_ready_file(ready, timeout_s=120, proc=proc)
        url = read_ready_info(ready)["url"]
        # reduced qwen2's vocabulary is smaller than loadgen's token range
        specs = [{"prompt": [(7 * i + 3 * j) % 256 for j in range(n)], "max_new": 4}
                 for i, n in enumerate((8, 16, 8, 16))]
        report = loadgen_run(url, specs, concurrency=2, timeout_s=120, keep_tokens=True)
        assert report["completed"] == 4 and report["duplicates"] == 0
        # each reply's trace id and the latency this client measured
        assert len(set(report["traces"])) == 4 and None not in report["traces"]
        assert all(ms > 0 for ms in report["client_ms"])
        r0 = _healthz(url)["replicas"]["r0"]
        assert (r0["chip"], r0["git_sha"]) == (default_chip().name, git_sha())
        h = _healthz(read_ready_info(str(tmp_path / "work" / "r0.ready"))["url"])
        assert h["ok"] and h["tiers"] == ["plain"] and h["device"] == "cpu"
        assert set(h["kernels"]) >= {"flash_attention", "decode_attention", "rmsnorm"}
        assert not any(h["kernels"].values())  # the CPU runs the plain versions
        assert h["dispatch"]["explore_dispatches"] == h["explore_events"] > 0
        assert sum(n for by_tier in h["dispatch"]["explore_by_op"].values()
                   for n in by_tier.values()) == h["explore_events"]
        assert h["fleet"]["pull"]["match"] == "miss"
        with pytest.raises(urllib.error.HTTPError, match="400"):
            _post(h["url"] if "url" in h else r0["url"], [10 ** 9], 2)
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    assert proc.returncode == 0
    rows = FleetClient(fleet).ls()
    assert [(r["git_sha"], r["chip"]) for r in rows] == [(git_sha(), default_chip().name)]
    assert rows[0]["samples"] > 0

    ready2 = str(tmp_path / "warm.ready")
    warm = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.router.replica", "--name", "w", "--port", "0",
         "--ready-file", ready2, "--fleet", fleet, *engine_flags],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        wait_for_ready_file(ready2, timeout_s=120, proc=warm)
        info = read_ready_info(ready2)
        assert info["fleet"]["pull"]["match"] == "exact"
        for spec in specs:
            assert len(_post(info["url"], spec["prompt"], spec["max_new"])["tokens"]) == 4
        h = _healthz(info["url"])
        assert h["explore_events"] == 0 and h["dispatch"]["decisions"] > 0
    finally:
        warm.send_signal(signal.SIGTERM)
        warm.wait(timeout=60)
    assert warm.returncode == 0


def test_a_real_replica_without_a_card_fails():
    """No fallback that hides the device: a real replica asked for the card
    (the default) exits non-zero where there is none, and writes no ready
    file."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.router.replica", "--arch", "qwen2-0.5b",
         "--reduced"], env=_env(), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
