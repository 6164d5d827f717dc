"""The port's fleet profile service (``repro_torch.fleet``) against the JAX
package's ``repro.fleet``.

Every behaviour ``tests/test_fleet.py`` holds of the JAX package is held of
the port: the profile store's merge and delta rules, the bucket store's
push / pull / gc, the HTTP daemon with its token, quota and audit log, the
delta pusher, the warm start and the CLIs (``python -m repro_torch.fleet``,
``repro_torch.trace push-profiles``), and the two-run warm start through
``repro_torch.launch.serve --fleet`` on the CPU.  Then the two packages
together: a store either one writes is read by the other with the same
bucket keys and the same bytes, and a port daemon serves a JAX client.
"""
import json
import os
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.dispatch.profiles import ProfileEntry, ProfileStore  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    FleetClient,
    FleetError,
    FleetPusher,
    FleetStore,
    declared_stamp,
    make_server,
    warm_start_from_fleet,
)
from repro_torch.fleet.cli import EXIT_MISS  # noqa: E402
from repro_torch.fleet.cli import main as fleet_main  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _store(samples, op="op", backend="be", sig="<s>", git_sha="", chip=""):
    s = ProfileStore()
    if git_sha or chip:
        s.set_stamp(git_sha=git_sha, chip=chip)
    for x in samples:
        s.record(op, backend, sig, x)
    return s


# ---------------------------------------------------------------------------
# ProfileStore: merge placeholder fix + delta subtraction
# ---------------------------------------------------------------------------


def test_merge_returns_sample_count_and_skips_placeholders():
    a, b = ProfileStore(), ProfileStore()
    b._entries["op|be|<s>"] = ProfileEntry()  # count=0 placeholder row
    b.record("op2", "be", "<s>", 0.001)
    b.record("op2", "be", "<s>", 0.002)
    assert a.merge(b) == 2  # samples merged, not keys touched
    # the empty row must not materialise as a warm-looking zero-sample entry
    assert len(a) == 1 and a.entry("op", "be", "<s>") is None


def test_merge_placeholder_does_not_pollute_existing_stamp():
    a = _store([0.001], git_sha="aaaa", chip="tpu-x")
    b = ProfileStore()
    b._entries["op|be|<s>"] = ProfileEntry()  # unstamped empty row, same key
    assert a.merge(b) == 0
    e = a.entry("op", "be", "<s>")
    assert e.count == 1
    assert e.git_sha == "aaaa" and e.chip == "tpu-x"  # no 'mixed' laundering


def test_merge_into_placeholder_adopts_incoming_stamp():
    """A sample-less placeholder in *self* must not launder the incoming
    entry's provenance to 'mixed' (age-out would then evict real samples)."""
    a = ProfileStore()
    a._entries["op|be|<s>"] = ProfileEntry()  # unstamped count=0 row
    b = _store([0.001, 0.002], git_sha="aaaa", chip="tpu-x")
    assert a.merge(b) == 2
    e = a.entry("op", "be", "<s>")
    assert e.count == 2 and e.git_sha == "aaaa" and e.chip == "tpu-x"
    assert a.age_out(git_sha="aaaa", chip="tpu-x") == []  # survives


def test_record_into_placeholder_adopts_writer_stamp():
    s = ProfileStore()
    s._entries["op|be|<s>"] = ProfileEntry()  # unstamped count=0 row
    s.set_stamp(git_sha="aaaa", chip="tpu-x")
    s.record("op", "be", "<s>", 0.001)
    e = s.entry("op", "be", "<s>")
    assert e.git_sha == "aaaa" and e.chip == "tpu-x"  # not 'mixed'


def test_delta_since_is_exact_welford_complement():
    s = ProfileStore()
    first, second = [0.5, 1.0, 2.0], [4.0, 0.25, 8.0]
    for x in first:
        s.record("op", "be", "<s>", x)
    base = ProfileStore.from_json(s.to_json())
    for x in second:
        s.record("op", "be", "<s>", x)
    s.record("new", "be", "<s>", 1.0)

    delta = s.delta_since(base)
    e = delta.entry("op", "be", "<s>")
    assert e.count == len(second)
    assert e.mean_s == pytest.approx(sum(second) / len(second))
    assert delta.entry("new", "be", "<s>").count == 1  # new key ships whole
    assert len(s.delta_since(s)) == 0  # no new samples -> empty delta

    # pushing base + delta must equal the full store (no double counting)
    base.merge(delta)
    full, merged = s.entry("op", "be", "<s>"), base.entry("op", "be", "<s>")
    assert merged.count == full.count
    assert merged.mean_s == pytest.approx(full.mean_s)
    assert merged.m2 == pytest.approx(full.m2)
    assert merged.min_s == full.min_s


# ---------------------------------------------------------------------------
# FleetStore: push merge, pull fallback ordering, gc retention
# ---------------------------------------------------------------------------


def test_push_welford_merges_into_bucket(tmp_path):
    fs = FleetStore(str(tmp_path))
    r1 = fs.push(_store([0.001, 0.003]), "sha1", "chipA")
    r2 = fs.push(_store([0.002]), "sha1", "chipA")
    assert (r1["merged_samples"], r2["merged_samples"]) == (2, 1)
    assert r2["samples"] == 3 and r2["pushes"] == 2
    pulled = fs.pull("sha1", "chipA")
    store = ProfileStore.from_json(json.dumps(pulled["store"]))
    e = store.entry("op", "be", "<s>")
    assert e.count == 3 and e.min_s == 0.001
    assert e.mean_s == pytest.approx(0.002)


def test_push_requires_key(tmp_path):
    fs = FleetStore(str(tmp_path))
    with pytest.raises(ValueError):
        fs.push(_store([0.001]), "", "chipA")


def test_push_stamps_unstamped_entries_with_bucket_key(tmp_path):
    """Unstamped samples adopt the declared bucket provenance on push, so a
    later chip-only fallback pull can age them out instead of trusting them
    across code changes."""
    fs = FleetStore(str(tmp_path))
    fs.push(_store([0.001]), "sha1", "chipA")  # _store default: no stamps
    pulled = fs.pull("other_sha", "chipA")  # chip fallback
    store = ProfileStore.from_json(json.dumps(pulled["store"]))
    e = store.entry("op", "be", "<s>")
    assert e.git_sha == "sha1" and e.chip == "chipA"
    aged = store.age_out(git_sha="other_sha", chip="chipA")
    assert len(aged) == 1  # evictable, not silently trusted


def test_push_dedups_on_source_and_seq(tmp_path):
    """Re-sending an already-recorded (source, seq) must not merge twice —
    the retry protocol for pushes whose response was lost."""
    fs = FleetStore(str(tmp_path))
    r1 = fs.push(_store([0.001, 0.002]), "sha1", "chipA", source="run-a", seq=1)
    r2 = fs.push(_store([0.001, 0.002]), "sha1", "chipA", source="run-a", seq=1)
    assert r1["merged_samples"] == 2 and "duplicate" not in r1
    assert r2["merged_samples"] == 0 and r2["duplicate"] is True
    assert fs.pull("sha1", "chipA")["samples"] == 2
    # a new seq (and other sources) merge normally
    assert fs.push(_store([0.003]), "sha1", "chipA",
                   source="run-a", seq=2)["merged_samples"] == 1
    assert fs.push(_store([0.004]), "sha1", "chipA",
                   source="run-b", seq=1)["merged_samples"] == 1


def test_read_verbs_do_not_create_a_store(tmp_path):
    """A mistyped --fleet path must surface, not mint an empty store: ls/gc
    error, pull reports a plain miss (cold-start bootstrap), and only a push
    creates the root."""
    root = str(tmp_path / "typo")
    fs = FleetStore(root)
    assert fs.pull("sha1", "chipA")["match"] == "miss"
    with pytest.raises(ValueError, match="does not exist"):
        fs.ls()
    with pytest.raises(ValueError, match="does not exist"):
        fs.gc(keep_per_chip=1)
    assert not os.path.exists(root)
    fs.push(_store([0.001]), "sha1", "chipA")
    assert os.path.isdir(root) and fs.ls()


def test_pull_fallback_exact_then_chip_then_miss(tmp_path):
    fs = FleetStore(str(tmp_path))
    fs.push(_store([0.001]), "old_sha", "chipA")
    time.sleep(0.01)
    fs.push(_store([0.002]), "new_sha", "chipA")
    fs.push(_store([0.003]), "new_sha", "chipB")

    # exact beats a fresher same-chip bucket
    assert fs.pull("old_sha", "chipA")["match"] == "exact"
    assert fs.pull("old_sha", "chipA")["git_sha"] == "old_sha"
    # unknown sha: freshest same-chip bucket
    chip = fs.pull("unknown", "chipA")
    assert chip["match"] == "chip" and chip["git_sha"] == "new_sha"
    # unknown chip: miss, store is None
    miss = fs.pull("unknown", "chipZ")
    assert miss["match"] == "miss" and miss["store"] is None


def test_mixed_provenance_never_shadows_real_buckets(tmp_path):
    fs = FleetStore(str(tmp_path))
    fs.push(_store([0.001]), "sha1", "chipA")
    time.sleep(0.01)
    fs.push(_store([0.002]), "mixed", "chipA")  # fresher, unknown provenance
    chip = fs.pull("unknown", "chipA")
    assert chip["match"] == "chip" and chip["git_sha"] == "sha1"
    # a fleet holding ONLY mixed buckets yields a miss, not mixed samples
    fs2 = FleetStore(str(tmp_path / "only_mixed"))
    fs2.push(_store([0.001]), "mixed", "chipA")
    assert fs2.pull("unknown", "chipA")["match"] == "miss"


def test_gc_age_and_per_chip_retention(tmp_path):
    fs = FleetStore(str(tmp_path))
    fs.push(_store([0.001]), "s1", "chipA")
    time.sleep(0.01)
    fs.push(_store([0.002]), "s2", "chipA")
    time.sleep(0.01)
    fs.push(_store([0.003]), "s3", "chipA")
    fs.push(_store([0.004]), "s4", "chipB")
    assert len(fs) == 4

    # staleness: everything is "old" relative to a far-future now except
    # nothing — inject now to make only s1 stale
    t1 = [r for r in fs.ls() if r["git_sha"] == "s1"][0]["pushed_unix"]
    removed = fs.gc(max_age_s=0.005, now=t1 + 0.006)
    assert [r["git_sha"] for r in removed] == ["s1"]

    # retention: keep the newest bucket per chip
    removed = fs.gc(keep_per_chip=1)
    assert sorted(r["git_sha"] for r in removed) == ["s2"]
    assert sorted(r["git_sha"] for r in fs.ls()) == ["s3", "s4"]


def test_slug_collision_safe_keys(tmp_path):
    """Keys that sanitise identically must land in distinct buckets."""
    fs = FleetStore(str(tmp_path))
    fs.push(_store([0.001]), "sha/1", "chip A")
    fs.push(_store([0.002]), "sha?1", "chip\tA")
    assert len(fs) == 2
    assert fs.pull("sha/1", "chip A")["match"] == "exact"
    assert fs.pull("sha?1", "chip\tA")["match"] == "exact"


def test_declared_stamp_unanimous_or_empty():
    unanimous = _store([0.001, 0.002], git_sha="aaaa", chip="tpu-x")
    assert declared_stamp(unanimous) == ("aaaa", "tpu-x")
    disagreeing = _store([0.001], git_sha="aaaa", chip="tpu-x")
    disagreeing.set_stamp(git_sha="bbbb", chip="tpu-x")
    disagreeing.record("op2", "be", "<s>", 0.002)
    assert declared_stamp(disagreeing) == ("", "tpu-x")
    # a unanimous 'mixed' stamp is unknown provenance, not agreement
    laundered = _store([0.001], git_sha="mixed", chip="mixed")
    assert declared_stamp(laundered) == ("", "")


# ---------------------------------------------------------------------------
# HTTP daemon + FleetClient (both transports)
# ---------------------------------------------------------------------------


@pytest.fixture()
def fleet_server(tmp_path):
    server = make_server(str(tmp_path / "fleet_root"), port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()


def test_http_round_trip(fleet_server):
    client = FleetClient(fleet_server.url)
    assert client.health()["ok"] is True
    res = client.push(_store([0.001, 0.002]), "sha1", "chipA")
    assert res["merged_samples"] == 2
    pulled = client.pull("sha1", "chipA")
    assert pulled["match"] == "exact"
    assert pulled["store"].entry("op", "be", "<s>").count == 2
    assert client.ls()[0]["git_sha"] == "sha1"
    assert [r["git_sha"] for r in client.gc(keep_per_chip=0)] == ["sha1"]
    assert client.ls() == []


def test_http_error_paths(fleet_server):
    client = FleetClient(fleet_server.url)
    with pytest.raises(FleetError, match="400"):
        client.push(_store([0.001]), "", "chipA")  # empty key
    with pytest.raises(FleetError, match="unreachable"):
        FleetClient("http://127.0.0.1:9", timeout=0.5).ls()  # discard port


def test_file_and_http_transports_share_format(fleet_server, tmp_path):
    """A bucket pushed over HTTP is pullable via direct file mode (the
    daemon is an optional front end over the same on-disk store)."""
    FleetClient(fleet_server.url).push(_store([0.001]), "sha1", "chipA")
    direct = FleetClient(str(fleet_server.fleet.root))
    assert direct.pull("sha1", "chipA")["match"] == "exact"
    file_url = FleetClient("file://" + str(fleet_server.fleet.root))
    assert file_url.pull("sha1", "chipA")["match"] == "exact"


# ---------------------------------------------------------------------------
# Authn: --token guards push/gc; pull stays open; 401s counted
# ---------------------------------------------------------------------------


@pytest.fixture()
def auth_server(tmp_path):
    server = make_server(str(tmp_path / "fleet_root"), port=0, token="s3cret")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()


def test_token_required_on_push_and_gc(auth_server):
    anon = FleetClient(auth_server.url)
    with pytest.raises(FleetError, match="401"):
        anon.push(_store([0.001]), "sha1", "chipA")
    with pytest.raises(FleetError, match="401"):
        anon.gc(keep_per_chip=0)
    wrong = FleetClient(auth_server.url, token="wrong")
    with pytest.raises(FleetError, match="401"):
        wrong.push(_store([0.001]), "sha1", "chipA")
    # every rejection is counted in the daemon stats
    health = anon.health()
    assert health["auth"] is True
    assert health["stats"]["auth_failures"] == 3
    assert health["stats"]["pushes"] == 0  # nothing landed
    assert len(auth_server.fleet) == 0


def test_token_holder_can_push_and_pull_stays_open(auth_server):
    authed = FleetClient(auth_server.url, token="s3cret")
    assert authed.push(_store([0.001, 0.002]), "sha1", "chipA")["merged_samples"] == 2
    # pull/ls/healthz require no token: a shared fleet warm-starts everyone
    anon = FleetClient(auth_server.url)
    assert anon.pull("sha1", "chipA")["match"] == "exact"
    assert anon.ls()[0]["git_sha"] == "sha1"
    assert authed.gc(keep_per_chip=0)
    stats = anon.health()["stats"]
    assert stats["pushes"] == 1 and stats["gcs"] == 1 and stats["pulls"] == 1
    assert stats["auth_failures"] == 0


def test_cli_serve_token_and_push_flag(tmp_path, capsys):
    """End-to-end through the CLIs: a token-protected daemon rejects
    `fleet push` without --token and accepts it with one."""
    profile = str(tmp_path / "p.json")
    with open(profile, "w") as f:
        f.write(_store([0.001], git_sha="sha1", chip="chipA").to_json())

    server = make_server(str(tmp_path / "root"), port=0, token="tok")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert fleet_main(["push", profile, "--fleet", server.url]) == 1
        assert "401" in capsys.readouterr().err
        assert fleet_main(["push", profile, "--fleet", server.url,
                           "--token", "tok"]) == 0
        assert json.loads(capsys.readouterr().out)["merged_samples"] == 1
        assert fleet_main(["ls", "--fleet", server.url]) == 0  # open without token
    finally:
        server.shutdown()
        server.server_close()


def test_unauthorized_pusher_degrades_not_crashes(auth_server):
    """A FleetPusher with a bad token behaves like an unreachable fleet:
    best-effort failure, delta retained for retry."""
    live = ProfileStore()
    pusher = FleetPusher(FleetClient(auth_server.url), live, "sha1", "chipA")
    live.record("op", "be", "<s>", 0.001)
    res = pusher.push()
    assert res["pushed"] is False and "401" in res["error"]
    assert pusher.pushed_samples == 0
    # fixing the token on the same client delivers the retained delta
    pusher.client = FleetClient(auth_server.url, token="s3cret")
    assert pusher.push()["pushed"] is True
    assert pusher.pushed_samples == 1


def test_concurrent_http_pushes_lose_no_samples(fleet_server):
    """The satellite stress test: concurrent overlapping pushes must
    Welford-merge losslessly (count, mean and min all exact)."""
    samples = [0.001, 0.002, 0.003, 0.004, 0.005]
    workers, pushes = 4, 6

    def worker():
        client = FleetClient(fleet_server.url)
        for _ in range(pushes):
            client.push(_store(samples), "sha1", "chipA")

    threads = [threading.Thread(target=worker) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    pulled = FleetClient(fleet_server.url).pull("sha1", "chipA")
    e = pulled["store"].entry("op", "be", "<s>")
    assert e.count == workers * pushes * len(samples)
    assert e.mean_s == pytest.approx(sum(samples) / len(samples))
    assert e.min_s == min(samples)
    assert pulled["samples"] == e.count


def test_concurrent_direct_clients_lose_no_samples(tmp_path):
    """Direct-path mode from independent clients (separate FleetStore
    instances, so only the advisory flock serialises them)."""
    root = str(tmp_path / "root")
    samples = [0.001, 0.002]
    workers, pushes = 4, 5

    def worker():
        client = FleetClient(root)  # own FleetStore, own threading.Lock
        for _ in range(pushes):
            client.push(_store(samples), "sha1", "chipA")

    threads = [threading.Thread(target=worker) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    e = FleetClient(root).pull("sha1", "chipA")["store"].entry("op", "be", "<s>")
    assert e.count == workers * pushes * len(samples)


# ---------------------------------------------------------------------------
# FleetPusher: delta pushes never double-count
# ---------------------------------------------------------------------------


def test_pusher_deltas_never_double_count(tmp_path):
    client = FleetClient(str(tmp_path))
    live = _store([0.004])
    pusher = FleetPusher(client, live, "sha1", "chipA")
    # samples present at pusher creation are the baseline (e.g. just pulled
    # from the fleet) and must NOT be echoed back
    assert pusher.push()["pushed"] is False

    live.record("op", "be", "<s>", 0.005)
    live.record("op2", "be", "<s>", 0.006)
    assert pusher.push()["pushed"] is True
    assert pusher.push()["pushed"] is False  # idempotent: no new samples
    live.record("op", "be", "<s>", 0.007)
    assert pusher.push()["merged_samples"] == 1

    pulled = client.pull("sha1", "chipA")
    assert pulled["store"].entry("op", "be", "<s>").count == 2  # 0.005, 0.007
    assert pulled["store"].entry("op2", "be", "<s>").count == 1
    assert pusher.pushed_samples == 3


def test_pusher_retry_after_lost_response_is_exactly_once(tmp_path):
    """A push that LANDED but whose response was lost (timeout) must not be
    Welford-merged twice: the pusher retries the same (delta, seq) and the
    fleet acknowledges it as a duplicate."""

    class LossyClient(FleetClient):
        def __init__(self, target):
            super().__init__(target)
            self.lose_next_response = False

        def push(self, *a, **kw):
            res = super().push(*a, **kw)
            if self.lose_next_response:
                self.lose_next_response = False
                raise FleetError("response lost after the server applied it")
            return res

    client = LossyClient(str(tmp_path / "fleet"))
    live = ProfileStore()
    pusher = FleetPusher(client, live, "sha1", "chipA")

    live.record("op", "be", "<s>", 0.001)
    client.lose_next_response = True
    res = pusher.push()
    assert res["pushed"] is False and "error" in res  # ambiguous outcome

    live.record("op", "be", "<s>", 0.002)  # recorded while delta pending
    assert pusher.push()["pushed"] is True  # retried delta deduped server-side
    assert pusher.push()["pushed"] is True  # then the 0.002 delta

    e = FleetClient(str(tmp_path / "fleet")).pull("sha1", "chipA")["store"] \
        .entry("op", "be", "<s>")
    assert e.count == 2  # exactly once despite the lost response
    assert e.mean_s == pytest.approx(0.0015)


def test_pusher_unreachable_fleet_keeps_baseline(tmp_path):
    live = ProfileStore()
    pusher = FleetPusher(FleetClient("http://127.0.0.1:9", timeout=0.5),
                         live, "sha1", "chipA")
    live.record("op", "be", "<s>", 0.001)
    res = pusher.push()
    assert res["pushed"] is False and "error" in res
    with pytest.raises(FleetError):
        pusher.push(raise_on_error=True)
    # a recovered fleet receives the missed samples on the next push
    pusher.client = FleetClient(str(tmp_path))
    assert pusher.push()["merged_samples"] == 1


def test_file_mode_io_errors_become_fleet_errors(tmp_path):
    """Direct-path verbs must normalise OSErrors to FleetError, so drivers
    degrade (log / start cold / retry next rotation) instead of crashing."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("occupied")  # root path collides with a regular file
    client = FleetClient(str(blocker))
    with pytest.raises(FleetError):
        client.push(_store([0.001]), "sha1", "chipA")
    # a pusher on the same target degrades best-effort instead of raising
    live = _store([0.001])
    pusher = FleetPusher(client, live, "sha1", "chipA")
    live.record("op", "be", "<s>", 0.002)
    res = pusher.push()
    assert res["pushed"] is False and "error" in res


# ---------------------------------------------------------------------------
# Driver wiring (warm_start_from_fleet) + CLI
# ---------------------------------------------------------------------------


def test_warm_start_pull_exact_then_stale_sha_reexplores(tmp_path):
    from repro_torch.dispatch import DispatchConfig, Dispatcher
    from repro_torch.trace.session import git_sha

    root = str(tmp_path / "fleet")
    disp = Dispatcher(DispatchConfig(policy="profiled"))
    sha, chip = git_sha(), disp.chip.name

    # empty fleet: miss, still returns a usable pusher
    rec, pusher = warm_start_from_fleet(root, disp)
    assert rec["pull"]["match"] == "miss"
    disp.store.record("op", "be", "<s>", 0.001)
    assert pusher.push()["merged_samples"] == 1

    # exact match warm start: entries survive age-out
    disp2 = Dispatcher(DispatchConfig(policy="profiled"))
    rec2, _ = warm_start_from_fleet(root, disp2)
    assert rec2["pull"] == {"match": "exact", "bucket_git_sha": sha,
                            "bucket_chip": chip, "entries": 1,
                            "merged_samples": 1, "aged_out": 0}
    assert disp2.store.samples("op", "be", "<s>") == 1

    # stale-SHA bucket: chip fallback pulls it, age-out evicts everything —
    # the dispatcher re-explores rather than trusting stale timings
    stale_root = str(tmp_path / "stale")
    stale = _store([0.002], git_sha="0000000", chip=chip)
    FleetClient(stale_root).push(stale, "0000000", chip)
    disp3 = Dispatcher(DispatchConfig(policy="profiled"))
    rec3, _ = warm_start_from_fleet(stale_root, disp3)
    assert rec3["pull"]["match"] == "chip"
    assert rec3["pull"]["aged_out"] == 1
    assert len(disp3.store) == 0

    # unreachable fleet: cold start, no crash
    disp4 = Dispatcher(DispatchConfig(policy="profiled"))
    rec4, pusher4 = warm_start_from_fleet("http://127.0.0.1:9", disp4)
    assert rec4["pull"]["match"] == "error" and pusher4 is not None


def test_stale_fleet_pull_never_destroys_valid_local_profiles(tmp_path):
    """A chip-only fallback bucket must be age-filtered BEFORE merging:
    merging first would degrade overlapping locally-valid entries (e.g.
    loaded via --profile-in) to 'mixed' and the age-out would then evict the
    driver's own good warm-start data."""
    from repro_torch.dispatch import DispatchConfig, Dispatcher
    from repro_torch.trace.session import git_sha

    disp = Dispatcher(DispatchConfig(policy="profiled"))
    sha, chip = git_sha(), disp.chip.name
    # valid local warm-start samples, stamped with the current environment
    for x in (0.001, 0.002, 0.003, 0.004, 0.005):
        disp.store.record("op", "be", "<s>", x)

    # fleet only holds an older-SHA same-chip bucket sharing the key
    root = str(tmp_path / "fleet")
    FleetClient(root).push(_store([0.9], git_sha="0000000", chip=chip),
                           "0000000", chip)

    rec, _ = warm_start_from_fleet(root, disp)
    assert rec["pull"]["match"] == "chip"
    assert rec["pull"]["aged_out"] == 1  # only the stale fleet entry
    e = disp.store.entry("op", "be", "<s>")
    assert e is not None and e.count == 5  # local samples fully intact
    assert e.git_sha == sha  # never degraded to 'mixed'
    assert e.min_s == 0.001  # the stale 0.9s sample never merged in


def test_cli_push_pull_ls_gc_round_trip(tmp_path, capsys):
    root = str(tmp_path / "fleet")
    src = str(tmp_path / "profiles.json")
    with open(src, "w") as f:
        f.write(_store([0.001, 0.002], git_sha="sha1", chip="chipA").to_json())

    # push derives the bucket key from the store's unanimous stamps
    assert fleet_main(["push", src, "--fleet", root, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["git_sha"] == "sha1" and out["chip"] == "chipA"
    assert out["merged_samples"] == 2

    dst = str(tmp_path / "pulled.json")
    assert fleet_main(["pull", "--fleet", root, "--git-sha", "sha1",
                       "--chip", "chipA", "-o", dst]) == 0
    restored = ProfileStore.from_json(open(dst).read())
    assert restored.entry("op", "be", "<s>").count == 2

    assert fleet_main(["pull", "--fleet", root, "--git-sha", "nope",
                       "--chip", "nochip"]) == EXIT_MISS
    assert "match=exact" in capsys.readouterr().out  # drain the pull chatter

    assert fleet_main(["ls", "--fleet", root, "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)["snapshots"]
    assert len(rows) == 1 and rows[0]["samples"] == 2

    assert fleet_main(["gc", "--fleet", root, "--keep-per-chip", "0",
                       "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["removed"]
    assert fleet_main(["ls", "--fleet", root, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["snapshots"] == []


def test_cli_push_refuses_ambiguous_provenance(tmp_path, capsys):
    """Foreign/unstamped samples must not be silently keyed to the current
    environment (they would become a trusted exact-match warm start)."""
    src = str(tmp_path / "unstamped.json")
    with open(src, "w") as f:
        f.write(_store([0.001]).to_json())  # no stamps at all
    root = str(tmp_path / "fleet")
    assert fleet_main(["push", src, "--fleet", root]) == 1
    assert "provenance" in capsys.readouterr().err
    # explicit flags resolve the ambiguity
    assert fleet_main(["push", src, "--fleet", root,
                       "--git-sha", "sha1", "--chip", "chipA"]) == 0
    assert FleetClient(root).pull("sha1", "chipA")["match"] == "exact"


def test_push_profiles_refuses_fleet_connected_run_without_force(tmp_path, capsys):
    """An artifact of a run that already fed a fleet live (delta pushes)
    must not be re-pushed wholesale — that would double-count every sample."""
    from repro_torch.trace.collector import TraceCollector
    from repro_torch.trace.stream import StreamingSession
    from repro_torch.trace.cli import main as trace_main

    store = _store([0.001, 0.002], git_sha="sha1", chip="chipA")
    root = str(tmp_path / "fleet")
    d = str(tmp_path / "run")
    col = TraceCollector()
    stream = StreamingSession(d, meta={"fleet": root},
                              store_provider=lambda: store).attach(col)
    col.record("mark", "m", 0)
    stream.close(stats=col.stats())

    assert trace_main(["push-profiles", d, "--fleet", root]) == 1
    assert "double-count" in capsys.readouterr().err
    assert trace_main(["push-profiles", d, "--fleet", root, "--force",
                       "--git-sha", "sha1", "--chip", "chipA"]) == 0
    assert FleetClient(root).pull("sha1", "chipA")["match"] == "exact"
    # a DIFFERENT fleet never received the live deltas: warn, don't refuse
    other = str(tmp_path / "other_fleet")
    assert trace_main(["push-profiles", d, "--fleet", other,
                       "--git-sha", "sha1", "--chip", "chipA"]) == 0
    assert "warning" in capsys.readouterr().err


def test_cli_push_rejects_profile_free_sources(tmp_path, capsys):
    bogus = str(tmp_path / "chrome.json")
    with open(bogus, "w") as f:
        json.dump({"traceEvents": []}, f)
    assert fleet_main(["push", bogus, "--fleet", str(tmp_path / "r")]) == 1


def test_cli_push_refuses_profile_out_of_fleet_connected_run(tmp_path, capsys):
    """--profile-out files written by a --fleet run carry a 'fleet' marker;
    re-pushing them wholesale is refused (the run already pushed deltas)."""
    root = str(tmp_path / "fleet")
    store = _store([0.001], git_sha="sha1", chip="chipA")
    doc = json.loads(store.to_json())
    doc["fleet"] = root  # what the drivers write
    src = str(tmp_path / "profiles.json")
    with open(src, "w") as f:
        json.dump(doc, f)
    assert fleet_main(["push", src, "--fleet", root]) == 1
    assert "double-count" in capsys.readouterr().err
    assert fleet_main(["push", src, "--fleet", root, "--force"]) == 0


def test_trace_cli_push_profiles_backfills_from_stream_dir(tmp_path, capsys):
    from repro_torch.trace.collector import TraceCollector
    from repro_torch.trace.stream import StreamingSession
    from repro_torch.trace.cli import main as trace_main

    store = _store([0.001, 0.002], git_sha="sess_sha", chip="sess_chip")
    d = str(tmp_path / "run")
    col = TraceCollector()
    stream = StreamingSession(d, store_provider=lambda: store).attach(col)
    col.record("mark", "m", 0)
    stream.close(stats=col.stats())

    root = str(tmp_path / "fleet")
    assert trace_main(["push-profiles", d, "--fleet", root,
                       "--git-sha", "sess_sha", "--chip", "sess_chip"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["merged_samples"] == 2
    assert FleetClient(root).pull("sess_sha", "sess_chip")["match"] == "exact"


def test_trace_cli_push_profiles_defaults_key_from_session(tmp_path, capsys):
    """Backfilling a --trace-out session uses the session's own git SHA and
    chip as the bucket key."""
    from repro_torch.core.events import EventLog
    from repro_torch.trace.session import Session
    from repro_torch.trace.cli import main as trace_main

    log = EventLog()
    log.record("mark", "m", 0)
    sess = Session.capture(log, store=_store([0.001]))
    sess.chip = {"name": "tpu_test"}
    p = sess.save(str(tmp_path / "s.json"))

    root = str(tmp_path / "fleet")
    assert trace_main(["push-profiles", p, "--fleet", root]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["chip"] == "tpu_test"
    assert out["git_sha"] == sess.meta["git_sha"]


# ---------------------------------------------------------------------------
# End-to-end: the two-process warm-start demo (acceptance criterion)
# ---------------------------------------------------------------------------


def _run_serve(fleet: str, extra=()):
    from repro_torch.launch import serve as serve_cli

    return serve_cli.main(
        ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--requests", "4",
         "--max-new", "6", "--dispatch", "profiled", "--fleet", fleet, *extra])


def test_two_process_fleet_warm_start(tmp_path):
    """Run 1 (cold) explores and pushes; run 2 pulls an exact match and
    reports zero exploration dispatches in its driver JSON (the two runs of
    ``launch.serve --fleet`` on the CPU, in this process)."""
    fleet = str(tmp_path / "fleet_store")
    r1 = _run_serve(fleet)
    assert r1["fleet"]["pull"]["match"] == "miss"
    assert r1["dispatch"]["explore_dispatches"] > 0
    assert r1["fleet"]["push"]["pushed_samples"] > 0

    r2 = _run_serve(fleet)
    assert r2["fleet"]["pull"]["match"] == "exact"
    assert r2["dispatch"]["explore_dispatches"] == 0


def test_healthz_and_metrics_share_one_counter_source(auth_server):
    """After a 401, the /healthz stats and the Prometheus /metrics series
    must agree — both read the same MetricsRegistry counters."""
    import urllib.request

    anon = FleetClient(auth_server.url)
    with pytest.raises(FleetError, match="401"):
        anon.push(_store([0.001]), "sha1", "chipA")
    assert anon.health()["stats"]["auth_failures"] == 1
    with urllib.request.urlopen(auth_server.url + "/metrics") as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert "repro_fleet_auth_failures_total 1" in text
    assert "repro_fleet_pushes_total 0" in text
    assert "repro_fleet_snapshots 0" in text
    # a successful authed push moves BOTH surfaces in lockstep
    FleetClient(auth_server.url, token="s3cret").push(
        _store([0.001]), "sha1", "chipA")
    assert anon.health()["stats"]["pushes"] == 1
    with urllib.request.urlopen(auth_server.url + "/metrics") as r:
        text = r.read().decode()
    assert "repro_fleet_pushes_total 1" in text
    assert "repro_fleet_snapshots 1" in text


# ---------------------------------------------------------------------------
# Audit log: every successful push/gc leaves a record
# ---------------------------------------------------------------------------


def test_audit_records_push_and_gc(fleet_server):
    from repro_torch.fleet.service import read_audit

    client = FleetClient(fleet_server.url)
    client.push(_store([0.001, 0.002]), "sha1", "chipA")
    client.gc(keep_per_chip=0)
    recs = read_audit(str(fleet_server.fleet.root))
    assert [r["verb"] for r in recs] == ["push", "gc"]
    push_rec, gc_rec = recs
    assert push_rec["git_sha"] == "sha1" and push_rec["chip"] == "chipA"
    assert push_rec["entries"] == 1 and push_rec["merged_samples"] == 2
    assert push_rec["addr"] == "127.0.0.1"
    assert "token_sha" not in push_rec  # tokenless daemon: no digest
    assert [b["git_sha"] for b in gc_rec["removed"]] == ["sha1"]
    # reads never touch the audit log, and rejected pushes leave no record
    client.pull("sha1", "chipA")
    with pytest.raises(FleetError, match="400"):
        client.push(_store([0.001]), "", "chipA")
    assert len(read_audit(str(fleet_server.fleet.root))) == 2


def test_audit_token_digest_not_secret(auth_server):
    import hashlib

    from repro_torch.fleet.service import read_audit

    FleetClient(auth_server.url, token="s3cret").push(
        _store([0.001]), "sha1", "chipA")
    # a rejected anonymous push must not be audited
    with pytest.raises(FleetError, match="401"):
        FleetClient(auth_server.url).push(_store([0.001]), "sha2", "chipA")
    (rec,) = read_audit(str(auth_server.fleet.root))
    assert rec["token_sha"] == hashlib.sha256(b"s3cret").hexdigest()[:12]
    raw = open(auth_server.audit_path).read()
    assert "s3cret" not in raw  # the secret itself never lands on disk


def test_audit_cli_tails_and_handles_missing(fleet_server, tmp_path, capsys):
    root = str(fleet_server.fleet.root)
    # empty store: friendly message, exit 0
    assert fleet_main(["audit", "--root", root]) == 0
    assert "(no audit records)" in capsys.readouterr().out
    client = FleetClient(fleet_server.url)
    for i in range(3):
        client.push(_store([0.001]), f"sha{i}", "chipA")
    assert fleet_main(["audit", "--root", root, "-n", "2", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert [r["git_sha"] for r in doc["records"]] == ["sha1", "sha2"]
    # human-readable table renders every verb
    client.gc(keep_per_chip=1)
    assert fleet_main(["audit", "--root", root]) == 0
    out = capsys.readouterr().out
    assert "push" in out and "gc" in out and "sha2" in out


# ---------------------------------------------------------------------------
# Per-source rate quotas: token bucket on push/gc; 429s counted + audited
# ---------------------------------------------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_rate_quota_bucket_spend_and_refill():
    from repro_torch.fleet.service import RateQuota

    clk = _FakeClock()
    q = RateQuota(rps=1.0, burst=2, clock=clk)
    assert q.allow("a") == (True, False)
    assert q.allow("a") == (True, False)
    # bucket empty: denied, and the FIRST denial starts the audit episode
    assert q.allow("a") == (False, True)
    assert q.allow("a") == (False, False)
    clk.t += 1.0  # one token refilled at 1 req/s
    assert q.allow("a") == (True, False)
    assert q.allow("a")[0] is False


def test_rate_quota_per_source_and_lru_fails_open():
    from repro_torch.fleet.service import RateQuota

    clk = _FakeClock()
    q = RateQuota(rps=1.0, burst=1, clock=clk, max_sources=2)
    assert q.allow("a")[0] is True
    assert q.allow("b")[0] is True  # b's bucket independent of a's spend
    assert q.allow("a") == (False, True)
    # touching two new sources evicts 'a' (LRU); it comes back with a full
    # bucket — eviction fails open, never spuriously throttles
    q.allow("c")
    q.allow("d")
    assert q.allow("a")[0] is True


def test_rate_quota_validates_params():
    from repro_torch.fleet.service import RateQuota

    with pytest.raises(ValueError):
        RateQuota(0)
    with pytest.raises(ValueError):
        RateQuota(-1.0)
    with pytest.raises(ValueError):
        RateQuota(1.0, burst=0.5)


@pytest.fixture()
def quota_server(tmp_path):
    from repro_torch.fleet.service import make_server as mk

    server = mk(str(tmp_path / "fleet_root"), port=0, quota_rps=1.0,
                quota_burst=2)
    server.quota.clock = _FakeClock()  # frozen: no refill unless advanced
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()


def test_quota_throttles_push_with_429_counted_and_audited(quota_server):
    from repro_torch.fleet.service import read_audit

    client = FleetClient(quota_server.url)
    client.push(_store([0.001, 0.002]), "sha1", "chipA")
    client.push(_store([0.003, 0.004]), "sha1", "chipA")
    for _ in range(2):
        with pytest.raises(FleetError, match="429"):
            client.push(_store([0.005]), "sha1", "chipA")
    health = client.health()
    assert health["stats"]["pushes"] == 2
    assert health["stats"]["throttled"] == 2
    # reads never spend quota: a fleet-warmed driver must always pull
    assert client.pull("sha1", "chipA")["match"] == "exact"
    assert client.ls()
    # one audit record per throttle EPISODE, not per denied request
    throttles = [r for r in read_audit(str(quota_server.fleet.root))
                 if r["verb"] == "throttle"]
    assert len(throttles) == 1
    assert throttles[0]["path"] == "/v1/push"
    assert throttles[0]["rps"] == 1.0
    # refill ends the episode; the next denial starts (and audits) a new one
    quota_server.quota.clock.t += 1.0
    client.push(_store([0.006]), "sha1", "chipA")
    with pytest.raises(FleetError, match="429"):
        client.gc(keep_per_chip=1)  # gc shares the same per-source bucket
    throttles = [r for r in read_audit(str(quota_server.fleet.root))
                 if r["verb"] == "throttle"]
    assert len(throttles) == 2
    assert throttles[1]["path"] == "/v1/gc"


# ---------------------------------------------------------------------------
# The two packages together
# ---------------------------------------------------------------------------


def _pkg(name):
    """(FleetStore, ProfileStore, FleetClient, make_server, store module) of
    the JAX package ("jax") or the port ("port")."""
    import importlib

    root = "repro" if name == "jax" else "repro_torch"
    store_mod = importlib.import_module(f"{root}.fleet.store")
    return (store_mod.FleetStore,
            importlib.import_module(f"{root}.dispatch.profiles").ProfileStore,
            importlib.import_module(f"{root}.fleet.client").FleetClient,
            importlib.import_module(f"{root}.fleet.service").make_server,
            store_mod)


def _pushes(ProfileStoreCls):
    """The same pushes for both packages: stamped and unstamped samples, two
    SHAs on one chip, a second chip, a deduplicated (source, seq) retry."""
    def st(samples, op="op", git_sha="", chip=""):
        s = ProfileStoreCls()
        if git_sha or chip:
            s.set_stamp(git_sha=git_sha, chip=chip)
        for x in samples:
            s.record(op, "kernel", "bfloat16[1,64]", x)
        return s

    return [
        (st([0.001, 0.003], git_sha="sha1", chip="h100_sxm"), "sha1", "h100_sxm", "a", 1),
        (st([0.002], op="op2"), "sha1", "h100_sxm", "a", 2),
        (st([0.002], op="op2"), "sha1", "h100_sxm", "a", 2),  # a retry: deduplicated
        (st([0.5]), "sha0", "h100_sxm", None, None),
        (st([0.004, 0.006], git_sha="sha1", chip="tpu_v5e"), "sha1", "tpu_v5e", None, None),
    ]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_store_either_package_writes_is_read_by_the_other(writer, reader, tmp_path,
                                                           monkeypatch):
    """The same pushes, at the same (scripted) wall times, write the same
    files byte for byte in both packages; each package's pull, ls and gc on
    the other's root give what they give on its own."""
    import itertools

    roots = {}
    for name in ("jax", "port"):
        FleetStoreCls, ProfileStoreCls, _, _, store_mod = _pkg(name)
        clock = itertools.count(1_700_000_000)
        monkeypatch.setattr(store_mod.time, "time", lambda: float(next(clock)))
        fs = FleetStoreCls(str(tmp_path / name))
        for store, sha, chip, source, seq in _pushes(ProfileStoreCls):
            fs.push(store, sha, chip, source=source, seq=seq)
        roots[name] = fs.root
    files = {name: sorted(os.path.relpath(os.path.join(d, f), root)
                          for d, _, fs_ in os.walk(root) for f in fs_ if f.endswith(".json"))
             for name, root in roots.items()}
    assert files["jax"] == files["port"] and len(files["port"]) == 3
    for rel in files["port"]:
        with open(os.path.join(roots["jax"], rel), "rb") as a, \
                open(os.path.join(roots["port"], rel), "rb") as b:
            assert a.read() == b.read(), rel

    ReaderStore = _pkg(reader)[0]
    own, other = ReaderStore(roots[reader]), ReaderStore(roots[writer])
    for key in (("sha1", "h100_sxm"), ("sha9", "h100_sxm"), ("sha1", "tpu_v5e"),
                ("sha1", "nochip")):
        assert other.pull(*key) == own.pull(*key), key
    assert other.pull("sha9", "h100_sxm")["git_sha"] == "sha0"  # freshest same-chip
    assert other.ls() == own.ls()
    pulled = _pkg(reader)[1].from_json(json.dumps(other.pull("sha1", "h100_sxm")["store"]))
    assert sorted(pulled._entries) == ["op2|kernel|bfloat16[1,64]", "op|kernel|bfloat16[1,64]"]
    assert pulled.entry("op2", "kernel", "bfloat16[1,64]").count == 1  # the retry deduplicated
    assert [r["git_sha"] for r in other.gc(keep_per_chip=1)] == \
        [r["git_sha"] for r in own.gc(keep_per_chip=1)] == ["sha1"]


@pytest.mark.parametrize("daemon,client", [("port", "jax"), ("jax", "port")])
def test_either_daemon_serves_the_other_packages_client(daemon, client, tmp_path):
    _, _, _, make, _ = _pkg(daemon)
    _, ProfileStoreCls, ClientCls, _, _ = _pkg(client)
    server = make(str(tmp_path / "root"), port=0, token="tok")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        c = ClientCls(server.url, token="tok")
        s = ProfileStoreCls()
        s.record("serve_prefill", "kernel", "int64[1,64]", 0.002)
        s.record("serve_prefill", "kernel", "int64[1,64]", 0.004)
        assert c.push(s, "sha1", "h100_sxm")["merged_samples"] == 2
        pulled = c.pull("sha1", "h100_sxm")
        assert pulled["match"] == "exact"
        e = pulled["store"].entry("serve_prefill", "kernel", "int64[1,64]")
        assert (e.count, e.min_s, e.chip) == (2, 0.002, "h100_sxm")
        assert c.health()["stats"]["pushes"] == 1
    finally:
        server.shutdown()
        server.server_close()


def test_a_port_warm_start_never_takes_tpu_samples(tmp_path):
    """ROADMAP R2: samples the JAX package's dispatcher stamps with its TPU
    chip sit in a bucket the port (stamping the card) never pulls."""
    from repro.dispatch import DispatchConfig as JaxDispatchConfig
    from repro.dispatch import Dispatcher as JaxDispatcher
    from repro.fleet import warm_start_from_fleet as jax_warm_start
    from repro_torch.dispatch import DispatchConfig, Dispatcher, host_registry

    root = str(tmp_path / "fleet")
    jax_disp = JaxDispatcher(JaxDispatchConfig(policy="profiled"))
    _, jax_pusher = jax_warm_start(root, jax_disp)
    jax_disp.store.record("serve_decode", "chunked", "int32[4,1]", 0.001)
    assert jax_pusher.push()["chip"] == jax_disp.chip.name != "h100_sxm"

    disp = Dispatcher(DispatchConfig(policy="profiled"), registry=host_registry(device="cpu"))
    rec, pusher = warm_start_from_fleet(root, disp)
    assert disp.chip.name == "h100_sxm"
    assert rec["pull"] == {"match": "miss"} and len(disp.store) == 0
    disp.store.record("serve_decode", "plain", "int64[4]", 0.002)
    assert pusher.push()["chip"] == "h100_sxm"
    assert {r["chip"] for r in FleetClient(root).ls()} == {jax_disp.chip.name, "h100_sxm"}
