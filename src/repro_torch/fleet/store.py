"""FleetStore: on-disk cross-run profile aggregation keyed by (git SHA, chip)
(counterpart of ``repro/fleet/store.py``, with the same on-disk layout and
bucket documents, so a store either package writes is read by the other).

Each run's :class:`~repro_torch.dispatch.profiles.ProfileStore` dies with its
``--profile-out`` file; the fleet store is the durable rendezvous the ROADMAP
calls for — a directory of merged profile snapshots, one bucket per
(git SHA, chip), so any process on matching code + hardware can warm-start
from the freshest samples the whole fleet has measured.

Semantics:

* **push** Welford-merges the incoming store into the bucket (Chan et al.
  parallel variance — N runs pushing equals one run that saw every sample);
* **pull** falls back provenance-safely: exact (git SHA, chip) match first,
  then freshest same-chip bucket (whose entries a driver will age out and
  re-explore if their SHA stamps mismatch), then a miss.  Buckets keyed
  ``"mixed"`` — samples of unknown provenance — never shadow either level;
* **gc** applies the staleness/retention policy: drop buckets older than
  ``max_age_s``, keep only the newest ``keep_per_chip`` per chip.

On-disk layout (one JSON doc per bucket, written atomically)::

    <root>/<chip>/<git_sha>.json

Thread-safe within a process (the HTTP daemon wraps one instance), and
best-effort cross-process safe in ``file://`` direct mode via an advisory
``flock`` on ``<root>/.lock``.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator, Optional

from repro_torch.dispatch.profiles import ProfileStore
from repro_torch.utils.io import atomic_write

FLEET_SCHEMA = "repro.fleet/v1"  # the JAX package's: one on-disk format
MIXED_STAMP = "mixed"  # ProfileStore's unknown-provenance marker


def _slug(s: str) -> str:
    """Filesystem-safe bucket-file name; hash-suffixed when lossy."""
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", s) or "_"
    if safe != s or len(safe) > 80:
        safe = f"{safe[:64]}-{hashlib.sha1(s.encode()).hexdigest()[:8]}"
    return safe


def declared_stamp(store: ProfileStore) -> tuple[str, str]:
    """The (git_sha, chip) a store's samples unanimously claim, else ''.

    Used to default a push's bucket key from a bare ``--profile-out`` file:
    if every non-empty entry agrees on a stamp, that stamp is trustworthy;
    any disagreement yields '' so the caller must choose explicitly.  A
    unanimous ``"mixed"`` stamp is unknown provenance, not agreement — it
    also yields '' (otherwise merged-across-environments stores would mint
    ``mixed/mixed`` buckets instead of being refused).
    """
    shas = {e.git_sha for e in store._entries.values() if e.count}
    chips = {e.chip for e in store._entries.values() if e.count}
    sha = shas.pop() if len(shas) == 1 else ""
    chip = chips.pop() if len(chips) == 1 else ""
    return ("" if sha == MIXED_STAMP else sha,
            "" if chip == MIXED_STAMP else chip)


class FleetStore:
    """Directory of Welford-merged ProfileStore buckets keyed (git SHA, chip)."""

    MAX_SOURCES = 128  # per-bucket push-dedup window (see push())

    def __init__(self, root: str) -> None:
        # the root is created lazily on first push: read verbs on a mistyped
        # path must report the miss/absence, not mint an empty store
        self.root = root
        self._lock = threading.Lock()

    def _require_root(self) -> None:
        if not os.path.isdir(self.root):
            raise ValueError(f"fleet store {self.root} does not exist "
                             "(created on first push / by `serve`)")

    # -- locking / io ---------------------------------------------------------

    @contextmanager
    def _locked(self) -> Iterator[None]:
        """Process lock + advisory cross-process flock (direct-path mode:
        two hosts sharing an NFS root should not lose a racing push)."""
        with self._lock:
            lock_fd = None
            try:
                try:
                    import fcntl

                    lock_fd = os.open(os.path.join(self.root, ".lock"),
                                      os.O_CREAT | os.O_RDWR)
                    fcntl.flock(lock_fd, fcntl.LOCK_EX)
                except (ImportError, OSError):
                    lock_fd = None  # non-posix / odd fs: in-process lock only
                yield
            finally:
                if lock_fd is not None:
                    import fcntl

                    fcntl.flock(lock_fd, fcntl.LOCK_UN)
                    os.close(lock_fd)

    def _bucket_path(self, git_sha: str, chip: str) -> str:
        return os.path.join(self.root, _slug(chip), f"{_slug(git_sha)}.json")

    def _read_bucket(self, path: str) -> Optional[dict[str, Any]]:
        try:
            with open(path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _write_bucket(self, path: str, doc: dict[str, Any]) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        atomic_write(path, json.dumps(doc, indent=1))

    def _iter_buckets(self) -> Iterator[tuple[str, dict[str, Any]]]:
        if not os.path.isdir(self.root):
            return
        for chip_dir in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, chip_dir)
            if not os.path.isdir(d):
                continue
            for name in sorted(os.listdir(d)):
                if not name.endswith(".json"):
                    continue
                path = os.path.join(d, name)
                doc = self._read_bucket(path)
                if doc is not None:
                    yield path, doc

    @staticmethod
    def _meta(doc: dict[str, Any]) -> dict[str, Any]:
        return {k: doc.get(k) for k in
                ("git_sha", "chip", "created_unix", "pushed_unix",
                 "pushes", "samples", "entries")}

    # -- the service verbs ----------------------------------------------------

    def push(self, store: ProfileStore, git_sha: str, chip: str,
             source: Optional[str] = None, seq: Optional[int] = None) -> dict[str, Any]:
        """Welford-merge ``store`` into the (git_sha, chip) bucket.

        Entries with an *empty* git_sha/chip stamp adopt the bucket key (the
        push declares their provenance): otherwise unstamped samples would
        survive every later age-out pass and be trusted across code changes.
        ``store`` is mutated in place — every call site passes a throwaway
        (a parsed request body, a computed delta, a freshly-loaded file).

        ``(source, seq)`` makes pushes idempotent for retrying clients
        (:class:`~repro_torch.fleet.client.FleetPusher`): a push whose response was
        lost can be resent with the same sequence number — if the bucket
        already recorded it, the re-push is acknowledged as a ``duplicate``
        without merging again (the samples are already in).  The per-bucket
        dedup window keeps the newest :data:`MAX_SOURCES` sources.
        """
        if not git_sha or not chip:
            raise ValueError(f"push needs a git_sha and chip, got "
                             f"({git_sha!r}, {chip!r})")
        for e in store._entries.values():
            if not e.git_sha:
                e.git_sha = git_sha
            if not e.chip:
                e.chip = chip
        os.makedirs(self.root, exist_ok=True)
        path = self._bucket_path(git_sha, chip)
        with self._locked():
            doc = self._read_bucket(path)
            now = time.time()
            if doc is None:
                doc = {"schema": FLEET_SCHEMA, "git_sha": git_sha, "chip": chip,
                       "created_unix": now, "pushes": 0, "samples": 0,
                       "sources": {}, "store": json.loads(ProfileStore().to_json())}
            sources = doc.setdefault("sources", {})
            if source is not None and seq is not None and sources.get(source, 0) >= seq:
                return {"merged_samples": 0, "duplicate": True, **self._meta(doc)}
            merged = ProfileStore.from_json(json.dumps(doc["store"]))
            n = merged.merge(store)
            doc["store"] = json.loads(merged.to_json())
            doc["pushed_unix"] = now
            doc["pushes"] += 1
            doc["samples"] += n
            doc["entries"] = len(merged)
            if source is not None and seq is not None:
                sources.pop(source, None)  # re-insert: dict order = recency
                sources[source] = seq
                while len(sources) > self.MAX_SOURCES:
                    sources.pop(next(iter(sources)))
            self._write_bucket(path, doc)
            return {"merged_samples": n, **self._meta(doc)}

    def pull(self, git_sha: str, chip: str) -> dict[str, Any]:
        """Best matching bucket: exact → freshest same-chip → miss.

        The chip-only fallback intentionally returns entries stamped with a
        *different* git SHA: the driver's age-out pass evicts them, so a
        mismatched pull degrades to cold exploration rather than trusting
        stale timings.  ``"mixed"``-keyed buckets are skipped at both levels —
        unknown provenance never shadows a real match.
        """
        with self._locked():
            exact = self._read_bucket(self._bucket_path(git_sha, chip))
            if exact is not None and exact.get("git_sha") != MIXED_STAMP:
                return {"match": "exact", "store": exact["store"],
                        **self._meta(exact)}
            best: Optional[dict[str, Any]] = None
            for _, doc in self._iter_buckets():
                if doc.get("chip") != chip or doc.get("git_sha") == MIXED_STAMP:
                    continue
                if best is None or doc.get("pushed_unix", 0) > best.get("pushed_unix", 0):
                    best = doc
            if best is not None:
                return {"match": "chip", "store": best["store"],
                        **self._meta(best)}
            return {"match": "miss", "store": None,
                    "git_sha": git_sha, "chip": chip}

    def ls(self) -> list[dict[str, Any]]:
        """Bucket metadata (no payloads), freshest first within each chip."""
        self._require_root()
        with self._locked():
            rows = [self._meta(doc) for _, doc in self._iter_buckets()]
        rows.sort(key=lambda r: (r.get("chip") or "",
                                 -(r.get("pushed_unix") or 0)))
        return rows

    def gc(
        self,
        max_age_s: Optional[float] = None,
        keep_per_chip: Optional[int] = None,
        now: Optional[float] = None,
    ) -> list[dict[str, Any]]:
        """Staleness/retention sweep; returns the removed buckets' metadata.

        ``max_age_s`` drops buckets whose last push is older; ``keep_per_chip``
        then keeps only the newest N per chip.  ``now`` is injectable for
        deterministic tests.
        """
        now = time.time() if now is None else now
        self._require_root()
        removed: list[dict[str, Any]] = []
        with self._locked():
            by_chip: dict[str, list[tuple[str, dict[str, Any]]]] = {}
            for path, doc in self._iter_buckets():
                age = now - doc.get("pushed_unix", doc.get("created_unix", now))
                if max_age_s is not None and age > max_age_s:
                    removed.append({**self._meta(doc), "reason": f"age {age:.0f}s > {max_age_s:g}s"})
                    os.unlink(path)
                    continue
                by_chip.setdefault(doc.get("chip", "?"), []).append((path, doc))
            if keep_per_chip is not None:
                for chip, rows in by_chip.items():
                    rows.sort(key=lambda r: -(r[1].get("pushed_unix") or 0))
                    for path, doc in rows[keep_per_chip:]:
                        removed.append({**self._meta(doc),
                                        "reason": f"beyond keep_per_chip={keep_per_chip}"})
                        os.unlink(path)
            for name in os.listdir(self.root):  # drop emptied chip dirs
                d = os.path.join(self.root, name)
                if os.path.isdir(d) and not os.listdir(d):
                    os.rmdir(d)
        return removed

    def __len__(self) -> int:
        return sum(1 for _ in self._iter_buckets())
