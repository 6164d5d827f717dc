"""Online profile store: measured samples override a-priori estimates.

A copy of ``repro/dispatch/profiles.py``: the same API, the same keys and
the same JSON, so a store written by either package loads in the other
(the profiles of a card and of a TPU tell themselves apart by their
``chip`` stamp, which :meth:`ProfileStore.age_out` reads).

This is the Adaptyst feedback loop.  The cost model in
:mod:`repro_torch.dispatch.cost` prices every (op, backend, shape) a
priori; each real execution the dispatcher routes is timed and folded back
in here.  Once a key is *warm* (``min_samples`` observations) the measured
minimum beats the estimate.

Samples arrive from three directions:

* :meth:`ProfileStore.record` — the dispatcher's own timed executions;
* :meth:`ProfileStore.observe_timing` — a
  :class:`repro_torch.core.overhead.TimingStats` from the hyperfine harness;
* :meth:`ProfileStore.ingest_event_log` — ``dispatch`` events recorded in a
  :class:`repro_torch.core.events.EventLog` by a previous run (profiles
  persist across processes via :meth:`to_json` / :meth:`from_json`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from typing import TYPE_CHECKING, Any, Iterator, Optional

from repro_torch.core.events import EventLog

if TYPE_CHECKING:  # annotation only: core/overhead imports the model stack
    from repro_torch.core.overhead import TimingStats


def _leaves(tree: Any) -> Iterator[Any]:
    """Leaves in ``jax.tree``'s order: dict values by sorted key, sequences in
    order (``torch.utils._pytree`` keeps a dict's insertion order instead)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def signature(*args: Any) -> str:
    """Shape/dtype signature of a call's array arguments (trees allowed):
    ``bfloat16[2,3]``, the dtype as JAX writes it, for tensors and numpy
    arrays alike, so that both packages key the same call the same way."""
    parts: list[str] = []
    for leaf in _leaves(args):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is not None and dtype is not None:
            name = str(dtype).removeprefix("torch.")
            parts.append(f"{name}[{','.join(map(str, shape))}]")
    sig = ";".join(parts) if parts else "<scalar>"
    if len(sig) > 256:  # train-state trees: stable digest instead of a novel
        sig = f"tree:{len(parts)}leaves:{hashlib.sha1(sig.encode()).hexdigest()[:16]}"
    return sig


def encode_config(params: Any) -> str:
    """Canonical string form of a kernel config point: ``"k=v,k2=v2"``.

    Sorted by key so two dicts with the same content encode identically —
    the encoding IS the profile-bucket identity.  Empty dict encodes to
    ``""`` (the default/legacy point).
    """
    return ",".join(f"{k}={params[k]}" for k in sorted(params))


def decode_config(config: str) -> dict[str, Any]:
    """Inverse of :func:`encode_config`; values parse as int, float, or str."""
    out: dict[str, Any] = {}
    if not config:
        return out
    for part in config.split(","):
        k, _, v = part.partition("=")
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def _esc(field: str) -> str:
    """Escape the key separator (and the escape char itself) inside a field.

    A crafted ``sig`` like ``"x|pallas|y"`` must not alias a different
    bucket's key — without escaping, ``profile_key("op", "ref", "x|pallas|y")``
    and ``profile_key("op|ref|x", "pallas", "y")`` collide silently.  Real
    signatures (``float32[1,16]``-style) contain neither ``%`` nor ``|``, so
    keys written by previous versions round-trip unchanged.
    """
    return field.replace("%", "%25").replace("|", "%7C")


def _unesc(field: str) -> str:
    return field.replace("%7C", "|").replace("%25", "%")


def profile_key(op: str, backend: str, sig: str, config: str = "") -> str:
    """Key of one profile bucket: a full *config point*.

    ``config`` is the canonical encoding of the kernel configuration the
    samples were measured under (block/tile sizes, batch/padding choices —
    the tuner's design space, ROADMAP M12); the empty string means "backend defaults"
    and yields the legacy three-field key, so existing fleet buckets and
    session snapshots keep their key strings byte-for-byte.
    """
    parts = [_esc(op), _esc(backend), _esc(sig)]
    if config:
        parts.append(_esc(config))
    return "|".join(parts)


def parse_profile_key(key: str) -> tuple[str, str, str, str]:
    """Inverse of :func:`profile_key`: ``(op, backend, sig, config)``.

    Legacy three-field keys parse with ``config == ""``.  Raises ValueError
    on keys with the wrong field count rather than guessing.
    """
    parts = key.split("|")
    if len(parts) == 3:
        parts.append("")
    if len(parts) != 4:
        raise ValueError(f"malformed profile key {key!r}: "
                         f"expected 3 or 4 |-separated fields, got {len(parts)}")
    op, backend, sig, config = (_unesc(p) for p in parts)
    return op, backend, sig, config


def _combine_stamp(a: str, b: str) -> str:
    """Provenance of samples from two environments: agreement persists,
    disagreement (including stamped vs unstamped) degrades to ``"mixed"``,
    which never matches a real SHA/chip so age_out evicts it."""
    return a if a == b else "mixed"


@dataclasses.dataclass
class ProfileEntry:
    """Welford running stats over observed wall-times for one key.

    ``git_sha``/``chip`` stamp where the samples came from: a measurement is
    only trustworthy on the code and hardware that produced it, and
    :meth:`ProfileStore.age_out` evicts entries whose stamp no longer matches
    the current environment (profile invalidation).  Empty = legacy/unknown.
    """

    count: int = 0
    mean_s: float = 0.0
    m2: float = 0.0
    min_s: float = float("inf")
    git_sha: str = ""
    chip: str = ""

    def add(self, seconds: float) -> None:
        self.count += 1
        delta = seconds - self.mean_s
        self.mean_s += delta / self.count
        self.m2 += delta * (seconds - self.mean_s)
        self.min_s = min(self.min_s, seconds)

    @property
    def variance(self) -> float:
        return self.m2 / (self.count - 1) if self.count > 1 else 0.0


class ProfileStore:
    def __init__(self, min_samples: int = 2) -> None:
        self.min_samples = min_samples
        self._entries: dict[str, ProfileEntry] = {}
        # guards mutation vs serialisation: ProfileEntry.add() updates
        # count/mean/m2 in several steps, and a snapshot taken mid-add (e.g.
        # a fleet push on the streaming-rotation thread while the dispatcher
        # records) would serialise a torn Welford state
        self._lock = threading.RLock()
        # provenance applied to entries as they receive samples; set via
        # set_stamp() (the Dispatcher stamps with its chip + the repo SHA)
        self._stamp_git = ""
        self._stamp_chip = ""

    # -- provenance ----------------------------------------------------------

    def set_stamp(self, git_sha: str = "", chip: str = "") -> None:
        """Declare the environment new samples are measured in."""
        self._stamp_git = git_sha
        self._stamp_chip = chip

    def age_out(self, git_sha: str = "", chip: str = "") -> list[dict[str, str]]:
        """Evict entries stamped with a *different* git SHA or chip.

        Stored profiles are only valid on the code + hardware that measured
        them; a mismatched entry is dropped so the dispatcher re-explores
        instead of trusting stale timings.  Unstamped (legacy) entries are
        kept.  Returns one ``{"key", "reason"}`` record per eviction so
        callers can log why warm-start data disappeared.
        """
        aged: list[dict[str, str]] = []
        with self._lock:
            for key, e in list(self._entries.items()):
                reason = None
                if git_sha and e.git_sha and e.git_sha != git_sha:
                    reason = f"git_sha changed ({e.git_sha} -> {git_sha})"
                elif chip and e.chip and e.chip != chip:
                    reason = f"chip changed ({e.chip} -> {chip})"
                if reason is not None:
                    del self._entries[key]
                    aged.append({"key": key, "reason": reason})
        return aged

    # -- writers -------------------------------------------------------------

    def _entry_for_write(self, key: str) -> ProfileEntry:
        """Get-or-create an entry about to receive current-environment samples.

        A fresh entry takes the store's stamp outright.  An existing entry's
        stamp may only persist if it agrees with the current environment —
        overwriting would launder old samples under a fresh stamp, hiding
        them from age_out (same rule as merge(): disagreement means
        'mixed', which never survives an invalidation pass).
        """
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = ProfileEntry(
                git_sha=self._stamp_git, chip=self._stamp_chip
            )
        elif e.count == 0:
            # a sample-less placeholder has no provenance to defend: adopt
            # the writer's stamp instead of laundering it to 'mixed'
            e.git_sha, e.chip = self._stamp_git, self._stamp_chip
        else:
            e.git_sha = _combine_stamp(e.git_sha, self._stamp_git)
            e.chip = _combine_stamp(e.chip, self._stamp_chip)
        return e

    def record(self, op: str, backend: str, sig: str, seconds: float,
               config: str = "") -> None:
        with self._lock:
            self._entry_for_write(profile_key(op, backend, sig, config)).add(seconds)

    def observe_timing(self, op: str, backend: str, sig: str, stats: TimingStats,
                       config: str = "") -> None:
        """Fold a hyperfine benchmark result in as ``stats.runs`` samples."""
        with self._lock:
            e = self._entry_for_write(profile_key(op, backend, sig, config))
            mean_s = stats.mean_ms / 1e3
            for _ in range(max(stats.runs, 1)):
                e.add(mean_s)
            e.min_s = min(e.min_s, stats.min_ms / 1e3)

    def ingest_event_log(self, log: EventLog) -> int:
        """Replay ``dispatch`` events (payload dicts) from a previous run."""
        n = 0
        for ev in log.events(kind="dispatch"):
            p = ev.payload
            if not isinstance(p, dict) or not isinstance(p.get("measured_s"), (int, float)):
                continue
            self.record(p["op"], p["backend"], p.get("sig", "<scalar>"),
                        p["measured_s"], config=p.get("config", ""))
            n += 1
        return n

    # -- readers -------------------------------------------------------------

    def entry(self, op: str, backend: str, sig: str,
              config: str = "") -> Optional[ProfileEntry]:
        return self._entries.get(profile_key(op, backend, sig, config))

    def samples(self, op: str, backend: str, sig: str, config: str = "") -> int:
        e = self.entry(op, backend, sig, config)
        return e.count if e else 0

    def warm(self, op: str, backend: str, sig: str, config: str = "") -> bool:
        return self.samples(op, backend, sig, config) >= self.min_samples

    def lookup(self, op: str, backend: str, sig: str,
               config: str = "") -> Optional[float]:
        """Measured seconds, or None if the key is not warm yet.

        Uses the *minimum* observed time (hyperfine's robust statistic; the
        dispatcher times a call on the card with CUDA events, others on the
        host's clock):
        the first sample of a jitted variant includes compilation, and a mean
        polluted by one cold call would mis-rank backends for the rest of the
        run.  With ``min_samples >= 2`` the minimum is a warm execution.

        Not so for a compiled step on the card (``serving/compiled.py``): its
        first call runs eagerly and its second captures a CUDA graph and
        replays it, so only a third sample is a plain replay.  The store
        stays as the JAX one; the port's drivers warm such steps with
        ``min_samples=3`` (``DispatchConfig``), so every warm set holds one.
        """
        e = self.entry(op, backend, sig, config)
        if e is None or e.count < self.min_samples:
            return None
        return e.min_s

    def combined_cost(self, op: str, backend: str, sig: str, estimate_s: float,
                      config: str = "") -> tuple[float, str]:
        """Measured-beats-estimated: (seconds, source)."""
        measured = self.lookup(op, backend, sig, config)
        if measured is not None:
            return measured, "measured"
        return estimate_s, "roofline"

    def config_points(self, op: str, backend: str, sig: str) -> dict[str, ProfileEntry]:
        """All measured config points of one (op, backend, sig), keyed by the
        canonical config encoding (``""`` = backend defaults / legacy keys).

        This is the read side of the design-space sweep: the tuner (ROADMAP
        M12) records each point as an ordinary sample, and consumers argmin
        over what came back — from this run, a ``--profile-in`` file, or a
        fleet pull.
        """
        out: dict[str, ProfileEntry] = {}
        with self._lock:
            for key, e in self._entries.items():
                try:
                    k_op, k_backend, k_sig, k_config = parse_profile_key(key)
                except ValueError:
                    continue
                if k_op == op and k_backend == backend and k_sig == sig:
                    out[k_config] = e
        return out

    def best_config(self, op: str, backend: str,
                    sig: str) -> Optional[tuple[str, float]]:
        """Argmin-cost *warm* config point: ``(config, min_s)`` or None.

        The default point (``config == ""``) competes on equal terms, so a
        tuned config is only ever preferred when its measured minimum beats
        the hand-picked default's.
        """
        best: Optional[tuple[str, float]] = None
        for config, e in self.config_points(op, backend, sig).items():
            if e.count < self.min_samples:
                continue
            if best is None or e.min_s < best[1]:
                best = (config, e.min_s)
        return best

    def merge(self, other: "ProfileStore") -> int:
        """Fold another store's samples in (warm-start across runs).

        Welford states combine exactly (Chan et al. parallel variance), so
        merging N per-run stores equals one store that saw every sample.
        Entries merged from *different* environments get a ``"mixed"`` stamp:
        it never matches a real SHA/chip, so :meth:`age_out` conservatively
        evicts them — samples of unknown provenance must not survive an
        invalidation pass.  ``count == 0`` placeholder rows in ``other`` are
        skipped outright: they carry no samples, and materialising them here
        would create warm-looking empty entries (inflating ``profiled_keys``
        and polluting stamps).  Returns the number of samples merged.
        """

        merged = 0
        with self._lock:
            for k, o in list(other._entries.items()):
                if o.count == 0:  # placeholder row: no samples to fold in
                    continue
                e = self._entries.get(k)
                if e is None or e.count == 0:
                    # absent or a sample-less placeholder: take the incoming
                    # entry wholesale — combining stamps with a placeholder
                    # would launder real provenance to 'mixed' and get the
                    # samples evicted by the next age-out pass
                    self._entries[k] = ProfileEntry(
                        o.count, o.mean_s, o.m2, o.min_s, o.git_sha, o.chip
                    )
                    merged += o.count
                    continue
                n = e.count + o.count
                delta = o.mean_s - e.mean_s
                e.m2 = e.m2 + o.m2 + delta * delta * e.count * o.count / n
                e.mean_s = e.mean_s + delta * o.count / n
                e.count = n
                e.min_s = min(e.min_s, o.min_s)
                e.git_sha = _combine_stamp(e.git_sha, o.git_sha)
                e.chip = _combine_stamp(e.chip, o.chip)
                merged += o.count
        return merged

    def delta_since(self, baseline: "ProfileStore") -> "ProfileStore":
        """Samples added to this store since ``baseline`` (an earlier
        snapshot of the *same* store).

        Welford states subtract exactly as they merge: for every key the
        returned store holds a state D such that ``baseline.merge(D)``
        reproduces this store's count/mean/m2.  ``min_s`` is carried whole —
        min-merging is idempotent, so re-pushing it is harmless.  Keys with
        no new samples are omitted.  This is what lets a long-lived run push
        per-rotation snapshots to a fleet store without double-counting the
        samples it already pushed.
        """
        out = ProfileStore(min_samples=self.min_samples)
        with self._lock:
            for k, e in list(self._entries.items()):
                if e.count == 0:  # placeholder row: nothing to push
                    continue
                b = baseline._entries.get(k)
                if b is None or b.count == 0:
                    out._entries[k] = ProfileEntry(
                        e.count, e.mean_s, e.m2, e.min_s, e.git_sha, e.chip
                    )
                    continue
                n = e.count - b.count
                if n <= 0:  # no new samples (counts never shrink in place)
                    continue
                mean = (e.count * e.mean_s - b.count * b.mean_s) / n
                delta = mean - b.mean_s
                m2 = e.m2 - b.m2 - delta * delta * b.count * n / e.count
                out._entries[k] = ProfileEntry(
                    n, mean, max(m2, 0.0), e.min_s, e.git_sha, e.chip
                )
        return out

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> str:
        def row(e: ProfileEntry) -> dict[str, Any]:
            d: dict[str, Any] = {"count": e.count, "mean_s": e.mean_s,
                                 "m2": e.m2, "min_s": e.min_s}
            if e.git_sha:
                d["git_sha"] = e.git_sha
            if e.chip:
                d["chip"] = e.chip
            return d

        # under the store lock: a concurrent record() (streaming rotation on
        # another thread serialising mid-run) must neither break iteration
        # nor expose a mid-add torn Welford state
        with self._lock:
            return json.dumps(
                {
                    "min_samples": self.min_samples,
                    "entries": {k: row(e) for k, e in list(self._entries.items())},
                },
                indent=1,
            )

    @classmethod
    def from_json(cls, text: str) -> "ProfileStore":
        raw = json.loads(text)
        store = cls(min_samples=raw.get("min_samples", 2))
        for k, d in raw.get("entries", {}).items():
            store._entries[k] = ProfileEntry(
                count=d["count"], mean_s=d["mean_s"], m2=d.get("m2", 0.0),
                min_s=d.get("min_s", float("inf")),
                git_sha=d.get("git_sha", ""), chip=d.get("chip", ""),
            )
        return store

    def __len__(self) -> int:
        return len(self._entries)
