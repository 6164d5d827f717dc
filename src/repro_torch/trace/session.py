"""Provenance and profile files: the part of ``repro/trace/session.py`` that
the dispatcher and the drivers' ``--profile-in`` need.

* :func:`git_sha` stamps the samples a dispatcher measures
  (``dispatch/dispatcher.py``), beside the chip's name;
* :func:`load_profile_store` / :func:`load_profile_stores` read the bare
  :class:`~repro_torch.dispatch.profiles.ProfileStore` JSON that
  ``--profile-out`` writes (either package's);
* :func:`age_out_profiles` drops the entries measured on other code or
  another chip, so a store of TPU samples never steers dispatch on the card.

Session files (the event trace, decisions and store of a run in one JSON)
come with the rest of the trace layer (ROADMAP M11).
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

from repro_torch.dispatch.profiles import ProfileStore


@functools.lru_cache(maxsize=1)
def git_sha() -> str:
    """Short SHA of the checkout this module lives in ("unknown" outside git)."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def load_profile_store(path: str) -> ProfileStore:
    """Read a bare ProfileStore JSON file."""
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict) or "entries" not in raw:
        # a silently empty store would make --profile-in a no-op with no signal
        raise ValueError(f"{path} is not a ProfileStore JSON (expected an 'entries' key; "
                         "trace sessions come with ROADMAP M11)")
    return ProfileStore.from_json(json.dumps(raw))


def load_profile_stores(paths: list[str]) -> ProfileStore:
    """Load one or more profile files and merge them into a single store."""
    stores = [load_profile_store(p) for p in paths]
    base = stores[0]
    for s in stores[1:]:
        base.merge(s)
    return base


def age_out_profiles(store: ProfileStore, chip_name: str) -> list[dict[str, str]]:
    """Evict ``--profile-in`` entries measured on different code or hardware
    (the current checkout's SHA, ``chip_name``); each eviction is logged to
    stderr with its reason, and the drivers print the count."""
    aged = store.age_out(git_sha=git_sha(), chip=chip_name)
    for a in aged:
        print(f"profile-in: aged out {a['key']}: {a['reason']}", file=sys.stderr)
    return aged
