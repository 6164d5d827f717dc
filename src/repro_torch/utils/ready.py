"""Ready-file + ``--port 0`` startup handshake, shared by every daemon CLI
(counterpart of ``repro/utils/ready.py``).

The pattern: a server binds port 0 (the OS picks a free port), then announces
the bound URL by atomically writing a small *ready file*; whoever spawned it
(a CI script, the router's ReplicaManager, a test) polls for that file
instead of guessing ports or parsing logs.  One writer helper and one waiter
helper, so ``repro_torch.fleet serve``, ``repro_torch.router`` and its replicas — and
any future daemon — all speak the same handshake.

The payload is a single line of text (a bare URL) or a JSON object for
daemons that need to announce more than a URL (the router replicas report
pid/chip/git SHA too).  ``wait_for_ready_file`` returns the raw text;
``read_ready_info`` parses either form into a dict with at least ``url``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

from repro_torch.utils.io import atomic_write


def write_ready_file(path: str, payload: Any) -> None:
    """Announce readiness: atomically write the URL (str) or info (dict).

    Atomic write-then-rename means a polling reader never sees a torn file —
    the file either does not exist yet or carries the complete payload.
    """
    text = payload if isinstance(payload, str) else json.dumps(payload)
    atomic_write(path, text)


def read_ready_info(path: str) -> dict[str, Any]:
    """Parse a ready file into ``{"url": ..., ...}`` (bare-URL or JSON form)."""
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("{"):
        info = json.loads(text)
        if not isinstance(info, dict) or "url" not in info:
            raise ValueError(f"ready file {path} carries no 'url': {text[:120]!r}")
        return info
    return {"url": text}


def wait_for_ready_file(
    path: str,
    timeout_s: float = 60.0,
    *,
    poll_s: float = 0.05,
    proc: Optional[Any] = None,
) -> str:
    """Poll until the ready file appears; return its text.

    ``proc`` (a ``subprocess.Popen``) short-circuits the wait when the daemon
    died before announcing — the caller gets a ``RuntimeError`` immediately
    instead of burning the whole timeout against a corpse.
    """
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                text = f.read().strip()
            if text:  # atomic_write means non-empty == complete
                return text
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(
                f"process exited (rc={proc.returncode}) before writing "
                f"ready file {path}")
        time.sleep(poll_s)
    raise TimeoutError(f"ready file {path} did not appear within {timeout_s}s")
