"""Shared filesystem helpers (counterpart of ``repro/utils/io.py``)."""
from __future__ import annotations

import os


def atomic_write(path: str, text: str) -> None:
    """Write-then-rename with fsync: readers never see a torn file."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
