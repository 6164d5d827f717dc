"""Checkpoint store: npz + manifest, async save, restore into a tree's shape."""

from repro_torch.checkpoint.store import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    restore,
    restore_into,
    save,
)
