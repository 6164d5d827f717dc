"""Checkpoint store: manifest + npz payloads, async writer (counterpart of
``repro/checkpoint/store.py``, in its layout).

Layout (one directory per step):

    <dir>/step_000042/
        manifest.json     step, then per leaf its key / shape / dtype
        arrays.npz        one entry per leaf, under the leaf's key

A leaf's key is its ``/``-joined path in the nested dict, and the leaves
are listed in the JAX store's order (each dict's keys sorted, as
``jax.tree_util`` flattens them), so the two packages write the same
manifest for the same tree.

* **bf16.**  numpy has no bfloat16, so a bf16 leaf is stored as its 16-bit
  words (``uint16``) under manifest dtype ``"bfloat16"``: the bytes the JAX
  store writes (as ``|V2`` voids, through ``ml_dtypes``).  :func:`restore`
  reads either and views the words as bf16, so it restores a bf16
  checkpoint the JAX store wrote, which the JAX store itself cannot
  (ROADMAP R12).
* **Async save.**  :class:`AsyncCheckpointer` blocks the train loop only for
  the snapshot to host, a copy on every device (on the CPU ``Tensor.cpu()``
  would return the live storage, which the next in-place step changes), and
  writes the files on a thread.
* **Sharded state.**  A ``DTensor`` leaf is saved as its whole tensor
  (``full_tensor``, a gather on every rank), so the layout stays the one
  above and a checkpoint restores onto any mesh: :func:`restore` reads the
  whole tensors and, given ``shardings``
  (``distributed.sharding.tree_shardings``), distributes them; and
  :func:`restore_into` copies each rank's shard into a live DTensor.
* **Atomicity.**  A checkpoint is written into ``<dir>/.tmp_step_N``,
  fsynced, and renamed to ``step_N`` only then, so a killed writer never
  leaves a half checkpoint that :func:`latest_step` would pick.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

Tree = Any


def _flatten(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) pairs in the JAX store's order: each dict's keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host tensor as the array the npz stores and the manifest's dtype."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _whole(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _snapshot(state: Tree) -> list[tuple[str, torch.Tensor]]:
    """Host copies of every leaf (never the live storage); a DTensor's
    whole tensor."""
    return [(k, _whole(t.detach()).to("cpu", copy=True)) for k, t in _flatten(state)]


def save(directory: str, step: int, state: Tree) -> str:
    """Synchronous checkpoint write.  Returns the final path."""
    return _write(directory, step, _snapshot(state))


def _write(directory: str, step: int, host: list[tuple[str, torch.Tensor]]) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp_step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    arrays, leaves = {}, []
    for k, t in host:
        arrays[k], dtype = _to_numpy(t)
        leaves.append({"key": k, "shape": list(t.shape), "dtype": dtype})
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": leaves}, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step (``.tmp_*`` directories are not
    checkpoints), or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and os.path.isdir(os.path.join(directory, d))]
    return max(steps) if steps else None


def _read(directory: str, step: int, like: Tree):
    """(key, like leaf, host tensor of checkpoint ``step``) for every leaf
    of ``like``, read one at a time; a stored shape that differs raises."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = {leaf["key"]: leaf["dtype"] for leaf in json.load(f)["leaves"]}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for k, t in _flatten(like):
            yield k, t, _from_numpy(z[k], dtypes[k], t)


def restore(directory: str, step: int, like: Tree, shardings: Optional[Tree] = None) -> Tree:
    """A new tree with ``like``'s structure, each leaf read from checkpoint
    ``step`` onto the like leaf's device in its dtype; a stored shape that
    differs from the like leaf's raises.  With ``shardings`` (a tree of
    ``distributed.sharding.Sharding`` in ``like``'s structure), each whole
    leaf is then distributed onto its mesh: the payload is unsharded, so
    any target mesh works."""
    flat = {k: host.to(device=t.device, dtype=t.dtype)
            for k, t, host in _read(directory, step, like)}
    shd = dict(_flatten(shardings)) if shardings is not None else {}

    def build(tree: Tree, prefix: str = "") -> Tree:
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
        t = flat[prefix[:-1]]
        s = shd.get(prefix[:-1])
        return s.distribute(t) if s is not None else t

    return build(like)


def restore_into(directory: str, step: int, state: Tree) -> None:
    """Checkpoint ``step`` copied into the tensors of ``state`` in place,
    leaf by leaf from the host: no second copy of the state on its device,
    and every leaf keeps its storage (a captured graph reads it there).  A
    DTensor leaf takes this rank's shard of the whole tensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    with torch.no_grad():
        for _, live, host in _read(directory, step, state):
            if isinstance(live, DTensor):
                shard = distribute_tensor(host.to(live.device), live.device_mesh,
                                          live.placements)
                live.to_local().copy_(shard.to_local())
            else:
                live.copy_(host)


def _from_numpy(a: np.ndarray, dtype: str, like: torch.Tensor) -> torch.Tensor:
    if dtype == "bfloat16":  # uint16 (this store) or |V2 (the JAX store)
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} restored into "
                         f"{tuple(like.shape)}")
    return t


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training.

    ``save()`` snapshots to host (blocking) and hands the write, then the
    garbage collection that keeps the newest ``keep`` checkpoints, to a
    daemon thread; ``wait()`` joins the write in flight and raises its
    error.  One write in flight at a time: ``save()`` waits for the last.
    """

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: Tree) -> None:
        self.wait()
        host = _snapshot(state)

        def _run() -> None:
            try:
                _write(self.directory, step, host)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True, name="ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory) if d.startswith("step_"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)
