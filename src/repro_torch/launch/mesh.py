"""Mesh construction (functions only: importing touches no device or
process group): the counterpart of ``repro/launch/mesh.py``.

The JAX package's production topology is kept, so a cell's shardings are
its shardings: 16 x 16 = 256 devices ``("data", "model")``, and the
multi-pod mesh's leading ``"pod"`` axis, 2 x 16 x 16 = 512.  ``data`` is
the FSDP axis, ``model`` the TP/EP axis, ``pod`` pure DP.

* :func:`make_production_mesh` builds that mesh over a ``fake`` process
  group of 256 / 512 ranks in this one process, for the meta-device
  dry-run only (``launch/dryrun.py``): DTensor's sharding propagation runs
  as it would on every rank, and every collective returns at once without
  moving a byte.  The ``fake`` backend lives in ``torch.testing._internal``
  (a private module), so it is imported only here, and
  :func:`destroy_mesh` takes the group down when the dry-run ends.
* :func:`make_local_mesh` is a 1 x 1 mesh on the card (an ``nccl`` group of
  one rank) or on the CPU (``gloo``).
* :func:`build_mesh` parses ``launch.train``'s ``--mesh DxM`` and refuses a
  mesh larger than the world the caller set up.
"""
from __future__ import annotations

import os
import socket
from typing import Any, Optional

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_production_mesh(*, multi_pod: bool = False) -> Any:
    """The 16 x 16 (or 2 x 16 x 16) mesh over a ``fake`` process group of
    this process alone (rank 0 of 256 / 512), on the ``meta``-friendly
    ``cpu`` device type.  Replaces any default group this process holds."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = MULTI_POD_AXES if multi_pod else PRODUCTION_AXES
    n = 1
    for s in shape:
        n *= s
    destroy_mesh()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def destroy_mesh() -> None:
    """Take down this process's default group, if any."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def init_world(device: str, *, rank: int = 0, world_size: int = 1,
               init_method: Optional[str] = None) -> None:
    """The default process group for a real mesh: ``nccl`` on the card,
    ``gloo`` on the CPU, at ``init_method`` (``tcp://localhost:<port>``; a
    free port for a world of one)."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init_method = init_method or f"tcp://localhost:{free_port()}"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def make_local_mesh(device: str = "cuda") -> Any:
    """A 1 x 1 ``("data", "model")`` mesh of this process alone."""
    from torch.distributed.device_mesh import init_device_mesh

    init_world(device)
    return init_device_mesh(device, (1, 1), mesh_dim_names=PRODUCTION_AXES)


def parse_mesh(spec: str) -> tuple[int, int]:
    """``"DxM"`` -> (data, model)."""
    try:
        data, model = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: want DxM, e.g. 1x1 or 1x2") from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {spec!r}: axes must be >= 1")
    return data, model


def build_mesh(spec: str, device: str = "cuda") -> Any:
    """The ``("data", "model")`` mesh ``spec`` asks for over the default
    process group (set up by the caller: :func:`init_world`).  Raises when
    the world is smaller than the mesh, or on the card when the machine
    has fewer devices than the mesh's ranks on this host need."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    data, model = parse_mesh(spec)
    n = data * model
    world = dist.get_world_size() if dist.is_initialized() else 1
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"--mesh {spec} needs {n} devices, this machine has "
                           f"{torch.cuda.device_count()} (one card runs --mesh 1x1)")
    if world != n:
        raise RuntimeError(f"--mesh {spec} needs a world of {n} ranks, have {world}")
    return init_device_mesh(device, (data, model), mesh_dim_names=PRODUCTION_AXES)


def rank_env() -> tuple[int, int]:
    """(rank, world size) from ``RANK`` / ``WORLD_SIZE``, (0, 1) without them."""
    return int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))
