"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

The build runs at first use, into ``build/repro_torch/`` at the repository
root, keyed by a hash of the sources and flags, so a changed source rebuilds
and an unchanged one loads at once.  :func:`build` starts one ``nvcc`` per
source, all at once.  ptxas' register / shared-memory report for each
library is kept beside it as ``<name>-<hash>.log``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.  A build or launch
that fails raises: nothing falls back to the plain version.

A wrapper may run inside a CUDA graph's capture (``serving/compiled.py``):
it launches on ``torch.cuda.current_stream()``, which is then the capture
stream.  The host work of a wrapper's first call (the build, the library
load, the SM-count query, and each kernel instance's first shared-memory
opt-in, ``allow_smem`` in ``csrc/common.cuh``) belongs in the eager call
that precedes each capture; a build, load or query that would first happen
inside a capture raises instead (:func:`refuse_in_capture`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SOURCES = ("flash_attention", "flash_attention_bwd", "flash_attention_bwd_sm90",
           "decode_attention", "rmsnorm", "moe_gmm", "moe_gmm_bwd", "rwkv6_scan", "mamba_scan")
# element types the CUDA kernels take (enum ReproDtype in csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH)")
    return found


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> dict[str, Path]:
    """Compile every named source that is not built yet, in parallel."""
    out = {name: lib_path(name) for name in names}
    todo = {name: path for name, path in out.items() if not path.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        path = todo[name]
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


# the end of a kernel's refusal inside a capture: its host work (a build, a
# library load, a device query) comes first in an eager call
EAGER_FIRST = ("first happened inside a CUDA graph capture; call the kernel once eagerly "
               "at the same shapes before capturing it")


def refuse_in_capture(message: str) -> None:
    """Raise ``message`` if the current CUDA stream is capturing a graph: the
    caller is about to do host work (a build, a device query, a read to the
    host) that a capture cannot hold."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(message)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            refuse_in_capture(f"building and loading csrc/{name}.cu {EAGER_FIRST}")
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


_SM_COUNTS: dict[int, int] = {}


def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the kernels' plans
    size their grids by it), queried once per device."""
    n = _SM_COUNTS.get(index)
    if n is None:
        refuse_in_capture(f"the SM count query of device {index} {EAGER_FIRST}")
        n = _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


# what common.cuh's kernel_info reports of a kernel instance
INFO_KEYS = ("registers", "spilled_bytes", "static_smem", "dynamic_smem", "blocks_per_sm")


def instance_info(lib: ctypes.CDLL, entry: str, *args: int, device: int = 0) -> dict[str, int]:
    """What the card made of one kernel instance, from the C entry point
    ``entry(*args, out)`` that fills common.cuh's kernel_info on CUDA device
    ``device``: registers and spilled bytes a thread, static and dynamic
    shared memory a block, and the blocks an SM holds."""
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(INFO_KEYS))()
    with torch.cuda.device(device):
        check(lib, fn(*args, out), entry)
    return dict(zip(INFO_KEYS, out))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
