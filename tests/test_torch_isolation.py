"""The port stands alone: it imports neither JAX nor the JAX package, imports
without Triton, and its chip check refuses to run without a card."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["triton"] = None  # import triton now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro") and sys.modules[m] is not None)
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_no_repro_and_no_triton():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 15


# the paper's measurement layer (ROADMAP M11): each imports alone, without
# JAX or the JAX package, and never triton
MEASUREMENT_MODULES = ["repro_torch.hw.specs", "repro_torch.core.scopes",
                       "repro_torch.core.tracepoints", "repro_torch.configs.microbench",
                       "repro_torch.core.uprobes", "repro_torch.core.overhead",
                       "repro_torch.core.roofline", "repro_torch.core.sdfg"]

_IMPORT_ONE = r"""
import importlib, sys
sys.modules["triton"] = None
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro") and sys.modules[m] is not None)
assert not bad, bad
"""


@pytest.mark.parametrize("module", MEASUREMENT_MODULES)
def test_measurement_module_imports_no_jax_no_repro(module):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    source = (REPO / "src" / (module.replace(".", "/") + ".py")).read_text()
    assert "import jax" not in source and "from repro." not in source


# the frontend stub imports alone, without repro/nn/frontend.py (which
# imports JAX through repro.nn.core): the port keeps its own copy
@pytest.mark.parametrize("module", ["repro_torch.nn.frontend", "repro_torch.nn.attention"])
def test_model_module_imports_no_jax_no_repro(module):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    source = (REPO / "src" / (module.replace(".", "/") + ".py")).read_text()
    assert "import jax" not in source and "from repro." not in source


# profile-guided dispatch (ROADMAP M8) and its provenance module: each
# imports alone, without JAX, the JAX package (not even the jax-free
# repro/dispatch/profiles.py or repro/trace/session.py) or triton
DISPATCH_MODULES = ["repro_torch.dispatch", "repro_torch.dispatch.profiles",
                    "repro_torch.dispatch.registry", "repro_torch.dispatch.cost",
                    "repro_torch.dispatch.dispatcher", "repro_torch.trace.session"]


@pytest.mark.parametrize("module", DISPATCH_MODULES)
def test_dispatch_module_imports_no_jax_no_repro(module):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    path = REPO / "src" / module.replace(".", "/")
    source = (path / "__init__.py" if path.is_dir() else path.with_suffix(".py")).read_text()
    assert "import jax" not in source and "from repro." not in source


# the trace and metrics plane (ROADMAP M11): each imports alone, without
# JAX, the JAX package (not even its jax-free repro/trace, repro/metrics and
# repro/utils modules) or triton
TRACE_MODULES = ["repro_torch.core.events", "repro_torch.utils.io", "repro_torch.utils.ready",
                 "repro_torch.trace.collector", "repro_torch.trace.session",
                 "repro_torch.trace.export", "repro_torch.trace.stream",
                 "repro_torch.trace.device", "repro_torch.trace.liveprof",
                 "repro_torch.trace.cli", "repro_torch.trace.__main__",
                 "repro_torch.metrics", "repro_torch.metrics.registry",
                 "repro_torch.metrics.sink", "repro_torch.metrics.controller",
                 "repro_torch.metrics.http"]


@pytest.mark.parametrize("module", TRACE_MODULES)
def test_trace_module_imports_no_jax_no_repro(module):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    path = REPO / "src" / module.replace(".", "/")
    source = (path / "__init__.py" if path.is_dir() else path.with_suffix(".py")).read_text()
    assert "import jax" not in source and "from repro." not in source
    assert "import repro." not in source and "import triton" not in source


# ROADMAP M13 and M11's hloanalysis counterpart: sharding over a DeviceMesh,
# the meta-device dry-run and its pricing; each imports alone, without JAX,
# the JAX package (not even its jax-free pieces) or triton, and none of them
# starts a process group on import
MESH_MODULES = ["repro_torch.utils.tree", "repro_torch.distributed",
                "repro_torch.distributed.sharding", "repro_torch.distributed.constrain",
                "repro_torch.launch.mesh", "repro_torch.launch.inputs",
                "repro_torch.launch.dryrun", "repro_torch.core.graphanalysis"]

_IMPORT_NO_GROUP = _IMPORT_ONE + r"""
import torch.distributed as dist
assert not dist.is_initialized()
"""


@pytest.mark.parametrize("module", MESH_MODULES)
def test_mesh_module_imports_no_jax_no_repro(module):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_NO_GROUP, module], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    path = REPO / "src" / module.replace(".", "/")
    source = (path / "__init__.py" if path.is_dir() else path.with_suffix(".py")).read_text()
    assert "import jax" not in source and "from repro." not in source
    assert "import repro." not in source and "import triton" not in source


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """No card here: chip_smoke.py exits non-zero and prints no result line,
    in the repo and as a lone file."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          cwd=script.parent, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# ROADMAP M12's serving tier: the fleet, the router and the stitcher import
# neither JAX nor the JAX package (not even its jax-free repro/fleet,
# repro/router and repro/trace/stitch.py), and no torch either: the fleet
# daemon, the router process and synthetic replicas start without it (only
# a real replica's ``_build_real_engine`` imports it)
SERVING_TIER_MODULES = ["repro_torch.fleet", "repro_torch.fleet.store",
                        "repro_torch.fleet.client", "repro_torch.fleet.service",
                        "repro_torch.fleet.cli", "repro_torch.fleet.__main__",
                        "repro_torch.router", "repro_torch.router.cost",
                        "repro_torch.router.manager", "repro_torch.router.frontdoor",
                        "repro_torch.router.replica", "repro_torch.router.loadgen",
                        "repro_torch.router.cli", "repro_torch.router.__main__",
                        "repro_torch.trace.stitch",
                        # ROADMAP M12's tune/: the spaces, the pruner and the CLI (and
                        # the explorer's synthetic path) enumerate and price without
                        # torch, as do the launch plans they price with
                        "repro_torch.tune", "repro_torch.tune.space",
                        "repro_torch.tune.prune", "repro_torch.tune.explore",
                        "repro_torch.tune.cli", "repro_torch.tune.__main__",
                        "repro_torch.kernels.plan"]

_IMPORT_NO_TORCH = r"""
import importlib, sys
sys.modules["torch"] = None  # import torch now raises ImportError
sys.modules["triton"] = None
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "numpy") and sys.modules[m] is not None)
assert not bad, bad
"""


@pytest.mark.parametrize("module", SERVING_TIER_MODULES)
def test_serving_tier_module_imports_no_torch_no_jax_no_repro(module):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_NO_TORCH, module], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    path = REPO / "src" / module.replace(".", "/")
    source = (path / "__init__.py" if path.is_dir() else path.with_suffix(".py")).read_text()
    assert "import jax" not in source and "from repro." not in source
    assert "import repro." not in source and "import triton" not in source
