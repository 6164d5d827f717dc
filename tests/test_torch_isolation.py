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
