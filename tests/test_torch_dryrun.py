"""The port's multi-pod dry-run (``repro_torch.launch.dryrun``), the
counterpart of ``tests/test_dryrun.py``: each cell runs in a child process,
so its fake process group of 256 / 512 ranks never reaches this one.  The
four JAX cases (a single-pod train cell, a decode cell, a multi-pod cell,
the long_500k skip) run at once, and each record must carry every key of
the JAX package's record.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

# the keys of a JAX dry-run record (repro/launch/dryrun.py, run_cell)
JAX_KEYS = {"arch", "shape", "mesh", "n_devices", "variant", "step", "lower_s", "compile_s",
            "hlo_flops_per_dev", "hlo_bytes_per_dev", "collective_bytes_per_dev",
            "collective_breakdown", "xla_cost_flops_per_dev", "t_compute_s", "t_memory_s",
            "t_collective_s", "bottleneck", "step_time_bound_s", "memory_analysis",
            "model_flops_global", "useful_flops_ratio", "t_model_ideal_s", "roofline_fraction",
            "status"}
CASES = {"train": ("--arch", "qwen2-0.5b", "--shape", "train_4k"),
         "decode": ("--arch", "qwen2-0.5b", "--shape", "decode_32k"),
         "multi_pod": ("--arch", "qwen2-0.5b", "--shape", "train_4k", "--multi-pod"),
         "long": ("--arch", "qwen2-0.5b", "--shape", "long_500k")}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{case: ([records], exit code)}, the four cells run at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {}
    for name, args in CASES.items():
        with open(tmp / f"{name}.err", "wb") as err:
            procs[name] = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                                            *args], stdout=subprocess.PIPE, stderr=err,
                                           text=True, env=env, cwd=ROOT)
    out = {}
    for name, proc in procs.items():
        stdout, _ = proc.communicate(timeout=600)
        lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
        assert lines, f"{name}: no record; stderr {(tmp / f'{name}.err').read_text()[-2000:]}"
        out[name] = ([json.loads(ln) for ln in lines], proc.returncode)
    return out


def test_single_pod_train_cell(records):
    recs, rc = records["train"]
    assert rc == 0
    r = recs[0]
    assert r["status"] == "ok" and r["n_devices"] == 256 and r["step"] == "train_step"
    assert r["mesh"] == "16x16"
    assert r["hlo_flops_per_dev"] > 0 and r["collective_bytes_per_dev"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert JAX_KEYS <= set(r), JAX_KEYS - set(r)
    assert r["xla_cost_flops_per_dev"] is None and r["flop_counter_flops_per_dev"] > 0
    assert r["memory_analysis"]["argument_bytes"] > 0
    assert 0 < r["roofline_fraction"] < 1


def test_single_pod_decode_cell(records):
    recs, rc = records["decode"]
    assert rc == 0 and recs[0]["status"] == "ok" and recs[0]["step"] == "serve_step"
    assert JAX_KEYS <= set(recs[0])


def test_multi_pod_cell(records):
    recs, rc = records["multi_pod"]
    assert rc == 0
    r = recs[0]
    assert r["status"] == "ok" and r["n_devices"] == 512 and r["mesh"] == "2x16x16"
    single = records["train"][0][0]
    # the pod axis only splits the batch further: half the per-device work
    assert r["hlo_flops_per_dev"] < single["hlo_flops_per_dev"]


def test_long_500k_skip_for_pure_attention(records):
    recs, rc = records["long"]
    assert rc == 0
    assert recs[0]["status"] == "skip" and "full-attention" in recs[0]["reason"]
