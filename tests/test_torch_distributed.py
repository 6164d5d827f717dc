"""Sharded execution on the CPU: real gloo ranks, the split-KV decode's
combine across them, and ``launch.train --mesh``.

* ``ops.decode_attention_seq_sharded`` on a 1 x 2 gloo mesh, its cache's
  sequence split over ``model``, equals the unsharded plain decode within
  1e-5 (f32), a window and a softcap included; with no ambient mesh, or an
  axis it lacks, it returns None.  On one process with a mesh of one
  device it combines a cache split by hand into 1, 2 and 4 sequence
  shards exactly as one call does.
* K2's plain stats (``ref.decode_attention_ref(return_stats=True)``) equal
  the JAX ``decode_attention_ref(return_stats=True)``.
* ``launch.train --device cpu --mesh 1x2`` on reduced smollm-360m, 3 steps
  over two gloo ranks the driver spawns, equals the run without a mesh
  within 1e-5 (f32), and ``--mesh 1x1`` equals it bit for bit; a mesh the
  machine cannot hold is refused.

Every process group lives in a child process, so none leaks into the test
process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src")}

_SEQ_SHARDED = r"""
import sys, socket
import torch, torch.multiprocessing as mp

def run(rank, world, port, case):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from repro_torch.distributed.constrain import mesh_scope
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import build_mesh, init_world
    init_world("cpu", rank=rank, world_size=world, init_method=f"tcp://localhost:{port}")
    mesh = build_mesh("1x2", "cpu")
    window, softcap = case
    g = torch.Generator().manual_seed(0)
    B, S, Hq, Hkv, D = 3, 64, 8, 2, 16
    q = torch.randn(B, Hq, D, generator=g)
    k, v = torch.randn(B, S, Hkv, D, generator=g), torch.randn(B, S, Hkv, D, generator=g)
    pos = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    pos[1, 40:] = -1  # row 1: its second half empty, so one shard holds no live slot
    cur = torch.tensor([63, 39, 50], dtype=torch.int32)
    want = ref.decode_attention_ref(q, k, v, pos, cur, window=window, softcap=softcap)
    seq = [Replicate(), Shard(1)]
    dk, dv, dp = (distribute_tensor(t, mesh, seq) for t in (k, v, pos))
    dq, dc = (distribute_tensor(t, mesh, [Replicate(), Replicate()]) for t in (q, cur))
    with mesh_scope(mesh):
        got = ops.decode_attention_seq_sharded(dq, dk, dv, dp, dc, window=window,
                                               softcap=softcap, seq_axes=("model",))
        absent = ops.decode_attention_seq_sharded(dq, dk, dv, dp, dc, seq_axes=("pod",))
    assert absent is None
    assert isinstance(got, DTensor), type(got)
    err = (got.full_tensor() - want).abs().max().item()
    if rank == 0:
        print("ERR", err)
    dist.destroy_process_group()

if __name__ == "__main__":
    s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]; s.close()
    window = None if sys.argv[1] == "none" else int(sys.argv[1])
    softcap = None if sys.argv[2] == "none" else float(sys.argv[2])
    mp.spawn(run, args=(2, port, (window, softcap)), nprocs=2)
"""


@pytest.mark.parametrize("window,softcap", [(None, None), (24, 30.0)])
def test_seq_sharded_decode_on_two_gloo_ranks_equals_the_plain_decode(window, softcap, tmp_path):
    script = tmp_path / "seq_sharded.py"  # spawn pickles ``run`` by its module's file
    script.write_text(_SEQ_SHARDED)
    proc = subprocess.run([sys.executable, str(script), str(window).lower(),
                           str(softcap).lower()], capture_output=True, text=True, env=ENV,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    err = float(proc.stdout.split("ERR")[1].split()[0])
    assert err <= 1e-5


def test_seq_sharded_decode_needs_a_mesh():
    from repro_torch.kernels import ops

    q = torch.randn(1, 2, 8)
    k = torch.randn(1, 4, 1, 8)
    pos = torch.arange(4, dtype=torch.int32)[None]
    cur = torch.tensor([3], dtype=torch.int32)
    assert ops.decode_attention_seq_sharded(q, k, k, pos, cur) is None


_SHARD_COMBINE = r"""
import torch
from repro_torch.distributed.constrain import mesh_scope
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import destroy_mesh, make_local_mesh
mesh = make_local_mesh("cpu")
g = torch.Generator().manual_seed(1)
B, S, Hq, Hkv, D = 2, 128, 4, 2, 16
q = torch.randn(B, Hq, D, generator=g)
k, v = torch.randn(B, S, Hkv, D, generator=g), torch.randn(B, S, Hkv, D, generator=g)
pos = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
cur = torch.tensor([127, 70], dtype=torch.int32)
want = ref.decode_attention_ref(q, k, v, pos, cur, window=50)
worst = 0.0
with mesh_scope(mesh):
    one = ops.decode_attention_seq_sharded(q, k, v, pos, cur, window=50, seq_axes=("model",))
    worst = max(worst, (one - want).abs().max().item())
for n in (1, 2, 4):
    parts = [ref.decode_attention_ref(q, k[:, i::n], v[:, i::n], pos[:, i::n], cur, window=50,
                                      return_stats=True) for i in range(n)]
    m_g = torch.stack([m for _, m, _ in parts]).amax(0)
    acc = sum(a * torch.exp(m - m_g)[..., None] for a, m, _ in parts)
    l = sum(l_ * torch.exp(m - m_g) for _, m, l_ in parts)
    out = (acc / l.clamp(min=1e-30)[..., None]).reshape(B, Hq, D)
    worst = max(worst, (out - want).abs().max().item())
destroy_mesh()
print("ERR", worst)
"""


def test_a_mesh_of_one_device_combines_as_one_call():
    proc = subprocess.run([sys.executable, "-c", _SHARD_COMBINE], capture_output=True,
                          text=True, env=ENV, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert float(proc.stdout.split("ERR")[1].split()[0]) <= 1e-5


@pytest.mark.parametrize("window,softcap", [(None, None), (24, None), (None, 30.0)])
def test_plain_stats_equal_the_jax_stats(window, softcap):
    rng = np.random.default_rng(7)
    B, S, Hq, Hkv, D = 2, 48, 6, 2, 16
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, 30:] = -1
    cur = np.array([47, 29], dtype=np.int32)
    want = jax_ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(pos), jnp.asarray(cur), window=window,
                                        softcap=softcap, return_stats=True)
    got = ref.decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, pos, cur)),
                                   window=window, softcap=softcap, return_stats=True)
    for w, g_ in zip(want, got):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_k2_wrapper_returns_the_plain_stats_on_the_cpu():
    from repro_torch.kernels.decode_attention import decode_attention

    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 4, 16, generator=g)
    k, v = torch.randn(2, 32, 2, 16, generator=g), torch.randn(2, 32, 2, 16, generator=g)
    pos = torch.arange(32, dtype=torch.int32)[None].repeat(2, 1)
    cur = torch.tensor([31, 10], dtype=torch.int32)
    got = decode_attention(q, k, v, pos, cur, return_stats=True)
    want = ref.decode_attention_ref(q, k, v, pos, cur, return_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tuple(got[0].shape) == (2, 2, 2, 16) and tuple(got[1].shape) == (2, 2, 2)


def _train(*extra: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m", "--reduced",
         "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32", "--ckpt-every", "0",
         *extra], capture_output=True, text=True, env=ENV, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])


def test_train_on_a_one_by_two_gloo_mesh_equals_the_run_without_a_mesh():
    plain, one, two = _train(), _train("--mesh", "1x1"), _train("--mesh", "1x2")
    assert plain["mesh"] is None and one["mesh"] == "1x1" and two["mesh"] == "1x2"
    assert one["losses"] == plain["losses"]  # bit for bit
    np.testing.assert_allclose(two["losses"], plain["losses"], rtol=0, atol=1e-5)
    assert two["steps"] == 3 and two["compiled"]["calls"] == 3


def test_a_mesh_the_machine_cannot_hold_is_refused():
    """As the JAX driver refuses a mesh larger than its devices: no card
    here, so even 1 x 1 on cuda; and a malformed spec before anything runs."""
    from repro_torch.launch import mesh

    with pytest.raises(RuntimeError, match="needs 2 devices"):
        mesh.build_mesh("1x2", "cuda")
    with pytest.raises(ValueError, match="DxM"):
        mesh.parse_mesh("2by2")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m", "--reduced",
         "--device", "cpu", "--steps", "1", "--mesh", "1x0"], capture_output=True, text=True,
        env=ENV, cwd=REPO, timeout=300)
    assert proc.returncode != 0 and "--mesh" in proc.stderr
