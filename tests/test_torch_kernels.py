"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel with ``interpret=True``, as tests/test_kernels.py
does.  The same inputs, drawn with numpy from a seed, feed both.  The CUDA
and Triton kernels themselves are held against the same plain versions on
the card by chip_smoke.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.moe_gmm import gmm as jax_gmm  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import _build, launch_counts, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.moe_gmm import gmm  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tols(dtype):
    """tests/test_kernels.py's tolerances."""
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=3e-5, rtol=3e-5)


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(jax_out, torch_out, **tol):
    np.testing.assert_allclose(torch_out.float().numpy(), np.asarray(jax_out, np.float32), **tol)


# ---------------------------------------------------------------------------
# K1 flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Sq,Sk,Hq,Hkv,D,window,softcap",
    [
        (2, 64, 64, 4, 4, 16, None, None),      # MHA
        (2, 64, 64, 4, 2, 16, None, None),      # GQA
        (1, 96, 96, 4, 1, 32, None, None),      # MQA, non-pow2 seq
        (2, 64, 64, 4, 2, 16, 16, None),        # sliding window
        (2, 64, 64, 4, 2, 16, None, 30.0),      # softcap (gemma2)
        (2, 64, 64, 4, 2, 16, 16, 50.0),        # both
        (1, 40, 40, 2, 2, 8, None, None),       # ragged
    ],
)
def test_flash_attention_vs_pallas(B, Sq, Sk, Hq, Hkv, D, window, softcap, dtype):
    rng = np.random.default_rng(42)
    jq, tq = _pair(rng.standard_normal((B, Sq, Hq, D), np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((B, Sk, Hkv, D), np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((B, Sk, Hkv, D), np.float32), dtype)
    want = jax_flash(jq, jk, jv, causal=True, window=window, softcap=softcap,
                     block_q=32, block_k=32, interpret=True)
    got = flash_attention(tq, tk, tv, causal=True, window=window, softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(want, got, **tols(dtype))


def test_flash_attention_q_offset():
    rng = np.random.default_rng(43)
    jq, tq = _pair(rng.standard_normal((2, 16, 4, 16), np.float32), "float32")
    jk, tk = _pair(rng.standard_normal((2, 80, 2, 16), np.float32), "float32")
    jv, tv = _pair(rng.standard_normal((2, 80, 2, 16), np.float32), "float32")
    want = jax_flash(jq, jk, jv, causal=True, q_offset=64, block_q=16, block_k=32,
                     interpret=True)
    got = flash_attention(tq, tk, tv, causal=True, q_offset=64)
    _close(want, got, **tols("float32"))


# ---------------------------------------------------------------------------
# K2 decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(None, None), (8, None), (None, 30.0)])
def test_decode_attention_vs_pallas(window, softcap, dtype):
    B, Hq, Hkv, D, S = 2, 4, 2, 16, 40
    rng = np.random.default_rng(44)
    jq, tq = _pair(rng.standard_normal((B, Hq, D), np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((B, S, Hkv, D), np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((B, S, Hkv, D), np.float32), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    cur = np.array([S - 1, 17], np.int32)
    want = jax_decode(jq, jk, jv, jnp.asarray(pos), jnp.asarray(cur), window=window,
                      softcap=softcap, block_s=16, interpret=True)
    got = decode_attention(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(cur),
                           window=window, softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(want, got, **tols(dtype))


def test_decode_attention_ring_buffer():
    """A ring holding positions 10..17 in wrapped order, cur=17, window 6."""
    B, Hq, Hkv, D, S = 1, 2, 1, 8, 8
    rng = np.random.default_rng(45)
    jq, tq = _pair(rng.standard_normal((B, Hq, D), np.float32), "float32")
    jk, tk = _pair(rng.standard_normal((B, S, Hkv, D), np.float32), "float32")
    jv, tv = _pair(rng.standard_normal((B, S, Hkv, D), np.float32), "float32")
    pos = np.array([[16, 17, 10, 11, 12, 13, 14, 15]], np.int32)
    cur = np.array([17], np.int32)
    want = jax_decode(jq, jk, jv, jnp.asarray(pos), jnp.asarray(cur), window=6,
                      interpret=True)
    got = decode_attention(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(cur), window=6)
    _close(want, got, **tols("float32"))
    # the mask keeps exactly positions 12..17
    live = torch.from_numpy((pos[0] > 17 - 6))
    qf = tq.reshape(B, Hkv, 2, D) / np.sqrt(D)
    s = torch.einsum("bhgd,bshd->bhgs", qf, tk).masked_fill(~live, -1e30)
    manual = torch.einsum("bhgs,bshd->bhgd", s.softmax(-1), tv).reshape(B, Hq, D)
    torch.testing.assert_close(got, manual, atol=3e-5, rtol=3e-5)


def test_decode_split_kv_combine_matches_whole_cache():
    """The (acc, m, l) partials of two cache halves combine to the whole:
    the flash-decoding merge a split-KV decode kernel will use."""
    B, Hq, Hkv, D, S = 2, 6, 2, 16, 32
    rng = np.random.default_rng(46)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D), np.float32))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S).contiguous()
    cur = torch.tensor([S - 1, 20], dtype=torch.int32)
    parts = [ref.decode_attention_ref(q, k[:, sl], v[:, sl], pos[:, sl], cur, return_stats=True)
             for sl in (slice(0, S // 2), slice(S // 2, S))]
    m = torch.maximum(parts[0][1], parts[1][1])
    acc = sum(a * torch.exp(mi - m)[..., None] for a, mi, _ in parts)
    l = sum(li * torch.exp(mi - m) for _, mi, li in parts)
    got = (acc / l[..., None]).reshape(B, Hq, D)
    torch.testing.assert_close(got, ref.decode_attention_ref(q, k, v, pos, cur),
                               atol=3e-5, rtol=3e-5)


# ---------------------------------------------------------------------------
# K3 rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 896), (3, 5, 96)])
def test_rmsnorm_vs_pallas(shape, dtype):
    rng = np.random.default_rng(47)
    jx, tx = _pair(rng.standard_normal(shape, np.float32), dtype)
    scale = rng.standard_normal(shape[-1:], np.float32) * 0.1
    want = jax_rmsnorm(jx, jnp.asarray(scale), eps=1e-6, interpret=True)
    got = rmsnorm(tx, torch.from_numpy(scale), eps=1e-6)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(want, got, **tols(dtype))


# ---------------------------------------------------------------------------
# K4 grouped matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", [None, "silu", "gelu"])
@pytest.mark.parametrize("E,C,D,F", [(4, 16, 32, 24), (2, 20, 24, 12), (8, 8, 8, 8)])
def test_gmm_vs_pallas(E, C, D, F, epilogue, dtype):
    """tests/test_kernels.py's shapes (ragged against 8-wide blocks), each
    epilogue, against the Pallas kernel in interpret mode; both accumulate
    in f32 and round once, so they differ by the order of f32 sums."""
    rng = np.random.default_rng(49)
    jx, tx = _pair(rng.standard_normal((E, C, D), np.float32), dtype)
    jw, tw = _pair(rng.standard_normal((E, D, F), np.float32), dtype)
    want = jax_gmm(jx, jw, block_c=8, block_f=8, block_d=8, epilogue=epilogue, interpret=True)
    got = gmm(tx, tw, epilogue=epilogue)
    assert got.dtype == tx.dtype and tuple(got.shape) == (E, C, F)
    _close(want, got, **tols(dtype))
    torch.testing.assert_close(ops.gmm(tx, tw, epilogue=epilogue, impl="plain"), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_moe_ffn_vs_jax(jax_impl, dtype):
    """ops.moe_ffn against the JAX op on both of its routes.

    The plain route is ``moe_ffn_ref``; ``auto`` on a CPU tensor is the
    kernel route's composition of three grouped matmuls, each wrapper
    running its plain version.  In f32 every route agrees to f32 sums
    (3e-5).  In bf16 each port route matches the JAX route that rounds as
    it does (2e-2); across routes, the kernel composition multiplies two
    bf16-rounded products (silu fused into the first) where the plain route
    multiplies in f32, so h differs by a bf16 rounding (~4e-3 relative)
    before the w2 product: held to 5e-2."""
    E, C, D, F = 4, 12, 32, 24
    rng = np.random.default_rng(50)
    jx, tx = _pair(rng.standard_normal((E, C, D), np.float32), dtype)
    ws = [_pair(rng.standard_normal(shape, np.float32) * 0.2, dtype)
          for shape in ((E, D, F), (E, D, F), (E, F, D))]
    want = jax_ops.moe_ffn(jx, *(j for j, _ in ws), act="silu", impl=jax_impl)
    for impl, same_rounding in (("plain", "xla"), ("auto", "pallas")):
        got = ops.moe_ffn(tx, *(t for _, t in ws), act="silu", impl=impl)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        cross = dtype == "bfloat16" and jax_impl != same_rounding
        _close(want, got, **(dict(atol=5e-2, rtol=5e-2) if cross else tols(dtype)))


def test_gmm_rejects_unknown_epilogue():
    x = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError, match="epilogue"):
        gmm(x, torch.zeros(1, 3, 4), epilogue="relu")


# ---------------------------------------------------------------------------
# ops dispatch and the build helper
# ---------------------------------------------------------------------------


def test_ops_impls_on_cpu():
    """auto and plain agree on a CPU tensor and launch nothing; kernel raises."""
    rng = np.random.default_rng(48)
    x = torch.from_numpy(rng.standard_normal((4, 32), np.float32))
    s = torch.zeros(32)
    before = launch_counts()
    torch.testing.assert_close(ops.rmsnorm(x, s), ops.rmsnorm(x, s, impl="plain"))
    with ops.impl_scope("plain"):
        torch.testing.assert_close(ops.rmsnorm(x, s), ref.rmsnorm_ref(x, s))
    assert launch_counts() == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rmsnorm(x, s, impl="kernel")
    with pytest.raises(ValueError, match="not in"):
        ops.rmsnorm(x, s, impl="pallas")


def test_tuned_table_keeps_jax_op_names():
    with ops.tuned_scope({"flash_attention": {"kernel": {"block_k": 64, "block_q": 32}}}):
        assert ops.active_config("flash_attention", "kernel") == "block_k=64,block_q=32"
        assert ops.config_tag("kernel") == "flash_attention:block_k=64,block_q=32"
    assert ops.tuned_overrides("flash_attention", "kernel") == {}


def test_build_paths_are_keyed_by_source():
    for name in _build.SOURCES:
        path = _build.lib_path(name)
        assert (_build.CSRC / f"{name}.cu").exists()
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"{name}-")
        assert path == _build.lib_path(name)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
