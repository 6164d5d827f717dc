"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel with ``interpret=True``, as tests/test_kernels.py
does.  The same inputs, drawn with numpy from a seed, feed both.  The CUDA
kernels themselves are held against the same plain versions on the card
by chip_smoke.py.
"""
import contextlib
import functools
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_vjp import _fwd_impl as jax_flash_fwd_lse  # noqa: E402
from repro.kernels.flash_vjp import flash_attention_fused as jax_flash_vjp  # noqa: E402
from repro.kernels.moe_gmm import gmm as jax_gmm  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6  # noqa: E402
from repro.nn.core import rmsnorm as jax_nn_rmsnorm  # noqa: E402
from repro_torch.kernels import _build, launch_counts, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import TILE as SPLIT_TILE  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention, split_plan  # noqa: E402
from repro_torch.kernels.decode_attention import instances as decode_instances  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attention import instance as flash_instance  # noqa: E402
from repro_torch.kernels import flash_attention as k1  # noqa: E402
from repro_torch.kernels import mamba_scan as k5  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro_torch.kernels import moe_gmm as k4  # noqa: E402
from repro_torch.kernels.moe_gmm import gmm  # noqa: E402
from repro_torch.kernels import rmsnorm as k3  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd  # noqa: E402
from repro_torch.kernels import rwkv6_scan as k6  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402

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
        # the shapes of the tensor-core instance (bf16, D 16..128): G = 8,
        # ragged Sq = Sk = 200, the queries as the last 72 of 200 keys
        # (q_offset 128), and a window starting inside a tile with a softcap
        (1, 200, 200, 8, 1, 64, None, None),
        (1, 200, 200, 8, 1, 128, None, None),
        (1, 72, 200, 8, 1, 128, None, None),
        (1, 96, 96, 8, 1, 128, 40, 30.0),
        # head dim 256 (gemma3-4b): GQA 2, a window that starts inside a
        # tile, a softcap, and the queries as the last 40 of 100 keys with a
        # window and a softcap
        (1, 64, 64, 4, 2, 256, None, None),
        (1, 64, 64, 4, 2, 256, 24, None),
        (1, 64, 64, 4, 2, 256, None, 50.0),
        (1, 40, 100, 4, 2, 256, 37, 30.0),
    ],
)
def test_flash_attention_vs_pallas(B, Sq, Sk, Hq, Hkv, D, window, softcap, dtype):
    """With Sk > Sq the queries are the last Sq positions (q_offset = Sk - Sq)."""
    rng = np.random.default_rng(42)
    jq, tq = _pair(rng.standard_normal((B, Sq, Hq, D), np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((B, Sk, Hkv, D), np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((B, Sk, Hkv, D), np.float32), dtype)
    q_offset = Sk - Sq
    want = jax_flash(jq, jk, jv, causal=True, window=window, softcap=softcap, q_offset=q_offset,
                     block_q=32, block_k=32, interpret=True)
    got = flash_attention(tq, tk, tv, causal=True, window=window, softcap=softcap,
                          q_offset=q_offset)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["full", "ring window", "softcap"])
def test_decode_attention_d256_vs_pallas(case, dtype):
    """Head dim 256 (gemma3-4b) against the Pallas kernel: a full cache at
    two fill levels, a 24-slot ring that has wrapped (cur 30 and 57) with a
    window of 16, and gemma2's softcap of 50; tests/test_kernels.py's
    tolerances."""
    B, Hq, Hkv, D, S = 2, 4, 2, 256, 24
    rng = np.random.default_rng(50)
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(rng, B, Hq, Hkv, D, S, dtype)
    window, softcap = {"full": (None, None), "ring window": (16, None),
                       "softcap": (None, 50.0)}[case]
    if case == "ring window":
        cur = np.array([30, 57], np.int32)
        base = cur[:, None] - S + 1  # slot s holds the position p = s (mod S) in (cur - S, cur]
        pos = (base + (np.arange(S)[None] - base) % S).astype(np.int32)
    else:
        cur = np.array([S - 1, 9], np.int32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    want = jax_decode(jq, jk, jv, jnp.asarray(pos), jnp.asarray(cur), window=window,
                      softcap=softcap, block_s=8, interpret=True)
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


def _decode_inputs(rng, B, Hq, Hkv, D, S, dtype):
    return (_pair(rng.standard_normal((B, Hq, D), np.float32), dtype),
            _pair(rng.standard_normal((B, S, Hkv, D), np.float32), dtype),
            _pair(rng.standard_normal((B, S, Hkv, D), np.float32), dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_split", [1, 2, 3, 5])
def test_decode_split_ref_vs_pallas(n_split, dtype):
    """The split-KV arithmetic of the K2 kernel (partials per slot range,
    then the fixed-order combine) against the Pallas kernel, with ranges
    of ceil(43 / n_split) slots that do not divide S = 43."""
    B, Hq, Hkv, D, S = 2, 6, 2, 16, 43
    rng = np.random.default_rng(47)
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(rng, B, Hq, Hkv, D, S, dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    cur = np.array([S - 1, 20], np.int32)
    want = jax_decode(jq, jk, jv, jnp.asarray(pos), jnp.asarray(cur), block_s=16,
                      interpret=True)
    got = ref.decode_attention_split_ref(tq, tk, tv, torch.from_numpy(pos),
                                         torch.from_numpy(cur), n_split=n_split)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(want, got, **tols(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_ref_dead_range(dtype):
    """A ring buffer whose window leaves the first of three ranges without a
    live slot: that range contributes (0, -1e30, 0) and the result is the
    whole cache's."""
    B, Hq, Hkv, D, S = 2, 4, 1, 16, 48
    rng = np.random.default_rng(48)
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(rng, B, Hq, Hkv, D, S, dtype)
    cur = np.array([100, 95], np.int32)
    base = cur[:, None] - S + 1  # slot s holds the position p = s (mod S) in (cur - S, cur]
    pos = (base + (np.arange(S)[None] - base) % S).astype(np.int32)
    window = 10  # live: p > cur - 10, slots 0..4 and 43..47 / slots 38..47
    live = pos > cur[:, None] - window
    assert not live[:, 16:32].any() and live[:, 32:].any(axis=1).all()
    args = (torch.from_numpy(pos), torch.from_numpy(cur))
    got = ref.decode_attention_split_ref(tq, tk, tv, *args, n_split=3, window=window)
    torch.testing.assert_close(got.float(), ref.decode_attention_ref(tq, tk, tv, *args,
                                                                     window=window).float(),
                               **tols(dtype))
    want = jax_decode(jq, jk, jv, jnp.asarray(pos), jnp.asarray(cur), window=window,
                      block_s=16, interpret=True)
    _close(want, got, **tols(dtype))


def test_decode_row_without_live_slot_is_zero():
    """Row 0 has no live slot: the Pallas kernel (interpret mode) and the
    split-KV version give zeros, the whole-cache plain version the mean of
    V; row 1 agrees everywhere."""
    B, Hq, Hkv, D, S = 2, 4, 2, 16, 40
    rng = np.random.default_rng(49)
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(rng, B, Hq, Hkv, D, S, "float32")
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    pos[0] = -1
    cur = np.array([30, 30], np.int32)
    want = np.asarray(jax_decode(jq, jk, jv, jnp.asarray(pos), jnp.asarray(cur), block_s=16,
                                 interpret=True))
    args = (torch.from_numpy(pos), torch.from_numpy(cur))
    split = ref.decode_attention_split_ref(tq, tk, tv, *args, n_split=2)
    whole = ref.decode_attention_ref(tq, tk, tv, *args)
    assert (want[0] == 0).all() and (split[0] == 0).all()
    mean_v = tv[0].mean(dim=0).repeat_interleave(Hq // Hkv, dim=0)
    torch.testing.assert_close(whole[0], mean_v, atol=3e-5, rtol=3e-5)
    _close(want[1:], split[1:], **tols("float32"))
    _close(want[1:], whole[1:], **tols("float32"))


@pytest.mark.parametrize("S", [1, 40, 1000, 1024, 4096])
@pytest.mark.parametrize("B,Hkv,n_sm", [(8, 2, 132), (8, 16, 132), (8, 8, 132), (1, 1, 132),
                                        (64, 16, 132), (2, 4, 8)])
def test_split_plan_covers_the_cache_once(B, Hkv, S, n_sm):
    n_split, chunk = split_plan(B, Hkv, S, n_sm)
    assert chunk % SPLIT_TILE == 0 and n_split >= 1
    ranges = [range(i * chunk, min(S, (i + 1) * chunk)) for i in range(n_split)]
    assert all(len(r) > 0 for r in ranges)
    assert [s for r in ranges for s in r] == list(range(S))
    # the kernel's own contract (decode_attention_fwd refuses anything else)
    assert (n_split - 1) * chunk < S <= n_split * chunk


@pytest.mark.parametrize("B,Hkv", [(8, 2), (8, 16), (8, 8)])  # qwen2, deepseek, jamba decode
def test_split_plan_fills_the_card_at_the_served_shapes(B, Hkv):
    n_split, chunk = split_plan(B, Hkv, 1024, 132)
    assert B * Hkv * n_split >= 2 * 132


# the gemmas' served decode: gemma3-4b's global layers (2048 slots) and its
# local layers' 1024-slot rings, 4 KV heads of 256; gemma2-27b's 1024-slot
# caches, 16 KV heads of 128
@pytest.mark.parametrize("B,Hkv,S,want", [(8, 4, 2048, (10, 224)), (8, 4, 1024, (11, 96)),
                                          (8, 16, 1024, (4, 320))])
def test_split_plan_at_the_gemma_shapes(B, Hkv, S, want):
    """A valid n_split / chunk (the kernel's contract) with two waves of
    blocks on 132 SMs."""
    n_split, chunk = split_plan(B, Hkv, S, 132)
    assert (n_split, chunk) == want
    assert chunk % SPLIT_TILE == 0 and (n_split - 1) * chunk < S <= n_split * chunk
    assert B * Hkv * n_split >= 2 * 132


def test_attention_instances_depend_on_dtype_and_head_dim_only():
    for D in (16, 32, 64, 128, 256):
        assert flash_instance(torch.bfloat16, D) == "flash_fwd_mma"
        assert decode_instances(torch.bfloat16, D) == ("decode_split_mma",
                                                       "decode_combine_kernel")
    for dt, D in ((torch.bfloat16, 8), (torch.float32, 8), (torch.float32, 64),
                  (torch.float32, 128), (torch.float32, 256)):
        assert flash_instance(dt, D) == "flash_fwd_simt"
        assert decode_instances(dt, D)[0] == "decode_split_kernel"


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, ("flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")),
    (torch.bfloat16, 16, ("flash_bwd_dq_mma", "flash_bwd_dkdv_mma")),
    (torch.bfloat16, 32, ("flash_bwd_dq_mma", "flash_bwd_dkdv_mma")),
    (torch.bfloat16, 8, ("flash_bwd_dq", "flash_bwd_dkdv")),
    (torch.bfloat16, 128, ("flash_bwd_dq_sm90", "flash_bwd_dkdv_sm90")),
    (torch.float32, 64, ("flash_bwd_dq", "flash_bwd_dkdv")),
    (torch.float32, 16, ("flash_bwd_dq", "flash_bwd_dkdv")),
    (torch.bfloat16, 256, ("flash_bwd_dq_sm90", "flash_bwd_dkdv_sm90")),
    (torch.float32, 256, ("flash_bwd_dq", "flash_bwd_dkdv")),
    (torch.float32, 128, ("flash_bwd_dq", "flash_bwd_dkdv")),
])
def test_bwd_instances_depend_on_dtype_and_head_dim_only(dtype, D, want):
    """K1b: bf16 D 64 (the training path) runs the wgmma pair, bf16 D 128 /
    256 the wgmma pair whose warpgroups split D (the previous wide mma.sync
    pair is no instance: only previous_wide_bwd reaches it), bf16 D 16 / 32
    the mma.sync pair, f32 and bf16 D 8 the CUDA-core pair."""
    assert k1.bwd_instances(dtype, D) == want
    names = {n for d in k1.BWD_HEAD_DIMS for dt in (torch.float32, torch.bfloat16)
             for n in k1.bwd_instances(dt, d)}
    assert not names & set(k1.PREVIOUS_WIDE_INSTANCES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_refuses_head_dim_256_before_any_launch(dtype, monkeypatch):
    """Off the CPU a head dim without a K1b instance (96, 512) raises before
    the wrapper loads a library or launches; D 256 and 128 now pass that
    check and stop at the device check (meta tensors stand in for the
    card; a library load fails the test).  On the CPU D 256 runs the plain
    version.  (The name dates from when D 256 had no backward instance.)"""
    def no_launch():
        raise AssertionError("a K1b library was loaded")

    monkeypatch.setattr(k1, "_bwd_entry", no_launch)
    monkeypatch.setattr(k1, "_sm90_entry", no_launch)
    before = launch_counts()

    def bwd(D, device):
        q, k, v = (torch.zeros((1, 8, h, D), dtype=dtype, device=device) for h in (4, 2, 2))
        lse = torch.zeros((1, 4, 8), dtype=torch.float32, device=device)
        return flash_attention_bwd(q, k, v, torch.zeros_like(q), lse, torch.zeros_like(q))

    with pytest.raises(NotImplementedError, match="no backward kernel at head dim 96"):
        bwd(96, "meta")
    with pytest.raises(NotImplementedError, match="head dim 512"):
        k1.bwd_instances(dtype, 512)
    for D in (256, 128):
        with pytest.raises(ValueError, match="no kernel for device"):
            bwd(D, "meta")
    dq, dk, dv = bwd(256, "cpu")
    assert dq.shape == (1, 8, 4, 256) and dk.shape == dv.shape == (1, 8, 2, 256)
    assert launch_counts() == before


# (B, Sq, Sk, Hq, Hkv, causal, window, q_offset): causal and not, a window,
# q_offset with Sq < Sk, ragged S against the 64-tiles, the training shape
PLAN_CASES = [
    (2, 256, 256, 15, 5, True, None, 0), (1, 200, 200, 8, 1, False, None, 0),
    (2, 136, 264, 15, 5, True, 48, 128), (1, 100, 300, 16, 2, True, 37, 200),
    (1, 8, 4, 2, 2, False, 2, 3), (3, 333, 333, 4, 4, True, None, 0),
    (4, 2048, 2048, 15, 5, True, None, 0),
]


def _live_tiles(pass_, tile, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, wg):
    """The 64-tiles of the other side (keys for "dq", rows for "dkdv") that
    hold a live pair with item ``tile``'s own rows (or keys), by brute force."""
    rows, keys = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    live = np.ones((Sq, Sk), bool)
    if causal:
        live &= keys <= q_offset + rows
    if window is not None:
        live &= keys > q_offset + rows - window
    own = slice(tile * wg * 64, (tile + 1) * wg * 64)
    seen = live[own].any(0) if pass_ == "dq" else live[:, own].any(1)
    return {int(i) // 64 for i in np.flatnonzero(seen)}


@pytest.mark.parametrize("case", PLAN_CASES[:-1])
@pytest.mark.parametrize("wg", [1, 2])
@pytest.mark.parametrize("pass_", ["dq", "dkdv"])
def test_bwd_walk_covers_every_live_pair(pass_, wg, case):
    """The tiles a wgmma K1b item walks (``bwd_walk``, the kernels'
    ``dq_keys`` / ``dkdv_rows`` as (start, n)) start at a multiple of 64
    and are exactly the tiles with a live pair of its rows (or keys): the
    live keys of a run of rows (the rows of a run of keys) are an
    interval, so the walk wastes no tile and misses none."""
    B, Sq, Sk, Hq, Hkv, causal, window, q_offset = case
    own_s = Sq if pass_ == "dq" else Sk
    for tile in range(-(-own_s // (wg * 64))):
        start, n = k1.bwd_walk(pass_, tile, Sq=Sq, Sk=Sk, wg=wg, causal=causal,
                               window=window, q_offset=q_offset)
        need = _live_tiles(pass_, tile, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, wg)
        assert start % 64 == 0, (tile, start)
        walked = set(range(start // 64, start // 64 + n))
        assert walked == need, (tile, start, n, sorted(need))


@pytest.mark.parametrize("case", PLAN_CASES)
@pytest.mark.parametrize("wg,slots", [(1, 264), (2, 132), (2, 8)])
@pytest.mark.parametrize("pass_", ["dq", "dkdv"])
def test_bwd_plan_covers_every_item_once_and_balances(pass_, wg, slots, case):
    """Every (tile, head, batch) item of a pass lies in exactly one block's
    list; the persistent plan has min(items, slots) blocks, none of whose
    loads exceeds the mean by more than the largest item (the bound of
    placing items longest first onto the least loaded block); one block
    per item otherwise."""
    B, Sq, Sk, Hq, Hkv, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    cost = k1.bwd_costs(pass_, B, Sq, Sk, Hq, Hkv, wg=wg, **kw)
    H, S = (Hq, Sq) if pass_ == "dq" else (Hkv, Sk)
    assert len(cost) == B * H * -(-S // (wg * 64))
    for persistent in (True, False):
        offsets, items = k1.bwd_plan(pass_, B, Sq, Sk, Hq, Hkv, wg=wg, slots=slots,
                                     persistent=persistent, **kw)
        assert offsets.dtype == items.dtype == np.int32
        assert sorted(items.tolist()) == list(range(len(cost)))
        assert offsets[0] == 0 and offsets[-1] == len(items) and (np.diff(offsets) > 0).all()
        loads = np.array([cost[items[a:b]].sum() for a, b in zip(offsets[:-1], offsets[1:])])
        if persistent:
            assert len(loads) == min(len(cost), slots)
            assert loads.max() <= loads.mean() + cost.max()
        else:
            assert len(loads) == len(cost) and (np.diff(loads) <= 0).all()  # longest first


@pytest.mark.parametrize("pass_,wg,margin", [("dq", 2, 0.02), ("dkdv", 2, 0.08),
                                             ("dq", 1, 0.02), ("dkdv", 1, 0.12)])
def test_bwd_plan_balances_the_training_shape(pass_, wg, margin):
    """At smollm-360m's (4, 2048, 15/5) causal on 132 SMs (one block of 2
    warpgroups, or two of 1, an SM), where the causal items' costs differ
    more than 10-fold, the fullest block carries at most ``margin`` over the
    mean."""
    cost = k1.bwd_costs(pass_, 4, 2048, 2048, 15, 5, wg=wg)
    offsets, items = k1.bwd_plan(pass_, 4, 2048, 2048, 15, 5, wg=wg, slots=132 * (3 - wg))
    loads = np.array([cost[items[a:b]].sum() for a, b in zip(offsets[:-1], offsets[1:])])
    assert cost.max() > 10 * cost.min()
    assert loads.max() <= (1 + margin) * loads.mean()


def _k1b_variants():
    """``tools/k1b_variants.py`` as a module (it imports torch only in main)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "k1b_variants.py"
    spec = importlib.util.spec_from_file_location("k1b_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", PLAN_CASES)
@pytest.mark.parametrize("order", ["by_head", "head_major"])
@pytest.mark.parametrize("pass_", ["dq", "dkdv"])
def test_bwd_plan_orders_by_kv_head(pass_, order, case):
    """The plans by KV head that ``tools/k1b_variants.py`` times beside
    ``bwd_plan``: every item in one block's list once, no block over the
    mean load by more than the largest item (any list schedule's bound);
    "by_head" holds the longest-first plan's lists, each run by (batch, KV
    head) and longest first within one; "head_major" places the items in
    that order."""
    plan_by_kv_head = _k1b_variants().plan_by_kv_head
    B, Sq, Sk, Hq, Hkv, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset, wg=1, slots=132)
    cost = k1.bwd_costs(pass_, B, Sq, Sk, Hq, Hkv, wg=1, causal=causal, window=window,
                        q_offset=q_offset)
    group = np.arange(len(cost)) // (len(cost) // (B * Hkv))  # (batch, KV head) of an item
    offsets, items = plan_by_kv_head(order, pass_, B, Sq, Sk, Hq, Hkv, **kw)
    assert offsets.dtype == items.dtype == np.int32
    assert sorted(items.tolist()) == list(range(len(cost)))
    lists = [items[a:b] for a, b in zip(offsets[:-1], offsets[1:])]
    loads = np.array([cost[lst].sum() for lst in lists])
    assert loads.max() <= loads.mean() + cost.max()
    if order == "by_head":
        base_off, base = k1.bwd_plan(pass_, B, Sq, Sk, Hq, Hkv, **kw)
        assert (base_off == offsets).all()
        for lst, a, b in zip(lists, base_off[:-1], base_off[1:]):
            assert sorted(lst.tolist()) == sorted(base[a:b].tolist())
            keys = [(group[x], -cost[x]) for x in lst]
            assert keys == sorted(keys)
    else:
        firsts = [group[lst[0]] for lst in lists]
        assert firsts == sorted(firsts)  # the first KV head's items open the blocks
    with pytest.raises(ValueError, match="order"):
        plan_by_kv_head("random", pass_, B, Sq, Sk, Hq, Hkv, **kw)


# the wgmma K1b's training shapes at D 128 / 256 (B, S, Hq, Hkv, window):
# gemma3-4b's global and local layers, chameleon-34b's (G 8)
WIDE_TRAIN_SHAPES = {"gemma3-4b global": (4, 2048, 8, 4, None),
                     "gemma3-4b local": (4, 2048, 8, 4, 1024),
                     "chameleon-34b": (4, 2048, 64, 8, None)}


@pytest.mark.parametrize("shape", list(WIDE_TRAIN_SHAPES))
@pytest.mark.parametrize("pass_", ["dq", "dkdv"])
def test_bwd_plan_balances_the_wide_training_shapes(pass_, shape):
    """At D 128 / 256 an item is one 64-row (or 64-key) tile and a block of
    two consumer warpgroups fills an SM: on 132 SMs every item of the pass
    lies in one block's list once, and the fullest block carries at most
    2 % over the mean, where the items' costs differ more than 8-fold (an
    item's own tiles cost BWD_ITEM_COST walk tiles at every head dim: both
    scale with D)."""
    B, S, Hq, Hkv, window = WIDE_TRAIN_SHAPES[shape]
    cost = k1.bwd_costs(pass_, B, S, S, Hq, Hkv, wg=1, window=window)
    offsets, items = k1.bwd_plan(pass_, B, S, S, Hq, Hkv, wg=1, slots=132, window=window)
    assert sorted(items.tolist()) == list(range(len(cost))) and len(offsets) == 133
    loads = np.array([cost[items[a:b]].sum() for a, b in zip(offsets[:-1], offsets[1:])])
    assert cost.max() > 8 * cost.min()
    assert loads.max() <= 1.02 * loads.mean()


class _StubSm90Library:
    """flash_attention_bwd_sm90_config of a build whose ptxas gave
    ``regs`` registers a thread to every wgmma K1b kernel at each head dim
    (the entry count setmaxnreg assumes is 168)."""

    def __init__(self, regs: int):
        self.regs = regs
        self.queries: list[int] = []
        self.flash_attention_bwd_sm90_config = self._config

    def _config(self, head_dim, out):
        self.queries.append(head_dim)
        wide = head_dim != 64
        vals = dict(wg_dq=2, wg_dkdv=2, stages=2 if head_dim == 256 else 4, blocks_per_sm_dq=1,
                    blocks_per_sm_dkdv=1, smem_dq=215088, smem_dkdv=231472, entry_regs_dq=168,
                    entry_regs_dkdv=168, regs_dq=self.regs, regs_dkdv=self.regs,
                    regs_dq_cap=self.regs, regs_dkdv_cap=self.regs, head_dim=head_dim,
                    item_tiles_dq=1 if wide else 2, item_tiles_dkdv=1 if wide else 2,
                    stages_dkdv=2, item_bufs_dq=1, item_bufs_dkdv=1, ahead=0)
        for i, key in enumerate(k1.SM90_CONFIG_KEYS):
            out[i] = vals[key]
        return 0


@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_sm90_config_refuses_a_build_off_its_entry_register_count(head_dim, monkeypatch):
    """The host side refuses a wgmma K1b build whose kernels ptxas gave
    another register count than the entry count setmaxnreg's exchange
    assumes (its consumers would wait forever), at each head dim of the
    source, before any launch; a build at the entry count is queried once
    per (library, device, head dim).  A stub stands in for the library and
    the card."""
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(k1, "_SM90_CONFIGS", {})
    bad = _StubSm90Library(regs=160)
    with pytest.raises(RuntimeError, match=f"at D {head_dim} .* setmaxnreg"):
        k1.sm90_config(bad, 0, head_dim)
    good = _StubSm90Library(regs=168)
    cfg = k1.sm90_config(good, 0, head_dim)
    assert cfg["head_dim"] == head_dim and cfg["regs_dkdv_cap"] == cfg["entry_regs_dkdv"] == 168
    assert cfg["item_tiles_dq"] == (2 if head_dim == 64 else 1)
    assert k1.sm90_config(good, 0, head_dim) is cfg and good.queries == [head_dim]


# ---------------------------------------------------------------------------
# K3 rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 896), (3, 5, 96), (2, 16), (4, 512), (2, 100)])
def test_rmsnorm_vs_pallas(shape, dtype):
    rng = np.random.default_rng(47)
    jx, tx = _pair(rng.standard_normal(shape, np.float32), dtype)
    scale = rng.standard_normal(shape[-1:], np.float32) * 0.1
    want = jax_rmsnorm(jx, jnp.asarray(scale), eps=1e-6, interpret=True)
    got = rmsnorm(tx, torch.from_numpy(scale), eps=1e-6)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(want, got, **tols(dtype))


# the served (rows, D) of K3: 8 decode rows and 512 prefill rows of qwen2's,
# deepseek's, rwkv6-7b's and jamba's d_model and jamba's Mamba norms (dt_rank
# 512, d_state 16), and a D off 16 bytes
NORM_SHAPES = [(r, d) for d in (896, 2048, 4096, 8192, 512, 16) for r in (8, 512)] + [(4, 100)]
# the gemmas' row widths: gemma3-4b's d 2560 (8 decode rows, 1536 prefill
# rows) and gemma2-27b's d 4608 (8 and 512)
NORM_SHAPES += [(8, 2560), (1536, 2560), (8, 4608), (512, 4608)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows,D", NORM_SHAPES)
def test_norm_plan_covers_each_element_once(rows, D, itemsize):
    """Over the plan's grid and threads, the lanes hold each (row, element)
    exactly once; a row's lanes are consecutive lanes of one warp or whole
    warps of one block, and a block is whole warps."""
    p = k3.norm_plan(rows, D, itemsize, n_sm=132)
    assert p.lanes & (p.lanes - 1) == 0 and p.threads % 32 == 0 and p.threads <= 1024
    assert p.chunks in (1, 2, 4, 8)
    assert (p.threads % p.lanes == 0) if p.lanes <= 32 else (p.threads == p.lanes)
    counts = np.zeros((rows, D), np.int64)
    for blk in range(p.grid):
        for t in range(p.threads):
            row, cols = p.elements(blk, t)
            if row is not None:
                counts[row, cols] += 1
    assert (counts == 1).all()


@pytest.mark.parametrize("rows,D,lanes,chunks", [
    (8, 16, 2, 1), (512, 16, 2, 1), (8, 512, 32, 2), (512, 512, 32, 2), (8, 896, 64, 2),
    (512, 896, 32, 4), (8, 2048, 128, 2), (512, 2048, 64, 4), (8, 4096, 256, 2),
    (512, 4096, 128, 4), (8, 8192, 256, 4), (512, 8192, 256, 4),
    (8, 2560, 256, 2), (1536, 2560, 128, 4), (8, 4608, 256, 4), (512, 4608, 256, 4)])
def test_norm_plan_lanes_at_the_served_widths(rows, D, lanes, chunks):
    """In bf16, D 16 packs 16 rows a warp (2 lanes of 16 bytes a row); a
    prefill row of up to 128 chunks takes one warp (shuffles only), a wider
    one 4 chunks a lane over whole warps of one block; decode rows (8, fewer
    warps than SMs) spread to 2 chunks a lane, up to 256 lanes."""
    p = k3.norm_plan(rows, D, 2, n_sm=132)
    assert (p.lanes, p.chunks) == (lanes, chunks)
    assert p.rows_per_block * p.lanes == p.threads if lanes <= 32 else p.rows_per_block == 1
    if D == 16:
        assert 32 // p.lanes == 16


# ---------------------------------------------------------------------------
# K4 grouped matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", [None, "silu", "gelu"])
@pytest.mark.parametrize("E,C,D,F", [(4, 16, 32, 24), (2, 20, 24, 12), (8, 8, 8, 8),
                                     (2, 8, 72, 40), (2, 17, 72, 40), (2, 80, 72, 40),
                                     (2, 129, 72, 40)])
def test_gmm_vs_pallas(E, C, D, F, epilogue, dtype):
    """tests/test_kernels.py's shapes (ragged against 8-wide blocks), and
    the capacities gmm_mma's plan covers with one row tile (8), a ragged
    one (17), one block (80) and two row blocks (129), at a D and F ragged
    against its 64-deep stages and 256-wide F tiles; each epilogue,
    against the Pallas kernel in interpret mode.  Both accumulate in f32
    and round once, so they differ by the order of f32 sums."""
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


# the served K4 shapes (E, C, D, F): jamba-1.5-large's and
# deepseek-moe-16b's w1 / w3 products at the prefill and decode capacities,
# and their w2 products at the prefill capacity
SERVED_GMM = [(16, 80, 8192, 24576), (16, 8, 8192, 24576), (64, 64, 2048, 1408),
              (64, 8, 2048, 1408), (16, 80, 24576, 8192), (64, 64, 1408, 2048)]


@pytest.mark.parametrize("E,C,D,F", SERVED_GMM)
def test_gmm_tile_plan_at_the_served_shapes(E, C, D, F):
    """One block holds every C row, so each weight element is read once;
    the ring fits a block's shared memory, at least 3 deep, with >= 32 KB
    of weights in flight ahead of the tile being multiplied; the grid fills
    the card's 132 SMs."""
    p = k4.tile_plan(E, C, F)
    assert p.row_blocks == 1 and p.rows(C) == [range(C)]
    assert p.row_tiles == -(-C // k4.ROW_TILE)
    assert p.smem_bytes == p.stages * k4.stage_bytes(p.row_tiles) <= k4.BLOCK_SMEM
    assert p.stages >= 3 and p.bk >= 64 and (p.stages - 1) * p.bk * p.bn * 2 >= 32 << 10
    assert p.grid == (-(-F // p.bn), 1, E) and p.grid[0] * p.grid[1] * p.grid[2] >= 132
    assert k4.instance(torch.bfloat16, D, F, aligned=True) == "gmm_mma"


@pytest.mark.parametrize("C", [1, 8, 16, 17, 80, 128, 129, 300])
def test_gmm_tile_plan_rows_cover_c_once(C):
    p = k4.tile_plan(4, C, 40)
    ranges = p.rows(C)
    assert len(ranges) == p.row_blocks == p.grid[1] and all(len(r) > 0 for r in ranges)
    assert [c for r in ranges for c in r] == list(range(C))
    assert 1 <= p.row_tiles <= k4.MAX_ROW_TILES and p.smem_bytes <= k4.BLOCK_SMEM
    # csrc/moe_gmm.cu's own contract (moe_gmm_mma_fwd refuses anything else)
    rows = k4.ROW_TILE * p.row_tiles
    assert (p.row_blocks - 1) * rows < C <= p.row_blocks * rows


def test_gmm_instances_depend_on_dtype_shape_and_alignment_only():
    assert k4.instance(torch.bfloat16, 72, 40, aligned=True) == "gmm_mma"
    for D, F, aligned in ((72, 12, True), (20, 40, True), (72, 40, False)):
        assert k4.instance(torch.bfloat16, D, F, aligned) == "gmm_bf16_kernel"
    for D, F, aligned in ((72, 40, True), (72, 12, False)):
        assert k4.instance(torch.float32, D, F, aligned) == "gmm_f32_kernel"


def test_gmm_rejects_unknown_epilogue():
    x = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError, match="epilogue"):
        gmm(x, torch.zeros(1, 3, 4), epilogue="relu")


# ---------------------------------------------------------------------------
# K6 RWKV6 WKV scan
# ---------------------------------------------------------------------------


def _rwkv6_inputs(seed, B, T, H, K, decay="mixed"):
    """r, k, v, w, u, state as numpy f32.  r and k have std K**-0.5, so that
    r·k is O(1) at every head size (standard normals at K = 64 put outputs
    near 100, where the tolerance would test f32 sums, not the algorithm).
    Decays: "mixed" is tests/test_kernels.py's law exp(-exp(N(0, 0.5²)));
    "strong" puts w in [10**-37.5, 1e-30], down to the chunked form's
    1e-38 clip (the state forgets at once); "subnormal" in [1e-45, 1e-38],
    below the smallest normal f32; "weak" in [0.999, 1]."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((B, T, H, K), np.float32) * K**-0.5 for _ in range(2))
    v = rng.standard_normal((B, T, H, K), np.float32)
    if decay == "strong":
        w = 10.0 ** rng.uniform(-37.5, -30, (B, T, H, K))
    elif decay == "subnormal":
        w = 10.0 ** rng.uniform(-45, -38, (B, T, H, K))
    elif decay == "weak":
        w = 1.0 - rng.uniform(0, 1e-3, (B, T, H, K))
    else:
        w = np.exp(-np.exp(rng.standard_normal((B, T, H, K)) * 0.5))
    u = rng.standard_normal((H, K), np.float32) * 0.5
    s0 = rng.standard_normal((B, H, K, K), np.float32) * 0.1
    return r, k, v, w.astype(np.float32), u, s0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,K,chunk", [(2, 64, 3, 8, 16), (1, 32, 2, 16, 32),
                                           (2, 48, 1, 8, 16), (1, 64, 64, 64, 32)])
def test_rwkv6_scan_vs_pallas(B, T, H, K, chunk, dtype):
    """tests/test_kernels.py's shapes and the full head shape (64 heads of
    64), a non-zero state, w cast to the dtype as there: the port's op on
    the CPU (the chunked plain version) against the Pallas kernel in
    interpret mode and against the JAX serial oracle."""
    arrays = _rwkv6_inputs(51, B, T, H, K)
    pairs = [_pair(a, dtype) for a in arrays[:5]] + [_pair(arrays[5], "float32")]
    jx, tx = [j for j, _ in pairs], [t for _, t in pairs]
    want_o, want_s = jax_ref.rwkv6_scan_ref(*jx)
    pal_o, pal_s = jax_rwkv6(*jx, chunk=chunk, interpret=True)
    got_o, got_s = ops.rwkv6_scan(*tx, chunk=chunk)
    assert got_o.dtype == tx[0].dtype and tuple(got_o.shape) == (B, T, H, K)
    assert got_s.dtype == torch.float32 and tuple(got_s.shape) == (B, H, K, K)
    for want in (want_o, pal_o):
        _close(want, got_o, **tols(dtype))
    for want in (want_s, pal_s):
        _close(want, got_s, **tols(dtype))
    # the port's own serial oracle, and the kernel wrapper's CPU route
    ref_o, ref_s = ref.rwkv6_scan_ref(*tx)
    _close(want_o, ref_o, **tols(dtype))
    _close(want_s, ref_s, **tols(dtype))
    torch.testing.assert_close(rwkv6_scan(*tx, chunk=chunk)[0], got_o)


def closed_form_tol(chunk: int) -> float:
    """The chunked closed form's own f32 rounding, relative to max |out|.

    Each pairwise decay is exp of a difference of two in-chunk cumsums of
    log w, which reach chunk x 88 in magnitude when w nears the 1e-38 clip.
    The difference carries about one ulp of that magnitude, 2**-23 x chunk x
    88, and exp turns it into the same relative error of a term whose decay
    is ~1 (the previous step's k vᵀ).  The serial recurrence has no such
    term.  At chunk 32 that is 3.4e-4; at mixed decays the cumsums stay
    small and the usual 3e-5 holds."""
    return 2.0**-23 * chunk * 88


@pytest.mark.parametrize("decay", ["strong", "weak"])
def test_rwkv6_scan_extreme_decays(decay):
    """Decays at both ends of (0, 1]: w near 1e-38 over a 32-step chunk (a
    cum of ~-2800, which exp(cum_{t-1}) · exp(-cum_s) would overflow) and w
    near 1, which carries the state across chunks.  The serial oracles and
    the final states agree within 3e-5; the closed form's outputs, the
    port's and Pallas', within its own rounding at strong decays."""
    B, T, H, K, chunk = 1, 64, 4, 16, 32
    arrays = _rwkv6_inputs(52, B, T, H, K, decay)
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(a) for a in arrays]
    want_o, want_s = jax_ref.rwkv6_scan_ref(*jx)
    ref_o, ref_s = ref.rwkv6_scan_ref(*tx)
    _close(want_o, ref_o, **tols("float32"))
    _close(want_s, ref_s, **tols("float32"))
    pal_o, pal_s = jax_rwkv6(*jx, chunk=chunk, interpret=True)
    got_o, got_s = ops.rwkv6_scan(*tx, chunk=chunk)
    assert bool(torch.isfinite(got_o).all()) and bool(torch.isfinite(got_s).all())
    tol_o = (dict(atol=closed_form_tol(chunk) * float(np.abs(want_o).max()), rtol=0.0)
             if decay == "strong" else tols("float32"))
    pallas = (torch.from_numpy(np.array(pal_o)), torch.from_numpy(np.array(pal_s)))
    for closed_o, closed_s in (pallas, (got_o, got_s)):
        _close(want_o, closed_o, **tol_o)
        _close(want_s, closed_s, **tols("float32"))
    if decay == "strong":  # the final state is the last step's k vᵀ alone
        kv = tx[1][:, -1, :, :, None] * tx[2][:, -1, :, None, :]
        torch.testing.assert_close(got_s, kv, atol=3e-5, rtol=3e-5)


def test_rwkv6_scan_subnormal_decays_stay_finite():
    """w below the smallest normal f32 (1.18e-38).  XLA on the CPU flushes
    such values to zero, so the JAX package's chunked form takes log(0) and
    returns NaN there (ROADMAP R7); the port's chunked form clips at 1e-38
    and stays finite, and matches the JAX serial oracle, which multiplies
    the state by the flushed w and so agrees up to a 1e-38 factor."""
    arrays = _rwkv6_inputs(55, 1, 64, 4, 16, "subnormal")
    tx = [torch.from_numpy(a) for a in arrays]
    want_o, want_s = jax_ref.rwkv6_scan_ref(*(jnp.asarray(a) for a in arrays))
    got_o, got_s = ops.rwkv6_scan(*tx, chunk=32)
    assert bool(torch.isfinite(got_o).all()) and bool(torch.isfinite(got_s).all())
    _close(want_o, got_o, atol=closed_form_tol(32) * float(np.abs(want_o).max()), rtol=0.0)
    _close(want_s, got_s, **tols("float32"))


def test_rwkv6_step_matches_scan():
    """ops.rwkv6_step, step by step, reproduces the scan and the JAX step
    (tests/test_kernels.py::test_ops_decode_steps_match_scans)."""
    B, T, H, K = 2, 8, 2, 8
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _rwkv6_inputs(53, B, T, H, K))
    want_o, want_s = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=T)
    st, outs = s0, []
    for t in range(T):
        o, st = ops.rwkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u, st)
        jo, _ = jax_ops.rwkv6_step(*(jnp.asarray(a[:, t].numpy()) for a in (r, k, v, w)),
                                   jnp.asarray(u.numpy()), jnp.asarray(st.numpy()))
        outs.append(o)
    torch.testing.assert_close(torch.stack(outs, 1), want_o, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(st, want_s, atol=2e-5, rtol=2e-5)
    # the step's dtypes: out in r's, state in the state's
    o, s = ops.rwkv6_step(r[:, 0].bfloat16(), k[:, 0].bfloat16(), v[:, 0].bfloat16(),
                          w[:, 0].bfloat16(), u.bfloat16(), s0)
    assert (o.dtype, s.dtype) == (torch.bfloat16, torch.float32)


def test_rwkv6_scan_chunk_contract():
    """T must be a multiple of min(chunk, T) on every route, where the JAX
    op asserts it too (ROADMAP R6); T <= chunk always passes."""
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _rwkv6_inputs(54, 1, 20, 2, 8))
    for impl in ("auto", "plain"):
        with pytest.raises(ValueError, match="multiple of chunk=16"):
            ops.rwkv6_scan(r, k, v, w, u, s0, chunk=16, impl=impl)
    with pytest.raises(AssertionError, match="multiple of chunk=16"):
        jax_ops.rwkv6_scan(*(jnp.asarray(a.numpy()) for a in (r, k, v, w, u, s0)), chunk=16)
    out, _ = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=32, remat_chunks=True)
    assert tuple(out.shape) == (1, 20, 2, 8)


def test_rwkv6_wrapper_refuses_other_devices():
    r = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        rwkv6_scan(r, r, r, r, torch.zeros(2, 8, device="meta"),
                   torch.zeros(1, 2, 8, 8, device="meta"))


@pytest.mark.parametrize("K", k6.HEAD_DIMS)
@pytest.mark.parametrize("V", [8, 16, 40, 64])
def test_rwkv6_scan_plan_covers_every_state_element_once(K, V):
    """Over the plan's grid and threads, the tiles (rows x unmasked columns)
    hold each (b, h, k, v) state element exactly once."""
    B, H = 2, 3
    p = k6.scan_plan(B, H, K, V, n_sm=132)
    assert p.threads == (K // p.kt) * (p.vb // p.vt) <= k6.MAX_THREADS
    assert p.threads % 32 == 0  # whole warps: the kernel's shuffles take the full mask
    assert p.vb % p.vt == 0 and p.vb * 2 % 16 == 0 and p.vb * 4 % 16 == 0
    seen = {}
    for bx in range(p.grid[0]):
        for by in range(p.grid[1]):
            for t in range(p.threads):
                b, h, rows, cols = p.tile((bx, by), t)
                assert len(rows) == p.kt and len(cols) <= p.vt
                for e in ((b, h, kk, vv) for kk in rows for vv in cols):
                    seen[e] = seen.get(e, 0) + 1
    want = {(b, h, kk, vv) for b in range(B) for h in range(H) for kk in range(K)
            for vv in range(V)}
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("B", [1, 8])
def test_rwkv6_scan_plan_fills_the_card_at_the_served_shapes(B):
    """rwkv6-7b's 64 heads of 64 give each of 132 SMs a block at batch 1
    (four 16-column tiles a head) and batch 8 (whole heads), inside a
    block's 227 KB of shared memory in either dtype."""
    for itemsize in (2, 4):
        p = k6.scan_plan(B, 64, 64, 64, n_sm=132, itemsize=itemsize)
        assert p.grid[0] * p.grid[1] >= 132
        assert p.smem_bytes <= 232448 and p.threads <= k6.MAX_THREADS
        assert p.smem_bytes == p.stages * p.steps * (64 * (2 * itemsize + 4) + p.vb * itemsize)
    assert k6.scan_plan(B, 64, 64, 64, n_sm=132).vb == (16 if B == 1 else 64)


def _rwkv6_kernel_emulation(r, k, v, w, u, s0, plan):
    """The kernel's decomposition in f32: thread kg of a column holds the
    plan's rows of the state; per step it forms p = Σ_j (r_j k_j) u_j over
    its rows in order, starts each column sum at p · v and adds r_j S[j, v]
    in row order, and the column's K / kt partial sums are reduced by the
    butterfly (kg with kg ^ 1, then ^ 2, ...); then S = w S + k v."""
    rows = torch.tensor([list(plan.tile((0, 0), g)[2]) for g in range(plan.K // plan.kt)])
    B, T, H, K = r.shape
    s = s0.clone()[:, :, rows]  # (B, H, G, kt, V)
    uk = u[:, rows]  # (H, G, kt)
    outs = []
    for t in range(T):
        rt, kt_, wt, vt = r[:, t][:, :, rows], k[:, t][:, :, rows], w[:, t][:, :, rows], v[:, t]
        p = torch.zeros(rt.shape[:3])
        for j in range(plan.kt):
            p = p + (rt[..., j] * kt_[..., j]) * uk[None, ..., j]
        acc = p[..., None] * vt[:, :, None, :]  # (B, H, G, V)
        for j in range(plan.kt):
            acc = acc + rt[..., j, None] * s[..., j, :]
        while acc.shape[2] > 1:
            acc = acc[:, :, 0::2] + acc[:, :, 1::2]
        outs.append(acc[:, :, 0])
        s = wt[..., None] * s + kt_[..., None] * vt[:, :, None, None, :]
    return torch.stack(outs, 1), s.reshape(B, H, K, -1)


@pytest.mark.parametrize("B,T,H,K,V", [(2, 64, 3, 8, 8), (1, 32, 2, 16, 16), (2, 48, 1, 8, 8),
                                       (1, 64, 4, 64, 64), (1, 64, 4, 64, 40)])
def test_rwkv6_kernel_decomposition_matches_the_oracle(B, T, H, K, V):
    """The per-thread tiles, the factored bonus and the reduction in the
    kernel's order, emulated in f32, hold the serial oracle within 1e-5
    relative to max |out| and max |state| (the CUDA kernel itself is held
    on the card by chip_smoke.py)."""
    r, k, _, w, u, _ = (torch.from_numpy(a) for a in _rwkv6_inputs(56, B, T, H, K))
    rng = np.random.default_rng(57)
    v = torch.from_numpy(rng.standard_normal((B, T, H, V), np.float32))
    s0 = torch.from_numpy(rng.standard_normal((B, H, K, V), np.float32) * 0.1)
    plan = k6.scan_plan(B, H, K, V, n_sm=132, itemsize=4)
    got_o, got_s = _rwkv6_kernel_emulation(r, k, v, w, u, s0, plan)
    want_o, want_s = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    for got, want in ((got_o, want_o), (got_s, want_s)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ---------------------------------------------------------------------------
# K5 Mamba-1 selective scan
# ---------------------------------------------------------------------------
#
# The Pallas kernel cannot be the reference here: on this jax its
# ``pl.store`` raises in interpret mode too (ROADMAP R1).  The port's plain
# versions are held against the JAX serial oracle ``ref.mamba_scan_ref``
# and the JAX chunked form ``ref.mamba_scan_chunked``, which is what the
# JAX model runs off the TPU.  f32 tolerance 2e-5: the two sides sum C·h
# and combine the scan's pairs in other orders (the JAX associative scan is
# an odd/even tree, the port's Hillis–Steele).


def _mamba_inputs(seed, B, T, DI, N, decay="mixed"):
    """x, dt, A, Bm, C, D, state as numpy f32.  "mixed" is
    tests/test_kernels.py's law: dt = softplus(N(0, 1)), A = -exp(N(0, 0.3²)).
    "strong": dt in [2, 5] and A = -exp(U(3, 4)), so every decay
    exp(dt A) is below e^-40 and most underflow to 0 (the state forgets at
    once).  "weak": dt in [0, 1e-3], so decays are ~1 and the state carries
    across chunks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, DI))
    if decay == "strong":
        dt = rng.uniform(2, 5, (B, T, DI))
        A = -np.exp(rng.uniform(3, 4, (DI, N)))
    else:
        dt = (rng.uniform(0, 1e-3, (B, T, DI)) if decay == "weak"
              else np.logaddexp(rng.standard_normal((B, T, DI)), 0))
        A = -np.exp(rng.standard_normal((DI, N)) * 0.3)
    Bm, C = (rng.standard_normal((B, T, N)) for _ in range(2))
    D = rng.standard_normal(DI)
    h0 = rng.standard_normal((B, DI, N)) * 0.1
    return tuple(a.astype(np.float32) for a in (x, dt, A, Bm, C, D, h0))


def _mamba_pairs(arrays, dtype):
    """x, dt, Bm, C in ``dtype``; A, D and the state in f32 (as the model
    passes them)."""
    pairs = [_pair(a, dtype if i in (0, 1, 3, 4) else "float32") for i, a in enumerate(arrays)]
    return [j for j, _ in pairs], [t for _, t in pairs]


def _mamba_tols(dtype):
    return tols(dtype) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,DI,N,chunk", [(2, 64, 12, 4, 16), (1, 32, 8, 8, 32),
                                            (2, 64, 40, 16, 32)])
def test_mamba_scan_vs_jax(B, T, DI, N, chunk, dtype):
    """tests/test_kernels.py's two shapes and one at N = 16 (jamba's state
    size) with DI = 40, a ragged channel tile on the card; a non-zero
    state.  The port's serial oracle against the JAX oracle, and the
    port's op on the CPU (the chunked plain version) against the JAX
    chunked form and the JAX oracle."""
    jx, tx = _mamba_pairs(_mamba_inputs(61, B, T, DI, N), dtype)
    want_y, want_s = jax_ref.mamba_scan_ref(*jx)
    jch_y, jch_s = jax_ref.mamba_scan_chunked(*jx, chunk=chunk)
    ref_y, ref_s = ref.mamba_scan_ref(*tx)
    got_y, got_s = ops.mamba_scan(*tx, chunk=chunk)
    for y, s in ((ref_y, ref_s), (got_y, got_s)):
        assert y.dtype == tx[0].dtype and tuple(y.shape) == (B, T, DI)
        assert s.dtype == torch.float32 and tuple(s.shape) == (B, DI, N)
    _close(want_y, ref_y, **_mamba_tols(dtype))
    _close(want_s, ref_s, **_mamba_tols(dtype))
    for want_y_, want_s_ in ((jch_y, jch_s), (want_y, want_s)):
        _close(want_y_, got_y, **_mamba_tols(dtype))
        _close(want_s_, got_s, **_mamba_tols(dtype))
    # the kernel wrapper's CPU route is the chunked plain version
    torch.testing.assert_close(mamba_scan(*tx, chunk=chunk)[0], got_y)


@pytest.mark.parametrize("decay", ["strong", "weak"])
def test_mamba_scan_extreme_decays(decay):
    """Decays at both ends of (0, 1): exp(dt A) underflowing to 0, and ~1
    over a 64-step sequence in 16-step chunks (the state crosses three chunk
    boundaries).  Both plain versions against both JAX forms, in f32."""
    arrays = _mamba_inputs(62, 2, 64, 12, 8, decay)
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(a) for a in arrays]
    want_y, want_s = jax_ref.mamba_scan_ref(*jx)
    jch_y, jch_s = jax_ref.mamba_scan_chunked(*jx, chunk=16)
    for y, s in (ref.mamba_scan_ref(*tx), ops.mamba_scan(*tx, chunk=16)):
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
        for want_y_, want_s_ in ((want_y, want_s), (jch_y, jch_s)):
            _close(want_y_, y, **_mamba_tols("float32"))
            _close(want_s_, s, **_mamba_tols("float32"))
    if decay == "strong":  # the final state is the last step's (dt x) ⊗ B alone
        x, dt, _, Bm = tx[:4]
        last = (dt[:, -1] * x[:, -1])[..., None] * Bm[:, -1, None, :]
        torch.testing.assert_close(ops.mamba_scan(*tx, chunk=16)[1], last, atol=2e-5, rtol=2e-5)


def test_mamba_step_matches_scan():
    """ops.mamba_step, step by step, reproduces the scan and the JAX step
    (tests/test_kernels.py::test_ops_decode_steps_match_scans)."""
    B, T, DI, N = 2, 8, 12, 8
    x, dt, A, Bm, C, D, s0 = (torch.from_numpy(a) for a in _mamba_inputs(63, B, T, DI, N))
    want_y, want_s = ops.mamba_scan(x, dt, A, Bm, C, D, s0, chunk=T)
    st, ys = s0, []
    for t in range(T):
        jy, js = jax_ops.mamba_step(*(jnp.asarray(a[:, t].numpy()) for a in (x, dt)),
                                    jnp.asarray(A.numpy()),
                                    *(jnp.asarray(a[:, t].numpy()) for a in (Bm, C)),
                                    jnp.asarray(D.numpy()), jnp.asarray(st.numpy()))
        y, st = ops.mamba_step(x[:, t], dt[:, t], A, Bm[:, t], C[:, t], D, st)
        _close(jy, y, atol=2e-5, rtol=2e-5)
        _close(js, st, atol=2e-5, rtol=2e-5)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), want_y, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(st, want_s, atol=2e-5, rtol=2e-5)
    # the step's dtypes: y in x's, state in the state's
    y, s = ops.mamba_step(x[:, 0].bfloat16(), dt[:, 0].bfloat16(), A, Bm[:, 0].bfloat16(),
                          C[:, 0].bfloat16(), D, s0)
    assert (y.dtype, s.dtype) == (torch.bfloat16, torch.float32)


def test_mamba_scan_chunk_contract():
    """T must be a multiple of min(chunk, T) on every route, where the JAX
    op asserts it too (ROADMAP R8); T <= chunk always passes."""
    arrays = _mamba_inputs(64, 1, 20, 8, 4)
    tx = [torch.from_numpy(a) for a in arrays]
    for impl in ("auto", "plain"):
        with pytest.raises(ValueError, match="multiple of chunk=16"):
            ops.mamba_scan(*tx, chunk=16, impl=impl)
    with pytest.raises(ValueError, match="multiple of chunk=16"):
        ref.mamba_scan_chunked(*tx, chunk=16)
    with pytest.raises(AssertionError, match="multiple of chunk=16"):
        jax_ops.mamba_scan(*(jnp.asarray(a) for a in arrays), chunk=16)
    y, _ = ops.mamba_scan(*tx, chunk=32, remat_chunks=True)
    assert tuple(y.shape) == (1, 20, 8)


@pytest.mark.parametrize("DI", [12, 40, 16384])
@pytest.mark.parametrize("N", k5.STATE_SIZES)
def test_mamba_plan_covers_every_channel_once(N, DI):
    """Over the plan's grid and threads, the lanes hold each (b, channel,
    state value) exactly once; channels past DI are masked."""
    B = 2
    p = k5.mamba_plan(B, DI, N, 2, n_sm=132)
    assert p.threads == p.channels * p.lanes == k5.THREADS and p.lanes * p.values == N
    assert p.values == min(N, k5.MAX_VALUES)
    assert p.steps % p.group == 0
    seen = {}
    for bx in range(p.grid[0]):
        for by in range(p.grid[1]):
            for t in range(p.threads):
                b, ch, values = p.channel((bx, by), t)
                for e in ((b, ch, n) for n in values if ch is not None):
                    seen[e] = seen.get(e, 0) + 1
    assert set(seen) == {(b, c, n) for b in range(B) for c in range(DI) for n in range(N)}
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("N", k5.STATE_SIZES)
def test_mamba_plan_runs_the_served_prefill_in_one_wave(N, itemsize):
    """At (1, 512, 16384, 16) every block is resident at once on 132 SMs (256
    blocks of 64 channels; 4 a block's register cap allows, which its
    ring's shared memory leaves room for inside 227 KB), and every state
    size's ring fits the same."""
    p = k5.mamba_plan(1, 16384, N, itemsize, n_sm=132)
    assert p.resident == k5.MIN_BLOCKS
    assert p.resident * (p.smem_bytes + k5.BLOCK_RESERVED) <= 232448
    assert p.steps * p.channels * itemsize == k5.STAGE_BYTES
    if N == 16:
        assert p.grid == (256, 1) and p.waves == 1 and p.grid[0] <= 132 * p.resident
    assert k5.mamba_plan(8, 16384, N, itemsize, n_sm=132).waves > 1


def _mamba_kernel_emulation(x, dt, A, Bm, C, D, s0, plan):
    """The kernel's arithmetic in f32: decays exp2(dt · A log2 e); lane g of
    a channel holds the plan's state values v·g .. v·g + v - 1 and sums C·h
    over them in that order; the lanes' partial sums of each step are added
    pairwise (g with g ^ 1, then ^ 2), as the reduce-scatter adds them; y =
    D·x + the sum."""
    import math

    B, T, DI = x.shape
    N = A.shape[1]
    a2 = A * math.log2(math.e)
    h = s0.clone()
    ys = []
    for t in range(T):
        dv, xv = dt[:, t], x[:, t]
        h = torch.exp2(dv[..., None] * a2) * h + (dv * xv)[..., None] * Bm[:, t, None, :]
        part = (C[:, t, None, :] * h).reshape(B, DI, plan.lanes, plan.values)
        acc = part[..., 0]
        for j in range(1, plan.values):
            acc = acc + part[..., j]
        while acc.shape[-1] > 1:
            acc = acc[..., 0::2] + acc[..., 1::2]
        ys.append(D * xv + acc[..., 0])
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("B,T,DI,N", [(2, 64, 12, 4), (1, 50, 40, 16), (2, 32, 20, 8)])
def test_mamba_kernel_decomposition_matches_the_oracle(B, T, DI, N):
    """The kernel's order of operations, emulated in f32, holds the serial
    oracle within 1e-5 relative to max |y| and max |state| (the CUDA kernel
    itself is held on the card by chip_smoke.py)."""
    arrays = [torch.from_numpy(a) for a in _mamba_inputs(65, B, T, DI, N)]
    plan = k5.mamba_plan(B, DI, N, 4, n_sm=132)
    got = _mamba_kernel_emulation(*arrays, plan)
    want = ref.mamba_scan_ref(*arrays)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_mamba_wrapper_refuses_other_devices():
    x = torch.zeros(1, 4, 8, device="meta")
    bc = torch.zeros(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        mamba_scan(x, x, torch.zeros(8, 16, device="meta"), bc, bc,
                   torch.zeros(8, device="meta"), torch.zeros(1, 8, 16, device="meta"))


# ---------------------------------------------------------------------------
# K1's log-sum-exp, K1b (the flash backward) and K3b (the RMSNorm backward)
# ---------------------------------------------------------------------------

# the window / softcap / q_offset cases of tests/test_kernels_vjp.py
VJP_CASES = [(None, None, 0), (16, None, 0), (None, 30.0, 0), (16, 50.0, 0), (None, None, 24)]


def _vjp_inputs(q_offset: int, dtype: str, seed: int, D: int = 16):
    """(B, Sq, Hq, Hkv, D) = (2, 40, 4, 2, 16) and Sk = Sq + q_offset, as
    tests/test_kernels_vjp.py draws them (or another head dim D); q, k, v
    and the output cotangent."""
    B, Sq, Hq, Hkv = 2, 40, 4, 2
    rng = np.random.default_rng(seed)
    shapes = [(B, Sq, Hq, D), (B, Sq + q_offset, Hkv, D), (B, Sq + q_offset, Hkv, D),
              (B, Sq, Hq, D)]
    return [_pair(rng.standard_normal(s).astype(np.float32), dtype) for s in shapes]


def _rel_close(got: torch.Tensor, want, tol: float, what: str):
    """max |got - want| within ``tol`` of max |want|."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), f"{what}: {err:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap,q_offset", VJP_CASES)
def test_flash_attention_lse_vs_fwd_impl(window, softcap, q_offset, dtype):
    """The plain version of K1 with its lse (and the wrapper's CPU route)
    against flash_vjp._fwd_impl's (out, lse)."""
    (qj, qt), (kj, kt), (vj, vt), _ = _vjp_inputs(q_offset, dtype, 61)
    out_j, lse_j = jax_flash_fwd_lse(qj, kj, vj, True, window, softcap, None, q_offset, 16)
    kw = dict(window=window, softcap=softcap, q_offset=q_offset)
    out_t, lse_t = ref.flash_attention_lse_ref(qt, kt, vt, **kw)
    B, Sq, Hq, _ = qt.shape
    _close(out_j, out_t, **tols(dtype))
    _close(np.asarray(lse_j).reshape(B, Hq, Sq), lse_t, **tols(dtype))
    assert lse_t.dtype == torch.float32 and out_t.dtype == qt.dtype
    out_w, lse_w = flash_attention(qt, kt, vt, return_lse=True, **kw)
    assert torch.equal(out_w, out_t) and torch.equal(lse_w, lse_t)


# the VJP cases at head dim 16, and again at the wide pair's head dims 128
# and 256 (the gemmas, chameleon-34b)
VJP_BWD_CASES = [pytest.param(*c, 16, id="-".join(map(str, c))) for c in VJP_CASES] + [
    pytest.param(*c, D, id="-".join(map(str, c)) + f"-D{D}") for D in (128, 256)
    for c in VJP_CASES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap,q_offset,D", VJP_BWD_CASES)
def test_flash_attention_bwd_vs_flash_vjp(window, softcap, q_offset, D, dtype):
    """ref.flash_attention_bwd_ref, the K1b wrapper's CPU route and the
    autograd.Function behind ops.attention against jax.vjp of
    flash_vjp.flash_attention_fused; each gradient relative to its max |.|
    (f32: 1e-5, rounding; bf16: 2e-2, the inputs' rounding)."""
    (qj, qt), (kj, kt), (vj, vt), (cj, ct) = _vjp_inputs(q_offset, dtype, 62, D)
    out_j, vjp = jax.vjp(
        lambda q, k, v: jax_flash_vjp(q, k, v, True, window, softcap, None, q_offset, 16),
        qj, kj, vj)
    want = vjp(cj)
    kw = dict(window=window, softcap=softcap, q_offset=q_offset)
    tol = 1e-5 if dtype == "float32" else 2e-2
    out_t, lse_t = ref.flash_attention_lse_ref(qt, kt, vt, **kw)
    got_ref = ref.flash_attention_bwd_ref(qt, kt, vt, out_t, lse_t, ct, **kw)
    got_wrap = flash_attention_bwd(qt, kt, vt, out_t, lse_t, ct, **kw)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    out_f = ops.attention(*leaves, **kw)
    got_fn = torch.autograd.grad(out_f, leaves, ct)
    _close(out_j, out_f.detach(), **tols(dtype))
    for name, a, b, c, w in zip("qkv", got_ref, got_wrap, got_fn, want):
        assert a.dtype == qt.dtype and torch.equal(a, b) and torch.equal(a, c)
        _rel_close(a, w, tol, f"d{name}")


def test_flash_attention_bwd_row_without_a_live_key_is_zero():
    """A window with q_offset past it leaves the first rows no key: their
    lse stays finite (the l floor), and every gradient is finite, with zero
    dq for them."""
    rng = np.random.default_rng(63)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((1, 8, 2, 16), (1, 4, 2, 16), (1, 4, 2, 16), (1, 8, 2, 16)))
    kw = dict(causal=False, window=2, q_offset=3)  # rows 2.. see no key of 0 .. 3
    out, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    assert bool(torch.isfinite(lse).all())
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    assert bool((dq[:, 2:] == 0).all()) and bool(dq[:, :2].abs().max() > 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 32), (3, 5, 96), (2, 960)])
def test_rmsnorm_bwd_vs_jax_grad(shape, dtype):
    """ref.rmsnorm_bwd_ref, the K3b wrapper's CPU route and the
    autograd.Function behind ops.rmsnorm against jax.vjp of
    repro.nn.core.rmsnorm (dx in x's dtype, dscale f32)."""
    rng = np.random.default_rng(64)
    (xj, xt) = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    (sj, st) = _pair((rng.standard_normal(shape[-1]) * 0.1).astype(np.float32), "float32")
    (gj, gt) = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    _, vjp = jax.vjp(lambda x, s: jax_nn_rmsnorm({"scale": s}, x, 1e-6), xj, sj)
    dx_j, ds_j = vjp(gj)
    tol = 1e-5 if dtype == "float32" else 2e-2
    got = ref.rmsnorm_bwd_ref(xt, st, gt)
    assert all(torch.equal(a, b) for a, b in zip(got, rmsnorm_bwd(xt, st, gt)))
    leaves = [xt.clone().requires_grad_(), st.clone().requires_grad_()]
    got_fn = torch.autograd.grad(ops.rmsnorm(*leaves), leaves, gt)
    for a, b, w, name in zip(got, got_fn, (dx_j, ds_j), ("dx", "dscale")):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
        _rel_close(a, w, tol, name)
    assert got[0].dtype == xt.dtype and got[1].dtype == torch.float32


# K3b's (rows, D): smollm-360m's training rows, the served widths at 8 and
# 512 rows, and ragged row counts against the grid and the row groups
BWD_SHAPES = ([(8192, 960)] + [(r, d) for d in (16, 512, 896, 2048, 4096, 8192) for r in (8, 512)]
              + [(r, 960) for r in (1, 7, 133, 8191)])


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows,D", BWD_SHAPES)
def test_rmsnorm_bwd_plan_covers_each_row_and_column_once(rows, D, itemsize):
    """K3b's plan: every row lies in exactly one group of one block; each
    block's run is contiguous and the runs differ by at most one row; every
    column of a row belongs to exactly one lane of its group; a lane holds
    at most the plan's cap of (1 + scale) values and dscale partials; the
    grid is at most one block an SM; the joiners' threads split the blocks'
    rows of partials into runs that cover each once."""
    p = k3.bwd_plan(rows, D, itemsize, n_sm=132)
    assert p.lanes & (p.lanes - 1) == 0 and p.lanes * p.groups == k3.BWD_THREADS
    assert p.reg_floats <= k3.BWD_REG_FLOATS and p.chunks in (1, 2, 4, 8)
    assert p.grid <= 132
    segments = p.join_segments()  # the rows of partials, as the joiners' threads split them
    assert [i for run in segments for i in run] == list(range(p.grid))
    per = -(-(D // 4) // min(k3.BWD_JOINERS, p.grid))  # a joiner's 16-byte columns
    assert len(segments) * min(per, k3.BWD_THREADS) <= k3.BWD_THREADS
    runs = [p.block_rows(b) for b in range(p.grid)]
    assert [r for run in runs for r in run] == list(range(rows))
    assert max(map(len, runs)) - min(map(len, runs)) <= 1
    seen = np.zeros(rows, np.int64)
    for b in range(p.grid):
        for g in range(p.groups):
            seen[list(p.group_rows(b, g))] += 1
    assert (seen == 1).all()
    owned = np.zeros(D, np.int64)
    for t in range(p.lanes):
        owned[p.columns(t)] += 1
    assert (owned == 1).all()
    assert all(p.columns(t) == p.columns(t % p.lanes) for t in range(k3.BWD_THREADS))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows,D", [(8192, 960), (8191, 2048), (133, 960), (7, 8192),
                                    (512, 16)])
def test_rmsnorm_bwd_dscale_in_the_kernels_order(rows, D, itemsize):
    """dscale summed in the order K3b sums it on the card, as its plan
    assigns the work: each group's rows in order (a lane's register
    partials), then the block's groups in order, then the blocks' rows in
    runs of consecutive rows, in order, then the runs' sums in order.  In
    f64 it equals the plain sum over rows to rounding (so the partition
    covers each row once); in f64 and in f32 it is within f32 rounding of
    ref.rmsnorm_bwd_ref."""
    rng = np.random.default_rng(65)
    xt, dyt = (torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32))
               .to(torch.bfloat16 if itemsize == 2 else torch.float32) for _ in range(2))
    st = torch.from_numpy((rng.standard_normal(D) * 0.1).astype(np.float32))
    want = ref.rmsnorm_bwd_ref(xt, st, dyt)[1].numpy()
    p = k3.bwd_plan(rows, D, itemsize, n_sm=132)
    for dt, tol in ((np.float64, 1e-6), (np.float32, 1e-5)):
        x, dy = xt.double().numpy(), dyt.double().numpy()
        r = 1.0 / np.sqrt((x * x).mean(axis=1, keepdims=True) + 1e-6)
        contrib = (dy * x * r).astype(dt)
        blocks = []
        for b in range(p.grid):
            acc = np.zeros(D, dt)
            for g in range(p.groups):
                lane_sum = np.zeros(D, dt)
                for row in p.group_rows(b, g):
                    lane_sum = lane_sum + contrib[row]
                acc = lane_sum if g == 0 else acc + lane_sum
            blocks.append(acc)
        segments = [functools.reduce(np.add, [blocks[i] for i in run], np.zeros(D, dt))
                    for run in p.join_segments()]
        got = functools.reduce(np.add, segments)
        if dt == np.float64:
            np.testing.assert_allclose(got, contrib.sum(axis=0), rtol=0, atol=1e-9)
        assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


@pytest.mark.parametrize("itemsize", [2, 4])
def test_rmsnorm_bwd_plan_refuses_rows_wider_than_8192(itemsize):
    """K3b holds a lane's 32 elements in registers, 256 lanes a row: D 8192
    is the widest row it takes (jamba's d_model), D 16384 raises."""
    assert k3.bwd_plan(8, 8192, itemsize, n_sm=132).reg_floats == k3.BWD_REG_FLOATS
    with pytest.raises(ValueError, match="8192 at most"):
        k3.bwd_plan(8, 16384, itemsize, n_sm=132)


def test_rmsnorm_bwd_counters_one_pair_a_stream():
    """K3b's ticket counters: two zeros a (device, stream), the same tensor
    for every call on that stream and another for any other stream, so two
    launches that may overlap never take tickets from one counter."""
    dev = torch.device("cpu")
    a, again, b = (k3.counters(dev, s) for s in (101, 101, 102))
    assert a is again and a is not b and a.data_ptr() != b.data_ptr()
    assert a.dtype == torch.int32 and a.tolist() == [0, 0] == b.tolist()


def _meta(*shape, grad=False, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta", requires_grad=grad)


# each kernel wrapper on inputs off the CPU, the first one requiring grad or not
GUARDED = {
    "flash_attention": lambda g: flash_attention(_meta(1, 4, 2, 16, grad=g), _meta(1, 4, 2, 16),
                                                 _meta(1, 4, 2, 16)),
    "decode_attention": lambda g: decode_attention(
        _meta(1, 2, 16, grad=g), _meta(1, 8, 2, 16), _meta(1, 8, 2, 16),
        _meta(1, 8, dtype=torch.int32), _meta(1, dtype=torch.int32)),
    "rmsnorm": lambda g: rmsnorm(_meta(4, 16, grad=g), _meta(16)),
    "moe_gmm": lambda g: gmm(_meta(2, 8, 16, grad=g), _meta(2, 16, 8)),
    "rwkv6_scan": lambda g: rwkv6_scan(*(_meta(1, 4, 2, 8, grad=g) for _ in range(4)),
                                       _meta(2, 8), _meta(1, 2, 8, 8)),
    "mamba_scan": lambda g: mamba_scan(_meta(1, 4, 8, grad=g), _meta(1, 4, 8), _meta(8, 16),
                                       _meta(1, 4, 16), _meta(1, 4, 16), _meta(8),
                                       _meta(1, 8, 16)),
}


@pytest.mark.parametrize("kernel", list(GUARDED))
def test_wrappers_refuse_inputs_that_need_grad(kernel):
    """R11: off the CPU a wrapper launches its kernel outside autograd, so an
    input that requires grad under grad mode raises (naming the ROADMAP
    item) instead of silently losing its gradient; under torch.no_grad(),
    or for inputs that do not require grad, it goes on (here to the
    device check, since a meta tensor has no kernel)."""
    with pytest.raises(RuntimeError, match="ROADMAP R11"):
        GUARDED[kernel](True)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel for device"):
        GUARDED[kernel](True)
    with pytest.raises(ValueError, match="no kernel for device"):
        GUARDED[kernel](False)


def test_plain_versions_stay_differentiable():
    """On the CPU the plain versions of the forward-only kernels carry
    gradients (the wrappers' guard only acts off the CPU)."""
    rng = np.random.default_rng(65)
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32)).requires_grad_()
    gx, gw = torch.autograd.grad(gmm(x, w, epilogue="silu").sum(), (x, w))
    assert float(gx.abs().sum()) > 0 and float(gw.abs().sum()) > 0


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
