"""K4b, the grouped expert matmul's backward, on the CPU.

The plain versions of ``kernels/ref.py`` (``gmm_dgrad_ref``,
``gmm_wgrad_ref``, ``gmm_gated_dgrad_ref``, ``moe_ffn_bwd_ref``) against
``jax.vjp`` of the JAX package's ``ref.gmm_ref`` / ``ref.moe_ffn_ref``,
and ``ops.moe_ffn`` / ``ops.gmm`` under grad through their
``autograd.Function``s (``ops.MoEFFN``, ``ops.GMM``), whose CPU insides
are those plain versions.  The same inputs, drawn with numpy from a seed,
feed both packages.  The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py`` phase 5 (l).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import moe_gmm as k4  # noqa: E402
from repro_torch.kernels import ops, plan, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (E, C, D, F): a small shape, one ragged against 16-row and 8-wide tiles
# (C 75, D 36, F 20), and deepseek-moe-16b's smoke shape (8 experts of 32)
SHAPES = [(4, 16, 32, 24), (3, 75, 36, 20), (8, 40, 64, 32)]
# each gradient relative to its largest |entry|.  f32: both packages sum the
# same f32 products in other orders (~1e-7 seen).  bf16, one grouped matmul:
# both round the same f32 sum once, so they differ by one bf16 step
# (2^-8 of an element) where the sums straddle a rounding boundary.  bf16,
# the gated FFN: the JAX route rounds dh to bf16 and applies the activation
# to the rounded product where K4b keeps dh in f32 and the kernel route's
# forward rounds act(x w1) once, so h and dh each differ by a bf16 step
# (~4e-3 of an element) before the next product
REL = {"float32": 1e-5, "bfloat16": 1e-2}
REL_FFN = {"float32": 1e-5, "bfloat16": 3e-2}


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _ffn_inputs(E, C, D, F, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = {"x": (E, C, D), "w1": (E, D, F), "w3": (E, D, F), "w2": (E, F, D),
              "dy": (E, C, D)}
    scale = {"x": 1.0, "w1": D ** -0.5, "w3": D ** -0.5, "w2": F ** -0.5, "dy": 1.0}
    return {k: _pair((rng.standard_normal(s) * scale[k]).astype(np.float32), dtype)
            for k, s in shapes.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", SHAPES)
def test_gmm_dgrad_and_wgrad_vs_jax_vjp(E, C, D, F, dtype):
    """gmm_dgrad_ref (g w^T) and gmm_wgrad_ref (x^T g) against jax.vjp of
    the JAX gmm_ref, and the K4b wrappers' CPU route, which is them."""
    rng = np.random.default_rng(61)
    jx, tx = _pair(rng.standard_normal((E, C, D)).astype(np.float32), dtype)
    jw, tw = _pair((rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32), dtype)
    jg, tg = _pair(rng.standard_normal((E, C, F)).astype(np.float32), dtype)
    _, vjp = jax.vjp(jax_ref.gmm_ref, jx, jw)
    jdx, jdw = vjp(jg)
    dx, dw = ref.gmm_dgrad_ref(tg, tw), ref.gmm_wgrad_ref(tx, tg)
    assert dx.dtype == dw.dtype == tx.dtype
    assert tuple(dx.shape) == (E, C, D) and tuple(dw.shape) == (E, D, F)
    assert _rel(dx, jdx) <= REL[dtype] and _rel(dw, jdw) <= REL[dtype]
    assert torch.equal(k4.dgrad(tg, tw), dx) and torch.equal(k4.wgrad(tx, tg), dw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_dgrad_sums_two_pairs_in_one_accumulator(dtype):
    """dgrad's second pair adds into the same f32 sum before the one
    rounding: in f32 it equals the two products summed, and in bf16 it is
    the f32 sum rounded once, not two rounded products added."""
    rng = np.random.default_rng(62)
    E, C, D, F = 3, 75, 36, 20
    g, g2 = (torch.from_numpy(rng.standard_normal((E, C, F)).astype(np.float32)).to(
        DTYPES[dtype][1]) for _ in range(2))
    w, w2 = (torch.from_numpy(rng.standard_normal((E, D, F)).astype(np.float32)).to(
        DTYPES[dtype][1]) for _ in range(2))
    got = ref.gmm_dgrad_ref(g, w, g2, w2)
    acc = g.float() @ w.float().mT + g2.float() @ w2.float().mT
    torch.testing.assert_close(got, acc.to(got.dtype), atol=0, rtol=0)
    assert torch.equal(k4.dgrad(g, w, g2, w2), got)
    with pytest.raises(ValueError, match="go together"):
        k4.dgrad(g, w, g2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("E,C,D,F", SHAPES)
def test_moe_ffn_bwd_ref_vs_jax_vjp(E, C, D, F, act, dtype):
    """moe_ffn_bwd_ref, from the kernel route's forward (moe_ffn_fwd: a3,
    h) and the pre-activation a1 = gmm_ref(x, w1), against jax.vjp of the
    JAX moe_ffn_ref: dx, dw1, dw3, dw2."""
    t = _ffn_inputs(E, C, D, F, dtype, seed=63)
    _, vjp = jax.vjp(lambda *a: jax_ref.moe_ffn_ref(*a, act=act), t["x"][0], t["w1"][0],
                     t["w3"][0], t["w2"][0])
    want = vjp(t["dy"][0])
    x, w1, w3, w2, dy = (t[k][1] for k in ("x", "w1", "w3", "w2", "dy"))
    y, a3, h = ref.moe_ffn_fwd(x, w1, w3, w2, act)
    a1 = ref.gmm_ref(x, w1)
    got = ref.moe_ffn_bwd_ref(x, w1, w3, w2, a1, a3, h, dy, act)
    for name, g, w in zip(("dx", "dw1", "dw3", "dw2"), got, want):
        assert g.dtype == x.dtype and tuple(g.shape) == tuple(w.shape), name
        assert _rel(g, w) <= REL_FFN[dtype], f"{name}: {_rel(g, w):.3e}"
    # the wrappers' CPU route is the same plain versions
    da1, da3 = k4.gated_dgrad(dy, w2, a1, a3, act)
    assert torch.equal(k4.dgrad(da1, w1, da3, w3), got[0])
    assert torch.equal(k4.wgrad(x, da1), got[1]) and torch.equal(k4.wgrad(h, dy), got[3])


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_act_and_grad_is_the_activation_and_its_derivative(act):
    """ref.act_and_grad (K4b's epilogue written out) against the forward's
    epilogue and torch autograd of it, in f64 as well as f32."""
    a = torch.linspace(-8.0, 8.0, 1001, dtype=torch.float64, requires_grad=True)
    y = ref.EPILOGUES[act](a)
    (dy,) = torch.autograd.grad(y.sum(), a)
    g, dg = ref.act_and_grad(a.detach(), act)
    torch.testing.assert_close(g.double(), y.detach(), atol=2e-6, rtol=2e-6)
    torch.testing.assert_close(dg.double(), dy, atol=2e-6, rtol=2e-6)


def _spy(monkeypatch, cls):
    calls = []

    def forward(ctx, *a, _orig=cls.forward):
        calls.append(cls.__name__)
        return _orig(ctx, *a)

    monkeypatch.setattr(cls, "forward", staticmethod(forward))
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("E,C,D,F", SHAPES)
def test_moe_ffn_under_grad_runs_moeffn(monkeypatch, E, C, D, F, act, dtype):
    """ops.moe_ffn under grad runs MoEFFN: its output is the forward's
    without grad, its gradients are moe_ffn_bwd_ref's bit for bit (the CPU
    insides), and equal torch autograd through the plain forward (the same
    composition of ref.gmm_ref) in f32; in bf16 within REL_FFN, since
    autograd differentiates act at the f32 accumulator and rounds dh where
    K4b reads the rounded a1 (recomputed) and keeps dh in f32."""
    calls = _spy(monkeypatch, ops.MoEFFN)
    t = _ffn_inputs(E, C, D, F, dtype, seed=65)
    x, w1, w3, w2, dy = (t[k][1] for k in ("x", "w1", "w3", "w2", "dy"))
    leaves = [v.clone().requires_grad_() for v in (x, w1, w3, w2)]
    y = ops.moe_ffn(*leaves, act=act)
    assert calls == ["MoEFFN"]
    with torch.no_grad():
        assert torch.equal(y, ops.moe_ffn(x, w1, w3, w2, act=act))
    assert calls == ["MoEFFN"]
    got = torch.autograd.grad(y, leaves, dy)
    _, a3, h = ref.moe_ffn_fwd(x, w1, w3, w2, act)
    want = ref.moe_ffn_bwd_ref(x, w1, w3, w2, ref.gmm_ref(x, w1), a3, h, dy, act)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    def plain_forward(x, w1, w3, w2):
        hh = ref.gmm_ref(x, w1, act) * ref.gmm_ref(x, w3)
        return ref.gmm_ref(hh, w2)

    auto = torch.autograd.grad(plain_forward(*leaves), leaves, dy)
    for g, w in zip(got, auto):
        assert _rel(g, w.float().numpy()) <= REL_FFN[dtype]


def test_moe_ffn_needs_only_the_gradients_asked_for(monkeypatch):
    """With only x requiring grad (weights frozen), MoEFFN recomputes a1 and
    computes dx, launching no wgrad; with only w2, one wgrad and nothing
    else (no recompute)."""
    t = _ffn_inputs(2, 12, 16, 8, "float32", seed=66)
    x, w1, w3, w2, dy = (t[k][1] for k in ("x", "w1", "w3", "w2", "dy"))
    calls = []
    for name in ("gated_dgrad", "dgrad", "wgrad"):
        orig = getattr(k4, name)
        monkeypatch.setattr(k4, name, lambda *a, _o=orig, _n=name: (calls.append(_n), _o(*a))[1])
    orig_gmm = ops._gmm_kernel
    monkeypatch.setattr(ops, "_gmm_kernel",
                        lambda *a, **kw: (calls.append("gmm"), orig_gmm(*a, **kw))[1])
    xg = x.clone().requires_grad_()
    y = ops.moe_ffn(xg, w1, w3, w2)
    assert calls == ["gmm"] * 3
    calls.clear()
    (dx,) = torch.autograd.grad(y, [xg], dy)
    assert calls == ["gmm", "gated_dgrad", "dgrad"] and dx.shape == x.shape
    calls.clear()
    wg = w2.clone().requires_grad_()
    y = ops.moe_ffn(x, w1, w3, wg)
    calls.clear()
    torch.autograd.grad(y, [wg], dy)
    assert calls == ["wgrad"]


def test_moe_ffn_under_a_checkpoint_saves_nothing_and_recomputes(monkeypatch):
    """Under torch.utils.checkpoint (remat_policy "nothing") MoEFFN runs its
    forward again in the backward and gives the same gradients bit for bit."""
    calls = _spy(monkeypatch, ops.MoEFFN)
    t = _ffn_inputs(3, 20, 16, 8, "float32", seed=67)
    leaves = [t[k][1].clone().requires_grad_() for k in ("x", "w1", "w3", "w2")]
    dy = t["dy"][1]
    plain = torch.autograd.grad(ops.moe_ffn(*leaves), leaves, dy)
    y = torch.utils.checkpoint.checkpoint(ops.moe_ffn, *leaves, use_reentrant=False)
    remat = torch.autograd.grad(y, leaves, dy)
    assert calls == ["MoEFFN"] * 3
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", SHAPES)
def test_gmm_under_grad_runs_gmm_function(monkeypatch, E, C, D, F, dtype):
    """ops.gmm under grad (no epilogue) runs GMM, whose gradients equal
    torch autograd through ref.gmm_ref; with an epilogue it stays on the
    plain autograd (the kernel has no fused-epilogue backward)."""
    calls = _spy(monkeypatch, ops.GMM)
    rng = np.random.default_rng(68)
    x = torch.from_numpy(rng.standard_normal((E, C, D)).astype(np.float32)).to(DTYPES[dtype][1])
    w = torch.from_numpy(rng.standard_normal((E, D, F)).astype(np.float32)).to(DTYPES[dtype][1])
    g = torch.from_numpy(rng.standard_normal((E, C, F)).astype(np.float32)).to(DTYPES[dtype][1])
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = torch.autograd.grad(ops.gmm(xl, wl), [xl, wl], g)
    assert calls == ["GMM"]
    want = torch.autograd.grad(ref.gmm_ref(xl, wl), [xl, wl], g)
    for a, b in zip(got, want):
        assert _rel(a, b.float().numpy()) <= REL[dtype]
    assert torch.equal(got[0], ref.gmm_dgrad_ref(g, w)) and torch.equal(got[1],
                                                                        ref.gmm_wgrad_ref(x, g))
    ops.gmm(xl, wl, epilogue="silu").sum().backward()
    assert calls == ["GMM"] and xl.grad is not None


def _meta(*shape, grad=False):
    return torch.zeros(shape, device="meta", requires_grad=grad)


BWD = {
    "gated_dgrad": lambda g: k4.gated_dgrad(_meta(2, 8, 16, grad=g), _meta(2, 12, 16),
                                            _meta(2, 8, 12), _meta(2, 8, 12)),
    "dgrad": lambda g: k4.dgrad(_meta(2, 8, 12, grad=g), _meta(2, 16, 12)),
    "wgrad": lambda g: k4.wgrad(_meta(2, 8, 16, grad=g), _meta(2, 8, 12)),
}


@pytest.mark.parametrize("wrapper", list(BWD))
def test_bwd_wrappers_refuse_grad_and_devices_without_a_kernel(wrapper):
    """Off the CPU a K4b wrapper launches outside autograd: an input that
    requires grad under grad mode raises (R11, no double backward), and a
    device without a kernel raises (meta tensors stand in for the card)."""
    with pytest.raises(RuntimeError, match="ROADMAP R11"):
        BWD[wrapper](True)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel for device"):
        BWD[wrapper](True)
    with pytest.raises(ValueError, match="no kernel for device"):
        BWD[wrapper](False)


def test_bwd_instance_is_chosen_by_dtype_shape_and_alignment():
    assert k4.bwd_instance(torch.float32, 2048, 1408, True) == "f32"
    assert k4.bwd_instance(torch.bfloat16, 2048, 1408, True) == "bf16 wgmma"
    assert k4.bwd_instance(torch.bfloat16, 2048, 1412, True) == "bf16 element-wise"
    assert k4.bwd_instance(torch.bfloat16, 196, 1408, True) == "bf16 element-wise"
    assert k4.bwd_instance(torch.bfloat16, 2048, 1408, False) == "bf16 element-wise"


def _dev(*shape, device="meta", dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype, device=device)


PREVIOUS = {  # each K4b kernel's tensors at a small aligned shape
    "gated_dgrad": ((2, 8, 16), (2, 24, 16), (2, 8, 24), (2, 8, 24)),
    "dgrad": ((2, 8, 24), (2, 16, 24), (2, 8, 24), (2, 16, 24)),
    "wgrad": ((2, 8, 16), (2, 8, 24)),
}


@pytest.mark.parametrize("kernel", list(PREVIOUS))
@pytest.mark.parametrize("device,dtype", [("cpu", torch.bfloat16), ("meta", torch.bfloat16),
                                          ("meta", torch.float32)])
def test_previous_bwd_refuses_all_but_bf16_cuda_tensors(kernel, device, dtype):
    """The first design's timing-only entry (moe_gmm.previous_bwd) takes
    bf16 CUDA tensors only: a CPU tensor does not fall to the plain
    version, and a meta (standing in for the card) or f32 tensor raises
    before any launch."""
    tensors = [_dev(*s, device=device, dtype=dtype) for s in PREVIOUS[kernel]]
    with pytest.raises(ValueError, match="bf16 CUDA tensors only"):
        k4.previous_bwd(kernel, *tensors)


def test_previous_bwd_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="not gated_dgrad, dgrad or wgrad"):
        k4.previous_bwd("gmm", _dev(2, 8, 16), _dev(2, 16, 8))


@pytest.mark.parametrize("epilogue", list(plan.BWD_EPILOGUES))
def test_bwd_wgmma_instances_fit_shared_memory(epilogue):
    """Each wgmma K4b instance's shared memory (plan.bwd_smem, which the
    source's own size must equal on the card) fits the 232448 bytes a block
    may opt into, with its ring's stages and the staging buffer whole, and
    its setmaxnreg entry count is the register file over its threads."""
    wg, stages = plan.BWD_DESIGN[epilogue]
    smem = plan.bwd_smem(epilogue)
    assert smem <= 232448
    tm = plan.bwd_tile_m(epilogue)
    assert tm == 64 * wg
    stage = (tm + plan.BWD_TILE_N) * plan.BWD_TILE_K * 2
    staging = tm * plan.BWD_TILE_N * 2 * (1 if epilogue == "store" else 2)
    assert smem >= stages * stage + staging + 1024
    assert plan.bwd_entry_regs(epilogue) == {2: 168, 3: 128}[wg]


# the (E, M, N) outputs of (a), (b) and (c) at each checked shape (E, C, D,
# F), with the instance that computes each: (a) (E, C, F) gated, (b) (E, C,
# D) and (c) dw1 / dw3 (E, D, F) and dw2 (E, F, D) store
WALK_SHAPES = [(64, 960, 2048, 1408), (3, 75, 264, 136), (1, 960, 2048, 1408)]


@pytest.mark.parametrize("E,C,D,F", WALK_SHAPES)
@pytest.mark.parametrize("n_sm", [132, 7])
def test_bwd_walk_covers_every_tile_once_in_a_fixed_order(E, C, D, F, n_sm):
    """The persistent walk (plan.bwd_walk, the kernels' tile order) gives
    every (expert, row tile, column tile) of each output exactly once, on
    a grid of min(tiles, SMs) blocks, each block's tiles a fixed stride
    apart with the columns fastest, and the same walk on each call."""
    tn = plan.BWD_TILE_N
    for M, N, epi in ((C, F, "silu"), (C, D, "store"), (D, F, "store"), (F, D, "store")):
        tm = plan.bwd_tile_m(epi)
        walk = plan.bwd_walk(E, M, N, n_sm, epi)
        want = [(e, m, n) for e in range(E) for m in range(0, M, tm) for n in range(0, N, tn)]
        assert len(walk) == min(len(want), n_sm)
        assert sorted(t for block in walk for t in block) == want  # each tile once
        grid = len(walk)
        for b, block in enumerate(walk):
            assert block == [want[t] for t in range(b, len(want), grid)]
        assert walk == plan.bwd_walk(E, M, N, n_sm, epi)
        lens = [len(block) for block in walk]
        assert max(lens) - min(lens) <= 1


def test_bwd_walk_at_the_slice_shape_wastes_no_rows():
    """At deepseek-moe-16b's capacity (C 960) the 192-row tiles of every
    wgmma instance cover (a)'s and (b)'s rows exactly: five row tiles an
    expert."""
    for epilogue in plan.BWD_EPILOGUES:
        assert plan.bwd_tile_m(epilogue) == 192 and 960 % plan.bwd_tile_m(epilogue) == 0
