"""Where the JAX package's RWKV6 gradient can serve as K6b's reference.

The JAX package has no backward kernel for the WKV scan (K6): training
differentiates ``repro.kernels.ref.rwkv6_scan_chunked`` with ``jax.vjp``.
These tests hold that vjp, and a serial reverse recurrence in f32 (the
plain version a K6b kernel would be held against), to float64 autograd
through the serial recurrence at four decay laws (ROADMAP R17):

* mixed and weak decays: JAX agrees to ~1e-5 of each gradient's max |.|;
* strong decays (w down to the chunked form's 1e-38 clip): JAX's dw is a
  residue divided by w, off by many orders of magnitude;
* subnormal decays: JAX's gradients hold NaN;
* and ``jax.grad`` of the clip that the chunked form's log passes through
  gives half the gradient at w = 1.0 (a tie) and inf below 1e-38.

The f32 serial reverse recurrence stays within 2e-6 of the f64 oracle at
all four laws.  On the CPU only; inputs from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import rwkv6_scan_chunked  # noqa: E402

SHAPE = (1, 256, 2, 64)  # B, T, H, K (= V)
CHUNK = 128
GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")


def _inputs(decay: str, seed: int = 7):
    """r, k, v, w, u, state as numpy f32 (tests/test_torch_kernels.py's
    law: r, k of std K**-0.5), and the cotangents of out and state."""
    B, T, H, K = SHAPE
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
    g_out = rng.standard_normal((B, T, H, K), np.float32)
    g_state = rng.standard_normal((B, H, K, K), np.float32)
    return (r, k, v, w.astype(np.float32), u, s0), (g_out, g_state)


def _oracle_f64(xs, gs):
    """The gradients by float64 autograd through the serial recurrence
    out_t = r_t (S_t + diag(u) k_t v_t^T), S_{t+1} = diag(w_t) S_t + k_t v_t^T."""
    r, k, v, w, u, s0 = (torch.from_numpy(x).double().requires_grad_() for x in xs)
    s, outs = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    out = torch.stack(outs, 1)
    g_out, g_state = (torch.from_numpy(g).double() for g in gs)
    return torch.autograd.grad((out * g_out).sum() + (s * g_state).sum(), (r, k, v, w, u, s0))


def _reverse_f32(xs, gs):
    """The same gradients by the serial reverse recurrence in f32: the
    forward's states S_t kept, then from t = T - 1 down, with dS the
    cotangent of S_{t+1}: dr_t = (S_t + diag(u) k_t v_t^T) dout_t,
    dw_t = rowsum(S_t * dS), d(kv_t) = dS + diag(u) r_t dout_t^T, and
    dS <- diag(w_t) dS + r_t dout_t^T."""
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in xs)
    g_out, g_state = (torch.from_numpy(g) for g in gs)
    T = r.shape[1]
    states = [s0]
    for t in range(T - 1):
        states.append(w[:, t, :, :, None] * states[-1] + k[:, t, :, :, None] * v[:, t, :, None, :])
    dS = g_state.clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    for t in range(T - 1, -1, -1):
        rt, kt, vt, wt, go, st = r[:, t], k[:, t], v[:, t], w[:, t], g_out[:, t], states[t]
        kv = kt[..., :, None] * vt[..., None, :]
        dr[:, t] = torch.einsum("bhkv,bhv->bhk", st + u[None, :, :, None] * kv, go)
        dw[:, t] = (st * dS).sum(-1)
        dkv = dS + u[None, :, :, None] * rt[..., :, None] * go[..., None, :]
        dk[:, t] = torch.einsum("bhkv,bhv->bhk", dkv, vt)
        dv[:, t] = torch.einsum("bhkv,bhk->bhv", dkv, kt)
        du += (rt * kt * (vt * go).sum(-1, keepdim=True)).sum(0)
        dS = wt[..., None] * dS + rt[..., :, None] * go[..., None, :]
    return dr, dk, dv, dw, du, dS


def _jax_vjp(xs, gs):
    """jax.vjp of the chunked form as the JAX package trains through it."""
    f = lambda *a: rwkv6_scan_chunked(*a, chunk=CHUNK, remat_chunks=True)  # noqa: E731
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in xs))
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(g) for g in gs))]


def _rel(got, want) -> dict[str, float]:
    """Each gradient's largest error relative to the oracle's max |.|."""
    out = {}
    for name, g, w in zip(GRADS, got, want):
        g, w = np.asarray(g, np.float64), w.numpy()
        out[name] = float(np.abs(g - w).max() / np.abs(w).max())
    return out


@pytest.mark.parametrize("decay", ["mixed", "weak", "strong", "subnormal"])
def test_f32_reverse_recurrence_holds_at_every_decay_law(decay):
    """K6b's plain version: the f32 serial reverse recurrence is within
    2e-6 of the f64 oracle's gradients at all four decay laws (f32 rounding
    of 256-step sums: ds0 at weak decays sums every step's outer product)."""
    xs, gs = _inputs(decay)
    want = _oracle_f64(xs, gs)
    got = _reverse_f32(xs, gs)
    rel = _rel([g.numpy() for g in got], want)
    assert all(np.isfinite(g.numpy()).all() for g in got), decay
    assert max(rel.values()) <= 2e-6, rel


@pytest.mark.parametrize("decay", ["mixed", "weak"])
def test_jax_vjp_agrees_where_sound(decay):
    """At mixed and weak decays jax.vjp of the chunked form is a reference:
    every gradient within 1e-4 of its max |.| (f32 rounding of the chunk's
    log-space products)."""
    xs, gs = _inputs(decay)
    rel = _rel(_jax_vjp(xs, gs), _oracle_f64(xs, gs))
    assert max(rel.values()) <= 1e-4, rel


def test_jax_vjp_fails_at_strong_and_subnormal_decays():
    """Where JAX is not a reference: at strong decays its dw is off by far
    more than dw's max |.| (the clip's residue divided by w), and at
    subnormal decays its gradients hold NaN.  The f64 oracle is finite at
    both."""
    xs, gs = _inputs("strong")
    want = _oracle_f64(xs, gs)
    rel = _rel(_jax_vjp(xs, gs), want)
    assert rel["dw"] > 1e6, rel
    xs, gs = _inputs("subnormal")
    want = _oracle_f64(xs, gs)
    assert all(bool(torch.isfinite(w).all()) for w in want)
    got = _jax_vjp(xs, gs)
    assert any(np.isnan(g).any() for g in got)


def test_jax_grad_of_the_clipped_log_at_its_ends():
    """The chunked form takes log(clip(w, 1e-38, 1)): at w = 1.0 (a tie with
    the clip's upper end) jax.grad passes half the gradient, 0.5 where
    d log w / dw = 1; below 1e-38 it is inf."""
    g = jax.grad(lambda w: jnp.log(jnp.clip(w, 1e-38, 1.0)))
    assert float(g(jnp.float32(1.0))) == 0.5
    assert float(g(jnp.float32(1e-39))) == float("inf")
