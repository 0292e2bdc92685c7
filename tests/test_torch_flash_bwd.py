"""The flash-attention backward (K2/K3's plain version and the
differentiable ``flash_attention``) against the JAX package: ``jax.grad``
through ``flash_attention_tpu(..., interpret=True)`` (the Pallas
forward and backward kernels in the interpreter), and ``_flash_bwd_call``
(the two backward kernels alone) with explicit residuals that are not
the local ones — the global logsumexp and delta of a longer key set, as
ring attention passes them.  Inputs are made with numpy from a seed;
fp32; atol 2e-5 (the frameworks sum in different orders; gradients of
sum(o * g) with unit-normal g reach a few units)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.ops import attention as jax_attn
from theanompi_tpu_torch.ops import attention as port_attn

ATOL = 2e-5
B, H, D = 2, 4, 16


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def port_grads(q, k, v, g, causal, rep=1):
    """(dq, dk, dv) of sum(flash_attention(q, repeat(k), repeat(v)) * g)
    through the port's autograd function (CPU: K1-K3's plain
    versions)."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    kk = tk.repeat_interleave(rep, dim=1) if rep > 1 else tk
    vv = tv.repeat_interleave(rep, dim=1) if rep > 1 else tv
    o = port_attn.flash_attention(tq, kk, vv, causal=causal)
    (o * torch.from_numpy(g)).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


def jax_grads(q, k, v, g, causal, rep=1):
    def loss(q, k, v):
        if rep > 1:
            k = jnp.repeat(k, rep, axis=1)
            v = jnp.repeat(v, rep, axis=1)
        o = jax_attn.flash_attention_tpu(q, k, v, causal=causal,
                                         interpret=True)
        return jnp.sum(o * g)

    return [np.asarray(x) for x in
            jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 33])
def test_flash_attention_grads_match_jax_kernels(causal, t):
    """Ragged T (33) runs in the interpreter as one full-axis block."""
    rng = np.random.default_rng(t + causal)
    q, k, v, g = (normal(rng, B, H, t, D) for _ in range(4))
    for name, got, want in zip("qkv", port_grads(q, k, v, g, causal),
                               jax_grads(q, k, v, g, causal)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_grads_through_the_repeat_match_jax(causal):
    """k/v with H/2 heads, repeated per group before attention
    (``repeat_interleave`` on dim 1 = ``jnp.repeat`` on axis 1): dk and
    dv sum over each group's query heads."""
    rng = np.random.default_rng(5)
    q, g = normal(rng, B, H, 24, D), normal(rng, B, H, 24, D)
    k, v = normal(rng, B, H // 2, 24, D), normal(rng, B, H // 2, 24, D)
    for name, got, want in zip("qkv", port_grads(q, k, v, g, causal, 2),
                               jax_grads(q, k, v, g, causal, 2)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")


def global_residuals(q, ks, vs, masks, g):
    """lse and delta = rowsum(dO * O) [B, H, T] of attention over the
    concatenated key blocks ``ks`` (each with its [Tq, Tk] mask)."""
    scale = D ** -0.5
    s = np.concatenate(
        [np.where(m, np.einsum("bhqd,bhkd->bhqk", q, k) * scale, -np.inf)
         for k, m in zip(ks, masks)], axis=-1).astype(np.float64)
    lse = np.logaddexp.reduce(s, axis=-1)
    p = np.exp(s - lse[..., None])
    o = np.einsum("bhqk,bhkd->bhqd", p, np.concatenate(vs, axis=2))
    delta = np.sum(g.astype(np.float64) * o, axis=-1)
    return lse.astype(np.float32), delta.astype(np.float32)


@pytest.mark.parametrize("t", [16, 20])
def test_explicit_global_residuals_match_jax_bwd_kernels(t):
    """One ring hop's backward: queries at positions [0, t) against a
    past kv block (full attention) and the diagonal block (causal).
    Each block's (dq, dk, dv) from the residuals of BOTH blocks — the
    port's ``flash_bwd`` (and its plain version) against the JAX
    ``_flash_bwd_call`` kernels."""
    rng = np.random.default_rng(t)
    q, g = normal(rng, B, H, t, D), normal(rng, B, H, t, D)
    k_past, v_past = normal(rng, B, H, 2 * t, D), normal(rng, B, H, 2 * t, D)
    k_diag, v_diag = normal(rng, B, H, t, D), normal(rng, B, H, t, D)
    causal_m = np.tril(np.ones((t, t), bool))
    lse, delta = global_residuals(
        q, [k_past, k_diag], [v_past, v_diag],
        [np.ones((t, 2 * t), bool), causal_m], g)
    for k, v, causal in ((k_past, v_past, False), (k_diag, v_diag, True)):
        want = jax_attn._flash_bwd_call(
            *(jnp.asarray(a) for a in (q, k, v, g)),
            jnp.asarray(lse)[..., None], jnp.asarray(delta)[..., None],
            causal, D ** -0.5, t, k.shape[2], True,
        )
        args = [torch.from_numpy(a) for a in (q, k, v, g, lse, delta)]
        got = port_attn.flash_bwd(*args, causal=causal)
        plain = port_attn.flash_bwd_reference(*args, causal=causal)
        for name, a, b, c in zip("qkv", got, plain, want):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=ATOL,
                                       rtol=0, err_msg=f"d{name} {causal}")


def test_delta_and_lse_residual_contract():
    """The autograd function hands the backward the forward's lse and
    delta = rowsum(dO * O) in f32: its gradients equal flash_bwd's on
    those residuals, and autograd of the dense reference."""
    rng = np.random.default_rng(9)
    q, k, v, g = (torch.from_numpy(normal(rng, 1, 2, 12, D))
                  for _ in range(4))
    o, lse = port_attn.flash_attention_fwd(q, k, v, causal=True)
    delta = (g * o).sum(-1)
    want = port_attn.flash_bwd(q, k, v, g, lse, delta, causal=True)
    got = port_grads(*(x.numpy() for x in (q, k, v, g)), True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-6, rtol=0)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (port_attn.mha_reference(*leaves, causal=True) * g).sum().backward()
    for a, b in zip(got, leaves):
        np.testing.assert_allclose(a, b.grad.numpy(), atol=ATOL, rtol=0)


def test_bwd_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run the plain math: a CPU tensor is an
    error there, and only ``flash_bwd`` routes CPU tensors to the
    plain version."""
    x = torch.zeros((1, 2, 8, 16))
    r = torch.zeros((1, 2, 8))
    for fn in (port_attn.flash_bwd_cuda, port_attn.flash_bwd_dkv_cuda,
               port_attn.flash_bwd_dq_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(x, x, x, x, r, r, True, 0.25)
