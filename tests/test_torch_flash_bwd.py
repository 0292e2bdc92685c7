"""The flash-attention backward (K2/K3's plain version and the
differentiable ``flash_attention``) against the JAX package: ``jax.grad``
through ``flash_attention_tpu(..., interpret=True)`` (the Pallas
forward and backward kernels in the interpreter), and ``_flash_bwd_call``
(the two backward kernels alone) with explicit residuals that are not
the local ones — the global logsumexp and delta of a longer key set, as
ring attention passes them.  Inputs are made with numpy from a seed;
fp32; atol 2e-5 (the frameworks sum in different orders; gradients of
sum(o * g) with unit-normal g reach a few units).

Last, the bf16 arithmetic of the tensor-core K1, K2 and K3, emulated
with torch ops on bf16 inputs (K1 rounds P to bf16 before P V, K2 rounds
P and dS before dV = P^T dO and dK = dS^T Q, K3 rounds dS before
dQ = dS K), held to the fp32 plain versions and to the Pallas kernels in
interpret mode within the tolerance the card's kernels are held to
(atol = rtol = 1e-2)."""

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


# -- the tensor-core kernels' bf16 rounding -----------------------------------

CARD_TOL = dict(atol=1e-2, rtol=1e-2)
TC_BK = 64        # K1's kv tile: the online softmax folds 64 keys at a time


def rounded(x):
    """x rounded to bf16, computed on in fp32."""
    return x.to(torch.bfloat16).float()


def bf16_inputs(seed, n, t, d=32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(normal(rng, 1, 2, t, d)).to(torch.bfloat16)
            for _ in range(n)]


def k1_tc_emulated(q, k, v, causal, sm_scale):
    """K1's tensor-core arithmetic: S in fp32 from bf16 operands, the
    online softmax over 64-key tiles with masked entries exactly 0, P
    rounded to bf16 before P V (l sums the unrounded P), O rounded to
    bf16; lse = m + log(max(l, 1e-30)) in fp32."""
    b, h, tq, _ = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, tq), port_attn.NEG_INF)
    l = torch.zeros((b, h, tq))
    acc = torch.zeros(qf.shape)
    rows = torch.arange(tq)
    for k0 in range(0, kf.shape[2], TC_BK):
        kt, vt = kf[:, :, k0:k0 + TC_BK], vf[:, :, k0:k0 + TC_BK]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * sm_scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])
            s = torch.where(cols[None, :] <= rows[:, None], s,
                            port_attn.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(s == port_attn.NEG_INF, 0.0,
                        torch.exp(s - m_new[..., None]))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", rounded(p), vt)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.to(torch.bfloat16), m + torch.log(torch.clamp(l, min=1e-30))


def k2_tc_emulated(q, k, v, do, lse, delta, causal, sm_scale):
    """K2's tensor-core arithmetic: P and dS in fp32 from bf16 operands,
    rounded to bf16 before dV = P^T dO and dK = dS^T Q (fp32 sums),
    dK and dV rounded to bf16."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        t_q, t_k = q.shape[2], k.shape[2]
        p = torch.where(port_attn.causal_mask(torch.arange(t_q),
                                              torch.arange(t_k)), p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * sm_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", rounded(p), dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", rounded(ds), qf)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def k3_tc_emulated(q, k, v, do, lse, delta, causal, sm_scale):
    """K3's tensor-core arithmetic: P and dS in fp32 from bf16 operands,
    dS rounded to bf16 before dQ = dS K (bf16 K, fp32 sums), dQ rounded
    to bf16."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        t_q, t_k = q.shape[2], k.shape[2]
        p = torch.where(port_attn.causal_mask(torch.arange(t_q),
                                              torch.arange(t_k)), p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", rounded(ds), kf)
    return dq.to(torch.bfloat16)


def jax_bf16(x):
    return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               err_msg=what, **CARD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [15, 64, 65, 130])
def test_k1_bf16_p_rounding_fits_the_card_tolerance(t, causal):
    """K1's rounding of P to bf16 against ``mha_reference_fwd`` in fp32
    and the Pallas forward (bf16 inputs, one full-axis block, interpret
    mode); lse, which the rounding does not touch, to 1e-5."""
    q, k, v = bf16_inputs(200 + t + causal, 3, t)
    scale = q.shape[-1] ** -0.5
    o, lse = k1_tc_emulated(q, k, v, causal, scale)
    o_ref, lse_ref = port_attn.mha_reference_fwd(
        q.float(), k.float(), v.float(), causal=causal)
    want_o, want_lse = jax_attn._flash_fwd_call(
        jax_bf16(q), jax_bf16(k), jax_bf16(v), causal, scale, t, t, True)
    close(o.float(), o_ref, "o vs fp32 plain")
    close(o.float(), want_o.astype(jnp.float32), "o vs Pallas")
    for want in (lse_ref, np.asarray(want_lse).reshape(lse.shape)):
        np.testing.assert_allclose(lse.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [15, 64, 65, 130])
def test_k2_bf16_p_ds_rounding_fits_the_card_tolerance(t, causal):
    """K2's rounding of P and dS to bf16 against ``flash_bwd_reference``
    in fp32 and the Pallas dK/dV kernel (bf16 inputs, fp32 products,
    interpret mode), on the residuals K1's emulation gives."""
    q, k, v, do = bf16_inputs(300 + t + causal, 4, t)
    scale = q.shape[-1] ** -0.5
    o, lse = k1_tc_emulated(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = k2_tc_emulated(q, k, v, do, lse, delta, causal, scale)
    _, dk_ref, dv_ref = port_attn.flash_bwd_reference(
        q.float(), k.float(), v.float(), do.float(), lse, delta,
        causal=causal)
    _, want_dk, want_dv = jax_attn._flash_bwd_call(
        jax_bf16(q), jax_bf16(k), jax_bf16(v), jax_bf16(do),
        jnp.asarray(lse.numpy())[..., None],
        jnp.asarray(delta.numpy())[..., None], causal, scale, t, t, True)
    close(dk.float(), dk_ref, "dk vs fp32 plain")
    close(dv.float(), dv_ref, "dv vs fp32 plain")
    close(dk.float(), want_dk.astype(jnp.float32), "dk vs Pallas")
    close(dv.float(), want_dv.astype(jnp.float32), "dv vs Pallas")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [15, 64, 65, 130])
def test_k3_bf16_ds_rounding_fits_the_card_tolerance(t, causal):
    """K3's rounding of dS to bf16 against ``flash_bwd_reference`` in
    fp32 and the Pallas dQ kernel (bf16 inputs, fp32 dS times K cast to
    fp32, interpret mode), on the residuals K1's emulation gives."""
    q, k, v, do = bf16_inputs(400 + t + causal, 4, t)
    scale = q.shape[-1] ** -0.5
    o, lse = k1_tc_emulated(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    dq = k3_tc_emulated(q, k, v, do, lse, delta, causal, scale)
    dq_ref = port_attn.flash_bwd_reference(
        q.float(), k.float(), v.float(), do.float(), lse, delta,
        causal=causal)[0]
    want_dq = jax_attn._flash_bwd_call(
        jax_bf16(q), jax_bf16(k), jax_bf16(v), jax_bf16(do),
        jnp.asarray(lse.numpy())[..., None],
        jnp.asarray(delta.numpy())[..., None], causal, scale, t, t, True)[0]
    close(dq.float(), dq_ref, "dq vs fp32 plain")
    close(dq.float(), want_dq.astype(jnp.float32), "dq vs Pallas")
