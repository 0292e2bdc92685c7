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
(atol = rtol = 1e-2).

And the fp32 K1, K2 and K3, which take every product on the tensor
cores as three TF32 passes: the split (hi rounded as cvt.rna rounds,
done with integer bit operations; lo = x - hi truncated to TF32) and
the three products emulated on the plain path (K1 with its online
softmax over the kernel's kv tiles, each tile's P V summed from zero
and then added in fp32), held to the fp32 plain versions and the
Pallas kernels within the card's fp32 tolerance (atol = rtol = 1e-4),
and one pass shown to miss a float64 forward and backward by at least
50 times what three passes miss."""

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


# -- the fp32 K2 and K3: three TF32 passes on the tensor cores -----------------

FP32_TOL = dict(atol=1e-4, rtol=1e-4)


def tf32_split(x, trunc=False):
    """(hi, lo) of fp32 ``x`` as ``split_tf32`` in csrc/mma_sm90.cuh
    takes them: hi rounded to a 10-bit mantissa to nearest, ties away
    from zero, as cvt.rna.tf32.f32 rounds (half a TF32 ulp added to the
    bits, the 13 low bits cleared); lo = x - hi in fp32 with its 13 low
    bits cleared (truncated to TF32).  ``trunc``: as the fp32 K1 takes
    them (``split_tf32_trunc``), hi truncated (the 13 low bits cleared)
    and lo = x - hi, truncated as the tensor cores read it."""
    bits = x.contiguous().numpy().view(np.uint32)
    hi = ((bits + np.uint32(0 if trunc else 0x1000))
          & np.uint32(0xffffe000)).view(np.float32)
    lo = ((x.numpy() - hi).view(np.uint32) & np.uint32(0xffffe000)).view(
        np.float32)
    return torch.from_numpy(hi), torch.from_numpy(lo)


def tf32_product(eq, a, b, passes, trunc=False):
    """``einsum(eq, a, b)`` as the fp32 kernels take it on the tensor
    cores: three passes sum lo*hi, hi*lo and hi*hi (TF32 products are
    exact in fp32, the sums fp32); one pass is hi*hi alone.  ``trunc``:
    the operands split as the fp32 K1 splits them."""
    (ah, al), (bh, bl) = tf32_split(a, trunc), tf32_split(b, trunc)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def tf32_bwd_emulated(q, k, v, do, lse, delta, causal, sm_scale, passes=3):
    """K2 (dK, dV) and K3 (dQ) in fp32 with every product taken as
    ``tf32_product`` takes it: S, dP, dV and dK (K2), S, dP and dQ
    (K3), P and dS in fp32 between them.  Returns (dq, dk, dv)."""
    s = tf32_product("bhqd,bhkd->bhqk", q, k, passes) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(port_attn.causal_mask(torch.arange(q.shape[2]),
                                              torch.arange(k.shape[2])),
                        p, 0.0)
    dp = tf32_product("bhqd,bhkd->bhqk", do, v, passes)
    ds = p * (dp - delta[..., None]) * sm_scale
    return (tf32_product("bhqk,bhkd->bhqd", ds, k, passes),
            tf32_product("bhqk,bhqd->bhkd", ds, q, passes),
            tf32_product("bhqk,bhqd->bhkd", p, do, passes))


def fp32_case(seed, t, causal):
    """fp32 q, k, v, dO [1, 2, t, 32] from a seed, with lse and delta
    from the fp32 forward's plain version (K1 fp32's)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(normal(rng, 1, 2, t, 32))
                   for _ in range(4))
    o, lse = port_attn.mha_reference_fwd(q, k, v, causal=causal)
    return q, k, v, do, lse, (do * o).sum(-1)


def pallas_bwd(q, k, v, do, lse, delta, causal, sm_scale):
    """(dq, dk, dv) of the Pallas dK/dV and dQ kernels in interpret mode
    on fp32 inputs and the given residuals."""
    t = q.shape[2]
    return jax_attn._flash_bwd_call(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, do)),
        jnp.asarray(lse.numpy())[..., None],
        jnp.asarray(delta.numpy())[..., None], causal, sm_scale, t, t, True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [15, 64, 65, 130])
def test_k2_fp32_tf32x3_fits_the_card_tolerance(t, causal):
    """K2's three TF32 passes against ``flash_bwd_reference`` in fp32
    and the Pallas dK/dV kernel (fp32, interpret mode), on the residuals
    of the fp32 forward, within the fp32 tolerance of the card's
    check."""
    args = fp32_case(600 + t, t, causal)
    scale = 32 ** -0.5
    _, dk, dv = tf32_bwd_emulated(*args, causal, scale)
    _, dk_ref, dv_ref = port_attn.flash_bwd_reference(*args, causal=causal)
    _, want_dk, want_dv = pallas_bwd(*args, causal, scale)
    for got, want, what in ((dk, dk_ref, "dk vs fp32 plain"),
                            (dv, dv_ref, "dv vs fp32 plain"),
                            (dk, want_dk, "dk vs Pallas"),
                            (dv, want_dv, "dv vs Pallas")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=what, **FP32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [15, 64, 65, 130])
def test_k3_fp32_tf32x3_fits_the_card_tolerance(t, causal):
    """K3's three TF32 passes (S, dP and dQ = dS K) against
    ``flash_bwd_reference`` in fp32 and the Pallas dQ kernel (fp32,
    interpret mode), on the residuals of the fp32 forward, within the
    fp32 tolerance of the card's check."""
    args = fp32_case(700 + t, t, causal)
    scale = 32 ** -0.5
    dq = tf32_bwd_emulated(*args, causal, scale)[0]
    dq_ref = port_attn.flash_bwd_reference(*args, causal=causal)[0]
    want_dq = pallas_bwd(*args, causal, scale)[0]
    for want, what in ((dq_ref, "dq vs fp32 plain"),
                       (want_dq, "dq vs Pallas")):
        np.testing.assert_allclose(dq.numpy(), np.asarray(want),
                                   err_msg=what, **FP32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_one_tf32_pass_is_why_there_are_three(causal):
    """At the same inputs, one TF32 pass (hi*hi) misses the float64
    backward by at least 50 times what three passes miss, in each of
    dq, dk and dv: TF32 keeps a 10-bit mantissa, the three passes about
    fp32's 23 bits."""
    args = fp32_case(800 + causal, 130, causal)
    scale = 32 ** -0.5
    q, k, v, do, lse, delta = (x.double() for x in args)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.tril(p)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, v)
              - delta[..., None]) * scale
    exact = (torch.einsum("bhqk,bhkd->bhqd", ds, k),
             torch.einsum("bhqk,bhqd->bhkd", ds, q),
             torch.einsum("bhqk,bhqd->bhkd", p, do))
    three = tf32_bwd_emulated(*args, causal, scale, passes=3)
    one = tf32_bwd_emulated(*args, causal, scale, passes=1)
    for name, want, a, b in zip(("dq", "dk", "dv"), exact, three, one):
        err3 = (a.double() - want).abs().max().item()
        err1 = (b.double() - want).abs().max().item()
        assert err1 >= 50 * err3, (name, err1, err3)


# -- the fp32 K1: three TF32 passes on the tensor cores ------------------------

XF_BK = 32        # the fp32 K1's kv tile (kXfBK in csrc/flash_fwd.cu)


def tf32_fwd_emulated(q, k, v, causal, sm_scale, passes=3):
    """K1 in fp32 as the three-pass kernel takes it: S = Q K^T and each
    kv tile's P V through ``tf32_product`` with the truncated split of
    ``split_tf32_trunc``, the online softmax over
    XF_BK-key tiles with masked entries exactly 0, each tile's P V
    summed from zero and then added in fp32 (acc = acc*alpha + tile);
    O = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))."""
    b, h, tq, _ = q.shape
    m = torch.full((b, h, tq), port_attn.NEG_INF)
    l = torch.zeros((b, h, tq))
    acc = torch.zeros(q.shape)
    rows = torch.arange(tq)
    for k0 in range(0, k.shape[2], XF_BK):
        kt, vt = k[:, :, k0:k0 + XF_BK], v[:, :, k0:k0 + XF_BK]
        s = tf32_product("bhqd,bhkd->bhqk", q, kt, passes, True) * sm_scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])
            s = torch.where(cols[None, :] <= rows[:, None], s,
                            port_attn.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(s == port_attn.NEG_INF, 0.0,
                        torch.exp(s - m_new[..., None]))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + tf32_product(
            "bhqk,bhkd->bhqd", p, vt, passes, True)
        m = m_new
    den = torch.clamp(l, min=1e-30)
    return acc / den[..., None], m + torch.log(den)


def fp32_qkv(seed, tq, tk=None):
    """fp32 q [1, 2, tq, 32] and k, v [1, 2, tk, 32] from a seed."""
    rng = np.random.default_rng(seed)
    tk = tq if tk is None else tk
    return [torch.from_numpy(normal(rng, 1, 2, t, 32)) for t in (tq, tk, tk)]


def check_k1_fp32(q, k, v, causal):
    """The three-pass K1 against ``mha_reference_fwd`` in fp32 and the
    Pallas forward (fp32, one full-axis block each side, interpret
    mode), O and lse, within the card's fp32 tolerance."""
    scale = q.shape[-1] ** -0.5
    o, lse = tf32_fwd_emulated(q, k, v, causal, scale)
    o_ref, lse_ref = port_attn.mha_reference_fwd(q, k, v, causal=causal)
    want_o, want_lse = jax_attn._flash_fwd_call(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal, scale,
        q.shape[2], k.shape[2], True)
    for got, want, what in ((o, o_ref, "o vs fp32 plain"),
                            (lse, lse_ref, "lse vs fp32 plain"),
                            (o, want_o, "o vs Pallas"),
                            (lse, np.asarray(want_lse).reshape(lse.shape),
                             "lse vs Pallas")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=what, **FP32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [15, 64, 65, 130])
def test_k1_fp32_tf32x3_fits_the_card_tolerance(t, causal):
    """K1's three TF32 passes (S and each tile's P V) against the fp32
    plain version and the Pallas forward, ragged T included."""
    check_k1_fp32(*fp32_qkv(900 + t, t), causal)


@pytest.mark.parametrize("tq, tk", [(40, 100), (100, 40)])
def test_k1_fp32_tf32x3_cross_lengths_full_attention(tq, tk):
    """Tq != Tk, full attention (a ring hop off the diagonal): the kv
    walk ends at Tk, not at the q tile."""
    check_k1_fp32(*fp32_qkv(950 + tq, tq, tk), False)


@pytest.mark.parametrize("causal", [True, False])
def test_one_tf32_pass_is_why_there_are_three_in_the_forward(causal):
    """The forward's O the same way as the backward's gradients: one
    TF32 pass misses the float64 attention by at least 50 times what
    three passes miss."""
    q, k, v = fp32_qkv(980 + causal, 130)
    scale = 32 ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * scale
    if causal:
        s = s.masked_fill(~torch.ones(130, 130, dtype=torch.bool).tril(),
                          float("-inf"))
    exact = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.double())
    three = tf32_fwd_emulated(q, k, v, causal, scale, passes=3)[0]
    one = tf32_fwd_emulated(q, k, v, causal, scale, passes=1)[0]
    err3 = (three.double() - exact).abs().max().item()
    err1 = (one.double() - exact).abs().max().item()
    assert err1 >= 50 * err3, (err1, err3)
