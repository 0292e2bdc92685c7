"""Attention parity: the port's ``mha_reference`` and
``flash_attention``/``flash_attention_fwd`` (CPU: the plain path of
kernel K1) against the JAX package's ``mha_reference`` and its Pallas
flash kernel run in interpret mode.  Same inputs, made with numpy from a
seed; fp32; atol 1e-5 (the two frameworks sum in different orders)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from theanompi_tpu.ops import attention as jax_attn
from theanompi_tpu_torch.ops import attention as port_attn

ATOL = 1e-5
B, H, D = 2, 3, 16


def qkv(seed, t, t_k=None):
    rng = np.random.default_rng(seed)
    t_k = t if t_k is None else t_k
    return (rng.normal(size=(B, H, t, D)).astype(np.float32),
            rng.normal(size=(B, H, t_k, D)).astype(np.float32),
            rng.normal(size=(B, H, t_k, D)).astype(np.float32))


def to_torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def to_jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 24, 33])
def test_mha_reference_matches_jax(causal, t):
    q, k, v = qkv(t, t)
    want = np.asarray(jax_attn.mha_reference(*to_jax(q, k, v),
                                             causal=causal))
    got = port_attn.mha_reference(*to_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_mha_reference_offsets_and_scale_match_jax():
    q, k, v = qkv(3, 8, 12)
    kw = dict(causal=True, q_offset=4, k_offset=0, sm_scale=0.3)
    want = np.asarray(jax_attn.mha_reference(*to_jax(q, k, v), **kw))
    got = port_attn.mha_reference(*to_torch(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 24, 33])
def test_flash_fwd_matches_jax_kernel(causal, t):
    """o and the logsumexp against the Pallas kernel in interpret mode
    (a ragged T runs there as one full-axis block)."""
    q, k, v = qkv(100 + t, t)
    jq, jk, jv = to_jax(q, k, v)
    blk = jax_attn._auto_block(t, jnp.float32) or t
    want_o, want_lse = jax_attn._flash_fwd_call(
        jq, jk, jv, causal, D ** -0.5, blk, blk, True
    )
    o, lse = port_attn.flash_attention_fwd(*to_torch(q, k, v),
                                           causal=causal)
    assert o.shape == (B, H, t, D) and lse.shape == (B, H, t)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(want_lse).reshape(B, H, t), atol=ATOL,
        rtol=0,
    )
    public = jax_attn.flash_attention_tpu(jq, jk, jv, causal=causal,
                                          interpret=True)
    np.testing.assert_allclose(
        port_attn.flash_attention(*to_torch(q, k, v),
                                  causal=causal).numpy(),
        np.asarray(public), atol=ATOL, rtol=0,
    )


def test_flash_attention_takes_strided_views_on_cpu():
    q, k, v = qkv(7, 20)
    tq, tk, tv = to_torch(q, k, v)
    # [B, T, H, D] storage viewed as [B, H, T, D]
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (tq, tk, tv)]
    got = port_attn.flash_attention(*views, causal=True)
    want = port_attn.mha_reference(tq, tk, tv, causal=True)
    assert torch.equal(got, want)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain math: a CPU tensor is an
    error there, and only the dispatcher routes CPU tensors to the
    reference."""
    q, k, v = to_torch(*qkv(1, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_attn.flash_fwd_cuda(q, k, v, True, D ** -0.5)


def test_causal_mask_matches_jax():
    qp, kp = np.arange(3, 8), np.arange(0, 9)
    want = np.asarray(jax_attn.causal_mask(jnp.asarray(qp), jnp.asarray(kp)))
    got = port_attn.causal_mask(torch.from_numpy(qp), torch.from_numpy(kp))
    assert np.array_equal(got.numpy(), want)
    assert port_attn.NEG_INF == jax_attn.NEG_INF
