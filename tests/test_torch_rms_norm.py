"""The serving RMS norm: the plain PyTorch version (``ops/norm.rms_norm``,
which training differentiates and the CPU path runs) against the JAX
``rms_norm`` on the same inputs, the dispatcher the serving decoder
calls (``rms_norm_rows``: the plain version on the CPU), every norm of
a decode, verify and prefill step going through it, and — marked
``cuda``, skipped without a card — the kernel ``csrc/rms_norm.cu``
against the plain version, with a row's output bitwise the same
whether the launch holds 1, 8 or 32 rows.

Tolerances: fp32 1e-6 (absolute plus relative; the mean sums in another
order), bf16 one bf16 ulp of the reference (the fp32 scale may differ in
its last bit, which can round an output the other way).

The JAX package is imported inside the tests that use it, so the card's
machine (no jax) runs this file's card tests with ``python -m pytest
--noconftest -m cuda tests/test_torch_rms_norm.py``."""

import numpy as np
import pytest
import torch

from theanompi_tpu_torch.models import Llama
from theanompi_tpu_torch.ops.norm import rms_norm, rms_norm_cuda, rms_norm_rows

SHAPES = [(8, 256), (32, 256), (3, 5, 64), (1, 4096)]


def inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, w


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``ref`` (fp32): 2**(e - 7)."""
    mag = ref.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def within_one_ulp(got: torch.Tensor, ref: torch.Tensor) -> bool:
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= bf16_ulp(ref)).all())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_jax_fp32(shape):
    import jax.numpy as jnp

    from theanompi_tpu.models.llama import rms_norm as jax_rms_norm

    x, w = inputs(shape, 1)
    ref = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w)))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_jax_bf16_within_one_ulp(shape):
    import jax.numpy as jnp

    from theanompi_tpu.models.llama import rms_norm as jax_rms_norm

    x, w = inputs(shape, 2)
    ref = jax_rms_norm(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(w, jnp.bfloat16))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    got = rms_norm(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    assert within_one_ulp(got, ref)


def test_rows_dispatch_is_the_plain_version_on_the_cpu():
    x, w = inputs((8, 64), 3)
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w)
    assert torch.equal(rms_norm_rows(xt, wt), rms_norm(xt, wt))
    with pytest.raises(ValueError, match="CUDA"):
        rms_norm_cuda(xt, wt.bfloat16())


def test_every_serving_norm_goes_through_the_dispatcher(monkeypatch):
    """2 norms a layer and the final norm: a decode step, a 4-token
    verify step and a prefill chunk each call ``rms_norm_rows`` 2L + 1
    times, each on all of the call's rows."""
    import theanompi_tpu_torch.serving.decoder as decoder_mod

    cfg = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
               vocab=64, seq_len=64, compute_dtype="float32")
    dec = Llama(cfg, device="cpu").make_decoder(
        paged=True, max_slots=2, max_seq=48, block_size=8, prefill_chunk=16)
    rows = []

    def counted(x, w, eps=1e-5):
        rows.append(x.reshape(-1, x.shape[-1]).shape[0])
        return rms_norm(x, w, eps)

    monkeypatch.setattr(decoder_mod, "rms_norm_rows", counted)
    mgr = dec.manager
    mgr.assign(0, [], mgr.blocks_for(12))
    tok = dec.prefill(mgr.tables[0], list(range(1, 9)), 0, 8, 0, 0.0)
    assert rows == [16] * 4 + [1]        # the chunk's rows, then the head
    rows.clear()
    tokens = np.array([int(tok), 0])
    lengths = np.array([8, 0])
    zeros, temps = np.zeros(2, np.int64), np.zeros(2, np.float32)
    dec.decode(tokens, lengths, zeros, temps, mgr.tables,
               np.array([True, False]))
    assert rows == [2] * 5
    rows.clear()
    dec.verify(np.array([[int(tok), 1, 2, 3], [0] * 4]), lengths, zeros,
               temps, mgr.tables, np.array([4, 0]))
    assert rows == [8] * 5


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("shape", [(8, 4096), (32, 4096), (64, 4096),
                                   (5, 8192), (3, 100)], ids=str)
def test_kernel_matches_plain(dev, dtype, shape):
    x, w = inputs(shape, 4)
    xt = torch.from_numpy(x).to(dev, dtype)
    wt = torch.from_numpy(w).to(dev, dtype)
    before = rms_norm_cuda.launches
    got = rms_norm_rows(xt, wt)
    ref = rms_norm(xt, wt)
    torch.cuda.synchronize()
    assert rms_norm_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == xt.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)
    else:
        assert within_one_ulp(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_kernel_row_is_bitwise_the_same_at_1_8_32_rows(dev, dtype):
    x, w = inputs((32, 4096), 5)
    xt = torch.from_numpy(x).to(dev, dtype)
    wt = torch.from_numpy(w).to(dev, dtype)
    full = rms_norm_cuda(xt, wt)
    eight = rms_norm_cuda(xt[:8].contiguous(), wt)
    assert torch.equal(full[:8], eight)
    for r in (0, 7, 8, 31):
        one = rms_norm_cuda(xt[r:r + 1].contiguous(), wt)
        assert torch.equal(full[r:r + 1], one)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(dev):
    x = torch.zeros((2, 16), device=dev)
    with pytest.raises(TypeError):
        rms_norm_cuda(x.half(), torch.ones(16, device=dev).half())
    with pytest.raises(ValueError):         # w of another width
        rms_norm_cuda(torch.zeros((2, 16384), device=dev),
                      torch.ones(8192, device=dev))
    with pytest.raises(ValueError):
        rms_norm_cuda(x.t(), torch.ones(2, device=dev))
