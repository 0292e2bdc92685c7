"""The hand-written CUDA kernels against their plain versions, on the
card, at shapes the serving and training paths do not reach (ragged
and tiny T, every supported head dim, full attention, multi-row query
windows), the tensor-core K1 and K2 (bf16) across their tile edges,
K1, K2 and K3 in fp32 (three TF32 passes on the tensor cores) at every
head dim, bitwise from run to run and from a layout's heads to the
whole launch's, and a small Llama's training steps on the card against
the CPU.
Marked ``cuda``; each test skips where no CUDA device is present.  Run
on the card with ``python -m pytest tests/test_torch_kernels_cuda.py``.

Tolerances: the plain version is evaluated in fp32 on the same inputs;
fp32 kernels differ from it by summation order (atol 1e-4), bf16
kernels also by rounding the output to bf16 and, on the tensor-core
route, P (K1, K2, K4) and dS (K2, K3) before their products (atol
1e-2, rtol 1e-2)."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(1, 16), (15, 32), (64, 64), (65, 128),
                                 (130, 128), (333, 64)])
def test_flash_fwd_matches_reference(dev, dtype, causal, t, d):
    from theanompi_tpu_torch.ops.attention import (
        flash_fwd_cuda,
        mha_reference_fwd,
    )

    gen = torch.Generator(device=dev).manual_seed(t * d)
    q, k, v = (torch.randn((2, 3, t, d), generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    counts = ("launches", "tc_launches", "tf32x3_launches")
    before = [getattr(flash_fwd_cuda, c) for c in counts]
    o, lse = flash_fwd_cuda(q, k, v, causal, d ** -0.5)
    # bf16 takes the bf16 tensor-core kernel, fp32 the three-pass TF32 one
    assert [getattr(flash_fwd_cuda, c) for c in counts] == [
        before[0] + 1, before[1] + (dtype is torch.bfloat16),
        before[2] + (dtype is torch.float32)]
    o_ref, lse_ref = mha_reference_fwd(q.float(), k.float(), v.float(),
                                       causal=causal)
    torch.testing.assert_close(o.float(), o_ref, **TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, **TOL[torch.float32])
    assert o.dtype == dtype and lse.dtype == torch.float32


def test_flash_fwd_cross_lengths_full_attention(dev):
    from theanompi_tpu_torch.ops.attention import (
        flash_fwd_cuda,
        mha_reference_fwd,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, 2, 40, 64), generator=gen, device=dev)
    k, v = (torch.randn((1, 2, 100, 64), generator=gen, device=dev)
            for _ in range(2))
    o, lse = flash_fwd_cuda(q, k, v, False, 0.125)
    o_ref, lse_ref = mha_reference_fwd(q, k, v, causal=False,
                                       sm_scale=0.125)
    torch.testing.assert_close(o, o_ref, **TOL[torch.float32])
    torch.testing.assert_close(lse, lse_ref, **TOL[torch.float32])


def test_flash_fwd_refuses_bad_inputs(dev):
    from theanompi_tpu_torch.ops.attention import flash_fwd_cuda

    x = torch.zeros((1, 2, 8, 48), device=dev)
    with pytest.raises(ValueError, match="head dims"):
        flash_fwd_cuda(x, x, x, True, 1.0)
    y = torch.zeros((1, 2, 8, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_fwd_cuda(y, y, y, True, 1.0)
    z = torch.zeros((1, 8, 2, 64), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd_cuda(z, z, z, True, 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(1, 16), (15, 32), (64, 64), (65, 128),
                                 (130, 128), (333, 64)])
def test_flash_bwd_matches_reference(dev, dtype, causal, t, d):
    """K2 (dk, dv) and K3 (dq) against ``flash_bwd_reference`` in fp32
    on the same inputs and residuals; each launch counted once, on its
    dtype's route (bf16: ``.tc_launches``, fp32: ``.tf32x3_launches``)."""
    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_reference,
        flash_fwd_cuda,
    )

    gen = torch.Generator(device=dev).manual_seed(t * d + 1)
    q, k, v, do = (torch.randn((2, 3, t, d), generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    o, lse = flash_fwd_cuda(q, k, v, causal, d ** -0.5)
    delta = (do.float() * o.float()).sum(-1)
    fns = (flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    before = [(f.launches, f.tc_launches, f.tf32x3_launches) for f in fns]
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, d ** -0.5)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, d ** -0.5)
    tc = int(dtype is torch.bfloat16)
    assert [(f.launches, f.tc_launches, f.tf32x3_launches) for f in fns] \
        == [(n + 1, c + tc, x + 1 - tc) for n, c, x in before]
    want = flash_bwd_reference(q.float(), k.float(), v.float(), do.float(),
                               lse, delta, causal=causal)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), ref, **TOL[dtype])


def test_flash_bwd_is_deterministic_and_takes_cross_lengths(dev):
    """Full attention with Tq != Tk, twice: bitwise the same (each
    output tile has one owner, no atomics)."""
    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_cuda,
        flash_bwd_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    q, do = (torch.randn((1, 2, 40, 64), generator=gen, device=dev)
             for _ in range(2))
    k, v = (torch.randn((1, 2, 100, 64), generator=gen, device=dev)
            for _ in range(2))
    lse = torch.randn((1, 2, 40), generator=gen, device=dev) + 5.0
    delta = torch.randn((1, 2, 40), generator=gen, device=dev)
    a = flash_bwd_cuda(q, k, v, do, lse, delta, False, 0.125)
    b = flash_bwd_cuda(q, k, v, do, lse, delta, False, 0.125)
    want = flash_bwd_reference(q, k, v, do, lse, delta, causal=False,
                               sm_scale=0.125)
    for x, y, ref in zip(a, b, want):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, ref, **TOL[torch.float32])


def test_flash_bwd_refuses_bad_inputs(dev):
    from theanompi_tpu_torch.ops.attention import flash_bwd_cuda

    x = torch.zeros((1, 2, 8, 64), device=dev)
    r = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="head dims"):
        y = torch.zeros((1, 2, 8, 48), device=dev)
        flash_bwd_cuda(y, y, y, y, r, r, True, 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        y = x.half()
        flash_bwd_cuda(y, y, y, y, r, r, True, 1.0)
    with pytest.raises(ValueError, match="lse and delta"):
        flash_bwd_cuda(x, x, x, x, r.double(), r, True, 1.0)
    with pytest.raises(ValueError, match="lse and delta"):
        flash_bwd_cuda(x, x, x, x, r[..., :4], r, True, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        z = torch.zeros((1, 8, 2, 64), device=dev).transpose(1, 2)
        flash_bwd_cuda(z, x, x, x, r, r, True, 1.0)


# the tensor-core K1, K2 and K3 (bf16): T across their 64-row tiles (K2
# walks 32-row q tiles) and the serving length, every head dim
TC_TS = (1, 15, 63, 64, 65, 127, 128, 129, 2047)
TC_DS = (16, 32, 64, 128)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", TC_DS)
@pytest.mark.parametrize("t", TC_TS)
def test_tc_flash_fwd_bf16_matches_reference(dev, t, d, causal):
    from theanompi_tpu_torch.ops.attention import (
        flash_fwd_cuda,
        mha_reference_fwd,
    )

    gen = torch.Generator(device=dev).manual_seed(7 * t + d)
    q, k, v = (torch.randn((1, 2, t, d), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    before = flash_fwd_cuda.tc_launches
    o, lse = flash_fwd_cuda(q, k, v, causal, d ** -0.5)
    assert flash_fwd_cuda.tc_launches == before + 1
    o_ref, lse_ref = mha_reference_fwd(q.float(), k.float(), v.float(),
                                       causal=causal)
    torch.testing.assert_close(o.float(), o_ref, **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, lse_ref, **TOL[torch.float32])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", TC_DS)
@pytest.mark.parametrize("t", TC_TS)
def test_tc_flash_bwd_dkv_bf16_matches_reference(dev, t, d, causal):
    """K2 (dK, dV) and K3 (dQ) on the tensor cores against the fp32
    plain version, each launch on its tensor-core route."""
    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_reference,
        flash_fwd_cuda,
    )

    gen = torch.Generator(device=dev).manual_seed(7 * t + d + 1)
    q, k, v, do = (torch.randn((1, 2, t, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = flash_fwd_cuda(q, k, v, causal, d ** -0.5)
    delta = (do.float() * o.float()).sum(-1)
    before = flash_bwd_dkv_cuda.tc_launches, flash_bwd_dq_cuda.tc_launches
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, d ** -0.5)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, d ** -0.5)
    assert (flash_bwd_dkv_cuda.tc_launches,
            flash_bwd_dq_cuda.tc_launches) == (before[0] + 1, before[1] + 1)
    refs = flash_bwd_reference(q.float(), k.float(), v.float(), do.float(),
                               lse, delta, causal=causal)
    for got, ref in zip((dq, dk, dv), refs):
        torch.testing.assert_close(got.float(), ref, **TOL[torch.bfloat16])


def test_tc_flash_bwd_dq_is_deterministic_at_the_training_length(dev):
    """K3 on the tensor cores, causal at T = 2048, twice: bitwise the
    same (each dQ tile has one owner, no atomics)."""
    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dq_cuda,
        flash_fwd_cuda,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v, do = (torch.randn((1, 4, 2048, 128), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
    delta = (do.float() * o.float()).sum(-1)
    a = flash_bwd_dq_cuda(q, k, v, do, lse, delta, True, 128 ** -0.5)
    b = flash_bwd_dq_cuda(q, k, v, do, lse, delta, True, 128 ** -0.5)
    assert torch.equal(a, b)


@pytest.mark.parametrize("tq,tk", [(40, 100), (130, 65), (1, 129)])
def test_tc_cross_lengths_full_attention(dev, tq, tk):
    """bf16 full attention with Tq != Tk through the three tensor-core
    kernels; K2 and K3 twice, bitwise the same (one owner per output
    tile)."""
    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_reference,
        flash_fwd_cuda,
        mha_reference_fwd,
    )

    gen = torch.Generator(device=dev).manual_seed(tq + tk)
    q, do = (torch.randn((1, 2, tq, 64), generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, 2, tk, 64), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    o, lse = flash_fwd_cuda(q, k, v, False, 0.125)
    o_ref, lse_ref = mha_reference_fwd(q.float(), k.float(), v.float(),
                                       causal=False, sm_scale=0.125)
    torch.testing.assert_close(o.float(), o_ref, **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, lse_ref, **TOL[torch.float32])
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, False, 0.125)
    a = (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
    b = (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
    want = flash_bwd_reference(q.float(), k.float(), v.float(), do.float(),
                               lse, delta, causal=False, sm_scale=0.125)
    for x, y, ref in zip(a, b, want):
        assert torch.equal(x, y)
        torch.testing.assert_close(x.float(), ref, **TOL[torch.bfloat16])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", TC_DS)
@pytest.mark.parametrize("t", TC_TS)
def test_tf32x3_flash_bwd_fp32_matches_reference(dev, t, d, causal):
    """K2 (dK, dV) and K3 (dQ) in fp32, three TF32 passes on the tensor
    cores, against the plain version within the fp32 tolerance, every
    launch on that route (``.tf32x3_launches``), none on the bf16
    kernel's."""
    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_reference,
        flash_fwd_cuda,
    )

    gen = torch.Generator(device=dev).manual_seed(5 * t + d)
    q, k, v, do = (torch.randn((1, 2, t, d), generator=gen, device=dev)
                   for _ in range(4))
    o, lse = flash_fwd_cuda(q, k, v, causal, d ** -0.5)
    delta = (do * o).sum(-1)
    fns = (flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    before = [(f.tf32x3_launches, f.tc_launches) for f in fns]
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, d ** -0.5)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, d ** -0.5)
    assert [(f.tf32x3_launches, f.tc_launches) for f in fns] \
        == [(x + 1, c) for x, c in before]
    refs = flash_bwd_reference(q, k, v, do, lse, delta, causal=causal)
    for got, ref in zip((dq, dk, dv), refs):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, ref, **TOL[torch.float32])


def fp32_bwd_case(dev, h, t, seed):
    from theanompi_tpu_torch.ops.attention import flash_fwd_cuda

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((1, h, t, 128), generator=gen, device=dev)
                   for _ in range(4))
    o, lse = flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
    return q, k, v, do, lse, (do * o).sum(-1)


def test_tf32x3_flash_bwd_is_bitwise_at_the_serving_length(dev):
    """fp32 K2 and K3 at [1, 32, 2047, 128] causal, twice: bitwise the
    same (one owner per output tile, no atomics)."""
    from theanompi_tpu_torch.ops.attention import flash_bwd_cuda

    args = fp32_bwd_case(dev, 32, 2047, 19)
    a = flash_bwd_cuda(*args, True, 128 ** -0.5)
    b = flash_bwd_cuda(*args, True, 128 ** -0.5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("t", [65, 2047])
def test_tf32x3_flash_bwd_heads_of_a_layout_rank_are_bitwise(dev, t):
    """A tp = 2 rank's [1, 16, T, 128] launch gives bitwise the rows of
    the matching 16 heads of the one-rank [1, 32, T, 128] launch: a
    head's rows never depend on the other heads."""
    from theanompi_tpu_torch.ops.attention import flash_bwd_cuda

    whole = fp32_bwd_case(dev, 32, t, 23)
    full = flash_bwd_cuda(*whole, True, 128 ** -0.5)
    for h0 in (0, 16):
        part = [x[:, h0:h0 + 16].contiguous() for x in whole]
        for x, y in zip(flash_bwd_cuda(*part, True, 128 ** -0.5), full):
            assert torch.equal(x, y[:, h0:h0 + 16])


def fp32_fwd_case(dev, h, t, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((1, h, t, 128), generator=gen, device=dev)
            for _ in range(3)]


def test_tf32x3_flash_fwd_is_bitwise_at_the_serving_length(dev):
    """fp32 K1 at [1, 32, 2047, 128] causal, twice: o and lse bitwise
    the same (one owner per output row, no atomics)."""
    from theanompi_tpu_torch.ops.attention import flash_fwd_cuda

    q, k, v = fp32_fwd_case(dev, 32, 2047, 29)
    a = flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
    b = flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("t", [65, 2047])
def test_tf32x3_flash_fwd_heads_of_a_layout_rank_are_bitwise(dev, t):
    """A tp = 2 rank's [1, 16, T, 128] fp32 K1 launch gives bitwise the
    o and lse rows of the matching 16 heads of the one-rank [1, 32, T,
    128] launch (serving_tp's fp32 ids and the fp32 layouts rely on
    it)."""
    from theanompi_tpu_torch.ops.attention import flash_fwd_cuda

    whole = fp32_fwd_case(dev, 32, t, 31)
    full = flash_fwd_cuda(*whole, True, 128 ** -0.5)
    for h0 in (0, 16):
        part = [x[:, h0:h0 + 16].contiguous() for x in whole]
        for x, y in zip(flash_fwd_cuda(*part, True, 128 ** -0.5), full):
            assert torch.equal(x, y[:, h0:h0 + 16])


@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_flash_fwd_takes_sm_scale_of_either_sign(dev, causal):
    """fp32 K1 scales each score before the row max, so a negative
    sm_scale (and zero) gives the plain version's o and lse."""
    from theanompi_tpu_torch.ops.attention import (
        flash_fwd_cuda,
        mha_reference_fwd,
    )

    q, k, v = (x[:, :, :100, :64].contiguous()
               for x in fp32_fwd_case(dev, 2, 100, 37))
    for scale in (-0.125, 0.0):
        o, lse = flash_fwd_cuda(q, k, v, causal, scale)
        o_ref, lse_ref = mha_reference_fwd(q, k, v, causal=causal,
                                           sm_scale=scale)
        torch.testing.assert_close(o, o_ref, **TOL[torch.float32])
        torch.testing.assert_close(lse, lse_ref, **TOL[torch.float32])


def test_tf32x3_flash_fwd_refuses_unaligned_fp32(dev):
    """fp32 K1 copies rows 16 bytes at a time: an fp32 view that starts
    off a 16-byte boundary is refused, not misread."""
    from theanompi_tpu_torch.ops.attention import flash_fwd_cuda

    x = torch.zeros(2 * 8 * 64 + 1, device=dev)[1:].view(1, 2, 8, 64)
    with pytest.raises(ValueError, match="aligned float32"):
        flash_fwd_cuda(x, x, x, True, 0.125)


def test_tf32x3_kernels_refuse_unaligned_fp32(dev):
    """fp32 K2 and K3 copy rows 16 bytes at a time: an fp32 view that
    starts off a 16-byte boundary is refused, not misread."""
    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_cuda,
        flash_bwd_dq_cuda,
    )

    n = 2 * 8 * 64
    x = torch.zeros(n + 1, device=dev)[1:].view(1, 2, 8, 64)
    r = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="aligned float32"):
        flash_bwd_cuda(x, x, x, x, r, r, True, 1.0)
    with pytest.raises(ValueError, match="aligned float32"):
        flash_bwd_dq_cuda(x, x, x, x, r, r, True, 1.0)


def test_tc_kernels_refuse_what_they_cannot_take(dev):
    """The tensor-core kernels copy 16-byte chunks: a bf16 view that
    starts off a 16-byte boundary is refused, not misread."""
    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_cuda,
        flash_bwd_dq_cuda,
        flash_fwd_cuda,
    )

    n = 2 * 8 * 64
    x = torch.zeros(n + 1, device=dev, dtype=torch.bfloat16)[1:]
    x = x.view(1, 2, 8, 64)
    r = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="aligned"):
        flash_fwd_cuda(x, x, x, True, 1.0)
    with pytest.raises(ValueError, match="aligned"):
        flash_bwd_cuda(x, x, x, x, r, r, True, 1.0)
    with pytest.raises(ValueError, match="aligned"):
        flash_bwd_dq_cuda(x, x, x, x, r, r, True, 1.0)


@pytest.mark.parametrize("causal", [True, False])
def test_tc_kernels_take_sm_scale_of_either_sign(dev, causal):
    """bf16 K1 at sm_scale -0.125 and 0 (launched as -Q at 0.125 and as
    Q = 0 at 1: the same S*scale) gives the plain version's o and lse;
    K2 and K3 read lse and mask P after the scale, so they take both
    scales as they are.  Each launch on the bf16 tensor-core route."""
    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_reference,
        flash_fwd_cuda,
        mha_reference_fwd,
    )

    gen = torch.Generator(device=dev).manual_seed(38)
    q, k, v, do = (torch.randn((1, 2, 100, 64), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    fns = (flash_fwd_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    for scale in (-0.125, 0.0):
        before = [(f.launches, f.tc_launches) for f in fns]
        o, lse = flash_fwd_cuda(q, k, v, causal, scale)
        o_ref, lse_ref = mha_reference_fwd(q.float(), k.float(), v.float(),
                                           causal=causal, sm_scale=scale)
        torch.testing.assert_close(o.float(), o_ref, **TOL[torch.bfloat16])
        torch.testing.assert_close(lse, lse_ref, **TOL[torch.float32])
        delta = (do.float() * o.float()).sum(-1)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
        assert [(f.launches, f.tc_launches) for f in fns] == [
            (n + 1, c + 1) for n, c in before]
        want = flash_bwd_reference(q.float(), k.float(), v.float(),
                                   do.float(), lse, delta, causal=causal,
                                   sm_scale=scale)
        for got, ref in zip((dq, dk, dv), want):
            torch.testing.assert_close(got.float(), ref,
                                       **TOL[torch.bfloat16])

def test_llama_training_on_the_card_matches_the_cpu(dev, tmp_path):
    """Three BSP steps of a small fp32 Llama on the card (K1-K3, cuBLAS,
    a one-rank NCCL group) and on the CPU (plain versions, gloo), both
    resuming from one seeded initial checkpoint: per-step losses within
    rtol 1e-4 (fp32 summation order on two devices, carried through
    Adam)."""
    import shutil

    import numpy as np

    from theanompi_tpu_torch.models.llama import save_init_checkpoint
    from theanompi_tpu_torch.workers import bsp_worker

    cfg = dict(dim=128, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256,
               vocab=128, seq_len=64, batch_size=2, n_train=6, n_val=2,
               compute_dtype="float32", seed=3, lr=1e-3)
    save_init_checkpoint(cfg, tmp_path / "init")
    losses = []
    for device in (0, "cpu"):
        d = tmp_path / str(device)
        shutil.copytree(tmp_path / "init", d)
        out = bsp_worker.run(
            devices=[device], modelfile="theanompi_tpu_torch.models.llama",
            modelclass="Llama", config=cfg, n_epochs=1, verbose=False,
            checkpoint_dir=str(d), resume=True)
        losses.append(out["recorder"].train_losses)
    assert len(losses[0]) == 3
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)


def paged_inputs(dev, dtype, *, s, nq, hkv, rep, hd, bs, mb, seed,
                 pos=None):
    rng = np.random.default_rng(seed)
    n_blocks = s * mb + 3
    if pos is None:
        pos = rng.integers(0, mb * bs, size=(s, nq)).astype(np.int32)
        pos[0, 0] = bs - 1          # on a block edge
    pos = np.asarray(pos, np.int32)
    perm = rng.permutation(n_blocks)
    tables = np.full((s, mb), n_blocks, np.int32)          # trash id
    used = 0
    for i in range(s):
        n = int(pos[i].max()) // bs + 1
        tables[i, :n] = perm[used:used + n]
        used += n
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return (rnd(s, nq, hkv, rep, hd), rnd(n_blocks + 1, hkv, bs, hd),
            rnd(n_blocks + 1, hkv, bs, hd),
            torch.as_tensor(tables, device=dev),
            torch.as_tensor(pos, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,rep,hkv,hd,bs,mb", [
    (1, 4, 8, 128, 16, 8),      # decode, the 8B grouping
    (1, 1, 2, 64, 4, 5),        # one row per (slot, kv head)
    (3, 2, 2, 32, 8, 4),        # verify-shaped window, Q > 1
    (4, 4, 1, 128, 16, 16),     # 16 rows: one full row group
    (5, 4, 2, 128, 16, 8),      # 20 rows: a second, partial group
    (8, 4, 4, 128, 16, 8),      # 32 rows: speculate_k = 8 at rep 4
    (16, 4, 1, 64, 8, 12),      # 64 rows: four groups
    (9, 2, 3, 32, 4, 6),        # 18 rows at rep 2, odd kv heads
])
def test_paged_attend_matches_gather_path(dev, dtype, nq, rep, hkv, hd,
                                          bs, mb):
    from theanompi_tpu_torch.serving.paged_attention import (
        paged_attend_cuda,
        paged_attend_reference,
    )

    q, kp, vp, tables, pos = paged_inputs(
        dev, dtype, s=3, nq=nq, hkv=hkv, rep=rep, hd=hd, bs=bs, mb=mb,
        seed=nq * 100 + hd,
    )
    counts = ("launches", "tc_launches", "tf32x3_launches")
    before = [getattr(paged_attend_cuda, c) for c in counts]
    out = paged_attend_cuda(q, kp, vp, tables, pos)
    # bf16 takes the bf16 tensor-core split kernel, fp32 the three-pass
    # TF32 one
    assert [getattr(paged_attend_cuda, c) for c in counts] == [
        before[0] + 1, before[1] + (dtype is torch.bfloat16),
        before[2] + (dtype is torch.float32)]
    ref = paged_attend_reference(q.float(), kp.float(), vp.float(),
                                 tables, pos)
    torch.testing.assert_close(out.float(), ref, **TOL[dtype])


def test_paged_attend_refuses_bad_inputs(dev):
    """What K4 still refuses: a head dim it has no tile for, q and pools
    of two dtypes, int64 tables.  (Any number of query rows runs: the
    rows of a (slot, kv head) are cut into groups of 16.)"""
    from theanompi_tpu_torch.serving.paged_attention import (
        paged_attend_cuda,
    )

    q, kp, vp, tables, pos = paged_inputs(
        dev, torch.float32, s=1, nq=5, hkv=1, rep=4, hd=32, bs=4, mb=2,
        seed=0,
    )
    with pytest.raises(TypeError):
        paged_attend_cuda(q.bfloat16(), kp, vp, tables, pos)
    with pytest.raises(TypeError):
        paged_attend_cuda(q, kp, vp, tables.long(), pos)
    q48 = torch.zeros((1, 5, 1, 4, 48), device=dev)
    kp48 = torch.zeros((kp.shape[0], 1, 4, 48), device=dev)
    with pytest.raises(ValueError, match="head dims"):
        paged_attend_cuda(q48, kp48, kp48, tables, pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attend_groups_are_independent_rows(dev, dtype):
    """A row's result does not depend on how many rows ride with it: the
    first 16 rows of a 32-row window are bitwise the 16-row launch's
    (group 0 is the single-group launch; later groups only add CTAs)."""
    from theanompi_tpu_torch.serving.paged_attention import (
        paged_attend_cuda,
    )

    q, kp, vp, tables, pos = paged_inputs(
        dev, dtype, s=2, nq=8, hkv=2, rep=4, hd=128, bs=16, mb=20, seed=7,
    )
    pos = pos.clone()
    pos[:, 4:] = pos[:, :4]                # rows 16-31 repeat 0-15's
    full = paged_attend_cuda(q, kp, vp, tables, pos)
    half = paged_attend_cuda(q[:, :4].contiguous(), kp, vp, tables,
                             pos[:, :4].contiguous())
    assert torch.equal(full[:, :4], half)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq", [1, 4])
def test_paged_attend_heads_of_a_tp_rank_are_bitwise(dev, dtype, nq):
    """A tp = 2 rank's 4 kv heads (its halves of q and the pools) give
    bitwise the 8-head launch's outputs of those heads: a CTA reads one
    kv head, whatever the others."""
    from theanompi_tpu_torch.serving.paged_attention import (
        paged_attend_cuda,
    )

    (q, kp, vp, tables, pos), out = paged_check(
        dev, dtype, s=4, nq=nq, hkv=8, rep=4, hd=128, bs=16, mb=40,
        seed=11)
    for h0 in (0, 4):
        rank = paged_attend_cuda(
            q[:, :, h0:h0 + 4].contiguous(), kp[:, h0:h0 + 4].contiguous(),
            vp[:, h0:h0 + 4].contiguous(), tables, pos)
        assert torch.equal(rank, out[:, :, h0:h0 + 4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_past_8192_matches_plain(dev, dtype):
    """The norm kernel at d = 16384 (each thread strides over the row):
    bf16 bitwise its plain version, fp32 within 1e-6, and a row the same
    bits at 1, 8 and 32 rows."""
    from theanompi_tpu_torch.ops.norm import rms_norm, rms_norm_cuda

    gen = torch.Generator(device=dev).manual_seed(16384)
    x = torch.randn((32, 16384), generator=gen, device=dev).to(dtype)
    w = (1.0 + 0.1 * torch.randn(16384, generator=gen, device=dev)) \
        .to(dtype)
    out = rms_norm_cuda(x, w)
    ref = rms_norm(x, w)
    if dtype is torch.bfloat16:
        # the plain version's fp32 mean sums in another order: at most
        # one bf16 ulp apart where the two scales round apart
        torch.testing.assert_close(out.float(), ref.float(), atol=0,
                                   rtol=2 ** -7)
    else:
        torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
    assert torch.equal(out[:8], rms_norm_cuda(x[:8].contiguous(), w))
    for r in (0, 9, 31):
        assert torch.equal(out[r:r + 1],
                           rms_norm_cuda(x[r:r + 1].contiguous(), w))


def test_paged_decoder_on_the_card_matches_the_cpu(dev):
    """A small fp32 model: the paged decoder's greedy ids through K4 on
    the card equal the gather path's on the CPU."""
    from theanompi_tpu_torch.models import Llama
    from theanompi_tpu_torch.serving import Engine

    cfg = dict(dim=128, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256,
               vocab=128, seq_len=128, compute_dtype="float32", seed=3)
    gpu = Llama(cfg, device=dev)
    cpu = Llama(cfg, device="cpu", params={
        "embed": gpu.params["embed"].cpu(),
        "layers": [{k: t.cpu() for k, t in lp.items()}
                   for lp in gpu.params["layers"]],
        "final_norm": gpu.params["final_norm"].cpu(),
        "lm_head": gpu.params["lm_head"].cpu(),
    })
    prompts = [[1, 2, 3, 4, 5], list(range(7, 40)), [9] * 20]
    ids = []
    for model in (gpu, cpu):
        eng = Engine(model.make_decoder(paged=True, max_slots=2,
                                        max_seq=96, block_size=8,
                                        prefill_chunk=16))
        futs = [eng.submit(p, max_tokens=10) for p in prompts]
        eng.run_until_idle()
        ids.append([f.result(timeout=0).tokens for f in futs])
    assert ids[0] == ids[1]


def paged_check(dev, dtype, ctas=None, **shape):
    """K4 on the inputs ``paged_inputs`` makes, against the gather path
    evaluated in fp32; returns the inputs and the kernel's output."""
    from theanompi_tpu_torch.serving.paged_attention import (
        paged_attend_cuda,
        paged_attend_reference,
    )

    args = paged_inputs(dev, dtype, **shape)
    out = paged_attend_cuda(*args, ctas=ctas)
    ref = paged_attend_reference(*(a.float() if a.is_floating_point() else a
                                   for a in args))
    torch.testing.assert_close(out.float(), ref, **TOL[dtype])
    return args, out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attend_takes_a_16_row_8192_position_window(dev, dtype):
    """16 query rows over Llama-3-8B's 8192 positions: the split kernel's
    shared memory does not grow with the window."""
    paged_check(dev, dtype, s=2, nq=4, hkv=2, rep=4, hd=128, bs=16, mb=512,
                seed=5, pos=[[8191, 8190, 4000, 0], [8191, 8191, 8191, 8191]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [4, 8, 16])
def test_paged_attend_positions_on_split_edges(dev, dtype, bs):
    """Rows whose last position is the last of a split, the first of the
    next, one past it, and a window shorter than one split; the split
    kernel's CTA counter sees every split launched and, per slot and kv
    head, the splits up to the slot's last position live."""
    from theanompi_tpu_torch.serving.paged_attention import split_len

    n = split_len()
    pos = [[n - 1, n, n + 1, 2 * n - 1], [2 * n, 2 * n + 1, 0, 1],
           [5, 17, n - 2, 2], [3 * n - 1, 3 * n - 1, 3 * n - 1, 3 * n - 1]]
    ctas = torch.zeros(2, dtype=torch.int32, device=dev)
    paged_check(dev, dtype, ctas, s=4, nq=4, hkv=2, rep=2, hd=64, bs=bs,
                mb=3 * n // bs, seed=bs, pos=pos)
    live = sum(max(p) // n + 1 for p in pos) * 2
    assert ctas.tolist() == [3 * 2 * 4, live]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attend_is_deterministic_and_batch_invariant(dev, dtype):
    """Two runs agree bit for bit, and each slot's output of a batched
    call equals that slot's call alone bit for bit (the splits depend
    on positions only)."""
    from theanompi_tpu_torch.serving.paged_attention import (
        paged_attend_cuda,
    )

    (q, kp, vp, tables, pos), out = paged_check(
        dev, dtype, s=5, nq=1, hkv=8, rep=4, hd=128, bs=16, mb=64, seed=9,
        pos=[[1023], [0], [255], [256], [700]])
    assert torch.equal(out, paged_attend_cuda(q, kp, vp, tables, pos))
    for i in range(q.shape[0]):
        alone = paged_attend_cuda(q[i:i + 1], kp, vp, tables[i:i + 1],
                                  pos[i:i + 1])
        assert torch.equal(alone[0], out[i])


NCCL_CHILD = """
import sys
import torch
sys.path.insert(0, {root!r})
from theanompi_tpu_torch.parallel.mesh import init_group
try:
    init_group(torch.device("cuda", 0), int(sys.argv[1]), 2, {init!r})
except ValueError as e:
    print("refused:", e)
    sys.exit(3)
"""


def test_nccl_refuses_two_ranks_on_one_card(dev, tmp_path):
    """Two ranks naming card 0 under NCCL: both raise a clear error
    before any process group is made (gloo is the way to share a
    card)."""
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "child.py"
    script.write_text(NCCL_CHILD.format(
        root=str(Path(__file__).resolve().parent.parent),
        init=f"tcp://127.0.0.1:{port}"))
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [3, 3], outs
    assert all("share a card under nccl" in o for o in outs), outs
