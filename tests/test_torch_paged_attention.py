"""Paged-attention parity: the port's ``paged_attend`` (CPU: the gather
path, the plain version of kernel K4) against the JAX package's gather
oracle and its Pallas kernel in interpret mode.  Covers the block-table
hazards: positions on block edges, trash-padded tables, multi-row query
windows (Q > 1) and the degenerate single-head shape.  fp32, atol 1e-5
(the two frameworks sum in different orders).

Last, the card's split-and-combine arithmetic (flash-decoding: per
split an online softmax over tiles, for bf16 pools P rounded to bf16
before P V, for fp32 pools every product in three TF32 passes, the
splits merged in order), emulated with torch ops and held to the same
two JAX references within the card's tolerances (atol = rtol = 1e-4
fp32, 1e-2 bf16): the split and the TF32 passes change the result, so
the emulation states how far."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from theanompi_tpu.serving.paged_attention import paged_attend as jax_paged
from theanompi_tpu_torch.ops.attention import NEG_INF
from theanompi_tpu_torch.serving.paged_attention import (
    gather_blocks,
    paged_attend,
    paged_attend_cuda,
    paged_attend_reference,
)

from test_paged_attention import gather_oracle, make_case
from test_torch_flash_bwd import tf32_product

pytestmark = pytest.mark.serving

ATOL = 1e-5


def both(case):
    """(JAX gather oracle, JAX kernel in interpret mode, port) outputs."""
    oracle = np.asarray(gather_oracle(*case))
    kernel = np.asarray(jax_paged(*case, interpret=True))
    got = paged_attend(*[torch.tensor(np.asarray(a)) for a in case])
    return oracle, kernel, got.numpy()


def assert_parity(case):
    oracle, kernel, got = both(case)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)


def test_random_tables_and_positions():
    assert_parity(make_case(np.random.default_rng(0)))


def test_block_boundary_positions():
    bs, mb = 4, 4
    edges = [0, bs - 1, bs, bs + 1, 2 * bs - 1, mb * bs - 1]
    pos = np.array([edges[:2], edges[2:4], edges[4:]], np.int32)
    assert_parity(make_case(np.random.default_rng(1), s=3, nq=2, bs=bs,
                            mb=mb, pos=pos))


def test_trash_padded_tables_are_masked():
    bs, mb, n_blocks = 4, 4, 9
    tables = np.full((3, mb), n_blocks, np.int64)     # trash id
    tables[0, :1] = [0]
    tables[1, :2] = [3, 1]
    tables[2, :4] = [2, 5, 7, 8]
    pos = np.array([[0, 1], [5, 7], [12, 15]], np.int32)
    assert_parity(make_case(np.random.default_rng(2), bs=bs, mb=mb,
                            n_blocks=n_blocks, tables=tables, pos=pos))


@pytest.mark.parametrize("nq,rep,hkv", [(1, 1, 1), (4, 1, 1), (1, 4, 2),
                                        (3, 2, 2)])
def test_query_window_shapes(nq, rep, hkv):
    """Q = 1 (decode) and Q > 1 (verify-shaped windows), GQA groups of
    1-4 rows, one or two kv heads."""
    assert_parity(make_case(np.random.default_rng(10 + nq * rep), nq=nq,
                            rep=rep, hkv=hkv))


def test_output_dtype_and_shape():
    case = make_case(np.random.default_rng(5))
    got = paged_attend(*[torch.tensor(np.asarray(a)) for a in case])
    assert got.shape == tuple(case[0].shape)
    assert got.dtype == torch.float32


def test_gather_blocks_position_order():
    """Row t of the gathered window is pool[table[t // bs], :, t % bs]."""
    rng = np.random.default_rng(6)
    pool = torch.from_numpy(rng.normal(size=(7, 2, 4, 3)).astype(np.float32))
    tables = torch.tensor([[3, 0, 6], [5, 5, 1]], dtype=torch.int32)
    g = gather_blocks(pool, tables)
    assert g.shape == (2, 2, 12, 3)
    for s in range(2):
        for t in range(12):
            want = pool[tables[s, t // 4], :, t % 4]
            assert torch.equal(g[s, :, t], want)
    assert torch.equal(gather_blocks(pool, tables[1]), g[1])


def test_kernel_wrapper_refuses_cpu_tensors():
    case = [torch.tensor(np.asarray(a))
            for a in make_case(np.random.default_rng(3))]
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_attend_cuda(*case)


def test_jax_tables_dtype_is_accepted():
    """Tables arrive as int32 from the block manager and as int64 from
    numpy defaults; the gather path takes both."""
    case = make_case(np.random.default_rng(4))
    args = [torch.tensor(np.asarray(a)) for a in case]
    a = paged_attend(*args)
    args[3] = args[3].long()
    assert torch.equal(paged_attend(*args), a)
    assert jnp.int32 == case[3].dtype


# -- the card's split-and-combine arithmetic (K4) ------------------------------

SPLIT = 256            # positions per split (kSplit in csrc/paged_attend.cu)
# (positions per tile, positions per warp and tile, warps): bf16 runs 4
# warps of 16 positions on each 64-position tile, fp32 (three TF32
# passes) 4 warps of 8 positions on each 32-position tile (kXTile, kXPos
# and kXWarps in csrc/paged_attend.cu)
WALK = {torch.bfloat16: (64, 16, 4), torch.float32: (32, 8, 4)}
LOG2E = 1.4426950408889634
CARD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


def merge(states):
    """(o, m, l) states merged in list order with exp2(m - M) weights."""
    big = states[0][1]
    for _, m, _ in states[1:]:
        big = torch.maximum(big, m)
    o = torch.zeros_like(states[0][0])
    l = torch.zeros_like(states[0][2])
    for oj, mj, lj in states:
        w = torch.exp2(mj - big)
        o = o + w[..., None] * oj
        l = l + w * lj
    return o, big, l


def k4_emulated(q, kp, vp, tables, pos, passes=3):
    """K4's arithmetic on the card for q [S, Q, Hkv, rep, hd] and pools of
    one dtype: scores in log2 units (scale*log2e) in fp32, masked entries'
    P exactly 0; each split of SPLIT positions walks its tiles with an
    online softmax per warp slice, rounding P to the pool dtype before
    P V for bf16; fp32 takes S = Q K^T and each tile's P V (summed from
    zero, then added to the rescaled sum) through ``tf32_product`` with
    the truncated split, in ``passes`` passes; the warps merge in order,
    then the splits; out = o / l in the pool dtype."""
    tile, width, warps = WALK[q.dtype]
    tf32 = q.dtype is torch.float32
    t_pad = tables.shape[1] * kp.shape[2]
    kg = gather_blocks(kp, tables).float()          # [S, Hkv, T, hd]
    vg = gather_blocks(vp, tables).float()
    scale = torch.tensor(q.shape[-1] ** -0.5 * LOG2E, dtype=torch.float32)
    if tf32:
        x = tf32_product("sjkrd,sktd->sjkrt", q, kg, passes, True) * scale
    else:
        x = torch.einsum("sjkrd,sktd->sjkrt", q.float(), kg) * scale
    valid = (torch.arange(t_pad)[None, None, :]
             <= pos[:, :, None].long())[:, :, None, None, :]
    x = torch.where(valid, x, NEG_INF)
    splits = []
    for t0 in range(0, t_pad, SPLIT):
        states = []
        for w in range(warps):
            o = torch.zeros(q.shape)
            m = torch.full(q.shape[:-1], NEG_INF)
            l = torch.zeros(q.shape[:-1])
            for a in range(t0 + w * width, min(t0 + SPLIT, t_pad), tile):
                xs = x[..., a:a + width]
                mx = torch.maximum(m, xs.amax(-1))
                alpha = torch.exp2(m - mx)
                p = torch.where(xs == NEG_INF, 0.0,
                                torch.exp2(xs - mx[..., None]))
                l = l * alpha + p.sum(-1)
                vt = vg[:, :, a:a + width]
                pv = (tf32_product("sjkrt,sktd->sjkrd", p, vt, passes, True)
                      if tf32 else
                      torch.einsum("sjkrt,sktd->sjkrd",
                                   p.to(q.dtype).float(), vt))
                o = o * alpha[..., None] + pv
                m = mx
            states.append((o, m, l))
        splits.append(merge(states))
    o, _, l = merge(splits)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def assert_k4_parity(case, dtype):
    """The emulation on ``case`` rounded to ``dtype`` against the JAX
    gather oracle (fp32, on the rounded inputs) and the Pallas kernel in
    interpret mode (in ``dtype``)."""
    args = [torch.tensor(np.asarray(a)) for a in case]
    for i in range(3):
        args[i] = args[i].to(dtype)
    got = k4_emulated(*args).float().numpy()
    rounded = [jnp.asarray(a.float().numpy()) for a in args[:3]] + list(
        case[3:])
    jdt = jnp.bfloat16 if dtype is torch.bfloat16 else jnp.float32
    oracle = np.asarray(gather_oracle(*rounded))
    kernel = np.asarray(jax_paged(
        *[a.astype(jdt) for a in rounded[:3]], *case[3:],
        interpret=True).astype(jnp.float32))
    for want in (oracle, kernel):
        np.testing.assert_allclose(got, want, **CARD_TOL[dtype])


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
def test_k4_split_emulation_positions_on_split_edges(dtype):
    """Rows ending on the last position of a split, the first of the
    next, one past it, and in the last split of a 640-position window."""
    pos = np.array([[SPLIT - 1, SPLIT], [SPLIT + 1, 2 * SPLIT - 1],
                    [2 * SPLIT, 639]], np.int32)
    case = make_case(np.random.default_rng(20), nq=2, hd=16, bs=16, mb=40,
                     n_blocks=120, pos=pos)
    assert_k4_parity(case, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k4_split_emulation_window_shorter_than_a_split(dtype):
    assert_k4_parity(make_case(np.random.default_rng(21), hd=16), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k4_split_emulation_trash_padded_tables(dtype):
    """Trash entries below a slot's largest position are walked and
    masked; those past it are never read."""
    bs, mb, n_blocks = 16, 24, 30
    tables = np.full((3, mb), n_blocks, np.int64)     # trash id
    tables[0, :1] = [0]
    tables[1, :17] = np.arange(1, 18)
    tables[2, :20] = np.arange(10, 30)
    pos = np.array([[0, 3], [100, 270], [300, 319]], np.int32)
    assert_k4_parity(make_case(np.random.default_rng(22), hd=16, bs=bs,
                               mb=mb, n_blocks=n_blocks, tables=tables,
                               pos=pos), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq,rep,hkv", [(1, 4, 2), (4, 4, 1), (3, 2, 2),
                                        (8, 4, 1)])
def test_k4_split_emulation_query_windows(dtype, nq, rep, hkv):
    """Q = 1 decode at the 8B grouping and Q > 1 verify windows up to the
    kernel's 16 rows and past them (32 rows: two row groups, each row
    computed alone), over windows that span several splits."""
    case = make_case(np.random.default_rng(30 + nq * rep), nq=nq, rep=rep,
                     hkv=hkv, hd=16, bs=16, mb=20, n_blocks=60)
    assert_k4_parity(case, dtype)


def test_one_tf32_pass_is_why_k4_takes_three():
    """fp32 K4's products the way the fp32 K1-K3 tests hold theirs: one
    TF32 pass (hi*hi) misses the float64 gather path by at least 50
    times what three passes miss, over a window of several splits."""
    case = make_case(np.random.default_rng(40), nq=4, rep=4, hkv=1, hd=16,
                     bs=16, mb=20, n_blocks=60)
    args = [torch.tensor(np.asarray(a)) for a in case]
    exact = paged_attend_reference(*(a.double() if a.is_floating_point()
                                     else a for a in args))
    errs = [(k4_emulated(*args, passes=n).double() - exact).abs().max()
            .item() for n in (3, 1)]
    assert errs[1] >= 50 * errs[0], errs
