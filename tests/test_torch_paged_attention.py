"""Paged-attention parity: the port's ``paged_attend`` (CPU: the gather
path, the plain version of kernel K4) against the JAX package's gather
oracle and its Pallas kernel in interpret mode.  Covers the block-table
hazards: positions on block edges, trash-padded tables, multi-row query
windows (Q > 1) and the degenerate single-head shape.  fp32, atol 1e-5
(the two frameworks sum in different orders)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from theanompi_tpu.serving.paged_attention import paged_attend as jax_paged
from theanompi_tpu_torch.serving.paged_attention import (
    gather_blocks,
    paged_attend,
    paged_attend_cuda,
)

from test_paged_attention import gather_oracle, make_case

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
