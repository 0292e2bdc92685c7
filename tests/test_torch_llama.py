"""Llama model math and the parameter bridge: the port's ``rms_norm``,
``rope``, ``rope_at`` and GQA head reshapes against the JAX package's
(fp32, atol 1e-6 / 1e-5), ``params_from_jax`` round-tripping a JAX
parameter tree bitwise, and the tp=1 building blocks."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu.models import llama as jax_llama
from theanompi_tpu_torch.models import llama as port_llama
from theanompi_tpu_torch.parallel import mesh as port_mesh
from theanompi_tpu_torch.parallel import tp as port_tp
from theanompi_tpu_torch.parallel.mesh import ModelGroup
from theanompi_tpu_torch.utils.checkpoint import parse_keystr

CFG = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
           vocab=64, seq_len=64, compute_dtype="float32")


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    want = np.asarray(jax_llama.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    got = port_llama.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_rms_norm_keeps_input_dtype():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    w = torch.ones(8)
    assert port_llama.rms_norm(x, w).dtype == torch.bfloat16


@pytest.mark.parametrize("offset", [0, 37])
def test_rope_matches_jax(offset):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    pos = np.arange(offset, offset + 7)
    want = np.asarray(jax_llama.rope(jnp.asarray(x), jnp.asarray(pos)))
    got = port_llama.rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_rope_at_matches_jax_and_rope():
    """Per-row positions: equal to the JAX vmap, and to ``rope`` of each
    row at its own position (one copy of the rotation math)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 3, 16)).astype(np.float32)
    pos = np.array([0, 3, 17, 3, 63])
    want = np.asarray(jax_llama.rope_at(jnp.asarray(x), jnp.asarray(pos)))
    tx, tp_ = torch.from_numpy(x), torch.from_numpy(pos)
    got = port_llama.rope_at(tx, tp_)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    for i in range(5):
        row = port_llama.rope(tx[i][None, :, None, :], tp_[i:i + 1])
        assert torch.equal(row[0, :, 0, :], got[i])


def test_heads_roundtrip_matches_jax():
    x = np.arange(2 * 5 * 12, dtype=np.float32).reshape(2, 5, 12)
    want = np.asarray(jax_llama._heads(jnp.asarray(x), 3, 4))
    got = port_llama._heads(torch.from_numpy(x), 3, 4)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(port_llama._unheads(got), torch.from_numpy(x))


@pytest.fixture(scope="module")
def jax_params():
    m = jax_llama.Llama(dict(CFG))
    return jax.device_get(m._init_full_params(jax.random.PRNGKey(0)))


def test_params_from_jax_roundtrip_bitwise(jax_params):
    params = port_llama.params_from_jax(jax_params, CFG, "cpu")
    back = port_llama.params_to_jax(params)
    flat_a = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert np.asarray(a).dtype == b.dtype == np.float32, path
        assert np.array_equal(np.asarray(a), b), path


def test_params_from_jax_casts_to_compute_dtype(jax_params):
    cfg = dict(CFG, compute_dtype="bfloat16")
    params = port_llama.params_from_jax(jax_params, cfg, "cpu")
    assert params["layers"][1]["wq"].dtype == torch.bfloat16
    want = torch.tensor(np.asarray(jax_params["lm_head"])).bfloat16()
    assert torch.equal(params["lm_head"], want)


def test_params_from_jax_rejects_wrong_shapes(jax_params):
    with pytest.raises(ValueError, match="shape"):
        port_llama.params_from_jax(jax_params, dict(CFG, ffn_dim=48), "cpu")


def test_init_shapes_match_jax_and_are_seeded(jax_params):
    a = port_llama.Llama(CFG, device="cpu")
    b = port_llama.Llama(CFG, device="cpu")
    c = port_llama.Llama(dict(CFG, seed=7), device="cpu")
    ja = jax.tree_util.tree_leaves(jax_params)
    pa = jax.tree_util.tree_leaves(port_llama.params_to_jax(a.params))
    assert [np.shape(x) for x in ja] == [x.shape for x in pa]
    assert torch.equal(a.params["layers"][0]["wq"],
                       b.params["layers"][0]["wq"])
    assert not torch.equal(a.params["embed"], c.params["embed"])
    assert torch.equal(a.params["final_norm"], torch.ones(CFG["dim"]))
    assert a.n_params() == sum(int(np.size(x)) for x in ja)


def test_config_checks():
    with pytest.raises(ValueError, match="n_kv_heads"):
        port_llama.Llama(dict(CFG, n_kv_heads=3), device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        port_llama.Llama(dict(CFG, compute_dtype="float16"), device="cpu")
    # pp, the MoE knobs and sp are layout knobs with the JAX asserts on
    # them
    for knob, match in (
            (dict(pp=3), "n_layers must divide by pp"),
            (dict(n_experts=4, ep=3), "must divide by ep"),
            (dict(n_experts=4, moe_top_k=5), "moe_top_k"),
            (dict(n_experts=4, moe_top_k=0), "moe_top_k"),
            (dict(ep=2), "ep > 1 requires n_experts > 0"),
            (dict(pp=2, batch_size=3), "microbatches")):
        with pytest.raises(ValueError, match=match):
            port_llama.Llama(dict(CFG, **knob), device="cpu")
    m = port_llama.Llama(dict(CFG, pp=2, batch_size=6), device="cpu")
    assert m.pp_microbatches == 2          # 2*pp does not divide 6
    m = port_llama.Llama(dict(CFG, pp=2, batch_size=8), device="cpu")
    assert m.pp_microbatches == 4
    assert port_llama.Llama(dict(CFG, n_experts=4, ep=2),
                            device="cpu").ep == 2
    with pytest.raises(ValueError, match="sp_mode"):
        port_llama.Llama(dict(CFG, sp=2, sp_mode="tree"), device="cpu")
    with pytest.raises(ValueError, match="seq_len"):
        port_llama.Llama(dict(CFG, sp=3), device="cpu")
    with pytest.raises(ValueError, match="ulysses"):
        port_llama.Llama(dict(CFG, sp=4, sp_mode="ulysses"), device="cpu")
    assert port_llama.Llama(dict(CFG, sp=2), device="cpu").sp == 2
    # tp = 2 runs over a two-rank group (a ModelGroup or a layout's)
    with pytest.raises(ValueError, match="ModelGroup"):
        port_llama.Llama(dict(CFG, tp=2), device="cpu")
    two = ModelGroup(rank=0, size=2, device_group=None, cpu_group=None)
    m = port_llama.Llama(dict(CFG, tp=2), device="cpu", group=two)
    m.build_model()
    # training at tp·sp > 1 runs over the layout the BSP worker builds
    # before the model (one process cannot lay out two model ranks)
    had_group = torch.distributed.is_initialized()
    try:
        with pytest.raises(ValueError, match="Layout built before"):
            m.compile_iter_fns()
    finally:
        if not had_group:
            port_mesh.destroy_group()


def test_llama3_8b_shape_is_the_jax_one():
    assert port_llama.LLAMA3_8B == jax_llama.LLAMA3_8B


def test_embed_lookup_misses_are_zero():
    table = torch.randn(6, 4)
    ids = torch.tensor([[0, 5, 6, -1]])
    got = port_tp.embed_lookup(ids, table, 6)
    assert torch.equal(got[0, :2], table[[0, 5]])
    assert torch.equal(got[0, 2:], torch.zeros(2, 4))


def test_argmax_breaks_ties_to_lowest_id():
    score = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    assert port_tp.sharded_argmax(score, 4).tolist() == [1, 0]


def test_sampling_is_seeded_per_row():
    """Greedy rows argmax; sampled rows depend only on their own seed,
    so a row sampled in a batch equals the row sampled alone."""
    logits = torch.randn(3, 50)
    temps = torch.tensor([0.0, 0.9, 0.9])
    seeds = [port_tp.fold_seed(1, 5), port_tp.fold_seed(2, 5),
             port_tp.fold_seed(2, 6)]
    batch = port_tp.sharded_sample(logits, 50, seeds, temps)
    assert batch[0] == torch.argmax(logits[0])
    for i in (1, 2):
        alone = port_tp.sharded_sample(logits[i:i + 1], 50, seeds[i:i + 1],
                                       temps[i:i + 1])
        assert alone[0] == batch[i]
    assert port_tp.fold_seed(2, 5) != port_tp.fold_seed(2, 6)
    assert 0 <= port_tp.fold_seed(2**40, 2**20) < 2**63


def test_checkpoint_keys_parse_without_jax(jax_params):
    for path, _ in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
        key = jax.tree_util.keystr(path)
        want = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        assert parse_keystr(key) == want
    with pytest.raises(ValueError):
        parse_keystr("['layers'][0]junk")
