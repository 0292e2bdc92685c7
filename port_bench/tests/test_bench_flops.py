"""Model FLOPs, kernel operations and bytes at the cells' shapes,
against hand-worked values."""

import pytest

from port_bench import flops, spec
from port_bench.model import dims

MISTRAL = spec.load_json(spec.HERE / "configs" / "mistral7b.json")
MIXTRAL = spec.load_json(spec.HERE / "configs" / "mixtral8x7b.json")


def test_mistral_parameters():
    d = dims(MISTRAL, "train")
    p = flops.matmul_params(d)
    # q and o 4096 x 4096, k and v 4096 x 1024; three 4096 x 14336
    assert p["layer"] == 2 * 4096 * 4096 + 2 * 4096 * 1024 \
        + 3 * 4096 * 14336 == 218_103_808
    assert p["head"] == 4096 * 32000
    # 8 layers, the embedding and the head: 2.007 B
    total = 8 * (p["layer"] + 2 * 4096) + 2 * 4096 * 32000 + 4096
    assert total == 2_007_044_096
    d32 = dims(MISTRAL, "serve")
    total32 = 32 * (p["layer"] + 2 * 4096) + 2 * 4096 * 32000 + 4096
    assert d32.n_layers == 32 and total32 == 7_241_732_096


def test_mistral_train_step_flops():
    d = dims(MISTRAL, "train")
    n_active = 8 * 218_103_808 + 131_072_000
    want = 6 * n_active * 16384 + 6 * 4096 * 4096 * 8 * 16384
    assert flops.train_step_flops(d, 4, 4096) == want
    assert want == pytest.approx(1.9760e14, rel=1e-4)


def test_mixtral_train_step_flops():
    d = dims(MIXTRAL, "train")
    p = flops.matmul_params(d)
    # attention, two of eight experts, the router
    assert p["layer"] == 41_943_040 + 2 * 176_160_768 + 4096 * 8
    n_active = 2 * p["layer"] + 4096 * 32000
    want = 6 * n_active * 8192 + 6 * 4096 * 4096 * 2 * 8192
    assert flops.train_step_flops(d, 2, 4096) == want
    # all eight experts held: 3.16 B parameters
    held = 2 * (41_943_040 + 8 * 176_160_768 + 4096 * 8 + 2 * 4096) \
        + 2 * 4096 * 32000 + 4096
    assert held == 3_164_688_384


def test_flash_bounds_at_the_training_shape():
    shape = (4, 32, 4096, 128)
    pairs = 4 * 32 * 4096 * 4097 / 2
    assert flops.flash_ops("fwd", shape) == 4 * 128 * pairs
    assert flops.flash_ops("dkv", shape) == 8 * 128 * pairs
    assert flops.flash_ops("dq", shape) == 6 * 128 * pairs
    numel = 4 * 32 * 4096 * 128
    assert flops.flash_bytes("fwd", shape, 2) == 4 * numel * 2 \
        + 4 * 32 * 4096 * 4
    assert flops.flash_bytes("dkv", shape, 2) == 6 * numel * 2 \
        + 2 * 4 * 32 * 4096 * 4
    # K1 is bound by its operations: 4*128*pairs / 989e12
    assert flops.flash_bound_s("fwd", shape) == pytest.approx(
        4 * 128 * pairs / 989e12)


def test_paged_bound():
    # 64 slots of one query row, 8 kv heads of 4 query heads, hd 128,
    # blocks of 16; every slot's last position 999: 1008 walked each
    q_shape = (64, 1, 8, 4, 128)
    walked = 64 * 1008
    nbytes = 2 * walked * 8 * 128 * 2 + 2 * 64 * 32 * 128 * 2 \
        + 64 * 256 * 4 + 64 * 4
    got = flops.paged_bound_s(q_shape, 16, [999] * 64, 64 * 256)
    assert got == pytest.approx(nbytes / 3.35e12)


def test_serve_flops():
    d = dims(MISTRAL, "serve")
    p = flops.matmul_params(d)
    n = 32 * p["layer"] + p["head"]
    assert flops.serve_token_flops(d, 1000) == 2 * n + 4 * 1000 * 4096 * 32
