"""The FLOP count behind the step profile's MFU (``train_step_flops``).

On the card the count has two parts: what ``FlopCounterMode`` sees of
the step (the products of eager PyTorch), and the K1-K3 launches'
operations, which it cannot see inside the extension and which
``count_kernel_ops`` tallies (``ops/attention.py: _tally``).  Here:

- the tally at the training shape [2, 32, 2048, 128] and at a ring hop
  (causal on the diagonal, full off it) against ``chip_smoke.py``'s
  ``flash_ops``, the operation counts its kernels' bounds use, and its
  live pairs against the causal mask's own count; exact;
- its per-pair factors against ``FlopCounterMode`` over the plain
  versions (full attention): K1 is ``mha_reference_fwd``'s products;
  K2 and K3 are ``flash_bwd_reference``'s five plus S and dP, which the
  second kernel computes again; exact;
- nesting: an enclosing tally counts a nested one's launches (the
  chip's check of the step's count wraps ``train_step_flops``);
- the counter's part against the JAX package: on the CPU the port's
  ``train_step_flops`` is the products of JAX's compiled train step
  (each ``dot`` of its optimized HLO: 2 x output elements x contracted
  size) plus one S product a layer, 2·D per (q, k) pair, that the
  port's attention backward computes again from the logsumexp where
  JAX's autodiff keeps P; with and without remat, whose replayed
  forward both count.  Exact.
"""

import importlib.util
import re
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from theanompi_tpu_torch.ops import attention as port_attn
from theanompi_tpu_torch.ops.attention import (
    causal_mask,
    count_kernel_ops,
    flash_bwd_reference,
    mha_reference_fwd,
)

ROOT = Path(__file__).resolve().parent.parent


def chip_smoke():
    """``chip_smoke.py`` as a module (its import runs no phase)."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", ROOT / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["chip_smoke"] = mod
    return sys.modules["chip_smoke"]


def tally(kernel, shape, causal, tk=None):
    q = torch.empty(shape, device="meta")
    with count_kernel_ops() as ops:
        port_attn._tally(kernel, q, shape[2] if tk is None else tk, causal)
    return ops[0]


# the training path's launch; a ring hop at sp = 2 of that sequence
SHAPES = [((2, 32, 2048, 128), True), ((2, 32, 1024, 128), True),
          ((2, 32, 1024, 128), False)]


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("shape,causal", SHAPES)
def test_tally_is_the_bound_formulas_count(kernel, shape, causal):
    assert tally(kernel, shape, causal) == \
        chip_smoke().flash_ops(kernel, shape, causal)


@pytest.mark.parametrize("tq,tk", [(64, 64), (64, 40), (40, 64), (1, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_tally_counts_the_masks_live_pairs(tq, tk, causal):
    b, h, d = 2, 3, 16
    live = (int(causal_mask(torch.arange(tq), torch.arange(tk)).sum())
            if causal else tq * tk)
    for kernel, per_pair in port_attn.KERNEL_OPS_PER_PAIR.items():
        assert tally(kernel, (b, h, tq, d), causal, tk) == \
            per_pair * d * b * h * live


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_forward_factor_is_the_plain_versions_products():
    g = torch.Generator().manual_seed(0)
    shape = (2, 3, 48, 32)
    q, k, v = (torch.randn(shape, generator=g) for _ in range(3))
    assert counted(lambda: mha_reference_fwd(q, k, v, causal=False)) == \
        tally("fwd", shape, False) > 0


def test_backward_factors_are_the_plain_versions_products_and_recompute():
    g = torch.Generator().manual_seed(1)
    shape = (2, 3, 48, 32)
    b, h, t, d = shape
    q, k, v, do = (torch.randn(shape, generator=g) for _ in range(4))
    _, lse = mha_reference_fwd(q, k, v, causal=False)
    delta = torch.randn((b, h, t), generator=g)
    plain = counted(lambda: flash_bwd_reference(q, k, v, do, lse, delta,
                                                causal=False))
    # the second kernel computes S and dP again: 2 products, 4·D a pair
    again = 4 * d * b * h * t * t
    assert tally("dkv", shape, False) + tally("dq", shape, False) == \
        plain + again


def test_an_enclosing_tally_counts_the_nested_ones():
    shape = (1, 2, 16, 16)
    q = torch.empty(shape, device="meta")
    fwd, dq = tally("fwd", shape, True), tally("dq", shape, True)
    with count_kernel_ops() as outer:
        port_attn._tally("fwd", q, 16, True)
        with count_kernel_ops() as inner:
            port_attn._tally("dq", q, 16, True)
        assert inner[0] == dq
    assert outer[0] == fwd + dq
    # outside every tally a launch counts nowhere
    port_attn._tally("fwd", q, 16, True)
    assert port_attn._KERNEL_OPS is None


# -- the counter's part against JAX's compiled step --------------------------

CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
           vocab=128, seq_len=32, batch_size=4, n_train=32, n_val=8,
           compute_dtype="float32", seed=3, lr=1e-2, optimizer="adam",
           exch_strategy="ici32")

_DEF = re.compile(r"%([\w.\-]+) = \w+\[([\d,]*)\]")
_DOT = re.compile(r"%[\w.\-]+ = \w+\[([\d,]*)\]\S* dot\(%([\w.\-]+), "
                  r"%[\w.\-]+\).*lhs_contracting_dims=\{([\d,]*)\}")


def _dims(text):
    return [int(x) for x in text.split(",") if x]


def hlo_dot_flops(hlo: str) -> int:
    """2 x output elements x contracted size, summed over every ``dot``
    of an optimized HLO module (instruction names are module-unique, so
    an operand's shape is its definition's)."""
    assert " while(" not in hlo and " convolution(" not in hlo
    shapes = {m.group(1): _dims(m.group(2)) for m in _DEF.finditer(hlo)}
    total = n = 0
    for line in hlo.splitlines():
        m = _DOT.search(line)
        if m is None:
            assert " dot(" not in line, line
            continue
        out, lhs = _dims(m.group(1)), shapes[m.group(2)]
        k = 1
        for c in _dims(m.group(3)):
            k *= lhs[c]
        size = 1
        for x in out:
            size *= x
        total += 2 * size * k
        n += 1
    assert n > 0
    return total


@pytest.mark.parametrize("remat", [True, False])
def test_step_products_are_jax_compiled_step_products(remat):
    import jax

    from theanompi_tpu.models.llama import Llama as JaxLlama
    from theanompi_tpu.parallel import make_mesh
    from theanompi_tpu_torch.models.llama import Llama
    from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group

    cfg = dict(CFG, remat=remat)
    jm = JaxLlama(dict(cfg))
    jm.build_model(n_replicas=1)
    jm.compile_iter_fns(mesh=make_mesh(data=1,
                                       devices=jax.devices("cpu")[:1]))
    jax_products = hlo_dot_flops(jm.train_step_hlo_text())

    created = init_group(torch.device("cpu"), 0, 1, None)
    try:
        m = Llama(dict(cfg), device="cpu")
        m.build_model()
        m.compile_iter_fns()
        port = m.train_step_flops()
    finally:
        if created:
            destroy_group()
    b, h, t = cfg["batch_size"], cfg["n_heads"], cfg["seq_len"]
    d = cfg["dim"] // h
    s_again = cfg["n_layers"] * 2 * d * b * h * t * t
    assert port == jax_products + s_again
