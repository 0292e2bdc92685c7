"""The port's ``utils/scaling_model`` against the JAX package's: every
public function of both modules gives the same output on the same
seeded inputs, with ``chip=V5E`` passed explicitly wherever a function
takes a chip (bitwise: plain float Python on both sides), over several
draws each; then the port's own additions — the ``H100`` spec, its
``PEAK_BF16`` entry, and ``peak_flops_per_chip`` on torch devices."""

import inspect

import numpy as np
import pytest
import torch

from theanompi_tpu.utils import scaling_model as jax_sm
from theanompi_tpu_torch.utils import scaling_model as port_sm

N_DRAWS = 4


def llama_cfg(rng, moe: bool = False) -> dict:
    heads = int(rng.choice([8, 16, 32]))
    cfg = dict(dim=heads * int(rng.choice([64, 128])),
               n_layers=int(rng.integers(2, 33)), n_heads=heads,
               n_kv_heads=heads // int(rng.choice([1, 2, 4])),
               ffn_dim=int(rng.choice([1024, 4096, 14336])),
               vocab=int(rng.choice([32000, 128256])),
               seq_len=int(rng.choice([2048, 4096, 8192])))
    if moe:
        cfg.update(n_experts=int(rng.choice([4, 8])), moe_top_k=2)
    return cfg


def _f(rng, lo, hi):
    return float(rng.uniform(lo, hi))


#: function name -> kwargs drawn from one seeded generator
CASES = {
    "ici_links_used": lambda r: dict(n_chips=int(r.integers(1, 129))),
    "allreduce_time": lambda r: dict(
        wire_bytes=_f(r, 1e6, 1e10), n_chips=int(r.integers(1, 65)),
        chip=jax_sm.V5E),
    "exchange_wire_bytes": lambda r: dict(
        param_bytes=_f(r, 1e6, 3e10),
        wire=[None, "fp32", "bf16", "int8", "fp8"][int(r.integers(5))],
        n_shards=int(r.choice([2, 8, 64])),
        bucket_bytes=_f(r, 1e5, 1e8)),
    "compression_table": lambda r: dict(
        step_time_1chip=_f(r, 0.05, 2.0), param_bytes=_f(r, 1e8, 3e10),
        wire=["int8", "fp8"][int(r.integers(2))],
        transport=["ici", "dcn"][int(r.integers(2))], chip=jax_sm.V5E),
    "bsp_efficiency": lambda r: dict(
        step_time_1chip=_f(r, 0.05, 2.0), param_bytes=_f(r, 1e8, 3e10),
        n_chips=int(r.choice([1, 8, 16, 64])), chip=jax_sm.V5E,
        compression=[None, "int8"][int(r.integers(2))]),
    "bucketed_overlap": lambda r: dict(
        wire_bytes=_f(r, 1e8, 3e10), n_chips=int(r.choice([8, 16, 64])),
        step_time_1chip=_f(r, 0.05, 2.0), bucket_bytes=_f(r, 1e6, 1e8),
        chip=jax_sm.V5E),
    "loader_pipeline": lambda r: dict(
        batch_bytes=_f(r, 1e6, 1e9), step_time_s=_f(r, 0.01, 1.0),
        fetch_s=_f(r, 0.0, 0.5), depth=int(r.integers(1, 4))),
    "elastic_resume_cost": lambda r: dict(
        param_bytes=_f(r, 1e8, 3e10), n_old=int(r.choice([4, 8])),
        n_new=int(r.choice([2, 4, 6])), step_time_s=_f(r, 0.1, 2.0),
        optimizer=["adam", "momentum", "sgd"][int(r.integers(3))],
        error_feedback=bool(r.integers(2))),
    "predict_table": lambda r: dict(
        step_time_1chip=_f(r, 0.05, 2.0), param_bytes=_f(r, 1e8, 3e10),
        wire_dtype_bytes=int(r.choice([2, 4])), chip=jax_sm.V5E),
    "llama_param_count": lambda r: dict(cfg=llama_cfg(r)),
    "llama_hbm_per_chip": lambda r: dict(
        cfg=llama_cfg(r), tp=int(r.choice([1, 2, 4])),
        sp=int(r.choice([1, 2])), pp=int(r.choice([1, 2])),
        dp=int(r.choice([1, 8])), zero1=bool(r.integers(2)),
        batch_per_replica=int(r.integers(1, 5)),
        remat=bool(r.integers(2))),
    "llama_max_batch": lambda r: dict(
        cfg=llama_cfg(r), tp=int(r.choice([4, 8])),
        dp=int(r.choice([1, 8])), zero1=bool(r.integers(2)),
        seq_len=2048, chip=jax_sm.V5E),
    "llama_kv_bytes_per_token": lambda r: dict(
        cfg=llama_cfg(r), kv_dtype_bytes=int(r.choice([1, 2]))),
    "serving_roofline": lambda r: dict(
        cfg=llama_cfg(r), batch=int(r.integers(1, 65)),
        context=int(r.integers(128, 8192)), tp=int(r.choice([1, 2])),
        chip=jax_sm.V5E, max_seq=8192, block_size=16,
        prefix_hit_frac=_f(r, 0.0, 0.5)),
    "speculation_speedup": lambda r: dict(
        k=int(r.integers(1, 9)), accept_rate=_f(r, 0.1, 0.95),
        verify_cost_ratio=_f(r, 1.0, 2.0), conditional=bool(r.integers(2))),
    "fleet_roofline": lambda r: dict(
        cfg=llama_cfg(r), offered_tokens_per_sec=_f(r, 100.0, 1e5),
        context=int(r.integers(128, 4096)), batch=int(r.choice([8, 16])),
        chip=jax_sm.V5E),
    "llama_step_flops": lambda r: dict(
        cfg=llama_cfg(r), batch=int(r.integers(1, 17)),
        remat=bool(r.integers(2))),
    "moe_param_count": lambda r: dict(cfg=llama_cfg(r, moe=True)),
    "moe_alltoall_bytes": lambda r: dict(
        cfg=llama_cfg(r, moe=True), batch_per_replica=int(r.integers(1, 5)),
        ep=int(r.choice([1, 2, 8])), sp=int(r.choice([1, 2]))),
    "moe_ep_overhead": lambda r: dict(
        cfg=llama_cfg(r, moe=True), batch_per_replica=int(r.integers(1, 5)),
        ep=int(r.choice([2, 8])), step_time_1chip=_f(r, 0.1, 2.0),
        chip=jax_sm.V5E),
    "llama_step_time": lambda r: dict(
        cfg=llama_cfg(r), batch=int(r.integers(1, 17)),
        mfu=_f(r, 0.1, 0.6), n_chips_compute=int(r.choice([1, 16])),
        chip=jax_sm.V5E),
}


def public_functions(mod) -> set:
    return {n for n, f in inspect.getmembers(mod, inspect.isfunction)
            if f.__module__ == mod.__name__ and not n.startswith("_")}


def port_kwargs(kw: dict) -> dict:
    """The same kwargs with the port's own V5E (an equal dataclass)."""
    return {k: (port_sm.V5E if v is jax_sm.V5E else v)
            for k, v in kw.items()}


def test_every_public_function_is_compared():
    """The two modules' public functions: the JAX ones less
    ``cost_analysis_totals`` (XLA's cost analysis, no counterpart), and
    each one of them has a case below (``peak_flops_per_chip`` is held
    by its own tests)."""
    jax_fns = public_functions(jax_sm) - {"cost_analysis_totals"}
    assert public_functions(port_sm) == jax_fns
    assert set(CASES) == jax_fns - {"peak_flops_per_chip"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_at_v5e(name):
    """Bitwise: the same float expressions in plain Python."""
    for draw in range(N_DRAWS):
        kw = CASES[name](np.random.default_rng([draw, len(name)]))
        want = getattr(jax_sm, name)(**kw)
        got = getattr(port_sm, name)(**port_kwargs(kw))
        assert got == want, (name, kw)


def test_v5e_spec_and_peaks_match_jax():
    assert port_sm.V5E == port_sm.ChipSpec(**vars(jax_sm.V5E))
    assert {k: v for k, v in port_sm.PEAK_BF16.items()
            if k != "NVIDIA H100"} == jax_sm.PEAK_BF16


def test_h100_spec():
    """The datasheet values of an NVIDIA H100 80GB HBM3 (SXM)."""
    h = port_sm.H100
    assert (h.peak_bf16, h.hbm_bytes, h.hbm_bw) == (989e12, 80e9, 3.35e12)
    assert (h.ici_link_bw, h.ici_links) == (25e9, 18)
    assert h.dcn_bw_per_chip == 50e9
    assert port_sm.PEAK_BF16["NVIDIA H100"] == 989e12


def test_peak_flops_per_chip_on_torch_devices(monkeypatch):
    assert port_sm.peak_flops_per_chip([torch.device("cpu")]) is None
    assert port_sm.peak_flops_per_chip(["cpu"]) is None
    assert port_sm.peak_flops_per_chip([]) is None
    # a card's name, as torch reports it on the H100 this port runs on
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert port_sm.peak_flops_per_chip([torch.device("cuda", 0)]) == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA A100-SXM4-80GB")
    assert port_sm.peak_flops_per_chip(["cuda:0"]) is None


def test_h100_rows_price_the_card():
    """With ``chip=H100`` the same formulas price the card: the HBM
    sizing fits where the v5e's 16 GiB does not, and the allreduce over
    NVLink's 18 links is faster than the v5e torus's."""
    from theanompi_tpu_torch.models import LLAMA3_8B

    fit = port_sm.llama_max_batch(LLAMA3_8B, tp=8, dp=8, zero1=True,
                                  seq_len=2048, chip=port_sm.H100)
    assert fit > port_sm.llama_max_batch(LLAMA3_8B, tp=8, dp=8, zero1=True,
                                         seq_len=2048)
    t_h100 = port_sm.allreduce_time(1e9, 8, chip=port_sm.H100,
                                    links=port_sm.H100.ici_links)
    assert t_h100 < port_sm.allreduce_time(1e9, 8)
