"""The harness's readings of the program fail loudly where the
program's interface changed, and read what they should where it did
not: the first gradient at the optimizer's ``update``, the serving
probe's arguments by name, and the sweep's live KV blocks."""

import dataclasses

import pytest
import torch

from port_bench import spec
from port_bench.drivers import serve
from port_bench.drivers.train import FirstGradient, port_leaves
from port_bench.model import dims, port_config
from port_bench.tests.helpers import tiny_cell

CPU = torch.device("cpu")


def _tiny_llama():
    from theanompi_tpu_torch.models.llama import Llama
    from theanompi_tpu_torch.utils import Recorder

    cell = tiny_cell("tiny.json", "tiny_train.json")
    d = dims(cell.config, "train")
    mix = cell.traffic
    batches = spec.load_generator(mix["generator"])(mix, d.vocab, 3)
    model = Llama(port_config(cell.config, "train", batches.seq_len,
                              batches.batch), device=CPU)
    model.build_model(n_replicas=1)
    model.data = batches
    model.compile_iter_fns(exch_strategy="ici32")
    rec = Recorder(rank=0, size=1, print_freq=1 << 30, verbose=False)
    return model, rec


def test_first_gradient_is_adams_first_moment():
    model, rec = _tiny_llama()
    real = model.optimizer
    grad = FirstGradient(model, port_leaves(model.params)).step(
        lambda: model.train_iter(0, rec))
    assert model.optimizer is real
    assert len(grad) == len(port_leaves(model.params))
    for (name, _), m in zip(port_leaves(model.params),
                            model.opt_state["m"]):
        want = float((m / 0.1).double().norm())
        assert grad[name] == pytest.approx(want, rel=1e-5), name


def test_first_gradient_refuses_what_it_cannot_name():
    model, rec = _tiny_llama()
    leaves = port_leaves(model.params)
    with pytest.raises(RuntimeError, match="never took"):
        FirstGradient(model, leaves + [("ghost", torch.zeros(3))]).step(
            lambda: model.train_iter(0, rec))
    with pytest.raises(RuntimeError, match="no named leaf"):
        FirstGradient(model, leaves[1:]).step(
            lambda: model.train_iter(1, rec))
    assert dataclasses.is_dataclass(model.optimizer)


def test_probe_refuses_a_changed_call():
    class Dec:
        def decode(self, tokens, lens, seeds, temps, tables=None,
                   active=None):
            return tokens

    class Good:
        def decode(self, tokens, lengths, seeds, temps, tables=None,
                   active=None):
            return tokens

        def prefill(self, *a):
            return None

    class Module:
        @staticmethod
        def paged_attend(q, k_pool, v_pool, tables, pos):
            return q

    class Renamed:
        @staticmethod
        def paged_attend(q, k_pool, v_pool, block_tables, pos):
            return q

    with pytest.raises(RuntimeError, match="lengths"):
        serve.Probe(Dec(), Module, None, 8)
    with pytest.raises(RuntimeError, match="no longer calls"):
        serve.Probe(Good(), object(), None, 8)
    with pytest.raises(RuntimeError, match="paged_attend takes"):
        serve.Probe(Good(), Renamed, None, 8)
    probe = serve.Probe(Good(), Module, None, 8)
    probe.remove()


def test_sweep_reads_a_rate_and_the_live_blocks():
    from port_bench import sweep
    from theanompi_tpu_torch.serving import decoder as decoder_module

    cell = tiny_cell("tiny.json", "tiny_chat.json")
    dec, eng, d, sv = serve.build(cell, 5, CPU, False, {"max_slots": 4})
    probe = serve.Probe(dec, decoder_module, d, int(sv["n_blocks"]))
    try:
        got = sweep.one_rate(eng, probe, cell.traffic, d.vocab, 5,
                             warm=0.1, seconds=1.0, drain=30.0)
    finally:
        probe.remove()
    assert got["due"] >= 1 and got["drained"]
    assert got["ok"] == got["due"]
    assert 0 < got["live_blocks_peak"] <= int(sv["n_blocks"])
    assert got["ttft_p50_ms"] <= got["ttft_p90_ms"] <= got["ttft_p95_ms"]
