"""``correct`` on tiny float32 cells on the CPU: the port agrees with the
plain reference, and the comparison fails the control (the reference in
float8 put in the port's place) and each fault the cells can have,
planted in the timed path while the rest of the run goes on."""

import time

import pytest
import torch

from port_bench import check, run
from port_bench.drivers import Run, serve, train
from port_bench.drivers.train import reference_train
from port_bench.model import dims
from port_bench.reference.model import Precision
from port_bench.tests.helpers import tiny_cell
from port_bench.traffic import TrainBatches

CPU = torch.device("cpu")
TRAIN = [("tiny.json", "tiny_train.json"),
         ("tiny_moe.json", "tiny_train.json")]


def _correct(cell, driver, seed=7, seconds=0.3):
    out = driver.run(Run(cell, seed=seed, seconds=seconds, trace=False,
                         t_start=time.monotonic(), device=CPU))
    line = run.result_line(cell, out, False, {"platform": "cpu"})
    return line["correct"], out


@pytest.mark.parametrize("config,mix", TRAIN)
def test_train_agrees(config, mix):
    ok, out = _correct(tiny_cell(config, mix), train)
    assert ok, out.numbers
    assert out.attempted >= 1 and out.failed == 0


def test_serve_agrees():
    ok, out = _correct(tiny_cell("tiny.json", "tiny_chat.json"), serve)
    assert ok, out.numbers
    assert out.numbers["served_gap"] == 0.0
    assert out.attempted >= 1 and out.failed == 0


@pytest.mark.parametrize("config,mix", TRAIN)
def test_train_control_fails(config, mix):
    cell = tiny_cell(config, mix)
    d = dims(cell.config, "train")
    b = TrainBatches(cell.traffic, d.vocab, 11)
    sec = cell.config["train"]
    want = reference_train(d, 11, b, sec, CPU, 3)
    ctrl = reference_train(d, 11, b, sec, CPU, 3, pr=Precision(fp8=True))
    ok, _ = check.verdict(check.train_numbers(ctrl, want), cell.limits)
    assert not ok


def test_serve_control_fails():
    cell = tiny_cell("tiny.json", "tiny_chat.json")
    # a window that holds enough requests for the control's first tokens
    # to part from the reference's somewhere
    _, out = _correct(cell, serve, seed=5, seconds=1.5)
    assert sum(len(tk) for _, tk in out.judged) >= 20
    from port_bench.calibrate import control_serve

    got = control_serve(cell, out.judged, 5, CPU)
    assert got["program_again"]["served_gap"] == 0.0
    ok, _ = check.verdict(got["control"], cell.limits)
    assert not ok


@pytest.mark.parametrize("config,mix", TRAIN)
def test_fault_state_unchanged(config, mix, monkeypatch):
    from theanompi_tpu_torch.ops import optimizers

    real = optimizers.adam

    def frozen(**kw):
        opt = real(**kw)
        return optimizers.Optimizer(opt.init, lambda p, g, s, lr: s)
    monkeypatch.setitem(optimizers.OPTIMIZERS, "adam", frozen)
    ok, out = _correct(tiny_cell(config, mix), train)
    assert not ok
    assert out.numbers["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("config,mix", TRAIN)
def test_fault_half_batch(config, mix, monkeypatch):
    from theanompi_tpu_torch.models.llama import Llama

    real = Llama._train_step

    def half(self, x, y):
        n = x.shape[0] // 2
        return real(self, x[:n], y[:n])
    monkeypatch.setattr(Llama, "_train_step", half)
    ok, out = _correct(tiny_cell(config, mix), train)
    assert not ok, out.numbers


def test_fault_token_altered(monkeypatch):
    from theanompi_tpu_torch.serving.decoder import PagedLlamaDecoder

    real = PagedLlamaDecoder.decode
    calls = [0]

    def altered(self, *a, **kw):
        out = real(self, *a, **kw)
        calls[0] += 1
        if calls[0] % 3 == 0:
            out = out.copy()
            out[:] = (out + 1) % self.model.vocab
        return out
    monkeypatch.setattr(PagedLlamaDecoder, "decode", altered)
    ok, out = _correct(tiny_cell("tiny.json", "tiny_chat.json"), serve)
    assert not ok, out.numbers


def test_fault_cache_not_written(monkeypatch):
    from theanompi_tpu_torch.serving.decoder import PagedLlamaDecoder

    monkeypatch.setattr(PagedLlamaDecoder, "_write_kv",
                        lambda self, pool, k, v, bids, offs: None)
    ok, out = _correct(tiny_cell("tiny.json", "tiny_chat.json"), serve)
    assert not ok, out.numbers
