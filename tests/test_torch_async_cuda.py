"""The asynchronous rules on the card (marked ``cuda``; each test skips
where no CUDA device is present): the replica engine with W = 2
replicas stacked on one card trains, in fp32, the losses the CPU
trains from the same init checkpoint.  The file imports no jax, so it
runs where the card is: ``python3 -m pytest --noconftest
tests/test_torch_async_cuda.py``.
"""

import shutil

import numpy as np
import pytest
import torch

from theanompi_tpu_torch.models.lstm import LSTM
from theanompi_tpu_torch.models.wresnet import WResNet
from theanompi_tpu_torch.workers import easgd_worker, gosgd_worker

pytestmark = pytest.mark.cuda

# fp32: cuBLAS/cuDNN against the CPU's kernels differ by summation
# order, carried over 4 steps and the merges
RTOL = 1e-4
CASES = {
    "gosgd_lstm": (gosgd_worker.run, LSTM, "lstm", "LSTM",
                   dict(vocab=64, emb_dim=8, hidden=8, maxlen=12,
                        batch_size=4, n_train=32, n_val=8, dropout=0.0),
                   dict(push_prob=1.0, staleness=1)),
    "easgd_wresnet": (easgd_worker.run, WResNet, "wresnet", "WResNet",
                      dict(depth=10, widen=1, batch_size=4, n_train=32,
                           n_val=8, lr=0.02, lr_schedule=None),
                      dict(tau=2, speeds=[1.0, 0.5])),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_on_the_card_trains_the_cpu_losses(dev, case, tmp_path,
                                                  monkeypatch):
    run, cls, mod, name, cfg, kw = CASES[case]
    monkeypatch.setenv("TM_DATA_DIR", str(tmp_path / "no_data"))
    cfg = dict(cfg, compute_dtype="float32", seed=3)
    init = tmp_path / "init"
    cls.save_init_checkpoint(cfg, init)
    losses, vals = [], []
    for devices in ([dev.index] * 2, ["cpu"] * 2):
        d = tmp_path / str(devices[0])
        shutil.copytree(init, d)
        out = run(devices=devices, modelfile=f"theanompi_tpu_torch.models."
                  f"{mod}", modelclass=name, config=cfg, n_epochs=1,
                  checkpoint_dir=str(d), resume=True, verbose=False, **kw)
        assert out["n_workers"] == 2
        assert out["device"] == ("cpu" if devices[0] == "cpu"
                                 else str(dev))
        losses.append(out["recorder"].train_losses)
        vals.append(out["final_val"]["loss"])
    assert len(losses[0]) == 4 and all(np.isfinite(losses[0]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=RTOL, atol=0)
    np.testing.assert_allclose(vals[0], vals[1], rtol=RTOL)


def test_lstm_cell_in_bf16_on_the_card_rounds_as_the_cpu(dev):
    """The recurrent layer at the published width (embedding and hidden
    128, 100 steps, batch 32) in bf16 carries h and c in bf16 on both
    devices: the pooled output on the card stays within 4e-3 (two bf16
    ulps at |y| < 0.5) of the CPU's on the same weights and inputs
    (measured on an H100: 4.9e-4 at max |y| 0.16; cuBLAS sums the
    products in another order)."""
    from theanompi_tpu_torch.ops.recurrent import LSTM as LSTMLayer

    gen = torch.Generator().manual_seed(0)
    layer = LSTMLayer(128)
    layer.init(gen, (100, 128))
    x = torch.randn((32, 100, 128), generator=gen).bfloat16()
    mask = (torch.rand((32, 100), generator=gen) < 0.8).float()
    with torch.no_grad():
        ref = layer(x, mask=mask)
        got = layer.to(dev)(x.to(dev), mask=mask.to(dev)).cpu()
    assert got.dtype == ref.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs().max().item()
    print(f"bf16 LSTM card vs CPU: max |diff| {err:.3g}, max |y| "
          f"{ref.float().abs().max().item():.3g}")
    assert ref.float().abs().max().item() < 0.5
    assert err <= 4e-3
