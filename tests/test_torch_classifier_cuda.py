"""The classifier path on the card against the CPU (marked ``cuda``;
each test skips where no CUDA device is present).  The file imports no
jax, so it runs where the card is: ``python3 -m pytest --noconftest
tests/test_torch_classifier_cuda.py``.
"""

import shutil

import numpy as np
import pytest
import torch

from theanompi_tpu_torch.models.wresnet import WResNet
from theanompi_tpu_torch.workers import bsp_worker

pytestmark = pytest.mark.cuda

CFG = dict(depth=10, widen=1, batch_size=8, n_train=24, n_val=8,
           compute_dtype="float32", seed=3, lr=0.02)


def test_wresnet_steps_on_the_card_match_the_cpu(tmp_path, monkeypatch):
    """Three BSP steps of a small fp32 WResNet on the card (cuDNN, a
    one-rank NCCL group) and on the CPU (gloo) from one initial
    checkpoint, on synthetic data: the per-step losses agree within
    1e-4 (summation order only, carried through 3 momentum steps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (tmp_path / "no_data").mkdir()
    monkeypatch.setenv("TM_DATA_DIR", str(tmp_path / "no_data"))
    WResNet.save_init_checkpoint(CFG, tmp_path / "init")
    losses = []
    for where, devices in (("card", [0]), ("cpu", ["cpu"])):
        d = tmp_path / where
        shutil.copytree(tmp_path / "init", d)
        out = bsp_worker.run(devices=devices, config=CFG, n_epochs=1,
                             checkpoint_dir=str(d), resume=True,
                             verbose=False,
                             modelfile="theanompi_tpu_torch.models.wresnet",
                             modelclass="WResNet")
        losses.append(out["recorder"].train_losses)
    assert len(losses[0]) == 3
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4, atol=0)
