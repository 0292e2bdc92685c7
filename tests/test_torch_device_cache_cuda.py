"""The device-resident chunk and selective remat on the card (marked
``cuda``; each test skips where no CUDA device is present).  The file
imports no jax, so it runs where the card is: ``python3 -m pytest
--noconftest tests/test_torch_device_cache_cuda.py``.

A small fp32 Llama (K1, K2 and K3 in three TF32 passes) trained by the
BSP worker on card 0 from one initial checkpoint:

- with the train set on the card and ``steps_per_call=4`` (6 batches:
  a chunk of 4, then a tail of 2 a step at a time) against the staged
  per-step run: every loss and parameter bitwise equal;
- with ``remat_save=("attn_out",)`` against ``remat=True``: bitwise
  equal, K1 launched L times a step instead of 2L.
"""

import shutil

import pytest
import torch

from theanompi_tpu_torch.models.llama import save_init_checkpoint
from theanompi_tpu_torch.ops.attention import flash_fwd_cuda
from theanompi_tpu_torch.workers import bsp_worker

pytestmark = pytest.mark.cuda

CFG = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512,
           vocab=512, seq_len=64, batch_size=2, n_train=12, n_val=2,
           compute_dtype="float32", seed=3, lr=1e-3, optimizer="adam",
           remat=True)
STEPS = 6


def run(tmp_path, name, cfg):
    d = tmp_path / name
    shutil.copytree(tmp_path / "init", d)
    flash_fwd_cuda.launches = 0
    out = bsp_worker.run(devices=[0], config=cfg, n_epochs=1,
                         checkpoint_dir=str(d), resume=True, verbose=False,
                         modelfile="theanompi_tpu_torch.models.llama",
                         modelclass="Llama")
    return out, flash_fwd_cuda.launches


def assert_bitwise(a, b):
    assert len(a["recorder"].train_losses) == STEPS
    assert a["recorder"].train_losses == b["recorder"].train_losses
    for x, y in zip(a["model"]._leaves(), b["model"]._leaves()):
        assert torch.equal(x, y)


@pytest.fixture
def init(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    save_init_checkpoint(CFG, tmp_path / "init")
    return tmp_path


def test_chunk_is_bitwise_the_staged_path_on_the_card(init):
    staged, _ = run(init, "staged", CFG)
    cached, _ = run(init, "cached", dict(CFG, device_data_cache=True,
                                         steps_per_call=4))
    assert cached["model"]._chunk_k == 4
    assert cached["model"]._device_cache is not None
    assert_bitwise(cached, staged)


def test_remat_save_is_bitwise_full_remat_with_half_the_k1(init):
    full, n_full = run(init, "full", CFG)
    save, n_save = run(init, "save", dict(CFG, remat_save=("attn_out",)))
    assert_bitwise(save, full)
    val = CFG["n_layers"]                 # one val batch, one forward
    assert n_full == STEPS * 2 * CFG["n_layers"] + val
    assert n_save == STEPS * CFG["n_layers"] + val
