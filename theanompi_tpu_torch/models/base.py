"""The model contract the workers drive (port of the ``TMModel`` subset
of ``theanompi_tpu/models/base.py`` that the BSP path uses).

Workers drive a duck-typed model exposing ``build_model /
compile_iter_fns / train_iter / val_iter / adjust_hyperp / save / load
/ data / epoch / n_epochs``.  This base supplies the shared pieces: the
lr schedule and the npz checkpoint round trip.  ``save`` stamps the
JAX package's metadata (``epoch``, ``lr``, ``world_size``,
``n_devices``, ``global_batch``, the recorder state); only rank 0 of
the process group writes.  ``load`` restores the newest checkpoint
that verifies, through the model's ``restore_trees`` hook.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from theanompi_tpu_torch.utils import checkpoint as ckpt


class TMModel:
    """Abstract contract; subclass or duck-type it."""

    data: Any
    epoch: int = 0
    n_epochs: int = 1
    current_lr: float = 0.0

    def build_model(self, n_replicas: int = 1) -> None:
        raise NotImplementedError

    def compile_iter_fns(self, **kwargs) -> None:
        raise NotImplementedError

    def train_iter(self, count: int, recorder) -> None:
        raise NotImplementedError

    def val_iter(self, count: int, recorder):
        raise NotImplementedError

    def checkpoint_trees(self) -> dict:
        """Named trees (nested dicts/lists of tensors or arrays) to
        checkpoint."""
        raise NotImplementedError

    def restore_trees(self, trees: dict) -> None:
        """Adopt trees of numpy arrays read from a checkpoint."""
        raise NotImplementedError

    # -- schedules ----------------------------------------------------------

    def adjust_hyperp(self, epoch: int) -> None:
        """Shared lr-schedule knobs: dict {epoch: lr} or 'step' decay."""
        sched = getattr(self, "config", {}).get("lr_schedule")
        if isinstance(sched, dict) and epoch in sched:
            self.current_lr = float(sched[epoch])
        elif sched == "step":
            every = self.config.get("lr_step_every", 20)
            gamma = self.config.get("lr_step_gamma", 0.1)
            self.current_lr = self.config.get("lr", 0.1) * (
                gamma ** (epoch // every)
            )

    # -- checkpoint / resume ------------------------------------------------

    def save(self, directory: str, recorder=None) -> None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        meta = {"epoch": self.epoch, "lr": self.current_lr,
                "world_size": world, "n_devices": world}
        gb = getattr(getattr(self, "data", None), "global_batch", None)
        if gb is not None:
            meta["global_batch"] = int(gb)
        if recorder is not None:
            meta["recorder"] = recorder.state_dict()
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        trees = {g: _to_numpy(t) for g, t in self.checkpoint_trees().items()}
        ckpt.save_checkpoint(directory, self.epoch, trees, meta)

    def load(self, directory: str, recorder=None) -> bool:
        """Restore the newest checkpoint under ``directory`` that
        verifies; False when there is none."""
        found = ckpt.load_latest(directory, tuple(self.checkpoint_trees()))
        if found is None:
            return False
        _, trees, meta = found
        self.restore_trees(trees)
        self.restored_meta = meta
        self.epoch = int(meta.get("epoch", 0))
        self.current_lr = float(meta.get("lr", self.current_lr))
        if recorder is not None and "recorder" in meta:
            recorder.load_state_dict(meta["recorder"])
        return True


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
