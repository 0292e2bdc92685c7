"""The model contract the workers drive (port of ``TMModel`` and
``ClassifierModel`` of ``theanompi_tpu/models/base.py``, the parts the
BSP path uses).

Workers drive a duck-typed model exposing ``build_model /
compile_iter_fns / train_iter / val_iter / adjust_hyperp / save / load
/ data / epoch / n_epochs / close_feed``.  This base supplies the shared
pieces: the lr schedule, the feed (a ``data.HostStager`` and, with
``loader_pipeline``, a ``data.StreamingLoader``) and the npz checkpoint
round trip.  ``save`` stamps the JAX package's metadata (``epoch``,
``lr``, ``world_size``, ``n_devices``, ``global_batch``, the feed's
``loader_cursor``, the recorder state); only rank 0 of the process
group writes.  ``load`` restores the newest checkpoint that verifies,
through the model's ``restore_trees`` hook.

``ClassifierModel`` is the generic image classifier the CNN zoo
(``wresnet``, ``resnet50``, ``alex_net``, ``vgg16``, ``googlenet``)
subclasses: a net of ``ops.layers`` in fp32 master weights run in the
compute dtype, the synthetic or file-backed data modules fed through
the stager, the streaming feed or the device-resident train set
(``device_data_cache``), momentum SGD, and the JAX step's exchange
(gradients by the named strategy, BN running statistics, loss and
error averaged over the ranks every step).  Its checkpoints hold the
JAX trees (``params``, ``net_state``, ``opt_state``) in the JAX layout
under JAX keystr keys, so they load in either package.
"""

from __future__ import annotations

import os
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from theanompi_tpu_torch.data.pipeline import (
    HostStager,
    StreamingLoader,
    resolve_loader_depth,
)
from theanompi_tpu_torch.ops import optimizers as opt_lib
from theanompi_tpu_torch.ops.layers import (
    accuracy,
    from_jax_layout,
    softmax_cross_entropy,
    to_jax_layout,
)
from theanompi_tpu_torch.parallel.exchange import allreduce_mean
from theanompi_tpu_torch.parallel.mesh import init_group, resolve_device
from theanompi_tpu_torch.parallel.strategies import (
    get_strategy,
    resolve_bucket_mb,
    resolve_compression,
)
from theanompi_tpu_torch.utils import checkpoint as ckpt

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(name) -> torch.dtype:
    """The ``compute_dtype`` config value as a torch dtype."""
    if str(name) not in DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {sorted(DTYPES)}, got {name!r}"
        )
    return DTYPES[str(name)]


#: config knobs of the JAX package that the port does not run yet
UNPORTED_KNOBS = {
    "elastic": "A9 (elastic resume, supervisor and fault drills)",
    "trace": "A13 (span tracing)",
    "step_profile": "A13 (step-phase profiler)",
}


def refuse_unported(cfg: dict) -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP item for a config
    knob (or ``TM_FAULT_AT``) of a feature the port does not run yet,
    and ``ValueError`` for a bad ``loader_pipeline``.  Training paths
    only: the serving fleet runs its ``TM_FAULT_AT`` drills
    (``die_replica``, ``spike_load``; ``utils/faults.py``), and a
    serving decoder builds whatever the variable holds."""
    for knob, item in UNPORTED_KNOBS.items():
        if cfg.get(knob):
            raise NotImplementedError(
                f"config {knob}={cfg[knob]!r} is not ported yet "
                f"(ROADMAP.md {item})"
            )
    if os.environ.get("TM_FAULT_AT"):
        raise NotImplementedError(
            f"TM_FAULT_AT={os.environ['TM_FAULT_AT']!r}: the training "
            f"fault drills and their supervisor are not ported yet "
            f"(ROADMAP.md A9; the serving fleet's die_replica and "
            f"spike_load drills run)"
        )
    resolve_loader_depth(cfg)
    if int(cfg.get("steps_per_call", 0) or 0) > 1:
        raise NotImplementedError(
            "steps_per_call > 1 (several steps a call over the "
            "device-resident data) is not ported yet (ROADMAP.md A7)"
        )


class TMModel:
    """Abstract contract; subclass or duck-type it."""

    data: Any
    #: ``restore_trees`` takes each group as ``{keystr: array}``
    flat_checkpoint: bool = False
    epoch: int = 0
    n_epochs: int = 1
    current_lr: float = 0.0
    #: the host→device path and, with ``loader_pipeline``, the
    #: streaming feed (built by ``compile_iter_fns``)
    _stager: HostStager | None = None
    _feed: StreamingLoader | None = None
    _device_cache = None

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

    # -- the feed (theanompi_tpu_torch/data: the data plane) ---------------

    def _init_feed(self, batch_size: int, dtypes=None) -> None:
        """Build the host→device path of this compile: a
        :class:`HostStager` over this rank's ``batch_size`` rows always,
        plus a :class:`StreamingLoader` feed when ``loader_pipeline``
        asks for one and no device-resident dataset is live (that path
        moves no batch bytes a step: a feed behind it would only burn a
        thread)."""
        self.close_feed()
        depth = resolve_loader_depth(getattr(self, "config", {}))
        self._stager = HostStager(self.device, batch_size, self._rank,
                                  dtypes=dtypes, slots=depth + 1)
        if not depth:
            return
        if self._device_cache is not None:
            warnings.warn(
                "loader_pipeline requested alongside an active "
                "device_data_cache path; the device cache already moves "
                "zero bytes per step — streaming feed disabled",
                stacklevel=3,
            )
            return
        data = self.data
        # a synthetic set builds its train arrays at the first read
        # (seconds at ImageNet shapes, past the feed's timeout): build
        # them here, before the producer starts
        perm = getattr(data, "epoch_permutation", None)
        if perm is not None:
            perm()
        self._feed = StreamingLoader(
            data.train_batch,
            self._stager.stage,
            n_batches=lambda: data.n_batch_train,
            depth=depth,
            global_batch=int(data.global_batch),
            sample_ids=getattr(data, "batch_indices", None),
            journal_meta=self._feed_meta,
            device=self.device,
        )

    def _feed_meta(self) -> dict:
        """Journal stamp of the feed's sample-id accounting: the epoch,
        and the world each delivery happened under."""
        return {"epoch": int(self.epoch), "world": int(self._world)}

    def close_feed(self) -> None:
        """Stop the streaming feed's producer thread (run exit,
        recompiles).  Idempotent; a no-op on the synchronous feed."""
        if self._feed is not None:
            self._feed.stop()
        self._feed = None

    # -- checkpoint / resume ------------------------------------------------

    def save(self, directory: str, recorder=None) -> None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        meta = {"epoch": self.epoch, "lr": self.current_lr,
                "world_size": world, "n_devices": world}
        gb = getattr(getattr(self, "data", None), "global_batch", None)
        if gb is not None:
            meta["global_batch"] = int(gb)
        # the stream cursor: epoch + next sample offset identify the
        # position exactly (the permutation is reseeded by shuffle)
        if self._feed is not None:
            meta["loader_cursor"] = dict(self._feed.cursor(),
                                         epoch=self.epoch)
        if recorder is not None:
            meta["recorder"] = recorder.state_dict()
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        trees = {g: _to_numpy(t) for g, t in self.checkpoint_trees().items()}
        ckpt.save_checkpoint(directory, self.epoch, trees, meta)

    def load(self, directory: str, recorder=None) -> bool:
        """Restore the newest checkpoint under ``directory`` that
        verifies; False when there is none."""
        found = ckpt.load_latest(directory, tuple(self.checkpoint_trees()),
                                 self.flat_checkpoint)
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


# -- the image classifier ------------------------------------------------------

def _nest(flat: dict) -> dict:
    """``{key path: array}`` -> nested dicts (int keys for the JAX
    tree's list nodes, which ``checkpoint.tree_to_flat`` writes under
    the same keystr keys as a list)."""
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = arr
    return tree


def _as_flat(tree) -> dict:
    """A group as ``{keystr: array}``: a nested tree (e.g.
    ``jax.device_get(model.params)``) is flattened, a flat checkpoint
    group passes through."""
    if isinstance(tree, dict) and all(
            isinstance(k, str) and k.startswith("[") for k in tree):
        return tree
    return ckpt.tree_to_flat(tree)


class ClassifierModel(TMModel):
    """Generic image classifier satisfying the contract.

    Subclasses set, in ``build_model``: ``self.net`` (an
    ``ops.layers.Layer`` ending in logits), ``self.input_shape`` (per
    example, ``(H, W, C)``) and ``self.data``, then call
    ``_init_params``.  Config knobs follow the JAX package:
    ``batch_size`` (per rank), ``n_epochs``, ``lr``, ``lr_schedule``,
    ``momentum``, ``weight_decay``, ``compute_dtype``, ``seed``,
    ``exch_strategy``, ``exchange_bucket_mb``, ``loader_pipeline``,
    ``device_data_cache``.  ``device`` defaults to the card;
    ``device="cpu"`` runs on the CPU.
    """

    flat_checkpoint = True

    def __init__(self, config: dict | None = None, device=None):
        self.config = dict(config or {})
        refuse_unported(self.config)
        self.n_epochs = int(self.config.get("n_epochs", 10))
        self.epoch = 0
        self.current_lr = float(self.config.get("lr", 0.1))
        self.compute_dtype = resolve_dtype(
            self.config.get("compute_dtype", "bfloat16"))
        self.seed = int(self.config.get("seed", 42))
        self.net = None
        self.data = None
        self.input_shape: tuple = ()
        self.optimizer = opt_lib.momentum(
            mu=float(self.config.get("momentum", 0.9)),
            weight_decay=float(self.config.get("weight_decay", 1e-4)),
        )
        self.params: list | None = None
        self.opt_state = None
        self._mean = None             # the data's device_mean, at compile
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)

    # -- construction -------------------------------------------------------

    def build_model(self, n_replicas: int = 1) -> None:
        """Define ``self.net``/``self.data`` and initialize params."""
        raise NotImplementedError

    def _init_params(self) -> None:
        """Draw the net's parameters from ``self.generator`` reseeded
        with ``seed`` (the JAX init's distributions, not its numbers),
        and fresh optimizer state."""
        self.generator.manual_seed(self.seed)
        self._out_shape = self.net.init(self.generator, self.input_shape)
        self._params_at = self.net.jax_entries("params")
        self._state_at = self.net.jax_entries("state")
        self.params = [t for t, _ in self._params_at.values()]
        self.net_state = [t for t, _ in self._state_at.values()]
        self.opt_state = self.optimizer.init(self.params)

    def compile_iter_fns(self, exch_strategy: str | None = None,
                         **unknown) -> None:
        """Resolve the exchange and join (or create, one rank) the
        process group; each rank takes rows ``[r*B, (r+1)*B)`` of the
        global batch, as the JAX ``shard_map`` splits it."""
        if unknown:
            raise TypeError(
                f"{type(self).__name__}.compile_iter_fns: unknown kwargs "
                f"{sorted(unknown)}"
            )
        if self.net is None:
            raise RuntimeError("call build_model() before compile_iter_fns()")
        self._strategy = get_strategy(
            exch_strategy or self.config.get("exch_strategy", "ici32"))
        resolve_compression(self.config)
        self._bucket_elems = self._strategy.bucket_elems(
            resolve_bucket_mb(self.config))
        if not dist.is_initialized():
            init_group(self.device)        # a one-rank group of its own
        self._rank, self._world = dist.get_rank(), dist.get_world_size()
        if self._world * self.data.batch_size != self.data.global_batch:
            raise ValueError(
                f"{self._world} ranks x per-rank batch "
                f"{self.data.batch_size} != global batch "
                f"{self.data.global_batch} (build_model n_replicas must "
                f"match the group)"
            )
        if self.params is None:
            self._init_params()
        # dropout masks: one stream per rank, as the JAX step folds the
        # device index into its key
        self._dropout_gen = torch.Generator(device=self.device)
        self._dropout_gen.manual_seed(self.seed * 1000003 + self._rank)
        self._init_input_mean()
        self._device_cache = None
        if self.config.get("device_data_cache"):
            self._init_device_cache()
        self._init_feed(self.data.batch_size, dtypes=(None, torch.int64))

    def _init_input_mean(self) -> None:
        """The data's ``device_mean`` (uint8 batches) on the device in the
        compute dtype, for ``prep_input`` to subtract."""
        m = getattr(self.data, "device_mean", None)
        self._mean = None if m is None else torch.as_tensor(
            np.asarray(m), device=self.device).to(self.compute_dtype)

    def _init_device_cache(self) -> None:
        """Put the whole train set on the device once
        (``device_data_cache``): floats in the compute dtype, labels as
        int64.  Each step then gathers its rows there from the epoch
        permutation (put there once an epoch), so steady-state steps
        move no image bytes from the host."""
        get = getattr(self.data, "dataset_arrays", None)
        arrays = get("train") if get is not None else None
        if arrays is None:
            warnings.warn(
                "device_data_cache requested but the data object does "
                "not expose dataset_arrays(); falling back to per-step "
                "staging",
                stacklevel=2,
            )
            return
        xs, ys = (torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
        xs = xs.to(self.device)
        if xs.is_floating_point():
            xs = xs.to(self.compute_dtype)
        self._device_cache = (xs, ys.to(self.device, torch.int64))
        self._perm_src = self._perm_dev = None

    def _cached_batch(self, count: int):
        """This rank's rows of train batch ``count``, gathered on the
        device: the rows ``[r*B, (r+1)*B)`` of the global batch, as the
        staged path takes them."""
        perm = self.data.epoch_permutation()
        if perm is not self._perm_src:
            self._perm_src = perm
            self._perm_dev = torch.from_numpy(
                np.asarray(perm, np.int64)).to(self.device)
        b = self.data.batch_size
        lo = count * self.data.global_batch + self._rank * b
        idx = self._perm_dev[lo:lo + b]
        return tuple(a.index_select(0, idx) for a in self._device_cache)

    # -- loss hooks ---------------------------------------------------------

    def prep_input(self, x: torch.Tensor) -> torch.Tensor:
        """The raw NHWC batch cast to the compute dtype, minus the data's
        ``device_mean`` when it has one (uint8 batches), as the NCHW-
        indexed ``channels_last`` view the net takes."""
        x = x.to(self.compute_dtype)
        if self._mean is not None:
            x = x - self._mean
        return x.permute(0, 3, 1, 2)

    def primary_logits(self, out):
        """The main logits of the net output (default: identity)."""
        return out

    def compute_loss(self, out, y):
        return softmax_cross_entropy(self.primary_logits(out), y)

    # -- iteration ----------------------------------------------------------

    def put_batch(self, batch):
        """This rank's rows of a global (x, y) host batch, on the device
        through the compile's :class:`HostStager` (labels as int64)."""
        return self._stager.stage(batch).wait()

    def _rank_mean(self, *xs) -> torch.Tensor:
        stats = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                             device=self.device)
                             for x in xs])
        dist.all_reduce(stats)
        return stats / self._world

    def train_iter(self, count: int, recorder) -> None:
        recorder.start()
        if self._device_cache is not None:
            x, y = self._cached_batch(count)
        elif self._feed is not None:
            # fetched and staged by the producer thread under the last
            # step: the wait segment is a ring pop
            x, y = self._feed.next(count).wait()
        else:
            x, y = self.put_batch(self.data.train_batch(count))
        recorder.end("wait")
        recorder.start()
        out = self.net(self.prep_input(x), train=True, gen=self._dropout_gen)
        loss = self.compute_loss(out, y)
        err = 1.0 - accuracy(self.primary_logits(out).detach(), y)
        # a conv's weight gradient may come back in channels_last
        # strides; the exchange packs flat views
        grads = [g.contiguous()
                 for g in torch.autograd.grad(loss, self.params)]
        # BN running statistics ride the step's reduce, every step, so
        # every rank evaluates with the same statistics
        allreduce_mean(self.net_state)
        self._strategy(grads, bucket_elems=self._bucket_elems)
        self.opt_state = self.optimizer.update(self.params, grads,
                                               self.opt_state,
                                               self.current_lr)
        stats = self._rank_mean(loss.detach(), err)
        recorder.end("calc")
        recorder.train_error(count, stats[0], stats[1])

    @torch.no_grad()
    def val_iter(self, count: int, recorder):
        x, y = self.put_batch(self.data.val_batch(count))
        logits = self.primary_logits(self.net(self.prep_input(x)))
        stats = self._rank_mean(
            softmax_cross_entropy(logits, y),
            1.0 - accuracy(logits, y),
            1.0 - accuracy(logits, y, k=5),
        )
        return tuple(float(v) for v in stats)

    # -- checkpoint: the JAX trees ------------------------------------------

    def _jax_tree(self, at: dict, tensors=None) -> dict:
        """The tensors of ``at`` (or ``tensors``, one per entry of
        ``at``, e.g. the momentum velocity) as a JAX-layout tree."""
        if tensors is None:
            tensors = [t for t, _ in at.values()]
        return _nest({path: to_jax_layout(t, layout) for (path, (_, layout)),
                      t in zip(at.items(), tensors)})

    def checkpoint_trees(self) -> dict:
        return {"params": self._jax_tree(self._params_at),
                "net_state": self._jax_tree(self._state_at),
                # the momentum velocity is a params-shaped tree, SGD's
                # state the empty tuple, in either package
                "opt_state": (self._jax_tree(self._params_at, self.opt_state)
                              if self.opt_state else ())}

    @torch.no_grad()
    def _copy_in(self, at: dict, tree, tensors=None, what="params") -> None:
        """Copy a JAX-layout group (nested or ``{keystr: array}``) into
        the tensors of ``at`` (or ``tensors``), key path by key path:
        every leaf the net has must be there with its shape, and
        nothing else."""
        flat = _as_flat(tree)
        keys = {ckpt.keystr(path): e for path, e in at.items()}
        if set(flat) != set(keys):
            raise ValueError(
                f"{what}: checkpoint keys do not match the net: missing "
                f"{sorted(set(keys) - set(flat))[:5]}, unexpected "
                f"{sorted(set(flat) - set(keys))[:5]}"
            )
        if tensors is None:
            tensors = [t for t, _ in at.values()]
        for (key, (_, layout)), t in zip(keys.items(), tensors):
            src = from_jax_layout(flat[key], layout)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{what} {key}: shape {tuple(src.shape)}, "
                                 f"expected {tuple(t.shape)}")
            t.copy_(src)

    def restore_trees(self, trees: dict) -> None:
        self._copy_in(self._params_at, trees["params"])
        self._copy_in(self._state_at, trees["net_state"], what="net_state")
        if self.opt_state:
            self._copy_in(self._params_at, trees["opt_state"],
                          self.opt_state, "opt_state")

    @classmethod
    def save_init_checkpoint(cls, config: dict, directory) -> None:
        """Write the model's seeded initial state — fp32 parameters drawn
        on the CPU, fresh BN statistics and optimizer state — as
        checkpoint 0 stamped epoch -1, which a run with ``resume=True``
        starts epoch 0 from.  Runs on different devices start from the
        same parameters this way (a generator draws other numbers on
        the card than on the CPU)."""
        model = cls(config, device="cpu")
        model.build_model()
        ckpt.save_checkpoint(directory, 0, model.checkpoint_trees(),
                             {"epoch": -1, "lr": model.current_lr})
