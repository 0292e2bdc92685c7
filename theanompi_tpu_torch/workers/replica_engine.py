"""Model replicas for the asynchronous rules (EASGD, GoSGD).

Port of ``theanompi_tpu/workers/replica_engine.py``.  The reference ran
the async rules as independent processes, each with its own model copy
(``theanompi/easgd_worker.py``, ``gosgd_worker.py``).  The JAX package
keeps one controller and gives every device of its mesh its own
replica.  Here one process holds W replicas on one device: every
per-worker leaf — parameters, BN running statistics, optimizer state —
is one tensor with a leading worker axis ``[W, ...]``, so each exchange
(``parallel.exchange.elastic_*``/``gossip_*``) is one batched op over
that axis, as in JAX.

The local step runs replica by replica: the model's own parameter and
buffer tensors are pointed (``.data``) at slot w of the stacks, so the
forward, the in-place optimizer update and BN's in-place running
statistics read and write that replica's slot.  Batching the replicas
into one step (``torch.func.vmap``) meets BN's autograd function, which
has no vmap rule and updates its statistics in place; that is later
perf work (ROADMAP.md B).  Dropout draws from one ``torch.Generator``
per replica, so its masks are not the JAX ones.

A global batch ``[W*B, ...]`` is staged whole through a
``data.HostStager`` and split ``[W, B, ...]``: replica w takes rows
``[w*B, (w+1)*B)``, as the JAX engine shards the worker axis.
"""

from __future__ import annotations

import numpy as np
import torch

from theanompi_tpu_torch.data.pipeline import HostStager, resolve_loader_depth
from theanompi_tpu_torch.models.base import ClassifierModel
from theanompi_tpu_torch.ops.layers import accuracy, softmax_cross_entropy
from theanompi_tpu_torch.parallel.exchange import tree_map
from theanompi_tpu_torch.parallel.mesh import (
    resolve_replica_devices,
    resolve_worker_devices,
)
from theanompi_tpu_torch.workers.bsp_worker import _resolve_model


def resolve_async_run(rule: str, devices, modelfile: str, modelclass: str,
                      config, extra: dict, n_epochs, world_size=None):
    """``(device, n_workers, Model, cfg)`` of an async run, every
    refusal made before the model is built.  In one process the
    ``devices`` entries name one device, once per worker; in a
    multi-process run (``world_size`` given) this process is one worker
    and ``devices`` names its one device (``ValueError`` otherwise: one
    process drives one device).  A model the workers cannot drive
    raises ``TypeError``, a bad ``loader_pipeline`` ``ValueError``.  The
    rules step each replica once a call, as the JAX workers do:
    ``steps_per_call`` does not change them."""
    if world_size is not None:
        devs = resolve_worker_devices(devices)
        if len(devs) != 1:
            raise ValueError(
                f"{rule}: this process of a {world_size}-process run was "
                f"given {len(devs)} devices ({devices}); one process drives "
                f"one device (launcher.launch(mode='subprocess') hands each "
                f"process its own)")
        device, n_workers = devs[0], 1
    else:
        device, n_workers = resolve_replica_devices(devices)
    Model = _resolve_model(modelfile, modelclass)
    if not (isinstance(Model, type) and issubclass(Model, ClassifierModel)):
        raise TypeError(
            f"{rule} drives a ClassifierModel's replicas (net, optimizer, "
            f"loss); {modelfile}.{modelclass} is not one")
    cfg = dict(config or {})
    cfg.update(extra)
    if n_epochs is not None:
        cfg["n_epochs"] = n_epochs
    resolve_loader_depth(cfg)       # a bad loader_pipeline fails here
    return device, n_workers, Model, cfg


@torch.no_grad()
def load_leaves(tensors, leaves) -> None:
    """Copy host leaves (numpy arrays or CPU tensors) into ``tensors``
    in place: the same tensor objects, which the model's net and
    optimizer hold, take the new values."""
    for t, a in zip(tensors, leaves):
        t.copy_(torch.as_tensor(a))


def broadcast_stack(tree, n: int):
    """Every leaf repeated along a new leading worker axis of size
    ``n`` (a contiguous copy)."""
    return tree_map(
        lambda x: x.detach().unsqueeze(0).expand((n,) + tuple(x.shape))
        .clone(), tree)


def stacked_mean(tree, weights: torch.Tensor | None = None):
    """The leading worker axis collapsed by a (weighted) mean in fp32,
    cast back to each leaf's dtype."""

    def one(x):
        f32 = x.float()
        if weights is None:
            m = f32.mean(dim=0)
        else:
            w = weights.float()
            m = torch.tensordot(w / w.sum(), f32, dims=([0], [0]))
        return m.to(x.dtype)

    return tree_map(one, tree)


class ReplicaEngine:
    """W independent replicas of a built ``ClassifierModel`` on its
    device (see the module docstring).  ``params``/``net_state`` are
    lists of ``[W, ...]`` tensors in the model's order, ``opt_state``
    the optimizer's tree with every leaf stacked."""

    def __init__(self, model, n_workers: int):
        self.model = model
        self.device = model.device
        self.n_workers = int(n_workers)
        if model.params is None:
            model._init_params()
        model._init_input_mean()
        self.params = broadcast_stack(model.params, self.n_workers)
        self.net_state = broadcast_stack(model.net_state, self.n_workers)
        # a resumed run restores the checkpointed consensus momentum
        # into model.opt_state first: every replica starts from it
        self.opt_state = broadcast_stack(model.opt_state, self.n_workers)
        self._gens = []
        for w in range(self.n_workers):
            g = torch.Generator(device=self.device)
            g.manual_seed((model.seed + 17) * 1000003 + w)
            self._gens.append(g)
        depth = resolve_loader_depth(getattr(model, "config", {}))
        self._stager = HostStager(self.device, model.data.global_batch,
                                  dtypes=(None, torch.int64),
                                  slots=depth + 1)

    # -- batches ------------------------------------------------------------

    def put_batch(self, batch):
        """A host global batch ``[W*B, ...]`` staged on the device whole
        (a ``StagedBatch``; the step splits it ``[W, B, ...]``)."""
        return self._stager.stage(batch)

    def _split(self, staged):
        w = self.n_workers
        return tuple(t.reshape((w, -1) + tuple(t.shape[1:]))
                     for t in staged.wait())

    # -- stepping -----------------------------------------------------------

    def _bind(self, params, net_state) -> None:
        """Point the model's parameter and buffer tensors at these."""
        for p, t in zip(self.model.params, params):
            p.data = t
        for b, t in zip(self.model.net_state, net_state):
            b.data = t

    def _local_step(self, w: int, x, y, lr: float):
        """One SGD step of replica ``w`` on its shard, written into slot
        ``w`` of the stacks; (loss, err) as device scalars."""
        m = self.model
        self._bind([p[w] for p in self.params],
                   [s[w] for s in self.net_state])
        opt = tree_map(lambda s: s[w], self.opt_state)
        out = m.net(m.prep_input(x), train=True, gen=self._gens[w])
        loss = m.compute_loss(out, y)
        err = 1.0 - accuracy(m.primary_logits(out).detach(), y)
        grads = [g.contiguous() for g in torch.autograd.grad(loss, m.params)]
        new = m.optimizer.update(m.params, grads, opt, lr)

        def write(slot, leaf):
            # the momentum velocity is updated in place; Adam's step
            # counter is replaced by a new tensor
            if leaf.data_ptr() != slot.data_ptr():
                slot.copy_(leaf)

        with torch.no_grad():
            tree_map(lambda s, leaf: write(s[w], leaf), self.opt_state, new)
        return loss.detach(), err

    def train_step(self, batch, lr: float, step_mask=None):
        """One local SGD step on every replica; returns mean (loss, err)
        as device scalars (see ``train_step_staged``)."""
        return self.train_step_staged(self.put_batch(batch), lr, step_mask)

    def train_step_staged(self, staged, lr: float, step_mask=None):
        """``train_step`` on a batch from ``put_batch``.  ``step_mask``
        (``[W]`` {0,1}) advances only the masked workers: the others'
        params, BN statistics and optimizer state are left untouched,
        and the mean (loss, err) is over the active workers."""
        xs, ys = self._split(staged)
        stats = [self._local_step(w, xs[w], ys[w], lr)
                 for w in range(self.n_workers)
                 if step_mask is None or step_mask[w]]
        if not stats:
            zero = torch.zeros((), device=self.device)
            return zero, zero
        losses, errs = (torch.stack(v) for v in zip(*stats))
        return losses.mean(), errs.mean()

    @torch.no_grad()
    def val_step(self, batch, params=None, net_state=None):
        """Validate: by default replica w scores its own shard of the
        batch and the means are averaged; unstacked ``params`` (the
        EASGD center) with ``net_state`` (default: the replicas' mean)
        are scored on every shard instead."""
        m = self.model
        xs, ys = self._split(self.put_batch(batch))
        if params is not None:
            self._bind(params, self.mean_net_state() if net_state is None
                       else net_state)
        stats = []
        for w in range(self.n_workers):
            if params is None:
                self._bind([p[w] for p in self.params],
                           [s[w] for s in self.net_state])
            logits = m.primary_logits(m.net(m.prep_input(xs[w])))
            stats.append(torch.stack([
                softmax_cross_entropy(logits, ys[w]),
                1.0 - accuracy(logits, ys[w]),
                1.0 - accuracy(logits, ys[w], k=5)]))
        return tuple(float(v) for v in torch.stack(stats).mean(dim=0))

    def validate(self, data, params=None, net_state=None):
        """A full validation sweep: mean ``(loss, err, err5)`` over
        ``data.n_batch_val`` batches."""
        tot = np.zeros(3)
        for j in range(data.n_batch_val):
            tot += self.val_step(data.val_batch(j), params=params,
                                 net_state=net_state)
        tot /= max(data.n_batch_val, 1)
        return tuple(tot)

    # -- consensus ----------------------------------------------------------

    def mean_params(self, weights=None):
        return stacked_mean(self.params, weights)

    def mean_net_state(self, weights=None):
        return stacked_mean(self.net_state, weights)

    def mean_opt_state(self, weights=None):
        return stacked_mean(self.opt_state, weights)

    def adopt(self, params, net_state, opt_state) -> None:
        """Set the model's own state to copies of these unstacked trees
        (the EASGD center, the best GoSGD replica), no longer views of
        the stacks, for its checkpoint and its caller."""
        self._bind([t.detach().clone() for t in params],
                   [t.detach().clone() for t in net_state])
        self.model.opt_state = tree_map(lambda t: t.detach().clone(),
                                        opt_state)
