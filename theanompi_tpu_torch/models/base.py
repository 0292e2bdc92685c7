"""The model contract the workers drive (port of ``TMModel`` and
``ClassifierModel`` of ``theanompi_tpu/models/base.py``, the parts the
BSP path uses).

Workers drive a duck-typed model exposing ``build_model /
compile_iter_fns / train_iter / val_iter / adjust_hyperp / save / load
/ data / epoch / n_epochs / close_feed``.  This base supplies the shared
pieces: the lr schedule, the feed (a ``data.HostStager`` and, with
``loader_pipeline``, a ``data.StreamingLoader``), the step's exchange
and optimizer update, and the checkpoint round trip.

- The exchange (``_compile_exchange``, ``_exchange_update``): the named
  strategy's allreduce-mean then the optimizer over the model's
  tensors; ``zero1``/``zero1_16``, ``scatter_update_gather`` over the
  flat layout with the optimizer state as this rank's flat shard; with
  ``exch_compression``, the quantized wire with its error-feedback
  residuals (``ef_state``: ``r1``, and ``r2`` without zero1).  The flat
  layout packs the parameters in the JAX leaf order and layout
  (``_exchange_order``), so the flat state crosses between the
  packages.
- ``save`` stamps the JAX package's metadata (``epoch``, ``lr``,
  ``world_size``, ``n_devices``, ``global_batch``, the feed's
  ``loader_cursor``, the recorder state, ``zero1_layout`` and
  ``ef_layout``).  Rank 0 writes an npz; a run whose state is split
  over more than one rank (zero1, the EF residuals) writes a
  ``.shards`` checkpoint, every rank its own shards.
- ``save(extra_meta=...)`` adds to the stamps (the preemption path's
  ``next_iter``); ``config["keep_last_checkpoints"]`` prunes older
  checkpoints past the newest N.
- ``load`` restores the newest checkpoint (either format) through the
  model's ``restore_trees`` hook, after the JAX package's layout
  guards.  It validates first (``config["validate_checkpoint"]``,
  default on): a checkpoint that fails its digests is quarantined as
  ``*.corrupt`` (by rank 0) and the previous one is used.
  ``load(reshard=True)`` — or ``config["elastic"]`` when the caller
  passes no ``reshard`` — re-lays a zero1 or EF state saved at another
  world size or bucket layout (``utils/reshard.py``).

``ClassifierModel`` is the generic image classifier the CNN zoo
(``wresnet``, ``resnet50``, ``alex_net``, ``vgg16``, ``googlenet``)
subclasses: a net of ``ops.layers`` in fp32 master weights run in the
compute dtype, the synthetic or file-backed data modules fed through
the stager, the streaming feed or the device-resident train set
(``device_data_cache``; each step's rows gathered on the device from
the epoch permutation, and with ``steps_per_call`` K > 1
``train_chunk`` runs K steps a call with no host fence among them, the
loss and error averaged over the ranks once a chunk), momentum SGD, and the JAX step's exchange
(gradients by the named strategy and BN running statistics every step,
loss and error averaged over the ranks).  Its checkpoints hold the
JAX trees (``params``, ``net_state``, ``opt_state``) in the JAX layout
under JAX keystr keys, so they load in either package.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from theanompi_tpu_torch.data.pipeline import (
    HostStager,
    StreamingLoader,
    resolve_loader_depth,
)
from theanompi_tpu_torch.obs.profiler import scope
from theanompi_tpu_torch.ops import optimizers as opt_lib
from theanompi_tpu_torch.ops.layers import (
    accuracy,
    from_jax_layout,
    jax_view,
    softmax_cross_entropy,
    to_jax_layout,
)
from theanompi_tpu_torch.parallel.exchange import (
    allreduce_mean,
    compressed_allreduce_mean,
    flat_spec,
    scatter_update_gather,
)
from theanompi_tpu_torch.parallel.mesh import init_group, resolve_device
from theanompi_tpu_torch.parallel.strategies import (
    get_strategy,
    resolve_bucket_mb,
    resolve_compression,
)
from theanompi_tpu_torch.utils import checkpoint as ckpt
from theanompi_tpu_torch.utils import reshard as reshard_lib
from theanompi_tpu_torch.utils.sharded_checkpoint import (
    ShardedLeaf,
    is_sharded_checkpoint,
    save_sharded_checkpoint,
    saved_shapes,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(name) -> torch.dtype:
    """The ``compute_dtype`` config value as a torch dtype."""
    if str(name) not in DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {sorted(DTYPES)}, got {name!r}"
        )
    return DTYPES[str(name)]


def resume_checkpoint(directory: str | Path, validate: bool = True,
                      device: torch.device | None = None) -> Path | None:
    """The checkpoint a resume loads, chosen once for every rank: rank 0
    takes the newest that passes validation (``latest_checkpoint``,
    which quarantines each corrupt one it meets) and broadcasts its step
    and format, so a checkpoint is hashed once a life, not once a rank.
    ``device``: where the group's tensors live (the card under nccl)."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return ckpt.latest_checkpoint(directory, validate=validate)
    pick = torch.full((2,), -1, dtype=torch.int64, device=device)
    if dist.get_rank() == 0:
        path = ckpt.latest_checkpoint(directory, validate=validate)
        if path is not None:
            m = ckpt._CKPT_RE.fullmatch(path.name)
            pick[0], pick[1] = int(m.group(1)), int(m.group(2) == ".shards")
    dist.broadcast(pick, src=0)
    step, sharded = pick.tolist()
    if step < 0:
        return None
    return Path(directory) / f"ckpt_{step}{'.shards' if sharded else '.npz'}"


def refuse_layout_exchange(cfg: dict, zero1: bool,
                           compression: str | None) -> None:
    """The exchange states a Llama layout cannot carry, refused before
    anything is built: zero1 and the compressed wire with MoE experts
    (the JAX package's own ``NotImplementedError``s: expert and dense
    leaves exchange over different groups)."""
    if int(cfg.get("n_experts", 0)):
        if zero1:
            raise NotImplementedError(
                "exch_strategy='zero1' does not yet compose with MoE "
                "expert sharding (n_experts > 0): expert leaves exchange "
                "over data alone while dense leaves exchange over "
                "(expert, data) — two separate shard groups")
        if compression:
            raise NotImplementedError(
                "exch_compression does not yet compose with MoE expert "
                "sharding (n_experts > 0): expert and dense leaves "
                "exchange over different shard groups, so there is no "
                "single flat buffer to quantize (same split that keeps "
                "MoE+zero1 NotImplementedError)")


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
    #: the exchange of the compile (``_compile_exchange``)
    _rank: int = 0
    _world: int = 1
    #: the exchange's group when the model lays the world out (tp, sp;
    #: ``_rank``/``_world`` are then its data coordinate and size): the
    #: data axis, or (data × seq) on an f32 wire at sp > 1; None: the
    #: default group, every rank a data replica
    _dp_group = None
    #: the seq axis's group at sp > 1 on a 16-bit wire, under zero1 or
    #: with a compression: the gradients' f32 mean over it comes before
    #: the data exchange
    _seq_group = None
    #: at pp > 1: (the pipe group, the indices of the leaves the stages
    #: all hold): their gradients are summed over it in f32 first
    _pipe_sum: tuple | None = None
    #: with MoE: the indices of the expert leaves, exchanged over
    #: ``_expert_dp_group`` (data, or data × seq on an f32 wire; None:
    #: the default group) and divided by ``_ep``; the exchange then runs
    #: per leaf, unbucketed, as JAX's does
    _expert_leaves: frozenset = frozenset()
    _expert_dp_group = None
    _ep: int = 1
    #: under the compressed wire at a layout: ``(src, group, indices)``
    #: of the leaves several model ranks or stages hold whole, brought
    #: back to the group's first rank's values (``src``, a global rank)
    #: after each update
    _replicated: tuple = ()
    #: whether ``checkpoint_trees`` is a collective (it gathers shards)
    _save_collective: bool = False
    _zero1: bool = False
    _compression: str | None = None
    _fspec = None
    #: the flat state's blocks: this rank's coordinate ``((p·E + e)·D +
    #: d)·M + m`` among the ``P·E·D·M`` of the JAX ``P((pipe, expert,
    #: data, model))`` sharding (the data rank without a layout), and
    #: whether it writes its block (seq rank 0: the seq ranks hold equal
    #: shards)
    _flat_at: int = 0
    _n_flat: int = 1
    _flat_writer: bool = True
    _zero1_layout: tuple | None = None
    _ef_layout: tuple | None = None
    ef_state: dict = {}

    def build_model(self, n_replicas: int = 1) -> None:
        raise NotImplementedError

    def compile_iter_fns(self, **kwargs) -> None:
        raise NotImplementedError

    def train_iter(self, count: int, recorder) -> None:
        raise NotImplementedError

    def val_iter(self, count: int, recorder):
        raise NotImplementedError

    # -- K steps a call over the device-resident data (steps_per_call) -----

    #: the chunk length ``train_chunk`` runs as one call (0: none; set
    #: by a model whose device-resident path is live)
    _chunk_k: int = 0

    def preferred_chunk(self, remaining: int) -> int:
        """Steps ``train_chunk`` should take in one call: the chunk
        length when the device-resident path is live and fits in
        ``remaining``, else 1."""
        if self._chunk_k and remaining >= self._chunk_k:
            return self._chunk_k
        return 1

    def train_chunk(self, count: int, k: int, recorder) -> None:
        """Steps ``count .. count+k-1``.  On a device-resident path
        (``_device_cache``) the ``k`` steps run with no host fence among
        them, each on the rows of its own batch (the model's
        ``_cached_batch`` and ``_train_step``), their f32 ``[loss, err]``
        stacked on the device and meaned over the ranks once
        (``_rank_mean``), one record of the ``k`` (the model's
        ``train_iter`` there is a chunk of one); otherwise a per-step
        ``train_iter`` loop."""
        if self._device_cache is None:
            for j in range(k):
                self.train_iter(count + j, recorder)
            return
        recorder.start()
        self._stage_cached_perm()
        recorder.end("wait")
        recorder.start()
        rows = []
        for j in range(k):
            rows.append(self._train_step(*self._cached_batch(count + j)))
        stats = self._rank_mean(torch.stack(rows))
        recorder.end("calc")
        recorder.train_error(count, stats[:, 0], stats[:, 1])

    def _stage_cached_perm(self) -> None:
        """Put the epoch permutation on the device when it changed: with
        the train set there, the one host→device transfer of the path,
        once an epoch."""
        perm = self.data.epoch_permutation()
        if perm is not self._perm_src:
            self._perm_src = perm
            self._perm_dev = torch.from_numpy(
                np.asarray(perm, np.int64)).to(self.device)

    def _cached_rows(self, count: int) -> torch.Tensor:
        """This replica's sample ids of train batch ``count``: rows
        ``[r*B, (r+1)*B)`` of the global batch in the epoch permutation
        on the device, r this rank's replica coordinate, as the staged
        path takes them.  The batch index is the host's own, so a run
        resumed inside an epoch takes the batches it stopped at."""
        self._stage_cached_perm()
        lo = count * self.data.global_batch + self._rank * self._b_loc
        return self._perm_dev[lo:lo + self._b_loc]

    def _init_cached_steps(self, b_loc: int, k: int) -> None:
        """The chunk length of a live device-resident path: ``k`` steps
        a ``train_chunk`` call (0 or 1: none), ``b_loc`` rows a
        replica."""
        self._chunk_k = k if k > 1 else 0
        self._b_loc = b_loc
        self._perm_src = self._perm_dev = None

    def checkpoint_trees(self) -> dict:
        """Named trees (nested dicts/lists of tensors or arrays) to
        checkpoint."""
        raise NotImplementedError

    def restore_trees(self, trees: dict) -> None:
        """Adopt trees of numpy arrays read from a checkpoint."""
        raise NotImplementedError

    # -- a step's FLOPs ------------------------------------------------------

    def _step_loss(self, count: int):
        """``(loss, leaves)`` of train batch ``count``'s forward, the
        graph ``train_step_flops`` differentiates."""
        raise NotImplementedError

    def train_step_flops(self, count: int = 0) -> float:
        """One training step's FLOPs on this rank (the counterpart of
        the JAX ``train_step_cost_analysis``): the forward and backward
        of batch ``count`` counted by ``torch.utils.flop_counter.
        FlopCounterMode`` (remat's replayed forward included), plus the
        operations of the K1-K3 launches, which the counter cannot see
        inside the extension (on the CPU their plain versions' products
        are counted as they run).  Neither the exchange nor the update
        runs, and their elementwise work is not counted: the parameters
        and the optimizer state are left as they were."""
        from torch.utils.flop_counter import FlopCounterMode

        from theanompi_tpu_torch.ops.attention import count_kernel_ops

        with count_kernel_ops() as ops, FlopCounterMode(display=False) as fc:
            loss, leaves = self._step_loss(count)
            torch.autograd.grad(loss, leaves)
        return float(fc.get_total_flops()) + ops[0]

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

    # -- the exchange ---------------------------------------------------------

    def _exchange_order(self) -> list[tuple[int, str | None]]:
        """``(index, layout)`` of the tensors of :meth:`_leaves` in the
        JAX package's leaf order, with the layout each has there
        (``ops.layers.jax_view``)."""
        raise NotImplementedError

    def _leaves(self) -> list:
        """The trained tensors, in the order of the optimizer state."""
        raise NotImplementedError

    def _jax_views(self, tensors) -> list:
        return [jax_view(tensors[i], lay) for i, lay in self._xorder]

    def _compile_exchange(self, exch_strategy: str | None) -> None:
        """Resolve the exchange of this compile (the group exists): the
        strategy, the bucket size, the compression; with zero1 or a
        compression, the flat layout over this rank's JAX-ordered
        tensors (its local shards at a layout) sharded over the data
        replicas, a zero1 optimizer state shaped for this rank's shard,
        and zero EF residuals (``r1`` ``[padded]``, ``r2``
        ``[shard_len]`` when not zero1)."""
        cfg = getattr(self, "config", {})
        self._strategy = get_strategy(
            exch_strategy or cfg.get("exch_strategy", "ici32"))
        self._bucket_elems = self._strategy.bucket_elems(
            resolve_bucket_mb(cfg))
        comp, use_ef = resolve_compression(cfg)
        self._compression, self._error_feedback = comp, use_ef
        self._zero1 = self._strategy.zero1
        self._xorder = self._exchange_order()
        spec = None
        if self._zero1 or comp:
            spec = flat_spec(self._jax_views(self._leaves()), self._world,
                             bucket_elems=self._bucket_elems)
        self._fspec = spec
        lay = getattr(self, "layout", None)
        if lay is None:
            self._flat_at, self._n_flat = self._rank, self._world
            self._flat_writer = True
        else:
            p, e, d, m, s = lay.coords
            n = lay.dims
            self._flat_at = ((p * n["expert"] + e) * n["data"] + d) \
                * n["model"] + m
            self._n_flat = lay.world // n["seq"]
            self._flat_writer = s == 0
        self._zero1_layout = ((spec.padded, spec.bucket_len)
                              if self._zero1 else None)
        if self._zero1:
            self.opt_state = self.optimizer.shard_state(spec.shard_len,
                                                        self.device)
        self._ef_layout = ((comp, spec.padded, spec.bucket_len)
                           if comp and use_ef else None)
        self.ef_state = {}
        if self._ef_layout:
            zeros = dict(dtype=torch.float32, device=self.device)
            self.ef_state["r1"] = torch.zeros(spec.padded, **zeros)
            if not self._zero1:
                self.ef_state["r2"] = torch.zeros(spec.shard_len, **zeros)

    def _exchange_update(self, leaves: list, grads: list) -> None:
        """The step's exchange and optimizer update: allreduce-mean by
        the strategy (or the compressed wire) then the update, or the
        zero1 reduce-scatter / shard update / all-gather.  A layout
        first sums the stage-invariant leaves over pipe and means every
        leaf over seq in f32 (``_seq_group``: a 16-bit wire, zero1 or a
        compression), as JAX's autodiff does before its exchange; the
        exchange then runs over the data replicas (``_dp_group``).  With
        MoE the expert leaves mean over their own group and divide by
        ``ep``."""
        lr = self.current_lr
        if self._pipe_sum is not None:
            group, idx = self._pipe_sum
            for i in idx:
                dist.all_reduce(grads[i], group=group)
        if self._seq_group is not None:
            allreduce_mean(grads, group=self._seq_group,
                           bucket_elems=self._bucket_elems)
        if self._zero1:
            def update(p, g, state):
                return self.optimizer.update([p], [g], state, lr)

            self.opt_state = scatter_update_gather(
                self._jax_views(leaves), self._jax_views(grads), update,
                spec=self._fspec, opt_state=self.opt_state,
                wire_dtype=self._strategy.wire_dtype,
                compression=self._compression,
                r1=self.ef_state.get("r1"), group=self._dp_group)
            self._resync_replicated(leaves)
            return
        if self._compression:
            compressed_allreduce_mean(
                self._jax_views(grads), compression=self._compression,
                r1=self.ef_state.get("r1"), r2=self.ef_state.get("r2"),
                bucket_elems=self._bucket_elems, group=self._dp_group)
        elif self._expert_leaves:
            for i, g in enumerate(grads):
                if i in self._expert_leaves:
                    self._strategy([g], group=self._expert_dp_group)
                    if self._ep > 1:
                        g.div_(self._ep)
                else:
                    self._strategy([g], group=self._dp_group)
        else:
            self._strategy(grads, group=self._dp_group,
                           bucket_elems=self._bucket_elems)
        # the optimizer update is its own step-phase leg (obs/profiler)
        with scope("opt_update"):
            self.opt_state = self.optimizer.update(leaves, grads,
                                                   self.opt_state, lr)
        self._resync_replicated(leaves)

    @torch.no_grad()
    def _resync_replicated(self, leaves: list) -> None:
        """The compressed wire quantizes each rank's own flat pack, whose
        chunk scales differ between model ranks and between stages, so
        a leaf they all hold whole (a norm at tp > 1; embed, final_norm
        and lm_head at pp > 1) comes out of the update with different
        rounding on each: it takes its group's first rank's values, as
        the one copy the checkpoint keeps."""
        for src, group, idx in self._replicated:
            for i in idx:
                dist.broadcast(leaves[i], src=src, group=group)

    def _split_leaf(self, t, block: int):
        """This rank's ``[block]`` of a global flat buffer of the
        ``_n_flat`` blocks in ``P((pipe, expert, data, model))`` order:
        itself when there is one block, else a ``ShardedLeaf`` of the
        ``[block · _n_flat]`` at its flat coordinate."""
        if self._n_flat == 1:
            return t
        return ShardedLeaf(t, (block * self._n_flat,),
                           block * self._flat_at, write=self._flat_writer)

    def _exchange_trees(self) -> dict:
        """The checkpoint groups of the exchange: a zero1 optimizer
        state (``opt_state``, the JAX shard-state tree: Adam ``{m, t,
        v}``, the velocity, SGD's ``()``) and the EF residuals
        (``ef_state``), each flat leaf this rank's block of the global
        buffer the JAX package shards ``P((pipe, expert, data, model))``
        (the zero1 state and ``r2`` ``[shard_len · P·E·D·M]``, ``r1``
        ``[padded · P·E·D·M]``; without a layout ``P·E·D·M`` is the
        world)."""
        trees = {}
        spec = self._fspec
        if self._zero1:
            def leaf(t):
                return self._split_leaf(t, spec.shard_len)

            st = self.opt_state
            if isinstance(st, dict):
                trees["opt_state"] = {
                    "m": leaf(st["m"][0]), "v": leaf(st["v"][0]),
                    "t": np.asarray(int(st["t"]), np.int32)}
            else:
                trees["opt_state"] = leaf(st[0]) if st else ()
        if self.ef_state:
            ef = {"r1": self._split_leaf(self.ef_state["r1"], spec.padded)}
            if "r2" in self.ef_state:
                ef["r2"] = self._split_leaf(self.ef_state["r2"],
                                            spec.shard_len)
            trees["ef_state"] = ef
        return trees

    @torch.no_grad()
    def _restore_exchange(self, trees: dict) -> None:
        """Adopt the exchange groups of :meth:`_exchange_trees` read
        back (``{keystr: array}`` of this rank's regions)."""
        def put(t, a):
            t.copy_(torch.from_numpy(np.ascontiguousarray(a)))

        if "opt_state" in trees:
            flat, st = trees["opt_state"], self.opt_state
            if isinstance(st, dict):
                put(st["m"][0], flat["['m']"])
                put(st["v"][0], flat["['v']"])
                st["t"] = torch.tensor(int(flat["['t']"]),
                                       dtype=torch.int32)
            elif st:
                put(st[0], flat[""])
        for k, t in self.ef_state.items():
            put(t, trees["ef_state"][f"['{k}']"])

    # -- checkpoint / resume ------------------------------------------------

    def _split_state(self) -> bool:
        """Whether this rank holds only its block of some state (zero1 or
        the EF residuals over more than one flat block): then every rank
        writes its own shards, as a ``.shards`` checkpoint."""
        return self._n_flat > 1 and (self._zero1 or bool(self.ef_state))

    def save(self, directory: str, recorder=None,
             extra_meta: dict | None = None) -> None:
        """Write a checkpoint (rank 0's npz, or every rank's ``.shards``
        when the state is split).  ``extra_meta`` rides in the sidecar:
        the graceful-preemption path stamps ``next_iter``, so a
        mid-epoch checkpoint resumes at the exact boundary.
        ``config["keep_last_checkpoints"]`` bounds the history on
        disk."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        # world_size: the data replicas (JAX dp_replicas); n_devices: all
        dp = self._world if self._dp_group is not None else world
        meta = {"epoch": self.epoch, "lr": self.current_lr,
                "world_size": dp, "n_devices": world}
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
        # a zero1 shard and an EF residual are flat buffers whose order
        # depends on the layout they were written under: stamped, and
        # checked on load
        if self._zero1_layout is not None:
            meta["zero1_layout"] = list(self._zero1_layout)
        if self._ef_layout is not None:
            meta["ef_layout"] = list(self._ef_layout)
        if extra_meta:
            meta.update(extra_meta)
        keep_last = getattr(self, "config", {}).get("keep_last_checkpoints")
        keep_last = int(keep_last) if keep_last is not None else None
        if self._split_state():
            save_sharded_checkpoint(directory, self.epoch,
                                    self.checkpoint_trees(), meta,
                                    rank=rank, world=world,
                                    keep_last=keep_last)
            return
        # a model whose trees gather shards runs the gather on every rank
        trees = self.checkpoint_trees() if self._save_collective else None
        if rank != 0:
            return
        trees = {g: _to_numpy(t) for g, t in
                 (trees or self.checkpoint_trees()).items()}
        ckpt.save_checkpoint(directory, self.epoch, trees, meta,
                             keep_last=keep_last)

    def _world_changed(self, meta: dict) -> bool:
        """The checkpoint's world stamp differs from this run's: a
        (padded, bucket_len) stamp can coincide across worlds, but the
        bucket-major storage order depends on the world, and ``r1`` is
        per-rank state."""
        return (meta.get("world_size") is not None
                and int(meta["world_size"]) != self._world)

    def _check_layouts(self, path, meta: dict, like: dict,
                       plan: dict | None) -> None:
        """Refuse a checkpoint whose zero1 or EF flat state does not fit
        the compiled one (the JAX package's guards): loading it would
        pair optimizer or residual rows with the wrong parameters.  A
        state whose packs span the model or pipe axes (its flat buffers
        are not the stamped ``[padded]``, or this run's would not be)
        resumes only at the data width and global shapes it was written
        at, elastic or not (the JAX reshard's refusal); any other layout
        change refuses unless ``plan`` re-lays it."""
        changed = self._world_changed(meta)
        z, ef = meta.get("zero1_layout"), meta.get("ef_layout")
        saved = saved_shapes(path) if is_sharded_checkpoint(path) else {}
        want = {f"{g}:{k}": _global_shape(v)
                for g in ("opt_state", "ef_state") if g in like
                and (self.ef_state if g == "ef_state" else self._zero1)
                for k, v in ckpt.flatten(like[g]).items()}
        # the JAX reshard's test: a flat zero1 buffer or r2 over the data
        # axis alone is [padded] (r1, a block a rank, goes beside one of
        # them)
        stamped = {k: (int(z[0]),) for k, s in want.items()
                   if z and k.startswith("opt_state:") and len(s) == 1}
        if ef:
            stamped["ef_state:['r2']"] = (int(ef[1]),)
        spans = self._n_flat != self._world or any(
            saved.get(k, s) != s for k, s in stamped.items())
        if want and spans and (changed or any(
                saved.get(k, s) != s for k, s in want.items())):
            raise ValueError(
                f"{path}: its flat exchange state was written over "
                f"{meta.get('world_size')} data replicas (zero1_layout "
                f"{z}, ef_layout {ef}), this run lays it over "
                f"{self._world} ({self._zero1_layout}, {self._ef_layout}): "
                f"{reshard_lib.SPANNING_REFUSAL}; resume at the tp, pp and "
                f"data width it was written at")
        if plan is not None:
            return
        cur = self._zero1_layout
        if cur is not None and "opt_state" in like:
            got = tuple(z) if z is not None else (cur[0], 0)
            if got != tuple(cur) or (cur[1] and changed):
                raise ValueError(
                    f"zero1 optimizer checkpoint layout {got} (padded, "
                    f"bucket_len) does not match the compiled exchange "
                    f"layout {tuple(cur)} — the flat shard order is "
                    f"bucket-dependent, so resuming would silently pair "
                    f"adam/momentum rows with the wrong parameters; set "
                    f"exchange_bucket_mb to the value the checkpoint was "
                    f"trained with, or pass reshard=True to load() to "
                    f"gather the shards to master order and re-scatter "
                    f"them onto this layout")
        cur_ef = self._ef_layout
        if cur_ef is not None and "ef_state" in like \
                and ef is not None \
                and (tuple(ef) != tuple(cur_ef) or changed):
            raise ValueError(
                f"checkpoint EF-residual layout {tuple(ef)} "
                f"(compression, padded, bucket_len) does not match the "
                f"compiled exchange layout {tuple(cur_ef)} — set "
                f"exch_compression/exchange_bucket_mb to the values the "
                f"checkpoint was trained with, or pass reshard=True to "
                f"load() to carry the residual across the layout change "
                f"(the compression itself must still match)")

    def _reshard_plan(self, meta: dict, like: dict) -> dict | None:
        """The groups an elastic load re-lays (``{group: (old, new)}``
        layouts), or None when the layouts already match."""
        changed = self._world_changed(meta)
        cur_z, cur_ef = self._zero1_layout, self._ef_layout
        saved_z, saved_ef = meta.get("zero1_layout"), meta.get("ef_layout")
        groups: dict[str, tuple] = {}
        if cur_z is not None and saved_z is not None and (
                tuple(saved_z) != tuple(cur_z) or (cur_z[1] and changed)):
            groups["opt_state"] = (tuple(saved_z), tuple(cur_z))
        if cur_ef is not None and saved_ef is not None and "ef_state" in like:
            if saved_ef[0] != cur_ef[0]:
                raise ValueError(
                    f"elastic resume cannot reshard across wire formats: "
                    f"the checkpoint's EF residual was written under "
                    f"exch_compression={saved_ef[0]!r}, the compiled "
                    f"exchange uses {cur_ef[0]!r} — the layouts/padding "
                    f"may change across worlds, the compression must not")
            if tuple(saved_ef) != tuple(cur_ef) or changed:
                groups["ef_state"] = ((saved_ef[1], saved_ef[2]),
                                      (cur_ef[1], cur_ef[2]))
        if not groups:
            return None
        return {"groups": groups, "world_size": meta.get("world_size"),
                "n_new": self._world, "size": self._fspec.size}

    def _load_resharded(self, path, like: dict, plan: dict) -> dict:
        """The elastic load: the layout-free groups through the normal
        loader; each flat group read whole at its saved shapes, gathered
        to pack order and re-scattered onto the compiled layout (an
        exact permutation), then this rank's slice kept."""
        groups = plan["groups"]
        trees = ckpt.load_trees(
            path, {g: t for g, t in like.items() if g not in groups})
        n_old, n_new = plan["world_size"], plan["n_new"]
        for group, (old, new) in groups.items():
            fn = (reshard_lib.reshard_ef_tree if group == "ef_state"
                  else reshard_lib.reshard_flat_tree)
            want = ckpt.flatten(like[group])
            full = fn(ckpt.load_raw_group(path, group),
                      {k: _global_shape(v) for k, v in want.items()},
                      size=plan["size"], old=(n_old, *old),
                      new=(n_new, *new))
            trees[group] = {k: _local_region(a, want[k])
                            for k, a in full.items()}
        print(f"elastic resume: resharded {sorted(groups)} from world "
              f"{n_old} to world {n_new} (gather to master order, "
              f"re-scatter)", flush=True)
        return trees

    def _load_trees(self, path, like: dict) -> dict:
        try:
            return ckpt.load_trees(path, like)
        except KeyError as e:
            if "ef_state" in like and "ef_state" in str(e):
                raise ValueError(
                    f"checkpoint {path} lacks the error-feedback residual "
                    f"group ('ef_state') this model's compressed exchange "
                    f"carries — resuming would silently drop the EF "
                    f"residual; resume from a checkpoint written with the "
                    f"same exch_compression, or set "
                    f"exch_compression='none'") from e
            raise

    def load(self, directory: str, recorder=None,
             reshard: bool | None = None,
             path: str | Path | None = None) -> bool:
        """Restore the newest valid checkpoint under ``directory`` (npz
        or ``.shards``); False when there is none.  Validation is on
        unless ``config["validate_checkpoint"]`` is False: a checkpoint
        that fails its digests is quarantined as ``*.corrupt`` and the
        previous one loads (``resume_checkpoint``: rank 0 validates and
        every rank loads its choice).  ``path``: a checkpoint the caller
        already chose that way.  A zero1 or EF state saved under another
        layout refuses, unless ``reshard=True`` (or ``config["elastic"]``
        when ``reshard`` is None): then it is gathered to pack order and
        re-scattered onto the compiled layout (the elastic resume).  A
        state whose packs span the model or pipe axes refuses any layout
        change (:meth:`_check_layouts`)."""
        cfg = getattr(self, "config", {})
        if reshard is None:
            reshard = bool(cfg.get("elastic"))
        if path is None:
            path = resume_checkpoint(
                directory, bool(cfg.get("validate_checkpoint", True)),
                self.device)
        if path is None:
            return False
        like = self.checkpoint_trees()
        meta = ckpt.checkpoint_meta(path)
        plan = self._reshard_plan(meta, like) if reshard else None
        self._check_layouts(path, meta, like, plan)
        trees = (self._load_resharded(path, like, plan) if plan
                 else self._load_trees(path, like))
        ex = {g: trees.pop(g) for g in ("opt_state", "ef_state")
              if g in trees and (g == "ef_state" or self._zero1)}
        self.restore_trees({
            g: t if self.flat_checkpoint or t == () else
            ckpt.unflatten(t) for g, t in trees.items()})
        self._restore_exchange(ex)
        self.restored_meta = meta
        self.resharded_from = plan and {
            "world_size": plan["world_size"],
            "groups": sorted(plan["groups"])}
        self.epoch = int(meta.get("epoch", 0))
        self.current_lr = float(meta.get("lr", self.current_lr))
        if recorder is not None and "recorder" in meta:
            recorder.load_state_dict(meta["recorder"])
        return True


def _global_shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, ShardedLeaf) \
        else tuple(np.shape(leaf))


def _local_region(arr: np.ndarray, leaf) -> np.ndarray:
    """This rank's region of a global array ``leaf`` describes."""
    if isinstance(leaf, ShardedLeaf):
        return arr[tuple(slice(a, b) for a, b in leaf.index)]
    return arr


def jax_order(paths: list) -> list[int]:
    """Indices of ``paths`` (key-path tuples) in the JAX package's leaf
    order: dict keys sorted, sequence entries in order, depth first."""
    def key(i):
        return tuple((0, p) if isinstance(p, int) else (1, p)
                     for p in paths[i])

    return sorted(range(len(paths)), key=key)


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
    ``device_data_cache``, ``steps_per_call``.  ``device`` defaults to
    the card;
    ``device="cpu"`` runs on the CPU.
    """

    flat_checkpoint = True

    def __init__(self, config: dict | None = None, device=None):
        self.config = dict(config or {})
        resolve_loader_depth(self.config)   # a bad value fails here
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
        self._compile_exchange(exch_strategy)
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
        move no image bytes from the host; ``steps_per_call`` K > 1 makes ``train_chunk`` run K steps
        a call."""
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
        self._init_cached_steps(
            self.data.batch_size,
            int(self.config.get("steps_per_call", 0) or 0))

    def _cached_batch(self, count: int):
        """This rank's rows of train batch ``count``, gathered on the
        device (:meth:`_cached_rows`)."""
        idx = self._cached_rows(count)
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

    def _rank_mean(self, stats: torch.Tensor) -> torch.Tensor:
        """f32 ``stats`` (a step's ``[loss, err]``, a chunk's ``[K, 2]``)
        meaned over the ranks."""
        dist.all_reduce(stats)
        return stats / self._world

    def train_iter(self, count: int, recorder) -> None:
        if self._device_cache is not None:
            return self.train_chunk(count, 1, recorder)
        recorder.start()
        if self._feed is not None:
            # fetched and staged by the producer thread under the last
            # step: the wait segment is a ring pop
            x, y = self._feed.next(count).wait()
        else:
            x, y = self.put_batch(self.data.train_batch(count))
        recorder.end("wait")
        recorder.start()
        stats = self._rank_mean(self._train_step(x, y))
        recorder.end("calc")
        recorder.train_error(count, stats[0], stats[1])

    def _train_step(self, x, y) -> torch.Tensor:
        """One step on this rank's batch: forward, backward, the BN
        statistics' and the gradients' exchange and the update; returns
        this rank's f32 ``[loss, err]``, not yet meaned over the
        ranks."""
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
        self._exchange_update(self.params, grads)
        return torch.stack([loss.detach().float(), err.float()])

    def _step_loss(self, count: int):
        x, y = self.put_batch(self.data.train_batch(count))
        out = self.net(self.prep_input(x), train=True, gen=self._dropout_gen)
        return self.compute_loss(out, y), self.params

    @torch.no_grad()
    def val_iter(self, count: int, recorder):
        x, y = self.put_batch(self.data.val_batch(count))
        logits = self.primary_logits(self.net(self.prep_input(x)))
        stats = self._rank_mean(torch.stack([
            softmax_cross_entropy(logits, y).float(),
            1.0 - accuracy(logits, y),
            1.0 - accuracy(logits, y, k=5),
        ]))
        return tuple(float(v) for v in stats)

    # -- checkpoint: the JAX trees ------------------------------------------

    def _jax_tree(self, at: dict, tensors=None) -> dict:
        """The tensors of ``at`` (or ``tensors``, one per entry of
        ``at``, e.g. the momentum velocity) as a JAX-layout tree."""
        if tensors is None:
            tensors = [t for t, _ in at.values()]
        return _nest({path: to_jax_layout(t, layout) for (path, (_, layout)),
                      t in zip(at.items(), tensors)})

    def _leaves(self) -> list:
        return self.params

    def _exchange_order(self) -> list:
        at = list(self._params_at.items())
        return [(i, at[i][1][1]) for i in jax_order([p for p, _ in at])]

    def checkpoint_trees(self) -> dict:
        trees = {"params": self._jax_tree(self._params_at),
                 "net_state": self._jax_tree(self._state_at),
                 # the momentum velocity is a params-shaped tree, SGD's
                 # state the empty tuple, in either package
                 "opt_state": (self._jax_tree(self._params_at,
                                              self.opt_state)
                               if self.opt_state and not self._zero1
                               else ())}
        trees.update(self._exchange_trees())
        return trees

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
        if "opt_state" in trees and self.opt_state:
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
