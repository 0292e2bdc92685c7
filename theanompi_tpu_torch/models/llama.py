"""Llama-family decoder transformer, no MoE: serving at tp >= 1 and BSP
training at tp >= 1 and sp >= 1 (pp = 1).

Port of ``theanompi_tpu/models/llama.py``: the model math (RMSNorm,
interleaved-pair RoPE with theta 10000, GQA, SwiGLU, untied LM head),
the parameter layout and init, the training contract the BSP worker
drives, and the bridge that carries a JAX parameter tree and optimizer
state across.

Parameters are a plain dict of tensors in the JAX layout —
``{"embed" [V, D], "layers": [{attn_norm, wq [D, H*hd], wk, wv, wo,
mlp_norm, w_gate, w_up, w_down}], "final_norm", "lm_head" [D, V]}``,
weights ``[in, out]`` so every product is ``x @ w``.

- Serving (``make_decoder``) holds them in the compute dtype: the JAX
  path keeps fp32 master weights but casts them to ``x.dtype`` before
  every use (``tp.col_parallel``/``row_parallel`` and ``rms_norm``), so
  casting once at init or load is exactly equivalent.
- Training (``build_model`` -> ``compile_iter_fns`` -> ``train_iter``)
  keeps fp32 master weights, cast at each use as in the JAX step, and
  trains them with the JAX optimizers' update forms.  Each step runs
  the forward (per-layer ``torch.utils.checkpoint`` when ``remat``),
  the fused LM head (chunked over the vocab at >= 64k, else dense), the
  backward (attention through kernels K1-K3 on the card), the
  allreduce-mean of the gradients by the named strategy over the
  data group, and the optimizer update.  A rank at data coordinate d
  takes rows ``[d*B, (d+1)*B)`` of the global batch, as the JAX
  ``batch_spec`` shards it, staged as int64 ids through
  ``data.HostStager`` (or the streaming feed, with ``loader_pipeline``);
  loss and error are means over the data and seq ranks.

- Tensor-parallel serving (``tp > 1`` with a ``ModelGroup``, one
  process a rank): each rank holds the JAX ``param_specs`` shard of
  every leaf (:data:`SHARD_AXIS`) — the columns of ``wq``, ``wk``,
  ``wv``, ``w_gate``, ``w_up`` and ``lm_head``, the rows of ``wo``,
  ``w_down`` and ``embed`` — so rank r holds query heads
  ``[r·H/tp, (r+1)·H/tp)`` and kv heads ``[r·Hkv/tp, (r+1)·Hkv/tp)``,
  GQA's grouping.  Random parameters are drawn in full from the seed
  and sliced, so every tp serves the same weights.

- Training at tp > 1 and sp > 1 (one process a rank, the world laid
  out as a ``parallel.mesh.Layout``: data × model × seq, seq fastest).
  The model axis shards the leaves as serving does; the replicated
  input of each column-parallel product goes through
  ``tp.copy_to_group`` and each row-parallel sum through
  ``tp.reduce_from_group`` (the JAX psum/pvary transposes), and the
  fused head reduces over the vocab shards.  The seq axis gives each
  rank ``T/sp`` columns of the inputs and targets at positions
  ``seq_idx·T/sp + arange``; attention runs as ring attention
  (``sp_mode="ring"``, ``parallel/ring_attention.py``) or Ulysses
  (``"ulysses"``, ``parallel/ulysses.py``).  Each rank's loss is its
  local mean over sp (the JAX pmean's cotangent) and every leaf's
  gradient is summed over the seq group in f32 (JAX's autodiff psum)
  before the data exchange.  The fp32 masters are drawn whole and
  sharded, so init equals the tp = 1 model's; checkpoints gather the
  model group's shards and hold full arrays.

pp > 1, MoE and selective remat (``remat_save``) are not ported yet
(ROADMAP.md); neither are zero1, the compressed wire and elastic
resume at tp·sp > 1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from theanompi_tpu_torch.models.base import DTYPES, TMModel, resolve_dtype
from theanompi_tpu_torch.models.data.lm_synthetic import MarkovLMData
from theanompi_tpu_torch.ops import optimizers as opt_lib
from theanompi_tpu_torch.ops.attention import flash_attention
# training differentiates the plain expression: the serving decoder's
# row-count-independent kernel (ops/norm.rms_norm_rows) has no backward
from theanompi_tpu_torch.ops.norm import rms_norm
from theanompi_tpu_torch.parallel import tp as tp_lib
from theanompi_tpu_torch.parallel.mesh import (
    current_layout,
    init_group,
    resolve_device,
)
from theanompi_tpu_torch.parallel.ring_attention import ring_attention
from theanompi_tpu_torch.parallel.strategies import resolve_compression
from theanompi_tpu_torch.parallel.ulysses import ulysses_attention
from theanompi_tpu_torch.utils import checkpoint as ckpt

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
              "w_gate", "w_up", "w_down")

#: the axis each leaf is split along over the model group (the JAX
#: ``param_specs``' MODEL_AXIS); None: every rank holds it whole
SHARD_AXIS = {"embed": 0, "lm_head": 1, "final_norm": None,
              "attn_norm": None, "mlp_norm": None, "wq": 1, "wk": 1,
              "wv": 1, "wo": 0, "w_gate": 1, "w_up": 1, "w_down": 0}


def shard_leaf(a, name: str, rank: int, tp: int):
    """Rank ``rank``'s slice of the full leaf ``a`` (numpy or torch) at
    ``tp`` ranks; the leaf itself at tp = 1 or when it is replicated."""
    ax = SHARD_AXIS[name]
    if tp == 1 or ax is None:
        return a
    n = a.shape[ax] // tp
    return a[(slice(None),) * ax + (slice(rank * n, (rank + 1) * n),)]


# -- model math ---------------------------------------------------------------

def _rope_inv(d: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device)
                  / d)
    )


def _rotate(x, cos, sin):
    """Rotate the interleaved pairs (x[..., 0::2], x[..., 1::2]) by the
    angles whose cos/sin broadcast against them."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def rope(x, pos, theta=10000.0):
    """Rotary embedding.  x: [B, H, T, D], pos: [T] global positions."""
    inv = _rope_inv(x.shape[-1], theta, x.device)
    ang = pos.float()[:, None] * inv[None, :]                # [T, D/2]
    return _rotate(x, torch.cos(ang), torch.sin(ang))


def rope_at(x, pos, theta=10000.0):
    """Rotary embedding at per-row positions (the KV-cache decode path,
    where every slot sits at its own position).  x: [S, H, D], pos: [S].
    The JAX vmap over rows is the leading batch dimension here."""
    inv = _rope_inv(x.shape[-1], theta, x.device)
    ang = (pos.float()[:, None] * inv[None, :])[:, None, :]  # [S, 1, D/2]
    return _rotate(x, torch.cos(ang), torch.sin(ang))


def _heads(x, n, d):
    """[B, T, n*d] -> [B, n, T, d]"""
    b, t, _ = x.shape
    return x.reshape(b, t, n, d).transpose(1, 2)


def _unheads(x):
    """[B, n, T, d] -> [B, T, n*d]"""
    b, n, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, n * d)


# -- the model ----------------------------------------------------------------

class Llama(TMModel):
    """Llama: config, parameters and device, for serving and training.

    Config knobs read: ``dim, n_layers, n_heads, n_kv_heads, ffn_dim,
    vocab, seq_len, compute_dtype, seed, tp, sp, sp_mode`` and, for
    training,
    ``batch_size`` (per rank), ``n_train, n_val, n_epochs, lr,
    optimizer, weight_decay, remat, xent_chunks, exch_strategy,
    exchange_bucket_mb, lr_schedule, loader_pipeline``.  Serving
    parameters are drawn from ``self.generator`` (seeded with ``seed``)
    at first use unless ``params`` is given (e.g. from
    :func:`params_from_jax` or a checkpoint); training draws the same
    values in fp32 at ``compile_iter_fns``.  ``device`` defaults to the card;
    ``device="cpu"`` runs on the CPU.  At ``tp > 1`` ``group`` is this
    rank's ``parallel.mesh.ModelGroup`` of ``tp`` ranks (by default the
    model axis of the ``current_layout()``, which the BSP worker builds)
    and ``params`` its shards.  At ``sp > 1`` (training) the seq axis
    comes from the layout.
    """

    def __init__(self, config: dict | None = None, device=None, *,
                 params: dict | None = None, group=None):
        c = dict(config or {})
        self.config = c
        self.dim = int(c.get("dim", 256))
        self.n_layers = int(c.get("n_layers", 4))
        self.n_heads = int(c.get("n_heads", 8))
        self.n_kv_heads = int(c.get("n_kv_heads", self.n_heads))
        self.ffn_dim = int(c.get("ffn_dim", self.dim * 4))
        self.vocab = int(c.get("vocab", 256))
        self.seq_len = int(c.get("seq_len", 256))
        self.head_dim = self.dim // self.n_heads
        self.seed = int(c.get("seed", 42))
        self.compute_dtype = resolve_dtype(c.get("compute_dtype", "bfloat16"))
        if self.dim % self.n_heads:
            raise ValueError(
                f"dim {self.dim} must divide by n_heads {self.n_heads}"
            )
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                "n_heads must be a multiple of n_kv_heads (GQA groups)"
            )
        unported = {k: c[k] for k in ("pp", "n_experts", "ep")
                    if int(c.get(k, 0 if k == "n_experts" else 1))
                    != (0 if k == "n_experts" else 1)}
        if unported:
            raise NotImplementedError(
                f"the port runs pp=1 without MoE; {unported} is not "
                f"ported yet (ROADMAP.md A12: parallel layouts, MoE)"
            )
        self.tp = int(c.get("tp", 1))
        self.sp = int(c.get("sp", 1))
        self.sp_mode = str(c.get("sp_mode", "ring"))
        if self.sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"sp_mode must be 'ring' or 'ulysses', got "
                             f"{self.sp_mode!r}")
        if self.seq_len % self.sp:
            raise ValueError(f"seq_len {self.seq_len} must divide by sp "
                             f"{self.sp}")
        # the layout the BSP worker built for this run, if it fits
        lay = current_layout()
        if lay is not None and (lay.sizes["model"], lay.sizes["seq"]) \
                != (self.tp, self.sp):
            lay = None
        self.layout = lay
        if group is None and lay is not None and self.tp > 1:
            group = lay.model
        self.group = group if group is not None and group.size > 1 else None
        self.tp_rank = group.rank if group is not None else 0
        if self.tp > 1:
            if group is None or group.size != self.tp:
                raise ValueError(
                    f"tp={self.tp} runs over a ModelGroup of {self.tp} "
                    f"ranks (parallel.mesh.ModelGroup.join, or the model "
                    f"axis of a parallel.mesh.Layout), got {group}"
                )
            for name, n in (("n_heads", self.n_heads),
                            ("n_kv_heads", self.n_kv_heads),
                            ("ffn_dim", self.ffn_dim),
                            ("vocab", self.vocab)):
                if n % self.tp:
                    raise ValueError(f"{name} {n} must divide by tp "
                                     f"{self.tp}")
        elif group is not None and group.size != 1:
            raise ValueError(f"a {group.size}-rank group needs tp="
                             f"{group.size} in the config")
        if self.sp_mode == "ulysses":
            h_loc = self.n_heads // self.tp
            hkv_loc = self.n_kv_heads // self.tp
            if h_loc % self.sp or hkv_loc % self.sp:
                raise ValueError(
                    f"ulysses needs per-TP-shard heads divisible by sp: "
                    f"H/tp={h_loc}, Hkv/tp={hkv_loc}, sp={self.sp}")
        if c.get("device_data_cache"):
            raise NotImplementedError(
                "device_data_cache for Llama is not ported yet (ROADMAP.md "
                "A7: the JAX Llama cache runs steps_per_call steps a call)"
            )
        if c.get("remat_save"):
            raise NotImplementedError(
                "remat_save (selective remat) is not ported yet "
                "(ROADMAP.md A6); remat=True recomputes whole layers"
            )
        self.remat = bool(c.get("remat", True))
        self.n_epochs = int(c.get("n_epochs", 5))
        self.epoch = 0
        self.current_lr = float(c.get("lr", 3e-3))
        self.opt_name = str(c.get("optimizer", "adam"))
        self.optimizer = opt_lib.get(
            self.opt_name, weight_decay=float(c.get("weight_decay", 0.0))
        )
        self.opt_state = None
        self.data = None
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self._params = params

    @property
    def params(self) -> dict:
        """The parameter tree; serving parameters (compute dtype) are
        drawn at first use."""
        if self._params is None:
            self._params = self.init_params()
        return self._params

    @params.setter
    def params(self, value: dict | None) -> None:
        self._params = value

    def init_params(self, dtype=None) -> dict:
        """Random parameters with the shapes and scales of the JAX
        ``_init_full_params``, in ``dtype`` (default: the compute
        dtype): each tensor drawn in fp32 from the model's generator,
        reseeded first so every call draws the same values, and cast
        before the next is drawn, so the fp32 peak is one tensor."""
        d, f, v = self.dim, self.ffn_dim, self.vocab
        hd = self.head_dim
        dev, cd = self.device, dtype or self.compute_dtype
        self.generator.manual_seed(self.seed)

        def normal(name, shape, scale):
            x = torch.randn(shape, generator=self.generator, device=dev,
                            dtype=torch.float32)
            x = shard_leaf(x.mul_(scale), name, self.tp_rank, self.tp)
            return x.to(cd, copy=self.tp > 1)     # no view of the full draw

        def dense(name, shape):
            return normal(name, shape,
                          (2.0 / (shape[0] + shape[-1])) ** 0.5)

        def ones():
            return torch.ones((d,), dtype=cd, device=dev)

        layers = []
        for _ in range(self.n_layers):
            layers.append({
                "attn_norm": ones(),
                "wq": dense("wq", (d, self.n_heads * hd)),
                "wk": dense("wk", (d, self.n_kv_heads * hd)),
                "wv": dense("wv", (d, self.n_kv_heads * hd)),
                "wo": dense("wo", (self.n_heads * hd, d)),
                "mlp_norm": ones(),
                "w_gate": dense("w_gate", (d, f)),
                "w_up": dense("w_up", (d, f)),
                "w_down": dense("w_down", (f, d)),
            })
        return {
            "embed": normal("embed", (v, d), 0.02),
            "layers": layers,
            "final_norm": ones(),
            "lm_head": dense("lm_head", (d, v)),
        }

    def n_params(self) -> int:
        return sum(t.numel() for t in _leaves(self.params))

    def make_decoder(self, *, paged: bool = False, **kw):
        """KV-cache decoder over this model's parameters;
        ``paged=True`` builds the block-table / prefix-cache decoder."""
        from theanompi_tpu_torch.serving import (
            LlamaDecoder,
            PagedLlamaDecoder,
        )

        cls = PagedLlamaDecoder if paged else LlamaDecoder
        return cls(self, **kw)

    # -- forward ----------------------------------------------------------

    def _layer(self, p, x, pos):
        """One decoder block on this rank's shards: x [B, T/sp, D] in the
        compute dtype, H/tp query and Hkv/tp kv heads."""
        cd, g = self.compute_dtype, self.group
        h, hkv = self.n_heads // self.tp, self.n_kv_heads // self.tp
        hd = self.head_dim
        xn = tp_lib.copy_to_group(rms_norm(x, p["attn_norm"]), g)
        q = rope(_heads(tp_lib.col_parallel(xn, p["wq"]), h, hd), pos)
        k = rope(_heads(tp_lib.col_parallel(xn, p["wk"]), hkv, hd), pos)
        v = _heads(tp_lib.col_parallel(xn, p["wv"]), hkv, hd)
        # GQA: K/V stay compact on the wire; repeated only to compute
        rep = h // hkv
        if self.sp == 1:
            if rep != 1:
                # jnp.repeat on axis 1 is repeat_interleave on dim 1
                k = k.repeat_interleave(rep, dim=1)
                v = v.repeat_interleave(rep, dim=1)
            o = flash_attention(q, k, v, causal=True)
        elif self.sp_mode == "ring":
            o = ring_attention(q, k, v, self.layout.seq, causal=True,
                               kv_rep=rep)
        else:
            o = ulysses_attention(q, k, v, self.layout.seq, causal=True,
                                  kv_rep=rep)
        x = x + tp_lib.row_parallel(_unheads(o), p["wo"], g).to(cd)
        xn = tp_lib.copy_to_group(rms_norm(x, p["mlp_norm"]), g)
        gate = F.silu(tp_lib.col_parallel(xn, p["w_gate"]))
        up = tp_lib.col_parallel(xn, p["w_up"])
        return x + tp_lib.row_parallel(gate * up, p["w_down"], g).to(cd)

    def _forward(self, params, ids):
        """ids [B, T/sp] (this rank's columns) -> final-normed hidden
        states [B, T/sp, D]; each layer under non-reentrant
        ``checkpoint`` when ``remat`` and gradients are on (its forward,
        collectives included, runs again in the backward)."""
        t_loc = ids.shape[1]
        seq_idx = self.layout.seq.rank if self.sp > 1 else 0
        pos = seq_idx * t_loc + torch.arange(t_loc, device=ids.device)
        x = tp_lib.embed_lookup(ids, params["embed"], self.vocab,
                                self.group)
        x = x.to(self.compute_dtype)
        remat = self.remat and torch.is_grad_enabled()
        for p in params["layers"]:
            if remat:
                x = checkpoint(self._layer, p, x, pos, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._layer(p, x, pos)
        return rms_norm(x, params["final_norm"])

    def _loss(self, params, x, y):
        """(mean loss, top-1 error) of one local batch through the
        fused head."""
        h = self._forward(params, x)
        h2 = h.reshape(-1, h.shape[-1])
        yf = y.reshape(-1)
        if self._n_xent_chunks > 1:
            loss_vec, pred = tp_lib.chunked_unembed_xent(
                h2, params["lm_head"], yf, self.vocab, self._n_xent_chunks,
                self.group)
        else:
            loss_vec, pred = tp_lib.dense_unembed_xent(
                h2, params["lm_head"], yf, self.vocab, self.group)
        return loss_vec.mean(), (pred != yf).float().mean()

    # -- contract -----------------------------------------------------------

    def build_model(self, n_replicas: int = 1) -> None:
        self.data = MarkovLMData(
            vocab=self.vocab,
            seq_len=self.seq_len,
            batch_size=int(self.config.get("batch_size", 8)),
            n_replicas=n_replicas,
            n_train=int(self.config.get("n_train", 2048)),
            n_val=int(self.config.get("n_val", 256)),
            seed=self.seed,
        )
        # master parameters materialize in compile_iter_fns
        self._params = None
        self.opt_state = None

    def compile_iter_fns(self, exch_strategy: str | None = None,
                         **unknown) -> None:
        """Resolve the exchange, join (or create, one rank) the process
        group, take the layout the BSP worker built at tp·sp > 1 (data ×
        tp × sp), pick the head, and draw fp32 master parameters (whole,
        then this rank's shards) and fresh optimizer state."""
        if unknown:
            raise TypeError(
                f"Llama.compile_iter_fns: unknown kwargs {sorted(unknown)}"
            )
        if self.data is None:
            raise RuntimeError("call build_model() before compile_iter_fns()")
        if not dist.is_initialized():
            init_group(self.device)        # a one-rank group of its own
        lay = self.layout
        if self.tp * self.sp > 1:
            if lay is None:
                raise ValueError(
                    f"tp={self.tp}, sp={self.sp} trains over a "
                    f"parallel.mesh.Layout built before the model "
                    f"(Layout.build, as bsp_worker.run does)")
            if self.tp > 1 and self.group is not lay.model:
                raise ValueError(f"the model group {self.group} is not "
                                 f"the layout's model axis {lay.model}")
            cfg = self.config
            for knob, on in (
                    ("exch_strategy=zero1",
                     str(exch_strategy or cfg.get("exch_strategy", "ici32"))
                     .startswith("zero1")),
                    ("exch_compression", bool(resolve_compression(cfg)[0])),
                    ("elastic", bool(cfg.get("elastic")))):
                if on:
                    raise NotImplementedError(
                        f"{knob} at tp*sp={self.tp * self.sp} > 1 is not "
                        f"ported yet (ROADMAP.md A12: the flat exchange "
                        f"state and its .shards layout per model shard)")
        if lay is not None:
            # the batch rows and the BSP exchange run over the data axis
            self._rank, self._world = lay.data.rank, lay.dp_replicas
            self._dp_group = lay.data.device_group
        else:
            self._rank, self._world = dist.get_rank(), dist.get_world_size()
        self._save_collective = self.group is not None
        b = int(self.config.get("batch_size", 8))
        if self._world * b != self.data.global_batch:
            raise ValueError(
                f"{self._world} data replicas x per-replica batch {b} != "
                f"global batch {self.data.global_batch} (build_model "
                f"n_replicas must match the layout's data axis)"
            )
        # the chunked head is a memory feature: "auto" chunks only at a
        # local vocab >= 64k; an int pins the count; 0/1 is the dense head
        v_loc = self.vocab // self.tp
        xc = self.config.get("xent_chunks", "auto")
        if xc == "auto":
            n = tp_lib.pick_xent_chunks(v_loc) if v_loc >= 65536 else 1
        else:
            n = max(1, int(xc or 1))
            if v_loc % n:
                raise ValueError(
                    f"xent_chunks={n} must divide the local vocab {v_loc} "
                    f"(vocab {self.vocab} / tp {self.tp})"
                )
        self._n_xent_chunks = n
        params = self.init_params(torch.float32)
        for t in _leaves(params):
            t.requires_grad_(True)
        self._params = params
        self.opt_state = None
        self._compile_exchange(exch_strategy)
        if self.sp > 1:
            # the seq ranks' gradients sum in f32, as JAX's autodiff psum
            # over seq: an f32 wire means them over (data × seq) in one
            # pass, a 16-bit wire means them over seq first
            if self._strategy.wire_dtype is None:
                self._dp_group = lay.data_seq.device_group
            else:
                self._seq_group = lay.seq.device_group
        if not self._zero1:          # zero1 holds the state of its shard
            self.opt_state = self.optimizer.init(list(_leaves(params)))
        # this rank's rows of each global (inputs, targets) batch, as
        # int64 ids, through the stager (and the feed, when asked for)
        self._init_feed(b, dtypes=(torch.int64, torch.int64))

    def _rank_mean(self, *xs) -> torch.Tensor:
        """The means of ``xs`` over the data and seq ranks (the model
        ranks hold equal values), as the JAX pmean over (data, seq)."""
        stats = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                             device=self.device)
                             for x in xs])
        if self.layout is None:
            dist.all_reduce(stats)
            return stats / self._world
        ds = self.layout.data_seq
        dist.all_reduce(stats, group=ds.device_group)
        return stats / ds.size

    def _seq_columns(self, *ts):
        """This seq rank's ``T/sp`` columns of each [B, T] batch."""
        if self.sp == 1:
            return ts
        t_loc, s = self.seq_len // self.sp, self.layout.seq.rank
        return tuple(t[:, s * t_loc:(s + 1) * t_loc].contiguous()
                     for t in ts)

    def train_iter(self, count: int, recorder) -> None:
        recorder.start()
        staged = (self._feed.next(count) if self._feed is not None
                  else self._stager.stage(self.data.train_batch(count)))
        x, y = self._seq_columns(*staged.wait())
        recorder.end("wait")
        recorder.start()
        leaves = list(_leaves(self.params))
        loss, err = self._loss(self.params, x, y)
        grads = list(torch.autograd.grad(loss, leaves))
        self._exchange_update(leaves, grads)
        stats = self._rank_mean(loss.detach(), err)
        recorder.end("calc")
        recorder.train_error(count, stats[0], stats[1])

    @torch.no_grad()
    def val_iter(self, count: int, recorder):
        x, y = self._seq_columns(
            *self._stager.stage(self.data.val_batch(count)).wait())
        h = self._forward(self.params, x)
        logits = tp_lib.col_parallel(h, self.params["lm_head"])
        g = self.group
        stats = self._rank_mean(
            tp_lib.sharded_softmax_xent(logits, y, self.vocab, g),
            tp_lib.sharded_top1_err(logits, y, self.vocab, g),
            tp_lib.sharded_topk_err(logits, y, self.vocab, k=5, group=g),
        )
        return tuple(float(v) for v in stats)

    # -- checkpoint ---------------------------------------------------------

    def _leaves(self) -> list:
        return list(_leaves(self.params))

    def _exchange_order(self) -> list:
        pos = {id(t): i for i, t in enumerate(_leaves(self.params))}
        return [(pos[id(t)], None) for t in ckpt.flatten(self.params).values()]

    def checkpoint_trees(self) -> dict:
        """The checkpoint's trees in full arrays: at tp > 1 every rank of
        the model group gathers the shards of each leaf (a collective:
        every rank calls this)."""
        opt = () if self._zero1 else _opt_tree(self.opt_state)
        trees = {"params": self.params, "opt_state": opt}
        if self.group is not None:
            trees["params"] = _gather_tree(self.params, self.group)
            if isinstance(opt, dict):
                trees["opt_state"] = {
                    "m": _gather_tree(opt["m"], self.group),
                    "v": _gather_tree(opt["v"], self.group), "t": opt["t"]}
            elif opt:
                trees["opt_state"] = _gather_tree(opt, self.group)
        trees.update(self._exchange_trees())
        return trees

    def restore_trees(self, trees: dict) -> None:
        shard = dict(rank=self.tp_rank, tp=self.tp)
        params = params_from_jax(trees["params"], self.config, self.device,
                                 dtype=torch.float32, **shard)
        for t in _leaves(params):
            t.requires_grad_(True)
        self._params = params
        if "opt_state" in trees:
            self.opt_state = opt_state_from_jax(trees["opt_state"],
                                                self.config, self.device,
                                                **shard)


def _gather_tree(tree: dict, group) -> dict:
    """A parameter-shaped tree of this rank's shards as full tensors:
    each sharded leaf gathered over the model ``group`` along its
    :data:`SHARD_AXIS`, the replicated ones as they are."""
    def one(t, name):
        ax = SHARD_AXIS[name]
        t = t.detach()
        if ax is None:
            return t
        out = torch.empty((group.size,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out.view(-1),
                                    t.contiguous().view(-1),
                                    group=group.device_group)
        return torch.cat(out.unbind(0), dim=ax)

    return {"embed": one(tree["embed"], "embed"),
            "layers": [{k: one(lp[k], k) for k in LAYER_KEYS}
                       for lp in tree["layers"]],
            "final_norm": one(tree["final_norm"], "final_norm"),
            "lm_head": one(tree["lm_head"], "lm_head")}


def _leaves(params: dict):
    yield params["embed"]
    for lp in params["layers"]:
        for k in LAYER_KEYS:
            yield lp[k]
    yield params["final_norm"]
    yield params["lm_head"]


# -- the JAX parameter bridge -------------------------------------------------

def save_init_checkpoint(config: dict, directory) -> None:
    """Write a model's seeded initial state — fp32 parameters drawn on
    the CPU and fresh optimizer state — as checkpoint 0 stamped epoch
    -1, which a run with ``resume=True`` starts epoch 0 from.  Runs on
    different devices start from the same parameters this way (a
    generator draws other numbers on the card than on the CPU)."""
    from theanompi_tpu_torch.utils.checkpoint import save_checkpoint

    model = Llama(config, device="cpu")
    params = model.init_params(torch.float32)
    state = model.optimizer.init(list(_leaves(params)))
    save_checkpoint(directory, 0, {
        "params": params_to_jax(params),
        "opt_state": opt_state_to_jax(state),
    }, {"epoch": -1, "lr": model.current_lr})


def _tree_from_leaves(flat: list) -> dict:
    """The parameter tree of a flat leaf list in ``_leaves`` order."""
    it = iter(flat)
    embed = next(it)
    layers = [{k: next(it) for k in LAYER_KEYS}
              for _ in range((len(flat) - 3) // len(LAYER_KEYS))]
    return {"embed": embed, "layers": layers, "final_norm": next(it),
            "lm_head": next(it)}


def _opt_tree(state):
    """The optimizer state (lists in ``_leaves`` order) in the JAX tree
    layout: ``()`` (SGD), a parameter tree (momentum velocity) or
    ``{"m", "v", "t"}`` (Adam)."""
    if isinstance(state, dict):
        return {"m": _tree_from_leaves(state["m"]),
                "v": _tree_from_leaves(state["v"]), "t": state["t"]}
    if not state:
        return ()
    return _tree_from_leaves(state)


def opt_state_to_jax(state):
    """The optimizer state as the JAX package holds it, in numpy: f32
    moment trees and Adam's int32 step count."""
    tree = _opt_tree(state)
    if isinstance(tree, dict) and "m" in tree:
        return {"m": params_to_jax(tree["m"]), "v": params_to_jax(tree["v"]),
                "t": np.asarray(int(tree["t"]), np.int32)}
    return params_to_jax(tree) if tree else ()


def opt_state_from_jax(tree, config: dict, device=None, *, rank: int = 0,
                       tp: int = 1):
    """Inverse of :func:`opt_state_to_jax`: the port's optimizer state
    (f32 lists in ``_leaves`` order) from a JAX optimizer-state tree of
    numpy arrays (a checkpoint's ``opt_state`` group); at ``tp > 1``
    rank ``rank``'s shards, as :func:`params_from_jax` slices them."""
    f32 = dict(device=device, dtype=torch.float32, rank=rank, tp=tp)
    if isinstance(tree, dict) and "m" in tree:
        return {"m": list(_leaves(params_from_jax(tree["m"], config, **f32))),
                "v": list(_leaves(params_from_jax(tree["v"], config, **f32))),
                "t": torch.tensor(int(np.asarray(tree["t"])),
                                  dtype=torch.int32)}
    if not isinstance(tree, dict):
        return ()
    return list(_leaves(params_from_jax(tree, config, **f32)))


def params_from_jax(tree: dict, config: dict, device=None, *,
                    dtype=None, rank: int = 0, tp: int = 1) -> dict:
    """The port's parameters from a JAX Llama parameter tree given as
    numpy arrays (``jax.device_get(model.params)`` or a checkpoint's
    ``params`` group).  Both packages keep weights ``[in, out]``, so
    this is a copy plus the cast to ``dtype`` (default: the compute
    dtype, as serving holds them; ``torch.float32`` keeps the master
    weights bitwise); shapes are checked against ``config``.  At
    ``tp > 1`` each full leaf is sliced to rank ``rank``'s shard by the
    JAX ``param_specs`` (:data:`SHARD_AXIS`), so a tp = 1 checkpoint
    loads at any tp."""
    dev = resolve_device(device)
    cd = dtype or DTYPES[str(config.get("compute_dtype", "bfloat16"))]
    expect = _shapes_of(config)
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside [0, {tp})")

    def conv(a, shape, name):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(
                f"param {name}: shape {a.shape}, expected {shape}"
            )
        a = shard_leaf(a, name.rsplit(".", 1)[-1], rank, tp)
        return torch.tensor(np.ascontiguousarray(a)).to(device=dev,
                                                        dtype=cd)

    n = len(expect["layers"])
    if len(tree["layers"]) != n:
        raise ValueError(
            f"tree has {len(tree['layers'])} layers, config {n}"
        )
    return {
        "embed": conv(tree["embed"], expect["embed"], "embed"),
        "layers": [
            {k: conv(lp[k], expect["layers"][i][k], f"layers[{i}].{k}")
             for k in LAYER_KEYS}
            for i, lp in enumerate(tree["layers"])
        ],
        "final_norm": conv(tree["final_norm"], expect["final_norm"],
                           "final_norm"),
        "lm_head": conv(tree["lm_head"], expect["lm_head"], "lm_head"),
    }


def params_to_jax(params: dict) -> dict:
    """Inverse of :func:`params_from_jax`: the JAX tree layout as fp32
    numpy arrays (bitwise the input when the compute dtype is fp32)."""
    def conv(t):
        return t.detach().to("cpu", torch.float32).numpy()

    return {
        "embed": conv(params["embed"]),
        "layers": [{k: conv(lp[k]) for k in LAYER_KEYS}
                   for lp in params["layers"]],
        "final_norm": conv(params["final_norm"]),
        "lm_head": conv(params["lm_head"]),
    }


def _shapes_of(config: dict) -> dict:
    c = dict(config)
    d = int(c.get("dim", 256))
    h = int(c.get("n_heads", 8))
    hkv = int(c.get("n_kv_heads", h))
    f = int(c.get("ffn_dim", d * 4))
    v = int(c.get("vocab", 256))
    hd = d // h
    layer = {
        "attn_norm": (d,), "wq": (d, h * hd), "wk": (d, hkv * hd),
        "wv": (d, hkv * hd), "wo": (h * hd, d), "mlp_norm": (d,),
        "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d),
    }
    return {
        "embed": (v, d),
        "layers": [layer] * int(c.get("n_layers", 4)),
        "final_norm": (d,), "lm_head": (d, v),
    }


# Llama-3-8B shape, for the smoke run and benchmarks; tests use much
# smaller dims.
LLAMA3_8B = dict(
    dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    ffn_dim=14336, vocab=128256, seq_len=8192,
)
