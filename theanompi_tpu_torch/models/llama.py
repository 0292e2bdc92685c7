"""Llama-family decoder transformer: serving at tp >= 1, BSP training at
tp, sp, pp >= 1, dense or with a top-k MoE FFN at ep >= 1.

Port of ``theanompi_tpu/models/llama.py``: the model math (RMSNorm,
interleaved-pair RoPE with theta 10000, GQA, SwiGLU, untied LM head),
the parameter layout and init, the training contract the BSP worker
drives, and the bridge that carries a JAX parameter tree and optimizer
state across.

Parameters are a plain dict of tensors in the JAX layout —
``{"embed" [V, D], "layers": [{attn_norm, wq [D, H*hd], wk, wv, wo,
mlp_norm, w_gate, w_up, w_down}], "final_norm", "lm_head" [D, V]}``,
weights ``[in, out]`` so every product is ``x @ w``; with MoE each
layer holds ``router`` [D, E] and ``we_gate``/``we_up`` [E, D, F],
``we_down`` [E, F, D] in place of the dense FFN.

- Serving (``make_decoder``) holds them in the compute dtype: the JAX
  path keeps fp32 master weights but casts them to ``x.dtype`` before
  every use (``tp.col_parallel``/``row_parallel`` and ``rms_norm``), so
  casting once at init or load is exactly equivalent.  As in JAX,
  serving takes tensor parallelism only (no sp, pp or MoE).
- Training (``build_model`` -> ``compile_iter_fns`` -> ``train_iter``)
  keeps fp32 master weights, cast at each use as in the JAX step, and
  trains them with the JAX optimizers' update forms.  Each step runs
  the forward (per-layer ``torch.utils.checkpoint`` when ``remat``),
  the fused LM head (chunked over the vocab at >= 64k, else dense), the
  backward (attention through kernels K1-K3 on the card), the
  allreduce-mean of the gradients by the named strategy over the
  data replicas, and the optimizer update.  A rank at replica
  coordinate r takes rows ``[r*B, (r+1)*B)`` of the global batch, as
  the JAX ``batch_spec`` shards it, staged as int64 ids through
  ``data.HostStager`` (or the streaming feed, with ``loader_pipeline``);
  loss and error are means over the replica and seq ranks.

- Tensor-parallel serving (``tp > 1`` with a ``ModelGroup``, one
  process a rank): each rank holds the JAX ``param_specs`` shard of
  every leaf (:data:`SHARD_AXIS`) — the columns of ``wq``, ``wk``,
  ``wv``, ``w_gate``, ``w_up`` and ``lm_head``, the rows of ``wo``,
  ``w_down`` and ``embed`` — so rank r holds query heads
  ``[r·H/tp, (r+1)·H/tp)`` and kv heads ``[r·Hkv/tp, (r+1)·Hkv/tp)``,
  GQA's grouping.  Random parameters are drawn in full from the seed
  and sliced, so every layout trains and serves the same weights.

- Training in a ``parallel.mesh.Layout`` (one process a rank; pipe ×
  expert × data × model × seq, seq fastest).  The model axis shards the
  leaves as serving does; the replicated input of each column-parallel
  product goes through ``tp.copy_to_group`` and each row-parallel sum
  through ``tp.reduce_from_group`` (the JAX psum/pvary transposes), and
  the fused head reduces over the vocab shards.  The seq axis gives each
  rank ``T/sp`` columns at positions ``seq_idx·T/sp + arange``;
  attention runs as ring attention (``sp_mode="ring"``) or Ulysses
  (``"ulysses"``).  Each rank backpropagates its local mean loss and
  every leaf's gradient is meaned over the seq group in f32 (JAX's
  autodiff psum of the seq pmean's cotangents) before or with the data
  exchange.
- The pipe axis (``pp > 1``) is GPipe (``parallel/pp.py``): a stage
  holds its ``L/pp`` consecutive layers (JAX stacks them ``[L, ...]``,
  sharded on dim 0) and runs them on ``pp_microbatches`` microbatches
  over ``M + pp - 1`` ticks.  The embed runs on every stage (stage 0's
  feeds the chain); by default the head runs on a ``1/pp`` token slice
  of the last stage's output on each stage (``pp_head_scatter``), the
  loss a mean over the stages; otherwise it runs on every stage, masked
  to the last.  The leaves the pipe axis does not shard (``embed``,
  ``final_norm``, ``lm_head``) have their gradients summed over the
  stages in f32 before the exchange: the psum JAX's autodiff inserts
  for a pipe-invariant leaf.
- MoE (``n_experts > 0``, ``parallel/moe.py``): every block's FFN is a
  top-k MoE; ``ep`` shards the expert leaves over the expert axis
  (their dim 0; the FFN dim over model), whose ranks are also data
  replicas, with the routed tokens exchanged by all-to-all.  Each
  layer's aux moments (the pick fractions and mean router
  probabilities over the token-sharding ranks, the z-loss) ride the
  pipeline's payload at pp > 1; the loss is ``xent + moe_aux_coef·lb
  + moe_z_coef·z``.  The exchange is per leaf and unbucketed, as JAX's:
  an expert leaf's gradient is meaned over data (its all-to-all
  backward already summed the expert group's token cotangents) and
  divided by ``ep``, every other leaf's meaned over (expert, data).
- Checkpoints hold full arrays in the JAX tree of the layout: every
  rank gathers its shards over the model, expert and pipe groups (a
  collective), rank 0 writes; at pp > 1 the layers are stacked.
- zero1 and the compressed wire at a layout, as JAX's: the flat layout
  packs this rank's local shards in the JAX leaf order of its local
  tree (a stage's layers stacked at pp > 1) and shards over the data
  replicas (expert × data) alone, after the pipe sum and the f32 seq
  mean; the flat state and the EF residuals are this rank's block of
  the JAX ``P((pipe, expert, data, model))`` buffer in a ``.shards``
  checkpoint (seq ranks hold equal blocks; seq rank 0 writes), and
  resume only at the layout they were written under.

- ``remat_save=("attn_out",)`` (selective remat, with ``remat``): each
  layer runs as two checkpointed segments around its attention call
  (flash at sp = 1, the ring or Ulysses at sp > 1), which runs once and
  keeps its residuals (K1's o and lse, with q, k and v), so the
  backward replays the projections, the norms and the FFN but not the
  attention forward: K1 L times a step, not 2L, and at sp > 1 no ring
  hop again.  The JAX policy ``save_only_these_names`` keeps only the
  names the layer has: any other name saves nothing, which is full
  remat, as here.
- ``device_data_cache`` puts ``dataset_sequences()`` on the device once;
  each step's rows come from the epoch permutation on the device,
  sliced at the step's batch index (this replica's ``[b_loc, T + 1]``
  rows; the inputs this seq rank's ``T/sp`` columns, the targets the
  same shifted by one), and ``train_chunk`` runs ``steps_per_call``
  steps a call (2 by default) with no host fence among them: their
  (loss, err) pairs stay on the device and are meaned over the ranks
  once a chunk.  ``train_iter`` on the cached path is a chunk of one.
  With ``steps_per_call < 2`` or data without ``dataset_sequences`` it
  warns and stages per step, as JAX does.

Zero1 and the compressed wire with MoE are refused (as in JAX).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from theanompi_tpu_torch.models.base import (
    DTYPES,
    TMModel,
    refuse_layout_exchange,
    resolve_dtype,
)
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
from theanompi_tpu_torch.parallel.moe import moe_ffn
from theanompi_tpu_torch.parallel.pp import (
    last_stage_value,
    merge_microbatches,
    pipe_mean,
    pipeline_apply,
    split_microbatches,
)
from theanompi_tpu_torch.parallel.ring_attention import ring_attention
from theanompi_tpu_torch.parallel.strategies import resolve_compression
from theanompi_tpu_torch.parallel.ulysses import ulysses_attention
from theanompi_tpu_torch.utils import checkpoint as ckpt

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
              "w_gate", "w_up", "w_down")
#: a MoE layer's leaves
MOE_LAYER_KEYS = LAYER_KEYS[:6] + ("router", "we_gate", "we_up", "we_down")
#: the leaves a rank holds the whole of
TOP_KEYS = ("embed", "final_norm", "lm_head")

#: the axis each leaf of the dense model is split along over the model
#: group (the JAX ``param_specs``' MODEL_AXIS); None: every rank holds
#: it whole
SHARD_AXIS = {"embed": 0, "lm_head": 1, "final_norm": None,
              "attn_norm": None, "mlp_norm": None, "wq": 1, "wk": 1,
              "wv": 1, "wo": 0, "w_gate": 1, "w_up": 1, "w_down": 0}
#: the same for the MoE FFN's leaves: the experts' FFN dim over model
MOE_SHARD_AXIS = {"router": None, "we_gate": 2, "we_up": 2, "we_down": 1}
#: every leaf's model axis
MODEL_AXIS = {**SHARD_AXIS, **MOE_SHARD_AXIS}
#: the leaves split on dim 0 over the expert group (JAX EXPERT_AXIS)
EXPERT_LEAVES = ("we_gate", "we_up", "we_down")


def layer_keys(n_experts: int) -> tuple:
    """The leaves of one layer, dense or MoE."""
    return MOE_LAYER_KEYS if n_experts else LAYER_KEYS


def _cut(a, ax: int, rank: int, n: int):
    k = a.shape[ax] // n
    return a[(slice(None),) * ax + (slice(rank * k, (rank + 1) * k),)]


def shard_leaf(a, name: str, rank: int, tp: int, expert_rank: int = 0,
               ep: int = 1):
    """Rank ``rank``'s slice of the full leaf ``a`` (numpy or torch) at
    ``tp`` model ranks, and at ``ep`` expert ranks expert rank
    ``expert_rank``'s experts of an expert leaf; the leaf itself where
    it is not split."""
    ax = MODEL_AXIS[name]
    if tp > 1 and ax is not None:
        a = _cut(a, ax, rank, tp)
    if ep > 1 and name in EXPERT_LEAVES:
        a = _cut(a, 0, expert_rank, ep)
    return a


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
    ``batch_size`` (per data replica), ``n_train, n_val, n_epochs, lr,
    optimizer, weight_decay, remat, remat_save, xent_chunks,
    exch_strategy, exchange_bucket_mb, lr_schedule, loader_pipeline,
    device_data_cache, steps_per_call, pp,
    pp_microbatches, pp_head_scatter, n_experts, moe_top_k,
    capacity_factor, ep, moe_aux_coef, moe_z_coef``.  Serving
    parameters are drawn from ``self.generator`` (seeded with ``seed``)
    at first use unless ``params`` is given (e.g. from
    :func:`params_from_jax` or a checkpoint); training draws the same
    values in fp32 at ``compile_iter_fns``.  ``device`` defaults to the card;
    ``device="cpu"`` runs on the CPU.  At ``tp > 1`` ``group`` is this
    rank's ``parallel.mesh.ModelGroup`` of ``tp`` ranks (by default the
    model axis of the ``current_layout()``, which the BSP worker builds)
    and ``params`` its shards.  At ``sp``, ``pp`` or ``ep > 1``
    (training) those axes come from the layout.
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
        self.tp = int(c.get("tp", 1))
        self.sp = int(c.get("sp", 1))
        self.pp = int(c.get("pp", 1))
        # MoE knobs: n_experts=0 keeps the dense SwiGLU FFN
        self.n_experts = int(c.get("n_experts", 0))
        self.moe_top_k = int(c.get("moe_top_k", 2))
        self.capacity_factor = float(c.get("capacity_factor", 1.25))
        self.ep = int(c.get("ep", 1))
        self.moe_aux_coef = float(c.get("moe_aux_coef", 0.01))
        self.moe_z_coef = float(c.get("moe_z_coef", 0.0))
        self.keys = layer_keys(self.n_experts)
        batch = int(c.get("batch_size", 8))
        # two microbatches a stage halve the GPipe bubble against M = S,
        # when the local batch allows it
        default_m = 2 * self.pp if batch % (2 * self.pp) == 0 else self.pp
        self.pp_microbatches = int(
            c.get("pp_microbatches", default_m) if self.pp > 1 else 1)
        self.sp_mode = str(c.get("sp_mode", "ring"))
        # the head on a 1/pp token slice a stage when the local token
        # count divides by pp; the ragged case masks it to the last stage
        self._pp_scatter = bool(c.get("pp_head_scatter", True)) and (
            self.pp > 1 and (batch * (self.seq_len // max(self.sp, 1)))
            % self.pp == 0)
        if self.sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"sp_mode must be 'ring' or 'ulysses', got "
                             f"{self.sp_mode!r}")
        if self.seq_len % self.sp:
            raise ValueError(f"seq_len {self.seq_len} must divide by sp "
                             f"{self.sp}")
        if self.pp < 1 or self.n_layers % self.pp:
            raise ValueError(f"n_layers must divide by pp: n_layers "
                             f"{self.n_layers}, pp {self.pp}")
        if self.n_experts:
            if self.n_experts % self.ep:
                raise ValueError(f"n_experts {self.n_experts} must divide "
                                 f"by ep {self.ep}")
            if not 0 < self.moe_top_k <= self.n_experts:
                raise ValueError(f"moe_top_k must be in (0, n_experts="
                                 f"{self.n_experts}], got {self.moe_top_k}")
        elif self.ep != 1:
            raise ValueError("ep > 1 requires n_experts > 0")
        if self.pp > 1 and batch % self.pp_microbatches:
            raise ValueError(f"local batch {batch} must divide into "
                             f"{self.pp_microbatches} microbatches")
        # the layout the BSP worker built for this run, if it fits
        lay = current_layout()
        if lay is not None and (lay.dims["model"], lay.dims["seq"],
                                lay.dims["pipe"], lay.dims["expert"]) \
                != (self.tp, self.sp, self.pp, self.ep):
            lay = None
        self.layout = lay
        if group is None and lay is not None and self.tp > 1:
            group = lay.model
        self.group = group if group is not None and group.size > 1 else None
        self.tp_rank = group.rank if group is not None else 0
        # this rank's stage and expert coordinates (0 without a layout)
        self.stage = lay.pipe.rank if lay is not None else 0
        self.expert_rank = lay.expert.rank if lay is not None else 0
        self.layer_offset = self.stage * (self.n_layers // self.pp)
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
        self.remat = bool(c.get("remat", True))
        # the names the remat policy saves (JAX save_only_these_names):
        # the layer names one, "attn_out"
        self.remat_save = tuple(c.get("remat_save", ()))
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

    @property
    def _coords(self) -> dict:
        """This rank's shard coordinates for :func:`params_from_jax`."""
        return dict(rank=self.tp_rank, tp=self.tp, stage=self.stage,
                    pp=self.pp, expert_rank=self.expert_rank, ep=self.ep)

    def init_params(self, dtype=None) -> dict:
        """Random parameters with the shapes and scales of the JAX
        ``_init_full_params`` (each expert its own fan-in/fan-out
        scale), in ``dtype`` (default: the compute dtype): each tensor
        drawn whole in fp32 from the model's generator, reseeded first
        so every call and every layout draws the same values, then cut
        to this rank's shard (its stage's layers, its experts, its model
        slice) and cast before the next is drawn, so the fp32 peak is
        one tensor."""
        d, f, v, e = self.dim, self.ffn_dim, self.vocab, self.n_experts
        hd = self.head_dim
        dev, cd = self.device, dtype or self.compute_dtype
        self.generator.manual_seed(self.seed)

        def normal(name, shape, scale):
            x = torch.randn(shape, generator=self.generator, device=dev,
                            dtype=torch.float32)
            part = shard_leaf(x.mul_(scale), name, self.tp_rank, self.tp,
                              self.expert_rank, self.ep)
            # no view of the full draw
            return part.to(cd, copy=part.shape != x.shape)

        def dense(name, shape):
            return normal(name, shape,
                          (2.0 / (shape[0] + shape[-1])) ** 0.5)

        def ones():
            return torch.ones((d,), dtype=cd, device=dev)

        l_loc = self.n_layers // self.pp
        layers = []
        for i in range(self.n_layers):
            lp = {
                "attn_norm": ones(),
                "wq": dense("wq", (d, self.n_heads * hd)),
                "wk": dense("wk", (d, self.n_kv_heads * hd)),
                "wv": dense("wv", (d, self.n_kv_heads * hd)),
                "wo": dense("wo", (self.n_heads * hd, d)),
                "mlp_norm": ones(),
            }
            if e:
                lp.update({
                    "router": dense("router", (d, e)),
                    "we_gate": normal("we_gate", (e, d, f),
                                      (2.0 / (d + f)) ** 0.5),
                    "we_up": normal("we_up", (e, d, f),
                                    (2.0 / (d + f)) ** 0.5),
                    "we_down": normal("we_down", (e, f, d),
                                      (2.0 / (f + d)) ** 0.5),
                })
            else:
                lp.update({
                    "w_gate": dense("w_gate", (d, f)),
                    "w_up": dense("w_up", (d, f)),
                    "w_down": dense("w_down", (f, d)),
                })
            # every stage draws every layer (the generator's sequence)
            # and keeps its own
            if self.layer_offset <= i < self.layer_offset + l_loc:
                layers.append(lp)
        return {
            "embed": normal("embed", (v, d), 0.02),
            "layers": layers,
            "final_norm": ones(),
            "lm_head": dense("lm_head", (d, v)),
        }

    def n_params(self) -> int:
        """The parameters this rank holds."""
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
        compute dtype, H/tp query and Hkv/tp kv heads.  With MoE returns
        ``(x, moments)``: the fp32 ``[2E+1]`` of this layer's aux moments
        (f, p, z), kept linear so microbatches average exactly."""
        return self._attn_out(p, x, self._attn(*self._attn_in(p, x, pos)))

    def _attn_in(self, p, x, pos):
        """The attention's inputs: q [B, H/tp, T/sp, hd] and k, v (at
        sp = 1 repeated to the query heads), roped."""
        h, hkv = self.n_heads // self.tp, self.n_kv_heads // self.tp
        hd = self.head_dim
        xn = tp_lib.copy_to_group(rms_norm(x, p["attn_norm"]), self.group)
        q = rope(_heads(tp_lib.col_parallel(xn, p["wq"]), h, hd), pos)
        k = rope(_heads(tp_lib.col_parallel(xn, p["wk"]), hkv, hd), pos)
        v = _heads(tp_lib.col_parallel(xn, p["wv"]), hkv, hd)
        # GQA: K/V stay compact on the wire; repeated only to compute
        if self.sp == 1 and h != hkv:
            # jnp.repeat on axis 1 is repeat_interleave on dim 1
            k = k.repeat_interleave(h // hkv, dim=1)
            v = v.repeat_interleave(h // hkv, dim=1)
        return q, k, v

    def _attn(self, q, k, v):
        """The attention output ``o`` (the JAX layer's ``attn_out``): K1
        at sp = 1, the ring or Ulysses over the seq group."""
        if self.sp == 1:
            return flash_attention(q, k, v, causal=True)
        rep = q.shape[1] // k.shape[1]
        if self.sp_mode == "ring":
            return ring_attention(q, k, v, self.layout.seq, causal=True,
                                  kv_rep=rep)
        return ulysses_attention(q, k, v, self.layout.seq, causal=True,
                                 kv_rep=rep)

    def _attn_out(self, p, x, o):
        """The rest of the block after the attention output ``o``: its
        projection onto the residual stream, then the FFN (dense or
        MoE)."""
        cd, g = self.compute_dtype, self.group
        x = x + tp_lib.row_parallel(_unheads(o), p["wo"], g).to(cd)
        xn = rms_norm(x, p["mlp_norm"])
        if self.n_experts:
            lay = self.layout
            y, aux = moe_ffn(
                xn, p["router"], p["we_gate"], p["we_up"], p["we_down"],
                n_experts=self.n_experts, top_k=self.moe_top_k,
                capacity_factor=self.capacity_factor,
                expert_group=lay.expert if self.ep > 1 else None,
                model_group=g,
                # the aux moments are means over every token-sharding rank
                batch_group=lay.expert_data_seq if lay is not None
                else None)
            mom = torch.cat([aux["f"], aux["p"], aux["z"][None]]).float()
            return x + y.to(cd), mom
        xn = tp_lib.copy_to_group(xn, g)
        gate = F.silu(tp_lib.col_parallel(xn, p["w_gate"]))
        up = tp_lib.col_parallel(xn, p["w_up"])
        return x + tp_lib.row_parallel(gate * up, p["w_down"], g).to(cd)

    def _forward(self, params, ids):
        """ids [B, T/sp] (this rank's columns) -> (final-normed hidden
        states, MoE aux ``[lb, z]`` or None).  The states are
        ``[B, T/sp, D]``, or at pp > 1 with the scattered head this
        stage's ``1/pp`` token slice ``[B·T/sp/pp, D]``; on the ragged
        fallback they are valid on the last stage only.  Each layer runs
        under non-reentrant ``checkpoint`` when ``remat`` and gradients
        are on (its forward, collectives included, runs again in the
        backward); with ``"attn_out"`` in ``remat_save`` as two
        checkpointed segments around the attention, which runs once."""
        t_loc = ids.shape[1]
        seq_idx = self.layout.seq.rank if self.sp > 1 else 0
        pos = seq_idx * t_loc + torch.arange(t_loc, device=ids.device)
        x = tp_lib.embed_lookup(ids, params["embed"], self.vocab,
                                self.group)
        x = x.to(self.compute_dtype)
        remat = self.remat and torch.is_grad_enabled()
        keep_attn = remat and "attn_out" in self.remat_save

        def ckpt(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)

        def layer(p, x):
            if keep_attn:
                # the attention's own residuals (q, k, v, o, lse) are
                # saved by its autograd function; both segments replay
                return ckpt(self._attn_out, p, x,
                            self._attn(*ckpt(self._attn_in, p, x, pos)))
            if remat:
                return ckpt(self._layer, p, x, pos)
            return self._layer(p, x, pos)

        moe = bool(self.n_experts)
        aux = None
        if self.pp == 1:
            moms = []
            for p in params["layers"]:
                if moe:
                    x, mom = layer(p, x)
                    moms.append(mom)
                else:
                    x = layer(p, x)
            if moe:
                aux = self._aux_from_moments(torch.stack(moms))
            return rms_norm(x, params["final_norm"]), aux
        pipe = self.layout.pipe
        # this stage's global layer rows of the moments payload
        rows = torch.arange(len(params["layers"]), device=x.device) \
            + self.layer_offset

        def stage_fn(stage_params, payload):
            xm, am = (payload["x"], payload["aux"]) if moe \
                else (payload, None)
            for i, p in enumerate(stage_params):
                if moe:
                    xm, mom = layer(p, xm)
                    # the moment rows travel WITH the microbatch, so the
                    # last stage's payload holds every layer's
                    am = am.index_copy(0, rows[i:i + 1], mom[None])
                else:
                    xm = layer(p, xm)
            return {"x": xm, "aux": am} if moe else xm

        xmb = split_microbatches(x, self.pp_microbatches)
        if moe:
            xmb = {"x": xmb, "aux": torch.zeros(
                (self.pp_microbatches, self.n_layers,
                 2 * self.n_experts + 1), dtype=torch.float32,
                device=x.device)}
        ys = pipeline_apply(stage_fn, params["layers"], xmb, pipe)
        if moe:
            # the microbatch mean of the moments (valid on the last
            # stage, broadcast), then the losses: the pp = 1 numbers at
            # any microbatch count
            aux = self._aux_from_moments(
                last_stage_value(ys["aux"].mean(dim=0), pipe))
            ys = ys["x"]
        x = merge_microbatches(ys)
        if self._pp_scatter:
            # the last stage's activations on every stage, then each
            # stage's 1/pp of the tokens: a stage-varying slice of a
            # pipe-invariant value, whose cotangents JAX's implicit
            # pvary sums over the stages (copy_to_group)
            x = self._pp_slice_tokens(tp_lib.copy_to_group(
                last_stage_value(x, pipe), pipe))
        return rms_norm(x, params["final_norm"]), aux

    def _aux_from_moments(self, moms):
        """``[L, 2E+1]`` per-layer moments -> fp32 ``[lb, z]``, layer
        means; ``E·Σ f·p`` forms after any microbatch mean."""
        e = self.n_experts
        f, p, z = moms[:, :e], moms[:, e:2 * e], moms[:, 2 * e]
        lb = e * (f * p).sum(dim=-1)
        return torch.stack([lb.mean(), z.mean()])

    def _pp_value(self, v):
        """A per-stage metric combined over the stages: the stages' mean
        with the scattered head (each holds an equal slice's), the last
        stage's value on the masked path; ``v`` at pp = 1."""
        if self.pp == 1:
            return v
        if self._pp_scatter:
            return pipe_mean(v, self.layout.pipe)
        return last_stage_value(v, self.layout.pipe)

    def _pp_slice_tokens(self, arr):
        """This stage's 1/pp token slice of ``[B, T/sp, ...]``, flattened
        row-major over (B, T): the one geometry of the scattered head's
        activations and :meth:`_pp_targets`."""
        n_tok = arr.shape[0] * arr.shape[1]
        flat = arr.reshape((n_tok,) + tuple(arr.shape[2:]))
        sl = n_tok // self.pp
        return flat[self.stage * sl:(self.stage + 1) * sl]

    def _pp_targets(self, y):
        return self._pp_slice_tokens(y) if self._pp_scatter else y

    def _loss(self, params, x, y):
        """(loss, top-1 error) of one local batch through the fused head:
        the mean xent (combined over the stages) plus, with MoE,
        ``moe_aux_coef·lb + moe_z_coef·z``."""
        h, aux = self._forward(params, x)
        h2 = h.reshape(-1, h.shape[-1])
        yf = self._pp_targets(y).reshape(-1)
        if self._n_xent_chunks > 1:
            loss_vec, pred = tp_lib.chunked_unembed_xent(
                h2, params["lm_head"], yf, self.vocab, self._n_xent_chunks,
                self.group)
        else:
            loss_vec, pred = tp_lib.dense_unembed_xent(
                h2, params["lm_head"], yf, self.vocab, self.group)
        loss = self._pp_value(loss_vec.mean())
        err = self._pp_value((pred != yf).float().mean())
        if aux is not None:
            loss = loss + self.moe_aux_coef * aux[0] \
                + self.moe_z_coef * aux[1]
        return loss, err

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
        group, take the layout the BSP worker built at tp·sp·pp·ep > 1,
        pick the head, and draw fp32 master parameters (whole, then this
        rank's shards) and fresh optimizer state."""
        if unknown:
            raise TypeError(
                f"Llama.compile_iter_fns: unknown kwargs {sorted(unknown)}"
            )
        if self.data is None:
            raise RuntimeError("call build_model() before compile_iter_fns()")
        cfg = self.config
        comp = resolve_compression(cfg)[0]
        refuse_layout_exchange(
            cfg, str(exch_strategy or cfg.get("exch_strategy", "ici32"))
            .startswith("zero1"), comp)
        if not dist.is_initialized():
            init_group(self.device)        # a one-rank group of its own
        lay = self.layout
        # MoE at world > 1 needs the layout too: its aux moments mean
        # over every token-sharding rank (expert × data × seq)
        if self.tp * self.sp * self.pp * self.ep > 1 or (
                self.n_experts and dist.get_world_size() > 1):
            if lay is None:
                raise ValueError(
                    f"tp={self.tp}, sp={self.sp}, pp={self.pp}, "
                    f"ep={self.ep}, n_experts={self.n_experts} over "
                    f"{dist.get_world_size()} ranks trains over a "
                    f"parallel.mesh.Layout built before the model "
                    f"(Layout.build, as bsp_worker.run does)")
            if self.tp > 1 and self.group is not lay.model:
                raise ValueError(f"the model group {self.group} is not "
                                 f"the layout's model axis {lay.model}")
        if lay is not None:
            # the batch rows and the BSP exchange run over the data
            # replicas: expert × data
            self._rank, self._world = lay.expert_data.rank, lay.dp_replicas
            self._dp_group = lay.expert_data.device_group
        else:
            self._rank, self._world = dist.get_rank(), dist.get_world_size()
        self._save_collective = (self.group is not None or self.pp > 1
                                 or self.ep > 1)
        b = int(self.config.get("batch_size", 8))
        if self._world * b != self.data.global_batch:
            raise ValueError(
                f"{self._world} data replicas x per-replica batch {b} != "
                f"global batch {self.data.global_batch} (build_model "
                f"n_replicas must match the layout's expert x data axes)"
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
        f32_wire = self._strategy.wire_dtype is None
        if self.sp > 1:
            # the seq ranks' gradients mean in f32, as JAX's autodiff psum
            # of the seq pmean's cotangents: an f32 wire means them with
            # the replicas' in one pass; a 16-bit wire, zero1 and the
            # compressed wire over seq first, their flat state then
            # sharded over the data replicas alone (JAX's padded / n_dp)
            if f32_wire and not (self._zero1 or self._compression):
                self._dp_group = lay.expert_data_seq.device_group
            else:
                self._seq_group = lay.seq.device_group
        names = leaf_names(params)
        if self.n_experts:
            # per leaf: the expert leaves over data (then / ep), the rest
            # over (expert, data)
            self._expert_leaves = frozenset(
                i for i, n in enumerate(names)
                if n.rsplit(".", 1)[-1] in EXPERT_LEAVES)
            self._ep = self.ep
            if lay is not None:
                self._expert_dp_group = (
                    lay.data_seq if self.sp > 1 and f32_wire
                    else lay.data).device_group
        if self.pp > 1:
            self._pipe_sum = (lay.pipe.device_group,
                              [i for i, n in enumerate(names)
                               if n in TOP_KEYS])
        replicated = []
        if self._compression and self.tp > 1:
            replicated.append((
                lay.axis_ranks("model")[0], lay.model.device_group,
                [i for i, n in enumerate(names)
                 if MODEL_AXIS[n.rsplit(".", 1)[-1]] is None]))
        if self._compression and self.pp > 1:
            replicated.append((lay.axis_ranks("pipe")[0],
                               lay.pipe.device_group, self._pipe_sum[1]))
        self._replicated = tuple(replicated)
        if not self._zero1:          # zero1 holds the state of its shard
            self.opt_state = self.optimizer.init(list(_leaves(params)))
        self._device_cache, self._chunk_k = None, 0
        if cfg.get("device_data_cache"):
            self._init_device_cache(b)
        # this rank's rows of each global (inputs, targets) batch, as
        # int64 ids, through the stager (and the feed, when asked for
        # and the train set is not on the device)
        self._init_feed(b, dtypes=(torch.int64, torch.int64))

    def _init_device_cache(self, b_loc: int) -> None:
        """Put the train sequences on the device once and run
        ``steps_per_call`` steps a ``train_chunk`` call (2 by default);
        with fewer than 2, or data without ``dataset_sequences``, warn
        and stage per step (the JAX ``_init_device_cache``)."""
        k = int(self.config.get("steps_per_call", 2) or 0)
        get = getattr(self.data, "dataset_sequences", None)
        if k < 2 or get is None:
            warnings.warn(
                "device_data_cache requested but "
                + ("steps_per_call < 2" if get is not None else
                   "the data object does not expose "
                   "dataset_sequences()")
                + "; falling back to per-step host staging",
                stacklevel=3,
            )
            return
        self._device_cache = (torch.from_numpy(
            np.asarray(get(), np.int64)).to(self.device),)
        self._init_cached_steps(b_loc, k)

    def _cached_batch(self, count: int):
        """This rank's (inputs, targets) of train batch ``count``: its
        replica's ``[b_loc, T + 1]`` rows gathered on the device
        (``_cached_rows``), the inputs this seq rank's ``T/sp`` columns
        and the targets the same shifted by one."""
        rows = self._device_cache[0].index_select(
            0, self._cached_rows(count))
        t_loc = self.seq_len // self.sp
        lo = (self.layout.seq.rank if self.sp > 1 else 0) * t_loc
        return (rows[:, lo:lo + t_loc].contiguous(),
                rows[:, lo + 1:lo + 1 + t_loc].contiguous())

    def _rank_mean(self, stats: torch.Tensor) -> torch.Tensor:
        """f32 ``stats`` (a step's ``[loss, err]``, a chunk's ``[K, 2]``)
        meaned over the replica and seq ranks (the model and pipe ranks
        hold equal values), as the JAX pmean over (expert, data,
        seq)."""
        if self.layout is None:
            dist.all_reduce(stats)
            return stats / self._world
        g = self.layout.expert_data_seq
        dist.all_reduce(stats, group=g.device_group)
        return stats / g.size

    def _seq_columns(self, *ts):
        """This seq rank's ``T/sp`` columns of each [B, T] batch."""
        if self.sp == 1:
            return ts
        t_loc, s = self.seq_len // self.sp, self.layout.seq.rank
        return tuple(t[:, s * t_loc:(s + 1) * t_loc].contiguous()
                     for t in ts)

    def train_iter(self, count: int, recorder) -> None:
        if self._device_cache is not None:
            return self.train_chunk(count, 1, recorder)
        recorder.start()
        staged = (self._feed.next(count) if self._feed is not None
                  else self._stager.stage(self.data.train_batch(count)))
        x, y = self._seq_columns(*staged.wait())
        recorder.end("wait")
        recorder.start()
        stats = self._rank_mean(self._train_step(x, y))
        recorder.end("calc")
        recorder.train_error(count, stats[0], stats[1])

    def _train_step(self, x, y) -> torch.Tensor:
        """One step on this rank's (inputs, targets): forward, backward,
        the exchange and the update; this rank's f32 ``[loss, err]``, not
        yet meaned over the ranks."""
        leaves = list(_leaves(self.params))
        loss, err = self._loss(self.params, x, y)
        grads = list(torch.autograd.grad(loss, leaves))
        self._exchange_update(leaves, grads)
        return torch.stack([loss.detach().float(), err.float()])

    def _step_loss(self, count: int):
        x, y = self._seq_columns(
            *self._stager.stage(self.data.train_batch(count)).wait())
        leaves = list(_leaves(self.params))
        return self._loss(self.params, x, y)[0], leaves

    @torch.no_grad()
    def val_iter(self, count: int, recorder):
        x, y = self._seq_columns(
            *self._stager.stage(self.data.val_batch(count)).wait())
        h, _ = self._forward(self.params, x)
        logits = tp_lib.col_parallel(h, self.params["lm_head"])
        g = self.group
        y = self._pp_targets(y).reshape(logits.shape[:-1])
        stats = self._rank_mean(torch.stack([
            self._pp_value(v).float() for v in (
                tp_lib.sharded_softmax_xent(logits, y, self.vocab, g),
                tp_lib.sharded_top1_err(logits, y, self.vocab, g),
                tp_lib.sharded_topk_err(logits, y, self.vocab, k=5,
                                        group=g))]))
        return tuple(float(v) for v in stats)

    def replica_groups(self) -> list:
        """The parameter leaves with the ranks that must hold each equal
        (``TM_DEBUG_SYNC``): the dense leaves over (expert, data, seq),
        the expert leaves over (data, seq); never over pipe (a stage
        holds its own layers) nor over model (a sharded leaf's shards
        differ)."""
        lay = self.layout
        names = leaf_names(self.params)
        leaves = list(_leaves(self.params))
        expert = [t for t, n in zip(leaves, names)
                  if n.rsplit(".", 1)[-1] in EXPERT_LEAVES]
        dense = [t for t, n in zip(leaves, names)
                 if n.rsplit(".", 1)[-1] not in EXPERT_LEAVES]
        return [(dense, lay.expert_data_seq), (expert, lay.data_seq)]

    # -- checkpoint ---------------------------------------------------------

    def _leaves(self) -> list:
        return list(_leaves(self.params))

    def _exchange_order(self) -> list:
        """The JAX leaf order of this rank's local tree: at pp > 1 JAX
        stacks a stage's layers ``{name: [L/pp, ...]}``, so each stacked
        leaf comes whole (its layers in order), name by name."""
        pos = {id(t): i for i, t in enumerate(_leaves(self.params))}
        tree = self.params
        if self.pp > 1:
            tree = dict(tree, layers={k: [lp[k] for lp in tree["layers"]]
                                      for k in self.keys})
        return [(pos[id(t)], None) for t in ckpt.flatten(tree).values()]

    def checkpoint_trees(self) -> dict:
        """The checkpoint's trees in full arrays in the JAX layout of
        this config (the layers stacked at pp > 1): every rank gathers
        each leaf's shards over its model, expert and pipe groups (a
        collective: every rank calls this)."""
        opt = () if self._zero1 else _opt_tree(self.opt_state, self.keys)
        full = self._full_tree
        trees = {"params": full(self.params), "opt_state": opt}
        if isinstance(opt, dict):
            trees["opt_state"] = {"m": full(opt["m"]), "v": full(opt["v"]),
                                  "t": opt["t"]}
        elif opt:
            trees["opt_state"] = full(opt)
        trees.update(self._exchange_trees())
        return trees

    def _full_tree(self, tree: dict) -> dict:
        """A parameter-shaped tree of this rank's shards as the full JAX
        tree: each split leaf gathered over the model group (along its
        :data:`MODEL_AXIS`) and, an expert leaf, over the expert group
        (dim 0); at pp > 1 the stages' layers gathered and stacked
        ``{name: [L, ...]}``."""
        lay = self.layout

        def leaf(t, name):
            t = t.detach()
            if self.group is not None and MODEL_AXIS[name] is not None:
                t = _gather(t, self.group, MODEL_AXIS[name])
            if self.ep > 1 and name in EXPERT_LEAVES:
                t = _gather(t, lay.expert, 0)
            return t

        layers = [{k: leaf(lp[k], k) for k in self.keys}
                  for lp in tree["layers"]]
        if self.pp > 1:
            layers = {k: _gather(torch.stack([lp[k] for lp in layers]),
                                 lay.pipe, 0) for k in self.keys}
        return {"embed": leaf(tree["embed"], "embed"), "layers": layers,
                "final_norm": leaf(tree["final_norm"], "final_norm"),
                "lm_head": leaf(tree["lm_head"], "lm_head")}

    def restore_trees(self, trees: dict) -> None:
        params = params_from_jax(trees["params"], self.config, self.device,
                                 dtype=torch.float32, **self._coords)
        for t in _leaves(params):
            t.requires_grad_(True)
        self._params = params
        if "opt_state" in trees:
            self.opt_state = opt_state_from_jax(trees["opt_state"],
                                                self.config, self.device,
                                                **self._coords)


def _gather(t, group, dim: int):
    """``t`` of every rank of ``group`` concatenated along ``dim``, rank
    order."""
    out = torch.empty((group.size,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out.view(-1), t.contiguous().view(-1),
                                group=group.device_group)
    return torch.cat(out.unbind(0), dim=dim)


def _leaves(params: dict):
    yield params["embed"]
    for lp in params["layers"]:
        yield from lp.values()
    yield params["final_norm"]
    yield params["lm_head"]


def leaf_names(params: dict, offset: int = 0) -> list:
    """The names of :func:`_leaves`: ``embed``, ``layers.i.wq``, ...,
    ``i`` the global layer index of a stage whose first layer is
    ``offset``."""
    return (["embed"] + [f"layers.{offset + i}.{k}"
                         for i, lp in enumerate(params["layers"])
                         for k in lp]
            + ["final_norm", "lm_head"])


# -- the JAX parameter bridge -------------------------------------------------

def save_init_checkpoint(config: dict, directory) -> None:
    """Write a model's seeded initial state — fp32 parameters drawn on
    the CPU and fresh optimizer state — as checkpoint 0 stamped epoch
    -1, which a run with ``resume=True`` starts epoch 0 from, in the
    JAX tree of ``config``'s layout (the layers stacked at pp > 1).
    Runs on different devices start from the same parameters this way
    (a generator draws other numbers on the card than on the CPU)."""
    from theanompi_tpu_torch.utils.checkpoint import save_checkpoint

    whole = dict(config, tp=1, sp=1, pp=1, ep=1)
    model = Llama(whole, device="cpu")
    params = model.init_params(torch.float32)
    state = model.optimizer.init(list(_leaves(params)))
    stacked = int(config.get("pp", 1)) > 1
    save_checkpoint(directory, 0, {
        "params": params_to_jax(params, stacked=stacked),
        "opt_state": opt_state_to_jax(state, model.keys, stacked=stacked),
    }, {"epoch": -1, "lr": model.current_lr})


def _tree_from_leaves(flat: list, keys: tuple = LAYER_KEYS) -> dict:
    """The parameter tree of a flat leaf list in ``_leaves`` order, whose
    layers hold ``keys``."""
    it = iter(flat)
    embed = next(it)
    layers = [{k: next(it) for k in keys}
              for _ in range((len(flat) - 3) // len(keys))]
    return {"embed": embed, "layers": layers, "final_norm": next(it),
            "lm_head": next(it)}


def _opt_tree(state, keys: tuple = LAYER_KEYS):
    """The optimizer state (lists in ``_leaves`` order) in the JAX tree
    layout: ``()`` (SGD), a parameter tree (momentum velocity) or
    ``{"m", "v", "t"}`` (Adam)."""
    if isinstance(state, dict):
        return {"m": _tree_from_leaves(state["m"], keys),
                "v": _tree_from_leaves(state["v"], keys), "t": state["t"]}
    if not state:
        return ()
    return _tree_from_leaves(state, keys)


def opt_state_to_jax(state, keys: tuple = LAYER_KEYS, *,
                     stacked: bool = False):
    """The optimizer state as the JAX package holds it, in numpy: f32
    moment trees (the layers stacked when ``stacked``) and Adam's int32
    step count."""
    tree = _opt_tree(state, keys)
    if isinstance(tree, dict) and "m" in tree:
        return {"m": params_to_jax(tree["m"], stacked=stacked),
                "v": params_to_jax(tree["v"], stacked=stacked),
                "t": np.asarray(int(tree["t"]), np.int32)}
    return params_to_jax(tree, stacked=stacked) if tree else ()


def opt_state_from_jax(tree, config: dict, device=None, **coords):
    """Inverse of :func:`opt_state_to_jax`: the port's optimizer state
    (f32 lists in ``_leaves`` order) from a JAX optimizer-state tree of
    numpy arrays (a checkpoint's ``opt_state`` group); ``coords`` (the
    keywords of :func:`params_from_jax`) pick this rank's shards."""
    f32 = dict(device=device, dtype=torch.float32, **coords)
    if isinstance(tree, dict) and "m" in tree:
        return {"m": list(_leaves(params_from_jax(tree["m"], config, **f32))),
                "v": list(_leaves(params_from_jax(tree["v"], config, **f32))),
                "t": torch.tensor(int(np.asarray(tree["t"])),
                                  dtype=torch.int32)}
    if not isinstance(tree, dict):
        return ()
    return list(_leaves(params_from_jax(tree, config, **f32)))


def _layer_list(layers, n: int) -> list:
    """A tree's layers as a list of per-layer dicts: a list as it is,
    the stacked ``{name: [L, ...]}`` of a pp > 1 tree unstacked."""
    if isinstance(layers, dict):
        return [{k: a[i] for k, a in layers.items()} for i in range(n)]
    return list(layers)


def params_from_jax(tree: dict, config: dict, device=None, *,
                    dtype=None, rank: int = 0, tp: int = 1, stage: int = 0,
                    pp: int = 1, expert_rank: int = 0,
                    ep: int = 1) -> dict:
    """The port's parameters from a JAX Llama parameter tree given as
    numpy arrays (``jax.device_get(model.params)`` or a checkpoint's
    ``params`` group), its layers a list or stacked ``{name: [L,
    ...]}`` (pp > 1).  Both packages keep weights ``[in, out]``, so this
    is a copy plus the cast to ``dtype`` (default: the compute dtype, as
    serving holds them; ``torch.float32`` keeps the master weights
    bitwise); full shapes are checked against ``config``.  Each full
    leaf is cut to one rank's shard by the JAX ``param_specs``: model
    rank ``rank`` of ``tp`` (:data:`MODEL_AXIS`), stage ``stage`` of
    ``pp`` (its ``L/pp`` consecutive layers), expert rank
    ``expert_rank`` of ``ep`` (dim 0 of an expert leaf) — so a
    checkpoint of any layout loads at any other."""
    dev = resolve_device(device)
    cd = dtype or DTYPES[str(config.get("compute_dtype", "bfloat16"))]
    expect = _shapes_of(config)
    for name, r, n in (("rank", rank, tp), ("stage", stage, pp),
                       ("expert_rank", expert_rank, ep)):
        if not 0 <= r < n:
            raise ValueError(f"{name} {r} outside [0, {n})")

    def conv(a, shape, name):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(
                f"param {name}: shape {a.shape}, expected {shape}"
            )
        a = shard_leaf(a, name.rsplit(".", 1)[-1], rank, tp, expert_rank,
                       ep)
        return torch.tensor(np.ascontiguousarray(a)).to(device=dev,
                                                        dtype=cd)

    n = len(expect["layers"])
    got = (len(next(iter(tree["layers"].values())))
           if isinstance(tree["layers"], dict) else len(tree["layers"]))
    if got != n:
        raise ValueError(f"tree has {got} layers, config {n}")
    layers = _layer_list(tree["layers"], n)
    keys = tuple(expect["layers"][0])
    if set(layers[0]) != set(keys):
        raise ValueError(f"tree layers hold {sorted(layers[0])}, config "
                         f"{sorted(keys)}")
    l_loc = n // pp
    return {
        "embed": conv(tree["embed"], expect["embed"], "embed"),
        "layers": [
            {k: conv(layers[i][k], expect["layers"][i][k],
                     f"layers[{i}].{k}") for k in keys}
            for i in range(stage * l_loc, (stage + 1) * l_loc)
        ],
        "final_norm": conv(tree["final_norm"], expect["final_norm"],
                           "final_norm"),
        "lm_head": conv(tree["lm_head"], expect["lm_head"], "lm_head"),
    }


def params_to_jax(params: dict, *, stacked: bool = False) -> dict:
    """Inverse of :func:`params_from_jax` for full parameters: the JAX
    tree layout as fp32 numpy arrays (bitwise the input when the compute
    dtype is fp32), the layers stacked ``{name: [L, ...]}`` when
    ``stacked`` (the JAX tree at pp > 1)."""
    def conv(t):
        return t.detach().to("cpu", torch.float32).numpy()

    layers = params["layers"]
    if isinstance(layers, dict):
        out = {k: conv(a) for k, a in layers.items()}
        if not stacked:
            out = _layer_list(out, len(next(iter(out.values()))))
    else:
        out = [{k: conv(a) for k, a in lp.items()} for lp in layers]
        if stacked:
            out = {k: np.stack([lp[k] for lp in out]) for k in out[0]}
    return {
        "embed": conv(params["embed"]),
        "layers": out,
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
    e = int(c.get("n_experts", 0))
    hd = d // h
    layer = {
        "attn_norm": (d,), "wq": (d, h * hd), "wk": (d, hkv * hd),
        "wv": (d, hkv * hd), "wo": (h * hd, d), "mlp_norm": (d,),
    }
    if e:
        layer.update({"router": (d, e), "we_gate": (e, d, f),
                      "we_up": (e, d, f), "we_down": (e, f, d)})
    else:
        layer.update({"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)})
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
