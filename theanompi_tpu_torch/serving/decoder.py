"""Model layer of the serving engine: GQA KV-cache decode for
``models/llama.py``, at one rank or tensor-parallel over a model
group.

Port of ``theanompi_tpu/serving/decoder.py``.  Two cache organisations:

- ``LlamaDecoder`` (v1) — slot-contiguous cache per layer,
  ``[slots, kv_heads, max_seq, hd]``.  The prompt runs through the
  causal forward in one go (bucketed lengths) with attention through
  ``flash_attention`` — kernel K1 on the card — after the K/V heads
  are repeated to the query heads; decode attends with plain einsum
  attention over the slot's cache.
- ``PagedLlamaDecoder`` (v2) — per-layer block pools ``[n_blocks + 1,
  kv_heads, block_size, hd]`` (the extra row is the trash block that
  padding and inactive slots write to) plus per-slot block tables
  (``serving/blocks.py``) and the radix prefix cache.  Prompts prefill
  in fixed-size chunks (gather plus plain attention, as in the JAX
  package); decode attends through ``paged_attend`` — kernel K4 on the
  card — which reads the pools through the tables.  The speculative
  ``verify`` step scores k tokens a slot in one call through the same
  kernel (Q = k query rows a slot), and ``export_blocks`` /
  ``import_blocks`` move a prompt's K/V blocks between decoders (the
  disaggregation handoff, ``serving/kv_transfer.py``).

Every RMS norm (prefill, decode, verify, the final norm) goes through
``ops/norm.rms_norm_rows``: on the card a kernel whose result for a row
depends on that row alone, so a row rounds alike in an 8-row decode
step, a 32-row verify window or a prefill chunk of any length.  The
products are the other half: a GEMM library picks its kernel by the
row count, and two kernels round a row differently.  So the paged
decoder fixes one row count ``product_rows`` = ``max_slots`` x
``PRODUCT_WINDOW`` when it is built, and its decode and verify bodies run
every product (the q/k/v, output, MLP and head projections) at exactly
that many rows: the residual stream is zero-padded to it (a wider
window to a multiple of it, in blocks of it).  A row then has the same
bits in a decode step and in any verify window, which is what makes
speculative ids equal one-token ids.  Prefill is not compared row for
row with another call and keeps its own shapes.

PyTorch runs eagerly, so the JAX package's jit/shard_map scaffolding
(compiled variants, donation, compile counters) has no counterpart:
the device bodies are plain methods and the caches are updated in
place.  The guarantees carry over: a slot's rows depend only on its
own tokens, positions and blocks, and decode always runs all
``max_slots`` rows, so a request decoded in a full batch gives the
same ids as decoded alone; a prefix-cache hit gives the same ids as a
cold prefill.  Sampling at temperature > 0 seeds each token's Gumbel
draw with (request seed, position) — see ``parallel/tp.py``.

**tp > 1.**  The JAX decoder is one controller over a mesh whose model
axis splits the heads, the FFN and the vocab (caches ``P(None,
MODEL_AXIS, None, None)``).  Here each rank is a process holding its
shards (``models/llama.py``), and its decoder holds the caches of its
local kv heads ``Hkv/tp``: K1 and K4 run on the local heads, the
row-parallel products, the embedding and the samplers reduce over the
model group (``parallel/tp.py``).  Rank 0 owns the engine, the block
manager and the prefix cache; each public call (``prefill``,
``decode``, ``verify``, ``copy_block``, ``export_blocks``,
``import_blocks``, ``close``) first broadcasts a header — the call's
name and host arguments — on the group's CPU gloo group to the ranks
>= 1, which sit in :meth:`LlamaDecoder.follow` and run the same body on
their shards.  The engine, router and autoscaler see rank 0's decoder
only.  ``export_blocks``/``import_blocks`` use the GLOBAL kv-head
layout ``[n, Hkv, bs, hd]``, so a handoff exported at one tp imports
at any other.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from theanompi_tpu_torch.models.llama import (
    Llama,
    _heads,
    _unheads,
    params_from_jax,
    rope,
    rope_at,
)
from theanompi_tpu_torch.ops.attention import NEG_INF, flash_attention
from theanompi_tpu_torch.ops.norm import rms_norm_rows
from theanompi_tpu_torch.parallel import tp as tp_lib
from theanompi_tpu_torch.serving.blocks import BlockManager
from theanompi_tpu_torch.serving.paged_attention import (
    gather_blocks,
    paged_attend,
)
from theanompi_tpu_torch.serving.prefix_cache import PrefixCache


def _collective(fn):
    """A public decoder call that every rank of the model group runs:
    on rank 0 of a tp > 1 group it first broadcasts its name and
    arguments to the followers (:meth:`LlamaDecoder.follow`)."""
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        g = self._group
        if g is not None and g.rank == 0:
            dist.broadcast_object_list([(fn.__name__, args, kwargs)], src=0,
                                       group=g.cpu_group)
        return fn(self, *args, **kwargs)
    return call


#: the verify window (tokens a slot) the paged decoder's one product row
#: count covers in one call: ``speculate_k`` 4 and 8 (the engine's and
#: the JAX bench's windows) run at ``max_slots`` x 8 rows, a wider window
#: in blocks of that many
PRODUCT_WINDOW = 8


def _in_blocks(fn, x, m):
    """``fn`` (a product) over the rows of ``x`` in calls of exactly
    ``m`` rows (``x`` holds a multiple of ``m``); ``m`` None: one call."""
    if m is None or x.shape[0] == m:
        return fn(x)
    return torch.cat([fn(x[i:i + m]) for i in range(0, x.shape[0], m)])


def _pad_rows(x, rows: int):
    """``x`` [n, D] with zero rows appended up to ``rows``."""
    return x if x.shape[0] == rows else F.pad(x, (0, 0, 0, rows - x.shape[0]))


def default_prefill_buckets(max_prefill: int, base: int = 16) -> tuple:
    """Power-of-two bucket ladder ``base, 2*base, ...`` capped at
    ``max_prefill`` (always included)."""
    out = []
    b = base
    while b < max_prefill:
        out.append(b)
        b *= 2
    out.append(max_prefill)
    return tuple(out)


class LlamaDecoder:
    """KV-cache decoder over a ``Llama`` (see module docstring).

    Host API (the engine's two scheduling primitives):

    - ``prefill(slot, prompt_ids, seed, temperature) -> first token``
    - ``decode(tokens, lengths, seeds, temps) -> next tokens [S]``
    """

    paged = False

    def __init__(self, model: Llama, *, max_slots: int = 8,
                 max_seq: int | None = None,
                 prefill_buckets: tuple | None = None):
        self._init_common(model, max_slots, max_seq)
        self.prefill_buckets = tuple(
            sorted(prefill_buckets)
            if prefill_buckets else default_prefill_buckets(self.max_prefill)
        )
        if self.prefill_buckets[-1] != self.max_prefill:
            raise ValueError(
                f"largest prefill bucket {self.prefill_buckets[-1]} must "
                f"equal max_prefill {self.max_prefill}"
            )
        shape = (self.max_slots, self._hkv, self.max_seq, self._hd)
        self.cache = self._zeros_cache(shape)

    def _init_common(self, model: Llama, max_slots, max_seq) -> None:
        if model.params is None:
            raise ValueError("LlamaDecoder needs a Llama with parameters")
        if model.pp > 1 or model.sp > 1 or model.n_experts:
            raise NotImplementedError(
                "serving composes with tensor parallelism only — "
                f"pp={model.pp}, sp={model.sp}, "
                f"n_experts={model.n_experts} are not yet servable")
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq or model.seq_len)
        # decode appends one position past the prompt per token, so
        # the longest servable prompt leaves room for >= 1 new token
        self.max_prefill = self.max_seq - 1
        # this rank's heads: all of them at tp = 1
        self._group = model.group if model.tp > 1 else None
        self._tp = model.tp
        self._h = model.n_heads // model.tp
        self._hkv = model.n_kv_heads // model.tp
        self._rep = self._h // self._hkv
        self._hd = model.head_dim
        self._cdtype = model.compute_dtype
        self._scale = self._hd ** -0.5

    def _zeros_cache(self, shape):
        """Per-layer {k, v} zeros of ``shape`` (the contiguous cache and
        the paged block pools differ only in shape)."""
        return [
            {"k": torch.zeros(shape, dtype=self._cdtype, device=self.device),
             "v": torch.zeros(shape, dtype=self._cdtype, device=self.device)}
            for _ in range(self.model.n_layers)
        ]

    def _tensor(self, a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    # -- the model group -------------------------------------------------

    def follow(self) -> None:
        """A follower rank's loop (tp > 1, rank >= 1): receive each
        header rank 0 broadcasts and run the call's body on this rank's
        shards, until ``close``."""
        g = self._group
        if g is None or g.rank == 0:
            raise ValueError("follow() runs on ranks >= 1 of a tp > 1 "
                             "model group")
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=g.cpu_group)
            name, args, kwargs = box[0]
            if name == "close":
                return
            getattr(type(self), name).__wrapped__(self, *args, **kwargs)

    @_collective
    def close(self) -> None:
        """Release the followers from :meth:`follow` (rank 0 of a tp > 1
        group; a no-op at tp = 1)."""

    # -- device bodies ---------------------------------------------------

    def _col(self, x, w, m=None):
        return _in_blocks(lambda b: tp_lib.col_parallel(b, w), x, m)

    def _row(self, x, w, m=None):
        return _in_blocks(lambda b: tp_lib.row_parallel(b, w, self._group),
                          x, m)

    def _mlp(self, p, x, m=None):
        """The MLP block on ``x`` [N, D]; ``m``: run every product in
        calls of ``m`` rows (the decode and verify bodies)."""
        xn = rms_norm_rows(x, p["mlp_norm"])
        gate = F.silu(self._col(xn, p["w_gate"], m))
        up = self._col(xn, p["w_up"], m)
        return x + self._row(gate * up, p["w_down"], m).to(x.dtype)

    def _qkv(self, p, x, n, m=None):
        """Normed input projected to q [n, H, hd], k/v [n, Hkv, hd] for
        the first ``n`` rows of ``x`` (the rest are padding)."""
        xn = rms_norm_rows(x, p["attn_norm"])

        def proj(w, heads):
            return self._col(xn, w, m)[:n].reshape(n, heads, self._hd)

        return (proj(p["wq"], self._h), proj(p["wk"], self._hkv),
                proj(p["wv"], self._hkv))

    def _logits(self, x, m=None):
        xf = rms_norm_rows(x, self.model.params["final_norm"])
        return self._col(xf, self.model.params["lm_head"], m)

    def _sample(self, logits, seeds, pos, temps, greedy: bool):
        """Token ids from [N, V] logits.  ``greedy`` is the all-greedy
        fast path (no Gumbel draw).  Otherwise the token that will sit
        at position pos+1 draws its noise from (seed, pos+1), so
        batched and single-request decodes draw identical noise.
        ``seeds``/``pos`` are host sequences, ``temps`` [N] f32."""
        if greedy:
            return tp_lib.sharded_argmax(logits.float(), self.model.vocab,
                                         self._group)
        folded = [tp_lib.fold_seed(s, int(p) + 1) for s, p in zip(seeds, pos)]
        return tp_lib.sharded_sample(logits, self.model.vocab, folded, temps,
                                     self._group)

    def _decode_body(self, tokens, lengths, seeds, host_lengths, temps,
                     greedy: bool):
        """One token for all slots.  tokens/lengths [S] int64 on the
        device, ``seeds``/``host_lengths`` host arrays, temps [S] f32
        -> next tokens [S]."""
        m = self.model
        s, hd, rep = self.max_slots, self._hd, self._rep
        x = tp_lib.embed_lookup(tokens, m.params["embed"], m.vocab,
                                self._group).to(
            self._cdtype)                                         # [S, D]
        pos = lengths                          # write position per slot
        rows = torch.arange(s, device=self.device)
        valid = (
            torch.arange(self.max_seq, device=self.device)[None, :]
            <= pos[:, None]
        )[:, None, None, :]                                 # [S, 1, 1, T]
        for cache, p in zip(self.cache, m.params["layers"]):
            q, k, v = self._qkv(p, x, s)
            q = rope_at(q, pos)
            k = rope_at(k, pos)
            # append this token's K/V at each slot's own position
            cache["k"][rows, :, pos] = k.to(self._cdtype)
            cache["v"][rows, :, pos] = v.to(self._cdtype)
            # GQA: group the query heads by their KV head
            qg = q.reshape(s, self._hkv, rep, hd)
            scores = torch.einsum("skrd,sktd->skrt", qg, cache["k"]).float()
            scores = torch.where(valid, scores * self._scale, NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            o = torch.einsum(
                "skrt,sktd->skrd", probs.to(self._cdtype), cache["v"]
            ).reshape(s, self._h * hd)
            x = x + tp_lib.row_parallel(o, p["wo"], self._group).to(
                self._cdtype)
            x = self._mlp(p, x)
        return self._sample(self._logits(x), seeds, host_lengths, temps,
                            greedy)

    def _prefill_body(self, ids, slot: int, length: int, seed: int, temp,
                      greedy: bool):
        """Prompt forward for ONE request: ids [t_bucket] (zero-padded
        past ``length``).  Writes K/V rows [0, t_bucket) of ``slot``
        (rows >= length hold padding garbage, overwritten by decode
        before any token attends to them) and samples the first output
        token, which sits at position ``length``."""
        m = self.model
        hd, rep = self._hd, self._rep
        t = ids.shape[0]
        x = tp_lib.embed_lookup(ids[None, :], m.params["embed"], m.vocab,
                                self._group).to(
            self._cdtype)                                      # [1, t, D]
        pos = torch.arange(t, device=self.device)
        for cache, p in zip(self.cache, m.params["layers"]):
            xn = rms_norm_rows(x, p["attn_norm"])
            q = _heads(tp_lib.col_parallel(xn, p["wq"]), self._h, hd)
            k = _heads(tp_lib.col_parallel(xn, p["wk"]), self._hkv, hd)
            v = _heads(tp_lib.col_parallel(xn, p["wv"]), self._hkv, hd)
            q = rope(q, pos)
            k = rope(k, pos)
            cache["k"][slot, :, :t] = k[0].to(self._cdtype)
            cache["v"][slot, :, :t] = v[0].to(self._cdtype)
            if rep != 1:
                k = k.repeat_interleave(rep, dim=1)
                v = v.repeat_interleave(rep, dim=1)
            o = flash_attention(q, k, v, causal=True)
            x = x + tp_lib.row_parallel(_unheads(o), p["wo"], self._group).to(
                self._cdtype)
            x = self._mlp(p, x)
        # only the last prompt token's logits matter
        logits = self._logits(x[:, length - 1])                  # [1, V]
        return self._sample(logits, [seed], [length - 1], temp[None],
                            greedy)[0]

    # -- host API ---------------------------------------------------------

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest bucket covering ``prompt_len``."""
        if not 1 <= prompt_len <= self.max_prefill:
            raise ValueError(
                f"prompt length {prompt_len} outside servable range "
                f"[1, {self.max_prefill}] (max_seq {self.max_seq} "
                f"leaves one position for generation)"
            )
        for b in self.prefill_buckets:
            if b >= prompt_len:
                return b
        raise AssertionError("unreachable: last bucket == max_prefill")

    @_collective
    @torch.no_grad()
    def prefill(self, slot: int, prompt_ids, seed: int,
                temperature: float) -> int:
        """Run one prompt into ``slot``; returns the first sampled token
        (a host int — reading it is the TTFT fence)."""
        ids = np.asarray(prompt_ids, np.int64)
        padded = np.zeros((self.bucket_for(ids.shape[0]),), np.int64)
        padded[: ids.shape[0]] = ids
        tok = self._prefill_body(
            self._tensor(padded), int(slot), int(ids.shape[0]), int(seed),
            self._tensor(temperature, torch.float32), temperature <= 0,
        )
        return int(tok)

    @_collective
    @torch.no_grad()
    def decode(self, tokens, lengths, seeds, temps) -> np.ndarray:
        """One decode step for all slots: host arrays in, host token ids
        [S] out (the read fences the step)."""
        temps = np.asarray(temps, np.float32)
        nxt = self._decode_body(
            self._tensor(tokens), self._tensor(lengths), np.asarray(seeds),
            np.asarray(lengths), self._tensor(temps, torch.float32),
            bool(np.all(temps <= 0.0)),
        )
        return nxt.cpu().numpy()

    def kv_cache_bytes(self) -> int:
        """Device memory this rank's KV cache occupies (all layers)."""
        m = self.model
        return (2 * m.n_layers * self.max_slots * self._hkv
                * self.max_seq * self._hd * _itemsize(self._cdtype))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class PagedLlamaDecoder(LlamaDecoder):
    """Paged-KV-cache decoder (serving v2): block pools + per-slot block
    tables instead of a slot-contiguous cache.

    - Decode writes each slot's K/V through its table (inactive slots
      write to the trash block) and attends through ``paged_attend``.
    - Prefill runs in fixed-size chunks of ``prefill_chunk`` positions:
      ``prefill(table_row, ids, start, q_len, seed, temp)`` processes
      the prompt span ``[start, start + q_len)`` against the history
      already cached (adopted prefix blocks included); a row's compute
      depends only on its own token, position and cached prefix, so
      chunked equals monolithic and a prefix hit equals a cold prefill.

    Block bookkeeping (``self.manager``) and the radix prefix cache
    (``self.prefix_cache``) are host-side; the engine drives admission,
    copy-on-write, growth and eviction through them.
    """

    paged = True

    def __init__(self, model: Llama, *, max_slots: int = 8,
                 max_seq: int | None = None, block_size: int = 16,
                 n_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 prefix_cache: bool = True):
        self._init_common(model, max_slots, max_seq)
        #: the one row count of every decode and verify product: a
        #: verify window of up to ``PRODUCT_WINDOW`` tokens a slot runs
        #: in one call of it, a wider one in blocks of it
        self.product_rows = self.max_slots * PRODUCT_WINDOW
        self.block_size = int(block_size)
        self.manager = BlockManager(
            n_blocks=None if n_blocks is None else int(n_blocks),
            block_size=self.block_size,
            max_slots=self.max_slots, max_seq=self.max_seq,
        )
        self.max_blocks = self.manager.max_blocks
        self.trash_id = self.manager.trash_id
        self.prefix_cache = (
            PrefixCache(self.manager.allocator) if prefix_cache else None
        )
        self.prefill_chunk = int(
            prefill_chunk if prefill_chunk is not None
            else min(64, self.max_prefill)
        )
        if not 1 <= self.prefill_chunk <= self.max_prefill:
            raise ValueError(
                f"prefill_chunk {self.prefill_chunk} outside "
                f"[1, {self.max_prefill}]"
            )
        shape = (self.manager.allocator.n_blocks + 1, self._hkv,
                 self.block_size, self._hd)
        self.pools = self._zeros_cache(shape)

    # -- device bodies -----------------------------------------------------

    def _write_kv(self, pool, k, v, bids, offs):
        """Scatter per-row K/V [N, Hkv, hd] into the pools at (block id,
        offset).  Only rows routed to the trash block may collide, and
        its content is never read unmasked."""
        pool["k"][bids, :, offs] = k.to(self._cdtype)
        pool["v"][bids, :, offs] = v.to(self._cdtype)

    def _decode_body(self, tables, tokens, lengths, seeds, host_lengths,
                     temps, active, greedy: bool):
        """One token for all slots through the block tables.  tables
        [S, MB] int32, active [S] bool (False: writes go to the trash
        block and the engine ignores the output)."""
        m = self.model
        s, bs, hd, rep = self.max_slots, self.block_size, self._hd, self._rep
        x = tp_lib.embed_lookup(tokens, m.params["embed"], m.vocab,
                                self._group).to(
            self._cdtype)                                         # [S, D]
        pos = lengths                          # write position per slot
        rows = torch.arange(s, device=self.device)
        bidx = (pos // bs).clamp(0, self.max_blocks - 1)
        wbid = torch.where(active, tables[rows, bidx].long(), self.trash_id)
        woff = pos % bs
        pos_q = pos.to(torch.int32)[:, None].contiguous()        # [S, 1]
        mr = self.product_rows
        x = _pad_rows(x, mr)                              # [M, D]: padded
        for pool, p in zip(self.pools, m.params["layers"]):
            q, k, v = self._qkv(p, x, s, mr)
            q = rope_at(q, pos)
            k = rope_at(k, pos)
            self._write_kv(pool, k, v, wbid, woff)
            o = paged_attend(
                q.reshape(s, 1, self._hkv, rep, hd), pool["k"], pool["v"],
                tables, pos_q,
            ).reshape(s, self._h * hd)
            x = x + self._row(_pad_rows(o, mr), p["wo"], mr).to(self._cdtype)
            x = self._mlp(p, x, mr)
        return self._sample(self._logits(x, mr)[:s], seeds, host_lengths,
                            temps, greedy)

    def _verify_body(self, tables, tokens, lengths, n_valid, seeds,
                     host_pos, temps, greedy: bool):
        """Speculative verify step: K tokens for all slots in one pass
        (the multi-token sibling of ``_decode_body``).  ``tokens``
        [S, K]: column 0 is the slot's committed token, the rest the
        drafter's proposals; row (s, j) sits at position
        ``lengths[s] + j``, and columns at or past ``n_valid[s]`` write
        their K/V to the trash block (``n_valid`` 0: inactive slot).
        ``host_pos`` [S*K] are those positions on the host (the
        sampler's seed fold).  Returns out [S, K]: ``out[s, j]`` is the
        token the model emits after ``tokens[s, :j+1]`` — row j computes
        what ``decode`` computes at position ``lengths[s] + j`` (same
        per-row math, position mask and seed fold), which makes
        accept-by-equality reproduce sequential decode.

        Rejected drafts need no rollback: positions past the first
        rejection hold garbage K/V, but the engine commits its lengths
        below them, and the next window's writes cover every garbage
        position before any query row's mask reaches it (writes precede
        the attention within each layer)."""
        m = self.model
        s, kq = tokens.shape
        bs, hd, rep = self.block_size, self._hd, self._rep
        n = s * kq
        x = tp_lib.embed_lookup(tokens.reshape(n), m.params["embed"],
                                m.vocab, self._group).to(
            self._cdtype)                                      # [S*K, D]
        pos = lengths[:, None] + torch.arange(kq, device=self.device)
        in_range = (torch.arange(kq, device=self.device)[None, :]
                    < n_valid[:, None])
        bidx = (pos // bs).clamp(0, self.max_blocks - 1)
        wbid = torch.where(in_range, torch.gather(tables.long(), 1, bidx),
                           self.trash_id).reshape(n)
        woff = (pos % bs).reshape(n)
        pos_f = pos.reshape(n)
        pos_q = pos.to(torch.int32).contiguous()                 # [S, K]
        mr = self.product_rows
        rows = -(-n // mr) * mr
        x = _pad_rows(x, rows)                 # padded to blocks of M rows
        for pool, p in zip(self.pools, m.params["layers"]):
            q, k, v = self._qkv(p, x, n, mr)
            q = rope_at(q, pos_f)
            k = rope_at(k, pos_f)
            self._write_kv(pool, k, v, wbid, woff)
            o = paged_attend(
                q.reshape(s, kq, self._hkv, rep, hd), pool["k"], pool["v"],
                tables, pos_q,
            ).reshape(n, self._h * hd)
            x = x + self._row(_pad_rows(o, rows), p["wo"], mr).to(
                self._cdtype)
            x = self._mlp(p, x, mr)
        return self._sample(self._logits(x, mr)[:n], np.repeat(seeds, kq),
                            host_pos, temps.repeat_interleave(kq),
                            greedy).reshape(s, kq)

    def _prefill_body(self, table_row, ids, start: int, q_len: int,
                      seed: int, temp, greedy: bool):
        """One prefill chunk for one request: ids [C] (zero-padded past
        ``q_len``) at absolute positions ``[start, start + q_len)``; K/V
        rows scatter through ``table_row`` [MB]; attention reads the
        gathered history under an absolute-position causal mask.
        Samples the token that follows position ``start + q_len - 1``
        (meaningful only on the final chunk)."""
        m = self.model
        bs, hd, rep = self.block_size, self._hd, self._rep
        t_pad = self.max_blocks * bs
        c = ids.shape[0]
        x = tp_lib.embed_lookup(ids, m.params["embed"], m.vocab,
                                self._group).to(
            self._cdtype)                                         # [C, D]
        idx = torch.arange(c, device=self.device)
        pos = start + idx
        bidx = (pos // bs).clamp(0, self.max_blocks - 1)
        wbid = torch.where(idx < q_len, table_row[bidx].long(), self.trash_id)
        woff = pos % bs
        valid = (
            torch.arange(t_pad, device=self.device)[None, :] <= pos[:, None]
        ).reshape(c, 1, 1, t_pad)
        for pool, p in zip(self.pools, m.params["layers"]):
            q, k, v = self._qkv(p, x, c)
            q = rope_at(q, pos)
            k = rope_at(k, pos)
            self._write_kv(pool, k, v, wbid, woff)
            kg = gather_blocks(pool["k"], table_row)          # [Hkv, T, hd]
            vg = gather_blocks(pool["v"], table_row)
            qg = q.reshape(c, self._hkv, rep, hd)
            scores = torch.einsum("ckrd,ktd->ckrt", qg, kg).float()
            scores = torch.where(valid, scores * self._scale, NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            o = torch.einsum(
                "ckrt,ktd->ckrd", probs.to(vg.dtype), vg
            ).reshape(c, self._h * hd)
            x = x + tp_lib.row_parallel(o, p["wo"], self._group).to(
                self._cdtype)
            x = self._mlp(p, x)
        # only the chunk's last valid row matters for sampling
        logits = self._logits(x[q_len - 1: q_len])                # [1, V]
        return self._sample(logits, [seed], [start + q_len - 1], temp[None],
                            greedy)[0]

    # -- host API -----------------------------------------------------------

    def bucket_for(self, prompt_len: int) -> int:
        """Servability check (same refusal as v1); paged prefill has one
        chunk shape, so the 'bucket' is always ``prefill_chunk``."""
        if not 1 <= prompt_len <= self.max_prefill:
            raise ValueError(
                f"prompt length {prompt_len} outside servable range "
                f"[1, {self.max_prefill}] (max_seq {self.max_seq} "
                f"leaves one position for generation)"
            )
        return self.prefill_chunk

    @_collective
    @torch.no_grad()
    def copy_block(self, src: int, dst: int) -> None:
        """Device-side copy of one physical block (all layers, K and V)
        — the copy-on-write primitive ``BlockManager.ensure_writable``
        calls."""
        for pool in self.pools:
            pool["k"][dst] = pool["k"][src]
            pool["v"][dst] = pool["v"][src]

    @_collective
    @torch.no_grad()
    def prefill(self, table_row, chunk_ids, start: int, q_len: int,
                seed: int, temperature: float):
        """Run one prefill chunk; returns the sampled follow-on token as
        an unread 0-d device tensor (meaningful on the final chunk —
        the caller's ``int()`` is the TTFT fence, and skipping it on
        non-final chunks keeps a long prompt's chunks asynchronous)."""
        if not 1 <= q_len <= self.prefill_chunk:
            raise ValueError(
                f"q_len {q_len} outside [1, {self.prefill_chunk}]"
            )
        padded = np.zeros((self.prefill_chunk,), np.int64)
        padded[:q_len] = np.asarray(chunk_ids, np.int64)[:q_len]
        return self._prefill_body(
            self._tensor(table_row), self._tensor(padded), int(start),
            int(q_len), int(seed),
            self._tensor(temperature, torch.float32), temperature <= 0,
        )

    @_collective
    @torch.no_grad()
    def decode(self, tokens, lengths, seeds, temps, tables=None,
               active=None) -> np.ndarray:
        """One decode step for all slots through the block tables (host
        arrays in, host token ids [S] out)."""
        if tables is None or active is None:
            raise ValueError(
                "paged decode needs the block tables and the active mask"
            )
        temps = np.asarray(temps, np.float32)
        nxt = self._decode_body(
            self._tensor(tables, torch.int32), self._tensor(tokens),
            self._tensor(lengths), np.asarray(seeds), np.asarray(lengths),
            self._tensor(temps, torch.float32),
            self._tensor(active, torch.bool), bool(np.all(temps <= 0.0)),
        )
        return nxt.cpu().numpy()

    @_collective
    @torch.no_grad()
    def verify(self, tokens, lengths, seeds, temps, tables,
               n_valid) -> np.ndarray:
        """One speculative verify step for all slots: ``tokens`` [S, K]
        (column 0 committed, the rest drafts), ``n_valid`` [S] (0 =
        inactive slot).  Host arrays in, the host token matrix [S, K]
        out (the read fences the step).  The engine owns accept and
        reject; this is the device math."""
        tokens = np.asarray(tokens, np.int64)
        lengths = np.asarray(lengths, np.int64)
        temps = np.asarray(temps, np.float32)
        kq = tokens.shape[1]
        host_pos = (lengths[:, None] + np.arange(kq)[None, :]).reshape(-1)
        nxt = self._verify_body(
            self._tensor(tables, torch.int32), self._tensor(tokens),
            self._tensor(lengths), self._tensor(n_valid),
            np.asarray(seeds), host_pos, self._tensor(temps, torch.float32),
            bool(np.all(temps <= 0.0)),
        )
        return nxt.cpu().numpy()

    # -- KV handoff (serving/kv_transfer.py) ----------------------------------

    @_collective
    @torch.no_grad()
    def export_blocks(self, block_ids) -> list[dict] | None:
        """Read ``block_ids``' K/V out of the pools as host numpy arrays,
        one {k, v} dict per layer of ``[n, Hkv, bs, hd]`` with the GLOBAL
        kv-head dim: a gather of the pools at the ids, then one
        device-to-host copy a layer; at tp > 1 the followers' heads
        reach rank 0 over the CPU group (followers return None).  fp32
        pools give ``float32`` arrays; bf16 pools give the bits as
        ``uint16`` (numpy has no bfloat16)."""
        n = len(block_ids)
        if not 1 <= n <= self.max_blocks:
            raise ValueError(f"export of {n} blocks outside "
                             f"[1, {self.max_blocks}]")
        bids = self._tensor(block_ids)
        out = []
        for pool in self.pools:
            kv = torch.stack([pool["k"][bids], pool["v"][bids]]).cpu()
            if kv.dtype == torch.bfloat16:
                kv = kv.view(torch.int16).numpy().view(np.uint16)
            else:
                kv = kv.numpy()
            out.append(kv)
        g = self._group
        if g is not None:
            shards = [None] * g.size if g.rank == 0 else None
            dist.gather_object(out, shards, dst=0, group=g.cpu_group)
            if g.rank != 0:
                return None
            out = [np.concatenate(layer, axis=2) for layer in zip(*shards)]
        return [{"k": kv[0], "v": kv[1]} for kv in out]

    @_collective
    @torch.no_grad()
    def import_blocks(self, layers: list[dict], block_ids) -> None:
        """Write exported K/V rows (GLOBAL kv heads ``[n, Hkv, bs,
        hd]``) into this decoder's pools at ``block_ids`` (freshly
        allocated by the caller), each rank its own heads: one
        host-to-device copy a layer, then a scatter.  A bf16 pool takes
        2-byte elements as bfloat16 bits (the ``uint16`` views
        ``export_blocks`` gives)."""
        n = len(block_ids)
        shape = (n, self.model.n_kv_heads, self.block_size, self._hd)
        if len(layers) != self.model.n_layers:
            raise ValueError(f"{len(layers)} layers of K/V for a "
                             f"{self.model.n_layers}-layer decoder")
        heads = slice(self.model.tp_rank * self._hkv,
                      (self.model.tp_rank + 1) * self._hkv)
        bids = self._tensor(block_ids)
        for pool, lkv in zip(self.pools, layers):
            kv = np.stack([np.asarray(lkv["k"]), np.asarray(lkv["v"])])
            if kv.shape[1:] != shape:
                raise ValueError(f"K/V rows of shape {kv.shape[1:]}, "
                                 f"want {shape}")
            kv = np.ascontiguousarray(kv[:, :, heads])
            if self._cdtype == torch.bfloat16:
                if kv.dtype.itemsize != 2:
                    raise TypeError(f"a bfloat16 pool takes 2-byte bits, "
                                    f"got {kv.dtype}")
                host = torch.from_numpy(kv.view(np.int16)).view(
                    torch.bfloat16)
            else:
                host = torch.from_numpy(kv)
                if host.dtype != self._cdtype:
                    raise TypeError(f"a {self._cdtype} pool got {kv.dtype} "
                                    f"K/V")
            dev = host.to(self.device)
            pool["k"][bids] = dev[0]
            pool["v"][bids] = dev[1]

    # -- accounting -----------------------------------------------------------

    def kv_cache_bytes(self) -> int:
        """Device memory this rank's block pools occupy (trash block
        included)."""
        m = self.model
        return (2 * m.n_layers * (self.manager.allocator.n_blocks + 1)
                * self._hkv * self.block_size * self._hd
                * _itemsize(self._cdtype))


def decoder_from_checkpoint(config: dict, directory: str, *, device=None,
                            paged: bool = False, group=None,
                            **decoder_kw) -> LlamaDecoder:
    """The train → checkpoint → serve path: read the newest checkpoint
    under ``directory`` whose digests verify — an npz, or the ``.shards``
    directory a zero1 run of several ranks writes, of either package —
    build a ``Llama`` from its ``params`` group and wrap it in a decoder
    (``paged=True`` → :class:`PagedLlamaDecoder`).  Training's
    parameters are full, replicated leaves in either format, so any
    training layout serves at any tp: at ``config["tp"] > 1``,
    ``group`` is this rank's ``ModelGroup`` and each rank takes its
    shards of the checkpoint's leaves."""
    from theanompi_tpu_torch.utils.checkpoint import load_latest_params

    tree = load_latest_params(Path(directory))
    rank = group.rank if group is not None else 0
    params = params_from_jax(tree, config, device, rank=rank,
                             tp=int(config.get("tp", 1)))
    model = Llama(config, device, params=params, group=group)
    cls = PagedLlamaDecoder if paged else LlamaDecoder
    return cls(model, **decoder_kw)
