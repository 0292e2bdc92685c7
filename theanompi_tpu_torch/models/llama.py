"""Llama-family decoder transformer, serving subset (one card, tp=1).

Port of ``theanompi_tpu/models/llama.py`` for the serving path: the
model math (RMSNorm, interleaved-pair RoPE with theta 10000, GQA,
SwiGLU, untied LM head), the parameter layout and init, and the bridge
that carries a JAX parameter tree across.

Parameters are a plain dict of tensors in the JAX layout —
``{"embed" [V, D], "layers": [{attn_norm, wq [D, H*hd], wk, wv, wo,
mlp_norm, w_gate, w_up, w_down}], "final_norm", "lm_head" [D, V]}``,
weights ``[in, out]`` so every product is ``x @ w`` — held in the
compute dtype.  That is exactly equivalent to the JAX path, which keeps
fp32 master weights but casts them to ``x.dtype`` before every use
(``tp.col_parallel``/``row_parallel`` and ``rms_norm``): the port casts
once, at load or init, instead of at every use.

Training, tp/sp/pp > 1 and MoE are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from theanompi_tpu_torch.parallel.mesh import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
              "w_gate", "w_up", "w_down")


# -- model math ---------------------------------------------------------------

def rms_norm(x, w, eps=1e-5):
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w.to(x.dtype)


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

class Llama:
    """Serving-only Llama: config, parameters and device.

    Config knobs read: ``dim, n_layers, n_heads, n_kv_heads, ffn_dim,
    vocab, seq_len, compute_dtype, seed``.  Parameters are drawn from
    ``self.generator`` (seeded with ``seed``) unless ``params`` is
    given (e.g. from :func:`params_from_jax` or a checkpoint).
    ``device`` defaults to the card; ``device="cpu"`` runs on the CPU.
    """

    def __init__(self, config: dict | None = None, device=None, *,
                 params: dict | None = None):
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
        dtype = str(c.get("compute_dtype", "bfloat16"))
        if dtype not in DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {sorted(DTYPES)}, got "
                f"{dtype!r}"
            )
        self.compute_dtype = DTYPES[dtype]
        if self.dim % self.n_heads:
            raise ValueError(
                f"dim {self.dim} must divide by n_heads {self.n_heads}"
            )
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                "n_heads must be a multiple of n_kv_heads (GQA groups)"
            )
        unported = {k: c[k] for k in ("tp", "sp", "pp", "n_experts", "ep")
                    if int(c.get(k, 0 if k == "n_experts" else 1))
                    != (0 if k == "n_experts" else 1)}
        if unported:
            raise NotImplementedError(
                f"the port serves at one card, tp=1, no MoE; {unported} "
                f"is not ported yet (ROADMAP.md A11-A12: tp>1 serving, MoE)"
            )
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.params = params if params is not None else self.init_params()

    def init_params(self) -> dict:
        """Random parameters with the shapes and scales of the JAX
        ``_init_full_params``: each tensor drawn in fp32 from the
        model's generator and cast to the compute dtype before the
        next is drawn, so the fp32 peak is one tensor."""
        d, f, v = self.dim, self.ffn_dim, self.vocab
        hd = self.head_dim
        dev, cd = self.device, self.compute_dtype

        def normal(shape, scale):
            x = torch.randn(shape, generator=self.generator, device=dev,
                            dtype=torch.float32)
            return x.mul_(scale).to(cd)

        def dense(shape):
            return normal(shape, (2.0 / (shape[0] + shape[-1])) ** 0.5)

        def ones():
            return torch.ones((d,), dtype=cd, device=dev)

        layers = []
        for _ in range(self.n_layers):
            layers.append({
                "attn_norm": ones(),
                "wq": dense((d, self.n_heads * hd)),
                "wk": dense((d, self.n_kv_heads * hd)),
                "wv": dense((d, self.n_kv_heads * hd)),
                "wo": dense((self.n_heads * hd, d)),
                "mlp_norm": ones(),
                "w_gate": dense((d, f)),
                "w_up": dense((d, f)),
                "w_down": dense((f, d)),
            })
        return {
            "embed": normal((v, d), 0.02),
            "layers": layers,
            "final_norm": ones(),
            "lm_head": dense((d, v)),
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


def _leaves(params: dict):
    yield params["embed"]
    for lp in params["layers"]:
        for k in LAYER_KEYS:
            yield lp[k]
    yield params["final_norm"]
    yield params["lm_head"]


# -- the JAX parameter bridge -------------------------------------------------

def params_from_jax(tree: dict, config: dict, device=None) -> dict:
    """The port's parameters from a JAX Llama parameter tree given as
    numpy arrays (``jax.device_get(model.params)`` or a checkpoint's
    ``params`` group).  Both packages keep weights ``[in, out]``, so
    this is a copy plus the cast to the compute dtype; shapes are
    checked against ``config``."""
    dev = resolve_device(device)
    cd = DTYPES[str(config.get("compute_dtype", "bfloat16"))]
    expect = _shapes_of(config)

    def conv(a, shape, name):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(
                f"param {name}: shape {a.shape}, expected {shape}"
            )
        return torch.tensor(a).to(device=dev, dtype=cd)

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
