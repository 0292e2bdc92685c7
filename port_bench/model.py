"""A configuration file read as the sizes the harness needs.

The configuration keeps the published keys of its source
(``hidden_size``, ``num_attention_heads`` ...); ``deployment`` says how
many layers one chip holds in each mode, and ``train`` / ``serve`` the
settings a user of the port would give it.  ``port_config`` turns them
into the port's ``Llama`` config knobs.
"""

from __future__ import annotations

from dataclasses import dataclass

#: what the port's Llama computes with no knob to change it; a
#: configuration that states another value cannot run through it
PORT_FIXED = {"rms_norm_eps": 1e-5, "rope_theta": 10000.0,
              "hidden_act": "silu", "tie_word_embeddings": False}


@dataclass(frozen=True)
class Dims:
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn: int
    vocab: int
    n_experts: int
    top_k: int
    eps: float
    theta: float
    init_std: float
    aux_coef: float

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def dims(config: dict, mode: str) -> Dims:
    """The sizes of ``config`` as run in ``mode`` (``"train"`` or
    ``"serve"``): the layers held come from its ``deployment``."""
    for key, want in PORT_FIXED.items():
        got = config.get(key, want)
        if got != want:
            raise ValueError(f"{key} = {got!r}: the port computes with "
                             f"{want!r} and has no knob for it")
    layers = int(config["deployment"][mode]["layers_held"])
    return Dims(
        dim=int(config["hidden_size"]),
        n_layers=layers,
        n_heads=int(config["num_attention_heads"]),
        n_kv_heads=int(config["num_key_value_heads"]),
        ffn=int(config["intermediate_size"]),
        vocab=int(config["vocab_size"]),
        n_experts=int(config.get("num_local_experts", 0)),
        top_k=int(config.get("num_experts_per_tok", 0)),
        eps=float(config["rms_norm_eps"]),
        theta=float(config.get("rope_theta", PORT_FIXED["rope_theta"])),
        init_std=float(config["initializer_range"]),
        aux_coef=float(config.get("router_aux_loss_coef", 0.0)),
    )


def port_config(config: dict, mode: str, seq_len: int,
                batch: int = 1) -> dict:
    """The port's ``Llama`` config for ``config`` in ``mode``."""
    d = dims(config, mode)
    sec = config[mode]
    out = dict(dim=d.dim, n_layers=d.n_layers, n_heads=d.n_heads,
               n_kv_heads=d.n_kv_heads, ffn_dim=d.ffn, vocab=d.vocab,
               seq_len=seq_len, compute_dtype=config["precision"]["compute"])
    if d.n_experts:
        out.update(n_experts=d.n_experts, moe_top_k=d.top_k,
                   capacity_factor=float(sec["capacity_factor"]),
                   moe_aux_coef=d.aux_coef, moe_z_coef=0.0)
    if mode == "train":
        out.update(batch_size=batch, optimizer=sec["optimizer"],
                   lr=float(sec["lr"]), remat=bool(sec["remat"]),
                   exch_strategy=sec["exch_strategy"], n_train=batch,
                   n_val=0, n_epochs=1)
    return out
