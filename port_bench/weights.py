"""The weights a run makes from its seed, the same for the port and for
the reference.

Each kind of matrix is drawn for all the layers a chip holds in one
call (``[L, ...]``) on the device, from a generator seeded by the run's
seed and the kind, so a kind can be drawn again alone (the reference
and the training check do) and gives the same values.  Matrices are
normal with the configuration's ``initializer_range`` as their
standard deviation (the published initialiser); the norms' weights are
ones.  ``dtype`` is the type they are used in: the fp32 masters for
training, the serving type for serving.
"""

from __future__ import annotations

import torch

from port_bench.model import Dims

def random_kinds(d: Dims) -> list[tuple[str, tuple]]:
    """``(kind, shape)`` of every random leaf, stacked over the layers
    held; the embedding and the head unstacked."""
    L, D, F = d.n_layers, d.dim, d.ffn
    hd = d.head_dim
    out = [("embed", (d.vocab, D)),
           ("wq", (L, D, d.n_heads * hd)),
           ("wk", (L, D, d.n_kv_heads * hd)),
           ("wv", (L, D, d.n_kv_heads * hd)),
           ("wo", (L, d.n_heads * hd, D))]
    if d.n_experts:
        E = d.n_experts
        out += [("router", (L, D, E)), ("we_gate", (L, E, D, F)),
                ("we_up", (L, E, D, F)), ("we_down", (L, E, F, D))]
    else:
        out += [("w_gate", (L, D, F)), ("w_up", (L, D, F)),
                ("w_down", (L, F, D))]
    return out + [("lm_head", (D, d.vocab))]


def _seed(seed: int, j: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * j) % (2**63)


def draw(d: Dims, kind: str, seed: int, dtype, device) -> torch.Tensor:
    """One random kind, drawn on ``device`` in ``dtype``."""
    kinds = [k for k, _ in random_kinds(d)]
    j = kinds.index(kind)
    shape = dict(random_kinds(d))[kind]
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, j))
    t = torch.randn(shape, generator=g, dtype=dtype, device=device)
    return t.mul_(d.init_std)


def make(d: Dims, seed: int, dtype, device) -> dict:
    """Every leaf: the random kinds stacked as drawn, and the norms'
    ones (``attn_norm``/``mlp_norm`` ``[L, D]``, ``final_norm``
    ``[D]``)."""
    out = {k: draw(d, k, seed, dtype, device) for k, _ in random_kinds(d)}
    for k in ("attn_norm", "mlp_norm"):
        out[k] = torch.ones((d.n_layers, d.dim), dtype=dtype, device=device)
    out["final_norm"] = torch.ones((d.dim,), dtype=dtype, device=device)
    return out


def layer_keys(d: Dims) -> tuple:
    """The leaves of one layer, in the port's order."""
    ffn = (("router", "we_gate", "we_up", "we_down") if d.n_experts
           else ("w_gate", "w_up", "w_down"))
    return ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm") + ffn


def leaf_names(d: Dims) -> list[str]:
    """Every leaf by name: ``embed``, ``layers.<i>.<key>``,
    ``final_norm``, ``lm_head``."""
    return (["embed"] + [f"layers.{i}.{k}" for i in range(d.n_layers)
                         for k in layer_keys(d)]
            + ["final_norm", "lm_head"])


def leaf(stacked: dict, name: str) -> torch.Tensor:
    """The leaf ``name`` of :func:`leaf_names` in ``stacked``."""
    if name.startswith("layers."):
        _, i, k = name.split(".")
        return stacked[k][int(i)]
    return stacked[name]


def tree(d: Dims, stacked: dict) -> dict:
    """The reference's tree of separate leaves, taken out of
    ``stacked`` (emptied as it goes, so the peak is one kind more):
    ``{"embed", "layers": [{key: tensor}], "final_norm", "lm_head"}``
    with each expert matrix a list of one tensor an expert, so that
    each gets its gradient alone."""
    layers = [{} for _ in range(d.n_layers)]
    for k in layer_keys(d):
        t = stacked.pop(k)
        for i in range(d.n_layers):
            layers[i][k] = ([t[i, e].clone() for e in range(t.shape[1])]
                            if k.startswith("we_") else t[i].clone())
        del t
    return {"embed": stacked.pop("embed"), "layers": layers,
            "final_norm": stacked.pop("final_norm"),
            "lm_head": stacked.pop("lm_head")}


def tree_leaf(t: dict, name: str):
    """The leaf ``name`` of :func:`leaf_names` in a :func:`tree` (a list
    of tensors for an expert matrix)."""
    if name.startswith("layers."):
        _, i, k = name.split(".")
        return t["layers"][int(i)][k]
    return t[name]


def tree_tensors(t: dict) -> list:
    """Every tensor of a :func:`tree`."""
    out = [t["embed"]]
    for lp in t["layers"]:
        for v in lp.values():
            out += v if isinstance(v, list) else [v]
    return out + [t["final_norm"], t["lm_head"]]


def port_tree(d: Dims, stacked: dict) -> dict:
    """The port's parameter tree (``{"embed", "layers": [{...}],
    "final_norm", "lm_head"}``, weights ``[in, out]``) as views of
    ``stacked``."""
    return {"embed": stacked["embed"],
            "layers": [{k: stacked[k][i] for k in layer_keys(d)}
                       for i in range(d.n_layers)],
            "final_norm": stacked["final_norm"],
            "lm_head": stacked["lm_head"]}
