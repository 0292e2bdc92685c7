"""A decoder of the Mistral family in plain PyTorch: RMSNorm, rotary
embedding on interleaved pairs (the published reference rotates
``(x[2i], x[2i+1])``), grouped-query attention with the key and value
heads repeated in place (query head h reads kv head ``h // rep``),
causal, SwiGLU, and, for Mixtral, a router whose top-k gates are
renormalised to sum to one (no token dropped), with the Switch load
balance ``E · Σ f·p`` (``f`` the share of the k picks an expert gets,
``p`` its mean router probability) as the auxiliary loss.

At sequences no longer than the sliding window (4096), windowed
attention is full causal attention, so there is no window here.

Training follows the port's recipe: the mean cross entropy plus
``aux_coef`` times the layers' mean load balance, and Adam in the
port's form (``step = lr·(m/(1-b1^t)) / (sqrt(v/(1-b2^t)) + eps)``).
A batch runs a row at a time, each layer checkpointed, so a batch of
4 × 4096 at Mistral widths fits beside its fp32 state.

``Precision(fp8=True)`` is the control: every product's operands
rounded to float8 e4m3 with a per-tensor scale (the gradients flowing
back to e5m2), the rest in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def no_tf32() -> None:
    """float32 products in float32: TF32 would round them to 10
    mantissa bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Q8(torch.autograd.Function):
    """Forward: rounded to e4m3; backward: the gradient rounded to
    e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Precision:
    """The reference's products: float32, or (the control) float32 on
    float8-rounded operands."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Q8.apply(x) if self.fp8 else x

    def mm(self, a, b):
        return self.q(a) @ self.q(b)


F32 = Precision()


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x [H, T, hd] rotated on its interleaved pairs at positions
    ``pos`` [T]."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def attention(q, k, v, pr: Precision):
    """Causal attention of one sequence: q [H, T, hd], k/v [Hkv, T,
    hd]."""
    rep = q.shape[0] // k.shape[0]
    k = k.repeat_interleave(rep, dim=0)
    v = v.repeat_interleave(rep, dim=0)
    t = k.shape[1]
    s = pr.mm(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    mask = (torch.arange(t, device=q.device)[None, :]
            > torch.arange(t, device=q.device)[:, None])
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    return pr.mm(p, v)


def route(x, w_router, top_k: int):
    """fp32 router: (gates [N, k] renormalised, expert ids [N, k],
    probabilities [N, E])."""
    probs = torch.softmax(x @ w_router, dim=-1)
    eidx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][
        :, :top_k]
    gates = torch.gather(probs, 1, eidx)
    return gates / gates.sum(dim=-1, keepdim=True), eidx, probs


def ffn(lp, x, d, pr: Precision, f=None, n_tokens=None):
    """The FFN of one layer (its leaves ``lp``) on ``x`` [T, D]; with
    experts also the row's share of the load balance given the batch's
    pick shares ``f`` [E] (None: no aux) over ``n_tokens`` tokens, and
    the row's pick counts [E]."""
    if not d.n_experts:
        g = pr.mm(x, lp["w_gate"])
        return pr.mm(F.silu(g) * pr.mm(x, lp["w_up"]), lp["w_down"]), \
            None, None
    gates, eidx, probs = route(x, lp["router"], d.top_k)
    y = torch.zeros_like(x)
    for e in range(d.n_experts):
        tok, slot = torch.nonzero(eidx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(pr.mm(xe, lp["we_gate"][e])) * pr.mm(xe, lp["we_up"][e])
        y = y.index_add(0, tok, pr.mm(h, lp["we_down"][e])
                        * gates[tok, slot][:, None])
    counts = torch.bincount(eidx.reshape(-1), minlength=d.n_experts)
    lb = None
    if f is not None:
        lb = d.n_experts * (f * probs.sum(dim=0)).sum() / n_tokens
    return y, lb, counts


def layer(lp, x, pos, d, pr: Precision, f=None, n_tokens=None):
    """One decoder block (its leaves ``lp``) on one sequence ``x`` [T, D]
    fp32 at positions ``pos`` [T]."""
    hd = d.head_dim
    xn = rms(x, lp["attn_norm"], d.eps)
    q = pr.mm(xn, lp["wq"]).reshape(-1, d.n_heads, hd).transpose(0, 1)
    k = pr.mm(xn, lp["wk"]).reshape(-1, d.n_kv_heads, hd).transpose(0, 1)
    v = pr.mm(xn, lp["wv"]).reshape(-1, d.n_kv_heads, hd).transpose(0, 1)
    q, k = rope(q, pos, d.theta), rope(k, pos, d.theta)
    o = attention(q, k, v, pr).transpose(0, 1).reshape(x.shape[0], -1)
    x = x + pr.mm(o, lp["wo"])
    y, lb, counts = ffn(lp, rms(x, lp["mlp_norm"], d.eps), d, pr, f,
                        n_tokens)
    return x + y, lb, counts


# -- training -----------------------------------------------------------------

def _row(p, ids, tgt, d, pr, f, n_tokens):
    """(sum of the row's cross entropy, its aux share) with each layer
    checkpointed; ``p`` is a tree of separate leaves
    (``weights.tree``)."""
    x = p["embed"][ids]
    pos = torch.arange(ids.shape[0], device=ids.device)
    aux = x.new_zeros(())
    for i, lp in enumerate(p["layers"]):
        fi = f[i] if f is not None else None
        x, lb, _ = checkpoint(layer, lp, x, pos, d, pr, fi, n_tokens,
                              use_reentrant=False)
        if lb is not None:
            aux = aux + lb
    h = rms(x, p["final_norm"], d.eps)
    xent = F.cross_entropy(pr.mm(h, p["lm_head"]), tgt, reduction="sum")
    return xent, aux


@torch.no_grad()
def pick_shares(p, rows, d, pr) -> list:
    """Each expert layer's share of the batch's k picks, ``[E]`` a
    layer, from a forward pass over every row."""
    counts = [torch.zeros(d.n_experts, device=rows[0][0].device)
              for _ in range(d.n_layers)]
    n = 0
    for ids, _ in rows:
        x = p["embed"][ids]
        pos = torch.arange(ids.shape[0], device=ids.device)
        for i, lp in enumerate(p["layers"]):
            x, _, c = layer(lp, x, pos, d, pr)
            counts[i] += c
        n += ids.shape[0]
    return [c / (n * d.top_k) for c in counts]


def loss_and_grads(p, rows, d, pr: Precision = F32):
    """The batch's loss (mean cross entropy plus ``aux_coef`` times the
    layers' mean load balance) and its gradients in each leaf's
    ``.grad``; ``rows`` is a list of (ids [T], targets [T])."""
    n_tokens = sum(int(ids.shape[0]) for ids, _ in rows)
    f = pick_shares(p, rows, d, pr) if d.n_experts else None
    total = 0.0
    for ids, tgt in rows:
        xent, aux = _row(p, ids, tgt, d, pr, f, n_tokens)
        loss = xent / n_tokens
        if f is not None:
            loss = loss + d.aux_coef * aux / d.n_layers
        loss.backward()
        total += float(loss.detach())
    return total


@torch.no_grad()
def adam_update(params: list, state: dict, lr, b1=0.9, b2=0.999,
                eps=1e-8):
    """The port's Adam form on every tensor of ``params``; ``state``
    starts as ``{"t": 0}``.  A leaf with no gradient (an expert no token
    picked) has a zero one, as the port's capacity buffer gives it."""
    state["t"] += 1
    tf = torch.tensor(float(state["t"]), dtype=torch.float32)
    bias1 = float(1 - torch.pow(torch.tensor(b1, dtype=torch.float32), tf))
    bias2 = float(1 - torch.pow(torch.tensor(b2, dtype=torch.float32), tf))
    ms = state.setdefault("m", [torch.zeros_like(w) for w in params])
    vs = state.setdefault("v", [torch.zeros_like(w) for w in params])
    for w, m, v in zip(params, ms, vs):
        g = w.grad if w.grad is not None else torch.zeros_like(w)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        w.sub_(lr * (m / bias1) / (torch.sqrt(v / bias2) + eps))
        w.grad = None


def norm(x) -> float:
    """The norm of a tensor, or of a list of tensors taken as one."""
    parts = x if isinstance(x, list) else [x]
    sq = [t.double().square().sum() for t in parts if t is not None]
    return float(torch.stack(sq).sum().sqrt()) if sq else 0.0


# -- serving ------------------------------------------------------------------

@torch.no_grad()
def served_logits(p, seqs, d, pr: Precision = F32, layer_dtype=None):
    """Logits ``[n_served, V]`` of each sequence at the positions that
    predict its served tokens: ``seqs`` holds (ids [T], n_served), the
    last ``n_served`` ids the served tokens.  Layer by layer over all
    the sequences, each layer's weights taken to float32 once
    (``p`` may hold them in the serving type)."""
    def f32(t):
        return t.float() if layer_dtype is None else t.to(layer_dtype)

    xs = [f32(p["embed"][ids]) for ids, _ in seqs]
    for i in range(d.n_layers):
        lp = {k: f32(p[k][i]) for k in p
              if k not in ("embed", "final_norm", "lm_head")}
        for j, (ids, _) in enumerate(seqs):
            pos = torch.arange(ids.shape[0], device=ids.device)
            xs[j] = layer(lp, xs[j], pos, d, pr)[0]
        del lp
    w = f32(p["lm_head"])
    fn = f32(p["final_norm"])
    out = []
    for x, (_, n) in zip(xs, seqs):
        h = rms(x[-n - 1:-1], fn, d.eps)
        out.append(pr.mm(h, w))
    return out
