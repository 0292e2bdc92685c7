"""The numbers that decide ``correct``, each held to its limit from
``limits/<cell>.json``.

Training: each checked step's loss; each leaf's first gradient as the
optimizer got it; each leaf's change over the checked steps.  A leaf's
number is the gap between the port's norm and the reference's,
measured against the reference's norm of that leaf or of the median
leaf, whichever is larger.  Leaves whose reference gradient is under a
thousandth of the median leaf's move by rounding alone and are left out
of the change.  Serving: the widest gap by which a served token's
reference logit lies below the reference's best at its position.
"""

from __future__ import annotations

import math
from statistics import median


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Each leaf's gap of norms, against the larger of its reference
    norm and the median leaf's."""
    floor = median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], floor) for n in names}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``{"losses": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}``.  The worst leaf's gap of each, and the
    median leaf's (steady from seed to seed where the worst leaf is not:
    an expert's gradient moves with the routing picks that flip between
    bf16 and fp32)."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    names = sorted(ref["grad"])
    g_med = median(ref["grad"][n] for n in names)
    moved = [n for n in names if ref["grad"][n] >= 1e-3 * g_med]
    grad = leaf_gaps(prog["grad"], ref["grad"], names)
    change = leaf_gaps(prog["change"], ref["change"], moved)
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
            "grad_gap_median": median(grad.values()),
            "change_gap_median": median(change.values())}


def served_gap(ref_logits: list, served: list) -> float:
    """Widest ``max(ref) - ref[served token]`` over every served token;
    ``ref_logits`` [n, V] a sequence, ``served`` its n token ids."""
    import torch

    worst = 0.0
    for lg, toks in zip(ref_logits, served):
        t = torch.as_tensor(toks, device=lg.device, dtype=torch.long)
        gap = lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def control_gap(ref_logits: list, ctrl_logits: list) -> float:
    """The same gap for the tokens the control puts first."""
    return served_gap(ref_logits, [c.argmax(dim=-1).tolist()
                                   for c in ctrl_logits])


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and at most its limit, ``{name: {"value",
    "limit"}}`` in the limits' order)."""
    checks = {}
    ok = True
    for name, lim in limits["numbers"].items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim["limit"]
        ok = ok and good
        finite = v is not None and math.isfinite(v)
        checks[name] = {"value": v if finite else None,
                        "limit": lim["limit"]}
    return ok, checks
