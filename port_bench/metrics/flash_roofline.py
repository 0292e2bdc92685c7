"""``flash_roofline``: the share of their bound that the traced K1, K2
and K3 launches reach, in percent: the sum of each launch's least time
(``flops.flash_bound_s`` at the cell's attention shape [batch, heads,
seq, head dim], causal) over the sum of their device times.  The
kernels are found by name."""

from port_bench.flops import flash_bound_s

KERNELS = (("flash_bwd_dkv", "dkv"), ("flash_bwd_dq", "dq"),
           ("flash_fwd", "fwd"))


def read(rec):
    work = rec.get("work")
    if work is None or "seq" not in rec:
        return None
    d = rec["dims"]
    shape = (rec["batch"], d.n_heads, rec["seq"], d.head_dim)
    bound = took = 0.0
    for name, s, e, _ in work.ops:
        kind = next((k for part, k in KERNELS if part in name), None)
        if kind is None:
            continue
        bound += flash_bound_s(kind, shape)
        took += (e - s) * 1e-9
    return 100.0 * bound / took if took else None
