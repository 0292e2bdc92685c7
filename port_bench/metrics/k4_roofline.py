"""``k4_roofline``: the share of its bound that kernel K4 (the paged
attention's split and combine launches, found by name) reaches over the
traced decode steps, in percent: the sum of each launch's least time
(``flops.paged_bound_s`` from the positions the launch was given) over
the kernels' device time."""

from port_bench.flops import paged_bound_s


def read(rec):
    work = rec.get("work")
    calls = rec.get("k4")
    if work is None or not calls:
        return None
    ops = work.select("paged_split") + work.select("paged_combine")
    took = sum(e - s for _, s, e, _ in ops) * 1e-9
    bound = sum(paged_bound_s(shape, bs, pos, n_table)
                for shape, bs, pos, n_table in calls)
    return 100.0 * bound / took if took else None
