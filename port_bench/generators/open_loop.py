"""An open loop of independent users: requests arrive on a schedule
whether or not earlier ones have finished.

``make(traffic, vocab, seed)`` is an endless iterator of ``(gap to the
previous arrival in seconds, prompt ids, max_tokens)``.  The mix gives
the rate, the prompt and output lengths (a lognormal each: ``median``,
``sigma``, ``min``, ``max``), ``block`` and ``strata``.  Every block of
``block`` requests holds the same set of gaps (the quantiles of the
exponential at the rate) and of lengths (the quantiles of each
lognormal), so every seed offers the same work; the seed draws their
order, the pairing of prompt, output and gap, and the tokens.  The
order is stratified: each run of ``strata`` requests holds one value of
each stratum of sizes, so no seed stacks the longest prompts or the
shortest gaps together.  Prompts are drawn independently, so no two
share a prefix.
"""

from __future__ import annotations

from port_bench.traffic import (TokenSampler, _rng, exp_gaps,
                                quantile_lengths, stratified_order)


def make(traffic: dict, vocab: int, seed: int):
    n, k = int(traffic["block"]), int(traffic["strata"])
    gaps = exp_gaps(float(traffic["rate_per_s"]), n)
    prompts = quantile_lengths(traffic["prompt"], n)
    outputs = quantile_lengths(traffic["output"], n)
    sampler = TokenSampler(vocab, float(traffic["zipf_exponent"]), seed)
    b = 0
    while True:
        order = _rng(seed, 3, b)
        gl = gaps[stratified_order(n, k, order)]
        pl = prompts[stratified_order(n, k, order)]
        ol = outputs[stratified_order(n, k, order)]
        rng = _rng(seed, 4, b)
        for j in range(n):
            yield (float(gl[j]), sampler.draw(rng, int(pl[j])).tolist(),
                   int(ol[j]))
        b += 1
