"""What the traffic generators share.  A mix is a data file of
parameters (``traffic/<mix>.json``) that names its generator,
``generators/<name>.py``; a generator reads the mix and the run's seed,
and nothing else, with the pieces here: token ids with Zipf
frequencies, lengths at the quantiles of a lognormal, the token batches
of training.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2**63), *salt])


def _zipf_cdf(vocab: int, exponent: float) -> np.ndarray:
    w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** exponent
    c = np.cumsum(w)
    return c / c[-1]


class TokenSampler:
    """Token ids with Zipf frequencies over the vocabulary: rank r has
    weight ``r**-exponent``, the ranks mapped to ids by a permutation
    drawn from the seed."""

    def __init__(self, vocab: int, exponent: float, seed: int):
        self.cdf = _zipf_cdf(vocab, exponent)
        self.ids = _rng(seed, 1).permutation(vocab)

    def draw(self, rng: np.random.Generator, shape) -> np.ndarray:
        ranks = np.searchsorted(self.cdf, rng.random(shape), side="right")
        return self.ids[np.minimum(ranks, len(self.cdf) - 1)]


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles ``(i + 0.5) / n`` of a lognormal
    with the spec's ``median`` and ``sigma``, clipped to ``[min,
    max]``."""
    nd = NormalDist()
    out = [spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf((i + 0.5)
                                                               / n))
           for i in range(n)]
    return np.clip(np.rint(out), spec["min"], spec["max"]).astype(np.int64)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """``n`` gaps between arrivals at the quantiles ``(i + 0.5) / n`` of
    the exponential of mean ``1 / rate`` (a Poisson process's)."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def stratified_order(n: int, strata: int,
                     rng: np.random.Generator) -> np.ndarray:
    """A permutation of ``range(n)`` drawn from ``rng`` in which each
    run of ``strata`` places (0 to strata - 1, strata to 2 strata - 1,
    ...) holds one index of each stratum, the stratum ``j`` being the
    indices ``j * n / strata`` to ``(j + 1) * n / strata - 1``.  Applied
    to values sorted by size, no order stacks the largest together."""
    if n % strata:
        raise ValueError(f"{n} values do not split into {strata} strata")
    m = n // strata
    # column g of ``groups`` is run g: one index of each stratum
    groups = np.stack([j * m + rng.permutation(m) for j in range(strata)])
    for g in range(m):
        groups[:, g] = rng.permutation(groups[:, g])
    return groups.T.reshape(-1)


# -- training -----------------------------------------------------------------

class TrainBatches:
    """Token batches for training: step ``i`` is ``(inputs, targets)``
    of ``[batch, seq_len]`` int64, the rows ``batch`` draws of
    ``seq_len + 1`` tokens from ``(seed, i)``.  It is also the data
    object the port's ``Llama`` reads (``global_batch``,
    ``n_batch_train``, ``train_batch``)."""

    def __init__(self, traffic: dict, vocab: int, seed: int,
                 n_steps: int = 1 << 30):
        self.batch = int(traffic["batch"])
        self.seq_len = int(traffic["seq_len"])
        self.global_batch = self.batch
        self.n_batch_train = n_steps
        self.n_batch_val = 0
        self.seed = int(seed)
        self.sampler = TokenSampler(vocab, float(traffic["zipf_exponent"]),
                                    seed)

    def rows(self, i: int) -> np.ndarray:
        """``[batch, seq_len + 1]`` tokens of step ``i``."""
        return self.sampler.draw(_rng(self.seed, 2, i),
                                 (self.batch, self.seq_len + 1))

    def train_batch(self, i: int):
        r = self.rows(i)
        return r[:, :-1], r[:, 1:]

    def shuffle(self, epoch: int) -> None:
        """Steps are drawn by index; there is nothing to permute."""
