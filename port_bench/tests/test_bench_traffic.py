"""The traffic generators: the same seed gives the same inputs, another
seed other inputs, and every seed the same work."""

import numpy as np
import pytest

from port_bench import spec
from port_bench.traffic import TrainBatches, quantile_lengths, \
    stratified_order

CHAT = spec.load_json(spec.HERE / "traffic" / "chat.json")
TRAIN = spec.load_json(spec.HERE / "traffic" / "train_b4_s4096.json")
chat_requests = spec.load_generator(CHAT["generator"])


def _take(it, n):
    return [next(it) for _ in range(n)]


def test_chat_same_seed_same_requests():
    a = _take(chat_requests(CHAT, 32000, 2**31 + 11), 70)
    b = _take(chat_requests(CHAT, 32000, 2**31 + 11), 70)
    assert a == b


def test_chat_other_seed_other_order_same_work():
    n = CHAT["block"]
    a = _take(chat_requests(CHAT, 32000, 5), 2 * n)
    b = _take(chat_requests(CHAT, 32000, 2**31 + 6), 2 * n)
    assert [p for _, p, _ in a] != [p for _, p, _ in b]
    parts = (lambda r: r[0], lambda r: len(r[1]), lambda r: r[2])
    for part in parts:
        # another order for another seed and block, the same set of
        # gaps and lengths in every block
        assert list(map(part, a[:n])) != list(map(part, b[:n]))
        assert list(map(part, a[:n])) != list(map(part, a[n:]))
        assert sorted(map(part, a[:n])) == sorted(map(part, b[:n])) \
            == sorted(map(part, a[n:]))
    # the arrivals' mean gap is the mix's rate
    assert np.mean([g for g, _, _ in a]) == pytest.approx(
        1 / CHAT["rate_per_s"], rel=0.05)


def test_chat_order_is_stratified():
    n, k = CHAT["block"], CHAT["strata"]
    prompts = np.sort(quantile_lengths(CHAT["prompt"], n))
    reqs = _take(chat_requests(CHAT, 32000, 2**31 + 99), n)
    for j in range(0, n, k):
        run = sorted(len(p) for _, p, _ in reqs[j:j + k])
        # one prompt of each stratum of sizes in every run of k
        for s, length in enumerate(run):
            stratum = prompts[s * (n // k):(s + 1) * (n // k)]
            assert stratum[0] <= length <= stratum[-1]


@pytest.mark.parametrize("n,k", [(64, 8), (8, 4), (6, 6)])
def test_stratified_order_is_a_permutation(n, k):
    rng = np.random.default_rng(3)
    order = stratified_order(n, k, rng)
    assert sorted(order) == list(range(n))
    for j in range(0, n, k):
        assert sorted(i // (n // k) for i in order[j:j + k]) == \
            list(range(k))
    with pytest.raises(ValueError):
        stratified_order(n + 1, k, rng)


def test_chat_lengths_follow_the_mix():
    prompts = quantile_lengths(CHAT["prompt"], CHAT["block"])
    outputs = quantile_lengths(CHAT["output"], CHAT["block"])
    assert prompts.min() >= CHAT["prompt"]["min"]
    assert prompts.max() == CHAT["prompt"]["max"]
    assert 0.9 <= np.median(prompts) / CHAT["prompt"]["median"] <= 1.1
    assert outputs.min() >= CHAT["output"]["min"]
    assert outputs.max() <= CHAT["output"]["max"]
    assert 0.9 <= np.median(outputs) / CHAT["output"]["median"] <= 1.1
    for _, p, n in _take(chat_requests(CHAT, 32000, 1), 64):
        assert all(0 <= t < 32000 for t in p[:50])


def test_train_batches_deterministic_and_distinct():
    make = spec.load_generator(TRAIN["generator"])
    a = make(TRAIN, 32000, 2**31 + 3)
    b = make(TRAIN, 32000, 2**31 + 3)
    c = TrainBatches(TRAIN, 32000, 2**31 + 4)
    x0, y0 = a.train_batch(0)
    assert x0.shape == (4, 4096) and y0.shape == (4, 4096)
    assert (x0[:, 1:] == y0[:, :-1]).all()
    assert (a.rows(0) == b.rows(0)).all()
    assert not (a.rows(0) == c.rows(0)).all()
    assert not (a.rows(0) == a.rows(1)).all()
    rows = np.concatenate([a.rows(i) for i in range(3)])
    assert len({r.tobytes() for r in rows}) == len(rows)
