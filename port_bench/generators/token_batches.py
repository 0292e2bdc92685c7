"""Pretraining batches: ``make(traffic, vocab, seed)`` is the
:class:`port_bench.traffic.TrainBatches` of the mix's ``batch`` rows of
``seq_len`` tokens a step, each row a fresh draw from the seed with
Zipf token frequencies."""

from __future__ import annotations

from port_bench.traffic import TrainBatches


def make(traffic: dict, vocab: int, seed: int) -> TrainBatches:
    return TrainBatches(traffic, vocab, seed)
