"""Self-drafting for speculative decoding (a copy of
``theanompi_tpu/serving/speculation.py``, stdlib only).

The decode cadence — one token per ``decode_step`` — is itself a
cost: every step pays the full weight-read at batch occupancy, so a
step that COMMITS more than one token divides the per-token weight
traffic.  Speculative decoding gets there without changing the
model: a cheap DRAFTER proposes the next few tokens, one fixed-shape
VERIFY step (``PagedLlamaDecoder.verify``) scores all of them, and
the engine commits the longest proposal prefix the model itself
would have emitted, plus the model's own next token (the "bonus").
Because this repo's samplers are deterministic given (seed,
position) — greedy argmax, or Gumbel-max under a position-folded
key — accept-by-equality reproduces the sequential decode chain
BITWISE at every temperature, not just greedy: the verify row at
position p computes exactly what ``decode`` would compute there.

Drafters are pluggable: anything with ``draft(history, k) ->
list[int]`` (``history`` = prompt + tokens generated so far,
including the committed current token; return UP TO ``k`` proposed
continuations).  The default is host-side self-drafting — no second
model, no device work:

- :class:`NGramDrafter` — prompt-lookahead (the "assisted
  generation" / LLMA trick): find the most recent earlier occurrence
  of the history's trailing n-gram and propose the tokens that
  followed it.  Free accuracy on repetitive continuations (code,
  templated text, shared system prompts, self-repeating greedy
  chains); harmless when wrong — a rejected draft costs only its
  share of the verify window.

A small draft MODEL can slot into the same interface later (wrap its
own decoder in a ``draft`` method); the engine and the verify step
never know the difference.
"""

from __future__ import annotations


class NGramDrafter:
    """Prompt-lookahead n-gram drafter.

    Scans the request's own token history for the most recent prior
    occurrence of the trailing ``n``-gram (longest ``n`` first, down
    to ``min_n``) and proposes the tokens that followed it.  Purely
    host-side and stateless across calls — the history IS the state.

    ``max_scan`` bounds the backward search so drafting stays O(1)
    per step for very long histories (the tail of the history is
    where repetition lives anyway).
    """

    def __init__(self, max_n: int = 3, min_n: int = 1,
                 max_scan: int = 512):
        if not 1 <= min_n <= max_n:
            raise ValueError(
                f"need 1 <= min_n <= max_n, got {min_n}/{max_n}"
            )
        self.max_n = int(max_n)
        self.min_n = int(min_n)
        self.max_scan = int(max_scan)

    def draft(self, history, k: int) -> list:
        """Up to ``k`` proposed continuations of ``history`` (may
        return fewer, or none — the engine degrades to a smaller
        verify window, floor one token/step)."""
        if k <= 0 or not history:
            return []
        h = list(history[-self.max_scan:])
        n_h = len(h)
        for n in range(min(self.max_n, n_h - 1), self.min_n - 1, -1):
            tail = h[n_h - n:]
            # most recent PRIOR occurrence of the trailing n-gram —
            # but a match near the end truncates its continuation at
            # the history boundary (periodic text always matches
            # late), so keep scanning back until a match offers the
            # FULL k-token window
            best: list = []
            for i in range(n_h - n - 1, -1, -1):
                if h[i:i + n] == tail:
                    cont = h[i + n: i + n + k]
                    if len(cont) > len(best):
                        best = cont
                        if len(best) == k:
                            break
            if best:
                return best
        return []
