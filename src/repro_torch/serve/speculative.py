"""Self-speculation draft proposal for LM serving (no second model).

Speculative decoding splits token generation into a cheap *draft* and an
exact *verify*: a proposer guesses the next K tokens, the target model
scores all K+1 positions in ONE launch, and the longest prefix of the draft
that matches the model's own selections is accepted — plus the model's
corrected token at the first mismatch (so every verify launch emits between
1 and K+1 tokens). The output stream is bit-identical to plain decode by
construction: every emitted token is the model's own pick at its position;
the draft only decides how many positions one launch advances.

This module is the *draft* half. The verify half is the existing
`transformer.decode_chunk` ragged multi-token launch — the serving session
(`runners.lm._LMSession`) feeds a drafting row ``[pending, d1..dK]`` with
``take == K+1`` and reads K+1 next-token distributions back, alongside
slot-mates that are prefilling or plain-decoding in the same launch.

`NGramProposer` is self-speculation via prompt lookup (the draft-model-free
scheme): find the most recent earlier occurrence of the request's own
trailing n-gram and propose the tokens that followed it. Repetitive
structure — code, templated text, the token loops small models fall into —
yields high accept rates for free; on non-repetitive streams the proposer
returns no draft and the row decodes plainly (speculation never costs
correctness, only wasted verify columns).

Proposers are pluggable (`Proposer` protocol) so the test battery can drive
adversarial drafts (all-wrong / all-right / partially-right / empty) through
the same acceptance/rollback machinery, and a future small draft model can
slot in without touching the session.

Pure Python: a copy of the JAX package's serve/speculative.py, kept so the
port stands alone.
"""
from __future__ import annotations

from typing import List, Protocol, Sequence, runtime_checkable


@runtime_checkable
class Proposer(Protocol):
    """Draft source for self-speculative decode."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` draft tokens continuing ``history`` (the request's
        prompt + everything emitted so far). An empty list means "no
        guess" — the row falls back to plain one-token decode this step.
        Returned ids must be valid vocabulary tokens: they are fed through
        the embedding in the verify launch."""
        ...


class NGramProposer:
    """Prompt-lookup drafting: continue the most recent match of the
    trailing n-gram.

    For n from ``max_ngram`` down to ``min_ngram``: take the history's last
    n tokens, scan backwards for the most recent earlier occurrence of that
    n-gram, and propose the (up to k) tokens that followed it. Longer
    n-grams are preferred — a longer matched context predicts the
    continuation better; the most recent match is preferred over older ones
    for the same reason. No match at any n => no draft.
    """

    def __init__(self, *, max_ngram: int = 3, min_ngram: int = 1,
                 max_k: int = 8):
        assert 1 <= min_ngram <= max_ngram, (min_ngram, max_ngram)
        assert max_k >= 1, max_k
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_k = max_k

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        k = min(int(k), self.max_k)
        n_hist = len(history)
        if k <= 0 or n_hist < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_hist - 1), self.min_ngram - 1, -1):
            suffix = tuple(history[n_hist - n:])
            # most recent occurrence whose continuation lies inside history
            for start in range(n_hist - n - 1, -1, -1):
                if tuple(history[start:start + n]) == suffix:
                    cont = history[start + n:start + n + k]
                    return [int(t) for t in cont]
        return []
