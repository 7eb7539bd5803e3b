"""Sampling layer for LM serving: temperature / top-k / top-p + logprobs.

Replaces greedy-only decode with the batched sampling contract production
engines expose (cf. the lmdeploy `sampling_utils` surface the ROADMAP names):
per-request ``temperature`` / ``top_k`` / ``top_p`` knobs, a per-request
PRNG ``seed``, and the sampled token's logprob surfaced on `api.Result`.

Determinism is the design center, not an afterthought. Serving correctness
elsewhere in this stack leans on *replay*: the router re-routes in-flight
requests off faulted replicas by resubmitting the frozen `Request` and
asserting bit-identical outputs (`serve.router`), and the speculative
decoder (`serve.speculative`) must sample the same token whether a position
is reached one-token-at-a-time or inside a K-token verify launch. Both
demand that the sampled token at generation index ``i`` be a pure function
of ``(request seed, i, logits)`` — never of engine state, step grouping, or
how many times the request has been partially executed. `token_rng`
therefore derives an independent generator per (seed, index) pair from a
`numpy.random.SeedSequence`; no RNG state is carried between tokens.

All math here is float64 numpy on host — this is the *selection* layer over
device logits, sized [vocab] per emitted token, and doubles as the reference
the differential tests (`tests/test_sampling.py`) check against.

Filter semantics (applied in this order, standard contract):

1. temperature — logits / T. ``T == 0`` is exact greedy argmax (no RNG).
2. top_k       — keep the k highest logits (ties broken toward lower token
                 ids, stable); 0 disables.
3. top_p       — keep the smallest prefix of the sorted distribution whose
                 cumulative probability reaches p (the crossing token is
                 kept; the top token always survives); 1.0 disables.

The surfaced logprob is ``log_softmax(raw logits)[token]`` — the model's
own distribution, *before* temperature/filtering, so downstream consumers
(rescoring, accept-rate analysis) see calibrated values regardless of the
sampling knobs.

Numpy only: a copy of the JAX package's serve/sampling.py, kept so the
port stands alone.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Mapping, Optional, Tuple

import numpy as np

#: request-option keys this layer owns; presence of any of them on a
#: `Request.options` opts the request into the sampling path
OPTION_KEYS = ("temperature", "top_k", "top_p", "seed", "logprobs")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration, parsed from `Request.options`.

    temperature: 0.0 (default) is exact greedy argmax — bit-identical to a
                 request that never opted into sampling. > 0 samples.
    top_k:       keep only the k highest logits before sampling; 0 = all.
    top_p:       nucleus filtering — keep the smallest probability mass
                 >= top_p; 1.0 = all.
    seed:        per-request PRNG seed. The token sampled at generation
                 index i depends only on (seed, i, logits), so replays and
                 speculative verification reproduce the stream exactly.
    logprobs:    surface per-token logprobs on `Result.stats` even for
                 greedy requests (sampled requests always surface them;
                 greedy ones only on request, because it forces a logits
                 transfer the argmax path otherwise skips).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    logprobs: bool = False

    KEYS: ClassVar[Tuple[str, ...]] = OPTION_KEYS

    def __post_init__(self):
        assert self.temperature >= 0.0, f"temperature {self.temperature} < 0"
        assert self.top_k >= 0, f"top_k {self.top_k} < 0"
        assert 0.0 < self.top_p <= 1.0, f"top_p {self.top_p} not in (0, 1]"

    @property
    def greedy(self) -> bool:
        """True when selection is argmax (temperature 0): no RNG involved."""
        return self.temperature == 0.0

    @property
    def track_logprobs(self) -> bool:
        """Whether the session must fetch logits for this request every
        step: sampled requests always (selection needs the distribution),
        greedy ones only when logprobs were explicitly requested."""
        return (not self.greedy) or self.logprobs

    @classmethod
    def from_options(cls, options: Mapping) -> Optional["SamplingParams"]:
        """Parse request options; None when the request never opted in
        (pure greedy decode, no logprob tracking — the zero-cost default).

        Ported onto the validated `api.RequestOptions` surface: parsing
        happens at the submit boundary's rules (unknown sampling values
        raise there, not here), and this is now just the opt-in view.
        """
        if not any(k in options for k in cls.KEYS):
            return None
        from .api import RequestOptions
        parsed = RequestOptions.parse(
            {k: v for k, v in options.items() if k in cls.KEYS})
        return parsed.sampling


def _check_option_key_registry():
    # the submit-boundary validator (api.OPTION_SPECS) must know every key
    # this layer reads, or a valid sampling request would be rejected at
    # submit; checked at import so the two registries cannot drift.
    from .api import SAMPLING_OPTION_KEYS
    assert SAMPLING_OPTION_KEYS == OPTION_KEYS, (
        SAMPLING_OPTION_KEYS, OPTION_KEYS)


_check_option_key_registry()


def log_softmax(logits: np.ndarray) -> np.ndarray:
    """Numerically stable log-softmax over the last axis, in float64."""
    x = np.asarray(logits, np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def apply_top_k(logits: np.ndarray, k: int) -> np.ndarray:
    """Mask all but the k highest logits to -inf. Ties at the boundary
    break toward lower token ids (stable sort), so the kept set is a pure
    function of the logits — required for cross-run determinism."""
    x = np.asarray(logits, np.float64)
    if k <= 0 or k >= x.size:
        return x
    order = np.argsort(-x, kind="stable")
    out = np.full_like(x, -np.inf)
    out[order[:k]] = x[order[:k]]
    return out


def apply_top_p(logits: np.ndarray, p: float) -> np.ndarray:
    """Nucleus filter: keep the smallest prefix of the probability-sorted
    distribution whose cumulative mass reaches ``p`` (the crossing token is
    kept, so the top token always survives). -inf entries (e.g. from a
    prior top-k pass) stay masked."""
    x = np.asarray(logits, np.float64)
    if p >= 1.0:
        return x
    order = np.argsort(-x, kind="stable")
    finite = np.isfinite(x[order])
    shifted = np.where(finite, x[order] - x[order[0]], -np.inf)
    probs = np.exp(shifted)
    probs = np.where(finite, probs, 0.0)
    probs = probs / probs.sum()
    cum = np.cumsum(probs)
    cutoff = int(np.searchsorted(cum, p, side="left")) + 1
    out = np.full_like(x, -np.inf)
    keep = order[:cutoff]
    out[keep] = x[keep]
    return out


def token_rng(seed: int, index: int) -> np.random.Generator:
    """Independent generator for one (request seed, generation index) pair.

    No state flows between tokens: the stream is a pure function of the
    pair, so replays, engine restarts, and speculative verify launches all
    reproduce the same draw for the same position.
    """
    entropy = (int(seed) & 0xFFFFFFFFFFFFFFFF, int(index))
    return np.random.default_rng(np.random.SeedSequence(entropy))


def sample(logits: np.ndarray, params: SamplingParams,
           index: int) -> Tuple[int, float]:
    """Select one token from ``logits`` [vocab] at generation ``index``.

    Returns (token, logprob) where logprob is taken from the *raw*
    distribution (see module docstring). temperature == 0 is exact argmax —
    the same tie-break (first maximum) as the device greedy path.
    """
    lsm = log_softmax(logits)
    if params.greedy:
        tok = int(np.argmax(np.asarray(logits)))
        return tok, float(lsm[tok])
    x = np.asarray(logits, np.float64) / params.temperature
    x = apply_top_k(x, params.top_k)
    x = apply_top_p(x, params.top_p)
    finite = np.isfinite(x)
    shifted = np.where(finite, x - x[finite].max(), -np.inf)
    probs = np.where(finite, np.exp(shifted), 0.0)
    probs = probs / probs.sum()
    tok = int(token_rng(params.seed, index).choice(probs.size, p=probs))
    return tok, float(lsm[tok])
