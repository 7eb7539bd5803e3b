"""LM runner: masked prefill + greedy decode behind the `ModelRunner` protocol.

The JAX package's serve/runners/lm.py in PyTorch; see its docstring for the
design. In short:

* ``run`` (batch admission) pads prompts to `prompt_bucket` multiples,
  prefills them with a masked loop of `decode_step` (a row's cache advances
  only inside its own prompt, and its first token is read at its own last
  prompt position) and decodes with a per-request position vector.
* ``open_session`` (continuous admission) holds one KV cache of width
  ``slots``; each engine step is one `decode_step` (every row takes one
  token) or one `decode_chunk` (prefilling rows take up to the budget's
  chunk, decode rows one, speculating rows one plus their draft), with the
  width bucketed to a power of two as in JAX. Free slots ride along with
  ``active=False``. A finished slot's rows (KV entries and recurrent
  state) are reset from a separate fresh cache before its next occupant,
  and rejected draft positions are zeroed
  (`transformer.rollback_cache_rows`), so a request sees the numerics of a
  solo run whatever joins it, and speculation never changes a stream.

The model writes its KV cache in place (`models.attention.attention_decode`),
so the session's fresh cache is a tensor of its own, never the live one.
Device-to-host reads are lazy, as in JAX: prefill-only steps read nothing,
greedy steps read the picks, and logits cross (``.cpu().numpy()``) only
when a row samples or tracks logprobs. Sampling is the numpy
`serve.sampling`, seeded per (request seed, generation index), so sampled
streams match the JAX package's.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from ...configs.base import ArchConfig
from ...core.quant import fake_quant
from ...core.tiling import round_up
from ...device import resolve_device
from ...models import transformer as tf
from .. import sampling as sampling_mod
from ..api import (PAD_REQUEST_ID, Request, Result, SlotProgress, StepBudget,
                   StepReport)
from ..sampling import SamplingParams
from ..speculative import NGramProposer, Proposer

#: block kinds whose decode cache is a position-indexed KV cache, the only
#: ones speculative rollback can restore exactly
_SPEC_SAFE_KINDS = ("attn_mlp", "attn_moe")


def _keystr(path) -> str:
    """A tree path as `jax.tree_util.keystr` prints it: ``['a'][0]['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def quantized_lm_params(params, bits: int):
    """Fake-quant view of the LM weights, leaf for leaf as the JAX package's.

    JAX selects leaves whose `keystr` path holds ".w" or "w_" and no
    "norm", with two or more dims, and gives each one scale over the whole
    (period-stacked) leaf. Its paths read ``['periods']['slot0']['mlp']
    ['w_in']`` (``['tail'][0][...]`` in the tail), so the selection is
    ``embed.w_tok`` / ``w_front`` and every ``w_*`` matrix (MLP, MoE router
    and experts, RG-LRU, mLSTM ``w_up`` / ``w_gate`` / ``w_if`` / ``w_down``,
    sLSTM ``w_in`` / ``w_out``); the attention and mLSTM ``wq`` / ``wk`` /
    ``wv`` / ``wo`` projections, ``lam``, ``r``, the biases and the LM head
    stay fp32. This is matched here on purpose (the reference's behaviour,
    not its docstring's)."""
    def walk(path, x):
        if isinstance(x, dict):
            return {k: walk(path + (k,), v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(walk(path + (i,), v) for i, v in enumerate(x))
        key = _keystr(path)
        if x.ndim >= 2 and (".w" in key or "w_" in key) and "norm" not in key:
            return fake_quant(x, bits, None)
        return x
    return walk((), params)


class LMRunner:
    """Greedy (or sampled) batched generation over the LM (`ModelRunner`).

    ``params`` live on ``device`` (the card unless ``device="cpu"``).
    """

    def __init__(self, cfg: ArchConfig, params, *, max_seq: int = 512,
                 quant_bits: int = 0, prompt_bucket: int = 8,
                 speculate_k: int = 0, proposer: Optional[Proposer] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_seq = max_seq
        self.prompt_bucket = prompt_bucket
        self.quant_bits = quant_bits
        self.speculate_k = int(speculate_k)
        if self.speculate_k:
            unsupported = (set(cfg.pattern) | set(cfg.tail)) - set(_SPEC_SAFE_KINDS)
            assert not unsupported, (
                f"speculate_k={speculate_k} needs position-indexed KV "
                f"rollback; block kinds {sorted(unsupported)} hold "
                f"recurrent or ring-buffer state that cannot roll back")
        self.proposer: Proposer = proposer if proposer is not None \
            else NGramProposer()
        # quantized once at construction: serving never re-quantizes
        self.params = quantized_lm_params(params, quant_bits) if quant_bits else params

    @property
    def precision(self) -> str:
        """Active weight numerics, as recorded on every `Result.stats`."""
        return f"int{self.quant_bits}" if self.quant_bits else "fp32"

    @property
    def wbytes_per(self) -> float:
        """Bytes per weight at the active precision (4.0 fp32, 0.5 int4)."""
        return self.quant_bits / 8.0 if self.quant_bits else 4.0

    def _tensor(self, values, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype).to(self.device)

    def _prefill(self, cache, toks, lens):
        """Masked teacher-forced prefill over the prompt block: rows past
        their own prompt freeze their caches, and each row's first decode
        token is read at its own last prompt position."""
        first = torch.zeros(toks.shape[0], dtype=torch.long, device=self.device)
        for p in range(toks.shape[1]):
            logits, cache = tf.decode_step(self.params, cache, {"tokens": toks[:, p:p + 1]},
                                           p, self.cfg, active=p < lens)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            first = torch.where(lens - 1 == p, nxt, first)
        return first[:, None], cache                     # [B, 1]: first decode input

    # -- ModelRunner protocol ------------------------------------------------

    def _padded_len(self, prompt: Sequence[int]) -> int:
        return round_up(max(len(prompt), 1), self.prompt_bucket)

    def bucket_key(self, request: Request) -> Hashable:
        return (self._padded_len(request.payload),
                int(request.options.get("max_new_tokens", 0)))

    def filler(self, request: Request) -> Request:
        # zero-length prompt: never active in the prefill mask, decode output
        # discarded by the engine
        return Request(PAD_REQUEST_ID, [], dict(request.options))

    def run(self, batch: Sequence[Request]) -> List[Result]:
        for r in batch:
            bad = sorted(set(r.options) & set(SamplingParams.KEYS))
            if not r.is_pad and bad:
                raise ValueError(
                    f"request {r.request_id} carries sampling options {bad}; "
                    "the run-to-completion batch path is greedy-only — use "
                    "EngineConfig.admission='continuous'")
        prompts = [list(r.payload) for r in batch]
        num_tokens = int(batch[0].options.get("max_new_tokens", 0))
        plen = self._padded_len(max(prompts, key=len) if prompts else [0])
        assert plen + num_tokens <= self.max_seq, (
            f"prompt bucket {plen} + {num_tokens} new tokens exceeds "
            f"max_seq {self.max_seq}")

        b = len(batch)
        toks = np.zeros((b, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        lens = self._tensor([len(p) for p in prompts])

        cache = tf.init_cache(self.cfg, b, self.max_seq, self.device)
        cur, cache = self._prefill(cache, self._tensor(toks), lens)
        out = [list(p) for p in prompts]
        for k in range(num_tokens):
            host = cur[:, 0].cpu().numpy()
            for i in range(b):
                out[i].append(int(host[i]))
            logits, cache = tf.decode_step(self.params, cache, {"tokens": cur}, lens + k,
                                           self.cfg)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]

        return [
            Result(r.request_id, out[i], stats={
                "prompt_len": len(prompts[i]),
                "padded_len": plen,
                "new_tokens": num_tokens,
                "precision": self.precision,
                "wbytes_per": self.wbytes_per,
            })
            for i, r in enumerate(batch)
        ]

    # -- continuous admission ------------------------------------------------

    def session_key(self, request: Request) -> Hashable:
        # any prompt/budget that fits max_seq can join a live LM session
        return ("lm", self.max_seq)

    def open_session(self, slots: int) -> "_LMSession":
        return _LMSession(self, slots)


class _LMSession:
    """A live width-``slots`` decode batch requests join between tokens.

    Per-slot Python state (prompt, emitted tokens, position, budget) steers
    one shared launch per engine step; the device state is the session-wide
    KV cache. See the module docstring for the equivalence argument.
    """

    def __init__(self, runner: LMRunner, slots: int):
        self.runner = runner
        self.slots = slots
        # two trees: the live cache is written in place, the fresh one never
        self._fresh = tf.init_cache(runner.cfg, slots, runner.max_seq, runner.device)
        self.cache = tf.init_cache(runner.cfg, slots, runner.max_seq, runner.device)
        self.req: List[Optional[Request]] = [None] * slots
        self.prompt: List[List[int]] = [[] for _ in range(slots)]
        self.out: List[List[int]] = [[] for _ in range(slots)]
        self.pos = [0] * slots        # next position this slot consumes
        self.budget = [0] * slots
        self.next_tok = [0] * slots   # token the slot feeds next step
        self.prefill_chunks = [0] * slots  # steps that consumed prompt tokens
        self.steps_in = [0] * slots   # steps since admission
        self.ttft = [0] * slots       # steps through the first emitted token
        self.sampling: List[Optional[SamplingParams]] = [None] * slots
        self.logprobs: List[List[float]] = [[] for _ in range(slots)]
        # speculative accounting: accepted + rejected == drafted, per slot
        self.drafted = [0] * slots
        self.accepted = [0] * slots
        self.rejected = [0] * slots
        self._stale: set = set()      # slots whose past occupant touched state

    def _result(self, i: int, status: str = "ok") -> Result:
        req = self.req[i]
        plen = len(self.prompt[i])
        # the outputs open with the prompt exactly as submitted
        assert self.out[i][:plen] == self.prompt[i], (self.out[i], self.prompt[i])
        stats = {
            "prompt_len": plen,
            "padded_len": plen,
            "new_tokens": self.budget[i],
            "prefill_chunks": self.prefill_chunks[i],
            "ttft_steps": self.ttft[i],
            "precision": self.runner.precision,
            "wbytes_per": self.runner.wbytes_per,
            "drafted_tokens": self.drafted[i],
            "accepted_tokens": self.accepted[i],
            "rejected_tokens": self.rejected[i],
        }
        sp = self.sampling[i]
        if sp is not None and sp.track_logprobs:
            stats["logprobs"] = list(self.logprobs[i])
        return Result(req.request_id, self.out[i], stats=stats, status=status)

    def admit(self, slot: int, request: Request) -> Optional[Result]:
        assert self.req[slot] is None, f"slot {slot} busy"
        prompt = [int(t) for t in request.payload]
        budget = int(request.options.get("max_new_tokens", 0))
        assert len(prompt) + budget <= self.runner.max_seq, (
            f"prompt {len(prompt)} + {budget} new tokens exceeds "
            f"max_seq {self.runner.max_seq}")
        self.req[slot] = request
        self.prompt[slot] = prompt
        self.out[slot] = list(prompt)
        self.pos[slot] = 0
        self.budget[slot] = budget
        self.prefill_chunks[slot] = 0
        self.steps_in[slot] = 0
        self.ttft[slot] = 0
        self.sampling[slot] = SamplingParams.from_options(request.options)
        self.logprobs[slot] = []
        self.drafted[slot] = 0
        self.accepted[slot] = 0
        self.rejected[slot] = 0
        if budget == 0:               # nothing to generate: done on arrival
            res = self._result(slot)
            self.req[slot] = None
            return res
        if prompt:
            self.next_tok[slot] = prompt[0]
        else:
            # batch-path parity: an empty prompt's first "generated" token is
            # the argmax placeholder 0 the batch prefill leaves behind; decode
            # continues from it at position 0, logprob 0.0 (it is forced)
            self.out[slot].append(0)
            self.next_tok[slot] = 0
            sp = self.sampling[slot]
            if sp is not None and sp.track_logprobs:
                self.logprobs[slot].append(0.0)
            if budget <= 1:
                res = self._result(slot)
                self.req[slot] = None
                return res
        return None

    def cancel(self, slot: int) -> Result:
        """Reclaim ``slot`` mid-flight; its rows are reset before the slot's
        next occupant, as after a normal completion."""
        assert self.req[slot] is not None, f"slot {slot} empty"
        res = self._result(slot, status="cancelled")
        self.req[slot] = None
        self._stale.add(slot)
        return res

    def _draft_k(self, i: int) -> int:
        """Draft allowance for slot ``i``: 0 unless it is a pure-decode row
        with at least two budgeted tokens left, clamped to ``remaining - 1``
        so a verify launch stays inside the budget and ``max_seq``."""
        if self.runner.speculate_k <= 0 or self.pos[i] < len(self.prompt[i]):
            return 0
        remaining = self.budget[i] - (len(self.out[i]) - len(self.prompt[i]))
        return max(0, min(self.runner.speculate_k, remaining - 1))

    def _plan(self, occupied: List[int], budget: StepBudget
              ) -> "tuple[Dict[int, int], Dict[int, List[int]]]":
        """Tokens each occupied slot consumes this step, plus draft
        proposals; a total-units cap trims the extras in slot order, never
        below one token per slot."""
        takes: Dict[int, int] = {}
        drafts: Dict[int, List[int]] = {}
        for i in occupied:
            remaining = len(self.prompt[i]) - self.pos[i]
            if remaining > 1:
                takes[i] = min(budget.for_slot(i), remaining)
                continue
            takes[i] = 1
            k = self._draft_k(i)
            if k > 0:
                draft = [int(t) for t in
                         self.runner.proposer.propose(self.out[i], k)][:k]
                assert all(0 <= t < self.runner.cfg.vocab for t in draft), draft
                if draft:
                    drafts[i] = draft
                    takes[i] = 1 + len(draft)
        if budget.units is not None:
            total = sum(takes.values())
            cap = max(int(budget.units), len(occupied))
            for i in occupied:
                if total <= cap:
                    break
                cut = min(takes[i] - 1, total - cap)
                takes[i] -= cut
                total -= cut
                if i in drafts:
                    drafts[i] = drafts[i][:takes[i] - 1]
                    if not drafts[i]:
                        del drafts[i]
        return takes, drafts

    def step(self, budget: StepBudget = StepBudget()) -> StepReport:
        occupied = [i for i in range(self.slots) if self.req[i] is not None]
        if not occupied:
            return StepReport()
        runner = self.runner
        stale = [i for i in occupied if i in self._stale]
        if stale:
            keep = np.ones(self.slots, bool)
            keep[stale] = False
            tf.reset_cache_rows(self.cache, self._fresh, torch.from_numpy(keep))
            self._stale.difference_update(stale)

        takes, drafts = self._plan(occupied, budget)
        width = max(takes.values())
        if width > 1:
            # pow2-bucketed launch width, as in JAX (extra columns ride along
            # fully masked, so numerics are unchanged)
            width = 1 << (width - 1).bit_length()
        pos_vec = runner._tensor(self.pos)
        active = runner._tensor([self.req[i] is not None for i in range(self.slots)],
                                torch.bool)
        chunked = width > 1
        if not chunked:
            # every row takes one token: one decode step
            tokens = runner._tensor([[self.next_tok[i]] for i in range(self.slots)])
            logits, self.cache = tf.decode_step(runner.params, self.cache, {"tokens": tokens},
                                                pos_vec, runner.cfg, active=active)
            logits_dev = logits[:, -1]
            picks_dev = torch.argmax(logits_dev, dim=-1)
        else:
            # row i consumes buf[i, :take[i]]: its prompt slice while
            # prefilling, its pending token (plus its draft) while decoding
            buf = np.zeros((self.slots, width), np.int64)
            take_vec = np.zeros(self.slots, np.int64)
            for i in occupied:
                t = takes[i]
                take_vec[i] = t
                p, prompt = self.pos[i], self.prompt[i]
                d = drafts.get(i)
                for j in range(t):
                    if p + j < len(prompt):
                        buf[i, j] = prompt[p + j]
                    elif d is not None and j > 0:
                        buf[i, j] = d[j - 1]
                    else:
                        buf[i, j] = self.next_tok[i]
            picks_dev, logits_dev, self.cache = tf.decode_chunk(
                runner.params, self.cache, runner._tensor(buf), pos_vec,
                runner._tensor(take_vec), runner.cfg, active=active)

        # device->host reads are lazy: prefill-only steps read nothing,
        # greedy steps the picks, logits only when a row samples or tracks
        # logprobs
        fetched: Dict[str, Optional[np.ndarray]] = {"picks": None, "logits": None}

        def pick_at(row: int, col: int) -> int:
            if fetched["picks"] is None:
                fetched["picks"] = picks_dev.cpu().numpy()
            arr = fetched["picks"]
            return int(arr[row, col] if chunked else arr[row])

        def logits_at(row: int, col: int) -> np.ndarray:
            if fetched["logits"] is None:
                fetched["logits"] = logits_dev.cpu().numpy()
            arr = fetched["logits"]
            return arr[row, col] if chunked else arr[row]

        def select(row: int, col: int, index: int):
            """(token, logprob|None) selected at launch column ``col`` for
            generation index ``index`` of slot ``row``: the device's greedy
            pick, or the seed-deterministic sampling layer."""
            sp = self.sampling[row]
            if sp is None or not sp.track_logprobs:
                return pick_at(row, col), None
            if sp.greedy:            # logprobs requested on the greedy path
                tok = pick_at(row, col)
                return tok, float(
                    sampling_mod.log_softmax(logits_at(row, col))[tok])
            return sampling_mod.sample(logits_at(row, col), sp, index)

        finished: Dict[int, Result] = {}
        progress: Dict[int, SlotProgress] = {}
        prompt_toks = decode_toks = 0
        drafted_toks = accepted_toks = 0
        rollback_rows: List[int] = []
        for i in occupied:
            t = takes[i]
            p = self.pos[i]
            plen = len(self.prompt[i])
            self.steps_in[i] += 1
            if p < plen:
                self.prefill_chunks[i] += 1
                prompt_toks += min(t, plen - p)
            emitted = ()
            if p + t < plen:          # still prefilling: picks discarded
                self.pos[i] = p + t
                self.next_tok[i] = self.prompt[i][self.pos[i]]
            else:
                sp = self.sampling[i]
                gen0 = len(self.out[i]) - plen   # generation index base
                d = drafts.get(i)
                toks: List[int] = []
                lps: List[Optional[float]] = []
                if d is None:
                    # plain decode, or a prefill chunk crossing the prompt
                    # end: the last column's selection is the generated token
                    tok, lp = select(i, t - 1, gen0)
                    toks.append(tok)
                    lps.append(lp)
                    self.pos[i] = p + t
                else:
                    # verify: the longest draft prefix matching the model's
                    # own selections, then the corrected (or bonus) token
                    for j in range(t):
                        tok, lp = select(i, j, gen0 + j)
                        toks.append(tok)
                        lps.append(lp)
                        if not (j < len(d) and tok == d[j]):
                            break
                    acc = len(toks) - 1
                    self.drafted[i] += len(d)
                    self.accepted[i] += acc
                    self.rejected[i] += len(d) - acc
                    drafted_toks += len(d)
                    accepted_toks += acc
                    if acc < len(d):
                        rollback_rows.append(i)   # KV written at dead columns
                    self.pos[i] = p + len(toks)
                self.out[i].extend(toks)
                self.next_tok[i] = toks[-1]
                if sp is not None and sp.track_logprobs:
                    self.logprobs[i].extend(lps)
                emitted = tuple(toks)
                decode_toks += len(toks)
                if self.ttft[i] == 0:
                    self.ttft[i] = self.steps_in[i]
            done = len(self.out[i]) - plen >= self.budget[i]
            progress[i] = SlotProgress(
                request_id=self.req[i].request_id,
                phase="decode" if self.pos[i] >= plen else "prefill",
                units_done=min(self.pos[i], plen) + max(0, len(self.out[i]) - plen),
                units_total=plen + self.budget[i],
                emitted=emitted)
            if done:
                finished[i] = self._result(i)
                self.req[i] = None
                self._stale.add(i)
        if rollback_rows:
            # zero the KV entries at rejected positions (one pass for all
            # rolled-back rows; other rows untouched)
            keep_len = np.zeros(self.slots, np.int64)
            mask = np.zeros(self.slots, bool)
            for i in rollback_rows:
                mask[i] = True
                keep_len[i] = self.pos[i]
            tf.rollback_cache_rows(self.cache, runner._tensor(keep_len),
                                   runner._tensor(mask, torch.bool))
        cost = {"units": sum(takes.values()), "prompt_tokens": prompt_toks,
                "decode_tokens": decode_toks, "drafted_tokens": drafted_toks,
                "accepted_tokens": accepted_toks}
        return StepReport(finished=finished, progress=progress, cost=cost)
