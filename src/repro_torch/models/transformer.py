"""Decoder LM: the JAX package's models/transformer.py in PyTorch.

The network is a sequence of *periods*: a fixed pattern of block kinds with
per-period parameters stacked along a leading ``[n_periods, ...]`` axis, as
in JAX (where `lax.scan` walks them); here a Python loop indexes the
stack, which is a view, not a copy. Pattern remainders live in the
unscanned ``tail``. Parameter trees use the JAX package's keys, so
`params_from_numpy` carries a JAX parameter tree across unchanged.

Block kinds:
    attn_mlp   — GQA attention + MLP (dense transformers, musicgen, phi-3)
    attn_moe   — GQA attention + mixture-of-experts (+ optional shared MLP)
    local_attn — sliding-window GQA attention + MLP (recurrentgemma)
    rglru      — RG-LRU recurrent block + MLP (recurrentgemma)
    mlstm      — xLSTM matrix-memory block (no MLP)
    slstm      — xLSTM scalar-memory block (no MLP)

The vision/audio frontends are stubs: ``batch["frontend_embeds"]`` is
projected by ``embed.w_front`` and prepended to the token embeddings
(`models.frontends`).

Tensor parallelism: under a ``(data, model)`` process-group mesh with more
than one model rank (`launch.mesh.make_process_mesh` under
``compute_mesh``), `forward` and `train_loss` take the placed tree
(DTensor leaves, `dist.sharding.place`) and run each block on this rank's
shards (`dist.tensor_parallel`), at the reference's sharding hooks:
``_embed`` looks tokens up in the vocab shard of ``w_tok`` (rows outside
it give zeros; the ranks' rows are summed, exactly), under
`shard_cotangents`; ``_unembed`` keeps the logits sharded over the vocab
(``_vocab_shard``) and `train_loss` reduces the log-softmax's max, sum of
exponentials and gold logit over the ranks, so no rank holds a whole
``[B, S, V]`` float32 tensor; ``_seq_shard`` keeps the residual stream
split along the sequence at period boundaries and after each
``attn_mlp`` / ``attn_moe`` block (``cfg.sp_blocks``), gathered where a
block needs all of it, so each period's checkpointed input is 1/tp the
size. Data parallelism needs none of them: the MoE routes each data
shard's rows on its own under an in-process data mesh (`models.moe`), and
the train step reduces over a process group (`train.train_step`).

Training: `train_loss` (next-token CE + the MoE aux loss), through
`forward`, which checkpoints each period when ``cfg.remat == "full"``.
Serving entry points: `prefill_step`, `init_cache`, `reset_cache_rows`,
`decode_step`, `decode_chunk` and `rollback_cache_rows`. Caches are
``{"periods": {"slot<i>": {...}}, "tail": (...)}`` with period leaves
``[n_periods, B, ...]``: a KV cache ``{"k", "v"}`` per attention block,
the recurrent state of an rglru / mlstm / slstm block. `decode_step`
writes the new KV entries and recurrent state into the cache it is given,
in place, and returns it; `reset_cache_rows` and `rollback_cache_rows`
update in place too. `decode_chunk` is a Python loop of `decode_step`
calls, so it equals sequential steps bit for bit by construction.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..dist.sharding import shard_cotangents
from ..dist.tensor_parallel import TPAxis, TPLeaf, tp_axis, unwrap
from .attention import (attention_block, attention_block_tp, attention_decode, attn_init,
                        init_kv_cache)
from .layers import (dense_init, embed_init, mlp_apply, mlp_apply_tp, mlp_init, rmsnorm,
                     rmsnorm_init)
from .moe import moe_apply, moe_init
from .rglru import (rglru_block, rglru_block_decode, rglru_block_tp, rglru_init,
                    rglru_init_state)
from .xlstm import (mlstm_block, mlstm_block_decode, mlstm_block_tp, mlstm_init,
                    mlstm_init_state, slstm_block, slstm_block_decode, slstm_block_tp,
                    slstm_init, slstm_init_state)

ATTN_KINDS = ("attn_mlp", "attn_moe", "local_attn")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ===========================================================================
# Parameter init
# ===========================================================================

def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str, device="cuda",
               lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    """One block's parameters, or ``lead`` stacked blocks drawn at once."""
    device = resolve_device(device)
    dt, d = _dtype(cfg), cfg.d_model
    p: Dict[str, Any] = {"norm1": rmsnorm_init(d, dt, device, lead)}
    if kind in ATTN_KINDS:
        p["attn"] = attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.qkv_bias, dt,
                              device, lead)
        p["norm2"] = rmsnorm_init(d, dt, device, lead)
        if kind == "attn_moe":
            p["moe"] = moe_init(gen, d, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff, cfg.mlp_act,
                                dt, cfg.shared_expert, cfg.d_ff,
                                n_experts_padded=cfg.n_experts_padded, device=device,
                                lead=lead)
        else:
            p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dt, device, lead)
    elif kind == "rglru":
        p["rglru"] = rglru_init(gen, d, cfg.d_rnn or d, cfg.conv_width, dt, device, lead)
        p["norm2"] = rmsnorm_init(d, dt, device, lead)
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dt, device, lead)
    elif kind == "mlstm":
        p["mlstm"] = mlstm_init(gen, d, cfg.n_heads, dt, device, lead)
    elif kind == "slstm":
        p["slstm"] = slstm_init(gen, d, cfg.n_heads, dt, device, lead)
    else:
        raise ValueError(kind)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, device="cuda") -> Dict[str, Any]:
    """Random parameters from ``gen`` (a generator on ``device``): the
    JAX package's tree and shapes, other numbers (torch's generator)."""
    device = resolve_device(device)
    dt = _dtype(cfg)
    params: Dict[str, Any] = {
        "embed": {"w_tok": embed_init(gen, cfg.vocab, cfg.d_model, dt, device)},
        "final_norm": rmsnorm_init(cfg.d_model, dt, device),
    }
    if cfg.frontend:
        params["embed"]["w_front"] = dense_init(gen, cfg.d_frontend, cfg.d_model, dt, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(gen, cfg.d_model, cfg.vocab, dt, device)}
    params["periods"] = {f"slot{si}": init_block(gen, cfg, kind, device, (cfg.n_periods,))
                         for si, kind in enumerate(cfg.pattern)}
    params["tail"] = tuple(init_block(gen, cfg, kind, device) for kind in cfg.tail)
    return params


def _bf16_like(arr: np.ndarray) -> bool:
    """An ``ml_dtypes.bfloat16`` array (what ``np.asarray`` of a JAX bf16
    array gives) or its 2-byte void records (what ``np.load`` gives back)."""
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def params_from_numpy(tree, device="cuda"):
    """A JAX parameter (or cache) tree, as numpy arrays, to torch tensors on
    ``device`` under the same keys (tuples stay tuples). bfloat16 arrays
    cross as their 16-bit patterns, exactly."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(params_from_numpy(v, device) for v in tree)
    arr = np.array(tree)
    if _bf16_like(arr):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _period(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Period ``i`` of a stacked tree: views into each leaf."""
    return {k: _period(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ===========================================================================
# Forward blocks
# ===========================================================================

def _apply_block(kind: str, p: Dict, x: torch.Tensor, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual block application. Returns (x, aux_loss)."""
    aux = torch.zeros((), device=x.device)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        x = x + attention_block(
            p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, rope_theta=cfg.rope_theta,
            window=cfg.window if kind == "local_attn" else 0,
            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, f32_streams=cfg.attn_f32_streams)
        h2 = rmsnorm(x, p["norm2"], cfg.norm_eps)
        if kind == "attn_moe":
            y, aux = _moe(p["moe"], h2, cfg)
            return x + y, aux
        return x + mlp_apply(p["mlp"], h2, cfg.mlp_act), aux
    if kind == "rglru":
        x = x + rglru_block(p["rglru"], h)
        return x + mlp_apply(p["mlp"], rmsnorm(x, p["norm2"], cfg.norm_eps), cfg.mlp_act), aux
    if kind == "mlstm":
        return x + mlstm_block(p["mlstm"], h, cfg.n_heads, cfg.mlstm_chunk), aux
    if kind == "slstm":
        return x + slstm_block(p["slstm"], h, cfg.n_heads), aux
    raise ValueError(kind)


def _moe(p: Dict, x: torch.Tensor, cfg: ArchConfig, tp: Optional[TPAxis] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    return moe_apply(p, x, top_k=cfg.top_k, act=cfg.mlp_act, n_experts=cfg.n_experts,
                     capacity_factor=cfg.capacity_factor,
                     n_experts_padded=cfg.n_experts_padded, fsdp_experts=cfg.fsdp_experts,
                     tp=tp)


def _embed(params: Dict, batch: Dict, cfg: ArchConfig) -> torch.Tensor:
    x = params["embed"]["w_tok"][batch["tokens"]]
    if cfg.frontend:
        front = batch["frontend_embeds"].to(x.dtype) @ params["embed"]["w_front"]
        x = torch.cat([front, x], dim=1)
    return x


def _unembed(params: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["w_tok"].T
    return x @ params["lm_head"]["w"]


def forward(params: Dict, batch: Dict, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward: batch {tokens [B,S], frontend_embeds?} -> (logits, aux).
    With a frontend the logits cover its n_frontend_tokens positions too.

    With ``cfg.remat == "full"`` and autograd recording, each period is
    checkpointed (its activations recomputed in the backward), as the
    reference's ``jax.checkpoint(period_fn)``; the recomputation runs the
    same ops on the same inputs, so it reproduces the saved forward exactly,
    MoE routing included. Under ``no_grad`` (serving) nothing changes.

    Under a tensor-parallel mesh (module docstring) the logits are a
    DTensor on the model axis, sharded over the vocab where it divides."""
    tp = tp_axis()
    if tp is not None:
        logits, aux, vocab_sharded = _forward_tp(tp, params, batch, cfg)
        from torch.distributed.tensor import DTensor, Replicate, Shard
        sub = tp.mesh.device_mesh["model"]
        return DTensor.from_local(logits, sub, [Shard(2) if vocab_sharded else Replicate()],
                                  run_check=False), aux
    def period_fn(x, aux, slot_params):
        for si, kind in enumerate(cfg.pattern):
            x, a = _apply_block(kind, slot_params[f"slot{si}"], x, cfg)
            aux = aux + a
        return x, aux

    remat = cfg.remat == "full" and torch.is_grad_enabled()
    x = _embed(params, batch, cfg)
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.n_periods):
        slot_params = _period(params["periods"], i)
        if remat:
            x, aux = checkpoint(period_fn, x, aux, slot_params, use_reentrant=False)
        else:
            x, aux = period_fn(x, aux, slot_params)
    for i, kind in enumerate(cfg.tail):
        x, a = _apply_block(kind, params["tail"][i], x, cfg)
        aux = aux + a
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x, cfg), aux


def train_loss(params: Dict, batch: Dict, cfg: ArchConfig, aux_weight: float = 0.01
               ) -> torch.Tensor:
    """Next-token cross-entropy (+ MoE load-balance aux), in the reference's
    order: the frontend positions dropped (they carry no labels), fp32
    logits, ``logsumexp - logits[label]`` averaged, plus ``aux_weight * aux``.
    ``batch["labels"]`` is int64 [B, S_tok], as `token_batch` makes it.
    Under a tensor-parallel mesh the log-softmax runs over the vocab shards
    (module docstring); the loss is the same on every model rank."""
    tp = tp_axis()
    if tp is not None:
        logits, aux, vocab_sharded = _forward_tp(tp, params, batch, cfg)
    else:
        (logits, aux), vocab_sharded = forward(params, batch, cfg), False
    labels = batch["labels"]
    if cfg.frontend:
        logits = logits[:, cfg.n_frontend_tokens:]
    logits = logits.float()
    if vocab_sharded:
        return _vocab_parallel_ce(tp, logits, labels) + aux_weight * aux
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    ce = torch.mean(logz - gold)
    return ce + aux_weight * aux


# ===========================================================================
# Tensor parallelism: the forward on one model rank's shards
# ===========================================================================

def _apply_block_tp(tp: TPAxis, kind: str, p: Dict, x: torch.Tensor, cfg: ArchConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_apply_block` on one model rank: ``p`` of `TPLeaf` s, ``x``
    replicated (the norms run on every rank, on their gathered gains)."""
    aux = torch.zeros((), device=x.device)
    h = rmsnorm(x, tp.full(p["norm1"]), cfg.norm_eps)
    if kind in ATTN_KINDS:
        x = x + attention_block_tp(
            tp, p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, rope_theta=cfg.rope_theta,
            window=cfg.window if kind == "local_attn" else 0,
            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, f32_streams=cfg.attn_f32_streams)
        h2 = rmsnorm(x, tp.full(p["norm2"]), cfg.norm_eps)
        if kind == "attn_moe":
            y, aux = _moe(p["moe"], h2, cfg, tp)
            return x + y, aux
        return x + mlp_apply_tp(tp, p["mlp"], h2, cfg.mlp_act), aux
    if kind == "rglru":
        x = x + rglru_block_tp(tp, p["rglru"], h)
        return x + mlp_apply_tp(tp, p["mlp"], rmsnorm(x, tp.full(p["norm2"]), cfg.norm_eps),
                                cfg.mlp_act), aux
    if kind == "mlstm":
        return x + mlstm_block_tp(tp, p["mlstm"], h, cfg.n_heads, cfg.mlstm_chunk), aux
    if kind == "slstm":
        return x + slstm_block_tp(tp, p["slstm"], h, cfg.n_heads), aux
    raise ValueError(kind)


def _embed_tp(tp: TPAxis, params: Dict, batch: Dict, cfg: ArchConfig) -> torch.Tensor:
    """The token embedding, replicated: a vocab shard looks up its own rows
    (zeros for the others' tokens) and the ranks' rows are summed, which
    is exact; a d_model shard's columns are gathered."""
    w, tokens = params["embed"]["w_tok"], batch["tokens"]
    if w.dim == -2:
        rows = w.t.shape[0]
        idx = tokens - tp.rank * rows
        inside = (idx >= 0) & (idx < rows)
        x = tp.reduce(w.t[idx.clamp(0, rows - 1)] * inside[..., None].to(w.t.dtype))
    elif w.dim == -1:
        x = tp.gather(w.t[tokens], -1)
    else:
        x = w.t[tokens]
    if cfg.frontend:
        front = batch["frontend_embeds"].to(x.dtype) @ tp.param(params["embed"]["w_front"],
                                                                None)
        x = torch.cat([front, x], dim=1)
    return x


def _unembed_tp(tp: TPAxis, params: Dict, x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, bool]:
    """-> (logits, whether they are this rank's vocab shard): sharded over
    the vocab where it divides (``_vocab_shard``), else whole on every rank."""
    if cfg.tie_embeddings:
        w, vocab_dim = params["embed"]["w_tok"], -2
    else:
        w, vocab_dim = params["lm_head"]["w"], -1
    if not tp.divides(cfg.vocab):
        w = tp.param(w, None)
        return x @ (w.T if cfg.tie_embeddings else w), False
    w = tp.param(w, vocab_dim)
    return tp.copy(x) @ (w.T if cfg.tie_embeddings else w), True


def _vocab_parallel_ce(tp: TPAxis, logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """``mean(logsumexp(logits) - logits[label])`` over vocab-sharded fp32
    logits: the max (no gradient: the log-sum-exp does not depend on it),
    the sum of exponentials and the gold logit each reduced over the ranks."""
    import torch.distributed as dist
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    logz = m + torch.log(tp.reduce(torch.exp(logits - m[..., None]).sum(dim=-1)))
    cols = logits.shape[-1]
    idx = labels.long() - tp.rank * cols
    inside = (idx >= 0) & (idx < cols)
    gold = torch.take_along_dim(logits, idx.clamp(0, cols - 1)[..., None], dim=-1)[..., 0]
    return torch.mean(logz - tp.reduce(gold * inside))


def _blocks_tp(tp: TPAxis, cfg: ArchConfig, x: torch.Tensor, aux: torch.Tensor, kinds,
               block_params, seq: bool, split_at_end: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kinds`` blocks on one model rank, ``x`` entering split along the
    sequence where ``seq`` (`_forward_tp`): a block gathers it, an
    ``attn_mlp`` / ``attn_moe`` block splits it again (``cfg.sp_blocks``),
    and it leaves split (``split_at_end``) or whole."""
    split = seq
    for kind, p in zip(kinds, block_params):
        if split:
            x, split = tp.gather(x, 1), False
        x, a = _apply_block_tp(tp, kind, p, x, cfg)
        aux = aux + a
        if seq and cfg.sp_blocks and kind in ("attn_mlp", "attn_moe"):
            x, split = tp.split(x, 1), True
    if split_at_end and seq and not split:
        x = tp.split(x, 1)
    elif not split_at_end and split:
        x = tp.gather(x, 1)
    return x, aux


def _period_axis_whole(tp: TPAxis, tree: Any) -> Any:
    """The stacked period leaves with every period on every rank: a leaf
    sharded along its period axis (a stacked 1-D leaf whose width the axis
    does not divide, where it divides the periods) is gathered; per-period
    tuples (`train.train_step.value_and_grad` 's) pass."""
    if isinstance(tree, dict):
        return {k: _period_axis_whole(tp, v) for k, v in tree.items()}
    if isinstance(tree, TPLeaf) and tree.dim == -tree.t.ndim:
        return TPLeaf(tp.gather(tree.t, tree.dim))
    return tree


def _forward_tp(tp: TPAxis, params: Dict, batch: Dict, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """`forward` on one model rank -> (logits, aux, vocab-sharded).

    The residual stream enters each period split along the sequence over
    the ranks (``_seq_shard``, where S divides) and leaves it so; inside,
    a block gathers it, and it is split again after each ``attn_mlp`` /
    ``attn_moe`` block (``cfg.sp_blocks``). Gathering a split stream and
    splitting a whole one move no number."""
    params = unwrap(shard_cotangents(params))
    if "periods" in params:
        params = dict(params, periods=_period_axis_whole(tp, params["periods"]))
    x = _embed_tp(tp, params, batch, cfg)
    seq = x.shape[1] % tp.size == 0

    def blocks(x, aux, kinds, block_params, split_at_end):
        return _blocks_tp(tp, cfg, x, aux, kinds, block_params, seq, split_at_end)

    def period_fn(x, aux, slot_params):
        return blocks(x, aux, cfg.pattern,
                      [slot_params[f"slot{si}"] for si in range(len(cfg.pattern))], True)

    remat = cfg.remat == "full" and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    if seq:
        x = tp.split(x, 1)
    for i in range(cfg.n_periods):
        slot_params = _period(params["periods"], i)
        if remat:
            x, aux = checkpoint(period_fn, x, aux, slot_params, use_reentrant=False)
        else:
            x, aux = period_fn(x, aux, slot_params)
    x, aux = blocks(x, aux, cfg.tail, params["tail"], False)
    x = rmsnorm(x, tp.full(params["final_norm"]), cfg.norm_eps)
    logits, vocab_sharded = _unembed_tp(tp, params, x, cfg)
    return logits, aux, vocab_sharded


def _data_rows(batch: Dict, mesh) -> Dict:
    """This rank's rows of a serving batch where the data-parallel axes
    divide it, else the whole batch on every rank (`dist.sharding.batch_spec`'s
    rule)."""
    from ..train.train_step import local_rows
    rows = batch["tokens"].shape[0]
    if mesh.dp_size == 1 or rows % mesh.dp_size:
        return batch
    return local_rows(batch, mesh.dp_rank, mesh.dp_size)


def prefill_step(params: Dict, batch: Dict, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill: forward over the prompt, returning last-position logits.
    Under a tensor-parallel mesh, this rank's rows of the batch (its
    position on the data-parallel axes)."""
    tp = tp_axis()
    if tp is not None:
        batch = _data_rows(batch, tp.mesh)
    logits, aux = forward(params, batch, cfg)
    return logits[:, -1:], aux


# ===========================================================================
# Serving: cache init, decode
# ===========================================================================

def _init_block_cache(kind: str, cfg: ArchConfig, batch: int, seq_len: int, dt, device,
                      lead: Tuple[int, ...] = ()) -> Dict:
    if kind in ("attn_mlp", "attn_moe"):
        return init_kv_cache(batch, seq_len, cfg.n_kv_heads, cfg.hd, dt, device, lead)
    if kind == "local_attn":
        return init_kv_cache(batch, min(cfg.window, seq_len), cfg.n_kv_heads, cfg.hd, dt,
                             device, lead)
    if kind == "rglru":
        return rglru_init_state(batch, cfg.d_rnn or cfg.d_model, cfg.conv_width, dt, device,
                                lead)
    if kind == "mlstm":
        return mlstm_init_state(batch, cfg.d_model, cfg.n_heads, device, lead)
    if kind == "slstm":
        return slstm_init_state(batch, cfg.d_model, device, lead)
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device="cuda") -> Dict[str, Any]:
    device = resolve_device(device)
    dt = _dtype(cfg)
    periods = {f"slot{si}": _init_block_cache(kind, cfg, batch, seq_len, dt, device,
                                              (cfg.n_periods,))
               for si, kind in enumerate(cfg.pattern)}
    tail = tuple(_init_block_cache(kind, cfg, batch, seq_len, dt, device) for kind in cfg.tail)
    return {"periods": periods, "tail": tail}


def _leaves(cache: Dict[str, Any]):
    """(leaf, batch axis) for every cache tensor (KV and recurrent state):
    period leaves carry the period axis first."""
    out = []
    for blk in cache["periods"].values():
        out += [(leaf, 1) for leaf in blk.values()]
    for blk in cache["tail"]:
        out += [(leaf, 0) for leaf in blk.values()]
    return out


def reset_cache_rows(cache: Dict[str, Any], fresh: Dict[str, Any],
                     keep: torch.Tensor) -> Dict[str, Any]:
    """Copy ``fresh`` rows into ``cache`` where ``keep`` [B] is False, in
    place (``fresh`` must be a separate tree from `init_cache`); returns
    ``cache``. Continuous serving resets a finished request's slot before
    the slot's next occupant."""
    reset = torch.nonzero(~torch.as_tensor(keep, dtype=torch.bool)).flatten()
    for (leaf, axis), (src, _) in zip(_leaves(cache), _leaves(fresh)):
        idx = reset.to(leaf.device)
        leaf.index_copy_(axis, idx, src.index_select(axis, idx))
    return cache


def _freeze_state_rows(new_state: Dict, old_state: Dict,
                       active: Optional[torch.Tensor]) -> Dict:
    """Write ``new_state`` into ``old_state`` in place, except the rows
    where ``active`` [B] is False, which keep their old values (recurrent
    state leaves are [B, ...]); returns ``old_state``."""
    for key, new in new_state.items():
        old = old_state[key]
        if active is not None:
            keep = torch.as_tensor(active, device=new.device)
            new = torch.where(keep.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)
        old.copy_(new)
    return old_state


def _decode_block(kind: str, p: Dict, x: torch.Tensor, cache: Dict, pos, cfg: ArchConfig,
                  active: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        y, cache = attention_decode(
            p["attn"], h, cache, pos, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, rope_theta=cfg.rope_theta,
            window=cfg.window if kind == "local_attn" else 0, active=active)
        x = x + y
        h2 = rmsnorm(x, p["norm2"], cfg.norm_eps)
        if kind == "attn_moe":
            return x + _moe(p["moe"], h2, cfg)[0], cache
        return x + mlp_apply(p["mlp"], h2, cfg.mlp_act), cache
    if kind == "rglru":
        y, new = rglru_block_decode(p["rglru"], h, cache)
        x = x + y
        x = x + mlp_apply(p["mlp"], rmsnorm(x, p["norm2"], cfg.norm_eps), cfg.mlp_act)
    elif kind == "mlstm":
        y, new = mlstm_block_decode(p["mlstm"], h, cache, cfg.n_heads)
        x = x + y
    elif kind == "slstm":
        y, new = slstm_block_decode(p["slstm"], h, cache, cfg.n_heads)
        x = x + y
    else:
        raise ValueError(kind)
    return x, _freeze_state_rows(new, cache, active)


def decode_step(params: Dict, cache: Dict, batch: Dict, pos, cfg: ArchConfig,
                active: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. batch {tokens [B,1]}; pos: a position shared by
    the batch, or a [B] vector of per-request positions (recurrent blocks
    are position-free).

    active: optional bool [B]; rows with active=False advance no cache (KV
    entry or recurrent state). Updates ``cache`` in place and returns
    (logits [B,1,V], cache).

    Under a tensor-parallel mesh (placed ``params``, a ``cache`` of
    DTensors split over the data-parallel axes, `dist.sharding.cache_specs`)
    the step has no tensor-parallel blocks: each block's weights are
    gathered whole over the model axis when it runs (`TPAxis.full`), and
    this rank decodes its rows of the batch (its cache shards) with the
    one-device blocks. The logits are this rank's rows."""
    tp = tp_axis()
    if tp is None:
        return _decode_layers(params, cache, batch, pos, cfg, active, lambda tree: tree)
    from ..dist.context import compute_mesh
    from ..dist.sharding import local
    params, cache = unwrap(params), local(cache)
    batch = _data_rows(batch, tp.mesh)
    with compute_mesh(None):             # whole weights: the one-device blocks
        return _decode_layers(params, cache, batch, pos, cfg, active, tp.full)


def _decode_layers(params: Dict, cache: Dict, batch: Dict, pos, cfg: ArchConfig, active,
                   full) -> Tuple[torch.Tensor, Dict]:
    """`decode_step`'s layers, each block's weights through ``full``."""
    x = full(params["embed"]["w_tok"])[batch["tokens"]]
    for i in range(cfg.n_periods):
        slot_params = _period(params["periods"], i)
        slot_cache = _period(cache["periods"], i)
        for si, kind in enumerate(cfg.pattern):
            x, _ = _decode_block(kind, full(slot_params[f"slot{si}"]), x,
                                 slot_cache[f"slot{si}"], pos, cfg, active)
    for i, kind in enumerate(cfg.tail):
        x, _ = _decode_block(kind, full(params["tail"][i]), x, cache["tail"][i], pos, cfg,
                             active)
    x = rmsnorm(x, full(params["final_norm"]), cfg.norm_eps)
    head = {k: full(params[k]) for k in ("embed", "lm_head") if k in params}
    return _unembed(head, x, cfg), cache


def decode_chunk(params: Dict, cache: Dict, tokens: torch.Tensor, pos0, take,
                 cfg: ArchConfig, active: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Chunk-masked multi-token decode: per-row ragged token chunks.

    tokens: int [B, C]; row i consumes ``tokens[i, :take[i]]`` at positions
    ``pos0[i] .. pos0[i] + take[i] - 1``; later columns are masked for that
    row (cache frozen, outputs ignored). This is the serving engine's
    chunked prefill and the speculative-verify launch. C `decode_step`
    calls with per-column active masks.

    Returns (picks [B, C] greedy argmax per column, logits [B, C, V], cache).
    """
    b, c = tokens.shape
    dev = tokens.device
    pos0 = torch.as_tensor(pos0, device=dev).long().expand(b)
    take = torch.as_tensor(take, device=dev).long().expand(b)
    base = torch.ones(b, dtype=torch.bool, device=dev) if active is None \
        else torch.as_tensor(active, device=dev)
    picks, logits = [], []
    for t in range(c):
        step_logits, cache = decode_step(params, cache, {"tokens": tokens[:, t:t + 1]},
                                         pos0 + t, cfg, active=base & (t < take))
        last = step_logits[:, -1]                                 # [B, V]
        picks.append(torch.argmax(last, dim=-1))
        logits.append(last)
    return torch.stack(picks, dim=1), torch.stack(logits, dim=1), cache


def rollback_cache_rows(cache: Dict, keep_len, rows) -> Dict:
    """Zero KV entries at positions ``>= keep_len[b]`` for the rows where
    ``rows`` [B] is True, in place; returns ``cache``.

    The speculative-decode rollback: a verify launch writes K+1 KV entries
    per drafting row, and zeroing the rejected suffix restores the state a
    never-speculated session holds. Valid only for position-indexed KV
    caches (``attn_mlp`` / ``attn_moe``); recurrent state and the ring
    buffer of ``local_attn`` cannot roll back (`serve.runners.lm` gates
    speculation off for them)."""
    for leaf, axis in _leaves(cache):
        keep_len = torch.as_tensor(keep_len, device=leaf.device).long()
        rows = torch.as_tensor(rows, dtype=torch.bool, device=leaf.device)
        seq = leaf.shape[axis + 1]
        idx = torch.arange(seq, device=leaf.device)
        keep = (~rows[:, None]) | (idx[None, :] < keep_len[:, None])     # [B, S]
        shape = [1] * leaf.ndim
        shape[axis], shape[axis + 1] = keep.shape
        leaf.masked_fill_(~keep.reshape(shape), 0)
    return cache
