"""Optimizers as pure transforms over trees of tensors: SGD-M, AdamW, Adafactor.

No external deps — each optimizer is (init, update):
    state = init(params)
    updates, state = update(grads, state, params, lr)
    params = apply_updates(params, updates)

Every update is written in the reference's order of operations, so a step
rounds as the JAX package's does (``torch.optim.AdamW`` orders its update
differently). ``zero1_spec`` is the ZeRO-1 rule for one optimizer leaf
(``dist.sharding.zero1_opt_specs`` is its tree form); nothing places
optimizer state by it. Under tensor parallelism (`train.train_step`) SGD
and AdamW update each rank's shards elementwise, their moments laid out as
their parameters; `clip_by_global_norm` counts each shard once
(``shards``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from .tree import tree_leaves, tree_leaves_with_path, tree_map, tree_map_with_path


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], Tuple[Any, Any]]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree, shards=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares. ``shards`` (a tree like
    ``tree``; tensor parallelism): per leaf, the process groups its local
    shard is split over, ``()`` for a replicated leaf. Each group of
    leaves split over the same groups sums its squares locally, and that
    sum is all-reduced over those groups once; a replicated leaf counts
    once. Every rank gets the same norm."""
    leaves = tree_leaves(tree)
    if shards is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))
    import torch.distributed as dist
    buckets = {}
    for x, groups in zip(leaves, _leaves_like(tree, shards)):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        key = tuple(groups)
        buckets[key] = sq if key not in buckets else buckets[key] + sq
    total = None
    for groups, sq in buckets.items():
        for group in groups:
            dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=group)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _leaves_like(tree, other):
    """``other``'s entries at ``tree``'s leaves, in `tree_leaves` order
    (``other`` may hold tuples as entries)."""
    by_path = {}
    tree_map_with_path(lambda path, _, o: by_path.__setitem__(path, o), tree, other)
    return [by_path[path] for path, _ in tree_leaves_with_path(tree)]


def clip_by_global_norm(grads, max_norm: float, shards=None):
    norm = global_norm(grads, shards)
    # a tensor numerator: `float / tensor` is reciprocal-then-multiply in torch
    scale = torch.clamp(torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-9),
                        max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _zeros_f32(p):
    return torch.zeros_like(p, dtype=torch.float32)


# ---------------------------------------------------------------------------
# SGD with momentum
# ---------------------------------------------------------------------------

def sgd(momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros_f32, params)}

    def update(grads, state, params, lr):
        mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32), state["mu"], grads)
        upd = tree_map(lambda m, p: -lr * (m + weight_decay * p.to(torch.float32)), mu, params)
        return upd, {"mu": mu}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# AdamW (fp32 master moments; bias-corrected)
# ---------------------------------------------------------------------------

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        device = tree_leaves(params)[0].device
        return {"m": tree_map(_zeros_f32, params), "v": tree_map(_zeros_f32, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32), state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        c1 = 1 - b1 ** t.to(torch.float32)
        c2 = 1 - b2 ** t.to(torch.float32)
        upd = tree_map(
            lambda m, v, p: -lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                                   + weight_decay * p.to(torch.float32)),
            m, v, params)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; memory ~ O(rows+cols))
# ---------------------------------------------------------------------------

def adafactor(decay: float = 0.8, eps: float = 1e-30, clip_thresh: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Simplified Adafactor (Shazeer & Stern): factored v for >=2D params,
    no momentum."""

    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def leaf(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros_f32(p)}
        device = tree_leaves(params)[0].device
        return {"s": tree_map(leaf, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        beta = 1.0 - (t.to(torch.float32) + 1.0) ** (-decay)

        def leaf(g, s, p):
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if _factored(p.shape):
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                rfac = torch.rsqrt(vr / torch.clamp(
                    torch.mean(vr, dim=-1, keepdim=True), min=eps) + eps)
                cfac = torch.rsqrt(vc + eps)
                u = g * rfac[..., None] * cfac[..., None, :]
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                ns = {"v": v}
            # update clipping (RMS <= clip_thresh)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_thresh, min=1.0)
            return -lr * (u + weight_decay * p.to(torch.float32)), ns

        # walk the params' structure: each leaf's state is itself a dict, and
        # each leaf's result an (update, state) pair
        out = tree_map(lambda p, g, s: leaf(g, s, p), params, grads, state["s"])
        return (tree_map(lambda p, o: o[0], params, out),
                {"s": tree_map(lambda p, o: o[1], params, out), "t": t})

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "adamw": adamw, "adafactor": adafactor}[name](**kw)


# ---------------------------------------------------------------------------
# ZeRO-1 sharding of optimizer state
# ---------------------------------------------------------------------------

def zero1_spec(param_spec, shape, data_axis: str = "data", data_size: int = 2):
    """Add ``data_axis`` to the first axis that is unsharded & divisible.

    param_spec: the parameter's `dist.sharding.PartitionSpec` (any
    sequence of entries). data_size: the data axis size to check
    divisibility against. Returns the spec for fp32 optimizer moments of the
    same shape.
    """
    from ..dist.sharding import PartitionSpec as P
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    if data_size > 1:
        for i, (e, dim) in enumerate(zip(entries, shape)):
            if e is None and dim % data_size == 0:
                entries[i] = data_axis
                return P(*entries)
    return P(*entries)
