"""Mixture-of-Experts layer: sort-based routing + capacity batched GEMMs.

The JAX package's models/moe.py in PyTorch. The router is the event
generator and the experts event-gated compute: work is spent only where
tokens are routed, the LM-scale analogue of event-driven execution. The
formulation is the reference's (dropped-token capacity):

  1. top-k route, flatten to T*k (token, expert) pairs, stable-sort by
     expert id;
  2. gather each expert's contiguous rows into a fixed-capacity buffer
     [E, C, d] (C = T*k/E * capacity_factor; rows past capacity dropped);
  3. three batched GEMMs ``ecd,edf->ecf``;
  4. gate-weighted combine of each token's k rows, and the Switch-style
     load-balancing auxiliary loss.

Padded experts (``n_experts_padded``) carry weights but are masked to
-1e30 in the router, so they are never routed; the batched GEMMs still
multiply them, as the reference does.

The combine sums each token's k contributions in sorted-row order (expert
ascending), the order the reference's CPU scatter-add takes, with plain
adds and no atomics, so two runs on the card agree bit for bit. A
padded or inactive decode row routes and takes capacity exactly as in JAX,
so capacity drops depend on the batch as they do there. In training, the
backwards of its gathers accumulate with ``index_put_(accumulate=True)``,
which sorts its indices on the card: deterministic under the train step's
settings, so two card steps from one state agree bit for bit too.

Under an ambient in-process data mesh (`launch.mesh.DataMesh`) whose
``'data'`` (x ``'pod'``) size ndp divides the batch, each of the ndp row
blocks of ``x`` is routed on its own, as the reference's ``shard_map`` over
the data axes routes each shard's rows: capacity comes from the *local*
row count, so which tokens drop depends on the block. The aux loss is the
mean of the blocks' (the reference's ``pmean``). The blocks run on ``x``'s
device: in JAX only the MoE is under ``shard_map``.

On one model rank of a tensor-parallel mesh (`dist.tensor_parallel`,
``p`` holding `TPLeaf` s) the router's column shards give logits that are
gathered before the stable top-k, so routing and capacity are the same on
every model rank; the experts' ``w_in`` / ``w_gate`` split d_ff (in
uneven ranges where the ranks do not divide it) and ``w_out`` is
row-parallel, and the combined partial sums are all-reduced.
Each data rank routes its own rows, as the reference's ``shard_map`` over
the data axes does: the train step hands each rank its rows. With
``fsdp_experts`` the expert stacks are also split over ``'data'`` and
gathered per layer (their gradient averaged over the data ranks and
scattered back); without a mesh it is a layout and changes no number.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.tiling import round_up
from ..device import resolve_device
from ..dist.context import current_mesh
from ..dist.tensor_parallel import tp_axis
from ..launch.mesh import DataMesh
from .layers import _gelu, dense_init, mlp_apply, mlp_apply_tp, mlp_init

NEG_INF = -1e30


def moe_init(gen: torch.Generator, d: int, n_experts: int, d_ff_e: int, act: str, dtype,
             shared_expert: bool = False, d_ff_shared: int = 0, n_experts_padded: int = 0,
             device="cuda", lead: Tuple[int, ...] = ()) -> Dict:
    device = resolve_device(device)
    n_experts = max(n_experts_padded, n_experts)  # padded experts router-masked
    stack = (*lead, n_experts)
    experts = {"w_in": dense_init(gen, d, d_ff_e, dtype, device, stack),
               "w_out": dense_init(gen, d_ff_e, d, dtype, device, stack)}
    if act in ("swiglu", "geglu"):
        experts["w_gate"] = dense_init(gen, d, d_ff_e, dtype, device, stack)
    p = {"w_router": dense_init(gen, d, n_experts, dtype, device, lead), "experts": experts}
    if shared_expert:
        p["shared"] = mlp_init(gen, d, d_ff_shared or d_ff_e, act, dtype, device, lead)
    return p


def moe_apply(p: Dict, x: torch.Tensor, *, top_k: int, act: str, n_experts: int,
              capacity_factor: float = 1.25, n_experts_padded: int = 0,
              fsdp_experts: bool = False, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar). Under an in-process
    data mesh the rows are routed block by block (module docstring).
    ``tp``: this model rank's `TPAxis` (default: the ambient mesh's), with
    ``p`` of `TPLeaf` s; given explicitly where the call may run outside
    the caller's context (a checkpointed period's recomputation runs on
    autograd's device thread). ``fsdp_experts`` is the placed tree's
    layout (`dist.sharding.place`) and changes no number here."""
    kw = dict(top_k=top_k, act=act, n_experts=max(n_experts_padded, n_experts),
              n_valid=n_experts, capacity_factor=capacity_factor)
    tp = tp if tp is not None else tp_axis()
    if tp is not None:
        return _moe_core(p, x, tp=tp, **kw)
    ndp = _data_blocks(x.shape[0])
    if ndp > 1:
        outs = [_moe_core(p, xb, **kw) for xb in x.chunk(ndp)]
        aux = outs[0][1]
        for _, a in outs[1:]:
            aux = aux + a
        return torch.cat([y for y, _ in outs]), aux / ndp
    return _moe_core(p, x, **kw)


def _data_blocks(batch: int) -> int:
    """ndp, the ambient in-process mesh's data-parallel size, where it
    divides ``batch``; else 1."""
    mesh = current_mesh()
    if not isinstance(mesh, DataMesh):
        return 1
    ndp = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            ndp *= int(mesh.shape[a])
    return ndp if batch % ndp == 0 and batch >= ndp else 1


def _top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k`: the k largest along the last axis, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_core(p: Dict, x: torch.Tensor, *, top_k: int, act: str, n_experts: int,
              n_valid: int, capacity_factor: float, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of rows; ``tp`` (a `TPAxis`, ``p`` of `TPLeaf` s): on one
    model rank, with d_ff split over the ranks (module docstring)."""
    if tp is not None:
        experts = _experts_tp(tp, p["experts"])
        if tp.divides(n_experts):
            router = lambda xt: tp.gather(tp.copy(xt) @ tp.param(p["w_router"], -1), -1)  # noqa: E731
        else:
            router = lambda xt: xt @ tp.param(p["w_router"], None)  # noqa: E731
        # rank-specific uses of replicated values (their gradients summed
        # over the ranks) and the partial sums' reduction
        part = (tp.copy, tp.reduce)
    else:
        experts = p["experts"]
        router = lambda xt: xt @ p["w_router"]  # noqa: E731
        part = (lambda t: t, lambda t: t)
    b, s, d = x.shape
    dev = x.device
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    rows = t * top_k
    # plain Python float arithmetic, as in the reference
    capacity = min(round_up(int(rows / n_valid * capacity_factor) + 1, 8), rows)

    logits = router(xt).float()                                # [T, E]
    if n_valid < n_experts:                                    # mask padded experts
        logits = logits.masked_fill(torch.arange(n_experts, device=dev) >= n_valid, NEG_INF)
    gate_vals, idx = _top_k(logits, top_k)                     # [T, k]
    weights = torch.sigmoid(gate_vals) if top_k == 1 else torch.softmax(gate_vals, dim=-1)

    flat_expert = idx.reshape(-1)                              # [T*k]
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    src_token = torch.div(order, top_k, rounding_mode="floor")  # token of each sorted row
    # rows per expert (integer adds: exact, and unlike bincount no device sync)
    group_sizes = torch.zeros(n_experts, dtype=torch.long, device=dev).index_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    offsets = torch.cumsum(group_sizes, 0) - group_sizes       # [E]

    # rank of each sorted row within its expert; rows >= capacity are dropped
    rank = torch.arange(rows, device=dev) - offsets[sorted_expert]
    valid = rank < capacity

    xs = xt[src_token]                                         # [T*k, d] sorted
    xs_pad = torch.cat([xs, xs.new_zeros((capacity, d))])      # offset + C never clamps
    slot = torch.arange(capacity, device=dev)
    xe = xs_pad[offsets[:, None] + slot[None, :]]              # [E, C, d]
    xe = xe * (slot[None, :] < group_sizes[:, None])[..., None].to(xe.dtype)

    xe = part[0](xe)
    h = torch.bmm(xe, experts["w_in"])                         # [E, C, ff]
    if act in ("swiglu", "geglu"):
        hg = torch.bmm(xe, experts["w_gate"])
        h = (F.silu(hg) if act == "swiglu" else _gelu(hg)) * h
    elif act == "gelu":
        h = _gelu(h)
    elif act == "relu2":
        h = torch.square(F.relu(h))
    oe = torch.bmm(h, experts["w_out"])                        # [E, C, d]

    # sorted row i reads oe[expert_i, rank_i] when valid
    out_rows = oe[sorted_expert, rank.clamp(0, capacity - 1)]
    gate = part[0]((weights.reshape(-1)[order] * valid).to(xt.dtype))   # [T*k]
    contrib = out_rows.to(xt.dtype) * gate[:, None]
    # each token's k rows in sorted-row order: its experts ascending
    where = torch.empty_like(order)
    where[order] = torch.arange(rows, device=dev)
    per_token = contrib[torch.sort(where.reshape(t, top_k), dim=1).values]   # [T, k, d]
    y = torch.zeros_like(xt)
    for j in range(top_k):
        y = y + per_token[:, j]
    y = part[1](y)

    if "shared" in p:
        y = y + (mlp_apply(p["shared"], xt, act) if tp is None
                 else mlp_apply_tp(tp, p["shared"], xt, act))

    # Switch-style load-balancing loss: E * sum_e f_e * p_e
    router_probs = torch.softmax(logits, dim=-1)               # [T, E]
    frac_tokens = F.one_hot(idx, n_experts).float().sum(1).mean(0)
    frac_probs = router_probs.mean(0)
    aux = n_experts * torch.sum(frac_tokens / top_k * frac_probs)
    return y.reshape(b, s, d), aux


def _experts_tp(tp, experts: Dict) -> Dict:
    """The expert stacks on one model rank: ``w_in`` / ``w_gate``
    column-parallel and ``w_out`` row-parallel on this rank's range of
    the expert d_ff (`TPAxis.span`, uneven where the ranks do not divide
    it)."""
    lo, hi = tp.span(tp.extent(experts["w_out"], -2))       # the expert d_ff
    return {k: tp.part(v, -2 if k == "w_out" else -1, lo, hi) for k, v in experts.items()}
