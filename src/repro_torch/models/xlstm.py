"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) + sLSTM (scalar).

The JAX package's models/xlstm.py in PyTorch. mLSTM recurrence (per head,
stabilized, state stored pre-scaled by exp(-m)):

    m_t = max(lf_t + m_{t-1}, li_t)
    C_t = exp(lf_t + m_{t-1} - m_t) C_{t-1} + exp(li_t - m_t) k_t v_t^T
    n_t = exp(lf_t + m_{t-1} - m_t) n_{t-1} + exp(li_t - m_t) k_t
    h_t = o_t * (q_t C_t) / max(|q_t . n_t|, exp(-m_t))

Prefill uses the exact chunkwise-parallel form: within a chunk the decay
matrix D_ij = exp(F_i - F_j + li_j) weighs a masked quadratic score;
across chunks a Python loop carries the (C, n, m) state. Per-position
stabilizers are computed in closed form (m_i = F_i + max(m_prev,
cummax_j(li_j - F_j))), so the chunked path equals the sequential
recurrence.

sLSTM has hidden-state feedback in its gates (true recurrence); it runs as
a loop over time with block-diagonal per-head recurrent weights.

Both are leaky-integrator relatives of the paper's LIF neuron: mLSTM's
forget gate is a learned, input-dependent beta. Decode functions return
the new state and do not write the one they are given. `mlstm_block_tp`
and `slstm_block_tp` split the heads over the ranks of a tensor-parallel
mesh (`dist.tensor_parallel`), in uneven ranges where the ranks do not
divide them.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .layers import dense_init

NEG = -1e30


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_init(gen: torch.Generator, d: int, n_heads: int, dtype, device="cuda",
               lead: Tuple[int, ...] = ()) -> Dict:
    device = resolve_device(device)
    d_in = 2 * d
    return {
        "w_up": dense_init(gen, d, d_in, dtype, device, lead),
        "w_gate": dense_init(gen, d, d_in, dtype, device, lead),
        "wq": dense_init(gen, d_in, d_in, dtype, device, lead),
        "wk": dense_init(gen, d_in, d_in, dtype, device, lead),
        "wv": dense_init(gen, d_in, d_in, dtype, device, lead),
        "w_if": dense_init(gen, d_in, 2 * n_heads, dtype, device, lead),  # input/forget logits
        "w_down": dense_init(gen, d_in, d, dtype, device, lead),
        # forget bias -> long memory
        "b_f": torch.full((*lead, n_heads), 3.0, dtype=torch.float32, device=device),
    }


def _mlstm_qkv_gates(p: Dict, x: torch.Tensor, n_heads: int):
    b, s, _ = x.shape
    u = x @ p["w_up"]
    hd = u.shape[-1] // n_heads
    q = (u @ p["wq"]).reshape(b, s, n_heads, hd) / math.sqrt(hd)
    k = (u @ p["wk"]).reshape(b, s, n_heads, hd) / math.sqrt(hd)
    v = (u @ p["wv"]).reshape(b, s, n_heads, hd)
    gates = (u @ p["w_if"]).float().reshape(b, s, n_heads, 2)
    li = gates[..., 0]                                        # log input gate (exp gating)
    lf = F.logsigmoid(gates[..., 1] + p["b_f"])               # log forget gate
    gate_out = F.silu(x @ p["w_gate"])
    return q, k, v, li, lf, gate_out


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis in log2(L) doubling steps
    of plain adds (Hillis-Steele; JAX's CPU cumsum is a parallel scan too).
    Deterministic, and the same bits on the card as on the CPU: the card's
    ``torch.cumsum`` on floats is neither, and raises inside a training
    step (`train.train_step.deterministic`)."""
    n, step = x.shape[-1], 1
    while step < n:
        x = torch.cat([x[..., :step], x[..., step:] + x[..., :-step]], dim=-1)
        step *= 2
    return x


def mlstm_block(p: Dict, x: torch.Tensor, n_heads: int, chunk: int = 256) -> torch.Tensor:
    """Chunkwise-parallel mLSTM over [B, S, d]."""
    q, k, v, li, lf, gate_out = _mlstm_qkv_gates(p, x, n_heads)
    h = _mlstm_chunkwise(q, k, v, li, lf, chunk)
    return (h.to(x.dtype) * gate_out) @ p["w_down"]


def mlstm_block_tp(tp, p: Dict, x: torch.Tensor, n_heads: int, chunk: int = 256
                   ) -> torch.Tensor:
    """`mlstm_block` on one model rank (``p`` of `TPLeaf` s, ``x``
    replicated): ``w_up`` column-parallel and gathered (q, k, v and the
    gates read every channel); this rank's range of the heads
    (`TPAxis.span`, uneven where the ranks do not divide them) takes its
    columns of ``wq`` / ``wk`` / ``wv`` / ``w_if`` / ``w_gate`` and of
    ``b_f`` (`TPAxis.part`), and its recurrences run here as in one
    process; ``w_down`` row-parallel on the same range, its partial sums
    all-reduced."""
    b, s, _ = x.shape
    lo, hi = tp.span(n_heads)
    d_in = tp.extent(p["wq"], -1)
    hd = d_in // n_heads
    cols = lambda name, dim=-1: tp.part(p[name], dim, lo * hd, hi * hd)  # noqa: E731
    xc = tp.copy(x)
    u = tp.gather(xc @ tp.part(p["w_up"], -1, *tp.span(d_in)), -1, partial=True, n=d_in)
    q = (u @ cols("wq")).reshape(b, s, hi - lo, hd) / math.sqrt(hd)
    k = (u @ cols("wk")).reshape(b, s, hi - lo, hd) / math.sqrt(hd)
    v = (u @ cols("wv")).reshape(b, s, hi - lo, hd)
    gates = (u @ tp.part(p["w_if"], -1, 2 * lo, 2 * hi)).float().reshape(b, s, hi - lo, 2)
    lf = F.logsigmoid(gates[..., 1] + tp.part(p["b_f"], -1, lo, hi))
    h = _mlstm_chunkwise(q, k, v, gates[..., 0], lf, chunk)
    gate_out = F.silu(xc @ cols("w_gate"))
    return tp.reduce((h.to(x.dtype) * gate_out) @ cols("w_down", -2))


def _mlstm_chunkwise(q, k, v, li, lf, chunk: int) -> torch.Tensor:
    """The chunkwise recurrence over q, k, v [B, S, H, hd] and the log
    gates [B, S, H] -> h [B, S, H * hd] (float32)."""
    b, s, n_heads, hd = q.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk

    def rc(a):
        """[B, S, H, ...] -> [nc, B, H, L, ...]"""
        a = a.reshape(b, nc, chunk, n_heads, *a.shape[3:])
        return a.movedim(1, 0).movedim(3, 2)

    qc, kc, vc = rc(q.float()), rc(k.float()), rc(v.float())
    lic, lfc = rc(li), rc(lf)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))

    C = torch.zeros((b, n_heads, hd, hd), device=q.device)
    n = torch.zeros((b, n_heads, hd), device=q.device)
    m = torch.full((b, n_heads), NEG, device=q.device)
    hs = []
    for ci in range(nc):
        qi, ki, vi, lii, lfi = qc[ci], kc[ci], vc[ci], lic[ci], lfc[ci]
        Fc = _prefix_sum(lfi)                                 # [B,H,L] inclusive
        # per-position stabilizer (the sequential m), in closed form
        g = torch.maximum(m[..., None], torch.cummax(lii - Fc, dim=2).values)
        m_i = Fc + g                                          # [B,H,L]
        # inter-chunk: qi against the carried state
        inter_w = torch.exp(Fc + m[..., None] - m_i)
        h_inter = torch.einsum("bhlq,bhqd->bhld", qi * inter_w[..., None], C)
        n_inter = torch.einsum("bhlq,bhq->bhl", qi * inter_w[..., None], n)
        # intra-chunk: D_ij = exp(F_i - F_j + li_j - m_i), causal
        D = Fc[..., :, None] - Fc[..., None, :] + lii[..., None, :] - m_i[..., :, None]
        D = torch.where(mask, D, NEG)
        sc = torch.einsum("bhld,bhjd->bhlj", qi, ki) * torch.exp(D)
        h_intra = torch.einsum("bhlj,bhjd->bhld", sc, vi)
        num = h_inter + h_intra                               # [B,H,L,hd]
        den = n_inter + sc.sum(-1)                            # [B,H,L]
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None])
        # state update to the end of the chunk
        F_tot = Fc[..., -1]
        m_next = torch.maximum(m + F_tot, (F_tot[..., None] - Fc + lii).amax(-1))
        decay_state = torch.exp(m + F_tot - m_next)
        w_j = torch.exp(F_tot[..., None] - Fc + lii - m_next[..., None])   # [B,H,L]
        C = decay_state[..., None, None] * C + torch.einsum(
            "bhjd,bhje->bhde", ki * w_j[..., None], vi)
        n = decay_state[..., None] * n + (ki * w_j[..., None]).sum(2)
        m = m_next
    # [nc, B, H, L, hd] -> [B, nc, L, H, hd] -> [B, S, H*hd]
    return torch.stack(hs).movedim(0, 1).permute(0, 1, 3, 2, 4).reshape(b, s, n_heads * hd)


def mlstm_init_state(batch: int, d: int, n_heads: int, device="cuda",
                     lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    hd = 2 * d // n_heads
    return {
        "C": torch.zeros((*lead, batch, n_heads, hd, hd), device=device),
        "n": torch.zeros((*lead, batch, n_heads, hd), device=device),
        "m": torch.full((*lead, batch, n_heads), NEG, device=device),
    }


def mlstm_block_decode(p: Dict, x: torch.Tensor, state: Dict, n_heads: int
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token mLSTM update. x: [B, 1, d]."""
    b = x.shape[0]
    q, k, v, li, lf, gate_out = _mlstm_qkv_gates(p, x, n_heads)
    q, k, v = (a[:, 0].float() for a in (q, k, v))           # [B,H,hd]
    li, lf = li[:, 0], lf[:, 0]                               # [B,H]
    C, n, m = state["C"], state["n"], state["m"]
    m_t = torch.maximum(lf + m, li)
    dec = torch.exp(lf + m - m_t)[..., None]
    inp = torch.exp(li - m_t)[..., None]
    C_t = dec[..., None] * C + inp[..., None] * (k[..., :, None] * v[..., None, :])
    n_t = dec * n + inp * k
    num = torch.einsum("bhq,bhqd->bhd", q, C_t)
    den = torch.maximum(torch.einsum("bhq,bhq->bh", q, n_t).abs(), torch.exp(-m_t))
    h = (num / den[..., None]).reshape(b, 1, -1).to(x.dtype)
    return (h * gate_out) @ p["w_down"], {"C": C_t, "n": n_t, "m": m_t}


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_init(gen: torch.Generator, d: int, n_heads: int, dtype, device="cuda",
               lead: Tuple[int, ...] = ()) -> Dict:
    device = resolve_device(device)
    hd = d // n_heads
    r = torch.randn((*lead, 4, n_heads, hd, hd), generator=gen, device=device) \
        * (0.02 / math.sqrt(hd))
    bias = torch.cat([torch.zeros(2 * d), torch.full((d,), 3.0), torch.zeros(d)])
    return {
        "w_in": dense_init(gen, d, 4 * d, dtype, device, lead),   # z, i, f, o pre-activations
        "r": r.to(dtype),                                         # recurrent block-diagonal
        "w_out": dense_init(gen, d, d, dtype, device, lead),
        "b": bias.to(device).expand(*lead, 4 * d).clone(),
    }


def _slstm_step(p: Dict, n_heads: int, carry, wx_t):
    """carry: (c, n, m, h) each [B, d] (fp32); wx_t: [B, 4d] input projection."""
    c, n, m, h = carry
    b, d = c.shape
    hh = h.reshape(b, n_heads, p["r"].shape[-1])
    rec = torch.einsum("bhk,ghkl->bghl", hh, p["r"].float()).reshape(b, 4 * d)
    pre = wx_t.float() + rec + p["b"]
    z = torch.tanh(pre[:, 0:d])
    li = pre[:, d:2 * d]                                      # exp input gate (log domain)
    lf = F.logsigmoid(pre[:, 2 * d:3 * d])
    o = torch.sigmoid(pre[:, 3 * d:4 * d])
    m_t = torch.maximum(lf + m, li)
    dec = torch.exp(lf + m - m_t)
    inp = torch.exp(li - m_t)
    c_t = dec * c + inp * z
    n_t = dec * n + inp
    h_t = o * c_t / torch.maximum(n_t, torch.exp(-m_t))
    return c_t, n_t, m_t, h_t


# Steps the sLSTM loop runs when set (None: all of them); the outputs then
# repeat the last step's h. The dry run sets it: `launch.costing` to 1
# while it measures a period (the other S - 1 steps are its ``slstm_step``
# piece), `launch.dryrun` to 1 and 2 to extrapolate a long loop. A plain
# global, not a context variable: a checkpointed period's recompute runs on
# autograd's device thread.
TRACE_STEPS = None


def _slstm_scan(p: Dict, n_heads: int, carry, wx: torch.Tensor, s: int) -> torch.Tensor:
    """The recurrence over the ``s`` positions of ``wx`` -> stacked h [B, S, d].
    The positions are taken with one ``unbind``, whose backward stacks the
    steps' gradients once (indexing ``wx[:, t]`` would write a zero-filled
    [B, S, 4d] gradient at every step and sum them)."""
    steps = s if TRACE_STEPS is None else min(s, TRACE_STEPS)
    wx_t = wx.unbind(1)
    hs = []
    for t in range(steps):
        carry = _slstm_step(p, n_heads, carry, wx_t[t])
        hs.append(carry[3])
    hs.extend(hs[-1:] * (s - steps))
    return torch.stack(hs, dim=1)


def slstm_block(p: Dict, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Sequential sLSTM over [B, S, d] (true recurrence)."""
    b, s, d = x.shape
    wx = (x @ p["w_in"]).float()                              # [B, S, 4d]
    zero = torch.zeros((b, d), device=x.device)
    carry = (zero, zero, torch.full((b, d), NEG, device=x.device), zero)
    return _slstm_scan(p, n_heads, carry, wx, s).to(x.dtype) @ p["w_out"]


def slstm_heads_tp(tp, p: Dict, d: int, n_heads: int, device):
    """This rank's heads of an sLSTM layer (`TPAxis.span`) -> (``r`` and
    ``b`` of those heads, the columns of the input projection that feed
    them (their z / i / f / o channels), their channel range). The stored
    layouts do not split by head (``w_in`` 's column shards cut across its
    z / i / f / o blocks, ``r`` is sharded inside a head), so the leaves are
    taken whole (`TPAxis.whole`, their gradients summed over the ranks)."""
    lo, hi = tp.span(n_heads)
    hd = d // n_heads
    cols = torch.cat([torch.arange(g * d + lo * hd, g * d + hi * hd, device=device)
                      for g in range(4)])
    return ({"r": tp.part(p["r"], -3, lo, hi), "b": tp.whole(p["b"])[..., cols]}, cols,
            (lo * hd, hi * hd))


def slstm_block_tp(tp, p: Dict, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """`slstm_block` on one model rank (``p`` of `TPLeaf` s, ``x``
    replicated): the recurrence is per head, so each rank runs its range
    of the heads' steps (`slstm_heads_tp`; uneven where the ranks do not
    divide them, none where there are fewer heads than ranks) with no
    collective inside the time loop; ``w_out`` is row-parallel on the same
    channels and its partial sums all-reduced."""
    b, s, d = x.shape
    mine, cols, (c0, c1) = slstm_heads_tp(tp, p, d, n_heads, x.device)
    wx = (tp.copy(x) @ tp.whole(p["w_in"])[:, cols]).float()          # [B, S, 4 (c1 - c0)]
    zero = torch.zeros((b, c1 - c0), device=x.device)
    carry = (zero, zero, torch.full((b, c1 - c0), NEG, device=x.device), zero)
    return tp.reduce(_slstm_scan(mine, mine["r"].shape[-3], carry, wx, s).to(x.dtype)
                     @ tp.part(p["w_out"], -2, c0, c1))


def slstm_init_state(batch: int, d: int, device="cuda", lead: Tuple[int, ...] = ()
                     ) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    zeros = lambda: torch.zeros((*lead, batch, d), device=device)
    return {"c": zeros(), "n": zeros(), "m": torch.full((*lead, batch, d), NEG, device=device),
            "h": zeros()}


def slstm_block_decode(p: Dict, x: torch.Tensor, state: Dict, n_heads: int
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    wx = (x[:, 0] @ p["w_in"]).float()
    c, n, m, h = _slstm_step(p, n_heads, (state["c"], state["n"], state["m"], state["h"]), wx)
    return h[:, None].to(x.dtype) @ p["w_out"], {"c": c, "n": n, "m": m, "h": h}
