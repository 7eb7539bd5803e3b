"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The JAX package's models/rglru.py in PyTorch. The RG-LRU is a gated leaky
integrator:

    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
    a_t = a ** (c * r_t)         (a = sigmoid(Lambda), c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

i.e. the paper's LIF Eq. 1 without threshold/reset, with learned
per-channel, per-step decay. Prefill runs a log-depth prefix scan over
(a, b) pairs (the reference uses `lax.associative_scan`; the two round
differently, within 1e-4 on values of order one); decode is the O(1)
recurrent update. The block follows Griffin: two branches (conv1d ->
RG-LRU) x (linear -> GeLU), multiplied, then projected back to d_model.
`rglru_block_tp` runs it on one model rank of a tensor-parallel mesh.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..device import resolve_device
from .layers import _gelu, dense_init

_C = 8.0


def rglru_init(gen: torch.Generator, d: int, d_rnn: int, conv_width: int, dtype,
               device="cuda", lead: Tuple[int, ...] = ()) -> Dict:
    device = resolve_device(device)
    conv = torch.randn((*lead, conv_width, d_rnn), generator=gen, device=device) * 0.02
    lam = torch.linspace(0.9, 0.999, d_rnn, device=device)
    return {
        "w_x": dense_init(gen, d, d_rnn, dtype, device, lead),      # recurrent branch in-proj
        "w_y": dense_init(gen, d, d_rnn, dtype, device, lead),      # gate branch in-proj
        "w_out": dense_init(gen, d_rnn, d, dtype, device, lead),
        "w_conv": conv.to(dtype),
        "w_a": dense_init(gen, d_rnn, d_rnn, dtype, device, lead),  # recurrence gate
        "w_i": dense_init(gen, d_rnn, d_rnn, dtype, device, lead),  # input gate
        "lam": lam.expand(*lead, d_rnn).clone(),                    # direct decay
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, C], w [W, C] depthwise causal conv."""
    width, s = w.shape[0], x.shape[1]
    pad = torch.cat([x.new_zeros((x.shape[0], width - 1, x.shape[2])), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + s, :] * w[i][None, None, :]
    return out


def _gates(p: Dict, u: torch.Tensor, u_in: torch.Tensor = None):
    """(a, b) of the recurrence; ``u_in`` (default ``u``) feeds the gate
    projections, which on a model rank read every channel while ``u``
    holds this rank's."""
    u_in = u if u_in is None else u_in
    r = torch.sigmoid(u_in @ p["w_a"])
    i = torch.sigmoid(u_in @ p["w_i"])
    a0 = torch.clamp(p["lam"], 1e-4, 1 - 1e-4).float()
    log_a = _C * r.float() * torch.log(a0)                     # [B, S, d_rnn]
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * u).float()
    return a, b


def rglru_scan(p: Dict, u: torch.Tensor) -> torch.Tensor:
    """Prefix scan of h_t = a_t h_{t-1} + b_t over the sequence, from
    h = 0 (Hillis-Steele: log2(S) doubling steps). u: [B, S, d_rnn]."""
    return _scan(*_gates(p, u)).to(u.dtype)


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s, step = a.shape[1], 1
    while step < s:
        # (a1, b1) then (a2, b2) composes to (a1 a2, a2 b1 + b2)
        a_prev, b_prev = a[:, :-step], b[:, :-step]
        b = torch.cat([b[:, :step], a[:, step:] * b_prev + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a_prev], dim=1)
        step *= 2
    return b


def rglru_block(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Full Griffin recurrent block over [B, S, d] (pre-normed input)."""
    u = _causal_conv1d(x @ p["w_x"], p["w_conv"])
    h = rglru_scan(p, u)
    gate = _gelu(x @ p["w_y"])
    return (h * gate) @ p["w_out"]


def rglru_block_tp(tp, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """`rglru_block` on one model rank (``p`` of `TPLeaf` s, ``x``
    replicated): the d_rnn channels split over the ranks (`TPAxis.span`,
    uneven where the ranks do not divide them: ``w_x``, ``w_y``,
    ``w_conv``, ``lam`` and the gates' columns), the conv and the scan per
    channel on this rank's, the gate projections reading every channel
    (gathered), ``w_out`` row-parallel and its partial sums all-reduced."""
    d_rnn = tp.extent(p["w_out"], -2)
    lo, hi = tp.span(d_rnn)
    local = {k: tp.part(v, -2 if k == "w_out" else -1, lo, hi) for k, v in p.items()}
    xc = tp.copy(x)
    u = _causal_conv1d(xc @ local["w_x"], local["w_conv"])
    h = _scan(*_gates(local, u, tp.gather(u, -1, partial=True, n=d_rnn))).to(u.dtype)
    gate = _gelu(xc @ local["w_y"])
    return tp.reduce((h * gate) @ local["w_out"])


# ---------------------------------------------------------------------------
# Decode path: O(1) state update per token
# ---------------------------------------------------------------------------

def rglru_init_state(batch: int, d_rnn: int, conv_width: int, dtype, device="cuda",
                     lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    return {
        "h": torch.zeros((*lead, batch, d_rnn), dtype=torch.float32, device=device),
        # trailing inputs of the causal conv
        "conv": torch.zeros((*lead, batch, conv_width - 1, d_rnn), dtype=dtype, device=device),
    }


def rglru_block_decode(p: Dict, x: torch.Tensor, state: Dict
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, 1, d]; returns ([B, 1, d], new state). ``state`` is not
    written; the caller stores the new state (`transformer._decode_block`)."""
    u = x @ p["w_x"]                                          # [B, 1, d_rnn]
    hist = torch.cat([state["conv"], u], dim=1)               # [B, W, d_rnn]
    u_conv = torch.einsum("bwc,wc->bc", hist.float(), p["w_conv"].float())[:, None, :]
    a, b = _gates(p, u_conv.to(x.dtype))
    h = a[:, 0] * state["h"] + b[:, 0]
    gate = _gelu(x @ p["w_y"])
    out = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return out, {"h": h, "conv": hist[:, 1:]}
