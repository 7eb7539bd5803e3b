"""Plain oracle for the fused flash-attention kernel."""
from __future__ import annotations

import torch


def causal_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q/k/v [BH, S, hd] -> [BH, S, hd]: masked softmax attention in fp32,
    cast to q's dtype."""
    s, hd = q.shape[1], q.shape[2]
    scores = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) / (hd ** 0.5)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkh->bqh", w, v.float()).to(q.dtype)
