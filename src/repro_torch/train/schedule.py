"""Learning-rate schedules (pure functions of the step counter), in float32."""
from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warmup to ``base_lr``, then cosine decay to ``min_ratio * base_lr``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant(base_lr: float):
    return lambda step: torch.full((), base_lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)
