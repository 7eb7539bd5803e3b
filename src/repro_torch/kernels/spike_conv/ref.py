"""im2col for the spiking convolution, in the reference's column order."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def im2col(spikes: torch.Tensor, kh: int, kw: int, padding: str = "SAME") -> torch.Tensor:
    """[B, H, W, C] (NHWC) -> [B*OH*OW, KH*KW*C] patches.

    Columns run taps first (dy, dx), then channels, as the JAX package's
    im2col orders them. `F.unfold` orders channels first, which would move
    every occupancy tile boundary and change occ_map / row_occ / skip_rate.
    """
    b, h, w, c = spikes.shape
    if padding == "SAME":
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        x = F.pad(spikes, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
        oh, ow = h, w
    elif padding == "VALID":
        x = spikes
        oh, ow = h - kh + 1, w - kw + 1
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    taps = [x[:, dy:dy + oh, dx:dx + ow, :] for dy in range(kh) for dx in range(kw)]
    # [B, OH, OW, KH*KW, C] -> [B*OH*OW, KH*KW*C]
    return torch.stack(taps, dim=3).reshape(b * oh * ow, kh * kw * c)
