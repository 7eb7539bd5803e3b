"""Layer-wise sparsity instrumentation (paper Fig. 1, Eq. 3 inputs).

Spike counts per layer drive (a) the quantization-sparsity study, (b) the
workload model used for core allocation, and (c) the energy model. A forward
pass can gather them in a `SpikeStats`, and `SpikeStats.cross_replica_sum`
adds them up across the ranks of a data-parallel process group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class SpikeStats:
    """Per-layer spike counts and element counts for one forward pass."""

    counts: Dict[str, torch.Tensor]  # layer name -> total spikes (0-d float32)
    sizes: Dict[str, torch.Tensor]   # layer name -> total elements (0-d float32)

    @staticmethod
    def empty() -> "SpikeStats":
        return SpikeStats({}, {})

    def record(self, name: str, spikes: torch.Tensor) -> "SpikeStats":
        counts = dict(self.counts)
        sizes = dict(self.sizes)
        counts[name] = (spikes != 0).sum().to(torch.float32)
        sizes[name] = torch.tensor(float(spikes.numel()), dtype=torch.float32,
                                   device=spikes.device)
        return SpikeStats(counts, sizes)

    def total_spikes(self) -> torch.Tensor:
        if not self.counts:
            return torch.tensor(0.0)
        return sum(self.counts.values())

    def layer_sparsity(self) -> Dict[str, torch.Tensor]:
        return {k: 1.0 - self.counts[k] / self.sizes[k] for k in self.counts}

    def cross_replica_sum(self, group=None) -> "SpikeStats":
        """Every field summed over ``group``'s ranks (``all_reduce(SUM)``;
        None: the default group), as the reference's ``psum`` over its data
        axes. Counts are whole numbers, so the float32 sums are exact below
        2**24 spikes per layer. This rank's stats are left as they were."""
        import torch.distributed as dist

        def summed(tree):
            out = {}
            for k in sorted(tree):
                out[k] = tree[k].clone()
                dist.all_reduce(out[k], op=dist.ReduceOp.SUM, group=group)
            return out
        return SpikeStats(summed(self.counts), summed(self.sizes))


def tile_occupancy(spikes: torch.Tensor, tile: int = 128) -> torch.Tensor:
    """Fraction of `tile`-wide blocks (last axis) containing >=1 spike: how
    much work a tile-gated spike kernel can skip."""
    flat = spikes.reshape(-1, spikes.shape[-1])
    pad = (-flat.shape[-1]) % tile
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(flat.shape[0], -1, tile)
    return (blocks != 0).any(dim=-1).to(torch.float32).mean()
