"""The work a layer needs, counted from its inputs, and the card's peaks.

Frozen here so that every implementation of a layer, fused or not, reads
against the same work. Counts are of what the inputs need, not of what a
kernel happens to do:

* a spiking 3x3 SAME convolution needs ``C_out`` adds for each in-bounds
  tap of each input spike: a spike at row i, column j reaches
  ``r(i) * r(j)`` output positions, r = 3 inside and 2 on a border row or
  column (Eq. 3's ``F * C_out * sum S`` with F = 9 counts the padding too);
* a spiking FC needs ``out`` adds per input spike;
* the dense input layer needs 2 * MACs flops, every tap in bounds counted;
* a spiking layer's bytes: its input and output spikes at 1 bit each and
  its weights once per launch at the configuration's precision.

Peaks: NVIDIA's data sheet for the H100 SXM at 700 W (dense rates).
"""
from __future__ import annotations

from typing import Dict

import torch

PEAKS = {
    "fp32_flops": 67e12,        # FLOP/s outside the tensor cores
    "fp32_adds": 33.5e12,       # adds/s: one add per lane-cycle, half the FMA rate in flops
    "hbm_bytes": 3.35e12,       # bytes/s
}


def border_weights(h: int, w: int, device=None) -> torch.Tensor:
    """[h, w]: how many 3x3 SAME output positions each input pixel reaches."""
    def reach(n):
        r = torch.full((n,), 3.0, device=device)
        r[0] = r[-1] = 2.0 if n > 1 else 1.0
        return r
    return reach(h)[:, None] * reach(w)[None, :]


def conv_taps(spikes: torch.Tensor) -> torch.Tensor:
    """spikes [N, C, H, W] (0/1) -> [N] in-bounds taps of every spike."""
    per_pixel = spikes.sum(dim=1)                        # [N, H, W]
    return (per_pixel * border_weights(*spikes.shape[2:], device=spikes.device)).sum(dim=(1, 2))


def conv_adds(spikes: torch.Tensor, c_out: int) -> float:
    """Adds a spiking 3x3 SAME convolution needs for ``spikes`` [N, C, H, W]."""
    return float(conv_taps(spikes).double().sum()) * c_out


def fc_adds(spikes: torch.Tensor, out: int) -> float:
    """Adds a spiking FC needs for ``spikes`` [N, D]."""
    return float(spikes.double().sum()) * out


def dense_flops(cfg: dict, images: int) -> float:
    """2 * MACs of the input convolution (once per image: direct coding)."""
    hw, cin = cfg["img_hw"], cfg["in_ch"]
    cout = [s for s in cfg["stages"] if s != "MP"][0]
    taps = float(border_weights(hw, hw).sum())           # in-bounds (pixel, tap) pairs
    return 2.0 * taps * cin * cout * images


def spike_map_bytes(entries_in: float, entries_out: float) -> float:
    """Bytes of a layer's input and output spike maps at 1 bit an entry."""
    return (entries_in + entries_out) / 8.0


def weight_bytes(fan_in: int, fan_out: int, quant_bits: int) -> float:
    return fan_in * fan_out * (quant_bits / 8.0 if quant_bits else 4.0)


def train_flops_per_image(cfg: dict) -> float:
    """Model FLOPs of one image's training step: 3x the forward's 2 * MACs
    of every convolution and FC (the input convolution once, the others T
    times), every 3x3 tap counted as SAME padding computes it."""
    hw, t = cfg["img_hw"], cfg["timesteps"]
    flops, cin, first = 0.0, cfg["in_ch"], True
    for s in cfg["stages"]:
        if s == "MP":
            hw //= 2
            continue
        macs = hw * hw * 9 * cin * s
        flops += 2.0 * macs * (1 if first else t)
        cin, first = s, False
    flat = hw * hw * cin
    flops += 2.0 * t * (flat * cfg["fc_dim"] + cfg["fc_dim"] * cfg["population"])
    return 3.0 * flops


class WorkCounter:
    """Sums a reference pass's needed work per layer, fed by the
    reference's ``on_layer(name, input_spikes, c_out)`` hook."""

    def __init__(self):
        self.adds: Dict[str, float] = {}
        self.entries_in: Dict[str, float] = {}
        self.entries_out: Dict[str, float] = {}

    def __call__(self, name: str, spikes: torch.Tensor, c_out: int) -> None:
        conv = spikes.dim() == 4
        adds = conv_adds(spikes, c_out) if conv else fc_adds(spikes, c_out)
        out = spikes.numel() // spikes.shape[1] * c_out if conv else spikes.shape[0] * c_out
        for table, value in ((self.adds, adds),
                             (self.entries_in, float(spikes.numel())),
                             (self.entries_out, float(out))):
            table[name] = table.get(name, 0.0) + value
