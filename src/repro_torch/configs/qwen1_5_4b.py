"""qwen1.5-4b [dense]: 40L d2560 20H (kv=20, MHA) d_ff 6912 vocab 151936.

[hf:Qwen/Qwen1.5-*; hf]. QKV bias (the Qwen signature), SwiGLU MLP.
20 heads do not divide the 16-way model axis — GSPMD pads; see DESIGN.md §4.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab=151936, mlp_act="swiglu", qkv_bias=True,
))
