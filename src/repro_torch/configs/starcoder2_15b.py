"""starcoder2-15b [dense]: 40L d6144 48H (GQA kv=4) d_ff 24576 vocab 49152.

[arXiv:2402.19173; hf]. GQA + RoPE, GELU MLP, linear biases on QKV.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab=49152, mlp_act="gelu", qkv_bias=True,
))
