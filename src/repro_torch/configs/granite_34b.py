"""granite-34b [dense]: 88L d6144 48H (GQA kv=1) d_ff 24576 vocab 49152.

[arXiv:2405.04324; hf]. Code model; multi-query attention (kv=1), 4x GELU
MLP (matches the 34B parameter count; a gated MLP would land at ~46B).
RMSNorm+RoPE standardization noted in DESIGN.md.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49152, mlp_act="gelu",
))
