"""minitron-8b [dense]: 32L d4096 32H (GQA kv=8) d_ff 16384 vocab 256000.

[arXiv:2407.14679; hf]. Pruned Nemotron: squared-ReLU MLP (ungated),
large vocab (sentencepiece 256k).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=256000, mlp_act="relu2",
))
