"""granite-moe-3b-a800m [moe]: 32L d1536 24H (GQA kv=8) vocab 49155 (padded
to 49408 = 16*3088 so the vocab dim shards; MaxText-style padding),
MoE 40 experts top-8 with expert d_ff 512, every layer MoE.

[hf:ibm-granite/granite-3.0-*; hf]. 40 experts do not divide the 16-way
model axis — expert GEMMs fall back to TP over the hidden dim (DESIGN.md §4).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49408, mlp_act="swiglu",
    pattern=("attn_moe",),
    n_experts=40, top_k=8, moe_d_ff=512, n_experts_padded=48,
))
