"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H (GQA kv=8) dense d_ff 8192
vocab 202048, MoE 128 experts top-1, interleaved (every other layer MoE)
with a shared expert — 397B total / ~17B active, matching the 400b-a17b
budget. [hf:meta-llama/Llama-4-*; unverified].

Adafactor optimizer (ZeRO-1 AdamW states for 400B exceed the per-chip HBM
budget at 512 chips; see DESIGN.md §5).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048, mlp_act="swiglu",
    pattern=("attn_mlp", "attn_moe"),
    n_experts=128, top_k=1, moe_d_ff=8192, shared_expert=True,
    optimizer="adafactor", fsdp_experts=True,
))
