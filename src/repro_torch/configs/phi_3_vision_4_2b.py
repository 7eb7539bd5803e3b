"""phi-3-vision-4.2b [vlm]: 32L d3072 32H (MHA kv=32) d_ff 8192 vocab 32064.

[hf:microsoft/Phi-3-vision-128k-instruct; hf]. Phi-3-mini backbone + CLIP
image tower. Backbone only per assignment: the CLIP tower is a stub —
input_specs() provides 1024 precomputed patch embeddings (d=1024) projected
and prepended to the text tokens. SwiGLU MLP.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064, mlp_act="swiglu",
    frontend="vision", n_frontend_tokens=1024, d_frontend=1024,
))
