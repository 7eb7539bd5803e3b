"""musicgen-large [audio]: 48L d2048 32H (MHA kv=32) d_ff 8192 vocab 2048.

[arXiv:2306.05284; hf]. Decoder-only over EnCodec tokens (vocab 2048 codes).
Backbone only per assignment: the EnCodec tokenizer and T5 text conditioner
are stubs — input_specs() provides 64 precomputed conditioning embeddings
(d=1024) prepended to the token sequence.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, mlp_act="gelu",
    frontend="audio", n_frontend_tokens=64, d_frontend=1024,
))
