"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1) d_ff 7680 vocab 256000.

[arXiv:2402.19427; hf]. Griffin: RG-LRU recurrent blocks + local attention
(window 2048), pattern (rglru, rglru, local_attn) x 8 with a 2-recurrent-layer
tail (26 = 3*8 + 2). GeGLU MLP. Sub-quadratic => runs long_500k.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, mlp_act="geglu",
    pattern=("rglru", "rglru", "local_attn"), tail=("rglru", "rglru"),
    window=2048, d_rnn=2560, conv_width=4,
    tie_embeddings=True, supports_long=True,
))
