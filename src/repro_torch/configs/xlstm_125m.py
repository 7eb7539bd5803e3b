"""xlstm-125m [ssm]: 12L d768 4H vocab 50304, alternating mLSTM/sLSTM blocks
(d_ff=0: no MLPs). [arXiv:2405.04517; unverified].

Pure recurrence => O(1)-state decode, runs long_500k.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab=50304, mlp_act="gelu",
    pattern=("mlstm", "slstm"),
    tie_embeddings=True, supports_long=True,
))
