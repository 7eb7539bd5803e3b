"""Config system: architecture configs + input-shape registry.

Every assigned architecture is an `ArchConfig`; shapes are the four assigned
input-shape cells. Configs are plain frozen dataclasses, hashable and
independent of any device. A copy of the JAX package's configs/base.py,
kept so the port stands alone; the fields that steer TPU lowering
(`unroll_chunks`, `sp_blocks`, ...) are carried so the two packages share
one config, and the port ignores them. `remat` it honours: "full"
checkpoints each period in training (`models.transformer.forward`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_act: str = "swiglu"          # swiglu | gelu | relu2
    pattern: Tuple[str, ...] = ("attn_mlp",)   # block kinds per scanned period
    tail: Tuple[str, ...] = ()       # unscanned leftover layers (pattern remainder)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    n_experts_padded: int = 0        # pad experts so EP shards the 16-way axis
                                     # (padded experts are router-masked to -inf)
    fsdp_experts: bool = False       # store expert weights sharded over 'data'
                                     # too (FSDP), gathered per layer at use
    # Recurrent / local attention
    window: int = 0                  # sliding-window size for 'local_attn' blocks
    d_rnn: int = 0
    conv_width: int = 4
    # Positional / numerics
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: str = ""               # '' | 'vision' | 'audio' (stub frontends)
    n_frontend_tokens: int = 0       # patches/frames prepended to the sequence
    d_frontend: int = 0              # stub embedding dim before projection
    # Execution
    dtype: str = "bfloat16"
    q_chunk: int = 512
    kv_chunk: int = 2048
    mlstm_chunk: int = 256
    unroll_chunks: bool = False      # dry-run cost lowering (EXPERIMENTS.md)
    attn_f32_streams: bool = False   # True = pre-optimization baseline (§Perf)
    sp_blocks: bool = True           # Megatron-SP: seq-shard every block output
                                     # (turns activation all-reduces into RS+AG)
    grad_dtype: str = ""             # e.g. "bfloat16": cast grads before the
                                     # cross-replica reduce (halves AR wire bytes)
    remat: str = "full"              # none | full  (activation checkpointing per period)
    optimizer: str = "adamw"         # adamw | adafactor
    supports_long: bool = False      # sub-quadratic -> long_500k cell runs

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        body = self.n_layers - len(self.tail)
        assert body % len(self.pattern) == 0, (self.name, body, self.pattern)
        return body // len(self.pattern)

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    from . import _load_all  # late import: populate registry
    _load_all()
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchConfig]:
    from . import _load_all
    _load_all()
    return dict(_REGISTRY)


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is this (arch x shape) cell runnable? Returns (ok, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.supports_long:
        return False, "full quadratic attention; 512k decode skipped per DESIGN.md §4"
    return True, ""
