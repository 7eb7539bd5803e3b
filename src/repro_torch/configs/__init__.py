"""Model configurations: the paper's spiking VGG9 (`vgg9_snn`) and the LM
architectures (`base.ArchConfig`, `get_arch(name)` / `all_archs()`).

Only the architectures whose block kinds the port runs are registered:
qwen1.5-4b (``attn_mlp``). The JAX package's other nine arch configs come
with their block kinds (ROADMAP, queue 1 item 5).
"""
from .base import ArchConfig, ShapeConfig, SHAPES, get_arch, all_archs, shape_applicable

_LOADED = False

ARCH_MODULES = ("qwen1_5_4b",)


def _load_all():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for m in ARCH_MODULES:
        importlib.import_module(f".{m}", __package__)
    _LOADED = True
