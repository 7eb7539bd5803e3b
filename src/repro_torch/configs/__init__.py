"""Model configurations: the paper's spiking VGG9 (`vgg9_snn`) and the LM
architectures (`base.ArchConfig`, `get_arch(name)` / `all_archs()`).

The registry holds the JAX package's ten LM architectures, each config a
copy of the reference's, field for field.
"""
from .base import ArchConfig, ShapeConfig, SHAPES, get_arch, all_archs, shape_applicable

_LOADED = False

ARCH_MODULES = (
    "granite_34b", "starcoder2_15b", "qwen1_5_4b", "minitron_8b",
    "recurrentgemma_2b", "musicgen_large", "phi_3_vision_4_2b",
    "llama4_maverick_400b", "granite_moe_3b", "xlstm_125m",
)


def _load_all():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for m in ARCH_MODULES:
        importlib.import_module(f".{m}", __package__)
    _LOADED = True
