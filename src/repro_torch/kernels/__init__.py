"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``kernels/<name>/csrc/*.cu`` hold the CUDA C++ (plain C interfaces, built
with nvcc for sm_90a at first use by `_build`; headers that several of them
include live in ``kernels/common/csrc/``); ``kernels/<name>/ops.py``
holds the wrapper that launches it for a CUDA tensor and the plain version
that a CPU tensor takes. ``CUDA_LAUNCHES`` counts hand-kernel launches.
"""
from ._build import CUDA_LAUNCHES, reset_cuda_launches

__all__ = ["CUDA_LAUNCHES", "reset_cuda_launches"]
