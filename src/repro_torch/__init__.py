"""PyTorch/CUDA port of the hybrid dense/sparse spiking-VGG9 serving system.

The JAX package `repro` is the reference; this package mirrors its layout
and names module by module, imports only torch and numpy, and runs its
kernels as hand-written CUDA C++ for Hopper (sm_90a). A tensor's device
picks the path: a CPU tensor goes to each kernel's plain PyTorch version, a
CUDA tensor to the hand kernel (or the wrapper raises).

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``;
asking for the card when there is none raises.
"""
import os

# cuBLAS reads its workspace setting once, when the first handle is made; a
# fixed one is what keeps its GEMMs run-to-run deterministic, which the
# training step asks for (`train.train_step.deterministic`). Set here, before
# anything of this package can touch the card; a value the caller set wins.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

# Full fp32 products everywhere. The serving pipeline thresholds membrane
# potentials at theta, and spike counts must match the reference as
# integers: TF32 keeps ~10 mantissa bits, which moves currents across theta
# and flips spikes. (Matmuls already default to fp32; cuDNN convolutions do
# not, and neither must ever change under the port.)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
