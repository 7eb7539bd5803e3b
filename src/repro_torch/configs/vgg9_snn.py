"""The paper's own model configs: spiking VGG9 for CIFAR10/CIFAR100/SVHN.

Population sizes and LIF hyperparameters follow §V-A: P=1000 (CIFAR10/SVHN),
P=5000 (CIFAR100), beta=0.15, theta=0.5, T=2 direct coding (the paper's
best operating point), T=25 for the rate-coding comparison. The same
values as the JAX package's configs.

The published LW core allocations (Fig. 4) are kept for the energy-model
benchmarks.
"""
import dataclasses

from ..models.vgg9 import VGG9Config

CIFAR10 = VGG9Config(num_classes=10, population=1000)
CIFAR100 = VGG9Config(num_classes=100, population=5000)
SVHN = VGG9Config(num_classes=10, population=1000)

CIFAR10_INT4 = VGG9Config(num_classes=10, population=1000, quant_bits=4)
CIFAR100_INT4 = VGG9Config(num_classes=100, population=5000, quant_bits=4)
SVHN_INT4 = VGG9Config(num_classes=10, population=1000, quant_bits=4)

RATE_CIFAR10 = VGG9Config(num_classes=10, population=1000, coding="rate",
                          timesteps=25, quant_bits=4)

# Reduced config for CPU smoke tests: same family, tiny dims.
TINY = VGG9Config(
    num_classes=4, population=64, timesteps=2, img_hw=16,
    stages=(8, 12, "MP", 16, 16, "MP"), fc_dim=32,
)
TINY_INT4 = dataclasses.replace(TINY, quant_bits=4)

# Paper Fig. 4 lightweight NC allocations (9 entries: dense core + 7 sparse
# conv layers + FC), used by the energy benchmarks.
LW_ALLOCATIONS = {
    "svhn": (1, 7, 1, 8, 2, 4, 14, 1, 2),
    "cifar10": (1, 8, 4, 18, 6, 6, 20, 2, 1),
    "cifar100": (1, 7, 3, 12, 4, 18, 16, 4, 1),
}
PERF2_CIFAR100 = (1, 28, 12, 54, 16, 72, 70, 19, 4)  # Table I configuration
