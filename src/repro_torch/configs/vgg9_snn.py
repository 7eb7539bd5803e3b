"""The paper's own model configs: spiking VGG9 for CIFAR10/CIFAR100/SVHN.

Population sizes and LIF hyperparameters follow §V-A: P=1000 (CIFAR10/SVHN),
P=5000 (CIFAR100), beta=0.15, theta=0.5, T=2 direct coding (the paper's
best operating point). The same values as the JAX package's configs.
"""
import dataclasses

from ..models.vgg9 import VGG9Config

CIFAR10 = VGG9Config(num_classes=10, population=1000)
CIFAR100 = VGG9Config(num_classes=100, population=5000)
SVHN = VGG9Config(num_classes=10, population=1000)

CIFAR10_INT4 = VGG9Config(num_classes=10, population=1000, quant_bits=4)
CIFAR100_INT4 = VGG9Config(num_classes=100, population=5000, quant_bits=4)
SVHN_INT4 = VGG9Config(num_classes=10, population=1000, quant_bits=4)

# Reduced config for CPU smoke tests: same family, tiny dims.
TINY = VGG9Config(
    num_classes=4, population=64, timesteps=2, img_hw=16,
    stages=(8, 12, "MP", 16, 16, "MP"), fc_dim=32,
)
TINY_INT4 = dataclasses.replace(TINY, quant_bits=4)
