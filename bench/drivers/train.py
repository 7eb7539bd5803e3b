"""Training: the port's `make_train_step` over `vgg9_loss`, steps back to
back (`bench/harness/training.py`)."""
from bench.harness import training

MIX_KEYS = training.MIX_KEYS
run = training.run
