"""sparse_core_ms.<cells> (model step, `models/vgg9.py` vgg9_infer_hybrid):
median over the window's steps of the device ms of the spiking convolutions
(``vgg9.conv1`` on, the sparse cores: im2col, kernel 1, kernel 2, the
pools), summed, between the pipeline's CUDA-event marks."""
import re

from bench.harness.program import over_steps

SPARSE_CORE = re.compile(r"^vgg9\.conv[1-9][0-9]*$")   # every spiking conv after the input layer


def _sparse_ms(step):
    layers = [ms for name, ms in step["device_ms"].items() if SPARSE_CORE.match(name)]
    return sum(layers) if layers else None


def read(r):
    return over_steps(r, _sparse_ms)
