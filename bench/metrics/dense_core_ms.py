"""dense_core_ms.<cells> (model step, `models/vgg9.py` vgg9_infer_hybrid):
median over the window's steps of the device ms of the input layer
(``vgg9.conv0``, the dense core: kernel 3 and its spike sums), between the
pipeline's CUDA-event marks."""
from bench.harness.program import over_steps


def read(r):
    return over_steps(r, lambda step: step["device_ms"].get("vgg9.conv0"))
