"""mfu.train (model step, `models/vgg9.py` vgg9_loss): model FLOPs of the
images trained in the traced run's window over the window's seconds, as a
share of 67 TFLOP/s (fp32 outside the tensor cores). Model FLOPs are 3x the
forward's 2 * MACs of every convolution and FC (`counts.train_flops_per_image`)."""
from bench.harness.counts import PEAKS, train_flops_per_image


def read(r):
    if r.window_s <= 0 or not r.done_in_window:
        return None
    flops = train_flops_per_image(r.config) * r.done_in_window
    return 100.0 * flops / (r.window_s * PEAKS["fp32_flops"])
