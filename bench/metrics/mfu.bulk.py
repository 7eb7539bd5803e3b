"""mfu.bulk (model step, `models/vgg9.py` vgg9_infer_hybrid): the least time
the traced steps' real images need, over the traced window's seconds, in %.
Per image: the input layer's 2 * MACs at 67 TFLOP/s, and the spiking
convolutions' and FCs' needed adds (counted on the reference's own spike
maps, `counts.WorkCounter`) at 33.5 T adds/s."""
from bench.harness.counts import PEAKS, dense_flops


def read(r):
    if r.trace is None or not r.work or not r.traced_images:
        return None
    least = (dense_flops(r.config, r.traced_images) / PEAKS["fp32_flops"]
             + sum(r.work["adds"].values()) / PEAKS["fp32_adds"])
    return 100.0 * least / r.trace.window_s
