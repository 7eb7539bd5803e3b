"""k1_roofline.<cells> (kernels: `kernels/spike_conv`, spike_matmul_mapped):
kernel 1's least time over its summed device time in the traced steps, in %.

The least time is the larger of the spiking convolutions' needed adds (C_out
per in-bounds tap of each input spike, on the reference's spike maps) at
33.5 T adds/s and their needed bytes at 3.35 TB/s: input and output spike
maps at 1 bit an entry, each layer's weights once per launch at the
configuration's precision. Kernel 1's device time is that of the
``__global__`` functions its source, ``spike_matmul_mapped.cu``, defines.
"""
import re

from bench.harness.counts import PEAKS, spike_map_bytes, weight_bytes

KERNEL = "spike_matmul_mapped"


def kernel_functions(kernel: str = KERNEL):
    from repro_torch.kernels import _build
    source = {p.stem: p for p in _build.sources()}[kernel].read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)"
                      r"\s*)?(\w+)\s*\(", source)


def read(r):
    if r.trace is None or not r.work or not r.traced_launches:
        return None
    convs = [s for s in r.config["stages"] if s != "MP"]
    layers = [k for k in r.work["adds"] if k.startswith("conv")]
    adds = sum(r.work["adds"][k] for k in layers)
    weights = sum(weight_bytes(9 * cin, cout, r.config.get("quant_bits", 0))
                  for cin, cout in zip(convs[:-1], convs[1:]))
    nbytes = (sum(spike_map_bytes(r.work["entries_in"][k], r.work["entries_out"][k])
                  for k in layers) + r.traced_launches * weights)
    least = max(adds / PEAKS["fp32_adds"], nbytes / PEAKS["hbm_bytes"])
    seconds = r.trace.seconds_of(kernel_functions())
    return 100.0 * least / seconds if seconds > 0 else None
