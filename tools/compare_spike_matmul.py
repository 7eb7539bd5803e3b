#!/usr/bin/env python3
"""Time the unfused pipeline's spike matmul of several checkouts, in turns.

    python3 tools/compare_spike_matmul.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (for a comparison,
list them as parent, change, change, parent). For each one in turn, in a
process of its own so that each imports its own `repro_torch`, it builds
that checkout's kernels and times its `spike_matmul` with this checkout's
`chip_smoke.py` helpers (its shapes, operands and CUDA-event timing) at
the unfused pipeline's six per-timestep shapes and `chip_smoke.DENSITIES`,
on the same seeded operands. It prints one JSON line per root with the
per-shape and summed times and a digest of the outputs, and exits non-zero
if the digests differ between roots (the kernel's sum order is fixed, so
every version must give the same bits) or if there is no CUDA device.
Needs one NVIDIA GPU.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sys.path[:0] = [os.path.join(os.path.abspath(root), "src"), REPO]
    import chip_smoke as cs
    from repro_torch.configs import vgg9_snn
    from repro_torch.kernels.spike_conv import ops as sc

    digest = hashlib.sha256()
    times = {}
    for d_i, density in enumerate(cs.DENSITIES):
        row = []
        for s_i, shape in enumerate(cs.unfused_shapes(vgg9_snn.CIFAR10, cs.SLOTS)[0]):
            gen = torch.Generator(device="cuda").manual_seed(100 * d_i + s_i)
            patches, w2d = cs.served_gated_operands(torch, shape, gen, density)
            digest.update(sc.spike_matmul(patches, w2d).cpu().numpy().tobytes())
            row.append(cs.cuda_ms(torch, lambda: sc.spike_matmul(patches, w2d)))
        times[str(density)] = row
    return {"root": root, "device": torch.cuda.get_device_name(0), "ms": times,
            "sum_ms": {d: sum(v) for d, v in times.items()}, "digest": digest.hexdigest()}


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1])))
        return 0
    if not argv:
        print(__doc__)
        return 2
    results = []
    for root in argv:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(f"FAIL: {root}: {out.stderr.strip()[-2000:]}", flush=True)
            return 1
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    digests = {r["digest"] for r in results}
    print(f"outputs bit-identical across roots: {len(digests) == 1}")
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
