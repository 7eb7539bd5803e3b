#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (needs one NVIDIA GPU).

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line or block each:

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — nvcc builds every kernel from the sources in the checkout
             (with -Xptxas -v: registers and spills per kernel);
3. kernels — each hand kernel against its plain PyTorch version on the card,
             at every shape the CIFAR10 serving path gives it with 8 slots,
             with kernel / plain / library times (CUDA events) and the bound
             the shapes allow on an H100;
4. serve   — spiking VGG9 at full CIFAR10 width, fp32 and int4, served by
             EngineCore + SNNRunner on the card: per-request checks, launch
             counts per engine step, and the same requests on the CPU's
             plain path as the reference.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it. Every per-shape row and serving figure also goes to
``build/chip_smoke.json``. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and fp32
# (non-tensor-core) rate, the unit all three kernels compute in.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

SLOTS = 8
BETA, THETA = 0.15, 0.5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def main_path_shapes(cfg, batch):
    """Per-kernel shapes of one serving step: conv (M, K, N_real, K_real)
    for the gated matmul, (R, N) for each epilogue, (M, K, N) for the dense
    core — read off the plan the runner uses."""
    from repro_torch.core.hybrid import plan_vgg9_inference
    from repro_torch.core.tiling import round_up
    plan = plan_vgg9_inference(cfg, batch)
    mm, epi = [], []
    for lp in plan.layers:
        ks = lp.kernel
        if ks.kernel == "dense_conv_lif":
            dense = (ks.m, ks.k, ks.n)
        elif ks.kernel == "spike_conv_mapped":
            mm.append((lp.name, ks.m, round_up(ks.k, ks.block_k), ks.n, ks.k,
                       ks.block_m, ks.block_k))
            epi.append((lp.name, ks.m // cfg.timesteps, ks.n))
        else:
            epi.append((lp.name, ks.m // cfg.timesteps, ks.n))
    return dense, mm, epi


def check_spike_matmul(torch, shapes, gen):
    from repro_torch.core.tiling import round_up
    from repro_torch.kernels.spike_conv import ops as sc
    rows = []
    for name, m, k_pad, n, k, bm, bk in shapes:
        n_pad = round_up(n, 128)
        patches = torch.zeros((m, k_pad), device="cuda")
        patches[:, :k] = (torch.rand((m, k), device="cuda", generator=gen) < 0.1).float()
        patches[:bm] = 0.0                                   # an all-zero tile row
        w2d = torch.zeros((k_pad, n_pad), device="cuda")
        w2d[:k, :n] = torch.randn((k, n), device="cuda", generator=gen) * (2.0 / k) ** 0.5
        out, occ, row_occ = sc.spike_matmul_mapped(patches, w2d, block_m=bm, block_k=bk)
        ref, ref_occ, ref_row = sc.spike_matmul_mapped_plain(patches, w2d, block_m=bm,
                                                             block_k=bk)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        ok = (torch.equal(occ, ref_occ) and torch.equal(row_occ, ref_row) and err <= tol
              and occ[0].sum().item() == 0)
        occupied = int(occ.sum().item())
        nk = k_pad // bk
        moved = 4 * (m * k_pad + k_pad * n_pad + m * n_pad) + m * nk + 4 * (m // bm) * nk
        flops = 2.0 * occupied * bm * bk * n_pad
        b_ms, b_by = bound(moved, flops)
        rows.append(dict(
            shape=f"{name} M={m} K={k_pad} N={n_pad}", ok=ok, err=err, tol=tol,
            bytes=moved, flops=flops,
            skip=1 - occupied / occ.numel(),
            ms=cuda_ms(torch, lambda: sc.spike_matmul_mapped(patches, w2d, block_m=bm,
                                                             block_k=bk)),
            plain_ms=cuda_ms(torch, lambda: sc.spike_matmul_mapped_plain(
                patches, w2d, block_m=bm, block_k=bk)),
            library_ms=cuda_ms(torch, lambda: torch.matmul(patches, w2d)),
            bound_ms=b_ms, bound_by=b_by))
    return rows


def check_lif_epilogue(torch, shapes, steps, gen):
    from repro_torch.kernels.lif_step import ops as lif
    rows = []
    for name, r, n in shapes:
        cur = torch.randn((steps, r, n), device="cuda", generator=gen) * 0.6
        bias = torch.randn((n,), device="cuda", generator=gen) * 0.1
        out = lif.lif_epilogue_scan(cur, bias, beta=BETA, theta=THETA)
        ref = lif.lif_epilogue_scan_plain(cur, bias, beta=BETA, theta=THETA)
        torch.cuda.synchronize()
        moved, flops = 4 * (2 * steps * r * n + n), 5.0 * steps * r * n
        b_ms, b_by = bound(moved, flops)
        rows.append(dict(
            shape=f"{name} T={steps} R={r} N={n}", ok=torch.equal(out, ref),
            bytes=moved, flops=flops,
            err=(out - ref).abs().max().item(), tol=0.0,
            ms=cuda_ms(torch, lambda: lif.lif_epilogue_scan(cur, bias, beta=BETA,
                                                            theta=THETA)),
            plain_ms=cuda_ms(torch, lambda: lif.lif_epilogue_scan_plain(
                cur, bias, beta=BETA, theta=THETA)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return rows


def check_dense_conv_lif(torch, shape, steps, gen):
    from repro_torch.kernels.dense_conv_lif import ops as dense
    m, k, n = shape
    patches = torch.rand((m, k), device="cuda", generator=gen)
    patches[:128] = 0.0                                      # an all-zero tile row
    w2d = torch.randn((k, n), device="cuda", generator=gen) * (2.0 / k) ** 0.5
    bias = torch.randn((n,), device="cuda", generator=gen) * 0.1
    s, u = dense.dense_conv_lif(patches, w2d, bias, num_steps=steps, beta=BETA, theta=THETA)
    rs, ru = dense.dense_conv_lif_plain(patches, w2d, bias, num_steps=steps,
                                        beta=BETA, theta=THETA)
    torch.cuda.synchronize()
    err = (u - ru).abs().max().item()
    ok = err <= 1e-5
    for t in range(steps):                # spikes agree wherever u_t is clear of theta
        _, u_t = dense.dense_conv_lif_plain(patches, w2d, bias, num_steps=t + 1,
                                            beta=BETA, theta=THETA)
        clear = (u_t - THETA).abs() > 1e-5
        ok = ok and torch.equal(s[t][clear], rs[t][clear])
    moved = 4 * (m * k + k * n + n + steps * m * n + m * n)
    flops = 2.0 * m * k * n + 5.0 * steps * m * n
    b_ms, b_by = bound(moved, flops)
    return [dict(
        shape=f"conv0 M={m} K={k} N={n} T={steps}", ok=ok, err=err, tol=1e-5,
        bytes=moved, flops=flops,
        ms=cuda_ms(torch, lambda: dense.dense_conv_lif(patches, w2d, bias, num_steps=steps,
                                                       beta=BETA, theta=THETA)),
        plain_ms=cuda_ms(torch, lambda: dense.dense_conv_lif_plain(
            patches, w2d, bias, num_steps=steps, beta=BETA, theta=THETA)),
        library_ms=cuda_ms(torch, lambda: torch.matmul(patches, w2d)),
        bound_ms=b_ms, bound_by=b_by)]


# ---------------------------------------------------------------------------
# phase 4: serving on the card, held against the CPU
# ---------------------------------------------------------------------------

def make_requests(torch, cfg):
    """16 requests alternating near-silent (x0.02, even ids) and dense
    random images (the mixed trace), then one all-zero image."""
    gen = torch.Generator().manual_seed(1)
    shape = (cfg.img_hw, cfg.img_hw, cfg.in_ch)
    imgs = []
    for i in range(16):
        img = torch.rand(shape, generator=gen)
        imgs.append(img * 0.02 if i % 2 == 0 else img)
    imgs.append(torch.zeros(shape))
    return imgs


def serve(torch, cfg, params, imgs, device):
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.core import EngineCore
    from repro_torch.serve.runners.snn import SNNRunner
    core = EngineCore(SNNRunner(cfg, params, device=device), EngineConfig(slots=SLOTS))
    ids = [core.submit(img, source="sparse" if i % 2 == 0 else "dense")
           for i, img in enumerate(imgs)]
    t0 = time.perf_counter()
    results = core.run_until_complete()
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return core, [results[i] for i in ids], seconds


def layer_totals(results):
    layers = results[0].stats["out_spikes"].keys()
    return {k: sum(r.stats["out_spikes"][k] for r in results) for k in layers}


def check_serving(torch, name, cfg, params_cpu, errors):
    import numpy as np
    from repro_torch.kernels import CUDA_LAUNCHES, reset_cuda_launches
    from repro_torch.models.vgg9 import vgg9_infer_hybrid

    params = {k: {kk: v.to("cuda") for kk, v in leaf.items()} for k, leaf in params_cpu.items()}
    imgs = make_requests(torch, cfg)
    serve(torch, cfg, params, imgs[:SLOTS], "cuda")           # warm-up

    reset_cuda_launches()
    core, res, seconds = serve(torch, cfg, params, imgs, "cuda")
    launches = dict(CUDA_LAUNCHES)
    steps = core.stats()["steps_run"]
    n_spiking = len(cfg.conv_channels) - 1
    want = {"dense_conv_lif": steps, "spike_matmul_mapped": n_spiking * steps,
            "lif_epilogue_scan": (n_spiking + 2) * steps}
    if launches != want:
        errors.append(f"{name}: CUDA_LAUNCHES {launches} != {want} over {steps} steps")

    for r in res:
        if r.status != "ok" or r.outputs is None or r.outputs.shape != (cfg.num_classes,) \
                or not np.isfinite(r.outputs).all():
            errors.append(f"{name}: request {r.request_id} status={r.status} "
                          f"outputs={r.outputs}")
    zero = res[-1]
    if zero.stats["spike_total"] != 0.0 or any(v != 1.0 for v in zero.stats["skip_rate"].values()):
        errors.append(f"{name}: zero image spikes={zero.stats['spike_total']} "
                      f"skip={zero.stats['skip_rate']}")

    # per-request out_spikes against each engine batch's layer totals
    by_id = {r.request_id: r for r in res}
    for _, ids in core.admission_log:
        batch = [imgs[i] for i in ids] + [torch.zeros_like(imgs[0])] * (SLOTS - len(ids))
        _, counts = vgg9_infer_hybrid(params, torch.stack(batch), cfg, device="cuda")
        for layer, total in counts.items():
            split = sum(by_id[i].stats["out_spikes"][layer] for i in ids)
            if split != float(total):
                errors.append(f"{name}: batch {ids} layer {layer}: per-request "
                              f"out_spikes sum {split} != layer total {float(total)}")

    t0 = time.perf_counter()
    _, cpu_res, _ = serve(torch, cfg, params_cpu, imgs, "cpu")
    cpu_seconds = time.perf_counter() - t0
    d_logits = max(float(np.abs(a.outputs - b.outputs).max()) for a, b in zip(res, cpu_res))
    gpu_tot, cpu_tot = layer_totals(res), layer_totals(cpu_res)
    d_spikes = {k: abs(gpu_tot[k] - cpu_tot[k]) / max(cpu_tot[k], 1.0) for k in gpu_tot}
    d_skip = max(abs(a.stats["batch_skip_rate"][k] - b.stats["batch_skip_rate"][k])
                 for a, b in zip(res, cpu_res) for k in a.stats["batch_skip_rate"])
    if d_logits > 0.02 or max(d_spikes.values()) > 1e-3 or d_skip > 0.01:
        errors.append(f"{name}: card vs CPU logits {d_logits} spikes {d_spikes} skip {d_skip}")
    print(f"serve {name}: {len(res)} requests, {steps} engine steps, "
          f"host {seconds / steps * 1e3:.3f} ms/step on the card "
          f"(CPU plain path {cpu_seconds / steps * 1e3:.1f} ms/step); "
          f"launches {launches}")
    print(f"serve {name}: card vs CPU max|dlogits|={d_logits} "
          f"max rel dspikes={max(d_spikes.values()):.3e} max|dskip|={d_skip:.3e}")
    skip = {k: float(np.mean([r.stats["batch_skip_rate"][k] for r in res]))
            for k in res[0].stats["batch_skip_rate"]}
    return {"totals": gpu_tot, "skip": skip, "ms_per_step": seconds / steps * 1e3,
            "launches": launches}


def profile_serving(torch, name, cfg, params_cpu, step_ms):
    """Where a serving step's time goes. ``step_ms`` is the unprofiled host
    time per engine step; against it: the host time of the pipeline alone
    (`vgg9_infer_hybrid` with stats on 8 slots, synchronized), and the
    device's kernel time per step from one engine run under torch.profiler
    (kernel events only, so no time is counted twice)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.vgg9 import vgg9_infer_hybrid
    params = {k: {kk: v.to("cuda") for kk, v in leaf.items()} for k, leaf in params_cpu.items()}
    imgs = make_requests(torch, cfg)
    batch = torch.stack(imgs[:SLOTS]).to("cuda")
    for _ in range(2):                                        # warm-up
        vgg9_infer_hybrid(params, batch, cfg, device="cuda", return_stats=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        vgg9_infer_hybrid(params, batch, cfg, device="cuda", return_stats=True)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3 / 5

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        core, _, _ = serve(torch, cfg, params, imgs, "cuda")
    steps = core.stats()["steps_run"]
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
           for e in kernels]
    print(f"profile {name}: step {step_ms:.3f} ms = pipeline forward {forward_ms:.3f} ms "
          f"+ runner/engine host work {step_ms - forward_ms:.3f} ms; device busy "
          f"{busy_ms:.3f} ms/step ({100 * busy_ms / step_ms:.1f}% of the step, idle "
          f"{100 - 100 * busy_ms / step_ms:.1f}%)")
    print(f"profile {name}: top device ms/step (launches/step): "
          + ", ".join(f"{k[:40]} {ms:.3f} ({n})" for k, ms, n in top[:8]))
    return {"step_ms": step_ms, "forward_ms": forward_ms, "busy_ms_per_step": busy_ms,
            "top": top[:16]}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"no src/repro_torch beside {os.path.basename(__file__)}: run from a checkout")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (sets the TF32 flags)
    from repro_torch.configs import vgg9_snn
    from repro_torch.kernels import _build
    from repro_torch.models.vgg9 import init_vgg9

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi unavailable (rc {smi.returncode})"
    print(f"phase 1 device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s)")
    print(f"nvidia-smi: {smi_line}")

    # 2. build
    try:
        built = _build.build(force=True, ptxas_verbose=True)
    except RuntimeError as exc:
        fail(f"build: {exc}")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line \
                or line.startswith("=="):
            print(f"  {line.strip()}")
    print(f"phase 2 build: {len(_build.sources())} sources -> {built['path'].name} "
          f"in {built['seconds']:.1f} s")

    # 3. kernels
    cfg = vgg9_snn.CIFAR10
    gen = torch.Generator(device="cuda").manual_seed(0)
    dense_shape, mm_shapes, epi_shapes = main_path_shapes(cfg, SLOTS)
    table = {
        "spike_matmul_mapped": check_spike_matmul(torch, mm_shapes, gen),
        "lif_epilogue_scan": check_lif_epilogue(torch, epi_shapes, cfg.timesteps, gen),
        "dense_conv_lif": check_dense_conv_lif(torch, dense_shape, cfg.timesteps, gen),
    }
    failed = []
    for kname, rows in table.items():
        for r in rows:
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            extra = f" skip={r['skip']:.4f}" if "skip" in r else ""
            print(f"  {kname} {r['shape']}: ok={r['ok']} err={r['err']:.3e} "
                  f"(tol {r['tol']:.1e}){extra} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={lib} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}: "
                  f"{r['bytes']:.0f} bytes, {r['flops']:.0f} flops)")
            if not r["ok"]:
                failed.append(f"{kname} {r['shape']}")
    print(f"phase 3 kernels: {sum(len(r) for r in table.values())} shapes, "
          f"{len(failed)} failed")
    if failed:
        fail(f"kernels disagree with their plain versions: {failed}")

    # 4. serve
    errors: list = []
    served = {}
    for name, scfg in (("CIFAR10", vgg9_snn.CIFAR10), ("CIFAR10_INT4", vgg9_snn.CIFAR10_INT4)):
        params = init_vgg9(torch.Generator().manual_seed(0), scfg, "cpu")
        served[name] = check_serving(torch, name, scfg, params, errors)
        served[name]["profile"] = profile_serving(torch, name, scfg, params,
                                                  served[name]["ms_per_step"])
    for layer in served["CIFAR10"]["totals"]:
        fp, q = served["CIFAR10"], served["CIFAR10_INT4"]
        skip = (f" batch skip fp32 {fp['skip'][layer]:.4f} int4 {q['skip'][layer]:.4f}"
                if layer in fp["skip"] else "")
        print(f"  {layer}: spikes fp32 {fp['totals'][layer]:.0f} "
              f"int4 {q['totals'][layer]:.0f}{skip}")
    print(f"phase 4 serve: {len(errors)} errors")
    if errors:
        fail("; ".join(errors))

    sources = {"spike_matmul_mapped": "src/repro_torch/kernels/spike_conv/csrc/spike_matmul_mapped.cu",
               "lif_epilogue_scan": "src/repro_torch/kernels/lif_step/csrc/lif_epilogue_scan.cu",
               "dense_conv_lif": "src/repro_torch/kernels/dense_conv_lif/csrc/dense_conv_lif.cu"}
    replaces = {"spike_matmul_mapped": "src/repro/kernels/spike_conv/spike_conv.py:119",
                "lif_epilogue_scan": "src/repro/kernels/lif_step/lif_step.py:72",
                "dense_conv_lif": "src/repro/kernels/dense_conv_lif/dense_conv_lif.py:40"}
    kernels = []
    for kname, rows in table.items():
        b_total = sum(r["bound_ms"] for r in rows)
        by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        lib = [r["library_ms"] for r in rows]
        kernels.append({
            "name": kname, "route": "cuda", "source": sources[kname],
            "replaces": replaces[kname],
            "launches": sum(s["launches"][kname] for s in served.values()),
            "max_abs_err": max(r["err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": b_total,
            "bound_by": "operations" if by_ops * 2 > b_total else "bytes",
            "library_ms": None if any(v is None for v in lib) else sum(lib),
            "shapes": len(rows), "ok": all(r["ok"] for r in rows)})
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi_line, "kernels": table,
                   "serve": served}, f, indent=1, default=str)
    if any(math.isnan(k["ms"]) for k in kernels):
        fail("a kernel time is NaN")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
