#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (needs one NVIDIA GPU).

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line or block each:

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — nvcc builds every kernel from the sources in the checkout
             (with -Xptxas -v: registers and spills per kernel); then
             `cuobjdump -sass` of the library: each bf16 flash kernel and
             each int4 tensor-core kernel must hold HGMMA (wgmma) and
             UTMALDG (TMA) instructions, no fp32 flash kernel a tensor-core
             instruction (no TF32), and no int4 tensor-core kernel a spill;
             each float4 LIF-epilogue kernel and 4-channel dense-core
             kernel must hold 128-bit global loads and stores
             (LDG.E*.128, STG.E*.128) and spill nothing;
3. kernels — each hand kernel against its plain PyTorch version on the card,
             at every shape the CIFAR10 serving path (8 slots) and the
             unfused pipeline (8 images) give it, with kernel / plain /
             library times (CUDA events) and the bound the shapes allow on
             an H100;
4. serve   — spiking VGG9 at full CIFAR10 width, fp32 and int4, served by
             EngineCore + SNNRunner on the card: per-request checks, launch
             counts per engine step, and the same requests on the CPU's
             plain path as the reference; a profile of one engine run
             with the device ms per step of each of the seven hand kernels;
5. unfused — the pre-fusion pipeline (T in-kernel-gated spike_matmul +
             lif_step launches per layer) at full CIFAR10 width, fp32 and
             int4, on 8 mixed images: bit-identical to the fused pipeline on
             the card, against itself on the CPU, launch counts, and fused
             vs unfused forward ms (CUDA events);
6. train   — surrogate-gradient BPTT of the full-width spiking VGG9, fp32
             and int4 QAT, AdamW + warmup-cosine: one step's loss and
             gradients on the card against the CPU on the same batch, then 5
             steps at batch 32 from one state four times, in turns under
             the training step's deterministic settings (runs A, B: losses,
             parameters and optimizer state must be bit-identical) and with
             them swapped out (runs C, D: their cost, and whether the
             default algorithms repeat); finite losses, median ms per step,
             per-layer spikes of the trained weights;
7. lm      — qwen1.5-4b: (a) at full width and depth (40 layers, 15.8 GB of
             fp32 weights), served in fp32 and int4 (fake-quant) by
             EngineCore + LMRunner, 4 slots, prefill chunk 8, speculation
             k=4, 8 requests (a repetitive, a sampled and an empty prompt
             among them): budgets, vocab range, speculative = plain and
             batch = solo streams, host ms per engine step; in fp32 only
             (int4's fake-quant view does the same work), host ms per
             decode step against the step's bound and the device busy
             share; (b) at full
             width and depth 2, `decode_chunk` logits on the card against
             the CPU and the same requests served on both; (c)
             `launch/serve_lm_w4.py --full`, the int4 matmul's main path;
             (d) the layer-0 prefill attention of a 2048-token prompt
             through `flash_attention`, in fp32 and in bf16, against the
             model's own `chunked_causal_attention` on the same values in
             fp32, the flash kernel's main path (a rerun bit-identical);
8. precision — (a) adaptive-precision serving at full CIFAR10 width: one
             pre-warmed fp32+int4 variant registry behind three engines
             (`PrecisionRunner` pinned fp32, pinned int4, adaptive; each
             controller bound to its sparsity scheduler) serving phase 4's
             17 requests in two waves, every third pinned to fp32: pinned
             requests at fp32, every request's logits bit-identical to a
             single-precision engine's at the precision it was served, each
             engine step launching one fused pipeline per precision that
             holds slots, the adaptive engine's served precisions equal to
             the CPU's, its mean served energy below pinned fp32's under Eq. 3
             and the analytical model; per mode host ms per step, device
             busy share and hand-kernel ms (torch.profiler), and the device
             ms of the int4 forward's weight view; (b) the adaptive run
             again with `obs.Observability` attached: results, decisions
             and admissions bit-identical, the precision gauges and energy
             counters in its snapshot; (c) qwen1.5-4b at full width and depth
             2, fp32 and int4 variants behind one adaptive engine (every
             other request pinned to int4): each stream equal to the plain
             engine's at its precision; (d) subprocesses, each of which must
             exit 0: `launch.serve` SNN with `--precision adaptive --metrics
             prom`, LM with `--scheduler slo --slo-ms 3000`, and
             `launch.quant_sparsity_study` on the card beside its CPU table
             (every number finite);
9. family  — the rest of the LM family: (a) granite-moe-3b-a800m at full
             width (40 experts padded to 48, top-8), 8 of its 32 layers
             (`MOE_LAYERS`), served as 7a serves qwen, fp32 and int4, with
             the decode step's bound over every expert and over the routed
             ones; (b) recurrentgemma-2b (26 layers, the 2-layer RG-LRU
             tail, local attention with window 2048) and xlstm-125m at full
             width and depth, fp32, 6 requests on 4 slots (two admitted into
             freed slots, which must equal their solo streams), speculation
             refused with the reference's message; (c) granite-moe (2
             periods), recurrentgemma (a period and the tail), xlstm (a
             period), phi-3-vision and musicgen (2 periods, synthesized
             frontend embeddings) at full width, the card against the CPU:
             `decode_chunk` and `forward` logits within 1e-3, and no token
             routed to another expert set where the CPU's k-th/(k+1)-th
             router-logit gap exceeds 1e-4; (d) `launch/serve_lm_w4.py
             --arch A --full` for the nine archs other than qwen, each one
             launch of the int4 matmul at x [4, d_model], held against its
             plain version, each model freed before the next loads;
10. fleet  — the serving fleet at full CIFAR10 width: (a) 3 in-process
             replicas (`make_router`) over one card `SNNRunner`, replica 0
             wedged from its second step and replica 1 poisoning slot 0 at
             its third, phase 4's 17 requests in three waves: both replicas
             drained, the poisoned request `failed` with nothing streamed,
             every `ok` result (logits, spikes, skip rates, occupancy trace
             and its partial stream) bit-identical to phase 4's solo engine,
             launches of kernels 1-3 equal to the replicas' forwards; (b) 2
             subprocess workers on the card from one `snn_spec`, worker 0
             the trace twice, a clean pass and one whose worker 0 is
             killed after the first router step: one drain, its requests
             replayed, every result bit-identical to an in-process engine
             over `build_runner(spec)` and to phase 4; handshake seconds,
             host ms per router step in each pass, nvidia-smi's memory
             before the spawn and with three CUDA contexts up; (c) qwen1.5-4b at full width and depth 2 in 2
             workers, worker 0 killed mid-decode, 7a's trace: every stream
             equal to the in-process engine's over the same `lm_spec`; (d)
             the CLI side by side: `--replicas 3 --fault-plan 0=wedge@1`
             (its drain line) and `--workers 2`, one slot each, the same
             request lines, and `--workers 1 --replicas 2` refused with its
             rule's message;
11. train  — LM training: (a) granite-moe-3b-a800m at full width, 8 of its
             32 layers (`MOE_LAYERS`), in the config's own bf16 with
             remat="full" and AdamW, warmup-cosine to a peak lr of 1e-3 in 2
             steps, `token_batch` batches of
             8 x 512 through `DataPipeline` onto the card: 2 steps twice from
             one state, the second time with the donated step
             (``donate=True``, written into the state's buffers): losses,
             parameters and optimizer state must be bit-identical; then 6
             more (finite, the last loss below the
             first); host ms per step, tokens/s, peak allocated and
             nvidia-smi's used memory, one profiled step's device busy
             share, and the step's bound (its flops over the bf16 peak,
             experts at capacity and routed only, against the optimizer's
             state bytes over HBM); before it, each indexing op of the step's
             backward (the MoE's gathers, the embedding gather, the loss's
             `take_along_dim`) at these shapes, twice under the step's
             deterministic settings: it raises or repeats its bits; (b)
             granite-moe and xlstm-125m at full width, one period, B = 2, S =
             128, fp32 on one set of weights: the train loss within 1e-4
             relative of the CPU's, the worst gradient's relative L2 within
             1e-3, expert sets equal where the router's gap exceeds 1e-4;
             the bf16 loss beside the fp32 one on the same weights; (c)
             xlstm-125m at full width and 4 of its 12 layers (bf16; cut
             from full depth to make room for phase 13) through `TrainLoop`
             with a checkpoint every 2 steps: a clean 6-step run bit-identical
             to one that fails at step 3 and resumes from step 2, the last
             checkpoint's bf16 leaves restoring bit for bit; then
             `python -m repro_torch.launch.train` (its defaults) as a
             subprocess on the card, which must exit 0 and print its final
             loss;
12. dist   — distribution, every shard and rank on the one card: (a) phase
             4's 17 requests at full CIFAR10 width, fp32 and int4, through
             EngineCore + SNNRunner under an in-process data mesh of two
             shards of cuda:0: every result bit for bit phase 4's solo
             engine's, kernels 1-3 launched twice as often per step, the
             near-silent request's skip rate above a dense one's, host ms
             per step beside solo's; (b) `compressed_psum` on two gloo
             ranks holding CUDA tensors (cuda:0) and on two CPU ranks, over
             seeded gradients of xlstm-125m's full-size leaf shapes, per
             tensor and per channel: mean gradients and residuals bit for
             bit equal, the residual invariant within f32 rounding, wire
             bytes and ms per call; (c) xlstm-125m at full width and 4 of
             its 12 layers (cut as 11c's) in fp32 through `launch.train`
             under torchrun on two ranks of cuda:0 (gloo), 3 steps plain
             and 3 with --compress-grads
             (this script re-enters itself as each rank with
             `--train-rank`): every rank's parameters and optimizer state
             equal (fingerprints after every step, every bit after the
             last), non-zero residuals, the plain first step equal to one
             process's step on the same two halves averaged in rank order,
             and within 1e-5 of one step on the whole batch (loss and
             parameter tree; each parameter within 2 lr; the AdamW
             moments' difference reported), ms per step; then
             --compress-grads at world size 1 on
             NCCL as a plain CLI; (d) `launch.serve --data-shard 2` on a
             one-card machine and `--workers 2 --data-shard 2` refused with
             the reference's messages.
13. tp     — tensor parallelism, every rank on the one card over gloo (this
             script re-enters itself as each torchrun rank with
             `--tp-rank`): (a) qwen1.5-4b at full width, 2 layers, fp32,
             batch 4 x 512 on a (2, 2) ('data', 'model') mesh: rank 0
             first takes one process's step alone; then every rank holds
             its `param_spec` shards (state bytes against one process's, at
             most 0.55), the first step's loss, gradients (averaged over
             the data ranks) and parameters against one process's (1e-5
             relative, 1e-4 per gradient leaf, 1e-5 relative L2), the data
             replicas of every shard bit-identical after each of 2 AdamW
             steps, a second run of the 2 steps bit-identical, ms per step
             and peak allocated memory per rank; (b) granite-moe-3b at full
             width, 2 layers, bf16, remat, on (1, 2): the same against one
             process (1e-3 loss and parameters; gradients reported), the
             expert sets equal on both model ranks, and in an fp32 forward
             equal to one process's where the router's gap exceeds 1e-4;
             (c) 13a's parameters saved on (2, 2), restored onto (4, 1) by
             the same ranks and onto this one process, every leaf
             bit-identical; (d) heads the model axis does not divide, on a
             (1, 3) mesh of 3 ranks (`--tp-uneven-rank`): qwen1.5-4b at
             full width, 2 layers (20 heads as 7 / 7 / 6) and xlstm-125m at
             full width, 4 of 12 layers (4 heads as 2 / 1 / 1), fp32,
             batch 2 x 512: one step of each against one process on the
             card (1e-6 loss, 1e-5 per gradient leaf, 1e-5 parameter tree,
             relative), each rank's head range and peak allocated beside
             one process's peak.
14. dryrun — the dry run (`launch.dryrun`, `launch.costing`): (a)
             `python -m repro_torch.launch.dryrun` as six subprocesses side
             by side, started after phase 2 with ``--device cpu``, niced
             (``--phase14``: started in phase 14, naming the card)
             (`DRYRUN_CELLS`: qwen1.5-4b, granite-moe-3b-a800m and
             llama4-maverick-400b-a17b at train_4k on the 16x16 pod mesh,
             the cells the reference has records of; phi-3-vision-4.2b
             prefill_32k; recurrentgemma-2b decode_32k; qwen1.5-4b
             train_4k on the 2x16x16 mesh), each ending ``ok``, the three
             records' params_total, params_active and model_flops equal
             to ``results/dryrun/``'s and their FLOP per chip at most
             `DRYRUN_FLOP_CEILING`'s; each cell's per-chip peak, totals,
             roofline terms and trace seconds printed (beside the
             reference's record where there is one); (b) granite-moe-3b
             at full width and full depth (32 layers), bf16, remat, AdamW,
             11a's 8 x 512 batches, the donated step on the card: 2 steps
             twice from one seeded state, bit-identical; the dry run of
             that step on a 1-rank fake mesh (a seventh subprocess,
             `--predict-14b`, started with them) predicts its peak (within
             `PEAK_TOL` of max_memory_allocated over a step, less what
             was allocated before the state was built), its FLOPs
             (equal to `launch.costing.step_costs`' count on the card's
             first step) and its roofline bound, printed beside the median
             step time (CUDA events) and 11a's `train_step_bound`. The
             subprocesses trace on the host while the card works.

Phase 3 holds `spike_matmul_mapped` at spike densities 0.1, 0.33 and 1.0:
within 1e-4 of the plain product, bit for bit the plain k-ascending sum
(`spike_matmul_event_plain`) and the in-kernel-gated `spike_matmul`, its
bitmask and maps exact, at least one block per SM; each row prints the
block count and the set bits, and its `bound_ms` is the event bound (one
add per set bit and real output column, or the bytes if they take longer),
with the tile-gated FMA count's bound beside it as `tile_bound_ms` (the
kernels line carries the density-0.1 rows, as in earlier runs). It holds
`spike_matmul` at the same densities and the unfused pipeline's six
per-timestep shapes: within 1e-4 of the plain product, bit for bit
`spike_matmul_mapped` and the k-ascending sum, an all-zero tile row exactly
0, at least one block per SM; each row prints its geometry, blocks, set
bits, the same two bounds and CUDA-graph device time (`graph_ms`), which the LIF
kernels and the dense core also print, with their launch geometry and block
count; the dense core is also held bit for bit against its ordered plain
version (k ascending, separate roundings), and a `launch floor` line gives
the `graph_ms` of the LIF epilogue on a [2, 1, 8] operand (one graph launch
with next to no work). It also
holds `int4_matmul` at qwen1.5-4b's projection shapes (decode M = 4,
prefill M = 512, the LM head, the example's shape) and at phase 9d's
shapes (M = 4, N = 256, K = each other arch's d_model) with fp32 x, and with
bf16 x at the prefill shapes and the LM head: within 1e-4 of the plain
version, a row's result equal to the M = 1 call's; each row prints the
path (TMA or ragged), token width, warpgroups, tiles, stages, K's splits,
blocks, `graph_ms`, the device time of each kernel the call launches, its
tensor-core bound (fp32 x as three bf16 passes) as `bound_ms` and its share
of `graph_ms`, and the fp32 CUDA-core bound beside it as `simt_bound_ms`;
and `flash_attention` at
20 heads of 128, S = 512 and 2048, fp32 and bf16, with its achieved
TFLOP/s, the share of its bound, and its and SDPA's device time from CUDA
graph replays (`graph_ms`: at S = 512 a call is shorter than its enqueue).

    python3 chip_smoke.py --sweep

runs phases 1-2, then times `int4_matmul` at every geometry it has (token
width, warpgroups, tiles, stages), in whole and split mode, at the chosen,
half and twice the chosen number of K's splits, at each qwen shape for fp32
and bf16 x (each held against the plain version, its bits reported equal
to or different from the chosen plan's), `spike_matmul_mapped` at every
block geometry it has at each served shape and density, and `spike_matmul`
at every geometry it has at each of the unfused pipeline's shapes and
density (each result held bit for bit against the k-ascending sum), and
stops there.
    python3 chip_smoke.py --phase12
runs phases 1, 2 and 12 only (its solo engines served on the spot), and

    python3 chip_smoke.py --phase13

phases 1, 2 and 13 only, and ``--phase14`` phases 1, 2 and 14.

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it. Every per-shape row and serving figure also goes to
``build/chip_smoke.json``. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRIPT = os.path.abspath(__file__)

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, the fp32
# (non-tensor-core) rate the fp32 kernels compute at, and the dense bf16
# tensor-core rate, the peak for work on bf16 inputs.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
FP32_ADDS = FP32_FLOPS / 2       # fp32 adds/s: one per FMA slot
# spike densities kernels 1 and 4 are held and timed at: 0.1, the densest
# served layer's 0.33, and every spike set
DENSITIES = (0.1, 0.33, 1.0)

SLOTS = 8
BETA, THETA = 0.15, 0.5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound(bytes_moved: float, flops: float, peak: float = FP32_FLOPS):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gated_flops(torch, occ, tm, tk, m, k, n) -> float:
    """The fp32 operations a tile-gated product must do: 2·n for each real
    (row, k) pair inside an occupied (tm x tk) tile of the [M_pad, K_pad]
    spikes; padded rows, columns and output channels are left out."""
    rows = (m - torch.arange(occ.shape[0], dtype=torch.float64) * tm).clamp(0, tm)
    cols = (k - torch.arange(occ.shape[1], dtype=torch.float64) * tk).clamp(0, tk)
    return 2.0 * n * float((occ.cpu().double() * rows[:, None] * cols[None, :]).sum())


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


def graph_ms(torch, fn, calls=20, replays=5) -> float:
    """Device ms per call of ``fn``, from replays of a CUDA graph of
    ``calls`` calls: the time without the host's launch path, which bounds
    `cuda_ms` where a call is shorter than its enqueue."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


# ---------------------------------------------------------------------------
# phase 2: what the flash kernels were compiled to
# ---------------------------------------------------------------------------

def sass_counts(lib_path, ops):
    """{kernel function: {op: instructions}} from `cuobjdump -sass`. ``ops``
    names opcodes, or maps a name to a regex for the instructions it counts."""
    import re
    import shutil
    from repro_torch.kernels import _build
    # cuobjdump comes with nvcc
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed: {out.stderr.strip()[-500:]}")
    patterns = ops if isinstance(ops, dict) else {op: rf"\b{op}\b" for op in ops}
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(patterns, 0)
        elif fn is not None:
            for op, pattern in patterns.items():
                if re.search(pattern, line):
                    counts[fn][op] += 1
    return counts


# 128-bit global loads and stores, any suffix (LDG.E.128, LDG.E.EF.128,
# STG.E.EF.128, ...)
WIDE_ACCESS = {"LDG128": r"\bLDG\.E\S*\.128\b", "STG128": r"\bSTG\.E\S*\.128\b"}


def check_sass(lib_path, ptxas_log):
    """The bf16 flash kernels run on tensor cores through TMA (HGMMA and
    UTMALDG in their SASS); the fp32 ones on no tensor core (no TF32). Each
    int4 tensor-core kernel holds HGMMA and UTMALDG and spills nothing. The
    vector paths of the LIF epilogue and the dense core move 16 bytes per
    global load and store, and spill nothing."""
    ops = ("HGMMA", "UTMALDG", "HMMA", "LDGSTS")
    counts = sass_counts(lib_path, {**{op: rf"\b{op}\b" for op in ops}, **WIDE_ACCESS})
    res = check_flash_sass(counts, ops)
    res["int4"] = check_int4_sass(counts, ops, ptxas_log)
    res["lif_dense"] = check_wide_sass(counts, ptxas_log)
    return res


def ptxas_report(log):
    """{kernel function: {"spills": (store bytes, load bytes), "regs": N}}
    from the `-Xptxas -v` report."""
    import re
    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            report[fn] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn is not None:
            report[fn]["spills"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            report[fn]["regs"] = int(m.group(1))
            fn = None
    return report


def check_int4_sass(counts, ops, ptxas_log):
    """Each int4 tensor-core kernel holds HGMMA and UTMALDG, spills nothing,
    and, where `setmaxnreg` moves registers (two consumer warpgroups),
    starts with the block's full count (threads x count = what an SM has),
    so the consumers' increase always finds its registers."""
    import re
    from repro_torch.kernels.int4_matmul import ops as i4
    tc = {f: c for f, c in counts.items() if "int4_wgmma_kernel" in f}
    report = ptxas_report(ptxas_log)
    bad = []
    for f, c in tc.items():
        rep = report.get(f, {})
        geometry = re.search(r"int4_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", f)
        warpgroups = int(geometry.group(2)) if geometry else 0
        threads = 128 * (warpgroups + 1)
        if rep.get("spills") != (0, 0) or "regs" not in rep or (
                warpgroups >= 2 and rep["regs"] != 65536 // threads // 8 * 8):
            bad.append((f, rep))
        print(f"  sass {f}: " + " ".join(f"{op}={c[op]}" for op in ops)
              + f" ptxas={rep}")
    if len(tc) != 2 * len(i4.INT4_GEOMETRIES):      # each geometry for fp32 and bf16 x
        fail(f"expected {2 * len(i4.INT4_GEOMETRIES)} int4 tensor-core kernels in the SASS, "
             f"found {sorted(tc)}")
    if any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in tc.values()):
        fail(f"an int4 tensor-core kernel lacks HGMMA or UTMALDG: {tc}")
    if bad:
        fail(f"int4 tensor-core kernels that spill, lack a ptxas report or start with fewer "
             f"registers than setmaxnreg assumes: {bad}")
    print(f"sass: int4 tensor-core kernels HGMMA {[c['HGMMA'] for c in tc.values()]} UTMALDG "
          f"{[c['UTMALDG'] for c in tc.values()]}; no spills")
    return {"kernels": tc, "ptxas": {f: report.get(f) for f in tc}}


def check_wide_sass(counts, ptxas_log):
    """Each float4 instance of `lif_epilogue_kernel` (lif_epilogue_scan.cu)
    and each 4-channel instance of `dense_conv_lif_kernel` holds 128-bit
    global loads and stores and spills nothing."""
    import re
    report = ptxas_report(ptxas_log)
    vector = {f: c for f, c in counts.items()
              if "lif_epilogue_kernelI6float4" in f
              or re.search(r"dense_conv_lif_kernelILi\d+ELi\d+ELi4E", f)}
    bad = []
    for f, c in vector.items():
        rep = report.get(f, {})
        if c["LDG128"] == 0 or c["STG128"] == 0 or rep.get("spills") != (0, 0):
            bad.append((f, c, rep))
        print(f"  sass {f}: LDG128={c['LDG128']} STG128={c['STG128']} ptxas={rep}")
    epilogue = sum("lif_epilogue" in f for f in vector)
    if epilogue == 0 or epilogue == len(vector):
        fail(f"expected float4 lif_epilogue and dense_conv_lif kernels in the SASS, found "
             f"{sorted(vector)}")
    if bad:
        fail(f"LIF/dense vector kernels without 128-bit global loads or stores, or that "
             f"spill: {bad}")
    print(f"sass: {epilogue} float4 lif_epilogue and {len(vector) - epilogue} 4-channel "
          f"dense_conv_lif kernels with 128-bit global loads and stores; no spills")
    return {f: {"sass": c, "ptxas": report.get(f)} for f, c in vector.items()}


def check_flash_sass(counts, ops):
    bf16 = {f: c for f, c in counts.items() if "flash_bf16_kernel" in f}
    fp32 = {f: c for f, c in counts.items() if "flash_fp32_kernel" in f}
    for f, c in {**bf16, **fp32}.items():
        print(f"  sass {f}: " + " ".join(f"{op}={c[op]}" for op in ops))
    if len(bf16) != 4 or len(fp32) != 4:   # hd 64/128 x (1 or 2 warpgroups | KV groups)
        fail(f"expected 4 bf16 and 4 fp32 flash kernels in the SASS, found {sorted(bf16)} "
             f"{sorted(fp32)}")
    if any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in bf16.values()):
        fail(f"a bf16 flash kernel lacks HGMMA or UTMALDG: {bf16}")
    if any(c["HGMMA"] or c["HMMA"] for c in fp32.values()):
        fail(f"an fp32 flash kernel uses tensor cores: {fp32}")
    print(f"sass: bf16 flash kernels HGMMA {[c['HGMMA'] for c in bf16.values()]} UTMALDG "
          f"{[c['UTMALDG'] for c in bf16.values()]}; fp32 flash kernels no HGMMA/HMMA")
    return {"bf16": bf16, "fp32": fp32}


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


def event_bound(bytes_moved: float, set_bits: int, n: int):
    """The bound of kernels 1 and 4, whose patches are 0/1 spikes: the
    larger of their bytes at the memory rate and one fp32 add per (set bit,
    real output column) at half the fp32 FMA rate, all the function needs
    (a zero spike adds nothing)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = set_bits * n / FP32_ADDS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def served_mapped_operands(torch, m, k_pad, n, k, bm, gen, density):
    """Spikes of the given density in the real [M, K] region and an all-zero
    first tile row; weights in the real [K, N] region; zero padding, as
    `spike_conv2d_mapped` hands them over."""
    from repro_torch.core.tiling import round_up
    n_pad = round_up(n, 128)
    patches = torch.zeros((m, k_pad), device="cuda")
    patches[:, :k] = (torch.rand((m, k), device="cuda", generator=gen) < density).float()
    patches[:bm] = 0.0                                       # an all-zero tile row
    w2d = torch.zeros((k_pad, n_pad), device="cuda")
    w2d[:k, :n] = torch.randn((k, n), device="cuda", generator=gen) * (2.0 / k) ** 0.5
    return patches, w2d


def check_spike_matmul(torch, shapes, gen, density):
    """Kernel 1 at the served shapes and one spike density: within 1e-4 of
    the plain product, bit for bit the plain k-ascending sum and kernel 4,
    maps and bitmask exact, at least one block per SM."""
    from repro_torch.kernels.spike_conv import ops as sc
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, m, k_pad, n, k, bm, bk in shapes:
        patches, w2d = served_mapped_operands(torch, m, k_pad, n, k, bm, gen, density)
        n_pad = w2d.shape[1]
        out, occ, row_occ = sc.spike_matmul_mapped(patches, w2d, block_m=bm, block_k=bk)
        _, _, _, mask = sc._spike_matmul_mapped_cuda(patches, w2d, block_m=bm, block_k=bk,
                                                     gate=True)
        ref, ref_occ, ref_row = sc.spike_matmul_mapped_plain(patches, w2d, block_m=bm,
                                                             block_k=bk)
        event = sc.spike_matmul_event_plain(patches, w2d)
        gated = sc.spike_matmul(patches, w2d)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        r_rows, cols = sc.event_geometry(m, k_pad, n_pad, bm, bk, sms)
        blocks = (m // r_rows) * (n_pad // cols)
        checks = {"maps": torch.equal(occ, ref_occ) and torch.equal(row_occ, ref_row),
                  "tol": err <= tol, "zero_rows": out[:bm].abs().max().item() == 0.0
                  and occ[0].sum().item() == 0,
                  "event_bits": torch.equal(out, event), "kernel4_bits": torch.equal(out, gated),
                  "bitmask": torch.equal(mask, sc.spike_bitmask_plain(patches)),
                  "blocks": blocks >= sms}
        occupied = int(occ.sum().item())
        set_bits = int((patches != 0).sum().item())
        nk = k_pad // bk
        moved = 4 * (m * k + k * n + m * n) + m * nk + 4 * (m // bm) * nk
        tile_flops = gated_flops(torch, occ, bm, bk, m, k, n)
        t_ms, t_by = bound(moved, tile_flops)
        b_ms, b_by = event_bound(moved, set_bits, n)
        rows.append(dict(
            shape=f"{name} M={m} K={k_pad} N={n_pad} density={density}",
            ok=all(checks.values()), failed=[c for c, v in checks.items() if not v],
            err=err, tol=tol, bytes=moved, adds=set_bits * n, set_bits=set_bits,
            geometry=f"{r_rows}x{cols}", blocks=blocks,
            skip=1 - occupied / occ.numel(),
            ms=cuda_ms(torch, lambda: sc.spike_matmul_mapped(patches, w2d, block_m=bm,
                                                             block_k=bk)),
            plain_ms=cuda_ms(torch, lambda: sc.spike_matmul_mapped_plain(
                patches, w2d, block_m=bm, block_k=bk)),
            library_ms=cuda_ms(torch, lambda: torch.matmul(patches, w2d)),
            bound_ms=b_ms, bound_by=b_by, tile_flops=tile_flops, tile_bound_ms=t_ms,
            tile_bound_by=t_by))
    return rows


def sweep_event_geometry(torch, shapes, gen):
    """Kernel 1's time at every (rows, cols) geometry it has, at each
    served shape and density; each result held bit for bit against the
    plain k-ascending sum. Prints one line per (shape, density)."""
    from repro_torch.kernels.spike_conv import ops as sc
    failed = []
    for density in DENSITIES:
        for name, m, k_pad, n, k, bm, bk in shapes:
            patches, w2d = served_mapped_operands(torch, m, k_pad, n, k, bm, gen, density)
            n_pad = w2d.shape[1]
            event = sc.spike_matmul_event_plain(patches, w2d)
            times = []
            for geometry in sc.EVENT_GEOMETRIES:
                r_rows, cols = geometry
                if not sc._fits(geometry, m, k_pad, n_pad) or \
                        (m // r_rows) * (n_pad // cols) < sc.H100_SMS:
                    continue
                run = lambda: sc._spike_matmul_mapped_cuda(patches, w2d, block_m=bm,
                                                           block_k=bk, gate=True,
                                                           geometry=geometry)
                if not torch.equal(run()[0], event):
                    failed.append(f"{name} density={density} {geometry}")
                times.append(f"{r_rows}x{cols} ({(m // r_rows) * (n_pad // cols)} blocks) "
                             f"{cuda_ms(torch, run):.4f}")
            chosen = sc.event_geometry(m, k_pad, n_pad, bm, bk)
            print(f"  sweep {name} M={m} K={k_pad} N={n_pad} density={density} "
                  f"(chosen {chosen[0]}x{chosen[1]}): ms " + ", ".join(times),
                  flush=True)
    return failed


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
        vector, blocks = lif.epilogue_geometry(r, n, steps)
        rows.append(dict(
            shape=f"{name} T={steps} R={r} N={n}", ok=torch.equal(out, ref),
            launch=f"{'float4' if vector else 'float'} per thread, {blocks} blocks",
            bytes=moved, flops=flops,
            err=(out - ref).abs().max().item(), tol=0.0,
            ms=cuda_ms(torch, lambda: lif.lif_epilogue_scan(cur, bias, beta=BETA,
                                                            theta=THETA)),
            graph_ms=graph_ms(torch, lambda: lif.lif_epilogue_scan(cur, bias, beta=BETA,
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
    os_, ou = dense.dense_conv_lif_ordered_plain(patches, w2d, bias, num_steps=steps,
                                                 beta=BETA, theta=THETA)
    torch.cuda.synchronize()
    err = (u - ru).abs().max().item()
    ordered_bits = torch.equal(s, os_) and torch.equal(u, ou)   # the kernel's own sum order
    ok = err <= 1e-5 and ordered_bits
    for t in range(steps):                # spikes agree wherever u_t is clear of theta
        _, u_t = dense.dense_conv_lif_plain(patches, w2d, bias, num_steps=t + 1,
                                            beta=BETA, theta=THETA)
        clear = (u_t - THETA).abs() > 1e-5
        ok = ok and torch.equal(s[t][clear], rs[t][clear])
    moved = 4 * (m * k + k * n + n + steps * m * n + m * n)
    flops = 2.0 * m * k * n + 5.0 * steps * m * n
    b_ms, b_by = bound(moved, flops)
    run = lambda: dense.dense_conv_lif(patches, w2d, bias, num_steps=steps, beta=BETA,
                                       theta=THETA)
    library = lambda: torch.matmul(patches, w2d)
    rows_, per, threads, blocks = dense.dense_geometry(m, k, n)
    return [dict(
        shape=f"conv0 M={m} K={k} N={n} T={steps}", ok=ok, err=err, tol=1e-5,
        ordered_bits=ordered_bits,
        launch=(f"{rows_}x{n} per block, {per} rows x {4 if n % 4 == 0 else 1} channels per "
                f"thread, {threads} threads, {blocks} blocks"),
        bytes=moved, flops=flops,
        ms=cuda_ms(torch, run), graph_ms=graph_ms(torch, run),
        plain_ms=cuda_ms(torch, lambda: dense.dense_conv_lif_plain(
            patches, w2d, bias, num_steps=steps, beta=BETA, theta=THETA)),
        library_ms=cuda_ms(torch, library), library_graph_ms=graph_ms(torch, library),
        bound_ms=b_ms, bound_by=b_by)]


def launch_floor_ms(torch) -> float:
    """`graph_ms` of kernel 2 on a [2, 1, 8] operand: what one launch of a
    hand kernel costs inside a CUDA graph with next to no work, the floor
    under the FC layers' epilogues."""
    from repro_torch.kernels.lif_step import ops as lif
    cur = torch.ones((2, 1, 8), device="cuda")
    bias = torch.zeros((8,), device="cuda")
    return graph_ms(torch, lambda: lif.lif_epilogue_scan(cur, bias, beta=BETA, theta=THETA))


def unfused_shapes(cfg, batch):
    """Per-timestep shapes of the unfused pipeline: (name, M_pad, K_pad,
    N_pad, M, K, N) of each spiking conv's gated product, padded as
    `spike_conv2d` pads them, and (name, n) of each of the 8 LIF launches'
    flat length."""
    from repro_torch.core.tiling import round_up
    mm, lif = [], []
    hw, cin = cfg.img_hw, cfg.conv_channels[0]
    for s in cfg.stages[1:]:
        if s == "MP":
            hw //= 2
            continue
        m, k = batch * hw * hw, 9 * cin
        mm.append((f"conv{len(mm) + 1}", round_up(m, min(256, round_up(m))),
                   round_up(k), round_up(s), m, k, s))
        lif.append((f"conv{len(lif) + 1}", m * s))
        cin = s
    lif += [("fc0", batch * cfg.fc_dim), ("fc1", batch * cfg.population)]
    return mm, lif


# the all-zero first rows of kernel 4's operands: one row of 64-row tiles
GATED_ZERO_ROWS = 64


def served_gated_operands(torch, shape, gen, density):
    """Spikes of the given density in the real [M, K] region and an
    all-zero first tile row; weights in the real [K, N] region; zero
    padding, as `spike_conv2d` hands them over."""
    _, m_pad, k_pad, n_pad, m, k, n = shape
    patches = torch.zeros((m_pad, k_pad), device="cuda")
    patches[:m, :k] = (torch.rand((m, k), device="cuda", generator=gen) < density).float()
    patches[:GATED_ZERO_ROWS] = 0.0                          # an all-zero tile row
    w2d = torch.zeros((k_pad, n_pad), device="cuda")
    w2d[:k, :n] = torch.randn((k, n), device="cuda", generator=gen) * (2.0 / k) ** 0.5
    return patches, w2d


def check_spike_matmul_gated(torch, shapes, gen, density):
    """Kernel 4 at the unfused pipeline's shapes and one spike density:
    within 1e-4 of the plain product, bit for bit kernel 1 and the plain
    k-ascending sum, the all-zero tile row exactly 0, at least one block
    per SM."""
    from repro_torch.kernels.spike_conv import ops as sc
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tm, tk = sc.GATED_M, sc.GATED_WORD_K
    rows = []
    for shape in shapes:
        name, m_pad, k_pad, n_pad, m, k, n = shape
        patches, w2d = served_gated_operands(torch, shape, gen, density)
        out = sc.spike_matmul(patches, w2d)
        ref = sc.spike_matmul_plain(patches, w2d)
        mapped, _, _ = sc.spike_matmul_mapped(patches, w2d, block_m=128, block_k=128)
        event = sc.spike_matmul_event_plain(patches, w2d)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        geometry = sc.gated_geometry(m_pad, k_pad, n_pad, sms)
        blocks = sc.gated_blocks(geometry, m_pad, n_pad)
        checks = {"tol": err <= tol, "kernel1_bits": torch.equal(out, mapped),
                  "event_bits": torch.equal(out, event),
                  "zero_rows": out[:GATED_ZERO_ROWS].abs().max().item() == 0.0,
                  "blocks": blocks >= sms}
        occ = (patches.reshape(m_pad // tm, tm, k_pad // tk, tk) != 0).any(3).any(1)
        set_bits = int((patches != 0).sum().item())
        moved = 4 * (m * k + k * n + m * n)
        tile_flops = gated_flops(torch, occ, tm, tk, m, k, n)
        t_ms, t_by = bound(moved, tile_flops)
        b_ms, b_by = event_bound(moved, set_bits, n)
        run = lambda: sc.spike_matmul(patches, w2d)
        library = lambda: torch.matmul(patches, w2d)
        rows.append(dict(
            shape=f"{name} M={m_pad} K={k_pad} N={n_pad} (real {m}x{k}x{n}) density={density}",
            ok=all(checks.values()), failed=[c for c, v in checks.items() if not v],
            err=err, tol=tol, bytes=moved, adds=set_bits * n, set_bits=set_bits,
            geometry="x".join(map(str, geometry)), blocks=blocks,
            skip=1 - int(occ.sum()) / occ.numel(),
            ms=cuda_ms(torch, run), graph_ms=graph_ms(torch, run),
            plain_ms=cuda_ms(torch, lambda: sc.spike_matmul_plain(patches, w2d)),
            library_ms=cuda_ms(torch, library), library_graph_ms=graph_ms(torch, library),
            bound_ms=b_ms, bound_by=b_by, tile_flops=tile_flops, tile_bound_ms=t_ms,
            tile_bound_by=t_by))
    return rows


def sweep_gated_geometry(torch, shapes, gen):
    """Kernel 4's time at every geometry it has that divides each unfused
    shape, at each density; each result held bit for bit against the plain
    k-ascending sum. Prints one line per (shape, density)."""
    from repro_torch.kernels.spike_conv import ops as sc
    failed = []
    for density in DENSITIES:
        for shape in shapes:
            name, m_pad, k_pad, n_pad = shape[:4]
            patches, w2d = served_gated_operands(torch, shape, gen, density)
            event = sc.spike_matmul_event_plain(patches, w2d)
            times = []
            for geometry in sc.GATED_GEOMETRIES:
                if m_pad % geometry[0] or n_pad % geometry[1]:
                    continue
                run = lambda: sc._spike_matmul_cuda(patches, w2d, gate=True, geometry=geometry)
                if not torch.equal(run(), event):
                    failed.append(f"{name} density={density} {geometry}")
                times.append(f"{'x'.join(map(str, geometry))} "
                             f"({sc.gated_blocks(geometry, m_pad, n_pad)} blocks) "
                             f"{cuda_ms(torch, run):.4f}")
            chosen = sc.gated_geometry(m_pad, k_pad, n_pad)
            print(f"  sweep spike_matmul {name} M={m_pad} K={k_pad} N={n_pad} "
                  f"density={density} (chosen {'x'.join(map(str, chosen))}): ms "
                  + ", ".join(times), flush=True)
    return failed


def check_lif_step(torch, shapes, gen):
    from repro_torch.kernels.lif_step import ops as lif
    rows = []
    for name, n in shapes:
        u = torch.randn((n,), device="cuda", generator=gen)
        cur = torch.randn((n,), device="cuda", generator=gen) * 0.7
        s = (torch.rand((n,), device="cuda", generator=gen) < 0.3).float()
        out = lif.lif_update(u, cur, s, beta=BETA, theta=THETA)
        ref = lif.lif_update_plain(u, cur, s, beta=BETA, theta=THETA)
        torch.cuda.synchronize()
        moved, flops = 20 * n, 5.0 * n
        b_ms, b_by = bound(moved, flops)
        rows.append(dict(
            shape=f"{name} n={n}", ok=torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
            bytes=moved, flops=flops, err=(out[0] - ref[0]).abs().max().item(), tol=0.0,
            ms=cuda_ms(torch, lambda: lif.lif_update(u, cur, s, beta=BETA, theta=THETA)),
            graph_ms=graph_ms(torch, lambda: lif.lif_update(u, cur, s, beta=BETA,
                                                            theta=THETA)),
            plain_ms=cuda_ms(torch, lambda: lif.lif_update_plain(u, cur, s, beta=BETA,
                                                                theta=THETA)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return rows


def int4_shapes(cfg, slots, prefill):
    """(M, K, N) of the int4 matmul at qwen's projections: attention (d x d),
    MLP in (d x d_ff) and out (d_ff x d) at decode (M = slots) and prefill
    (M = prefill) widths, the LM head at decode width, and the shape
    `launch/serve_lm_w4.py --full` gives it."""
    d, ff = cfg.d_model, cfg.d_ff
    out = [(m, k, n) for k, n in ((d, d), (d, ff), (ff, d)) for m in (slots, prefill)]
    return out + [(slots, d, cfg.vocab), (4, d, 256)]


def int4_bounds(m, k, n, x_bytes, passes):
    """(bytes, tensor-core bound, its cause, fp32 CUDA-core bound, its
    cause) of one int4 call: x, the packed weights, the scale and the
    output cross device memory once; the tensor cores form `passes` bf16
    products per multiply-add (3 for fp32 x split into exact bf16 terms)."""
    moved = x_bytes * m * k + k * n // 2 + 4 * n + 4 * m * n
    flops = 2.0 * m * k * n
    return (moved, flops) + bound(moved, passes * flops, BF16_FLOPS) + bound(moved, flops)


INT4_PARTS = {"split_bf16x3": "split", "int4_wgmma": "product", "int4_simt": "simt",
              "sum_splits": "sum"}


def int4_parts_ms(torch, fn, calls=10):
    """Device ms per call of each kernel one int4 call launches (the fp32
    split, the product, the sum of K's ranges), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        for key, part in INT4_PARTS.items():
            if key in e.key and e.self_device_time_total > 0:
                parts[part] = parts.get(part, 0.0) + e.self_device_time_total / 1e3 / calls
    return parts


def check_int4_matmul(torch, shapes, gen, dtype):
    """Kernel 6 at qwen1.5-4b's shapes for one x dtype: within 1e-4 of the
    plain version, a row's result equal to the M = 1 call's, the plan's
    path, token width, splits and blocks, and its bound on the tensor cores
    (fp32 x as three bf16 passes) beside the fp32 CUDA-core bound."""
    from repro_torch.core.quant import dequantize, quantize_int4
    from repro_torch.kernels.int4_matmul import ops as i4
    rows = []
    for m, k, n in shapes:
        qt = quantize_int4(torch.randn((k, n), device="cuda", generator=gen))
        x = torch.randn((m, k), device="cuda", generator=gen).to(dtype)
        out = i4.int4_matmul(x, qt.packed, qt.scale)
        ref = i4.int4_matmul_plain(x, qt.packed, qt.scale)
        row1 = i4.int4_matmul(x[1:2].clone(), qt.packed, qt.scale)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        plan = i4.int4_plan(m, k, n, dtype,
                            torch.cuda.get_device_properties(0).multi_processor_count)
        # the library's operand: the pre-dequantized weights in x's dtype
        # (for bf16 x, torch.matmul also rounds its output to bf16)
        w = dequantize(qt).to(dtype)
        moved, flops, b_ms, b_by, simt_ms, simt_by = int4_bounds(
            m, k, n, x.element_size(), 3 if dtype == torch.float32 else 1)
        run = lambda: i4.int4_matmul(x, qt.packed, qt.scale)
        library = lambda: torch.matmul(x, w)
        checks = {"tol": err <= tol, "row_independent": torch.equal(row1, out[1:2])}
        rows.append(dict(
            shape=f"M={m} K={k} N={n} {str(dtype).split('.')[1]}", ok=all(checks.values()),
            failed=[c for c, v in checks.items() if not v], err=err, tol=tol, bytes=moved,
            flops=flops, path=plan.path, token_width=plan.token_width,
            warpgroups=plan.warpgroups, tiles=plan.tiles, stages=plan.stages, splits=plan.splits,
            whole=plan.whole, ctas=plan.ctas,
            ms=cuda_ms(torch, run), graph_ms=graph_ms(torch, run),
            plain_ms=cuda_ms(torch, lambda: i4.int4_matmul_plain(x, qt.packed, qt.scale)),
            library_ms=cuda_ms(torch, library), library_graph_ms=graph_ms(torch, library),
            bound_ms=b_ms, bound_by=b_by, simt_bound_ms=simt_ms, simt_bound_by=simt_by))
        rows[-1]["bound_share"] = b_ms / rows[-1]["graph_ms"]
        rows[-1]["parts_ms"] = int4_parts_ms(torch, run)
        del qt, w, x, out, ref
    return rows


def sweep_int4_geometry(torch, shapes, gen):
    """Kernel 6's time (`graph_ms`) at every geometry (token width,
    warpgroups, tiles, stages) it has, in whole and split mode, at the
    chosen number of K's splits and at half and twice it, at each qwen shape
    and x dtype; each result held against the plain version and reported as
    equal to or different from the chosen plan's bits. Prints one line per
    (shape, dtype)."""
    from repro_torch.core.quant import quantize_int4
    from repro_torch.kernels.int4_matmul import ops as i4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    failed = []
    for m, k, n in shapes:
        qt = quantize_int4(torch.randn((k, n), device="cuda", generator=gen))
        scale = qt.scale.reshape(-1).float().contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((m, k), device="cuda", generator=gen).to(dtype)
            ref = i4.int4_matmul_plain(x, qt.packed, qt.scale)
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            chosen_plan = i4.int4_plan(m, k, n, dtype, sms)
            chosen = i4.int4_matmul(x, qt.packed, qt.scale)
            s0, units = chosen_plan.splits, -(-k // i4.UNIT_K)
            times = []
            for splits in sorted({s0, max(1, s0 // 2), min(units, 2 * s0)}):
                for geometry in i4.INT4_GEOMETRIES:
                    for fill in (1, 10 ** 6):              # whole mode, split mode
                        plan = i4.int4_plan(m, k, n, dtype, fill, geometry, splits)
                        if fill > 1 and plan.whole:
                            continue                       # one range: no split mode
                        run = lambda: i4._int4_matmul_cuda(x, qt.packed, scale, geometry=geometry,
                                                           splits=splits, sms=fill)
                        out = run()
                        if (out - ref).abs().max().item() > tol:
                            failed.append(f"M={m} K={k} N={n} {dtype} {plan}")
                        times.append(f"{geometry} S={splits} "
                                     f"{'whole' if plan.whole else 'split'} ({plan.ctas} blocks) "
                                     f"{graph_ms(torch, run):.4f} "
                                     f"{'=' if torch.equal(out, chosen) else '!='}")
            print(f"  sweep int4_matmul M={m} K={k} N={n} {str(dtype).split('.')[1]} (chosen "
                  f"{chosen_plan.geometry} S={s0} {'whole' if chosen_plan.whole else 'split'}, "
                  f"graph ms {graph_ms(torch, lambda: i4.int4_matmul(x, qt.packed, qt.scale)):.4f}"
                  f"): graph ms, bits vs chosen: " + ", ".join(times), flush=True)
        del qt
    return failed


def check_flash_attention(torch, gen, heads=20, hd=128):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    rows = []
    for s in (512, 2048):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((heads, s, hd), device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
            out = fa.flash_attention_fwd(q, k, v)
            ref = fa.flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            # fp32: the JAX test's bar; bf16: one rounding step of the largest output
            tol = 5e-5 if dtype == torch.float32 else 2 ** -7 * max(1.0, ref.abs().max().item())
            moved = 4 * heads * s * hd * q.element_size()
            flops = 4.0 * hd * heads * s * (s + 1) / 2      # QK^T and PV over causal pairs
            b_ms, b_by = bound(moved, flops,
                               FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS)
            rows.append(dict(
                shape=f"B=1 H=KV={heads} S={s} hd={hd} {str(dtype).split('.')[1]}",
                ok=err <= tol, err=err, tol=tol, bytes=moved, flops=flops,
                ms=cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v)),
                plain_ms=cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v)),
                library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True)),
                bound_ms=b_ms, bound_by=b_by))
            rows[-1].update(tflops=flops / rows[-1]["ms"] / 1e9,
                            bound_share=b_ms / rows[-1]["ms"],
                            graph_ms=graph_ms(torch, lambda: fa.flash_attention_fwd(q, k, v)),
                            library_graph_ms=graph_ms(torch, lambda: F.scaled_dot_product_attention(
                                q[None], k[None], v[None], is_causal=True)))
    return rows


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
    want = dict.fromkeys(CUDA_LAUNCHES, 0)
    want.update({"dense_conv_lif": steps, "spike_matmul_mapped": n_spiking * steps,
                 "lif_epilogue_scan": (n_spiking + 2) * steps})
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
            "launches": launches, "results": res}


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
          + ", ".join(f"{k[:40]} {ms:.3f} ({n})" for k, ms, n in top[:10]))
    import re
    hand = {}
    for kname, functions in hand_kernel_functions().items():
        found = [e for e in kernels if re.search(rf"\b({'|'.join(functions)})\b", e.key)]
        hand[kname] = (sum(e.self_device_time_total for e in found) / 1e3 / steps,
                       sum(e.count for e in found) / steps)
    print(f"profile {name}: hand kernels device ms/step (launches/step): "
          + ", ".join(f"{k} {ms:.4f} ({n:g})" for k, (ms, n) in hand.items()))
    return {"step_ms": step_ms, "forward_ms": forward_ms, "busy_ms_per_step": busy_ms,
            "top": top[:16], "hand_kernels": hand}


def hand_kernel_functions():
    """{hand kernel: the __global__ functions of its source}, read off
    ``kernels/*/csrc/<kernel>.cu``, to find its launches in a profile."""
    import re
    from repro_torch.kernels import CUDA_LAUNCHES, _build
    sources = {p.stem: p for p in _build.sources()}
    return {name: re.findall(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)"
                             r"\s*)?(\w+)\s*\(", sources[name].read_text())
            for name in CUDA_LAUNCHES}


# ---------------------------------------------------------------------------
# phase 5: the unfused pipeline, held against the fused one and the CPU
# ---------------------------------------------------------------------------

def check_unfused(torch, name, cfg, params_cpu, errors):
    from repro_torch.kernels import CUDA_LAUNCHES, reset_cuda_launches
    from repro_torch.models.vgg9 import vgg9_infer_hybrid, vgg9_infer_hybrid_unfused

    params = {k: {kk: v.to("cuda") for kk, v in leaf.items()} for k, leaf in params_cpu.items()}
    images = torch.stack(make_requests(torch, cfg)[:SLOTS])    # the mixed trace
    gpu_images = images.to("cuda")
    fused = lambda: vgg9_infer_hybrid(params, gpu_images, cfg, device="cuda")
    unfused = lambda: vgg9_infer_hybrid_unfused(params, gpu_images, cfg, device="cuda")
    fused()                                                   # warm-up
    unfused()
    torch.cuda.synchronize()

    reset_cuda_launches()
    logits, counts = unfused()
    torch.cuda.synchronize()
    launches = dict(CUDA_LAUNCHES)
    t, n_spiking = cfg.timesteps, len(cfg.conv_channels) - 1
    want = dict.fromkeys(CUDA_LAUNCHES, 0)
    want.update({"dense_conv_lif": 1, "spike_matmul": n_spiking * t,
                 "lif_step": (n_spiking + 2) * t})
    if launches != want:
        errors.append(f"{name} unfused: CUDA_LAUNCHES {launches} != {want}")

    ref_logits, ref_counts = fused()
    if not torch.equal(logits, ref_logits):
        errors.append(f"{name} unfused vs fused on the card: logits differ by "
                      f"{(logits - ref_logits).abs().max().item()}")
    for k in ref_counts:
        if float(counts[k]) != float(ref_counts[k]):
            errors.append(f"{name} unfused vs fused: {k} spikes {float(counts[k])} "
                          f"!= {float(ref_counts[k])}")
    if logits.shape != (SLOTS, cfg.num_classes) or not bool(torch.isfinite(logits).all()):
        errors.append(f"{name} unfused: logits {tuple(logits.shape)} not finite")

    cpu_logits, cpu_counts = vgg9_infer_hybrid_unfused(params_cpu, images, cfg, device="cpu")
    d_logits = (logits.cpu() - cpu_logits).abs().max().item()
    d_spikes = {k: abs(float(counts[k]) - float(cpu_counts[k])) / max(float(cpu_counts[k]), 1.0)
                for k in counts}
    if d_logits > 0.02 or max(d_spikes.values()) > 1e-3:
        errors.append(f"{name} unfused card vs CPU logits {d_logits} spikes {d_spikes}")

    fused_ms, unfused_ms = cuda_ms(torch, fused), cuda_ms(torch, unfused)
    print(f"unfused {name}: bit-identical to fused {torch.equal(logits, ref_logits)}; "
          f"card vs CPU max|dlogits|={d_logits} max rel dspikes={max(d_spikes.values()):.3e}; "
          f"launches {launches}")
    print(f"unfused {name}: forward ms (CUDA events, 8 images) fused {fused_ms:.4f} "
          f"unfused {unfused_ms:.4f}")
    return {"launches": launches, "fused_ms": fused_ms, "unfused_ms": unfused_ms,
            "counts": {k: float(v) for k, v in counts.items()}, "d_logits_cpu": d_logits}


# ---------------------------------------------------------------------------
# phase 6: training on the card
# ---------------------------------------------------------------------------

def check_training(torch, name, cfg, errors):
    import numpy as np
    from repro_torch.data.synthetic import image_batch
    from repro_torch.models.vgg9 import init_vgg9, vgg9_forward, vgg9_loss
    from repro_torch.train.optim import adamw
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import init_train_state, make_train_step, value_and_grad

    loss_fn = lambda p, b: vgg9_loss(p, b, cfg)
    params_cpu = init_vgg9(torch.Generator().manual_seed(0), cfg, "cpu")
    params = {k: {kk: v.to("cuda") for kk, v in leaf.items()} for k, leaf in params_cpu.items()}

    # one step's loss and gradients, card against CPU, on the same batch of 8
    batch = image_batch(0, 0, 8, num_classes=cfg.num_classes, hw=cfg.img_hw)
    grad_fn = value_and_grad(loss_fn)
    cpu_loss, cpu_grads = grad_fn(params_cpu, batch)
    loss, grads = grad_fn(params, {k: v.to("cuda") for k, v in batch.items()})
    d_loss = abs(loss.item() - cpu_loss.item())
    rel = {f"{layer}.{k}": (grads[layer][k].cpu() - g).norm().item() / max(g.norm().item(), 1e-30)
           for layer, leaf in cpu_grads.items() for k, g in leaf.items()}
    worst = max(rel, key=rel.get)
    if d_loss > 1e-4 or rel[worst] > 1e-3:
        errors.append(f"{name} train: card vs CPU loss {d_loss} worst grad {worst} {rel[worst]}")
    print(f"train {name}: batch 8 card vs CPU |dloss|={d_loss:.3e} (loss {loss.item():.6f}); "
          f"worst gradient rel L2 {worst} {rel[worst]:.3e}")

    # 5 steps at batch 32, twice from one state with the training step's
    # deterministic settings (the two runs must agree bit for bit), then
    # twice with them swapped out, for their cost and to show what they fix
    from repro_torch.train import train_step as train_step_mod
    steps = 5
    opt = adamw(weight_decay=0.0)
    step = make_train_step(loss_fn, opt, warmup_cosine(3e-3, 20, steps))
    state0 = init_train_state(params, opt)
    test = image_batch(77, 0, 64, num_classes=cfg.num_classes, hw=cfg.img_hw, device="cuda")

    def run():
        state, losses, times = state0, [], []
        for i in range(steps):
            b = image_batch(0, i, 32, num_classes=cfg.num_classes, hw=cfg.img_hw,
                            device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
        with torch.no_grad():
            _, counts = vgg9_forward(state["params"], test["images"], cfg)
        return {"state": state, "losses": losses, "ms": times,
                "median_ms": float(np.median(times)),
                "spikes": {k: float(v) for k, v in counts.items()}}

    runs, deterministic = {}, train_step_mod.deterministic
    try:
        for det, default in ("AC", "BD"):       # in turns
            runs[det] = run()
            train_step_mod.deterministic = contextlib.nullcontext
            runs[default] = run()
            train_step_mod.deterministic = deterministic
    finally:
        train_step_mod.deterministic = deterministic
    same = {pair: tree_equal(torch, runs[pair[0]]["state"], runs[pair[1]]["state"])
            and runs[pair[0]]["losses"] == runs[pair[1]]["losses"] for pair in ("AB", "CD")}
    if not all(math.isfinite(v) for r in runs.values() for v in r["losses"]):
        errors.append(f"{name} train: losses {[r['losses'] for r in runs.values()]}")
    if not same["AB"]:
        errors.append(f"{name} train: two deterministic 5-step runs from one state differ: "
                      f"losses {runs['A']['losses']} vs {runs['B']['losses']}")
    for key, r in sorted(runs.items()):
        print(f"train {name} run {key} ({'deterministic' if key in 'AB' else 'default'}): "
              f"{steps} steps at batch 32, losses {[round(v, 6) for v in r['losses']]}, "
              f"host ms/step (synchronized) {[round(v, 3) for v in r['ms']]}, "
              f"median {r['median_ms']:.3f}, spikes after {sum(r['spikes'].values()):.0f}")
    print(f"train {name}: deterministic runs A, B bit-identical (losses, params, optimizer "
          f"state) {same['AB']}; default runs C, D bit-identical {same['CD']}")
    spikes = runs["A"]["spikes"]
    return {"d_loss": d_loss, "worst_grad": [worst, rel[worst]], "losses": runs["A"]["losses"],
            "ms_per_step": runs["A"]["ms"], "median_ms": runs["A"]["median_ms"],
            "spikes_after": spikes, "bit_identical": same,
            "runs": {k: {kk: v for kk, v in r.items() if kk != "state"}
                     for k, r in runs.items()}}


def tree_equal(torch, a, b) -> bool:
    """Two trees of tensors (dicts, tuples) bit for bit (keys, dtypes,
    shapes and bits)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(torch, a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(tree_equal(torch, x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# phase 7: the LM (qwen1.5-4b) served on the card
# ---------------------------------------------------------------------------

LM_SLOTS, LM_MAX_SEQ, LM_CHUNK, LM_NEW, LM_SPECULATE = 4, 512, 8, 16, 4
# card vs CPU: logits are sums of 2560-6912 fp32 products taken in other
# orders (cuBLAS vs the CPU's BLAS), through two layers; the observed
# differences are ~1e-5 on logits of order one, so 1e-3 leaves a wide margin
# while still catching a wrong kernel or a wrong mask
LM_CPU_TOL = 1e-3


def sync(torch, device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def lm_trace(vocab):
    """8 requests, 16 new tokens each: prompts of 5-200 random tokens, one
    empty prompt (index 4), one repetitive prompt (index 6) and one sampled
    request (index 2: temperature 0.8, top-p 0.9, seed 0)."""
    import numpy as np
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, vocab, n).tolist() for n in (5, 200, 37, 120, 0, 64, 0, 90)]
    prompts[6] = [11, 12, 13, 14, 15] * 6
    opts = [{} for _ in prompts]
    opts[2] = dict(temperature=0.8, top_p=0.9, seed=0)
    return prompts, opts


def lm_serve(torch, runner, prompts, opts, device, profile_at=None, profile_steps=3):
    """Serve the trace through one EngineCore; returns (results in order,
    host ms of each unprofiled step (synchronized), profile or None). With
    ``profile_at``, steps profile_at .. profile_at + profile_steps - 1 run
    under one torch.profiler window that traces the device only (tracing
    the host's ~4,000 ops per decode step too cost a minute per window to
    collect): (kernel ms, wall ms, steps, the top kernels as (name, ms per
    step, launches per step))."""
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.core import EngineCore
    core = EngineCore(runner, EngineConfig(slots=LM_SLOTS, prefill_chunk=LM_CHUNK))
    ids = [core.submit(p, max_new_tokens=LM_NEW, **o) for p, o in zip(prompts, opts)]
    times, prof, i = [], None, 0
    while core.pending() or core.in_flight():
        if i == profile_at:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as trace:
                t0 = time.perf_counter()
                for _ in range(profile_steps):
                    core.step()
                sync(torch, device)
                wall = (time.perf_counter() - t0) * 1e3
            kernels = sorted((e for e in trace.key_averages()
                              if e.device_type == torch.autograd.DeviceType.CUDA
                              and e.self_device_time_total > 0),
                             key=lambda e: e.self_device_time_total, reverse=True)
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            top = [(e.key, e.self_device_time_total / 1e3 / profile_steps,
                    e.count // profile_steps) for e in kernels[:8]]
            prof = (busy, wall, profile_steps, top)
            i += profile_steps
            continue
        t0 = time.perf_counter()
        core.step()
        sync(torch, device)
        times.append((time.perf_counter() - t0) * 1e3)
        i += 1
    results = core.run_until_complete()
    return [results[r] for r in ids], times, prof


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def decode_bound_ms(torch, cfg, params, cache) -> float:
    """The least time of one decode step on the cache's slots: every weight
    it reads once (the embedding table only where the LM head is tied to
    it, else the 4 rows it gathers are left out; every expert, padded ones
    included, as the reference's formulation multiplies them all), the
    whole KV cache (attention scores every slot) and the recurrent state
    read and written once, at 3.35 TB/s."""
    weights = {k: v for k, v in params.items() if k != "embed" or cfg.tie_embeddings}
    kv = recurrent = 0
    for blk in list(cache["periods"].values()) + list(cache["tail"]):
        for key, leaf in blk.items():
            if key in ("k", "v"):
                kv += tree_bytes(leaf)
            else:
                recurrent += tree_bytes(leaf)
    moved = tree_bytes(weights) + kv + 2 * recurrent
    return moved / HBM_BYTES_PER_S * 1e3


def routed_bound_ms(torch, cfg, params, cache, step) -> float:
    """`decode_bound_ms` with each MoE layer's experts cut to the ones that
    ``step()`` (one decode step) routes a row to."""
    with Routes() as routes:
        step()
    routed = [int(torch.unique(idx).numel()) for _, idx in routes.calls]
    experts = [blk["moe"]["experts"] for blk in list(params["periods"].values())
               + list(params["tail"]) if "moe" in blk]
    all_experts = sum(tree_bytes(e) for e in experts)
    # one call per MoE layer; every layer holds the same expert shapes
    per_expert = all_experts / (len(routed) * experts[0]["w_in"].shape[-3])
    unrouted = all_experts - per_expert * sum(routed)
    return decode_bound_ms(torch, cfg, params, cache) - unrouted / HBM_BYTES_PER_S * 1e3


def check_lm_serving(torch, cfg, device, errors, trace=None, speculate=LM_SPECULATE,
                     solo=(6, 1), precisions=(0, 4), smi=""):
    """Phases 7a and 9: ``cfg`` (full width; 9a cuts the depth) served on
    ``device`` in each of ``precisions`` (0 = fp32, 4 = int4 fake-quant) by
    EngineCore + LMRunner: 4 slots, prefill chunk 8, speculation k =
    ``speculate``, the ``trace`` (`lm_trace` by default). Every request
    emits its budget inside the vocab; the ``solo`` requests served alone
    without speculation equal their streams in the batch; host ms per
    engine step. The first precision alone is warmed up, profiled (device
    busy from torch.profiler) and timed per decode step against the step's
    bound: the fake-quant view changes the weights' values, not the work."""
    import copy
    import numpy as np
    from repro_torch.models import transformer as tf
    from repro_torch.serve.runners.lm import LMRunner
    prompts, opts = (trace or lm_trace)(cfg.vocab)
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device=device).manual_seed(0), cfg, device)
    sync(torch, device)
    init_s = time.perf_counter() - t0
    out = {"init_s": init_s, "params_bytes": tree_bytes(params)}
    for bits in precisions:
        name = f"int{bits}" if bits else "fp32"
        first = bits == precisions[0]
        runner = LMRunner(cfg, params, max_seq=LM_MAX_SEQ, quant_bits=bits,
                          speculate_k=speculate, device=device)
        plain = copy.copy(runner)                     # the same weights, no speculation
        plain.speculate_k = 0
        if first:
            lm_serve(torch, runner, prompts[:1], opts[:1], device)        # warm-up
        t1 = time.perf_counter()
        res, times, prof = lm_serve(torch, runner, prompts, opts, device,
                                    profile_at=6 if first else None)
        for i, (p, r) in enumerate(zip(prompts, res)):
            new = r.outputs[len(p):]
            if r.status != "ok" or len(new) != LM_NEW or r.outputs[:len(p)] != p \
                    or not all(0 <= t < cfg.vocab for t in r.outputs):
                errors.append(f"lm {cfg.name} {name}: request {i} status={r.status} "
                              f"emitted {len(new)}")
        drafted = sum(r.stats["drafted_tokens"] for r in res)
        t2 = time.perf_counter()
        # requests served alone without speculation: equal to their streams
        # in the (speculative) batch
        alone = {i: lm_serve(torch, plain, [prompts[i]], [opts[i]], device)[0][0].outputs
                 for i in solo}
        for i, stream in alone.items():
            if stream != res[i].outputs:
                errors.append(f"lm {cfg.name} {name}: request {i} served alone without "
                              f"speculation differs from the batch")
        row = {"steps": len(times) + (prof[2] if prof else 0), "ms_per_step": times,
               "median_ms_per_step": float(np.median(times)), "drafted": drafted,
               "accepted": sum(r.stats["accepted_tokens"] for r in res),
               "solo_equal": sorted(alone), "trace_s": t2 - t1,
               "solo_s": time.perf_counter() - t2,
               "outputs": [r.outputs[len(p):] for p, r in zip(prompts, res)]}
        out[name] = row
        print(f"lm {cfg.name} {name} [{smi}]: {len(prompts)} requests, {row['steps']} engine "
              f"steps, host {row['median_ms_per_step']:.3f} ms per engine step (median, "
              f"synchronized; up to {LM_CHUNK} decode steps each); drafted {drafted}, "
              f"accepted {row['accepted']}; requests {sorted(alone)} alone = batch; trace "
              f"{row['trace_s']:.1f} s, solo {row['solo_s']:.1f} s")
        if first:
            row.update(decode_step(torch, cfg, plain, device, prof, row, smi))
        del runner, plain
    del params
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    return out


def decode_step(torch, cfg, runner, device, prof, row, smi):
    """One plain decode step of ``runner`` on 4 slots: host ms, against its
    bound (and for MoE the routed experts' bound), and the profiled engine
    steps' device busy beside ``row``'s median engine step."""
    import numpy as np
    from repro_torch.models import transformer as tf
    sess = runner.open_session(LM_SLOTS)
    tokens = torch.ones((LM_SLOTS, 1), dtype=torch.long, device=device)
    pos = torch.full((LM_SLOTS,), LM_MAX_SEQ // 2, device=device)
    step = lambda: tf.decode_step(runner.params, sess.cache, {"tokens": tokens}, pos, cfg)
    step_ms = []
    for _ in range(6):
        t1 = time.perf_counter()
        step()
        sync(torch, device)
        step_ms.append((time.perf_counter() - t1) * 1e3)
    bound_ms = decode_bound_ms(torch, cfg, runner.params, sess.cache)
    routed_ms = routed_bound_ms(torch, cfg, runner.params, sess.cache, step) \
        if cfg.n_experts else None
    busy, wall, n_prof, top = prof
    out = {"decode_step_ms": step_ms, "median_decode_step_ms": float(np.median(step_ms[1:])),
           "decode_bound_ms": bound_ms, "routed_bound_ms": routed_ms,
           "profiled_steps": n_prof, "profiled_wall_ms": wall, "profiled_busy_ms": busy,
           "profiled_top": top}
    routed = "" if routed_ms is None else f" (routed experts only: {routed_ms:.3f} ms)"
    print(f"lm {cfg.name} [{smi}]: one decode step on {LM_SLOTS} slots "
          f"{out['median_decode_step_ms']:.3f} ms against a bound of {bound_ms:.3f} ms"
          f"{routed}; profiled steps 6-{5 + n_prof}: device busy {busy / n_prof:.3f} ms/step, "
          f"{100 * busy / wall:.1f}% of their {wall / n_prof:.3f} ms/step under the profiler, "
          f"{100 * busy / n_prof / row['median_ms_per_step']:.1f}% of the unprofiled median "
          f"step")
    print(f"lm {cfg.name}: top device ms/step (launches/step): "
          + ", ".join(f"{k[:40]} {ms:.3f} ({n})" for k, ms, n in top))
    return out


def first_divergence(torch, cfg, params, prompt, a, b):
    """(index, CPU top-2 logit gap) at the first generated token where
    streams a and b differ, or None."""
    from repro_torch.models import transformer as tf
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            seq = torch.tensor([prompt + a[:j]], dtype=torch.long)
            logits, _ = tf.forward(params, {"tokens": seq}, cfg)
            top2 = torch.topk(logits[0, -1], 2).values
            return j, float(top2[0] - top2[1])
    return None


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_device(v, device) for v in tree)
    return tree.to(device)


def compare_decode_chunk(torch, cfg, params, cpu, device, rng, errors):
    """`decode_chunk` logits of 4 ragged rows (16 columns) on the card
    against the CPU: (max |dlogits|, columns with a CPU top-2 gap above
    tol, columns)."""
    from repro_torch.models import transformer as tf
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (LM_SLOTS, 16)))
    pos0, take = torch.tensor([0, 3, 0, 7]), torch.tensor([16, 11, 16, 6])
    _, card, _ = tf.decode_chunk(params, tf.init_cache(cfg, LM_SLOTS, 64, device),
                                 toks.to(device), pos0.to(device), take.to(device), cfg)
    _, ref, _ = tf.decode_chunk(cpu, tf.init_cache(cfg, LM_SLOTS, 64, "cpu"), toks, pos0,
                                take, cfg)
    card = card.cpu()
    worst, flips, clear = 0.0, 0, 0
    for r in range(LM_SLOTS):
        cols = slice(0, int(take[r]))
        worst = max(worst, (card[r, cols] - ref[r, cols]).abs().max().item())
        top2 = torch.topk(ref[r, cols], 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > LM_CPU_TOL
        clear += int(sure.sum())
        flips += int((card[r, cols].argmax(-1) != ref[r, cols].argmax(-1))[sure].sum())
    if worst > LM_CPU_TOL or flips:
        errors.append(f"lm {cfg.name} card vs CPU: decode_chunk max|dlogits| {worst} (tol "
                      f"{LM_CPU_TOL}), {flips} argmax flips where the CPU's top-2 gap "
                      f"exceeds it")
    return worst, clear, int(take.sum())


def check_lm_against_cpu(torch, cfg, device, errors):
    """Phase 7b: qwen at full width and depth 2, the card against the CPU."""
    import numpy as np
    from repro_torch.models import transformer as tf
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.core import EngineCore
    from repro_torch.serve.runners.lm import LMRunner
    params = tf.init_params(torch.Generator(device=device).manual_seed(1), cfg, device)
    cpu = to_device(params, "cpu")

    rng = np.random.default_rng(8)
    worst, clear, columns = compare_decode_chunk(torch, cfg, params, cpu, device, rng, errors)

    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (3, 17, 40, 9)]
    streams = {}
    for dev, p in ((device, params), ("cpu", cpu)):
        core = EngineCore(LMRunner(cfg, p, max_seq=64, device=dev),
                          EngineConfig(slots=LM_SLOTS, prefill_chunk=LM_CHUNK))
        ids = [core.submit(q, max_new_tokens=8) for q in prompts]
        res = core.run_until_complete()
        streams[dev] = [res[i].outputs[len(q):] for i, q in zip(ids, prompts)]
    diverged = []
    for q, a, b in zip(prompts, streams["cpu"], streams[device]):
        d = first_divergence(torch, cfg, cpu, q, a, b)
        if d is not None:
            diverged.append(d)
            if d[1] > LM_CPU_TOL:
                errors.append(f"lm card vs CPU: greedy streams differ at token {d[0]} "
                              f"where the CPU's top-2 gap is {d[1]}")
    print(f"lm card vs CPU ({cfg.n_layers} layers, full width): decode_chunk max|dlogits| "
          f"{worst:.3e} (tol {LM_CPU_TOL}) over {columns} columns, argmax equal at "
          f"all {clear} columns with a top-2 gap above tol; served streams "
          f"{'equal' if not diverged else f'diverge at (token, top-2 gap) {diverged}'}")
    return {"max_dlogits": worst, "clear_columns": clear, "diverged": diverged}, params


def check_serve_lm_w4(torch, errors, arch="qwen1.5-4b", tokens=12):
    """Phases 7c and 9d: `launch/serve_lm_w4.py --arch ARCH --full`, the int4
    matmul's main path: exits, every stream emits ``tokens``, and its one
    kernel-6 launch within phase 3's bar of `int4_matmul_plain`."""
    from repro_torch.kernels import CUDA_LAUNCHES, reset_cuda_launches
    from repro_torch.kernels.int4_matmul import ops as i4
    from repro_torch.launch import serve_lm_w4
    t0 = time.perf_counter()
    reset_cuda_launches()
    res = serve_lm_w4.main(["--arch", arch, "--full", "--tokens", str(tokens),
                            "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(CUDA_LAUNCHES)
    ref = i4.int4_matmul_plain(res["x"], res["qt"].packed, res["qt"].scale)
    err = (res["y"] - ref).abs().max().item()
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    emitted = [len(s) for bits in res["streams"].values() for s in bits]
    if err > tol or launches["int4_matmul"] != 1 or set(emitted) != {tokens}:
        errors.append(f"serve_lm_w4 --arch {arch} --full: err {err} (tol {tol}) launches "
                      f"{launches} emitted {emitted}")
    out = {"launches": launches, "err": err, "tol": tol, "streams": res["streams"],
           "x": tuple(res["x"].shape), "packed": tuple(res["qt"].packed.shape),
           "seconds": time.perf_counter() - t0}
    del res
    torch.cuda.empty_cache()
    print(f"serve_lm_w4 --arch {arch} --full: x{out['x']} @ packed{out['packed']}, "
          f"max|y - int4_matmul_plain| {err:.3e} (tol {tol:.1e}), launches "
          f"{launches['int4_matmul']}, {len(emitted)} streams of {tokens} tokens, "
          f"{out['seconds']:.1f} s")
    return out


def check_prefill_attention(torch, cfg, params, errors, seq=2048):
    """Phase 7d: layer 0 of a 2048-token prefill: embed -> rmsnorm -> q/k/v,
    through `flash_attention` and the model's `chunked_causal_attention`,
    in fp32 and with q, k, v cast to bf16 (the reference then takes the same
    bf16 values in fp32)."""
    import numpy as np
    from repro_torch.kernels import CUDA_LAUNCHES, reset_cuda_launches
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import attention, layers
    from repro_torch.models import transformer as tf
    toks = torch.from_numpy(np.random.default_rng(9).integers(1, cfg.vocab, (1, seq))).cuda()
    p0 = tf._period(params["periods"], 0)["slot0"]
    h = layers.rmsnorm(tf._embed(params, {"tokens": toks}, cfg), p0["norm1"], cfg.norm_eps)
    qkv32 = attention._project_qkv(p0["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                   cfg.rope_theta, torch.arange(seq, device="cuda")[None])
    res = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = (t.to(dtype) for t in qkv32)
        reset_cuda_launches()
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        launches = dict(CUDA_LAUNCHES)
        chunked = lambda: attention.chunked_causal_attention(
            q.float(), k.float(), v.float(), q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        ref = chunked()
        err = (out.float() - ref).abs().max().item()
        # fp32: the JAX test's bar; bf16: one rounding step of the largest output
        tol = 5e-5 if dtype == torch.float32 else 2 ** -7 * max(1.0, ref.abs().max().item())
        same = torch.equal(out, flash_attention(q, k, v))
        if err > tol or not same or launches["flash_attention"] != 1:
            errors.append(f"prefill attention {name}: flash vs chunked {err} (tol {tol}) "
                          f"bit-identical rerun {same} launches {launches}")
        flash_ms, chunked_ms = cuda_ms(torch, lambda: flash_attention(q, k, v), reps=5), \
            cuda_ms(torch, chunked, reps=5)
        print(f"lm layer-0 prefill attention {name}, S={seq}: flash_attention vs "
              f"chunked_causal_attention (q_chunk {cfg.q_chunk}, kv_chunk {cfg.kv_chunk}) "
              f"max|d| {err:.3e} (tol {tol:.1e}); rerun bit-identical {same}; "
              f"ms {flash_ms:.4f} vs {chunked_ms:.4f}")
        res[name] = {"launches": launches, "err": err, "tol": tol, "flash_ms": flash_ms,
                     "chunked_ms": chunked_ms}
    return res


# ---------------------------------------------------------------------------
# phase 8: adaptive precision, observability, the CLI and the study
# ---------------------------------------------------------------------------

PRECISION_MODES = ("fp32", "int4", "adaptive")


def precision_options(n):
    """make_requests' sources, every third request pinned to fp32."""
    return [dict(source="sparse" if i % 2 == 0 else "dense",
                 **({"pin_precision": "fp32"} if i % 3 == 0 else {})) for i in range(n)]


def precision_engine(registry, cfg, mode, obs=None):
    """One engine over the shared registry: `PrecisionRunner` in ``mode``
    with a fresh controller bound to a fresh sparsity scheduler."""
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.core import EngineCore
    from repro_torch.serve.precision import (PrecisionController, PrecisionRunner,
                                             bind_controller, make_snn_pricer)
    from repro_torch.serve.scheduler import make_scheduler
    controller = PrecisionController(pricer=make_snn_pricer(cfg), dense_threshold=0.8)
    scheduler = make_scheduler("sparsity")
    bind_controller(scheduler, controller)
    engine = EngineCore(PrecisionRunner(registry, controller, mode=mode),
                        EngineConfig(slots=SLOTS, scheduler="sparsity", precision=mode),
                        scheduler=scheduler, obs=obs)
    return engine, controller, scheduler


def serve_waves(torch, engine, imgs, options, device):
    """The trace in two waves, as the reference's precision benchmark
    serves it (the second wave is decided with what the first taught the
    scheduler). Returns (results in order, one (request ids admitted,
    hand-kernel launches, synchronized host ms) per engine step)."""
    from repro_torch.kernels import CUDA_LAUNCHES
    half = len(imgs) // 2
    results, steps = [], []
    for lo, hi in ((0, half), (half, len(imgs))):
        ids = [engine.submit(img, **o) for img, o in zip(imgs[lo:hi], options[lo:hi])]
        while engine.pending() or engine.in_flight():
            logged, before = len(engine.admission_log), dict(CUDA_LAUNCHES)
            t0 = time.perf_counter()
            engine.step()
            sync(torch, device)
            ms = (time.perf_counter() - t0) * 1e3
            steps.append(([i for _, a in engine.admission_log[logged:] for i in a],
                          {k: CUDA_LAUNCHES[k] - before[k] for k in before}, ms))
        done = engine.run_until_complete()
        results += [done[i] for i in ids]
    return results, steps


def decision_log(controller):
    return [(d.request_id, d.precision, d.reason, d.predicted_skip, d.prices)
            for d in controller.decisions]


def learned_state(controller, scheduler):
    """The EWMAs a decision rests on: the controller's per precision and
    the scheduler's per source (what it publishes to a registry)."""
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    scheduler.metrics_into(reg)
    return {"controller_skip_ewma": dict(controller.skip_ewma),
            "scheduler": {k: v["value"] for k, v in reg.snapshot().items()}}


def profile_precision(torch, registry, cfg, mode, imgs, options):
    """Device kernel ms per engine step of one served trace in ``mode``,
    from torch.profiler (kernel events only), total and per hand kernel."""
    import re
    from torch.profiler import ProfilerActivity, profile
    engine, _, _ = precision_engine(registry, cfg, mode)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, steps = serve_waves(torch, engine, imgs, options, "cuda")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    n = len(steps)
    hand = {}
    for kname, functions in hand_kernel_functions().items():
        found = [e for e in kernels if re.search(rf"\b({'|'.join(functions)})\b", e.key)]
        if found:
            hand[kname] = sum(e.self_device_time_total for e in found) / 1e3 / n
    return sum(e.self_device_time_total for e in kernels) / 1e3 / n, hand


def quantized_view_ms(torch, params, cfg, calls=10):
    """What the int4 variant's forward adds before its first kernel: the
    fake-quant view of every weight leaf (`models.vgg9.quantized_view`),
    recomputed per forward. Device ms per call (torch.profiler) and
    synchronized host ms per call."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.vgg9 import quantized_view
    int4 = dataclasses.replace(cfg, quant_bits=4)
    quantized_view(params, int4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        quantized_view(params, int4)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            quantized_view(params, int4)
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls
    return device_ms, host_ms


def check_precision_serving(torch, cfg, params_cpu, errors):
    """Phases 8a and 8b: adaptive SNN serving at full width, then the
    adaptive run again with the observability plane attached."""
    import numpy as np
    from repro_torch.kernels import CUDA_LAUNCHES, reset_cuda_launches
    from repro_torch.obs import Observability, to_prometheus
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.core import EngineCore
    from repro_torch.serve.precision import make_snn_variants

    params = {k: {kk: v.to("cuda") for kk, v in leaf.items()} for k, leaf in params_cpu.items()}
    imgs = make_requests(torch, cfg)
    options = precision_options(len(imgs))
    pinned = [i for i, o in enumerate(options) if "pin_precision" in o]
    n_spiking = len(cfg.conv_channels) - 1
    per_precision = {"dense_conv_lif": 1, "spike_matmul_mapped": n_spiking,
                     "lif_epilogue_scan": n_spiking + 2}

    t0 = time.perf_counter()
    registry = make_snn_variants(cfg, params, device="cuda")
    registry.prewarm(SLOTS)
    torch.cuda.synchronize()
    out = {"prewarm_s": time.perf_counter() - t0, "modes": {}}

    # the bit-identity references: plain single-precision SNNRunner engines
    refs = {}
    for prec in registry.precisions:
        engine = EngineCore(registry.runner(prec), EngineConfig(slots=SLOTS))
        ids = [engine.submit(img, **o) for img, o in zip(imgs, options)]
        done = engine.run_until_complete()
        refs[prec] = [done[i].outputs for i in ids]

    runs = {}
    for mode in PRECISION_MODES:
        engine, controller, scheduler = precision_engine(registry, cfg, mode)
        reset_cuda_launches()
        res, steps = serve_waves(torch, engine, imgs, options, "cuda")
        launches = dict(CUDA_LAUNCHES)
        served = [r.stats["precision"] for r in res]
        runs[mode] = (res, engine, controller, scheduler, launches)
        for i in pinned:
            if served[i] != "fp32":
                errors.append(f"precision {mode}: pinned request {i} served {served[i]}")
        for i, r in enumerate(res):
            if r.status != "ok" or not np.array_equal(r.outputs, refs[served[i]][i]):
                errors.append(f"precision {mode}: request {i} ({served[i]}) status={r.status}, "
                              f"logits differ from the single-precision engine's")
        by_id = {r.request_id: p for r, p in zip(res, served)}
        for admitted, step_launches, _ in steps:
            occupied = len({by_id[i] for i in admitted})
            want = {k: per_precision.get(k, 0) * occupied for k in step_launches}
            if step_launches != want:
                errors.append(f"precision {mode}: a step admitting {admitted} launched "
                              f"{step_launches}, want {want} ({occupied} precisions)")
        step_ms = [ms for _, _, ms in steps]
        out["modes"][mode] = {
            "precision_counts": {p: served.count(p) for p in registry.precisions},
            "served_energy_j": float(np.mean([r.stats["served_energy_j"] for r in res])),
            "served_energy_analytical_j": float(np.mean(
                [r.stats["served_energy_analytical_j"] for r in res])),
            "steps": len(steps), "ms_per_step": step_ms,
            "median_ms_per_step": float(np.median(step_ms)),
            "occupied_precisions_per_step": [len({by_id[i] for i in a}) for a, _, _ in steps],
            "launches": launches, "served": served}
    fp32 = out["modes"]["fp32"]
    for mode, row in out["modes"].items():
        row["win_eq3"] = fp32["served_energy_j"] / row["served_energy_j"]
        row["win_analytical"] = fp32["served_energy_analytical_j"] / \
            row["served_energy_analytical_j"]
    adaptive = out["modes"]["adaptive"]
    if not (adaptive["win_eq3"] > 1.0 and adaptive["win_analytical"] > 1.0):
        errors.append(f"precision: adaptive served energy not below pinned fp32's "
                      f"(Eq. 3 x{adaptive['win_eq3']}, analytical x{adaptive['win_analytical']})")
    out["controller"] = runs["adaptive"][2].summary()

    # device busy share per mode, and what the int4 forward's weight view costs
    for mode, row in out["modes"].items():
        busy, hand = profile_precision(torch, registry, cfg, mode, imgs, options)
        row.update(busy_ms_per_step=busy, busy_share=busy / row["median_ms_per_step"],
                   hand_kernel_ms_per_step=hand)
    out["quantized_view_device_ms"], out["quantized_view_host_ms"] = \
        quantized_view_ms(torch, params, cfg)

    # the same adaptive engine on the CPU's plain path: the same decisions
    cpu_registry = make_snn_variants(cfg, params_cpu, device="cpu")
    cpu_engine, cpu_controller, cpu_scheduler = precision_engine(cpu_registry, cfg, "adaptive")
    cpu_res, _ = serve_waves(torch, cpu_engine, imgs, options, "cpu")
    cpu_served = [r.stats["precision"] for r in cpu_res]
    res, _, controller, scheduler, _ = runs["adaptive"]
    out["cpu_served"] = cpu_served
    out["cpu_max_dlogits"] = max(float(np.abs(a.outputs - b.outputs).max())
                                 for a, b in zip(res, cpu_res))
    if cpu_served != adaptive["served"]:
        card_log = {d[0]: d for d in decision_log(controller)}
        cpu_log = {d[0]: d for d in decision_log(cpu_controller)}
        for r, a, b in zip(res, adaptive["served"], cpu_served):
            if a != b:
                print(f"  precision mismatch: request {r.request_id} card {a} "
                      f"{card_log.get(r.request_id)} CPU {b} {cpu_log.get(r.request_id)}")
        print(f"  card EWMAs {learned_state(controller, scheduler)}")
        print(f"  CPU EWMAs {learned_state(cpu_controller, cpu_scheduler)}")
        errors.append(f"precision: served precisions on the card {adaptive['served']} "
                      f"!= the CPU's {cpu_served}")

    # 8b: the adaptive run with the observability plane attached
    bundle = Observability()
    obs_engine, obs_controller, _ = precision_engine(registry, cfg, "adaptive", obs=bundle)
    obs_res, obs_steps = serve_waves(torch, obs_engine, imgs, options, "cuda")
    same = (all(np.array_equal(a.outputs, b.outputs) and dict(a.stats) == dict(b.stats)
                for a, b in zip(obs_res, res))
            and obs_engine.admission_log == runs["adaptive"][1].admission_log
            and decision_log(obs_controller) == decision_log(controller))
    snap = bundle.snapshot()
    metrics = snap["metrics"]
    missing = [k for k in ("precision_decisions", "precision_downshifted",
                           "precision_served_fp32", "precision_served_int4",
                           "precision_served_energy_eq3_j",
                           "precision_served_energy_analytical_j") if k not in metrics]
    if not same or missing:
        errors.append(f"precision obs: attached == detached {same}; missing metrics {missing}")
    out["obs"] = {"bit_identical": same, "spans": len(snap["trace"]),
                  "prometheus_lines": len(to_prometheus(metrics).splitlines()),
                  "metrics": len(metrics),
                  "median_ms_per_step": float(np.median([ms for _, _, ms in obs_steps]))}

    for mode, row in out["modes"].items():
        print(f"precision {mode}: served {row['precision_counts']} in {row['steps']} engine "
              f"steps (occupied precisions per step {row['occupied_precisions_per_step']}); "
              f"mean served energy Eq. 3 {row['served_energy_j']:.4e} J, analytical "
              f"{row['served_energy_analytical_j']:.4e} J; win over pinned fp32 Eq. 3 "
              f"x{row['win_eq3']:.4f}, analytical x{row['win_analytical']:.4f}; host "
              f"{row['median_ms_per_step']:.3f} ms/step (median, synchronized); device busy "
              f"{row['busy_ms_per_step']:.3f} ms/step ({100 * row['busy_share']:.1f}% of the "
              f"step); hand kernels ms/step "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["hand_kernel_ms_per_step"].items()))
    print(f"precision: registry prewarm {out['prewarm_s']:.2f} s; quantized_view (int4 weight "
          f"view, once per int4 forward) device {out['quantized_view_device_ms']:.4f} ms, host "
          f"{out['quantized_view_host_ms']:.3f} ms per call; card = CPU served precisions "
          f"{cpu_served == adaptive['served']}, max|dlogits| {out['cpu_max_dlogits']:.3e}; "
          f"controller {out['controller']}")
    print(f"precision obs: attached == detached {same}; {out['obs']['spans']} spans, "
          f"{out['obs']['metrics']} metrics, {out['obs']['prometheus_lines']} Prometheus lines; "
          f"host {out['obs']['median_ms_per_step']:.3f} ms/step attached against "
          f"{adaptive['median_ms_per_step']:.3f} detached (median, synchronized)")
    return out


def check_lm_precision(torch, cfg, errors):
    """Phase 8c: qwen's fp32 and int4 variants behind one adaptive engine,
    every other request pinned to int4, against plain LMRunner engines."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.core import EngineCore
    from repro_torch.serve.precision import PrecisionRunner, make_lm_variants
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(2), cfg, "cuda")
    t0 = time.perf_counter()
    registry = make_lm_variants(cfg, params, max_seq=LM_MAX_SEQ, device="cuda")
    registry.prewarm(LM_SLOTS)
    torch.cuda.synchronize()
    prewarm_s = time.perf_counter() - t0
    prompts, opts = lm_trace(cfg.vocab)
    pinned = [dict(o, **({"pin_precision": "int4"} if i % 2 else {})) for i, o in enumerate(opts)]
    config = EngineConfig(slots=LM_SLOTS, prefill_chunk=LM_CHUNK)
    engine = EngineCore(PrecisionRunner(registry), config)
    ids = [engine.submit(p, max_new_tokens=LM_NEW, **o) for p, o in zip(prompts, pinned)]
    done = engine.run_until_complete()
    res = [done[i] for i in ids]
    served = [r.stats["precision"] for r in res]
    equal = []
    for prec in registry.precisions:
        plain = EngineCore(registry.runner(prec), config)
        rids = [plain.submit(p, max_new_tokens=LM_NEW, **o) for p, o in zip(prompts, opts)]
        ref = plain.run_until_complete()
        for i, r in enumerate(res):
            if served[i] == prec:
                equal.append(r.outputs == ref[rids[i]].outputs)
                if not equal[-1] or r.status != "ok" or len(r.outputs) != len(prompts[i]) + LM_NEW:
                    errors.append(f"lm precision: request {i} ({prec}) status={r.status}, stream "
                                  f"differs from the plain {prec} engine's")
    if served != ["int4" if i % 2 else "fp32" for i in range(len(prompts))]:
        errors.append(f"lm precision: served {served}")
    print(f"lm precision ({cfg.n_layers} layers, full width): registry prewarm {prewarm_s:.2f} s; "
          f"served {served}; {sum(equal)}/{len(equal)} streams equal to the plain engine's at "
          f"their precision")
    del registry, params
    torch.cuda.empty_cache()
    return {"prewarm_s": prewarm_s, "served": served, "streams_equal": sum(equal)}


def study_table(stdout):
    """The study's rows: {precision: (accuracy, spikes per image, uJ)}."""
    rows = {}
    for line in stdout.splitlines():
        parts = line.split()
        if len(parts) == 5 and parts[-1] == "uJ":
            rows[parts[0]] = tuple(float(x) for x in parts[1:4])
    return rows


def check_entry_points(errors):
    """Phase 8d: the CLI's new flags and the study, each in a subprocess
    (the study also on the CPU, beside it); any non-zero exit fails."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {"serve snn": ["repro_torch.launch.serve", "--workload", "snn", "--scheduler",
                          "sparsity", "--mixed-trace", "--precision", "adaptive",
                          "--metrics", "prom"],
            "serve lm": ["repro_torch.launch.serve", "--workload", "lm", "--scheduler", "slo",
                         "--slo-ms", "3000", "--prefill-chunk", "8"],
            "study": ["repro_torch.launch.quant_sparsity_study"]}
    cpu_study = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.quant_sparsity_study",
                                  "--device", "cpu"], cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    outs = {}
    try:
        for name, args in runs.items():
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env, text=True,
                                  capture_output=True, timeout=600)
            outs[name] = (proc.returncode, proc.stdout, proc.stderr, time.perf_counter() - t0)
        stdout, stderr = cpu_study.communicate(timeout=600)
    finally:
        if cpu_study.poll() is None:
            cpu_study.kill()
            cpu_study.communicate()
    outs["study cpu"] = (cpu_study.returncode, stdout, stderr, None)
    result = {}
    for name, (rc, stdout, stderr, seconds) in outs.items():
        result[name] = {"rc": rc, "seconds": seconds}
        if rc != 0:
            errors.append(f"{name}: exit {rc}: {stderr[-2000:]}")
    snn_out, lm_out = outs["serve snn"][1], outs["serve lm"][1]
    reqs = [line for line in snn_out.splitlines() if line.startswith("req")]
    statuses = [w for line in lm_out.splitlines() if line.startswith("req")
                for w in line.split() if w.startswith("status=")]
    print(f"cli snn --precision adaptive --metrics prom: rc {outs['serve snn'][0]}, "
          f"{len(reqs)} requests, precisions "
          f"{[w for line in reqs for w in line.split() if w.startswith('precision=')]}, "
          f"{sum(line.startswith('# TYPE') for line in snn_out.splitlines())} metrics; "
          + next((line[:160] for line in snn_out.splitlines()
                  if line.startswith("precision controller")), "no controller line"))
    print(f"cli lm --scheduler slo --slo-ms 3000: rc {outs['serve lm'][0]}, {statuses}")
    card, cpu = study_table(outs["study"][1]), study_table(outs["study cpu"][1])
    if set(card) != {"fp32", "int8", "int4", "int3"} or set(cpu) != set(card) or not all(
            math.isfinite(x) for row in list(card.values()) + list(cpu.values()) for x in row):
        errors.append(f"study: tables card {card} CPU {cpu}")
    print(f"study ({outs['study'][3]:.1f} s on the card): precision | card accuracy, "
          f"spikes/img, uJ | CPU accuracy, spikes/img, uJ")
    for name in card:
        print(f"  {name:>5} | {card[name]} | {cpu.get(name)}")
    result.update(study_card=card, study_cpu=cpu, lm_statuses=statuses)
    return result


# ---------------------------------------------------------------------------
# phase 9: the rest of the LM family
# ---------------------------------------------------------------------------

# the archs phase 9 runs beside qwen1.5-4b, in the registry's order
FAMILY = ("granite-34b", "starcoder2-15b", "minitron-8b", "recurrentgemma-2b",
          "musicgen-large", "phi-3-vision-4.2b", "llama4-maverick-400b-a17b",
          "granite-moe-3b-a800m", "xlstm-125m")
# phase 9c: the archs held against the CPU, at full width and this many
# periods (plus the tail)
# 9a's depth: a quarter of granite-moe's 32 layers. At full depth 9a took
# 133.5-164.5 s of host-bound engine steps on an H100, which with phase 10
# put the script past ~8.5 minutes; every layer is the same block, so the
# cut runs every op the full model runs.
MOE_LAYERS = 8
CPU_PERIODS = {"granite-moe-3b-a800m": 2, "recurrentgemma-2b": 1, "xlstm-125m": 1,
               "phi-3-vision-4.2b": 2, "musicgen-large": 2}
# an expert set may differ between card and CPU only where the CPU's
# k-th/(k+1)-th router-logit gap is within this (7b's argmax rule, routed)
ROUTE_GAP = 1e-4


def recurrent_trace(vocab):
    """6 requests on 4 slots, 16 new tokens each, so that two are admitted
    into freed slots (indices 4 and 5): prompts of 0-90 random tokens, one
    sampled (index 2: temperature 0.8, top-p 0.9, seed 1)."""
    import numpy as np
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, vocab, n).tolist() for n in (30, 90, 5, 60, 17, 0)]
    opts = [{} for _ in prompts]
    opts[2] = dict(temperature=0.8, top_p=0.9, seed=1)
    return prompts, opts


def check_recurrent_serving(torch, cfg, errors, smi):
    """Phase 9b: a recurrent arch at full width and depth served in fp32,
    freed slots re-admitted (the re-admitted requests served alone equal
    their batch streams), and speculation refused with the reference's
    message."""
    from repro_torch.serve.runners.lm import LMRunner
    out = check_lm_serving(torch, cfg, "cuda", errors, trace=recurrent_trace, speculate=0,
                           solo=(4, 5), precisions=(0,), smi=smi)
    try:
        LMRunner(cfg, None, speculate_k=LM_SPECULATE, device="cuda")
        errors.append(f"lm {cfg.name}: speculate_k={LM_SPECULATE} was not refused")
    except AssertionError as exc:
        out["speculation_refused"] = str(exc)
        if "cannot roll back" not in str(exc):
            errors.append(f"lm {cfg.name}: speculation refused with {exc!r}")
    print(f"lm {cfg.name}: speculate_k={LM_SPECULATE} refused: "
          f"{out.get('speculation_refused')}")
    return out


class Routes:
    """Records each MoE layer's router logits and top-k experts (CPU copies),
    call by call, while active, by wrapping `models.moe._top_k`."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.top_k, self.calls = moe, moe._top_k, []

        def spy(logits, k):
            vals, idx = self.top_k(logits, k)
            self.calls.append((logits.float().cpu(), idx.cpu()))
            return vals, idx
        moe._top_k = spy
        return self

    def __exit__(self, *exc):
        self.moe._top_k = self.top_k


def route_differences(torch, card, cpu, k):
    """(tokens whose expert set differs between the card's and the CPU's
    calls, of those the ones where the CPU's k-th/(k+1)-th router-logit gap
    exceeds ROUTE_GAP, tokens routed)."""
    differ = clear = tokens = 0
    assert len(card) == len(cpu)
    for (_, a), (logits, b) in zip(card, cpu):
        tokens += a.shape[0]
        diff = (a.sort(-1).values != b.sort(-1).values).any(-1)
        top = torch.topk(logits, k + 1, dim=-1).values
        differ += int(diff.sum())
        clear += int((diff & ((top[:, k - 1] - top[:, k]) > ROUTE_GAP)).sum())
    return differ, clear, tokens


def check_arch_against_cpu(torch, cfg, errors, batch=2):
    """Phase 9c: ``cfg`` at full width (its depth cut by the caller) on the
    card against the CPU: `decode_chunk` and `forward` logits (with
    synthesized frontend embeddings where the arch has a frontend) within
    LM_CPU_TOL, argmax equal where the CPU's top-2 gap exceeds it, and for
    MoE no token whose expert set differs where the router's gap exceeds
    ROUTE_GAP, in either run."""
    import numpy as np
    from repro_torch.models import transformer as tf
    from repro_torch.models.frontends import synth_frontend
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(1), cfg, "cuda")
    cpu = to_device(params, "cpu")
    rng = np.random.default_rng(11)
    inputs = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab, (batch, 64)))}
    if cfg.frontend:
        inputs["frontend_embeds"] = synth_frontend(torch.Generator().manual_seed(3), cfg, batch,
                                                   "cpu")
    with Routes() as routes:
        # decode_chunk runs on the card, then on the CPU
        dc_worst, dc_clear, columns = compare_decode_chunk(torch, cfg, params, cpu, "cuda",
                                                           rng, errors)
        n_dc = len(routes.calls)
        out, aux = tf.forward(params, to_device(inputs, "cuda"), cfg)
        out = out.cpu()
        n_card = len(routes.calls)
        ref, ref_aux = tf.forward(cpu, inputs, cfg)
    calls = routes.calls
    worst = (out - ref).abs().max().item()
    top2 = torch.topk(ref, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > LM_CPU_TOL
    flips = int((out.argmax(-1) != ref.argmax(-1))[sure].sum())
    if worst > LM_CPU_TOL or flips or not torch.isfinite(out).all():
        errors.append(f"lm {cfg.name} card vs CPU: forward max|dlogits| {worst} (tol "
                      f"{LM_CPU_TOL}), {flips} argmax flips where the CPU's top-2 gap "
                      f"exceeds it")
    row = {"layers": cfg.n_layers, "decode_chunk_max_dlogits": dc_worst,
           "decode_chunk_columns": columns, "decode_chunk_clear": dc_clear,
           "forward_max_dlogits": worst,
           "forward_positions": int(ref.shape[0] * ref.shape[1]),
           "forward_clear": int(sure.sum()), "aux_card": float(aux), "aux_cpu": float(ref_aux)}
    routed = ""
    if cfg.n_experts:
        differ, clear, tokens = (sum(v) for v in zip(
            route_differences(torch, calls[:n_dc // 2], calls[n_dc // 2:n_dc], cfg.top_k),
            route_differences(torch, calls[n_dc:n_card], calls[n_card:], cfg.top_k)))
        row.update(route_tokens=tokens, route_differ=differ, route_differ_clear=clear)
        if clear:
            errors.append(f"lm {cfg.name} card vs CPU: {clear} tokens route to other experts "
                          f"where the router's k-th/(k+1)-th gap exceeds {ROUTE_GAP}")
        routed = (f"; expert sets equal at {tokens - differ}/{tokens} routed tokens "
                  f"({clear} differ above a {ROUTE_GAP} router gap); aux {float(aux):.6f} "
                  f"vs {float(ref_aux):.6f}")
    front = f", frontend {tuple(inputs['frontend_embeds'].shape)}" if cfg.frontend else ""
    row["seconds"] = time.perf_counter() - t0
    print(f"lm {cfg.name} card vs CPU ({cfg.n_layers} layers, full width{front}): "
          f"decode_chunk max|dlogits| {dc_worst:.3e} over {columns} columns, forward "
          f"{worst:.3e} over {row['forward_positions']} positions (tol {LM_CPU_TOL}), argmax "
          f"equal at all {row['forward_clear']} positions with a top-2 gap above tol{routed}; "
          f"{row['seconds']:.1f} s")
    del params, cpu
    torch.cuda.empty_cache()
    return row


def check_family(torch, errors, smi):
    """Phase 9: (a) granite-moe-3b at full width, `MOE_LAYERS` deep, and (b)
    the two recurrent archs at full width and depth, served; (c) five archs'
    card against the CPU at full
    width, (d) serve_lm_w4 --full for each arch but qwen; the seconds of
    each part."""
    from repro_torch.configs import get_arch
    fp32 = lambda arch, **kw: get_arch(arch).with_(dtype="float32", **kw)
    family = {"serve": {}, "cpu": {}, "serve_lm_w4": {}}
    t = time.perf_counter()
    moe_cfg = fp32("granite-moe-3b-a800m", n_layers=MOE_LAYERS)
    family["serve"][moe_cfg.name] = check_lm_serving(torch, moe_cfg, "cuda", errors, smi=smi)
    family["seconds_a"], t = time.perf_counter() - t, time.perf_counter()
    for arch in ("recurrentgemma-2b", "xlstm-125m"):
        family["serve"][arch] = check_recurrent_serving(torch, fp32(arch), errors, smi)
    family["seconds_b"], t = time.perf_counter() - t, time.perf_counter()
    for arch, periods in CPU_PERIODS.items():
        base = get_arch(arch)
        family["cpu"][arch] = check_arch_against_cpu(
            torch, fp32(arch, n_layers=periods * len(base.pattern) + len(base.tail)), errors,
            batch=1 if base.frontend else 2)
    family["seconds_c"], t = time.perf_counter() - t, time.perf_counter()
    for arch in FAMILY:
        family["serve_lm_w4"][arch] = check_serve_lm_w4(torch, errors, arch, tokens=4)
    family["seconds_d"] = time.perf_counter() - t
    return family


# ---------------------------------------------------------------------------
# phase 11: LM training on the card
# ---------------------------------------------------------------------------

# 11a's batch: 8 sequences of 512 tokens; 11b's card-vs-CPU batch
TRAIN_BATCH, TRAIN_SEQ = 8, 512
CPU_TRAIN_BATCH, CPU_TRAIN_SEQ = 2, 128
# 11a: 2 steps twice from one state, then this many more, at this peak lr
TRAIN_MORE = 6
TRAIN_LR = 1e-3


def train_step_bound(cfg, n_params, batch, seq):
    """Phase 11a: the least time of one train step of an all-MoE arch
    (``attn_moe`` periods) on batch x seq tokens. Flops: the forward's
    projections, causal attention (the half of QK^T and PV a causal mask
    needs), router and expert GEMMs, four times for the checkpointed
    periods (forward, recomputed forward, backward's two products) and
    three times for the LM head; the experts at the reference's padded
    capacity, and routed only beside it. Bytes: the optimizer's state,
    each parameter and moment read and written once and each gradient
    read once. Returns (ms, by, flops, routed flops, bytes)."""
    from repro_torch.core.tiling import round_up
    t = batch * seq
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    attn = 2 * t * d * (h + 2 * kv) * hd + 2 * t * h * hd * d \
        + 2 * batch * h * seq * (seq + 1) * hd
    e = max(cfg.n_experts_padded, cfg.n_experts)
    rows = t * cfg.top_k
    capacity = min(round_up(int(rows / cfg.n_experts * cfg.capacity_factor) + 1, 8), rows)
    mats = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    router = 2 * t * d * e
    per_row = 2 * mats * d * cfg.moe_d_ff
    head = 2 * t * d * cfg.vocab
    flops = 4 * cfg.n_layers * (attn + router + e * capacity * per_row) + 3 * head
    routed = 4 * cfg.n_layers * (attn + router + rows * per_row) + 3 * head
    p_bytes = 2 if cfg.dtype == "bfloat16" else 4
    state_bytes = n_params * (2 * p_bytes + p_bytes + 4 * 4)
    ms, by = bound(state_bytes, flops, BF16_FLOPS)
    return ms, by, flops, routed, state_bytes


def probe_index_backwards(torch, cfg, batch, seq):
    """Phase 11a: each indexing op of the LM step whose backward
    accumulates into repeated indices (``index_put_(accumulate=True)`` or
    ``scatter_add``), at the shapes 11a's step gives it, with the MoE's
    index structure (each token in k sorted rows, capacity-padded expert
    windows, dropped rows repeating capacity - 1): its gradient taken twice
    under the step's deterministic settings. Returns {op: status}, the
    status "raises: ..." or whether the two gradients' bits agree."""
    from repro_torch.core.tiling import round_up
    from repro_torch.train.train_step import deterministic
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    t, d, k = batch * seq, cfg.d_model, cfg.top_k
    e = max(cfg.n_experts_padded, cfg.n_experts)
    rows = t * k
    capacity = min(round_up(int(rows / cfg.n_experts * cfg.capacity_factor) + 1, 8), rows)
    scores = torch.rand((t, cfg.n_experts), generator=g, device=dev)
    flat = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k].reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_expert, src_token = flat[order], order // k
    group = torch.bincount(flat, minlength=e)
    offsets = torch.cumsum(group, 0) - group
    rank = torch.arange(rows, device=dev) - offsets[sorted_expert]
    slot = torch.arange(capacity, device=dev)
    where = torch.empty_like(order)
    where[order] = torch.arange(rows, device=dev)
    per_token = torch.sort(where.reshape(t, k), dim=1).values
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev)
    bf16 = getattr(torch, cfg.dtype)
    ops = {
        "xt[src_token]": ((t, d), bf16, lambda x: x[src_token]),
        "xs_pad[offsets + slot]": ((rows + capacity, d), bf16,
                                   lambda x: x[offsets[:, None] + slot[None, :]]),
        "oe[sorted_expert, rank.clamp]": ((e, capacity, d), bf16,
                                          lambda x: x[sorted_expert, rank.clamp(0, capacity - 1)]),
        "contrib[per_token]": ((rows, d), bf16, lambda x: x[per_token]),
        "w_tok[tokens]": ((cfg.vocab, d), bf16, lambda x: x[tokens]),
        "take_along_dim(logits, labels)": ((batch, seq, cfg.vocab), torch.float32,
                                           lambda x: torch.take_along_dim(x, tokens[..., None],
                                                                          dim=-1)),
    }
    out = {}
    for name, (shape, dtype, fn) in ops.items():
        x = torch.randn(shape, generator=g, device=dev).to(dtype)

        def grad():
            leaf = x.detach().requires_grad_(True)
            with deterministic():
                y = fn(leaf)
                cot = torch.randn(y.shape, generator=torch.Generator(device=dev).manual_seed(9),
                                  device=dev).to(y.dtype)
                return torch.autograd.grad(y, leaf, cot)[0]
        try:
            same = torch.equal(grad(), grad())
            out[name] = "bit-identical" if same else "differs"
        except RuntimeError as exc:
            out[name] = f"raises: {str(exc).splitlines()[0][:160]}"
        del x
    torch.cuda.empty_cache()
    return out


def check_lm_training(torch, errors, smi):
    """Phase 11a (see the module docstring)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import transformer as tf
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.train.tree import tree_leaves
    t0 = time.perf_counter()
    cfg = get_arch("granite-moe-3b-a800m").with_(n_layers=MOE_LAYERS)
    probes = probe_index_backwards(torch, cfg, TRAIN_BATCH, TRAIN_SEQ)
    for name, status in probes.items():
        print(f"train {cfg.name}: backward of {name} under the step's deterministic "
              f"settings: {status}")
        if status != "bit-identical":
            errors.append(f"11a: the backward of {name}: {status}")

    torch.cuda.reset_peak_memory_stats()
    opt = make_optimizer(cfg.optimizer)
    steps = 2 + TRAIN_MORE
    # peak lr 1e-3 after a 2-step warmup: at the launcher's 3e-3 (its
    # default for d_model 64) the full-width bf16 model's loss rose over 8
    # steps on an H100, and a 10-step warmup never reaches the peak in 8
    step = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt,
                           warmup_cosine(TRAIN_LR, 2, steps))
    donated = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt,
                              warmup_cosine(TRAIN_LR, 2, steps), donate=True)
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    n_params = sum(leaf.numel() for leaf in tree_leaves(params))
    state0 = init_train_state(params, opt)
    del params
    pipe = DataPipeline(make_batch_fn(cfg, 0, TRAIN_BATCH, TRAIN_SEQ), device="cuda")

    def run(state, start, n, step=step):
        losses, times, it = [], [], pipe(start)
        for _ in range(n):
            i, batch = next(it)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        it.close()
        return state, losses, times

    a, loss_a, ms_a = run(state0, 0, 2)
    # the second run donated: written into state0's buffers, the first's bits
    b, loss_b, ms_b = run(state0, 0, 2, donated)
    same = loss_a == loss_b and tree_equal(torch, a, b) and b is state0
    del b, state0
    if not same:
        errors.append(f"11a: the donated 2-step run differs from the functional one from "
                      f"one state: losses {loss_a} vs {loss_b}")
    state, loss_more, ms_more = run(a, 2, TRAIN_MORE)
    del a
    losses = loss_a + loss_more
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        errors.append(f"11a: losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    smi_used = gpu_memory("gpu=memory.used,memory.total")

    # one profiled step (the device only, as 7a profiles)
    it = pipe(steps)
    _, batch = next(it)
    it.close()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        t1 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    kernels = sorted((e for e in trace.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [(e.key, e.self_device_time_total / 1e3, e.count) for e in kernels[:8]]
    del state, batch
    torch.cuda.empty_cache()

    bound_ms, bound_by, flops, routed, state_bytes = train_step_bound(
        cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    median = float(np.median(ms_more[1:]))
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (median / 1e3)
    out = {"layers": cfg.n_layers, "params": n_params, "losses": losses,
           "ms_per_step": ms_a + ms_b + ms_more, "median_ms": median, "tokens_per_s": tokens_s,
           "bit_identical": same, "peak_allocated_bytes": peak, "nvidia_smi_memory": smi_used,
           "profiled_wall_ms": wall, "profiled_busy_ms": busy, "profiled_top": top,
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "routed_flops": routed,
           "state_bytes": state_bytes, "index_backwards": probes,
           "seconds": time.perf_counter() - t0}
    print(f"train {cfg.name} ({cfg.n_layers} of {get_arch(cfg.name).n_layers} layers, full "
          f"width, {cfg.dtype}, remat {cfg.remat}, {cfg.optimizer} at peak lr {TRAIN_LR}; "
          f"{n_params} parameters) [{smi}]: batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} through DataPipeline; 2-step runs from one state, functional and "
          f"donated, bit-identical (losses, parameters, optimizer state) {same}; losses "
          f"{[round(v, 6) for v in losses]}")
    print(f"train {cfg.name}: host ms/step (synchronized) {[round(v, 3) for v in out['ms_per_step']]}, "
          f"median of steps 3-{steps - 1} {median:.3f} ms, {tokens_s:.0f} tokens/s; peak allocated "
          f"{peak / 2**30:.2f} GiB; nvidia-smi used, total {smi_used}")
    print(f"train {cfg.name}: profiled step {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%); bound {bound_ms:.3f} ms ({bound_by}: "
          f"{flops / 1e12:.3f} TFLOP at capacity, {routed / 1e12:.3f} routed only = "
          f"{routed / BF16_FLOPS * 1e3:.3f} ms, over {BF16_FLOPS / 1e12:.0f} TFLOP/s; optimizer "
          f"state {state_bytes / 1e9:.3f} GB over {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
          f"{state_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms): the median step at "
          f"{100 * bound_ms / median:.1f}% of its bound")
    print(f"train {cfg.name}: top device ms in the profiled step (launches): "
          + ", ".join(f"{k[:40]} {ms:.3f} ({n})" for k, ms, n in top))
    return out


def check_train_against_cpu(torch, arch, errors):
    """Phase 11b: ``arch`` at full width, one period, fp32 with its own
    remat, one set of weights: the train loss and every gradient on the
    card against the CPU, MoE routes compared as in 9c; and the loss of
    the same weights rounded to bf16 beside it."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.train.tree import keystr, tree_leaves_with_path, tree_map
    t0 = time.perf_counter()
    base = get_arch(arch)
    cfg = base.with_(dtype="float32", n_layers=len(base.pattern) + len(base.tail))
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(2), cfg, "cuda")
    cpu = to_device(params, "cpu")
    batch = token_batch(0, 0, CPU_TRAIN_BATCH, CPU_TRAIN_SEQ, cfg.vocab)
    grad_fn = value_and_grad(lambda p, b: tf.train_loss(p, b, cfg))
    with Routes() as routes:
        loss, grads = grad_fn(params, to_device(batch, "cuda"))
        n_card = len(routes.calls)
        ref_loss, ref_grads = grad_fn(cpu, batch)
    calls = routes.calls
    rel = {keystr(p): (g.cpu() - r).norm().item() / max(r.norm().item(), 1e-30)
           for (p, g), (_, r) in zip(tree_leaves_with_path(grads),
                                     tree_leaves_with_path(ref_grads))}
    worst = max(rel, key=rel.get)
    d_loss = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    row = {"layers": cfg.n_layers, "loss": loss.item(), "loss_cpu": ref_loss.item(),
           "rel_dloss": d_loss, "worst_grad": [worst, rel[worst]]}
    if d_loss > 1e-4 or rel[worst] > 1e-3 or not math.isfinite(loss.item()):
        errors.append(f"11b {arch}: card vs CPU loss rel {d_loss} worst grad {worst} {rel[worst]}")
    routed = ""
    if cfg.n_experts:
        differ, clear, tokens = route_differences(torch, calls[:n_card], calls[n_card:],
                                                  cfg.top_k)
        row.update(route_tokens=tokens, route_differ=differ, route_differ_clear=clear)
        if clear:
            errors.append(f"11b {arch}: {clear} tokens route to other experts where the "
                          f"router's k-th/(k+1)-th gap exceeds {ROUTE_GAP}")
        routed = (f"; expert sets equal at {tokens - differ}/{tokens} routed tokens (forward "
                  f"and recomputed forward; {clear} differ above a {ROUTE_GAP} gap)")
    # the same weights rounded to the dtypes the config's own bf16 gives
    with torch.no_grad():
        bcfg = cfg.with_(dtype="bfloat16")
        dtypes = tf.init_params(torch.Generator(device="cuda").manual_seed(2), bcfg, "cuda")
        bparams = tree_map(lambda like, x: x.to(like.dtype), dtypes, params)
        del dtypes
        bf16_loss = tf.train_loss(bparams, to_device(batch, "cuda"), bcfg).item()
        del bparams
    row["bf16_loss"] = bf16_loss
    row["seconds"] = time.perf_counter() - t0
    print(f"train {arch} card vs CPU ({cfg.n_layers} layers, full width, fp32, remat "
          f"{cfg.remat}, batch {CPU_TRAIN_BATCH} x {CPU_TRAIN_SEQ}): loss {loss.item():.6f} vs "
          f"{ref_loss.item():.6f} (rel {d_loss:.3e}, tol 1e-4), worst gradient rel L2 {worst} "
          f"{rel[worst]:.3e} (tol 1e-3){routed}; bf16 loss on the same weights rounded to bf16 "
          f"{bf16_loss:.6f} (|d| {abs(bf16_loss - loss.item()):.3e}); {row['seconds']:.1f} s")
    del params, cpu, grads, ref_grads
    torch.cuda.empty_cache()
    return row


# 11c: xlstm-125m's depth (cut from its 12 layers to make room for phase 13)
RESUME_LAYERS = 4


def check_train_resume(torch, errors):
    """Phase 11c: xlstm-125m at full width, RESUME_LAYERS layers (bf16, remat) through
    `TrainLoop`, checkpointing every 2 steps: a clean 6-step run against
    one that fails at step 3 and resumes from its step-2 checkpoint (losses
    and final state bit for bit), and the last checkpoint restored against
    the final state (bf16 leaves included); then the launcher's defaults as
    a subprocess on the card."""
    import shutil
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import init_train_state, make_train_step
    t0 = time.perf_counter()
    cfg = get_arch("xlstm-125m").with_(n_layers=RESUME_LAYERS)
    root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    steps = 6
    opt = make_optimizer(cfg.optimizer)
    state0 = init_train_state(
        tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda"), opt)

    def loop(name):
        step = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt,
                               warmup_cosine(3e-3, 10, steps))
        return TrainLoop(step, make_batch_fn(cfg, 0, 8, 128, "cuda"),
                         ckpt_dir=os.path.join(root, name), ckpt_every=2, log_every=1,
                         log_fn=lambda *a: None)

    clean = loop("clean")
    final = clean.run(state0, steps)
    crash = loop("crash")
    try:
        crash.run(state0, steps, fail_at_step=3)
        errors.append("11c: the run meant to fail at step 3 did not")
    except RuntimeError:
        pass
    restored, start = crash.maybe_restore(state0)
    resumed = crash.run(restored, steps, start_step=start)
    losses = [m["loss"] for _, m in clean.history]
    same = (start == 2 and tree_equal(torch, final, resumed)
            and [m["loss"] for _, m in crash.history] == losses[2:])
    with open(os.path.join(root, "clean", f"step_{steps:08d}", "manifest.json")) as f:
        dtypes = [leaf["dtype"] for leaf in json.load(f)["leaves"]]
    back = ckpt.restore(os.path.join(root, "clean"), steps, state0)
    round_trip = tree_equal(torch, back, final)
    del state0, final, resumed, restored, back
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    if not same or not round_trip or not all(math.isfinite(v) for v in losses):
        errors.append(f"11c: resumed run bit-identical {same} (resumed from {start}), "
                      f"checkpoint round trip {round_trip}, losses {losses}")

    t1 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    final_line = [ln for ln in cli.stdout.splitlines() if ln.startswith("final loss:")]
    if cli.returncode != 0 or not final_line:
        errors.append(f"11c: python -m repro_torch.launch.train exited {cli.returncode}: "
                      f"{cli.stderr[-2000:]}")
    out = {"losses": losses, "bit_identical": same, "resumed_from": start,
           "bf16_leaves": dtypes.count("bfloat16"), "leaves": len(dtypes),
           "round_trip": round_trip, "seconds_loop": t1 - t0,
           "cli_rc": cli.returncode, "cli_final": final_line,
           "cli_seconds": time.perf_counter() - t1}
    print(f"train {cfg.name} (full width, {cfg.n_layers} layers, {cfg.dtype}, remat {cfg.remat}; "
          f"batch 8 x 128) through TrainLoop, a checkpoint every 2 steps: losses "
          f"{[round(v, 6) for v in losses]}; failed at step 3, resumed from step {start}: "
          f"bit-identical to the clean run {same}; the step-{steps} checkpoint "
          f"({dtypes.count('bfloat16')} of {len(dtypes)} leaves bfloat16) restores bit for bit "
          f"{round_trip}; {t1 - t0:.1f} s")
    print(f"train: python -m repro_torch.launch.train (defaults) rc {cli.returncode}, "
          f"{final_line[-1] if final_line else 'no final loss'}; {out['cli_seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: the serving fleet
# ---------------------------------------------------------------------------

# replica 0 wedges from its second step, replica 1 poisons slot 0 at its third
FLEET_PLAN = "0=wedge@1,1=nan@2:slot=0"
# what a request's own result holds (the batch-share energies depend on who
# else rode its batch)
FLEET_STATS = ("out_spikes", "in_spikes", "spike_total", "skip_rate", "ts_occupancy",
               "energy_j", "latency_s", "precision")


def same_result(a, b) -> bool:
    """Bit for bit: status, logits (dtype and bits) and `FLEET_STATS`."""
    import numpy as np
    return (a.status == b.status and a.outputs.dtype == b.outputs.dtype
            and np.array_equal(a.outputs, b.outputs)
            and all(a.stats[k] == b.stats[k] for k in FLEET_STATS))


def drive_fleet(router, rids):
    """Step the router until every request has its result; returns
    (results in order, each request's partial stream, router steps)."""
    streams = {rid: router.poll_partial(rid) for rid in rids}
    steps = 0
    while router._outstanding:
        router.step()
        steps += 1
        for rid in rids:
            streams[rid] += router.poll_partial(rid)
    return [router.poll(rid) for rid in rids], streams, steps


def fleet_forwards(router) -> int:
    """Pipeline forwards the in-process replicas ran: each replica's
    session steps that its fault plan did not wedge or raise."""
    total = 0
    for rep in router.replicas:
        sess = rep.core._session
        if sess is not None:
            total += sum(1 for i in range(sess.step_idx)
                         if sess.plan.active("wedge", i) is None
                         and sess.plan.active("raise", i) is None)
    return total


def gpu_memory(smi_query):
    """nvidia-smi's answer to ``--query-<smi_query>`` (csv, no header)."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-{smi_query}", "--format=csv,noheader"],
                             capture_output=True, text=True)
    except FileNotFoundError:
        return "nvidia-smi not found"
    return out.stdout.strip() if out.returncode == 0 else f"nvidia-smi rc {out.returncode}"


def check_fleet_inproc(torch, cfg, params_cpu, solo, errors):
    """10a: 3 in-process replicas over one card `SNNRunner`, `FLEET_PLAN`,
    phase 4's 17 requests submitted in three waves (a router step after
    each of the first two), so that the wedge and the poison find work."""
    from repro_torch.kernels import CUDA_LAUNCHES, reset_cuda_launches
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.core import all_finite
    from repro_torch.serve.faults import parse_fleet_plan
    from repro_torch.serve.router import make_router
    from repro_torch.serve.runners.snn import SNNRunner
    params = {k: {kk: v.to("cuda") for kk, v in leaf.items()} for k, leaf in params_cpu.items()}
    imgs = make_requests(torch, cfg)
    router = make_router(SNNRunner(cfg, params, device="cuda"), 3, EngineConfig(slots=SLOTS),
                         plans=parse_fleet_plan(FLEET_PLAN))
    reset_cuda_launches()
    t0 = time.perf_counter()
    rids, per = [], -(-len(imgs) // 3)
    for w in range(3):
        rids += [router.submit(img, source="sparse" if (w * per + i) % 2 == 0 else "dense")
                 for i, img in enumerate(imgs[w * per:(w + 1) * per])]
        if w < 2:
            router.step()
    res, streams, _ = drive_fleet(router, rids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(CUDA_LAUNCHES)
    steps = router.stats()["router_steps"]
    forwards, n_spiking = fleet_forwards(router), len(cfg.conv_channels) - 1
    want = dict.fromkeys(CUDA_LAUNCHES, 0)
    want.update({"dense_conv_lif": forwards, "spike_matmul_mapped": n_spiking * forwards,
                 "lif_epilogue_scan": (n_spiking + 2) * forwards})
    if launches != want or forwards == 0:
        errors.append(f"10a: CUDA_LAUNCHES {launches} != {want} over {forwards} forwards")
    conditions = sorted(e[2] for e in router.drain_log)
    if conditions != ["poisoned", "wedged"] or [e[1] for e in router.drain_log] != [1, 0]:
        errors.append(f"10a: drain log {[e[:4] for e in router.drain_log]}")
    failed = [r for r in res if r.status == "failed"]
    if len(failed) != 1 or any(r.status not in ("ok", "failed") for r in res):
        errors.append(f"10a: statuses {[r.status for r in res]}")
    for r in failed:
        # retired with what had streamed before the poison: for the SNN a
        # request lives one step, so nothing, and never a NaN
        if streams[r.request_id] or not all_finite(streams[r.request_id]) \
                or all_finite(r.outputs):
            errors.append(f"10a: poisoned request {r.request_id} streamed "
                          f"{streams[r.request_id]} outputs {r.outputs}")
    mismatch = [r.request_id for r, want_r in zip(res, solo)
                if r.status == "ok" and not (
                    same_result(r, want_r)
                    and streams[r.request_id] == [
                        {k: v[t] for k, v in want_r.stats["ts_occupancy"].items()}
                        for t in range(cfg.timesteps)])]
    if mismatch:
        errors.append(f"10a: ok results not bit-identical to phase 4's solo engine: {mismatch}")
    stats = router.stats()
    print(f"fleet 10a: 3 replicas, plan {FLEET_PLAN!r}, {len(res)} requests in 3 waves: "
          f"{stats['ok']} ok, {stats['failed']} failed, rerouted {stats['rerouted']}; drains "
          + "; ".join(f"@{e[0]} replica {e[1]} {e[2]} re-routed {e[3]}" for e in router.drain_log)
          + f"; {steps} router steps, host {seconds / steps * 1e3:.3f} ms per router step; "
          f"ok results bit-identical to phase 4's solo engine {not mismatch}; "
          f"launches {launches} ({forwards} forwards)")
    return {"launches": launches, "forwards": forwards, "router_steps": steps,
            "ms_per_router_step": seconds / steps * 1e3, "seconds": seconds,
            "drain_log": [e[:4] for e in router.drain_log], "statuses": [r.status for r in res],
            "bit_identical": not mismatch}


def check_fleet_workers(torch, cfg, solo, errors):
    """10b: 2 subprocess workers on the one card, built from one
    `snn_spec`. The trace runs twice: a clean pass (the workers' first
    steps load the kernel library and the CUDA libraries' kernels), then a
    pass whose worker 0 is killed after the first router step."""
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.core import EngineCore
    from repro_torch.serve.router import make_worker_fleet
    from repro_torch.serve.worker import build_runner, snn_spec
    spec = snn_spec(cfg, seed=0, device="cuda")
    config = EngineConfig(slots=SLOTS)
    imgs = make_requests(torch, cfg)
    sources = ["sparse" if i % 2 == 0 else "dense" for i in range(len(imgs))]
    inproc = EngineCore(build_runner(spec), config)
    ids = [inproc.submit(img, source=src) for img, src in zip(imgs, sources)]
    done = inproc.run_until_complete()
    reference = [done[i] for i in ids]
    parent_memory = gpu_memory("gpu=memory.used")
    t0 = time.perf_counter()
    router = make_worker_fleet(spec, 2, config)
    spawn_s = time.perf_counter() - t0
    passes = {}
    try:
        handshakes = [r.transport.handshake_s for r in router.replicas]
        memory = gpu_memory("gpu=memory.used,memory.total")
        for name in ("clean", "kill"):
            steps0 = router.stats()["router_steps"]
            t1 = time.perf_counter()
            rids = [router.submit(img, source=src) for img, src in zip(imgs, sources)]
            in_flight = None
            if name == "kill":
                router.step()
                victim = router.replicas[0].transport
                in_flight = victim.in_flight()
                victim.kill()
            res, _, _ = drive_fleet(router, rids)
            steps = router.stats()["router_steps"] - steps0
            passes[name] = {"ms_per_router_step": (time.perf_counter() - t1) / steps * 1e3,
                            "router_steps": steps, "in_flight_at_kill": in_flight,
                            "bad": [r.request_id for r, a, b in zip(res, reference, solo)
                                    if r.status != "ok" or not same_result(r, a)
                                    or not same_result(r, b)]}
    finally:
        router.close()
    stats = router.stats()
    killed = passes["kill"]
    if not killed["in_flight_at_kill"] or len(router.drain_log) != 1 or stats["rerouted"] < 1:
        errors.append(f"10b: in flight at the kill {killed['in_flight_at_kill']}, drains "
                      f"{[e[:4] for e in router.drain_log]}, rerouted {stats['rerouted']}")
    bad = {name: p["bad"] for name, p in passes.items() if p["bad"]}
    if bad:
        errors.append(f"10b: results not bit-identical to the in-process engine over "
                      f"build_runner(spec) and phase 4's: {bad}")
    print(f"fleet 10b: 2 workers spawned in {spawn_s:.2f} s (handshakes "
          f"{', '.join(f'{h:.2f}' for h in handshakes)} s); clean pass "
          f"{passes['clean']['router_steps']} router steps at "
          f"{passes['clean']['ms_per_router_step']:.3f} ms host each (the workers' first "
          f"steps); kill pass: worker 0 killed after router step 1 with "
          f"{killed['in_flight_at_kill']} requests in flight, {killed['router_steps']} router "
          f"steps at {killed['ms_per_router_step']:.3f} ms; {stats['ok']} ok, rerouted "
          f"{stats['rerouted']}, drains {[e[:4] for e in router.drain_log]}; both passes "
          f"bit-identical to the in-process engine and phase 4 {not bad}")
    print(f"fleet 10b: nvidia-smi memory.used {parent_memory} with this process's context, "
          f"{memory.split(',')[0]} with 3 CUDA contexts up (this process + 2 workers; "
          f"memory.total {memory.split(',')[-1].strip()})")
    return {"spawn_s": spawn_s, "handshake_s": handshakes, "memory_parent": parent_memory,
            "memory": memory, "passes": passes, "rerouted": stats["rerouted"],
            "bit_identical": not bad}


def check_fleet_lm(torch, cfg, errors, kill_after=6):
    """10c: qwen1.5-4b at full width, depth 2, in 2 workers; worker 0
    killed mid-decode. Every stream (7a's trace: greedy, sampled, empty and
    repetitive prompts) equals the in-process engine's over the same
    `lm_spec`."""
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.core import EngineCore
    from repro_torch.serve.router import make_worker_fleet
    from repro_torch.serve.worker import build_runner, lm_spec
    spec = lm_spec(cfg, seed=0, max_seq=LM_MAX_SEQ, device="cuda")
    config = EngineConfig(slots=LM_SLOTS, prefill_chunk=LM_CHUNK)
    prompts, opts = lm_trace(cfg.vocab)
    inproc = EngineCore(build_runner(spec), config)
    ids = [inproc.submit(p, max_new_tokens=LM_NEW, **o) for p, o in zip(prompts, opts)]
    want_streams = {i: [] for i in ids}
    while inproc.pending() or inproc.in_flight():
        inproc.step()
        for i in ids:
            want_streams[i] += inproc.poll_partial(i)
    done = inproc.run_until_complete()
    want = [(list(done[i].outputs), want_streams[i]) for i in ids]
    del inproc, done
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    router = make_worker_fleet(spec, 2, config)
    spawn_s = time.perf_counter() - t0
    try:
        handshakes = [r.transport.handshake_s for r in router.replicas]
        rids = [router.submit(p, max_new_tokens=LM_NEW, **o) for p, o in zip(prompts, opts)]
        streams = {rid: [] for rid in rids}
        for _ in range(kill_after):
            router.step()
            for rid in rids:
                streams[rid] += router.poll_partial(rid)
        victim = router.replicas[0].transport
        victims = [router.replicas[0].placed[local] for local in victim._live]
        decoding = [rid for rid in victims if streams[rid]]
        victim.kill()
        res, more, _ = drive_fleet(router, rids)
    finally:
        router.close()
    for rid in rids:
        streams[rid] += more[rid]
    stats = router.stats()
    bad = [i for i, (r, (out, stream)) in enumerate(zip(res, want))
           if r.status != "ok" or list(r.outputs) != out or streams[rids[i]] != stream]
    if not decoding or len(router.drain_log) != 1 or stats["rerouted"] < 1 or bad:
        errors.append(f"10c: requests decoding at the kill {decoding}, drains "
                      f"{[e[:4] for e in router.drain_log]}, rerouted {stats['rerouted']}, "
                      f"streams differing from the in-process engine {bad}")
    print(f"fleet 10c: {cfg.name} at full width, depth {cfg.n_layers}, 2 workers (handshakes "
          f"{', '.join(f'{h:.2f}' for h in handshakes)} s); worker 0 killed after "
          f"{kill_after} router steps holding {victims} ({decoding} mid-decode); rerouted "
          f"{stats['rerouted']}; {len(res) - len(bad)}/{len(res)} streams equal the "
          f"in-process engine's")
    return {"spawn_s": spawn_s, "handshake_s": handshakes, "victims": victims,
            "decoding_at_kill": decoding, "rerouted": stats["rerouted"], "differing": bad}


def check_fleet_cli(errors):
    """10d: the CLI's fleet flags as subprocesses, side by side: 3 replicas
    with replica 0 wedged, 2 workers (one slot per engine in both, so that
    the wedge finds work and the two print the same request lines), and a
    refused ``--workers 1 --replicas 2``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--workload", "snn"]
    runs = {"replicas": base + ["--slots", "1", "--replicas", "3", "--fault-plan", "0=wedge@1"],
            "workers": base + ["--slots", "1", "--workers", "2"],
            "refused": base + ["--workers", "1", "--replicas", "2"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(v, cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE) for k, v in runs.items()}
    outs = {}
    try:
        for k, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            outs[k] = (proc.returncode, out, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    seconds = time.perf_counter() - t0
    lines = {k: [line for line in outs[k][1].splitlines() if line.startswith("req")]
             for k in ("replicas", "workers")}
    drains = [line for line in outs["replicas"][1].splitlines() if line.startswith("drain @step")]
    message = ("--workers and --replicas are both fleet sizes (subprocess vs in-process "
               "replicas); pick one")
    refusal = (outs["refused"][2].strip().splitlines() or [""])[-1]
    for k in ("replicas", "workers"):
        if outs[k][0] != 0:
            errors.append(f"10d {k}: exit {outs[k][0]}: {outs[k][2][-2000:]}")
    if len(drains) != 1 or len(lines["replicas"]) != 4 or lines["replicas"] != lines["workers"]:
        errors.append(f"10d: drain lines {drains}; request lines {lines}")
    if outs["refused"][0] == 0 or message not in outs["refused"][2]:
        errors.append(f"10d refused: exit {outs['refused'][0]}: {outs['refused'][2][-500:]}")
    print(f"fleet 10d ({seconds:.1f} s, three CLIs side by side): --replicas 3 --fault-plan "
          f"0=wedge@1 rc {outs['replicas'][0]}, {drains[0][:90] if drains else 'no drain line'}; "
          f"--workers 2 rc {outs['workers'][0]}, request lines equal the replicas' "
          f"{lines['replicas'] == lines['workers']}; --workers 1 --replicas 2 rc "
          f"{outs['refused'][0]} ({refusal[:80]})")
    return {k: {"rc": v[0]} for k, v in outs.items()} | {"seconds": seconds}


# ---------------------------------------------------------------------------
# phase 12: distribution on the card
# ---------------------------------------------------------------------------

# 12a's shards and the ranks of 12b and 12c: all on card 0 of a one-card
# machine, so their times say what splitting and the reductions cost there,
# not what more cards would give
DIST_RANKS = 2
PSUM_ARCH = "xlstm-125m"
# 12c: the launcher's own flags at xlstm-125m's full width, 4 of its 12 layers
# (cut from full depth to make room for phase 13), fp32
DIST_TRAIN_ARGS = ["--arch", "xlstm-125m", "--d-model", "0", "--n-layers", "4", "--vocab", "0",
                   "--steps", "3", "--device", "cuda"]
DIST_TRAIN_TOL = 1e-5


def check_sharded_serving(torch, name, cfg, params_cpu, solo, solo_ms, errors):
    """12a: phase 4's 17 requests through EngineCore + SNNRunner under an
    in-process data mesh of `DIST_RANKS` shards, all on cuda:0: every
    result bit for bit phase 4's solo engine's, kernels 1-3 launched
    `DIST_RANKS` times as often per engine step, and the near-silent
    request's skip rate above a dense one's."""
    import numpy as np
    from repro_torch.dist.context import compute_mesh
    from repro_torch.kernels import CUDA_LAUNCHES, reset_cuda_launches
    from repro_torch.launch.mesh import DataMesh
    params = {k: {kk: v.to("cuda") for kk, v in leaf.items()} for k, leaf in params_cpu.items()}
    imgs = make_requests(torch, cfg)
    mesh = DataMesh(["cuda:0"] * DIST_RANKS)
    with compute_mesh(mesh):
        serve(torch, cfg, params, imgs[:SLOTS], "cuda")           # warm-up
        reset_cuda_launches()
        core, res, seconds = serve(torch, cfg, params, imgs, "cuda")
    launches = dict(CUDA_LAUNCHES)
    steps = core.stats()["steps_run"]
    n_spiking = len(cfg.conv_channels) - 1
    want = dict.fromkeys(CUDA_LAUNCHES, 0)
    want.update({"dense_conv_lif": DIST_RANKS * steps,
                 "spike_matmul_mapped": DIST_RANKS * n_spiking * steps,
                 "lif_epilogue_scan": DIST_RANKS * (n_spiking + 2) * steps})
    if launches != want:
        errors.append(f"12a {name}: CUDA_LAUNCHES {launches} != {want} over {steps} steps")
    bad = [r.request_id for r, s in zip(res, solo) if not same_result(r, s)]
    if bad or len(res) != len(solo):
        errors.append(f"12a {name}: results not bit-identical to phase 4's solo engine: {bad}")
    silent = float(np.mean(list(res[0].stats["skip_rate"].values())))
    dense = float(np.mean(list(res[1].stats["skip_rate"].values())))
    if not silent > dense:
        errors.append(f"12a {name}: near-silent request's skip {silent} <= dense one's {dense}")
    ms = seconds / steps * 1e3
    print(f"dist 12a {name}: {len(res)} requests, {SLOTS} slots, EngineCore + SNNRunner under "
          f"a data mesh of {DIST_RANKS} shards on one card (cuda:0 twice): bit-identical to "
          f"phase 4's solo engine {not bad}; launches per engine step "
          f"{ {k: v // steps for k, v in launches.items() if v} } over {steps} steps; "
          f"skip near-silent {silent:.4f} > dense {dense:.4f}; host {ms:.3f} ms/step against "
          f"solo's {solo_ms:.3f} ({DIST_RANKS} shards sharing one card: the cost of splitting "
          f"and re-assembly, not a scaling figure)")
    return {"launches": launches, "steps": steps, "ms_per_step": ms, "solo_ms_per_step": solo_ms,
            "bit_identical": not bad, "skip_silent": silent, "skip_dense": dense}


def _tree_digest(tree) -> str:
    """sha256 over the leaves' bytes (keys sorted): equal digests, equal bits."""
    import hashlib
    h = hashlib.sha256()
    for key in sorted(tree):
        h.update(key.encode())
        h.update(tree[key].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _psum_rank(index, store_dir, shapes, out_dir, reps):
    """12b, one spawned process: rank ``index % DIST_RANKS`` of the card's
    gloo group (index < DIST_RANKS; CUDA tensors on cuda:0) or of the CPU's.
    Both draw the same seeded gradients and incoming residuals on the host."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.compression import compressed_psum, quantize_error_feedback
    group, rank = divmod(index, DIST_RANKS)
    device = "cuda" if group == 0 else "cpu"
    dist.init_process_group("gloo", init_method=f"file://{store_dir}/store{group}", rank=rank,
                            world_size=DIST_RANKS)
    gen = torch.Generator().manual_seed(1000 + rank)
    grads, err = {}, {}
    for i, (key, shape) in enumerate(shapes):
        grads[key] = (torch.randn(shape, generator=gen) * 10.0 ** -(i % 4)).to(device)
        err[key] = (torch.randn(shape, generator=gen) * 10.0 ** -(i % 4 + 3)).to(device)
    out = {"device": device, "rank": rank}
    worst = 0.0
    for key in grads:
        q, scale, new_e = quantize_error_feedback(grads[key], err[key])
        comp = grads[key].double() + err[key].double()
        gap = (q.double() * scale.double() + new_e.double() - comp).abs().max()
        worst = max(worst, float(gap / comp.abs().max()))
    out["invariant"] = worst
    for mode, per_channel in (("per_tensor", False), ("per_channel", True)):
        mean, new_err = compressed_psum(grads, err, per_channel=per_channel)   # warm-up
        times = []
        for _ in range(reps):
            dist.barrier()
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, new_err = compressed_psum(grads, err, per_channel=per_channel)
            if device == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[mode] = {"mean": _tree_digest(mean), "err": _tree_digest(new_err),
                     "ms": sorted(times)[len(times) // 2],
                     "residual_nonzero": all(bool(e.abs().sum() > 0) for e in new_err.values())}
    with open(os.path.join(out_dir, f"psum{index}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def check_compressed_psum(torch, errors, reps=2):
    """12b: `compressed_psum` over two gloo ranks on cuda:0 (CUDA tensors)
    and two on the CPU, on seeded gradients of xlstm-125m's full-size leaf
    shapes: the card's mean gradients and residuals bit for bit the CPU's,
    per tensor and per channel; the residual invariant exact; wire bytes and
    ms per call."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.train.tree import keystr, tree_leaves_with_path
    t0 = time.perf_counter()
    cfg = get_arch(PSUM_ARCH).with_(dtype="float32")
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    shapes = [(keystr(p), tuple(x.shape)) for p, x in tree_leaves_with_path(params)]
    # bytes a rank puts on the wire per step: int8 counts + fp32 scales (one
    # per leaf, or one per last-axis channel of a leaf with 2+ dims) against
    # the fp32 gradients; the SUM here reduces the counts as int32
    elements = sum(math.prod(s) for _, s in shapes)
    wire = {}
    for mode in ("per_tensor", "per_channel"):
        scales = sum(s[-1] if mode == "per_channel" and len(s) >= 2 else 1 for _, s in shapes)
        wire[mode] = {"int8_and_scales": elements + 4 * scales, "fp32": 4 * elements,
                      "int32_sum_buffer": 4 * elements}
    del params
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="psum", dir=os.path.join(ROOT, "build"))
    try:
        mp.start_processes(_psum_rank, args=(tmp, shapes, tmp, reps), nprocs=2 * DIST_RANKS,
                           join=True, start_method="spawn")
        ranks = []
        for i in range(2 * DIST_RANKS):
            with open(os.path.join(tmp, f"psum{i}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card, cpu = ranks[:DIST_RANKS], ranks[DIST_RANKS:]
    out = {"seconds": time.perf_counter() - t0, "leaves": len(shapes), "elements": elements,
           "wire": wire}
    for mode in ("per_tensor", "per_channel"):
        equal = all(a[mode]["mean"] == b[mode]["mean"] and a[mode]["err"] == b[mode]["err"]
                    for a, b in zip(card, cpu))
        same_mean = len({r[mode]["mean"] for r in ranks}) == 1
        out[mode] = {"card_equals_cpu": equal, "mean_same_on_all_ranks": same_mean,
                     "card_ms": [r[mode]["ms"] for r in card],
                     "cpu_ms": [r[mode]["ms"] for r in cpu],
                     "residual_nonzero": all(r[mode]["residual_nonzero"] for r in ranks)}
        if not (equal and same_mean and out[mode]["residual_nonzero"]):
            errors.append(f"12b {mode}: card == CPU {equal}, one mean on every rank "
                          f"{same_mean}, residuals non-zero {out[mode]['residual_nonzero']}")
        w = wire[mode]
        print(f"dist 12b {mode}: compressed_psum over {DIST_RANKS} gloo ranks sharing cuda:0 "
              f"(CUDA tensors, staged through the host) on {out['leaves']} {PSUM_ARCH} leaves "
              f"({out['elements']} elements): mean and residuals bit-identical to {DIST_RANKS} "
              f"CPU ranks {equal}; wire per rank per step {w['int8_and_scales']} B int8 + "
              f"scales vs {w['fp32']} B fp32 ({w['fp32'] / w['int8_and_scales']:.2f}x; the "
              f"SUM reduces an int32 buffer of {w['int32_sum_buffer']} B here); ms per call "
              f"card {[round(v, 1) for v in out[mode]['card_ms']]} CPU "
              f"{[round(v, 1) for v in out[mode]['cpu_ms']]}")
    out["invariant"] = max(r["invariant"] for r in ranks)
    if not out["invariant"] <= 2.0 ** -24:
        errors.append(f"12b: |q * scale + new_err - (g + err)| up to {out['invariant']} of amax")
    print(f"dist 12b: residual invariant q*scale + new_err == g + err within f32 rounding on "
          f"every rank (worst gap {out['invariant']:.3e} of the leaf's amax, bar 2^-24); "
          f"{out['seconds']:.1f} s")
    return out


def train_rank(out_path, argv):
    """12c, one torchrun worker: `repro_torch.launch.train.main(argv)`, its
    steps timed (synchronized); rank 0 writes the history and step times to
    ``out_path``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.launch import train as launch
    times = []
    make = launch.make_train_step

    def timed(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    launch.make_train_step = timed
    history = launch.main(argv)
    if os.environ.get("RANK", "0") == "0":
        with open(out_path, "w") as f:
            json.dump({"history": history, "step_ms": times}, f)


def split_step(torch, cfg, opt, state, batch, lr):
    """One process's emulation of the plain data-parallel first step on
    `DIST_RANKS` ranks: each rank's rows' loss and gradients, summed in rank
    order in fp32 and divided by the rank count (`rank_order_mean`'s
    arithmetic), then the step's clip and optimizer -> (state, loss)."""
    from repro_torch.models import transformer as tf
    from repro_torch.train.optim import apply_updates, clip_by_global_norm
    from repro_torch.train.train_step import deterministic, local_rows, value_and_grad
    from repro_torch.train.tree import tree_map
    vg = value_and_grad(lambda p, b: tf.train_loss(p, b, cfg))
    parts = [vg(state["params"], local_rows(batch, r, DIST_RANKS)) for r in range(DIST_RANKS)]
    n = torch.tensor(float(DIST_RANKS), device=state["step"].device)

    def mean(*xs):
        total = xs[0].float().clone()
        for x in xs[1:]:
            total += x.float()
        return (total / n).to(xs[0].dtype)
    with torch.no_grad(), deterministic():
        loss = mean(*[p[0] for p in parts])
        grads = tree_map(mean, *[p[1] for p in parts])
        grads, _ = clip_by_global_norm(grads, 1.0)
        updates, new_opt = opt.update(grads, state["opt"], state["params"], lr)
        params = apply_updates(state["params"], updates)
    return {"params": params, "opt": new_opt, "step": state["step"] + 1}, float(loss)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_dist_training(torch, errors):
    """12c and 12d, their subprocesses side by side: xlstm-125m at full
    width and depth in fp32 through `launch.train` under torchrun on
    `DIST_RANKS` ranks sharing cuda:0 (gloo), 3 steps plain and 3 with
    --compress-grads, and 3 compressed steps at world size 1 (NCCL) as a
    plain CLI; the serving CLI's data-shard refusals. The plain run's first
    step against one process's step on the same global batch."""
    import re
    import shutil
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import make_batch_fn, parse_args, reduce_cfg
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.train.tree import keystr, tree_leaves_with_path
    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke_dist")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                str(DIST_RANKS), "--master-addr", "127.0.0.1"]
    runs = {
        "plain": torchrun + ["--master-port", str(_free_port()), SCRIPT, "--train-rank",
                             os.path.join(root, "plain.json")] + DIST_TRAIN_ARGS
        + ["--ckpt-dir", os.path.join(root, "plain"), "--ckpt-every", "1"],
        "compressed": torchrun + ["--master-port", str(_free_port()), SCRIPT, "--train-rank",
                                  os.path.join(root, "compressed.json")] + DIST_TRAIN_ARGS
        + ["--compress-grads"],
        "world1": [sys.executable, "-m", "repro_torch.launch.train", "--compress-grads"]
        + DIST_TRAIN_ARGS,
        "shard": [sys.executable, "-m", "repro_torch.launch.serve", "--workload", "snn",
                  "--data-shard", str(DIST_RANKS)],
        "workers": [sys.executable, "-m", "repro_torch.launch.serve", "--workload", "snn",
                    "--workers", "2", "--data-shard", str(DIST_RANKS)],
    }
    procs = {k: subprocess.Popen(v, cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE) for k, v in runs.items()}
    outs = {}
    try:
        # meanwhile, one process's first step on the same global batch
        args = parse_args(DIST_TRAIN_ARGS)
        cfg = reduce_cfg(get_arch(args.arch), args)
        opt = make_optimizer(cfg.optimizer)
        step = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt,
                               warmup_cosine(args.lr, 10, args.steps))
        state = init_train_state(tf.init_params(torch.Generator(device="cuda").manual_seed(
            args.seed), cfg, "cuda"), opt)
        make_batch = make_batch_fn(cfg, args.seed, args.batch, args.seq, "cuda")
        one, m1 = step(state, make_batch(0))
        split, split_loss = split_step(torch, cfg, opt, state, make_batch(0), m1["lr"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(one, make_batch(1))
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t1) * 1e3
        for k, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            outs[k] = (proc.returncode, out, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    res = {"seconds": time.perf_counter() - t0, "rc": {k: v[0] for k, v in outs.items()},
           "one_process_ms": one_ms}
    for k in ("plain", "compressed", "world1"):
        if outs[k][0] != 0:
            errors.append(f"12c {k}: exit {outs[k][0]}: {outs[k][2][-3000:]}")
    if errors:
        return res
    agree = {k: [ln for ln in outs[k][1].splitlines() if ln.startswith("replicas agree")]
             for k in ("plain", "compressed")}
    residuals = [float(v) for v in re.findall(r"rank \d+: residual \|grad_err\| sum (\S+)\n",
                                              outs["compressed"][1])]
    runs_json = {}
    for k in ("plain", "compressed"):
        with open(os.path.join(root, f"{k}.json")) as f:
            runs_json[k] = json.load(f)
    loss0 = runs_json["plain"]["history"][0][1]["loss"]
    loss_rel = abs(loss0 - float(m1["loss"])) / abs(float(m1["loss"]))
    ranks = ckpt.restore(os.path.join(root, "plain"), 1, one)
    # (1) the ranks' step is the one-process step on their two halves,
    # averaged in rank order: equal value for value (adding the other
    # ranks' zeros can flip the sign of a zero gradient, nothing else)
    split_equal = loss0 == split_loss and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves_with_path(ranks),
                                                    tree_leaves_with_path(split)))
    # (2) against the whole batch in one step: the loss and the parameter
    # tree within DIST_TRAIN_TOL, each parameter within 2 lr (the first
    # AdamW update lr g/(|g|+eps) takes an entry whose gradient is within
    # rounding of 0 either way); the AdamW moments (m = (1-b1) g,
    # v = (1-b2) g^2) are reported, with no bar: a gradient that sums
    # contributions which nearly cancel moves when its sum is split
    worst, worst_key, num, den, far = 0.0, None, 0.0, 0.0, 0.0
    lr0 = float(m1["lr"])
    for (path, a), (_, b) in zip(tree_leaves_with_path(ranks), tree_leaves_with_path(one)):
        if path[0] == "opt" and path[1] in ("m", "v"):
            rel = float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))
            if rel > worst:
                worst, worst_key = rel, path
        elif path[0] == "params":
            num += float(((a.double() - b.double()) ** 2).sum())
            den += float((b.double() ** 2).sum())
            far = max(far, float((a - b).abs().max()))
    params_rel = (num / den) ** 0.5
    final1 = [ln for ln in outs["world1"][1].splitlines() if ln.startswith("final loss:")]
    res.update({"split_equal": split_equal, "loss0_rel": loss_rel,
                "moment_rel_l2_max": worst, "params_rel_l2": params_rel,
                "param_abs_max": far, "lr0": lr0, "residuals": residuals,
                "step_ms": {k: v["step_ms"] for k, v in runs_json.items()},
                "agree": agree, "world1_final": final1})
    if not all(agree.values()):
        errors.append(f"12c: no 'replicas agree' line: {agree}")
    if len(residuals) != DIST_RANKS or not all(r > 0 for r in residuals):
        errors.append(f"12c: residuals {residuals}")
    if not split_equal:
        errors.append("12c: the ranks' first plain step differs from one process's step on "
                      "the same two halves averaged in rank order")
    if loss_rel > DIST_TRAIN_TOL or params_rel > DIST_TRAIN_TOL or far > 2 * lr0:
        errors.append(f"12c: first plain step vs one process: loss rel {loss_rel}, params rel "
                      f"L2 {params_rel}, largest param difference {far} (lr {lr0})")
    if not final1:
        errors.append(f"12c world1: no final loss line: {outs['world1'][1][-500:]}")
    rule_msg = ("--data-shard builds a device mesh in this process; workers serve from their "
                "own processes (shard inside a worker is not wired up)")
    if outs["workers"][0] == 0 or rule_msg not in outs["workers"][2]:
        errors.append(f"12d workers: exit {outs['workers'][0]}: {outs['workers'][2][-500:]}")
    if torch.cuda.device_count() < DIST_RANKS:
        if outs["shard"][0] == 0 or "needs that many devices" not in outs["shard"][2]:
            errors.append(f"12d shard: exit {outs['shard'][0]}: {outs['shard'][2][-500:]}")
    elif outs["shard"][0] != 0 or "data-mesh serving: slot batches split over" \
            not in outs["shard"][1]:
        errors.append(f"12d shard ({torch.cuda.device_count()} cards): exit "
                      f"{outs['shard'][0]}: {outs['shard'][2][-500:]}")
    del state, one, ranks
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    med = {k: sorted(v[1:])[len(v[1:]) // 2] if len(v) > 1 else v[0]
           for k, v in res["step_ms"].items()}
    res["median_step_ms"] = med
    print(f"dist 12c: {PSUM_ARCH} full width, {cfg.n_layers} layers, fp32, batch {args.batch} x {args.seq}, "
          f"through launch.train under torchrun on {DIST_RANKS} ranks sharing cuda:0 (gloo, "
          f"reductions staged through the host): plain {agree['plain']}; compressed "
          f"{agree['compressed']}, residual sums per rank {residuals}; step ms plain "
          f"{[round(v, 1) for v in res['step_ms']['plain']]} compressed "
          f"{[round(v, 1) for v in res['step_ms']['compressed']]} against one process's "
          f"{one_ms:.1f} ms on the card alone")
    print(f"dist 12c: first plain step equal to one process's step on the two ranks' halves "
          f"averaged in rank order {split_equal}; against one step on the whole batch: loss "
          f"rel {loss_rel:.3e}, parameters rel L2 {params_rel:.3e} (bars {DIST_TRAIN_TOL}), "
          f"largest parameter difference {far:.3e} (bar 2 lr = {2 * lr0:.1e}), worst AdamW "
          f"moment leaf rel L2 {worst:.3e} at {keystr(worst_key)}; "
          f"--compress-grads at world size 1 (NCCL) rc {outs['world1'][0]}, "
          f"{final1[-1] if final1 else 'no final loss'}")
    print(f"dist 12d: --data-shard {DIST_RANKS} on a one-card machine rc {outs['shard'][0]} "
          f"({(outs['shard'][2].strip().splitlines() or [''])[-1][:100]}); --workers 2 "
          f"--data-shard {DIST_RANKS} rc {outs['workers'][0]} (workers-vs-data-shard); "
          f"{res['seconds']:.1f} s")
    return res


def check_distribution(torch, cfgs, solo, solo_ms, errors):
    """Phase 12: 12a per config, 12b, then 12c with 12d."""
    t12 = time.perf_counter()
    from repro_torch.models.vgg9 import init_vgg9
    out = {"serve": {name: check_sharded_serving(
        torch, name, cfg, init_vgg9(torch.Generator().manual_seed(0), cfg, "cpu"),
        solo[name], solo_ms[name], errors) for name, cfg in cfgs.items()}}
    out["seconds_a"] = time.perf_counter() - t12
    out["psum"] = check_compressed_psum(torch, errors)
    out["train"] = check_dist_training(torch, errors)
    out["seconds"] = time.perf_counter() - t12
    return out


# ---------------------------------------------------------------------------
# phase 13: tensor parallelism on the card
# ---------------------------------------------------------------------------

# 13a: qwen1.5-4b at full width, 2 layers, fp32, on a (2, 2) mesh of 4 ranks;
# 13b: granite-moe-3b at full width, 2 layers, bf16, remat, on (1, 2); every
# rank on cuda:0 over gloo, so the times say what the collectives cost staged
# through the host, not what NCCL over several cards gives
TP_CASES = {"dense": ("qwen1.5-4b", (2, 2), "float32"),
            "moe": ("granite-moe-3b-a800m", (1, 2), "bfloat16")}
TP_LAYERS, TP_BATCH, TP_SEQ, TP_LR, TP_STEPS = 2, 4, 512, 1e-4, 2
# against one process on the card: loss (relative), worst gradient leaf and
# the parameter tree after one step (relative L2). fp32: the row-parallel
# halves sum in another order; bf16: each half is rounded to bf16 before
# the two are added (the gradients are reported, not barred)
TP_BARS = {"float32": {"loss": 1e-5, "grad": 1e-4, "params": 1e-5},
           "bfloat16": {"loss": 1e-3, "grad": None, "params": 1e-3}}
TP_STATE_BAR = 0.55


def _tp_template(manifest_path, device):
    """A restore template from a checkpoint's manifest: every leaf's shape,
    dtype and device, no data."""
    import types
    import torch
    with open(manifest_path) as f:
        manifest = json.load(f)
    tree: dict = {}
    for leaf in manifest["leaves"]:
        keys = [int(k) if k.isdigit() else k.strip("'") for k in leaf["path"][1:-1].split("][")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = types.SimpleNamespace(shape=tuple(leaf["shape"]),
                                               dtype=getattr(torch, leaf["dtype"]),
                                               device=torch.device(device))
    return tree


def _leaf_digest(x) -> str:
    """sha256 of a tensor's bytes (bf16 too: hashed as its 16-bit patterns)."""
    import hashlib
    import torch
    t = x.detach().contiguous().cpu()
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return hashlib.sha256(memoryview(t.view(bits).numpy()).cast("B")).hexdigest()


def tp_rank(case, out_prefix):
    """Phase 13, one torchrun worker (every rank on cuda:0, gloo): the case's
    arch at full width and TP_LAYERS layers on its mesh. Rank 0 first runs
    one process's first step alone on the card (the other ranks wait); then
    every rank places the same seeded weights by `param_spec`, takes the
    first step's gradients (averaged over the data ranks) and TP_STEPS
    AdamW steps, twice from one state, and the dense case writes its
    parameters as a checkpoint and restores it onto a (4, 1) mesh. Each
    rank writes ``{out_prefix}.{rank}.json``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_arch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.context import compute_mesh
    from repro_torch.launch.mesh import make_host_mesh, make_process_mesh
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import replicas_agree
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.schedule import constant
    from repro_torch.train.train_step import (init_train_state, local_rows, make_train_step,
                                              rank_order_mean, value_and_grad)
    from repro_torch.train.tree import keystr, tree_leaves_with_path
    arch, shape, dtype = TP_CASES[case]
    cfg = get_arch(arch).with_(n_layers=TP_LAYERS, dtype=dtype)
    mesh = make_process_mesh(*shape, device="cuda")
    rank = mesh.rank
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    batch = make_batch_fn(cfg, 0, TP_BATCH, TP_SEQ, "cuda")(0)
    opt = make_optimizer(cfg.optimizer)
    loss_fn = lambda p, b: tf.train_loss(p, b, cfg)  # noqa: E731
    step = make_train_step(loss_fn, opt, constant(TP_LR))
    out = {"rank": rank, "coords": [mesh.data_rank, mesh.model_rank], "backend": mesh.backend}

    def sync_ms(t0):
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def nbytes(tree):
        return sum(x.to_local().nbytes if isinstance(x, DTensor) else x.nbytes
                   for _, x in tree_leaves_with_path(tree))

    marks = [("start", time.perf_counter())]
    ref = None
    if rank == 0:                     # one process, alone on the card
        torch.cuda.reset_peak_memory_stats()
        with Routes() as routes:
            loss1, grads1 = value_and_grad(loss_fn)(params, batch)
        grads1 = {keystr(p): g.cpu() for p, g in tree_leaves_with_path(grads1)}
        state = init_train_state(params, opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, _ = step(state, batch)
        one_ms = sync_ms(t0)
        ref = {"loss": float(loss1), "routes": routes.calls, "grads": grads1,
               "params": {keystr(p): x.cpu() for p, x in tree_leaves_with_path(new["params"])}}
        out["one_process"] = {
            "ms": one_ms, "peak_bytes": torch.cuda.max_memory_allocated(),
            "state_bytes": nbytes(params) * 2 + nbytes(state["opt"])}
        del grads1, state, new
        torch.cuda.empty_cache()
    dist.barrier()
    marks.append(("one process", time.perf_counter()))

    def fresh_state():
        """The seeded weights placed by `param_spec` (every rank draws the
        same whole tensors on the card and keeps its shards)."""
        whole = params if params is not None else tf.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
        placed = shd.place(whole, mesh, cfg.fsdp_experts)
        del whole
        torch.cuda.empty_cache()
        return init_train_state(placed, opt)

    state0 = fresh_state()
    params = None
    out["state_bytes"] = nbytes(state0["params"]) * 2 + nbytes(state0["opt"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_data = mesh.shape["data"]

    def whole_on_rank0(x, local=None):
        """The whole tensor of a DTensor leaf (or of ``local`` laid out as
        it) on rank 0; a collective on every rank."""
        if local is not None:
            x = DTensor.from_local(local, x.device_mesh, x.placements, run_check=False,
                                   shape=x.shape, stride=x.stride())
        full = shd.full_tensor(x)
        return full if rank == 0 else None

    def rel(a, b):
        return float((a - b).norm() / max(float(b.norm()), 1e-30))

    with compute_mesh(mesh):
        with Routes() as routes:
            loss, grads = value_and_grad(loss_fn)(state0["params"],
                                                  local_rows(batch, mesh.data_rank, n_data))
        if n_data > 1:
            loss, = rank_order_mean([loss], mesh.group("data"))
        worst, worst_key = 0.0, None
        for path, g in tree_leaves_with_path(grads):
            local = g.to_local()
            if n_data > 1:
                local, = rank_order_mean([local], mesh.group("data"))
            full = whole_on_rank0(g, local)
            if rank == 0:
                r = rel(full, ref["grads"][keystr(path)].cuda())
                if r > worst:
                    worst, worst_key = r, keystr(path)
            del full, local
        out["routes"] = _leaf_digest(torch.cat([i.reshape(-1) for _, i in routes.calls])) \
            if routes.calls else None
        if rank == 0:
            out["loss_rel"] = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
            out["grad_worst"] = [worst, worst_key]
            if routes.calls:
                differ, clear, tokens = route_differences(torch, routes.calls, ref["routes"],
                                                          cfg.top_k)
                out["route_vs_one_process"] = {"differ": differ, "clear": clear,
                                               "tokens": tokens}
        del grads
        torch.cuda.empty_cache()
        marks.append(("gradients", time.perf_counter()))

        def against_one_process(new_params):
            """The parameter tree after the first step against one process's."""
            num = den = 0.0
            worst_p = (0.0, None)
            for path, x in tree_leaves_with_path(new_params):
                full = whole_on_rank0(x)
                if rank == 0:
                    b = ref["params"][keystr(path)].cuda()
                    num += float((full - b).norm()) ** 2
                    den += float(b.norm()) ** 2
                    worst_p = max(worst_p, (rel(full, b), keystr(path)))
                    del b
                del full
            if rank == 0:
                out["params_rel"] = (num / den) ** 0.5
                out["params_worst"] = list(worst_p)

        def run(state, first=False):
            """TP_STEPS steps; the first run also checks the data replicas
            after each step and the first step against one process (the
            rerun is held against the first run's bits)."""
            times, agree, losses = [], [], []
            for i in range(TP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                times.append(sync_ms(t0))
                losses.append(float(metrics["loss"]))
                if first:
                    agree.append(replicas_agree(state, mesh, exact=True) if n_data > 1
                                 else None)
                if first and i == 0:
                    against_one_process(state["params"])
            return state, times, agree, losses

        state, times, agree, losses = run(state0, first=True)
        del state0
        out.update(step_ms=times, agree=agree, losses=losses,
                   peak_bytes=torch.cuda.max_memory_allocated())
        marks.append(("steps", time.perf_counter()))
        kept = [x.to_local().cpu() if isinstance(x, DTensor) else x.cpu()
                for _, x in tree_leaves_with_path(state)]
        del state
        torch.cuda.empty_cache()
        again, times2, _, losses2 = run(fresh_state())
        marks.append(("rerun", time.perf_counter()))
        out["rerun_equal"] = all(
            torch.equal(a, (b.to_local() if isinstance(b, DTensor) else b).cpu())
            for a, (_, b) in zip(kept, tree_leaves_with_path(again)))
        out["rerun_losses"] = losses2
        out["rerun_step_ms"] = times2
        del kept
        ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_tp", case)
        if case == "dense":
            t0 = time.perf_counter()
            ckpt.save(ckpt_dir, TP_STEPS, {"params": again["params"], "step": again["step"]})
            dist.barrier()
            out["save_s"] = time.perf_counter() - t0
    if case == "dense":
        t0 = time.perf_counter()
        final = os.path.join(ckpt_dir, f"step_{TP_STEPS:08d}")
        with compute_mesh(make_host_mesh("cuda")):     # the same 4 ranks as (4, 1)
            restored = ckpt.restore(ckpt_dir, TP_STEPS, _tp_template(
                os.path.join(final, "manifest.json"), "cuda"))
        out["restore_s"] = time.perf_counter() - t0
        equal = True
        for (path, full), (_, x) in zip(tree_leaves_with_path(restored["params"]),
                                        tree_leaves_with_path(again["params"])):
            mine = shd._from_full(full, x.device_mesh, x.placements).to_local()
            equal &= torch.equal(mine, x.to_local())
            del mine
        out["restore_41_equal"] = equal
        if rank == 0:
            out["digests"] = {keystr(p): _leaf_digest(x)
                              for p, x in tree_leaves_with_path(restored["params"])}
        del restored
    if case == "moe":
        # the routing itself, where bf16 rounding does not move the router's
        # input: one fp32 forward, one process against the mesh
        cfg32 = cfg.with_(dtype="float32")
        whole = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg32, "cuda")
        with torch.no_grad():
            if rank == 0:
                with Routes() as one32:
                    tf.forward(whole, batch, cfg32)
            placed = shd.place(whole, mesh)
            del whole
            with compute_mesh(mesh), Routes() as tp32:
                tf.forward(placed, batch, cfg32)
        out["routes_fp32"] = _leaf_digest(torch.cat([i.reshape(-1) for _, i in tp32.calls]))
        if rank == 0:
            differ, clear, tokens = route_differences(torch, tp32.calls, one32.calls,
                                                      cfg.top_k)
            out["route_fp32_vs_one_process"] = {"differ": differ, "clear": clear,
                                                "tokens": tokens}
    marks.append(("end", time.perf_counter()))
    out["seconds"] = {b[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])}
    with open(f"{out_prefix}.{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# 13d: heads the model axis does not divide, on (1, 3): qwen1.5-4b (20 heads
# as 7 / 7 / 6) at 13a's depth and xlstm-125m (4 heads as 2 / 1 / 1) at 11c's
# 4 of its 12 layers, full width, fp32, each rank computing its range of the
# heads; one step of each against one process on the card at
# tests/test_torch_tp.py (a)'s bars
UNEVEN_CASES = (("qwen1.5-4b", TP_LAYERS), ("xlstm-125m", RESUME_LAYERS))
UNEVEN_MESH, UNEVEN_BATCH = (1, 3), 2
UNEVEN_BARS = {"loss": 1e-6, "grad": 1e-5, "params": 1e-5}


def tp_uneven_rank(out_path):
    """Phase 13d, one torchrun worker (every rank on cuda:0, gloo), for each
    of UNEVEN_CASES: rank 0 first takes one process's gradients and one
    AdamW step alone on the card (the other ranks wait, holding nothing);
    then every rank draws the same seeded weights, places them by
    `param_spec` on the (1, 3) mesh and takes the gradients and one step.
    Rank 0 holds them against one process's; each rank writes its head
    range and its peak allocated to ``{out_path}.{rank}.json``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.context import compute_mesh
    from repro_torch.dist.tensor_parallel import tp_axis
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import transformer as tf
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.schedule import constant
    from repro_torch.train.train_step import init_train_state, make_train_step, value_and_grad
    from repro_torch.train.tree import keystr, tree_leaves_with_path
    mesh = make_process_mesh(*UNEVEN_MESH, device="cuda")
    rank = mesh.rank
    out = {"rank": rank, "models": {}}

    def rel(a, b):
        return float((a - b).norm() / max(float(b.norm()), 1e-30))

    for arch, layers in UNEVEN_CASES:
        t0 = time.perf_counter()
        cfg = get_arch(arch).with_(n_layers=layers, dtype="float32")
        opt = make_optimizer(cfg.optimizer)
        loss_fn = lambda p, b: tf.train_loss(p, b, cfg)  # noqa: E731
        step = make_train_step(loss_fn, opt, constant(TP_LR))
        batch = make_batch_fn(cfg, 0, UNEVEN_BATCH, TP_SEQ, "cuda")(0)

        def draw():
            return tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
        rec, ref = {}, None
        if rank == 0:                 # one process, alone on the card
            torch.cuda.reset_peak_memory_stats()
            params = draw()
            loss1, grads1 = value_and_grad(loss_fn)(params, batch)
            grads1 = {keystr(p): g.cpu() for p, g in tree_leaves_with_path(grads1)}
            new, _ = step(init_train_state(params, opt), batch)
            ref = {"loss": float(loss1), "grads": grads1,
                   "params": {keystr(p): x.cpu() for p, x in tree_leaves_with_path(
                       new["params"])}}
            rec["one_process_peak_bytes"] = torch.cuda.max_memory_allocated()
            del params, new, grads1
            torch.cuda.empty_cache()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(shd.place(draw(), mesh), opt)
        torch.cuda.empty_cache()
        with compute_mesh(mesh):
            rec["heads"] = list(tp_axis().span(cfg.n_heads))
            loss, grads = value_and_grad(loss_fn)(state["params"], batch)
            worst = (0.0, None)
            for path, g in tree_leaves_with_path(grads):
                full = shd.full_tensor(g)
                if rank == 0:
                    worst = max(worst, (rel(full, ref["grads"][keystr(path)].cuda()),
                                        keystr(path)))
                del full
            del grads
            new, metrics = step(state, batch)
            num = den = 0.0
            for path, x in tree_leaves_with_path(new["params"]):
                full = shd.full_tensor(x)
                if rank == 0:
                    b = ref["params"][keystr(path)].cuda()
                    num += float((full - b).norm()) ** 2
                    den += float(b.norm()) ** 2
                    del b
                del full
        torch.cuda.synchronize()
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["loss"] = float(loss)
        if rank == 0:
            rec.update(loss_rel=abs(float(loss) - ref["loss"]) / abs(ref["loss"]),
                       step_loss_rel=abs(float(metrics["loss"]) - ref["loss"]) / abs(ref["loss"]),
                       grad_worst=list(worst), params_rel=(num / den) ** 0.5)
        rec["seconds"] = time.perf_counter() - t0
        out["models"][arch] = rec
        del state, new
        torch.cuda.empty_cache()
    with open(f"{out_path}.{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def check_uneven_heads(torch, errors, smi, root):
    """Phase 13d (see UNEVEN_CASES) under torchrun, this script re-entering
    itself as each rank with `--tp-uneven-rank`."""
    t0 = time.perf_counter()
    n = UNEVEN_MESH[0] * UNEVEN_MESH[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
           "--master-addr", "127.0.0.1", "--master-port", str(_free_port()), SCRIPT,
           "--tp-uneven-rank", os.path.join(root, "uneven")]
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(
        ROOT, "src")), capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        lines = [ln for ln in proc.stderr.splitlines() if ln.startswith("[rank")]
        errors.append(f"13d: exit {proc.returncode}: "
                      + "\n".join(lines[-60:] or proc.stderr.splitlines()[-60:]))
        return {"seconds": time.perf_counter() - t0}
    ranks = []
    for r in range(n):
        with open(os.path.join(root, f"uneven.{r}.json")) as f:
            ranks.append(json.load(f))
    res = {"ranks": ranks}
    for arch, layers in UNEVEN_CASES:
        recs = [r["models"][arch] for r in ranks]
        r0 = recs[0]
        bars = UNEVEN_BARS
        if r0["loss_rel"] > bars["loss"] or r0["step_loss_rel"] > bars["loss"] \
                or r0["grad_worst"][0] > bars["grad"] or r0["params_rel"] > bars["params"]:
            errors.append(f"13d {arch}: against one process loss rel {r0['loss_rel']:.3e} "
                          f"(step {r0['step_loss_rel']:.3e}), worst gradient "
                          f"{r0['grad_worst']}, parameters rel L2 {r0['params_rel']:.3e} "
                          f"(bars {bars})")
        if len({r["loss"] for r in recs}) != 1:
            errors.append(f"13d {arch}: the ranks' losses differ: {[r['loss'] for r in recs]}")
        print(f"tp 13d: {arch} full width, {layers} layers, fp32, batch {UNEVEN_BATCH} x "
              f"{TP_SEQ}, mesh {UNEVEN_MESH} ({n} ranks on cuda:0, gloo): heads per rank "
              f"{[tuple(r['heads']) for r in recs]}; peak allocated per rank "
              f"{[round(r['peak_bytes'] / 2**30, 2) for r in recs]} GiB (one process "
              f"{r0['one_process_peak_bytes'] / 2**30:.2f} GiB alone); against one process: "
              f"loss rel {r0['loss_rel']:.3e} (the step's {r0['step_loss_rel']:.3e}), worst "
              f"gradient leaf {r0['grad_worst'][0]:.3e} at {r0['grad_worst'][1]}, parameters "
              f"after one step rel L2 {r0['params_rel']:.3e} (bars {bars}); "
              f"{r0['seconds']:.1f} s [{smi}]")
    res["seconds"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# phase 14: the dry run and its prediction against the card
# ---------------------------------------------------------------------------

# 14a: the three cells the reference has records of (results/dryrun/), and
# one prefill, one decode and one multi-pod cell
DRYRUN_CELLS = (("qwen1.5-4b", "train_4k", "pod"), ("granite-moe-3b-a800m", "train_4k", "pod"),
                ("llama4-maverick-400b-a17b", "train_4k", "pod"),
                ("phi-3-vision-4.2b", "prefill_32k", "pod"),
                ("recurrentgemma-2b", "decode_32k", "pod"),
                ("qwen1.5-4b", "train_4k", "multipod"))
# 14a: FLOP per chip at most (the cells whose heads the 16-way model axis
# does not divide; before each rank computed only its own heads they
# counted 1.0629e15, 3.4830e14 and 2.9879e15)
DRYRUN_FLOP_CEILING = {"qwen1.5-4b_train_4k_pod": 2.0e14,
                       "granite-moe-3b-a800m_train_4k_pod": 7.0e13,
                       "llama4-maverick-400b-a17b_train_4k_pod": 8.0e14}
# 14b: the predicted peak against max_memory_allocated over a step
PEAK_TOL = 0.15


def _cpu_env():
    """A dry-run subprocess's environment: the port on the path, one
    intra-op thread (the processes run side by side)."""
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1")


def start_dry_cells(out_dir, device, nice=0):
    """14a's cells, each `launch.dryrun` in its own process, all at once
    -> {cell: Popen}. They trace on fake tensors on the host; ``nice``
    lowers their priority where they run beside other phases."""
    os.makedirs(out_dir, exist_ok=True)
    prefix = ["nice", "-n", str(nice)] if nice else []
    return {(arch, shape, mesh): _child(
        prefix + [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                  shape, "--mesh", mesh, "--out", out_dir, "--device", device],
        os.path.join(out_dir, f"{arch}_{shape}_{mesh}.log"))
        for arch, shape, mesh in DRYRUN_CELLS}


def _child(argv, log_path):
    """A subprocess of this script's, its output to ``log_path`` (a pipe
    nobody reads until phase 14 could fill), killed when the script exits
    (a failed phase included) if it is still running."""
    import atexit
    log = open(log_path, "w")
    proc = subprocess.Popen(argv, cwd=ROOT, env=_cpu_env(), stdout=log,
                            stderr=subprocess.STDOUT, text=True)
    proc.log_path = log_path
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def _wait(proc, timeout=900):
    """(returncode, the end of its log) of a `_child`."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(proc.log_path) as f:
        return proc.returncode, f.read()[-3000:]


def predict_14b(out_path):
    """14b's prediction, one process: granite-moe-3b-a800m at full width
    and depth on a 1-rank fake mesh, 11a's batch, the donated step: the
    whole step's counts and memory and the pieces' roofline."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.context import compute_mesh
    from repro_torch.launch import costing, dryrun
    from repro_torch.launch.mesh import make_fake_mesh
    cfg = get_arch("granite-moe-3b-a800m")
    shape = ShapeConfig("train_8x512", "train", TRAIN_SEQ, TRAIN_BATCH)
    with make_fake_mesh(1, 1, device="cuda") as mesh:
        raw, mem = dryrun._run_step(cfg, shape, mesh, "cuda")
        with FakeTensorMode(), compute_mesh(mesh):
            cost = costing.measure_pieces(costing.train_pieces(cfg, shape, mesh, "cuda"), mesh)
    terms = costing.roofline(cost["totals"]["flops"], cost["totals"]["bytes"],
                             cost["totals"]["coll_bytes"], 1)
    peak = (mem["argument_bytes_per_chip"] + mem["output_bytes_per_chip"]
            + mem["temp_bytes_per_chip"] - mem["alias_bytes_per_chip"])
    with open(out_path, "w") as f:
        json.dump({"step": raw, "memory": mem, "peak_bytes": peak, "totals": cost["totals"],
                   "roofline": terms.as_dict(), "seconds": time.perf_counter() - t0}, f)


def train_full_depth(torch, smi):
    """14b on the card: granite-moe-3b-a800m at full width and depth, bf16,
    remat, AdamW, the donated step, 11a's batches; 2 steps twice from one
    seeded state (the first step of the first run counted by
    `launch.costing.step_costs`). -> the runs' losses, per-step ms (CUDA
    events), peak allocated over a step above what was allocated before
    the state was built (``base``: earlier phases' leftovers), FLOPs
    counted, bit-identity."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.costing import step_costs
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import transformer as tf
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.train.tree import tree_leaves_with_path
    cfg = get_arch("granite-moe-3b-a800m")
    opt = make_optimizer(cfg.optimizer)
    step = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt,
                           warmup_cosine(TRAIN_LR, 2, 4), donate=True)
    pipe = DataPipeline(make_batch_fn(cfg, 0, TRAIN_BATCH, TRAIN_SEQ), device="cuda")
    out = {"layers": cfg.n_layers, "ms": [], "peaks": [], "losses": []}

    def run(count_first):
        # what earlier phases still hold on the card is not this step's
        gc.collect()
        torch.cuda.empty_cache()
        out["base"] = torch.cuda.memory_allocated()
        params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
        out["params"] = sum(x.numel() for _, x in tree_leaves_with_path(params))
        state = init_train_state(params, opt)
        del params
        losses, it = [], pipe(0)
        for i in range(2):
            _, batch = next(it)
            torch.cuda.synchronize()
            if count_first and i == 0:
                costs, (state, m) = step_costs(step, state, batch)
                out["flops"] = costs["flops"]
            else:
                torch.cuda.reset_peak_memory_stats()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                state, m = step(state, batch)
                end.record()
                torch.cuda.synchronize()
                out["ms"].append(start.elapsed_time(end))
                out["peaks"].append(torch.cuda.max_memory_allocated() - out["base"])
            losses.append(m["loss"].item())
        it.close()
        out["losses"].append(losses)
        return state

    a = run(True)
    a_host = [(path, x.to("cpu")) for path, x in tree_leaves_with_path(a)]
    del a
    torch.cuda.empty_cache()
    b = run(False)
    same = out["losses"][0] == out["losses"][1]
    for (pa, xa), (pb, xb) in zip(a_host, tree_leaves_with_path(b)):
        same = same and pa == pb and xa.dtype == xb.dtype and torch.equal(xa.to("cuda"), xb)
    out["bit_identical"] = bool(same)
    del b, a_host
    torch.cuda.empty_cache()
    return out


DRY_RUN_DIR = os.path.join(ROOT, "build", "dryrun_torch")


def start_prediction(out_dir):
    """14b's prediction (`predict_14b`) in its own process."""
    os.makedirs(out_dir, exist_ok=True)
    return _child([sys.executable, SCRIPT, "--predict-14b",
                   os.path.join(out_dir, "predict_14b.json")],
                  os.path.join(out_dir, "predict_14b.log"))


def check_dry_run(torch, errors, smi, started=None):
    """Phase 14 (see the module docstring); ``started``: 14a's processes
    and 14b's prediction if they were started earlier, else they start
    here, the cells naming the card."""
    import numpy as np
    t0 = time.perf_counter()
    out_dir = DRY_RUN_DIR
    procs = dict(started or dict(start_dry_cells(out_dir, "cuda"),
                                 predict=start_prediction(out_dir)))
    torch.cuda.empty_cache()
    card = train_full_depth(torch, smi)
    t_card = time.perf_counter() - t0
    runs = {name: _wait(proc) for name, proc in procs.items()}
    out = {"cells": {}, "card": card, "seconds_card": t_card}

    # 14a
    for arch, shape, mesh in DRYRUN_CELLS:
        rc, log = runs[(arch, shape, mesh)]
        tag = f"{arch}_{shape}_{mesh}"
        path = os.path.join(out_dir, f"{tag}.json")
        rec = {}
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
        if rc != 0 or rec.get("status") != "ok":
            errors.append(f"14a: dry run of {tag} rc {rc}, status {rec.get('status')}: "
                          f"{log[-600:]}")
            continue
        ref_path = os.path.join(ROOT, "results", "dryrun", f"{tag}.json")
        match, ref = None, None
        if os.path.exists(ref_path):
            with open(ref_path) as f:
                ref = json.load(f)
            match = all(rec[k] == ref[k] for k in ("params_total", "params_active",
                                                   "model_flops"))
            if not match:
                errors.append(f"14a: {tag} counts differ from the reference's record")
        if rec["totals"]["flops"] > DRYRUN_FLOP_CEILING.get(tag, math.inf):
            errors.append(f"14a: {tag} counts {rec['totals']['flops']:.4e} FLOP per chip, "
                          f"over {DRYRUN_FLOP_CEILING[tag]:.1e}")
        out["cells"][tag] = {"trace_s": rec["trace_s"], "pieces_s": rec["pieces_s"],
                             "memory": rec["memory"], "totals": rec["totals"],
                             "roofline": rec["roofline"], "step_raw": rec["step_raw"],
                             "params_total": rec["params_total"],
                             "params_active": rec["params_active"],
                             "model_flops": rec["model_flops"],
                             "useful_flops_ratio": rec["useful_flops_ratio"],
                             "reference_counts_equal": match}
        r = rec["roofline"]
        t = rec["totals"]
        print(f"dry run {tag} [{smi}; the predicted per-chip costs of a {rec['chips']}-chip "
              f"mesh]: ok, trace {rec['trace_s']} s + pieces {rec['pieces_s']} s "
              f"({rec['memory']['method']}); peak {rec['memory']['peak_estimate_gib']} GiB "
              f"per chip; totals {t['flops']:.4e} FLOP, {t['bytes']:.4e} bytes, "
              f"{t['coll_bytes']:.4e} wire bytes; roofline comp {r['t_comp_s']:.4f} s, mem "
              f"{r['t_mem_s']:.4f} s, coll {r['t_coll_s']:.4f} s ({r['dominant']}); params "
              f"{rec['params_total']} / {rec['params_active']} active, model FLOPs "
              f"{rec['model_flops']}"
              + ("" if match is None else f"; reference's counts equal: {match}; the "
                 f"reference's record {ref['totals']['flops']:.4e} FLOP, "
                 f"{ref['totals']['coll_bytes']:.4e} wire bytes, peak "
                 f"{ref['memory']['peak_estimate_gib']} GiB per chip"))

    # 14b
    rc, log = runs["predict"]
    pred_path = os.path.join(out_dir, "predict_14b.json")
    if rc != 0 or not os.path.exists(pred_path):
        errors.append(f"14b: the prediction failed (rc {rc}): {log[-600:]}")
        out["seconds"] = time.perf_counter() - t0
        return out
    with open(pred_path) as f:
        pred = json.load(f)
    out["predicted"] = pred
    peak = max(card["peaks"])
    ms = float(np.median(card["ms"]))
    bound_ms = pred["roofline"]["bound_s"] * 1e3
    from repro_torch.configs import get_arch
    lm_bound_ms = train_step_bound(get_arch("granite-moe-3b-a800m"), card["params"],
                                   TRAIN_BATCH, TRAIN_SEQ)[0]
    off = abs(pred["peak_bytes"] - peak) / peak
    out.update({"measured_peak_bytes": peak, "peak_off": off, "median_ms": ms,
                "roofline_bound_ms": bound_ms, "train_lm_bound_ms": lm_bound_ms})
    if not card["bit_identical"]:
        errors.append(f"14b: two 2-step runs from one state differ: {card['losses']}")
    if not all(math.isfinite(v) for run in card["losses"] for v in run):
        errors.append(f"14b: losses {card['losses']}")
    if off > PEAK_TOL:
        errors.append(f"14b: predicted peak {pred['peak_bytes']} bytes against "
                      f"{peak} measured ({100 * off:.1f}% off)")
    if card["flops"] != pred["step"]["flops"]:
        errors.append(f"14b: the real step counts {card['flops']} FLOPs, the dry run "
                      f"{pred['step']['flops']}")
    print(f"train granite-moe-3b-a800m at full depth ({card['layers']} layers, full width, "
          f"bf16, remat, AdamW, donated step, {card['params']} parameters) [{smi}]: batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}; 2-step runs from one state bit-identical "
          f"{card['bit_identical']}; losses {card['losses']}")
    print(f"train granite-moe-3b-a800m full depth: peak allocated over a step {peak} bytes "
          f"({peak / 2**30:.3f} GiB, above {card['base']} allocated before the state) "
          f"against the dry run's {pred['peak_bytes']} "
          f"({pred['peak_bytes'] / 2**30:.3f} GiB; {100 * off:.1f}% off; on a 1-rank mesh in "
          f"{pred['seconds']:.1f} s); FLOPs counted on the card {card['flops']:.6e}, "
          f"predicted {pred['step']['flops']:.6e}, pieces {pred['totals']['flops']:.6e}")
    print(f"train granite-moe-3b-a800m full depth: step ms (CUDA events) "
          f"{[round(v, 3) for v in card['ms']]}, median {ms:.3f} ms; roofline bound "
          f"{bound_ms:.3f} ms ({pred['roofline']['dominant']}: comp "
          f"{pred['roofline']['t_comp_s'] * 1e3:.3f}, mem {pred['roofline']['t_mem_s'] * 1e3:.3f}"
          f" ms), the step at {100 * bound_ms / ms:.1f}% of it; 11a's train_step_bound at "
          f"{card['layers']} layers {lm_bound_ms:.3f} ms")
    out["seconds"] = time.perf_counter() - t0
    return out


def check_tensor_parallel(torch, errors, smi):
    """Phase 13: 13a (qwen1.5-4b, (2, 2)) and 13b (granite-moe-3b, (1, 2))
    under torchrun, this script re-entering itself as each rank with
    `--tp-rank`; then 13c: the checkpoint 13a wrote on (2, 2), which its
    ranks restored onto (4, 1), restored onto this one process, every leaf
    bit-identical; then 13d (`check_uneven_heads`)."""
    import shutil
    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke_tp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = {}
    for case, (arch, shape, dtype) in TP_CASES.items():
        t1 = time.perf_counter()
        n = shape[0] * shape[1]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
               "--master-addr", "127.0.0.1", "--master-port", str(_free_port()), SCRIPT,
               "--tp-rank", case, os.path.join(root, case)]
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            # the failing ranks' tracebacks, not torchrun's summary
            lines = [ln for ln in proc.stderr.splitlines() if ln.startswith("[rank")]
            errors.append(f"13 {case}: exit {proc.returncode}: "
                          + "\n".join(lines[-60:] or proc.stderr.splitlines()[-60:]))
            continue
        ranks = []
        for r in range(n):
            with open(os.path.join(root, f"{case}.{r}.json")) as f:
                ranks.append(json.load(f))
        r0, one = ranks[0], ranks[0]["one_process"]
        bars = TP_BARS[dtype]
        ratio = max(r["state_bytes"] for r in ranks) / one["state_bytes"]
        agree = [r["agree"] for r in ranks]
        res[case] = {"ranks": ranks, "seconds": time.perf_counter() - t1, "state_ratio": ratio}
        tag = "13a" if case == "dense" else "13b"
        if shape[0] > 1 and not all(all(a) for a in agree):
            errors.append(f"{tag}: data replicas differ after a step: {agree}")
        if not all(r["rerun_equal"] for r in ranks):
            errors.append(f"{tag}: a second run of the {TP_STEPS} steps gave other bits")
        if ratio > TP_STATE_BAR:
            errors.append(f"{tag}: a rank's state is {ratio:.3f} of one process's")
        if r0["loss_rel"] > bars["loss"] or r0["params_rel"] > bars["params"] or (
                bars["grad"] is not None and r0["grad_worst"][0] > bars["grad"]):
            errors.append(f"{tag}: against one process loss rel {r0['loss_rel']:.3e}, worst "
                          f"gradient {r0['grad_worst']}, parameters rel L2 "
                          f"{r0['params_rel']:.3e} (bars {bars})")
        if case == "moe":
            rv = r0["route_fp32_vs_one_process"]
            same = {r["routes"] for r in ranks}, {r["routes_fp32"] for r in ranks}
            if len(same[0]) != 1 or len(same[1]) != 1 or rv["clear"]:
                errors.append(f"13b: expert sets differ between the model ranks (bf16 "
                              f"{len(same[0])}, fp32 {len(same[1])} digests) or, in fp32, from "
                              f"one process where the router's gap exceeds {ROUTE_GAP}: {rv}")
        step_ms = [round(v, 1) for r in ranks for v in r["step_ms"]]
        print(f"tp {tag}: {arch} full width, {TP_LAYERS} layers, {dtype}, batch {TP_BATCH} x "
              f"{TP_SEQ}, mesh {shape} ({n} ranks on cuda:0, {r0['backend']}): state per rank "
              f"{[r['state_bytes'] for r in ranks]} B = {ratio:.3f} of one process's "
              f"{one['state_bytes']} B; peak allocated per rank "
              f"{[round(r['peak_bytes'] / 2**30, 2) for r in ranks]} GiB (one process "
              f"{one['peak_bytes'] / 2**30:.2f} GiB alone); ms per step {step_ms} against one "
              f"process's {one['ms']:.1f} [{smi}]")
        print(f"tp {tag}: against one process: loss rel {r0['loss_rel']:.3e}, worst gradient "
              f"leaf {r0['grad_worst'][0]:.3e} at {r0['grad_worst'][1]}, parameters after "
              f"step 1 rel L2 {r0['params_rel']:.3e} (worst leaf {r0['params_worst'][0]:.3e} "
              f"at {r0['params_worst'][1]}; bars {bars}); losses {r0['losses']}, rerun "
              f"{r0['rerun_losses']} bit-identical {all(r['rerun_equal'] for r in ranks)}; data "
              f"replicas bit-identical after each step {agree}; {res[case]['seconds']:.1f} s "
              f"(rank 0: {r0['seconds']})")
        if case == "moe":
            print(f"tp 13b: expert sets equal on the model ranks, bf16 "
                  f"{len({r['routes'] for r in ranks}) == 1}, fp32 "
                  f"{len({r['routes_fp32'] for r in ranks}) == 1}; against one process (tokens "
                  f"whose set differs, of them with the router's k-th/(k+1)-th gap above "
                  f"{ROUTE_GAP}, tokens routed) bf16 {r0['route_vs_one_process']} (the "
                  f"row-parallel halves are rounded to bf16 before they are added, which moves "
                  f"the router's input), fp32 forward {r0['route_fp32_vs_one_process']}")
    if "dense" in res:
        ranks = res["dense"]["ranks"]
        t1 = time.perf_counter()
        final = os.path.join(root, "dense", f"step_{TP_STEPS:08d}")
        from repro_torch.train import checkpoint as ckpt
        restored = ckpt.restore(os.path.join(root, "dense"), TP_STEPS,
                                _tp_template(os.path.join(final, "manifest.json"), "cpu"))
        from repro_torch.train.tree import keystr, tree_leaves_with_path
        mine = {keystr(p): _leaf_digest(x) for p, x in tree_leaves_with_path(restored["params"])}
        del restored
        equal41 = all(r["restore_41_equal"] for r in ranks)
        one_equal = mine == ranks[0]["digests"]
        res["restore"] = {"equal_41": equal41, "one_process_equal": one_equal,
                          "seconds": time.perf_counter() - t1}
        if not (equal41 and one_equal):
            errors.append(f"13c: restored onto (4, 1) equal {equal41}, onto one process equal "
                          f"{one_equal}")
        print(f"tp 13c: 13a's parameters saved on (2, 2) ({ranks[0]['save_s']:.1f} s, rank 0 "
              f"writing the gathered leaves), restored onto (4, 1) (every rank's shards "
              f"bit-identical {equal41}, {ranks[0]['restore_s']:.1f} s) and onto one process "
              f"(every leaf's digest equal {one_equal}, {res['restore']['seconds']:.1f} s)")
    torch.cuda.empty_cache()
    res["uneven"] = check_uneven_heads(torch, errors, smi, root)
    shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    return res


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"no src/repro_torch beside {os.path.basename(__file__)}: run from a checkout")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (sets the TF32 flags)
    from repro_torch.configs import get_arch, vgg9_snn
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
    sass = check_sass(built["path"], built["log"])
    if "--sweep" in sys.argv[1:]:
        gen = torch.Generator(device="cuda").manual_seed(0)
        qwen = get_arch("qwen1.5-4b").with_(dtype="float32")
        failed = sweep_int4_geometry(torch, int4_shapes(qwen, LM_SLOTS, LM_MAX_SEQ), gen)
        if failed:
            fail(f"int4_matmul differs from its plain version at {failed}")
        failed = sweep_event_geometry(torch, main_path_shapes(vgg9_snn.CIFAR10, SLOTS)[1], gen)
        if failed:
            fail(f"spike_matmul_mapped differs from the k-ascending sum at {failed}")
        failed = sweep_gated_geometry(torch, unfused_shapes(vgg9_snn.CIFAR10, SLOTS)[0], gen)
        if failed:
            fail(f"spike_matmul differs from the k-ascending sum at {failed}")
        print("sweep: every spike-matmul geometry bit-identical to the k-ascending sum; "
              "every int4 geometry within its bar of the plain version")
        return
    if "--phase14" in sys.argv[1:]:
        errors = []
        dry = check_dry_run(torch, errors, smi_line)
        print(f"phase 14 dry run: {len(errors)} errors in {dry['seconds']:.1f} s "
              f"[{smi_line}]")
        if errors:
            fail("; ".join(errors))
        return
    if "--phase13" in sys.argv[1:]:
        errors = []
        tensor_parallel = check_tensor_parallel(torch, errors, smi_line)
        print(f"phase 13 tensor parallel: {len(errors)} errors in "
              f"{tensor_parallel['seconds']:.1f} s [{smi_line}]")
        if errors:
            fail("; ".join(errors))
        return
    if "--phase12" in sys.argv[1:]:
        errors = []
        cfgs = {"CIFAR10": vgg9_snn.CIFAR10, "CIFAR10_INT4": vgg9_snn.CIFAR10_INT4}
        solo, solo_ms = {}, {}
        for name, scfg in cfgs.items():
            params = {k: {kk: v.to("cuda") for kk, v in leaf.items()} for k, leaf in
                      init_vgg9(torch.Generator().manual_seed(0), scfg, "cpu").items()}
            imgs = make_requests(torch, scfg)
            serve(torch, scfg, params, imgs[:SLOTS], "cuda")
            core, solo[name], seconds = serve(torch, scfg, params, imgs, "cuda")
            solo_ms[name] = seconds / core.stats()["steps_run"] * 1e3
        distribution = check_distribution(torch, cfgs, solo, solo_ms, errors)
        print(f"phase 12 distribution: {len(errors)} errors in "
              f"{distribution['seconds']:.1f} s")
        if errors:
            fail("; ".join(errors))
        return

    # 14a's dry-run cells trace on the host from here on, niced, beside
    # phases 3-13 (fake tensors naming the host: no card memory held), and
    # 14b's prediction (a minute, naming the card)
    dry_runs = dict(start_dry_cells(DRY_RUN_DIR, "cpu", nice=10),
                    predict=start_prediction(DRY_RUN_DIR))

    # 3. kernels
    qwen = get_arch("qwen1.5-4b").with_(dtype="float32")
    cfg = vgg9_snn.CIFAR10
    gen = torch.Generator(device="cuda").manual_seed(0)
    dense_shape, mm_shapes, epi_shapes = main_path_shapes(cfg, SLOTS)
    gated_shapes, lif_shapes = unfused_shapes(cfg, SLOTS)
    # kernel 6: fp32 x at qwen's eight shapes and at serve_lm_w4 --full's
    # shape for the other archs (K = their d_model, phase 9d) goes in the
    # kernels line; bf16 x at qwen's prefill shapes and LM head is held and
    # printed beside it
    int4_qwen = int4_shapes(qwen, LM_SLOTS, LM_MAX_SEQ)
    int4_family = [(4, k, 256) for k in sorted({get_arch(a).d_model for a in FAMILY}
                                               - {qwen.d_model})]
    # kernel 1 at density 0.1 goes in the kernels line, as in every
    # earlier run; its denser rows are held and printed beside it
    mapped = {d: check_spike_matmul(torch, mm_shapes, gen, d) for d in DENSITIES}
    gated = {d: check_spike_matmul_gated(torch, gated_shapes, gen, d) for d in DENSITIES}
    table = {
        "spike_matmul_mapped": mapped[0.1],
        "lif_epilogue_scan": check_lif_epilogue(torch, epi_shapes, cfg.timesteps, gen),
        "dense_conv_lif": check_dense_conv_lif(torch, dense_shape, cfg.timesteps, gen),
        "spike_matmul": gated[0.1],
        "lif_step": check_lif_step(torch, lif_shapes, gen),
        "int4_matmul": check_int4_matmul(torch, int4_qwen + int4_family, gen, torch.float32),
        "flash_attention": check_flash_attention(torch, gen, qwen.n_heads, qwen.hd),
    }
    failed = []
    checked = dict(table)
    checked.update({f"spike_matmul_mapped density={d}": mapped[d] for d in DENSITIES[1:]})
    checked.update({f"spike_matmul density={d}": gated[d] for d in DENSITIES[1:]})
    checked["int4_matmul bf16"] = check_int4_matmul(
        torch, [sh for sh in int4_qwen if sh[0] == LM_MAX_SEQ or sh[2] == qwen.vocab], gen,
        torch.bfloat16)
    for kname, rows in checked.items():
        for r in rows:
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            extra = f" skip={r['skip']:.4f}" if "skip" in r else ""
            if "tflops" in r:
                extra += f" tflops={r['tflops']:.1f} bound_share={r['bound_share']:.3f}"
            if "graph_ms" in r:
                extra += f" graph_ms={r['graph_ms']:.4f}"
            if "library_graph_ms" in r:
                extra += f" library_graph_ms={r['library_graph_ms']:.4f}"
            if "launch" in r:
                extra += f" launch=({r['launch']})"
            if "ordered_bits" in r:
                extra += f" ordered_bits={r['ordered_bits']}"
            if "simt_bound_ms" in r:
                extra += (f" path={r['path']} token_width={r['token_width']} "
                          f"warpgroups={r['warpgroups']} tiles={r['tiles']} stages={r['stages']} "
                          f"splits={r['splits']} {'whole' if r['whole'] else 'split'} "
                          f"ctas={r['ctas']} bound_share={r['bound_share']:.3f} "
                          f"simt_bound_ms={r['simt_bound_ms']:.4f} ({r['simt_bound_by']}) "
                          f"device ms by kernel "
                          + " ".join(f"{k}={v:.4f}" for k, v in r["parts_ms"].items())
                          + f" failed={r['failed']}")
            if "tile_bound_ms" in r:
                extra += (f" blocks={r['blocks']} ({r['geometry']}) set_bits={r['set_bits']} "
                          f"tile_bound_ms={r['tile_bound_ms']:.4f} ({r['tile_bound_by']}: "
                          f"{r['tile_flops']:.0f} flops) failed={r['failed']}")
            ops = f"{r['adds']:.0f} adds" if "adds" in r else f"{r['flops']:.0f} flops"
            print(f"  {kname} {r['shape']}: ok={r['ok']} err={r['err']:.3e} "
                  f"(tol {r['tol']:.1e}){extra} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={lib} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}: "
                  f"{r['bytes']:.0f} bytes, {ops})")
            if not r["ok"]:
                failed.append(f"{kname} {r['shape']}")
    for kname, by_density in (("spike_matmul_mapped", mapped), ("spike_matmul", gated)):
        for d in DENSITIES:
            rows = by_density[d]
            graph = (f" graph_ms={sum(r['graph_ms'] for r in rows):.4f}"
                     f" library_graph_ms={sum(r['library_graph_ms'] for r in rows):.4f}"
                     if "graph_ms" in rows[0] else "")
            print(f"  {kname} density={d}: sum over shapes ms={sum(r['ms'] for r in rows):.4f}"
                  f"{graph} plain_ms={sum(r['plain_ms'] for r in rows):.4f} library_ms="
                  f"{sum(r['library_ms'] for r in rows):.4f} bound_ms="
                  f"{sum(r['bound_ms'] for r in rows):.4f} tile_bound_ms="
                  f"{sum(r['tile_bound_ms'] for r in rows):.4f}")
    int4_rows = {"int4_matmul": checked["int4_matmul"],
                 "int4_matmul qwen": checked["int4_matmul"][:len(int4_qwen)],
                 "int4_matmul family": checked["int4_matmul"][len(int4_qwen):],
                 "int4_matmul bf16": checked["int4_matmul bf16"]}
    for kname, rows in int4_rows.items():
        print(f"  {kname}: sum over shapes ms={sum(r['ms'] for r in rows):.4f} graph_ms="
              f"{sum(r['graph_ms'] for r in rows):.4f} library_ms="
              f"{sum(r['library_ms'] for r in rows):.4f} library_graph_ms="
              f"{sum(r['library_graph_ms'] for r in rows):.4f} bound_ms="
              f"{sum(r['bound_ms'] for r in rows):.4f} simt_bound_ms="
              f"{sum(r['simt_bound_ms'] for r in rows):.4f}")
    floor_ms = launch_floor_ms(torch)
    print(f"  launch floor: lif_epilogue_scan T=2 R=1 N=8 graph_ms={floor_ms:.4f}")
    print(f"phase 3 kernels: {sum(len(r) for r in checked.values())} shapes, "
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

    # 5. unfused
    unfused = {}
    for name, scfg in (("CIFAR10", vgg9_snn.CIFAR10), ("CIFAR10_INT4", vgg9_snn.CIFAR10_INT4)):
        params = init_vgg9(torch.Generator().manual_seed(0), scfg, "cpu")
        unfused[name] = check_unfused(torch, name, scfg, params, errors)
    print(f"phase 5 unfused: {len(errors)} errors")
    if errors:
        fail("; ".join(errors))

    # 6. train
    trained = {}
    for name, scfg in (("CIFAR10", vgg9_snn.CIFAR10), ("CIFAR10_INT4", vgg9_snn.CIFAR10_INT4)):
        trained[name] = check_training(torch, name, scfg, errors)
    for layer in trained["CIFAR10"]["spikes_after"]:
        print(f"  {layer}: spikes after 5 steps fp32 "
              f"{trained['CIFAR10']['spikes_after'][layer]:.0f} int4 "
              f"{trained['CIFAR10_INT4']['spikes_after'][layer]:.0f}")
    print(f"phase 6 train: {len(errors)} errors")
    if errors:
        fail("; ".join(errors))

    # 7. lm
    lm = {"serve": check_lm_serving(torch, qwen, "cuda", errors, smi=smi_line)}
    lm["cpu"], params2 = check_lm_against_cpu(torch, qwen.with_(n_layers=2), "cuda", errors)
    lm["attention"] = check_prefill_attention(torch, qwen.with_(n_layers=2), params2, errors)
    del params2
    torch.cuda.empty_cache()
    lm["serve_lm_w4"] = check_serve_lm_w4(torch, errors)
    print(f"phase 7 lm: {len(errors)} errors")
    if errors:
        fail("; ".join(errors))

    # 8. precision, observability, the CLI and the study
    t8 = time.perf_counter()
    precision = check_precision_serving(
        torch, cfg, init_vgg9(torch.Generator().manual_seed(0), cfg, "cpu"), errors)
    precision["lm"] = check_lm_precision(torch, qwen.with_(n_layers=2), errors)
    precision["entry_points"] = check_entry_points(errors)
    precision["seconds"] = time.perf_counter() - t8
    print(f"phase 8 precision: {len(errors)} errors in {precision['seconds']:.1f} s")
    if errors:
        fail("; ".join(errors))

    # 9. the rest of the LM family
    t9 = time.perf_counter()
    family = check_family(torch, errors, smi_line)
    family["seconds"] = time.perf_counter() - t9
    print(f"phase 9 lm family: {len(errors)} errors in {family['seconds']:.1f} s "
          f"(9a {family['seconds_a']:.1f}, 9b {family['seconds_b']:.1f}, 9c "
          f"{family['seconds_c']:.1f}, 9d {family['seconds_d']:.1f}) [{smi_line}]")
    if errors:
        fail("; ".join(errors))

    # 10. the serving fleet
    t10 = time.perf_counter()
    solo = served["CIFAR10"].pop("results")
    solo_int4 = served["CIFAR10_INT4"].pop("results")
    fleet = {"inproc": check_fleet_inproc(
        torch, cfg, init_vgg9(torch.Generator().manual_seed(0), cfg, "cpu"), solo, errors)}
    fleet["seconds_a"] = time.perf_counter() - t10
    fleet["workers"] = check_fleet_workers(torch, cfg, solo, errors)
    fleet["seconds_b"] = time.perf_counter() - t10 - fleet["seconds_a"]
    torch.cuda.empty_cache()
    fleet["lm"] = check_fleet_lm(torch, qwen.with_(n_layers=2), errors)
    fleet["seconds_c"] = time.perf_counter() - t10 - fleet["seconds_a"] - fleet["seconds_b"]
    fleet["cli"] = check_fleet_cli(errors)
    fleet["seconds"] = time.perf_counter() - t10
    print(f"phase 10 fleet: {len(errors)} errors in {fleet['seconds']:.1f} s (10a "
          f"{fleet['seconds_a']:.1f}, 10b {fleet['seconds_b']:.1f}, 10c "
          f"{fleet['seconds_c']:.1f}, 10d {fleet['cli']['seconds']:.1f}) [{smi_line}]")
    if errors:
        fail("; ".join(errors))

    # 11. LM training
    t11 = time.perf_counter()
    torch.cuda.empty_cache()
    lm_train = {"moe": check_lm_training(torch, errors, smi_line)}
    lm_train["seconds_a"] = time.perf_counter() - t11
    lm_train["cpu"] = {arch: check_train_against_cpu(torch, arch, errors)
                       for arch in ("granite-moe-3b-a800m", "xlstm-125m")}
    lm_train["seconds_b"] = time.perf_counter() - t11 - lm_train["seconds_a"]
    lm_train["resume"] = check_train_resume(torch, errors)
    lm_train["seconds"] = time.perf_counter() - t11
    print(f"phase 11 train: {len(errors)} errors in {lm_train['seconds']:.1f} s (11a "
          f"{lm_train['seconds_a']:.1f}, 11b {lm_train['seconds_b']:.1f}, 11c "
          f"{lm_train['resume']['seconds_loop']:.1f} + cli "
          f"{lm_train['resume']['cli_seconds']:.1f}) [{smi_line}]")
    if errors:
        fail("; ".join(errors))

    # 12. distribution
    torch.cuda.empty_cache()
    distribution = check_distribution(
        torch, {"CIFAR10": cfg, "CIFAR10_INT4": vgg9_snn.CIFAR10_INT4},
        {"CIFAR10": solo, "CIFAR10_INT4": solo_int4},
        {k: v["ms_per_step"] for k, v in served.items()}, errors)
    print(f"phase 12 distribution: {len(errors)} errors in {distribution['seconds']:.1f} s "
          f"(12a {distribution['seconds_a']:.1f}, 12b {distribution['psum']['seconds']:.1f}, "
          f"12c+d {distribution['train']['seconds']:.1f}) [{smi_line}; every shard and rank "
          f"on one card]")
    if errors:
        fail("; ".join(errors))

    # 13. tensor parallelism
    torch.cuda.empty_cache()
    tensor_parallel = check_tensor_parallel(torch, errors, smi_line)
    print(f"phase 13 tensor parallel: {len(errors)} errors in "
          f"{tensor_parallel['seconds']:.1f} s [{smi_line}; every rank on one card]")
    if errors:
        fail("; ".join(errors))

    # 14. the dry run, and its prediction against the card
    torch.cuda.empty_cache()
    dry_run = check_dry_run(torch, errors, smi_line, dry_runs)
    print(f"phase 14 dry run: {len(errors)} errors in {dry_run['seconds']:.1f} s "
          f"(card {dry_run['seconds_card']:.1f}) [{smi_line}]")
    if errors:
        fail("; ".join(errors))

    csrc = "src/repro_torch/kernels/{}/csrc/{}.cu"
    sources = {"spike_matmul_mapped": csrc.format("spike_conv", "spike_matmul_mapped"),
               "lif_epilogue_scan": csrc.format("lif_step", "lif_epilogue_scan"),
               "dense_conv_lif": csrc.format("dense_conv_lif", "dense_conv_lif"),
               "spike_matmul": csrc.format("spike_conv", "spike_matmul"),
               "lif_step": csrc.format("lif_step", "lif_step"),
               "int4_matmul": csrc.format("int4_matmul", "int4_matmul"),
               "flash_attention": csrc.format("flash_attention", "flash_attention")}
    replaces = {"spike_matmul_mapped": "src/repro/kernels/spike_conv/spike_conv.py:119",
                "lif_epilogue_scan": "src/repro/kernels/lif_step/lif_step.py:72",
                "dense_conv_lif": "src/repro/kernels/dense_conv_lif/dense_conv_lif.py:40",
                "spike_matmul": "src/repro/kernels/spike_conv/spike_conv.py:57",
                "lif_step": "src/repro/kernels/lif_step/lif_step.py:25",
                "int4_matmul": "src/repro/kernels/int4_matmul/int4_matmul.py:47",
                "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:71"}
    # launches of each kernel in the runs of its own main paths: serving
    # (phase 4), adaptive-precision serving (phase 8a), the in-process
    # fleet (phase 10a) and sharded serving (phase 12a) for the fused
    # pipeline's kernels, the unfused pipeline (phase 5) for the two it
    # alone runs
    main_runs = {k: [v["launches"] for v in served.values()]
                 + [precision["modes"]["adaptive"]["launches"], fleet["inproc"]["launches"]]
                 + [v["launches"] for v in distribution["serve"].values()]
                 for k in ("spike_matmul_mapped", "lif_epilogue_scan", "dense_conv_lif")}
    main_runs.update({k: [v["launches"] for v in unfused.values()]
                      for k in ("spike_matmul", "lif_step")})
    # the LM's kernels: serve_lm_w4 --full (phases 7c and 9d) and the layer-0
    # prefill attention (phase 7d)
    main_runs["int4_matmul"] = [lm["serve_lm_w4"]["launches"]] + [
        run["launches"] for run in family["serve_lm_w4"].values()]
    main_runs["flash_attention"] = [run["launches"] for run in lm["attention"].values()]
    kernels = []
    for kname, rows in table.items():
        b_total = sum(r["bound_ms"] for r in rows)
        by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        lib = [r["library_ms"] for r in rows]
        kernels.append({
            "name": kname, "route": "cuda", "source": sources[kname],
            "replaces": replaces[kname],
            "launches": sum(run[kname] for run in main_runs[kname]),
            "max_abs_err": max(r["err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": b_total,
            "bound_by": "operations" if by_ops * 2 > b_total else "bytes",
            "library_ms": None if any(v is None for v in lib) else sum(lib),
            "shapes": len(rows), "ok": all(r["ok"] for r in rows)})
        if all("graph_ms" in r for r in rows):
            kernels[-1]["graph_ms"] = sum(r["graph_ms"] for r in rows)
        if all("simt_bound_ms" in r for r in rows):
            kernels[-1]["simt_bound_ms"] = sum(r["simt_bound_ms"] for r in rows)
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi_line, "sass": sass, "kernels": checked,
                   "launch_floor_ms": floor_ms,
                   "serve": served, "unfused": unfused, "train": trained, "lm": lm,
                   "precision": precision, "family": family, "fleet": fleet,
                   "lm_train": lm_train, "distribution": distribution,
                   "tensor_parallel": tensor_parallel, "dry_run": dry_run}, f,
                  indent=1,
                  default=str)
    if any(math.isnan(k["ms"]) for k in kernels):
        fail("a kernel time is NaN")
    if any(k["launches"] == 0 for k in kernels):
        fail(f"a kernel was not launched on its main path: {kernels}")
    print(f"phases 1-14 in {time.perf_counter() - t_start:.1f} s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-rank"]:
        train_rank(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == ["--tp-rank"]:
        tp_rank(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--tp-uneven-rank"]:
        tp_uneven_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--predict-14b"]:
        predict_14b(sys.argv[2])
    else:
        main()
