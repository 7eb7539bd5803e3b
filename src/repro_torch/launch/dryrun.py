"""Production dry run: trace every (arch x shape x mesh) cell on fake tensors.

The reference lowers and compiles each cell's step for 256 / 512 host
devices. The port runs it as one rank would: for each cell this

  1. builds the production mesh (`launch.mesh.make_production_mesh`:
     16x16 single pod, 2x16x16 multi-pod) over a fake process group, of
     which this process is rank 0;
  2. builds the state, batch and cache as fake tensors, laid out by the
     production rules (`launch.specs`; no parameter is allocated);
  3. runs the real step (train with its state donated, prefill, decode
     with its cache written in place) on them under `launch.costing`'s
     dispatch mode: the step's FLOPs, bytes and wire bytes (``step_raw``)
     and the storages alive at once over it (``memory``);
  4. measures the cost *pieces* (`launch.costing`) and composes the
     roofline terms on one H100, written to ``--out``/*.json.

Where the whole-step trace of a cell would take minutes, it is cut and
extrapolated linearly (``memory.method`` says how): a deep model with many
attention chunk pairs (`_trace_units` over `_UNITS_LIMIT`) is traced at
depths of 1 and 2 periods and extrapolated to its depth (a period's ops,
parameters and stashed activations are the same in every period), and
long sLSTM loops (``n_slstm * seq_len`` over `_LOOP_LIMIT`) are cut to
their first 1 and 2 positions (`models.xlstm.TRACE_STEPS`) and
extrapolated to ``seq_len`` (a loop step's ops and the outputs and saved
activations it adds are the same at every position).

Record keys are the reference's, apart from ``compile_s`` -> ``trace_s``
and ``hlo_raw`` -> ``step_raw``. ``--device cuda`` (the default) names the
card, as every entry point does, and raises without one; the tests pass
``cpu``.

Usage:
    python -m repro_torch.launch.dryrun --device cpu --arch granite-34b --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --device cpu --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Tuple

# sLSTM loop steps (layers x positions) above which the loops are cut to 1
# and 2 positions and extrapolated
_LOOP_LIMIT = 8_192
# `_trace_units` above which the step is traced at depths 1 and 2 and
# extrapolated (a unit: about 20 ms of fake trace on one core)
_UNITS_LIMIT = 4_000


def _storages(tree) -> Dict[int, int]:
    """{storage id: bytes} of a tree's tensors (a DTensor's local shard)."""
    import torch
    from ..train.tree import tree_leaves_with_path
    out = {}
    for _, x in tree_leaves_with_path(tree):
        if isinstance(x, torch.Tensor):
            st = getattr(x, "_local_tensor", x).untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _run_step(cfg, shape, mesh, device, loop_steps=None) -> Tuple[Dict, Dict]:
    """The cell's whole step on fake tensors -> (step costs, memory);
    ``loop_steps``: the positions each sLSTM loop runs (None: all)."""
    from ..models import xlstm
    saved, xlstm.TRACE_STEPS = xlstm.TRACE_STEPS, loop_steps
    try:
        return _trace(cfg, shape, mesh, device)
    finally:
        xlstm.TRACE_STEPS = saved


def _trace(cfg, shape, mesh, device) -> Tuple[Dict, Dict]:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..dist.context import compute_mesh
    from . import costing, specs
    with FakeTensorMode():
        if shape.kind == "train":
            step_fn, state, batch, _, _ = specs.make_train_objects(cfg, shape, mesh, device)
            args = (state, batch)
        elif shape.kind == "prefill":
            step_fn, args, _ = specs.make_prefill_objects(cfg, shape, mesh, device)
        else:
            step_fn, args, _ = specs.make_decode_objects(cfg, shape, mesh, device)
        arg_st = _storages(args)
        with compute_mesh(mesh), costing.counting(costing.CostMode(track_memory=True)) as mode:
            mode.hold(args)
            out = step_fn(*args)
        out_st = _storages(out)
        del out, args
    arg_b = sum(arg_st.values())
    out_b = sum(out_st.values())
    alias_b = sum(n for k, n in out_st.items() if k in arg_st)
    temp_b = max(mode.peak_bytes - (out_b - alias_b), 0)
    memory = {"argument_bytes_per_chip": arg_b, "output_bytes_per_chip": out_b,
              "temp_bytes_per_chip": temp_b, "alias_bytes_per_chip": alias_b}
    return mode.costs(), memory


def _extrapolate(a: Dict, b: Dict, n: int) -> Dict:
    """Counts at ``n`` from those at 1 (``a``) and 2 (``b``), linearly."""
    out = {}
    for k, v in a.items():
        if isinstance(v, dict):
            out[k] = _extrapolate(v, b[k], n)
        elif isinstance(v, (int, float)):
            x = v + (n - 1) * (b[k] - v)
            out[k] = int(round(x)) if isinstance(v, int) else float(x)
        else:
            out[k] = v
    return out


def _loops_cut(cfg, shape) -> bool:
    n_slstm = sum(1 for k in cfg.pattern if k == "slstm") * cfg.n_periods \
        + sum(1 for k in cfg.tail if k == "slstm")
    return shape.kind != "decode" and n_slstm * shape.seq_len > _LOOP_LIMIT


def _trace_units(cfg, shape) -> int:
    """The whole step's trace cost in rough units: per layer, the
    attention's chunk pairs (or the mLSTM's chunks), three passes in
    training (forward, recompute, backward)."""
    s = 1 if shape.kind == "decode" else shape.seq_len
    q, kv, m = -(-s // cfg.q_chunk), -(-s // cfg.kv_chunk), -(-s // cfg.mlstm_chunk)
    kinds = list(cfg.pattern) * cfg.n_periods + list(cfg.tail)
    per = sum(q * kv if k in ("attn_mlp", "attn_moe", "local_attn") else m if k == "mlstm"
              else 1 for k in kinds)
    return per * (3 if shape.kind == "train" else 1)


def _traced(cfg, shape, mesh, device):
    """The step's costs and memory, traced whole or cut and extrapolated
    (module docstring) -> (costs, memory, method)."""
    deep = cfg.n_periods > 2 and _trace_units(cfg, shape) > _UNITS_LIMIT
    cut = _loops_cut(cfg, shape)
    depths = (1, 2) if deep else (cfg.n_periods,)
    loops = (1, 2) if cut else (None,)
    runs = {(d, n): _run_step(cfg.with_(n_layers=d * len(cfg.pattern) + len(cfg.tail)),
                              shape, mesh, device, loop_steps=n)
            for d in depths for n in loops}

    def at_depth(d):
        if not cut:
            return runs[(d, None)]
        return tuple(_extrapolate(a, b, shape.seq_len) for a, b in zip(runs[(d, 1)],
                                                                         runs[(d, 2)]))
    if deep:
        raw, mem = (_extrapolate(a, b, cfg.n_periods) for a, b in zip(at_depth(1), at_depth(2)))
    else:
        raw, mem = at_depth(cfg.n_periods)
    parts = []
    if deep:
        parts.append(f"depths 1 and 2 extrapolated to {cfg.n_periods} periods")
    if cut:
        parts.append(f"sLSTM loops at 1 and 2 positions extrapolated to {shape.seq_len}")
    return raw, mem, "whole step" + (": " + "; ".join(parts) if parts else "")


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             out_dir: str = "results/dryrun_torch", skip_pieces: bool = False,
             variant: str = "", device: str = "cuda") -> dict:
    from ..configs import SHAPES, get_arch, shape_applicable
    from ..device import resolve_device
    from . import costing, specs
    from .mesh import make_production_mesh

    resolve_device(device)
    cfg = get_arch(arch_name)
    if variant:
        cfg = apply_variant(cfg, variant)
    shape = SHAPES[shape_name]
    mesh_name = "multipod" if multi_pod else "pod"
    tag = f"{arch_name}_{shape_name}_{mesh_name}" + (f"_{variant}" if variant else "")

    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": reason}
        _write(out_dir, tag, rec)
        print(f"[{tag}] SKIPPED: {reason}")
        return rec

    t0 = time.time()
    with make_production_mesh(multi_pod=multi_pod, device=device) as mesh:
        chips = 1
        for n in mesh.shape.values():
            chips *= n
        raw, mem, method = _traced(cfg, shape, mesh, device)
        trace_s = time.time() - t0

        rec = {
            "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
            "variant": variant or "baseline",
            "status": "ok", "kind": shape.kind, "chips": chips,
            "trace_s": round(trace_s, 1),
            "memory": dict(mem, method=method, peak_estimate_gib=round(
                (mem["argument_bytes_per_chip"] + mem["output_bytes_per_chip"]
                 + mem["temp_bytes_per_chip"] - mem["alias_bytes_per_chip"]) / 2**30, 3)),
            "step_raw": raw,
        }

        if not skip_pieces:
            from torch._subclasses.fake_tensor import FakeTensorMode
            from ..dist.context import compute_mesh
            t1 = time.time()
            with FakeTensorMode(), compute_mesh(mesh):
                if shape.kind == "train":
                    pieces = costing.train_pieces(cfg, shape, mesh, device)
                else:
                    pieces = costing.serve_pieces(cfg, shape, mesh,
                                                  decode=shape.kind == "decode", device=device)
                cost = costing.measure_pieces(pieces, mesh)
            rec["pieces"] = cost["pieces"]
            rec["totals"] = cost["totals"]
            rec["pieces_s"] = round(time.time() - t1, 1)
            terms = costing.roofline(cost["totals"]["flops"], cost["totals"]["bytes"],
                                     cost["totals"]["coll_bytes"], 1)  # per-chip costs
            rec["roofline"] = terms.as_dict()

            total, active = specs.count_params(cfg)
            tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
            factor = 6 if shape.kind == "train" else 2
            model_flops = factor * active * tokens
            rec["model_flops"] = model_flops
            rec["params_total"] = total
            rec["params_active"] = active
            # per-chip flops * chips vs global model flops
            global_flops = cost["totals"]["flops"] * chips
            rec["useful_flops_ratio"] = round(model_flops / global_flops, 4) \
                if global_flops else None

    _write(out_dir, tag, rec)
    print(f"[{tag}] OK trace={trace_s:.0f}s "
          f"mem/chip={rec['memory']['peak_estimate_gib']}GiB "
          + (f"dominant={rec['roofline']['dominant']}" if "roofline" in rec else ""))
    print(f"  memory: {rec['memory']}")
    print(f"  step: flops={raw['flops']:.3e} bytes={raw['bytes']:.3e} "
          f"coll_bytes={raw['coll_bytes']:.3e}")
    return rec


def apply_variant(cfg, variant: str):
    """Named optimization variants (the reference's): ``k=v`` pairs
    separated by commas; unknown keys are ignored, as there."""
    if variant == "baseline":
        return cfg
    mods = {}
    for kv in variant.split(","):
        k, _, v = kv.partition("=")
        mods[k] = v
    out = cfg
    if "remat" in mods:
        out = out.with_(remat=mods["remat"])
    if "qc" in mods:
        out = out.with_(q_chunk=int(mods["qc"]))
    if "kc" in mods:
        out = out.with_(kv_chunk=int(mods["kc"]))
    if "dtype" in mods:
        out = out.with_(dtype=mods["dtype"])
    if "attnf32" in mods:
        out = out.with_(attn_f32_streams=mods["attnf32"] == "1")
    if "cf" in mods:
        out = out.with_(capacity_factor=float(mods["cf"]))
    if "graddt" in mods:
        out = out.with_(grad_dtype=mods["graddt"])
    if "spblocks" in mods:
        out = out.with_(sp_blocks=mods["spblocks"] == "1")
    return out


def _write(out_dir: str, tag: str, rec: dict):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-pieces", action="store_true",
                    help="whole step only (no roofline pieces)")
    ap.add_argument("--variant", default="", help="perf variant, e.g. remat=none,qc=1024")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose JSON already reports status=ok")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the fake tensors name (cuda raises without a card)")
    args = ap.parse_args(argv)

    from ..configs import SHAPES, all_archs
    from ..device import resolve_device
    resolve_device(args.device)

    archs = list(all_archs()) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.mesh == "both" else [args.mesh == "multipod"]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                if args.skip_existing:
                    tag = f"{arch}_{shape}_{'multipod' if mp else 'pod'}"
                    pth = os.path.join(args.out, f"{tag}.json")
                    if os.path.exists(pth):
                        try:
                            with open(pth) as f:
                                if json.load(f).get("status") in ("ok", "skipped"):
                                    continue
                        except Exception:
                            pass
                try:
                    run_cell(arch, shape, mp, args.out, args.skip_pieces, args.variant,
                             args.device)
                except Exception as e:
                    failures.append((arch, shape, mp, repr(e)))
                    traceback.print_exc()
                    _write(args.out,
                           f"{arch}_{shape}_{'multipod' if mp else 'pod'}",
                           {"arch": arch, "shape": shape,
                            "mesh": "multipod" if mp else "pod",
                            "status": "failed", "error": repr(e)})
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nAll dry-run cells passed.")


if __name__ == "__main__":
    main()
