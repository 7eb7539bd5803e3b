"""The port's dry run (`launch.specs`, `launch.costing`, `launch.dryrun`,
`launch.mesh.make_production_mesh`) against the JAX package's, on the CPU.

JAX runs in one subprocess on 512 host devices (`tests/jax_dist_cases.py`,
case ``dryrun_specs``, as the reference's ``dryrun.py`` sets
``--xla_force_host_platform_device_count=512``) and builds what its dry
run builds without compiling: ``jax.eval_shape`` trees, the production
meshes' specs and the cost pieces. The port builds the same on fake
tensors over a fake process group. Bars:

- (a) all ten archs: `count_params` exactly, the parameter shape tree
  path by path, `batch_shapes` for every shape (the port's token ids are
  int64, so shapes only);
- (b) on both production meshes: `param_specs`, `zero1_opt_specs` of the
  SGD, AdamW and Adafactor states, `cache_specs` and `batch_spec`, entry
  for entry;
- (c) every applicable (arch x shape) cell's pieces on the pod mesh:
  names, multipliers and argument shapes;
- (d) `run_cell` for the three cells the reference has records of
  (``results/dryrun/``): ``params_total``, ``params_active`` and
  ``model_flops`` equal the records' (the whole step is stubbed here: at
  full size it takes minutes on the CPU, and the pieces are stubbed too:
  `chip_smoke.py` phase 14a runs these cells whole);
- (e) at a reduced size (a dense arch, granite-moe, xlstm-125m with its
  sLSTM; remat on), on a fake (2, 2) mesh and a 1-rank mesh, the pieces
  compose to the whole step's FLOPs and collective bytes exactly, and
  their bytes too except the sLSTM's (`launch.costing`'s docstring says
  why); a dense period's FLOPs are 2*M*N*K summed over its matmuls; the
  dry run's cut traces (depths 1 and 2, sLSTM loops at 1 and 2 positions)
  extrapolate to the whole step's FLOPs, bytes and wire bytes exactly;
- every arch's prefill and decode, whole and in pieces, on a fake (2, 2)
  mesh at a reduced size, the pieces' FLOPs equal to the step's;
- (f) the CLI: an ``ok`` record, a ``skipped`` record with the
  reference's reason, ``--skip-existing``, ``--skip-pieces``,
  ``--variant``, and ``--device cuda`` refused without a card.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from jax_dist_cases import collect, run_cases
from repro_torch.configs import SHAPES, all_archs, get_arch, shape_applicable
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist.context import compute_mesh
from repro_torch.launch import costing, dryrun, specs
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.train.optim import make_optimizer
from repro_torch.train.tree import keystr, tree_leaves_with_path, tree_map_with_path

ARCHS = sorted(all_archs())
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REFERENCE_CELLS = ("qwen1.5-4b", "granite-moe-3b-a800m", "llama4-maverick-400b-a17b")


@pytest.fixture(scope="module")
def ref():
    return collect(run_cases([("dryrun_specs", dict(archs=ARCHS))], 512))["dryrun_specs"]


def _shapes(tree) -> dict:
    return {keystr(p): tuple(x.shape) for p, x in tree_leaves_with_path(tree)}


def _specs(tree) -> dict:
    return {keystr(p): tuple(s) for p, s in
            tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, shd.PartitionSpec))}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_batches_match_reference(ref, arch):
    """(a)"""
    cfg = get_arch(arch)
    assert specs.count_params(cfg) == tuple(ref[arch]["count"])
    with FakeTensorMode():
        assert _shapes(specs.param_shapes(cfg, "cpu")) == dict(ref[arch]["params"])
        for name, shape in SHAPES.items():
            assert _shapes(specs.batch_shapes(cfg, shape, "cpu")) == \
                dict(ref[arch]["batch"][name]), name


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_production_mesh_layouts_match_reference(ref, mesh_name):
    """(b) and the mesh itself: rank 0 of 256 / 512 at the origin."""
    with make_production_mesh(mesh_name == "multipod", "cpu") as mesh, FakeTensorMode():
        world = 512 if mesh_name == "multipod" else 256
        assert torch.distributed.get_world_size() == world
        assert mesh.axis_names == (("pod",) if mesh_name == "multipod" else ()) + (
            "data", "model")
        assert (mesh.dp_rank, mesh.model_rank, mesh.dp_size) == (0, 0, world // 16)
        assert mesh.group("dp").size() == world // 16 and mesh.group("model").size() == 16
        for arch in ARCHS:
            cfg = get_arch(arch)
            want = ref[arch]["specs"][mesh_name]
            p_shapes = specs.param_shapes(cfg, "cpu")
            p_part = shd.param_specs(p_shapes, mesh, cfg.fsdp_experts)
            assert _specs(p_part) == want["params"], arch
            for opt in ("sgd", "adamw", "adafactor"):
                o = make_optimizer(opt).init(p_shapes)
                assert _specs(shd.zero1_opt_specs(o, p_part, mesh)) == want["opt"][opt], \
                    (arch, opt)
            for name, shape in SHAPES.items():
                b = specs.batch_shapes(cfg, shape, "cpu")
                assert _specs(shd.batch_spec(b, mesh)) == want["batch"][name], (arch, name)
                if name in want["cache"]:
                    cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len, "cpu")
                    assert _specs(shd.cache_specs(cache, mesh)) == want["cache"][name], \
                        (arch, name)
    with pytest.raises(RuntimeError, match="already running"):
        with make_fake_mesh(1, 1, device="cpu"):
            with make_production_mesh(False, "cpu"):
                pass


def _piece_list(cfg, shape, mesh):
    if shape.kind == "train":
        pieces = costing.train_pieces(cfg, shape, mesh, "cpu")
    else:
        pieces = costing.serve_pieces(cfg, shape, mesh, decode=shape.kind == "decode",
                                      device="cpu")
    return [(pc.name, pc.mult, [sorted(_shapes(a).items()) for a in pc.arg_specs])
            for pc in pieces]


def test_pieces_match_reference(ref):
    """(c) every applicable cell on the pod mesh."""
    with make_production_mesh(False, "cpu") as mesh, FakeTensorMode(), compute_mesh(mesh):
        for arch in ARCHS:
            cfg = get_arch(arch)
            for name, shape in SHAPES.items():
                if not shape_applicable(cfg, shape)[0]:
                    assert name not in ref[arch]["pieces"]
                    continue
                want = [(n, m, [sorted(dict(a).items()) for a in args])
                        for n, m, args in ref[arch]["pieces"][name]]
                assert _piece_list(cfg, shape, mesh) == want, (arch, name)


def test_run_cell_reproduces_reference_counts(tmp_path, monkeypatch):
    """(d) params_total, params_active and model_flops of the reference's
    three committed records (the whole step stubbed: module docstring)."""
    stub = {"flops": 0.0, "bytes": 0.0, "coll_bytes": 0.0, "coll_detail": {}}
    mem = dict.fromkeys(("argument_bytes_per_chip", "output_bytes_per_chip",
                         "temp_bytes_per_chip", "alias_bytes_per_chip"), 0)
    monkeypatch.setattr(dryrun, "_run_step", lambda *a, **k: (dict(stub), dict(mem)))
    monkeypatch.setattr(costing, "train_pieces", lambda *a, **k: [])
    for arch in REFERENCE_CELLS:
        with open(os.path.join(ROOT, "results", "dryrun", f"{arch}_train_4k_pod.json")) as f:
            want = json.load(f)
        rec = dryrun.run_cell(arch, "train_4k", False, str(tmp_path), device="cpu")
        assert rec["status"] == "ok" and rec["chips"] == 256
        for key in ("params_total", "params_active", "model_flops"):
            assert rec[key] == want[key], (arch, key)
        assert set(want) - {"compile_s", "hlo_raw"} <= set(rec)
        assert {"trace_s", "step_raw"} <= set(rec)


# ---------------------------------------------------------------------------
# (e) composition at a reduced size
# ---------------------------------------------------------------------------

DENSE = dict(name="t", family="dense", n_layers=3, d_model=32, n_heads=4, n_kv_heads=2,
             head_dim=8, d_ff=64, vocab=64, dtype="float32", remat="full", q_chunk=8,
             kv_chunk=8)


def _reduced(arch):
    from test_torch_lm_train import _reduce
    return _reduce(get_arch(arch)).with_(remat="full", vocab=102)


COMPOSE = {"dense": lambda: ArchConfig(**DENSE),
           "granite": lambda: _reduced("granite-moe-3b-a800m"),
           "xlstm": lambda: _reduced("xlstm-125m")}
SHAPE = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=4)


class _Matmuls(TorchDispatchMode):
    """2*M*N*K of every mm / addmm / bmm (local shapes)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        loc = [getattr(a, "_local_tensor", a) for a in args]
        if name == "aten.mm":
            (m, k), n = loc[0].shape, loc[1].shape[1]
            self.flops += 2 * m * n * k
        elif name == "aten.addmm":
            (m, k), n = loc[1].shape, loc[2].shape[1]
            self.flops += 2 * m * n * k
        elif name == "aten.bmm":
            (b, m, k), n = loc[0].shape, loc[1].shape[2]
            self.flops += 2 * b * m * n * k
        return out


@pytest.mark.parametrize("dims", [(1, 1), (2, 2)])
@pytest.mark.parametrize("name", list(COMPOSE))
def test_pieces_compose_to_the_whole_step(name, dims):
    """(e)"""
    cfg = COMPOSE[name]()
    with make_fake_mesh(*dims, device="cpu") as mesh, FakeTensorMode(), compute_mesh(mesh):
        step, state, batch, _, _ = specs.make_train_objects(cfg, SHAPE, mesh, "cpu")
        with costing.counting(costing.CostMode()) as mode:
            step(state, batch)
        whole = mode.costs()
        pieces = costing.train_pieces(cfg, SHAPE, mesh, "cpu")
        assert [(pc.name, pc.mult) for pc in pieces] == [("stem", 1.0), (
            "period", float(cfg.n_periods))] + ([("slstm_step", float(
                cfg.n_periods * (SHAPE.seq_len - 1)))] if name == "xlstm" else [])
        got = costing.measure_pieces(pieces, mesh)
        if name == "dense":
            period = next(pc for pc in pieces if pc.name == "period")
            with costing.counting(costing.CostMode()), _Matmuls() as mm:
                period.fn(*period.arg_specs)
            assert got["pieces"]["period"]["flops"] == mm.flops > 0
    totals = got["totals"]
    assert totals["flops"] == whole["flops"] > 0
    assert totals["coll_bytes"] == whole["coll_bytes"]
    assert (whole["coll_bytes"] > 0) == (dims != (1, 1))
    if name != "xlstm":
        assert totals["bytes"] == whole["bytes"] > 0
    else:
        assert 0.5 < totals["bytes"] / whole["bytes"] < 2.0


def test_cut_traces_extrapolate_to_the_whole_step(monkeypatch):
    """(e) the dry run's cut traces (`dryrun._traced` with both limits at
    0) on xlstm-125m reduced: depths 1 and 2 extrapolated to the model's
    depth and the sLSTM loops at 1 and 2 positions extrapolated to the
    sequence give the whole step's FLOPs, bytes and wire bytes exactly."""
    cfg = COMPOSE["xlstm"]().with_(n_layers=6)
    monkeypatch.setattr(dryrun, "_UNITS_LIMIT", 0)
    monkeypatch.setattr(dryrun, "_LOOP_LIMIT", 0)
    with make_fake_mesh(2, 2, device="cpu") as mesh:
        whole, _ = dryrun._run_step(cfg, SHAPE, mesh, "cpu")
        raw, mem, method = dryrun._traced(cfg, SHAPE, mesh, "cpu")
    assert "depths 1 and 2 extrapolated to 3 periods" in method and "sLSTM loops" in method
    assert {k: raw[k] for k in ("flops", "bytes", "coll_bytes")} == \
        {k: whole[k] for k in ("flops", "bytes", "coll_bytes")}
    assert mem["argument_bytes_per_chip"] > 0 and mem["alias_bytes_per_chip"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_and_pieces_trace_on_a_model_axis(arch, kind):
    """Every arch's prefill and decode step, whole and in pieces, on a fake
    (2, 2) mesh at the reduced size (a batch the data axis divides and
    one it does not): both trace, and the pieces' FLOPs compose to the
    step's where the step has no tail (a tail's first block takes the
    stem's gather)."""
    from test_torch_lm_train import _reduce
    cfg = _reduce(get_arch(arch)).with_(vocab=102)
    for batch in (4, 1):
        shape = dataclasses.replace(SHAPES[f"{kind}_32k"], seq_len=16, global_batch=batch)
        with make_fake_mesh(2, 2, device="cpu") as mesh:
            raw, mem = dryrun._run_step(cfg, shape, mesh, "cpu")
            with FakeTensorMode(), compute_mesh(mesh):
                got = costing.measure_pieces(costing.serve_pieces(
                    cfg, shape, mesh, decode=kind == "decode", device="cpu"), mesh)
        assert raw["flops"] > 0 and mem["argument_bytes_per_chip"] > 0
        if not cfg.tail:
            assert got["totals"]["flops"] == raw["flops"], (arch, batch)


def test_roofline_terms():
    terms = costing.roofline(989e12, 3.35e12, 0.9e12, 1)
    assert terms.as_dict() == {"t_comp_s": 1.0, "t_mem_s": 1.0, "t_coll_s": 2.0,
                               "dominant": "collective", "bound_s": 2.0}
    assert costing.parse_collective_bytes("all-reduce", 100, 4) == 150
    assert costing.parse_collective_bytes("all-gather", 100, 4) == 75
    assert costing.parse_collective_bytes("reduce-scatter", 100, 4) == 300


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------

def test_cli_records(tmp_path, capsys):
    """An ok cell (recurrentgemma-2b decode_32k: a few seconds), the
    reference's skip, --skip-existing, --skip-pieces and --variant."""
    out = str(tmp_path)
    dryrun.main(["--device", "cpu", "--arch", "recurrentgemma-2b", "--shape", "decode_32k",
                 "--mesh", "pod", "--out", out])
    with open(os.path.join(out, "recurrentgemma-2b_decode_32k_pod.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["kind"] == "decode" and rec["variant"] == "baseline"
    for key in ("argument", "output", "temp", "alias"):
        assert rec["memory"][f"{key}_bytes_per_chip"] >= 0
    m = rec["memory"]
    assert m["alias_bytes_per_chip"] > 0                 # the cache, written in place
    assert m["peak_estimate_gib"] == round((m["argument_bytes_per_chip"]
                                            + m["output_bytes_per_chip"]
                                            + m["temp_bytes_per_chip"]
                                            - m["alias_bytes_per_chip"]) / 2**30, 3)
    assert set(rec["pieces"]) == {"stem", "period", "tail0_rglru", "tail1_rglru"}
    assert rec["roofline"]["bound_s"] > 0 and rec["useful_flops_ratio"] > 0

    dryrun.main(["--device", "cpu", "--arch", "qwen1.5-4b", "--shape", "long_500k",
                 "--mesh", "both", "--out", out])
    for mesh in ("pod", "multipod"):
        with open(os.path.join(out, f"qwen1.5-4b_long_500k_{mesh}.json")) as f:
            skipped = json.load(f)
        assert skipped == {"arch": "qwen1.5-4b", "shape": "long_500k", "mesh": mesh,
                           "status": "skipped", "reason": shape_applicable(
                               get_arch("qwen1.5-4b"), SHAPES["long_500k"])[1]}

    path = os.path.join(out, "recurrentgemma-2b_decode_32k_pod.json")
    before = os.stat(path).st_mtime_ns
    capsys.readouterr()
    dryrun.main(["--device", "cpu", "--arch", "recurrentgemma-2b", "--shape", "decode_32k",
                 "--mesh", "pod", "--out", out, "--skip-existing"])
    assert os.stat(path).st_mtime_ns == before and "OK" not in capsys.readouterr().out

    dryrun.main(["--device", "cpu", "--arch", "recurrentgemma-2b", "--shape", "decode_32k",
                 "--mesh", "pod", "--out", out, "--skip-pieces", "--variant", "remat=none"])
    with open(os.path.join(out, "recurrentgemma-2b_decode_32k_pod_remat=none.json")) as f:
        var = json.load(f)
    assert var["variant"] == "remat=none" and "pieces" not in var and "roofline" not in var
    assert var["step_raw"]["flops"] == rec["step_raw"]["flops"]
    assert dryrun.apply_variant(get_arch("qwen1.5-4b"), "qc=1024,remat=none").q_chunk == 1024

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dryrun.main(["--arch", "qwen1.5-4b", "--shape", "train_4k", "--out", out])
