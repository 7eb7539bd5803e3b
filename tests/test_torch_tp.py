"""Tensor parallelism in the port (`launch.mesh.make_process_mesh`,
`dist.sharding.place`, the model on its shards, the (data, model) train
step, checkpoints and the data pipeline on a mesh) against the JAX package,
on the CPU.

JAX runs on 4 host devices in one subprocess (`tests/jax_dist_cases.py`:
its GSPMD step on a (2, 2) ``('data', 'model')`` mesh, as
`tests/test_dist.py`'s sharded case runs it); the port runs as one gloo
group of 4 ranks on a (2, 2) mesh (`tests/torch_dist_workers.py`, case
``tp``), spawned once for every case below, beside the JAX process. The
weights are the port's init (norms and biases bumped off it), carried to
both as numpy; so are the batches. Bars, and why:

- (a) one step on (2, 2) of the reference test's dense config, reduced
  granite-moe and xlstm-125m, and reduced llama4-maverick with
  ``fsdp_experts`` (its expert stacks split over 'data' too): against
  JAX's GSPMD step and against one process of the port (each data half's
  gradients averaged in rank order, the data-parallel arithmetic; the MoE
  routes each half's rows on its own, as the reference's ``shard_map``
  over the data axes does): the loss within 1e-6 relative, each gradient
  leaf within 1e-5 relative L2, the parameter tree after one AdamW step
  within 1e-5 relative L2 (worst leaf in the message). A row-parallel
  product sums its halves in another order than one process, so the bars
  are tolerances, not bits;
- (b) every placed parameter, gradient and AdamW moment has
  ``to_placements(param_spec(...))`` as its layout and half the whole
  extent on each model-sharded dim; the two data replicas of every shard
  hold the same bits after the step, and a second step from the same
  state gives the same bits;
- (c) all ten archs reduced (every block kind, both frontends, tied
  embeddings), at the reduction's vocab 101 (which does not divide: the
  embedding shards d_model, the logits are whole) and at 102 (vocab-
  parallel lookup and log-softmax): `train_loss` and its gradients with
  each model pair doing a (1, 2) mesh's work, against one process: the
  same bars as (a);
- (d) a checkpoint written on (2, 2) restores onto (2, 2), onto (4, 1) and
  onto one process bit for bit, and the reference's (2, 2) checkpoint
  restores onto the port's (2, 2) mesh bit for bit;
- (e) a `DataPipeline` on the mesh hands each rank the rows JAX's
  ``NamedSharding(mesh, P('data', None))`` gives the device at its mesh
  position;
- (f) Adafactor under tensor parallelism: one (2, 2) step of the reduced
  llama4-fsdp config with Adafactor against JAX's GSPMD step and one
  process at (a)'s bars, its factored moments laid out by
  ``zero1_opt_specs``; the collective bytes the fake (2, 2) dry run
  (`launch.costing`) predicts for a step equal the bytes the gloo step
  issues, counted by the same dispatch mode; and a donated step
  (``donate=True``) gives the functional step's bits in the input's
  buffers for SGD, AdamW and Adafactor.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from jax_dist_cases import collect, run_cases
from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.train import optim
from repro_torch.train.train_step import local_rows, value_and_grad
from repro_torch.train.tree import keystr, tree_leaves_with_path, tree_map, tree_map_with_path
from test_torch_lm_train import _reduce, _rel_l2
from torch_dist_workers import run_ranks

ARCHS = sorted(jax_all_archs())
DENSE = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             head_dim=8, d_ff=64, vocab=64, dtype="float32", remat="none", q_chunk=8,
             kv_chunk=8)
LR = 1e-3
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-6, 1e-5, 1e-5
VOCABS = (101, 102)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


STEP_CFGS = {
    "dense": DENSE,
    "granite": _fields(_reduce(jax_get_arch("granite-moe-3b-a800m"))),
    "xlstm": _fields(_reduce(jax_get_arch("xlstm-125m"))),
    "llama4-fsdp": _fields(_reduce(jax_get_arch("llama4-maverick-400b-a17b")).with_(
        fsdp_experts=True)),
}
STEP_CFGS["llama4-fsdp-adafactor"] = STEP_CFGS["llama4-fsdp"]
STEP_OPTS = {"llama4-fsdp-adafactor": "adafactor"}


def _batch(cfg, rows, seq, seed):
    rng = np.random.default_rng(seed)
    n_front = cfg.n_frontend_tokens if cfg.frontend else 0
    b = {"tokens": rng.integers(0, cfg.vocab, (rows, seq - n_front)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (rows, seq - n_front)).astype(np.int32)}
    if cfg.frontend:
        b["frontend_embeds"] = rng.normal(size=(rows, n_front, cfg.d_frontend)).astype(
            np.float32)
    return b


def _params(fields, seed=0):
    """The port's init as numpy, norm gains and biases moved off it (as
    `test_torch_lm_train._bumped` moves them) so that they are exercised."""
    params = tf.init_params(torch.Generator().manual_seed(seed), ArchConfig(**fields), "cpu")
    rng = np.random.default_rng(seed)

    def bump(path, x):
        x = x.numpy()
        key = keystr(path)
        if "norm" in key or "['b" in key:
            return x + (rng.normal(size=x.shape) * 0.1).astype(x.dtype)
        return x
    return tree_map_with_path(bump, params)


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(
        np.array(x, dtype=np.int64) if np.asarray(x).dtype.kind in "iu" else np.array(x)), tree)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    steps = {name: {"cfg": f, "params": _params(f),
                    "batch": _batch(ArchConfig(**f), 8, 16, seed=i), "lr": LR,
                    "opt": STEP_OPTS.get(name, "adamw")}
             for i, (name, f) in enumerate(STEP_CFGS.items())}
    losses = {}
    for arch in ARCHS:
        for vocab in VOCABS:
            cfg = _reduce(configs.get_arch(arch)).with_(vocab=vocab)
            losses[f"{arch}-{vocab}"] = {
                "cfg": _fields(cfg), "params": _params(_fields(cfg)),
                "batch": _batch(cfg, 2, 16, seed=vocab)}
    pipeline = {"tokens": np.arange(8 * 6, dtype=np.int32).reshape(8, 6),
                "labels": np.arange(8 * 6, dtype=np.int32).reshape(8, 6)[:, ::-1].copy()}
    jax_ckpt = str(root / "jax_ckpt")
    # two JAX processes side by side (each compiles two steps), beside the ranks
    procs = [run_cases([("tp_step", dict(steps["dense"], ckpt_dir=jax_ckpt, key="dense")),
                        ("tp_step", dict(steps["llama4-fsdp"], key="llama4-fsdp")),
                        ("tp_batch", dict(batch=pipeline))], 4),
             run_cases([("tp_step", dict(steps["llama4-fsdp-adafactor"],
                                         key="llama4-fsdp-adafactor"))], 4),
             run_cases([("tp_step", dict(steps[name], key=name)) for name in ("granite", "xlstm")],
                       4)]
    ref = {}
    try:
        ranks = run_ranks("tp", 4, {"steps": steps, "losses": losses, "elastic": "dense",
                                    "root": str(root / "port_ckpt"), "jax_ckpt": jax_ckpt,
                                    "pipeline": pipeline, "donate": steps["dense"]},
                          timeout=600)
    finally:
        for proc in procs:
            ref.update(collect(proc))
    return {"ranks": ranks, "ref": ref, "steps": steps, "losses": losses, "pipeline": pipeline}


def _flat(tree, jax_tree=False) -> dict:
    if jax_tree:
        return {jax.tree_util.keystr(p): np.asarray(x)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {keystr(p): np.asarray(x) for p, x in tree_leaves_with_path(tree)}


def _tree_rel_l2(a: dict, b: dict) -> float:
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in b)
    den = sum(float(np.sum(b[k].astype(np.float64) ** 2)) for k in b)
    return (num / den) ** 0.5


def _one_process(case):
    """One process of the port on the global batch, as the data-parallel
    step computes it: each data half's loss and gradients, averaged in rank
    order, clipped, one step of the case's optimizer -> (loss, gradient norm,
    gradients, state)."""
    from repro_torch.train.optim import apply_updates, clip_by_global_norm
    from repro_torch.train.train_step import deterministic, init_train_state
    cfg = ArchConfig(**case["cfg"])
    params = tf.params_from_numpy(case["params"], "cpu")
    batch = _torch(case["batch"])
    vg = value_and_grad(lambda p, b: tf.train_loss(p, b, cfg))
    halves = [vg(params, local_rows(batch, r, 2)) for r in range(2)]
    mean = lambda a, b: ((a.float() + b.float()) / 2.0).to(a.dtype)  # noqa: E731
    loss = float(mean(halves[0][0], halves[1][0]))
    grads = tree_map(mean, halves[0][1], halves[1][1])
    opt = optim.make_optimizer(case.get("opt", "adamw"), weight_decay=0.0)
    state = init_train_state(params, opt)
    with torch.no_grad(), deterministic():
        clipped, norm = clip_by_global_norm(grads, 1.0)
        updates, new_opt = opt.update(clipped, state["opt"], params, torch.tensor(LR))
        new = {"params": apply_updates(params, updates), "opt": new_opt, "step": state["step"] + 1}
    return (loss, float(norm), tree_map(lambda x: x.numpy(), grads),
            tree_map(lambda x: x.numpy(), new))


def _check_grads(ours: dict, ref: dict, tol=GRAD_TOL):
    assert list(ours) == list(ref)
    worst = max((_rel_l2(ours[k], ref[k]), k) for k in ref)
    assert worst[0] <= tol, worst


def _check_params(ours: dict, ref: dict):
    keys = [k for k in ref if k.startswith("['params']")]
    worst = max((_rel_l2(ours[k], ref[k]), k) for k in keys)
    rel = _tree_rel_l2({k: ours[k] for k in keys}, {k: ref[k] for k in keys})
    assert rel <= PARAM_TOL, (rel, "worst leaf", worst)


@pytest.mark.parametrize("name", list(STEP_CFGS))
def test_tp_step_matches_reference_gspmd_step(tp_run, name):
    """(a) against JAX's (2, 2) GSPMD step: loss, gradients, one AdamW step."""
    out, ref = tp_run["ranks"][0]["steps"][name], tp_run["ref"][name]
    assert abs(out["loss"] - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    assert abs(out["step_loss"] - ref["step_loss"]) <= LOSS_TOL * abs(ref["step_loss"])
    assert abs(out["grad_norm"] - ref["grad_norm"]) <= GRAD_TOL * ref["grad_norm"]
    _check_grads(_flat(out["grads"]), _flat(ref["grads"], jax_tree=True))
    _check_params(_flat(out["state"]), _flat(ref["state"], jax_tree=True))


@pytest.mark.parametrize("name", list(STEP_CFGS))
def test_tp_step_matches_one_process(tp_run, name):
    """(a) against one process of the port, the data halves averaged."""
    out = tp_run["ranks"][0]["steps"][name]
    loss, norm, grads, state = _one_process(tp_run["steps"][name])
    assert abs(out["loss"] - loss) <= LOSS_TOL * abs(loss)
    assert abs(out["step_loss"] - loss) <= LOSS_TOL * abs(loss)
    assert abs(out["grad_norm"] - norm) <= GRAD_TOL * norm
    _check_grads(_flat(out["grads"]), _flat(grads))
    _check_params(_flat(out["state"]), _flat(state))


def _expected_layout(path, shape, fsdp):
    """Placements and local shape of a leaf's `param_spec` on (2, 2)."""
    class Mesh:
        axis_names, shape = ("data", "model"), {"data": 2, "model": 2}
    spec = shd.param_spec(path, np.zeros(shape, np.float32), Mesh(), fsdp)
    placements, local = [], list(shape)
    for name in ("data", "model"):
        dims = [d for d, e in enumerate(spec) if e == name]
        placements.append(f"S({dims[0]})" if dims else "R")
        if dims:
            local[dims[0]] //= 2
    return tuple(placements), tuple(local)


@pytest.mark.parametrize("name", list(STEP_CFGS))
def test_tp_layouts_follow_param_spec(tp_run, name):
    """(b) parameters, gradients, the AdamW moments and the new parameters:
    each leaf laid out by its `param_spec` (the moments by their
    parameter's path), 1/2 of the extent on a model-sharded dim."""
    fsdp = tp_run["steps"][name]["cfg"].get("fsdp_experts", False)
    params = {keystr(p): x for p, x in tree_leaves_with_path(tp_run["steps"][name]["params"])}
    factored = tp_run["steps"][name]["opt"] == "adafactor"
    for out in tp_run["ranks"]:
        layouts = dict(out["steps"][name]["layouts"])
        for kind in ("params", "grads", "new_params"):
            assert set(layouts[kind]) == set(params), kind
        if factored:                     # (f): checked by its own test
            layouts.pop("opt")
        else:
            assert {k for k in layouts["opt"]} == {f"['{m}']{k}" for m in "mv" for k in params}
        for kind, table in layouts.items():
            for key, (placements, local, whole) in table.items():
                pkey = key[5:] if kind == "opt" else key
                path = tuple(int(p) if p.isdigit() else p.strip("'")
                             for p in pkey[1:-1].split("]["))
                want = _expected_layout(path, params[pkey].shape, fsdp)
                assert whole == params[pkey].shape, (kind, key)
                assert (tuple(p.replace("Shard", "S").replace("Replicate()", "R").replace(
                    "(dim=", "(") for p in placements), local) == want, (kind, key, placements)
    sharded = [k for k, (pl, local, whole) in tp_run["ranks"][0]["steps"][name]["layouts"][
        "params"].items() if local != whole]
    assert sharded, "no leaf is sharded"
    if fsdp:
        assert any("experts" in k and pl[0].startswith("S") for k, (pl, _, _) in
                   tp_run["ranks"][0]["steps"][name]["layouts"]["params"].items())


@pytest.mark.parametrize("name", list(STEP_CFGS))
def test_tp_data_replicas_bit_identical(tp_run, name):
    """(b) ranks (0, 2) and (1, 3) hold the data replicas of model shards 0
    and 1: after the step, every replicated-over-data leaf bit for bit; the
    loop's exact check agrees; a second step from the same state gives the
    same bits; the model shards differ."""
    ranks = [out["steps"][name] for out in tp_run["ranks"]]
    assert [out["coords"] for out in tp_run["ranks"]] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    layouts = ranks[0]["layouts"]["new_params"]
    for a, b in ((0, 2), (1, 3)):
        la, lb = _flat(ranks[a]["local"]), _flat(ranks[b]["local"])
        for key in la:
            if layouts[key][0][0].startswith("S"):              # FSDP: split over 'data'
                continue
            np.testing.assert_array_equal(la[key], lb[key], err_msg=key)
    assert all(r["agree"] and r["rerun_equal"] for r in ranks)
    l0, l1 = _flat(ranks[0]["local"]), _flat(ranks[1]["local"])
    assert any(l0[k].shape == l1[k].shape and not np.array_equal(l0[k], l1[k])
               for k in l0 if layouts[k][1] != layouts[k][2])


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_train_loss_matches_one_process(tp_run, arch, vocab):
    """(c) each model pair's `train_loss` and gradients against one process."""
    case = tp_run["losses"][f"{arch}-{vocab}"]
    cfg = ArchConfig(**case["cfg"])
    loss, grads = value_and_grad(lambda p, b: tf.train_loss(p, b, cfg))(
        tf.params_from_numpy(case["params"], "cpu"), _torch(case["batch"]))
    ref = _flat(tree_map(lambda x: x.numpy(), grads))
    for out in tp_run["ranks"]:
        got = out["losses"][f"{arch}-{vocab}"]
        assert abs(got["loss"] - float(loss)) <= LOSS_TOL * abs(float(loss))
        _check_grads(_flat(got["grads"]), ref)
    assert tp_run["ranks"][0]["losses"][f"{arch}-{vocab}"]["loss"] == \
        tp_run["ranks"][2]["losses"][f"{arch}-{vocab}"]["loss"]


def _params_layouts(layouts: dict) -> dict:
    """The ``['params']`` part of a state's layouts, keyed as the params'."""
    return {k[len("['params']"):]: v for k, v in layouts.items() if k.startswith("['params']")}


def test_elastic_restore_from_2x2(tp_run):
    """(d) the port's (2, 2) checkpoint onto (2, 2) (each rank its shards),
    onto (4, 1) (every rank whole tensors) and onto one process."""
    saved = _flat(tp_run["ranks"][0]["steps"]["dense"]["state"])
    for out in tp_run["ranks"]:
        assert out["elastic"]["onto22_equal"]
        assert _params_layouts(out["elastic"]["onto22_layouts"]) == \
            out["steps"]["dense"]["layouts"]["new_params"]
        onto41 = _flat(out["elastic"]["onto41"])
        assert list(onto41) == list(saved)
        for k in saved:
            np.testing.assert_array_equal(onto41[k], saved[k], err_msg=k)
    one = _flat(tp_run["ranks"][0]["elastic"]["one_process"])
    for k in saved:
        np.testing.assert_array_equal(one[k], saved[k], err_msg=k)


def test_reference_checkpoint_restores_onto_port_mesh(tp_run):
    """(d) JAX's (2, 2) checkpoint (its step's state) restored onto the
    port's (2, 2) mesh: every leaf JAX's bits, laid out by `param_spec`."""
    ref = _flat(tp_run["ref"]["dense"]["state"], jax_tree=True)
    for out in tp_run["ranks"]:
        got = _flat(out["from_jax"]["state"])
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert _params_layouts(out["from_jax"]["layouts"]) == \
            out["steps"]["dense"]["layouts"]["new_params"]


def test_data_pipeline_rows_match_reference_sharding(tp_run):
    """(e) rank r = data * 2 + model gets the rows JAX's NamedSharding gives
    the device at that mesh position, as a DTensor split over 'data' and
    replicated over 'model'."""
    ref = tp_run["ref"]["tp_batch"]
    for r, out in enumerate(tp_run["ranks"]):
        for key, (rows, placements) in out["pipeline"].items():
            np.testing.assert_array_equal(rows, ref[r][key].astype(rows.dtype), err_msg=key)
            assert placements == ("S(0)", "R")
        assert out["pipeline"]["tokens"][0].shape == (4, 6)


def test_data_pipeline_refuses_a_mesh_without_a_model_axis():
    """A mesh hands each rank its rows as DTensors, which needs a
    `make_process_mesh` mesh; a data-parallel step takes the global batch
    from a pipeline with a device, and a mesh with a device is refused."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.mesh import make_data_mesh
    with pytest.raises(ValueError, match="make_process_mesh"):
        DataPipeline(lambda step: {}, make_data_mesh(2, "cpu"))
    with pytest.raises(ValueError, match="make_process_mesh"):
        DataPipeline(lambda step: {}, make_data_mesh(2, "cpu"), device="cpu")


def test_tp_adafactor_moments_follow_zero1_specs(tp_run):
    """(f) Adafactor's moments (``vr`` / ``vc``, ``v``) after the step: each
    laid out by `zero1_opt_specs` on the (2, 2) mesh (its own shape, the
    first divisible dim over 'data'), the local shard that spec's slice."""
    from repro_torch.train.optim import adafactor

    class Mesh:
        axis_names, shape = ("data", "model"), {"data": 2, "model": 2}
    params = tf.params_from_numpy(tp_run["steps"]["llama4-fsdp-adafactor"]["params"], "cpu")
    want = {keystr(("s",) + p): s for p, s in tree_leaves_with_path(
        shd.zero1_opt_specs(adafactor().init(params)["s"], {}, Mesh()),
        is_leaf=lambda x: isinstance(x, shd.PartitionSpec))}
    shapes = {keystr(("s",) + p): tuple(x.shape)
              for p, x in tree_leaves_with_path(adafactor().init(params)["s"])}
    for out in tp_run["ranks"]:
        table = out["steps"]["llama4-fsdp-adafactor"]["layouts"]["opt"]
        assert set(table) == set(want)
        for key, (placements, local, whole) in table.items():
            spec = want[key]
            dims = [d for d, e in enumerate(spec) if e == "data"]
            assert whole == shapes[key], key
            assert placements == ((f"S({dims[0]})" if dims else "R"), "R"), (key, placements)
            assert local == tuple(n // 2 if dims and d == dims[0] else n
                                  for d, n in enumerate(whole)), key
    assert any(pl[0].startswith("S") for pl, _, _ in table.values())


@pytest.mark.parametrize("name", ["dense", "llama4-fsdp-adafactor"])
def test_tp_collective_bytes_match_the_dry_run(tp_run, name):
    """(f) the wire bytes the fake (2, 2) dry run counts for a step (its
    train objects, on fake tensors) equal what the gloo step issued."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import SHAPES
    from repro_torch.dist.context import compute_mesh
    from repro_torch.launch import costing, specs
    from repro_torch.launch.mesh import make_fake_mesh
    case = tp_run["steps"][name]
    cfg = ArchConfig(**case["cfg"])
    assert cfg.optimizer == case["opt"]
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=8)
    with make_fake_mesh(2, 2, device="cpu") as mesh, FakeTensorMode(), compute_mesh(mesh):
        step, state, batch, _, _ = specs.make_train_objects(cfg, shape, mesh, "cpu")
        with costing.counting(costing.CostMode()) as mode:
            step(state, batch)
    for out in tp_run["ranks"]:
        issued = out["steps"][name]["costs"]
        assert issued["coll_bytes"] == mode.costs()["coll_bytes"] > 0
        assert issued["coll_detail"] == mode.costs()["coll_detail"]
        assert issued["flops"] == mode.costs()["flops"]


@pytest.mark.parametrize("opt", ["sgd", "adamw", "adafactor"])
def test_tp_donated_step_keeps_the_functional_bits(tp_run, opt):
    """(f) on (2, 2): ``donate=True`` returns the input state object, keeps
    every leaf's buffer and gives the functional step's bits and loss; the
    functional step leaves its input unchanged."""
    for out in tp_run["ranks"]:
        assert out["donate"][opt] == {"same_object": True, "same_buffers": True, "bits": True,
                                      "loss": True, "unchanged": True}
