"""The port's spiking VGG9 serving path against the JAX package.

Weights come from the JAX init and cross with `params_from_numpy`; images
are numpy from a seed. The JAX pipeline runs its Pallas kernels in
interpret mode, the port takes its plain versions on CPU tensors.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import vgg9_snn as jax_cfgs
from repro.core.hybrid import plan_vgg9_inference as jax_plan
from repro.models import vgg9 as jax_vgg9
from repro_torch.configs import vgg9_snn as torch_cfgs
from repro_torch.core.hybrid import plan_vgg9_inference
from repro_torch.kernels.dense_conv_lif import ops as dense_ops
from repro_torch.kernels.spike_conv import ops as sc_ops
from repro_torch.models import vgg9


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_vgg9.init_vgg9(jax.random.PRNGKey(0), jax_cfgs.TINY))


@pytest.fixture(scope="module")
def images():
    imgs = np.random.default_rng(1).random((4, 16, 16, 3)).astype(np.float32)
    imgs[1] = 0.0                                          # silent request
    imgs[2] *= 0.02                                        # near-silent request
    return imgs


def _assert_same_forward(ref, out):
    (jl, jc, js), (tl, tc, ts) = ref, out
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    assert set(tc) == set(jc)
    for k in jc:
        assert int(tc[k]) == int(jc[k]), k
    assert set(ts) == set(js)
    for name in js:
        assert set(ts[name]) == set(js[name]), name
        for k, v in js[name].items():
            a, b = np.asarray(v), ts[name][k].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, (name, k)
            np.testing.assert_array_equal(b, a, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("name", ["TINY", "TINY_INT4"])
def test_infer_hybrid_matches_reference(jax_params, images, name):
    jcfg, tcfg = getattr(jax_cfgs, name), getattr(torch_cfgs, name)
    ref = jax_vgg9.vgg9_infer_hybrid(jax_params, images, jcfg, interpret=True,
                                     return_stats=True)
    params = vgg9.params_from_numpy(jax_params, "cpu")
    sc_ops.reset_launch_counts()
    dense_ops.reset_launch_counts()
    out = vgg9.vgg9_infer_hybrid(params, images, tcfg, device="cpu", return_stats=True)
    _assert_same_forward(ref, out)
    n_spiking = len(tcfg.conv_channels) - 1
    assert sc_ops.launch_counts() == {"spike_matmul_mapped": n_spiking}
    assert dense_ops.launch_counts() == {"dense_conv_lif": 1}
    plan = plan_vgg9_inference(tcfg, 4)
    ks0 = plan.layer("conv0").kernel
    assert dense_ops.LAUNCH_LOG == [{"block_m": ks0.block_m, "block_n": ks0.block_n}]


def test_infer_hybrid_without_stats(jax_params, images):
    params = vgg9.params_from_numpy(jax_params, "cpu")
    logits, counts = vgg9.vgg9_infer_hybrid(params, images, torch_cfgs.TINY, device="cpu")
    ref_logits, ref_counts = jax_vgg9.vgg9_infer_hybrid(jax_params, images, jax_cfgs.TINY,
                                                        interpret=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-5)
    assert {k: int(v) for k, v in counts.items()} == {k: int(v) for k, v in ref_counts.items()}


def test_infer_hybrid_respects_custom_plan(jax_params, images):
    """Block-size overrides flow from the plan into the kernels unchanged."""
    def widen(plan):
        layers = tuple(
            dataclasses.replace(l, kernel=dataclasses.replace(l.kernel, block_m=256))
            if l.kernel and l.kernel.kernel == "spike_conv_mapped" else l
            for l in plan.layers)
        return dataclasses.replace(plan, layers=layers)

    ref = jax_vgg9.vgg9_infer_hybrid(jax_params, images, jax_cfgs.TINY, interpret=True,
                                     plan=widen(jax_plan(jax_cfgs.TINY, 4)),
                                     return_stats=True)
    out = vgg9.vgg9_infer_hybrid(vgg9.params_from_numpy(jax_params, "cpu"), images,
                                 torch_cfgs.TINY, device="cpu",
                                 plan=widen(plan_vgg9_inference(torch_cfgs.TINY, 4)),
                                 return_stats=True)
    _assert_same_forward(ref, out)
    assert int(out[2]["conv1"]["block_m"]) == 256


@pytest.mark.parametrize("name", ["TINY", "TINY_INT4", "CIFAR10_INT4"])
def test_quantized_view_bit_exact(name):
    jcfg, tcfg = getattr(jax_cfgs, name), getattr(torch_cfgs, name)
    jp = jax.tree.map(np.asarray, jax_vgg9.init_vgg9(jax.random.PRNGKey(2), jcfg))
    for leaf in jp.values():                               # non-trivial biases
        leaf["b"] = leaf["b"] + np.linspace(-0.3, 0.2, leaf["b"].size, dtype=np.float32)
    ref = jax_vgg9.quantized_view(jp, jcfg)
    out = vgg9.quantized_view(vgg9.params_from_numpy(jp, "cpu"), tcfg)
    for layer in ref:
        for k in ("w", "b"):
            np.testing.assert_array_equal(out[layer][k].numpy(), np.asarray(ref[layer][k]))


@pytest.mark.parametrize("name", ["TINY", "CIFAR10", "CIFAR100"])
def test_init_matches_reference_layout_and_seed(name):
    jcfg, tcfg = getattr(jax_cfgs, name), getattr(torch_cfgs, name)
    ref = jax.eval_shape(lambda k: jax_vgg9.init_vgg9(k, jcfg), jax.random.PRNGKey(0))
    a = vgg9.init_vgg9(torch.Generator().manual_seed(3), tcfg, "cpu")
    b = vgg9.init_vgg9(torch.Generator().manual_seed(3), tcfg, "cpu")
    assert set(a) == set(ref) == set(vgg9.conv_names(tcfg) + ["fc0", "fc1"])
    for layer in ref:
        for k in ("w", "b"):
            assert tuple(a[layer][k].shape) == ref[layer][k].shape
            assert a[layer][k].dtype == torch.float32
            assert torch.equal(a[layer][k], b[layer][k])
    fan_in = 9 * tcfg.in_ch
    std = a["conv0"]["w"].std().item()
    assert abs(std / (2.0 / fan_in) ** 0.5 - 1.0) < 0.2


def test_params_from_numpy_keeps_keys_and_layouts(jax_params):
    p = vgg9.params_from_numpy(jax_params, "cpu")
    for layer, leaf in jax_params.items():
        for k, v in leaf.items():
            np.testing.assert_array_equal(p[layer][k].numpy(), v)


def test_maxpool_is_or_over_windows():
    s = (np.random.default_rng(5).random((3, 6, 7, 4)) < 0.2).astype(np.float32)
    ref = np.asarray(jax_vgg9._maxpool_spikes(s))
    np.testing.assert_array_equal(vgg9._maxpool_spikes(torch.from_numpy(s)).numpy(), ref)


def test_stage_plan_matches_reference():
    for name in ("TINY", "CIFAR10"):
        assert (vgg9._stage_plan(getattr(torch_cfgs, name))
                == jax_vgg9._stage_plan(getattr(jax_cfgs, name)))


def test_rate_coding_is_refused(jax_params, images):
    cfg = dataclasses.replace(torch_cfgs.TINY, coding="rate")
    with pytest.raises(ValueError, match="direct"):
        vgg9.vgg9_infer_hybrid(vgg9.params_from_numpy(jax_params, "cpu"), images, cfg,
                               device="cpu")
