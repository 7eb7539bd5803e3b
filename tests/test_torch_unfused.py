"""The port's unfused baseline pipeline against the JAX package and against the
port's fused pipeline.

Inputs are numpy from a seed, weights come from the JAX init. The JAX
kernels run in interpret mode; the port takes its plain versions on CPU
tensors. Bars: `lif_update` bit-exact; `spike_conv2d` within 1e-5; the
port's unfused pipeline bit-identical to its fused one (the reference's own
`test_fused_matches_unfused_bitexact`), and against JAX's unfused pipeline
logits within 1e-5 and spike counts exact; `n_spiking * T` gated-matmul
launches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vgg9_snn as jax_cfgs
from repro.kernels.lif_step.ops import lif_update as jax_lif_update
from repro.kernels.spike_conv import ops as jax_sc
from repro.models import vgg9 as jax_vgg9
from repro_torch.configs import vgg9_snn as torch_cfgs
from repro_torch.kernels import CUDA_LAUNCHES
from repro_torch.kernels.dense_conv_lif import ops as dense_ops
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.spike_conv import ops as sc_ops
from repro_torch.models import vgg9

BETA, THETA = 0.15, 0.5


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_vgg9.init_vgg9(jax.random.PRNGKey(0), jax_cfgs.TINY))


@pytest.fixture(scope="module")
def images():
    imgs = np.random.default_rng(1).random((4, 16, 16, 3)).astype(np.float32)
    imgs[1] = 0.0                                          # silent image
    imgs[2] *= 0.02                                        # near-silent image
    return imgs


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _spikes(seed, shape, density=0.1):
    return (np.random.default_rng(seed).random(shape) < density).astype(np.float32)


# ---------------------------------------------------------------------------
# lif_update (kernel 5's plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 16, 16, 8), (8, 1064), (1000,), (3, 7, 37), (512,),
                                   (2, 513)])
def test_lif_update_bit_exact(shape):
    u, cur = _normal(1, shape), _normal(2, shape, 0.7)
    s = _spikes(3, shape, 0.3)
    ju, js = jax_lif_update(*map(jnp.asarray, (u, cur, s)), beta=BETA, theta=THETA,
                            interpret=True)
    tu, ts = lif_ops.lif_update(*map(torch.from_numpy, (u, cur, s)), beta=BETA, theta=THETA)
    assert tu.shape == shape and ts.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_lif_update_plain_is_the_cpu_path():
    before = dict(CUDA_LAUNCHES)
    u = torch.from_numpy(_normal(4, (10,)))
    out = lif_ops.lif_update(u, u, torch.zeros(10))
    ref = lif_ops.lif_update_plain(u, u, torch.zeros(10))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert dict(CUDA_LAUNCHES) == before


# ---------------------------------------------------------------------------
# spike_conv2d (kernel 4's wrapper)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,cout,kw", [
    ((4, 16, 16, 8), 12, {}),
    ((4, 16, 16, 8), 12, dict(gate=False)),
    ((2, 8, 8, 12), 16, dict(block_m=128, block_k=128, block_n=128)),
    ((3, 6, 6, 16), 16, dict(block_m=256, gate=False)),     # M not a tile multiple
    ((2, 5, 5, 8), 24, dict(padding="VALID")),
])
def test_spike_conv2d_matches_reference(shape, cout, kw):
    spikes = _spikes(5, shape)
    spikes[0] = 0.0                                          # a silent image
    w = _normal(6, (3, 3, shape[-1], cout))
    ref = jax_sc.spike_conv2d(jnp.asarray(spikes), jnp.asarray(w), interpret=True, **kw)
    sc_ops.reset_launch_counts()
    out = sc_ops.spike_conv2d(torch.from_numpy(spikes), torch.from_numpy(w), **kw)
    assert sc_ops.launch_counts() == {"spike_matmul": 1}
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_spike_matmul_plain_gate_changes_nothing():
    patches = torch.from_numpy(_spikes(7, (256, 128)))
    patches[:128] = 0.0
    w2d = torch.from_numpy(_normal(8, (128, 128)))
    assert torch.equal(sc_ops.spike_matmul(patches, w2d, gate=True),
                       sc_ops.spike_matmul(patches, w2d, gate=False))


# ---------------------------------------------------------------------------
# The unfused pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["TINY", "TINY_INT4"])
def test_unfused_matches_fused_bitexact(jax_params, images, name):
    """Per-timestep in-kernel-gated launches against T folded into the rows
    of one occupancy-mapped launch: same sums, same LIF rounding."""
    cfg = getattr(torch_cfgs, name)
    params = vgg9.params_from_numpy(jax_params, "cpu")
    a, ca = vgg9.vgg9_infer_hybrid(params, images, cfg, device="cpu")
    b, cb = vgg9.vgg9_infer_hybrid_unfused(params, images, cfg, device="cpu")
    assert torch.equal(a, b)
    assert set(ca) == set(cb)
    for k in ca:
        assert int(ca[k]) == int(cb[k]), k


@pytest.mark.parametrize("name", ["TINY", "TINY_INT4"])
def test_unfused_matches_reference(jax_params, images, name):
    jcfg, tcfg = getattr(jax_cfgs, name), getattr(torch_cfgs, name)
    ref_logits, ref_counts = jax_vgg9.vgg9_infer_hybrid_unfused(jax_params, images, jcfg,
                                                                interpret=True)
    logits, counts = vgg9.vgg9_infer_hybrid_unfused(vgg9.params_from_numpy(jax_params, "cpu"),
                                                    images, tcfg, device="cpu")
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-5)
    assert {k: int(v) for k, v in counts.items()} == {k: int(v) for k, v in ref_counts.items()}


def test_unfused_launches_per_timestep(jax_params, images):
    cfg = torch_cfgs.TINY
    n_spiking = len(cfg.conv_channels) - 1
    sc_ops.reset_launch_counts()
    dense_ops.reset_launch_counts()
    before = dict(CUDA_LAUNCHES)
    vgg9.vgg9_infer_hybrid_unfused(vgg9.params_from_numpy(jax_params, "cpu"), images, cfg,
                                   device="cpu")
    assert sc_ops.launch_counts() == {"spike_matmul": n_spiking * cfg.timesteps}
    assert dense_ops.launch_counts() == {"dense_conv_lif": 1}
    assert dict(CUDA_LAUNCHES) == before                   # the plain path ran


def test_unfused_matches_reference_at_other_timesteps(jax_params, images):
    jcfg = dataclasses.replace(jax_cfgs.TINY, timesteps=3)
    tcfg = dataclasses.replace(torch_cfgs.TINY, timesteps=3)
    ref_logits, ref_counts = jax_vgg9.vgg9_infer_hybrid_unfused(jax_params, images, jcfg,
                                                                interpret=True)
    params = vgg9.params_from_numpy(jax_params, "cpu")
    logits, counts = vgg9.vgg9_infer_hybrid_unfused(params, images, tcfg, device="cpu")
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-5)
    assert {k: int(v) for k, v in counts.items()} == {k: int(v) for k, v in ref_counts.items()}
    fused, _ = vgg9.vgg9_infer_hybrid(params, images, tcfg, device="cpu")
    assert torch.equal(fused, logits)


def test_unfused_refuses_rate_coding(jax_params, images):
    cfg = dataclasses.replace(torch_cfgs.TINY, coding="rate")
    with pytest.raises(ValueError, match="direct"):
        vgg9.vgg9_infer_hybrid_unfused(vgg9.params_from_numpy(jax_params, "cpu"), images,
                                       cfg, device="cpu")


def test_unfused_on_the_card_without_one_raises(jax_params, images):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        vgg9.vgg9_infer_hybrid_unfused(vgg9.params_from_numpy(jax_params, "cpu"), images,
                                       torch_cfgs.TINY)
