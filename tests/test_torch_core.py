"""Parity of the port's core modules with the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Quantization, planning and the cost models must agree exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vgg9_snn as jax_cfgs
from repro.core import energy as jax_energy
from repro.core import hybrid as jax_hybrid
from repro.core import workload as jax_workload
from repro.core.lif import LIFParams as JaxLIFParams
from repro.core.lif import lif_step as jax_lif_step
from repro.core.quant import fake_quant as jax_fake_quant
from repro_torch.configs import vgg9_snn as torch_cfgs
from repro_torch.core import energy as torch_energy
from repro_torch.core import hybrid as torch_hybrid
from repro_torch.core import workload as torch_workload
from repro_torch.core.lif import LIFParams, lif_step
from repro_torch.core.quant import fake_quant
from repro_torch.core.tiling import round_up


def _quant_inputs(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    # values lying exactly on rounding ties of the int4 grid
    s = np.float32(np.abs(w).max()) / np.float32(7)
    w.reshape(-1)[:16] = (np.arange(16, dtype=np.float32) - 7.5) * s
    return w


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_fake_quant_bit_exact(bits, seed):
    w = _quant_inputs(seed)
    ref = np.asarray(jax_fake_quant(jnp.asarray(w), bits, None))
    out = fake_quant(torch.from_numpy(w), bits).numpy()
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def test_fake_quant_all_zero_tensor():
    w = np.zeros((5,), np.float32)
    ref = np.asarray(jax_fake_quant(jnp.asarray(w), 8, None))
    np.testing.assert_array_equal(fake_quant(torch.from_numpy(w), 8).numpy(), ref)


def test_lif_step_matches_reference():
    rng = np.random.default_rng(3)
    u, cur = (rng.normal(size=(64, 40)).astype(np.float32) for _ in range(2))
    s = (rng.random((64, 40)) < 0.3).astype(np.float32)
    # compiled, as the reference runs it inside jit and lax.scan
    step = jax.jit(jax_lif_step, static_argnums=3)
    ju, js = step(jnp.asarray(u), jnp.asarray(cur), jnp.asarray(s), JaxLIFParams())
    tu, ts = lif_step(torch.from_numpy(u), torch.from_numpy(cur), torch.from_numpy(s),
                      LIFParams())
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("x,m", [(1, 128), (128, 128), (129, 128), (27, 8)])
def test_round_up(x, m):
    assert round_up(x, m) == -(-x // m) * m


@pytest.mark.parametrize("name,batch", [("TINY", 4), ("TINY_INT4", 3),
                                        ("CIFAR10", 8), ("CIFAR100", 2)])
def test_plan_vgg9_inference_field_for_field(name, batch):
    ref = jax_hybrid.plan_vgg9_inference(getattr(jax_cfgs, name), batch)
    plan = torch_hybrid.plan_vgg9_inference(getattr(torch_cfgs, name), batch)
    assert dataclasses.asdict(plan) == dataclasses.asdict(ref)
    assert hash(plan) == hash(plan)


@pytest.mark.parametrize("m,k,n,sparse", [(16384, 576, 112, True), (7, 27, 64, False),
                                          (8192, 27, 64, False)])
def test_select_blocks(m, k, n, sparse):
    assert (torch_hybrid.select_blocks(m, k, n, sparse=sparse)
            == jax_hybrid.select_blocks(m, k, n, sparse=sparse))


def _workloads(mod, spikes):
    return [mod.dense_input_workload("conv0", 32, 32, 64, 2),
            mod.conv_workload("conv1", 112, 9, spikes[0]),
            mod.conv_workload("conv2", 192, 9, spikes[1]),
            mod.fc_workload("fc0", 1064, spikes[2])]


@pytest.mark.parametrize("precision", ["fp32", "int4"])
def test_energy_models_match(precision):
    spikes = np.random.default_rng(4).integers(0, 5000, size=3).astype(float)
    alloc = jax_workload.balance_allocation(_workloads(jax_workload, spikes), 12)
    assert torch_workload.balance_allocation(_workloads(torch_workload, spikes), 12) == alloc
    wbytes = [1e3, 2e4, 5e4, 7e5]
    assert (torch_energy.energy_per_image(_workloads(torch_workload, spikes), alloc,
                                          wbytes, precision)
            == jax_energy.energy_per_image(_workloads(jax_workload, spikes), alloc,
                                           wbytes, precision))
    assert (torch_energy.analytical_energy_per_image(
                _workloads(torch_workload, spikes), precision)
            == jax_energy.analytical_energy_per_image(
                _workloads(jax_workload, spikes), precision))
