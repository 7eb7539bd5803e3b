"""The port's hand CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips (in a fixture) where there is
no CUDA device. This file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bars: the gated matmuls' occupancy maps exactly equal and currents within
1e-4 * max(1, max|ref|) (0/1 inputs make every product exact; only the
order of the fp32 sum differs), and the two gated matmuls bit-identical to
each other and to the plain k-ascending sum (all three sum k ascending) at
every block geometry, density and gate setting; the LIF kernels bit-identical; the dense
core's u within 1e-5 and its spikes equal wherever u is clear of theta, and
bit-identical to its ordered plain version (k ascending); the
unfused pipeline bit-identical to the fused one; a training step's loss
within 1e-4 and each gradient's relative L2 difference within 1e-3 of the
CPU's (cuDNN and the CPU sum in different orders), two card steps from one
state bit-identical and a crash -> resume equal to the clean run; the
same for LM training (every arch reduced, in bf16 with remat, two steps
from one state bit-identical; granite-moe's crash -> resume equal to the
clean run) and a bf16 checkpoint's round trip on the card. The int4 matmul within
1e-4 * max(1, max|ref|) (integer weights, fp32 sums in another order), a
row equal to the M = 1 call's, two calls and every geometry and mode at the
chosen K splits bit-identical;
flash attention within 5e-5 in fp32 (5e-5 of the largest output where
each head's V is offset by 64 * head) and within one bf16 step of the
largest output in bf16, two calls bit-identical; LM logits on the card
within 1e-3 of the CPU's (a dense LM, a reduced MoE and a reduced
recurrentgemma), and two card runs of the MoE bit-identical. Adaptive-precision serving of TINY on the card:
each request's logits bit-identical to the single-precision engine's at
the precision it was served, pinned requests at fp32, the served
precisions equal to the CPU's, one fused pipeline's launches per occupied
precision per engine step, and the same results with the observability
plane attached. The serving fleet at TINY: in-process replicas with a
wedge and a NaN-poison, and subprocess workers with one killed, every ok
result bit-identical to a solo engine's. Distribution: TINY served under a
data mesh of two shards of cuda:0 bit-identical to the solo engine, and
`compressed_psum` on two gloo ranks holding CUDA tensors bit-identical to
the same ranks on the CPU (`tests/torch_dist_workers.py` runs the ranks).
Tensor parallelism: one AdamW step of a tiny dense LM on a (1, 2) mesh of
two gloo ranks sharing cuda:0 against the same ranks on the CPU: the same
layouts, the loss and gradient norm within 1e-5 and the new parameter tree
within 1e-5 relative L2 (the card's matmuls sum in other orders).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import vgg9_snn
from repro_torch.configs.base import ArchConfig
from repro_torch.core.quant import quantize_int4
from repro_torch.kernels import CUDA_LAUNCHES, reset_cuda_launches
from repro_torch.kernels.dense_conv_lif import ops as dense_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.int4_matmul import ops as int4_ops
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.spike_conv import ops as sc_ops
from repro_torch.models import attention, vgg9
from repro_torch.models import transformer as tf
from repro_torch.obs import Observability
from repro_torch.serve.api import EngineConfig
from repro_torch.serve.core import EngineCore
from repro_torch.serve.precision import (PrecisionController, PrecisionRunner,
                                         bind_controller, make_snn_pricer, make_snn_variants)
from repro_torch.serve.scheduler import make_scheduler

BETA, THETA = 0.15, 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spikes(seed, shape, density=0.1):
    return torch.from_numpy(
        (np.random.default_rng(seed).random(shape) < density).astype(np.float32))


def _normal(seed, shape, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,block_m", [(16384, 640, 128, 128), (1024, 4608, 640, 128),
                                           (512, 256, 128, 256)])
def test_spike_matmul_mapped_matches_plain(cuda, m, k, n, block_m):
    patches = _spikes(14, (m, k)).to(cuda)
    patches[:block_m] = 0.0                                  # an all-zero tile row
    w2d = _normal(15, (k, n)).to(cuda)
    before = CUDA_LAUNCHES["spike_matmul_mapped"]
    out, occ, row_occ = sc_ops.spike_matmul_mapped(patches, w2d, block_m=block_m,
                                                   block_k=128)
    torch.cuda.synchronize()
    assert CUDA_LAUNCHES["spike_matmul_mapped"] == before + 1
    ref, ref_occ, ref_row = sc_ops.spike_matmul_mapped_plain(patches, w2d,
                                                             block_m=block_m, block_k=128)
    assert torch.equal(occ, ref_occ) and torch.equal(row_occ, ref_row)
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    assert out[:block_m].abs().max().item() == 0.0


SERVED_MAPPED = [(16384, 640, 128), (4096, 1024, 256), (4096, 1792, 256), (1024, 2048, 512),
                 (1024, 4352, 512), (1024, 4608, 640)]   # conv1-6 at CIFAR10 width, 8 slots


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.1, 0.33, 1.0])
@pytest.mark.parametrize("m,k,n", SERVED_MAPPED)
def test_spike_matmul_mapped_bit_identical_to_event_order(cuda, m, k, n, density):
    """The event-driven kernel at the served shapes: bit for bit the plain
    k-ascending sum and the in-kernel-gated kernel, its bitmask and maps
    exactly the plain ones, a row block with no spikes exactly 0."""
    patches = _spikes(40, (m, k), density).to(cuda)
    patches[128:256] = 0.0                                   # a row block with no spikes
    w2d = _normal(41, (k, n), (2.0 / k) ** 0.5).to(cuda)
    out, occ, row_occ, mask = sc_ops._spike_matmul_mapped_cuda(
        patches, w2d, block_m=128, block_k=128, gate=True)
    ref, ref_occ, ref_row = sc_ops.spike_matmul_mapped_plain(patches, w2d, block_m=128,
                                                             block_k=128)
    assert torch.equal(mask, sc_ops.spike_bitmask_plain(patches))
    assert torch.equal(occ, ref_occ) and torch.equal(row_occ, ref_row)
    assert torch.equal(out, sc_ops.spike_matmul_event_plain(patches, w2d))
    assert torch.equal(out, sc_ops.spike_matmul(patches, w2d))
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    assert out[128:256].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("block_m,gate", [(128, True), (256, True), (256, False)])
@pytest.mark.parametrize("geometry", sc_ops.EVENT_GEOMETRIES)
def test_spike_matmul_mapped_every_geometry(cuda, geometry, block_m, gate):
    """Every (rows, cols) block the kernel has, with the gate on and off."""
    patches = _spikes(42, (2048, 1024), 0.2).to(cuda)
    patches[:block_m] = 0.0                                  # an all-zero tile row
    patches[:, 256:384] = 0.0                                # an all-zero k tile
    w2d = _normal(43, (1024, 640), 0.05).to(cuda)
    out, occ, row_occ, mask = sc_ops._spike_matmul_mapped_cuda(
        patches, w2d, block_m=block_m, block_k=128, gate=gate, geometry=geometry)
    _, ref_occ, ref_row = sc_ops.spike_matmul_mapped_plain(patches, w2d, block_m=block_m,
                                                           block_k=128, gate=gate)
    assert torch.equal(occ, ref_occ) and torch.equal(row_occ, ref_row)
    assert torch.equal(mask, sc_ops.spike_bitmask_plain(patches))
    assert torch.equal(out, sc_ops.spike_matmul_event_plain(patches, w2d))
    assert out[:block_m].abs().max().item() == 0.0


@pytest.mark.cuda
def test_spike_conv2d_mapped_stats_match_cpu(cuda):
    spikes = _spikes(21, (4, 16, 16, 24))
    spikes[1] = 0.0
    w = _normal(22, (3, 3, 24, 40))
    out, st = sc_ops.spike_conv2d_mapped(spikes.to(cuda), w.to(cuda), block_m=128)
    ref, ref_st = sc_ops.spike_conv2d_mapped(spikes, w, block_m=128)
    assert (out.cpu() - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    for key, v in ref_st.items():
        assert torch.equal(st[key].cpu(), v), key


# the served epilogues' (R, N) at CIFAR10, 8 slots (conv1-6, fc0, fc1), and
# two widths that take the scalar path, each at T = 1, 2, 4 and 25
SERVED_EPILOGUES = [(8192, 112), (2048, 192), (2048, 216), (512, 480), (512, 504),
                    (512, 560), (8, 1064), (8, 1000)]
EPILOGUE_CASES = [(2, 8192, 112), (2, 8, 1064), (3, 100, 37)] + [
    (steps, rows, n) for steps in (1, 2, 4, 25)
    for rows, n in SERVED_EPILOGUES + [(100, 37), (50, 6)]
    if (steps, rows, n) not in ((2, 8192, 112), (2, 8, 1064))]


@pytest.mark.cuda
@pytest.mark.parametrize("steps,rows,n", EPILOGUE_CASES)
def test_lif_epilogue_scan_bit_identical(cuda, steps, rows, n):
    cur = _normal(16, (steps, rows, n), 0.6).to(cuda)
    bias = _normal(17, (n,), 0.1).to(cuda)
    before = CUDA_LAUNCHES["lif_epilogue_scan"]
    out = lif_ops.lif_epilogue_scan(cur, bias, beta=BETA, theta=THETA)
    torch.cuda.synchronize()
    assert CUDA_LAUNCHES["lif_epilogue_scan"] == before + 1
    ref = lif_ops.lif_epilogue_scan_plain(cur, bias, beta=BETA, theta=THETA)
    assert torch.equal(out, ref)


def _column_bias(seed, n):
    """A distinct bias per column around theta, shuffled, so that with zero
    currents each column's spike train depends on its own column."""
    b = np.linspace(0.0, 1.2, n, dtype=np.float32)
    return torch.from_numpy(b[np.random.default_rng(seed).permutation(n)])


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 25])
@pytest.mark.parametrize("rows,n", [(2048, 192), (8, 1064), (100, 37)])
def test_lif_epilogue_scan_column_bias(cuda, rows, n, steps):
    """Zero currents and a bias distinct per column: a wrong column index
    shows as wrong spikes, on the unrolled T = 2 and on the general-T path
    (T = 1, 25)."""
    cur = torch.zeros((steps, rows, n), device=cuda)
    bias = _column_bias(32, n).to(cuda)
    ref = lif_ops.lif_epilogue_scan_plain(cur, bias, beta=BETA, theta=THETA)
    assert 0 < ref.sum().item() < ref.numel()
    out = lif_ops.lif_epilogue_scan(cur, bias, beta=BETA, theta=THETA)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8192, 27, 64), (100, 27, 40), (8192, 75, 64)])
def test_dense_conv_lif_bit_identical_to_ordered_plain(cuda, m, k, n):
    patches = torch.from_numpy(np.random.default_rng(33).random((m, k))
                               .astype(np.float32)).to(cuda)
    w2d = _normal(34, (k, n), 0.3).to(cuda)
    bias = _normal(35, (n,), 0.1).to(cuda)
    before = CUDA_LAUNCHES["dense_conv_lif"]
    s, u = dense_ops.dense_conv_lif(patches, w2d, bias, num_steps=2, beta=BETA, theta=THETA)
    torch.cuda.synchronize()
    assert CUDA_LAUNCHES["dense_conv_lif"] == before + 1
    rs, ru = dense_ops.dense_conv_lif_ordered_plain(patches, w2d, bias, num_steps=2,
                                                    beta=BETA, theta=THETA)
    assert torch.equal(s, rs) and torch.equal(u, ru)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8192, 27, 64), (100, 27, 40), (70, 27, 6), (45, 75, 64)])
def test_dense_conv_lif_tail_tiles_and_paths(cuda, m, k, n):
    """The ordered sum's bits with a tail tile (M % 32 != 0, its patch
    floats not a multiple of 4), the one-channel path (N % 4 != 0) and a
    staging of more than one pass (K = 75)."""
    patches = torch.from_numpy(np.random.default_rng(36).random((m, k))
                               .astype(np.float32)).to(cuda)
    w2d = _normal(37, (k, n), 0.3).to(cuda)
    bias = _normal(38, (n,), 0.1).to(cuda)
    s, u = dense_ops.dense_conv_lif(patches, w2d, bias, num_steps=3, beta=BETA, theta=THETA)
    rs, ru = dense_ops.dense_conv_lif_ordered_plain(patches, w2d, bias, num_steps=3,
                                                    beta=BETA, theta=THETA)
    assert torch.equal(s, rs) and torch.equal(u, ru)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(8192, 64), (100, 40), (70, 6)])
def test_dense_conv_lif_column_bias(cuda, m, n):
    """Zero patches and a bias distinct per column: a wrong column index
    shows as wrong spikes."""
    patches = torch.zeros((m, 27), device=cuda)
    w2d = _normal(39, (27, n), 0.3).to(cuda)
    bias = _column_bias(40, n).to(cuda)
    s, u = dense_ops.dense_conv_lif(patches, w2d, bias, num_steps=4, beta=BETA, theta=THETA)
    rs, ru = dense_ops.dense_conv_lif_ordered_plain(patches, w2d, bias, num_steps=4,
                                                    beta=BETA, theta=THETA)
    assert 0 < rs.sum().item() < rs.numel()
    assert torch.equal(s, rs) and torch.equal(u, ru)


@pytest.mark.cuda
def test_dense_conv_lif_matches_plain(cuda):
    patches = torch.from_numpy(np.random.default_rng(18).random((8192, 27))
                               .astype(np.float32)).to(cuda)
    w2d = _normal(19, (27, 64), 0.3).to(cuda)
    bias = _normal(20, (64,), 0.1).to(cuda)
    s, u = dense_ops.dense_conv_lif(patches, w2d, bias, num_steps=2, beta=BETA, theta=THETA)
    rs, ru = dense_ops.dense_conv_lif_plain(patches, w2d, bias, num_steps=2,
                                            beta=BETA, theta=THETA)
    assert (u - ru).abs().max().item() <= 1e-5
    for t in range(2):                   # spikes agree wherever u_t is clear of theta
        _, u_t = dense_ops.dense_conv_lif_plain(patches, w2d, bias, num_steps=t + 1,
                                                beta=BETA, theta=THETA)
        clear = (u_t - THETA).abs() > 1e-5
        assert torch.equal(s[t][clear], rs[t][clear])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["TINY", "TINY_INT4"])
def test_pipeline_matches_cpu(cuda, name):
    """The card's pipeline (three hand kernels) against the CPU's plain one."""
    cfg = getattr(vgg9_snn, name)
    params = vgg9.init_vgg9(torch.Generator().manual_seed(0), cfg, "cpu")
    imgs = torch.rand((4, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    imgs[1] = 0.0
    cpu = vgg9.vgg9_infer_hybrid(params, imgs, cfg, device="cpu", return_stats=True)
    gpu_params = {k: {kk: v.to(cuda) for kk, v in leaf.items()} for k, leaf in params.items()}
    reset_cuda_launches()
    gpu = vgg9.vgg9_infer_hybrid(gpu_params, imgs, cfg, device="cuda", return_stats=True)
    assert dict(CUDA_LAUNCHES) == {"dense_conv_lif": 1, "spike_matmul_mapped": 3,
                                   "lif_epilogue_scan": 5, "spike_matmul": 0, "lif_step": 0,
                                   "int4_matmul": 0, "flash_attention": 0}
    assert (gpu[0].cpu() - cpu[0]).abs().max().item() <= 1e-5
    for k in cpu[1]:
        assert int(gpu[1][k]) == int(cpu[1][k]), k
    for layer, st in cpu[2].items():
        for key, v in st.items():
            assert torch.equal(gpu[2][layer][key].cpu(), v), (layer, key)


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.1, 0.33, 1.0])
@pytest.mark.parametrize("m,k,n,gate", [(8192, 640, 128, True), (512, 4608, 640, True),
                                        (512, 2048, 512, False), (256, 128, 128, True)])
def test_spike_matmul_matches_plain_and_mapped(cuda, m, k, n, gate, density):
    patches = _spikes(23, (m, k), density).to(cuda)
    patches[:64] = 0.0                                       # an all-zero tile row
    patches[:, :32] = 0.0                                    # an all-zero k slice
    w2d = _normal(24, (k, n)).to(cuda)
    before = CUDA_LAUNCHES["spike_matmul"]
    out = sc_ops.spike_matmul(patches, w2d, gate=gate)
    torch.cuda.synchronize()
    assert CUDA_LAUNCHES["spike_matmul"] == before + 1
    ref = sc_ops.spike_matmul_plain(patches, w2d, gate=gate)
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    assert out[:64].abs().max().item() == 0.0
    mapped, _, _ = sc_ops.spike_matmul_mapped(patches, w2d, block_m=128, block_k=128)
    assert torch.equal(out, mapped)                  # the same per-element sum order
    assert torch.equal(out, sc_ops.spike_matmul_event_plain(patches, w2d))


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("geometry", sc_ops.GATED_GEOMETRIES)
def test_spike_matmul_every_geometry(cuda, geometry, gate):
    """Every block geometry the kernel has, with the gate on and off; K is
    an odd number of words, so the last ring stage holds one."""
    patches = _spikes(44, (1024, 1056), 0.2).to(cuda)
    patches[:64] = 0.0                                       # an all-zero tile row
    patches[:, 256:288] = 0.0                                # an all-zero k word
    w2d = _normal(45, (1056, 640), 0.05).to(cuda)
    out = sc_ops._spike_matmul_cuda(patches, w2d, gate=gate, geometry=geometry)
    assert torch.equal(out, sc_ops.spike_matmul_event_plain(patches, w2d))
    assert out[:64].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", sc_ops.GATED_GEOMETRIES)
def test_spike_matmul_lone_rows(cuda, geometry):
    """One row of every 8 spikes (so one of each warp's row group at most)
    and its neighbours are silent; no two rows spike at the same k."""
    m, k, n = 256, 256, 128
    patches = torch.zeros((m, k))
    for i in range(m):
        if i % 8 == (i // 8) % 8:
            patches[i, (3 * i) % k] = 1.0
            patches[i, (3 * i + 131) % k] = 1.0
    patches = patches.to(cuda)
    w2d = _normal(46, (k, n)).to(cuda)
    out = sc_ops._spike_matmul_cuda(patches, w2d, gate=True, geometry=geometry)
    assert torch.equal(out, sc_ops.spike_matmul_event_plain(patches, w2d))
    silent = patches.sum(dim=1) == 0
    assert out[silent].abs().max().item() == 0.0
    assert out[~silent].abs().min().item() > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.05, 0.33, 1.0])
def test_spike_matmul_gate_off_equals_gate_on(cuda, density):
    patches = _spikes(47, (512, 2048), density).to(cuda)
    w2d = _normal(48, (2048, 512)).to(cuda)
    on = sc_ops.spike_matmul(patches, w2d, gate=True)
    off = sc_ops.spike_matmul(patches, w2d, gate=False)
    assert torch.equal(on, off)
    assert torch.equal(on, sc_ops.spike_matmul_event_plain(patches, w2d))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [917504, 8512, 8000, 1001, 3])
def test_lif_update_bit_identical(cuda, n):
    u, cur = _normal(25, (n,)).to(cuda), _normal(26, (n,), 0.7).to(cuda)
    s = _spikes(27, (n,), 0.3).to(cuda)
    before = CUDA_LAUNCHES["lif_step"]
    out = lif_ops.lif_update(u, cur, s, beta=BETA, theta=THETA)
    torch.cuda.synchronize()
    assert CUDA_LAUNCHES["lif_step"] == before + 1
    ref = lif_ops.lif_update_plain(u, cur, s, beta=BETA, theta=THETA)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["TINY", "TINY_INT4"])
def test_unfused_matches_fused_on_card(cuda, name):
    cfg = getattr(vgg9_snn, name)
    params = vgg9.init_vgg9(torch.Generator().manual_seed(0), cfg, "cuda")
    imgs = torch.rand((4, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    imgs[1] = 0.0
    fused, fc = vgg9.vgg9_infer_hybrid(params, imgs, cfg, device="cuda")
    reset_cuda_launches()
    unfused, uc = vgg9.vgg9_infer_hybrid_unfused(params, imgs, cfg, device="cuda")
    n_spiking = len(cfg.conv_channels) - 1
    assert CUDA_LAUNCHES["spike_matmul"] == n_spiking * cfg.timesteps
    assert CUDA_LAUNCHES["lif_step"] == (n_spiking + 2) * cfg.timesteps
    assert torch.equal(fused, unfused)
    for k in fc:
        assert int(fc[k]) == int(uc[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["TINY", "TINY_INT4"])
def test_training_grads_match_cpu(cuda, name):
    from repro_torch.train.train_step import value_and_grad
    cfg = getattr(vgg9_snn, name)
    params = vgg9.init_vgg9(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(28)
    batch = {"images": torch.from_numpy(rng.random((8, 16, 16, 3)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.num_classes, 8))}
    grad_fn = value_and_grad(lambda p, b: vgg9.vgg9_loss(p, b, cfg))
    loss, grads = grad_fn(params, batch)
    gpu_params = {k: {kk: v.to(cuda) for kk, v in leaf.items()} for k, leaf in params.items()}
    gpu_loss, gpu_grads = grad_fn(gpu_params, {k: v.to(cuda) for k, v in batch.items()})
    assert abs(gpu_loss.item() - loss.item()) <= 1e-4
    for layer, leaf in grads.items():
        for k, g in leaf.items():
            diff = (gpu_grads[layer][k].cpu() - g).norm().item()
            assert diff <= 1e-3 * max(g.norm().item(), 1e-12), (layer, k)


def _tree_equal(a, b):
    """Two trees of tensors (dicts, tuples, lists) bit for bit: same keys,
    dtypes, shapes and bits."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_tree_equal, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["CIFAR10", "CIFAR10_INT4"])
def test_training_step_is_run_to_run_deterministic(cuda, name):
    """Two train steps from one state on one batch of 8, at full CIFAR10
    width: bit-identical loss, parameters and optimizer state."""
    from repro_torch.data.synthetic import image_batch
    from repro_torch.train.optim import adamw
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = getattr(vgg9_snn, name)
    opt = adamw(weight_decay=0.0)
    step = make_train_step(lambda p, b: vgg9.vgg9_loss(p, b, cfg), opt,
                           warmup_cosine(3e-3, 20, 5))
    state = init_train_state(vgg9.init_vgg9(torch.Generator().manual_seed(0), cfg, cuda), opt)
    batch = image_batch(0, 0, 8, num_classes=cfg.num_classes, hw=cfg.img_hw, device=cuda)
    a, ma = step(state, batch)
    b, mb = step(state, batch)
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"], mb["grad_norm"])
    assert _tree_equal(a, b)


@pytest.mark.cuda
def test_training_crash_resume_bit_identical_on_card(cuda, tmp_path):
    """TINY on the card: a run that crashes after its step-4 checkpoint,
    restores and finishes equals the clean run bit for bit."""
    from repro_torch.data.synthetic import image_batch
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.optim import adamw
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = vgg9_snn.TINY
    opt = adamw(weight_decay=0.0)

    def run(ckpt_dir, fail_at_step=None):
        step = make_train_step(lambda p, b: vgg9.vgg9_loss(p, b, cfg), opt,
                               warmup_cosine(3e-3, 2, 8))
        loop = TrainLoop(step, lambda i: image_batch(0, i, 16, num_classes=cfg.num_classes,
                                                     hw=cfg.img_hw, device=cuda),
                         ckpt_dir=str(ckpt_dir), ckpt_every=2, log_every=100,
                         log_fn=lambda *a: None)
        state = init_train_state(vgg9.init_vgg9(torch.Generator().manual_seed(0), cfg, cuda),
                                 opt)
        if fail_at_step is None:
            return loop.run(state, 8)
        with pytest.raises(RuntimeError, match="simulated"):
            loop.run(state, 8, fail_at_step=fail_at_step)
        restored, start = loop.maybe_restore(state)
        assert start == 4
        return loop.run(restored, 8, start_step=start)

    assert _tree_equal(run(tmp_path / "clean"), run(tmp_path / "crash", fail_at_step=5))


def _lm_train_cfg(arch):
    """An LM arch cut as `tests/test_models_smoke.py` cuts it, but in its
    own bf16 with ``remat="full"``, as a full-size run trains."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    kw = dict(dtype="bfloat16", remat="full", d_model=48, head_dim=12, q_chunk=8, kv_chunk=8,
              mlstm_chunk=8, vocab=101, fsdp_experts=False,
              n_layers=2 * len(cfg.pattern) + len(cfg.tail))
    if cfg.d_ff:
        kw["d_ff"] = 96
    if cfg.moe_d_ff:
        kw["moe_d_ff"] = 32
    if cfg.d_rnn:
        kw["d_rnn"] = 48
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), n_experts_padded=0)
    if cfg.window:
        kw["window"] = 8
    if cfg.frontend:
        kw.update(n_frontend_tokens=4, d_frontend=16)
    return cfg.with_(**kw)


def _lm_training(cfg, device, steps=6):
    from repro_torch.data.synthetic import _generator, token_batch
    from repro_torch.models.frontends import synth_frontend
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import init_train_state, make_train_step
    opt = make_optimizer(cfg.optimizer)
    step = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt,
                           warmup_cosine(3e-3, 2, steps))
    n_front = cfg.n_frontend_tokens if cfg.frontend else 0

    def make_batch(i):
        b = token_batch(0, i, 4, 32 - n_front, cfg.vocab, device=device)
        if cfg.frontend:
            b["frontend_embeds"] = synth_frontend(_generator(0, i), cfg, 4, "cpu").to(device)
        return b
    params = tf.init_params(torch.Generator(device=device).manual_seed(0), cfg, device)
    return step, make_batch, init_train_state(params, opt)


LM_ARCHS = ("granite-34b", "granite-moe-3b-a800m", "llama4-maverick-400b-a17b", "minitron-8b",
            "musicgen-large", "phi-3-vision-4.2b", "qwen1.5-4b", "recurrentgemma-2b",
            "starcoder2-15b", "xlstm-125m")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_is_run_to_run_deterministic(cuda, arch):
    """Every arch (reduced, bf16, remat="full"; the MoE's gathers and their
    index_put backwards, the mLSTM's prefix sums) under the step's
    deterministic settings: no op refuses, and two steps from one state on
    one batch give bit-identical loss, parameters and optimizer state."""
    step, make_batch, state = _lm_training(_lm_train_cfg(arch), cuda)
    batch = make_batch(0)
    a, ma = step(state, batch)
    b, mb = step(state, batch)
    assert torch.isfinite(ma["loss"])
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"], mb["grad_norm"])
    assert _tree_equal(a, b)


@pytest.mark.cuda
def test_lm_crash_resume_bit_identical_on_card(cuda, tmp_path):
    """granite-moe (reduced, bf16, remat) on the card: a run that fails at
    step 3 and resumes from its step-2 checkpoint (bf16 leaves on disk as
    2-byte records) equals the clean 6-step run bit for bit."""
    from repro_torch.train.loop import TrainLoop
    cfg = _lm_train_cfg("granite-moe-3b-a800m")

    def run(ckpt_dir, fail_at_step=None):
        step, make_batch, state = _lm_training(cfg, cuda)
        loop = TrainLoop(step, make_batch, ckpt_dir=str(ckpt_dir), ckpt_every=2,
                         log_every=100, log_fn=lambda *a: None)
        if fail_at_step is None:
            return loop.run(state, 6)
        with pytest.raises(RuntimeError, match="simulated"):
            loop.run(state, 6, fail_at_step=fail_at_step)
        restored, start = loop.maybe_restore(state)
        assert start == 2
        return loop.run(restored, 6, start_step=start)

    assert _tree_equal(run(tmp_path / "clean"), run(tmp_path / "crash", fail_at_step=3))


@pytest.mark.cuda
def test_bf16_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A bf16 LM train state on the card saves and restores onto the card
    bit for bit (bf16 parameters, fp32 moments, int32 counters)."""
    from repro_torch.train import checkpoint as ckpt
    _, _, state = _lm_training(_lm_train_cfg("recurrentgemma-2b"), cuda)
    assert state["params"]["embed"]["w_tok"].dtype == torch.bfloat16
    ckpt.save(str(tmp_path), 3, state)
    out = ckpt.restore(str(tmp_path), 3, state)
    assert out["params"]["embed"]["w_tok"].device.type == cuda.type
    assert _tree_equal(out, state)


# qwen1.5-4b's projections at decode (4 slots) and prefill (512) widths, the
# LM head and serve_lm_w4's shape, then ragged shapes
QWEN_INT4 = [(4, 2560, 2560), (512, 2560, 2560), (4, 2560, 6912), (512, 2560, 6912),
             (4, 6912, 2560), (512, 6912, 2560), (4, 2560, 151936), (4, 2560, 256)]
# serve_lm_w4 --full's shape for the other archs: K = their d_model
ARCH_INT4 = [(4, k, 256) for k in (768, 1536, 2048, 3072, 4096, 5120, 6144)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", QWEN_INT4 + ARCH_INT4 + [(17, 96, 130), (5, 33, 18)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_matches_plain(cuda, m, k, n, dtype):
    qt = quantize_int4(_normal(29, (k, n)).to(cuda))
    x = _normal(30, (m, k)).to(cuda).to(dtype)
    before = CUDA_LAUNCHES["int4_matmul"]
    out = int4_ops.int4_matmul(x, qt.packed, qt.scale)
    torch.cuda.synchronize()
    assert CUDA_LAUNCHES["int4_matmul"] == before + 1 and out.dtype == torch.float32
    ref = int4_ops.int4_matmul_plain(x, qt.packed, qt.scale)
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    # a row's result does not depend on the rows beside it (the row is
    # copied: the wrappers take 16-byte aligned operands, and a row view
    # of a [5, 33] tensor starts 132 bytes in)
    assert torch.equal(int4_ops.int4_matmul(x[1:2].clone(), qt.packed, qt.scale), out[1:2])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 2560, 256), (4, 6912, 2560), (512, 2560, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_calls_are_bit_identical(cuda, m, k, n, dtype):
    """Split mode (decode widths) and whole mode (prefill) sum K's ranges in
    one fixed order, with no atomics."""
    qt = quantize_int4(_normal(32, (k, n)).to(cuda))
    x = _normal(33, (m, k)).to(cuda).to(dtype)
    first = int4_ops.int4_matmul(x, qt.packed, qt.scale)
    assert torch.equal(int4_ops.int4_matmul(x, qt.packed, qt.scale), first)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(7, 67, 50), (9, 67, 96), (3, 1, 64), (600, 68, 6912)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_ragged_shapes(cuda, m, k, n, dtype):
    """K odd or not a multiple of 8 or 64, N % 32 != 0 or not a multiple of
    64, tiny K, on whichever path `int4_plan` gives (fp32 x with N % 32 == 0
    takes the tensor cores, its planes' rows padded)."""
    qt = quantize_int4(_normal(34, (k, n)).to(cuda))
    x = _normal(35, (m, k)).to(cuda).to(dtype)
    out = int4_ops.int4_matmul(x, qt.packed, qt.scale)
    ref = int4_ops.int4_matmul_plain(x, qt.packed, qt.scale)
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", int4_ops.INT4_GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_every_geometry(cuda, geometry, dtype):
    """Each tensor-core kernel, in split and in whole mode, within the bar of
    the plain version and bit for bit the picker's choice (the ranges of K,
    not the geometry or the mode, fix the sum's order)."""
    m, k, n = 20, 1000, 320
    qt = quantize_int4(_normal(36, (k, n)).to(cuda))
    x = _normal(37, (m, k)).to(cuda).to(dtype)
    chosen = int4_ops.int4_matmul(x, qt.packed, qt.scale)
    ref = int4_ops.int4_matmul_plain(x, qt.packed, qt.scale)
    for sms in (1, 10 ** 6):                 # whole mode, then split mode
        plan = int4_ops.int4_plan(m, k, n, dtype, sms, geometry)
        assert plan.whole == (sms == 1)
        out = int4_ops._int4_matmul_cuda(x, qt.packed, qt.scale.reshape(-1).float(),
                                         geometry=geometry, sms=sms)
        assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
        assert torch.equal(out, chosen), (geometry, plan)


def _flash_bar(ref, dtype):
    # fp32: the JAX test's bar; bf16: one rounding step of the largest output
    return 5e-5 if dtype == torch.float32 else 2 ** -7 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,hd", [(20, 512, 128)] + [
    (2 if s == 2048 else 3, s, hd) for hd in (64, 128) for s in (1, 100, 128, 130, 512, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, bh, s, hd, dtype):
    q, k, v = (_normal(31 + i, (bh, s, hd)).to(cuda).to(dtype) for i in range(3))
    before = CUDA_LAUNCHES["flash_attention"]
    out = flash_ops.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert CUDA_LAUNCHES["flash_attention"] == before + 1 and out.dtype == dtype
    ref = flash_ops.flash_attention_plain(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= _flash_bar(ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("s,hd", [(100, 64), (130, 128), (512, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_keeps_heads_apart(cuda, s, hd, dtype):
    # each head's V sits 64 * head away from the others: a tile that read
    # rows of the next head (past S) would pull its output far off
    bh = 4
    q, k, v = (_normal(41 + i, (bh, s, hd)) for i in range(3))
    v = v + 64.0 * torch.arange(bh, dtype=torch.float32)[:, None, None]
    q, k, v = (t.to(cuda).to(dtype) for t in (q, k, v))
    out = flash_ops.flash_attention_fwd(q, k, v)
    ref = flash_ops.flash_attention_plain(q, k, v)
    # outputs reach 64 * 3 + 4: fp32's bar relative to them (another head's
    # rows would move an output by ~64)
    top = max(1.0, ref.abs().max().item())
    bar = 5e-5 * top if dtype == torch.float32 else _flash_bar(ref, dtype)
    assert (out.float() - ref.float()).abs().max().item() <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_is_deterministic(cuda, dtype):
    q, k, v = (_normal(51 + i, (20, 2048, 128)).to(cuda).to(dtype) for i in range(3))
    assert torch.equal(flash_ops.flash_attention_fwd(q, k, v), flash_ops.flash_attention_fwd(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_chunked_gqa(cuda, dtype):
    q, k, v = (_normal(34 + i, (2, 256, h, 64)).to(cuda).to(dtype)
               for i, h in enumerate((8, 2, 2)))
    out = flash_ops.flash_attention(q, k, v)
    assert out.dtype == dtype
    # the model's attention on the same (bf16-rounded) values in fp32
    ref = attention.chunked_causal_attention(q.float(), k.float(), v.float(), q_chunk=64,
                                             kv_chunk=128)
    assert (out.float() - ref).abs().max().item() <= _flash_bar(ref, dtype)


@pytest.mark.cuda
def test_lm_decode_chunk_matches_cpu(cuda):
    cfg = ArchConfig(name="t", family="dense", n_layers=2, d_model=256, n_heads=4,
                     n_kv_heads=2, head_dim=64, d_ff=512, vocab=1000, qkv_bias=True,
                     dtype="float32", remat="none")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gpu = {"embed": {"w_tok": params["embed"]["w_tok"].to(cuda)},
           "final_norm": params["final_norm"].to(cuda),
           "lm_head": {"w": params["lm_head"]["w"].to(cuda)},
           "periods": {"slot0": {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
                                     if isinstance(v, dict) else v.to(cuda))
                                 for k, v in params["periods"]["slot0"].items()}},
           "tail": ()}
    toks = torch.from_numpy(np.random.default_rng(37).integers(0, 1000, (3, 6)))
    pos0, take = torch.tensor([0, 2, 5]), torch.tensor([6, 4, 1])
    _, ref, _ = tf.decode_chunk(params, tf.init_cache(cfg, 3, 16, "cpu"), toks, pos0, take, cfg)
    _, out, _ = tf.decode_chunk(gpu, tf.init_cache(cfg, 3, 16, cuda), toks.to(cuda),
                                pos0.to(cuda), take.to(cuda), cfg)
    for row in range(3):
        cols = slice(0, int(take[row]))
        assert (out[row, cols].cpu() - ref[row, cols]).abs().max().item() <= 1e-3


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device)


# reduced granite-moe-3b (40 experts padded to 48, top-8 -> 12 padded to 16,
# top-4) and recurrentgemma-2b (one period and its 2-layer RG-LRU tail)
MOE_SMALL = dict(name="moe-small", family="moe", n_layers=2, d_model=256, n_heads=4,
                 n_kv_heads=2, head_dim=64, d_ff=128, vocab=1000, mlp_act="swiglu",
                 pattern=("attn_moe",), n_experts=12, top_k=4, moe_d_ff=128,
                 n_experts_padded=16, dtype="float32", remat="none")
RG_SMALL = dict(name="rg-small", family="hybrid", n_layers=5, d_model=256, n_heads=4,
                n_kv_heads=1, head_dim=64, d_ff=512, vocab=1000, mlp_act="geglu",
                pattern=("rglru", "rglru", "local_attn"), tail=("rglru", "rglru"), window=8,
                d_rnn=256, tie_embeddings=True, dtype="float32", remat="none")


@pytest.mark.cuda
def test_moe_decode_is_bit_identical_across_card_runs(cuda):
    """The combine sums each token's k expert rows in a fixed order with no
    atomics, so two card runs agree bit for bit; both within 1e-3 of the
    CPU."""
    cfg = ArchConfig(**MOE_SMALL)
    params = tf.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    gpu = _to(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(38).integers(0, 1000, (4, 6)))
    pos0, take = torch.tensor([0, 2, 5, 0]), torch.tensor([6, 4, 1, 6])
    runs = [tf.decode_chunk(gpu, tf.init_cache(cfg, 4, 16, cuda), toks.to(cuda), pos0.to(cuda),
                            take.to(cuda), cfg)[1] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    _, ref, _ = tf.decode_chunk(params, tf.init_cache(cfg, 4, 16, "cpu"), toks, pos0, take, cfg)
    for row in range(4):
        cols = slice(0, int(take[row]))
        assert (runs[0][row, cols].cpu() - ref[row, cols]).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_recurrentgemma_matches_cpu(cuda):
    """RG-LRU scan and decode, local attention's ring buffer and the tail:
    forward and decode_chunk logits on the card within 1e-3 of the CPU's."""
    cfg = ArchConfig(**RG_SMALL)
    params = tf.init_params(torch.Generator().manual_seed(2), cfg, "cpu")
    gpu = _to(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(39).integers(0, 1000, (3, 12)))
    ref, _ = tf.forward(params, {"tokens": toks}, cfg)
    out, _ = tf.forward(gpu, {"tokens": toks.to(cuda)}, cfg)
    assert (out.cpu() - ref).abs().max().item() <= 1e-3
    pos0, take = torch.tensor([0, 3, 1]), torch.tensor([12, 9, 5])
    _, ref, _ = tf.decode_chunk(params, tf.init_cache(cfg, 3, 16, "cpu"), toks, pos0, take, cfg)
    _, out, _ = tf.decode_chunk(gpu, tf.init_cache(cfg, 3, 16, cuda), toks.to(cuda),
                                pos0.to(cuda), take.to(cuda), cfg)
    for row in range(3):
        cols = slice(0, int(take[row]))
        assert (out[row, cols].cpu() - ref[row, cols]).abs().max().item() <= 1e-3


def _precision_trace(cfg, n=8):
    """Images from a seed, even ids near-silent, every third pinned to fp32."""
    gen = torch.Generator().manual_seed(3)
    trace = []
    for i in range(n):
        img = torch.rand((cfg.img_hw, cfg.img_hw, cfg.in_ch), generator=gen)
        opts = {"source": "sparse" if i % 2 == 0 else "dense"}
        if i % 3 == 0:
            opts["pin_precision"] = "fp32"
        trace.append((img * 0.02 if i % 2 == 0 else img, opts))
    return trace


def _serve_adaptive(registry, cfg, trace, obs=None):
    controller = PrecisionController(pricer=make_snn_pricer(cfg), dense_threshold=0.8)
    sched = make_scheduler("sparsity")
    bind_controller(sched, controller)
    engine = EngineCore(PrecisionRunner(registry, controller),
                        EngineConfig(slots=2, scheduler="sparsity", precision="adaptive"),
                        scheduler=sched, obs=obs)
    ids = [engine.submit(img, **opts) for img, opts in trace]
    res = engine.run_until_complete()
    return [res[i] for i in ids], engine


@pytest.mark.cuda
def test_adaptive_serving_matches_single_precision_engines(cuda):
    cfg = vgg9_snn.TINY
    params = vgg9.init_vgg9(torch.Generator().manual_seed(0), cfg, "cpu")
    gpu_params = {k: {kk: v.to(cuda) for kk, v in leaf.items()} for k, leaf in params.items()}
    registry = make_snn_variants(cfg, gpu_params, device=cuda)
    registry.prewarm(2)
    trace = _precision_trace(cfg)
    reset_cuda_launches()
    res, engine = _serve_adaptive(registry, cfg, trace)
    torch.cuda.synchronize()
    launches = dict(CUDA_LAUNCHES)
    served = [r.stats["precision"] for r in res]
    assert set(served) == {"fp32", "int4"}
    assert all(served[i] == "fp32" for i, (_, o) in enumerate(trace) if "pin_precision" in o)
    by_id = {r.request_id: p for r, p in zip(res, served)}
    occupied = sum(len({by_id[i] for i in ids}) for _, ids in engine.admission_log)
    assert launches == {"dense_conv_lif": occupied, "spike_matmul_mapped": 3 * occupied,
                        "lif_epilogue_scan": 5 * occupied, "spike_matmul": 0, "lif_step": 0,
                        "int4_matmul": 0, "flash_attention": 0}
    for prec in registry.precisions:
        single = EngineCore(registry.runner(prec), EngineConfig(slots=2))
        ids = [single.submit(img, **opts) for img, opts in trace]
        ref = single.run_until_complete()
        for i, r in enumerate(res):
            if served[i] == prec:
                assert np.array_equal(r.outputs, ref[ids[i]].outputs), (prec, i)
    cpu = make_snn_variants(cfg, params, device="cpu")
    cpu_res, _ = _serve_adaptive(cpu, cfg, trace)
    assert [r.stats["precision"] for r in cpu_res] == served
    # at most one output spike flipped near theta (fp32 sums in other orders)
    one_spike = 1.0 / (cfg.timesteps * (cfg.population // cfg.num_classes))
    assert max(np.abs(a.outputs - b.outputs).max() for a, b in zip(res, cpu_res)) \
        <= one_spike + 1e-6


@pytest.mark.cuda
def test_adaptive_serving_with_obs_attached_is_bit_identical(cuda):
    cfg = vgg9_snn.TINY
    params = vgg9.init_vgg9(torch.Generator().manual_seed(0), cfg, cuda)
    registry = make_snn_variants(cfg, params, device=cuda)
    trace = _precision_trace(cfg)
    plain, engine = _serve_adaptive(registry, cfg, trace)
    bundle = Observability()
    observed, engine_obs = _serve_adaptive(registry, cfg, trace, obs=bundle)
    assert engine_obs.admission_log == engine.admission_log
    for a, b in zip(observed, plain):
        assert np.array_equal(a.outputs, b.outputs)
        assert dict(a.stats) == dict(b.stats)
    snap = bundle.metrics.snapshot()
    assert snap["precision_decisions"]["value"] == len(trace)
    assert snap["precision_served_energy_eq3_j"]["value"] > 0


def _fleet_images(n=9):
    rng = np.random.default_rng(5)
    return [rng.random((16, 16, 3)).astype(np.float32) * np.float32(0.02 if i % 2 == 0 else 1)
            for i in range(n)]


_FLEET_STATS = ("out_spikes", "in_spikes", "spike_total", "skip_rate", "ts_occupancy")


@pytest.mark.cuda
def test_fleet_chaos_on_card_bit_identical_to_solo(cuda):
    """TINY on the card: 3 in-process replicas, replica 0 wedged from its
    second step and replica 1 poisoning slot 0 at its third, the trace in
    three waves. Both drained, one request failed, every ok result bit for
    bit the solo engine's, and kernels 1-3 launched once per forward."""
    from repro_torch.serve.faults import parse_fleet_plan
    from repro_torch.serve.router import make_router
    from repro_torch.serve.runners.snn import SNNRunner
    cfg = vgg9_snn.TINY
    runner = SNNRunner(cfg, vgg9.init_vgg9(torch.Generator().manual_seed(0), cfg, cuda),
                       device=cuda)
    imgs = _fleet_images()
    solo = EngineCore(runner, EngineConfig(slots=2))
    ids = [solo.submit(img) for img in imgs]
    want = solo.run_until_complete()
    router = make_router(runner, 3, EngineConfig(slots=2),
                         plans=parse_fleet_plan("0=wedge@1,1=nan@2:slot=0"))
    reset_cuda_launches()
    rids = []
    for w in range(3):
        rids += [router.submit(img) for img in imgs[3 * w:3 * w + 3]]
        if w < 2:
            router.step()
    results = router.run_until_complete()
    assert sorted(e[2] for e in router.drain_log) == ["poisoned", "wedged"]
    assert [results[r].status for r in rids].count("failed") == 1
    for rid, i in zip(rids, ids):
        if results[rid].status == "ok":
            assert np.array_equal(results[rid].outputs, want[i].outputs)
            for key in _FLEET_STATS:
                assert results[rid].stats[key] == want[i].stats[key], key
    forwards = sum(1 for rep in router.replicas for k in range(rep.core._session.step_idx)
                   if rep.core._session.plan.active("wedge", k) is None)
    assert CUDA_LAUNCHES["dense_conv_lif"] == forwards > 0
    assert CUDA_LAUNCHES["spike_matmul_mapped"] == 3 * forwards


@pytest.mark.cuda
def test_worker_fleet_on_card_replays_bit_identical(cuda):
    """2 subprocess workers on the card from one TINY `snn_spec`; worker 0
    killed with a request in flight: every result equals the in-process
    engine's over ``build_runner(spec)`` bit for bit."""
    from repro_torch.serve.router import make_worker_fleet
    from repro_torch.serve.worker import build_runner, snn_spec
    spec = snn_spec(vgg9_snn.TINY, seed=0)
    assert spec.device == "cuda"
    config = EngineConfig(slots=2, max_idle_steps=50)
    imgs = _fleet_images(6)
    inproc = EngineCore(build_runner(spec), config)
    ids = [inproc.submit(img) for img in imgs]
    want = inproc.run_until_complete()
    router = make_worker_fleet(spec, 2, config)
    try:
        rids = [router.submit(img) for img in imgs]
        router.step()
        victim = router.replicas[0].transport
        assert victim.in_flight() > 0
        victim.kill()
        results = router.run_until_complete()
    finally:
        router.close()
    assert len(router.drain_log) == 1 and router.stats()["rerouted"] >= 1
    for rid, i in zip(rids, ids):
        assert results[rid].status == "ok"
        assert np.array_equal(results[rid].outputs, want[i].outputs)
        for key in _FLEET_STATS:
            assert results[rid].stats[key] == want[i].stats[key], key



@pytest.mark.cuda
def test_sharded_engine_on_two_shards_of_one_card_bit_identical_to_solo(cuda):
    """TINY through EngineCore + SNNRunner under an in-process data mesh of
    two shards, both on cuda:0: every result (logits, spike counts, skip
    rates, occupancy trace, energy) bit for bit the solo engine's, and
    kernels 1-3 launched twice per engine step."""
    from repro_torch.dist.context import compute_mesh
    from repro_torch.launch.mesh import DataMesh
    from repro_torch.serve.runners.snn import SNNRunner
    cfg = vgg9_snn.TINY
    runner = SNNRunner(cfg, vgg9.init_vgg9(torch.Generator().manual_seed(0), cfg, cuda),
                       device=cuda)
    imgs = _fleet_images(6)

    def serve():
        core = EngineCore(runner, EngineConfig(slots=4))
        ids = [core.submit(img) for img in imgs]
        done = core.run_until_complete()
        return core, [done[i] for i in ids]
    _, solo = serve()
    reset_cuda_launches()
    with compute_mesh(DataMesh(["cuda:0", "cuda:0"])):
        core, sharded = serve()
    steps = core.stats()["steps_run"]
    assert CUDA_LAUNCHES["dense_conv_lif"] == 2 * steps
    assert CUDA_LAUNCHES["spike_matmul_mapped"] == 2 * 3 * steps
    for a, b in zip(solo, sharded):
        assert np.array_equal(a.outputs, b.outputs)
        for key in _FLEET_STATS + ("energy_j",):
            assert a.stats[key] == b.stats[key], key


@pytest.mark.cuda
@pytest.mark.parametrize("per_channel", [False, True])
def test_compressed_psum_over_gloo_with_cuda_tensors_equals_cpu(cuda, per_channel):
    """`compressed_psum` on two gloo ranks holding CUDA tensors (both on
    cuda:0) against the same two ranks on the CPU: mean gradients and
    residuals bit for bit equal."""
    from torch_dist_workers import run_ranks
    rng = np.random.default_rng(3)
    shapes = {"w": (64, 48), "b": (48,), "stack": (3, 32, 16)}
    inputs = {"grads": {k: rng.normal(size=(2,) + s).astype(np.float32) for k, s in shapes.items()},
              "err": {k: (rng.normal(size=(2,) + s) * 1e-3).astype(np.float32)
                      for k, s in shapes.items()},
              "per_channel": per_channel}
    card = run_ranks("psum", 2, inputs, device="cuda")
    cpu = run_ranks("psum", 2, inputs, device="cpu")
    for a, b in zip(card, cpu):
        for part in ("mean", "err"):
            for k in shapes:
                assert np.array_equal(a[part][k], b[part][k]), (part, k)
    for k in shapes:
        assert np.array_equal(card[0]["mean"][k], card[1]["mean"][k])


@pytest.mark.cuda
def test_tensor_parallel_step_on_two_ranks_of_one_card_matches_cpu(cuda):
    """One AdamW step of a tiny dense LM on a (1, 2) mesh: two gloo ranks
    holding CUDA tensors on cuda:0 against the same two ranks on the CPU."""
    from torch_dist_workers import run_ranks
    from repro_torch.train.tree import tree_leaves_with_path, tree_map
    cfg = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
               head_dim=8, d_ff=64, vocab=64, dtype="float32", remat="none", q_chunk=8,
               kv_chunk=8)
    params = tf.init_params(torch.Generator().manual_seed(0), ArchConfig(**cfg), "cpu")
    rng = np.random.default_rng(0)
    inputs = {"cfg": cfg, "lr": 1e-3, "params": tree_map(lambda x: x.numpy(), params),
              "batch": {"tokens": rng.integers(0, 64, (4, 16)),
                        "labels": rng.integers(0, 64, (4, 16))}}
    card = run_ranks("tp_step", 2, inputs, device="cuda")
    cpu = run_ranks("tp_step", 2, inputs, device="cpu")
    for c, h in zip(card, cpu):
        assert c["layouts"] == h["layouts"] and any(
            local != whole for _, local, whole in c["layouts"].values())
        assert abs(c["loss"] - h["loss"]) <= 1e-5 * abs(h["loss"])
        assert abs(c["grad_norm"] - h["grad_norm"]) <= 1e-5 * h["grad_norm"]
        a = dict(tree_leaves_with_path(c["state"]["params"]))
        b = dict(tree_leaves_with_path(h["state"]["params"]))
        num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in b)
        den = sum(float(np.sum(b[k].astype(np.float64) ** 2)) for k in b)
        assert (num / den) ** 0.5 <= 1e-5
    assert card[0]["loss"] == card[1]["loss"]


@pytest.mark.cuda
@pytest.mark.parametrize("opt_name", ["sgd", "adamw", "adafactor"])
def test_donated_train_step_on_the_card_keeps_the_functional_bits(cuda, opt_name):
    """``make_train_step(donate=True)`` on the card (a reduced MoE LM, bf16,
    remat): the input state object returned, every leaf in its own buffer,
    the functional step's bits and loss; the functional step leaves its
    input unchanged."""
    from torch_dist_workers import donation_check
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import token_batch
    from repro_torch.train import optim, schedule
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.train.tree import tree_map
    cfg = get_arch("granite-moe-3b-a800m").with_(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64, moe_d_ff=32,
        n_experts=8, top_k=2, n_experts_padded=0, vocab=128, q_chunk=16, kv_chunk=16)
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    batch = token_batch(0, 0, 4, 32, cfg.vocab, "cuda")
    opt = optim.make_optimizer(opt_name)

    def step_fn(donate):
        return make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt,
                               schedule.constant(1e-3), donate=donate)
    state = init_train_state(params, opt)
    for _ in range(2):
        assert donation_check(step_fn, state, batch, lambda s: tree_map(
            lambda x: x.clone(), s)) == {"same_object": True, "same_buffers": True,
                                         "bits": True, "loss": True, "unchanged": True}
