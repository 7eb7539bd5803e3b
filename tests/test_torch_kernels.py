"""The port's kernel modules against the JAX kernels, and each CUDA kernel
against its plain PyTorch version.

CPU tests hand the same numpy inputs (made from a seed) to the JAX kernels
in interpret mode and to the port's wrappers on CPU tensors, which take the
plain versions. The hand kernels themselves are compared with their plain
versions on the card in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.dense_conv_lif import ops as jax_dense
from repro.kernels.dense_conv_lif.dense_conv_lif import dense_conv_lif as jax_dense_conv_lif
from repro.kernels.lif_step.ops import lif_epilogue as jax_lif_epilogue
from repro.kernels.spike_conv import ops as jax_sc
from repro.kernels.spike_conv.ref import im2col as jax_im2col
from repro_torch.kernels import CUDA_LAUNCHES, _build
from repro_torch.core.quant import unpack_int4
from repro_torch.kernels.dense_conv_lif import ops as dense_ops
from repro_torch.kernels.int4_matmul import ops as int4_ops
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.spike_conv import ops as sc_ops
from repro_torch.kernels.spike_conv.ref import im2col

BETA, THETA = 0.15, 0.5


def _spikes(seed, shape, density=0.1):
    return (np.random.default_rng(seed).random(shape) < density).astype(np.float32)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _assert_stats_equal(st, ref):
    assert set(st) == set(ref)
    for k, v in ref.items():
        a, b = np.asarray(v), st[k].numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, (k, b.dtype, a.dtype)
        np.testing.assert_array_equal(b, a, err_msg=k)


# ---------------------------------------------------------------------------
# im2col / occupancy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_im2col_exact(padding):
    x = _normal(0, (2, 7, 5, 3))
    ref = np.asarray(jax_im2col(jnp.asarray(x), 3, 3, padding))
    np.testing.assert_array_equal(im2col(torch.from_numpy(x), 3, 3, padding).numpy(), ref)


def test_occupancy_map_matches_reference():
    p = np.zeros((512, 256), np.float32)
    p[0, 0] = p[300, 200] = 1.0
    ref = np.asarray(jax_sc.occupancy_map(jnp.asarray(p), 256, 128))
    out = sc_ops.occupancy_map(torch.from_numpy(p), 256, 128).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == np.int32


# ---------------------------------------------------------------------------
# spike_conv2d_mapped
# ---------------------------------------------------------------------------

def _both_mapped(spikes, w, **kw):
    ref_out, ref_st = jax_sc.spike_conv2d_mapped(jnp.asarray(spikes), jnp.asarray(w),
                                                 interpret=True, **kw)
    out, st = sc_ops.spike_conv2d_mapped(torch.from_numpy(spikes), torch.from_numpy(w), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    _assert_stats_equal(st, ref_st)
    return out, st


@pytest.mark.parametrize("shape,cout,kw", [
    ((4, 16, 16, 8), 12, dict(block_m=128)),
    ((4, 8, 8, 12), 16, dict(block_m=128, block_k=128, block_n=128)),
    ((3, 6, 6, 16), 16, dict(block_m=256)),                 # M not a tile multiple
    ((2, 16, 16, 8), 12, dict(block_m=128, gate=False)),
])
def test_spike_conv2d_mapped_matches_reference(shape, cout, kw):
    spikes = _spikes(1, shape)
    spikes[0] = 0.0                                          # a silent image
    w = _normal(2, (3, 3, shape[-1], cout))
    _both_mapped(spikes, w, **kw)


def test_known_empty_tiles_report_expected_skip_rate():
    """Image 0 all-zero, image 1 all-one: its 256 im2col rows fill exactly
    two 128-row tiles, so the occupancy map must skip exactly half."""
    spikes = np.concatenate([np.zeros((1, 16, 16, 8), np.float32),
                             np.ones((1, 16, 16, 8), np.float32)])
    out, st = _both_mapped(spikes, _normal(3, (3, 3, 8, 16)), block_m=128)
    assert float(st["tiles_total"]) == 4.0
    assert float(st["tiles_occupied"]) == 2.0
    assert float(st["skip_rate"]) == 0.5
    assert float(out[0].abs().max()) == 0.0


def test_all_empty_input_skips_everything():
    spikes = np.zeros((1, 16, 16, 8), np.float32)
    out, st = _both_mapped(spikes, _normal(4, (3, 3, 8, 16)))
    assert float(st["skip_rate"]) == 1.0
    assert float(out.abs().max()) == 0.0


def test_mapped_wrapper_counts_calls_not_cuda_launches():
    sc_ops.reset_launch_counts()
    before = dict(CUDA_LAUNCHES)
    sc_ops.spike_conv2d_mapped(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 8))
    assert sc_ops.launch_counts() == {"spike_matmul_mapped": 1}
    assert dict(CUDA_LAUNCHES) == before                   # the plain path ran


# ---------------------------------------------------------------------------
# the event-driven product's bitmask, sum order and geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.0, 0.1, 0.33, 1.0])
def test_spike_bitmask_plain_matches_packbits(density):
    p = _spikes(30, (96, 256), density)
    p[5, 31] = p[6, 63] = 1.0                                # bit 31 of a word
    p[7, :] = 0.0
    ref = np.packbits(p != 0, axis=1, bitorder="little").view("<u4").view(np.int32)
    out = sc_ops.spike_bitmask_plain(torch.from_numpy(p))
    assert out.dtype == torch.int32 and out.shape == (96, 256 // 32)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("density", [0.1, 0.33, 1.0])
def test_spike_matmul_event_plain_matches_mapped_plain(density):
    p = _spikes(31, (256, 384), density)
    p[:128] = 0.0                                            # an all-zero tile row
    w = _normal(32, (384, 128))
    out = sc_ops.spike_matmul_event_plain(torch.from_numpy(p), torch.from_numpy(w))
    ref, _, _ = sc_ops.spike_matmul_mapped_plain(torch.from_numpy(p), torch.from_numpy(w),
                                                 block_m=128, block_k=128)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    assert out[:128].abs().max().item() == 0.0


def test_spike_matmul_event_plain_sums_k_ascending():
    """Each element is the fp32 sum of the selected weights, k ascending,
    from +0: the numpy loop in that order gives the same bits."""
    p = _spikes(33, (64, 160), 0.4)
    w = _normal(34, (160, 64), 1e3) * np.float32(1 + 2 ** -20)
    acc = np.zeros((64, 64), np.float32)
    for k in range(160):
        acc = acc + np.where(p[:, k:k + 1] != 0, w[k], np.float32(0))
    out = sc_ops.spike_matmul_event_plain(torch.from_numpy(p), torch.from_numpy(w))
    np.testing.assert_array_equal(out.numpy(), acc)


def test_spike_matmul_event_plain_matches_jax_kernel():
    """The port's order-exact product against the JAX package's
    `spike_matmul_mapped` in interpret mode, on the same occupancy map."""
    from repro.kernels.spike_conv.spike_conv import spike_matmul_mapped as jax_mapped
    p = _spikes(35, (256, 256), 0.2)
    p[128:, 128:] = 0.0
    w = _normal(36, (256, 128))
    occ = jax_sc.occupancy_map(jnp.asarray(p), 128, 128)
    ref = np.asarray(jax_mapped(jnp.asarray(p), jnp.asarray(w), occ,
                                jax_sc.skip_load_indices(occ), block_m=128,
                                block_k=128, block_n=128, interpret=True))
    out = sc_ops.spike_matmul_event_plain(torch.from_numpy(p), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("m,k,n", [(16384, 640, 128), (4096, 1024, 256), (4096, 1792, 256),
                                   (1024, 2048, 512), (1024, 4352, 512), (1024, 4608, 640)])
def test_event_geometry_fills_the_card_at_served_shapes(m, k, n):
    rows, cols = sc_ops.event_geometry(m, k, n, 128, 128)
    assert m % rows == 0 and n % cols == 0
    assert (m // rows) * (n // cols) >= sc_ops.H100_SMS
    assert sc_ops.event_smem_bytes(rows, cols, k) <= sc_ops.EVENT_MAX_SMEM


@pytest.mark.parametrize("m,k,n,block_m,block_k,match", [
    (1000, 640, 128, 128, 128, "M % block_m"),            # M not a tile multiple
    (1024, 600, 128, 128, 128, "K % block_k"),
    (1024, 640, 128, 128, 80, "block_k % 32"),              # a word would straddle tiles
    (1024, 640, 96, 128, 128, "N % 64"),
    (1000, 640, 128, 8, 128, "M % 16"),                     # no 16-row block
    (1024, 4_194_304, 128, 128, 128, "shared memory"),      # the word list cannot fit
])
def test_event_geometry_refuses_what_the_kernel_does_not_take(m, k, n, block_m, block_k,
                                                               match):
    with pytest.raises(ValueError, match=match):
        sc_ops.event_geometry(m, k, n, block_m, block_k)


def test_event_geometry_takes_the_most_blocks_when_none_fills_the_card():
    assert sc_ops.event_geometry(256, 128, 64, 128, 128) == (16, 64)


# the unfused pipeline's per-timestep (M_pad, K_pad, N_pad) at 8 images
UNFUSED_SHAPES = [(8192, 640, 128), (2048, 1024, 256), (2048, 1792, 256),
                  (512, 2048, 512), (512, 4352, 512), (512, 4608, 640)]


@pytest.mark.parametrize("m,k,n", UNFUSED_SHAPES)
def test_gated_geometry_fills_the_card_at_served_shapes(m, k, n):
    geometry = sc_ops.gated_geometry(m, k, n)
    assert m % geometry[0] == 0 and n % geometry[1] == 0
    assert sc_ops.gated_blocks(geometry, m, n) >= sc_ops.H100_SMS


def test_gated_geometry_takes_the_card_test_shape():
    rows, cols, _, _ = geometry = sc_ops.gated_geometry(256, 128, 128)
    assert geometry in sc_ops.GATED_GEOMETRIES and 256 % rows == 0 and 128 % cols == 0
    assert sc_ops.gated_blocks(geometry, 256, 128) == max(
        sc_ops.gated_blocks(g, 256, 128) for g in sc_ops.GATED_GEOMETRIES
        if 256 % g[0] == 0 and 128 % g[1] == 0)


@pytest.mark.parametrize("m,k,n,geometry,match", [
    (1000, 640, 128, None, "M % 64"),
    (1024, 600, 128, None, "K % 32"),
    (1024, 640, 96, None, "N % 64"),
    (0, 640, 128, None, "M % 64"),
    (1024, 640, 64, (32, 128, 2, 4), "does not fit"),       # 128 columns in N = 64
    (1024, 640, 128, (32, 128, 3, 4), "does not fit"),      # not in the table
])
def test_gated_geometry_refuses_what_the_kernel_does_not_take(m, k, n, geometry, match):
    before = dict(CUDA_LAUNCHES)
    with pytest.raises(ValueError, match=match):
        sc_ops.gated_geometry(m, k, n, sc_ops.H100_SMS, geometry)
    assert CUDA_LAUNCHES == before


def test_gated_geometries_are_the_ones_the_kernel_instantiates():
    """The table in ops.py against the GEOMETRY(...) lines of spike_matmul.cu,
    each a whole number of consumer warps (at most 16, beside the producer)
    whose lanes cover the block's columns."""
    import re
    src = (_build.PACKAGE_DIR / "kernels/spike_conv/csrc/spike_matmul.cu").read_text()
    built = [tuple(map(int, g)) for g in
             re.findall(r"^\s*GEOMETRY\((\d+), (\d+), (\d+), (\d+)\)", src, re.M)]
    assert built == list(sc_ops.GATED_GEOMETRIES)
    for rows, cols, r, c in built:
        assert rows % r == 0 and cols % (32 * c) == 0 and c in (2, 4) and r in (1, 2, 4)
        assert 1 <= (rows // r) * (cols // (32 * c)) <= 16


# ---------------------------------------------------------------------------
# int4_matmul: the plain mirrors of the kernel's conversions, and its picker
# ---------------------------------------------------------------------------

_NORMAL_F32 = st.floats(min_value=2.0 ** -100, max_value=2.0 ** 100, width=32)
_F32 = st.one_of(_NORMAL_F32, _NORMAL_F32.map(lambda v: -v), st.sampled_from([0.0, -0.0]),
                 st.integers(-100, 100).map(lambda e: float(2.0 ** e)))


@settings(max_examples=60, deadline=None)
@given(st.lists(_F32, min_size=1, max_size=64))
def test_split_bf16x3_is_exact(values):
    """hi + mid + lo == x bit for bit over normal fp32 values (summed in
    fp64, and in fp32 in the kernel's order), and each term's product with
    every int4 value -8..7 is exact in fp32."""
    x = torch.tensor(values, dtype=torch.float32)
    hi, mid, lo = int4_ops.split_bf16x3_plain(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    for term in (hi, mid, lo):
        for v in range(-8, 8):
            assert torch.equal((term.float() * v).double(), term.double() * v)


def test_split_bf16x3_terms_shrink():
    x = torch.from_numpy(_normal(40, (4096,)))
    hi, mid, lo = int4_ops.split_bf16x3_plain(x)
    assert torch.equal(hi, x.bfloat16())
    assert bool(((mid.float().abs() <= hi.float().abs() * 2.0 ** -8)).all())
    assert bool(((lo.float().abs() <= mid.float().abs() * 2.0 ** -8)).all())


def test_nibble_conversion_gives_every_signed_value():
    """0x4300 | (nibble ^ 8) - 136 in bf16, for all 16 nibbles, and for both
    nibbles of all 256 bytes against `unpack_int4`."""
    vals = int4_ops.nibble_bf16_plain(torch.arange(16))
    assert vals.dtype == torch.bfloat16
    assert vals.float().tolist() == list(range(8)) + list(range(-8, 0))
    packed = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8).reshape(1, 256)
    byte = packed.to(torch.int32) & 0xFF
    conv = torch.stack([int4_ops.nibble_bf16_plain(byte & 0xF),
                        int4_ops.nibble_bf16_plain(byte >> 4)], -1).reshape(1, 512)
    assert torch.equal(conv.float(), unpack_int4(packed, (1, 512)).float())


QWEN_INT4 = [(4, 2560, 2560), (512, 2560, 2560), (4, 2560, 6912), (512, 2560, 6912),
             (4, 6912, 2560), (512, 6912, 2560), (4, 2560, 151936), (4, 2560, 256)]


@pytest.mark.parametrize("m,k,n", QWEN_INT4)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_plan_fills_the_card_at_qwen_shapes(m, k, n, dtype):
    """A consumer warpgroup for every SM (a block of two takes an SM alone)."""
    plan = int4_ops.int4_plan(m, k, n, dtype)
    assert plan.path == "tma" and plan.ctas * plan.warpgroups >= int4_ops.H100_SMS
    assert plan.geometry in int4_ops.INT4_GEOMETRIES
    assert plan.splits == int4_ops.int4_splits(k, n)


@pytest.mark.parametrize("k,n", sorted({(k, n) for _, k, n in QWEN_INT4} | {(96, 160), (8, 32)}))
def test_int4_splits_depend_on_k_and_n_alone(k, n):
    """The ranges of K, and so each row's sum, are the same at every M."""
    for dtype in (torch.float32, torch.bfloat16):
        plans = [int4_ops.int4_plan(m, k, n, dtype, sms) for m in (1, 4, 17, 512)
                 for sms in (1, 132, 10 ** 6)]
        assert {p.splits for p in plans} == {int4_ops.int4_splits(k, n)}
        assert 1 <= plans[0].splits <= -(-k // int4_ops.UNIT_K)


@pytest.mark.parametrize("m,k,n,dtype,path", [
    (17, 96, 130, torch.float32, "ragged"), (17, 96, 130, torch.bfloat16, "ragged"),
    (5, 33, 18, torch.float32, "ragged"), (5, 33, 18, torch.bfloat16, "ragged"),
    (9, 68, 96, torch.float32, "tma"), (9, 68, 96, torch.bfloat16, "ragged"),
    (9, 67, 96, torch.float32, "tma"), (9, 72, 96, torch.bfloat16, "tma"),
    (7, 67, 50, torch.float32, "ragged"), (3, 0, 64, torch.float32, "ragged"),
    (4, 2560, 256, torch.bfloat16, "tma"), (4, 2564, 256, torch.bfloat16, "ragged")])
def test_int4_plan_takes_tma_only_where_it_can(m, k, n, dtype, path):
    """16-byte row strides: N % 32 for packed, K % 8 for bf16 x (fp32 x's
    planes are padded); ragged shapes have no geometry to override."""
    plan = int4_ops.int4_plan(m, k, n, dtype)
    assert plan.path == path
    if path == "ragged":
        assert plan.scratch_bytes == 0 and plan.ctas == -(-n // 256) * -(-m // 4)
        with pytest.raises(ValueError, match="ragged path"):
            int4_ops.int4_plan(m, k, n, dtype, geometry=int4_ops.INT4_GEOMETRIES[0])


@pytest.mark.parametrize("m,k,n", QWEN_INT4 + [(9, 68, 96), (17, 2560, 2564), (17, 2564, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_plan_scratch_bytes(m, k, n, dtype):
    """fp32 x's three bf16 planes, rows padded to 8; split mode's partial
    sums, one [M, N] fp32 per range; nothing else."""
    plan = int4_ops.int4_plan(m, k, n, dtype)
    if plan.path == "ragged":
        assert plan.scratch_bytes == 0
        return
    assert plan.planes_bytes == (0 if dtype == torch.bfloat16 else 3 * m * (-(-k // 8) * 8) * 2)
    assert plan.partial_bytes == (0 if plan.whole else 4 * plan.splits * m * n)
    assert plan.whole or plan.splits > 1


def test_int4_plan_modes():
    # decode width: four ranges of K, one block each, summed by a second pass
    plan = int4_ops.int4_plan(4, 2560, 2560, torch.float32)
    assert (plan.splits, plan.whole, plan.partial_bytes) == (4, False, 4 * 4 * 4 * 2560)
    assert plan.planes_bytes == 3 * 4 * 2560 * 2
    # prefill width: every block walks the four ranges, no partial sums
    plan = int4_ops.int4_plan(512, 2560, 2560, torch.float32)
    assert (plan.token_width, plan.whole, plan.partial_bytes) == (128, True, 0)
    # the LM head: one range, no partial sums
    plan = int4_ops.int4_plan(4, 2560, 151936, torch.float32)
    assert (plan.splits, plan.whole, plan.partial_bytes) == (1, True, 0)
    # a card of one SM: every block walks every range
    assert int4_ops.int4_plan(512, 2560, 2560, torch.bfloat16, sms=1).whole
    # a card too large to fill: the most blocks, a block per range
    plan = int4_ops.int4_plan(4, 2560, 2560, torch.bfloat16, sms=10 ** 6)
    assert not plan.whole and plan.ctas == max(
        int4_ops.int4_plan(4, 2560, 2560, torch.bfloat16, 10 ** 6, g).ctas
        for g in int4_ops.DECODE_GEOMETRIES)


def test_int4_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no kernel for geometry"):
        int4_ops.int4_plan(4, 2560, 2560, torch.float32, geometry=(16, 2, 1, 4))
    with pytest.raises(ValueError, match="splits of K"):
        int4_ops.int4_plan(4, 128, 2560, torch.float32, splits=3)


def test_int4_geometries_are_the_ones_the_kernel_instantiates():
    """The table in ops.py against the GEOMETRY(...) lines of int4_matmul.cu;
    the picker's preferences are among them."""
    import re
    src = (_build.PACKAGE_DIR / "kernels/int4_matmul/csrc/int4_matmul.cu").read_text()
    built = [tuple(map(int, g)) for g in
             re.findall(r"^\s*GEOMETRY\((\d+), (\d+), (\d+), (\d+)\)", src, re.M)]
    assert built == list(int4_ops.INT4_GEOMETRIES)
    assert set(int4_ops.DECODE_GEOMETRIES + int4_ops.PREFILL_GEOMETRIES) <= set(built)
    for tn, c, t, stages in built:
        assert tn in (8, 64, 128) and c in (1, 2) and t in (1, 2) and stages >= 2
        assert 32 * c * t in (32, 64, 128)          # a packed row is one swizzle span


def test_build_covers_every_counted_kernel():
    assert sorted(p.name for p in _build.sources()) == [
        "dense_conv_lif.cu", "flash_attention.cu", "int4_matmul.cu", "lif_epilogue_scan.cu",
        "lif_step.cu", "spike_matmul.cu", "spike_matmul_mapped.cu"]
    assert set(CUDA_LAUNCHES) == {p.stem for p in _build.sources()}


def test_build_digest_keys_on_every_csrc_file(monkeypatch, tmp_path):
    csrc = tmp_path / "kernels" / "k" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(_build, "PACKAGE_DIR", tmp_path)
    before = _build._digest()
    assert [p.name for p in _build.sources()] == ["k.cu"]
    # a header is not compiled on its own, but an edit to it rebuilds
    (csrc / "k.cuh").write_text("// header\n")
    assert [p.name for p in _build.sources()] == ["k.cu"]
    added = _build._digest()
    (csrc / "k.cuh").write_text("// header, edited\n")
    assert len({before, added, _build._digest()}) == 3


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_failure_carries_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build()
    assert not list((tmp_path / "build").rglob(_build.LIB_NAME))


def test_cuda_operand_checks_refuse_host_tensors():
    with pytest.raises(ValueError, match="not a CUDA device"):
        _build.check_cuda_operands("k", x=torch.zeros(4))


def test_cuda_operand_checks_refuse_wrong_dtypes_before_any_launch():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.int4_matmul import ops as int4_ops
    before = dict(CUDA_LAUNCHES)
    x, packed, scale = torch.zeros((4, 8)), torch.zeros((8, 4), dtype=torch.int8), torch.ones(8)
    # kernels 1-5 still take float32 only
    with pytest.raises(TypeError, match="patches must be one of"):
        sc_ops._spike_matmul_cuda(x.double(), x, gate=True)
    # int4_matmul: x float32 or bf16, packed int8
    with pytest.raises(TypeError, match="x must be one of"):
        int4_ops._int4_matmul_cuda(x.half(), packed, scale)
    with pytest.raises(TypeError, match="packed must be one of"):
        int4_ops._int4_matmul_cuda(x, packed.to(torch.uint8), scale)
    # flash_attention: q/k/v float32 or bf16
    q = torch.zeros((2, 16, 64))
    with pytest.raises(TypeError, match="k must be one of"):
        flash_ops._flash_attention_cuda(q, q.double(), q)
    # the dtypes the kernels take pass the dtype check, and fail on the device
    with pytest.raises(ValueError, match="not a CUDA device"):
        int4_ops._int4_matmul_cuda(x.bfloat16(), packed, scale)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_ops._flash_attention_cuda(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert CUDA_LAUNCHES == before


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty((128, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sc_ops.spike_matmul_mapped(meta, meta, block_m=128, block_k=128)
    with pytest.raises(ValueError, match="no kernel"):
        lif_ops.lif_epilogue_scan(torch.empty((2, 4, 8), device="meta"),
                                  torch.empty((8,), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        dense_ops.dense_conv_lif(torch.empty((8, 27), device="meta"),
                                 torch.empty((27, 8), device="meta"),
                                 torch.empty((8,), device="meta"),
                                 num_steps=2, beta=BETA, theta=THETA)


def test_unfused_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty((128, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sc_ops.spike_matmul(meta, meta)
    with pytest.raises(ValueError, match="no kernel"):
        lif_ops.lif_update(meta, meta, meta, beta=BETA, theta=THETA)


# ---------------------------------------------------------------------------
# LIF epilogue
# ---------------------------------------------------------------------------

def test_lif_epilogue_step_bit_exact():
    u, cur = _normal(5, (96, 40)), _normal(6, (96, 40))
    s = _spikes(7, (96, 40), 0.3)
    b = _normal(8, (40,), 0.1)
    ju, js = jax_lif_epilogue(*map(jnp.asarray, (u, cur, s, b)), beta=BETA, theta=THETA,
                              interpret=True)
    tu, ts = lif_ops.lif_epilogue(*map(torch.from_numpy, (u, cur, s, b)),
                                  beta=BETA, theta=THETA)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("steps,rows,n", [(2, 64, 24), (4, 37, 130), (2, 8, 1064),
                                         (2, 16, 112), (25, 6, 24), (2, 4, 5000),
                                         (1, 9, 37), (25, 3, 6)])
def test_lif_epilogue_scan_matches_lax_scan(steps, rows, n):
    cur = _normal(9, (steps, rows, n), 0.6)
    b = _normal(10, (n,), 0.1)
    bias = jnp.asarray(b)

    def step(carry, c):
        u, s = jax_lif_epilogue(carry[0], c, carry[1], bias, beta=BETA, theta=THETA,
                                interpret=True)
        return (u, s), s

    zeros = jnp.zeros((rows, n), jnp.float32)
    _, ref = jax.lax.scan(step, (zeros, zeros), jnp.asarray(cur))
    out = lif_ops.lif_epilogue_scan(torch.from_numpy(cur), torch.from_numpy(b),
                                    beta=BETA, theta=THETA)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# the served epilogues' (R, N) at CIFAR10, 8 slots, T = 2 (conv1-6, fc0, fc1)
SERVED_EPILOGUES = [(8192, 112), (2048, 192), (2048, 216), (512, 480), (512, 504),
                    (512, 560), (8, 1064), (8, 1000)]


@pytest.mark.parametrize("rows,n", SERVED_EPILOGUES)
def test_epilogue_geometry_at_served_shapes(rows, n):
    vector, blocks = lif_ops.epilogue_geometry(rows, n, 2)
    groups = rows * n // 4
    assert vector and blocks == -(-groups // lif_ops.EPILOGUE_THREADS)
    if groups >= lif_ops.EPILOGUE_THREADS * _build.H100_SMS:      # the convs fill the card
        assert blocks >= _build.H100_SMS


def test_epilogue_geometry_paths():
    assert lif_ops.epilogue_geometry(100, 37, 3) == (False, 15)      # scalar, T not unrolled
    assert lif_ops.epilogue_geometry(8192, 112, 25) == (True, 896)
    assert lif_ops.epilogue_geometry(8192, 112, 2) == (True, 896)
    assert lif_ops.epilogue_geometry(8, 1064, 2) == (True, 9)
    assert lif_ops.epilogue_geometry(3, 6, 1) == (False, 1)
    # past 2^20 blocks the threads loop over the rest
    assert lif_ops.epilogue_geometry(1 << 20, 1024, 2) == (True, lif_ops.EPILOGUE_MAX_BLOCKS)


@pytest.mark.parametrize("rows,n,steps", [(0, 112, 2), (8, 0, 2), (8, 112, 0)])
def test_epilogue_geometry_refuses_what_the_kernel_does_not_take(rows, n, steps):
    with pytest.raises(ValueError, match="unsupported shape"):
        lif_ops.epilogue_geometry(rows, n, steps)


def test_epilogue_geometry_tables_are_the_ones_the_kernel_instantiates():
    import re
    src = (_build.PACKAGE_DIR / "kernels/lif_step/csrc/lif_epilogue_scan.cu").read_text()
    steps = [int(t) for t in re.findall(r"case (\d+): kernel = &lif_epilogue_kernel<V, \1>;",
                                        src)]
    assert steps == list(lif_ops.EPILOGUE_UNROLLED_STEPS)
    assert f"kThreads = {lif_ops.EPILOGUE_THREADS};" in src


# ---------------------------------------------------------------------------
# Dense core
# ---------------------------------------------------------------------------

def _ordered_numpy(p, w, b, steps):
    """The kernel's order in numpy float32: k ascending, each product and sum
    rounded, then the bias; the LIF sum rounded once (float64 then float32)."""
    acc = np.zeros((p.shape[0], w.shape[1]), np.float32)
    for kk in range(p.shape[1]):
        acc = (acc + (p[:, kk:kk + 1] * w[kk]).astype(np.float32)).astype(np.float32)
    cur = (acc + b).astype(np.float32)
    u = np.zeros_like(cur)
    s = np.zeros_like(cur)
    out = []
    for _ in range(steps):
        u = ((np.float64(np.float32(BETA)) * u.astype(np.float64) + cur.astype(np.float64))
             .astype(np.float32) - s * np.float32(THETA)).astype(np.float32)
        s = (u > THETA).astype(np.float32)
        out.append(s)
    return np.stack(out), u


@pytest.mark.parametrize("m,k,n,steps", [(200, 27, 64, 2), (37, 75, 40, 3), (16, 27, 6, 1)])
def test_dense_conv_lif_ordered_plain_matches_numpy_loop(m, k, n, steps):
    p = np.random.default_rng(21).random((m, k)).astype(np.float32)
    w, b = _normal(22, (k, n), 0.3), _normal(23, (n,), 0.1)
    rs, ru = _ordered_numpy(p, w, b, steps)
    ts, tu = dense_ops.dense_conv_lif_ordered_plain(
        *map(torch.from_numpy, (p, w, b)), num_steps=steps, beta=BETA, theta=THETA)
    np.testing.assert_array_equal(tu.numpy(), ru)
    np.testing.assert_array_equal(ts.numpy(), rs)


def test_dense_conv_lif_ordered_plain_matches_jax_kernel():
    """u within 1e-5 of the JAX kernel (interpret mode; its dot sums in
    another order), spikes equal wherever u_t is clear of theta."""
    m, k, n, steps = 256, 27, 64, 2
    p = np.random.default_rng(24).random((m, k)).astype(np.float32)
    w, b = _normal(25, (k, n), 0.3), _normal(26, (n,), 0.1)
    js, ju = jax_dense_conv_lif(*map(jnp.asarray, (p, w, b)), num_steps=steps, beta=BETA,
                                theta=THETA, block_m=128, block_n=64, interpret=True)
    args = tuple(map(torch.from_numpy, (p, w, b)))
    ts, tu = dense_ops.dense_conv_lif_ordered_plain(*args, num_steps=steps, beta=BETA,
                                                    theta=THETA)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-5)
    for t in range(steps):
        _, u_t = dense_ops.dense_conv_lif_ordered_plain(*args, num_steps=t + 1, beta=BETA,
                                                        theta=THETA)
        clear = np.abs(u_t.numpy() - THETA) > 1e-5
        np.testing.assert_array_equal(ts[t].numpy()[clear], np.asarray(js)[t][clear])


def test_dense_geometry_at_the_served_shape():
    rows, per, threads, blocks = dense_ops.dense_geometry(8192, 27, 64)
    assert (rows, per, threads) == dense_ops.DENSE_GEOMETRY
    assert blocks == 8192 // rows >= _build.H100_SMS
    assert dense_ops.dense_smem_bytes(rows, 27, 64) <= dense_ops.SMEM_LIMIT_BYTES


def test_dense_geometry_small_and_scalar_shapes():
    # a tail block; N = 40: 8 row lanes x 10 channel groups, threads cut to 96
    assert dense_ops.dense_geometry(100, 27, 40) == (32, 4, 96, 4)
    # N % 4 != 0: one channel a thread, threads cut to the block's 8 x 6 tiles
    assert dense_ops.dense_geometry(64, 27, 6) == (32, 4, 64, 2)


@pytest.mark.parametrize("m,k,n,match", [
    (0, 27, 64, "unsupported shape"),
    (64, 0, 64, "unsupported shape"),
    (64, 27, 440, "shared memory"),              # w, bias and 32 patch rows > 48 KB
    (64, 200, 32, "shared memory"),              # the 32 x 200 patch tile and w > 48 KB
])
def test_dense_geometry_refuses_what_the_kernel_does_not_take(m, k, n, match):
    with pytest.raises(ValueError, match=match):
        dense_ops.dense_geometry(m, k, n)


def test_dense_geometries_are_the_ones_the_kernel_instantiates():
    import re
    src = (_build.PACKAGE_DIR / "kernels/dense_conv_lif/csrc/dense_conv_lif.cu").read_text()
    built = [tuple(map(int, g)) for g in re.findall(r"^\s*GEOMETRY\((\d+), (\d+)\)", src, re.M)]
    rows, per, threads = dense_ops.DENSE_GEOMETRY
    assert built == [(rows, per)]
    assert rows % 4 == 0 and rows % per == 0 and threads <= 256 and threads % 32 == 0

@pytest.mark.parametrize("b,hw,cout,blocks", [(2, 16, 8, (256, 128)), (3, 5, 64, (128, 128))])
def test_input_layer_conv_lif_matches_reference(b, hw, cout, blocks):
    img = np.random.default_rng(11).random((b, hw, hw, 3)).astype(np.float32)
    w = _normal(12, (3, 3, 3, cout), 0.5)
    bias = _normal(13, (cout,), 0.1)
    block_m, block_n = blocks
    jax_dense.reset_launch_counts()
    dense_ops.reset_launch_counts()
    js, ju = jax_dense.input_layer_conv_lif(
        *map(jnp.asarray, (img, w, bias)), num_steps=2, beta=BETA, theta=THETA,
        block_m=block_m, block_n=block_n, interpret=True)
    ts, tu = dense_ops.input_layer_conv_lif(
        *map(torch.from_numpy, (img, w, bias)), num_steps=2, beta=BETA, theta=THETA,
        block_m=block_m, block_n=block_n)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-5)
    assert dense_ops.LAUNCH_LOG == jax_dense.LAUNCH_LOG
    assert dense_ops.launch_counts() == jax_dense.launch_counts() == {"dense_conv_lif": 1}
