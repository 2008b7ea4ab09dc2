"""Parity of the PyTorch port's kernels, d4 transforms and tiling geometry
with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them.  Tensors are NCHW in the port and NHWC in the JAX package; the tests
transpose between the two.  The CUDA kernels themselves are tested in
``test_torch_cuda.py``.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.inference import functional as JF
from pytorch_toolbelt_tpu.inference import tta as JT
from pytorch_toolbelt_tpu.inference.tiles import ImageSlicer as JImageSlicer
from pytorch_toolbelt_tpu.inference.tiles import accumulate_tiles as j_accumulate_tiles
from pytorch_toolbelt_tpu.nn import functional as JNF
from pytorch_toolbelt_tpu.ops import conv_kernels as JK
from pytorch_toolbelt_tpu.ops import pallas_grid_merge as j_pallas_grid_merge
from pytorch_toolbelt_tpu_torch.inference import functional as TF
from pytorch_toolbelt_tpu_torch.inference import tta as TT
from pytorch_toolbelt_tpu_torch.inference.tiles import ImageSlicer as TImageSlicer
from pytorch_toolbelt_tpu_torch.nn import functional as TNF
from pytorch_toolbelt_tpu_torch.ops import (
    conv3x3,
    detect_regular_grid,
    fold_batchnorm,
    grid_merge,
    grid_merge_reference,
    pack_conv3x3_weights,
)
from pytorch_toolbelt_tpu_torch.ops.conv_kernels import _pack_wmma, _unpack

REPO = Path(__file__).resolve().parent.parent


def nhwc_to_nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nchw_to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# d4 transforms: bit-equal
# ---------------------------------------------------------------------------

_PRIMITIVES = [
    "image_none", "image_rot90_ccw", "image_rot90_cw", "image_rot180", "image_fliplr", "image_flipud",
    "image_transpose", "image_rot90_ccw_transpose", "image_rot90_cw_transpose", "image_rot180_transpose",
    "image_transpose_rot90_ccw", "image_transpose_rot90_cw", "image_transpose_rot180",
]


@pytest.mark.parametrize("name", _PRIMITIVES)
def test_d4_primitives_bit_equal(name):
    x = np.random.RandomState(0).rand(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(getattr(JF, name)(jnp.asarray(x)))
    got = nchw_to_nhwc(getattr(TF, name)(nhwc_to_nchw(x)))
    np.testing.assert_array_equal(got, want)


def test_d4_augment_deaugment_bit_equal():
    rng = np.random.RandomState(1)
    x = rng.rand(2, 6, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(
        nchw_to_nhwc(TT.d4_image_augment(nhwc_to_nchw(x))), np.asarray(JT.d4_image_augment(jnp.asarray(x)))
    )
    y = rng.rand(16, 6, 6, 2).astype(np.float32)
    np.testing.assert_array_equal(
        nchw_to_nhwc(TT.d4_image_deaugment(nhwc_to_nchw(y), reduction=None).flatten(0, 1)),
        np.asarray(JT.d4_image_deaugment(jnp.asarray(y), reduction=None)).reshape(-1, 6, 6, 2),
    )


@pytest.mark.parametrize("views", [(0, 2), (1, 3), (4, 6), (5, 7), (3, 0, 6)])
def test_d4_view_subsets_bit_equal(views):
    rng = np.random.RandomState(2)
    x = rng.rand(3, 8, 8, 2).astype(np.float32)
    aug_t = TT.d4_image_augment_views(nhwc_to_nchw(x), views)
    np.testing.assert_array_equal(nchw_to_nhwc(aug_t), np.asarray(JT.d4_image_augment_views(jnp.asarray(x), views)))
    y = rng.rand(3 * len(views), 8, 8, 2).astype(np.float32)
    np.testing.assert_array_equal(
        nchw_to_nhwc(TT.d4_image_deaugment_views(nhwc_to_nchw(y), views, reduction=None).flatten(0, 1)),
        np.asarray(JT.d4_image_deaugment_views(jnp.asarray(y), views, reduction=None)).reshape(-1, 8, 8, 2),
    )


@pytest.mark.parametrize("reduction", ["mean", "sum", "gmean", "hmean", "harmonic1p", "logodd", "log1p"])
def test_deaugment_reductions_match(reduction):
    y = np.random.RandomState(3).uniform(0.05, 0.95, (16, 6, 6, 2)).astype(np.float32)
    want = np.asarray(JT.d4_image_deaugment(jnp.asarray(y), reduction=reduction))
    got = nchw_to_nhwc(TT.d4_image_deaugment(nhwc_to_nchw(y), reduction=reduction))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_d4_image2mask_roundtrip_of_equivariant_model():
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 3, 8, 8).astype(np.float32))
    out = TT.d4_image2mask(lambda t: t * 2.0, x)
    torch.testing.assert_close(out, x * 2.0, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        TT.d4_image_augment(torch.zeros(1, 1, 4, 5))


# ---------------------------------------------------------------------------
# ImageSlicer geometry and pyramid window: bit-equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,tile,step,weight",
    [((100, 90), 32, 16, "pyramid"), ((5000, 5000), 512, 256, "pyramid"), ((123, 77), (40, 24), (20, 12), "mean"),
     ((500, 500), 51, 26, "pyramid")],
)
def test_image_slicer_bit_equal(shape, tile, step, weight):
    j = JImageSlicer(shape, tile, step, weight=weight)
    t = TImageSlicer(shape, tile, step, weight=weight)
    np.testing.assert_array_equal(t.crops, j.crops)
    np.testing.assert_array_equal(t.bbox_crops, j.bbox_crops)
    np.testing.assert_array_equal(t.weight, j.weight)
    assert (t.margin_top, t.margin_bottom, t.margin_left, t.margin_right) == (
        j.margin_top, j.margin_bottom, j.margin_left, j.margin_right)
    assert t.target_shape == j.target_shape
    if shape[0] < 1000:
        image = np.random.RandomState(5).rand(*shape, 2).astype(np.float32)
        tiles = t.split(image)
        for a, b in zip(tiles, j.split(image)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.merge(tiles), j.merge(tiles))


# ---------------------------------------------------------------------------
# Resize helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,align_corners", [("bilinear", False), ("bilinear", True), ("nearest", False)])
@pytest.mark.parametrize("size", [(16, 24), (5, 7), (8, 12)])
def test_resize_2d_matches_jax(mode, align_corners, size):
    x = np.random.RandomState(6).rand(2, 8, 12, 3).astype(np.float32)
    want = np.asarray(JNF.resize_2d(jnp.asarray(x), size, mode=mode, align_corners=align_corners))
    got = nchw_to_nhwc(TNF.resize_2d(nhwc_to_nchw(x), size, mode=mode, align_corners=align_corners))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resize_bilinear_splits_large_batches(monkeypatch):
    """Outputs above torch's 32-bit index limit are resized in batch chunks;
    the chunked result equals the one-call result."""
    x = torch.from_numpy(np.random.RandomState(7).rand(7, 3, 8, 12).astype(np.float32))
    want = TNF.resize_bilinear(x, (16, 24), align_corners=True)
    monkeypatch.setattr(TNF, "_MAX_OUTPUT_NUMEL", 2 * 3 * 16 * 24)
    got = TNF.resize_bilinear(x.contiguous(memory_format=torch.channels_last), (16, 24), align_corners=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K1: grid merge
# ---------------------------------------------------------------------------


def _grid_case(k, seed, th=32, ty=3, tx=4, c=3):
    rng = np.random.RandomState(seed)
    s = th // k
    coords = np.array([[y * s, x * s] for y in range(ty) for x in range(tx)], dtype=np.int32)
    tiles = rng.rand(ty * tx, th, th, c).astype(np.float32)
    weight = rng.rand(th, th).astype(np.float32) + 0.1
    return coords, tiles, weight, s, ((ty - 1) * s + th, (tx - 1) * s + th)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_grid_merge_reference_matches_jax(k):
    coords, tiles, weight, s, (H, W) = _grid_case(k, seed=k)
    ty, tx = 3, 4
    j_canvas, j_norm = j_pallas_grid_merge(jnp.asarray(tiles), coords, weight, (H, W), interpret=True)
    s_canvas, s_norm = j_accumulate_tiles(
        jnp.zeros((H, W, 3)), jnp.zeros((H, W, 1)), jnp.asarray(tiles), jnp.asarray(coords),
        jnp.asarray(weight)[..., None],
    )
    t_tiles = nhwc_to_nchw(tiles)
    t_weight = torch.from_numpy(weight)
    grid = detect_regular_grid(coords, 32, 32)
    assert grid == (ty, tx, s, s)
    canvas, norm = grid_merge_reference(t_tiles, t_weight, grid, normalize=False)
    for want_c, want_n in ((j_canvas, j_norm), (s_canvas, s_norm)):
        np.testing.assert_allclose(canvas.numpy().transpose(1, 2, 0), np.asarray(want_c), atol=1e-5)
        np.testing.assert_allclose(norm.numpy().transpose(1, 2, 0), np.asarray(want_n), atol=1e-5)
    # the fused normalisation and crop
    out = grid_merge_reference(t_tiles, t_weight, grid, out_hw=(H - 5, W - 7), offset=(2, 3))
    want = (np.asarray(j_canvas) / np.asarray(j_norm))[2 : H - 3, 3 : W - 4]
    np.testing.assert_allclose(out.numpy().transpose(1, 2, 0), want, atol=1e-5)
    # the CPU route of the wrapper is the reference
    torch.testing.assert_close(grid_merge(t_tiles, t_weight, grid), grid_merge_reference(t_tiles, t_weight, grid),
                               rtol=0, atol=0)


def test_grid_merge_reference_step_not_dividing_tile():
    """The port's merge takes any step <= tile; hold it against the JAX
    scatter accumulator, which takes any coordinates."""
    rng = np.random.RandomState(9)
    th, tw, sh, sw, ty, tx = 51, 40, 26, 15, 3, 4
    coords = np.array([[y * sh, x * sw] for y in range(ty) for x in range(tx)], dtype=np.int32)
    H, W = (ty - 1) * sh + th, (tx - 1) * sw + tw
    tiles = rng.rand(ty * tx, th, tw, 2).astype(np.float32)
    weight = rng.rand(th, tw).astype(np.float32) + 0.1
    want_c, want_n = j_accumulate_tiles(
        jnp.zeros((H, W, 2)), jnp.zeros((H, W, 1)), jnp.asarray(tiles), jnp.asarray(coords),
        jnp.asarray(weight)[..., None],
    )
    got = grid_merge_reference(nhwc_to_nchw(tiles), torch.from_numpy(weight), (ty, tx, sh, sw))
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), np.asarray(want_c) / np.asarray(want_n), atol=1e-5)


# (th, tw, sh, sw, ty, tx): the geometries whose route the CUDA tests check
_K1_GEOMETRIES = [
    (64, 64, 32, 32, 4, 4),
    (32, 32, 32, 32, 3, 4),  # no overlap
    (32, 32, 8, 8, 3, 4),  # 16 covering tiles
    (36, 48, 12, 24, 4, 3),
    (48, 40, 24, 20, 3, 4),  # steps of 20 columns
    (36, 36, 12, 12, 3, 3),
    (32, 32, 4, 4, 3, 3),  # 64 covering tiles
    (40, 40, 20, 10, 3, 5),  # steps of 10 columns
    (32, 30, 16, 15, 3, 4),
    (32, 36, 16, 18, 3, 4),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", _K1_GEOMETRIES)
def test_grid_merge_geometries_match_jax(geometry, dtype):
    """The port's merge on the CPU against the JAX Pallas grid merge at each
    geometry of K1's routes, on fp32 tiles and on bf16-rounded ones."""
    th, tw, sh, sw, ty, tx = geometry
    rng = np.random.RandomState(th * tw + sh)
    coords = np.array([[y * sh, x * sw] for y in range(ty) for x in range(tx)], dtype=np.int32)
    H, W = (ty - 1) * sh + th, (tx - 1) * sw + tw
    tiles = torch.from_numpy(rng.rand(ty * tx, 2, th, tw).astype(np.float32)).to(dtype)
    weight = rng.rand(th, tw).astype(np.float32) + 0.1
    j_canvas, j_norm = j_pallas_grid_merge(jnp.asarray(nchw_to_nhwc(tiles.float())), coords, weight, (H, W),
                                           interpret=True)
    got = grid_merge(tiles, torch.from_numpy(weight), (ty, tx, sh, sw), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), np.asarray(j_canvas) / np.asarray(j_norm),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="steps"):
        grid_merge(tiles, torch.from_numpy(weight), (ty, tx, th + 1, sw))


@pytest.mark.parametrize(
    "geometry,crop",
    [((64, 64, 32, 32, 4, 4), (6, 6, 6, 6)), ((64, 64, 32, 32, 3, 4), (5, 7, 2, 3)),
     ((64, 64, 32, 32, 1, 4), (3, 4, 0, 8)), ((36, 48, 12, 24, 4, 3), (1, 2, 1, 2))],
)
def test_grid_merge_crops_match_jax(geometry, crop):
    """The cell route's geometries of the CUDA tests, cropped as there (the
    main path's offset at a small scale, and ragged x-offsets and widths):
    the port's merge on the CPU against the JAX Pallas grid merge."""
    th, tw, sh, sw, ty, tx = geometry
    top, left, bottom, right = crop
    rng = np.random.RandomState(th + ty)
    coords = np.array([[y * sh, x * sw] for y in range(ty) for x in range(tx)], dtype=np.int32)
    H, W = (ty - 1) * sh + th, (tx - 1) * sw + tw
    tiles = rng.rand(ty * tx, th, tw, 3).astype(np.float32)
    weight = rng.rand(th, tw).astype(np.float32) + 0.1
    j_canvas, j_norm = j_pallas_grid_merge(jnp.asarray(tiles), coords, weight, (H, W), interpret=True)
    want = (np.asarray(j_canvas) / np.asarray(j_norm))[top : H - bottom, left : W - right]
    got = grid_merge(nhwc_to_nchw(tiles), torch.from_numpy(weight), (ty, tx, sh, sw),
                     out_hw=(H - top - bottom, W - left - right), offset=(top, left))
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), want, rtol=0, atol=1e-5)


def test_detect_regular_grid():
    tiler = TImageSlicer((1024, 768), tile_size=256, tile_step=128, weight="mean")
    assert detect_regular_grid(tiler.crops[:, [1, 0]], 256, 256) == (7, 5, 128, 128)
    assert detect_regular_grid(np.array([[0, 0], [0, 100], [0, 300]]), 256, 256) is None
    assert detect_regular_grid(tiler.crops[:-1, [1, 0]], 256, 256) is None


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """A wrapper runs its plain version only for CPU tensors; any other
    device launches the kernel or raises."""
    tiles = torch.zeros(4, 1, 8, 8, device="meta")
    with pytest.raises(ValueError):
        grid_merge(tiles, torch.zeros(8, 8, device="meta"), (2, 2, 4, 4))
    x = torch.zeros(1, 8, 4, 4, dtype=torch.bfloat16, device="meta").contiguous(memory_format=torch.channels_last)
    packed = pack_conv3x3_weights(torch.zeros(8, 8, 3, 3, device="meta"))
    with pytest.raises(ValueError):
        conv3x3(x, packed, torch.ones(8, device="meta"), torch.zeros(8, device="meta"))


# ---------------------------------------------------------------------------
# K2: conv3x3 with the folded epilogue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c_in,c_out", [(8, 32), (32, 16)])
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_matches_jax_kernel(c_in, c_out, relu):
    rng = np.random.default_rng(0)
    x_hcw = np.asarray(jnp.asarray(rng.standard_normal((2, 32, c_in, 128)), jnp.bfloat16).astype(jnp.float32))
    w_hwio = (rng.standard_normal((3, 3, c_in, c_out)) * 0.1).astype(np.float32)
    scale = (rng.standard_normal(c_out) * 0.5 + 1.0).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    want = np.asarray(
        JK.conv3x3_hcw(jnp.asarray(x_hcw, jnp.bfloat16), JK.pack_conv3x3_weights(jnp.asarray(w_hwio)),
                       jnp.asarray(scale), jnp.asarray(bias), relu=relu, interpret=True).astype(jnp.float32)
    )  # [B, H, C_out, W]
    x = torch.from_numpy(x_hcw.transpose(0, 2, 1, 3).copy()).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy())
    got = conv3x3(x, pack_conv3x3_weights(w), torch.from_numpy(scale), torch.from_numpy(bias), relu=relu)
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    got = got.float().numpy().transpose(0, 2, 1, 3)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_conv3x3_borders_are_zero_padded():
    c = 8
    x = torch.ones(1, c, 16, 128, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    y = conv3x3(x, pack_conv3x3_weights(torch.ones(8, c, 3, 3)), torch.ones(8), torch.zeros(8)).float()
    assert float(y[0, 0, 8, 64]) == pytest.approx(9 * c, rel=1e-2)  # interior
    assert float(y[0, 0, 0, 64]) == pytest.approx(6 * c, rel=1e-2)  # top edge
    assert float(y[0, 0, 0, 0]) == pytest.approx(4 * c, rel=1e-2)  # corner
    assert float(y[0, 0, 8, 127]) == pytest.approx(6 * c, rel=1e-2)  # right edge


@pytest.mark.parametrize("c_in,c_out", [(3, 32), (96, 32), (32, 1), (384, 128), (20, 70)])
def test_pack_conv3x3_weights_roundtrip(c_in, c_out):
    w = torch.from_numpy(np.random.RandomState(c_in).randn(c_out, c_in, 3, 3).astype(np.float32))
    w_bf = w.to(torch.bfloat16)
    # the wgmma routes' [NB, KC, 9, NT, 64] slabs, K-major, 128-byte swizzled
    packed = pack_conv3x3_weights(w)
    nb, kc, taps, nt, ck = packed.shape
    assert (taps, ck) == (9, 64) and kc == -(-c_in // 64) and nt in (8, 16, 32, 64, 128, 256)
    assert nb * nt >= c_out and (nb - 1) * nt < c_out
    assert int((packed != 0).sum()) == int((w_bf != 0).sum())  # the padding is zero
    for n, k, ky, kx in ((0, 0, 0, 0), (c_out - 1, c_in - 1, 2, 1), (c_out // 2, c_in // 3, 1, 2)):
        nbi, ni = divmod(n, nt)
        kci, ki = divmod(k, 64)
        column = ((ki // 8) ^ (ni % 8)) * 8 + ki % 8  # 16-byte group g of row n sits at g ^ (n % 8)
        assert torch.equal(packed[nbi, kci, 3 * ky + kx, ni, column], w_bf[n, k, ky, kx])
    torch.testing.assert_close(_unpack(packed, c_in, c_out).float(), w_bf.float(), rtol=0, atol=0)
    # the WMMA route's [9, C_in_pad, C_out_pad], tap-major
    wmma = _pack_wmma(w)
    assert wmma.shape[1] % 16 == 0 and wmma.shape[2] % 32 == 0
    assert float(wmma.float()[:, c_in:].abs().sum()) == 0 and float(wmma.float()[:, :, c_out:].abs().sum()) == 0
    torch.testing.assert_close(_unpack(wmma, c_in, c_out).float(), w_bf.float(), rtol=0, atol=0)


def test_fold_batchnorm_matches_jax():
    rng = np.random.default_rng(1)
    gamma, beta, mean = (rng.standard_normal(16).astype(np.float32) for _ in range(3))
    var = (rng.random(16) + 0.5).astype(np.float32)
    want = JK.fold_batchnorm(*(jnp.asarray(a) for a in (gamma, beta, mean, var)))
    got = fold_batchnorm(*(torch.from_numpy(a) for a in (gamma, beta, mean, var)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The port imports no JAX
# ---------------------------------------------------------------------------


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import pytorch_toolbelt_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert sys.modules['jax'] is None and 'pytorch_toolbelt_tpu' not in sys.modules\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
