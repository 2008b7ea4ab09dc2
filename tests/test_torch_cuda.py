"""The port's CUDA kernels on a GPU, against their plain versions.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false.  The file imports no JAX, so it runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu_torch.inference import ImageSlicer, TileMerger, tiled_apply_d4_tta
from pytorch_toolbelt_tpu_torch.ops import conv3x3, conv3x3_reference, grid_merge, grid_merge_reference
from pytorch_toolbelt_tpu_torch.ops import pack_conv3x3_weights
from pytorch_toolbelt_tpu_torch.ops.conv_kernels import _unpack
from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel, fuse_unet_inference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "c_in,c_out,h,w",
    [(3, 32, 64, 67), (32, 32, 33, 64), (96, 32, 48, 130), (192, 64, 16, 16), (384, 128, 16, 5), (32, 1, 37, 37),
     (20, 70, 9, 11)],
)
def test_conv3x3_matches_reference(dev, c_in, c_out, h, w):
    gen = torch.Generator().manual_seed(c_in * 1000 + c_out)
    x = torch.randn(2, c_in, h, w, generator=gen).to(torch.bfloat16)
    weight = torch.randn(c_out, c_in, 3, 3, generator=gen) * (2.0 / (9 * c_in)) ** 0.5
    scale, bias = 1.0 + 0.1 * torch.randn(c_out, generator=gen), 0.1 * torch.randn(c_out, generator=gen)
    relu = c_out > 1
    packed = pack_conv3x3_weights(weight).to(dev)
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    before = conv3x3.launches
    got = conv3x3(x, packed, scale.to(dev), bias.to(dev), relu=relu)
    assert conv3x3.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    ref = conv3x3_reference(x, _unpack(packed, c_in, c_out), scale.to(dev), bias.to(dev), relu)
    # bf16 operands and output, fp32 accumulation
    assert float((got.float() - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


def test_conv3x3_rejects_what_the_kernel_does_not_take(dev):
    packed = pack_conv3x3_weights(torch.randn(16, 8, 3, 3)).to(dev)
    one, zero = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    nchw = torch.randn(1, 8, 8, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        conv3x3(nchw, packed, one, zero)
    fp32 = torch.randn(1, 8, 8, 8, device=dev).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        conv3x3(fp32, packed, one, zero)
    x = nchw.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        conv3x3(x, packed.cpu(), one, zero)


def _grid(th, tw, sh, sw, ty, tx, k, seed, dtype, dev):
    rng = np.random.RandomState(seed)
    tiles = torch.from_numpy(rng.rand(ty * tx, k, th, tw).astype(np.float32)).to(dev, dtype)
    weight = torch.from_numpy(rng.rand(th, tw).astype(np.float32) + 0.1).to(dev)
    return tiles, weight, (ty, tx, sh, sw), ((ty - 1) * sh + th, (tx - 1) * sw + tw)


@pytest.mark.parametrize(
    "geometry,k,dtype,out_dtype",
    [((32, 32, 32, 32, 3, 4), 3, torch.float32, torch.float32),
     ((32, 32, 16, 16, 3, 4), 1, torch.float32, torch.float32),
     ((32, 32, 16, 16, 3, 4), 2, torch.bfloat16, torch.bfloat16),
     ((32, 32, 8, 8, 3, 4), 3, torch.float32, torch.bfloat16),
     ((51, 40, 26, 15, 3, 4), 2, torch.float32, torch.float32)],
)
def test_grid_merge_matches_reference(dev, geometry, k, dtype, out_dtype):
    tiles, weight, grid, (H, W) = _grid(*geometry, k=k, seed=k, dtype=dtype, dev=dev)
    for kwargs in ({}, {"out_hw": (H - 5, W - 7), "offset": (2, 3)}):
        before = grid_merge.launches
        got = grid_merge(tiles, weight, grid, out_dtype=out_dtype, **kwargs)
        assert grid_merge.launches == before + 1 and got.dtype == out_dtype
        want = grid_merge_reference(tiles, weight, grid, out_dtype=out_dtype, **kwargs)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 if out_dtype == torch.float32 else 1e-2)
    got_c, got_n = grid_merge(tiles, weight, grid, normalize=False, out_dtype=torch.float32)
    ref_c, ref_n = grid_merge_reference(tiles, weight, grid, normalize=False, out_dtype=torch.float32)
    torch.testing.assert_close(got_c, ref_c, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_n, ref_n, rtol=0, atol=1e-5)


def test_tile_merger_on_cuda_matches_cpu(dev):
    image = np.random.RandomState(8).random((96, 80, 3)).astype(np.float32)
    slicer = ImageSlicer(image.shape, tile_size=32, tile_step=16, weight="pyramid")
    tiles = torch.from_numpy(np.stack(slicer.split(image)).transpose(0, 3, 1, 2).copy())
    results = []
    for device in (torch.device("cpu"), dev):
        merger = TileMerger(slicer.target_shape, channels=3, weight=slicer.weight, device=device)
        merger.integrate_batch(tiles.to(device), slicer.crops)
        results.append(merger.merge().cpu())
    torch.testing.assert_close(results[1], results[0], rtol=0, atol=1e-5)


def _pattern_model(device):
    """Depends on absolute tile position, so no d4 view equals another."""
    gen = torch.Generator().manual_seed(7)
    pattern = torch.rand(1, 1, 32, 32, generator=gen).to(device)
    bias = torch.rand(1, 1, 32, 32, generator=gen).to(device)
    return lambda x: torch.cat([(x * pattern).sum(1, keepdim=True) + bias, (x * bias).sum(1, keepdim=True)], 1)


@pytest.mark.parametrize("mode", ["distributed", "full"])
def test_tiled_apply_d4_tta_on_cuda_matches_cpu(dev, mode):
    image = torch.from_numpy(np.random.RandomState(13).random((3, 100, 90)).astype(np.float32))
    want = tiled_apply_d4_tta(_pattern_model("cpu"), image, 32, 16, batch_size=4, mode=mode)
    before = grid_merge.launches
    got = tiled_apply_d4_tta(_pattern_model(dev), image.to(dev), 32, 16, batch_size=4, mode=mode)
    assert grid_merge.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def test_fused_unet_on_cuda_matches_module(dev):
    torch.manual_seed(0)
    model = UNetSegmentationModel(num_classes=2, encoder_channels=8, num_layers=3).to(dev).eval()
    x = torch.rand(4, 3, 64, 96, device=dev)
    with torch.no_grad():
        want = model(x)
    before = conv3x3.launches
    got = fuse_unet_inference(model)(x)
    assert conv3x3.launches == before + 2 * (2 * 3 - 1) + 1
    assert float((got.float() - want).abs().max()) <= 5e-2 * float(want.abs().max())
