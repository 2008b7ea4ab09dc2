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
from pytorch_toolbelt_tpu_torch.ops import accumulate_tiles, accumulate_tiles_reference
from pytorch_toolbelt_tpu_torch.ops import conv3x3, conv3x3_reference, grid_merge, grid_merge_reference
from pytorch_toolbelt_tpu_torch.ops import pack_conv3x3_weights
from pytorch_toolbelt_tpu_torch.ops.conv_kernels import _pack_wmma, _route, _unpack
from pytorch_toolbelt_tpu_torch.ops import pack_qconv2d_weights, q_upsample, q_upsample_cat, q_upsample_cat_reference
from pytorch_toolbelt_tpu_torch.ops import q_add, q_add_reference, q_upsample_reference, qconv2d, qconv2d_reference
from pytorch_toolbelt_tpu_torch.ops import upsample_taps
from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel, fuse_unet_inference, quantize_unet_inference
from pytorch_toolbelt_tpu_torch.zoo.quantized_unet import _build_int8_unet, _calibrate_unet, _q_upsample_matrices

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


def _conv_case(dev, c_in, c_out, b, h, w, relu, pack=pack_conv3x3_weights, seed=0):
    """Runs K2 once and holds it against ``conv3x3_reference`` on the
    bf16-rounded weights within 2e-2 * max|ref| (bf16 operands and output,
    fp32 accumulation); returns the route it took."""
    gen = torch.Generator().manual_seed(seed + c_in * 1000 + c_out)
    x = torch.randn(b, c_in, h, w, generator=gen).to(torch.bfloat16)
    weight = torch.randn(c_out, c_in, 3, 3, generator=gen) * (2.0 / (9 * c_in)) ** 0.5
    scale, bias = 1.0 + 0.1 * torch.randn(c_out, generator=gen), 0.1 * torch.randn(c_out, generator=gen)
    packed = pack(weight).to(dev)
    taken = _route(packed, c_in)
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    before = dict(conv3x3.launches_by_route)
    got = conv3x3(x, packed, scale.to(dev), bias.to(dev), relu=relu)
    assert {k: conv3x3.launches_by_route[k] - n for k, n in before.items()} == {k: int(k == taken) for k in before}
    assert got.shape == (b, c_out, h, w) and got.is_contiguous(memory_format=torch.channels_last)
    ref = conv3x3_reference(x, _unpack(packed, c_in, c_out), scale.to(dev), bias.to(dev), relu)
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
    return taken


# (C_in, C_out, relu) of the 15 convs of UNet-32 (channels 32/64/128/256, one class), in forward order
_UNET32_CONVS = [(3, 32, 1), (32, 32, 1), (32, 64, 1), (64, 64, 1), (64, 128, 1), (128, 128, 1), (128, 256, 1),
                 (256, 256, 1), (384, 128, 1), (128, 128, 1), (192, 64, 1), (64, 64, 1), (96, 32, 1), (32, 32, 1),
                 (32, 1, 0)]


@pytest.mark.parametrize("layer", range(len(_UNET32_CONVS)))
def test_conv3x3_at_every_unet32_shape(dev, layer):
    c_in, c_out, relu = _UNET32_CONVS[layer]
    taken = _conv_case(dev, c_in, c_out, 2, 19, 70, bool(relu), seed=layer)
    assert taken == ("tma_wgmma" if c_in % 8 == 0 else "ld_wgmma")


@pytest.mark.parametrize(
    "c_in,c_out,b,h,w,relu",
    [(64, 64, 1, 7, 130, True),  # W not a multiple of the 64-pixel tile row
     (32, 32, 2, 9, 1, True),  # W = 1: the halo box is mostly off the image
     (32, 32, 2, 1, 70, False),  # H = 1
     (8, 16, 2, 12, 33, True),  # the smallest C_in a tensor map takes
     (96, 32, 2, 10, 40, False),  # a ragged second 64-channel chunk
     (32, 1, 2, 11, 65, False),  # C_out = 1: odd C_out, scalar stores
     (128, 256, 1, 6, 66, True),  # C_out = 256: one full N tile
     (64, 320, 1, 5, 67, True),  # C_out = 320: two N blocks
     (16, 70, 2, 9, 11, True),  # C_out not a multiple of 8
     (64, 128, 8, 64, 128, True),  # more tiles than SMs: streamed weights wrap their ring
     (32, 32, 4, 96, 128, True),  # more tiles than SMs with resident weights
     (3, 32, 2, 20, 70, True),  # the load route
     (20, 70, 2, 9, 11, False),
     (12, 48, 3, 33, 65, True),
     (100, 40, 1, 8, 70, True)],  # the load route over two chunks
)
def test_conv3x3_tiling_edges(dev, c_in, c_out, b, h, w, relu):
    taken = _conv_case(dev, c_in, c_out, b, h, w, relu)
    assert taken == ("tma_wgmma" if c_in % 8 == 0 else "ld_wgmma")


@pytest.mark.parametrize("c_in,c_out", [(3, 32), (32, 32), (96, 32), (20, 70)])
def test_conv3x3_wmma_route(dev, c_in, c_out):
    assert _conv_case(dev, c_in, c_out, 2, 17, 70, True, pack=_pack_wmma) == "wmma"


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
    with pytest.raises(ValueError):  # packed for one 64-channel chunk, given two
        conv3x3(torch.zeros(1, 72, 8, 8, device=dev, dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last), packed, one, zero)
    base = torch.zeros(1 * 8 * 8 * 8 + 1, device=dev, dtype=torch.bfloat16)
    shifted = base[1:].view(1, 8, 8, 8).permute(0, 3, 1, 2)  # channels_last, 2 bytes off 16-byte alignment
    assert shifted.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="aligned"):
        conv3x3(shifted, packed, one, zero)


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
        torch.testing.assert_close(got, want, rtol=0, atol=0 if out_dtype == torch.float32 else 1e-2)
    got_c, got_n = grid_merge(tiles, weight, grid, normalize=False, out_dtype=torch.float32)
    ref_c, ref_n = grid_merge_reference(tiles, weight, grid, normalize=False, out_dtype=torch.float32)
    torch.testing.assert_close(got_c, ref_c, rtol=0, atol=0)
    torch.testing.assert_close(got_n, ref_n, rtol=0, atol=0)


# (th, tw, sh, sw, ty, tx), crop (top, left, bottom, right), K, tiles' dtype, output dtype, the route K1 takes
_K1_CASES = {
    "main_path_small": ((64, 64, 32, 32, 4, 4), (6, 6, 6, 6), 1, torch.float32, torch.float32, "cell"),
    "ragged_crop": ((64, 64, 32, 32, 3, 4), (5, 7, 2, 3), 1, torch.float32, torch.float32, "cell"),
    "tw_not_multiple_of_4": ((32, 30, 16, 15, 3, 4), (2, 3, 1, 1), 2, torch.float32, torch.float32, "general"),
    "step_not_dividing_tile": ((64, 64, 24, 24, 3, 3), (6, 6, 6, 6), 2, torch.float32, torch.float32, "general"),
    "one_tile": ((64, 64, 32, 32, 1, 1), (0, 0, 0, 0), 2, torch.float32, torch.float32, "cell"),
    "one_row": ((64, 64, 32, 32, 1, 4), (3, 4, 0, 8), 1, torch.float32, torch.float32, "cell"),
    "one_column": ((64, 64, 32, 32, 4, 1), (6, 0, 5, 1), 1, torch.float32, torch.float32, "cell"),
    "k3": ((64, 64, 32, 32, 3, 3), (6, 6, 6, 6), 3, torch.float32, torch.float32, "cell"),
    "k19": ((64, 64, 32, 32, 3, 3), (6, 6, 6, 6), 19, torch.float32, torch.float32, "cell"),
    "bf16_in_bf16_out": ((64, 64, 32, 32, 3, 4), (6, 6, 6, 6), 3, torch.bfloat16, torch.bfloat16, "cell"),
    "bf16_in_fp32_out": ((64, 64, 32, 32, 3, 4), (5, 7, 2, 3), 2, torch.bfloat16, torch.float32, "cell"),
    "fp32_in_bf16_out": ((64, 64, 32, 32, 3, 4), (6, 6, 6, 6), 2, torch.float32, torch.bfloat16, "cell"),
    "no_overlap": ((32, 32, 32, 32, 3, 4), (0, 0, 0, 0), 1, torch.float32, torch.float32, "cell"),
    "16_covering_tiles": ((32, 32, 8, 8, 3, 4), (2, 3, 3, 4), 3, torch.float32, torch.float32, "cell"),
    "steps_of_12_and_24": ((36, 48, 12, 24, 4, 3), (1, 2, 1, 2), 2, torch.float32, torch.float32, "cell"),
    "step_beyond_a_box": ((320, 320, 160, 160, 2, 2), (7, 9, 5, 3), 1, torch.float32, torch.float32, "cell"),
}


def _assert_k1_route(route, before):
    after = grid_merge.launches_by_route
    assert {r: after[r] - n for r, n in before.items()} == {r: int(r == route) for r in before}


@pytest.mark.parametrize("case", list(_K1_CASES))
def test_grid_merge_routes_equal_reference_bit_for_bit(dev, case):
    """Each geometry takes its route (counted in launches_by_route) and
    equals grid_merge_reference exactly: normalized, and as (canvas, norm)."""
    geometry, (top, left, bottom, right), k, dtype, out_dtype, route = _K1_CASES[case]
    tiles, weight, grid, (H, W) = _grid(*geometry, k=k, seed=len(case), dtype=dtype, dev=dev)
    crop = {"out_hw": (H - top - bottom, W - left - right), "offset": (top, left)}
    for normalize in (True, False):
        before = dict(grid_merge.launches_by_route)
        got = grid_merge(tiles, weight, grid, normalize=normalize, out_dtype=out_dtype, **crop)
        _assert_k1_route(route, before)
        want = grid_merge_reference(tiles, weight, grid, normalize=normalize, out_dtype=out_dtype, **crop)
        for g, w in [(got, want)] if normalize else zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=0, atol=0)


# (th, tw, sh, sw, ty, tx): the route K1 takes with fp32 tiles and with bf16 tiles
_K1_ROUTES = [
    ((512, 512, 256, 256, 19, 19), "cell", "cell"),  # the main path
    ((64, 64, 32, 32, 4, 4), "cell", "cell"),
    ((32, 32, 32, 32, 3, 4), "cell", "cell"),  # no overlap
    ((32, 32, 8, 8, 3, 4), "cell", "cell"),  # 16 covering tiles, the most the cell route takes
    ((36, 48, 12, 24, 4, 3), "cell", "cell"),
    ((36, 36, 12, 12, 3, 3), "cell", "general"),  # bf16 rows of 72 bytes: no tensor map
    ((32, 32, 4, 4, 3, 3), "general", "general"),  # 64 covering tiles
    ((64, 64, 24, 24, 3, 3), "general", "general"),  # the step does not divide the tile
    ((32, 30, 16, 15, 3, 4), "general", "general"),  # steps of 15 columns, rows of 120 bytes
    ((32, 36, 16, 18, 3, 4), "general", "general"),  # steps of 18 columns: vectors would cross cells
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry,fp32_route,bf16_route", _K1_ROUTES)
def test_grid_merge_route(dev, geometry, fp32_route, bf16_route, dtype):
    """The kernel picks its route from the geometry (cell_takes in
    csrc/tile_merge.cu) and reports it; either route equals the reference."""
    tiles, weight, grid, _ = _grid(*geometry, k=1, seed=geometry[2], dtype=dtype, dev=dev)
    before = dict(grid_merge.launches_by_route)
    got = grid_merge(tiles, weight, grid, out_dtype=torch.float32)
    _assert_k1_route(fp32_route if dtype == torch.float32 else bf16_route, before)
    torch.testing.assert_close(got, grid_merge_reference(tiles, weight, grid, out_dtype=torch.float32),
                               rtol=0, atol=0)


@pytest.mark.parametrize("off", ["tiles", "weight"])
def test_grid_merge_general_route_off_16_byte_alignment(dev, off):
    """Tiles or a weight that start off a 16-byte boundary go to the general route."""
    tiles, weight, grid, _ = _grid(64, 64, 32, 32, 2, 2, k=1, seed=0, dtype=torch.float32, dev=dev)
    moved = tiles if off == "tiles" else weight
    moved = torch.empty(moved.numel() + 1, device=dev)[1:].view_as(moved).copy_(moved)
    args = (moved, weight) if off == "tiles" else (tiles, moved)
    before = dict(grid_merge.launches_by_route)
    got = grid_merge(*args, grid)
    _assert_k1_route("general", before)
    torch.testing.assert_close(got, grid_merge_reference(tiles, weight, grid), rtol=0, atol=0)


def test_grid_merge_over_2_31_elements_in_the_tile_stack(dev):
    """64-bit offsets: 46 x 46 bf16 tiles of [4, 512, 512] hold 2.2e9
    elements; the cell route's tile planes and the output stay exact."""
    if torch.cuda.get_device_properties(dev).total_memory < 40 * 2**30:
        pytest.skip("needs a card with 40 GB")
    gen = torch.Generator(device=dev).manual_seed(3)
    ty = tx = 46
    tiles = torch.rand(ty * tx, 4, 512, 512, device=dev, generator=gen, dtype=torch.bfloat16)
    assert tiles.numel() > 2**31
    weight = torch.rand(512, 512, device=dev, generator=gen) + 0.1
    grid = (ty, tx, 256, 256)
    H = W = (ty - 1) * 256 + 512
    crop = {"out_hw": (H - 12, W - 12), "offset": (6, 6)}
    before = dict(grid_merge.launches_by_route)
    got = grid_merge(tiles, weight, grid, out_dtype=torch.float32, **crop)
    _assert_k1_route("cell", before)
    want = grid_merge_reference(tiles, weight, grid, out_dtype=torch.float32, **crop)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_tile_merger_on_cuda_matches_cpu(dev):
    image = np.random.RandomState(8).random((96, 80, 3)).astype(np.float32)
    slicer = ImageSlicer(image.shape, tile_size=32, tile_step=16, weight="pyramid")
    tiles = torch.from_numpy(np.stack(slicer.split(image)).transpose(0, 3, 1, 2).copy())
    results = []
    for device in (torch.device("cpu"), dev):
        merger = TileMerger(slicer.target_shape, channels=3, weight=slicer.weight, device=device)
        before = dict(grid_merge.launches_by_route)
        merger.integrate_batch(tiles.to(device), slicer.crops)
        results.append(merger.merge().cpu())
    _assert_k1_route("cell", before)  # use_pallas="auto": the whole grid in one K1 launch, on the cell route
    torch.testing.assert_close(results[1], results[0], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# K3: the scatter merge
# ---------------------------------------------------------------------------


def _scatter_case(c, h, w, th, tw, coords, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    canvas = torch.rand(c, h, w, generator=gen).to(dev)
    norm = torch.rand(1, h, w, generator=gen).to(dev)
    tiles = torch.randn(len(coords), c, th, tw, generator=gen).to(dev, dtype)
    weight = (torch.rand(th, tw, generator=gen) + 0.1).to(dev)
    return canvas, norm, tiles, np.asarray(coords, dtype=np.int64), weight


def _odd_coords(n, h, w, th, tw, seed):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(0, h - th + 1, n), rng.randint(0, w - tw + 1, n)], axis=1)


_SCATTER_CASES = {
    # 32 tiles of a 512/256 grid in one batch: up to four overlap at a pixel
    "overlapping": (3, 1280, 1536, 512, 512, [(y, x) for y in (0, 256, 512, 768) for x in range(0, 1025, 128)][:32]),
    "misaligned": (5, 1001, 999, 301, 257, _odd_coords(13, 1001, 999, 301, 257, seed=1)),
    "one_tile": (19, 700, 900, 512, 512, [(101, 333)]),
    "long_batch": (2, 300, 300, 40, 40, _odd_coords(1500, 300, 300, 40, 40, seed=2)),  # two launches
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(_SCATTER_CASES))
def test_scatter_merge_equals_reference_bit_for_bit(dev, case, dtype):
    from pytorch_toolbelt_tpu_torch.ops.tile_merge import MAX_TILES_PER_LAUNCH

    c, h, w, th, tw, coords = _SCATTER_CASES[case]
    canvas, norm, tiles, coords, weight = _scatter_case(c, h, w, th, tw, coords, dtype, dev)
    want_c, want_n = accumulate_tiles_reference(canvas.clone(), norm.clone(), tiles, coords, weight)
    before = accumulate_tiles.launches
    got_c, got_n = accumulate_tiles(canvas, norm, tiles, coords, weight)
    assert got_c is canvas and got_n is norm
    assert accumulate_tiles.launches == before + -(-len(coords) // MAX_TILES_PER_LAUNCH)
    assert torch.equal(got_c, want_c) and torch.equal(got_n, want_n)


def test_scatter_merge_on_a_canvas_over_2_31_bytes(dev):
    """[3, 16384, 16384] fp32 is 3 GiB: offsets pass 2^31 bytes and 2^29
    elements; tiles land in the last channel's far corner too."""
    c, h, w = 3, 16384, 16384
    coords = [(0, 0), (16384 - 512, 16384 - 512), (16384 - 521, 100), (16384 - 512, 16384 - 700)]
    canvas, norm, tiles, coords, weight = _scatter_case(c, h, w, 512, 512, coords, torch.bfloat16, dev, seed=3)
    assert canvas.numel() * canvas.element_size() > 2**31
    want_c, want_n = accumulate_tiles_reference(canvas.clone(), norm.clone(), tiles, coords, weight)
    accumulate_tiles(canvas, norm, tiles, coords, weight)
    assert torch.equal(canvas, want_c) and torch.equal(norm, want_n)


def test_scatter_merge_rejects_what_the_kernel_does_not_take(dev):
    canvas, norm, tiles, coords, weight = _scatter_case(2, 64, 64, 32, 32, [(0, 0), (8, 8)], torch.float32, dev)
    with pytest.raises(ValueError, match="contiguous"):
        accumulate_tiles(canvas, norm, tiles.transpose(2, 3), coords, weight)
    with pytest.raises(ValueError, match="contiguous"):
        accumulate_tiles(canvas.transpose(1, 2), norm, tiles, coords, weight)
    with pytest.raises(ValueError, match="off the"):
        accumulate_tiles(canvas, norm, tiles, [(0, 0), (40, 8)], weight)
    with pytest.raises(ValueError, match="off the"):
        accumulate_tiles(canvas, norm, tiles, [(0, -1), (8, 8)], weight)
    with pytest.raises(ValueError, match="lie on"):
        accumulate_tiles(canvas, norm, tiles, coords, weight.cpu())
    with pytest.raises(TypeError):
        accumulate_tiles(canvas, norm, tiles.half(), coords, weight)


def test_tile_merger_scatter_path_on_cuda_matches_cpu(dev):
    image = np.random.RandomState(9).random((300, 260, 3)).astype(np.float32)
    slicer = ImageSlicer(image.shape, tile_size=64, tile_step=32, weight="pyramid")
    tiles = torch.from_numpy(np.stack(slicer.split(image)).transpose(0, 3, 1, 2).copy()).to(torch.bfloat16)
    results = []
    for device in (torch.device("cpu"), dev):
        merger = TileMerger(slicer.target_shape, channels=3, weight=slicer.weight, device=device, use_pallas=True)
        before = accumulate_tiles.launches
        for start in range(0, len(tiles), 16):
            merger.integrate_batch(tiles[start : start + 16].to(device), slicer.crops[start : start + 16])
        assert accumulate_tiles.launches - before == (-(-len(tiles) // 16) if device.type == "cuda" else 0)
        results.append((merger.image.cpu(), merger.norm_mask.cpu(), merger.merge().cpu()))
    for got, want in zip(results[1], results[0]):
        assert torch.equal(got, want)


def test_tile_merger_defaults_to_cuda(dev):
    merger = TileMerger((64, 64), channels=2, weight=np.ones((32, 32)))
    assert merger.image.device.type == "cuda" and merger.norm_mask.device.type == "cuda"
    assert merger.weight.device.type == "cuda"


def test_config3_model_on_cuda_matches_cpu(dev):
    """SEResNeXt50-FPN(128) with 19 classes in fp32, TF32 off, on CUDA
    against the CPU; the convolutions add in another order."""
    from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, se_resnext50_encoder

    torch.manual_seed(0)
    encoder = se_resnext50_encoder()
    decoder = FPNDecoder(encoder.get_output_spec(), out_channels=128)
    model = EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(), num_classes=19)).eval()
    x = torch.rand(2, 3, 96, 128)
    with torch.no_grad():
        want = model(x)
        got = model.to(dev)(x.to(dev)).cpu()
    assert got.shape == (2, 19, 96, 128)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


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
    before, by_route = grid_merge.launches, dict(grid_merge.launches_by_route)
    got = tiled_apply_d4_tta(_pattern_model(dev), image.to(dev), 32, 16, batch_size=4, mode=mode)
    assert grid_merge.launches == before + 1
    _assert_k1_route("cell", by_route)  # at a crop x-offset of 3: rows of the output off a 16-byte boundary
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


# ---------------------------------------------------------------------------
# int8 inference: Q1 (qconv2d), Q2 (q_upsample, q_upsample_cat) and the integer UNet
# ---------------------------------------------------------------------------


def _to(weight, dev):
    return weight._replace(**{k: v.to(dev) for k, v in weight._asdict().items() if isinstance(v, torch.Tensor)})


def _epilogue_operands(c_out, epilogue, gen, dev):
    """Seeded int32 operands: biases of up to 2^20 (2^30 where ``wide`` makes
    sums wrap), shifts 0-40 (32 and more leave the sign), multipliers with
    their overflow clamps as ``_quantize_conv_mul`` makes them."""
    bias = torch.randint(-(1 << 20), 1 << 20, (c_out,), generator=gen, dtype=torch.int32)
    if epilogue == "shift":
        shift = torch.randint(0, 41, (c_out,), generator=gen, dtype=torch.int32)
        rnd = torch.where(shift > 0, torch.ones_like(shift) << (shift - 1).clamp(0, 30), 0).to(torch.int32)
        ops = dict(bias=bias, rnd=rnd, shift=shift)
    elif epilogue == "mul":
        mult = torch.randint(1, 1 << 24, (c_out,), generator=gen, dtype=torch.int32)
        clamp = torch.floor((2.0**31 - 1 - (1 << 22)) / mult.double()).to(torch.int32)
        ops = dict(bias=bias, mult=mult, clamp=clamp)
    else:
        ops = {}
    return {k: v.to(dev) for k, v in ops.items()}


# (B, C_in, C_out, groups, kernel, stride, H, W, pads (top, bottom, left, right), epilogue, relu)
_QCONV_CASES = {
    "unet_stem": (2, 3, 32, 1, 3, 1, 64, 67, (1, 1, 1, 1), "shift", True),
    "unet_32": (2, 32, 32, 1, 3, 1, 33, 64, (1, 1, 1, 1), "shift", True),
    "unet_cat_384": (1, 384, 128, 1, 3, 1, 16, 21, (1, 1, 1, 1), "shift", True),
    "unet_head": (2, 32, 1, 1, 3, 1, 37, 37, (1, 1, 1, 1), "acc", False),
    "ragged_32": (3, 32, 32, 1, 3, 1, 37, 70, (1, 1, 1, 1), "shift", True),
    "ragged_64": (2, 32, 64, 1, 3, 1, 13, 131, (1, 1, 1, 1), "shift", True),
    "unet_cat_96": (2, 96, 32, 1, 3, 1, 40, 50, (1, 1, 1, 1), "shift", True),
    "unet_cat_192": (2, 192, 64, 1, 3, 1, 20, 33, (1, 1, 1, 1), "shift", True),
    "c_out_256_512_wide": (1, 128, 256, 1, 3, 1, 5, 512, (1, 1, 1, 1), "shift", True),
    "c_out_256_acc": (1, 256, 256, 1, 3, 1, 6, 70, (1, 1, 1, 1), "acc", False),
    "fpn_mul_128": (2, 128, 128, 1, 3, 1, 32, 32, (1, 1, 1, 1), "mul", False),
    "mul_relu_48": (2, 64, 48, 1, 3, 1, 9, 65, (1, 1, 1, 1), "mul", True),
    "c_out_16": (2, 16, 16, 1, 3, 1, 17, 66, (1, 1, 1, 1), "shift", True),
    "c_out_24_tail_200": (1, 200, 24, 1, 3, 1, 11, 12, (1, 1, 1, 1), "shift", True),
    "c_out_300": (1, 64, 300, 1, 3, 1, 4, 9, (1, 1, 1, 1), "mul", True),
    "ld_c_in_12_acc": (2, 12, 20, 1, 3, 1, 15, 70, (1, 1, 1, 1), "acc", False),
    "stem_7x7_s2": (2, 3, 64, 1, 7, 2, 64, 64, (3, 3, 3, 3), "mul", True),
    "same_s2_even": (2, 64, 64, 1, 3, 2, 32, 32, (0, 1, 0, 1), "mul", True),
    "same_s2_odd": (2, 64, 64, 1, 3, 2, 33, 31, (1, 1, 1, 1), "mul", True),
    "grouped_4": (2, 128, 128, 32, 3, 1, 16, 16, (1, 1, 1, 1), "mul", True),
    "grouped_8_s2": (2, 256, 256, 32, 3, 2, 16, 16, (0, 1, 0, 1), "mul", True),
    "grouped_16": (1, 512, 512, 32, 3, 1, 8, 8, (1, 1, 1, 1), "mul", True),
    "grouped_2": (2, 8, 8, 2, 3, 1, 9, 9, (1, 1, 1, 1), "shift", True),
    "proj_1x1_s2": (2, 256, 512, 1, 1, 2, 16, 16, (0, 0, 0, 0), "mul", False),
    "fpn_lateral": (2, 2048, 128, 1, 1, 1, 4, 4, (0, 0, 0, 0), "mul", False),
    "c_in_4": (2, 4, 24, 1, 3, 1, 20, 20, (1, 1, 1, 1), "shift", False),
    "acc_grouped": (2, 128, 128, 32, 3, 2, 15, 15, (1, 1, 1, 1), "acc", False),
}


@pytest.mark.parametrize("case", list(_QCONV_CASES))
def test_qconv2d_equals_reference_bit_for_bit(dev, case):
    b, c_in, c_out, groups, k, stride, h, w, pads, epilogue, relu = _QCONV_CASES[case]
    gen = torch.Generator().manual_seed(sum(map(ord, case)))
    x = torch.randint(-127, 128, (b, c_in, h, w), generator=gen, dtype=torch.int8)
    weight = torch.randint(-127, 128, (c_out, c_in // groups, k, k), generator=gen, dtype=torch.int8)
    ops = _epilogue_operands(c_out, epilogue, gen, dev)
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    packed = _to(pack_qconv2d_weights(weight, groups), dev)
    before = qconv2d.launches
    got = qconv2d(x, packed, stride, pads, epilogue, relu=relu, **ops)
    assert qconv2d.launches == before + 1
    want = qconv2d_reference(x, weight.to(dev), stride, pads, groups, epilogue, relu=relu, **ops)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want), int((got != want).sum())


def _misaligned(x):
    """x's values in a channels_last tensor whose storage starts one byte past a 16-byte boundary."""
    b, c, h, w = x.shape
    flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    y = flat[1:1 + x.numel()].view(b, h, w, c).permute(0, 3, 1, 2)
    y.copy_(x)
    assert y.is_contiguous(memory_format=torch.channels_last) and y.data_ptr() % 16 == 1
    return y


# (route, C_in, stride, pads, misaligned x): the 3x3 stride-1 pad-1 convs on the wgmma routes, the rest on mma_*
@pytest.mark.parametrize("route,c_in,stride,pads,misaligned", [
    ("tma_wgmma", 32, 1, (1, 1, 1, 1), False),
    ("ld_wgmma", 3, 1, (1, 1, 1, 1), False),
    ("ld_wgmma", 32, 1, (1, 1, 1, 1), True),
    ("mma_v16", 32, 2, (0, 1, 0, 1), False),
    ("mma_v16", 32, 1, (0, 0, 0, 0), False),
    ("mma_v4", 12, 2, (1, 1, 1, 1), False),
    ("mma_v1", 3, 2, (1, 1, 1, 1), False),
])
def test_qconv2d_routes(dev, route, c_in, stride, pads, misaligned):
    gen = torch.Generator().manual_seed(c_in)
    x = torch.randint(-127, 128, (1, c_in, 10, 10), generator=gen, dtype=torch.int8).to(dev)
    weight = torch.randint(-127, 128, (8, c_in, 3, 3), generator=gen, dtype=torch.int8)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    before = dict(qconv2d.launches_by_route)
    got = qconv2d(_misaligned(x_cl) if misaligned else x_cl, _to(pack_qconv2d_weights(weight), dev), stride, pads)
    assert {k: qconv2d.launches_by_route[k] - n for k, n in before.items()} == {k: int(k == route) for k in before}
    assert torch.equal(got, qconv2d_reference(x, weight.to(dev), stride, pads))


@pytest.mark.parametrize("c_in", [32, 64, 128, 3])
def test_qconv2d_wgmma_single_tap(dev, c_in):
    """One tap of identity weights at a time, on known values: the output is
    the input shifted by that tap, which pins the s8 A fragments, the swizzle
    decode and the tap shift of the wgmma routes."""
    c_out = 32
    x = ((torch.arange(c_in).view(1, c_in, 1, 1) * 7 + torch.arange(9).view(1, 1, 9, 1) * 3
          + torch.arange(70).view(1, 1, 1, 70)) % 255 - 127).to(torch.int8).repeat(2, 1, 1, 1)
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    padded = torch.nn.functional.pad(x.to(torch.int32), (1, 1, 1, 1))
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        weight = torch.zeros(c_out, c_in, 3, 3, dtype=torch.int8)
        for n in range(c_out):
            weight[n, n % c_in, dy, dx] = 1
        got = qconv2d(x, _to(pack_qconv2d_weights(weight), dev), 1, (1, 1, 1, 1), "acc")
        want = padded[:, torch.arange(c_out) % c_in, dy:dy + 9, dx:dx + 70]
        assert torch.equal(got, want), (tap, int((got != want).sum()))


# (B, C_in, C_out, groups, kernel, stride, H, W, pads, epilogue, relu) on the 1x1 and grouped 3x3 routes: ragged
# M and tiles, C_out off the N tile (19: register stores), batch 8, the K chunk tails, the NT = 256 tile, every
# group width of the bands, both SAME pad forms at stride 2, each epilogue with and without ReLU
_NEW_ROUTE_CASES = {
    "gemm_ragged_m": (1, 64, 256, 1, 1, 1, 13, 17, (0, 0, 0, 0), "shift", True),
    "gemm_shift": (2, 128, 128, 1, 1, 1, 20, 33, (0, 0, 0, 0), "shift", False),
    "gemm_head_19": (2, 128, 19, 1, 1, 1, 9, 11, (0, 0, 0, 0), "mul", False),
    "gemm_acc": (1, 256, 128, 1, 1, 1, 7, 9, (0, 0, 0, 0), "acc", False),
    "gemm_batch_8": (8, 256, 512, 1, 1, 1, 16, 16, (0, 0, 0, 0), "mul", True),
    "gemm_expand_2048": (1, 1024, 2048, 1, 1, 1, 8, 8, (0, 0, 0, 0), "mul", False),
    "gemm_lateral_2048": (2, 2048, 128, 1, 1, 1, 8, 8, (0, 0, 0, 0), "mul", False),
    "gemm_c_in_48": (2, 48, 64, 1, 1, 1, 10, 10, (0, 0, 0, 0), "shift", True),
    "gemm_c_in_96_c_out_32": (2, 96, 32, 1, 1, 1, 10, 10, (0, 0, 0, 0), "mul", True),
    "gemm_s2_odd": (2, 256, 512, 1, 1, 2, 15, 17, (0, 0, 0, 0), "mul", False),
    "gemm_s2_acc": (1, 512, 1024, 1, 1, 2, 8, 8, (0, 0, 0, 0), "acc", False),
    "gemm_s2_wide": (1, 64, 256, 1, 1, 2, 6, 300, (0, 0, 0, 0), "shift", True),
    "gemm_s2_head_19": (3, 32, 19, 1, 1, 2, 9, 9, (0, 0, 0, 0), "shift", False),
    "grouped_4": (2, 128, 128, 32, 3, 1, 17, 70, (1, 1, 1, 1), "mul", True),
    "grouped_4_narrow": (2, 128, 128, 32, 3, 1, 5, 3, (1, 1, 1, 1), "mul", False),
    "grouped_8_s2_batch_8": (8, 256, 256, 32, 3, 2, 32, 32, (0, 1, 0, 1), "mul", True),
    "grouped_16_s2_odd": (1, 512, 512, 32, 3, 2, 15, 13, (1, 1, 1, 1), "shift", True),
    "grouped_16_s2_wide": (1, 512, 512, 32, 3, 2, 6, 200, (0, 1, 0, 1), "mul", True),
    "grouped_32_acc": (1, 1024, 1024, 32, 3, 1, 8, 8, (1, 1, 1, 1), "acc", False),
    "grouped_32_s2_shift": (2, 1024, 1024, 32, 3, 2, 8, 8, (0, 1, 0, 1), "shift", False),
    "grouped_2": (1, 128, 128, 64, 3, 1, 9, 65, (1, 1, 1, 1), "shift", True),
    "depthwise": (2, 256, 256, 256, 3, 2, 12, 12, (0, 1, 0, 1), "mul", True),
}


@pytest.mark.parametrize("case", list(_NEW_ROUTE_CASES))
def test_qconv2d_gemm_and_grouped_routes(dev, case):
    b, c_in, c_out, groups, k, stride, h, w, pads, epilogue, relu = _NEW_ROUTE_CASES[case]
    gen = torch.Generator().manual_seed(sum(map(ord, case)))
    x = torch.randint(-127, 128, (b, c_in, h, w), generator=gen, dtype=torch.int8)
    weight = torch.randint(-127, 128, (c_out, c_in // groups, k, k), generator=gen, dtype=torch.int8)
    ops = _epilogue_operands(c_out, epilogue, gen, dev)
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    route = "gemm_wgmma" if k == 1 else "grouped_wgmma"
    before = dict(qconv2d.launches_by_route)
    got = qconv2d(x, _to(pack_qconv2d_weights(weight, groups), dev), stride, pads, epilogue, relu=relu, **ops)
    assert {r: qconv2d.launches_by_route[r] - n for r, n in before.items()} == {r: int(r == route) for r in before}
    want = qconv2d_reference(x, weight.to(dev), stride, pads, groups, epilogue, relu=relu, **ops)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("stride,pads", [(1, (1, 1, 1, 1)), (2, (0, 1, 0, 1)), (2, (1, 1, 1, 1))])
def test_qconv2d_grouped_single_tap(dev, stride, pads):
    """One tap of identity weights at a time (output channel n reads its group's first input channel), on known
    values: the output is the input at that tap's strided pixels, which pins the bands' A fragments, the halo's
    origin and the tap shift of grouped_wgmma at both strides."""
    c, width = 128, 4
    x = ((torch.arange(c).view(1, c, 1, 1) * 7 + torch.arange(11).view(1, 1, 11, 1) * 3
          + torch.arange(70).view(1, 1, 1, 70)) % 255 - 127).to(torch.int8).repeat(2, 1, 1, 1)
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    top, bottom, left, right = pads
    padded = torch.nn.functional.pad(x.to(torch.int32), (left, right, top, bottom))
    ho, wo = (11 + top + bottom - 3) // stride + 1, (70 + left + right - 3) // stride + 1
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        weight = torch.zeros(c, width, 3, 3, dtype=torch.int8)
        weight[:, 0, dy, dx] = 1
        got = qconv2d(x, _to(pack_qconv2d_weights(weight, c // width), dev), stride, pads, "acc")
        rows = dy + stride * torch.arange(ho, device=dev)
        cols = dx + stride * torch.arange(wo, device=dev)
        want = padded[:, torch.arange(c) // width * width][:, :, rows][:, :, :, cols]
        assert torch.equal(got, want), (tap, int((got != want).sum()))


@pytest.mark.parametrize("kind", ["gemm_s1", "gemm_s2", "grouped_s2"])
def test_qconv2d_new_routes_over_2_31_bytes_of_input(dev, kind):
    """Offsets past 2^31 bytes on the 1x1 (flat and strided maps) and grouped routes, with data only in the last
    sample's corner."""
    c, groups, k, stride, pads, n = {"gemm_s1": (256, 1, 1, 1, (0, 0, 0, 0), 33),
                                     "gemm_s2": (256, 1, 1, 2, (0, 0, 0, 0), 33),
                                     "grouped_s2": (1024, 32, 3, 2, (0, 1, 0, 1), 9)}[kind]
    x = torch.zeros(n, c, 512, 512, dtype=torch.int8, device=dev).contiguous(memory_format=torch.channels_last)
    assert x.numel() > 2**31
    x[-1, :, -8:, -8:] = torch.randint(-127, 128, (c, 8, 8), dtype=torch.int8, device=dev)
    gen = torch.Generator().manual_seed(12)
    c_out = 16 if k == 1 else c
    weight = torch.randint(-127, 128, (c_out, c // groups, k, k), generator=gen, dtype=torch.int8)
    route = "gemm_wgmma" if k == 1 else "grouped_wgmma"
    before = qconv2d.launches_by_route[route]
    got = qconv2d(x, _to(pack_qconv2d_weights(weight, groups), dev), stride, pads)
    assert qconv2d.launches_by_route[route] == before + 1
    want = qconv2d_reference(x[-1:, :, -8:, -8:], weight.to(dev), stride, pads, groups)
    assert torch.equal(got[-1:, :, -(8 // stride):, -(8 // stride):], want)
    assert int(got[-1].abs().amax()) > 0 and int(got[:-1].abs().amax()) == 0


def test_qconv2d_over_2_31_bytes_of_input(dev):
    """Offsets past 2^31 bytes: the decoder's 96-channel 512^2 input at the main path's 128 views (TMA route)."""
    x = torch.zeros(88, 96, 512, 512, dtype=torch.int8, device=dev).contiguous(memory_format=torch.channels_last)
    x[-1, :, -3:, -3:] = torch.randint(-127, 128, (96, 3, 3), dtype=torch.int8, device=dev)
    gen = torch.Generator().manual_seed(9)
    weight = torch.randint(-127, 128, (32, 96, 3, 3), generator=gen, dtype=torch.int8)
    before = qconv2d.launches_by_route["tma_wgmma"]
    got = qconv2d(x, _to(pack_qconv2d_weights(weight), dev), padding=(1, 1, 1, 1))
    assert qconv2d.launches_by_route["tma_wgmma"] == before + 1
    want = qconv2d_reference(x[-1:, :, -4:, -4:], weight.to(dev), padding=(1, 1, 1, 1))
    assert torch.equal(got[-1:, :, -4:, -4:][:, :, 1:, 1:], want[:, :, 1:, 1:])


# (B, C, Cs of the skip, H, W, OH, OW): ragged bands and strips on the banded route (8-row bands, strips of
# 16/32/64 columns at 256/128/64 channels), the decoder's channel pairs, a downsample, C % 32 == 16, and the
# per-pixel routes
_Q2_CASES = [
    (1, 256, 128, 9, 11, 17, 21), (3, 128, 64, 13, 20, 26, 39), (3, 64, 32, 12, 40, 23, 79), (1, 256, 0, 4, 4, 8, 8),
    (2, 32, 0, 8, 8, 16, 16), (2, 64, 16, 5, 7, 10, 13), (2, 48, 16, 6, 6, 12, 12), (2, 16, 0, 1, 3, 2, 6),
    (1, 128, 0, 40, 40, 9, 17), (2, 3, 5, 7, 7, 13, 14), (2, 4, 4, 32, 32, 64, 64), (3, 4, 0, 5, 6, 9, 11),
]


@pytest.mark.parametrize("b,c,cs,h,w,oh,ow", _Q2_CASES)
def test_q_upsample_equals_reference_bit_for_bit(dev, b, c, cs, h, w, oh, ow):
    """Both forms, q_upsample and q_upsample_cat, against their plain versions, with their launch and route counts."""
    gen = torch.Generator().manual_seed(c * h * w + cs)
    x = torch.randint(-128, 128, (b, c, h, w), generator=gen, dtype=torch.int8)
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    skip = torch.randint(-128, 128, (b, cs, oh, ow), generator=gen, dtype=torch.int8)
    skip = skip.to(dev).contiguous(memory_format=torch.channels_last)
    mh, mw, _ = _q_upsample_matrices(h, w, oh, ow)
    route = "banded" if c % 16 == 0 and cs % 16 == 0 else "v4" if c % 4 == 0 and cs % 4 == 0 else "v1"
    want = q_upsample_reference(x, mh, mw)
    for fn, args, ref in ((q_upsample, (x,), want),
                          (q_upsample_cat, (x, skip), torch.cat([want, skip], dim=1))):
        before, by_route = fn.launches, dict(fn.launches_by_route)
        got = fn(*args, mh, mw)
        assert fn.launches == before + 1
        assert fn.launches_by_route[route] == by_route[route] + 1
        assert got.shape == ref.shape and got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, ref)
        taps = (upsample_taps(mh, dev), upsample_taps(mw, dev))  # made once by the caller, as the int8 forwards do
        assert torch.equal(fn(*args, mh, mw, taps=taps), got)
        with pytest.raises(ValueError, match="taps must be"):
            fn(*args, mh, mw, taps=taps[::-1] if oh != ow else (taps[0][:-1], taps[1]))


def test_q_upsample_cat_over_2_31_bytes_of_output(dev):
    """Offsets past 2^31 bytes: the stage-3 decoder input at the main path's batch, 100 x 96 x 512^2 (2.5 GB),
    with data only in the last sample's corner."""
    x = torch.zeros(100, 64, 256, 256, dtype=torch.int8, device=dev).contiguous(memory_format=torch.channels_last)
    skip = torch.zeros(100, 32, 512, 512, dtype=torch.int8, device=dev).contiguous(memory_format=torch.channels_last)
    x[-1, :, -3:, -3:] = torch.randint(-127, 128, (64, 3, 3), dtype=torch.int8, device=dev)
    skip[-1, :, -3:, -3:] = torch.randint(-127, 128, (32, 3, 3), dtype=torch.int8, device=dev)
    mh, mw, _ = _q_upsample_matrices(256, 256, 512, 512)
    before = q_upsample_cat.launches_by_route["banded"]
    got = q_upsample_cat(x, skip, mh, mw)
    assert q_upsample_cat.launches_by_route["banded"] == before + 1
    assert got.numel() > 2**31
    assert torch.equal(got[-1:], q_upsample_cat_reference(x[-1:], skip[-1:], mh, mw))
    assert int(got[-1, :, -6:, -6:].abs().sum()) > 0 and int(got[:-1].abs().amax()) == 0


def _every_tap_pair():
    """The distinct (m0, m1) tap pairs of the main paths' matrices: the int8 UNet-32's decoder upsamples
    (64 -> 128, 128 -> 256, 256 -> 512) and the SEResNeXt50-FPN's x2 (32 -> 64 and up), the one-tap edge
    rows (127, 0) among them."""
    pairs = set()
    for size in (32, 64, 128, 256):
        m = _q_upsample_matrices(size, size, 2 * size, 2 * size)[0]
        for row in m:
            nz = np.flatnonzero(row)
            pairs.add((int(row[nz[0]]), int(row[nz[-1]]) if nz.size == 2 else 0))
    return sorted(pairs)


@pytest.mark.parametrize("axis", ["rows", "columns"])
def test_q_upsample_arithmetic_is_exact_for_every_int8_pair_and_tap_pair(dev, axis):
    """Every int8 pair (a, b), a in the rows (or columns) 2i and b in 2i + 1, under every tap pair of the main
    paths, one pass of the banded route at a time: a of input 2i is i - 128, b is the channel - 128.  The
    other axis has two equal inputs under the taps (127, 1), which pass a value of the first pass through:
    (128 v + 64) >> 7 = v."""
    pairs = _every_tap_pair()
    assert (127, 0) in pairs and len(pairs) > 100
    m = np.zeros((len(pairs) * 256, 512), np.int8)  # 256 rows per pair: no 8-row band or 16-column strip spans two
    for k, (m0, m1) in enumerate(pairs):
        m[k * 256 + np.arange(256), 2 * np.arange(256)] = m0
        m[k * 256 + np.arange(256), 2 * np.arange(256) + 1] = m1
    through = np.array([[127, 1]], np.int8)
    values = torch.where(torch.arange(512) % 2 == 0, torch.arange(512) // 2, torch.zeros(512, dtype=torch.long))
    x = (values.view(1, 1, 512) + torch.where(torch.arange(512) % 2 == 1, torch.arange(256).view(256, 1), 0)) - 128
    x = x.to(torch.int8).view(1, 256, 512, 1).expand(1, 256, 512, 2)  # [1, C, 512 (a, b), 2 equal]
    mh, mw = (m, through) if axis == "rows" else (through, m)
    if axis == "columns":
        x = x.transpose(2, 3)
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    before = q_upsample.launches_by_route["banded"]
    got = q_upsample(x, mh, mw)
    assert q_upsample.launches_by_route["banded"] == before + 1
    assert got.shape == (1, 256, *((len(pairs) * 256, 1) if axis == "rows" else (1, len(pairs) * 256)))
    assert torch.equal(got, q_upsample_reference(x, mh, mw))


def test_int8_unet_on_cuda_equals_its_plain_forward(dev):
    """One calibration, the integer network built on the card (Q1, Q2) and on
    the CPU (their plain versions): bit-equal logits."""
    torch.manual_seed(0)
    model = UNetSegmentationModel(num_classes=2, encoder_channels=16, num_layers=3).eval()
    gen = torch.Generator().manual_seed(1)
    cal_images, x = torch.rand(2, 3, 64, 64, generator=gen), torch.rand(3, 3, 64, 96, generator=gen)
    cal = _calibrate_unet(model, cal_images, 1.0)
    before, ups, cats = qconv2d.launches, q_upsample.launches, q_upsample_cat.launches_by_route["banded"]
    got = _build_int8_unet(cal, 3, None, dev)(x.to(dev))
    assert (qconv2d.launches - before, q_upsample.launches - ups) == (2 * (2 * 3 - 1) + 1, 0)
    assert q_upsample_cat.launches_by_route["banded"] - cats == 2  # each decoder input in one launch
    want = _build_int8_unet(cal, 3, None, torch.device("cpu"))(x)
    assert torch.equal(got.cpu(), want)
    # and calibrated on the card (TF32 off), it stays within int8 PTQ error of the float model
    q = quantize_unet_inference(model.to(dev), cal_images.to(dev))(x.to(dev))
    with torch.no_grad():
        f = model(x.to(dev))
    assert float(((q - f) ** 2).mean().sqrt() / (f**2).mean().sqrt()) < 0.06


# Q3 (q_add) at the int8 SEResNeXt50-FPN's add shapes at batch 8: the residual
# adds of its four stages on 1024^2 views, and the FPN's widest top-down add
_Q_ADD_SHAPES = {"stage1": (8, 256, 256, 256), "stage2": (8, 512, 128, 128), "stage3": (8, 1024, 64, 64),
                 "stage4": (8, 2048, 32, 32), "fpn": (8, 128, 512, 512)}


def _q_add_operands(shape, seed, dev):
    """Seeded addends over the whole int8 range, multipliers in [0, 2^20],
    gates in [0, 2^14], with both ends of each present."""
    n, c, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    a, b = (torch.randint(-128, 128, (n, h, w, c), generator=gen, device=dev, dtype=torch.int8).permute(0, 3, 1, 2)
            for _ in range(2))
    ma, mb = (torch.randint(0, (1 << 20) + 1, (c,), generator=gen, device=dev, dtype=torch.int32) for _ in range(2))
    gate = torch.randint(0, (1 << 14) + 1, (n, c), generator=gen, device=dev, dtype=torch.int32)
    a[:, :, 0, 0], b[:, :, 0, 0], ma[0], mb[1], gate[0, :2] = 127, 127, 1 << 20, 1 << 20, 0
    a[:, :, 0, 1], b[:, :, 0, 1], gate[-1, -2:] = -128, -128, 1 << 14
    return a, b, ma, mb, gate


def _q_add_case(a, b, ma, mb, relu, gate, route):
    before, gated = dict(q_add.launches_by_route), q_add.gated
    got = q_add(a, b, ma, mb, relu, gate)
    assert {k: q_add.launches_by_route[k] - n for k, n in before.items()} == {k: int(k == route) for k in before}
    assert q_add.gated - gated == int(gate is not None)
    assert got.dtype == torch.int8 and got.shape == a.shape and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, q_add_reference(a, b, ma, mb, relu, gate))


@pytest.mark.parametrize("gated", [False, True], ids=["no_gate", "gate"])
@pytest.mark.parametrize("case", list(_Q_ADD_SHAPES))
def test_q_add_equals_reference_bit_for_bit(dev, case, gated):
    a, b, ma, mb, gate = _q_add_operands(_Q_ADD_SHAPES[case], sum(map(ord, case)) + gated, dev)
    _q_add_case(a, b, ma, mb, case != "fpn", gate if gated else None, "vec16")


@pytest.mark.parametrize("case", ["c_24", "c_24_relu_gate", "misaligned"])
def test_q_add_scalar_route(dev, case):
    """C % 16 != 0, and a map that starts one byte past a 16-byte boundary."""
    shape = (2, 256, 9, 10) if case == "misaligned" else (3, 24, 17, 19)
    a, b, ma, mb, gate = _q_add_operands(shape, 7, dev)
    if case == "misaligned":
        n, c, h, w = shape
        a = torch.empty(n * h * w * c + 1, dtype=torch.int8, device=dev)[1:].view(n, h, w, c).permute(0, 3, 1, 2)
        a.copy_(b.flip(0))
        assert a.is_contiguous(memory_format=torch.channels_last) and a.data_ptr() % 16 == 1
    gated = case != "c_24"
    _q_add_case(a, b, ma, mb, gated, gate if gated else None, "scalar")


def test_int8_seresnext50_fpn_on_cuda_runs_its_adds_on_q3(dev, monkeypatch):
    """One 256^2 forward of the int8 SEResNeXt50-FPN(128): its 20 adds on
    Q3's vector route, the 16 of the bottlenecks with their SE gates; bit-equal
    to the same calibration built and run with every add, excitation
    included, on the eager int32 formula."""
    from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, seresnext50_encoder
    from pytorch_toolbelt_tpu_torch.zoo import quantized_encdec as TQE
    from test_torch_q_add import _formula  # the SE excitation and add as separate int32 passes

    torch.manual_seed(0)
    encoder = seresnext50_encoder()
    decoder = FPNDecoder(encoder.get_output_spec(), out_channels=128)
    model = EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(), num_classes=19)).eval().to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    cal, x = (torch.rand(2, 3, 256, 256, generator=gen, device=dev) for _ in range(2))
    g, input_id, head_id = TQE._build_encdec_graph(model)
    with torch.no_grad(), TQE._full_fp32():
        vals, amax, input_amax = TQE._calibrate(g, input_id, cal, False, (256, 256), "absmax", 99.9, 1.0)

    def build():
        return TQE._build_int8_encdec(g, input_id, head_id, amax, input_amax, set(), "mul", False, None, dev, vals,
                                      cal)

    forward = build()
    counted = lambda: (q_add.launches, q_add.gated, q_add.launches_by_route["scalar"])  # noqa: E731
    for call in ("the first, eager, then captured", "a replay"):
        before = counted()
        got = forward(x)
        assert tuple(n - b for n, b in zip(counted(), before)) == (20, 16, 0), call

    monkeypatch.setattr(TQE, "q_add", _formula)
    assert torch.equal(got, build()(x))


@pytest.fixture(scope="module")
def int8_seresnext():
    """Fresh int8 SEResNeXt50-FPN(128) forwards, 19 classes, all built from
    one calibration on the card (2 images of 256^2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, seresnext50_encoder
    from pytorch_toolbelt_tpu_torch.zoo import quantized_encdec as TQE

    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    encoder = seresnext50_encoder()
    decoder = FPNDecoder(encoder.get_output_spec(), out_channels=128)
    model = EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(), num_classes=19)).eval().to(dev)
    cal = torch.rand(2, 3, 256, 256, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    g, input_id, head_id = TQE._build_encdec_graph(model)
    with torch.no_grad(), TQE._full_fp32():
        vals, amax, input_amax = TQE._calibrate(g, input_id, cal, False, (256, 256), "absmax", 99.9, 1.0)
    del model
    return lambda: TQE._build_int8_encdec(g, input_id, head_id, amax, input_amax, set(), "mul", False, None, dev,
                                          vals, cal)


def _graph_counts():
    from pytorch_toolbelt_tpu_torch.zoo import quantized_encdec as TQE

    return dict(vars(TQE.int8_graph))


def _counted_since(before):
    return tuple(_graph_counts()[k] - before[k] for k in ("captures", "replays", "eager_calls"))


@pytest.mark.parametrize("batch,size", [(8, 1024), (8, 768), (32, 512), (9, 512)],
                         ids=["msd4-1024", "msd4-768", "stream-32", "stream-9"])
def test_int8_encdec_cuda_graph_replays_equal_the_eager_forward(int8_seresnext, batch, size):
    """The benchmark's keys: the first call runs eagerly and captures, later
    calls replay; every output is the eager forward's bit for bit, and one
    call's output is left as it was by the calls after it."""
    forward = int8_seresnext()
    gen = torch.Generator(device="cuda").manual_seed(batch * size)
    x1, x2 = (torch.rand(batch, 3, size, size, generator=gen, device="cuda") for _ in range(2))
    want1, want2 = forward.eager(x1), forward.eager(x2)
    before = _graph_counts()
    got1 = forward(x1)
    assert _counted_since(before) == (1, 0, 1)
    got2 = forward(x2)
    kept = got2.clone()
    got3, got4 = forward(x1), forward(x2)
    assert _counted_since(before) == (1, 3, 1)
    assert torch.equal(got1, want1) and torch.equal(got2, want2) and torch.equal(got3, want1)
    assert torch.equal(got4, want2) and torch.equal(got2, kept) and got2.data_ptr() != got3.data_ptr()


def test_multiscale_tta_over_the_graphed_int8_encdec_equals_it_eager(int8_seresnext):
    """msd4's request: 8 d4 views at 1024^2 and at 768^2, one replay each
    once both keys are captured."""
    from pytorch_toolbelt_tpu_torch.inference import MultiscaleTTA, d4_image2mask

    forward = int8_seresnext()
    x = torch.rand(1, 3, 1024, 1024, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    tta = lambda f: MultiscaleTTA(lambda v: d4_image2mask(f, v), size_offsets=[0, -256])(x)  # noqa: E731
    want = tta(forward.eager)
    tta(forward)
    before = _graph_counts()
    got = tta(forward)
    assert _counted_since(before) == (0, 2, 0)
    assert torch.equal(got, want)


def test_int8_encdec_graph_spans_time_each_node_on_the_card(int8_seresnext):
    """Under a profiler each add, SE gate, pool and head conv counts one call
    a replay with the card's time (the graph's event pairs), under
    ``int8.graph``, the third replay's copy after a wait for the first; one
    graph launch a forward, no host-to-card copy and no stream sync."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_toolbelt_tpu_torch.utils import profiling

    forward = int8_seresnext()
    x = torch.rand(2, 3, 256, 256, device="cuda")
    want = forward(x)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = [forward(x) for _ in range(3)]
        torch.cuda.synchronize()
    totals = profiling.span_totals()
    assert all(torch.equal(y, want) for y in got)
    for name, calls in (("int8.add", 60), ("int8.se", 48), ("int8.pool", 3), ("int8.graph", 3), ("int8.head", 6)):
        assert totals[name]["calls"] == calls and totals[name]["device_s"] > 0, name
    assert totals["int8.add"]["parents"] == {"int8.graph": 60} and "q1.call" not in totals
    names = [e.name for e in prof.events()]
    assert names.count("cudaGraphLaunch") == 3 and "cudaStreamSynchronize" not in names
    assert not any(name.startswith("Memcpy HtoD") for name in names)


def test_int8_encdec_calls_on_another_stream_run_eagerly(int8_seresnext):
    """The graphs replay on the stream of the model's first capture only: a
    call on another stream runs eagerly, is counted so and gives the same
    output."""
    forward = int8_seresnext()
    x = torch.rand(2, 3, 128, 128, device="cuda")
    want = forward(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = _graph_counts()
    with torch.cuda.stream(side):
        got = forward(x)
    torch.cuda.current_stream().wait_stream(side)
    assert _counted_since(before) == (0, 0, 1)
    assert torch.equal(got, want) and torch.equal(forward(x), want)
    assert _counted_since(before) == (0, 1, 1)


def test_int8_encdec_keys_beyond_the_cap_run_eagerly_and_are_counted(int8_seresnext):
    from pytorch_toolbelt_tpu_torch.zoo import quantized_encdec as TQE

    forward = int8_seresnext()
    xs = [torch.rand(1, 3, 64 + 32 * k, 64, device="cuda") for k in range(TQE._GRAPH_KEYS + 1)]
    before = _graph_counts()
    firsts = [forward(x) for x in xs]
    assert _counted_since(before) == (TQE._GRAPH_KEYS, 0, TQE._GRAPH_KEYS + 1)
    before = _graph_counts()
    again = [forward(x) for x in xs]
    assert _counted_since(before) == (0, TQE._GRAPH_KEYS, 1)
    assert all(torch.equal(a, b) for a, b in zip(firsts, again))


# ---------------------------------------------------------------------------
# Strip-sharded tiled inference and 3D tiles on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3])
def test_strips_on_cuda_equal_single_chip_bit_for_bit(dev, n):
    """The fused UNet on the card: each strip runs other batch sizes than
    the single-chip call, and the strips still equal it bit for bit; one K1
    launch per strip, on the cell route."""
    from pytorch_toolbelt_tpu_torch.distributed import tiled_apply_sharded

    torch.manual_seed(0)
    fused = fuse_unet_inference(UNetSegmentationModel(num_classes=2, encoder_channels=8, num_layers=3).to(dev).eval())
    image = torch.rand(3, 200, 170, device=dev)
    want = tiled_apply_d4_tta(fused, image, 64, 32, batch_size=5, mode="distributed")
    strips = []
    for d in range(n):
        before = dict(grid_merge.launches_by_route)
        strips.append(tiled_apply_sharded(fused, image, 64, 32, batch_size=5, d4_tta="distributed", rank=d,
                                          world_size=n))
        _assert_k1_route("cell", before)
    got = torch.cat(strips, dim=1)
    assert got.device == image.device and got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_replicated_canvas_on_cuda_launches_k3(dev):
    from pytorch_toolbelt_tpu_torch.distributed import tiled_apply_sharded

    image = torch.from_numpy(np.random.RandomState(14).random((3, 100, 90)).astype(np.float32))
    kw = dict(tile_size=32, tile_step=16, batch_size=4, d4_tta="distributed")
    strips = tiled_apply_sharded(_pattern_model(dev), image, **kw)  # a host image moves to the current device
    model, batches = _pattern_model(dev), []

    def counted(tiles):
        batches.append(len(tiles))
        return model(tiles)

    before = accumulate_tiles.launches
    got = tiled_apply_sharded(counted, image.to(dev), canvas="replicated", **kw)
    # 30 tiles of two views each; one K3 launch per batch
    assert sum(batches) == 2 * 30 and accumulate_tiles.launches == before + len(batches)
    assert strips.device == got.device == dev
    assert float((got - strips).abs().max()) <= 1e-5 * float(strips.abs().max())


def test_volume_merger_allocates_on_the_current_cuda_device(dev):
    from pytorch_toolbelt_tpu_torch.inference import VolumeMerger, VolumeSlicer, tiled_apply_3d

    slicer = VolumeSlicer((12, 20, 16), 8, 4, weight="pyramid")
    merger = VolumeMerger(slicer.target_shape, channels=2, weight=slicer.weight)
    assert merger.volume.device == merger.norm_mask.device == torch.device("cuda", torch.cuda.current_device())
    volume = torch.rand(2, 12, 20, 16, device=dev)
    padded = torch.nn.functional.pad(volume, (slicer.margin_left, slicer.margin_right, slicer.margin_top,
                                              slicer.margin_bottom, slicer.margin_front, slicer.margin_back))
    tiles = torch.stack([padded[:, z : z + d, y : y + h, x : x + w] for z, y, x, d, h, w in slicer.crops])
    merger.integrate_batch(tiles, slicer.crops)
    torch.testing.assert_close(slicer.crop_to_original_size(merger.merge()), volume, rtol=0, atol=1e-5)
    torch.testing.assert_close(tiled_apply_3d(lambda t: t * 2.0, volume, 8, 4, batch_size=3), volume * 2.0,
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# K4 / K5: the row sorts
# ---------------------------------------------------------------------------


def _awkward_keys(rows, n, key_dtype, seed):
    """Heavy ties; float keys add -0.0 / +0.0, +-inf and NaN, int keys the extremes."""
    gen = torch.Generator().manual_seed(seed)
    pick = torch.rand(rows, n, generator=gen)
    if key_dtype == torch.float32:
        keys = torch.randint(-6, 6, (rows, n), generator=gen).float() * 0.5
        for lo, hi, value in ((0.0, 0.1, -0.0), (0.1, 0.2, 0.0), (0.2, 0.25, float("nan")),
                              (0.25, 0.28, float("inf")), (0.28, 0.31, float("-inf"))):
            keys[(pick >= lo) & (pick < hi)] = value
        return keys
    keys = torch.randint(-9, 9, (rows, n), generator=gen, dtype=torch.int32)
    keys[pick < 0.05] = torch.iinfo(torch.int32).min
    keys[pick > 0.95] = torch.iinfo(torch.int32).max
    return keys


def _payload(rows, n, payload_dtype, seed):
    gen = torch.Generator().manual_seed(seed + 1)
    if payload_dtype == torch.int32:
        return torch.randint(-(2**31), 2**31 - 1, (rows, n), generator=gen, dtype=torch.int64).to(torch.int32)
    return torch.randn(rows, n, generator=gen)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


RADIX_TILE = 512 * 15  # pairs per tile of K4's pass kernel: kThreads * kItems in csrc/radix_sort.cu


def _sorts():
    from pytorch_toolbelt_tpu_torch.ops import bitonic_sort_chunked, split_sort

    return {"K4": bitonic_sort_chunked, "K5": split_sort}


def _sort_case(dev, kernel, keys, payload):
    """Runs the kernel twice and holds both results against sort_reference, bit for bit."""
    from pytorch_toolbelt_tpu_torch.ops import sort_reference

    sort = _sorts()[kernel]
    before = sort.launches
    got = sort(keys, payload)
    again = sort(keys, payload)
    assert sort.launches == before + 2
    want = sort_reference(keys, payload)
    for out in (got, again):
        assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(out, want))
    return got


@pytest.mark.parametrize("pair", [(torch.float32, torch.int32), (torch.int32, torch.float32)], ids=["f32_i32", "i32_f32"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 1000003), (19, 1 << 16), (152, 4099), (4096, 17), (64, 1 << 20)])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_sort_kernels_equal_sort_reference(dev, kernel, shape, pair):
    """(4096, 17): many short rows; (64, 2^20): K4 has far more tiles than
    resident blocks, so its look-back crosses waves."""
    keys = _awkward_keys(*shape, pair[0], seed=shape[1]).to(dev)
    payload = _payload(*shape, pair[1], seed=shape[1]).to(dev)
    _sort_case(dev, kernel, keys, payload)


@pytest.mark.parametrize("pair", [(torch.float32, torch.int32), (torch.int32, torch.float32)], ids=["f32_i32", "i32_f32"])
@pytest.mark.parametrize("offset", [-1, 0, 1])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_sort_kernels_at_the_radix_tile_edges(dev, kernel, offset, pair):
    """Rows of one K4 tile less one pair, exactly one tile, one tile and one pair."""
    n = RADIX_TILE + offset
    keys = _awkward_keys(3, n, pair[0], seed=n).to(dev)
    payload = _payload(3, n, pair[1], seed=n).to(dev)
    _sort_case(dev, kernel, keys, payload)


@pytest.mark.parametrize("key_dtype", [torch.float32, torch.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_sort_kernels_keep_equal_keys_in_input_order(dev, kernel, key_dtype):
    """Every key equal across five tiles and a ragged one: stability alone
    orders the payload, which must come out as it went in."""
    n = 5 * RADIX_TILE + 7
    keys = torch.full((3, n), 3, dtype=key_dtype, device=dev)
    payload = torch.arange(3 * n, dtype=torch.int32, device=dev).reshape(3, n)
    got_k, got_p = _sort_case(dev, kernel, keys, payload)
    assert torch.equal(got_p, payload) and torch.equal(got_k, keys)


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_sort_kernels_over_the_whole_int32_range(dev, kernel):
    """int32 keys drawn from INT_MIN..INT_MAX, both extremes planted: every
    bit of every digit place varies."""
    gen = torch.Generator().manual_seed(21)
    keys = torch.randint(-(2**31), 2**31, (5, 300007), generator=gen, dtype=torch.int64).to(torch.int32)
    keys[:, :3] = torch.tensor([-(2**31), 2**31 - 1, 0], dtype=torch.int32)
    payload = _payload(5, 300007, torch.float32, seed=21)
    _sort_case(dev, kernel, keys.to(dev), payload.to(dev))


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_sort_kernels_keep_every_nan_last_and_in_order(dev, kernel):
    """NaNs of every bit pattern tie and come last in input order, as in
    torch.sort on the CPU (torch.sort on CUDA orders them by bit pattern)."""
    from pytorch_toolbelt_tpu_torch.ops import sort_reference

    keys = _awkward_keys(3, 5001, torch.float32, seed=11)
    bits = keys.view(torch.int32)
    patterns = torch.tensor([0x7FC00000, 0x7FFFFFFF, 0x7F800001, -0x00400000, -1], dtype=torch.int32)
    nan = torch.isnan(keys)
    bits[nan] = patterns[torch.arange(int(nan.sum())) % len(patterns)]
    payload = _payload(3, 5001, torch.int32, seed=11)
    got_k, got_p = _sorts()[kernel](keys.to(dev), payload.to(dev))
    want_k, want_p = sort_reference(keys, payload)
    assert torch.equal(_bits(got_k).cpu(), _bits(want_k)) and torch.equal(got_p.cpu(), want_p)


MERGE_CHUNK = 512 * 16  # pairs per chunk and per merge tile of K5: kThreads * kItems in csrc/merge_sort.cu
MERGE_WAYS = 32  # most runs K5 merges at once: kMaxWays in csrc/merge_sort.cu
_MERGE_EDGES = {  # row length: K5's merge rounds are 0, 0, 1, 1, 1, 2, 2, 2, 3
    "C1-1": MERGE_CHUNK - 1, "C1": MERGE_CHUNK, "C1+1": MERGE_CHUNK + 1,
    "C1k-1": MERGE_CHUNK * MERGE_WAYS - 1, "C1k": MERGE_CHUNK * MERGE_WAYS, "C1k+1": MERGE_CHUNK * MERGE_WAYS + 1,
    "C1k2-1": MERGE_CHUNK * MERGE_WAYS**2 - 1, "C1k2": MERGE_CHUNK * MERGE_WAYS**2,
    "C1k2+1": MERGE_CHUNK * MERGE_WAYS**2 + 1,
}


@pytest.mark.parametrize("pair", [(torch.float32, torch.int32), (torch.int32, torch.float32)], ids=["f32_i32", "i32_f32"])
@pytest.mark.parametrize("edge", list(_MERGE_EDGES))
def test_split_sort_at_its_merge_round_edges(dev, edge, pair):
    """Rows of C1 +- 1 and C1 * k^r (+- 1) pairs: the chunk sort alone, then
    one, two and three merge rounds, with a ragged last run and a ragged
    last group of runs."""
    n = _MERGE_EDGES[edge]
    keys = _awkward_keys(2, n, pair[0], seed=n).to(dev)
    payload = _payload(2, n, pair[1], seed=n).to(dev)
    _sort_case(dev, "K5", keys, payload)


@pytest.mark.parametrize("key_dtype", [torch.float32, torch.int32], ids=["f32", "i32"])
def test_split_sort_keeps_one_tie_in_input_order_over_two_merge_rounds(dev, key_dtype):
    """Every key equal over k + 4 chunks and a ragged one: two merge rounds
    run and every partition boundary falls inside the tie, so the payload
    must come out exactly as it went in."""
    n = MERGE_CHUNK * (MERGE_WAYS + 4) + 5
    keys = torch.full((2, n), -3, dtype=key_dtype, device=dev)
    payload = torch.arange(2 * n, dtype=torch.int32, device=dev).reshape(2, n)
    got_k, got_p = _sort_case(dev, "K5", keys, payload)
    assert torch.equal(got_p, payload) and torch.equal(got_k, keys)


@pytest.mark.parametrize("key_dtype", [torch.float32, torch.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("n", [MERGE_CHUNK * MERGE_WAYS, 3 * MERGE_CHUNK * MERGE_WAYS + 17], ids=["1round", "2rounds"])
def test_split_sort_splits_inside_ties_that_span_every_run(dev, n, key_dtype):
    """Keys of two values, both in every chunk: every k-way partition lands
    inside a run of ties that spans all k runs of its group, so the run
    index alone decides which run gives the tile its next pair.  The float
    keys write the lower value as -0.0 and +0.0, which tie and keep their bits."""
    gen = torch.Generator().manual_seed(n)
    high = torch.rand(2, n, generator=gen) < 0.3
    if key_dtype == torch.float32:
        low = torch.where(torch.rand(2, n, generator=gen) < 0.5, torch.tensor(-0.0), torch.tensor(0.0))
        keys = torch.where(high, torch.tensor(1.0), low)
    else:
        keys = torch.where(high, torch.tensor(7, dtype=torch.int32), torch.tensor(-7, dtype=torch.int32))
    payload = torch.arange(2 * n, dtype=torch.int32).reshape(2, n)
    _sort_case(dev, "K5", keys.to(dev), payload.to(dev))


def test_sort_kernels_reject_non_contiguous(dev):
    keys = torch.zeros(8, 4, device=dev).t()
    payload = torch.zeros(4, 8, dtype=torch.int32, device=dev)
    for sort in _sorts().values():
        with pytest.raises(ValueError):
            sort(keys, payload)


# ---------------------------------------------------------------------------
# Every loss on CUDA against the same loss on the CPU
# ---------------------------------------------------------------------------


def _loss_cases():
    from pytorch_toolbelt_tpu_torch import losses as L

    b, c, h, w = 2, 5, 16, 16
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn(b, c, h, w, generator=gen)
    labels = torch.randint(0, c, (b, h, w), generator=gen)
    labels_ignored = labels.masked_fill(torch.rand(b, h, w, generator=gen) < 0.1, 255)
    binary = (torch.rand(b, c, h, w, generator=gen) > 0.5).float()
    binary1 = binary[:, :1].clone()
    probas = torch.softmax(logits, 1)
    vec, vec_labels = torch.randn(8, c, generator=gen), torch.randint(0, c, (8,), generator=gen)
    reg_a, reg_b = 3 * torch.randn(b, 17, generator=gen), 3 * torch.randn(b, 17, generator=gen)
    last = logits.movedim(1, -1).contiguous()
    return [
        ("binary_focal", L.BinaryFocalLoss(alpha=0.25), logits, binary),
        ("ce_focal", L.CrossEntropyFocalLoss(ignore_index=255), logits, labels_ignored),
        ("ce_focal_normalized", L.CrossEntropyFocalLoss(normalized=True), logits, labels),
        ("dice_multiclass", L.DiceLoss("multiclass", ignore_index=255), logits, labels_ignored),
        ("dice_multilabel", L.DiceLoss("multilabel", log_loss=True), logits, binary),
        ("dice_binary", L.DiceLoss("binary", from_logits=False), torch.sigmoid(logits[:, :1]), binary1),
        ("jaccard_multiclass", L.JaccardLoss("multiclass", classes=(1, 3)), logits, labels),
        ("jaccard_binary", L.JaccardLoss("binary"), logits[:, :1].contiguous(), binary1),
        ("lovasz", L.LovaszLoss(ignore=255), probas, labels_ignored),
        ("lovasz_per_image", L.LovaszLoss(per_image=True, classes="all"), probas, labels),
        ("binary_lovasz", L.BinaryLovaszLoss(ignore_index=255), logits[:, 0].contiguous(),
         labels_ignored.clamp_max(1).masked_fill(labels_ignored == 255, 255).float()),
        ("binary_lovasz_per_image", L.BinaryLovaszLoss(per_image=True), logits[:, :1].contiguous(), binary1),
        ("soft_bce", L.SoftBCEWithLogitsLoss(smooth_factor=0.1), logits, binary),
        ("soft_ce", L.SoftCrossEntropyLoss(smooth_factor=0.1, ignore_index=255), logits, labels_ignored),
        ("balanced_bce", L.BalancedBCEWithLogitsLoss(), logits, binary),
        ("binary_soft_f1", L.BinarySoftF1Loss(), logits[:, 0].contiguous(), binary[:, 0].contiguous()),
        ("soft_f1", L.SoftF1Loss(), vec, vec_labels),
        ("wing", L.WingLoss(), reg_a, reg_b),
        ("log_cosh", L.LogCoshLoss(), reg_a, reg_b),
        ("focal_cosine", L.FocalCosineLoss(), vec, vec_labels),
        ("quality_focal", L.QualityFocalLoss(), reg_a, torch.sigmoid(reg_b)),
        ("bitempered", L.BiTemperedLogisticLoss(0.8, 1.2), last, labels),
        ("bitempered_binary", L.BinaryBiTemperedLogisticLoss(0.5, 0.8), logits[:, :1].contiguous(), binary1),
        ("joint", L.JointLoss(L.CrossEntropyFocalLoss(), L.LovaszLoss(), 1.0, 0.5), probas, labels),
        ("weighted", L.WeightedLoss(L.DiceLoss("multiclass"), 0.3), logits, labels),
    ]


LOSS_CASES = _loss_cases()


@pytest.mark.parametrize("case", range(len(LOSS_CASES)), ids=[c[0] for c in LOSS_CASES])
def test_loss_on_cuda_matches_cpu(dev, case):
    from pytorch_toolbelt_tpu_torch.ops import bitonic_sort_chunked

    name, loss, x, y = LOSS_CASES[case]
    results = []
    for device in (torch.device("cpu"), dev):
        xi = x.detach().to(device).clone().requires_grad_(True)
        before = bitonic_sort_chunked.launches
        value = loss(xi, y.to(device))
        value.backward()
        if device.type == "cuda" and "lovasz" in name:
            assert bitonic_sort_chunked.launches == before + 1  # the forward's sort; the backward scatters
        results.append((value.detach().cpu(), xi.grad.cpu()))
    (want_v, want_g), (got_v, got_g) = results
    # CUDA reductions (sums, cumsums, softmax) add in another order than the CPU's
    torch.testing.assert_close(got_v, want_v, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-5 * float(want_g.abs().max()))


def test_lovasz_split_sort_route_on_cuda(dev):
    from pytorch_toolbelt_tpu_torch.losses import LovaszLoss, lovasz
    from pytorch_toolbelt_tpu_torch.ops import bitonic_sort_chunked, split_sort

    gen = torch.Generator().manual_seed(4)
    probas = torch.softmax(torch.randn(2, 19, 32, 32, generator=gen), 1)
    labels = torch.randint(0, 19, (2, 32, 32), generator=gen)
    values = []
    for split in (False, True):
        lovasz.SPLIT_SORT = split
        try:
            x = probas.to(dev).requires_grad_(True)
            k4, k5 = bitonic_sort_chunked.launches, split_sort.launches
            value = LovaszLoss()(x, labels.to(dev))
            value.backward()
            assert (split_sort.launches - k5, bitonic_sort_chunked.launches - k4) == ((1, 0) if split else (0, 1))
            values.append((value.detach(), x.grad))
        finally:
            lovasz.SPLIT_SORT = False
    # both sorts are stable and equal bit for bit, so the two routes agree exactly
    assert torch.equal(values[0][0], values[1][0]) and torch.equal(values[0][1], values[1][1])


# ---------------------------------------------------------------------------
# Every C entry point leaves the calling thread on the device it was on
# ---------------------------------------------------------------------------


def _launch_each_entry_point(name, dev):
    gen = torch.Generator().manual_seed(5)
    if name == "grid_merge":
        tiles, weight, grid, _ = _grid(32, 32, 16, 16, 3, 4, k=2, seed=5, dtype=torch.float32, dev=dev)
        grid_merge(tiles, weight, grid)
    elif name == "scatter_merge":
        accumulate_tiles(*_scatter_case(2, 64, 64, 32, 32, [(0, 0), (8, 8)], torch.float32, dev))
    elif name == "qconv2d":
        x = torch.randint(-127, 128, (1, 16, 8, 8), generator=gen, dtype=torch.int8)
        w = torch.randint(-127, 128, (8, 16, 3, 3), generator=gen, dtype=torch.int8)
        qconv2d(x.to(dev).contiguous(memory_format=torch.channels_last), _to(pack_qconv2d_weights(w), dev),
                padding=(1, 1, 1, 1))
    elif name in ("q_upsample", "q_upsample_cat"):
        x = torch.randint(-127, 128, (1, 16, 8, 8), generator=gen, dtype=torch.int8)
        mh, mw, _ = _q_upsample_matrices(8, 8, 16, 16)
        x = x.to(dev).contiguous(memory_format=torch.channels_last)
        if name == "q_upsample":
            q_upsample(x, mh, mw)
        else:
            q_upsample_cat(x, torch.zeros(1, 16, 16, 16, dtype=torch.int8, device=dev).contiguous(
                memory_format=torch.channels_last), mh, mw)
    elif name == "q_add":
        x = torch.randint(-127, 128, (1, 16, 8, 8), generator=gen, dtype=torch.int8).to(dev).contiguous(
            memory_format=torch.channels_last)
        m = torch.full((16,), 4096, dtype=torch.int32, device=dev)
        q_add(x, x, m, m, True, torch.ones(1, 16, dtype=torch.int32, device=dev))
    elif name in ("conv3x3_tma_wgmma", "conv3x3_ld_wgmma", "conv3x3_wmma"):
        c_in = 3 if name == "conv3x3_ld_wgmma" else 16
        pack = _pack_wmma if name == "conv3x3_wmma" else pack_conv3x3_weights
        x = torch.randn(1, c_in, 8, 8, generator=gen).to(dev, torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        conv3x3(x, pack(torch.randn(8, c_in, 3, 3, generator=gen)).to(dev), torch.ones(8, device=dev),
                torch.zeros(8, device=dev))
    else:
        keys, payload = torch.randn(2, 100, generator=gen).to(dev), torch.arange(200, dtype=torch.int32).to(dev)
        _sorts()[name](keys, payload.reshape(2, 100))


@pytest.mark.parametrize("name", ["grid_merge", "scatter_merge", "conv3x3_tma_wgmma", "conv3x3_ld_wgmma",
                                  "conv3x3_wmma", "K4", "K5", "qconv2d", "q_upsample", "q_upsample_cat", "q_add"])
def test_entry_points_restore_the_current_device(dev, name):
    """A launch on cuda:1 tensors from a thread on cuda:0 leaves it on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        _launch_each_entry_point(name, other)
        torch.cuda.synchronize(other)
        assert torch.cuda.current_device() == 0


# ---------------------------------------------------------------------------
# Training (slice F): one step on the card against the CPU; prefetch_to_device
# ---------------------------------------------------------------------------


def _narrow_seresnext_fpn():
    from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, SENetEncoder

    encoder = SENetEncoder(kind="seresnext", stage_blocks=(1, 1, 1, 1), groups=32, base_width=4)
    decoder = FPNDecoder(encoder.get_output_spec(), out_channels=32)
    return EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(), num_classes=5))


@pytest.mark.parametrize("loss_kind", ["dice_ce", "ce_lovasz"])
def test_training_step_on_cuda_matches_cpu(dev, loss_kind):
    """One training step of a narrow SEResNeXt-FPN (train mode, the port's
    BatchNorm2d) on the card and on the CPU: the loss within 1e-4 relative,
    every gradient within 1e-3 * max|g| over the model (cuDNN and the CPU's
    convolutions add in other orders through 16 BatchNorms in train mode),
    the running statistics within 1e-5 (absolute + relative); then the
    example's AdamW step runs on the card."""
    import copy

    from pytorch_toolbelt_tpu_torch import losses as L
    from pytorch_toolbelt_tpu_torch.ops import bitonic_sort_chunked
    from pytorch_toolbelt_tpu_torch.optimization import make_optimizer

    torch.manual_seed(0)
    cpu_model = _narrow_seresnext_fpn().train()
    cuda_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(1)
    x, y = torch.rand(2, 3, 64, 64, generator=gen), torch.randint(0, 5, (2, 64, 64), generator=gen, dtype=torch.int32)
    if loss_kind == "dice_ce":
        loss_fn = L.JointLoss(L.DiceLoss(mode="multiclass"), L.CrossEntropyFocalLoss(), 1.0, 0.5)
    else:
        lovasz = L.LovaszLoss(per_image=False)
        loss_fn = L.JointLoss(L.CrossEntropyFocalLoss(), lambda p, t: lovasz(torch.softmax(p, 1), t), 1.0, 0.5)
    values = []
    for model, device in ((cpu_model, torch.device("cpu")), (cuda_model, dev)):
        before = bitonic_sort_chunked.launches
        value = loss_fn(model(x.to(device)), y.to(device))
        value.backward()
        assert bitonic_sort_chunked.launches - before == (1 if device.type == "cuda" and loss_kind == "ce_lovasz" else 0)
        values.append(value.item())
    assert abs(values[1] - values[0]) <= 1e-4 * abs(values[0])
    scale = max(float(p.grad.abs().max()) for p in cpu_model.parameters())
    for (name, a), (_, b) in zip(cpu_model.named_parameters(), cuda_model.named_parameters()):
        assert float((b.grad.cpu() - a.grad).abs().max()) <= 1e-3 * scale, name
    for (name, a), (_, b) in zip(cpu_model.named_buffers(), cuda_model.named_buffers()):
        if name.endswith(("running_mean", "running_var")):
            assert float(((b.cpu() - a).abs() / (1 + a.abs())).max()) <= 1e-5, name
    before = [p.detach().clone() for p in cuda_model.parameters()]
    make_optimizer(cuda_model, 1e-3, 1e-4, torch.optim.AdamW, apply_weight_decay_on_bias=False,
                   apply_weight_decay_on_norm=False).step()
    after = list(cuda_model.parameters())
    assert all(torch.isfinite(p).all() for p in after)
    assert sum(not torch.equal(a, b) for a, b in zip(after, before)) == len(after)


def test_prefetch_to_device_overlaps_copies_and_keeps_content(dev):
    """Batches go host -> card on a side stream while a kernel runs on the
    consumer's stream, and arrive unchanged.  The consumer frees each batch
    while its stream still reads it (a 20 ms spin, then a sum): without
    record_stream the next copy could take that memory.  The sums are of
    small integers in fp32, exact in any order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pytorch_toolbelt_tpu_torch.datasets import prefetch_to_device

    rng = np.random.RandomState(0)
    host = [(rng.randint(0, 8, (8, 3, 256, 256)).astype(np.float32), rng.randint(0, 5, (8, 256, 256)).astype(np.int32))
            for _ in range(6)]
    want = [(float(x.sum()), int(y.sum())) for x, y in host]
    sums = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x, y in prefetch_to_device(host, size=2, device=dev):
            assert x.is_cuda and y.is_cuda and x.dtype == torch.float32 and y.dtype == torch.int32
            torch.cuda._sleep(20_000_000)  # ~10-20 ms on the consumer's stream
            sums.append((x.sum(), y.sum()))
            del x, y  # freed while the consumer's stream still has to read them
        torch.cuda.synchronize()
    assert [(float(a), int(b)) for a, b in sums] == want
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [(e.time_range.start, e.time_range.end) for e in events if "HtoD" in e.name]
    spins = [(e.time_range.start, e.time_range.end) for e in events if "spin" in e.name.lower()]
    if not copies or not spins:
        pytest.skip("the profiler saw no CUDA copies or kernels here")
    assert any(a < d and c < b for a, b in copies for c, d in spins), "no copy ran while the consumer's kernel ran"


def test_make_mesh_and_prefetch_default_to_the_card(dev):
    from pytorch_toolbelt_tpu_torch.datasets import prefetch_to_device
    from pytorch_toolbelt_tpu_torch.distributed import batch_sharding, make_mesh

    mesh = make_mesh()
    assert mesh.device_type == "cuda" and mesh.mesh_dim_names == ("data", "spatial")
    (x,) = next(prefetch_to_device([(np.arange(12, dtype=np.float32).reshape(4, 3),)], sharding=batch_sharding(mesh)))
    assert x.device == torch.device("cuda", torch.cuda.current_device())
    assert torch.equal(x.cpu(), torch.arange(12.0).reshape(4, 3))


# ---------------------------------------------------------------------------
# The decoders, heads and pools: on the card, against the same module on the CPU
# ---------------------------------------------------------------------------

def _decoder_and_head_cases():
    from pytorch_toolbelt_tpu_torch import nn as tnn
    from pytorch_toolbelt_tpu_torch import zoo
    from pytorch_toolbelt_tpu_torch.core import FeatureMapsSpec

    spec = FeatureMapsSpec((8, 12, 16, 24), (4, 8, 16, 32))
    return {
        "deeplab_v3": lambda: zoo.DeeplabV3Decoder(spec, 5, aspp_channels=16, atrous_rates=(2, 4, 6), dropout=0.0),
        "deeplab_v3_plus": lambda: zoo.DeeplabV3PlusDecoder(spec, 16, aspp_channels=16, low_level_channels=8,
                                                            atrous_rates=(2, 4, 6), dropout=0.0),
        "ppm": lambda: zoo.PPMDecoder(spec, out_channels=16, dropout=0.0),
        "can": lambda: zoo.CANDecoder(spec, out_channels=8),
        "bifpn": lambda: zoo.BiFPNDecoder(spec, out_channels=16, num_layers=2),
        "bifpn_separable": lambda: zoo.BiFPNDecoder(spec, out_channels=16, num_layers=1, separable=True),
        "generic_head": lambda: zoo.GenericPoolingClassificationHead(spec, 5, pool_fn=lambda x: x.amax(dim=(2, 3))),
        "avg_head": lambda: zoo.GlobalAveragePoolingClassificationHead(spec, 5),
        "max_head": lambda: zoo.GlobalMaxPoolingClassificationHead(spec, 5),
        "gem_head": lambda: zoo.GeneralizedMeanPoolingClassificationHead(spec, 5),
        "fc_head": lambda: zoo.FullyConnectedClassificationHead(spec, 5),
        "max_avg_head": lambda: zoo.GlobalMaxAvgPoolingClassificationHead(spec, 5),
        "max_avg_sum_head": lambda: zoo.GlobalMaxAvgSumPoolingClassificationHead(spec, 5),
        "hypercolumn": lambda: zoo.HypercolumnHead(spec, 3, mid_channels=16),
        "deep_supervision": lambda: zoo.DeepSupervisionHead(spec, 3, output_name_prefix="mask"),
        "progressive_shuffle": lambda: zoo.ProgressiveShuffleHead(spec, 3),
        "segformer": lambda: zoo.SegFormerHead(spec, 3, embedding_dim=16, with_supervision=True),
        "resize": lambda: zoo.ResizeHead(spec, 3),
        "fpn_context": lambda: _OnCoarsest(tnn.FPNContextBlock(8, 16), index=0),
        "fpn_bottleneck": lambda: _OnCoarsest(tnn.FPNBottleneckBlock(24, 16)),
        "kmax_pool": lambda: _OnCoarsest(tnn.GlobalKMaxPool2d(k=3)),
        "kmax_pool_fixed": lambda: _OnCoarsest(tnn.GlobalKMaxPool2d(k=3, trainable=False)),
        "gwap": lambda: _OnCoarsest(tnn.GWAP(24)),
        "rms_pool": lambda: _OnCoarsest(tnn.RMSPool()),
        "mil_pool": lambda: _OnCoarsest(tnn.MILCustomPoolingModule(24, 4)),
        "rank_pool": lambda: _OnCoarsest(tnn.GlobalRankPooling(24, 4)),
        "gem_pool": lambda: _OnCoarsest(tnn.GeneralizedMeanPooling2d(l2_normalize=True)),
        "max_avg_pool": lambda: _OnCoarsest(tnn.GlobalMaxAvgPooling2d()),
    }


_DECODERS = ("deeplab_v3", "deeplab_v3_plus", "ppm", "can", "bifpn", "bifpn_separable")


class _OnCoarsest(torch.nn.Module):
    """A block or pool applied to one of the feature maps, the coarsest by default."""

    def __init__(self, block, index=-1):
        super().__init__()
        self.block = block
        self.index = index

    def forward(self, feature_maps, output_size=None):
        return self.block(feature_maps[self.index])


def _same_on_card(got, ref):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        return all(_same_on_card(got[k], ref[k]) for k in ref)
    if isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref)
        return all(_same_on_card(g, r) for g, r in zip(got, ref))
    assert got.is_cuda and got.shape == ref.shape and got.dtype == ref.dtype
    return float((got.cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("name", list(_decoder_and_head_cases()))
def test_decoder_or_head_on_cuda_matches_cpu(dev, name):
    """Each new decoder, head, pool and FPN block at a small size: on the
    card it returns tensors on the card that agree with the same module on
    the CPU in fp32 with TF32 off (1e-4 * max|ref|); a tensor made on the
    CPU inside a forward would fail the call."""
    torch.manual_seed(0)
    module = _decoder_and_head_cases()[name]()
    gen = torch.Generator().manual_seed(1)
    maps = [torch.randn(2, c, 64 // s, 64 // s, generator=gen) for c, s in zip((8, 12, 16, 24), (4, 8, 16, 32))]
    if name in ("gem_head", "gem_pool"):
        maps = [m.abs() for m in maps]
    kwargs = {} if name in _DECODERS else {"output_size": (64, 64)}
    with torch.no_grad():
        ref = module.eval()(maps, **kwargs)
        got = module.to(dev)([m.to(dev) for m in maps], **kwargs)
    assert _same_on_card(got, ref)


# ---------------------------------------------------------------------------
# The transformer and mobile encoders, the rest of nn/, SegFormer: on the card against the CPU
# ---------------------------------------------------------------------------

def _encoder_and_block_cases():
    from pytorch_toolbelt_tpu_torch import nn as tnn
    from pytorch_toolbelt_tpu_torch import zoo

    def segformer():
        encoder = zoo.MixVisionTransformerEncoder(embed_dims=(16, 32, 40, 64))
        return zoo.EncoderDecoderModel(encoder, tnn.Identity(), zoo.SegFormerHead(encoder.get_output_spec(), 3,
                                                                                    embedding_dim=32))

    short_v2 = (("fused", 1, 8, 1, 1), ("fused", 4, 16, 1, 2), ("fused", 4, 16, 1, 2), ("mb", 4, 24, 1, 2),
                ("mb", 6, 32, 1, 2))
    return {  # name: (module factory, NCHW input shape)
        "mit": (lambda: zoo.MixVisionTransformerEncoder(embed_dims=(16, 32, 40, 64), depths=(1, 1, 1, 1)),
                (2, 3, 64, 66)),
        "swin": (lambda: zoo.SwinTransformerEncoder(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4)),
                 (1, 3, 200, 200)),
        "efficientnet": (lambda: zoo.EfficientNetEncoder(width_mult=0.5, depth_mult=0.3), (2, 3, 64, 66)),
        "efficientnet_v2": (lambda: zoo.EfficientNetV2Encoder(config_override=short_v2), (2, 3, 64, 66)),
        "mixnet": (lambda: zoo.MixNetEncoder(width_mult=0.5, depth_mult=0.3), (2, 3, 64, 66)),
        "mobilenet_v2": (lambda: zoo.MobileNetV2Encoder(width_mult=0.5), (2, 3, 64, 66)),
        "mobilenet_v3_large": (lambda: zoo.MobileNetV3Encoder(), (2, 3, 64, 66)),
        "mobilenet_v3_small": (lambda: zoo.MobileNetV3Encoder(small=True), (2, 3, 64, 66)),
        "coord_conv": (lambda: tnn.CoordConv(4, 6, with_r=True), (2, 4, 9, 8)),
        "srm": (lambda: tnn.SRMLayer(8), (4, 8, 6, 5)),
        "dropblock_scheduled_eval": (lambda: tnn.DropBlockScheduled(3, 0.0, 0.5, 3), (2, 4, 10, 10)),
        "self_attention": (lambda: tnn.SelfAttentionBlock2D(8, 6, 10, scale=2), (2, 8, 8, 10)),
        "object_context": (lambda: tnn.ObjectContextBlock(8, 12, 6, 10, sizes=(1, 2)), (2, 8, 8, 8)),
        "asp_object_context": (lambda: tnn.ASPObjectContextBlock(8, 16, dilations=(1, 2, 3)), (2, 8, 8, 8)),
        "pyramid_self_attention": (lambda: tnn.PyramidSelfAttentionBlock2D(8, 4, 8, 10, scale=3), (2, 8, 9, 6)),
        "pyramid_object_context": (lambda: tnn.PyramidObjectContextBlock(8, 12, sizes=(1, 2, 3, 6)), (2, 8, 12, 12)),
        "segformer": (segformer, (2, 3, 128, 128)),
    }


@pytest.mark.parametrize("name", list(_encoder_and_block_cases()))
def test_encoder_or_block_on_cuda_matches_cpu(dev, name):
    """Each new encoder family, nn block and a narrow SegFormer at a small
    size, in eval mode: on the card it returns tensors on the card that agree
    with the same module on the CPU in fp32 with TF32 off (1e-4 * max|ref|);
    Swin's cached mask and position index are copied to the card."""
    torch.manual_seed(0)
    factory, shape = _encoder_and_block_cases()[name]
    module = factory().eval()
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = module(x)
        got = module.to(dev)(x.to(dev))
    assert _same_on_card(got, ref)


def test_dropblock_on_cuda_draws_on_the_card(dev):
    """DropBlock2D in training on a CUDA tensor, with a CUDA generator: the
    mask is drawn and pooled on the card and the mean of ones stays 1."""
    from pytorch_toolbelt_tpu_torch.nn import DropBlock2D

    drop = DropBlock2D(0.2, 3, generator=torch.Generator(device=dev).manual_seed(2)).train()
    out = drop(torch.ones(8, 3, 64, 64, device=dev))
    assert out.is_cuda and 0.14 < float((out == 0).float().mean()) < 0.22
    assert abs(float(out.mean()) - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# The CNN encoders of slice I, HRNetV2 and the torch state-dict loader: on the card against the CPU
# ---------------------------------------------------------------------------

def _cnn_encoder_cases():
    from pytorch_toolbelt_tpu_torch import nn as tnn
    from pytorch_toolbelt_tpu_torch import zoo

    def hrnetv2():
        encoder = zoo.HRNetEncoder(width=8, stage_modules=(1, 1, 1), blocks_per_module=2, stage1_blocks=1)
        return zoo.EncoderDecoderModel(encoder, tnn.Identity(), zoo.HypercolumnHead(encoder.get_output_spec(), 3,
                                                                                      mid_channels=16))

    dpn = dict(stage_blocks=(1, 2, 1, 1), base_width=(16, 16, 32, 32), res_width=(16, 32, 32, 64), inc=(4, 4, 8, 8),
               groups=4, stem_channels=8, small_stem=True)
    return {  # name: (module factory, NCHW input shape)
        "hrnet": (lambda: zoo.HRNetEncoder(width=8, stage_modules=(1, 2, 1), blocks_per_module=1, stage1_blocks=1),
                  (2, 3, 64, 66)),
        "hrnetv2_hypercolumn": (hrnetv2, (2, 3, 128, 128)),
        "se_xresnet": (lambda: zoo.XResNetEncoder(expansion=4, blocks=(1, 1, 1, 1), use_se=True), (2, 3, 64, 64)),
        "res2net": (lambda: zoo.Res2NetEncoder(stage_blocks=(1, 1, 1, 1)), (2, 3, 64, 64)),
        "skresnext": (lambda: zoo.SKResNetEncoder(stage_blocks=(1, 1, 1, 1), bottleneck=True, groups=32,
                                                  base_width=4), (2, 3, 64, 66)),
        "densenet": (lambda: zoo.DenseNetEncoder(block_config=(2, 2, 2, 2), growth_rate=8, num_init_features=16),
                     (2, 3, 64, 66)),
        "dpn": (lambda: zoo.DPNEncoder(**dpn), (2, 3, 64, 66)),
        "dpn_b_style": (lambda: zoo.DPNEncoder(**dpn, b_style=True), (2, 3, 64, 64)),
        "inception_same": (lambda: zoo.InceptionV4Encoder(stage_repeats=(1, 1, 1)), (1, 3, 66, 66)),
        "inception_torch_compat": (lambda: zoo.InceptionV4Encoder(stage_repeats=(1, 1, 1), torch_compat=True),
                                   (1, 3, 99, 99)),
        "wider_resnet16": (lambda: zoo.wider_resnet16_encoder(), (1, 3, 64, 66)),
        "wider_resnet16_a2_dilated": (lambda: zoo.wider_resnet16_a2_encoder(dilation=True), (1, 3, 64, 64)),
    }


@pytest.mark.parametrize("name", list(_cnn_encoder_cases()))
def test_cnn_encoder_on_cuda_matches_cpu(dev, name):
    """Each slice-I encoder family and a narrow HRNetV2 + HypercolumnHead at
    a small size, in eval mode: on the card it returns tensors on the card
    that agree with the same module on the CPU in fp32 with TF32 off (1e-4 *
    max|ref|)."""
    torch.manual_seed(0)
    factory, shape = _cnn_encoder_cases()[name]
    module = factory().eval()
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = module(x)
        got = module.to(dev)(x.to(dev))
    assert _same_on_card(got, ref)


def test_port_torch_state_dict_fills_a_model_on_the_card(dev):
    """A reference-layout state dict on the host fills a WiderResNet16 on
    the card: the tensors stay on the card and equal the state dict's."""
    from pytorch_toolbelt_tpu_torch.zoo import port_torch_state_dict, wider_resnet16_encoder
    from pytorch_toolbelt_tpu_torch.zoo.porting import wider_resnet_mapping

    model = wider_resnet16_encoder().to(dev)
    mapping = wider_resnet_mapping((1, 1, 1, 1, 1, 1))
    gen = torch.Generator().manual_seed(3)
    reference = {"mod1.conv1.weight": torch.randn(64, 3, 3, 3, generator=gen),
                 "mod2.block1.bn1.bn.running_var": torch.rand(64, generator=gen) + 0.5,
                 "mod7.block1.convs.conv3.weight": torch.randn(4096, 2048, 1, 1, generator=gen)}
    port_torch_state_dict(model, reference, mapping, strict=False)
    assert model.mod1_conv1.weight.is_cuda
    torch.testing.assert_close(model.mod1_conv1.weight.cpu(), reference["mod1.conv1.weight"], rtol=0, atol=0)
    torch.testing.assert_close(model.mod2_block1.bn1.running_var.cpu(), reference["mod2.block1.bn1.bn.running_var"],
                               rtol=0, atol=0)
    torch.testing.assert_close(model.mod7_block1.conv3.weight.cpu(), reference["mod7.block1.convs.conv3.weight"],
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The encoders of slice J, a narrow MaxViT + FPN, and the sync BatchNorm: on the card against the CPU
# ---------------------------------------------------------------------------

def _slice_j_cases():
    from pytorch_toolbelt_tpu_torch import zoo

    maxvit = dict(stem_channels=8, stage_channels=(16, 16, 24, 32), stage_blocks=(1, 2, 1, 1), num_heads=(2, 2, 3, 4))

    def maxvit_fpn():
        encoder = zoo.MaxViTEncoder(**maxvit, layers=(1, 2, 3, 4))
        decoder = zoo.FPNDecoder(encoder.get_output_spec(), 16)
        return zoo.EncoderDecoderModel(encoder, decoder, zoo.ResizeHead(decoder.get_output_spec(), 3))

    def nfnet():
        encoder = zoo.NFNetEncoder(stage_blocks=(1, 2, 1, 1), stage_channels=(16, 32, 32, 48))
        with torch.no_grad():
            for m in encoder.modules():
                if isinstance(m, zoo.NFBlock):
                    m.skip_gain.fill_(0.7)  # flax's zero would leave the residual branches out
        return encoder

    return {  # name: (module factory, NCHW input shape)
        "maxvit_padded": (lambda: zoo.MaxViTEncoder(**maxvit), (2, 3, 160, 160)),
        "maxvit_fpn": (maxvit_fpn, (2, 3, 128, 128)),
        "nfnet": (nfnet, (2, 3, 64, 64)),
        "tresnet_odd": (lambda: zoo.TResNetEncoder(width_factor=0.25, stage_blocks=(1, 2, 1, 1)), (2, 3, 68, 68)),
        "stacked_hourglass": (lambda: zoo.StackedHGEncoder(stack_level=2, depth=2, features=16), (2, 3, 64, 60)),
        "squeezenet": (lambda: zoo.SqueezeNetEncoder(), (2, 3, 66, 66)),
    }


@pytest.mark.parametrize("name", list(_slice_j_cases()))
def test_slice_j_encoder_on_cuda_matches_cpu(dev, name):
    """Each slice-J encoder family (MaxViT on a map that pads, NFNet with a
    non-zero ``skip_gain``, TResNet on odd stride-4 maps) and a narrow
    MaxViT + FPN at a small size, in eval mode: on the card it returns
    tensors on the card that agree with the same module on the CPU in fp32
    with TF32 off (1e-4 * max|ref|)."""
    torch.manual_seed(0)
    factory, shape = _slice_j_cases()[name]
    module = factory().eval()
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = module(x)
        got = module.to(dev)(x.to(dev))
    assert _same_on_card(got, ref)


def test_stacked_supervised_hourglass_on_cuda_matches_cpu(dev):
    from pytorch_toolbelt_tpu_torch.zoo import StackedSupervisedHGEncoder

    torch.manual_seed(0)
    module = StackedSupervisedHGEncoder(supervision_channels=2, stack_level=3, depth=2, features=16).eval()
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        features, masks = module(x)
        got_features, got_masks = module.to(dev)(x.to(dev))
    assert _same_on_card(got_features, features) and _same_on_card(got_masks, masks)


def test_sync_batchnorm_in_a_world_of_one_on_cuda_matches_cpu(tmp_path, dev):
    """``SyncBatchNorm2d`` under an nccl group of one, in train mode (its
    all-reduces run on nccl): outputs, running statistics and input
    gradients on the card against the port's ``BatchNorm2d`` on the CPU."""
    from pytorch_toolbelt_tpu_torch.distributed import DistributedGuard, SyncBatchNorm2d
    from pytorch_toolbelt_tpu_torch.nn import BatchNorm2d

    gen = torch.Generator().manual_seed(2)
    x, w = torch.randn(4, 6, 9, 7, generator=gen) * 2 + 1, torch.randn(4, 6, 9, 7, generator=gen)
    plain = BatchNorm2d(6, momentum=0.1).train()
    xc = x.clone().requires_grad_()
    ref = plain(xc)
    (ref * w).sum().backward()
    with DistributedGuard(f"file://{tmp_path}/store", world_size=1, rank=0, backend="nccl"):
        sync = SyncBatchNorm2d(6, momentum=0.1).to(dev).train()
        xg = x.to(dev).requires_grad_()
        got = sync(xg)
        (got * w.to(dev)).sum().backward()
    assert got.is_cuda and _same_on_card(got.detach(), ref.detach()) and _same_on_card(xg.grad, xc.grad)
    torch.testing.assert_close(sync.running_var.cpu(), plain.running_var, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sync.running_mean.cpu(), plain.running_mean, rtol=1e-5, atol=1e-6)
