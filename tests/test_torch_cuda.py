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


def _sorts():
    from pytorch_toolbelt_tpu_torch.ops import bitonic_sort_chunked, split_sort

    return {"K4": bitonic_sort_chunked, "K5": split_sort}


@pytest.mark.parametrize("pair", [(torch.float32, torch.int32), (torch.int32, torch.float32)], ids=["f32_i32", "i32_f32"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 1000003), (19, 1 << 16), (152, 4099)])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_sort_kernels_equal_sort_reference(dev, kernel, shape, pair):
    from pytorch_toolbelt_tpu_torch.ops import sort_reference

    sort = _sorts()[kernel]
    keys = _awkward_keys(*shape, pair[0], seed=shape[1]).to(dev)
    payload = _payload(*shape, pair[1], seed=shape[1]).to(dev)
    before = sort.launches
    got_k, got_p = sort(keys, payload)
    assert sort.launches == before + 1
    want_k, want_p = sort_reference(keys, payload)
    assert torch.equal(_bits(got_k), _bits(want_k)) and torch.equal(_bits(got_p), _bits(want_p))


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
            assert bitonic_sort_chunked.launches == before + 2  # the forward sort and the backward's
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
            assert (split_sort.launches - k5, bitonic_sort_chunked.launches - k4) == ((2, 0) if split else (0, 2))
            values.append((value.detach(), x.grad))
        finally:
            lovasz.SPLIT_SORT = False
    # both sorts are stable and equal bit for bit, so the two routes agree exactly
    assert torch.equal(values[0][0], values[1][0]) and torch.equal(values[0][1], values[1][1])
