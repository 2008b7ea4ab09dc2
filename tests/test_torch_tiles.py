"""Parity of the PyTorch port's tiled inference with the JAX package, on the
CPU (the merge through its plain version): ``tiled_apply_d4_tta`` in both
modes with a bridged UNet, an independent numpy oracle on a model that is
not d4-equivariant, ``ImageSlicer``'s border modes, ``TileMerger`` and the
tiling plan.

Images are [H, W, C] in JAX and [C, H, W] in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.inference import ImageSlicer as JImageSlicer
from pytorch_toolbelt_tpu.inference import TileMerger as JTileMerger
from pytorch_toolbelt_tpu.inference import tiled_apply_d4_tta as j_tiled_apply_d4_tta
from pytorch_toolbelt_tpu.inference.tiles import _get_tiled_plan as j_get_tiled_plan
from pytorch_toolbelt_tpu.inference.tiles import _stack_batches as j_stack_batches
from pytorch_toolbelt_tpu.zoo import UNetSegmentationModel as JUNet
from pytorch_toolbelt_tpu_torch.inference import (
    ImageSlicer,
    TileMerger,
    clear_tiled_cache,
    tiled_apply,
    tiled_apply_d4_tta,
)
from pytorch_toolbelt_tpu_torch.inference.tiles import _D4_PARITY_VIEW_PAIRS, _get_tiled_plan, _stack_batches
from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel, fuse_unet_inference, load_flax_variables


def _chw(image_hwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(image_hwc.transpose(2, 0, 1)))


def _hwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(1, 2, 0)


# ---------------------------------------------------------------------------
# Against the JAX pipeline, with a bridged UNet
# ---------------------------------------------------------------------------


def _bridged_unet():
    jmodel = JUNet(num_classes=2, encoder_channels=8, num_layers=3)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float32), jmodel.init(jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3)))
    )
    rng = np.random.RandomState(5)
    stats = variables["batch_stats"]
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.2 * rng.randn(*a.shape) if p[-1].key == "mean" else 0.5 + rng.rand(*a.shape)).astype(
            np.float32), stats)
    tmodel = load_flax_variables(UNetSegmentationModel(num_classes=2, encoder_channels=8, num_layers=3), variables)
    return jmodel, variables, tmodel.eval()


@pytest.fixture(scope="module")
def unet_pair():
    return _bridged_unet()


@pytest.mark.parametrize("mode", ["distributed", "full"])
def test_tiled_apply_d4_tta_matches_jax(unet_pair, mode):
    jmodel, variables, tmodel = unet_pair
    image = np.random.RandomState(11).rand(100, 90, 3).astype(np.float32)

    def j_model(x):
        return jmodel.apply(variables, x)

    want = np.asarray(j_tiled_apply_d4_tta(j_model, jnp.asarray(image), tile_size=32, tile_step=16, batch_size=4,
                                           mode=mode))
    with torch.no_grad():
        got = tiled_apply_d4_tta(tmodel, _chw(image), tile_size=32, tile_step=16, batch_size=4, mode=mode)
    assert got.shape == (2, 100, 90) and got.dtype == torch.float32
    assert np.abs(_hwc(got) - want).max() <= 1e-4 * np.abs(want).max()


def test_tiled_apply_d4_tta_fused_unet_runs_bf16(unet_pair):
    """The main path's model: the fused bf16 forward gives bf16 output that
    stays within bf16 tolerance of the fp32 module path."""
    _, _, tmodel = unet_pair
    image = _chw(np.random.RandomState(12).rand(64, 64, 3).astype(np.float32))
    with torch.no_grad():
        ref = tiled_apply_d4_tta(tmodel, image, 32, 16, batch_size=8, mode="distributed")
    got = tiled_apply_d4_tta(fuse_unet_inference(tmodel), image, 32, 16, batch_size=8, mode="distributed")
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert float((got.float() - ref).abs().max()) <= 5e-2 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# Independent numpy oracle on a model that is not d4-equivariant
# ---------------------------------------------------------------------------

_NP_D4_AUG = (
    lambda t: t,
    lambda t: np.rot90(t, k=-1, axes=(0, 1)),
    lambda t: np.rot90(t, k=2, axes=(0, 1)),
    lambda t: np.rot90(t, k=1, axes=(0, 1)),
    lambda t: np.swapaxes(t, 0, 1),
    lambda t: np.rot90(np.swapaxes(t, 0, 1), k=-1, axes=(0, 1)),
    lambda t: np.rot90(np.swapaxes(t, 0, 1), k=2, axes=(0, 1)),
    lambda t: np.rot90(np.swapaxes(t, 0, 1), k=1, axes=(0, 1)),
)
_NP_D4_DEAUG = (
    lambda t: t,
    lambda t: np.rot90(t, k=1, axes=(0, 1)),
    lambda t: np.rot90(t, k=2, axes=(0, 1)),
    lambda t: np.rot90(t, k=-1, axes=(0, 1)),
    lambda t: np.swapaxes(t, 0, 1),
    lambda t: np.swapaxes(np.rot90(t, k=1, axes=(0, 1)), 0, 1),
    lambda t: np.swapaxes(np.rot90(t, k=2, axes=(0, 1)), 0, 1),
    lambda t: np.swapaxes(np.rot90(t, k=-1, axes=(0, 1)), 0, 1),
)


def _host_tiled_d4_oracle(image_np, model_np, tile_size, tile_step, views_for_tile):
    """numpy tiled d4 inference: pad, slice, per-tile view-averaged
    prediction, pyramid-weighted overlap-add in float64, normalize, crop."""
    slicer = ImageSlicer(image_np.shape[:2], tile_size, tile_step, weight="pyramid")
    th, tw = slicer.tile_size
    padded = np.pad(
        image_np,
        [(slicer.margin_top, slicer.margin_bottom), (slicer.margin_left, slicer.margin_right), (0, 0)],
    )
    w = slicer.weight.astype(np.float32)[..., None]
    k = model_np(padded[:th, :tw]).shape[-1]
    canvas = np.zeros(slicer.target_shape + (k,), dtype=np.float64)
    norm = np.zeros(slicer.target_shape + (1,), dtype=np.float64)
    for x, y, _, _ in slicer.crops:
        tile = padded[y : y + th, x : x + tw]
        views = views_for_tile(y, x)
        pred = np.mean([_NP_D4_DEAUG[v](model_np(_NP_D4_AUG[v](tile))) for v in views], axis=0)
        canvas[y : y + th, x : x + tw] += pred * w
        norm[y : y + th, x : x + tw] += w
    out = canvas / np.clip(norm, np.finfo(np.float64).eps, None)
    return out[
        slicer.margin_top : slicer.margin_top + image_np.shape[0],
        slicer.margin_left : slicer.margin_left + image_np.shape[1],
    ].astype(np.float32)


def _nonequivariant_model():
    """Output depends on absolute tile position through a fixed non-symmetric
    per-pixel pattern, so every d4 view gives different deaugmented values."""
    rng = np.random.RandomState(7)
    pattern = rng.random((32, 32, 1)).astype(np.float32)
    bias = rng.random((32, 32, 1)).astype(np.float32)
    pattern_t = torch.from_numpy(pattern.transpose(2, 0, 1).copy())
    bias_t = torch.from_numpy(bias.transpose(2, 0, 1).copy())

    def model_torch(x):  # [B, C, 32, 32] -> [B, 2, 32, 32]
        a = (x * pattern_t[None]).sum(1, keepdim=True) + bias_t[None]
        b = (x * bias_t[None]).sum(1, keepdim=True)
        return torch.cat([a, b], dim=1)

    def model_np(t):  # [32, 32, C] -> [32, 32, 2]
        a = (t * pattern).sum(-1, keepdims=True) + bias
        b = (t * bias).sum(-1, keepdims=True)
        return np.concatenate([a, b], axis=-1).astype(np.float32)

    return model_torch, model_np


@pytest.mark.parametrize("mode", ["distributed", "full"])
def test_tiled_apply_d4_tta_exact_oracle(mode):
    model_torch, model_np = _nonequivariant_model()
    image = np.random.RandomState(42).random((100, 90, 3)).astype(np.float32)
    out = tiled_apply_d4_tta(model_torch, _chw(image), tile_size=32, tile_step=16, batch_size=4, mode=mode)

    def views_for_tile(y, x):
        if mode == "full":
            return tuple(range(8))
        return _D4_PARITY_VIEW_PAIRS[(y // 16) % 2 * 2 + (x // 16) % 2]

    expected = _host_tiled_d4_oracle(image, model_np, 32, 16, views_for_tile)
    np.testing.assert_allclose(_hwc(out), expected, atol=1e-4)


def test_tiled_apply_distributed_needs_half_step():
    with pytest.raises(ValueError):
        tiled_apply_d4_tta(lambda t: t, torch.zeros(3, 64, 64), tile_size=32, tile_step=8, mode="distributed")
    with pytest.raises(ValueError):
        tiled_apply_d4_tta(lambda t: t, torch.zeros(3, 64, 64), tile_size=32, tile_step=16, mode="bogus")


@pytest.mark.parametrize("acc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile,step", [(32, 16), (32, 32), (24, 10)])
def test_tiled_apply_pixelwise_model_is_identity(acc_dtype, tile, step):
    image = torch.from_numpy(np.random.RandomState(3).rand(3, 70, 61).astype(np.float32))
    out = tiled_apply(lambda t: t[:, :2] * 3.0, image, tile_size=tile, tile_step=step, batch_size=5,
                      accumulator_dtype=acc_dtype)
    tol = 1e-5 if acc_dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out, image[:2] * 3.0, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# ImageSlicer's border modes, against the JAX slicer
# ---------------------------------------------------------------------------

# the five modes by name, then by their cv2.BORDER_* codes
_BORDERS = ["constant", "replicate", "reflect", "wrap", "reflect101", 0, 1, 2, 3, 4]


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("border", _BORDERS, ids=str)
def test_image_slicer_border_modes_match_jax(border, channels):
    """``split``, ``iter_split`` and ``cut_patch`` pad the margins as the JAX
    slicer does, bit for bit, in each border mode, where the step does not
    divide the image (70x90, tile 32, step 24: margins on all four sides).
    The margins are K1's crop offset."""
    shape = (70, 90) + ((channels,) if channels else ())
    image = np.random.RandomState(12).randint(0, 256, shape).astype(np.uint8)
    kwargs = dict(value=7, border_type=border)
    t, j = ImageSlicer(image.shape, 32, 24), JImageSlicer(image.shape, 32, 24)
    margins = ("margin_top", "margin_bottom", "margin_left", "margin_right")
    assert [getattr(t, m) for m in margins] == [getattr(j, m) for m in margins] == [5, 5, 7, 7]
    np.testing.assert_array_equal(t.crops, j.crops)
    np.testing.assert_array_equal(t.bbox_crops, j.bbox_crops)

    def assert_same(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    t_tiles, j_tiles = t.split(image, **kwargs), j.split(image, **kwargs)
    assert len(t_tiles) == len(j_tiles) == len(t.crops) == 12
    for a, b in zip(t_tiles, j_tiles):
        assert_same(a, b)
    for (a, a_coords), (b, b_coords) in zip(t.iter_split(image, **kwargs), j.iter_split(image, **kwargs), strict=True):
        assert_same(a, b)
        np.testing.assert_array_equal(a_coords, b_coords)
    for i in range(len(t.crops)):
        assert_same(t.cut_patch(image, i, **kwargs), j.cut_patch(image, i, **kwargs))


# ---------------------------------------------------------------------------
# TileMerger and the tiling plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", [None, 7])
def test_tile_merger_matches_jax(split):
    """One call with the whole grid takes the grid merge; batches of 7 take
    the slice-add path.  Both match the JAX merger."""
    image = np.random.RandomState(8).random((96, 80, 3)).astype(np.float32)
    slicer = ImageSlicer(image.shape, tile_size=(32, 32), tile_step=(16, 16), weight="pyramid")
    tiles = np.stack(slicer.split(image))
    jm = JTileMerger(slicer.target_shape, channels=3, weight=slicer.weight)
    jm.integrate_batch(jnp.asarray(tiles), slicer.crops)
    want = np.asarray(jm.merge())

    tm = TileMerger(slicer.target_shape, channels=3, weight=slicer.weight, device="cpu")
    t_tiles = torch.from_numpy(tiles.transpose(0, 3, 1, 2).copy())
    step = split or len(tiles)
    for start in range(0, len(tiles), step):
        tm.integrate_batch(t_tiles[start : start + step], slicer.crops[start : start + step])
    got = tm.merge()
    np.testing.assert_allclose(_hwc(got), want, atol=1e-5)
    np.testing.assert_allclose(slicer.crop_to_original_size(_hwc(got)), image, atol=1e-5)


@pytest.mark.parametrize("n,batch", [(361, 64), (100, 32), (49, 16), (7, 8), (0, 4)])
def test_stack_batches_matches_jax(n, batch):
    coords = np.stack([np.arange(n), np.arange(n) * 2], axis=1).astype(np.int32)
    j_main, j_rem = j_stack_batches(coords, batch)
    t_main, t_rem = _stack_batches(coords, batch)
    np.testing.assert_array_equal(t_main.numpy(), np.asarray(j_main))
    np.testing.assert_array_equal(t_rem.numpy(), np.asarray(j_rem))


@pytest.mark.parametrize("partition", ["none", "parity2x2"])
def test_tiled_plan_matches_jax(partition):
    clear_tiled_cache()
    j_plan = j_get_tiled_plan(100, 90, 32, 16, "pyramid", 4, partition)
    t_plan = _get_tiled_plan(100, 90, 32, 16, "pyramid", 4, partition, torch.device("cpu"))
    assert len(t_plan[1]) == len(j_plan[1]) == (1 if partition == "none" else 4)
    for t_group, j_group in zip(t_plan[1] + t_plan[2], j_plan[1] + j_plan[2]):
        np.testing.assert_array_equal(t_group.numpy(), np.asarray(j_group))
    np.testing.assert_array_equal(t_plan[3].numpy(), np.asarray(j_plan[3])[..., 0])
    assert _get_tiled_plan.cache_info().currsize == 1
    clear_tiled_cache()
    assert _get_tiled_plan.cache_info().currsize == 0
