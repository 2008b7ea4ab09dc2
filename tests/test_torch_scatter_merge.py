"""Parity of the port's scatter merge (kernel K3, here through its plain
version on the CPU) with the JAX package: ``accumulate_tiles_reference``
against the Pallas kernel ``pallas_accumulate_tiles`` in interpret mode and
against the XLA scan ``inference.accumulate_tiles``; ``TileMerger(use_pallas=
True)`` against the JAX merger; the functional ``accumulate_tiles``.

Canvases are [H, W, C] in JAX and [C, H, W] in the port, tiles [N, th, tw, C]
and [N, C, th, tw].  Both packages add the tiles in the same order with the
product rounded before the sum, so the tolerance (1e-5) is met with room.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_toolbelt_tpu.ops.tile_merge as jtm
from pytorch_toolbelt_tpu.inference import TileMerger as JTileMerger
from pytorch_toolbelt_tpu.inference.tiles import accumulate_tiles as j_accumulate_tiles
from pytorch_toolbelt_tpu_torch.inference import ImageSlicer, TileMerger, accumulate_tiles
from pytorch_toolbelt_tpu_torch.ops import accumulate_tiles as k3
from pytorch_toolbelt_tpu_torch.ops import accumulate_tiles_reference

TOL = 1e-5


def _case(h, w, c, th, tw, coords, seed, dtype=np.float32):
    """Non-zero starting accumulators (as after earlier batches), tiles, a
    window and coordinates, as numpy in the JAX layout."""
    rng = np.random.RandomState(seed)
    canvas = rng.rand(h, w, c).astype(np.float32)
    norm = rng.rand(h, w, 1).astype(np.float32)
    tiles = rng.randn(len(coords), th, tw, c).astype(np.float32)
    if dtype == "bfloat16":  # values that bf16 holds exactly, so both sides read the same tiles
        tiles = torch.from_numpy(tiles).to(torch.bfloat16).float().numpy()
    weight = (rng.rand(th, tw, 1) + 0.1).astype(np.float32)
    return canvas, norm, tiles, weight, np.asarray(coords, dtype=np.int32)


def _port(canvas, norm, tiles, weight, tile_dtype=torch.float32):
    return (torch.from_numpy(canvas.transpose(2, 0, 1).copy()), torch.from_numpy(norm.transpose(2, 0, 1).copy()),
            torch.from_numpy(tiles.transpose(0, 3, 1, 2).copy()).to(tile_dtype), torch.from_numpy(weight[..., 0]))


def _hwc(t):
    return t.numpy().transpose(1, 2, 0)


# a 3x3 grid of 256^2 tiles at step 128 in shuffled order: every interior
# pixel lies under up to four tiles of the one batch
_GRID = [(y, x) for y in (0, 128, 256) for x in (0, 128, 256)]
_SHUFFLED = [_GRID[i] for i in np.random.RandomState(0).permutation(len(_GRID))]


@pytest.mark.parametrize("channels", [1, 2, 19])
def test_reference_matches_pallas_kernel_and_xla(channels):
    canvas, norm, tiles, weight, coords = _case(512, 512, channels, 256, 256, _SHUFFLED, seed=channels)
    assert jtm.pallas_merge_supported(coords, 256, 256, channels, 1)
    want_c, want_n = jtm.pallas_accumulate_tiles(jnp.asarray(canvas), jnp.asarray(norm), jnp.asarray(tiles),
                                                 jnp.asarray(coords), jnp.asarray(weight), interpret=True)
    xla_c, xla_n = j_accumulate_tiles(jnp.asarray(canvas), jnp.asarray(norm), jnp.asarray(tiles),
                                      jnp.asarray(coords), jnp.asarray(weight))
    t_canvas, t_norm, t_tiles, t_weight = _port(canvas, norm, tiles, weight)
    got_c, got_n = accumulate_tiles_reference(t_canvas, t_norm, t_tiles, coords, t_weight)
    assert got_c is t_canvas and got_n is t_norm  # in place, as the JAX kernel donates its accumulators
    for want_canvas, want_norm in ((want_c, want_n), (xla_c, xla_n)):
        np.testing.assert_allclose(_hwc(got_c), np.asarray(want_canvas), rtol=0, atol=TOL)
        np.testing.assert_allclose(_hwc(got_n), np.asarray(want_norm), rtol=0, atol=TOL)


@pytest.mark.parametrize("tile_dtype", ["float32", "bfloat16"])
def test_reference_matches_xla_on_a_misaligned_geometry(tile_dtype):
    """Odd tile size and odd offsets, which the Pallas kernel's DMA alignment
    rule refuses; the port takes any coordinates inside the canvas."""
    rng = np.random.RandomState(3)
    coords = np.stack([rng.randint(0, 101 - 37 + 1, 11), rng.randint(0, 93 - 29 + 1, 11)], axis=1)
    dtype = np.float32 if tile_dtype == "float32" else "bfloat16"
    canvas, norm, tiles, weight, coords = _case(101, 93, 3, 37, 29, coords, seed=4, dtype=dtype)
    assert not jtm.pallas_merge_supported(coords, 37, 29, 3, 1)
    j_tiles = jnp.asarray(tiles, dtype=jnp.bfloat16 if tile_dtype == "bfloat16" else jnp.float32)
    want_c, want_n = j_accumulate_tiles(jnp.asarray(canvas), jnp.asarray(norm), j_tiles, jnp.asarray(coords),
                                        jnp.asarray(weight))
    t_canvas, t_norm, t_tiles, t_weight = _port(canvas, norm, tiles, weight, getattr(torch, tile_dtype))
    got_c, got_n = accumulate_tiles_reference(t_canvas, t_norm, t_tiles, torch.from_numpy(coords), t_weight)
    np.testing.assert_allclose(_hwc(got_c), np.asarray(want_c), rtol=0, atol=TOL)
    np.testing.assert_allclose(_hwc(got_n), np.asarray(want_n), rtol=0, atol=TOL)


def test_kernel_wrapper_takes_the_reference_on_cpu():
    case = _case(64, 64, 2, 32, 32, [(0, 0), (16, 16), (32, 8)], seed=5)
    coords = case[-1]
    want = accumulate_tiles_reference(*_port(*case[:4])[:3], coords, _port(*case[:4])[3])
    before = k3.launches
    got = k3(*_port(*case[:4])[:3], coords, _port(*case[:4])[3])
    assert k3.launches == before  # no kernel launch on the CPU
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _merger_case():
    image = np.random.RandomState(8).random((600, 500, 2)).astype(np.float32)
    slicer = ImageSlicer(image.shape, tile_size=256, tile_step=128, weight="pyramid")
    return image, slicer, np.stack(slicer.split(image))


def test_tile_merger_scatter_kernel_matches_jax():
    """Streamed in batches of 7 through K3 (the plain version here) and
    through the JAX merger's Pallas kernel in interpret mode."""
    image, slicer, tiles = _merger_case()
    coords_yx = slicer.crops[:, [1, 0]]
    assert jtm.pallas_merge_supported(coords_yx, 256, 256, 2, 1)
    original = jtm.pallas_accumulate_tiles
    jtm.pallas_accumulate_tiles = partial(original, interpret=True)
    try:
        jm = JTileMerger(slicer.target_shape, channels=2, weight=slicer.weight, use_pallas=True)
        for start in range(0, len(tiles), 7):
            jm.integrate_batch(jnp.asarray(tiles[start : start + 7]), slicer.crops[start : start + 7])
        want_image, want_norm, want = np.asarray(jm.image), np.asarray(jm.norm_mask), np.asarray(jm.merge())
    finally:
        jtm.pallas_accumulate_tiles = original

    tm = TileMerger(slicer.target_shape, channels=2, weight=slicer.weight, device="cpu", use_pallas=True)
    t_tiles = torch.from_numpy(tiles.transpose(0, 3, 1, 2).copy())
    for start in range(0, len(tiles), 7):
        tm.integrate_batch(t_tiles[start : start + 7], slicer.crops[start : start + 7])
    np.testing.assert_allclose(_hwc(tm.image), want_image, rtol=0, atol=TOL)
    np.testing.assert_allclose(_hwc(tm.norm_mask), want_norm, rtol=0, atol=TOL)
    got = tm.merge()
    np.testing.assert_allclose(_hwc(got), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(slicer.crop_to_original_size(got).numpy().transpose(1, 2, 0), image, atol=TOL)


def test_tile_merger_scatter_path_equals_slice_adds_on_bf16_batches():
    """The streaming path's contract: bf16 model outputs merged by K3 equal
    the slice-add path bit for bit."""
    _, slicer, tiles = _merger_case()
    t_tiles = torch.from_numpy(tiles.transpose(0, 3, 1, 2).copy()).to(torch.bfloat16)
    merged = []
    for use_pallas in (True, False):
        tm = TileMerger(slicer.target_shape, channels=2, weight=slicer.weight, device="cpu", use_pallas=use_pallas)
        for start in range(0, len(tiles), 5):
            tm.integrate_batch(t_tiles[start : start + 5], slicer.crops[start : start + 5])
        merged.append((tm.image, tm.norm_mask))
    assert torch.equal(merged[0][0], merged[1][0]) and torch.equal(merged[0][1], merged[1][1])


def test_functional_accumulate_tiles_keeps_inputs_valid_unless_donated():
    canvas, norm, tiles, weight, coords = _case(96, 80, 3, 32, 32, [(0, 0), (16, 16), (64, 48), (10, 40)], seed=6)
    want_c, want_n = j_accumulate_tiles(jnp.asarray(canvas), jnp.asarray(norm), jnp.asarray(tiles),
                                        jnp.asarray(coords), jnp.asarray(weight))
    t_canvas, t_norm, t_tiles, _ = _port(canvas, norm, tiles, weight)
    c2, n2 = accumulate_tiles(t_canvas, t_norm, t_tiles, coords, weight)  # [th, tw, 1] window, as JAX takes it
    np.testing.assert_array_equal(_hwc(t_canvas), canvas)
    np.testing.assert_array_equal(_hwc(t_norm), norm)
    c3, _ = accumulate_tiles(t_canvas, t_norm, t_tiles, coords, weight)
    assert torch.equal(c2, c3)
    np.testing.assert_allclose(_hwc(c2), np.asarray(want_c), rtol=0, atol=TOL)
    np.testing.assert_allclose(_hwc(n2), np.asarray(want_n), rtol=0, atol=TOL)

    c4, n4 = accumulate_tiles(t_canvas, t_norm, t_tiles, coords, weight, donate=True)
    assert c4 is t_canvas and n4 is t_norm and torch.equal(c4, c2) and torch.equal(n4, n2)


@pytest.mark.parametrize("coords", [[(-1, 0)], [(0, -3)], [(33, 0)], [(0, 49)], [(40, 60)]])
def test_out_of_canvas_coordinates_raise(coords):
    canvas, norm, tiles, weight = torch.zeros(2, 64, 80), torch.zeros(1, 64, 80), torch.ones(1, 2, 32, 32), torch.ones(32, 32)
    with pytest.raises(ValueError, match="off the"):
        k3(canvas, norm, tiles, coords, weight)


def test_scatter_merge_rejects_bad_geometry_and_types():
    canvas, norm, tiles, weight = torch.zeros(2, 64, 64), torch.zeros(1, 64, 64), torch.ones(2, 2, 32, 32), torch.ones(32, 32)
    with pytest.raises(ValueError, match="coordinates for"):
        k3(canvas, norm, tiles, [(0, 0)], weight)
    with pytest.raises(ValueError, match="weight"):
        k3(canvas, norm, tiles, [(0, 0), (1, 1)], torch.ones(16, 32))
    with pytest.raises(ValueError, match="tiles"):
        k3(canvas, norm, torch.ones(2, 3, 32, 32), [(0, 0), (1, 1)], weight)
    with pytest.raises(TypeError):
        k3(canvas.to(torch.bfloat16), norm, tiles, [(0, 0), (1, 1)], weight)


def test_tile_merger_needs_a_device_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TileMerger((64, 64), channels=1, weight=np.ones((32, 32)))
    merger = TileMerger((64, 64), channels=1, weight=np.ones((32, 32)), device="cpu")
    assert merger.image.device.type == "cpu" and merger.norm_mask.device.type == "cpu"
