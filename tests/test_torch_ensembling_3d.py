"""Parity of the port's ``inference/ensembling.py`` and
``inference/tiles_3d.py`` with the JAX package on the CPU, on the same
numpy data.

Maps are NHWC and volumes DHWC in JAX; NCHW and ``[C, D, H, W]`` in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.inference import ensembling as JE
from pytorch_toolbelt_tpu.inference import tiles_3d as J3
from pytorch_toolbelt_tpu.zoo import UNetSegmentationModel as JUNet
from pytorch_toolbelt_tpu_torch.inference import (
    ApplySigmoidTo,
    ApplySoftmaxTo,
    Ensembler,
    PickModelOutput,
    SelectByIndex,
    VolumeMerger,
    VolumeSlicer,
    average_checkpoints,
    compute_pyramid_patch_weight_loss_3d,
    tiled_apply_3d,
)
from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel, load_flax_variables


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


# ---------------------------------------------------------------------------
# Ensembling
# ---------------------------------------------------------------------------

# per-member scale and offset: member outputs stay in (0, 1) for every reduction
_MEMBERS = ((0.5, 0.1), (0.8, 0.05), (0.3, 0.4))


def _members(kind: str):
    """Three models of one input map with tensor, dict or list outputs (the
    same arithmetic on JAX and torch arrays)."""
    def member(scale, offset):
        def fn(x):
            y = x * scale + offset
            if kind == "dict":
                return {"mask": y, "aux": 1.0 - y}
            if kind == "list":
                return [y, y * y]
            return y
        return fn

    return [member(s, o) for s, o in _MEMBERS]


def _cmp(got, want, atol=1e-6):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(_nhwc(got[key]), np.asarray(want[key]), rtol=1e-5, atol=atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-5, atol=atol)
    else:
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("reduction", ["mean", "sum", "gmean", "hmean", "harmonic1p", "logodd", "log1p"])
@pytest.mark.parametrize("kind", ["tensor", "dict", "list"])
def test_ensembler_matches_jax(kind, reduction):
    x = np.random.RandomState(1).rand(2, 6, 5, 3).astype(np.float32)
    want = JE.Ensembler(_members(kind), reduction=reduction)(jnp.asarray(x))
    got = Ensembler(_members(kind), reduction=reduction)(_nchw(x))
    _cmp(got, want)


@pytest.mark.parametrize("kind,outputs", [("dict", ["mask"]), ("list", [1]), ("tensor", [0])])
def test_ensembler_selected_outputs_match_jax(kind, outputs):
    x = np.random.RandomState(2).rand(2, 4, 4, 2).astype(np.float32)
    want = JE.Ensembler(_members(kind), outputs=outputs)(jnp.asarray(x))
    got = Ensembler(_members(kind), outputs=outputs)(_nchw(x))
    if kind == "tensor":  # output[0] of a tensor is its first image: [C, H, W] here, [H, W, C] in JAX
        got, want = [g[None] for g in got], [w[None] for w in want]
    _cmp(got, want)
    if kind == "dict":
        assert set(got) == {"mask"}


def test_ensembler_selected_tensor_output_reduces_over_the_members():
    x = np.random.RandomState(5).rand(2, 3, 4, 4).astype(np.float32)
    members = [lambda t, k=k: t * k for k in (1.0, 2.0, 3.0)]
    want = JE.Ensembler(members, outputs=[0])(jnp.asarray(x))
    got = Ensembler(members, outputs=[0])(torch.from_numpy(x))
    assert len(got) == len(want) == 1 and got[0].shape == (3, 4, 4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), 2 * x[0], rtol=1e-6)


def test_ensembler_reduction_none_and_callable():
    x = _nchw(np.random.RandomState(3).rand(2, 4, 4, 2).astype(np.float32))
    stacked = Ensembler(_members("tensor"), reduction=None)(x)
    assert stacked.shape == (3, 2, 2, 4, 4)
    got = Ensembler(_members("tensor"), reduction=lambda t, dim: t.amax(dim=dim))(x)
    torch.testing.assert_close(got, stacked.amax(0), rtol=0, atol=0)


def _bridged_unets(seeds):
    jmodel = JUNet(num_classes=2, encoder_channels=8, num_layers=3)
    pairs = []
    for seed in seeds:
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, dtype=np.float32), jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3))))
        rng = np.random.RandomState(seed)
        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (0.2 * rng.randn(*a.shape) if p[-1].key == "mean" else 0.5 + rng.rand(*a.shape)).astype(
                np.float32), variables["batch_stats"])
        tmodel = load_flax_variables(UNetSegmentationModel(num_classes=2, encoder_channels=8, num_layers=3), variables)
        pairs.append((variables, tmodel.eval()))
    return jmodel, pairs


def test_ensembler_from_stacked_matches_a_list_and_jax():
    jmodel, pairs = _bridged_unets([1, 2, 3])
    x = np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[v for v, _ in pairs])
    want = JE.Ensembler.from_stacked(lambda p, t: jmodel.apply(p, t), stacked)(jnp.asarray(x))
    models = [m for _, m in pairs]
    with torch.no_grad():
        got = Ensembler.from_stacked(models)(_nchw(x))
        listed = Ensembler(models)(_nchw(x))
    assert got.shape == (2, 2, 32, 32)
    torch.testing.assert_close(got, listed, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-4 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_apply_softmax_and_sigmoid_match_jax(temperature):
    logits = np.random.RandomState(5).randn(2, 5, 4, 3).astype(np.float32)
    for kind in ("dict", "list"):
        key = "logits" if kind == "dict" else 0

        def model(x):
            return {"logits": x, "other": x * 2} if kind == "dict" else [x, x * 2]

        for j_cls, t_cls in ((JE.ApplySoftmaxTo, ApplySoftmaxTo), (JE.ApplySigmoidTo, ApplySigmoidTo)):
            want = j_cls(model, key, temperature=temperature)(jnp.asarray(logits))
            got = t_cls(model, key, temperature=temperature)(_nchw(logits))
            _cmp(got, want)
    probs = ApplySoftmaxTo(lambda x: {"logits": x}, "logits")(_nchw(logits))["logits"]  # over dim 1, NCHW
    torch.testing.assert_close(probs.sum(1), torch.ones(2, 5, 4))


def test_pick_and_select_match_jax():
    x = np.random.RandomState(6).rand(2, 3, 3, 1).astype(np.float32)
    for key, model in (("b", lambda t: {"a": t, "b": t * 2}), (1, lambda t: [t, t * 2])):
        want = JE.PickModelOutput(model, key)(jnp.asarray(x))
        np.testing.assert_array_equal(_nhwc(PickModelOutput(model, key)(_nchw(x))), np.asarray(want))
        np.testing.assert_array_equal(_nhwc(SelectByIndex(key)(model(_nchw(x)))),
                                      np.asarray(JE.SelectByIndex(key)(model(jnp.asarray(x)))))


@pytest.mark.parametrize("count", [1, 2, 3])
def test_average_checkpoints_matches_jax(count):
    rng = np.random.RandomState(count)
    states = [{"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32),
               "num_batches_tracked": np.asarray(rng.randint(0, 100), dtype=np.int64)} for _ in range(count)]
    want = JE.average_checkpoints([jax.tree_util.tree_map(jnp.asarray, s) for s in states])
    got = average_checkpoints([{k: torch.from_numpy(np.asarray(v)) for k, v in s.items()} for s in states])
    assert set(got) == set(want)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=1e-6)
    np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]), rtol=1e-6)
    assert got["num_batches_tracked"].dtype == torch.int64
    assert int(got["num_batches_tracked"]) == int(want["num_batches_tracked"]) == sum(
        int(s["num_batches_tracked"]) for s in states) // count
    with pytest.raises(ValueError):
        average_checkpoints([])


def test_average_checkpoints_of_bridged_models():
    _, pairs = _bridged_unets([7, 8])
    states = [m.state_dict() for _, m in pairs]
    avg = average_checkpoints(states)
    for key, value in avg.items():
        if torch.is_floating_point(value):
            torch.testing.assert_close(value, (states[0][key] + states[1][key]) / 2)
        else:
            assert torch.equal(value, (states[0][key] + states[1][key]) // 2)
    UNetSegmentationModel(num_classes=2, encoder_channels=8, num_layers=3).load_state_dict(avg)


# ---------------------------------------------------------------------------
# 3D tiles
# ---------------------------------------------------------------------------

_GEOMETRIES = [((20, 33, 27), 8, 4), ((16, 16, 16), (8, 6, 4), (4, 3, 2)), ((9, 40, 12), (9, 16, 8), (9, 8, 8))]


@pytest.mark.parametrize("shape,size,step", _GEOMETRIES)
@pytest.mark.parametrize("weight", ["mean", "pyramid"])
def test_volume_slicer_matches_jax(shape, size, step, weight):
    t, j = VolumeSlicer(shape, size, step, weight=weight), J3.VolumeSlicer(shape, size, step, weight=weight)
    np.testing.assert_array_equal(t.crops, j.crops)
    np.testing.assert_array_equal(t.weight, j.weight)
    assert t.target_shape == j.target_shape
    margins = ("margin_front", "margin_back", "margin_top", "margin_bottom", "margin_left", "margin_right")
    assert [getattr(t, m) for m in margins] == [getattr(j, m) for m in margins]
    volume = np.random.RandomState(0).rand(*shape, 2).astype(np.float32)
    t_tiles, j_tiles = t.split(volume), j.split(volume)
    assert len(t_tiles) == len(j_tiles) == len(t.crops)
    for a, b in zip(t_tiles, j_tiles):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.merge(t_tiles), j.merge(j_tiles))
    np.testing.assert_allclose(t.merge(t_tiles), volume, atol=1e-6)


@pytest.mark.parametrize("dims", [(8, 8, 8), (5, 12, 7), (1, 4, 9)])
def test_pyramid_weight_3d_matches_jax(dims):
    np.testing.assert_array_equal(compute_pyramid_patch_weight_loss_3d(*dims),
                                  J3.compute_pyramid_patch_weight_loss_3d(*dims))


def test_volume_slicer_rejects_bad_steps_and_shapes():
    with pytest.raises(ValueError):
        VolumeSlicer((16, 16, 16), 8, 9)
    with pytest.raises(ValueError):
        VolumeSlicer((16, 16, 16), (8, 8), 4)
    with pytest.raises(ValueError):
        VolumeSlicer((16, 16, 16), 8, 4).split(np.zeros((16, 16, 15)))


@pytest.mark.parametrize("batch", [1, 5, None])
def test_volume_merger_matches_jax(batch):
    shape = (20, 33, 27)
    slicer = VolumeSlicer(shape, 8, 4, weight="pyramid")
    volume = np.random.RandomState(1).rand(*shape, 3).astype(np.float32)
    tiles = np.stack(slicer.split(volume))  # [N, d, h, w, C]
    jm = J3.VolumeMerger(slicer.target_shape, channels=3, weight=slicer.weight)
    tm = VolumeMerger(slicer.target_shape, channels=3, weight=slicer.weight, device="cpu")
    t_tiles = torch.from_numpy(np.ascontiguousarray(np.moveaxis(tiles, -1, 1)))
    step = batch or len(tiles)
    for start in range(0, len(tiles), step):
        jm.integrate_batch(jnp.asarray(tiles[start : start + step]), slicer.crops[start : start + step])
        tm.integrate_batch(t_tiles[start : start + step], slicer.crops[start : start + step])
    want = np.asarray(jm.merge())
    got = tm.merge()
    assert got.shape == (3,) + slicer.target_shape
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 0, -1), want, atol=1e-5)
    np.testing.assert_allclose(np.moveaxis(slicer.crop_to_original_size(got).numpy(), 0, -1), volume, atol=1e-5)


def test_volume_merger_allocates_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VolumeMerger((8, 8, 8), channels=1, weight=np.ones((4, 4, 4), np.float32))


def _conv3d_pair(c_in, c_out, seed):
    """A 3x3x3 conv + ReLU + 1x1x1 conv as a torch module and the same
    function in JAX, from one set of numpy weights."""
    rng = np.random.RandomState(seed)
    w1 = (rng.randn(8, c_in, 3, 3, 3) * 0.3).astype(np.float32)
    b1 = (rng.randn(8) * 0.1).astype(np.float32)
    w2 = (rng.randn(c_out, 8, 1, 1, 1) * 0.3).astype(np.float32)
    net = torch.nn.Sequential(torch.nn.Conv3d(c_in, 8, 3, padding=1), torch.nn.ReLU(),
                              torch.nn.Conv3d(8, c_out, 1, bias=False))
    with torch.no_grad():
        net[0].weight.copy_(torch.from_numpy(w1))
        net[0].bias.copy_(torch.from_numpy(b1))
        net[2].weight.copy_(torch.from_numpy(w2))

    def j_net(x):  # [B, d, h, w, C]
        dn = ("NDHWC", "DHWIO", "NDHWC")
        y = jax.lax.conv_general_dilated(x, jnp.asarray(w1.transpose(2, 3, 4, 1, 0)), (1, 1, 1), "SAME",
                                         dimension_numbers=dn) + b1
        y = jax.nn.relu(y)
        return jax.lax.conv_general_dilated(y, jnp.asarray(w2.transpose(2, 3, 4, 1, 0)), (1, 1, 1), "SAME",
                                            dimension_numbers=dn)

    return net.eval(), j_net


@pytest.mark.parametrize("batch", [2, 7])
@pytest.mark.parametrize("shape,size,step", _GEOMETRIES[:2])
def test_tiled_apply_3d_matches_jax(shape, size, step, batch):
    net, j_net = _conv3d_pair(2, 3, seed=len(shape) + batch)
    volume = np.random.RandomState(2).rand(*shape, 2).astype(np.float32)
    want = np.asarray(J3.tiled_apply_3d(j_net, jnp.asarray(volume), size, step, batch_size=batch))
    with torch.no_grad():
        got = tiled_apply_3d(net, torch.from_numpy(np.ascontiguousarray(np.moveaxis(volume, -1, 0))), size, step,
                             batch_size=batch)
    assert got.shape == (3,) + shape and got.dtype == torch.float32
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 0, -1), want, atol=1e-5)


@pytest.mark.parametrize("weight", ["mean", "pyramid"])
def test_tiled_apply_3d_pointwise_model_is_identity_and_runs_each_tile_once(weight):
    volume = torch.from_numpy(np.random.RandomState(3).rand(2, 20, 33, 27).astype(np.float32))
    batches = []

    def model(tiles):
        batches.append(len(tiles))
        return tiles * 3.0

    out = tiled_apply_3d(model, volume, 8, 4, weight=weight, batch_size=7)
    torch.testing.assert_close(out, volume * 3.0, rtol=0, atol=1e-5)
    n_tiles = len(VolumeSlicer((20, 33, 27), 8, 4).crops)
    assert sum(batches) == n_tiles and max(batches) <= 7 and max(batches) - min(batches[:-1] or batches) == 0
