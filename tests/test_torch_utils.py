"""Parity of the port's ``utils/`` and ``core/support.py`` with the JAX
package's, on the CPU.

The checkpoint round trip is bit for bit: a model and its AdamW state saved
after two steps, loaded into fresh ones with the RNG state restored, take the
third step exactly as the originals do.  Seeding reproduces python's,
numpy's and torch's draws.  The name generator, the python and file helpers
and the tensor helpers are held to the JAX package's on the same inputs
(images CHW here, HWC there).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu import utils as JU
from pytorch_toolbelt_tpu.core import support as jsupport
from pytorch_toolbelt_tpu.utils import tensor as jtensor
from pytorch_toolbelt_tpu.zoo import UNetSegmentationModel as JUNetSegmentationModel
from pytorch_toolbelt_tpu_torch import losses as L
from pytorch_toolbelt_tpu_torch import utils as U
from pytorch_toolbelt_tpu_torch.core import DeprecationError, toolbelt_deprecated
from pytorch_toolbelt_tpu_torch.optimization import make_optimizer
from pytorch_toolbelt_tpu_torch.utils import tensor as T
from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel, flax_name_map

NO_CARD = not torch.cuda.is_available()


def _train_step(model, optimizer):
    """One step of the UNet on a batch drawn from numpy's and torch's global
    RNGs (both restored with the checkpoint); returns the loss."""
    x = torch.from_numpy(np.random.rand(2, 3, 32, 32).astype(np.float32))
    y = torch.from_numpy(np.random.randint(0, 2, (2, 32, 32)))
    noise = torch.randn(2, 3, 32, 32) * 1e-3  # torch's global RNG, restored too
    loss = L.JointLoss(L.DiceLoss(mode="multiclass"), L.CrossEntropyFocalLoss(), 1.0, 0.5)(model(x + noise), y)
    optimizer.zero_grad()
    loss.backward()
    optimizer.step()
    return loss.detach()


def _fresh(seed: int = 0):
    torch.manual_seed(seed)
    model = UNetSegmentationModel(num_classes=2, encoder_channels=8, num_layers=3).train()
    optimizer = make_optimizer(model, 1e-3, 1e-4, torch.optim.AdamW, apply_weight_decay_on_bias=False,
                               apply_weight_decay_on_norm=False)
    return model, optimizer


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    U.set_manual_seed(5)
    model, optimizer = _fresh()
    for _ in range(2):
        _train_step(model, optimizer)
    path = str(tmp_path / "ckpt" / "step2.pt")
    U.save_checkpoint(path, {"model": model, "optimizer": optimizer, "step": 2, "rng": U.get_rng_state()})
    assert U.checkpoint_exists(path)
    want_loss = _train_step(model, optimizer)

    other, other_optimizer = _fresh(seed=99)  # other weights, empty AdamW state
    state = U.load_checkpoint(path, target={"model": other, "optimizer": other_optimizer})
    U.set_rng_state(state["rng"])
    assert state["step"] == 2
    got_loss = _train_step(other, other_optimizer)
    assert torch.equal(got_loss, want_loss)
    for (name, a), (_, b) in zip(model.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), name
    for a, b in zip(optimizer.state_dict()["state"].values(), other_optimizer.state_dict()["state"].values()):
        for key in a:
            assert torch.equal(torch.as_tensor(a[key]), torch.as_tensor(b[key])), key


def test_checkpoint_is_read_with_weights_only(tmp_path, monkeypatch):
    path = str(tmp_path / "c.pt")
    U.save_checkpoint(path, {"rng": U.get_rng_state(), "step": 1})
    calls = []
    load = torch.load
    monkeypatch.setattr(torch, "load", lambda *a, **k: calls.append(k) or load(*a, **k))
    U.load_checkpoint(path)
    assert calls and calls[0]["weights_only"] is True
    torch.load(path, weights_only=True)  # the RNG state holds only numbers, lists and tensors


def test_checkpoint_force_and_target_errors(tmp_path):
    path = str(tmp_path / "c.pt")
    U.save_checkpoint(path, {"step": 1})
    with pytest.raises(FileExistsError):
        U.save_checkpoint(path, {"step": 2}, force=False)
    U.save_checkpoint(path, {"step": 3})
    assert U.load_checkpoint(path)["step"] == 3
    with pytest.raises(TypeError, match="module or an optimizer"):
        U.load_checkpoint(path, target={"step": 3})
    assert not U.checkpoint_exists(str(tmp_path / "missing.pt"))


def test_checkpoint_unwraps_ddp_names(tmp_path):
    """A DDP-wrapped model is stored under its module's names."""
    from pytorch_toolbelt_tpu_torch.distributed import DistributedGuard

    model = torch.nn.Linear(3, 2)
    with DistributedGuard(f"file://{tmp_path}/store", world_size=1, rank=0, backend="gloo", timeout_s=60):
        ddp = torch.nn.parallel.DistributedDataParallel(model)
        U.save_checkpoint(str(tmp_path / "c.pt"), {"model": ddp})
    assert set(U.load_checkpoint(str(tmp_path / "c.pt"))["model"]) == {"weight", "bias"}


def test_set_manual_seed_reproduces_every_rng():
    def draws():
        return random.random(), float(np.random.rand()), float(torch.rand(1))

    gen = U.set_manual_seed(123)
    first = draws()
    assert isinstance(gen, torch.Generator)
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=torch.Generator().manual_seed(123)))
    U.set_manual_seed(123)
    assert draws() == first
    JU.set_manual_seed(123)  # the JAX package seeds python and numpy the same way
    assert draws()[:2] == first[:2]


def test_rng_state_round_trip_is_exact(tmp_path):
    U.set_manual_seed(1)
    np.random.randn()  # leaves a cached gaussian in numpy's state
    state = U.get_rng_state()
    path = str(tmp_path / "rng.pt")
    torch.save(state, path)
    want = (random.random(), random.gauss(0, 1), np.random.randn(3).tolist(), torch.randn(3).tolist())
    U.set_rng_state(torch.load(path, weights_only=True))
    assert (random.random(), random.gauss(0, 1), np.random.randn(3).tolist(), torch.randn(3).tolist()) == want


@pytest.mark.parametrize("seed", [0, 1, 17, 2024])
def test_random_names_match_jax(seed):
    for sep in ("_", "-"):
        assert U.get_random_name(sep, random.Random(seed)) == JU.get_random_name(sep, random.Random(seed))


def test_random_name_skips_boring_wozniak():
    class Rigged(random.Random):
        def __init__(self):
            super().__init__(0)
            self.calls = 0

        def choice(self, seq):
            self.calls += 1
            return {1: "boring", 2: "wozniak"}.get(self.calls, seq[0])

    assert U.get_random_name(rng=Rigged()) == "admiring_albattani"


def test_python_utils_match_jax():
    assert U.maybe_eval("$1 + 2") == JU.maybe_eval("$1 + 2") == 3
    assert U.maybe_eval(["$2*3", "x", 4]) == JU.maybe_eval(["$2*3", "x", 4]) == [6, "x", 4]
    d = {"a": 1, "b": 2, "c": 3}
    assert U.without(d, "a") == JU.without(d, "a") and U.without(d, {"a", "b"}) == JU.without(d, {"a", "b"})
    for v in (512, (256, 257), [3, 4]):
        assert U.as_tuple_of_two(v) == JU.as_tuple_of_two(v)
    with pytest.raises(RuntimeError):
        U.as_tuple_of_two(object())
    text = "lr: 1e-4\nsteps: 10\nname: run\n"
    with pytest.warns(DeprecationWarning):
        got = U.load_yaml(text)
    with pytest.warns(DeprecationWarning):
        assert got == JU.load_yaml(text) == {"lr": 1e-4, "steps": 10, "name": "run"}


def test_toolbelt_deprecated_matches_jax():
    @toolbelt_deprecated("use g")
    def f(x):
        return x + 1

    with pytest.warns(DeprecationWarning, match="use g"):
        assert f(1) == 2
    assert f.__name__ == "f"
    assert issubclass(DeprecationError, Exception) and jsupport.toolbelt_deprecated.__doc__


def test_fs_helpers_match_jax(tmp_path):
    from pytorch_toolbelt_tpu.utils import fs as jfs
    from pytorch_toolbelt_tpu_torch.utils import fs

    (tmp_path / "sub" / "deep").mkdir(parents=True)
    for name in ("a.PNG", "b.jpg", "c.txt", "sub/d.tif", "sub/deep/e.webp", "sub/deep/unique.bin"):
        (tmp_path / name).write_bytes(b"x")
    root = str(tmp_path)
    for fn, args in [("find_in_dir", (root,)), ("find_in_dir_with_ext", (root, [".txt", ".JPG"])),
                     ("find_images_in_dir", (root,)), ("find_images_in_dir_recursive", (root,)),
                     ("find_subdirectories_in_dir", (root,)), ("find_in_dir_glob", (f"{root}/**/*.*", True)),
                     ("has_ext", ("x.PnG", [".png"])), ("has_image_ext", ("x.tiff",)), ("id_from_fname", ("/a/b/c.d.png",)),
                     ("change_extension", ("/a/b.png", "jpg")), ("auto_file", ("unique.bin", root))]:
        assert getattr(fs, fn)(*args) == getattr(jfs, fn)(*args), fn
    with pytest.raises(FileNotFoundError):
        fs.auto_file("nothing.bin", root)
    with pytest.raises(ValueError):
        fs.has_ext("x.png", 3)


def test_image_readers_match_jax(tmp_path):
    import cv2

    rgb = (np.random.RandomState(2).rand(7, 9, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "im.png")
    cv2.imwrite(path, rgb[..., ::-1])
    np.testing.assert_array_equal(U.read_rgb_image(path), JU.read_rgb_image(path))
    np.testing.assert_array_equal(U.read_rgb_image(path), rgb)
    np.testing.assert_array_equal(U.read_image_as_is(path), JU.read_image_as_is(path))


def test_count_parameters_matches_jax():
    jmodel = JUNetSegmentationModel(num_classes=2, encoder_channels=16, num_layers=3)
    params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"]
    model = UNetSegmentationModel(num_classes=2, encoder_channels=16, num_layers=3)
    top = {t: f for t, f in zip(("encoder", "decoder", "head"), ("UnetEncoder_0", "UNetDecoder_0", "ResizeHead_0"))}
    for human in (False, True):
        want = JU.count_parameters(params, human_friendly=human)
        got = U.count_parameters(model, human_friendly=human)
        assert got == {k if k == "total" else next(t for t, f in top.items() if f == k): v for k, v in want.items()}
    assert U.count_parameters(model, keys=["head", "missing"]) == {
        "total": sum(p.numel() for p in model.parameters()), "head": sum(p.numel() for p in model.head.parameters())}
    assert all(flax_name_map(model)[n][1][0] == top[n.split(".")[0]] for n, _ in model.named_parameters())


def test_tensor_conversions_match_jax():
    rng = np.random.RandomState(3)
    image = (rng.rand(5, 6, 3) * 255).astype(np.uint8)
    mask = rng.randint(0, 2, (5, 6)).astype(np.uint8)
    np.testing.assert_array_equal(T.image_to_tensor(image).numpy(), np.asarray(jtensor.image_to_tensor(image)).transpose(2, 0, 1))
    np.testing.assert_array_equal(T.image_to_tensor(mask).numpy(), np.asarray(jtensor.image_to_tensor(mask)).transpose(2, 0, 1))
    assert tuple(T.image_to_tensor(mask, dummy_channels_dim=False).shape) == (5, 6)
    assert T.tensor_from_rgb_image is T.image_to_tensor
    normalized = rng.rand(5, 6, 3).astype(np.float32)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_array_equal(T.rgb_image_from_tensor(torch.from_numpy(normalized.transpose(2, 0, 1)), mean, std),
                                  jtensor.rgb_image_from_tensor(jnp.asarray(normalized), mean, std))
    one = rng.rand(1, 5, 6).astype(np.float32)
    np.testing.assert_array_equal(T.mask_from_tensor(torch.from_numpy(one), squeeze_single_channel=True, dtype=np.uint8),
                                  jtensor.mask_from_tensor(jnp.asarray(one.transpose(1, 2, 0)), True, np.uint8))
    for value in (np.arange(3), [1, 2], (3,), 4, 2.5):
        np.testing.assert_array_equal(T.to_numpy(value), jtensor.to_numpy(value))
    np.testing.assert_array_equal(T.to_numpy(torch.arange(3.0, requires_grad=True)), np.arange(3.0, dtype=np.float32))
    with pytest.raises(ValueError):
        T.to_numpy("x")
    assert T.to_tensor([1, 2], dtype=torch.float32).dtype == torch.float32
    np.testing.assert_array_equal(T.to_tensor(np.arange(4)).numpy(), np.asarray(jtensor.to_tensor(np.arange(4))))
    for value in (999, 1234, 2_500_000, 12_345_678, 3_000_000_000):
        assert T.int_to_string_human_friendly(value) == jtensor.int_to_string_human_friendly(value)


def test_tensor_math_helpers_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 5, 7).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x.transpose(0, 2, 3, 1))
    np.testing.assert_allclose(T.softmax_over(xt).numpy(), np.asarray(jtensor.softmax_over(xj)).transpose(0, 3, 1, 2),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(T.argmax_over(xt).numpy(), np.asarray(jtensor.argmax_over(xj)))
    p = rng.rand(4, 5).astype(np.float32)
    np.testing.assert_allclose(T.logit(torch.from_numpy(p)).numpy(), np.asarray(jtensor.logit(jnp.asarray(p))), rtol=1e-6)
    np.testing.assert_array_equal(T.sigmoid_with_threshold(torch.from_numpy(x)).numpy(),
                                  np.asarray(jtensor.sigmoid_with_threshold(jnp.asarray(x))))
    target = torch.zeros(2, 3, 9, 11)
    for mode in ("bilinear", "nearest"):
        want = jtensor.resize_like(xj, jnp.zeros((2, 9, 11, 3)), mode=mode)
        np.testing.assert_allclose(T.resize_like(xt, target, mode=mode).numpy(),
                                   np.asarray(want).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-6)


def test_describe_outputs_matches_jax():
    x = np.random.RandomState(5).randn(2, 3).astype(np.float32)
    outputs = {"a": torch.from_numpy(x), "b": [torch.arange(4), "s"]}
    joutputs = {"a": jnp.asarray(x), "b": [jnp.arange(4), "s"]}
    got, want = T.describe_outputs(outputs), jtensor.describe_outputs(joutputs)
    assert got["a"] == want["a"] and got["b"][1] == want["b"][1]
    assert {k: v for k, v in got["b"][0].items() if k != "dtype"} == {k: v for k, v in want["b"][0].items() if k != "dtype"}


def test_transfer_weights_copies_matching_entries():
    source = UNetSegmentationModel(num_classes=3, encoder_channels=8, num_layers=3)
    target = UNetSegmentationModel(num_classes=2, encoder_channels=8, num_layers=3)
    model, transferred, skipped = T.transfer_weights(target, source.state_dict())
    assert model is target
    assert skipped and set(skipped) == {
        n for n, v in target.state_dict().items() if v.shape != source.state_dict()[n].shape}
    for name in transferred:
        assert torch.equal(target.state_dict()[name], source.state_dict()[name])
    assert set(transferred) | set(skipped) == set(target.state_dict())


def test_move_to_device_and_container_to_tensor():
    tree = {"x": np.arange(3, dtype=np.float32), "y": [torch.ones(2), "name", (np.zeros(1), 5)],
            "s": np.array(["a", "b"])}
    moved = T.move_to_device(tree, "cpu", non_blocking=True)
    assert isinstance(moved["x"], torch.Tensor) and isinstance(moved["y"][2][0], torch.Tensor)
    assert moved["y"][1] == "name" and moved["y"][2][1] == 5 and isinstance(moved["s"], np.ndarray)
    converted = T.container_to_tensor(tree)
    want = jtensor.container_to_tensor({"x": tree["x"], "y": ["name", (np.zeros(1), 5)], "s": tree["s"]})
    assert isinstance(converted["x"], torch.Tensor) and isinstance(want["x"], jax.Array)
    np.testing.assert_array_equal(converted["x"].numpy(), np.asarray(want["x"]))
    assert isinstance(converted["s"], np.ndarray) and isinstance(want["s"], np.ndarray)


def test_benchmark_and_timer_on_the_cpu():
    result = U.benchmark(lambda a: a * 2, torch.ones(8), iters=3, warmup=1, device="cpu")
    assert set(result) == {"mean_s", "best_s", "iters"} and result["iters"] == 3
    assert 0 <= result["best_s"] <= result["mean_s"]
    with U.Timer() as t:
        sum(range(1000))
    assert t.elapsed >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with U.trace(str(tmp_path / "trace"), device="cpu"):
        torch.ones(16).mul(2).sum()
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0


@pytest.mark.skipif(not NO_CARD, reason="checks the behaviour without a card")
def test_card_entry_points_raise_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        U.benchmark(lambda: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with U.trace(str(tmp_path)):
            pass
