"""Parity of the port's ``datasets/`` and the training half of
``distributed/mesh.py`` with the JAX package's, on the CPU.

Collate, the dataset wrappers (seeded), mean/std, the segmentation helpers
and the sample keys run the same numpy code in both packages; each is held
to JAX's on the same data, bit for bit.  ``prefetch_to_device`` on the CPU
keeps the order and content of JAX's; under ``batch_sharding`` each rank
takes the rows JAX's ``data`` axis gives that device.  The entry points
raise without a card unless given the CPU.
"""

import copy
import random

import jax
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu import datasets as JD
from pytorch_toolbelt_tpu.distributed import batch_sharding as jbatch_sharding
from pytorch_toolbelt_tpu.distributed import make_mesh as jmake_mesh
from pytorch_toolbelt_tpu_torch import datasets as D
from pytorch_toolbelt_tpu_torch.distributed import (
    DistributedGuard,
    MeshSharding,
    batch_sharding,
    batch_spatial_sharding,
    data_parallel,
    local_part,
    make_mesh,
    replicated,
)

NO_CARD = not torch.cuda.is_available()


def _samples(n: int, seed: int):
    rng = np.random.RandomState(seed)
    return [
        {"image": rng.rand(3, 4, 5).astype(np.float32), "mask": rng.randint(0, 3, (4, 5)).astype(np.int32),
         "id": f"sample_{i}", "index": i, "weight": float(rng.rand()), "pair": (rng.rand(2), np.int64(i))}
        for i in range(n)
    ]


def _assert_same_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("n", [1, 4])
def test_default_collate_matches_jax(n):
    batch = _samples(n, seed=n)
    got = D.default_collate(batch)
    _assert_same_tree(got, JD.default_collate(batch))
    assert isinstance(got["image"], np.ndarray) and got["image"].shape == (n, 3, 4, 5)


def test_get_collate_for_dataset_matches_jax():
    def special(batch):
        return batch

    class WithCollate(list):
        def get_collate_fn(self):
            return special

    class Concat:
        def __init__(self, *datasets):
            self.datasets = datasets

    for module in (D, JD):
        assert module.get_collate_for_dataset([1, 2]) is module.default_collate
        assert module.get_collate_for_dataset(WithCollate([1])) is special
        assert module.get_collate_for_dataset(Concat(WithCollate([1]), WithCollate([2]))) is special
        with pytest.raises(ValueError, match="different collate"):
            module.get_collate_for_dataset(Concat(WithCollate([1]), [2]))
        subset = module.RandomSubsetDataset(WithCollate([1, 2]), 3)
        assert module.get_collate_for_dataset(subset) is special


@pytest.mark.parametrize("weighted", [False, True])
def test_random_subset_dataset_matches_jax_seeded(weighted):
    data = list(range(10))
    weights = np.linspace(0.1, 1.0, 10) if weighted else None
    draws = []
    for module in (JD, D):
        random.seed(7)
        ds = module.RandomSubsetDataset(data, 25, weights=weights)
        draws.append([ds[i] for i in range(len(ds))])
    assert draws[0] == draws[1] and len(draws[1]) == 25
    with pytest.raises(ValueError, match="Length of weights"):
        D.RandomSubsetDataset(data, 5, weights=np.ones(3))


def test_random_subset_with_mask_dataset_matches_jax_seeded():
    data = [f"item{i}" for i in range(8)]
    mask = np.array([0, 1, 0, 1, 1, 0, 0, 1], dtype=bool)
    draws = []
    for module in (JD, D):
        random.seed(3)
        ds = module.RandomSubsetWithMaskDataset(data, mask, 20)
        draws.append([ds[i] for i in range(len(ds))])
    assert draws[0] == draws[1]
    assert set(draws[1]) <= {data[i] for i in np.flatnonzero(mask)}
    for bad in (mask.astype(np.int32), np.zeros(8, dtype=bool), mask[:4]):
        with pytest.raises(ValueError):
            D.RandomSubsetWithMaskDataset(data, bad, 5)


@pytest.mark.parametrize("channels,masked", [(3, False), (3, True), (1, False)])
def test_mean_std_calculator_matches_jax(channels, masked):
    rng = np.random.RandomState(channels + masked)
    calcs = [JD.DatasetMeanStdCalculator(channels), D.DatasetMeanStdCalculator(channels)]
    for _ in range(4):
        image = rng.rand(6, 7, channels) if channels > 1 else rng.rand(6, 7)
        mask = rng.rand(6, 7) > 0.5 if masked else None
        for calc in calcs:
            calc.accumulate(image, mask)
    (jm, js), (m, s) = calcs[0].compute(), calcs[1].compute()
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(calcs[1].global_max, calcs[0].global_max)
    with pytest.raises(RuntimeError):
        D.DatasetMeanStdCalculator(2).accumulate(rng.rand(4, 4, 3))


def test_segmentation_helpers_match_jax():
    rng = np.random.RandomState(0)
    mask = np.zeros((40, 40), np.uint8)
    mask[10:25, 12:30] = 1
    for fn in ("mask_to_bce_target", "mask_to_ce_target"):
        for m in (mask, mask[..., None]):
            got, want = getattr(D, fn)(m), getattr(JD, fn)(m)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(D.compute_weight_mask(mask, 3.0), JD.compute_weight_mask(mask, 3.0))
    np.testing.assert_array_equal(D.compute_weight_mask(np.zeros_like(mask)), JD.compute_weight_mask(np.zeros_like(mask)))
    labels = rng.randint(0, 4, (5, 6, 9))
    np.testing.assert_array_equal(D.block_reduce_dominant_label(labels), JD.block_reduce_dominant_label(labels))


def test_read_binary_mask_matches_jax(tmp_path):
    from PIL import Image

    path = str(tmp_path / "mask.png")
    Image.fromarray((np.random.RandomState(1).rand(9, 11) > 0.5).astype(np.uint8) * 255).save(path)
    got = D.read_binary_mask(path)
    np.testing.assert_array_equal(got, JD.read_binary_mask(path))
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 1}


def test_sample_keys_match_jax():
    from pytorch_toolbelt_tpu.datasets import common as jcommon
    from pytorch_toolbelt_tpu_torch.datasets import common

    assert common.__all__ == jcommon.__all__
    for name in common.__all__:
        if name.isupper():
            assert getattr(common, name) == getattr(jcommon, name)
    assert common.name_for_stride("X", 4) == jcommon.name_for_stride("X", 4) == "X_STRIDE_4"
    assert common.name_for_stride("X", None) == "X"


def _loader(n: int, batch: int, seed: int):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, 3, 4, 4).astype(np.float32), rng.randint(0, 5, (batch, 4, 4)).astype(np.int32),
             {"ids": [f"s{i}" for i in range(batch)], "weight": rng.rand(batch)}) for _ in range(n)]


@pytest.mark.parametrize("size", [1, 2, 7])
@pytest.mark.parametrize("n", [0, 1, 5])
def test_prefetch_to_device_on_the_cpu_matches_jax(n, size):
    items = _loader(n, 4, seed=n)
    numeric = [(x, y, {"weight": extra["weight"]}) for x, y, extra in items]  # JAX's device_put takes no strings
    want = list(JD.prefetch_to_device(iter(numeric), size=size))
    got = list(D.prefetch_to_device(iter(items), size=size, device="cpu"))
    assert len(got) == len(want) == n
    for (x, y, extra), (jx, jy, jextra), (_, _, host) in zip(got, want, items):
        assert x.device.type == "cpu" and x.dtype == torch.float32 and y.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        # JAX without x64 narrows float64 leaves to float32; torch keeps the dtype
        assert extra["weight"].dtype == torch.float64
        np.testing.assert_array_equal(extra["weight"].numpy(), host["weight"])
        np.testing.assert_array_equal(extra["weight"].numpy().astype(np.float32), np.asarray(jextra["weight"]))
        assert extra["ids"] == host["ids"]  # non-numeric leaves pass through


def test_prefetch_to_device_reads_ahead_by_size():
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield np.full((2,), i)

    it = D.prefetch_to_device(source(), size=3, device="cpu")
    first = next(it)
    assert int(first[0]) == 0 and pulled == [0, 1, 2]
    assert [int(b[0]) for b in it] == [1, 2, 3, 4, 5]


class _StubMesh:
    """A (data, spatial) mesh seen from one rank: its coordinate and the dims' sizes."""

    def __init__(self, coordinate, shape):
        self.coordinate, self.shape = coordinate, shape

    def get_coordinate(self):
        return self.coordinate

    def size(self, dim):
        return self.shape[dim]


def test_local_part_takes_the_rows_jax_gives_each_device():
    """Under batch_sharding, rank i's part of the global batch is what JAX's
    ``data`` axis puts on device i (8 virtual CPU devices)."""
    x = np.arange(16 * 3 * 2 * 2, dtype=np.float32).reshape(16, 3, 2, 2)
    jmesh = jmake_mesh()
    shards = jax.device_put(x, jbatch_sharding(jmesh, 4)).addressable_shards
    rows = {shard.device: np.asarray(shard.data) for shard in shards}
    devices = list(jmesh.devices[:, 0])
    for rank, device in enumerate(devices):
        mesh = _StubMesh((rank, 0), (len(devices), 1))
        sharding = MeshSharding(mesh, batch_sharding(make_mesh(device_type="cpu")).placements)
        np.testing.assert_array_equal(local_part(torch.from_numpy(x), sharding).numpy(), rows[device])


def test_prefetch_to_device_takes_the_ranks_rows():
    items = _loader(3, 8, seed=4)
    for rank in range(4):
        sharding = MeshSharding(_StubMesh((rank, 0), (4, 1)), batch_sharding(make_mesh(device_type="cpu")).placements)
        for (x, y, extra), (hx, hy, hextra) in zip(D.prefetch_to_device(items, sharding=sharding, device="cpu"), items):
            np.testing.assert_array_equal(x.numpy(), hx[2 * rank: 2 * rank + 2])
            np.testing.assert_array_equal(y.numpy(), hy[2 * rank: 2 * rank + 2])
            np.testing.assert_array_equal(extra["weight"].numpy(), hextra["weight"][2 * rank: 2 * rank + 2])
    with pytest.raises(ValueError, match="equal parts"):
        local_part(torch.zeros(6, 2), MeshSharding(_StubMesh((0, 0), (4, 1)), sharding.placements))


def test_mesh_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "spatial") and tuple(mesh.shape) == (1, 1)
    assert batch_sharding(mesh, 4) == MeshSharding(mesh, (Shard(0), Replicate()))
    assert batch_spatial_sharding(mesh, 4).placements == (Shard(0), Shard(2))  # NCHW rows
    assert batch_spatial_sharding(mesh, 3).placements == (Shard(0), Shard(1))  # [B, H, W] rows
    assert replicated(mesh).placements == (Replicate(), Replicate())
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(local_part(x, batch_spatial_sharding(mesh, 3)), x)
    with pytest.raises(NotImplementedError, match="halo"):
        make_mesh(spatial_parallel=2, device_type="cpu")
    with pytest.raises(ValueError):
        make_mesh(data_parallel=2, device_type="cpu")


@pytest.mark.skipif(not NO_CARD, reason="checks the behaviour without a card")
def test_entry_points_raise_without_a_card():
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(D.prefetch_to_device([np.zeros(2)]))


def test_data_parallel_under_a_gloo_group_of_one(tmp_path):
    """Without a group the model comes back as it is; in a group it is
    wrapped in DDP, whose step equals the plain module's."""
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1), torch.nn.BatchNorm2d(4))
    assert data_parallel(model) is model
    x = torch.randn(2, 3, 8, 8)
    plain = copy.deepcopy(model)
    plain(x).square().mean().backward()
    with DistributedGuard(f"file://{tmp_path}/store", world_size=1, rank=0, backend="gloo", timeout_s=60):
        mesh = make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "spatial")
        net = data_parallel(model, mesh)
        assert isinstance(net, torch.nn.parallel.DistributedDataParallel)
        assert not any(isinstance(m, torch.nn.SyncBatchNorm) for m in net.modules())  # world 1: kept as they are
        net(x).square().mean().backward()
    for (name, a), (_, b) in zip(model.named_parameters(), plain.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0, msg=name)
