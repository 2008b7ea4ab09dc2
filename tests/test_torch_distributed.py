"""The port's ``distributed/`` package on the CPU: the bucket assignment and
work splitting against the JAX functions, the comm helpers and the guard
without a group, strip-sharded tiled inference composed rank by rank
against the port's single-chip ``tiled_apply*`` (bit for bit) and against
the JAX package's ``tiled_apply_sharded`` on a virtual mesh, and two real
``gloo`` process groups (world 2 and 4) of subprocess ranks.

The JAX package counts the job's devices as its world size (8 on the
virtual mesh of ``tests/conftest.py``); the port counts the group's
processes, one per GPU: 1 without a group.

CPU convolutions round differently at different batch sizes, so the
bit-for-bit tests use models whose per-tile output does not depend on the
batch: the position-dependent model of ``test_torch_tiles.py`` and the
bridged UNet run tile by tile.  ``chip_smoke.py`` holds the fused UNet-32
to the same equality on the card.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_toolbelt_tpu.distributed as jdist
from pytorch_toolbelt_tpu.utils import bucket_assignment as jba
from pytorch_toolbelt_tpu_torch import distributed as tdist
from pytorch_toolbelt_tpu_torch.distributed.tiled import _get_replicated_plan, _get_strip_plan
from pytorch_toolbelt_tpu_torch.inference import tiled_apply, tiled_apply_d4_tta
from pytorch_toolbelt_tpu_torch.inference.tiles import _D4_PARITY_VIEW_PAIRS
from pytorch_toolbelt_tpu_torch.utils import bucket_assignment as tba
from test_tiles import _host_tiled_d4_oracle
from test_tiles import _nonequivariant_model as j_nonequivariant_model
from test_torch_tiles import _bridged_unet, _chw, _hwc, _nonequivariant_model

REPO = Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------------------
# Bucket assignment and work splitting, against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("buckets", [2, 3, 4])
@pytest.mark.parametrize("n", [1, 7, 40])
def test_bucket_assignment_matches_jax(n, buckets):
    costs = np.random.RandomState(n * 10 + buckets).gamma(2.0, 3.0, n)
    for name in ("naive_bucket_assignment", "filler_bucket_assignment"):
        want, got = getattr(jba, name)(costs, buckets), getattr(tba, name)(costs, buckets)
        np.testing.assert_array_equal(got, want)
        assert tba.compute_bucket_imbalance_score(costs, got) == jba.compute_bucket_imbalance_score(costs, want)
    want = jba.random_bucket_assignment(costs, buckets, 20, rng=np.random.RandomState(3))
    np.testing.assert_array_equal(tba.random_bucket_assignment(costs, buckets, 20, rng=np.random.RandomState(3)), want)


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("balanced", [False, True], ids=["even", "cost_balanced"])
def test_split_across_nodes_matches_jax(world, balanced):
    items = [f"item{i}" for i in range(23)]
    costs = np.random.RandomState(world).rand(len(items)) * 10 if balanced else None
    shards = []
    for rank in range(world):
        want = jdist.split_across_nodes(items, costs=costs, rank=rank, world_size=world)
        got = tdist.split_across_nodes(items, costs=costs, rank=rank, world_size=world)
        assert got == want
        shards += got
    assert sorted(shards) == sorted(items)
    with pytest.raises(ValueError):
        tdist.split_across_nodes(items, costs=np.ones(3), rank=0, world_size=world)


# ---------------------------------------------------------------------------
# The comm helpers and the guard without a group
# ---------------------------------------------------------------------------


def test_world_size_and_rank_without_a_group():
    assert tdist.get_world_size() == 1 and jdist.get_world_size() == 8  # processes here, devices in JAX
    assert tdist.get_rank() == jdist.get_rank() == 0
    assert tdist.is_main_process() and not tdist.is_dist_avail_and_initialized()
    assert tdist.scale_learning_rate_for_ddp(0.1) == 0.1
    assert tdist.scale_learning_rate_for_ddp(0.1, world_size=4) == jdist.scale_learning_rate_for_ddp(0.1, 4)


def test_single_process_collectives_are_identity(capsys):
    obj = {"a": 1, "b": [1, 2, 3]}
    assert tdist.all_gather(obj) == jdist.all_gather(obj) == [obj]
    assert tdist.broadcast_from_master(obj) == obj
    assert tdist.reduce_dict_sum({"x": 5}) == {"x": 5}
    assert tdist.split_across_nodes(list(range(5))) == list(range(5))
    tdist.master_print("from the main process")
    assert capsys.readouterr().out == "from the main process\n"


def test_master_node_only():
    calls = []

    @tdist.master_node_only
    def record(x):
        calls.append(x)
        return x

    @tdist.master_node_only(default="skipped")
    def other(x):
        return x * 2

    assert record(5) == 5 and calls == [5]
    assert other(4) == 8


def test_distributed_guard_without_init_method_is_a_noop():
    with tdist.DistributedGuard() as guard:
        assert not torch.distributed.is_initialized()
        assert tdist.get_world_size() == 1
    assert not guard._initialized_here


def test_distributed_guard_makes_and_ends_a_gloo_group(tmp_path):
    with tdist.DistributedGuard(f"file://{tmp_path / 'store'}", world_size=1, rank=0, backend="gloo", timeout_s=60):
        assert torch.distributed.is_initialized() and torch.distributed.get_backend() == "gloo"
        assert tdist.get_world_size() == 1 and not tdist.is_dist_avail_and_initialized()
    assert not torch.distributed.is_initialized()


def test_distributed_guard_without_a_rank(tmp_path):
    with tdist.DistributedGuard(f"file://{tmp_path / 'store'}", world_size=1, backend="gloo", timeout_s=60):
        assert torch.distributed.is_initialized() and torch.distributed.get_rank() == 0
        assert tdist.get_world_size() == 1
    assert not torch.distributed.is_initialized()


def test_distributed_guard_nccl_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no GPU")
    with pytest.raises(RuntimeError, match="gloo"):
        with tdist.DistributedGuard(f"file://{tmp_path / 'store'}", world_size=1, rank=0):
            pass
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# Strips composed rank by rank, against the single-chip path
# ---------------------------------------------------------------------------


def _compose(model_fn, image, n, **kwargs):
    kwargs = {"device": "cpu", **kwargs}
    strips = [tdist.tiled_apply_sharded(model_fn, image, rank=d, world_size=n, **kwargs) for d in range(n)]
    assert sum(s.shape[1] for s in strips) == image.shape[1]
    return torch.cat(strips, dim=1), strips


def _single_chip(model_fn, image, d4_tta, **kwargs):
    if d4_tta is None:
        return tiled_apply(model_fn, image, **kwargs)
    return tiled_apply_d4_tta(model_fn, image, mode=d4_tta, **kwargs)


@pytest.mark.parametrize("d4_tta", [None, "full", "distributed"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_strips_equal_single_chip_bit_for_bit(n, d4_tta):
    model, _ = _nonequivariant_model()
    image = _chw(np.random.RandomState(20 + n).rand(100, 90, 3).astype(np.float32))
    kw = dict(tile_size=32, tile_step=16, batch_size=4)
    got, strips = _compose(model, image, n, d4_tta=d4_tta, **kw)
    want = _single_chip(model, image, d4_tta, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert [s.shape[1] for s in strips] == [min(100, (d + 1) * -(-100 // n)) - min(100, d * -(-100 // n))
                                            for d in range(n)]


@pytest.fixture(scope="module")
def unet_pair():
    return _bridged_unet()


@pytest.mark.parametrize("n", [2, 4])
def test_strips_of_a_bridged_unet_run_tile_by_tile_equal_single_chip(unet_pair, n):
    _, _, tmodel = unet_pair

    def per_tile(tiles):
        return torch.cat([tmodel(t[None]) for t in tiles])

    image = _chw(np.random.RandomState(21).rand(64, 80, 3).astype(np.float32))
    kw = dict(tile_size=32, tile_step=16, batch_size=3)
    with torch.no_grad():
        got, _ = _compose(per_tile, image, n, d4_tta="distributed", **kw)
        want = tiled_apply_d4_tta(per_tile, image, mode="distributed", **kw)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Against the JAX package's tiled_apply_sharded on a virtual mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_strips_of_a_bridged_unet_match_jax_sharded(unet_pair, n):
    jmodel, variables, tmodel = unet_pair
    image = np.random.RandomState(22).rand(64, 80, 3).astype(np.float32)
    mesh = jdist.make_mesh(jax.devices()[:n], data_parallel=n, spatial_parallel=1)
    want = np.asarray(jdist.tiled_apply_sharded(lambda x: jmodel.apply(variables, x), jnp.asarray(image), mesh,
                                                tile_size=32, tile_step=16, batch_size=4, d4_tta="distributed"))
    with torch.no_grad():
        got, _ = _compose(tmodel, _chw(image), n, tile_size=32, tile_step=16, batch_size=4, d4_tta="distributed")
    assert got.shape == (2, 64, 80)
    assert np.abs(_hwc(got) - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("d4_tta", ["full", "distributed"])
@pytest.mark.parametrize("n", [3, 4])
def test_strips_match_the_host_oracle_and_jax_sharded(n, d4_tta):
    model, _ = _nonequivariant_model()
    j_model, model_np = j_nonequivariant_model()
    image = np.random.RandomState(42).random((100, 90, 3)).astype(np.float32)
    got, _ = _compose(model, _chw(image), n, tile_size=32, tile_step=16, batch_size=4, d4_tta=d4_tta)

    def views_for_tile(y, x):
        return tuple(range(8)) if d4_tta == "full" else _D4_PARITY_VIEW_PAIRS[(y // 16) % 2 * 2 + (x // 16) % 2]

    np.testing.assert_allclose(_hwc(got), _host_tiled_d4_oracle(image, model_np, 32, 16, views_for_tile), atol=1e-4)
    mesh = jdist.make_mesh(jax.devices()[:n], data_parallel=n, spatial_parallel=1)
    want = np.asarray(jdist.tiled_apply_sharded(j_model, jnp.asarray(image), mesh, tile_size=32, tile_step=16,
                                                batch_size=4, d4_tta=d4_tta))
    np.testing.assert_allclose(_hwc(got), want, atol=1e-5)


# ---------------------------------------------------------------------------
# Shapes, edges and the replicated canvas in one process
# ---------------------------------------------------------------------------


def test_empty_strips_and_uneven_rows():
    """h = 5 rows over 4 ranks: strip_h = 2, so ranks 0-1 own 2 rows, rank 2
    owns 1 and rank 3 none, and its strip is [K, 0, W]."""
    model, _ = _nonequivariant_model()
    image = _chw(np.random.RandomState(5).rand(5, 40, 3).astype(np.float32))
    got, strips = _compose(model, image, 4, tile_size=32, tile_step=16, batch_size=2)
    assert [tuple(s.shape) for s in strips] == [(2, 2, 40), (2, 2, 40), (2, 1, 40), (2, 0, 40)]
    assert torch.equal(got, tiled_apply(model, image, 32, 16, batch_size=2))


def test_a_strip_runs_only_the_tile_rows_that_meet_it():
    """At the config-5 geometry (10000^2, 512/256) each of four strips runs
    11 of the 39 tile rows: 44 against 39."""
    tdist.clear_sharded_cache()
    rows = [_get_strip_plan(10000, 10000, (512, 512), (256, 256), "pyramid", 32, "parity2x2", d, 4,
                            torch.device("cpu")).tile_rows for d in range(4)]
    assert rows == [(0, 11), (9, 20), (19, 30), (28, 39)]
    assert _get_strip_plan.cache_info().currsize == 4
    tdist.clear_sharded_cache()
    assert _get_strip_plan.cache_info().currsize == _get_replicated_plan.cache_info().currsize == 0


def test_distributed_d4_needs_half_step():
    model, _ = _nonequivariant_model()
    for canvas in ("strips", "replicated"):
        with pytest.raises(ValueError, match="distributed"):
            tdist.tiled_apply_sharded(model, torch.zeros(3, 96, 96), 32, 24, d4_tta="distributed", canvas=canvas,
                                      device="cpu")
    with pytest.raises(ValueError):
        tdist.tiled_apply_sharded(model, torch.zeros(3, 96, 96), 32, 16, d4_tta="bogus", device="cpu")
    with pytest.raises(ValueError):
        tdist.tiled_apply_sharded(model, torch.zeros(3, 96, 96), 32, 16, canvas="bogus", device="cpu")
    with pytest.raises(ValueError):
        tdist.tiled_apply_sharded(model, torch.zeros(3, 96, 96), 32, 16, rank=4, world_size=4, device="cpu")


def test_the_rank_device_is_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no GPU")
    model, _ = _nonequivariant_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.tiled_apply_sharded(model, torch.zeros(3, 64, 64), 32, 16)


@pytest.mark.parametrize("d4_tta", [None, "distributed"])
def test_replicated_at_world_one_agrees_with_strips(d4_tta):
    model, _ = _nonequivariant_model()
    image = _chw(np.random.RandomState(8).rand(128, 96, 3).astype(np.float32))
    kw = dict(tile_size=32, tile_step=16, batch_size=4, d4_tta=d4_tta, device="cpu")
    strips = tdist.tiled_apply_sharded(model, image, canvas="strips", **kw)
    replicated = tdist.tiled_apply_sharded(model, image, canvas="replicated", **kw)
    assert replicated.shape == strips.shape == (2, 128, 96)
    assert float((replicated - strips).abs().max()) <= 1e-5 * float(strips.abs().max())


def test_replicated_above_world_one_needs_the_group():
    model, _ = _nonequivariant_model()
    with pytest.raises(RuntimeError, match="process group"):
        tdist.tiled_apply_sharded(model, torch.zeros(3, 64, 64), 32, 16, canvas="replicated", rank=0, world_size=2,
                                  device="cpu")


def test_read_sharded_window_without_a_group():
    model, _ = _nonequivariant_model()
    image = _chw(np.random.RandomState(9).rand(70, 50, 3).astype(np.float32))
    whole = tdist.tiled_apply_sharded(model, image, 32, 16, device="cpu")
    assert torch.equal(tdist.read_sharded_window(whole, 10, 60, 5, 45), whole[:, 10:60, 5:45])
    strip = tdist.tiled_apply_sharded(model, image, 32, 16, rank=2, world_size=3, device="cpu")  # rows [48, 70)
    got = tdist.read_sharded_window(strip, 50, 70, 0, 50, rank=2, world_size=3, image_height=70)
    assert torch.equal(got, whole[:, 50:70])
    with pytest.raises(ValueError, match="not all owned"):
        tdist.read_sharded_window(strip, 40, 60, 0, 50, rank=2, world_size=3, image_height=70)
    with pytest.raises(ValueError, match="image_height"):
        tdist.read_sharded_window(strip, 50, 60, 0, 50, rank=2, world_size=3)
    with pytest.raises(ValueError, match="owns"):  # rank 1's strip has 24 rows
        tdist.read_sharded_window(strip, 50, 60, 0, 50, rank=1, world_size=3, image_height=70)
    with pytest.raises(ValueError, match="outside"):
        tdist.read_sharded_window(whole, 10, 60, 5, 51)


# ---------------------------------------------------------------------------
# Real gloo process groups: one subprocess per rank
# ---------------------------------------------------------------------------

# The model and image every rank and the parent build: position-dependent,
# so a tile's output depends on its place in the grid, and batch-independent.
_SHARED = textwrap.dedent('''
    import numpy as np
    import torch

    def make_case():
        rng = np.random.RandomState(31)
        pattern = torch.from_numpy(rng.rand(2, 32, 32).astype(np.float32))
        image = torch.from_numpy(rng.rand(3, 75, 58).astype(np.float32))

        def model(x):
            return torch.stack([(x * pattern[0]).sum(1), x.amax(1) * pattern[1]], dim=1)

        return model, image

    KW = dict(tile_size=32, tile_step=16, batch_size=3, d4_tta="distributed", device="cpu")
    WINDOW = (20, 70, 3, 41)
''')

_RANK = _SHARED + textwrap.dedent('''
    import sys
    sys.modules["jax"] = None  # a rank imports no JAX
    torch.set_num_threads(1)
    import torch.distributed as dist
    from pytorch_toolbelt_tpu_torch import distributed as D

    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    model, image = make_case()
    res = {}
    with D.DistributedGuard("file://" + store, world_size=world, rank=rank, backend="gloo", timeout_s=60):
        res["group"] = [D.get_world_size(), D.get_rank(), int(D.is_dist_avail_and_initialized()),
                        int(D.is_main_process())]
        res["gathered"] = [g["sq"] for g in D.all_gather({"sq": rank * rank})]
        res["broadcast"] = D.broadcast_from_master({"from": rank})["from"]
        summed = D.reduce_dict_sum({"x": rank + 1, "y": np.arange(3) * rank})
        res["dict_x"], res["dict_y"] = summed["x"], summed["y"]
        res["split"] = D.split_across_nodes(list(range(10)))
        res["strip"] = D.tiled_apply_sharded(model, image, **KW).numpy()
        res["replicated"] = D.tiled_apply_sharded(model, image, canvas="replicated", **KW).numpy()
        res["window"] = D.read_sharded_window(torch.from_numpy(res["strip"]), *WINDOW).numpy()
        narrow = torch.from_numpy(res["strip"])[:, :, : 20 if rank == 0 else None]  # rank 0 cut by column
        try:
            D.read_sharded_window(narrow, *WINDOW)
            res["rejected"] = 0
        except ValueError:
            res["rejected"] = 1
    res["guard_ended"] = int(not dist.is_initialized())
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    print("ok", "jax" in sys.modules and sys.modules["jax"] is not None)
''')


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_in_subprocesses(tmp_path, world):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(rank), str(world), str(tmp_path / "store"),
                               str(tmp_path / f"rank{rank}.npz")], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in range(world)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr[-3000:]
        assert stdout.strip() == "ok False"
    ranks = [dict(np.load(tmp_path / f"rank{rank}.npz")) for rank in range(world)]

    shared = {}
    exec(_SHARED, shared)
    model, image = shared["make_case"]()
    kw = shared["KW"]
    want, _ = _compose(model, image, world, **kw)
    r0, r1, c0, c1 = shared["WINDOW"]
    for rank, res in enumerate(ranks):
        assert res["group"].tolist() == [world, rank, 1, int(rank == 0)]
        assert res["gathered"].tolist() == [d * d for d in range(world)]
        assert int(res["broadcast"]) == 0
        assert int(res["dict_x"]) == sum(range(1, world + 1))
        assert res["dict_y"].tolist() == [0, sum(range(world)), 2 * sum(range(world))]
        assert res["split"].tolist() == list(range(10))[rank::world]
        assert int(res["guard_ended"]) == 1
        np.testing.assert_array_equal(res["replicated"], ranks[0]["replicated"])
        np.testing.assert_array_equal(res["window"], want[:, r0:r1, c0:c1].numpy())
        assert int(res["rejected"]) == 1  # every rank sees the strips are not row strips of one canvas
    strips = np.concatenate([res["strip"] for res in ranks], axis=1)
    np.testing.assert_array_equal(strips, want.numpy())
    assert np.abs(ranks[0]["replicated"] - strips).max() <= 1e-5 * np.abs(strips).max()
