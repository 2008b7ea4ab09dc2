"""The global batch under DDP past world 1, on a real ``gloo`` group of two
subprocess ranks on the CPU, against the JAX package on the whole batch.

Under ``jit`` over a batch-sharded mesh, the JAX package computes BatchNorm
statistics and the loss over the global batch.  The port's
``SyncBatchNorm2d`` all-reduces the per-channel sums over the group (with
autograd through the all-reduce), and the example's ``global_batch_loss``
gathers the logits and targets before the loss.  Each rank here holds one
half of a seeded batch of four:

* a lone ``SyncBatchNorm2d`` in train mode against flax's BatchNorm on the
  whole batch: outputs, running mean and (biased) running variance, and the
  gradients of ``sum(y * w)`` for the input and, summed over the ranks, for
  the scale and bias;
* the example's UNet through ``data_parallel`` (DDP with its batch norms
  converted) and the example's loss (dice + CE-focal, dice reduced over the
  batch): the loss and one step's gradients (DDP's mean over the ranks)
  against ``jax.value_and_grad`` of the JAX example's loss on the whole
  batch, and the running statistics.

Each rank is a ``subprocess.Popen`` of ``python -c`` that imports no JAX,
with a ``file://`` store and a 60 s group timeout, and writes an ``.npz``.
Tolerances: outputs 1e-5 * max|ref|, losses 1e-5 relative, gradients 1e-4 *
max|g| (over the model for the UNet), running statistics 1e-5.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu_torch.distributed import SyncBatchNorm2d, convert_sync_batchnorm, gather_batch
from pytorch_toolbelt_tpu_torch.nn import BatchNorm2d
from pytorch_toolbelt_tpu_torch.zoo import flax_name_map
from test_torch_training import _batch, _jax_step, _leaf, _losses, _pair, _to_torch_layout

REPO = Path(__file__).resolve().parents[1]
WORLD = 2

_RANK = textwrap.dedent('''
    import sys
    sys.modules["jax"] = None  # a rank imports no JAX
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from pytorch_toolbelt_tpu_torch import distributed as D
    from pytorch_toolbelt_tpu_torch import losses as L
    from pytorch_toolbelt_tpu_torch.examples.train_segmentation import global_batch_loss
    from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel, load_flax_variables

    rank, world, store, case, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    data = dict(np.load(case))

    def nested(prefix):
        tree = {}
        for key, value in data.items():
            if key.startswith(prefix):
                node = tree
                *path, leaf = key[len(prefix):].split("|")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = value
        return tree

    def part(a):
        n = a.shape[0] // world
        return torch.from_numpy(np.ascontiguousarray(a[rank * n:(rank + 1) * n]))

    res = {}
    with D.DistributedGuard("file://" + store, world_size=world, rank=rank, backend="gloo", timeout_s=60):
        bn = load_flax_variables(D.SyncBatchNorm2d(5, momentum=0.1), nested("bn|")).train()
        x = part(data["bn_x"]).requires_grad_()
        y = bn(x)
        (y * part(data["bn_w"])).sum().backward()
        res.update(bn_y=y.detach(), bn_dx=x.grad, bn_dscale=bn.weight.grad, bn_dbias=bn.bias.grad,
                   bn_mean=bn.running_mean, bn_var=bn.running_var)

        model = load_flax_variables(UNetSegmentationModel(num_classes=2, encoder_channels=16, num_layers=3),
                                    nested("unet|"))
        mesh = D.make_mesh(device_type="cpu")
        net = D.data_parallel(model, mesh).train()
        res["sync_bns"] = sum(isinstance(m, D.SyncBatchNorm2d) for m in model.modules())
        res["torch_sync_bns"] = sum(isinstance(m, torch.nn.SyncBatchNorm) for m in model.modules())
        loss_fn = L.JointLoss(L.DiceLoss(mode="multiclass"), L.CrossEntropyFocalLoss(), 1.0, 0.5)
        loss = global_batch_loss(loss_fn, net(part(data["x"])), part(data["y"]), mesh.get_group("data"))
        loss.backward()
        res["loss"] = loss.detach()
        for name, p in model.named_parameters():
            res["grad|" + name] = p.grad
        for name, b in model.named_buffers():
            if not name.endswith("num_batches_tracked"):
                res["buffer|" + name] = b
    np.savez(out, **{k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v) for k, v in res.items()})
    print("ok", "jax" in sys.modules and sys.modules["jax"] is not None)
''')


def _flat(tree, prefix):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}|"))
        else:
            out[prefix + key] = np.asarray(value, np.float32)
    return out


@pytest.fixture(scope="module")
def world_two(tmp_path_factory):
    """The inputs, both ranks' results and the JAX package's whole-batch ones."""
    tmp = tmp_path_factory.mktemp("sync_bn")
    rng = np.random.RandomState(0)
    bn_x = (1.5 + 2.0 * rng.randn(4, 6, 7, 5)).astype(np.float32)  # NHWC, a mean away from 0
    bn_w = rng.randn(4, 6, 7, 5).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    bn_vars = {"params": {"scale": (1 + 0.2 * rng.randn(5)).astype(np.float32),
                          "bias": (0.1 * rng.randn(5)).astype(np.float32)},
               "batch_stats": {"mean": (0.2 * rng.randn(5)).astype(np.float32),
                               "var": (0.5 + rng.rand(5)).astype(np.float32)}}

    def bn_loss(params, x):
        y, new = jbn.apply({"params": params, "batch_stats": bn_vars["batch_stats"]}, x, mutable=["batch_stats"])
        return jnp.sum(y * bn_w), (y, new["batch_stats"])

    (_, (bn_y, bn_stats)), (bn_dparams, bn_dx) = jax.jit(jax.value_and_grad(bn_loss, argnums=(0, 1), has_aux=True))(
        bn_vars["params"], bn_x)

    jmodel, variables, tmodel, size, classes = _pair("unet", seed=1)
    x, y, _, _ = _batch(size, classes, seed=2, batch=4)
    jloss, _ = _losses("dice_ce")
    loss, grads, stats = _jax_step(jmodel, variables, jloss, x, y)

    case = tmp / "case.npz"
    np.savez(case, bn_x=bn_x.transpose(0, 3, 1, 2), bn_w=bn_w.transpose(0, 3, 1, 2),
             x=x.transpose(0, 3, 1, 2), y=y, **_flat(bn_vars, "bn|"), **_flat(variables, "unet|"))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(rank), str(WORLD), str(tmp / "store"), str(case),
                               str(tmp / f"rank{rank}.npz")], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in range(WORLD)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr[-3000:]
        assert stdout.strip() == "ok False"
    ranks = [dict(np.load(tmp / f"rank{rank}.npz")) for rank in range(WORLD)]
    want = dict(bn_y=np.asarray(bn_y).transpose(0, 3, 1, 2), bn_dx=np.asarray(bn_dx).transpose(0, 3, 1, 2),
                bn_dscale=np.asarray(bn_dparams["scale"]), bn_dbias=np.asarray(bn_dparams["bias"]),
                bn_mean=np.asarray(bn_stats["mean"]), bn_var=np.asarray(bn_stats["var"]),
                loss=loss, grads=grads, stats=stats, names=flax_name_map(tmodel))
    return ranks, want


def _close(got, want, tol):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_sync_batchnorm_matches_flax_on_the_whole_batch(world_two):
    ranks, want = world_two
    _close(np.concatenate([r["bn_y"] for r in ranks]), want["bn_y"], 1e-5)
    _close(np.concatenate([r["bn_dx"] for r in ranks]), want["bn_dx"], 1e-4)
    _close(sum(r["bn_dscale"] for r in ranks), want["bn_dscale"], 1e-4)
    _close(sum(r["bn_dbias"] for r in ranks), want["bn_dbias"], 1e-4)
    for r in ranks:  # biased global variance, flax's momentum 0.9 (torch's 0.1)
        np.testing.assert_allclose(r["bn_mean"], want["bn_mean"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["bn_var"], want["bn_var"], rtol=1e-5, atol=1e-5)


def test_data_parallel_converts_to_the_ports_sync_batchnorm(world_two):
    ranks, want = world_two
    n_bns = sum(1 for name in want["names"] if name.endswith("running_mean"))
    for r in ranks:
        assert int(r["sync_bns"]) == n_bns > 0
        assert int(r["torch_sync_bns"]) == 0


def test_example_loss_and_gradients_are_the_global_batchs(world_two):
    """Every rank's loss is the whole batch's; DDP's mean of the gradients
    and the running statistics are the whole batch's, on both ranks."""
    ranks, want = world_two
    names = want["names"]
    scale = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(want["grads"]))
    for r in ranks:
        assert abs(float(r["loss"]) - want["loss"]) <= 1e-5 * abs(want["loss"])
        grads = {k[len("grad|"):]: v for k, v in r.items() if k.startswith("grad|")}
        assert len(grads) == sum(1 for c, _ in names.values() if c == "params")
        for name, g in grads.items():
            collection, path = names[name]
            assert float(np.abs(g - _to_torch_layout(_leaf(want["grads"], path))).max()) <= 1e-4 * scale, name
        for name, b in ((k[len("buffer|"):], v) for k, v in r.items() if k.startswith("buffer|")):
            collection, path = names[name]
            np.testing.assert_allclose(b, _leaf(want["stats"], path), rtol=1e-5, atol=1e-5, err_msg=name)


def test_sync_batchnorm_without_a_group_is_the_ports_batchnorm():
    """World 1 (no group): the plain ``BatchNorm2d``'s outputs and running
    statistics; ``gather_batch`` passes the tensor through."""
    torch.manual_seed(0)
    plain = BatchNorm2d(3, momentum=0.1)
    sync = convert_sync_batchnorm(torch.nn.Sequential(BatchNorm2d(3, momentum=0.1)))[0]
    assert isinstance(sync, SyncBatchNorm2d)
    x = torch.randn(4, 3, 5, 5) * 2 + 1
    assert torch.equal(sync.train()(x), plain.train()(x))
    assert torch.equal(sync.running_var, plain.running_var)
    assert gather_batch(x) is x
