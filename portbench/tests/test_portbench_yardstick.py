"""The frozen operation counts against torch's own count on each
configuration's float model, and the seeded inputs."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, inputs, weights, yardstick

from conftest import SEED

CONFIG_CELLS = {"unet32-int8": "unet32-int8.d4-5000", "seresnext50-fpn-int8": "seresnext50-fpn-int8.msd4-1024"}


@pytest.mark.parametrize("config", sorted(CONFIG_CELLS))
@pytest.mark.parametrize("size", [(64, 64), (96, 64)])
def test_conv_operations_match_torch_flop_counter(config, size):
    cell = harness.Cell(CONFIG_CELLS[config])
    model = cell.builder.float_model(cell.cfg)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.zeros(1, 3, *size))
    counts = counter.get_flop_counts()
    convs = sum(v for op, v in counts["Global"].items() if "convolution" in str(op))
    # the SE squeezes run in float and are not Q1's
    se = sum(v for name, ops in counts.items() if name.endswith(".se") for op, v in ops.items()
             if "convolution" in str(op))
    frozen = yardstick.request_ops(cell.reference, cell.cfg, [(1, *size)])
    assert frozen == convs - se > 0


def test_q1_bound_is_the_larger_of_bytes_and_operations():
    shape = dict(cin=64, cout=64, kh=3, kw=3, stride=1, groups=1, h=512, w=512, ho=512, wo=512, out_bytes=1)
    ops, nbytes = yardstick.conv_ops(shape, 100), yardstick.conv_bytes(shape, 100)
    assert ops == 2.0 * 100 * 512 * 512 * 64 * 64 * 9 and nbytes == 100 * 2 * 64 * 512 * 512 + 64 * 64 * 9
    assert yardstick.bound_s(nbytes, ops) == max(nbytes / yardstick.HBM_RATE, ops / yardstick.INT8_PEAK)


@pytest.mark.parametrize("seed", [0, SEED, 2**33 + 7])
def test_seeded_inputs_repeat_for_a_seed_and_differ_across_seeds(seed):
    cell = harness.Cell("unet32-int8.d4-5000")
    traffic = dict(cell.traffic, image={"sizes": [[40, 48]], "pool": 3})
    cfg = dict(cell.cfg, calibration={"images": 2, "size": 16})
    spec = cell.reference.param_spec(cfg)

    def draw(s):
        pool = inputs.image_pool(traffic, "cpu", inputs.subseed(s, "images"))
        cal = inputs.calibration_images(cfg, "cpu", inputs.subseed(s, "calibration"))
        return pool, cal, weights.make(spec, "cpu", inputs.subseed(s, "weights"))

    (pool, cal, w), (pool2, cal2, w2), (pool3, cal3, w3) = draw(seed), draw(seed), draw(seed + 1)
    assert all(torch.equal(a, b) for a, b in zip(pool, pool2)) and torch.equal(cal, cal2)
    assert all(torch.equal(w[k], w2[k]) for k in w)
    assert not torch.equal(pool[0], pool[1])  # the pool's images are distinct
    assert not any(torch.equal(a, b) for a, b in zip(pool, pool3)) and not torch.equal(cal, cal3)
    assert not torch.equal(w["head.conv.weight"], w3["head.conv.weight"])
