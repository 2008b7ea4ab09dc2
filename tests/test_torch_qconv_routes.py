"""Q1's route rule and the wgmma routes' weight packing, on the CPU.

``ops/quantized.py`` ``_conv_route`` is the one place that decides which
kernel a ``qconv2d`` call launches on the card; ``_pack_wgmma`` lays out the
3x3 groups-1 weights for the wgmma routes.  Both are plain Python, so they
are held here; the kernels themselves run in ``tests/test_torch_cuda.py``.
"""

import pytest
import torch

from pytorch_toolbelt_tpu_torch.ops import pack_qconv2d_weights, qconv2d, qconv2d_reference
from pytorch_toolbelt_tpu_torch.ops.quantized import _conv_route, _pack_wgmma, _unpack_wgmma, _wgmma_chunks

_SAME_3x3 = (1, 1, 1, 1)

# (C_in, C_out, kernel, stride, pads (top, bottom, left, right), groups): the 15 convs of the int8 UNet-32
# (channels 32/64/128/256, 4 levels, 1 class), in the order its forward calls them; all take a wgmma route
_UNET32 = [
    (3, 32, 3, 1, _SAME_3x3, 1), (32, 32, 3, 1, _SAME_3x3, 1),
    (32, 64, 3, 1, _SAME_3x3, 1), (64, 64, 3, 1, _SAME_3x3, 1),
    (64, 128, 3, 1, _SAME_3x3, 1), (128, 128, 3, 1, _SAME_3x3, 1),
    (128, 256, 3, 1, _SAME_3x3, 1), (256, 256, 3, 1, _SAME_3x3, 1),
    (384, 128, 3, 1, _SAME_3x3, 1), (128, 128, 3, 1, _SAME_3x3, 1),
    (192, 64, 3, 1, _SAME_3x3, 1), (64, 64, 3, 1, _SAME_3x3, 1),
    (96, 32, 3, 1, _SAME_3x3, 1), (32, 32, 3, 1, _SAME_3x3, 1),
    (32, 1, 3, 1, _SAME_3x3, 1),  # the head, epilogue "acc"
]

# the int8 SEResNeXt50-FPN(128)'s conv kinds at 1024^2, with the route each takes
_SERESNEXT50_FPN = {
    "stem_7x7_s2": ((3, 64, 7, 2, (3, 3, 3, 3), 1), "mma_v1"),
    "bottleneck_1x1": ((64, 128, 1, 1, (0, 0, 0, 0), 1), "mma_v16"),
    "grouped_3x3_width_4": ((128, 128, 3, 1, _SAME_3x3, 32), "mma_v4"),
    "grouped_3x3_width_8_s2": ((256, 256, 3, 2, (0, 1, 0, 1), 32), "mma_v4"),
    "grouped_3x3_width_16": ((512, 512, 3, 1, _SAME_3x3, 32), "mma_v16"),
    "grouped_3x3_width_32_s2": ((1024, 1024, 3, 2, (0, 1, 0, 1), 32), "mma_v16"),
    "bottleneck_1x1_expand": ((128, 256, 1, 1, (0, 0, 0, 0), 1), "mma_v16"),
    "downsample_1x1_s2": ((256, 512, 1, 2, (0, 0, 0, 0), 1), "mma_v16"),
    "fpn_lateral_1x1": ((2048, 128, 1, 1, (0, 0, 0, 0), 1), "mma_v16"),
    "fpn_3x3": ((128, 128, 3, 1, _SAME_3x3, 1), "tma_wgmma"),
    "same_3x3_s2_even": ((64, 64, 3, 2, (0, 1, 0, 1), 1), "mma_v16"),
    "same_3x3_s2_odd": ((64, 64, 3, 2, _SAME_3x3, 1), "mma_v16"),
}


def _route(c_in, c_out, k, stride, pads, groups, x_addr=0):
    return _conv_route(c_in, c_in // groups, (k, k), stride, pads, groups, x_addr)


@pytest.mark.parametrize("layer", range(len(_UNET32)))
def test_every_unet32_conv_takes_a_wgmma_route(layer):
    c_in = _UNET32[layer][0]
    assert _route(*_UNET32[layer]) == ("ld_wgmma" if c_in == 3 else "tma_wgmma")


@pytest.mark.parametrize("case", list(_SERESNEXT50_FPN))
def test_seresnext50_fpn_routes(case):
    shape, route = _SERESNEXT50_FPN[case]
    assert _route(*shape) == route


@pytest.mark.parametrize("c_in,x_addr,route", [
    (32, 1, "ld_wgmma"), (32, 8, "ld_wgmma"), (32, 4096, "tma_wgmma"),  # a tensor map needs 16-byte alignment
    (4, 0, "ld_wgmma"), (12, 0, "ld_wgmma"), (24, 0, "ld_wgmma"), (48, 0, "tma_wgmma"),
])
def test_wgmma_route_by_c_in_and_alignment(c_in, x_addr, route):
    assert _route(c_in, 32, 3, 1, _SAME_3x3, 1, x_addr) == route


@pytest.mark.parametrize("shape,route", [
    ((32, 32, 3, 1, (1, 1, 0, 0), 1), "mma_v16"),  # pads other than (1, 1, 1, 1)
    ((32, 32, 3, 1, (0, 0, 0, 0), 1), "mma_v16"),
    ((32, 32, 3, 1, (2, 2, 2, 2), 1), "mma_v16"),
    ((8, 8, 3, 1, _SAME_3x3, 2), "mma_v4"),  # grouped
    ((32, 32, 1, 1, (0, 0, 0, 0), 1), "mma_v16"),  # 1x1
    ((32, 32, 5, 1, (2, 2, 2, 2), 1), "mma_v16"),
    ((12, 32, 3, 2, _SAME_3x3, 1), "mma_v4"),
    ((3, 32, 3, 2, _SAME_3x3, 1), "mma_v1"),
])
def test_other_shapes_keep_the_mma_routes(shape, route):
    assert _route(*shape) == route
    assert _route(*shape, x_addr=2) == "mma_v1"


@pytest.mark.parametrize("c_in", [1, 3, 4, 31, 32, 33, 63, 64, 65, 96, 97, 100, 128, 160, 192, 200, 256, 384, 420])
def test_wgmma_chunks_cover_c_in(c_in):
    chunks = _wgmma_chunks(c_in)
    c = 0
    for i, (c0, width) in enumerate(chunks):
        assert c0 == c and width in (128, 64, 32)
        assert width == 128 or i >= len(chunks) - 2  # narrow chunks only at the end, 64 before 32
        c += width
    assert c_in <= c < c_in + 32 or (c_in % 128 > 96 and c == -(-c_in // 128) * 128)
    assert [w for _, w in chunks if w < 128] in ([], [64], [32], [64, 32])


@pytest.mark.parametrize("c_in", [3, 32, 96, 384])
@pytest.mark.parametrize("c_out", [1, 32, 256])
def test_wgmma_packing_round_trip(c_in, c_out):
    gen = torch.Generator().manual_seed(c_in * 1000 + c_out)
    weight = torch.randint(-127, 128, (c_out, c_in, 3, 3), generator=gen, dtype=torch.int8)
    packed = _pack_wgmma(weight)
    nt = packed.shape[3]
    assert packed.shape == (-(-c_out // nt), len(_wgmma_chunks(c_in)), 9, nt, 128) and packed.dtype == torch.int8
    assert torch.equal(_unpack_wgmma(packed, c_in, c_out), weight)
    assert pack_qconv2d_weights(weight).wgmma.equal(packed)


def test_wgmma_packing_layout():
    """Byte b of 16-byte group g of output channel n's row in slab (block, chunk, tap) sits at group
    g ^ (n % 8): the 128-byte swizzle a wgmma B descriptor reads."""
    gen = torch.Generator().manual_seed(7)
    c_in, c_out = 192, 40
    weight = torch.randint(-127, 128, (c_out, c_in, 3, 3), generator=gen, dtype=torch.int8)
    packed = _pack_wgmma(weight)
    assert packed.shape == (1, 2, 9, 64, 128)
    for kc, (c0, width) in enumerate(_wgmma_chunks(c_in)):
        for tap in (0, 4, 8):
            for n in (0, 5, 13, 39, 40, 63):
                for g in range(8):
                    row = packed[0, kc, tap, n, 16 * (g ^ (n % 8)):16 * (g ^ (n % 8)) + 16]
                    c = c0 + 16 * g + torch.arange(16)
                    inside = (c < c0 + width) & (c < c_in) & (n < c_out)
                    want = torch.zeros(16, dtype=torch.int8)
                    if n < c_out:
                        want[inside] = weight[n, c[inside], tap // 3, tap % 3]
                    assert torch.equal(row, want), (kc, tap, n, g)


def test_only_3x3_groups_1_weights_get_the_wgmma_packing():
    assert pack_qconv2d_weights(torch.ones(8, 4, 3, 3, dtype=torch.int8)).wgmma is not None
    assert pack_qconv2d_weights(torch.ones(8, 2, 3, 3, dtype=torch.int8), groups=2).wgmma is None
    assert pack_qconv2d_weights(torch.ones(8, 4, 1, 1, dtype=torch.int8)).wgmma is None
    assert pack_qconv2d_weights(torch.ones(8, 4, 7, 7, dtype=torch.int8)).wgmma is None


def test_qconv2d_on_the_cpu_ignores_the_wgmma_packing():
    """CPU tensors take the plain version whatever the route would be on the card."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(-127, 128, (2, 32, 9, 11), generator=gen, dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    weight = torch.randint(-127, 128, (16, 32, 3, 3), generator=gen, dtype=torch.int8)
    packed = pack_qconv2d_weights(weight)
    got = qconv2d(x, packed, padding=_SAME_3x3)
    assert torch.equal(got, qconv2d_reference(x, weight, padding=_SAME_3x3))
    assert torch.equal(qconv2d(x, packed._replace(wgmma=None), padding=_SAME_3x3), got)
