"""Q1's route rule and the wgmma routes' weight packing, on the CPU.

``ops/quantized.py`` ``_conv_route`` is the one place that decides which
kernel a ``qconv2d`` call launches on the card; ``_pack_wgmma``,
``_pack_gemm`` and ``_pack_banded`` lay out the weights of the 3x3
groups-1, 1x1 and grouped 3x3 convs for the wgmma routes.  All are plain
Python, so they are held here (and the bands of a grouped conv are run as
dense float64 convs against the plain version); the kernels themselves run
in ``tests/test_torch_cuda.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from pytorch_toolbelt_tpu_torch.ops import pack_qconv2d_weights, qconv2d, qconv2d_reference
from pytorch_toolbelt_tpu_torch.ops.quantized import (_band_weights, _conv_route, _pack_banded, _pack_gemm,
                                                     _pack_wgmma, _unpack_banded, _unpack_gemm, _unpack_wgmma,
                                                     _wgmma_chunks)

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

# the int8 SEResNeXt50-FPN(128)'s conv kinds at 1024^2, with the route each takes: only the 7x7 stem stays on the
# mma.sync kernel (and the dense strided 3x3 convs of a deep stem or a basic block, which this model has none of)
_SERESNEXT50_FPN = {
    "stem_7x7_s2": ((3, 64, 7, 2, (3, 3, 3, 3), 1), "mma_v1"),
    "bottleneck_1x1": ((64, 128, 1, 1, (0, 0, 0, 0), 1), "gemm_wgmma"),
    "grouped_3x3_width_4": ((128, 128, 3, 1, _SAME_3x3, 32), "grouped_wgmma"),
    "grouped_3x3_width_8_s2": ((256, 256, 3, 2, (0, 1, 0, 1), 32), "grouped_wgmma"),
    "grouped_3x3_width_16": ((512, 512, 3, 1, _SAME_3x3, 32), "grouped_wgmma"),
    "grouped_3x3_width_32_s2": ((1024, 1024, 3, 2, (0, 1, 0, 1), 32), "grouped_wgmma"),
    "bottleneck_1x1_expand": ((128, 256, 1, 1, (0, 0, 0, 0), 1), "gemm_wgmma"),
    "downsample_1x1_s2": ((256, 512, 1, 2, (0, 0, 0, 0), 1), "gemm_wgmma"),
    "fpn_lateral_1x1": ((2048, 128, 1, 1, (0, 0, 0, 0), 1), "gemm_wgmma"),
    "fpn_3x3": ((128, 128, 3, 1, _SAME_3x3, 1), "tma_wgmma"),
    "same_3x3_s2_even": ((64, 64, 3, 2, (0, 1, 0, 1), 1), "mma_v16"),
    "same_3x3_s2_odd": ((64, 64, 3, 2, _SAME_3x3, 1), "mma_v16"),
}


def _route(c_in, c_out, k, stride, pads, groups, x_addr=0):
    return _conv_route(c_in, c_out, (k, k), stride, pads, groups, x_addr)


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
    ((8, 8, 3, 1, _SAME_3x3, 2), "mma_v4"),  # grouped, C not a multiple of 128
    ((24, 32, 1, 1, (0, 0, 0, 0), 1), "mma_v4"),  # 1x1 with C_in % 16 != 0
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


# (C_in, C_out, kernel, stride, pads, groups, x address, route): the new routes' rule at its edges
@pytest.mark.parametrize("shape,route", [
    ((32, 32, 1, 1, (0, 0, 0, 0), 1, 0), "gemm_wgmma"),
    ((16, 19, 1, 2, (0, 0, 0, 0), 1, 4096), "gemm_wgmma"),
    ((48, 64, 1, 1, (0, 0, 0, 0), 1, 8), "mma_v4"),  # x 8 bytes past a 16-byte boundary: no tensor map
    ((48, 64, 1, 1, (0, 0, 0, 0), 1, 4), "mma_v4"),
    ((40, 64, 1, 1, (0, 0, 0, 0), 1, 0), "mma_v4"),  # C_in % 16 != 0
    ((64, 64, 1, 3, (0, 0, 0, 0), 1, 0), "mma_v16"),  # stride 3
    ((64, 64, 1, 1, (1, 1, 1, 1), 1, 0), "mma_v16"),  # a padded 1x1
    ((64, 64, 1, 1, (0, 0, 0, 0), 2, 0), "mma_v16"),  # a grouped 1x1
    ((128, 128, 3, 1, _SAME_3x3, 128, 0), "grouped_wgmma"),  # depthwise: width 1
    ((128, 128, 3, 1, _SAME_3x3, 64, 0), "grouped_wgmma"),  # width 2
    ((2048, 2048, 3, 2, (0, 1, 0, 1), 64, 0), "grouped_wgmma"),  # width 32
    ((256, 256, 3, 1, _SAME_3x3, 4, 0), "mma_v16"),  # width 64: outside the table
    ((384, 384, 3, 2, _SAME_3x3, 8, 0), "mma_v16"),  # width 48
    ((96, 96, 3, 1, _SAME_3x3, 24, 0), "mma_v4"),  # C % 128 != 0
    ((128, 256, 3, 1, _SAME_3x3, 32, 0), "mma_v4"),  # 4 input, 8 output channels per group
    ((256, 128, 3, 2, (0, 1, 0, 1), 32, 0), "mma_v4"),  # 8 input, 4 output channels per group
    ((128, 128, 3, 3, _SAME_3x3, 32, 0), "mma_v4"),  # stride 3
    ((128, 128, 3, 1, (0, 1, 0, 1), 32, 0), "mma_v4"),  # pads other than SAME at stride 1
    ((128, 128, 3, 2, (1, 0, 1, 0), 32, 0), "mma_v4"),  # and at stride 2
    ((128, 128, 3, 1, (0, 0, 0, 0), 32, 0), "mma_v4"),
    ((512, 512, 3, 2, (0, 1, 0, 1), 32, 8), "mma_v4"),  # x misaligned
    ((512, 512, 3, 2, (0, 1, 0, 1), 32, 1), "mma_v1"),
    ((128, 128, 5, 1, (2, 2, 2, 2), 32, 0), "mma_v4"),  # 5x5
])
def test_route_rule_at_its_edges(shape, route):
    assert _route(*shape) == route


@pytest.mark.parametrize("c_in", [16, 48, 64, 96, 200, 256, 2048])
@pytest.mark.parametrize("c_out", [19, 128, 300])
def test_gemm_packing_round_trip(c_in, c_out):
    gen = torch.Generator().manual_seed(c_in * 1000 + c_out)
    weight = torch.randint(-127, 128, (c_out, c_in, 1, 1), generator=gen, dtype=torch.int8)
    packed = _pack_gemm(weight)
    assert packed.shape == (len(_wgmma_chunks(c_in)), -(-c_out // 128) * 128, 128) and packed.dtype == torch.int8
    assert torch.equal(_unpack_gemm(packed, c_in, c_out), weight)
    assert pack_qconv2d_weights(weight).gemm.equal(packed)


def test_gemm_packing_layout():
    """Byte b of 16-byte group g of output channel n's row in chunk kc sits at group g ^ (n % 8), zero past C_in
    and C_out: any N tile's slab of the 128-byte swizzled rows is contiguous."""
    gen = torch.Generator().manual_seed(11)
    c_in, c_out = 200, 40
    weight = torch.randint(-127, 128, (c_out, c_in, 1, 1), generator=gen, dtype=torch.int8)
    packed = _pack_gemm(weight)
    for kc, (c0, width) in enumerate(_wgmma_chunks(c_in)):
        for n in (0, 5, 39, 40, 127):
            for g in range(8):
                row = packed[kc, n, 16 * (g ^ (n % 8)):16 * (g ^ (n % 8)) + 16]
                c = c0 + 16 * g + torch.arange(16)
                inside = (c < c0 + width) & (c < c_in)
                want = torch.zeros(16, dtype=torch.int8)
                if n < c_out:
                    want[inside] = weight[n, c[inside], 0, 0]
                assert torch.equal(row, want), (kc, n, g)


@pytest.mark.parametrize("width", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("c", [128, 256, 1024])
def test_banded_packing_round_trip(width, c):
    gen = torch.Generator().manual_seed(width * 100 + c)
    weight = torch.randint(-127, 128, (c, width, 3, 3), generator=gen, dtype=torch.int8)
    packed = _pack_banded(weight, c // width)
    assert packed.shape == (c // 128, 9, 32, 128) and packed.dtype == torch.int8
    assert torch.equal(_unpack_banded(packed, c // width), weight)
    assert pack_qconv2d_weights(weight, c // width).banded.equal(packed)


@pytest.mark.parametrize("width", [4, 8, 16, 32])
def test_banded_packing_layout(width):
    """Row n of slab (block, tap), byte 32 k + c (16-byte group g = (32 k + c) / 16 stored at g ^ (n % 8)): the
    weight from input 32 k + c to output 32 k + n of the block, zero outside their common group."""
    gen = torch.Generator().manual_seed(width)
    c_all, groups = 256, 256 // width
    weight = torch.randint(-127, 128, (c_all, width, 3, 3), generator=gen, dtype=torch.int8)
    packed = _pack_banded(weight, groups)
    for block in range(2):
        for tap in (0, 4, 8):
            for n in (0, 3, 17, 31):
                for k in range(4):
                    for c in (0, 5, 16, 31):
                        byte = 32 * k + c
                        got = packed[block, tap, n, 16 * ((byte // 16) ^ (n % 8)) + byte % 16]
                        o, i = 128 * block + 32 * k + n, 128 * block + 32 * k + c
                        want = weight[o, i % width, tap // 3, tap % 3] if o // width == i // width else 0
                        assert int(got) == int(want), (block, tap, n, k, c)


@pytest.mark.parametrize("width", [4, 8, 16, 32])
@pytest.mark.parametrize("stride,pads,size", [(1, _SAME_3x3, (12, 10)), (2, (0, 1, 0, 1), (12, 10)),
                                              (2, _SAME_3x3, (13, 11))])
def test_grouped_conv_is_its_bands(width, stride, pads, size):
    """The band decomposition of grouped_wgmma is exact: each 32-channel band of x through a dense float64 conv
    with the block-diagonal band weights of the packing gives qconv2d_reference's accumulator bit for bit, and
    with it every epilogue."""
    gen = torch.Generator().manual_seed(width * 10 + stride)
    c = 256
    x = torch.randint(-127, 128, (2, c, *size), generator=gen, dtype=torch.int8)
    weight = torch.randint(-127, 128, (c, width, 3, 3), generator=gen, dtype=torch.int8)
    bands = _band_weights(pack_qconv2d_weights(weight, c // width).banded)
    top, bottom, left, right = pads
    xd = F.pad(x.double(), (left, right, top, bottom))
    acc = torch.cat([F.conv2d(xd[:, 32 * j:32 * j + 32], bands[j].double(), stride=stride)
                     for j in range(c // 32)], dim=1).to(torch.int32)
    assert torch.equal(acc, qconv2d_reference(x, weight, stride, pads, c // width, "acc"))


def test_which_weights_get_the_new_packings():
    def packings(shape, groups=1):
        w = pack_qconv2d_weights(torch.ones(shape, dtype=torch.int8), groups)
        return w.wgmma is not None, w.gemm is not None, w.banded is not None

    assert packings((8, 4, 1, 1)) == (False, True, False)
    assert packings((8, 2, 1, 1), 2) == (False, False, False)
    assert packings((128, 4, 3, 3), 32) == (False, False, True)
    assert packings((128, 64, 3, 3), 2) == (False, False, False)  # width 64
    assert packings((96, 4, 3, 3), 24) == (False, False, False)  # C % 128
    assert packings((256, 4, 3, 3), 32) == (False, False, False)  # 4 in, 8 out per group
    assert packings((8, 4, 3, 3)) == (True, False, False)
    assert packings((64, 3, 7, 7)) == (False, False, False)

