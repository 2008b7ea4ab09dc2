"""Q3 (``ops.q_add``: the int8 encoder-decoder's requantized add with the SE
excitation fused in) on the CPU: its plain version against the int8 graph's
formula written out as separate int32 passes, the wrapper's checks and route
rule, the graph's SE nodes each read only by their block's add, and an int8
SE-ResNet + FPN forward whose adds excite their first addend against the same
model run on the written-out formula.  The kernel itself is held against
``q_add_reference`` on the card (``tests/test_torch_cuda.py``)."""

import collections

import pytest
import torch

from pytorch_toolbelt_tpu_torch.ops import q_add, q_add_reference
from pytorch_toolbelt_tpu_torch.ops.quantized import _add_route
from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead
from pytorch_toolbelt_tpu_torch.zoo import quantize_encoder_decoder_inference
from pytorch_toolbelt_tpu_torch.zoo import quantized_encdec as TQE
from pytorch_toolbelt_tpu_torch.zoo.encoders.resnet import ResNetEncoder

CL = torch.channels_last


def _formula(a, b, ma, mb, relu, gate=None):
    """The graph's SE excitation and add as it ran them before Q3: the excited
    map narrowed to int8, then the add's int32 passes."""
    if gate is not None:
        excited = a.to(torch.int32) * gate[:, :, None, None]
        a = ((excited + 8192) >> 14).clamp(-127, 127).to(torch.int8).contiguous(memory_format=CL)
    acc = a.to(torch.int32) * ma.view(1, -1, 1, 1) + b.to(torch.int32) * mb.view(1, -1, 1, 1)
    if relu:
        acc = torch.clamp_min(acc, 0)
    return ((acc + 2048) >> 12).clamp(-127, 127).to(torch.int8).contiguous(memory_format=CL)


def _operands(c, seed, n=2, h=5, w=7):
    """Seeded addends over the whole int8 range with both ends in every
    channel, multipliers in [0, 2^20] with 0 and 2^20 present, gates in
    [0, 2^14] with both ends present."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.randint(-128, 128, (n, c, h, w), generator=gen, dtype=torch.int8)
    b = torch.randint(-128, 128, (n, c, h, w), generator=gen, dtype=torch.int8)
    for t in (a, b):
        t[0, :, 0, :3] = torch.tensor([127, -127, -128], dtype=torch.int8)
    a[1, :, 1, 1], b[1, :, 1, 1] = 127, 127  # the largest sum
    ma = torch.randint(0, (1 << 20) + 1, (c,), generator=gen, dtype=torch.int32)
    mb = torch.randint(0, (1 << 20) + 1, (c,), generator=gen, dtype=torch.int32)
    ma[:2], mb[:2] = torch.tensor([1 << 20, 0], dtype=torch.int32), torch.tensor([1 << 20, 1 << 20],
                                                                                  dtype=torch.int32)
    gate = torch.randint(0, (1 << 14) + 1, (n, c), generator=gen, dtype=torch.int32)
    gate[0, :2], gate[1, :3] = torch.tensor([0, 1 << 14]), torch.tensor([1 << 14, 1 << 14, 0])
    return a.contiguous(memory_format=CL), b.contiguous(memory_format=CL), ma, mb, gate


@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("gated", [False, True], ids=["no_gate", "gate"])
@pytest.mark.parametrize("c", [8, 24, 128])
def test_q_add_reference_is_the_graphs_formula(c, gated, relu):
    a, b, ma, mb, gate = _operands(c, seed=c + 2 * gated + relu)
    gate = gate if gated else None
    want = _formula(a, b, ma, mb, relu, gate)
    for fn in (q_add_reference, q_add):  # on the CPU the wrapper runs the plain version
        got = fn(a, b, ma, mb, relu, gate)
        assert got.dtype == torch.int8 and got.is_contiguous(memory_format=CL)
        assert torch.equal(got, want)
    if relu:
        assert int(want.min()) >= 0
    assert int(want.max()) == 127 and (relu or int(want.min()) == -127)  # the clip is reached at both ends


def _bad_call(kind):
    a, b, ma, mb, gate = _operands(16, seed=3)
    if kind == "nchw":
        a = a.contiguous()
    elif kind == "int32":
        a, b = a.to(torch.int32), b.to(torch.int32)
    elif kind == "shapes":
        b = b[:, :, :4].contiguous(memory_format=CL)
    elif kind == "gate_shape":
        gate = gate[:, :8].contiguous()
    elif kind == "gate_dtype":
        gate = gate.to(torch.int64)
    elif kind == "multiplier_shape":
        ma = ma[:8].contiguous()
    return a, b, ma, mb, True, gate


@pytest.mark.parametrize("kind", ["nchw", "int32", "shapes", "gate_shape", "gate_dtype", "multiplier_shape"])
def test_q_add_rejects_what_the_kernel_does_not_take(kind):
    with pytest.raises(ValueError, match="q_add"):
        q_add(*_bad_call(kind))


@pytest.mark.parametrize("c,addrs,route", [(128, (0, 16, 4096), "vec16"), (2048, (256, 512), "vec16"),
                                           (24, (0, 16), "scalar"), (128, (0, 1), "scalar"),
                                           (128, (0, 8), "scalar")])
def test_q_add_route_rule(c, addrs, route):
    assert _add_route(c, addrs) == route


_ENCODERS = {
    "basic_se": dict(stage_blocks=(1, 1, 1, 1), bottleneck=False, use_se=True),
    "bottleneck_se_resnext": dict(stage_blocks=(1, 1, 1, 1), bottleneck=True, use_se=True, groups=2, base_width=4),
}


@pytest.mark.parametrize("name", [*_ENCODERS, "bottleneck_se_resnet_d"])
def test_every_se_node_is_read_only_by_its_blocks_add(name):
    """The int8 forward hands an SE node's gate to the add that reads it:
    the graph gives every SE node that add, as its first addend, as its only
    reader."""
    kw = _ENCODERS.get(name) or dict(stage_blocks=(2, 1, 1, 1), bottleneck=True, use_se=True, stem_channels=16,
                                     deep_stem=True, avg_down=True)
    enc = ResNetEncoder(**kw)
    dec = FPNDecoder(enc.get_output_spec(), out_channels=8)
    g, _, _ = TQE._build_encdec_graph(EncoderDecoderModel(enc, dec, ResizeHead(dec.get_output_spec(), num_classes=2)))
    readers = collections.defaultdict(list)
    for node in g.nodes:
        for pos, src in enumerate(node.inputs):
            readers[src].append((node.op, pos))
    se_ids = [node.id for node in g.nodes if node.op == "se"]
    assert len(se_ids) == sum(kw["stage_blocks"])
    assert all(readers[i] == [("add", 0)] for i in se_ids)


@pytest.mark.parametrize("name", list(_ENCODERS))
def test_int8_encdec_with_the_excitation_in_its_adds_equals_it_unfused(name, monkeypatch):
    """The graph as it runs (each SE node computes its gate, its add excites
    the conv output in Q3's plain version) against the same model built and
    run with every add, excitation included, on the written-out formula:
    bit-equal, bias correction's replay included.  Every add reaches
    ``q_add``, and one per SE node carries its gate."""
    torch.manual_seed(0)
    enc = ResNetEncoder(**_ENCODERS[name])
    dec = FPNDecoder(enc.get_output_spec(), out_channels=16)
    model = EncoderDecoderModel(enc, dec, ResizeHead(dec.get_output_spec(), num_classes=3)).eval()
    gen = torch.Generator().manual_seed(1)
    cal, x = torch.rand(2, 3, 32, 32, generator=gen), torch.rand(2, 3, 32, 32, generator=gen)
    ops = collections.Counter(n.op for n in TQE._build_encdec_graph(model)[0].nodes)

    calls = []

    def counted(a, b, ma, mb, relu, gate=None):
        calls.append(gate is not None)
        return q_add(a, b, ma, mb, relu, gate)

    monkeypatch.setattr(TQE, "q_add", counted)
    fused = quantize_encoder_decoder_inference(model, cal)
    calls.clear()
    got = fused(x)
    assert (len(calls), sum(calls)) == (ops["add"], ops["se"]) and ops["se"] == 4

    monkeypatch.setattr(TQE, "q_add", _formula)
    want = quantize_encoder_decoder_inference(model, cal)(x)
    assert torch.equal(got, want)
