"""Parity of the port's integer encoder-decoder (``zoo/quantized_encdec.py``:
ResNet family + FPN + ResizeHead, on Q1 and Q2 through their plain versions)
with the JAX package, on the CPU.  Tolerances as ``test_torch_quantized.py``
states them: bit for bit given the JAX package's ranges; from the port's own
calibration within 2e-2 relative RMS of the JAX int8 output and within 0.06
of the float32 model."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo import FPNDecoder as JFPNDecoder
from pytorch_toolbelt_tpu.zoo import ResizeHead as JResizeHead
from pytorch_toolbelt_tpu.zoo import quantized_encdec as JQE
from pytorch_toolbelt_tpu.zoo.encoders.resnet import ResNetEncoder as JResNetEncoder
from pytorch_toolbelt_tpu_torch.zoo import (
    EncoderDecoderModel,
    FPNDecoder,
    ResizeHead,
    attribute_quantization_error,
    load_flax_variables,
    quantize_encoder_decoder_inference,
)
from pytorch_toolbelt_tpu_torch.zoo import quantized_encdec as TQE
from pytorch_toolbelt_tpu_torch.zoo.encoders.resnet import ResNetEncoder
from pytorch_toolbelt_tpu_torch.zoo.encoders.unet import UnetEncoder

from test_torch_quantized import CPU, PTQ_RMS, SELF_CAL_RMS, _nchw, _nhwc, _rel_rms, _seeded_variables


_ENCODERS = {
    "basic": dict(stage_blocks=(1, 1, 1, 1), bottleneck=False),
    "basic_se": dict(stage_blocks=(1, 1, 1, 1), bottleneck=False, use_se=True),
    "bottleneck_se_resnext": dict(stage_blocks=(1, 1, 1, 1), bottleneck=True, use_se=True, groups=2, base_width=4),
    "resnet_d": dict(stage_blocks=(1, 1, 1, 1), bottleneck=True, deep_stem=True, avg_down=True),
}


@pytest.fixture(scope="module", params=list(_ENCODERS))
def encdec_case(request):
    return _encdec_case(request.param)


def _encdec_case(name):
    """A flax model and the port's, with the same seeded variables, and its data."""
    kwargs = _ENCODERS[name]
    jenc = JResNetEncoder(**kwargs)
    jdec = JFPNDecoder(input_spec=jenc.get_output_spec(), out_channels=16)
    jmodel = JEncoderDecoderModel(encoder=jenc, decoder=jdec,
                                  head=JResizeHead(input_spec=jdec.get_output_spec(), num_classes=5))
    rng = np.random.RandomState(1)
    cal = rng.rand(2, 64, 64, 3).astype(np.float32)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    variables = _seeded_variables(jmodel, cal, seed=2)
    tenc = ResNetEncoder(**kwargs)
    tdec = FPNDecoder(tenc.get_output_spec(), out_channels=16)
    tmodel = load_flax_variables(EncoderDecoderModel(tenc, tdec, ResizeHead(tdec.get_output_spec(), num_classes=5)),
                                 variables).eval()
    return dict(name=name, jmodel=jmodel, variables=variables, tmodel=tmodel, cal=cal, x=x)


def _jax_calibration(c):
    """The JAX package's per-node ranges (its float32 replay at HIGHEST)."""
    g, input_id, _ = JQE._build_encdec_graph(c["jmodel"], c["variables"])
    vals, amax = {input_id: jnp.asarray(c["cal"])}, {}
    for node in g.nodes:
        if node.op != "input":
            vals[node.id] = JQE._f32_exec(node, vals, False, c["cal"].shape[1:3])
            amax[node.id] = JQE._node_amax(vals[node.id], "absmax", 99.9)
    return g, amax, JQE._node_amax(jnp.asarray(c["cal"]), "absmax", 99.9)


@pytest.mark.parametrize("requant", ["mul", "shift"])
def test_int8_encdec_given_the_jax_ranges_is_bit_exact(encdec_case, requant):
    c = encdec_case
    j_graph, amax, input_amax = _jax_calibration(c)
    g, input_id, head_id = TQE._build_encdec_graph(c["tmodel"])
    assert [(n.op, n.inputs) for n in g.nodes] == [(n.op, n.inputs) for n in j_graph.nodes]
    forward = TQE._build_int8_encdec(g, input_id, head_id, amax, input_amax, set(), requant, False, None, CPU)
    j_forward = JQE.quantize_encoder_decoder_inference(c["jmodel"], c["variables"], jnp.asarray(c["cal"]),
                                                       requant=requant, bias_correction=False)
    got = forward(_nchw(c["x"]))
    assert got.shape == (2, 5, 64, 64) and got.dtype == torch.float32
    np.testing.assert_array_equal(_nhwc(got), np.asarray(j_forward(jnp.asarray(c["x"]))))
    assert torch.equal(forward(_nchw(c["x"])), got)  # deterministic


def test_int8_encdec_calibration_replay_matches_jax_and_the_model(encdec_case):
    c = encdec_case
    j_graph, j_amax, j_input_amax = _jax_calibration(c)
    g, input_id, head_id = TQE._build_encdec_graph(c["tmodel"])
    with torch.no_grad():
        vals, amax, input_amax = TQE._calibrate(g, input_id, _nchw(c["cal"]), False, (64, 64), "absmax", 99.9, 1.0)
        ref = c["tmodel"](_nchw(c["cal"]))
    np.testing.assert_allclose(input_amax, j_input_amax, rtol=1e-7)
    for node_id, want in j_amax.items():
        np.testing.assert_allclose(amax[node_id], want, rtol=1e-5, atol=1e-6 * want.max())
    np.testing.assert_allclose(vals[head_id].numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_int8_encdec_own_calibration_matches_jax_and_the_float_model(encdec_case):
    c = encdec_case
    forward = quantize_encoder_decoder_inference(c["tmodel"], _nchw(c["cal"]))
    j_forward = JQE.quantize_encoder_decoder_inference(c["jmodel"], c["variables"], jnp.asarray(c["cal"]))
    got = forward(_nchw(c["x"]))
    want = np.asarray(j_forward(jnp.asarray(c["x"])))
    assert _rel_rms(_nhwc(got), want) <= SELF_CAL_RMS
    with torch.no_grad():
        ref = c["tmodel"](_nchw(c["x"]))
    assert _rel_rms(got, ref) < PTQ_RMS
    assert _rel_rms(got, ref) <= 1.1 * _rel_rms(want, _nhwc(ref))


# (option, its value, tolerance of the port's int8 output against the JAX int8 output)
_OPTIONS = [("bias_correction", False, SELF_CAL_RMS), ("calibration", "percentile", SELF_CAL_RMS),
            ("calibration", "mse", SELF_CAL_RMS), ("requant", "shift", SELF_CAL_RMS),
            ("fallback_convs", 1, SELF_CAL_RMS)]


@pytest.mark.parametrize("option,value,tol", _OPTIONS, ids=[f"{o}={v}" for o, v, _ in _OPTIONS])
def test_int8_encdec_options_match_jax(option, value, tol):
    kwargs = _ENCODERS["bottleneck_se_resnext"]
    jenc = JResNetEncoder(**kwargs)
    jdec = JFPNDecoder(input_spec=jenc.get_output_spec(), out_channels=16)
    jmodel = JEncoderDecoderModel(encoder=jenc, decoder=jdec,
                                  head=JResizeHead(input_spec=jdec.get_output_spec(), num_classes=5))
    rng = np.random.RandomState(11)
    cal = rng.rand(2, 64, 64, 3).astype(np.float32)
    variables = _seeded_variables(jmodel, cal, seed=11)
    tenc = ResNetEncoder(**kwargs)
    tdec = FPNDecoder(tenc.get_output_spec(), out_channels=16)
    tmodel = load_flax_variables(EncoderDecoderModel(tenc, tdec, ResizeHead(tdec.get_output_spec(), num_classes=5)),
                                 variables).eval()
    want = JQE.quantize_encoder_decoder_inference(jmodel, variables, jnp.asarray(cal), **{option: value})(
        jnp.asarray(cal))
    got = quantize_encoder_decoder_inference(tmodel, _nchw(cal), **{option: value})(_nchw(cal))
    assert _rel_rms(_nhwc(got), want) <= tol


def test_attribution_ranks_like_jax():
    c = _encdec_case("bottleneck_se_resnext")  # the encoder with every node kind the ranking sees
    want = JQE.attribute_quantization_error(c["jmodel"], c["variables"], jnp.asarray(c["cal"]))
    got = attribute_quantization_error(c["tmodel"], _nchw(c["cal"]))
    assert [r["op"] for r in got].count("conv") >= 10 and {"add", "se", "upsample2"} <= {r["op"] for r in got}
    assert sorted(r["node"] for r in got) == sorted(r["node"] for r in want)
    # one layer's error moves where an input rounds the other way on its int8
    # grid: held within 3%, and the order is JAX's wherever JAX's errors are
    # more than 3% apart
    errs = {r["node"]: r["rel_rms"] for r in want}
    for r in got:
        assert r["rel_rms"] == pytest.approx(errs[r["node"]], rel=3e-2)
    for i, a in enumerate(got):
        for b in got[i + 1:]:
            assert errs[a["node"]] >= (1 - 3e-2) * errs[b["node"]], (a, b)
    assert [r["node"] for r in got[:4]] == [r["node"] for r in want[:4]]  # what fallback_convs keeps


def test_int8_encdec_fallback_nodes_and_rejects():
    kwargs = _ENCODERS["basic"]
    enc = ResNetEncoder(**kwargs)
    dec = FPNDecoder(enc.get_output_spec(), out_channels=8)
    model = EncoderDecoderModel(enc, dec, ResizeHead(dec.get_output_spec(), num_classes=2)).eval()
    cal = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="conv node ids"):
        quantize_encoder_decoder_inference(model, cal, fallback_nodes=[2])  # node 2 is the max pool
    with pytest.raises(ValueError, match="requant"):
        quantize_encoder_decoder_inference(model, cal, requant="none")
    unet_enc = UnetEncoder(out_channels=8, num_layers=2)
    with pytest.raises(NotImplementedError):
        quantize_encoder_decoder_inference(
            EncoderDecoderModel(unet_enc, dec, ResizeHead(unet_enc.get_output_spec(), num_classes=2)), cal)
