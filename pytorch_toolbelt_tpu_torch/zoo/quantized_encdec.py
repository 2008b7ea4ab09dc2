"""Post-training int8 quantized inference for ``EncoderDecoderModel``
pipelines: a ResNet-family trunk, an FPN decoder and a resize head
(counterpart of ``pytorch_toolbelt_tpu/zoo/quantized_encdec.py``; config 3's
model class, SEResNeXt50-FPN with 19 classes).

The design rules are the UNet path's (``quantized_unet.py``): the network
stays in the integer domain end to end, weights are per-output-channel
symmetric int8 with the producer's activation scales absorbed into the
consumer's weights, and conv epilogues are integer-only requants fused into
Q1 (:func:`~pytorch_toolbelt_tpu_torch.ops.qconv2d`).  The default epilogue
is an int32 fixed-point multiply+shift (``requant="mul"``: exact activation
scales, full int8 range per layer); ``"shift"`` is the UNet's power-of-two
form.  Structures the UNet does not have:

* **Residual adds** (shortcuts, FPN top-down sums): each addend is
  requantized to the add's calibrated scale with a per-channel int32
  fixed-point multiplier ``round(sigma_in / sigma_out * 2^12)``, in one
  launch of Q3 (:func:`~pytorch_toolbelt_tpu_torch.ops.q_add`).
* **SE gates**: the squeeze (mean -> fc -> relu -> fc -> sigmoid) runs in
  float32 on the pooled [B, C, 1, 1] vector; the excitation is an integer
  multiply by ``round(gate * 2^14)`` and a >> 14 requant.  The graph reads
  every SE node only from its block's add, as the first addend, so the add's
  Q3 launch applies the excitation in registers and the excited map is never
  written.
* **Bias-only convs** (FPN laterals and prediction convs, the head):
  quantized like conv+BN with signed calibrated ranges.

Only the image input (one quantize) and the head logits (one dequant at the
head's resolution, before the float32 output resize) touch float.  The FPN's
x2 upsample runs on Q2 (:func:`~pytorch_toolbelt_tpu_torch.ops.q_upsample`);
pools, the SE squeezes and the head's dequant and resize are int32 / float32
torch ops, as they are XLA ops in the JAX package.

The architecture is built once as a list of nodes (:class:`_Graph`) from the
port's modules, with HWIO float64 weights, and interpreted three times: the
float32 calibration replay, the scale propagation and constant building (in
numpy float64, the JAX package's arithmetic), and the integer forward.

**CUDA graphs.**  On the card the integer forward, from the input's quantize
to the head's dequantised logits at the head's resolution, is one CUDA graph
per input key (shape, dtype, device, memory format) and model, replayed in
one launch: the first call of a key runs eagerly, then captures it.  The
head's resize runs eagerly after the replay and writes a new tensor, so no
output aliases the graph's memory.  The graphs of a model share one memory
pool and one static input a key, so they replay one at a time (a lock) on
the stream of the model's first capture.  Calls on the CPU, calls on another
stream, calls made while the caller's stream captures a graph and calls of
keys beyond the first ``_GRAPH_KEYS`` run eagerly.  ``int8_graph`` counts
captures (one a key), replays and eager calls (set-up's bias-correction
replay among them).  The kernels' own launch counters count what the card
runs: an eager call's launches, and at each replay the launches its graph
holds; a capture counts none.  Each key also keeps two copies of its graph
with the spans ``int8.se``, ``int8.add``, ``int8.head`` and ``int8.pool`` as
event pairs inside it (``utils/profiling.py``), which replay in turns
instead while a profiler records, so that reading a replay's events waits
only for the replay before last.  The plain graph carries no event: on an
H100 the forward's ~40 event pairs cost the card 1.6-2.9% of its time.
"""

import threading
import types
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .decoders.fpn import FPNDecoder
from .encoders.resnet import ResNetEncoder
from .heads.resize import ResizeHead
from .models import EncoderDecoderModel
from .quantized_unet import (
    _QMAX,
    _DeviceQConv,
    _full_fp32,
    _hwio,
    _q_upsample,
    _quantize_conv,
    _quantize_conv_mul,
    _resize_matmul,
)
from ..nn.simple import _same_padding
from ..ops.quantized import _ADD_SHIFT, _GATE_SHIFT, _requant, q_add, q_upsample, q_upsample_cat, qconv2d
from ..utils import profiling
from ..utils.profiling import span
from ..nn.upsample import BilinearInterpolationLayer

__all__ = ["quantize_encoder_decoder_inference", "attribute_quantization_error"]

_CL = torch.channels_last
_GRAPH_KEYS = 8  # CUDA graphs a model keeps, one per input key: a mix of image sizes stays bounded in memory
int8_graph = types.SimpleNamespace(captures=0, replays=0, eager_calls=0)  # the integer forwards' calls, by kind


class _Node:
    __slots__ = ("op", "inputs", "attrs", "id")

    def __init__(self, op: str, inputs: List[int], **attrs):
        self.op = op
        self.inputs = inputs
        self.attrs = attrs
        self.id = None  # assigned by _Graph.add


class _Graph:
    def __init__(self):
        self.nodes: List[_Node] = []

    def add(self, op: str, inputs: List[int], **attrs) -> int:
        node = _Node(op, inputs, **attrs)
        node.id = len(self.nodes)
        self.nodes.append(node)
        return node.id


def _fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    """conv (no bias) + BatchNorm -> (w_eff HWIO f64, bias f64)."""
    w = _hwio(conv.weight)
    scale = bn.weight.detach().cpu().numpy().astype(np.float64)
    bias = bn.bias.detach().cpu().numpy().astype(np.float64)
    mean = bn.running_mean.detach().cpu().numpy().astype(np.float64)
    var = bn.running_var.detach().cpu().numpy().astype(np.float64)
    s = scale / np.sqrt(var + bn.eps)
    return w * s[None, None, None, :], bias - mean * s


def _conv_with_bias(conv: nn.Conv2d):
    w = _hwio(conv.weight)
    b = np.zeros(w.shape[-1]) if conv.bias is None else conv.bias.detach().cpu().numpy().astype(np.float64)
    return w, b


def _build_resnet_graph(g: _Graph, enc: ResNetEncoder, x_id: int) -> List[int]:
    """Append the ResNetEncoder inference graph; return feature-map node ids."""
    outputs = []
    if isinstance(enc.conv1, nn.Sequential):  # deep stem: 3x3/2 -> 3x3 -> 3x3
        stem = enc.conv1
        for conv, bn, stride in ((stem[0], stem[1], 2), (stem[3], stem[4], 1), (stem[6], enc.bn1, 1)):
            w, b = _fold_conv_bn(conv, bn)
            x_id = g.add("conv", [x_id], w=w, b=b, stride=stride, groups=1, relu=True, pad="SAME")
    else:
        w, b = _fold_conv_bn(enc.conv1, enc.bn1)
        x_id = g.add("conv", [x_id], w=w, b=b, stride=2, groups=1, relu=True, pad=((3, 3), (3, 3)))
    outputs.append(x_id)

    x_id = g.add("maxpool3s2", [x_id])

    for stage in enc.stages:
        for block in stage:
            residual_id = x_id
            if enc.bottleneck:
                w, b = _fold_conv_bn(block.conv1, block.bn1)
                y = g.add("conv", [x_id], w=w, b=b, stride=1, groups=1, relu=True, pad="SAME")
                w, b = _fold_conv_bn(block.conv2, block.bn2)
                y = g.add("conv", [y], w=w, b=b, stride=block.conv2.stride[0], groups=block.conv2.groups,
                          relu=True, pad="SAME")
                w, b = _fold_conv_bn(block.conv3, block.bn3)
                y = g.add("conv", [y], w=w, b=b, stride=1, groups=1, relu=False, pad="SAME")
            else:
                w, b = _fold_conv_bn(block.conv1, block.bn1)
                y = g.add("conv", [x_id], w=w, b=b, stride=block.conv1.stride[0], groups=1, relu=True,
                          pad="SAME")
                w, b = _fold_conv_bn(block.conv2, block.bn2)
                y = g.add("conv", [y], w=w, b=b, stride=1, groups=1, relu=False, pad="SAME")
            if block.se is not None:
                w1, b1 = _conv_with_bias(block.se.squeeze)
                w2, b2 = _conv_with_bias(block.se.expand)
                y = g.add("se", [y], w1=w1, b1=b1, w2=w2, b2=b2)
            if block.downsample is not None:  # projection shortcut
                layers = list(block.downsample)
                sc_in = residual_id
                if isinstance(layers[0], nn.AvgPool2d):  # ResNet-D: 2x2 average pool, then a 1x1 conv
                    sc_in = g.add("avgpool2", [sc_in])
                    layers = layers[1:]
                conv, bn = layers
                w, b = _fold_conv_bn(conv, bn)
                residual_id = g.add("conv", [sc_in], w=w, b=b, stride=conv.stride[0], groups=1, relu=False,
                                    pad="SAME")
            x_id = g.add("add", [y, residual_id], relu=True)
        outputs.append(x_id)

    if enc.layers is not None:
        outputs = [outputs[i] for i in enc.layers]
    return outputs


def _build_fpn_graph(g: _Graph, dec: FPNDecoder, fm_ids: List[int]) -> List[int]:
    lateral = []
    for conv, fm in zip(dec.lateral, fm_ids):
        w, b = _conv_with_bias(conv)
        lateral.append(g.add("conv", [fm], w=w, b=b, stride=1, groups=1, relu=False, pad="SAME"))
    outputs = [lateral[-1]]
    for index, predict in zip(range(len(fm_ids) - 2, -1, -1), dec.predict):
        up = g.add("upsample2", [outputs[-1]])
        fused = g.add("add", [lateral[index], up], relu=False)
        if isinstance(predict, nn.Conv2d):
            w, b = _conv_with_bias(predict)
            fused = g.add("conv", [fused], w=w, b=b, stride=1, groups=1, relu=False, pad="SAME")
        outputs.append(fused)
    return outputs[::-1]


def _node_amax(y: torch.Tensor, mode: str, percentile: float) -> np.ndarray:
    """Per-channel clip range of one NCHW calibration activation.

    * ``absmax``     — exact max |y|.
    * ``percentile`` — the ``percentile``-th percentile of |y| (linear
      interpolation, as ``jnp.percentile``), floored at 1e-3 x absmax so a
      sparse channel clips instead of vanishing.
    * ``mse``        — per-channel grid search over 0.5..1.0 x absmax for the
      clip minimizing quantize-dequantize MSE on the calibration batch.
    """
    a = y.abs()
    dims = (0, 2, 3)
    absmax = a.amax(dim=dims)
    if mode == "absmax":
        return absmax.cpu().numpy().astype(np.float64)
    if mode == "percentile":
        flat = a.transpose(0, 1).reshape(a.shape[1], -1).sort(dim=1).values
        pos = percentile / 100.0 * (flat.shape[1] - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, flat.shape[1] - 1)
        frac = pos - lo
        pct = (flat[:, lo] * (1.0 - frac) + flat[:, hi] * frac).cpu().numpy().astype(np.float64)
        return np.maximum(pct, absmax.cpu().numpy().astype(np.float64) * 1e-3)
    if mode == "mse":
        factors = np.linspace(0.5, 1.0, 11)
        errs = []
        for f in factors:
            s = (torch.clamp_min(absmax * float(f), 1e-12) / _QMAX).view(1, -1, 1, 1)
            q = torch.clamp(torch.round(y / s), -_QMAX, _QMAX) * s
            errs.append(((q - y) ** 2).mean(dim=dims))
        best = np.argmin(torch.stack(errs).cpu().numpy(), axis=0)
        return absmax.cpu().numpy().astype(np.float64) * factors[best]
    raise ValueError(f"calibration must be 'absmax', 'percentile' or 'mse'; got {mode!r}")


def _build_encdec_graph(model: EncoderDecoderModel):
    """Checked preconditions + IR, shared by the quantizer and the attribution probe."""
    enc, dec, head = model.encoder, model.decoder, model.head
    if not isinstance(enc, ResNetEncoder):
        raise NotImplementedError(
            "quantize_encoder_decoder_inference supports ResNetEncoder-family trunks; "
            f"got {type(enc).__name__}"
        )
    if not isinstance(dec, FPNDecoder):
        raise NotImplementedError(f"decoder must be FPNDecoder; got {type(dec).__name__}")
    if not all(isinstance(up, BilinearInterpolationLayer) and up.align_corners for up in dec.upsamples):
        raise NotImplementedError("FPN upsample must be bilinear for the int8 path")
    if not isinstance(head, ResizeHead):
        raise NotImplementedError(f"head must be ResizeHead; got {type(head).__name__}")
    if head.interpolation_mode != "bilinear":
        raise NotImplementedError("the head's resize must be bilinear for the int8 path")

    g = _Graph()
    input_id = g.add("input", [])
    fm_ids = _build_resnet_graph(g, enc, input_id)
    fpn_ids = _build_fpn_graph(g, dec, fm_ids)
    head_index = dec.get_output_spec().get_index_of_largest_feature_map()
    w, b = _conv_with_bias(head.conv)
    head_id = g.add("head", [fpn_ids[head_index]], w=w, b=b)
    return g, input_id, head_id


def _pads(attrs, x: torch.Tensor):
    """(top, bottom, left, right) of a conv node on input x."""
    k = attrs["w"].shape[:2]
    if attrs["pad"] == "SAME":
        return (*_same_padding(x.shape[2], k[0], attrs["stride"]), *_same_padding(x.shape[3], k[1], attrs["stride"]))
    (top, bottom), (left, right) = attrs["pad"]
    return top, bottom, left, right


def _f32_conv(x: torch.Tensor, w_hwio: np.ndarray, b: np.ndarray, stride: int, pads, groups: int) -> torch.Tensor:
    top, bottom, left, right = pads
    w = torch.as_tensor(w_hwio.transpose(3, 2, 0, 1).astype(np.float32), device=x.device)
    y = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride, groups=groups)
    return y + torch.as_tensor(np.asarray(b, np.float32), device=x.device).view(1, -1, 1, 1)


def _f32_exec(node, vals, align_corners: bool, out_hw):
    """Execute one graph node in float32 (the calibration-replay semantics)."""
    if node.op == "conv":
        x = vals[node.inputs[0]]
        a = node.attrs
        y = _f32_conv(x, a["w"], a["b"], a["stride"], _pads(a, x), a["groups"])
        return torch.relu(y) if a["relu"] else y
    if node.op == "maxpool3s2":
        return F.max_pool2d(vals[node.inputs[0]], 3, 2, padding=1)
    if node.op == "avgpool2":
        return F.avg_pool2d(vals[node.inputs[0]], 2, 2)
    if node.op == "se":
        x = vals[node.inputs[0]]
        a = node.attrs
        pooled = x.mean(dim=(2, 3), keepdim=True)
        h = torch.relu(_f32_conv(pooled, a["w1"], a["b1"], 1, (0, 0, 0, 0), 1))
        return x * torch.sigmoid(_f32_conv(h, a["w2"], a["b2"], 1, (0, 0, 0, 0), 1))
    if node.op == "add":
        y = vals[node.inputs[0]] + vals[node.inputs[1]]
        return torch.relu(y) if node.attrs["relu"] else y
    if node.op == "upsample2":
        x = vals[node.inputs[0]]
        return _resize_matmul(x, (2 * x.shape[2], 2 * x.shape[3]), True)
    if node.op == "head":
        x = vals[node.inputs[0]]
        y = _f32_conv(x, node.attrs["w"], node.attrs["b"], 1, _pads(dict(node.attrs, stride=1, pad="SAME"), x), 1)
        return _resize_matmul(y, out_hw, align_corners)
    raise AssertionError(node.op)  # pragma: no cover


def _absorb_grouped(w_eff, sig_in, groups):
    """Absorb per-channel input scales into the HWIO conv weights (grouped-aware)."""
    ci_pg = w_eff.shape[2]
    co = w_eff.shape[3]
    if groups == 1:
        return w_eff * sig_in[None, None, :, None]
    sig_grp = sig_in.reshape(groups, ci_pg)
    per_out = np.empty((ci_pg, co))
    co_pg = co // groups
    for gi in range(groups):
        per_out[:, gi * co_pg : (gi + 1) * co_pg] = sig_grp[gi][:, None]
    return w_eff * per_out[None, None, :, :]


def _per_channel(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device).view(1, -1, 1, 1)


def _simulate_conv_int8(node, x_f32, sig_in, amax_out):
    """One conv with int8 input, weights and output in float32 surroundings
    (the single-layer PTQ simulation of the attribution probe)."""
    a = node.attrs
    w_abs = _absorb_grouped(a["w"], sig_in, a["groups"])
    sw = np.maximum(np.abs(w_abs).max(axis=(0, 1, 2)) / _QMAX, 1e-12)
    w_q = np.clip(np.round(w_abs / sw), -_QMAX, _QMAX)
    x_q = torch.clamp(torch.round(x_f32 / _per_channel(sig_in, x_f32.device)), -_QMAX, _QMAX)
    acc = _f32_conv(x_q, w_q, np.zeros(w_q.shape[-1]), a["stride"], _pads(a, x_f32), a["groups"])
    y = acc * _per_channel(sw, acc.device) + _per_channel(a["b"], acc.device)
    if a["relu"]:
        y = torch.relu(y)
    sig_out = _per_channel(np.maximum(amax_out, 1e-12) / _QMAX, y.device)
    return torch.clamp(torch.round(y / sig_out), -_QMAX, _QMAX) * sig_out


def _calibrate(g, input_id, x_cal, align_corners, out_hw, calibration, percentile, margin):
    """The float32 replay of the graph: every node's value and clip range."""
    vals: Dict[int, torch.Tensor] = {input_id: x_cal}
    amax: Dict[int, np.ndarray] = {}
    for node in g.nodes:
        if node.op == "input":
            continue
        y = _f32_exec(node, vals, align_corners, out_hw)
        vals[node.id] = y
        amax[node.id] = _node_amax(y, calibration, percentile) * margin
    return vals, amax, _node_amax(x_cal, calibration, percentile) * margin


def attribute_quantization_error(
    model: EncoderDecoderModel,
    calibration_images,
    *,
    margin: float = 1.0,
    calibration: str = "absmax",
    percentile: float = 99.9,
) -> List[dict]:
    """Per-layer PTQ error attribution.

    For each conv node of the graph, quantize that layer alone (int8
    input, weights and output; everything else float32) and measure the
    final logits' relative RMS against the float32 replay.  Non-conv nodes
    (adds, SE gates, upsamples) are attributed with their output snapped onto
    the int8 grid.

    Returns ``{"node": id, "op": str, "rel_rms": float}`` rows sorted most
    damaging first: the ranking ``fallback_convs`` uses.
    """
    g, input_id, head_id = _build_encdec_graph(model)
    device = next(model.parameters()).device
    x_cal = torch.as_tensor(calibration_images, dtype=torch.float32, device=device)
    out_hw = tuple(x_cal.shape[2:])
    align = model.head.interpolation_align_corners
    with torch.no_grad(), _full_fp32():
        vals, amax, input_amax = _calibrate(g, input_id, x_cal, align, out_hw, calibration, percentile, margin)
        return _rank_single_layer_errors(g, input_id, head_id, align, out_hw, vals, amax, input_amax)


def _rank_single_layer_errors(
    g, input_id, head_id, align_corners, out_hw, vals, amax, input_amax, ops=None
) -> List[dict]:
    """Single-layer replay ranking shared by the attribution probe and the
    ``fallback_convs`` selection."""
    f_ref = vals[head_id]
    ref_norm = float(torch.sqrt(torch.mean(f_ref**2))) + 1e-12

    rows = []
    for k_node in g.nodes:
        if k_node.op in ("input", "maxpool3s2", "avgpool2", "head"):
            continue
        if ops is not None and k_node.op not in ops:
            continue
        src = k_node.inputs[0]
        sig_in = np.maximum(input_amax if src == input_id else amax[src], 1e-12) / _QMAX
        if k_node.op == "conv":
            y_q = _simulate_conv_int8(k_node, vals[src], sig_in, amax[k_node.id])
        else:
            sig_out = _per_channel(np.maximum(amax[k_node.id], 1e-12) / _QMAX, f_ref.device)
            y_q = torch.clamp(torch.round(vals[k_node.id] / sig_out), -_QMAX, _QMAX) * sig_out
        # replay downstream in float32 (node ids are topological)
        vals_k = dict(vals)
        vals_k[k_node.id] = y_q
        for node in g.nodes[k_node.id + 1 :]:
            if node.op == "input":
                continue
            vals_k[node.id] = _f32_exec(node, vals_k, align_corners, out_hw)
        err = float(torch.sqrt(torch.mean((vals_k[head_id] - f_ref) ** 2))) / ref_norm
        rows.append({"node": k_node.id, "op": k_node.op, "rel_rms": err})
    rows.sort(key=lambda r: r["rel_rms"], reverse=True)
    return rows


def _q_maxpool3s2(x_q: torch.Tensor) -> torch.Tensor:
    """3x3 / 2 max pool of int8 NCHW padded with -128 (XLA's
    ``reduce_window`` with init -128): the max of nine strided views."""
    xp = F.pad(x_q, (1, 1, 1, 1), value=-128)
    ho, wo = (x_q.shape[2] - 1) // 2 + 1, (x_q.shape[3] - 1) // 2 + 1
    y = None
    for dy in range(3):
        for dx in range(3):
            v = xp[:, :, dy : dy + 2 * ho - 1 : 2, dx : dx + 2 * wo - 1 : 2]
            y = v if y is None else torch.maximum(y, v)
    return y.contiguous(memory_format=_CL)


def _sra_clip(acc: torch.Tensor, bits: int) -> torch.Tensor:
    return ((acc + (1 << (bits - 1))) >> bits).clamp(-_QMAX, _QMAX).to(torch.int8)


_KERNELS = (qconv2d, q_upsample, q_upsample_cat, q_add)  # whose launch counters a replay adds to


def _launch_counts() -> dict:
    """The kernels' launch counters, flat: {(kernel, counter, route): n}."""
    counts = {}
    for kernel in _KERNELS:
        counts[kernel, "launches", None] = kernel.launches
        counts[kernel, "gated", None] = getattr(kernel, "gated", 0)
        counts.update(((kernel, "launches_by_route", route), n) for route, n in kernel.launches_by_route.items())
    return counts


def _launches_since(before: dict) -> dict:
    return {key: n - before[key] for key, n in _launch_counts().items() if n != before[key]}


def _count_launches(launches: dict) -> None:
    for (kernel, counter, route), n in launches.items():
        if route is None:
            setattr(kernel, counter, getattr(kernel, counter) + n)
        else:
            kernel.launches_by_route[route] += n


class _KeyGraphs:
    """One input key's CUDA graphs of ``run``: the plain one, and two copies
    with its spans as event pairs, which replay in turns while a profiler
    records.  All read one static input; each writes its own static output."""

    def __init__(self, run: Callable, x: torch.Tensor, channels_last: bool, pool):
        self.x = torch.empty_like(x, memory_format=_CL if channels_last else torch.contiguous_format).copy_(x)
        stream = torch.cuda.Stream(x.device)
        # thread_local: another thread's waits on the card (a producer of the caller's) do not end the capture
        capture = dict(pool=pool, stream=stream, capture_error_mode="thread_local")
        before, self.turn = _launch_counts(), 0
        self.plain, *self.traced = (self._capture(run, spans, capture)
                                    for spans in (None, profiling.GraphSpans(), profiling.GraphSpans()))
        captured = _launches_since(before)
        _count_launches({key: -n for key, n in captured.items()})  # a capture launches nothing
        self.launches = {key: n // 3 for key, n in captured.items()}  # each replay does

    def _capture(self, run: Callable, spans: Optional[profiling.GraphSpans], capture: dict) -> tuple:
        graph = torch.cuda.CUDAGraph()
        with profiling.capture_spans(spans), torch.cuda.graph(graph, **capture):
            y = run(self.x)
        return graph, spans, y

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Replay on x: a static output, which a later replay overwrites."""
        self.x.copy_(x)
        with span("int8.graph", x):
            if torch.autograd._profiler_enabled():
                graph, spans, y = self.traced[self.turn]
                self.turn ^= 1
                spans.replay(graph)
            else:
                graph, _, y = self.plain
                graph.replay()
        _count_launches(self.launches)
        return y


class _Int8Graphs:
    """``run`` (the integer forward up to the head's dequantised logits)
    replayed from one CUDA graph per input key, or run eagerly (the module's
    docstring says when), then ``tail(logits, x)``, which writes a new
    tensor."""

    def __init__(self, run: Callable, tail: Callable):
        self.run, self.tail, self.graphs = run, tail, {}
        self.pool = self.stream = None  # made at the first capture
        self.lock = threading.Lock()

    def eager(self, x: torch.Tensor) -> torch.Tensor:
        int8_graph.eager_calls += 1
        return self.tail(self.run(x), x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not x.is_cuda or torch.cuda.is_current_stream_capturing():
            return self.eager(x)
        stream = torch.cuda.current_stream(x.device)
        if self.stream is not None and stream != self.stream:
            return self.eager(x)
        channels_last = x.is_contiguous(memory_format=_CL) and not x.is_contiguous()
        key = (tuple(x.shape), x.dtype, x.device, channels_last)
        with self.lock:  # the tail reads the static output before another replay can write it
            graphs = self.graphs.get(key)
            if graphs is not None:
                int8_graph.replays += 1
                with torch.cuda.device(x.device):
                    return self.tail(graphs(x), x)
            y = self.eager(x)  # a key's first call also warms the libraries and the kernels' lazy state up
            if len(self.graphs) < _GRAPH_KEYS:
                with torch.cuda.device(x.device):
                    if self.pool is None:
                        self.pool, self.stream = torch.cuda.graph_pool_handle(), stream
                    self.graphs[key] = _KeyGraphs(self.run, x, channels_last, self.pool)
                int8_graph.captures += 1
            return y


def quantize_encoder_decoder_inference(
    model: EncoderDecoderModel,
    calibration_images,
    *,
    margin: float = 1.0,
    requant: str = "mul",
    bias_correction: bool = True,
    calibration: str = "absmax",
    percentile: float = 99.9,
    fallback_convs: int = 0,
    fallback_nodes: Optional[Iterable[int]] = None,
) -> Callable:
    """Build a fully-integer inference forward for a trained
    ``EncoderDecoderModel`` with a ResNet-family encoder (SE, ResNeXt and
    ResNet-D flavours included), an ``FPNDecoder`` and a ``ResizeHead``.

    Args:
        model: the trained model; calibration and the forward run on its device.
        calibration_images: [N, C, H, W] float images (a tensor or array).
        margin: multiplier on calibrated ranges.
        requant: ``"mul"`` (default): int32 fixed-point multiply+shift per
            conv; ``"shift"``: the UNet's power-of-two shift.
        bias_correction: run the int8 graph node by node beside the float32
            replay and absorb each conv's per-channel mean quantization error
            into its integer bias (the head's into its float bias).
        calibration: ``"absmax"``, ``"percentile"`` or ``"mse"`` (see
            ``_node_amax``); ``percentile`` for the second.
        fallback_convs: keep the K most damaging convs (ranked by
            :func:`attribute_quantization_error` on the calibration batch) in
            float32, their outputs snapped back onto the int8 grid.
        fallback_nodes: explicit conv node ids to keep in float32; overrides
            ``fallback_convs``.

    Returns:
        ``forward(x: [B, C, H, W]) -> [B, num_classes, H, W]`` float32 logits
        (or ``{output_name: logits}``) approximating ``model.eval()(x)`` at
        int8 PTQ fidelity, replayed from a CUDA graph per input key on the
        card (the module's docstring); ``forward.eager`` is the same forward
        without graphs, bit for bit.  Its float32 convs and products
        (fallback convs, SE squeezes, the head's resize) switch TF32 off
        process-wide while each runs, so that they are full float32 as in the
        JAX package.
    """
    if requant not in ("mul", "shift"):
        raise ValueError(f"requant must be 'mul' or 'shift'; got {requant!r}")
    g, input_id, head_id = _build_encdec_graph(model)
    head = model.head
    device = next(model.parameters()).device
    out_align = head.interpolation_align_corners
    output_name = head.output_name

    # ---- float32 calibration replay over the same graph ------------------
    x_cal = torch.as_tensor(calibration_images, dtype=torch.float32, device=device)
    cal_hw = tuple(x_cal.shape[2:])
    with torch.no_grad(), _full_fp32():
        vals, amax, input_amax = _calibrate(g, input_id, x_cal, out_align, cal_hw, calibration, percentile, margin)
        cal_out = vals[head_id]

        # ---- mixed-precision fallback selection ---------------------------
        f32_nodes: set = set()
        if fallback_nodes is not None:
            f32_nodes = {int(i) for i in fallback_nodes}
            bad = [i for i in f32_nodes if i >= len(g.nodes) or g.nodes[i].op != "conv"]
            if bad:
                raise ValueError(f"fallback_nodes must be conv node ids; bad: {sorted(bad)}")
        elif fallback_convs > 0:
            rows = _rank_single_layer_errors(g, input_id, head_id, out_align, cal_hw, vals, amax, input_amax,
                                             ops=("conv",))
            f32_nodes = {r["node"] for r in rows[:fallback_convs]}
    forward = _build_int8_encdec(g, input_id, head_id, amax, input_amax, f32_nodes, requant, out_align,
                                 output_name, device, vals if bias_correction else None, x_cal)
    forward._calibration_output = cal_out  # exposed for tests
    return forward


def _build_int8_encdec(g, input_id, head_id, amax, input_amax, f32_nodes, requant, out_align, output_name,
                       device, vals=None, x_cal=None) -> Callable:
    """Scale propagation, the integer constants and the forward; with
    ``vals`` (the float32 replay of ``x_cal``) the sequential bias correction."""
    sigma: Dict[int, np.ndarray] = {input_id: np.maximum(input_amax, 1e-12) / _QMAX}
    consts: Dict[int, dict] = {}
    inv_sigma_in = _per_channel(1.0 / sigma[input_id], device)
    bias_correction = vals is not None

    def quantize_input(x):
        return torch.clamp(torch.round(x.float() * inv_sigma_in), -_QMAX, _QMAX).to(torch.int8).contiguous(
            memory_format=_CL)

    def conv_epilogue(node, acc):  # Q1's epilogue on an accumulator, through its plain version
        dq = consts[node.id]["qc"]
        return _requant(acc, requant, dq.b_q, dq.relu, dq.rnd, dq.shift, dq.mult, dq.clamp).contiguous(
            memory_format=_CL)

    def exec_node(node, vals_q):
        if node.op == "conv":
            c = consts[node.id]
            x_q = vals_q[node.inputs[0]]
            if "f32" in c:  # mixed-precision fallback layer
                a = node.attrs
                x = x_q.float() * c["sig_in"]
                top, bottom, left, right = _pads(a, x)
                with _full_fp32():
                    y = F.conv2d(F.pad(x, (left, right, top, bottom)), c["w"], stride=a["stride"],
                                 groups=a["groups"])
                y = y + c["b"]
                if a["relu"]:
                    y = torch.relu(y)
                return torch.clamp(torch.round(y * c["inv_sig_out"]), -_QMAX, _QMAX).to(torch.int8).contiguous(
                    memory_format=_CL)
            return c["qc"](x_q)
        if node.op == "maxpool3s2":
            with span("int8.pool", vals_q[node.inputs[0]]):
                return _q_maxpool3s2(vals_q[node.inputs[0]])
        if node.op == "avgpool2":
            with span("int8.pool", vals_q[node.inputs[0]]):
                x4 = vals_q[node.inputs[0]].to(torch.int32)
                s = x4[:, :, 0::2, 0::2] + x4[:, :, 0::2, 1::2] + x4[:, :, 1::2, 0::2] + x4[:, :, 1::2, 1::2]
                return _sra_clip(s, 2).contiguous(memory_format=_CL)
        if node.op == "se":
            c = consts[node.id]
            x_q = vals_q[node.inputs[0]]
            with span("int8.se", x_q):
                pooled = x_q.float().mean(dim=(2, 3)) * c["sig_in"]
                with _full_fp32():
                    h = torch.relu(torch.matmul(pooled, c["w1"]) + c["b1"])
                    gate = torch.sigmoid(torch.matmul(h, c["w2"]) + c["b2"])
                # the excitation is left to the add that reads it: the SE's value
                # is its input with the [B, C] gate, round(gate * 2^14), beside it
                return x_q, torch.round(gate * (1 << _GATE_SHIFT)).to(torch.int32)
        if node.op == "add":
            c = consts[node.id]
            a, gate = vals_q[node.inputs[0]], None
            if isinstance(a, tuple):  # an SE's output
                a, gate = a
            with span("int8.add", a):
                return q_add(a, vals_q[node.inputs[1]], c["ma"], c["mb"], node.attrs["relu"], gate)
        if node.op == "upsample2":
            x_q = vals_q[node.inputs[0]]
            return _q_upsample(x_q, 2 * x_q.shape[2], 2 * x_q.shape[3])
        if node.op == "head":  # the dequantised logits at the head's resolution; resize() brings them to the input's
            c = consts[node.id]
            with span("int8.head", vals_q[node.inputs[0]]):
                return c["conv"](vals_q[node.inputs[0]]).float() * c["sw"] + c["bias"]
        raise AssertionError(node.op)  # pragma: no cover

    def resize(logits, out_hw):
        with span("int8.head", logits), _full_fp32():
            return _resize_matmul(logits, out_hw, out_align)

    # ---- integer constants (+ optional sequential bias correction) ------
    vals_q: Optional[Dict[int, torch.Tensor]] = {input_id: quantize_input(x_cal)} if bias_correction else None
    cal_hw = tuple(x_cal.shape[2:]) if bias_correction else None
    int8_graph.eager_calls += bias_correction

    with torch.no_grad():
        for node in g.nodes:
            if node.op == "input":
                continue
            if node.op == "conv":
                sig_in = sigma[node.inputs[0]]
                a = node.attrs
                if node.id in f32_nodes:
                    # mixed-precision fallback: float32 conv on the dequantized
                    # input, output snapped back onto its calibrated int8 grid
                    sig_out = np.maximum(amax[node.id], 1e-12) / _QMAX
                    consts[node.id] = {
                        "f32": True,
                        "w": torch.as_tensor(a["w"].transpose(3, 2, 0, 1).astype(np.float32), device=device),
                        "b": _per_channel(a["b"], device),
                        "sig_in": _per_channel(sig_in, device),
                        "inv_sig_out": _per_channel(1.0 / sig_out, device),
                    }
                    sigma[node.id] = sig_out
                    if bias_correction:
                        vals_q[node.id] = exec_node(node, vals_q)
                    continue
                w_abs = _absorb_grouped(a["w"], sig_in, a["groups"])
                if requant == "mul":
                    qc = _quantize_conv_mul(w_abs, a["b"], amax[node.id])
                else:
                    qc, _ = _quantize_conv(w_abs, a["b"], amax[node.id])
                dq = _DeviceQConv(qc.w_q, device, stride=a["stride"], pad=a["pad"], groups=a["groups"],
                                  epilogue=requant, relu=a["relu"], qc=qc)
                consts[node.id] = {"qc": dq}
                sigma[node.id] = qc.sigma_out
                if bias_correction:
                    sw = np.maximum(np.abs(w_abs).max(axis=(0, 1, 2)) / _QMAX, 1e-12)
                    acc = dq(vals_q[node.inputs[0]], epilogue="acc")
                    q0 = conv_epilogue(node, acc)
                    dims = (0, 2, 3)
                    err = vals[node.id].mean(dim=dims).cpu().numpy().astype(np.float64) - (
                        qc.sigma_out * q0.float().mean(dim=dims).cpu().numpy().astype(np.float64)
                    )
                    delta = np.round(err / sw)
                    b_new = (np.asarray(qc.b_q, np.int64) + delta.astype(np.int64)).clip(
                        -(2**31), 2**31 - 1).astype(np.int32)
                    dq.b_q = torch.as_tensor(b_new, device=device)
                    vals_q[node.id] = conv_epilogue(node, acc)
                continue
            if node.op in ("maxpool3s2", "avgpool2"):
                sigma[node.id] = sigma[node.inputs[0]]
            elif node.op == "se":
                a = node.attrs
                sig_in = sigma[node.inputs[0]]
                consts[node.id] = {  # the 1x1 convs on the pooled vector as [C_in, C_out] matrices
                    "w1": torch.as_tensor(a["w1"][0, 0].astype(np.float32), device=device),
                    "b1": torch.as_tensor(a["b1"].astype(np.float32), device=device),
                    "w2": torch.as_tensor(a["w2"][0, 0].astype(np.float32), device=device),
                    "b2": torch.as_tensor(a["b2"].astype(np.float32), device=device),
                    "sig_in": torch.as_tensor(sig_in.astype(np.float32), device=device),
                }
                sigma[node.id] = sig_in
            elif node.op == "add":
                sig_a, sig_b = sigma[node.inputs[0]], sigma[node.inputs[1]]
                sig_out = np.maximum(amax[node.id], 1e-12) / _QMAX
                ma = np.clip(np.round(sig_a / sig_out * (1 << _ADD_SHIFT)), 0, 1 << 20)
                mb = np.clip(np.round(sig_b / sig_out * (1 << _ADD_SHIFT)), 0, 1 << 20)
                consts[node.id] = {
                    "ma": torch.as_tensor(ma.astype(np.int32), device=device),
                    "mb": torch.as_tensor(mb.astype(np.int32), device=device),
                }
                sigma[node.id] = sig_out
            elif node.op == "upsample2":
                sigma[node.id] = sigma[node.inputs[0]] * (128.0 / _QMAX) ** 2
            elif node.op == "head":
                sig_in = sigma[node.inputs[0]]
                head_eff = node.attrs["w"] * sig_in[None, None, :, None]
                sw = np.maximum(np.abs(head_eff).max(axis=(0, 1, 2)) / _QMAX, 1e-12)
                w_q = np.clip(np.round(head_eff / sw), -_QMAX, _QMAX).astype(np.int8)
                consts[node.id] = {
                    "conv": _DeviceQConv(w_q, device, epilogue="acc"),
                    "sw": _per_channel(sw, device),
                    "bias": _per_channel(node.attrs["b"], device),
                }
                if bias_correction:
                    # the output resize is linear with per-pixel weights summing
                    # to 1, so a constant per-channel shift before the resize
                    # equals the same shift after it: correct against the final
                    # float32 logits directly
                    q0 = resize(exec_node(node, vals_q), cal_hw)
                    err = vals[node.id].mean(dim=(0, 2, 3)) - q0.mean(dim=(0, 2, 3))
                    consts[node.id]["bias"] = consts[node.id]["bias"] + err.view(1, -1, 1, 1)
            if bias_correction and node.op != "head":
                vals_q[node.id] = exec_node(node, vals_q)

    del vals, vals_q
    last_use = {src: node.id for node in g.nodes for src in node.inputs}

    def logits(x: torch.Tensor) -> torch.Tensor:
        vals_fw = {input_id: quantize_input(x)}
        for node in g.nodes:
            if node.op == "input":
                continue
            vals_fw[node.id] = exec_node(node, vals_fw)
            for src in node.inputs:  # free what no later node reads
                if last_use[src] == node.id:
                    del vals_fw[src]
        return vals_fw[head_id]

    graphs = _Int8Graphs(logits, lambda y, x: resize(y, tuple(x.shape[2:])))

    def run(x: torch.Tensor, through: Callable):
        with span("int8.forward", device=False):
            out = through(x)
        if output_name is not None:
            return {output_name: out}
        return out

    @torch.no_grad()
    def forward(x: torch.Tensor):
        return run(x, graphs)

    @torch.no_grad()
    def eager(x: torch.Tensor):
        """The same forward with no CUDA graph (counted in ``int8_graph.eager_calls``)."""
        return run(x, graphs.eager)

    forward.eager = eager
    return forward
