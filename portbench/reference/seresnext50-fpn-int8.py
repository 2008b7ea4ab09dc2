"""Plain reference of ``seresnext50-fpn-int8``: SE-ResNeXt-50 32x4d (stem 7x7/2
and 3x3/2 max pool, bottlenecks 3/4/6/3 of grouped 3x3 convs with
squeeze-and-excitation, projection shortcuts), an FPN of 128 channels over its
five feature maps (bilinear align_corners x2 top-down sums, 3x3 prediction
convs) and a ResizeHead of 19 classes (3x3 conv at stride 2, float32 bilinear
resize to the input), post-training quantized to int8 as
``pytorch_toolbelt_tpu_torch.zoo.quantize_encoder_decoder_inference`` does
with its defaults (absmax ranges, the multiply+shift requant, sequential bias
correction on the calibration batch).

It works the calibration and the integer network out again from the seeded
float weights and calibration images the benchmark hands to both sides:
the numpy float64 BatchNorm fold, the float32 replay (TF32 off) that records
every node's per-channel range, the scale propagation, the integer constants,
the bias correction that runs the integer graph beside the replay, and the
integer forward on ``common.qconv2d`` and ``common.q_upsample`` (float64 sums
of int8 values: exact), its adds and SE gates in int32 and float32 torch
ops.  Frozen copies of ``zoo/quantized_encdec.py:89-663``; it imports
nothing of the program.

Weights are named as the program's ``EncoderDecoderModel(seresnext50_encoder(),
FPNDecoder(.., 128), ResizeHead(.., 19))`` names them.
"""

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import common as C

ADD_SHIFT = 12  # zoo/quantized_encdec.py:63
SE_SHIFT = 14  # zoo/quantized_encdec.py:64


class Node:
    __slots__ = ("id", "op", "inputs", "attrs")

    def __init__(self, node_id, op, inputs, attrs):
        self.id, self.op, self.inputs, self.attrs = node_id, op, inputs, attrs


def _stages(cfg):
    """(planes, blocks, stride) of each stage."""
    return [(cfg["stem_channels"] * 2**s, n, 1 if s == 0 else 2) for s, n in enumerate(cfg["stage_blocks"])]


def graph(cfg) -> list:
    """The inference graph as zoo/quantized_encdec.py:106-235 builds it, each
    conv naming the tensors it folds: ``conv`` (OIHW weight), ``bn``
    (BatchNorm prefix) or ``bias``."""
    nodes = []

    def add(op, inputs, **attrs):
        nodes.append(Node(len(nodes), op, list(inputs), attrs))
        return len(nodes) - 1

    def conv(x, name, cin, cout, k, stride, groups, relu, pad, bn=None, bias=None):
        return add("conv", [x], conv=name, bn=bn, bias=bias, cin=cin, cout=cout, k=k, stride=stride, groups=groups,
                   relu=relu, pad=pad)

    x = add("input", [])
    stem = cfg["stem_channels"]
    x = conv(x, "encoder.conv1.weight", cfg["in_channels"], stem, 7, 2, 1, True, ((3, 3), (3, 3)), bn="encoder.bn1")
    features = [x]
    x = add("maxpool3s2", [x])
    inplanes, groups, expansion = stem, cfg["groups"], cfg["expansion"]
    for s, (planes, blocks, stride) in enumerate(_stages(cfg)):
        width = planes * cfg["base_width"] // 64 * groups
        out = planes * expansion
        for b in range(blocks):
            p = f"encoder.layer{s + 1}.{b}"
            st = stride if b == 0 else 1
            y = conv(x, f"{p}.conv1.weight", inplanes, width, 1, 1, 1, True, "SAME", bn=f"{p}.bn1")
            y = conv(y, f"{p}.conv2.weight", width, width, 3, st, groups, True, "SAME", bn=f"{p}.bn2")
            y = conv(y, f"{p}.conv3.weight", width, out, 1, 1, 1, False, "SAME", bn=f"{p}.bn3")
            y = add("se", [y], prefix=f"{p}.se", channels=out)
            residual = x
            if b == 0:
                residual = conv(x, f"{p}.downsample.0.weight", inplanes, out, 1, st, 1, False, "SAME",
                                bn=f"{p}.downsample.1")
            x = add("add", [y, residual], relu=True)
            inplanes = out
        features.append(x)
    fpn = cfg["fpn_channels"]
    feature_channels = [stem] + [planes * expansion for planes, _, _ in _stages(cfg)]
    lateral = [conv(fm, f"decoder.lateral.{i}.weight", c, fpn, 1, 1, 1, False, "SAME", bias=f"decoder.lateral.{i}.bias")
               for i, (fm, c) in enumerate(zip(features, feature_channels))]
    outputs = [lateral[-1]]
    for j, index in enumerate(range(len(features) - 2, -1, -1)):
        up = add("upsample2", [outputs[-1]])
        fused = add("add", [lateral[index], up], relu=False)
        fused = conv(fused, f"decoder.predict.{j}.weight", fpn, fpn, 3, 1, 1, False, "SAME",
                     bias=f"decoder.predict.{j}.bias")
        outputs.append(fused)
    add("head", [outputs[-1]], conv="head.conv.weight", bias="head.conv.bias", cin=fpn, cout=cfg["num_classes"])
    return nodes


def param_spec(cfg) -> list:
    """(name, shape, kind, factor) of every tensor of the model's state dict;
    the last BatchNorm scale of every residual branch and projection
    shortcut takes ``residual_bn_scale``."""
    spec = []
    for node in graph(cfg):
        a = node.attrs
        if node.op in ("conv", "head"):
            k = a.get("k", 3)
            spec.append((a["conv"], (a["cout"], a["cin"] // a.get("groups", 1), k, k), "conv", 1.0))
            if a.get("bn"):
                last = a["bn"].endswith(("bn3", "downsample.1"))
                spec += [(f"{a['bn']}.weight", (a["cout"],), "bn_weight", cfg["residual_bn_scale"] if last else 1.0),
                         (f"{a['bn']}.bias", (a["cout"],), "bias", 1.0),
                         (f"{a['bn']}.running_mean", (a["cout"],), "bias", 1.0),
                         (f"{a['bn']}.running_var", (a["cout"],), "bn_var", 1.0),
                         (f"{a['bn']}.num_batches_tracked", (), "count", 1.0)]
            else:
                spec.append((a["bias"], (a["cout"],), "bias", 1.0))
        elif node.op == "se":
            c, r = a["channels"], a["channels"] // cfg["se_reduction"]
            p = a["prefix"]
            spec += [(f"{p}.squeeze.weight", (r, c, 1, 1), "conv", 1.0), (f"{p}.squeeze.bias", (r,), "bias", 1.0),
                     (f"{p}.expand.weight", (c, r, 1, 1), "conv", 1.0), (f"{p}.expand.bias", (c,), "bias", 1.0)]
    return spec


def _pads(attrs, h: int, w: int):
    """zoo/quantized_encdec.py:238 ``_pads``: (top, bottom, left, right)."""
    k = attrs.get("k", 3)
    if attrs.get("pad", "SAME") == "SAME":
        return (*C.same_padding(h, k, attrs.get("stride", 1)), *C.same_padding(w, k, attrs.get("stride", 1)))
    (top, bottom), (left, right) = attrs["pad"]
    return top, bottom, left, right


def conv_shapes(cfg, h: int, w: int) -> list:
    """Every conv of one forward of an h x w view, the head's included: what
    Q1 computes (the SE squeezes run in float and are not Q1's)."""
    sizes, shapes = {}, []
    for node in graph(cfg):
        a = node.attrs
        if node.op == "input":
            sizes[node.id] = (h, w)
            continue
        ih, iw = sizes[node.inputs[0]]
        if node.op in ("conv", "head"):
            k, stride = a.get("k", 3), a.get("stride", 1)
            top, bottom, left, right = _pads(a, ih, iw)
            ho, wo = (ih + top + bottom - k) // stride + 1, (iw + left + right - k) // stride + 1
            shapes.append(dict(cin=a["cin"], cout=a["cout"], kh=k, kw=k, stride=stride, groups=a.get("groups", 1),
                               h=ih, w=iw, ho=ho, wo=wo, out_bytes=4 if node.op == "head" else 1))
            sizes[node.id] = (ho, wo)
        elif node.op == "maxpool3s2":
            sizes[node.id] = ((ih - 1) // 2 + 1, (iw - 1) // 2 + 1)
        elif node.op == "upsample2":
            sizes[node.id] = (2 * ih, 2 * iw)
        else:
            sizes[node.id] = (ih, iw)
    return shapes


def _fold_conv_bn(weights, conv, bn, eps):
    """zoo/quantized_encdec.py:89 ``_fold_conv_bn``: numpy float64."""
    w = C.hwio(weights[conv])
    scale, bias, mean, var = (weights[f"{bn}.{k}"].detach().cpu().numpy().astype(np.float64)
                              for k in ("weight", "bias", "running_mean", "running_var"))
    s = scale / np.sqrt(var + eps)
    return w * s[None, None, None, :], bias - mean * s


def _with_bias(weights, conv, bias):
    """zoo/quantized_encdec.py:100 ``_conv_with_bias``."""
    return C.hwio(weights[conv]), weights[bias].detach().cpu().numpy().astype(np.float64)


def _f32_conv(x, w_hwio, b, stride, pads, groups):
    """zoo/quantized_encdec.py:247 ``_f32_conv``."""
    top, bottom, left, right = pads
    w = torch.as_tensor(w_hwio.transpose(3, 2, 0, 1).astype(np.float32), device=x.device)
    y = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride, groups=groups)
    return y + torch.as_tensor(np.asarray(b, np.float32), device=x.device).view(1, -1, 1, 1)


def _absorb_grouped(w_eff, sig_in, groups):
    """zoo/quantized_encdec.py:284 ``_absorb_grouped``."""
    ci_pg, co = w_eff.shape[2], w_eff.shape[3]
    if groups == 1:
        return w_eff * sig_in[None, None, :, None]
    sig_grp = sig_in.reshape(groups, ci_pg)
    per_out = np.empty((ci_pg, co))
    co_pg = co // groups
    for gi in range(groups):
        per_out[:, gi * co_pg:(gi + 1) * co_pg] = sig_grp[gi][:, None]
    return w_eff * per_out[None, None, :, :]


def _f32_per_channel(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device).view(1, -1, 1, 1)


def _absmax(y: torch.Tensor) -> np.ndarray:
    """zoo/quantized_encdec.py:176 ``_node_amax``, mode ``absmax``."""
    return y.abs().amax(dim=(0, 2, 3)).cpu().numpy().astype(np.float64)


def _q_maxpool3s2(x_q):
    """zoo/quantized_encdec.py:394 ``_q_maxpool3s2``: padded with -128."""
    xp = F.pad(x_q, (1, 1, 1, 1), value=-128)
    ho, wo = (x_q.shape[2] - 1) // 2 + 1, (x_q.shape[3] - 1) // 2 + 1
    y = None
    for dy in range(3):
        for dx in range(3):
            v = xp[:, :, dy:dy + 2 * ho - 1:2, dx:dx + 2 * wo - 1:2]
            y = v if y is None else torch.maximum(y, v)
    return y.contiguous(memory_format=C.CL)


class Model:
    """The int8 model of ``weights`` calibrated on ``calibration_images``
    ([N, C, H, W] float32 on the weights' device); calling it maps
    [B, C, H, W] float32 to [B, num_classes, H, W] float32 logits."""

    def __init__(self, cfg, weights: dict, calibration_images: torch.Tensor, qmax: int = C.QMAX):
        self.qmax, self.nodes = qmax, graph(cfg)
        self.device = calibration_images.device
        eps = cfg["bn_eps"]
        for node in self.nodes:  # the folded float64 HWIO weights
            a = node.attrs
            if node.op == "conv":
                a["w"], a["b"] = (_fold_conv_bn(weights, a["conv"], a["bn"], eps) if a["bn"]
                                  else _with_bias(weights, a["conv"], a["bias"]))
            elif node.op == "head":
                a["w"], a["b"] = _with_bias(weights, a["conv"], a["bias"])
            elif node.op == "se":
                p = a["prefix"]
                a["w1"], a["b1"] = _with_bias(weights, f"{p}.squeeze.weight", f"{p}.squeeze.bias")
                a["w2"], a["b2"] = _with_bias(weights, f"{p}.expand.weight", f"{p}.expand.bias")
        self.align = cfg["head_align_corners"]
        x_cal = calibration_images
        with torch.no_grad(), C.full_fp32():
            vals, amax = {0: x_cal}, {}
            for node in self.nodes[1:]:  # zoo/quantized_encdec.py:318 _calibrate
                vals[node.id] = self._f32_exec(node, vals, tuple(x_cal.shape[2:]))
                amax[node.id] = _absmax(vals[node.id])
            input_amax = _absmax(x_cal)
        self._build(amax, input_amax, vals, x_cal)

    def _f32_exec(self, node, vals, out_hw):
        """zoo/quantized_encdec.py:254 ``_f32_exec``: one node in float32."""
        a = node.attrs
        x = vals[node.inputs[0]]
        if node.op == "conv":
            y = _f32_conv(x, a["w"], a["b"], a["stride"], _pads(a, *x.shape[2:]), a["groups"])
            return torch.relu(y) if a["relu"] else y
        if node.op == "maxpool3s2":
            return F.max_pool2d(x, 3, 2, padding=1)
        if node.op == "se":
            pooled = x.mean(dim=(2, 3), keepdim=True)
            h = torch.relu(_f32_conv(pooled, a["w1"], a["b1"], 1, (0, 0, 0, 0), 1))
            return x * torch.sigmoid(_f32_conv(h, a["w2"], a["b2"], 1, (0, 0, 0, 0), 1))
        if node.op == "add":
            y = x + vals[node.inputs[1]]
            return torch.relu(y) if a["relu"] else y
        if node.op == "upsample2":
            return C.resize_matmul(x, (2 * x.shape[2], 2 * x.shape[3]), True)
        if node.op == "head":
            y = _f32_conv(x, a["w"], a["b"], 1, _pads(dict(a, stride=1, pad="SAME"), *x.shape[2:]), 1)
            return C.resize_matmul(y, out_hw, self.align)
        raise AssertionError(node.op)

    def _sra_clip(self, acc, bits):
        """zoo/quantized_encdec.py:407 ``_sra_clip``."""
        return ((acc + (1 << (bits - 1))) >> bits).clamp(-self.qmax, self.qmax).to(torch.int8)

    def _conv(self, node, x_q, epilogue="mul", b_q=None):
        c = self.consts[node.id]
        return C.qconv2d(x_q, c["w"], node.attrs["stride"], _pads(node.attrs, *x_q.shape[2:]), node.attrs["groups"],
                         epilogue, bias=c["b_q"] if b_q is None else b_q, relu=node.attrs["relu"], mult=c["mult"],
                         clamp=c["clamp"], qmax=self.qmax)

    def _exec(self, node, vals_q, resize_hw):
        """zoo/quantized_encdec.py:501 ``exec_node``: one node of the integer forward."""
        c = self.consts.get(node.id)
        x_q = vals_q[node.inputs[0]]
        if node.op == "conv":
            return self._conv(node, x_q)
        if node.op == "maxpool3s2":
            return _q_maxpool3s2(x_q)
        if node.op == "se":
            pooled = x_q.float().mean(dim=(2, 3)) * c["sig_in"]
            with C.full_fp32():
                h = torch.relu(torch.matmul(pooled, c["w1"]) + c["b1"])
                gate = torch.sigmoid(torch.matmul(h, c["w2"]) + c["b2"])
            gate_q = torch.round(gate * (1 << SE_SHIFT)).to(torch.int32)[:, :, None, None]
            return self._sra_clip(x_q.to(torch.int32) * gate_q, SE_SHIFT).contiguous(memory_format=C.CL)
        if node.op == "add":
            acc = x_q.to(torch.int32) * c["ma"] + vals_q[node.inputs[1]].to(torch.int32) * c["mb"]
            if node.attrs["relu"]:
                acc = torch.clamp_min(acc, 0)
            return self._sra_clip(acc, ADD_SHIFT).contiguous(memory_format=C.CL)
        if node.op == "upsample2":
            mh, mw = C.q_upsample_matrices(*x_q.shape[2:], 2 * x_q.shape[2], 2 * x_q.shape[3])
            return C.q_upsample(x_q, mh, mw, self.qmax)
        if node.op == "head":
            acc = C.qconv2d(x_q, c["w"], 1, _pads(dict(stride=1, pad="SAME"), *x_q.shape[2:]), 1, "acc")
            logits = acc.float() * c["sw"] + c["bias"]
            with C.full_fp32():
                return C.resize_matmul(logits, resize_hw, self.align)
        raise AssertionError(node.op)

    def _build(self, amax, input_amax, vals, x_cal):
        """zoo/quantized_encdec.py:483 ``_build_int8_encdec`` (requant
        ``"mul"``, no float fallback): scale propagation, the integer
        constants and the sequential bias correction."""
        qmax, device = self.qmax, self.device
        sigma = {0: np.maximum(input_amax, 1e-12) / qmax}
        self.consts = {}
        self.inv_sigma_in = _f32_per_channel(1.0 / sigma[0], device)
        cal_hw = tuple(x_cal.shape[2:])
        vals_q = {0: self._quantize_input(x_cal)}
        dims = (0, 2, 3)
        with torch.no_grad():
            for node in self.nodes[1:]:
                a = node.attrs
                if node.op == "conv":
                    sig_in = sigma[node.inputs[0]]
                    w_abs = _absorb_grouped(a["w"], sig_in, a["groups"])
                    w_q, b_q, mult, clamp, sigma_out = C.quantize_conv_mul(w_abs, a["b"], amax[node.id], qmax)
                    self.consts[node.id] = {"w": C.oihw(w_q, device), "b_q": C.int32(b_q, device),
                                            "mult": C.int32(mult, device), "clamp": C.int32(clamp, device)}
                    sigma[node.id] = sigma_out
                    sw = np.maximum(np.abs(w_abs).max(axis=(0, 1, 2)) / qmax, 1e-12)
                    acc = self._conv(node, vals_q[node.inputs[0]], epilogue="acc")
                    q0 = C.requant(acc, "mul", self.consts[node.id]["b_q"], a["relu"], None, None,
                                   self.consts[node.id]["mult"], self.consts[node.id]["clamp"], qmax
                                   ).contiguous(memory_format=C.CL)
                    err = vals[node.id].mean(dim=dims).cpu().numpy().astype(np.float64) - (
                        sigma_out * q0.float().mean(dim=dims).cpu().numpy().astype(np.float64))
                    delta = np.round(err / sw)
                    b_new = (np.asarray(b_q, np.int64) + delta.astype(np.int64)).clip(-(2**31), 2**31 - 1)
                    self.consts[node.id]["b_q"] = torch.as_tensor(b_new.astype(np.int32), device=device)
                    vals_q[node.id] = C.requant(acc, "mul", self.consts[node.id]["b_q"], a["relu"], None, None,
                                                self.consts[node.id]["mult"], self.consts[node.id]["clamp"], qmax
                                                ).contiguous(memory_format=C.CL)
                    continue
                if node.op == "maxpool3s2":
                    sigma[node.id] = sigma[node.inputs[0]]
                elif node.op == "se":
                    sig_in = sigma[node.inputs[0]]
                    self.consts[node.id] = {
                        "w1": torch.as_tensor(a["w1"][0, 0].astype(np.float32), device=device),
                        "b1": torch.as_tensor(a["b1"].astype(np.float32), device=device),
                        "w2": torch.as_tensor(a["w2"][0, 0].astype(np.float32), device=device),
                        "b2": torch.as_tensor(a["b2"].astype(np.float32), device=device),
                        "sig_in": torch.as_tensor(sig_in.astype(np.float32), device=device),
                    }
                    sigma[node.id] = sig_in
                elif node.op == "add":
                    sig_a, sig_b = sigma[node.inputs[0]], sigma[node.inputs[1]]
                    sig_out = np.maximum(amax[node.id], 1e-12) / qmax
                    ma = np.clip(np.round(sig_a / sig_out * (1 << ADD_SHIFT)), 0, 1 << 20)
                    mb = np.clip(np.round(sig_b / sig_out * (1 << ADD_SHIFT)), 0, 1 << 20)
                    self.consts[node.id] = {
                        "ma": torch.as_tensor(ma.astype(np.int32), device=device).view(1, -1, 1, 1),
                        "mb": torch.as_tensor(mb.astype(np.int32), device=device).view(1, -1, 1, 1),
                    }
                    sigma[node.id] = sig_out
                elif node.op == "upsample2":
                    sigma[node.id] = sigma[node.inputs[0]] * C.UP_MULT
                elif node.op == "head":
                    head_eff = a["w"] * sigma[node.inputs[0]][None, None, :, None]
                    sw = np.maximum(np.abs(head_eff).max(axis=(0, 1, 2)) / qmax, 1e-12)
                    w_q = np.clip(np.round(head_eff / sw), -qmax, qmax).astype(np.int8)
                    self.consts[node.id] = {"w": C.oihw(w_q, device), "sw": _f32_per_channel(sw, device),
                                            "bias": _f32_per_channel(a["b"], device)}
                    # the output resize is linear with weights summing to 1 per pixel: correct the final logits
                    q0 = self._exec(node, vals_q, cal_hw)
                    err = vals[node.id].mean(dim=dims) - q0.mean(dim=dims)
                    self.consts[node.id]["bias"] = self.consts[node.id]["bias"] + err.view(1, -1, 1, 1)
                if node.op != "head":
                    vals_q[node.id] = self._exec(node, vals_q, cal_hw)
        self.last_use = {src: node.id for node in self.nodes for src in node.inputs}

    def _quantize_input(self, x):
        return torch.clamp(torch.round(x.float() * self.inv_sigma_in), -self.qmax, self.qmax).to(
            torch.int8).contiguous(memory_format=C.CL)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        resize_hw = tuple(x.shape[2:])
        vals = {0: self._quantize_input(x)}
        for node in self.nodes[1:]:
            vals[node.id] = self._exec(node, vals, resize_hw)
            for src in node.inputs:  # free what no later node reads
                if self.last_use[src] == node.id:
                    del vals[src]
        return vals[self.nodes[-1].id]
