"""Plain reference of ``unet32-int8``: UNet-32 (channels 32/64/128/256, four
levels, one class, 15 3x3 convs, BatchNorm, ReLU, 2x2 max pooling, bilinear
align_corners upsampling joined to the skip), post-training quantized to
int8 as ``pytorch_toolbelt_tpu_torch.zoo.quantize_unet_inference`` does.

It works the calibration and the integer network out again from the seeded
float weights and calibration images the benchmark hands to both sides: the
BatchNorm fold in float32 on the weights' device, the folded float32 replay
that records each conv's per-channel range (TF32 off), the numpy float64
constants, and the integer forward on ``common.qconv2d`` and
``common.q_upsample_cat`` (float64 sums of int8 values: exact).  Frozen
copies of ``zoo/quantized_unet.py:219-355``; it imports nothing of the
program.

Weights are named as the program's ``UNetSegmentationModel`` names them, so
that one dict of tensors loads into both.
"""

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import common as C


def channels(cfg) -> list:
    return [cfg["encoder_channels"] * cfg["growth_factor"] ** i for i in range(cfg["num_layers"])]


def _blocks(cfg):
    """(parameter prefix, C_in, C_out) of each UnetBlock, encoder first,
    then the decoder's stages coarsest first."""
    ch = channels(cfg)
    blocks, prev = [], cfg["in_channels"]
    for i, c in enumerate(ch):
        blocks.append((f"encoder.blocks.{i}", prev, c))
        prev = c
    for s, i in enumerate(range(len(ch) - 2, -1, -1)):
        blocks.append((f"decoder.stages.{s}.0", prev + ch[i], ch[i]))
        prev = ch[i]
    return blocks


def param_spec(cfg) -> list:
    """(name, shape, kind, factor) of every tensor of the model's state dict;
    kinds as ``weights.make`` draws them."""
    spec = []
    for prefix, cin, cout in _blocks(cfg):
        for j, c_in in ((1, cin), (2, cout)):
            spec.append((f"{prefix}.conv{j}.weight", (cout, c_in, 3, 3), "conv", 1.0))
            bn = f"{prefix}.norm{j}.norm"
            spec += [(f"{bn}.weight", (cout,), "bn_weight", 1.0), (f"{bn}.bias", (cout,), "bias", 1.0),
                     (f"{bn}.running_mean", (cout,), "bias", 1.0), (f"{bn}.running_var", (cout,), "bn_var", 1.0),
                     (f"{bn}.num_batches_tracked", (), "count", 1.0)]
    k = cfg["num_classes"]
    spec += [("head.conv.weight", (k, channels(cfg)[0], 3, 3), "conv", 1.0), ("head.conv.bias", (k,), "bias", 1.0)]
    return spec


def conv_shapes(cfg, h: int, w: int) -> list:
    """Every conv of one forward of an h x w view: what Q1 computes."""
    shapes, blocks, n_enc = [], _blocks(cfg), cfg["num_layers"]
    for b, (_, cin, cout) in enumerate(blocks):
        level = b if b < n_enc else 2 * n_enc - 2 - b
        size = (h >> level, w >> level)
        for c_in in (cin, cout):
            shapes.append(dict(cin=c_in, cout=cout, kh=3, kw=3, stride=1, groups=1, h=size[0], w=size[1],
                               ho=size[0], wo=size[1], out_bytes=1))
    c0 = channels(cfg)[0]
    shapes.append(dict(cin=c0, cout=cfg["num_classes"], kh=3, kw=3, stride=1, groups=1, h=h, w=w, ho=h, wo=w,
                       out_bytes=4))
    return shapes


def q2_calls(cfg, h: int, w: int) -> list:
    """Every decoder input of one forward (Q2 with the skip): channels of
    the upsampled x and of the skip, input and output sizes."""
    ch, calls = channels(cfg), []
    prev = ch[-1]
    for i in range(len(ch) - 2, -1, -1):
        calls.append(dict(c=prev, cs=ch[i], h=h >> (i + 1), w=w >> (i + 1), oh=h >> i, ow=w >> i))
        prev = ch[i]
    return calls


class Model:
    """The int8 UNet of ``weights`` calibrated on ``calibration_images``
    ([N, C, H, W] float32 on the weights' device); calling it maps
    [B, C, H, W] float32 to [B, num_classes, H, W] float32 logits."""

    def __init__(self, cfg, weights: dict, calibration_images: torch.Tensor, qmax: int = C.QMAX):
        self.qmax = qmax
        blocks = _blocks(cfg)
        n_enc = cfg["num_layers"]
        folded = [self._fold(weights, prefix, cfg["bn_eps"]) for prefix, _, _ in blocks]
        enc, dec = folded[:n_enc], folded[n_enc:]
        head_w = C.hwio(weights["head.conv.weight"])
        head_b = weights["head.conv.bias"].detach().cpu().numpy().astype(np.float64)
        amax, input_amax = self._calibrate(enc, dec, calibration_images)
        self._build(enc, dec, head_w, head_b, amax, input_amax, calibration_images.shape[1],
                    calibration_images.device)

    @staticmethod
    def _fold(weights, prefix, eps):
        """zoo/quantized_unet.py:219 ``_fold_block``: the BatchNorm fold in
        float32 on the weights' device, then widened."""
        out = []
        for j in (1, 2):
            bn = f"{prefix}.norm{j}.norm"
            inv = weights[f"{bn}.weight"].float() / torch.sqrt(weights[f"{bn}.running_var"].float() + eps)
            bias = weights[f"{bn}.bias"].float() - weights[f"{bn}.running_mean"].float() * inv
            out.append((C.hwio(weights[f"{prefix}.conv{j}.weight"])
                        * inv.cpu().numpy().astype(np.float64)[None, None, None, :],
                        bias.cpu().numpy().astype(np.float64)))
        return out

    @staticmethod
    def _calibrate(enc, dec, x_cal):
        """zoo/quantized_unet.py:256 ``_calibrate_unet``: per-channel
        post-ReLU absmax of every conv from one folded float32 replay."""
        device, amax, num_stages = x_cal.device, {}, len(enc) - 1

        def cal_conv(x, w, b, key):
            w32 = torch.as_tensor(w.transpose(3, 2, 0, 1).astype(np.float32), device=device)
            y = F.conv2d(x, w32, padding=(w.shape[0] // 2, w.shape[1] // 2))
            y = torch.relu(y + torch.as_tensor(b.astype(np.float32), device=device).view(1, -1, 1, 1))
            amax[key] = y.abs().amax(dim=(0, 2, 3)).cpu().numpy().astype(np.float64)
            return y

        with torch.no_grad(), C.full_fp32():
            x, skips = x_cal, []
            for layer in range(len(enc)):
                if layer > 0:
                    x = torch.maximum(torch.maximum(x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2]),
                                      torch.maximum(x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2]))
                for j, (w, b) in enumerate(enc[layer]):
                    x = cal_conv(x, w, b, ("enc", layer, j))
                skips.append(x)
            for i in range(num_stages - 1, -1, -1):
                skip = skips[i]
                x = torch.cat([C.resize_matmul(x, skip.shape[2:], True), skip], dim=1)
                for j, (w, b) in enumerate(dec[num_stages - 1 - i]):
                    x = cal_conv(x, w, b, ("dec", i, j))
            input_amax = float(x_cal.abs().max())
        return amax, input_amax

    def _build(self, enc, dec, head_w, head_b, amax, input_amax, in_channels, device):
        """zoo/quantized_unet.py:295 ``_build_int8_unet``: the integer
        constants, input scales absorbed into each consumer's weights."""
        qmax, num_stages = self.qmax, len(enc) - 1
        sigma_in = np.full(in_channels, max(input_amax, 1e-12) / qmax)

        def build_conv(w_eff, b, key, sigma):
            w_q, b_q, shift, rnd, sigma_out = C.quantize_conv(w_eff * sigma[None, None, :, None], b, amax[key], qmax)
            return (C.oihw(w_q, device), C.int32(b_q, device), C.int32(rnd, device), C.int32(shift, device)), sigma_out

        self.enc, sig, sig_skips = [], sigma_in, []
        for layer in range(len(enc)):
            row = []
            for j, (w, b) in enumerate(enc[layer]):
                qc, sig = build_conv(w, b, ("enc", layer, j), sig)
                row.append(qc)
            self.enc.append(row)
            sig_skips.append(sig)
        self.dec = []
        for i in range(num_stages - 1, -1, -1):
            sig = np.concatenate([sig * C.UP_MULT, sig_skips[i]])
            row = []
            for j, (w, b) in enumerate(dec[num_stages - 1 - i]):
                qc, sig = build_conv(w, b, ("dec", i, j), sig)
                row.append(qc)
            self.dec.append(row)
        head_eff = head_w * sig[None, None, :, None]
        sw_head = np.maximum(np.abs(head_eff).max(axis=(0, 1, 2)) / qmax, 1e-12)
        self.head = C.oihw(np.clip(np.round(head_eff / sw_head), -qmax, qmax).astype(np.int8), device)
        self.head_sw = torch.as_tensor(sw_head, dtype=torch.float32, device=device).view(1, -1, 1, 1)
        self.head_bias = torch.as_tensor(head_b, dtype=torch.float32, device=device).view(1, -1, 1, 1)
        self.inv_sigma_in = torch.as_tensor(1.0 / sigma_in, dtype=torch.float32, device=device).view(1, -1, 1, 1)

    def _conv(self, x_q, qc):
        w, b_q, rnd, shift = qc
        return C.qconv2d(x_q, w, 1, (1, 1, 1, 1), 1, "shift", bias=b_q, relu=True, rnd=rnd, shift=shift, qmax=self.qmax)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        qmax = self.qmax
        x_q = torch.round(x.float() * self.inv_sigma_in).clamp(-qmax, qmax).to(torch.int8).contiguous(memory_format=C.CL)
        skips = []
        for layer, row in enumerate(self.enc):
            if layer > 0:
                x_q = torch.maximum(torch.maximum(x_q[:, :, 0::2, 0::2], x_q[:, :, 0::2, 1::2]),
                                    torch.maximum(x_q[:, :, 1::2, 0::2], x_q[:, :, 1::2, 1::2])
                                    ).contiguous(memory_format=C.CL)
            for qc in row:
                x_q = self._conv(x_q, qc)
            skips.append(x_q)
        for idx, i in enumerate(range(len(self.enc) - 2, -1, -1)):
            mh, mw = C.q_upsample_matrices(*x_q.shape[2:], *skips[i].shape[2:])
            x_q = C.q_upsample_cat(x_q, skips[i], mh, mw, qmax)
            for qc in self.dec[idx]:
                x_q = self._conv(x_q, qc)
        acc = C.qconv2d(x_q, self.head, 1, (1, 1, 1, 1), 1, "acc")
        return (acc.float() * self.head_sw + self.head_bias).contiguous()
