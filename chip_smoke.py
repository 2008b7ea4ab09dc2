#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytorch_toolbelt_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pytorch_toolbelt_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version at the shapes of the
main path, then drives the main paths through the entry points a user calls -- tiled UNet-32
inference with d4 test-time augmentation in both modes, the BASELINE
config-4 loss suite, streaming tiled inference of SEResNeXt50-FPN through
``TileMerger(use_pallas=True)``, and config 3's d4 + multiscale TTA -- and
holds each against an independent plain path.  Weights and data are random,
made from a seed.

Phases, each printed on its own line:
  1. the card's name and power limit; the kernel build and its time; each
     kernel's registers and spills; the HGMMA, UTMALDG and UBLKCP
     instructions in the wgmma conv kernels' SASS (``cuobjdump``);
  2. K2 (conv3x3) against ``conv3x3_reference`` at every conv shape of
     UNet-32 on 512^2 tiles, through the route the UNet takes and through
     the WMMA route; at the main path's batch (64 tiles x 2 views), per
     shape: the kernel's ms and TFLOP/s, the WMMA kernel's, cuDNN plus the
     eager epilogue, one ``F.conv2d``, and the shape's bound and what sets it;
  3. K1 (grid merge) against ``grid_merge_reference`` at the 5000^2
     geometry (361 tiles of 512^2, step 256, K = 1);
  4. ``fuse_unet_inference`` against the plain module in ``eval()``;
  5. ``tiled_apply_d4_tta`` on a 2048^2 image in both modes against the
     plain path; both kernels' launch counters must rise, and every conv
     with C_in % 8 == 0 must take K2's TMA route;
  6. one 5000^2 run in each mode at the bench batches, for its wall time,
     peak memory and K2's launches by route; then the distributed run under
     ``torch.profiler``: device idle share, K2's share and the top kernels
     (information only);
  7. K4 (radix sort) and K5 (merge sort) against ``sort_reference``, keys
     and payloads bit for bit, at the Lovasz shapes of config 4 ([19, 2^23]
     forward and backward pairs, [152, 2^20] per image) and an odd shape
     with planted ties, +-0.0 and NaN; ms and Gpairs/s of each;
  8. the config-4 loss suite at full size (logits [8, 19, 1024, 1024]):
     focal, dice, jaccard, Lovasz-Softmax on K4 and on K5, binary Lovasz,
     each value and gradient against a plain fp32 autograd path written
     here; both sort counters must rise; ms per chained fwd+bwd step, peak
     memory, GB/s against the card's own copy bandwidth, the sorts' share;
  9. K3 (scatter merge) against ``accumulate_tiles_reference``, bit for
     bit: the streaming batch (32 overlapping 512^2 tiles of 19 channels
     into the [19, 5120, 5120] canvas) in fp32 and bf16, a misaligned
     geometry and one tile; ms, GB/s and bound of the bf16 batch, beside the
     reference and an ``index_add_`` pair;
 10. streaming tiled inference of a 5000^2 uint8 RGB image: ImageSlicer
     (512, step 256, pyramid) -> batches of 32 host -> device ->
     SEResNeXt50-FPN(128) in bf16 -> ``TileMerger(use_pallas=True)`` (one K3
     launch per batch, 12 in all) -> ``merge()`` -> crop.  Its canvas must
     equal ``TileMerger(use_pallas=False)``'s on the same model outputs bit
     for bit; a 2048^2 run holds the bf16 result against the fp32 model;
     wall time, MP/s, peak memory, K3's share of device time, the device
     idle share and the top kernels (``torch.profiler``), the host's
     slicing time;
 11. BASELINE config 3: ``MultiscaleTTA(d4_image2mask, [0, -256])`` over
     SEResNeXt50-FPN(128) on one 1024^2 image in bf16 against fp32; ms per
     call, MP/s, peak memory.

The kernels line gives, for every kernel, its time at the main path's shape
beside its plain version's, one library call's where one computes the same
function, and its bound: the larger of its compulsory bytes over 3.35 TB/s
and its operations over the 989 TFLOP/s bf16 peak (H100 SXM data sheet).

Any mismatch or error exits non-zero.  The line before the last is a JSON
object describing the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TILE, STEP = 512, 256
DIST_BATCH, FULL_BATCH = 64, 16
CONV_TOL = 2e-2  # bf16 operands and output, fp32 accumulation: relative to max|ref|
MERGE_TOL = 1e-5  # fp32 sums in the same order as the reference
# bf16 fused path against the fp32 plain path, relative to max|ref|: the activations are
# rounded to bf16 (2^-9 relative) after each of the 15 convs and the errors compound
PATH_TOL = 5e-2
SEED = 0
TIME_BUDGET_S = 1200
# fp32 sums over up to 2^23 elements run in another order than the plain path's
LOSS_VALUE_RTOL = 1e-4  # relative to the plain value
LOSS_GRAD_TOL = 1e-4  # relative to max|plain gradient|
LOSS_SHAPE = (8, 19, 1024, 1024)  # BASELINE config 4: batch 8, 19 classes, 1024^2 logits
LOSS_STEPS = 16  # chained value + gradient + x += 1e-4 * grad steps, as bench.py times them
# The card's published peaks (H100 SXM data sheet, dense, at 700 W): the least time the card could
# take for a kernel's work is the larger of its bytes over HBM_RATE and its operations over the peak
HBM_RATE = 3.35e12  # bytes/s
BF16_PEAK = 989e12  # tensor-core FLOP/s
# Slice C + K3: the streaming tiled path and config 3
CLASSES = 19
STREAM_SIZE, STREAM_BATCH = 5000, 32  # 361 tiles of 512^2 at step 256 -> 12 batches
STREAM_CHECK_SIZE = 2048  # the bf16 path against the fp32 one
MS_SIZE, MS_OFFSETS = 1024, [0, -256]  # BASELINE config 3
RESIDUAL_BN_SCALE = 0.25  # see config3_model


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float = 0.0, peak_flops: float = BF16_PEAK):
    """(least time in ms on the card's published peaks, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, between CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def unet_conv_shapes(channels=32, num_layers=4, num_classes=1, size=TILE):
    """(C_in, C_out, spatial size, relu) of every 3x3 conv of the UNet."""
    ch = [channels * 2**i for i in range(num_layers)]
    shapes = []
    prev = 3
    for i, c in enumerate(ch):
        shapes += [(prev, c, size >> i, True), (c, c, size >> i, True)]
        prev = c
    for i in range(num_layers - 2, -1, -1):
        shapes += [(prev + ch[i], ch[i], size >> i, True), (ch[i], ch[i], size >> i, True)]
        prev = ch[i]
    shapes.append((prev, num_classes, size, False))
    return shapes


def seed_weights(model, seed: int):
    """Seeded weights: He-normal convs, BN affine parameters and running
    statistics near their identity values."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=gen))
    return model


def seeded_unet(seed: int, device):
    """UNet-32 with weights and non-trivial BN statistics from a seeded generator."""
    from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel

    model = UNetSegmentationModel(num_classes=1, encoder_channels=32, num_layers=4, growth_factor=2)
    return seed_weights(model, seed).to(device).eval()


def phase_build():
    from pytorch_toolbelt_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s: {path.name}")
    log_file = path.with_name(path.name + ".log")
    if log_file.is_file():
        for name, regs, spills in _ptxas_report(log_file.read_text()):
            log(f"[1]   ptxas: {name}: {regs} registers, {spills} bytes of spill stores")
    cuobjdump = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    if not Path(cuobjdump).is_file():
        log("[1] cuobjdump not found: the conv kernels' SASS is not inspected")
    else:
        sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True, timeout=300).stdout
        counts = _sass_counts(sass, "conv3x3_wgmma_kernel", ("HGMMA", "UTMALDG", "UBLKCP"))
        log(f"[1] SASS of the {counts.pop('functions')} wgmma conv kernels (cuobjdump -sass): "
            + ", ".join(f"{op} {n}" for op, n in counts.items()))
    return smi


def _ptxas_report(text: str):
    """(kernel, registers, spill-store bytes) for every entry function in a ``ptxas -v`` log."""
    name = None
    for line in text.splitlines():
        match = re.search(r"Compiling entry function '(\S+)'", line)
        if match:  # a mangled name: keep the kernel's name and its integer template arguments
            name = match.group(1)
            inner = re.search(r"(conv3x3_wgmma_kernel|conv3x3_kernel|[a-z_]+_kernel)(I(?:L[ib]\d+E)+)?", name)
            if inner:
                args = re.findall(r"L[ib](\d+)E", inner.group(2) or "")
                name = inner.group(1) + (f"<{', '.join(args)}>" if args else "")
            spills = 0
        match = re.search(r"(\d+) bytes spill stores", line)
        if match:
            spills = int(match.group(1))
        match = re.search(r"Used (\d+) registers", line)
        if match and name:
            yield name, int(match.group(1)), spills
            name = None


def _sass_counts(sass: str, function: str, ops) -> dict:
    """Occurrences of each SASS opcode in the functions whose name holds ``function``."""
    counts, inside, functions = dict.fromkeys(ops, 0), False, 0
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function in line
            functions += inside
        elif inside:
            for op in ops:
                counts[op] += bool(re.search(rf"\b{op}\b", line))
    return {"functions": functions, **counts}


def phase_conv(dev, smi):
    """K2 at every conv shape of UNet-32: each route against its plain
    version at batch 2, then the times at the main path's batch."""
    from pytorch_toolbelt_tpu_torch.ops import conv3x3, conv3x3_reference, pack_conv3x3_weights
    from pytorch_toolbelt_tpu_torch.ops.conv_kernels import _pack_wmma, _route, _unpack

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    max_err = 0.0
    total = dict.fromkeys(("ms", "wmma_ms", "cudnn_ms", "library_ms", "plain_ms", "gflop"), 0.0)
    bounds = {"bytes": 0.0, "operations": 0.0}
    timing_batch = 2 * DIST_BATCH
    for c_in, c_out, size, relu in unet_conv_shapes():
        w = torch.randn(c_out, c_in, 3, 3, device=dev, generator=gen) * (2.0 / (9 * c_in)) ** 0.5
        packed, packed_wmma = pack_conv3x3_weights(w), _pack_wmma(w)
        route = _route(packed, c_in)
        w_bf = _unpack(packed, c_in, c_out).float()  # the bf16-rounded weights the kernels use
        scale = (1.0 + 0.1 * torch.randn(c_out, device=dev, generator=gen)) if relu else torch.ones(c_out, device=dev)
        bias = 0.1 * torch.randn(c_out, device=dev, generator=gen)

        x = torch.randn(2, c_in, size, size, device=dev, generator=gen).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        ref = conv3x3_reference(x, w_bf, scale, bias, relu)
        tol = CONV_TOL * float(ref.abs().max())
        errs = {}
        for name, wp in ((route, packed), ("wmma", packed_wmma)):
            got = conv3x3(x, wp, scale, bias, relu=relu).float()
            torch.cuda.synchronize()
            errs[name] = float((got - ref).abs().max()) if bool(torch.isfinite(got).all()) else float("inf")
        err = errs[route]
        max_err = max(max_err, err)

        xb = torch.randn(timing_batch, c_in, size, size, device=dev, generator=gen).to(torch.bfloat16)
        xb = xb.contiguous(memory_format=torch.channels_last)
        w_cudnn = w_bf.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

        def cudnn():
            y = F.conv2d(xb, w_cudnn, padding=1).float() * scale[None, :, None, None] + bias[None, :, None, None]
            return (torch.relu(y) if relu else y).to(torch.bfloat16)

        # one library call for the same function but the ReLU: scale folded into the weights, bias as conv bias
        w_folded = (w_bf * scale[:, None, None, None]).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        b_folded = bias.to(torch.bfloat16)

        ms = cuda_ms(lambda: conv3x3(xb, packed, scale, bias, relu=relu), reps=5)
        wmma_ms = cuda_ms(lambda: conv3x3(xb, packed_wmma, scale, bias, relu=relu), reps=3)
        cudnn_ms = cuda_ms(cudnn, reps=3)
        library_ms = cuda_ms(lambda: F.conv2d(xb, w_folded, b_folded, padding=1), reps=5)
        plain_ms = cuda_ms(lambda: conv3x3_reference(xb, w_bf, scale, bias, relu), reps=1)
        gflop = 2.0 * timing_batch * size * size * 9 * c_in * c_out / 1e9
        nbytes = 2 * timing_batch * size * size * (c_in + c_out) + 2 * 9 * c_in * c_out + 8 * c_out
        bound, bound_by = bound_ms(nbytes, gflop * 1e9)
        bounds[bound_by] += bound
        for key, value in (("ms", ms), ("wmma_ms", wmma_ms), ("cudnn_ms", cudnn_ms), ("library_ms", library_ms),
                           ("plain_ms", plain_ms), ("gflop", gflop)):
            total[key] += value
        ok = max(errs.values()) <= tol
        log(f"[2] conv3x3 {c_in:>3}->{c_out:<3} @{size:>3}^2 relu={int(relu)} route {route}: max|err| {err:.3e} "
            f"(wmma {errs['wmma']:.3e}) <= {tol:.3e} {'ok' if ok else 'FAIL'}; batch {timing_batch}: "
            f"kernel {ms:.3f} ms ({gflop / ms:.1f} TFLOP/s), wmma {wmma_ms:.3f} ms, cuDNN + epilogue "
            f"{cudnn_ms:.3f} ms, one F.conv2d {library_ms:.3f} ms, fp32 reference {plain_ms:.3f} ms; "
            f"bound {bound:.3f} ms ({bound_by}) = {bound / ms:.1%} of the kernel")
        if not ok:
            raise AssertionError(f"conv3x3 {c_in}->{c_out} @{size} disagrees with conv3x3_reference: {errs}")
        del xb, w_cudnn, w_folded
    bound_total = bounds["bytes"] + bounds["operations"]
    bound_by = max(bounds, key=bounds.get)
    log(f"[2] conv3x3 all shapes, batch {timing_batch}: kernel {total['ms']:.2f} ms "
        f"({total['gflop'] / total['ms']:.1f} TFLOP/s), wmma {total['wmma_ms']:.2f} ms, cuDNN + epilogue "
        f"{total['cudnn_ms']:.2f} ms, one F.conv2d per shape {total['library_ms']:.2f} ms, fp32 reference "
        f"{total['plain_ms']:.2f} ms; bound {bound_total:.2f} ms (bytes {bounds['bytes']:.2f}, operations "
        f"{bounds['operations']:.2f}) ({smi})")
    return {"max_abs_err": max_err, "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": bound_total,
            "bound_by": bound_by, "library_ms": total["library_ms"]}


def phase_merge(dev):
    from pytorch_toolbelt_tpu_torch.inference import ImageSlicer
    from pytorch_toolbelt_tpu_torch.ops import grid_merge, grid_merge_reference

    slicer = ImageSlicer((5000, 5000), TILE, STEP, weight="pyramid")
    th, tw = slicer.tile_size
    ty = (slicer.target_shape[0] - th) // STEP + 1
    tx = (slicer.target_shape[1] - tw) // STEP + 1
    grid = (ty, tx, STEP, STEP)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    tiles = torch.randn(ty * tx, 1, th, tw, device=dev, generator=gen)
    weight = torch.as_tensor(slicer.weight.astype(np.float32), device=dev)
    crop = dict(out_hw=(5000, 5000), offset=(slicer.margin_top, slicer.margin_left))

    got = grid_merge(tiles, weight, grid, **crop)
    ref = grid_merge_reference(tiles, weight, grid, **crop)
    got_c, got_n = grid_merge(tiles, weight, grid, normalize=False)
    ref_c, ref_n = grid_merge_reference(tiles, weight, grid, normalize=False)
    torch.cuda.synchronize()
    err = max(float((got - ref).abs().max()), float((got_c - ref_c).abs().max()), float((got_n - ref_n).abs().max()))
    ok = bool(torch.isfinite(got).all()) and err <= MERGE_TOL
    ms = cuda_ms(lambda: grid_merge(tiles, weight, grid, **crop), reps=10)
    ref_ms = cuda_ms(lambda: grid_merge_reference(tiles, weight, grid, **crop), reps=2)
    # the library's overlap-add: F.fold of the weighted tiles (no division, no crop)
    cols = (tiles * weight).reshape(ty * tx, -1).t().unsqueeze(0)
    fold = lambda: F.fold(cols, got_c.shape[1:], (th, tw), stride=STEP)  # noqa: E731
    fold_err = float((fold()[0] - got_c).abs().max())
    fold_ms = cuda_ms(fold, reps=10)
    nbytes = tiles.numel() * 4 + 5000 * 5000 * 4 + weight.numel() * 4
    bound, bound_by = bound_ms(nbytes)
    log(f"[3] grid_merge {ty * tx} tiles -> 5000^2: max|err| {err:.3e} <= {MERGE_TOL:.0e} {'ok' if ok else 'FAIL'}; "
        f"kernel {ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s of compulsory traffic), reference {ref_ms:.3f} ms; "
        f"F.fold {fold_ms:.3f} ms (vs the kernel's canvas max|diff| {fold_err:.2e}); bound {bound:.3f} ms ({bound_by})")
    if not ok:
        raise AssertionError("grid_merge disagrees with grid_merge_reference")
    return {"max_abs_err": err, "ms": ms, "plain_ms": ref_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": fold_ms}


def phase_fused(model, fused, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.rand(8, 3, TILE, TILE, device=dev, generator=gen)
    with torch.no_grad():
        ref = model(x)
    got = fused(x).float()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = PATH_TOL * float(ref.abs().max())
    ok = got.shape == ref.shape and bool(torch.isfinite(got).all()) and err <= tol
    log(f"[4] fuse_unet_inference vs nn.Module eval, 8 x 512^2: max|err| {err:.3e} <= {tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fused UNet disagrees with the plain module")


_AUG = (
    lambda t: t,
    lambda t: torch.rot90(t, -1, (1, 2)),
    lambda t: torch.rot90(t, 2, (1, 2)),
    lambda t: torch.rot90(t, 1, (1, 2)),
    lambda t: t.transpose(1, 2),
    lambda t: torch.rot90(t.transpose(1, 2), -1, (1, 2)),
    lambda t: torch.rot90(t.transpose(1, 2), 2, (1, 2)),
    lambda t: torch.rot90(t.transpose(1, 2), 1, (1, 2)),
)
_DEAUG = (
    lambda t: t,
    lambda t: torch.rot90(t, 1, (1, 2)),
    lambda t: torch.rot90(t, 2, (1, 2)),
    lambda t: torch.rot90(t, -1, (1, 2)),
    lambda t: t.transpose(1, 2),
    lambda t: torch.rot90(t, 1, (1, 2)).transpose(1, 2),
    lambda t: torch.rot90(t, 2, (1, 2)).transpose(1, 2),
    lambda t: torch.rot90(t, -1, (1, 2)).transpose(1, 2),
)
_PARITY_VIEWS = ((0, 2), (1, 3), (4, 6), (5, 7))


@torch.no_grad()
def plain_tiled_d4(model, image, mode):
    """Independent plain path: tile by tile, the views of each tile through
    the plain module, then the plain merge."""
    from pytorch_toolbelt_tpu_torch.inference import ImageSlicer
    from pytorch_toolbelt_tpu_torch.ops import grid_merge_reference

    h, w = image.shape[1:]
    slicer = ImageSlicer((h, w), TILE, STEP, weight="pyramid")
    padded = F.pad(image, (slicer.margin_left, slicer.margin_right, slicer.margin_top, slicer.margin_bottom))
    preds = []
    for x, y, tw, th in slicer.crops:
        tile = padded[:, y : y + th, x : x + tw]
        views = range(8) if mode == "full" else _PARITY_VIEWS[(y // STEP) % 2 * 2 + (x // STEP) % 2]
        out = model(torch.stack([_AUG[v](tile) for v in views]))
        preds.append(torch.stack([_DEAUG[v](o) for v, o in zip(views, out)]).mean(0))
    ty = (slicer.target_shape[0] - TILE) // STEP + 1
    tx = (slicer.target_shape[1] - TILE) // STEP + 1
    weight = torch.as_tensor(slicer.weight.astype(np.float32), device=image.device)
    return grid_merge_reference(torch.stack(preds), weight, (ty, tx, STEP, STEP), out_hw=(h, w),
                                offset=(slicer.margin_top, slicer.margin_left))


def phase_tiled(model, fused, dev):
    from pytorch_toolbelt_tpu_torch.inference import tiled_apply_d4_tta
    from pytorch_toolbelt_tpu_torch.ops import conv3x3, grid_merge

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    image = torch.rand(3, 2048, 2048, device=dev, generator=gen)
    runs = (("distributed", DIST_BATCH), ("full", FULL_BATCH))

    torch.cuda.synchronize()
    _reset_conv_counts()
    grid_merge.launches = 0
    outs, walls = {}, {}
    for mode, batch in runs:
        t0 = time.perf_counter()
        outs[mode] = tiled_apply_d4_tta(fused, image, TILE, STEP, weight="pyramid", batch_size=batch, mode=mode)
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t0
    launches = {"conv3x3": conv3x3.launches, "grid_merge": grid_merge.launches,
                "conv3x3_by_route": dict(conv3x3.launches_by_route)}
    log(f"[5] main path launches: {launches}")
    if min(conv3x3.launches, grid_merge.launches) == 0:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    _check_conv_routes("[5] 2048^2 runs")

    for mode, batch in runs:
        got = outs[mode].float()
        ref = plain_tiled_d4(model, image, mode)
        err = float((got - ref).abs().max())
        tol = PATH_TOL * float(ref.abs().max())
        ok = got.shape == (1, 2048, 2048) and bool(torch.isfinite(got).all()) and err <= tol
        log(f"[5] tiled_apply_d4_tta 2048^2 mode={mode} batch={batch}: {walls[mode]:.3f} s (first call); "
            f"vs plain path max|err| {err:.3e} <= {tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"tiled_apply_d4_tta mode={mode} disagrees with the plain path")
    return launches


def _reset_conv_counts():
    from pytorch_toolbelt_tpu_torch.ops import conv3x3

    conv3x3.launches = 0
    for route in conv3x3.launches_by_route:
        conv3x3.launches_by_route[route] = 0


def _check_conv_routes(what: str):
    """UNet-32's forward has one conv with C_in % 8 != 0 (the 3-channel stem,
    the load route) and 14 with C_in % 8 == 0, which must all take TMA."""
    from pytorch_toolbelt_tpu_torch.ops import conv3x3

    by_route = conv3x3.launches_by_route
    if by_route["wmma"] or not by_route["ld_wgmma"] or by_route["tma_wgmma"] != 14 * by_route["ld_wgmma"]:
        raise AssertionError(f"{what}: K2 launches by route {by_route}, expected 14 tma_wgmma per ld_wgmma")


def phase_full_size(fused, dev, smi):
    from torch.profiler import ProfilerActivity, profile

    from pytorch_toolbelt_tpu_torch.inference import tiled_apply_d4_tta
    from pytorch_toolbelt_tpu_torch.ops import conv3x3

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    image = torch.rand(3, 5000, 5000, device=dev, generator=gen)
    for mode, batch in (("distributed", DIST_BATCH), ("full", FULL_BATCH)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_conv_counts()
        t0 = time.perf_counter()
        out = tiled_apply_d4_tta(fused, image, TILE, STEP, weight="pyramid", batch_size=batch, mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if out.shape != (1, 5000, 5000) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"5000^2 {mode} run gave a wrong shape or non-finite values")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[6] tiled_apply_d4_tta 5000^2 {mode} batch={batch}: {wall:.3f} s, {25.0 / wall:.2f} MP/s, "
            f"peak {peak:.2f} GiB allocated; K2 launches by route {dict(conv3x3.launches_by_route)} ({smi})")
        _check_conv_routes(f"[6] 5000^2 {mode}")
        del out

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = tiled_apply_d4_tta(fused, image, TILE, STEP, weight="pyramid", batch_size=DIST_BATCH,
                                 mode="distributed")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    busy, by_name = _device_busy_ms(prof), _device_ms_by_name(prof)
    if busy == 0:
        log("[6] profiled 5000^2 distributed run: device time not measured (the profiler saw no CUDA events)")
        return
    k2_ms = sum(ms for name, ms in by_name.items() if "conv3x3" in name)
    log(f"[6] profiled 5000^2 distributed run: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"(idle {1 - busy / wall_ms:.1%}), K2 {k2_ms:.1f} ms = {k2_ms / busy:.1%} of device time ({smi})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[6]   device {ms:8.2f} ms  {name[:100]}")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _sort_error(got, want, what: str, has_nan: bool) -> float:
    """Raise unless keys and payloads are equal bit for bit; return the largest
    |difference| over both (0 when equal; not taken where NaN keys stand)."""
    if not all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want)):
        raise AssertionError(f"{what} disagrees with sort_reference")
    if has_nan:
        return 0.0
    return max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))


def phase_sorts(dev, smi):
    """K4 and K5 against sort_reference at the Lovasz shapes of config 4."""
    from pytorch_toolbelt_tpu_torch.ops import bitonic_sort_chunked, sort_reference, split_sort

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    kernels = {"radix_sort": bitonic_sort_chunked, "merge_sort": split_sort}
    n = 1 << 23

    def forward_pair(rows, cols):  # -errors keys, (fg | position) payload, as LovaszLoss builds them
        keys = -torch.rand(rows, cols, device=dev, generator=gen)
        fg = torch.rand(rows, cols, device=dev, generator=gen) < 1 / 19
        pos = torch.arange(cols, device=dev, dtype=torch.int32).expand(rows, cols)
        return keys, torch.where(fg, pos | (1 << 30), pos)

    def backward_pair(rows, cols):  # permutation keys, sorted-domain weights
        keys = torch.argsort(torch.rand(rows, cols, device=dev, generator=gen), dim=1).to(torch.int32)
        return keys, torch.randn(rows, cols, device=dev, generator=gen)

    def odd_pair(rows, cols):  # ties, -0.0 / +0.0, +-inf, NaN
        keys = torch.randint(-6, 6, (rows, cols), device=dev, generator=gen).float() * 0.5
        pick = torch.rand(rows, cols, device=dev, generator=gen)
        for lo, hi, value in ((0.0, 0.1, -0.0), (0.1, 0.2, 0.0), (0.2, 0.25, float("nan")),
                              (0.25, 0.28, float("inf")), (0.28, 0.31, float("-inf"))):
            keys = torch.where((pick >= lo) & (pick < hi), torch.tensor(value, device=dev), keys)
        return keys, torch.arange(rows * cols, device=dev, dtype=torch.int32).reshape(rows, cols)

    cases = (("fwd", 19, n, forward_pair), ("bwd", 19, n, backward_pair),
             ("per_image", 152, 1 << 20, forward_pair), ("odd", 7, 1000003, odd_pair))
    times, errors = {}, {name: 0.0 for name in kernels}
    for case, rows, cols, make in cases:
        keys, payload = make(rows, cols)
        want = sort_reference(keys, payload)
        for name, sort in kernels.items():
            got = sort(keys, payload)
            torch.cuda.synchronize()
            errors[name] = max(errors[name], _sort_error(got, want, f"{name} {case} [{rows}, {cols}]",
                                                             has_nan=case == "odd"))
            del got
            times[name, case] = cuda_ms(lambda: sort(keys, payload), reps=5)
        times["reference", case] = cuda_ms(lambda: sort_reference(keys, payload), reps=5)
        times["library", case] = cuda_ms(lambda: torch.sort(keys, dim=1, stable=True), reps=5)
        line = ", ".join(f"{who} {times[who, case]:.3f} ms ({rows * cols / times[who, case] / 1e6:.2f} Gpairs/s)"
                         for who in (*kernels, "reference", "library"))
        log(f"[7] sort {case} [{rows}, {cols}] {keys.dtype}/{payload.dtype}: keys and payloads equal "
            f"sort_reference bit for bit; {line} (library = one torch.sort(stable=True)); bound "
            f"{bound_ms(16 * rows * cols)[0]:.3f} ms (bytes) ({smi})")
        if case == "bwd":
            index = keys.long()  # the inverse permutation as a scatter, for information only
            scattered = torch.empty_like(payload).scatter_(1, index, payload)
            if not torch.equal(scattered, want[1]):
                raise AssertionError("scatter_ inverse permutation disagrees with the sort")
            times["scatter", case] = cuda_ms(lambda: torch.empty_like(payload).scatter_(1, index, payload), reps=5)
            log(f"[7] inverse permutation [{rows}, {cols}] as scatter_ (int64 index ready): "
                f"{times['scatter', case]:.3f} ms vs radix_sort {times['radix_sort', case]:.3f} ms")
            del index, scattered
        del keys, payload, want
    return times, errors


def lovasz_grad(gt_sorted):
    """Berman et al. 2018, Algorithm 1: gradient of the Lovasz extension."""
    gts = gt_sorted.sum()
    intersection = gts - gt_sorted.cumsum(0)
    union = gts + (1.0 - gt_sorted).cumsum(0)
    jaccard = 1.0 - intersection / union
    jaccard[1:] = jaccard[1:] - jaccard[:-1]
    return jaccard


def plain_lovasz_softmax(probas, labels):
    """classes='present', one problem over the whole batch, torch.sort(descending)."""
    num_classes = probas.shape[1]
    probas = probas.movedim(1, -1).reshape(-1, num_classes)
    labels = labels.reshape(-1)
    losses = []
    for c in range(num_classes):
        fg = (labels == c).float()
        if fg.sum() == 0:
            continue
        errors_sorted, perm = torch.sort((fg - probas[:, c]).abs(), descending=True, stable=True)
        losses.append(torch.dot(errors_sorted, lovasz_grad(fg[perm])))
    return torch.stack(losses).mean()


def plain_lovasz_hinge(logits, labels):
    logits, labels = logits.reshape(-1), labels.reshape(-1).float()
    errors_sorted, perm = torch.sort(1.0 - logits * (2.0 * labels - 1.0), descending=True, stable=True)
    return torch.dot(F.relu(errors_sorted), lovasz_grad(labels[perm]))


def plain_binary_focal(x, t, gamma=2.0):
    p = torch.sigmoid(x)
    pt = p * t + (1 - p) * (1 - t)
    return ((1 - pt) ** gamma * F.binary_cross_entropy_with_logits(x, t, reduction="none")).mean()


def plain_ce_focal(x, t, gamma=2.0):
    one_hot = F.one_hot(t, x.shape[1]).movedim(-1, 1).float()
    p = torch.softmax(x, 1)
    pt = (1 - one_hot) * p + one_hot * (1 - p)
    return (pt**gamma * F.binary_cross_entropy_with_logits(x, one_hot, reduction="none")).sum(1).mean()


def plain_soft_iou(x, t, kind, eps=1e-7):
    one_hot = F.one_hot(t, x.shape[1]).movedim(-1, 1).float()
    p = torch.softmax(x, 1)
    dims = (0, 2, 3)
    intersection, cardinality = (p * one_hot).sum(dims), (p + one_hot).sum(dims)
    if kind == "dice":
        score = 2 * intersection / cardinality.clamp_min(eps)
    else:
        score = intersection / (cardinality - intersection).clamp_min(eps)
    return ((1 - score) * (one_hot.sum(dims) > 0)).mean()


def _value_and_grad(fn, x0, target):
    x = x0.detach().clone().requires_grad_(True)
    value = fn(x, target)
    value.backward()
    return value.detach(), x.grad


def _chained_steps(fn, x0, target):
    """ms per step of LOSS_STEPS chained (value, gradient, x += 1e-4 * grad)
    steps after one warm-up, and the peak memory allocated meanwhile."""
    def step(x):
        x = x.detach().requires_grad_(True)
        value = fn(x, target)
        value.backward()
        return (x + 1e-4 * x.grad).detach()

    x = step(x0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(LOSS_STEPS):
        x = step(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / LOSS_STEPS * 1e3, torch.cuda.max_memory_allocated() / 2**30


def phase_losses(dev, smi, sort_times):
    """The config-4 loss suite at full size through the port's public classes."""
    from pytorch_toolbelt_tpu_torch import losses as L
    from pytorch_toolbelt_tpu_torch.losses import lovasz
    from pytorch_toolbelt_tpu_torch.ops import bitonic_sort_chunked, split_sort

    b, c, h, w = LOSS_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    logits = torch.randn(b, c, h, w, device=dev, generator=gen)
    t_int = torch.randint(0, c, (b, h, w), device=dev, generator=gen)
    t_bin = (torch.rand(b, c, h, w, device=dev, generator=gen) > 0.5).float()
    logits_1 = torch.randn(b, 1, h, w, device=dev, generator=gen)
    t_bin_1 = t_bin[:, :1].contiguous()
    n_logits, n_int = logits.numel() * 4, t_int.numel() * 4
    copy_ms = cuda_ms(lambda: torch.empty_like(logits).copy_(logits), reps=10)
    copy_gbps = 2 * n_logits / copy_ms / 1e6
    log(f"[8] logits {list(LOSS_SHAPE)} fp32: copy {copy_ms:.3f} ms = {copy_gbps:.0f} GB/s read+write ({smi})")

    softmax = lambda x: torch.softmax(x, 1)  # noqa: E731
    focal, ce_focal = L.BinaryFocalLoss(), L.CrossEntropyFocalLoss()
    dice, jaccard = L.DiceLoss(mode="multiclass"), L.JaccardLoss(mode="multiclass")
    lovasz_loss, binary_lovasz = L.LovaszLoss(), L.BinaryLovaszLoss()
    # (name, port loss, plain loss, input, target, byte floor, split sort)
    cases = (
        ("BinaryFocalLoss", focal, plain_binary_focal, logits, t_bin, 5 * n_logits, False),
        ("CrossEntropyFocalLoss", ce_focal, plain_ce_focal, logits, t_int, None, False),
        ("DiceLoss(multiclass)", dice, lambda x, t: plain_soft_iou(x, t, "dice"), logits, t_int,
         3 * n_logits + 2 * n_int, False),
        ("JaccardLoss(multiclass)", jaccard, lambda x, t: plain_soft_iou(x, t, "jaccard"), logits, t_int, None,
         False),
        ("LovaszLoss(softmax) K4", lambda x, t: lovasz_loss(softmax(x), t),
         lambda x, t: plain_lovasz_softmax(softmax(x), t), logits, t_int, None, False),
        ("LovaszLoss(softmax) K5", lambda x, t: lovasz_loss(softmax(x), t),
         lambda x, t: plain_lovasz_softmax(softmax(x), t), logits, t_int, None, True),
        ("BinaryLovaszLoss", binary_lovasz, plain_lovasz_hinge, logits_1, t_bin_1, None, False),
    )
    torch.cuda.synchronize()
    bitonic_sort_chunked.launches = 0
    split_sort.launches = 0
    for name, port, plain, x0, target, floor, split in cases:
        lovasz.SPLIT_SORT = split
        try:
            k4, k5 = bitonic_sort_chunked.launches, split_sort.launches
            value, grad = _value_and_grad(port, x0, target)
            sorts = bitonic_sort_chunked.launches - k4 + split_sort.launches - k5
            want_value, want_grad = _value_and_grad(plain, x0, target)
            value_err = float((value - want_value).abs() / want_value.abs())
            grad_err = float((grad - want_grad).abs().max())
            grad_tol = LOSS_GRAD_TOL * float(want_grad.abs().max())
            ok = bool(torch.isfinite(grad).all()) and value_err <= LOSS_VALUE_RTOL and grad_err <= grad_tol
            ok = ok and sorts == (2 if "Lovasz" in name else 0)
            log(f"[8] {name}: value {float(value):.7g} vs plain {float(want_value):.7g}, rel err {value_err:.2e} "
                f"<= {LOSS_VALUE_RTOL:.0e}; grad max|err| {grad_err:.3e} <= {grad_tol:.3e}; sort launches {sorts} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with the plain path")
            del grad, want_grad
            ms, peak = _chained_steps(port, x0, target)
        finally:
            lovasz.SPLIT_SORT = False
        extra = ""
        if floor is not None:
            gbps = floor / ms / 1e6
            extra = f", {gbps:.0f} GB/s of its byte floor = {gbps / copy_gbps:.1%} of the copy rate"
        if "Lovasz" in name and x0 is logits:
            sort = "merge_sort" if split else "radix_sort"
            sort_ms = sort_times[sort, "fwd"] + sort_times[sort, "bwd"]
            extra = (f", its two {sort} launches {sort_ms:.2f} ms = {sort_ms / ms:.1%} of the step "
                     f"(scatter_ inverse permutation {sort_times['scatter', 'bwd']:.2f} ms)")
        log(f"[8] {name}: {ms:.3f} ms per fwd+bwd step ({LOSS_STEPS} chained), peak {peak:.2f} GiB{extra}")
    launches = {"radix_sort": bitonic_sort_chunked.launches, "merge_sort": split_sort.launches}
    log(f"[8] loss suite launches: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a sort kernel of the loss path was never launched: {launches}")
    return launches


def _covered_pixels(coords, th: int, tw: int) -> int:
    """Canvas pixels that at least one tile of the batch covers."""
    (y0, x0), (y1, x1) = coords.min(0), coords.max(0) + (th, tw)
    mask = np.zeros((y1 - y0, x1 - x0), dtype=bool)
    for y, x in coords - (y0, x0):
        mask[y : y + th, x : x + tw] = True
    return int(mask.sum())


def _scatter_cases(dev):
    """(name, canvas [C, H, W], norm, tiles, coords, weight): the streaming
    batch in fp32 and bf16, a misaligned geometry and a batch of one tile."""
    from pytorch_toolbelt_tpu_torch.inference import ImageSlicer

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rng = np.random.RandomState(SEED + 9)
    slicer = ImageSlicer((STREAM_SIZE, STREAM_SIZE), TILE, STEP, weight="pyramid")
    h, w = slicer.target_shape
    canvas = torch.rand(CLASSES, h, w, device=dev, generator=gen)
    norm = torch.rand(1, h, w, device=dev, generator=gen)
    weight = torch.as_tensor(slicer.weight.astype(np.float32), device=dev)
    stream = slicer.crops[:STREAM_BATCH, [1, 0]]
    tiles = torch.randn(STREAM_BATCH, CLASSES, TILE, TILE, device=dev, generator=gen)
    odd_h, odd_w, odd_th, odd_tw = 1001, 999, 301, 257
    odd = np.stack([rng.randint(0, odd_h - odd_th + 1, 13) | 1, rng.randint(0, odd_w - odd_tw + 1, 13) | 1], 1)
    yield "stream fp32", canvas, norm, tiles, stream, weight
    yield "stream bf16", canvas, norm, tiles.to(torch.bfloat16), stream, weight
    yield ("misaligned bf16", torch.rand(CLASSES, odd_h, odd_w, device=dev, generator=gen),
           torch.rand(1, odd_h, odd_w, device=dev, generator=gen),
           torch.randn(13, CLASSES, odd_th, odd_tw, device=dev, generator=gen).to(torch.bfloat16), odd,
           torch.rand(odd_th, odd_tw, device=dev, generator=gen) + 0.1)
    middle = len(slicer.crops) // 2
    yield "one tile bf16", canvas, norm, tiles[:1].to(torch.bfloat16), slicer.crops[middle : middle + 1, [1, 0]], weight


def phase_scatter(dev, smi):
    """K3 against accumulate_tiles_reference, bit for bit, at the streaming
    shapes; its time beside the reference, index_add_ and its bound."""
    from pytorch_toolbelt_tpu_torch.ops import accumulate_tiles, accumulate_tiles_reference

    result = None
    for name, canvas, norm, tiles, coords, weight in _scatter_cases(dev):
        got_c, got_n = accumulate_tiles(canvas.clone(), norm.clone(), tiles, coords, weight)
        want_c, want_n = accumulate_tiles_reference(canvas.clone(), norm.clone(), tiles, coords, weight)
        torch.cuda.synchronize()
        equal = torch.equal(got_c, want_c) and torch.equal(got_n, want_n)
        err = max(float((got_c - want_c).abs().max()), float((got_n - want_n).abs().max()))
        log(f"[9] scatter_merge {name}: tiles {list(tiles.shape)} at {len(coords)} coordinates into "
            f"{list(canvas.shape)}: {'equals' if equal else 'DIFFERS FROM'} accumulate_tiles_reference bit for bit")
        if not equal:
            raise AssertionError(f"scatter_merge {name} disagrees with accumulate_tiles_reference (max|err| {err:.3e})")
        del got_c, got_n, want_c, want_n
        if name != "stream bf16":
            continue
        # the streaming path's shape: bf16 model outputs into the fp32 canvas
        b, c, th, tw = tiles.shape
        covered = _covered_pixels(coords, th, tw)
        nbytes = tiles.numel() * 2 + covered * (c + 1) * 4 * 2 + weight.numel() * 4
        bound, bound_by = bound_ms(nbytes)
        copy_ms = cuda_ms(lambda: torch.empty_like(canvas).copy_(canvas), reps=5)
        copy_rate = 2 * canvas.numel() * 4 / copy_ms / 1e6  # bytes per ms -> GB/s
        ms = cuda_ms(lambda: accumulate_tiles(canvas, norm, tiles, coords, weight), reps=10)
        plain_ms = cuda_ms(lambda: accumulate_tiles_reference(canvas, norm, tiles, coords, weight), reps=3)
        ct = torch.as_tensor(coords, device=dev)
        ys = ct[:, 0, None, None] + torch.arange(th, device=dev)[None, :, None]
        xs = ct[:, 1, None, None] + torch.arange(tw, device=dev)[None, None, :]
        pix = ys * canvas.shape[2] + xs  # [B, th, tw]
        idx = (pix[:, None] + torch.arange(c, device=dev)[None, :, None, None] * canvas[0].numel()).flatten()
        nidx, wflat = pix.flatten(), weight.expand(b, th, tw).flatten()

        def index_add():
            canvas.view(-1).index_add_(0, idx, (tiles.float() * weight).flatten())
            norm.view(-1).index_add_(0, nidx, wflat)

        library_ms = cuda_ms(index_add, reps=5)
        log(f"[9] scatter_merge {name}: kernel {ms:.3f} ms = {nbytes / ms / 1e6:.0f} GB/s of its {nbytes / 1e9:.3f} GB "
            f"({covered} covered pixels); accumulate_tiles_reference {plain_ms:.3f} ms; index_add_ pair (int64 "
            f"index ready, atomics) {library_ms:.3f} ms; bound {bound:.3f} ms at {HBM_RATE / 1e12:.2f} TB/s, "
            f"{nbytes / copy_rate / 1e6:.3f} ms at the measured copy rate {copy_rate:.0f} GB/s ({smi})")
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                  "library_ms": library_ms}
        del idx, nidx, wflat, pix
    return result


def config3_model(dev):
    """SEResNeXt50-FPN(128) with 19 classes (BASELINE config 3), seeded
    weights; returns the fp32 and the bf16 model, both channels_last.

    The last BatchNorm of every residual branch and of every projection
    shortcut gets its scale cut by RESIDUAL_BN_SCALE, so that activations
    stay of order one through the 16 bottlenecks, as in a trained network.
    With every scale near 1 each block roughly doubles the residual stream:
    the logits reach ~2e3 and bf16 rounding grows to ~20% of max|logit|
    (measured on the CPU at 128^2; ~1% with the cut)."""
    import copy

    from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, se_resnext50_encoder

    encoder = se_resnext50_encoder()
    decoder = FPNDecoder(encoder.get_output_spec(), out_channels=128)
    model = seed_weights(EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(),
                                                                            num_classes=CLASSES)), SEED + 10)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bn3.weight", "downsample.1.weight")):
                p.mul_(RESIDUAL_BN_SCALE)
    model = model.eval().to(dev, memory_format=torch.channels_last)
    return model, copy.deepcopy(model).to(torch.bfloat16)


def image_forward(model, dtype):
    """[B, H, W, 3] uint8 tiles (or [B, 3, H, W] float images) -> [B, 19, H, W] logits in ``dtype``."""
    def forward(x):
        if x.dtype == torch.uint8:
            x = x.permute(0, 3, 1, 2).to(dtype) / 255
        return model(x.to(dtype).contiguous(memory_format=torch.channels_last))

    return forward


@torch.no_grad()
def stream_tiled(forward, image, slicer, dev, use_pallas=True, keep=None):
    """The streaming loop of tiled inference: ImageSlicer cuts the tiles on
    the host; each batch goes host -> device (pinned, without a sync),
    through the model, and into TileMerger.integrate_batch; then merge() and
    the crop.  Returns the merger and the [19, H, W] result."""
    from pytorch_toolbelt_tpu_torch.inference import TileMerger

    merger = TileMerger(slicer.target_shape, channels=CLASSES, weight=slicer.weight, device=dev,
                        use_pallas=use_pallas)
    tiles = slicer.split(image)  # views of the padded image
    for start in range(0, len(tiles), STREAM_BATCH):
        host = torch.from_numpy(np.stack(tiles[start : start + STREAM_BATCH])).pin_memory()
        logits = forward(host.to(dev, non_blocking=True))
        if keep is not None:
            keep.append(logits)
        merger.integrate_batch(logits, slicer.crops[start : start + STREAM_BATCH])
    return merger, slicer.crop_to_original_size(merger.merge())


def _device_busy_ms(prof) -> float:
    """Union of the device intervals (kernels, copies) a profile saw, in ms."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _device_ms_by_name(prof) -> dict:
    """Device time in ms of each kernel or copy name a profile saw."""
    by_name = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def phase_streaming(dev, smi, model, model_bf16):
    """Streaming tiled inference of a 5000^2 image through K3, and the
    2048^2 bf16 run against the fp32 one."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_toolbelt_tpu_torch.inference import ImageSlicer, TileMerger
    from pytorch_toolbelt_tpu_torch.ops import accumulate_tiles

    rng = np.random.default_rng(SEED + 11)
    forward = image_forward(model_bf16, torch.bfloat16)

    check = rng.integers(0, 256, (STREAM_CHECK_SIZE, STREAM_CHECK_SIZE, 3), dtype=np.uint8)
    check_slicer = ImageSlicer(check.shape, TILE, STEP, weight="pyramid")
    _, got = stream_tiled(forward, check, check_slicer, dev)
    _, ref = stream_tiled(image_forward(model, torch.float32), check, check_slicer, dev)
    torch.cuda.synchronize()
    err, tol = float((got - ref).abs().max()), PATH_TOL * float(ref.abs().max())
    ok = got.shape == (CLASSES, STREAM_CHECK_SIZE, STREAM_CHECK_SIZE) and bool(torch.isfinite(got).all()) and err <= tol
    log(f"[10] streaming {STREAM_CHECK_SIZE}^2, {len(check_slicer.crops)} tiles: bf16 model vs fp32 model (TF32 off) "
        f"max|err| {err:.3e} <= {tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 streaming path disagrees with the fp32 one")
    del got, ref

    image = rng.integers(0, 256, (STREAM_SIZE, STREAM_SIZE, 3), dtype=np.uint8)
    slicer = ImageSlicer(image.shape, TILE, STEP, weight="pyramid")
    n_batches = -(-len(slicer.crops) // STREAM_BATCH)
    kept = []
    torch.cuda.synchronize()
    accumulate_tiles.launches = 0
    merger, out = stream_tiled(forward, image, slicer, dev, keep=kept)
    torch.cuda.synchronize()
    launches = accumulate_tiles.launches
    log(f"[10] streaming {STREAM_SIZE}^2 main path launches: {{'scatter_merge': {launches}}} for "
        f"{len(slicer.crops)} tiles in {n_batches} batches")
    if launches != n_batches:
        raise AssertionError(f"scatter_merge launched {launches} times for {n_batches} batches")
    if out.shape != (CLASSES, STREAM_SIZE, STREAM_SIZE) or not bool(torch.isfinite(out).all()):
        raise AssertionError("the streaming path gave a wrong shape or non-finite values")

    plain = TileMerger(slicer.target_shape, channels=CLASSES, weight=slicer.weight, device=dev, use_pallas=False)
    for i, logits in enumerate(kept):
        plain.integrate_batch(logits, slicer.crops[i * STREAM_BATCH : (i + 1) * STREAM_BATCH])
    equal = torch.equal(merger.image, plain.image) and torch.equal(merger.norm_mask, plain.norm_mask)
    log(f"[10] streaming {STREAM_SIZE}^2: TileMerger(use_pallas=True) {'equals' if equal else 'DIFFERS FROM'} "
        f"TileMerger(use_pallas=False) on the same bf16 model outputs, bit for bit")
    if not equal:
        raise AssertionError("TileMerger(use_pallas=True) disagrees with the slice-add merger")
    del kept, merger, plain, out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, out = stream_tiled(forward, image, slicer, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    del out

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, out = stream_tiled(forward, image, slicer, dev)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    busy, by_name = _device_busy_ms(prof), _device_ms_by_name(prof)
    k3_ms = sum(ms for name, ms in by_name.items() if "scatter_merge" in name)
    profile_line = "device time not measured (the profiler saw no CUDA events)"
    if busy > 0:
        profile_line = (f"device busy {busy:.1f} ms of {prof_wall_ms:.1f} ms (idle {1 - busy / prof_wall_ms:.1%}), "
                        f"scatter_merge {k3_ms:.2f} ms = {k3_ms / busy:.2%} of device time")
    # the host's share of the loop: padding and cutting the tiles, stacking and pinning each batch
    t0 = time.perf_counter()
    tiles = slicer.split(image)
    split_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for start in range(0, len(tiles), STREAM_BATCH):
        torch.from_numpy(np.stack(tiles[start : start + STREAM_BATCH])).pin_memory()
    stack_ms = (time.perf_counter() - t0) * 1e3 / n_batches
    mp = STREAM_SIZE * STREAM_SIZE / 1e6
    log(f"[10] streaming {STREAM_SIZE}^2 SEResNeXt50-FPN(128) bf16, batch {STREAM_BATCH}, host slicing and copies "
        f"included: {wall:.3f} s, {mp / wall:.2f} MP/s, peak {peak:.2f} GiB allocated; under torch.profiler: "
        f"{profile_line}; host alone: split {split_ms:.1f} ms, stack + pin {stack_ms:.1f} ms per batch ({smi})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[10]   device {ms:8.2f} ms  {name[:100]}")
    return launches


def phase_config3(dev, smi, model, model_bf16):
    """BASELINE config 3: d4 + multiscale TTA at 1024^2, bf16 against fp32."""
    from pytorch_toolbelt_tpu_torch.inference import MultiscaleTTA, d4_image2mask

    def tta(m, dtype):
        forward = image_forward(m, dtype)
        return MultiscaleTTA(lambda xi: d4_image2mask(lambda v: forward(v).float(), xi), size_offsets=MS_OFFSETS)

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    x = torch.rand(1, 3, MS_SIZE, MS_SIZE, device=dev, generator=gen)
    run = tta(model_bf16, torch.bfloat16)
    with torch.no_grad():
        got = run(x)
        ref = tta(model, torch.float32)(x)
        torch.cuda.synchronize()
        err, tol = float((got - ref).abs().max()), PATH_TOL * float(ref.abs().max())
        ok = (got.shape == (1, CLASSES, MS_SIZE, MS_SIZE) and got.dtype == torch.float32
              and bool(torch.isfinite(got).all()) and err <= tol)
        log(f"[11] config 3 (d4 + multiscale {MS_OFFSETS} TTA, SEResNeXt50-FPN(128), {CLASSES} classes, "
            f"{MS_SIZE}^2): bf16 vs fp32 (TF32 off) max|err| {err:.3e} <= {tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("config 3 in bf16 disagrees with fp32")
        del got, ref
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            out = run(x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[11] config 3 bf16: {ms:.1f} ms per call ({reps} calls), {MS_SIZE * MS_SIZE / 1e3 / ms:.2f} MP/s, "
        f"peak {peak:.2f} GiB allocated ({smi})")
    del out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA GPU", file=sys.stderr)
        return 1
    import pytorch_toolbelt_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from pytorch_toolbelt_tpu_torch.zoo import fuse_unet_inference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = phase_build()
    conv = phase_conv(dev, smi)
    merge = phase_merge(dev)
    model = seeded_unet(SEED, dev)
    fused = fuse_unet_inference(model)
    phase_fused(model, fused, dev)
    launches = phase_tiled(model, fused, dev)
    if time.perf_counter() - t_start < TIME_BUDGET_S / 2:
        phase_full_size(fused, dev, smi)
    else:
        log("[6] skipped: over half the time budget spent")
    sort_times, sort_errors = phase_sorts(dev, smi)
    sort_launches = phase_losses(dev, smi, sort_times)
    scatter = phase_scatter(dev, smi)
    model3, model3_bf16 = config3_model(dev)
    scatter_launches = phase_streaming(dev, smi, model3, model3_bf16)
    phase_config3(dev, smi, model3, model3_bf16)

    kernels = [
        {"name": "conv3x3", "route": "cuda", "source": "pytorch_toolbelt_tpu_torch/csrc/conv3x3_wgmma.cuh",
         "replaces": "pytorch_toolbelt_tpu/ops/conv_kernels.py:153", "launches": launches["conv3x3"], **conv,
         "launches_by_route": launches["conv3x3_by_route"]},
        {"name": "grid_merge", "route": "cuda", "source": "pytorch_toolbelt_tpu_torch/csrc/tile_merge.cu",
         "replaces": "pytorch_toolbelt_tpu/ops/tile_merge.py:358", "launches": launches["grid_merge"], **merge},
        {"name": "scatter_merge", "route": "cuda", "source": "pytorch_toolbelt_tpu_torch/csrc/scatter_merge.cu",
         "replaces": "pytorch_toolbelt_tpu/ops/tile_merge.py:153", "launches": scatter_launches, **scatter},
    ]
    sort_bound = bound_ms(16 * 19 * (1 << 23))  # the fwd pair [19, 2^23]: keys and payloads read and written once
    for name, source, line in (("radix_sort", "radix_sort.cu", 219), ("merge_sort", "merge_sort.cu", 298)):
        kernels.append({"name": name, "route": "cuda", "source": f"pytorch_toolbelt_tpu_torch/csrc/{source}",
                        "replaces": f"pytorch_toolbelt_tpu/ops/sort.py:{line}", "launches": sort_launches[name],
                        "max_abs_err": sort_errors[name], "ms": sort_times[name, "fwd"],
                        "plain_ms": sort_times["reference", "fwd"], "bound_ms": sort_bound[0],
                        "bound_by": sort_bound[1], "library_ms": sort_times["library", "fwd"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
