#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytorch_toolbelt_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pytorch_toolbelt_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version at the shapes of the
main path, then drives the main paths through the entry points a user calls -- tiled UNet-32
inference with d4 test-time augmentation in both modes, and the BASELINE
config-4 loss suite -- and holds each against an independent plain path.
Weights and data are random, made from a seed.

Phases, each printed on its own line:
  1. the card's name and power limit; the kernel build and its time;
  2. K2 (conv3x3) against ``conv3x3_reference`` at every conv shape of
     UNet-32 on 512^2 tiles; kernel and cuDNN times at the main path's
     batch (64 tiles x 2 views);
  3. K1 (grid merge) against ``grid_merge_reference`` at the 5000^2
     geometry (361 tiles of 512^2, step 256, K = 1);
  4. ``fuse_unet_inference`` against the plain module in ``eval()``;
  5. ``tiled_apply_d4_tta`` on a 2048^2 image in both modes against the
     plain path; both kernels' launch counters must rise;
  6. one 5000^2 run in each mode at the bench batches, for its wall time
     and peak memory (information only);
  7. K4 (radix sort) and K5 (merge sort) against ``sort_reference``, keys
     and payloads bit for bit, at the Lovasz shapes of config 4 ([19, 2^23]
     forward and backward pairs, [152, 2^20] per image) and an odd shape
     with planted ties, +-0.0 and NaN; ms and Gpairs/s of each;
  8. the config-4 loss suite at full size (logits [8, 19, 1024, 1024]):
     focal, dice, jaccard, Lovasz-Softmax on K4 and on K5, binary Lovasz,
     each value and gradient against a plain fp32 autograd path written
     here; both sort counters must rise; ms per chained fwd+bwd step, peak
     memory, GB/s against the card's own copy bandwidth, the sorts' share.

Any mismatch or error exits non-zero.  The line before the last is a JSON
object describing the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import os
import subprocess
import sys
import time

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


def log(msg: str) -> None:
    print(msg, flush=True)


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


def seeded_unet(seed: int, device):
    """UNet-32 with weights and non-trivial BN statistics from a seeded generator."""
    from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel

    gen = torch.Generator().manual_seed(seed)
    model = UNetSegmentationModel(num_classes=1, encoder_channels=32, num_layers=4, growth_factor=2)
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
    return model.to(device).eval()


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
        for line in log_file.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[1]   ptxas: {line.strip()}")
    return smi


def phase_conv(dev):
    from pytorch_toolbelt_tpu_torch.ops import conv3x3, conv3x3_reference, pack_conv3x3_weights
    from pytorch_toolbelt_tpu_torch.ops.conv_kernels import _unpack

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    max_err, total_ms, total_cudnn_ms, total_ref_ms, total_gflop = 0.0, 0.0, 0.0, 0.0, 0.0
    timing_batch = 2 * DIST_BATCH
    for c_in, c_out, size, relu in unet_conv_shapes():
        w = torch.randn(c_out, c_in, 3, 3, device=dev, generator=gen) * (2.0 / (9 * c_in)) ** 0.5
        packed = pack_conv3x3_weights(w)
        w_bf = _unpack(packed, c_in, c_out).float()  # the bf16-rounded weights the kernel uses
        scale = (1.0 + 0.1 * torch.randn(c_out, device=dev, generator=gen)) if relu else torch.ones(c_out, device=dev)
        bias = 0.1 * torch.randn(c_out, device=dev, generator=gen)

        x = torch.randn(2, c_in, size, size, device=dev, generator=gen).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        got = conv3x3(x, packed, scale, bias, relu=relu).float()
        ref = conv3x3_reference(x, w_bf, scale, bias, relu)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = CONV_TOL * float(ref.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= tol
        max_err = max(max_err, err)

        xb = torch.randn(timing_batch, c_in, size, size, device=dev, generator=gen).to(torch.bfloat16)
        xb = xb.contiguous(memory_format=torch.channels_last)
        w_cudnn = w_bf.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

        def cudnn():
            y = F.conv2d(xb, w_cudnn, padding=1).float() * scale[None, :, None, None] + bias[None, :, None, None]
            return (torch.relu(y) if relu else y).to(torch.bfloat16)

        ms = cuda_ms(lambda: conv3x3(xb, packed, scale, bias, relu=relu), reps=3)
        cudnn_ms = cuda_ms(cudnn, reps=3)
        ref_ms = cuda_ms(lambda: conv3x3_reference(xb, w_bf, scale, bias, relu), reps=1)
        gflop = 2.0 * timing_batch * size * size * 9 * c_in * c_out / 1e9
        total_ms, total_cudnn_ms, total_ref_ms, total_gflop = (
            total_ms + ms, total_cudnn_ms + cudnn_ms, total_ref_ms + ref_ms, total_gflop + gflop)
        log(f"[2] conv3x3 {c_in:>3}->{c_out:<3} @{size:>3}^2 relu={int(relu)}: max|err| {err:.3e} <= {tol:.3e} "
            f"{'ok' if ok else 'FAIL'}; batch {timing_batch}: kernel {ms:.3f} ms ({gflop / ms:.1f} TFLOP/s), "
            f"cuDNN bf16 {cudnn_ms:.3f} ms, fp32 reference {ref_ms:.3f} ms")
        if not ok:
            raise AssertionError(f"conv3x3 {c_in}->{c_out} @{size} disagrees with conv3x3_reference")
        del xb, w_cudnn
    log(f"[2] conv3x3 all shapes, batch {timing_batch}: kernel {total_ms:.2f} ms ({total_gflop / total_ms:.1f} "
        f"TFLOP/s), cuDNN bf16 {total_cudnn_ms:.2f} ms, fp32 reference {total_ref_ms:.2f} ms")
    return {"max_abs_err": max_err, "ms": total_ms, "plain_ms": total_cudnn_ms}


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
    gbytes = (tiles.numel() * 4 + 5000 * 5000 * 4) / 1e9
    log(f"[3] grid_merge {ty * tx} tiles -> 5000^2: max|err| {err:.3e} <= {MERGE_TOL:.0e} {'ok' if ok else 'FAIL'}; "
        f"kernel {ms:.3f} ms ({gbytes / ms * 1e3:.0f} GB/s of compulsory traffic), reference {ref_ms:.3f} ms")
    if not ok:
        raise AssertionError("grid_merge disagrees with grid_merge_reference")
    return {"max_abs_err": err, "ms": ms, "plain_ms": ref_ms}


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
    conv3x3.launches = 0
    grid_merge.launches = 0
    outs, walls = {}, {}
    for mode, batch in runs:
        t0 = time.perf_counter()
        outs[mode] = tiled_apply_d4_tta(fused, image, TILE, STEP, weight="pyramid", batch_size=batch, mode=mode)
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t0
    launches = {"conv3x3": conv3x3.launches, "grid_merge": grid_merge.launches}
    log(f"[5] main path launches: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")

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


def phase_full_size(fused, dev, smi):
    from pytorch_toolbelt_tpu_torch.inference import tiled_apply_d4_tta

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    image = torch.rand(3, 5000, 5000, device=dev, generator=gen)
    for mode, batch in (("distributed", DIST_BATCH), ("full", FULL_BATCH)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = tiled_apply_d4_tta(fused, image, TILE, STEP, weight="pyramid", batch_size=batch, mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if out.shape != (1, 5000, 5000) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"5000^2 {mode} run gave a wrong shape or non-finite values")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[6] tiled_apply_d4_tta 5000^2 {mode} batch={batch}: {wall:.3f} s, {25.0 / wall:.2f} MP/s, "
            f"peak {peak:.2f} GiB allocated ({smi})")


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
        line = ", ".join(f"{who} {times[who, case]:.3f} ms ({rows * cols / times[who, case] / 1e6:.2f} Gpairs/s)"
                         for who in (*kernels, "reference"))
        log(f"[7] sort {case} [{rows}, {cols}] {keys.dtype}/{payload.dtype}: keys and payloads equal "
            f"sort_reference bit for bit; {line} ({smi})")
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
    conv = phase_conv(dev)
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

    kernels = [
        {"name": "conv3x3", "route": "cuda", "source": "pytorch_toolbelt_tpu_torch/csrc/conv3x3.cu",
         "replaces": "pytorch_toolbelt_tpu/ops/conv_kernels.py:153", "launches": launches["conv3x3"], **conv},
        {"name": "grid_merge", "route": "cuda", "source": "pytorch_toolbelt_tpu_torch/csrc/tile_merge.cu",
         "replaces": "pytorch_toolbelt_tpu/ops/tile_merge.py:358", "launches": launches["grid_merge"], **merge},
    ]
    for name, source, line in (("radix_sort", "radix_sort.cu", 219), ("merge_sort", "merge_sort.cu", 298)):
        kernels.append({"name": name, "route": "cuda", "source": f"pytorch_toolbelt_tpu_torch/csrc/{source}",
                        "replaces": f"pytorch_toolbelt_tpu/ops/sort.py:{line}", "launches": sort_launches[name],
                        "max_abs_err": sort_errors[name], "ms": sort_times[name, "fwd"],
                        "plain_ms": sort_times["reference", "fwd"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
