#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytorch_toolbelt_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pytorch_toolbelt_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version at the shapes of the
main path, then drives the main paths through the entry points a user calls -- tiled UNet-32
inference with d4 test-time augmentation in both modes, the BASELINE
config-4 loss suite, streaming tiled inference of SEResNeXt50-FPN through
``TileMerger(use_pallas=True)``, config 3's d4 + multiscale TTA, a
ResNet34-UNet through tiled d4 inference, pad -> d2 TTA -> unpad on one
image, config 5's strip-sharded tiled inference under an nccl process
group, an ensemble and 3D tiles, config 2 in int8 and the int8
SEResNeXt50-FPN, training config 3's model at config 4's shape,
DeepLabV3+ on a ResNet-50, SegFormer-B2, HRNetV2-W48 and MaxViT-B + FPN
through tiled d4 inference -- and
holds each against an independent plain path.  Weights and
data are random, made from a seed.

Phases, each printed on its own line:
  1. the card's name and power limit; the kernel build and its time; each
     kernel's registers, static shared memory and spills; K4's pass kernel's
     tile, dynamic shared memory and resident blocks per SM; K1's cell-route
     block (threads, ring stages, dynamic shared memory, blocks per SM); the
     HGMMA, UTMALDG and UBLKCP instructions in the wgmma conv kernels' SASS,
     the IGMMA, UTMALDG, UTMASTG and UBLKCP in Q1's wgmma kernels' and the
     UTMALDG, LDG, LDS and STG in K1's cell kernels' (``cuobjdump``); Q2's
     SASS instructions per output byte, first and banded design;
  2. K2 (conv3x3) against ``conv3x3_reference`` at every conv shape of
     UNet-32 on 512^2 tiles, through the route the UNet takes and through
     the WMMA route; at the main path's batch (64 tiles x 2 views), per
     shape: the kernel's ms and TFLOP/s, the WMMA kernel's, cuDNN plus the
     eager epilogue, one ``F.conv2d``, and the shape's bound and what sets it;
  3. K1 (grid merge) against ``grid_merge_reference`` at the 5000^2
     geometry (361 fp32 tiles of 512^2, step 256, K = 1, crop offset
     (60, 60)), bit for bit, in fp32 and bf16 output, normalized and as
     (canvas, norm), on the cell route the geometry takes and on the
     general route (the same tiles 4 bytes off a 16-byte boundary); per
     output type the cell route's ms and spread, GB/s of its compulsory
     bytes (the tile pixels inside the crop, the output, the weight) and
     share of its bound, beside the general route, the plain version and
     ``F.fold``; then the cell route, bit for bit and timed, at a crop
     whose x-offset and width are not multiples of 4;
  4. ``fuse_unet_inference`` against the plain module in ``eval()``;
  5. ``tiled_apply_d4_tta`` on a 2048^2 image in both modes against the
     plain path; both kernels' launch counters must rise, every conv with
     C_in % 8 == 0 must take K2's TMA route, and each call's one K1 launch
     must take K1's cell route;
  6. one 5000^2 run in each mode at the bench batches, for its wall time,
     peak memory and K2's and K1's launches by route (K1: one, on the cell
     route); then the distributed run under
     ``torch.profiler``: device idle share, K2's share and the top kernels
     (information only);
  7. K4 (radix sort) and K5 (merge sort) against ``sort_reference``, keys
     and payloads bit for bit, at the Lovasz shapes of config 4 ([19, 2^23]
     forward and backward pairs, [152, 2^20] per image) and an odd shape
     with planted ties, +-0.0 and NaN; ms and Gpairs/s of each; for K4 per
     case its spread, its launches per sort and each launch's time
     (``torch.profiler``), its design's byte floor and GB/s; the inverse
     permutation as Lovasz's backward scatters it;
  8. the config-4 loss suite at full size (logits [8, 19, 1024, 1024]):
     focal, dice, jaccard, Lovasz-Softmax on K4 and on K5, binary Lovasz,
     each value and gradient against a plain fp32 autograd path written
     here; one sort launch per Lovasz step, and both sort counters must
     rise; ms per chained fwd+bwd step, peak memory, GB/s against the card's
     own copy bandwidth, the sort's and the scatter's shares; the Lovasz K4
     step's device time by kernel (``torch.profiler``);
  9. K3 (scatter merge) against ``accumulate_tiles_reference``, bit for
     bit: the streaming batch (32 overlapping 512^2 tiles of 19 channels
     into the [19, 5120, 5120] canvas) in fp32 and bf16, a misaligned
     geometry and one tile; ms, GB/s and bound of the bf16 batch (the
     kernel with its coordinates on the card, and through the wrapper),
     beside the reference and an ``index_add_`` pair;
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
     call, MP/s, peak memory;
 12. a ResNet34-UNet (``resnet34_encoder()``, residual UNet decoder (32, 64,
     128, 256) with deconvolution upsampling, ResizeHead(19); cuDNN convs,
     eager, bf16, channels_last) through ``tiled_apply_d4_tta``: at 2048^2
     in both modes against the plain path on the fp32 model, every K1 launch
     on the cell route; one 5000^2 distributed run at batch 64 for its wall
     time, MP/s, peak memory and K1's route at K = 19, then under
     ``torch.profiler`` the idle share, the device time by kind (cuDNN
     convs, BatchNorm, upsample, cat, K1, the rest) and the top kernels;
     K1 alone at that call's shape (361 fp32 [19, 512, 512] tiles ->
     5000^2), bit for bit against the plain version, timed beside its
     bound, the plain version and ``F.fold``;
 13. pad -> d2 TTA -> unpad: ``pad_image_tensor`` of one 1000^2 image to
     1024^2, ``GeneralizedTTA(d2_image_augment, d2_image_deaugment)`` over
     the ResNet34-UNet in bf16, ``unpad_image_tensor``; against four flips
     of the fp32 model written here; ms per call;
 14. BASELINE config 5: a 10000^2 image through ``tiled_apply_sharded``
     (UNet-32 fused, bf16 convs, fp32 canvas, 512/256 pyramid tiles, d4
     ``distributed``, batch 32) under a real nccl group of world size 1
     (``DistributedGuard`` with a ``file://`` store): the strips canvas
     against ``tiled_apply_d4_tta`` bit for bit, its wall time, MP/s, peak
     memory, K2's and K1's launches by route (K1: one, on the cell route)
     and, under ``torch.profiler``, the idle share and device time by kind;
     the four strips of a world of 4 computed one after another, each
     strip's wall, peak memory, tiles and K1 route, concatenated against
     world 1 bit for bit; the replicated canvas (K3 per batch +
     ``all_reduce``) against the strips within 1e-5 * max, its K3 launches,
     wall and peak memory; a pixelwise 19-channel head's peak memory at
     world 1 against one strip of four, a 100x100 window of each against
     the head's direct output; K1 alone at the 10000^2 shape (1521 fp32
     tiles), bit for bit and timed beside its bound, the plain version and
     ``F.fold``;
 15. the rest of ``inference/``: ``Ensembler`` of two UNet-32s as the model
     of ``tiled_apply_d4_tta`` at 2048^2 against the mean of the two fp32
     plain paths; ``tiled_apply_3d`` of a Conv3d net over a [1, 128, 512,
     512] volume at 64/32 against a plain tile-by-tile path, and of a
     pointwise Conv3d against its direct output; ms per call;
 16. int8 inference (slice E): ``quantize_unet_inference`` of UNet-32
     calibrated on the first 4 tiles of phase 6's 5000^2 image, bit-equal on
     those tiles to the same network on Q1's and Q2's plain versions, and its
     ``int8_forward_rel_rms`` against the bf16 fused forward (bench.py's
     metric); Q1 (qconv2d) at every conv call of that network on 16 tiles
     and Q2 at every decoder input (q_upsample_cat, and q_upsample alone on
     the same x), with the calls' own data, bit for bit against
     ``qconv2d_reference`` / ``q_upsample_cat_reference``, each timed beside
     its bound (bytes over 3.35 TB/s or int8 operations over 1979 TOP/s),
     its plain version, ``torch._int_mm`` on the im2col and the bf16 K2 at
     the shape (Q2: q_upsample + ``torch.cat`` of the same tensors), with its
     route (every 3x3 stride-1 pad-1 groups-1 call on a wgmma route, every
     Q2 call on the banded route, else the phase fails); config 2 in int8
     (5000^2, distributed, batch 64, after a warm-up): wall, MP/s, peak
     memory, launches (by route: the checked run's wgmma calls, no other
     route), the output
     against the bf16 path's, then bf16 and int8 timed in turns and both
     profiled by kind; the int8 SEResNeXt50-FPN(128) with 19 classes
     (``quantize_encoder_decoder_inference``) at 1024^2: Q1, Q2 and Q3 at
     each distinct call bit for bit and timed, Q3's launches a forward (20,
     16 of them gated, none on the scalar route), ms per forward and per
     config-3 d4 + multiscale TTA call, relative RMS against the fp32
     forward;
 17. training (slice F), under an nccl group of world size 1: config 3's
     model (SEResNeXt50-FPN(128), 19 classes, train mode, fp32, channels_last)
     under ``data_parallel`` (DDP), CE-focal + 0.5 Lovasz-Softmax (K4 sorts
     [19, 2^23] each step), ``make_optimizer``'s AdamW; one step at batch 2,
     512^2 against a plain step on a copy (the plain losses written here,
     ``torch.sort``): loss, every gradient, BN running statistics, one K4
     launch; then batches of 8 x 3 x 1024^2 (config 4's logits) drawn by
     ``RandomSubsetDataset`` from 16 seeded samples, ``default_collate``d and
     put on the card by ``prefetch_to_device`` under ``batch_sharding``:
     the warm-up step's peak memory (the batch is halved if it does not
     fit, on a line of its own), 5 timed steps (ms per step, images/s, MP/s,
     peak memory, losses), 2 steps under ``torch.profiler`` (idle share,
     device time by kind, top kernels, K4's kernels), K4 once per step; the
     step in NCHW against channels_last in turns; ``save_checkpoint`` after
     step 3, step 4, ``load_checkpoint`` into a fresh model and optimizer
     with the RNG restored, step 4 again in deterministic mode: loss,
     parameters and buffers bit-equal; the port's example
     (``examples.train_segmentation.main()``) at its defaults, its tiled d4
     tail on K1;
 18. DeepLabV3+ on a ResNet-50 (``resnet50_encoder(layers=(1, 4))``,
     ``DeeplabV3PlusDecoder`` at segmentation_models_pytorch's defaults:
     ASPP 256, low level 48, rates (12, 24, 36), out 256; ResizeHead(19);
     cuDNN convs, eager, bf16, channels_last; residual branches' last BN
     scales x 0.25) through ``tiled_apply_d4_tta``: at 2048^2 in both modes
     against the plain path on the fp32 model (TF32 off), every K1 launch on
     the cell route; K1 alone at the 5000^2 K = 19 shape, bit for bit and
     timed beside its bound, the plain version and ``F.fold``; one 5000^2
     distributed run at batch 64 after a warm-up run for its wall time, MP/s,
     peak memory and K1's route; under ``torch.profiler`` the idle share,
     device time by kind (cuDNN convs, depthwise convs, BatchNorm, upsample,
     cat, K1, elementwise passes) and the top kernels; the ASPP alone (its
     dilated and depthwise convs, at the run's coarse map) per run; the
     phase's own seconds;
 19. SegFormer-B2 (``mit_b2_encoder()``, no decoder, ``SegFormerHead`` at
     embedding 768, 19 classes: NVlabs SegFormer's Cityscapes B2 setting;
     eager, bf16, channels_last; seeded weights, ``Linear`` weights
     LeCun-normal) through ``tiled_apply_d4_tta``: at 2048^2 in both modes
     against the plain path on the fp32 model (TF32 off), every K1 launch on
     the cell route; K1 alone at the 5000^2 K = 19 shape; one 5000^2
     distributed run at batch 64 after a warm-up run for its wall time, MP/s,
     peak memory and K1's route; under ``torch.profiler`` the idle share and
     device time by kind (kernel names first, then the labelled module whose
     range holds the kernel on the card's timeline: GEMMs / 1x1 convs,
     attention matmuls and softmax, sr convs, depthwise 3x3, patch
     embeddings) and the top kernels; then Swin-T,
     EfficientNet-B4, EfficientNetV2-S, MixNet-M, MobileNetV2 and
     MobileNetV3-large at their published widths, one [8, 3, 512, 512] bf16
     forward each against fp32 (5e-2 * max|ref| per map) and its ms; the
     phase's own seconds;
 20. HRNetV2-W48 (``hrnet48_encoder()``, no decoder, ``HypercolumnHead``
     at 720 mid channels, 19 classes: HRNet-Semantic-Segmentation's
     Cityscapes W48 setting; eager, bf16, channels_last; seeded weights,
     residual branches' last BN and the fuse layers' BNs cut) through
     ``tiled_apply_d4_tta`` as in phase 19, with its multiply-adds per view
     and per run (``FlopCounterMode``) and the device time by kind told by
     kernel name, then by the labelled module (stem, stage-1 Bottlenecks,
     BasicBlocks, transitions, fuse layers, head); then InceptionV4,
     WiderResNet38-A2, XResNet50, Res2Net50, SK-ResNeXt50, DenseNet121,
     DPN92 and the HRNet-W48 encoder alone, timed as phase 19 times its
     encoders; the phase's own seconds;
 21. MaxViT-B + FPN (``maxvit_base_encoder(layers=(1, 2, 3, 4))``,
     ``FPNDecoder`` at 256 channels, ``ResizeHead``, 19 classes; eager,
     bf16, channels_last; seeded weights, MBConvs' last BN cut) through
     ``tiled_apply_d4_tta`` as in phase 20, with its multiply-adds and the
     device time by kind (attention, LayerNorm, GELU, MBConv depthwise, the
     FPN, K1); then MaxViT-T, NFNet-F0, TResNet-M, the Stacked Hourglass
     (8 stacks, 256 features) and SqueezeNet 1.1 alone, timed as phase 19
     times its encoders; the phase's own seconds.

Device times are medians over five windows of CUDA events; each phase
prints the spread (min-max) of its kernel's windows beside the median.
The kernels line gives, for every kernel, its time at the main path's shape
beside its plain version's, one library call's where one computes the same
function, and its bound: the larger of its compulsory bytes over 3.35 TB/s
and its operations over the 989 TFLOP/s bf16 peak (1979 TOP/s for Q1's int8
operations; H100 SXM data sheet).

Any mismatch or error exits non-zero.  The line before the last is a JSON
object describing the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import ctypes
import json
import math
import os
import re
import shutil
import statistics
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
MERGE_TOL = 0.0  # K1 sums in the reference's order with the same roundings: bit for bit
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
INT8_PEAK = 1979e12  # tensor-core int8 operations/s (dense)
# Slice C + K3: the streaming tiled path and config 3
CLASSES = 19
STREAM_SIZE, STREAM_BATCH = 5000, 32  # 361 tiles of 512^2 at step 256 -> 12 batches
STREAM_CHECK_SIZE = 2048  # the bf16 path against the fp32 one
MS_SIZE, MS_OFFSETS = 1024, [0, -256]  # BASELINE config 3
RESIDUAL_BN_SCALE = 0.25  # see config3_model
# The ResNet34-UNet: the first four of segmentation_models_pytorch.Unet's default decoder_channels
UNET34_DECODER = (32, 64, 128, 256)
UNET34_SIZE, UNET34_CHECK_SIZE = 5000, 2048  # the timed run; the bf16 path against the fp32 plain path
PAD_SIZE, PAD_TARGET = 1000, 1024  # one image, padded to a multiple of 32
# BASELINE config 5 (benchmarks/configs_bench.py:104-136): UNet-32, one class, 512/256 pyramid tiles,
# d4 "distributed", batch 32, a 10000^2 image; four strips computed one after another on the one card
CONFIG5_SIZE, CONFIG5_BATCH, CONFIG5_STRIPS = 10000, 32, 4
REPLICATED_TOL = 1e-5  # the replicated canvas against the strips, relative to max|strips|: fp32 sums in another order
WINDOW_TOL = 1e-4  # the K = 19 pixelwise head's tiled output against its direct output
# Phase 15: an ensemble of two UNet-32s at 2048^2; tiled_apply_3d of a small Conv3d net
ENSEMBLE_SIZE = 2048
VOLUME_SHAPE, VOXEL_TILE, VOXEL_STEP, VOXEL_BATCH = (1, 128, 512, 512), 64, 32, 32
VOLUME_TOL = 1e-5  # against the plain tile-by-tile path, relative to max|ref|
# Phase 16: int8 inference.  The int8 UNet-32 calibrated on the first 4 tiles of the 5000^2 image
# (bench.py:185-187), checked on 16 tiles and then at every shape of config 2's int8 run; the int8
# SEResNeXt50-FPN(128) on one 1024^2 image
INT8_CHECK_BATCH, INT8_CAL_TILES = 16, 4
INT8_PLAIN_CHUNK = 16  # samples per call of the float64 plain versions and of the im2col for torch._int_mm
INT8_INT_MM_BYTES = 40 * 2**30  # the largest im2col + int32 product the torch._int_mm yardstick may allocate
INT8_SIZE, INT8_CAL_IMAGES = 1024, 2
# calls per timing window of Q1 and its torch._int_mm yardstick at each shape: the first call's host latency
# (~60 us on the H100 machine, most of it the Python wrapper) is spread over them
INT8_Q1_REPS = 10
# The int8 UNet-32 against the bf16 fused path (relative RMS).  seed_weights' He-normal weights with BN statistics
# lose more to the shift-only requant over 15 convs than flax's default init (the JAX bench's 0.0246): this phase
# measures ~0.105 on the calibration tiles, with the integer path bit-equal to the JAX package's given its ranges
# (tests/test_torch_quantized.py).  A broken integer path lands near 1.
INT8_PTQ_RMS = 0.15
INT8_KINDS = (("Q1 (int8 conv)", r"qconv_kernel|qconv_wgmma_kernel|qconv_gemm_kernel"),
              ("Q2 (int8 upsample and decoder input)", r"q_upsample_band_kernel|q_upsample_kernel"),
              ("K1", r"grid_merge"), ("cat", r"CatArray"), ("max pooling (torch.maximum)", r"maximum|max_"))
# and the int8 SEResNeXt50-FPN's: Q1 by kernel (the 1x1 and grouped routes are qconv_gemm_kernel<NT, MW, taps, banded>)
ENCDEC_KINDS = (("Q1 gemm_wgmma (1x1)", r"qconv_gemm_kernel<\d+, ?\d+, ?1,"),
                ("Q1 grouped_wgmma", r"qconv_gemm_kernel<\d+, ?\d+, ?9,"),
                ("Q1 tma_wgmma (3x3)", r"qconv_wgmma_kernel"), ("Q1 mma.sync (qconv_kernel)", r"qconv_kernel"),
                ("Q2", r"q_upsample"), ("Q3 (int8 add)", r"q_add"), ("max pooling (torch.maximum)", r"maximum|max_"),
                ("SE (float)", r"gemm|gemv|reduce|mean|sigmoid"))
# Q3's launches in one int8 SEResNeXt50-FPN forward: the 16 bottlenecks' adds, each with its SE gate, and the FPN's 4
ENCDEC_ADDS, ENCDEC_GATED_ADDS = 20, 16
# Phase 17: training (slice F).  Config 3's model (SEResNeXt50-FPN(128), 19 classes) trained at config 4's shape:
# batches of 8 x 3 x 1024^2, so the logits are config 4's [8, 19, 1024, 1024]; CE-focal + 0.5 Lovasz-Softmax
TRAIN_BATCH, TRAIN_SIZE = 8, 1024
TRAIN_CHECK_BATCH, TRAIN_CHECK_SIZE = 2, 512  # the step against the plain step
TRAIN_STEPS, TRAIN_PROFILED_STEPS = 5, 2  # timed after one warm-up step; then two under torch.profiler
TRAIN_SAMPLES = 16  # seeded (image, mask) pairs that RandomSubsetDataset draws from
TRAIN_LOSS_RTOL = 1e-4  # the loss against the plain step's, relative
TRAIN_GRAD_TOL = 1e-3  # every gradient against the plain step's, relative to max|g| over the model
TRAIN_STATS_TOL = 1e-5  # BN running means and variances, absolute + relative
TRAIN_KINDS = (("K4", r"radix_"), ("BatchNorm", r"[Bb]atch_?[Nn]orm|bn_fw|bn_bw|welford"),
               ("Lovasz cumsum", r"[Ss]can|cumsum"), ("scatter_", r"scatter"), ("bilinear upsample", r"upsample"),
               ("AdamW", r"multi_tensor"), ("nccl", r"nccl"), ("cuDNN layout transforms", r"nhwcToNchw|nchwToNhwc"),
               ("cuDNN conv wgrad", r"wgrad"), ("cuDNN conv dgrad", r"dgrad"),
               ("cuDNN conv fprop and FFT", r"xmma|cutlass|cudnn|fprop|convolve|conv2d|gemm|fft"))
# Phase 18: DeepLabV3+ on a ResNet-50 at segmentation_models_pytorch.DeepLabV3Plus's defaults (ASPP 256, low-level
# projection 48, rates (12, 24, 36), decoder out 256); the timed run and the bf16 check against the fp32 plain path
DEEPLAB_DECODER = dict(out_channels=256, aspp_channels=256, low_level_channels=48, atrous_rates=(12, 24, 36))
DEEPLAB_SIZE, DEEPLAB_CHECK_SIZE = 5000, 2048
# (kind, pattern of the kernel names) for phase 12's device time; the first match counts, and a kernel that
# matches none (nor a labelled range, see _log_profile_by_kind) is OTHER_KIND
OTHER_KIND = "everything else"
DEVICE_KINDS = (("K1", r"grid_merge"), ("cuDNN convs", r"xmma|cutlass|cudnn|fprop|dgrad|convolve"),
                ("BatchNorm", r"batch_norm"), ("bilinear upsample", r"upsample"), ("cat", r"CatArray"))
# and for phase 18's: the separable ASPP's dilated depthwise convs (cuDNN's grouped direct kernel) apart from the rest
DEEPLAB_KINDS = (("K1", r"grid_merge"), ("ASPP dilated depthwise convs", r"[Dd]epthwise|grouped_direct"),
                 ("cuDNN convs", r"xmma|cutlass|cudnn|fprop|dgrad|convolve|conv2d|gemm"),
                 ("BatchNorm", r"batch_norm|bn_fw"), ("bilinear upsample", r"upsample"), ("cat", r"CatArray"),
                 ("ReLU (clamp)", r"clamp"), ("residual add", r"CUDAFunctor_add"), ("max pooling", r"max_pool"))
# Phase 19: SegFormer-B2, NVlabs SegFormer's Cityscapes setting (local_configs/segformer/B2/
# segformer.b2.1024x1024.city.160k.py): MiT-B2 + the MLP decode head at embed_dim 768, 19 classes
SEGFORMER_EMBED = 768
SEGFORMER_SIZE, SEGFORMER_CHECK_SIZE = 5000, 2048
# phase 19's device time: kinds told by kernel name first, then by the labelled module whose range holds the kernel
SEGFORMER_KINDS = (("K1", r"grid_merge"), ("LayerNorm", r"layer_norm"), ("GELU", r"gelu|Gelu"),
                   ("attention matmuls and softmax", r"softmax"), ("bilinear upsample", r"upsample"),
                   ("cat", r"CatArray"), ("BatchNorm", r"batch_norm|bn_fw"))
# and the encoders phase 19 runs at their published widths on one [8, 3, 512, 512] batch: timed in
# ENCODER_WINDOWS windows of ENCODER_REPS forwards after ENCODER_WARMUP, the host's launch time taken over
# ENCODER_HOST_FORWARDS single forwards, the card's busy time over ENCODER_PROFILED profiled forwards
ENCODER_BATCH = 8
ENCODER_WARMUP, ENCODER_REPS, ENCODER_WINDOWS = 3, 10, 5
ENCODER_HOST_FORWARDS, ENCODER_PROFILED = 5, 5
HOST_BOUND_IDLE = 0.2  # the card's idle share of a forward's event time from which the host is named its bound
PROJECTION_BN_SCALE = 0.5  # see _scale_block_outputs
FUSE_BN_SCALE = 0.5  # see _scale_residual_branches
ENCODERS_19 = ("swin_tiny_encoder", "efficientnet_b4_encoder", "efficientnet_v2_s_encoder", "mixnet_m_encoder",
               "MobileNetV2Encoder", "mobilenet_v3_large_encoder")
# Phase 20: HRNetV2-W48, HRNet/HRNet-Semantic-Segmentation's Cityscapes setting (experiments/cityscapes/
# seg_hrnet_w48_train_512x1024_sgd_lr1e-2_wd5e-4_bs_12_epoch484.yaml): hrnet48_encoder + the head of
# lib/models/seg_hrnet.py (four branches at stride 4, 48 + 96 + 192 + 384 = 720 channels, 1x1 conv, BN, ReLU,
# conv to 19), which the repo's HypercolumnHead(mid_channels=720) is
HRNET_MID = 720
HRNET_SIZE, HRNET_CHECK_SIZE = 5000, 2048
# phase 20's device time: kinds told by kernel name first, then by the labelled module whose range holds the kernel
# (the convs of the stem, stage 1, the BasicBlocks, the transitions, the fuse layers and the head)
HRNET_KINDS = (("K1", r"grid_merge"), ("BatchNorm", r"batch_norm|bn_fw"), ("nearest upsample", r"upsample_nearest"),
               ("bilinear upsample", r"upsample"), ("cat", r"CatArray"), ("ReLU (clamp)", r"clamp"),
               ("add", r"CUDAFunctor_add"))
# and the encoders of slice I at their published widths, timed as phase 19 times its own
ENCODERS_20 = ("inception_v4_encoder", "wider_resnet38_a2_encoder", "xresnet50_encoder", "res2net50_encoder",
               "skresnext50_encoder", "densenet121_encoder", "dpn92_encoder", "hrnet48_encoder")
# Phase 21: MaxViT-B (arXiv:2204.01697 table 1: stem 64, stages 96/192/384/768 of 2/6/14/2 blocks, heads
# 3/6/12/24, partition 8) on its four stages + FPNDecoder(256) + ResizeHead(19)
MAXVIT_FPN = 256
MAXVIT_SIZE, MAXVIT_CHECK_SIZE = 5000, 2048
# phase 21's device time: kinds told by kernel name first, then by the labelled module whose range holds the kernel
MAXVIT_KINDS = (("K1", r"grid_merge"), ("LayerNorm", r"layer_norm"), ("GELU", r"gelu|Gelu"),
                ("attention (SDPA)", r"flash|fmha|attention|softmax"), ("BatchNorm", r"batch_norm|bn_fw"),
                ("bilinear upsample", r"upsample"), ("cat", r"CatArray"))
# and the encoders of slice J at their published widths, timed as phase 19 times its own
ENCODERS_21 = ("maxvit_tiny_encoder", "nfnet_f0_encoder", "tresnet_m_encoder", "StackedHGEncoder",
               "squeezenet_encoder")
# and for phase 14's (the fused UNet-32 of config 5)
CONFIG5_KINDS = (("K1", r"grid_merge"), ("K2", r"conv3x3"), ("bilinear upsample", r"upsample"), ("cat", r"CatArray"),
                 ("max pooling", r"max_pool"))


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float = 0.0, peak_flops: float = BF16_PEAK):
    """(least time in ms on the card's published peaks, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timing(float):
    """A device time in ms: the median over several windows, which also
    keeps the fastest and the slowest window (``lo``, ``hi``)."""

    def __new__(cls, windows):
        self = super().__new__(cls, statistics.median(windows))
        self.lo, self.hi = min(windows), max(windows)
        return self

    def __str__(self) -> str:
        return f"{float(self):.3f} ms (min-max {self.lo:.3f}-{self.hi:.3f})"


def cuda_ms(fn, reps: int = 5, warmup: int = 1, windows: int = 5) -> Timing:
    """Device time of one call of ``fn`` in ms: the mean over ``reps`` calls
    between CUDA events, in each of ``windows`` windows; their median and
    spread."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return Timing(times)


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
        for name, regs, smem, spills in _ptxas_report(log_file.read_text()):
            log(f"[1]   ptxas: {name}: {regs} registers, {smem} bytes of static shared memory, "
                f"{spills} bytes of spill stores")
    info = (ctypes.c_int * 4)()
    _build.check(_build.library().ptt_radix_sort_pass_info(0, info), "ptt_radix_sort_pass_info")
    log(f"[1] radix_pass_kernel: {info[0]} pairs per tile, {info[1]} threads, {info[2]} bytes of dynamic shared "
        f"memory, {info[3]} blocks resident per SM")
    info = _merge_sort_info()
    log(f"[1] merge_sort: {info[0]} pairs per chunk and per merge tile, {info[1]} threads, {info[2]} bytes of "
        f"dynamic shared memory; blocks resident per SM: block_sort_kernel {info[3]}, merge_kernel {info[4]}; "
        f"at most {info[5]} runs merged at once")
    info = (ctypes.c_int * 6)()
    _build.check(_build.library().ptt_grid_merge_cell_info(0, 0, 0, TILE // STEP, TILE // STEP, info),
                 "ptt_grid_merge_cell_info")
    log(f"[1] grid_merge_cell_kernel at the main path's {(TILE // STEP) ** 2} covering tiles, fp32: {info[0]} threads "
        f"(a producer warp), {info[1]} ring stages of {info[4]}x{info[5]}-pixel boxes, {info[2]} bytes of dynamic "
        f"shared memory, {info[3]} blocks resident per SM")
    cuobjdump = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    if not Path(cuobjdump).is_file():
        log("[1] cuobjdump not found: the conv, Q1 and grid-merge kernels' SASS is not inspected")
    else:
        sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True, timeout=300).stdout
        counts = _sass_counts(sass, "conv3x3_wgmma_kernel", ("HGMMA", "UTMALDG", "UBLKCP"))
        log(f"[1] SASS of the {counts.pop('functions')} wgmma conv kernels (cuobjdump -sass): "
            + ", ".join(f"{op} {n}" for op, n in counts.items()))
        for name, what in (("qconv_wgmma_kernel", "Q1 3x3 wgmma kernels"),
                           ("qconv_gemm_kernel", "Q1 1x1 and grouped wgmma kernels")):
            counts = _sass_counts(sass, name, ("IGMMA", "UTMALDG", "UTMASTG", "UBLKCP"))
            log(f"[1] SASS of the {counts.pop('functions')} {what} (cuobjdump -sass): "
                + ", ".join(f"{op} {n}" for op, n in counts.items()))
        counts = _sass_counts(sass, "grid_merge_cell_kernel", ("UTMALDG", "LDG", "LDS", "STG"))
        log(f"[1] SASS of the {counts.pop('functions')} grid_merge_cell_kernel instances (cuobjdump -sass): "
            + ", ".join(f"{op} {n}" for op, n in counts.items()))
        _log_q2_sass(sass)
    return smi


def _sass_functions(sass: str) -> dict:
    """{function name: [(address, opcode, instruction)]} of a ``cuobjdump -sass`` listing."""
    functions, current = {}, None
    for line in sass.splitlines():
        match = re.search(r"Function : (\S+)", line)
        if match:
            current = functions.setdefault(match.group(1), [])
            continue
        match = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if match and current is not None:
            text = match.group(2)
            opcode = re.sub(r"^@!?U?P[T0-9]+\s+", "", text).split()[0]
            current.append((int(match.group(1), 16), opcode, text))
    return functions


def _loops(code):
    """(first address, branch address) of each innermost loop: a branch to an
    earlier address with no other such branch inside it."""
    spans = []
    for addr, opcode, text in code:
        target = re.search(r"BRA\S*\s+(?:`\(\S+\)\s*)?(0x[0-9a-f]+)", text)
        if opcode.startswith("BRA") and target and int(target.group(1), 16) < addr:
            spans.append((int(target.group(1), 16), addr))
    return [s for s in spans if not any(o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]


def _log_q2_sass(sass: str) -> None:
    """Q2's SASS instructions per output byte: the per-pixel kernel's v4
    instance (the first design, straight-line: its static count, both
    branches, over its 4 bytes), and the banded kernel's row and column
    passes (the instructions of each innermost loop that holds IDP.2A, over
    its IDP.2A count: one IDP.2A yields one byte of a pass), combined at the
    main path's tiles (a row-pass byte per WW / P output bytes)."""
    from pytorch_toolbelt_tpu_torch.ops.quantized import _band_tile
    from pytorch_toolbelt_tpu_torch.zoo.quantized_unet import _q_upsample_matrices

    functions = _sass_functions(sass)
    pixel = [code for name, code in functions.items() if "q_upsample_kernelILi4E" in name]
    band = [code for name, code in functions.items() if "q_upsample_band_kernel" in name]
    if not pixel or not band:
        log(f"[1] Q2's SASS not found ({len(pixel)} per-pixel v4 and {len(band)} banded functions)")
        return
    useful = [op for _, op, _ in pixel[0] if op not in ("NOP", "BRA")]
    passes = {}
    for first, last in _loops(band[0]):
        body = [(op, text) for addr, op, text in band[0] if first <= addr <= last]
        dp2a = sum(op.startswith("IDP") for op, _ in body)
        if dp2a:
            kind = "column" if any(op.startswith("STG") for op, _ in body) else "row"
            passes.setdefault(kind, []).append((len(body), dp2a))
    log(f"[1] Q2 SASS: the per-pixel kernel's v4 instance (the first design) {len(useful)} instructions for 4 output "
        f"bytes = {len(useful) / 4:.2f} per byte; the banded kernel's loops with IDP.2A: "
        + "; ".join(f"{kind} pass {', '.join(f'{n} instructions / {d} IDP.2A = {n / d:.2f} per byte' for n, d in v)}"
                    for kind, v in sorted(passes.items())))
    if set(passes) == {"row", "column"}:
        row, col = (min(n / d for n, d in passes[k]) for k in ("row", "column"))
        for c, size in ((256, 64), (128, 128), (64, 256)):
            mh, mw, _ = _q_upsample_matrices(size, size, 2 * size, 2 * size)
            r, p, rw, ww = _band_tile(c, mh, mw)
            log(f"[1] Q2 banded at {c} channels {size}^2 -> {2 * size}^2: tile {r}x{p} (input {rw}x{ww}), "
                f"{row:.2f} x {ww}/{p} + {col:.2f} = {row * ww / p + col:.2f} SASS instructions per output byte")


def _ptxas_report(text: str):
    """(kernel, registers, static shared-memory bytes, spill-store bytes) for
    every entry function in a ``ptxas -v`` log."""
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
            smem = re.search(r"(\d+) bytes smem", line)
            yield name, int(match.group(1)), int(smem.group(1)) if smem else 0, spills
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
            f"kernel {ms} ({gflop / ms:.1f} TFLOP/s), wmma {wmma_ms:.3f} ms, cuDNN + epilogue "
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


def merge_bytes(grid, tile_hw, out_hw, offset, channels, in_size, out_size) -> int:
    """K1's compulsory bytes: each tile pixel that lands in the crop read once,
    the output written once, the weight read once."""
    (ty, tx, sh, sw), (th, tw) = grid, tile_hw

    def inside(n, t, s, lo, size):  # the tiles' rows (columns) inside [lo, lo + size), summed over the tiles
        return sum(max(0, min(i * s + t, lo + size) - max(i * s, lo)) for i in range(n))

    pixels = inside(ty, th, sh, offset[0], out_hw[0]) * inside(tx, tw, sw, offset[1], out_hw[1])
    return pixels * channels * in_size + channels * out_hw[0] * out_hw[1] * out_size + th * tw * 4


def phase_merge(dev, smi):
    """K1 at phase 3's shape: each output type bit for bit against the plain
    version on both routes, and timed on the cell route beside the general
    route, F.fold and the plain version; then the cell route at a ragged crop."""
    from pytorch_toolbelt_tpu_torch.inference import ImageSlicer
    from pytorch_toolbelt_tpu_torch.ops import grid_merge, grid_merge_reference

    slicer = ImageSlicer((5000, 5000), TILE, STEP, weight="pyramid")
    th, tw = slicer.tile_size
    ty = (slicer.target_shape[0] - th) // STEP + 1
    tx = (slicer.target_shape[1] - tw) // STEP + 1
    grid = (ty, tx, STEP, STEP)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    tiles = torch.randn(ty * tx, 1, th, tw, device=dev, generator=gen)
    # the same tiles 4 bytes off a 16-byte boundary: the kernel takes its general route for them
    shifted = torch.empty(tiles.numel() + 1, device=dev)[1:].view_as(tiles).copy_(tiles)
    weight = torch.as_tensor(slicer.weight.astype(np.float32), device=dev)
    out_hw, offset = (5000, 5000), (slicer.margin_top, slicer.margin_left)
    inputs = {"cell": tiles, "general": shifted}

    def merge(route, out_dtype, normalize=True, crop=(out_hw, offset)):
        before = dict(grid_merge.launches_by_route)
        got = grid_merge(inputs[route], weight, grid, *crop, normalize=normalize, out_dtype=out_dtype)
        taken = [r for r, n in grid_merge.launches_by_route.items() if n != before[r]]
        if taken != [route]:
            raise AssertionError(f"phase 3's {route} input took the route {taken}")
        return got

    errs = {}
    for out_dtype in (torch.float32, torch.bfloat16):
        for route in ("cell", "general"):
            got = merge(route, out_dtype)
            got_c, got_n = merge(route, out_dtype, normalize=False, crop=(None, (0, 0)))
            ref = grid_merge_reference(tiles, weight, grid, out_hw, offset, out_dtype=out_dtype)
            ref_c, ref_n = grid_merge_reference(tiles, weight, grid, normalize=False, out_dtype=out_dtype)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got).all())
            errs[route, out_dtype] = max(float((a.float() - b.float()).abs().max())
                                         for a, b in ((got, ref), (got_c, ref_c), (got_n, ref_n))) if finite else math.inf
            del got, got_c, got_n, ref, ref_c, ref_n
    ok = all(err <= MERGE_TOL for err in errs.values())
    log(f"[3] grid_merge {ty * tx} tiles -> 5000^2 at offset {offset}, normalized and (canvas, norm): max|err| "
        "against grid_merge_reference "
        + ", ".join(f"{route} route {str(dt)[6:]} out {err:.3e}" for (route, dt), err in errs.items())
        + f" <= {MERGE_TOL:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"grid_merge disagrees with grid_merge_reference: {errs}")

    # the library's overlap-add: F.fold of the weighted tiles (no division, no crop)
    cols = (tiles * weight).reshape(ty * tx, -1).t().unsqueeze(0)
    fold = lambda: F.fold(cols, slicer.target_shape, (th, tw), stride=STEP)  # noqa: E731
    fold_ms = cuda_ms(fold, reps=10)
    del cols
    times = {}
    for out_dtype in (torch.float32, torch.bfloat16):
        nbytes = merge_bytes(grid, (th, tw), out_hw, offset, 1, 4, 4 if out_dtype == torch.float32 else 2)
        bound, bound_by = bound_ms(nbytes)
        for route in ("cell", "general"):
            times[route, out_dtype] = cuda_ms(lambda: merge(route, out_dtype), reps=20)
        ref_ms = cuda_ms(lambda: grid_merge_reference(tiles, weight, grid, out_hw, offset, out_dtype=out_dtype),
                         reps=2)
        ms = times["cell", out_dtype]
        times["reference", out_dtype], times["bound", out_dtype] = ref_ms, (bound, bound_by)
        log(f"[3] grid_merge {str(out_dtype)[6:]} out, cell route: {ms} ({nbytes / ms / 1e6:.0f} GB/s of "
            f"{nbytes / 1e6:.1f} MB compulsory, {bound / ms:.0%} of the bound {bound:.4f} ms ({bound_by})); "
            f"general route (one thread per element) {times['general', out_dtype]}; reference {ref_ms:.3f} ms; "
            f"F.fold {fold_ms:.3f} ms ({smi})")

    # a crop whose x-offset and width are not multiples of 4: each row's output starts off a 16-byte boundary
    ragged = ((out_hw[0], out_hw[1] - 3), (offset[0], offset[1] + 1))
    got = merge("cell", torch.float32, crop=ragged)
    err = float((got - grid_merge_reference(tiles, weight, grid, *ragged, out_dtype=torch.float32)).abs().max())
    del got
    nbytes = merge_bytes(grid, (th, tw), *ragged, 1, 4, 4)
    bound = bound_ms(nbytes)[0]
    ms = cuda_ms(lambda: merge("cell", torch.float32, crop=ragged), reps=20)
    log(f"[3] grid_merge float32 out, cell route at the ragged crop {ragged[0]} at offset {ragged[1]}: max|err| "
        f"{err:.3e} <= {MERGE_TOL:.0e} {'ok' if err <= MERGE_TOL else 'FAIL'}; {ms} ({nbytes / ms / 1e6:.0f} GB/s, "
        f"{bound / ms:.0%} of the bound {bound:.4f} ms) ({smi})")
    if not err <= MERGE_TOL:
        raise AssertionError(f"grid_merge at a ragged crop disagrees with grid_merge_reference: {err}")
    return {"max_abs_err": errs["cell", torch.float32], "ms": times["cell", torch.float32],
            "plain_ms": times["reference", torch.float32], "bound_ms": times["bound", torch.float32][0],
            "bound_by": times["bound", torch.float32][1], "library_ms": fold_ms,
            "bf16_out_ms": times["cell", torch.bfloat16], "bf16_out_bound_ms": times["bound", torch.bfloat16][0]}


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
    _reset_merge_counts()
    outs, walls = {}, {}
    for mode, batch in runs:
        t0 = time.perf_counter()
        outs[mode] = tiled_apply_d4_tta(fused, image, TILE, STEP, weight="pyramid", batch_size=batch, mode=mode)
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t0
    launches = {"conv3x3": conv3x3.launches, "grid_merge": grid_merge.launches,
                "conv3x3_by_route": dict(conv3x3.launches_by_route),
                "grid_merge_by_route": dict(grid_merge.launches_by_route)}
    log(f"[5] main path launches: {launches}")
    if min(conv3x3.launches, grid_merge.launches) == 0:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    _check_conv_routes("[5] 2048^2 runs")
    _check_merge_routes("[5] 2048^2 runs", len(runs))

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


def _reset_merge_counts():
    from pytorch_toolbelt_tpu_torch.ops import grid_merge

    grid_merge.launches = 0
    for route in grid_merge.launches_by_route:
        grid_merge.launches_by_route[route] = 0


def _check_merge_routes(what: str, calls: int):
    """Each ``tiled_apply_d4_tta`` call merges with one K1 launch, on the cell route."""
    from pytorch_toolbelt_tpu_torch.ops import grid_merge

    by_route = grid_merge.launches_by_route
    if by_route["cell"] != calls or sum(by_route.values()) != calls:
        raise AssertionError(f"{what}: K1 launches by route {by_route}, expected {calls} on the cell route")


def _check_conv_routes(what: str):
    """UNet-32's forward has one conv with C_in % 8 != 0 (the 3-channel stem,
    the load route) and 14 with C_in % 8 == 0, which must all take TMA."""
    from pytorch_toolbelt_tpu_torch.ops import conv3x3

    by_route = conv3x3.launches_by_route
    if by_route["wmma"] or not by_route["ld_wgmma"] or by_route["tma_wgmma"] != 14 * by_route["ld_wgmma"]:
        raise AssertionError(f"{what}: K2 launches by route {by_route}, expected 14 tma_wgmma per ld_wgmma")


def phase_full_size(fused, dev, smi):
    from pytorch_toolbelt_tpu_torch.inference import tiled_apply_d4_tta
    from pytorch_toolbelt_tpu_torch.ops import conv3x3, grid_merge

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    image = torch.rand(3, 5000, 5000, device=dev, generator=gen)
    for mode, batch in (("distributed", DIST_BATCH), ("full", FULL_BATCH)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_conv_counts()
        _reset_merge_counts()
        t0 = time.perf_counter()
        out = tiled_apply_d4_tta(fused, image, TILE, STEP, weight="pyramid", batch_size=batch, mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if out.shape != (1, 5000, 5000) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"5000^2 {mode} run gave a wrong shape or non-finite values")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[6] tiled_apply_d4_tta 5000^2 {mode} batch={batch}: {wall:.3f} s, {25.0 / wall:.2f} MP/s, "
            f"peak {peak:.2f} GiB allocated; K2 launches by route {dict(conv3x3.launches_by_route)}, K1 "
            f"{dict(grid_merge.launches_by_route)} ({smi})")
        _check_conv_routes(f"[6] 5000^2 {mode}")
        _check_merge_routes(f"[6] 5000^2 {mode}", 1)
        del out

    wall_ms, prof = _profiled(lambda: tiled_apply_d4_tta(fused, image, TILE, STEP, weight="pyramid",
                                                         batch_size=DIST_BATCH, mode="distributed"))
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


SORT_KERNEL = re.compile(r"::((?:radix_\w+|block_sort|partition|merge)_kernel)\b")  # K4's and K5's


def _short_kernel_name(name: str) -> str:
    match = SORT_KERNEL.search(name) or re.search(r"(Memset[^)]*\))", name)
    return match.group(1) if match else name[:40]


def _merge_sort_info() -> list:
    """K5's geometry (``ptt_merge_sort_info``): pairs per chunk, threads, dynamic shared bytes,
    blocks per SM of the chunk sort and of the merge, most runs merged at once."""
    from pytorch_toolbelt_tpu_torch.ops import _build

    info = (ctypes.c_int * 6)()
    _build.check(_build.library().ptt_merge_sort_info(0, info), "ptt_merge_sort_info")
    return list(info)


def _merge_sort_rounds(n: int, info) -> int:
    """K5's merge rounds for a row of n pairs: the fewest that merge its chunks info[5] at a time."""
    chunks, rounds, reach = -(-n // info[0]), 0, 1
    while reach < chunks:
        reach *= info[5]
        rounds += 1
    return rounds


def _sort_account(name, sort, keys, payload, design_bytes, ms, library_ms, what, smi):
    """One sort under torch.profiler: log its launches, each launch's ms and their sums by kernel, beside
    the sort's median ``ms`` and the GB/s it reaches of its design's bytes; return the launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sort(keys, payload)
        torch.cuda.synchronize()
    ops = [(_short_kernel_name(op), (end - start) / 1e3) for start, end, op, _ in _device_events(prof)]
    launches = f"{len(ops)} launches per sort" if ops else "launches per sort not measured (no CUDA events)"
    log(f"[7] {name} {what}: {ms}; {launches}; design bytes {design_bytes / 1e9:.2f} GB "
        f"= {design_bytes / HBM_RATE * 1e3:.3f} ms at {HBM_RATE / 1e12:.2f} TB/s, {design_bytes / ms / 1e6:.0f} GB/s "
        f"of them; compulsory-bytes bound {bound_ms(keys.numel() * 16)[0]:.3f} ms; torch.sort(stable=True) "
        f"{library_ms} ({smi})")
    if ops:
        by_kernel = {}
        for op, op_ms in ops:
            count, total = by_kernel.get(op, (0, 0.0))
            by_kernel[op] = (count + 1, total + op_ms)
        log("[7]   one sort under torch.profiler: " + ", ".join(f"{op} {op_ms:.3f}" for op, op_ms in ops)
            + f" ms; sum {sum(op_ms for _, op_ms in ops):.3f} ms; by kernel: "
            + ", ".join(f"{op} {count}x {total:.3f} ms" for op, (count, total) in by_kernel.items()))
    return ops


def phase_sorts(dev, smi):
    """K4 and K5 against sort_reference at the Lovasz shapes of config 4."""
    from pytorch_toolbelt_tpu_torch.ops import bitonic_sort_chunked, sort_reference, split_sort

    merge_info = _merge_sort_info()

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
        # Each kernel's own account: its design's bytes and what each launch of one sort took.
        # K4: the keys once for the histograms, then keys and payloads read and written once per
        # pass; K5: keys and payloads read and written by the chunk sort and once per merge round.
        what = f"{case} [{rows}, {cols}]"
        _sort_account("radix_sort", bitonic_sort_chunked, keys, payload, 68 * rows * cols,
                      times["radix_sort", case], times["library", case], what, smi)
        rounds = _merge_sort_rounds(cols, merge_info)
        ops = _sort_account("merge_sort", split_sort, keys, payload, 16 * (1 + rounds) * rows * cols,
                            times["merge_sort", case], times["library", case], f"{what} ({rounds} merge rounds)", smi)
        if len(ops) > 1 + 2 * rounds:  # its design: the chunk sort, then a partition and a merge per round
            raise AssertionError(f"merge_sort {what}: {len(ops)} device operations, more than 1 + 2 * {rounds}")
        log(f"[7] merge_sort {what}: {times['merge_sort', case] / times['library', case]:.2f}x one torch.sort"
            f"(stable=True), {times['merge_sort', case] / times['radix_sort', case]:.2f}x radix_sort")
        if case == "bwd":
            # the inverse permutation as Lovasz's backward applies it: a scatter, the int64 cast included
            scattered = torch.empty_like(payload).scatter_(1, keys.long(), payload)
            if not torch.equal(scattered, want[1]):
                raise AssertionError("scatter_ inverse permutation disagrees with the sort")
            times["scatter", case] = cuda_ms(lambda: torch.empty_like(payload).scatter_(1, keys.long(), payload),
                                             reps=5)
            index = keys.long()
            scatter_ready = cuda_ms(lambda: torch.empty_like(payload).scatter_(1, index, payload), reps=5)
            log(f"[7] inverse permutation [{rows}, {cols}] as scatter_: {times['scatter', case]} with the int64 cast, "
                f"{scatter_ready} with the int64 index ready; radix_sort {times['radix_sort', case]:.3f} ms")
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
    steps after one warm-up on the host's clock; the median and spread of
    the steps between CUDA events recorded after each; the peak memory
    allocated meanwhile."""
    def step(x):
        x = x.detach().requires_grad_(True)
        value = fn(x, target)
        value.backward()
        return (x + 1e-4 * x.grad).detach()

    x = step(x0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(LOSS_STEPS + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(LOSS_STEPS):
        x = step(x)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / LOSS_STEPS * 1e3
    steps = Timing([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    return wall, steps, torch.cuda.max_memory_allocated() / 2**30


def _profile_loss_step(fn, x0, target, smi, steps: int = 2):
    """Device time by kernel of ``steps`` chained loss steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    x = x0.detach()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            x = x.detach().requires_grad_(True)
            fn(x, target).backward()
            x = (x + 1e-4 * x.grad).detach()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    busy, by_name = _device_busy_ms(prof) / steps, _device_ms_by_name(prof)
    if busy == 0:
        log("[8]   profiled step: device time not measured (the profiler saw no CUDA events)")
        return
    log(f"[8]   profiled step ({steps} steps): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"(idle {1 - busy / wall_ms:.1%}) ({smi})")
    for kernel, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[8]     device {ms / steps:8.3f} ms per step = {ms / steps / busy:6.1%}  {kernel[:90]}")
    sort_kernels = {}
    for kernel, ms in by_name.items():
        match = SORT_KERNEL.search(kernel)
        if match:
            sort_kernels[match.group(1)] = sort_kernels.get(match.group(1), 0.0) + ms / steps
    total = sum(sort_kernels.values())
    log(f"[8]     the sort's kernels {total:.3f} ms per step = {total / busy:.1%}: "
        + ", ".join(f"{kernel} {ms:.3f}" for kernel, ms in sort_kernels.items()))


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
    log(f"[8] logits {list(LOSS_SHAPE)} fp32: copy {copy_ms} = {copy_gbps:.0f} GB/s read+write ({smi})")

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
            ok = ok and sorts == (1 if "Lovasz" in name else 0)  # the forward's sort; the backward scatters
            log(f"[8] {name}: value {float(value):.7g} vs plain {float(want_value):.7g}, rel err {value_err:.2e} "
                f"<= {LOSS_VALUE_RTOL:.0e}; grad max|err| {grad_err:.3e} <= {grad_tol:.3e}; sort launches {sorts} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with the plain path")
            del grad, want_grad
            ms, steps, peak = _chained_steps(port, x0, target)
            extra = ""
            if floor is not None:
                gbps = floor / ms / 1e6
                extra = f", {gbps:.0f} GB/s of its byte floor = {gbps / copy_gbps:.1%} of the copy rate"
            if "Lovasz" in name and x0 is logits:
                sort = "merge_sort" if split else "radix_sort"
                sort_ms, scatter_ms = sort_times[sort, "fwd"], sort_times["scatter", "bwd"]
                extra = (f", its one {sort} launch {sort_ms:.2f} ms = {sort_ms / ms:.1%} of the step, the "
                         f"backward's scatter_ (int64 cast included) {scatter_ms:.2f} ms = {scatter_ms / ms:.1%}")
            log(f"[8] {name}: {ms:.3f} ms per fwd+bwd step ({LOSS_STEPS} chained; per step between CUDA events "
                f"{steps}), peak {peak:.2f} GiB{extra}")
            if name.startswith("LovaszLoss(softmax)"):
                _profile_loss_step(port, x0, target, smi)
        finally:
            lovasz.SPLIT_SORT = False
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


def _scatter_merge_launch(canvas, norm, tiles, coords, weight):
    """One K3 launch through the library's C entry point, with the batch's
    coordinates copied to the card once, here: the kernel alone, without
    the wrapper's host checks and coordinate copy."""
    from pytorch_toolbelt_tpu_torch.ops import _build
    from pytorch_toolbelt_tpu_torch.ops.tile_merge import _DTYPE_CODES

    coords = np.ascontiguousarray(coords, dtype=np.int64)
    (y0, x0), (y1, x1) = coords.min(0), coords.max(0) + tiles.shape[2:]
    coords_dev = torch.from_numpy(coords).to(canvas.device)
    lib, stream = _build.library(), _build.stream_of(canvas.device)
    n, c, th, tw = tiles.shape
    h, w = canvas.shape[1:]

    def launch():
        err = lib.ptt_scatter_merge(canvas.device.index, canvas.data_ptr(), norm.data_ptr(), tiles.data_ptr(),
                                    _DTYPE_CODES[tiles.dtype], weight.data_ptr(), coords_dev.data_ptr(), n, c, h, w,
                                    th, tw, int(y0), int(x0), int(y1 - y0), int(x1 - x0), stream)
        _build.check(err, "ptt_scatter_merge")

    return launch


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
        # the C call that is timed below, with its coordinates on the card, on fresh buffers
        got_c, got_n = canvas.clone(), norm.clone()
        _scatter_merge_launch(got_c, got_n, tiles, coords, weight)()
        torch.cuda.synchronize()
        if not (torch.equal(got_c, want_c) and torch.equal(got_n, want_n)):
            raise AssertionError(f"ptt_scatter_merge {name} with device coordinates disagrees with "
                                 "accumulate_tiles_reference")
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
        wrapper_ms = cuda_ms(lambda: accumulate_tiles(canvas, norm, tiles, coords, weight), reps=10)
        ms = cuda_ms(_scatter_merge_launch(canvas, norm, tiles, coords, weight), reps=10)
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
        log(f"[9] scatter_merge {name}: kernel with its coordinates on the card {ms} = {nbytes / ms / 1e6:.0f} GB/s "
            f"of its {nbytes / 1e9:.3f} GB ({covered} covered pixels); through accumulate_tiles (host checks, pinned "
            f"coordinate copy) {wrapper_ms}; accumulate_tiles_reference {plain_ms:.3f} ms; index_add_ pair (int64 "
            f"index ready, atomics) {library_ms:.3f} ms; bound {bound:.3f} ms at {HBM_RATE / 1e12:.2f} TB/s, "
            f"{nbytes / copy_rate / 1e6:.3f} ms at the measured copy rate {copy_rate:.0f} GB/s ({smi})")
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                  "library_ms": library_ms, "wrapper_ms": wrapper_ms}
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

    model = config3_module().eval().to(dev, memory_format=torch.channels_last)
    return model, copy.deepcopy(model).to(torch.bfloat16)


def config3_module():
    """config3_model's fp32 module on the CPU, before its device and mode."""
    from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, se_resnext50_encoder

    encoder = se_resnext50_encoder()
    decoder = FPNDecoder(encoder.get_output_spec(), out_channels=128)
    model = seed_weights(EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(),
                                                                            num_classes=CLASSES)), SEED + 10)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bn3.weight", "downsample.1.weight")):
                p.mul_(RESIDUAL_BN_SCALE)
    return model


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


def _device_events(prof) -> list:
    """(start us, end us, name, stream) of each kernel, copy and memset a
    profile saw on the card, in the order they started; empty if it saw no
    CUDA events.  Ranges that ``record_function`` marks on the card's
    timeline (DDP's forward, say) are not device work and are left out."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name, getattr(e, "device_resource_id", None))
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))


def _busy_ms(events) -> float:
    """Union of the (start us, end us, ...) intervals, in ms."""
    busy, end = 0.0, float("-inf")
    for a, b, *_ in events:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _device_busy_ms(prof) -> float:
    """Union of the device intervals (kernels, copies) a profile saw, in ms."""
    return _busy_ms(_device_events(prof))


def _device_ms_by_name(prof) -> dict:
    """Device time in ms of each kernel or copy name a profile saw."""
    by_name = {}
    for a, b, name, _ in _device_events(prof):
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    return by_name


def _log_profile_by_kind(what: str, fn, kinds, smi, top: int, labels=None) -> None:
    """Run ``fn`` once under torch.profiler (with ``labels``' ranges, see
    ``_profiled``); log its idle share and device time by kind: the first of
    ``kinds``, (kind, pattern of the kernel names), whose pattern the
    kernel's name matches, else the kind of the innermost labelled range
    that holds the kernel on the card's timeline (the profiler's spans of
    the ``record_function`` ranges there), else OTHER_KIND; then its ``top``
    kernels."""
    from torch.autograd import DeviceType

    wall_ms, prof = _profiled(fn, labels)
    events = _device_events(prof)
    if not events:
        log(f"{what}: device time not measured (the profiler saw no CUDA events)")
        return
    busy, names = _busy_ms(events), set((labels or {}).values())
    # ranges by start, the outer of two that start together first, so that the innermost is on top of the stack
    ranges = sorted((e.time_range.start, -e.time_range.end, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA and getattr(e, "is_user_annotation", False)
                    and e.name in names)
    totals, stack, i = {}, [], 0
    for start, end, name, _ in events:
        while i < len(ranges) and ranges[i][0] <= start:
            r_start, r_end, r_name = ranges[i][0], -ranges[i][1], ranges[i][2]
            while stack and stack[-1][0] <= r_start:
                stack.pop()
            stack.append((r_end, r_name))
            i += 1
        while stack and stack[-1][0] <= start:
            stack.pop()
        kind = next((k for k, pattern in kinds if re.search(pattern, name)), None)
        kind = kind or (stack[-1][1] if stack else OTHER_KIND)
        totals[kind] = totals.get(kind, 0.0) + (end - start) / 1e3
    by_kind = sorted(totals.items(), key=lambda kv: -kv[1])
    log(f"{what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms (idle {1 - busy / wall_ms:.1%}); device time by "
        f"kind ({sum(totals.values()):.1f} ms of kernels and copies, {len(ranges)} labelled ranges): "
        + ", ".join(f"{k} {ms:.2f} ms ({ms / busy:.1%})" for k, ms in by_kind) + f" ({smi})")
    label = what.split()[0]
    for name, ms in sorted(_device_ms_by_name(prof).items(), key=lambda kv: -kv[1])[:top]:
        log(f"{label}   device {ms:8.2f} ms  {name[:100]}")


@contextlib.contextmanager
def _labelled(labels: dict):
    """Mark each call of each module of ``labels`` as a ``record_function``
    range named by its kind, for the profiler to attribute kernels to."""
    from torch.autograd.profiler import record_function

    open_ranges, handles = {}, []
    for module, label in labels.items():
        def pre(m, args, label=label):
            open_ranges.setdefault(id(m), []).append(record_function(label).__enter__())

        def post(m, args, out):
            open_ranges[id(m)].pop().__exit__(None, None, None)

        handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _profiled(fn, labels=None):
    """Run ``fn`` once under ``torch.profiler``, each call of each module of
    ``labels`` ({module: kind}) marked as a range (``_labelled``): (wall ms
    to a synchronize, the profile)."""
    from torch.profiler import ProfilerActivity, profile

    with _labelled(labels or {}), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, prof


def phase_streaming(dev, smi, model, model_bf16):
    """Streaming tiled inference of a 5000^2 image through K3, and the
    2048^2 bf16 run against the fp32 one."""
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

    prof_wall_ms, prof = _profiled(lambda: stream_tiled(forward, image, slicer, dev))
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


def resnet34_unet(dev):
    """The ResNet34-UNet: ``resnet34_encoder()``, a residual UNet decoder of
    widths UNET34_DECODER with deconvolution upsampling, ResizeHead(19);
    seeded weights.  As in config3_model, the last BatchNorm of every
    residual branch (the encoder's blocks and the decoder's residual blocks)
    and of every projection shortcut gets its scale cut by
    RESIDUAL_BN_SCALE, so that activations stay of order one.  Returns the
    fp32 and the bf16 model, both channels_last."""
    import copy

    from pytorch_toolbelt_tpu_torch.nn import UnetResidualBlock
    from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, ResizeHead, UNetDecoder, resnet34_encoder
    from pytorch_toolbelt_tpu_torch.zoo.encoders.resnet import BasicBlock

    encoder = resnet34_encoder()
    decoder = UNetDecoder(encoder.get_output_spec(), UNET34_DECODER, block_type="unet_residual",
                          upsample_block="deconv")
    model = seed_weights(EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(),
                                                                            num_classes=CLASSES)), SEED + 13)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BasicBlock):
                m.bn2.weight.mul_(RESIDUAL_BN_SCALE)
                if m.downsample is not None:
                    m.downsample[-1].weight.mul_(RESIDUAL_BN_SCALE)
            elif isinstance(m, UnetResidualBlock):
                m.norm2.norm.weight.mul_(RESIDUAL_BN_SCALE)
    model = model.eval().to(dev, memory_format=torch.channels_last)
    return model, copy.deepcopy(model).to(torch.bfloat16)


def _k1_at(stack, weight, grid, out_hw, offset, smi, phase="[12]"):
    """K1 alone at a main path's shape: bit for bit against the plain
    version, then its ms beside its bound, the plain version and F.fold, per
    output type."""
    from pytorch_toolbelt_tpu_torch.ops import grid_merge, grid_merge_reference

    n, k, th, tw = stack.shape
    ty, tx, sh, sw = grid
    for out_dtype in (torch.float32, torch.bfloat16):
        got = grid_merge(stack, weight, grid, out_hw, offset, out_dtype=out_dtype)
        err = float((got.float() - grid_merge_reference(stack, weight, grid, out_hw, offset,
                                                        out_dtype=out_dtype).float()).abs().max())
        del got
        if not err <= MERGE_TOL:
            raise AssertionError(f"grid_merge at K = {k} disagrees with grid_merge_reference: {err}")
        nbytes = merge_bytes(grid, (th, tw), out_hw, offset, k, 4, 4 if out_dtype == torch.float32 else 2)
        bound, bound_by = bound_ms(nbytes)
        ms = cuda_ms(lambda: grid_merge(stack, weight, grid, out_hw, offset, out_dtype=out_dtype))
        plain_ms = cuda_ms(lambda: grid_merge_reference(stack, weight, grid, out_hw, offset, out_dtype=out_dtype),
                           reps=1, windows=3)
        log(f"{phase} grid_merge {n} fp32 tiles [{k}, {th}, {tw}] -> {out_hw[0]}x{out_hw[1]}, {str(out_dtype)[6:]} out: "
            f"max|err| {err:.3e} <= {MERGE_TOL:.0e} ok; {ms} ({nbytes / ms / 1e6:.0f} GB/s of {nbytes / 1e6:.1f} MB "
            f"compulsory, {bound / ms:.0%} of the bound {bound:.4f} ms ({bound_by})); reference {plain_ms:.3f} ms "
            f"({smi})")
    cols = (stack * weight).reshape(n, -1).t().unsqueeze(0)
    fold_ms = cuda_ms(lambda: F.fold(cols, ((ty - 1) * sh + th, (tx - 1) * sw + tw), (th, tw), stride=(sh, sw)),
                      reps=2)
    del cols
    log(f"{phase} F.fold of the {n} weighted tiles (overlap-add only, no division, no crop): {fold_ms} ({smi})")


@torch.no_grad()
def phase_resnet34_unet(dev, smi, model, model_bf16):
    """The ResNet34-UNet through tiled d4 inference: at 2048^2 in both modes
    against the plain path on the fp32 model; one 5000^2 distributed run for
    its wall time, peak memory, K1's route at K = 19 and, under
    torch.profiler, the idle share, device time by kind and top kernels; K1
    alone at that shape."""
    from pytorch_toolbelt_tpu_torch.inference import ImageSlicer, tiled_apply_d4_tta
    from pytorch_toolbelt_tpu_torch.ops import conv3x3, grid_merge

    forward = image_forward(model_bf16, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    check = torch.rand(3, UNET34_CHECK_SIZE, UNET34_CHECK_SIZE, device=dev, generator=gen)
    runs = (("distributed", DIST_BATCH), ("full", FULL_BATCH))
    torch.cuda.synchronize()
    _reset_conv_counts()
    _reset_merge_counts()
    outs = {mode: tiled_apply_d4_tta(forward, check, TILE, STEP, weight="pyramid", batch_size=batch, mode=mode)
            for mode, batch in runs}
    torch.cuda.synchronize()
    launches = {"grid_merge": grid_merge.launches, "grid_merge_by_route": dict(grid_merge.launches_by_route),
                "conv3x3": conv3x3.launches}
    log(f"[12] ResNet34-UNet main path launches at {UNET34_CHECK_SIZE}^2: {launches}")
    _check_merge_routes(f"[12] {UNET34_CHECK_SIZE}^2 runs", len(runs))
    for mode, batch in runs:
        got = outs.pop(mode).float()
        ref = plain_tiled_d4(model, check, mode)
        err, tol = float((got - ref).abs().max()), PATH_TOL * float(ref.abs().max())
        ok = (got.shape == (CLASSES, UNET34_CHECK_SIZE, UNET34_CHECK_SIZE) and bool(torch.isfinite(got).all())
              and err <= tol)
        log(f"[12] ResNet34-UNet tiled_apply_d4_tta {UNET34_CHECK_SIZE}^2 mode={mode} batch={batch}, bf16 vs the "
            f"plain path on the fp32 model (TF32 off): max|err| {err:.3e} <= {tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the ResNet34-UNet tiled d4 path mode={mode} disagrees with the plain path")
        del got, ref

    image = torch.rand(3, UNET34_SIZE, UNET34_SIZE, device=dev, generator=gen)
    run = lambda: tiled_apply_d4_tta(forward, image, TILE, STEP, weight="pyramid", batch_size=DIST_BATCH,  # noqa: E731
                                     mode="distributed")
    run()  # warm-up: cuDNN picks its algorithms for these shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_merge_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if out.shape != (CLASSES, UNET34_SIZE, UNET34_SIZE) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"the ResNet34-UNet {UNET34_SIZE}^2 run gave a wrong shape or non-finite values")
    del out
    by_route = dict(grid_merge.launches_by_route)
    log(f"[12] ResNet34-UNet tiled_apply_d4_tta {UNET34_SIZE}^2 distributed batch={DIST_BATCH} bf16: {wall:.3f} s, "
        f"{UNET34_SIZE**2 / 1e6 / wall:.2f} MP/s, peak {peak:.2f} GiB allocated; K1 launches by route {by_route} at K = {CLASSES} "
        f"({smi})")
    _check_merge_routes(f"[12] {UNET34_SIZE}^2 distributed", 1)
    launches["grid_merge"] += grid_merge.launches
    for route, n in by_route.items():
        launches["grid_merge_by_route"][route] += n

    _log_profile_by_kind(f"[12] profiled {UNET34_SIZE}^2 distributed run", run, DEVICE_KINDS, smi, top=10)

    slicer = ImageSlicer((UNET34_SIZE, UNET34_SIZE), TILE, STEP, weight="pyramid")
    ty, tx = ((t - TILE) // STEP + 1 for t in slicer.target_shape)
    stack = torch.randn(ty * tx, CLASSES, TILE, TILE, device=dev, generator=gen)
    weight = torch.as_tensor(slicer.weight.astype(np.float32), device=dev)
    _k1_at(stack, weight, (ty, tx, STEP, STEP), (UNET34_SIZE, UNET34_SIZE), (slicer.margin_top, slicer.margin_left), smi)
    return launches


def phase_pad_d2(dev, smi, model, model_bf16):
    """The reference's pad -> TTA -> unpad recipe on one 1000^2 image:
    pad_image_tensor to 1024^2, GeneralizedTTA with the d2 transforms, then
    unpad_image_tensor; bf16 against the fp32 model through four flips
    written here."""
    from pytorch_toolbelt_tpu_torch.inference import (
        GeneralizedTTA,
        d2_image_augment,
        d2_image_deaugment,
        pad_image_tensor,
        unpad_image_tensor,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    x = torch.rand(1, 3, PAD_SIZE, PAD_SIZE, device=dev, generator=gen)
    tta = GeneralizedTTA(image_forward(model_bf16, torch.bfloat16), d2_image_augment, d2_image_deaugment)

    def recipe():
        padded, pad = pad_image_tensor(x, 32)
        return unpad_image_tensor(tta(padded), pad), pad

    with torch.no_grad():
        got, pad = recipe()
        got = got.float()
        margin = (PAD_TARGET - PAD_SIZE) // 2
        padded = F.pad(x, (margin,) * 4)
        flips = ((), (3,), (2,), (2, 3))
        ref = sum(model(padded.flip(dims)).flip(dims) for dims in flips) / len(flips)
        ref = ref[:, :, margin : margin + PAD_SIZE, margin : margin + PAD_SIZE]
        torch.cuda.synchronize()
        err, tol = float((got - ref).abs().max()), PATH_TOL * float(ref.abs().max())
        ok = (pad == (margin,) * 4 and got.shape == (1, CLASSES, PAD_SIZE, PAD_SIZE)
              and bool(torch.isfinite(got).all()) and err <= tol)
        log(f"[13] pad_image_tensor({PAD_SIZE}^2 -> {PAD_TARGET}^2, pad {pad}) -> GeneralizedTTA(d2) -> "
            f"unpad_image_tensor, ResNet34-UNet bf16 vs four flips of the fp32 model (TF32 off): max|err| {err:.3e} "
            f"<= {tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the pad -> d2 TTA -> unpad recipe disagrees with the explicit flips")
        del got, ref, padded
        ms = cuda_ms(recipe, reps=3, windows=3)
    log(f"[13] pad -> d2 TTA -> unpad bf16: {ms} per call ({smi})")


def config5_head(x):
    """A cheap pixelwise 19-channel head: the memory is in the stack and the canvas."""
    return torch.cat([x, x * 2.0, x * x, -x, x + 1.0, x * 0.5, x.flip(1)], dim=1)[:, :CLASSES]


class _CountedViews:
    """A model function that counts the images it is given."""

    def __init__(self, fn):
        self.fn, self.images = fn, 0

    def __call__(self, x):
        self.images += len(x)
        return self.fn(x)


@torch.no_grad()
def phase_config5(dev, smi, fused):
    """BASELINE config 5 through ``tiled_apply_sharded`` under a real nccl
    group of world size 1: the strips canvas against the single-chip call
    bit for bit, timed and profiled; four strips one after another against
    it bit for bit; the replicated canvas (K3 + all_reduce) against it; the
    K = 19 memory of world 1 against one strip of four; K1 alone at the
    10000^2 shape.  Returns the launches of K2, K1 and K3 in its runs."""
    import tempfile

    from pytorch_toolbelt_tpu_torch.distributed import DistributedGuard, get_world_size, read_sharded_window
    from pytorch_toolbelt_tpu_torch.distributed import tiled_apply_sharded
    from pytorch_toolbelt_tpu_torch.inference import ImageSlicer, tiled_apply_d4_tta
    from pytorch_toolbelt_tpu_torch.ops import accumulate_tiles, conv3x3, grid_merge

    size, mp = CONFIG5_SIZE, CONFIG5_SIZE**2 / 1e6
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    image = torch.rand(3, size, size, device=dev, generator=gen)
    kw = dict(tile_size=TILE, tile_step=STEP, weight="pyramid", batch_size=CONFIG5_BATCH)

    def model(x):  # config 5 returns the fp32 canvas, as the JAX pipeline does
        return fused(x).float()

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30

    launches = {"grid_merge": 0, "grid_merge_by_route": dict.fromkeys(grid_merge.launches_by_route, 0),
                "scatter_merge": 0}

    def add_merge_launches():
        launches["grid_merge"] += grid_merge.launches
        for route, n in grid_merge.launches_by_route.items():
            launches["grid_merge_by_route"][route] += n

    with tempfile.TemporaryDirectory() as tmp, DistributedGuard(f"file://{tmp}/store", world_size=1, rank=0,
                                                                backend="nccl", timeout_s=300):
        if torch.distributed.get_backend() != "nccl" or get_world_size() != 1:
            raise AssertionError("phase 14 needs an nccl group of world size 1")
        single = tiled_apply_d4_tta(model, image, mode="distributed", **kw)
        run = lambda **extra: tiled_apply_sharded(model, image, d4_tta="distributed", **kw, **extra)  # noqa: E731
        run()  # warm-up
        _reset_conv_counts()
        _reset_merge_counts()
        strips, wall, peak = timed(run)
        log(f"[14] config 5: tiled_apply_sharded {size}^2 strips, nccl world 1, d4 distributed batch={CONFIG5_BATCH}, "
            f"UNet-32 fused bf16, fp32 canvas: {wall:.3f} s, {mp / wall:.2f} MP/s, peak {peak:.2f} GiB allocated; "
            f"K2 launches by route {dict(conv3x3.launches_by_route)}, K1 {dict(grid_merge.launches_by_route)} ({smi})")
        _check_conv_routes("[14] world 1 strips")
        _check_merge_routes("[14] world 1 strips", 1)
        launches["conv3x3"], launches["conv3x3_by_route"] = conv3x3.launches, dict(conv3x3.launches_by_route)
        add_merge_launches()
        ok = strips.shape == (1, size, size) and bool(torch.isfinite(strips).all()) and torch.equal(strips, single)
        log(f"[14] world 1 strips vs tiled_apply_d4_tta(mode='distributed', batch_size={CONFIG5_BATCH}): "
            f"{'bit for bit' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the world-1 strips differ from the single-chip tiled_apply_d4_tta")
        del single

        _log_profile_by_kind("[14] profiled world-1 strips run", run, CONFIG5_KINDS, smi, top=8)

        slicer = ImageSlicer((size, size), TILE, STEP, weight="pyramid")
        ty, tx = ((t - TILE) // STEP + 1 for t in slicer.target_shape)
        parts, tiles_run, total_wall = [], 0, 0.0
        for d in range(CONFIG5_STRIPS):
            counted = _CountedViews(model)
            _reset_merge_counts()
            part, wall_d, peak_d = timed(lambda: tiled_apply_sharded(counted, image, d4_tta="distributed", rank=d,
                                                                     world_size=CONFIG5_STRIPS, **kw))
            _check_merge_routes(f"[14] strip {d} of {CONFIG5_STRIPS}", 1)
            add_merge_launches()
            tiles_d = counted.images // 2  # two d4 views per tile
            tiles_run, total_wall = tiles_run + tiles_d, total_wall + wall_d
            log(f"[14] strip {d} of {CONFIG5_STRIPS}: rows {tuple(part.shape[1:])}, {tiles_d} tiles "
                f"({tiles_d // tx} tile rows), {wall_d:.3f} s, peak {peak_d:.2f} GiB allocated, K1 "
                f"{dict(grid_merge.launches_by_route)} ({smi})")
            parts.append(part)
        four = torch.cat(parts, dim=1)
        del parts
        ok = torch.equal(four, strips)
        log(f"[14] {CONFIG5_STRIPS} strips one after another: {total_wall:.3f} s ({total_wall / wall:.2f}x world 1), "
            f"{tiles_run // tx} tile rows run against {ty} ({tiles_run} tiles against {ty * tx}, "
            f"{tiles_run / (ty * tx) - 1:.1%} duplicated); concatenated vs world 1: {'bit for bit' if ok else 'FAIL'}")
        if not ok:
            bad = (four != strips).nonzero()
            raise AssertionError(f"the {CONFIG5_STRIPS} strips differ from world 1 at {bad.shape[0]} pixels, "
                                 f"first at {bad[0].tolist()}: a tile's output depends on its batch")
        del four

        rep_run = lambda: run(canvas="replicated")  # noqa: E731
        rep_run()  # warm-up: the plan's inverse norm is computed on the host once
        accumulate_tiles.launches = 0
        replicated, wall_r, peak_r = timed(rep_run)
        launches["scatter_merge"] += accumulate_tiles.launches
        err = float((replicated - strips).abs().max())
        tol = REPLICATED_TOL * float(strips.abs().max())
        ok = replicated.shape == strips.shape and err <= tol
        log(f"[14] replicated canvas, nccl world 1: {wall_r:.3f} s, {mp / wall_r:.2f} MP/s, peak {peak_r:.2f} GiB "
            f"allocated, K3 launches {accumulate_tiles.launches}; vs strips max|err| {err:.3e} <= {tol:.3e} "
            f"{'ok' if ok else 'FAIL'} ({smi})")
        if not ok or accumulate_tiles.launches == 0:
            raise AssertionError("the replicated canvas disagrees with the strips or never launched K3")
        del replicated, strips

        c = size // 2  # an interior 100x100 window from the centre
        want = config5_head(image[None, :, c : c + 100, c : c + 100])[0]
        whole, wall_19, peak_19 = timed(lambda: tiled_apply_sharded(config5_head, image, **kw))
        err_whole = float((whole[:, c : c + 100, c : c + 100] - want).abs().max())
        del whole
        rank = c // -(-size // CONFIG5_STRIPS)
        strip, wall_s19, peak_s19 = timed(lambda: tiled_apply_sharded(config5_head, image, rank=rank,
                                                                      world_size=CONFIG5_STRIPS, **kw))
        got = read_sharded_window(strip, c, c + 100, c, c + 100, rank=rank, world_size=CONFIG5_STRIPS,
                                  image_height=size)
        err_strip = float((got - want).abs().max())
        del strip
        ok = max(err_whole, err_strip) <= WINDOW_TOL
        log(f"[14] K = {CLASSES} pixelwise head, no TTA: world 1 {wall_19:.3f} s, peak {peak_19:.2f} GiB allocated; "
            f"strip {rank} of {CONFIG5_STRIPS} {wall_s19:.3f} s, peak {peak_s19:.2f} GiB allocated; window "
            f"[{c}:{c + 100}]^2 vs the head's direct output: max|err| {err_whole:.3e} (world 1), {err_strip:.3e} "
            f"(read_sharded_window of the strip) <= {WINDOW_TOL:.0e} {'ok' if ok else 'FAIL'} ({smi})")
        if not ok:
            raise AssertionError("the K = 19 head's tiled output disagrees with its direct output")
    if torch.distributed.is_initialized():
        raise AssertionError("DistributedGuard left the process group alive")

    stack = torch.randn(ty * tx, 1, TILE, TILE, device=dev, generator=gen)
    weight = torch.as_tensor(slicer.weight.astype(np.float32), device=dev)
    _k1_at(stack, weight, (ty, tx, STEP, STEP), (size, size), (slicer.margin_top, slicer.margin_left), smi, "[14]")
    return launches


@torch.no_grad()
def plain_tiled_3d(net, volume, size, step):
    """Plain path: tile by tile through the module, float64 merge."""
    from pytorch_toolbelt_tpu_torch.inference import VolumeSlicer

    slicer = VolumeSlicer(volume.shape[1:], size, step, weight="pyramid")
    padded = F.pad(volume, (slicer.margin_left, slicer.margin_right, slicer.margin_top, slicer.margin_bottom,
                            slicer.margin_front, slicer.margin_back))
    weight = torch.as_tensor(slicer.weight, dtype=torch.float64, device=volume.device)
    canvas = norm = None
    for z, y, x, d, h, w in slicer.crops:
        pred = net(padded[None, :, z : z + d, y : y + h, x : x + w])[0].double()
        if canvas is None:
            canvas = torch.zeros((pred.shape[0],) + slicer.target_shape, dtype=torch.float64, device=volume.device)
            norm = torch.zeros(slicer.target_shape, dtype=torch.float64, device=volume.device)
        canvas[:, z : z + d, y : y + h, x : x + w] += pred * weight
        norm[z : z + d, y : y + h, x : x + w] += weight
    return slicer.crop_to_original_size(canvas / norm).float()


@torch.no_grad()
def phase_ensemble_3d(dev, smi, model, fused):
    """The rest of inference/: an Ensembler of two fused UNet-32s as the
    model of tiled d4 inference at 2048^2, and tiled_apply_3d of a small
    Conv3d net over a [1, 128, 512, 512] volume."""
    from pytorch_toolbelt_tpu_torch.inference import Ensembler, tiled_apply_3d, tiled_apply_d4_tta
    from pytorch_toolbelt_tpu_torch.zoo import fuse_unet_inference

    model_b = seeded_unet(SEED + 17, dev)
    ensemble = Ensembler([fused, fuse_unet_inference(model_b)])
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    image = torch.rand(3, ENSEMBLE_SIZE, ENSEMBLE_SIZE, device=dev, generator=gen)
    run = lambda: tiled_apply_d4_tta(ensemble, image, TILE, STEP, batch_size=DIST_BATCH, mode="distributed")  # noqa: E731
    got = run().float()
    ref = (plain_tiled_d4(model, image, "distributed") + plain_tiled_d4(model_b, image, "distributed")) / 2
    err, tol = float((got - ref).abs().max()), PATH_TOL * float(ref.abs().max())
    ok = got.shape == ref.shape and bool(torch.isfinite(got).all()) and err <= tol
    ms = cuda_ms(run, reps=1, windows=3)
    log(f"[15] Ensembler of two fused UNet-32s in tiled_apply_d4_tta {ENSEMBLE_SIZE}^2 distributed batch={DIST_BATCH}: "
        f"vs the mean of the two fp32 plain paths max|err| {err:.3e} <= {tol:.3e} {'ok' if ok else 'FAIL'}; "
        f"{ms} per call ({smi})")
    if not ok:
        raise AssertionError("the ensemble's tiled output disagrees with the plain paths")
    del got, ref, model_b, ensemble

    torch.manual_seed(SEED + 19)
    net = torch.nn.Sequential(torch.nn.Conv3d(1, 8, 3, padding=1), torch.nn.ReLU(), torch.nn.Conv3d(8, 2, 1))
    pointwise = torch.nn.Conv3d(1, 2, 1)
    net, pointwise = net.to(dev).eval(), pointwise.to(dev).eval()
    volume = torch.rand(*VOLUME_SHAPE, device=dev, generator=gen)
    for name, fn, want in (("Conv3d 3^3 net", net, lambda: plain_tiled_3d(net, volume, VOXEL_TILE, VOXEL_STEP)),
                           ("pointwise Conv3d", pointwise, lambda: pointwise(volume[None])[0])):
        run = lambda fn=fn: tiled_apply_3d(fn, volume, VOXEL_TILE, VOXEL_STEP, batch_size=VOXEL_BATCH)  # noqa: E731
        got, ref = run(), want()
        err, tol = float((got - ref).abs().max()), VOLUME_TOL * float(ref.abs().max())
        ok = got.shape == ref.shape and bool(torch.isfinite(got).all()) and err <= tol
        ms = cuda_ms(run, reps=1, windows=3)
        log(f"[15] tiled_apply_3d {name} over {list(VOLUME_SHAPE)} at {VOXEL_TILE}/{VOXEL_STEP} batch={VOXEL_BATCH}: "
            f"vs {'the plain tile-by-tile path' if fn is net else 'its direct output'} max|err| {err:.3e} <= "
            f"{tol:.3e} {'ok' if ok else 'FAIL'}; {ms} per call ({smi})")
        if not ok:
            raise AssertionError(f"tiled_apply_3d with the {name} disagrees with its reference")


# ---------------------------------------------------------------------------
# Phase 16: int8 inference (Q1, Q2, Q3) -- the integer UNet-32 through config 2's pipeline, the integer
# SEResNeXt50-FPN(128) at 1024^2
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _checked_calls(name: str, check, module=None):
    """While the block runs, hold the int8 forwards' calls of Q1, Q2 or Q3
    (``qconv2d``, ``q_upsample`` or ``q_upsample_cat`` as
    ``zoo/quantized_unet.py`` calls them, or ``q_add`` as ``module``,
    ``zoo/quantized_encdec.py``, calls it)
    against their plain versions as the main path makes them: at the first
    call of each distinct shape (a gate or none, ReLU or not), ``check(args,
    kwargs)`` runs on that call's own inputs, so no input outlives its call.
    Yields {shape: [check's record, calls]}."""
    from pytorch_toolbelt_tpu_torch.zoo import quantized_unet

    qu = quantized_unet if module is None else module
    real, seen = getattr(qu, name), {}

    def wrapped(*args, **kwargs):
        key = tuple((tuple(a.shape), a.dtype) if isinstance(a, (torch.Tensor, np.ndarray)) else
                    (tuple(a.weight.shape), a.groups) if hasattr(a, "groups") else a for a in args)
        key += tuple(sorted((k, v) for k, v in kwargs.items() if k == "relu"))
        if key not in seen:
            seen[key] = [check(args, kwargs), 0]
        seen[key][1] += 1
        return real(*args, **kwargs)

    setattr(qu, name, wrapped)
    try:
        yield seen
    finally:
        setattr(qu, name, real)


@contextlib.contextmanager
def _plain_kernels():
    """The int8 forwards with Q1 and Q2 replaced by their plain versions."""
    from pytorch_toolbelt_tpu_torch.ops import q_upsample_cat_reference, q_upsample_reference, qconv2d_reference
    from pytorch_toolbelt_tpu_torch.zoo import quantized_unet as qu

    real = qu.qconv2d, qu.q_upsample, qu.q_upsample_cat
    qu.qconv2d = lambda x, weight, stride, padding, epilogue, **kw: qconv2d_reference(
        x, weight.weight, stride, padding, weight.groups, epilogue, **kw)
    qu.q_upsample = lambda x, mh, mw, taps=None: q_upsample_reference(x, mh, mw)
    qu.q_upsample_cat = lambda x, skip, mh, mw, taps=None: q_upsample_cat_reference(x, skip, mh, mw)
    try:
        yield
    finally:
        qu.qconv2d, qu.q_upsample, qu.q_upsample_cat = real


INT8_KERNELS = ("qconv2d", "q_upsample", "q_upsample_cat", "q_add")


def _reset_int8_counts():
    from pytorch_toolbelt_tpu_torch import ops

    for name in INT8_KERNELS:
        fn = getattr(ops, name)
        fn.launches = 0
        for route in fn.launches_by_route:
            fn.launches_by_route[route] = 0
    ops.q_add.gated = 0


def _int8_counts() -> dict:
    from pytorch_toolbelt_tpu_torch import ops

    counts = {}
    for name in INT8_KERNELS + ("grid_merge",):
        fn = getattr(ops, name)
        counts[name], counts[f"{name}_by_route"] = fn.launches, dict(fn.launches_by_route)
    counts["q_add_gated"] = ops.q_add.gated
    return counts


def _by_chunks(fn, x, *args, **kwargs):
    """A plain version over x's batch in chunks of INT8_PLAIN_CHUNK samples:
    the same values (every sample is its own), in a bounded float64 memory."""
    return torch.cat([fn(x[i:i + INT8_PLAIN_CHUNK], *args, **kwargs) for i in range(0, x.shape[0], INT8_PLAIN_CHUNK)])


def _int_mm_ms(x, weight, stride, padding):
    """(ms, what was timed) of one ``torch._int_mm`` (cuBLASLt int8 ->
    int32) computing the conv's accumulator with the same weights: for a 1x1
    stride-1 conv on x's own channels_last storage viewed as [B*H*W, C_in]
    (the same product, with nothing else to do); else on the im2col of x,
    made (in batch chunks) before the timing and not in it, K and N padded to
    multiples of 8 as ``_int_mm`` needs.  (None, why) where no single call
    computes the conv (groups > 1) or it does not fit."""
    if weight.groups != 1:
        return None, "groups > 1: no single library call"
    b, c_in, c_out = x.shape[0], x.shape[1], weight.weight.shape[0]
    kh, kw = weight.weight.shape[2:]
    top, bottom, left, right = padding
    if (kh, kw, stride, top, bottom, left, right) == (1, 1, 1, 0, 0, 0, 0) and c_in % 8 == 0 and c_out % 8 == 0:
        a = x.permute(0, 2, 3, 1).reshape(-1, c_in)  # a view: the storage of a channels_last tensor
        w = weight.weight.reshape(c_out, c_in)
        how = "on x's storage as [B*H*W, C_in], no im2col"
        return cuda_ms(lambda: torch._int_mm(a, w.t()), reps=INT8_Q1_REPS), how
    ho = (x.shape[2] + top + bottom - kh) // stride + 1
    wo = (x.shape[3] + left + right - kw) // stride + 1
    k, n = x.shape[1] * kh * kw, -(-c_out // 8) * 8
    if b * ho * wo * (-(-k // 8) * 8 + 4 * n) > INT8_INT_MM_BYTES:
        log(f"[16]   torch._int_mm not timed: its operands would pass {INT8_INT_MM_BYTES / 2**30:.0f} GiB")
        return None, "not timed"
    a = torch.zeros(b * ho * wo, -(-k // 8) * 8, dtype=torch.int8, device=x.device)
    for i in range(0, b, INT8_PLAIN_CHUNK):
        cols = F.unfold(F.pad(x[i:i + INT8_PLAIN_CHUNK].half(), (left, right, top, bottom)), (kh, kw),
                        stride=stride)  # exact for int8 values
        a[i * ho * wo:(i + cols.shape[0]) * ho * wo, :k] = cols.transpose(1, 2).reshape(-1, k).to(torch.int8)
        del cols
    w = torch.zeros(n, a.shape[1], dtype=torch.int8, device=x.device)
    w[:c_out, :k] = weight.weight.reshape(c_out, -1)
    try:
        return cuda_ms(lambda: torch._int_mm(a, w.t()), reps=INT8_Q1_REPS), "on the im2col, im2col not timed"
    except RuntimeError as exc:
        log(f"[16]   torch._int_mm refused [{a.shape[0]}, {a.shape[1]}] x [{a.shape[1]}, {n}]: {exc}")
        return None, "refused"


def _q1_class(kh: int, kw: int, stride: int, groups: int, ci_pg: int) -> str:
    """The class of conv a Q1 call belongs to, by its shape."""
    if (kh, kw) == (1, 1):
        return f"1x1 stride {stride}"
    if groups > 1:
        return f"grouped 3x3 width {ci_pg} stride {stride}"
    return f"{kh}x{kw} stride {stride}" + (" (stem)" if ci_pg <= 4 else "")


def _q1_expected_routes(kh: int, kw: int, stride: int, groups: int, padding) -> tuple:
    """The routes the int8 forwards' convs must take since the 1x1 and grouped
    routes exist: the 3x3 stride-1 pad-1 groups-1 convs a 3x3 wgmma route, the
    1x1 and grouped 3x3 convs theirs, the 7x7 stem the mma.sync kernel's
    byte gather; () where the phase expects nothing."""
    if (kh, kw, stride, groups) == (3, 3, 1, 1) and tuple(padding) == (1, 1, 1, 1):
        return "tma_wgmma", "ld_wgmma"
    if (kh, kw, groups) == (1, 1, 1):
        return ("gemm_wgmma",)
    if (kh, kw) == (3, 3) and groups > 1:
        return ("grouped_wgmma",)
    return ("mma_v1",) if (kh, kw) == (7, 7) else ()


def _check_q1(what: str, timed: bool, with_k2: bool = False, strict: bool = True):
    """A check for ``_checked_calls("qconv2d", ...)``: Q1 against
    ``qconv2d_reference`` bit for bit on the call's own inputs and, if
    ``timed``, Q1's time beside its bound, its plain version,
    ``torch._int_mm`` and (with_k2: the UNet's 3x3 stride-1 shapes) the bf16
    K2 at the same shape.  With ``strict``, a call that took another route
    than :func:`_q1_expected_routes` names fails it."""
    from pytorch_toolbelt_tpu_torch.ops import conv3x3, pack_conv3x3_weights, qconv2d, qconv2d_reference

    def check(args, kwargs):
        x, weight, stride, padding, epilogue = args
        plain = lambda: _by_chunks(qconv2d_reference, x, weight.weight, stride, padding, weight.groups,  # noqa: E731
                                   epilogue, **kwargs)
        before = dict(qconv2d.launches_by_route)
        got = qconv2d(*args, **kwargs)
        route = next(r for r, n in qconv2d.launches_by_route.items() if n != before[r])
        want = plain()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        b, c_in, h, w = x.shape
        c_out, ci_pg, kh, kw = weight.weight.shape
        shape = (f"{c_in}->{c_out} {kh}x{kw}/{stride} g{weight.groups} @{h}x{w} batch {b} {epilogue}"
                 f"{' relu' if kwargs.get('relu') else ''}")
        if got.dtype != want.dtype or got.shape != want.shape or err != 0:
            raise AssertionError(f"{what}: qconv2d {shape} disagrees with qconv2d_reference (max |err| {err})")
        del want
        expected = _q1_expected_routes(kh, kw, stride, weight.groups, padding)
        if strict and expected and route not in expected:
            raise AssertionError(f"{what}: qconv2d {shape} took the route {route}, not {' or '.join(expected)}")
        record = {"max_abs_err": err, "route": route, "shape": shape,
                  "cls": _q1_class(kh, kw, stride, weight.groups, ci_pg)}
        if not timed:
            return record
        ho, wo = got.shape[2:]
        nbytes = x.numel() + weight.weight.numel() + got.numel() * got.element_size()
        ops = 2.0 * b * ho * wo * c_out * ci_pg * kh * kw
        del got
        record["bound"], record["bound_by"] = bound_ms(nbytes, ops, INT8_PEAK)
        record["ms"] = cuda_ms(lambda: qconv2d(*args, **kwargs), reps=INT8_Q1_REPS)
        record["plain_ms"] = cuda_ms(plain, reps=1, windows=1, warmup=0)
        record["library_ms"], how = _int_mm_ms(x, weight, stride, padding)
        record["lib"] = how if record["library_ms"] is None else f"{record['library_ms']:.3f} ms {how}"
        record["ops"] = ops
        if with_k2 and (kh, kw, stride, weight.groups) == (3, 3, 1, 1):
            xb = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            wb = pack_conv3x3_weights(weight.weight.float())
            ones, zeros = torch.ones(c_out, device=x.device), torch.zeros(c_out, device=x.device)
            record["k2_ms"] = cuda_ms(lambda: conv3x3(xb, wb, ones, zeros, relu=bool(kwargs.get("relu"))), reps=3)
            del xb
        return record

    return check


def _route_of(fn, call):
    """``call()``'s result and the route of ``fn`` (a kernel wrapper) that it launched."""
    before = dict(fn.launches_by_route)
    out = call()
    return out, next(r for r, n in fn.launches_by_route.items() if n != before[r])


def _check_q2(timed: bool):
    """A check for ``_checked_calls("q_upsample", ...)``: Q2 against
    ``q_upsample_reference`` bit for bit on the call's own inputs, on the
    banded route, and, if ``timed``, its time beside its bound, its plain
    version and bf16 ``F.interpolate`` of the same tensor."""
    from pytorch_toolbelt_tpu_torch.ops import q_upsample, q_upsample_reference

    def check(args, kwargs):
        x, mh, mw = args
        got, route = _route_of(q_upsample, lambda: q_upsample(*args, **kwargs))
        want = _by_chunks(q_upsample_reference, x, mh, mw)
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        shape = f"{list(x.shape)} -> {list(got.shape[2:])}"
        if got.shape != want.shape or err != 0:
            raise AssertionError(f"q_upsample {shape} disagrees with q_upsample_reference (max |err| {err})")
        if route != "banded":
            raise AssertionError(f"q_upsample {shape} took the route {route}, not banded")
        record = {"max_abs_err": err, "route": route, "shape": shape}
        if not timed:
            return record
        record["bound"], _ = bound_ms(x.numel() + got.numel())
        record["bytes"] = x.numel() + got.numel()
        record["ms"] = cuda_ms(lambda: q_upsample(*args, **kwargs), reps=5)
        record["plain_ms"] = cuda_ms(lambda: _by_chunks(q_upsample_reference, x, mh, mw), reps=1, windows=1,
                                     warmup=0)
        xb = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        record["bf16_ms"] = cuda_ms(lambda: F.interpolate(xb, size=got.shape[2:], mode="bilinear",
                                                          align_corners=True), reps=5)
        return record

    return check


def _check_q2_cat(timed: bool):
    """A check for ``_checked_calls("q_upsample_cat", ...)``: the decoder
    input on Q2 against ``q_upsample_cat_reference`` bit for bit on the
    call's own inputs, and Q2 alone on the same x against the reference's
    upsampled channels, both on the banded route; if ``timed``, both
    kernels' times beside their byte bounds, the yardstick (Q2 alone, then
    ``torch.cat`` with the skip: the decoder before it was fused) and the
    plain version once."""
    from pytorch_toolbelt_tpu_torch.ops import q_upsample, q_upsample_cat, q_upsample_cat_reference
    from pytorch_toolbelt_tpu_torch.ops import q_upsample_reference

    def check(args, kwargs):
        x, skip, mh, mw = args
        taps = kwargs.get("taps")
        plain = lambda: torch.cat([  # noqa: E731
            q_upsample_cat_reference(x[i:i + INT8_PLAIN_CHUNK], skip[i:i + INT8_PLAIN_CHUNK], mh, mw)
            for i in range(0, x.shape[0], INT8_PLAIN_CHUNK)])
        got, route = _route_of(q_upsample_cat, lambda: q_upsample_cat(*args, **kwargs))
        alone, route_alone = _route_of(q_upsample, lambda: q_upsample(x, mh, mw, taps=taps))
        want = plain()
        c = x.shape[1]
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        err_alone = int((alone.to(torch.int32) - want[:, :c].to(torch.int32)).abs().max())
        shape = f"{list(x.shape)} -> {list(got.shape[2:])} + skip {skip.shape[1]}"
        if got.shape != want.shape or alone.shape != want[:, :c].shape or max(err, err_alone) != 0:
            raise AssertionError(f"q_upsample_cat {shape} disagrees with q_upsample_cat_reference (max |err| {err}; "
                                 f"q_upsample alone {err_alone})")
        if (route, route_alone) != ("banded", "banded"):
            raise AssertionError(f"q_upsample_cat {shape} took the routes {route}, {route_alone}, not banded")
        del want
        record = {"max_abs_err": max(err, err_alone), "route": route, "shape": shape}
        if not timed:
            return record
        record["bytes"], record["bytes_alone"] = x.numel() + skip.numel() + got.numel(), x.numel() + alone.numel()
        record["bound"], record["bound_alone"] = bound_ms(record["bytes"])[0], bound_ms(record["bytes_alone"])[0]
        del got
        record["ms"] = cuda_ms(lambda: q_upsample_cat(*args, **kwargs), reps=5)
        record["alone_ms"] = cuda_ms(lambda: q_upsample(x, mh, mw, taps=taps), reps=5)
        record["cat_ms"] = cuda_ms(lambda: torch.cat([alone, skip], dim=1).contiguous(
            memory_format=torch.channels_last), reps=5)
        record["plain_ms"] = cuda_ms(plain, reps=1, windows=1, warmup=0)
        record["plain_alone_ms"] = cuda_ms(lambda: _by_chunks(q_upsample_reference, x, mh, mw), reps=1, windows=1,
                                           warmup=0)
        return record

    return check


def _check_q3(timed: bool):
    """A check for ``_checked_calls("q_add", ..., module=quantized_encdec)``:
    Q3 against ``q_add_reference`` bit for bit on the call's own inputs, its
    SE gate included where it has one, on the ``vec16`` route; if ``timed``,
    its time beside its byte bound (a, b and the sum once) and its plain
    version's."""
    from pytorch_toolbelt_tpu_torch.ops import q_add, q_add_reference

    def check(args, kwargs):
        a, _, _, _, relu, gate = (*args, kwargs.get("gate"))[:6]
        got, route = _route_of(q_add, lambda: q_add(*args, **kwargs))
        want = q_add_reference(*args, **kwargs)
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        shape = f"{'gated ' if gate is not None else ''}{'ReLU ' if relu else ''}{list(a.shape)}"
        if got.shape != want.shape or err != 0:
            raise AssertionError(f"q_add {shape} disagrees with q_add_reference (max |err| {err})")
        if route != "vec16":
            raise AssertionError(f"q_add {shape} took the route {route}, not vec16")
        del want
        record = {"max_abs_err": err, "route": route, "shape": shape, "gated": gate is not None}
        if not timed:
            return record
        record["bytes"] = 3 * a.numel()
        record["bound"] = bound_ms(record["bytes"])[0]
        record["ms"] = cuda_ms(lambda: q_add(*args, **kwargs), reps=5)
        record["plain_ms"] = cuda_ms(lambda: q_add_reference(*args, **kwargs), reps=1, windows=1, warmup=0)
        return record

    return check


def _q1_totals(seen: dict, what: str) -> dict:
    """Q1's checked shapes of one run: a log line each, and the run's sums
    (each shape's time times its calls)."""
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "operations": 0.0, "library_ms": 0.0, "k2_ms": 0.0,
             "max_abs_err": 0, "shapes": len(seen), "calls": sum(n for _, n in seen.values()), "routes": {}}
    for r, n in seen.values():
        total["max_abs_err"] = max(total["max_abs_err"], r["max_abs_err"])
        if "ms" not in r:
            log(f"[16] qconv2d {what} {r['shape']} (x{n}) route {r['route']}: bit-equal to qconv2d_reference")
            continue
        ms = r["ms"]
        route = total["routes"].setdefault(r["route"], {"calls": 0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0.0,
                                                        "operations": 0.0, "library_ms": 0.0})
        for sums in (total, route):
            for key in ("ms", "plain_ms", "k2_ms"):
                if key in sums:
                    sums[key] += n * r.get(key, 0.0)
            sums[r["bound_by"]] += n * r["bound"]
            sums["library_ms"] = None if r["library_ms"] is None or sums["library_ms"] is None else \
                sums["library_ms"] + n * r["library_ms"]
        route["calls"] += n
        k2 = f"; bf16 K2 at the shape {r['k2_ms']:.3f} ms" if "k2_ms" in r else ""
        log(f"[16] qconv2d {what} {r['shape']} (x{n}) route {r['route']}: bit-equal to qconv2d_reference; kernel "
            f"{ms} ({r['ops'] / ms / 1e9:.1f} TOP/s), bound {r['bound']:.3f} ms ({r['bound_by']}) = "
            f"{r['bound'] / ms:.1%} of the kernel; plain version (in batch chunks of {INT8_PLAIN_CHUNK}) "
            f"{r['plain_ms']:.3f} ms; torch._int_mm {r['lib']}{k2}")
    return total


def _q1_classes(seen: dict, what: str, smi: str) -> dict:
    """Q1's timed calls of one run summed by class of conv (each shape's time
    times its calls), a log line each: {class: sums}."""
    classes = {}
    for r, n in seen.values():
        c = classes.setdefault(r["cls"], {"calls": 0, "ms": 0.0, "bound": 0.0, "bytes": 0.0, "operations": 0.0,
                                          "plain_ms": 0.0, "library_ms": 0.0, "library_calls": 0, "routes": {}})
        c["calls"] += n
        c["routes"][r["route"]] = c["routes"].get(r["route"], 0) + n
        if "ms" not in r:
            continue
        c["ms"] += n * r["ms"]
        c["bound"] += n * r["bound"]
        c[r["bound_by"]] += n * r["bound"]
        c["plain_ms"] += n * r["plain_ms"]
        if r["library_ms"] is not None:
            c["library_ms"] += n * r["library_ms"]
            c["library_calls"] += n
    for name, c in sorted(classes.items()):
        lib = (f"{c['library_ms']:.3f} ms ({c['library_calls']} of {c['calls']} calls)" if c["library_calls"]
               else "none")
        log(f"[16] Q1 by class, {what}: {name}: {c['calls']} calls on {c['routes']}: kernel {c['ms']:.3f} ms, bound "
            f"{c['bound']:.3f} ms (bytes {c['bytes']:.3f}, operations {c['operations']:.3f}) = "
            f"{c['bound'] / c['ms'] if c['ms'] else 0.0:.1%} of the kernel; plain version {c['plain_ms']:.2f} ms; "
            f"torch._int_mm {lib} ({smi})")
    return classes


def _check_q1_routes(seen: dict, by_route: dict, what: str, stems_alone_on_mma: bool = False) -> None:
    """A counted run's Q1 launches by route against the routes the checked
    run's calls took (each held to its class's routes by ``_check_q1``);
    with ``stems_alone_on_mma``, the mma.sync kernel must have run the 7x7
    stems and nothing else."""
    want = dict.fromkeys(by_route, 0)
    for r, n in seen.values():
        want[r["route"]] += n
    if dict(by_route) != want:
        raise AssertionError(f"{what}: Q1 launched {by_route}, the checked run's calls took {want}")
    mma = {route: n for route, n in by_route.items() if route.startswith("mma") and n}
    stems = sum(n for r, n in seen.values() if r["cls"].endswith("(stem)"))
    if stems_alone_on_mma and mma != {"mma_v1": stems}:
        raise AssertionError(f"{what}: the mma.sync kernel ran {mma}, not the {stems} stems alone")
    log(f"[16] qconv2d {what}: launches by route {dict(by_route)}, as the checked run's calls took them")


def _q2_totals(seen: dict) -> dict:
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bf16_ms": 0.0, "max_abs_err": 0,
             "calls": sum(n for _, n in seen.values())}
    for r, n in seen.values():
        total["max_abs_err"] = max(total["max_abs_err"], r["max_abs_err"])
        if "ms" not in r:
            log(f"[16] q_upsample {r['shape']} (x{n}) route {r['route']}: bit-equal to q_upsample_reference")
            continue
        for key, value in (("ms", r["ms"]), ("plain_ms", r["plain_ms"]), ("bound_ms", r["bound"]),
                           ("bf16_ms", r["bf16_ms"])):
            total[key] += n * value
        log(f"[16] q_upsample {r['shape']} (x{n}) route {r['route']}: bit-equal to q_upsample_reference; kernel "
            f"{r['ms']} = {r['bytes'] / r['ms'] / 1e6:.0f} GB/s, bound {r['bound']:.3f} ms (bytes) = "
            f"{r['bound'] / r['ms']:.1%} of the kernel; plain version {r['plain_ms']:.3f} ms; bf16 F.interpolate "
            f"of the same tensor (another function, for scale) {r['bf16_ms']:.3f} ms")
    return total


def _q2_cat_totals(seen: dict) -> dict:
    """The decoder inputs of one run: a log line per checked shape, and the
    run's sums (each shape's time times its calls)."""
    keys = ("ms", "alone_ms", "cat_ms", "plain_ms", "plain_alone_ms", "bound", "bound_alone", "bytes", "bytes_alone")
    total = {**dict.fromkeys(keys, 0.0), "max_abs_err": 0, "calls": sum(n for _, n in seen.values())}
    for r, n in seen.values():
        total["max_abs_err"] = max(total["max_abs_err"], r["max_abs_err"])
        if "ms" not in r:
            log(f"[16] q_upsample_cat {r['shape']} (x{n}) route {r['route']}: bit-equal to q_upsample_cat_reference, "
                "q_upsample alone on the same x to its upsampled channels")
            continue
        for key in keys:
            total[key] += n * r[key]
        log(f"[16] q_upsample_cat {r['shape']} (x{n}) route {r['route']}: bit-equal to q_upsample_cat_reference; "
            f"kernel {r['ms']} = {r['bytes'] / r['ms'] / 1e6:.0f} GB/s, bound {r['bound']:.3f} ms (bytes: x, skip, "
            f"output) = {r['bound'] / r['ms']:.1%} of the kernel; q_upsample alone on the same x (bit-equal) "
            f"{r['alone_ms']} = {r['bytes_alone'] / r['alone_ms'] / 1e6:.0f} GB/s, bound {r['bound_alone']:.3f} ms = "
            f"{r['bound_alone'] / r['alone_ms']:.1%}; yardstick q_upsample + torch.cat "
            f"{r['alone_ms'] + r['cat_ms']:.3f} ms (the cat {r['cat_ms']}); plain versions {r['plain_ms']:.3f} ms, "
            f"alone {r['plain_alone_ms']:.3f} ms")
    return total


def int8_config3_model(dev):
    """The ResNet-family twin of config 3's model that the int8 quantizer
    takes: ``seresnext50_encoder()`` (3/4/6/3 bottlenecks, 32 groups of width
    4, SE), FPN(128), ResizeHead(19); seeded weights with config3_model's cut
    of the residual branches' last BatchNorm scales."""
    from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, seresnext50_encoder

    encoder = seresnext50_encoder()
    decoder = FPNDecoder(encoder.get_output_spec(), out_channels=128)
    model = seed_weights(EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(),
                                                                            num_classes=CLASSES)), SEED + 10)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bn3.weight", "downsample.1.weight")):
                p.mul_(RESIDUAL_BN_SCALE)
    return model.eval().to(dev)


def _rel_rms(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


def _q3_totals(seen: dict, what: str) -> dict:
    """Q3's checked shapes of one run: a log line each, and the run's sums
    (each shape's time times its calls)."""
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0, "shapes": len(seen),
             "calls": sum(n for _, n in seen.values()), "gated": sum(n for r, n in seen.values() if r["gated"])}
    for r, n in seen.values():
        total["max_abs_err"] = max(total["max_abs_err"], r["max_abs_err"])
        for key, value in (("ms", r["ms"]), ("plain_ms", r["plain_ms"]), ("bound_ms", r["bound"])):
            total[key] += n * value
        log(f"[16] q_add {what} {r['shape']} (x{n}) route {r['route']}: bit-equal to q_add_reference; kernel "
            f"{r['ms']} = {r['bytes'] / r['ms'] / 1e6:.0f} GB/s, bound {r['bound']:.4f} ms (bytes) = "
            f"{r['bound'] / r['ms']:.1%} of the kernel; plain version {r['plain_ms']:.3f} ms")
    return total


def _check_q3_counts(counts: dict, seen: dict, forwards: int, what: str) -> None:
    """A counted run's Q3 launches: the checked run's calls, ``ENCDEC_ADDS``
    a forward, ``ENCDEC_GATED_ADDS`` of them gated, none on the scalar
    route."""
    got = (counts["q_add"], counts["q_add_gated"], counts["q_add_by_route"]["scalar"])
    want = (ENCDEC_ADDS * forwards, ENCDEC_GATED_ADDS * forwards, 0)
    checked = sum(n for _, n in seen.values())
    if got != want or checked != counts["q_add"]:
        raise AssertionError(f"{what}: Q3 launched {counts['q_add_by_route']} with {counts['q_add_gated']} gated "
                             f"(want {want[0]} on vec16, {want[1]} gated), the checked run {checked}")
    log(f"[16] q_add {what}: launches by route {counts['q_add_by_route']}, {counts['q_add_gated']} gated, as the "
        f"checked run's calls took them")


def _q3_kernel(launches: dict, q3: dict, q3_tta: dict) -> dict:
    """Q3's entry of the ``kernels`` line: the forward's adds at batch 1 and
    the TTA call's at batch 8, summed over each run's calls."""
    return {"name": "q_add", "route": "cuda", "source": "pytorch_toolbelt_tpu_torch/csrc/q_add.cu",
            "replaces": "pytorch_toolbelt_tpu/zoo/quantized_encdec.py:622", "launches": launches["q_add"],
            "gated": launches["q_add_gated"], "max_abs_err": max(q3["max_abs_err"], q3_tta["max_abs_err"]),
            "ms": q3["ms"], "plain_ms": q3["plain_ms"], "bound_ms": q3["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "launches_by_route": launches["q_add_by_route"], "tta_ms": q3_tta["ms"],
            "tta_plain_ms": q3_tta["plain_ms"], "tta_bound_ms": q3_tta["bound_ms"]}


def _add_counts(total: dict, counts: dict) -> dict:
    """Launch counts by kernel and by route, summed."""
    for key, value in counts.items():
        if isinstance(value, dict):
            by_route = total.setdefault(key, dict.fromkeys(value, 0))
            for route, n in value.items():
                by_route[route] = by_route.get(route, 0) + n
        else:
            total[key] = total.get(key, 0) + value
    return total


def phase_int8_encdec(dev, smi, strict: bool = True):
    """[16.5] The int8 SEResNeXt50-FPN(128), 19 classes, through
    ``quantize_encoder_decoder_inference``: one 1024^2 forward at batch 1 and
    one call of config 3's d4 + multiscale TTA (the model on its batch-8 d4
    views at 1024^2 and 768^2), in each of which Q1 is held bit for bit
    against its plain version at the first call of every distinct shape and
    timed there (Q2 too in the forward, and Q3, gated or not, in both), Q1's
    times summed by class of conv; then a counted forward and a counted TTA
    call, whose launches by route must be the checked calls' (with
    ``strict``, each call on its class's route: only the 7x7 stem on
    ``mma_v1``; Q3 ``ENCDEC_ADDS`` times a forward on ``vec16``,
    ``ENCDEC_GATED_ADDS`` of them gated); the forward and the TTA timed;
    shapes, finite values and the distance to the fp32 forward.  Returns the
    counted runs' launches, Q1's sums of the forward and of the TTA call,
    Q2's of the forward and Q3's of the forward and of the TTA call.  The
    checked calls come from the forward without CUDA graphs (``.eager``), as
    a replay makes no call; the graphed forward and TTA call must equal their
    eager versions bit for bit, and the counted, timed and profiled runs
    replay the graphs."""
    from pytorch_toolbelt_tpu_torch.inference import MultiscaleTTA, d4_image2mask
    from pytorch_toolbelt_tpu_torch.zoo import quantize_encoder_decoder_inference
    from pytorch_toolbelt_tpu_torch.zoo import quantized_encdec

    model3 = int8_config3_model(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    cal_images = torch.rand(INT8_CAL_IMAGES, 3, INT8_SIZE, INT8_SIZE, device=dev, generator=gen)
    x = torch.rand(1, 3, INT8_SIZE, INT8_SIZE, device=dev, generator=gen)
    t0 = time.perf_counter()
    q3 = quantize_encoder_decoder_inference(model3, cal_images)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    del cal_images
    with _checked_calls("qconv2d", _check_q1("SEResNeXt50-FPN", True, strict=strict)) as convs, \
            _checked_calls("q_upsample", _check_q2(True)) as ups, \
            _checked_calls("q_add", _check_q3(True), module=quantized_encdec) as adds:
        q3.eager(x)  # the kernels' calls as the forward makes them: a replay of its graph makes none
    torch.cuda.synchronize()
    q1_3 = _q1_totals(convs, "SEResNeXt50-FPN")
    _q1_classes(convs, "one forward at batch 1", smi)
    q2_3 = _q2_totals(ups)
    q3_3 = _q3_totals(adds, "SEResNeXt50-FPN")
    q3(x)  # the first graphed call captures
    if not torch.equal(q3(x), q3.eager(x)):
        raise AssertionError("the int8 SEResNeXt50-FPN's graphed forward differs from its eager forward")
    _reset_int8_counts()
    got = q3(x)  # a replay: the kernels' counters add the launches its graph holds
    torch.cuda.synchronize()
    counts3 = _int8_counts()
    _check_q1_routes(convs, counts3["qconv2d_by_route"], "SEResNeXt50-FPN forward", strict)
    _check_q3_counts(counts3, adds, 1, "SEResNeXt50-FPN forward")
    del convs, ups, adds
    with torch.no_grad():
        ref = model3(x)
    rms = _rel_rms(got, ref)
    ok = got.shape == (1, CLASSES, INT8_SIZE, INT8_SIZE) and bool(torch.isfinite(got).all())
    ms = cuda_ms(lambda: q3(x), reps=3)
    f_ms = cuda_ms(lambda: model3(x), reps=3)
    _log_profile_by_kind("[16] profiled int8 SEResNeXt50-FPN forward", lambda: q3(x), ENCDEC_KINDS, smi, top=8)

    tta = MultiscaleTTA(lambda xi: d4_image2mask(q3, xi), size_offsets=MS_OFFSETS)
    tta_eager = MultiscaleTTA(lambda xi: d4_image2mask(q3.eager, xi), size_offsets=MS_OFFSETS)
    with _checked_calls("qconv2d", _check_q1("SEResNeXt50-FPN TTA", True, strict=strict)) as tta_convs, \
            _checked_calls("q_add", _check_q3(True), module=quantized_encdec) as tta_adds:
        tta_eager(x)
    torch.cuda.synchronize()
    q1_tta = _q1_totals(tta_convs, "SEResNeXt50-FPN TTA")
    _q1_classes(tta_convs, "one call of config 3's TTA (batch-8 views at 1024^2 and 768^2)", smi)
    q3_tta = _q3_totals(tta_adds, "SEResNeXt50-FPN TTA")
    tta(x)  # each key's first graphed call captures its graph
    if not torch.equal(tta(x), tta_eager(x)):
        raise AssertionError("config 3's TTA call over the graphed int8 forward differs from it over the eager one")
    _reset_int8_counts()
    out = tta(x)
    torch.cuda.synchronize()
    counts_tta = _int8_counts()
    _check_q1_routes(tta_convs, counts_tta["qconv2d_by_route"], "config 3's TTA call", strict)
    _check_q3_counts(counts_tta, tta_adds, len(MS_OFFSETS), "config 3's TTA call")
    del tta_convs, tta_adds
    t0 = time.perf_counter()
    for _ in range(3):
        out = tta(x)
    torch.cuda.synchronize()
    tta_ms = (time.perf_counter() - t0) / 3 * 1e3
    _log_profile_by_kind("[16] profiled config-3 TTA call (int8)", lambda: tta(x), ENCDEC_KINDS, smi, top=8)
    ok = ok and out.shape == (1, CLASSES, INT8_SIZE, INT8_SIZE) and bool(torch.isfinite(out).all())
    log(f"[16] int8 SEResNeXt50-FPN(128), {CLASSES} classes (quantize_encoder_decoder_inference, requant mul, bias "
        f"correction, calibrated in {cal_s:.1f} s on {INT8_CAL_IMAGES} images of {INT8_SIZE}^2): its {q1_3['calls']} "
        f"convs ({q1_3['shapes']} distinct shapes) bit-equal to qconv2d_reference, {q1_3['ms']:.2f} ms of Q1 per "
        f"forward against a bound of {q1_3['bytes'] + q1_3['operations']:.2f} ms; its {q3_3['calls']} adds "
        f"({q3_3['gated']} gated) bit-equal to q_add_reference, {q3_3['ms']:.3f} ms of Q3 per forward against a bound "
        f"of {q3_3['bound_ms']:.3f} ms (plain version {q3_3['plain_ms']:.2f} ms); launches per forward: Q1 "
        f"{counts3['qconv2d_by_route']}, Q2 {counts3['q_upsample_by_route']}, Q3 {counts3['q_add_by_route']} "
        f"({counts3['q_add_gated']} gated) ({smi})")
    log(f"[16] int8 SEResNeXt50-FPN(128), config 3's TTA: its {q1_tta['calls']} convs ({q1_tta['shapes']} distinct "
        f"shapes) bit-equal to qconv2d_reference, {q1_tta['ms']:.2f} ms of Q1 per call against a bound of "
        f"{q1_tta['bytes'] + q1_tta['operations']:.2f} ms; its {q3_tta['calls']} adds ({q3_tta['gated']} gated) "
        f"bit-equal to q_add_reference, {q3_tta['ms']:.3f} ms of Q3 per call against a bound of "
        f"{q3_tta['bound_ms']:.3f} ms (plain version {q3_tta['plain_ms']:.2f} ms); launches per call: Q1 "
        f"{counts_tta['qconv2d_by_route']}, Q2 {counts_tta['q_upsample_by_route']}, Q3 "
        f"{counts_tta['q_add_by_route']} ({counts_tta['q_add_gated']} gated) ({smi})")
    log(f"[16] int8 SEResNeXt50-FPN(128): {ms} per [1, 3, {INT8_SIZE}, {INT8_SIZE}] forward (the fp32 module "
        f"{f_ms}); config 3's d4 + multiscale {MS_OFFSETS} TTA {tta_ms:.1f} ms per call; rel RMS against the fp32 "
        f"forward {rms:.4f}; {'ok' if ok else 'FAIL'} ({smi})")
    if not ok:
        raise AssertionError("the int8 SEResNeXt50-FPN gave a wrong shape or non-finite values")
    for counts in (counts3, counts_tta):
        if counts["q_upsample_by_route"]["banded"] != counts["q_upsample"]:
            raise AssertionError(f"the SEResNeXt50-FPN's upsamples took {counts['q_upsample_by_route']}")
    del model3, q3
    torch.cuda.empty_cache()
    return _add_counts(counts3, counts_tta), q1_3, q1_tta, q2_3, q3_3, q3_tta


def phase_int8(dev, smi, model, fused, t_start):
    """Slice E: the int8 UNet-32 forward against its plain version and the
    bf16 fused path; config 2 in int8 at 5000^2, whose first run holds Q1
    and Q2 bit for bit against their plain versions at each of its shapes,
    on its own data, and times them; the int8 SEResNeXt50-FPN(128) at 1024^2
    and under config 3's TTA (:func:`phase_int8_encdec`)."""
    from pytorch_toolbelt_tpu_torch.inference import ImageSlicer, tiled_apply_d4_tta
    from pytorch_toolbelt_tpu_torch.zoo import quantize_unet_inference
    from pytorch_toolbelt_tpu_torch.zoo.quantized_unet import _build_int8_unet, _calibrate_unet

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    image = torch.rand(3, 5000, 5000, device=dev, generator=gen)  # phase 6's image
    slicer = ImageSlicer((5000, 5000), TILE, STEP)
    tiles = slicer.split(image.permute(1, 2, 0).cpu().numpy())[:INT8_CHECK_BATCH]
    tiles = torch.from_numpy(np.stack(tiles)).permute(0, 3, 1, 2).contiguous().to(dev)
    cal_tiles = tiles[:INT8_CAL_TILES]

    # [16.3] the int8 UNet-32 on the calibration tiles: kernels against plain versions, against bf16
    t0 = time.perf_counter()
    q_forward = quantize_unet_inference(model, cal_tiles)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    cal = _calibrate_unet(model, cal_tiles, 1.0)
    forward = _build_int8_unet(cal, 3, None, dev)
    got = forward(cal_tiles)
    with _plain_kernels():
        want = forward(cal_tiles)
    if not torch.equal(got, want):
        raise AssertionError(f"the int8 UNet-32 on Q1 and Q2 disagrees with its plain version: max |err| "
                             f"{float((got - want).abs().max())}")
    if not torch.equal(q_forward(cal_tiles), got):
        raise AssertionError("two calibrations of the int8 UNet-32 on the same tiles gave other networks")
    with torch.no_grad():
        ref_bf16 = fused(cal_tiles).float()
        ref_fp32 = model(cal_tiles)
    rel_rms = _rel_rms(got, ref_bf16)
    log(f"[16] int8 UNet-32 (quantize_unet_inference, calibrated in {cal_s:.2f} s on the first {INT8_CAL_TILES} "
        f"tiles of the 5000^2 image): on those tiles bit-equal to the same network on the plain versions; "
        f"int8_forward_rel_rms against the bf16 fused forward {rel_rms:.4f} (<= {INT8_PTQ_RMS}), against the "
        f"fp32 module {_rel_rms(got, ref_fp32):.4f}")
    if not rel_rms <= INT8_PTQ_RMS:
        raise AssertionError("the int8 UNet-32 is further from the bf16 path than int8 PTQ error")
    del got, want, ref_bf16, ref_fp32, forward

    # the int8 UNet-32 on 16 tiles: Q1 and Q2 at each call against their plain versions
    with _checked_calls("qconv2d", _check_q1("UNet-32", False)) as convs, \
            _checked_calls("q_upsample_cat", _check_q2_cat(False)) as ups:
        q_forward(tiles)
    torch.cuda.synchronize()
    _q1_totals(convs, f"UNet-32 on {INT8_CHECK_BATCH} tiles")
    _q2_cat_totals(ups)
    del convs, ups, tiles

    # [16.1, 16.2] config 2 in int8 (5000^2, distributed, batch 64): its first run is the warm-up, in which Q1 and
    # Q2 are held against their plain versions at the first call of each shape, on that call's data, and timed
    run = lambda f: tiled_apply_d4_tta(f, image, TILE, STEP, weight="pyramid", batch_size=DIST_BATCH,  # noqa: E731
                                       mode="distributed")
    with _checked_calls("qconv2d", _check_q1("UNet-32", True, with_k2=True)) as convs, \
            _checked_calls("q_upsample_cat", _check_q2_cat(True)) as ups:
        run(q_forward)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    q1 = _q1_totals(convs, "UNet-32")
    q2 = _q2_cat_totals(ups)
    del ups
    log(f"[16] qconv2d UNet-32, the {q1['calls']} convs of the 5000^2 int8 run ({q1['shapes']} distinct shapes), "
        f"each shape's time times its calls: kernel {q1['ms']:.2f} ms, bound {q1['bytes'] + q1['operations']:.2f} ms "
        f"(bytes {q1['bytes']:.2f}, operations {q1['operations']:.2f}), plain version {q1['plain_ms']:.2f} ms, "
        f"torch._int_mm {q1['library_ms']} ms, bf16 K2 at the 3x3 stride-1 shapes {q1['k2_ms']:.2f} ms ({smi})")
    log(f"[16] q_upsample_cat UNet-32, the {q2['calls']} decoder inputs of the 5000^2 int8 run, each shape's time "
        f"times its calls: kernel {q2['ms']:.3f} ms = {q2['bytes'] / q2['ms'] / 1e6:.0f} GB/s, bound "
        f"{q2['bound']:.3f} ms = {q2['bound'] / q2['ms']:.1%} of the kernel; q_upsample alone on the same x "
        f"{q2['alone_ms']:.3f} ms = {q2['bytes_alone'] / q2['alone_ms'] / 1e6:.0f} GB/s, bound "
        f"{q2['bound_alone']:.3f} ms = {q2['bound_alone'] / q2['alone_ms']:.1%}; yardstick q_upsample + torch.cat "
        f"{q2['alone_ms'] + q2['cat_ms']:.3f} ms (the cat {q2['cat_ms']:.3f}); plain version {q2['plain_ms']:.2f} ms "
        f"({smi})")

    # [16.4] the counted run, held against the bf16 fused path; then both timed in turns and profiled
    _reset_int8_counts()
    _reset_merge_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run(q_forward)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _int8_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check_merge_routes("[16] 5000^2 int8", 1)
    if (launches["qconv2d"], launches["q_upsample_cat"], launches["q_upsample"]) != (q1["calls"], q2["calls"], 0):
        raise AssertionError(f"the counted 5000^2 int8 run launched {launches}, the checked run made "
                             f"{q1['calls']} qconv2d and {q2['calls']} q_upsample_cat calls")
    if launches["q_upsample_cat_by_route"]["banded"] != q2["calls"]:
        raise AssertionError(f"the counted 5000^2 int8 run's decoder inputs took {launches['q_upsample_cat_by_route']}")
    _check_q1_routes(convs, launches["qconv2d_by_route"], "UNet-32 5000^2 int8 run")
    del convs
    with torch.no_grad():
        out_bf16 = run(fused).float()
    rms = _rel_rms(out, out_bf16)
    ok = out.shape == (1, 5000, 5000) and bool(torch.isfinite(out).all()) and rms <= INT8_PTQ_RMS
    log(f"[16] config 2 int8: tiled_apply_d4_tta 5000^2 distributed batch={DIST_BATCH}: {wall:.3f} s, "
        f"{25.0 / wall:.2f} MP/s, peak {peak:.2f} GiB allocated; launches {launches}; rel RMS against the "
        f"bf16 fused path's output {rms:.4f} (<= {INT8_PTQ_RMS}) {'ok' if ok else 'FAIL'} ({smi})")
    if not ok:
        raise AssertionError("config 2 in int8 gave a wrong shape, non-finite values or strays from bf16")
    del out, out_bf16
    if time.perf_counter() - t_start < TIME_BUDGET_S / 2:
        walls = {"bf16": [], "int8": []}
        for name, f in (("bf16", fused), ("int8", q_forward), ("int8", q_forward), ("bf16", fused)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(f)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
        log("[16] 5000^2 distributed batch 64 in turns (bf16, int8, int8, bf16): " + "; ".join(
            f"{k} {', '.join(f'{w:.3f}' for w in v)} s = {25.0 / statistics.median(v):.2f} MP/s"
            for k, v in walls.items()) + f" ({smi})")
        _log_profile_by_kind("[16] profiled 5000^2 int8 distributed run", lambda: run(q_forward), INT8_KINDS, smi,
                             top=10)
        _log_profile_by_kind("[16] profiled 5000^2 bf16 distributed run (same call)", lambda: run(fused),
                             CONFIG5_KINDS, smi, top=0)
    else:
        log("[16] config 2 int8 at 5000^2: the timing in turns and the profiles skipped, over half the time "
            "budget spent")
    del image
    torch.cuda.empty_cache()

    # [16.5] the int8 SEResNeXt50-FPN(128) at batch 1 and under config 3's TTA
    counts3, q1_3, q1_tta, q2_3, q3_3, q3_tta = phase_int8_encdec(dev, smi)
    _add_counts(launches, counts3)
    if min(launches[key] for key in INT8_KERNELS) == 0:
        raise AssertionError(f"a kernel of the int8 paths was never launched: {launches}")
    max_err = max(q1["max_abs_err"], q1_3["max_abs_err"], q1_tta["max_abs_err"])
    kernels = [
        {"name": "qconv2d", "route": "cuda", "source": "pytorch_toolbelt_tpu_torch/csrc/qconv_wgmma.cu",
         "mma_source": "pytorch_toolbelt_tpu_torch/csrc/qconv.cu",
         "replaces": "pytorch_toolbelt_tpu/zoo/quantized_unet.py:140", "launches": launches["qconv2d"],
         "max_abs_err": max_err, "ms": q1["ms"], "plain_ms": q1["plain_ms"],
         "bound_ms": q1["bytes"] + q1["operations"],
         "bound_by": "bytes" if q1["bytes"] >= q1["operations"] else "operations", "library_ms": q1["library_ms"],
         "launches_by_route": launches["qconv2d_by_route"], "k2_bf16_ms": q1["k2_ms"],
         "encdec_ms": q1_3["ms"], "encdec_bound_ms": q1_3["bytes"] + q1_3["operations"],
         "encdec_library_ms": q1_3["library_ms"], "encdec_tta_ms": q1_tta["ms"],
         "encdec_tta_bound_ms": q1_tta["bytes"] + q1_tta["operations"]},
    ]
    for route in ("gemm_wgmma", "grouped_wgmma"):  # the routes of csrc/qconv_gemm.cu, at the forward's and TTA's calls
        r, t = q1_3["routes"][route], q1_tta["routes"][route]
        kernels.append({
            "name": f"qconv2d ({route})", "route": "cuda", "source": "pytorch_toolbelt_tpu_torch/csrc/qconv_gemm.cu",
            "replaces": "pytorch_toolbelt_tpu/zoo/quantized_encdec.py:572",
            "launches": launches["qconv2d_by_route"][route],
            "max_abs_err": max(q1_3["max_abs_err"], q1_tta["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bytes"] + r["operations"],
            "bound_by": "bytes" if r["bytes"] >= r["operations"] else "operations", "library_ms": r["library_ms"],
            "tta_ms": t["ms"], "tta_bound_ms": t["bytes"] + t["operations"], "tta_library_ms": t["library_ms"]})
    kernels += [
        {"name": "q_upsample", "route": "cuda", "source": "pytorch_toolbelt_tpu_torch/csrc/q_upsample.cu",
         "replaces": "pytorch_toolbelt_tpu/zoo/quantized_unet.py:175", "launches": launches["q_upsample"],
         "max_abs_err": max(q2["max_abs_err"], q2_3["max_abs_err"]), "ms": q2["alone_ms"],
         "plain_ms": q2["plain_alone_ms"], "bound_ms": q2["bound_alone"], "bound_by": "bytes", "library_ms": None,
         "launches_by_route": launches["q_upsample_by_route"], "encdec_ms": q2_3["ms"],
         "encdec_bound_ms": q2_3["bound_ms"]},
        {"name": "q_upsample_cat", "route": "cuda", "source": "pytorch_toolbelt_tpu_torch/csrc/q_upsample.cu",
         "replaces": "pytorch_toolbelt_tpu/zoo/quantized_unet.py:354", "launches": launches["q_upsample_cat"],
         "max_abs_err": q2["max_abs_err"], "ms": q2["ms"], "plain_ms": q2["plain_ms"], "bound_ms": q2["bound"],
         "bound_by": "bytes", "library_ms": None, "launches_by_route": launches["q_upsample_cat_by_route"],
         "yardstick_ms": q2["alone_ms"] + q2["cat_ms"], "cat_ms": q2["cat_ms"]},
        _q3_kernel(launches, q3_3, q3_tta),
    ]
    return kernels, launches.get("grid_merge", 0), launches.get("grid_merge_by_route", {})


# ---------------------------------------------------------------------------
# Phase 17: training (slice F) -- config 3's model trained at config 4's shape
# ---------------------------------------------------------------------------


class _SeededSegmentation:
    """``n`` (image, mask) pairs made from a seed, a map-style dataset: [S, S] int32 masks of CLASSES classes in
    a 16 x 16 grid of blocks, and [3, S, S] float32 images that paint each class its own colour (0.7) under
    uniform noise (0.3), so that the model can learn them."""

    def __init__(self, n: int, size: int, seed: int):
        rng = np.random.RandomState(seed)
        colours = rng.rand(CLASSES, 3).astype(np.float32)
        block = size // 16
        self.images, self.masks = [], []
        for _ in range(n):
            mask = rng.randint(0, CLASSES, (16, 16)).astype(np.int32).repeat(block, 0).repeat(block, 1)
            self.masks.append(mask)
            self.images.append(colours[mask].transpose(2, 0, 1) * 0.7 + rng.rand(3, size, size).astype(np.float32) * 0.3)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.masks[i]


def _train_loss():
    """The port's CE-focal + 0.5 Lovasz-Softmax (per_image=False) on the softmax of the logits."""
    from pytorch_toolbelt_tpu_torch import losses as L

    lovasz = L.LovaszLoss(per_image=False)
    return L.JointLoss(L.CrossEntropyFocalLoss(), lambda x, y: lovasz(torch.softmax(x, 1), y), 1.0, 0.5)


def _plain_train_loss(x, t):
    return plain_ce_focal(x, t.long()) + 0.5 * plain_lovasz_softmax(torch.softmax(x, 1), t)


def _train_setup(dev, mesh):
    """Config 3's model in train mode (fp32, NCHW), wrapped by ``data_parallel`` over the mesh, and the example's
    AdamW over ``make_optimizer``'s groups: (module, wrapped module, optimizer)."""
    from pytorch_toolbelt_tpu_torch.distributed import data_parallel
    from pytorch_toolbelt_tpu_torch.optimization import make_optimizer

    model = config3_module().train().to(dev)
    optimizer = make_optimizer(model, 1e-3, 1e-4, torch.optim.AdamW, apply_weight_decay_on_norm=False,
                               apply_weight_decay_on_bias=False, betas=(0.9, 0.999), eps=1e-8)
    return model, data_parallel(model, mesh), optimizer


def _train_step(net, optimizer, loss_fn, x, y):
    loss = loss_fn(net(x), y)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def _batches(dataset, batch: int, steps: int, mesh, size: int = 2):
    """``steps`` batches of ``batch`` samples drawn by RandomSubsetDataset (python's RNG), collated by
    default_collate and put on the card by prefetch_to_device under batch_sharding."""
    from pytorch_toolbelt_tpu_torch.datasets import RandomSubsetDataset, default_collate, prefetch_to_device
    from pytorch_toolbelt_tpu_torch.distributed import batch_sharding

    subset = RandomSubsetDataset(dataset, batch * steps)
    host = (default_collate([subset[i * batch + j] for j in range(batch)]) for i in range(steps))
    return prefetch_to_device(host, size=size, sharding=batch_sharding(mesh, 4))


@contextlib.contextmanager
def _plain_bn_statistics(model):
    """While the block runs, forward pre-hooks on every BatchNorm of ``model`` compute from the norm's own input
    the running statistics it should hold after a training forward, as flax updates them: (1 - m) old + m batch,
    in float64, the batch variance biased (over n).  Yields {module name: (mean, var)}."""
    expected = {}

    def record(name):
        def hook(module, inputs):
            x = inputs[0].detach().double()
            m = module.momentum
            mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
            expected[name] = ((1 - m) * module.running_mean.double() + m * mean,
                              (1 - m) * module.running_var.double() + m * var)
        return hook

    hooks = [module.register_forward_pre_hook(record(name)) for name, module in model.named_modules()
             if isinstance(module, torch.nn.modules.batchnorm._BatchNorm)]
    try:
        yield expected
    finally:
        for hook in hooks:
            hook.remove()


def _check_train_step(dev, mesh, smi) -> None:
    """One step of the port (DDP, the library's losses, Lovasz's sort on K4) against a plain step on a copy of the
    same model (the plain losses, torch.sort): the loss, every gradient, and the BN running statistics against
    those computed from each norm's input in the plain step."""
    import copy

    from pytorch_toolbelt_tpu_torch.distributed import data_parallel
    from pytorch_toolbelt_tpu_torch.ops import bitonic_sort_chunked

    model = config3_module().train().to(dev)
    plain = copy.deepcopy(model)
    net = data_parallel(model, mesh)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    b, size = TRAIN_CHECK_BATCH, TRAIN_CHECK_SIZE
    x = torch.rand(b, 3, size, size, device=dev, generator=gen)
    y = torch.randint(0, CLASSES, (b, size, size), device=dev, generator=gen, dtype=torch.int32)
    k4 = bitonic_sort_chunked.launches
    loss = _train_loss()(net(x), y)
    loss.backward()
    sorts = bitonic_sort_chunked.launches - k4
    with _plain_bn_statistics(plain) as expected:
        want = _plain_train_loss(plain(x), y)
    want.backward()
    loss_err = abs(loss.item() - want.item()) / abs(want.item())
    pairs = list(zip(model.named_parameters(), plain.named_parameters()))
    scale = max(float(q.grad.abs().max()) for _, q in plain.named_parameters())
    grad_err, worst = max((float((p.grad - q.grad).abs().max()), name) for (name, p), (_, q) in pairs)
    norms = dict(model.named_modules())
    stats = [(getattr(norms[name], buffer).double(), value) for name, pair in expected.items()
             for buffer, value in zip(("running_mean", "running_var"), pair)]
    stats_err = max(float(((a - b_).abs() / (1 + b_.abs())).max()) for a, b_ in stats)
    ok = (math.isfinite(loss.item()) and loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL * scale
          and stats_err <= TRAIN_STATS_TOL and sorts == 1)
    log(f"[17] check: one training step at batch {b}, {size}^2 (DDP, nccl world 1) against the plain step on a copy: "
        f"loss {loss.item():.7g} vs {want.item():.7g}, rel err {loss_err:.2e} <= {TRAIN_LOSS_RTOL:.0e}; gradients "
        f"max|err| {grad_err:.3e} <= {TRAIN_GRAD_TOL:.0e} x max|g| {scale:.3e} (worst {worst}); {len(stats)} BN running "
        f"statistics against (1 - m) old + m x (biased batch variance) from each norm's input in the plain step: max err "
        f"{stats_err:.2e} <= {TRAIN_STATS_TOL:.0e} (relative to 1 + |expected|); K4 launches {sorts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the training step disagrees with the plain step")


def _full_width_run(dev, mesh, smi, dataset):
    """Config 3's model trained on batches of TRAIN_BATCH x 3 x TRAIN_SIZE^2: the warm-up step's peak memory (the
    batch is halved if it does not fit), TRAIN_STEPS timed steps, TRAIN_PROFILED_STEPS under torch.profiler.
    Returns K4's launches in these steps."""
    from pytorch_toolbelt_tpu_torch.ops import bitonic_sort_chunked

    loss_fn = _train_loss()
    total = 1 + TRAIN_STEPS + TRAIN_PROFILED_STEPS
    for batch in (TRAIN_BATCH, TRAIN_BATCH // 2):
        model, net, optimizer = _train_setup(dev, mesh)
        batches = _batches(dataset, batch, total, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bitonic_sort_chunked.launches = 0
        try:
            loss = _train_step(net, optimizer, loss_fn, *next(batches))
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            del model, net, optimizer, batches
            torch.cuda.empty_cache()
            log(f"[17] cut: batch {batch} does not fit in the card's memory; batch {batch // 2} from here on")
    else:
        raise AssertionError("config 3's training step fits at no batch")
    first_peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in model.parameters())
    mp = batch * TRAIN_SIZE**2 / 1e6
    log(f"[17] full width: SEResNeXt50-FPN(128), 19 classes, train mode fp32 (TF32 off), NCHW, DDP (nccl world "
        f"1), batch {batch} x 3 x {TRAIN_SIZE}^2 -> logits [{batch}, {CLASSES}, {TRAIN_SIZE}, {TRAIN_SIZE}]; "
        f"CE-focal + 0.5 Lovasz-Softmax; AdamW; warm-up step loss {loss.item():.5f}, peak {first_peak:.2f} GiB "
        f"allocated; the model's {n_params / 1e6:.2f}M parameters with their gradients and AdamW moments "
        f"{4 * n_params * 4 / 2**30:.2f} GiB; one [{batch}, {CLASSES}, {TRAIN_SIZE}, {TRAIN_SIZE}] fp32 tensor "
        f"{batch * CLASSES * TRAIN_SIZE**2 * 4 / 2**30:.2f} GiB ({smi})")

    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        losses.append(_train_step(net, optimizer, loss_fn, *next(batches)))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    steps = Timing([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    losses = torch.stack(losses).tolist()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training losses {losses}")
    log(f"[17] full width: {steps} per step between CUDA events, {wall:.1f} ms per step on the host's clock "
        f"({TRAIN_STEPS} steps, batches through prefetch_to_device); {batch / steps * 1e3:.2f} images/s, "
        f"{mp / steps * 1e3:.2f} MP/s; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated; losses "
        + ", ".join(f"{v:.5f}" for v in losses) + f" ({smi})")

    def profiled_steps():
        for _ in range(TRAIN_PROFILED_STEPS):
            _train_step(net, optimizer, loss_fn, *next(batches))

    _log_training_profile(profiled_steps, smi)
    launches = bitonic_sort_chunked.launches
    log(f"[17] K4 (radix_sort) launches in the {total} steps: {launches} {'ok' if launches == total else 'FAIL'}")
    if launches != total:
        raise AssertionError(f"K4 launched {launches} times in {total} training steps")
    return launches


def _log_training_profile(fn, smi) -> None:
    """Run TRAIN_PROFILED_STEPS steps (``fn``) under torch.profiler; log per step the idle share, the device time
    by kind (each kind's kernel time summed, and the time the card ran any of its kernels: the card runs kernels
    of several streams at once, so the sums may add up to more than the busy time), the top kernels and K4's."""
    n = TRAIN_PROFILED_STEPS
    wall_ms, prof = _profiled(fn)
    events = _device_events(prof)
    if not events:
        log("[17] profiled steps: device time not measured (the profiler saw no CUDA events)")
        return
    busy = _busy_ms(events)
    kinds, by_name = {}, {}
    for a, b, name, stream in events:
        kind = next((k for k, pattern in TRAIN_KINDS if re.search(pattern, name)), OTHER_KIND)
        kinds.setdefault(kind, []).append((a, b))
        entry = by_name.setdefault(name, [0.0, set()])
        entry[0] += (b - a) / 1e3
        entry[1].add(stream)
    summed = sum(b - a for a, b, *_ in events) / 1e3
    streams = len({stream for *_, stream in events})
    log(f"[17] profiled steps ({n}): wall {wall_ms / n:.1f} ms per step, device busy {busy / n:.1f} ms (idle "
        f"{1 - busy / wall_ms:.1%}); kernel time {summed / n:.1f} ms per step on {streams} streams; per step by kind, "
        "summed (on the timeline): "
        + ", ".join(f"{k} {sum(b - a for a, b in iv) / 1e3 / n:.2f} ({_busy_ms(sorted(iv)) / n:.2f}) ms"
                    for k, iv in sorted(kinds.items(), key=lambda kv: -sum(b - a for a, b in kv[1])))
        + f" ({smi})")
    for name, (ms, on) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"[17]   device {ms / n:8.2f} ms per step, {len(on)} stream(s)  {name[:100]}")
    k4 = {}
    for name, (ms, _) in by_name.items():
        match = SORT_KERNEL.search(name)
        if match:
            k4[match.group(1)] = k4.get(match.group(1), 0.0) + ms / n
    log(f"[17] K4 per step (one launch: a memset and six kernels): {sum(k4.values()):.3f} ms = "
        f"{sum(k4.values()) / (busy / n):.2%} of the busy time: "
        + ", ".join(f"{kernel} {ms:.3f}" for kernel, ms in sorted(k4.items(), key=lambda kv: -kv[1])))


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms and torch's deterministic mode, which warns on an op that has none;
    yields the list of warnings caught."""
    import warnings

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def _checkpoint_round_trip(dev, mesh, dataset, tmp: str) -> None:
    """Three steps, save_checkpoint, a fourth step; then a fresh model and optimizer, load_checkpoint, the RNG
    restored (RandomSubsetDataset draws the same samples), the fourth step again: bit-equal loss and parameters."""
    from pytorch_toolbelt_tpu_torch.utils import get_rng_state, load_checkpoint, save_checkpoint
    from pytorch_toolbelt_tpu_torch.utils import set_manual_seed, set_rng_state

    loss_fn = _train_loss()
    set_manual_seed(SEED + 17)
    model, net, optimizer = _train_setup(dev, mesh)
    for _ in range(3):
        _train_step(net, optimizer, loss_fn, *next(_batches(dataset, TRAIN_BATCH, 1, mesh)))
    path = os.path.join(tmp, "step3.pt")
    t0 = time.perf_counter()
    save_checkpoint(path, {"model": model, "optimizer": optimizer, "step": 3, "rng": get_rng_state()})
    save_s, size_mb = time.perf_counter() - t0, os.path.getsize(path) / 1e6
    with _deterministic() as caught:
        want_loss = _train_step(net, optimizer, loss_fn, *next(_batches(dataset, TRAIN_BATCH, 1, mesh)))
    want = [t.detach().clone() for t in list(model.parameters()) + list(model.buffers())]
    del model, net, optimizer
    torch.cuda.empty_cache()

    model, net, optimizer = _train_setup(dev, mesh)
    t0 = time.perf_counter()
    state = load_checkpoint(path, target={"model": model, "optimizer": optimizer})
    set_rng_state(state["rng"])
    load_s = time.perf_counter() - t0
    with _deterministic() as caught_again:
        got_loss = _train_step(net, optimizer, loss_fn, *next(_batches(dataset, TRAIN_BATCH, 1, mesh)))
    got = list(model.parameters()) + list(model.buffers())
    differing = sum(not torch.equal(a, b) for a, b in zip(got, want))
    ok = state["step"] == 3 and torch.equal(got_loss, want_loss) and differing == 0
    notes = sorted({str(w.message).split(".")[0] for w in list(caught) + list(caught_again)})
    log(f"[17] checkpoint: save after step 3 {save_s:.2f} s ({size_mb:.0f} MB), load + RNG restore {load_s:.2f} s; "
        f"step 4 loss {want_loss.item():.7g}, replayed {got_loss.item():.7g}; {len(got) - differing} of {len(got)} "
        f"parameters and buffers bit-equal {'ok' if ok else 'FAIL'}"
        + (f"; deterministic mode warned: {notes}" if notes else ""))
    if not ok:
        raise AssertionError("the replayed step 4 differs from the original")


@contextlib.contextmanager
def _recorded_grid_merges():
    """While the block runs, record every call of K1 that tiled_apply makes (``inference/tiles.py`` calls
    ``grid_merge`` by its name there): its arguments and its output, cloned.  Yields the list of records."""
    from pytorch_toolbelt_tpu_torch.inference import tiles

    real, calls = tiles.grid_merge, []

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(([a.clone() if torch.is_tensor(a) else a for a in args], dict(kwargs), out.clone()))
        return out

    tiles.grid_merge = wrapped
    try:
        yield calls
    finally:
        tiles.grid_merge = real


def _run_example(smi):
    """The port's example at its defaults on the card; then each K1 call of its tiled d4 tail bit for bit against
    the plain merge on the call's own inputs, and K1 alone at that shape.  Returns K1's launches in the example,
    in all and by route."""
    import io

    from pytorch_toolbelt_tpu_torch.examples.train_segmentation import main as example_main
    from pytorch_toolbelt_tpu_torch.ops import grid_merge, grid_merge_reference

    _reset_merge_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out, _recorded_grid_merges() as calls:
        result = example_main()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_route = grid_merge.launches, dict(grid_merge.launches_by_route)
    for line in out.getvalue().splitlines():
        log(f"[17] example: {line}")
    errors = [float((got.float() - grid_merge_reference(*args, **kwargs).float()).abs().max())
              for args, kwargs, got in calls]
    prediction = result["prediction"]
    ok = (len(result["losses"]) == 5 and all(math.isfinite(v) for v in result["losses"])
          and prediction.is_cuda and tuple(prediction.shape) == (2, 512, 512)
          and bool(torch.isfinite(prediction).all()) and launches >= 1 and len(calls) == launches
          and all(err <= MERGE_TOL for err in errors))
    log(f"[17] example: pytorch_toolbelt_tpu_torch.examples.train_segmentation.main() {wall:.1f} s (20 steps at "
        f"batch 8, 128^2, then tiled d4 at 512^2); K1 launches {launches} {by_route}, each call's output against "
        f"grid_merge_reference on its inputs max|err| {max(errors, default=float('nan')):.3e} <= {MERGE_TOL:.0e} "
        f"{'ok' if ok else 'FAIL'} ({smi})")
    if not ok:
        raise AssertionError("the port's example failed on the card")
    args, kwargs, _ = calls[0]
    _k1_at(*args[:3], kwargs["out_hw"], kwargs["offset"], smi, "[17]")
    return launches, by_route


def phase_training(dev, smi):
    """Slice F's training path on config 3's model at config 4's shape, under an nccl group of world size 1; then
    the port's example.  Returns (K4's launches in the full-width run, K1's launches and by route in the example)."""
    import tempfile

    from pytorch_toolbelt_tpu_torch.distributed import DistributedGuard, get_world_size, make_mesh

    t0 = time.perf_counter()
    dataset = _SeededSegmentation(TRAIN_SAMPLES, TRAIN_SIZE, SEED + 17)
    log(f"[17] {TRAIN_SAMPLES} seeded samples of {TRAIN_SIZE}^2 made in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp, DistributedGuard(f"file://{tmp}/store", world_size=1, rank=0,
                                                                backend="nccl", timeout_s=300):
        if torch.distributed.get_backend() != "nccl" or get_world_size() != 1:
            raise AssertionError("phase 17 needs an nccl group of world size 1")
        mesh = make_mesh()
        _check_train_step(dev, mesh, smi)
        torch.cuda.empty_cache()
        k4 = _full_width_run(dev, mesh, smi, dataset)
        torch.cuda.empty_cache()
        _checkpoint_round_trip(dev, mesh, dataset, tmp)
    torch.cuda.empty_cache()
    merges, merges_by_route = _run_example(smi)
    log(f"[17] phase 17: {time.perf_counter() - t0:.1f} s")
    return k4, merges, merges_by_route


@torch.no_grad()
def _tiled_d4_check(tag: str, name: str, model, forward, size: int, gen) -> dict:
    """``tiled_apply_d4_tta`` of ``forward`` (the bf16 model) on a seeded
    ``size``^2 image in both modes against the plain path on the fp32
    ``model`` (5e-2 * max|ref|), each call's one K1 launch on the cell
    route.  Returns K1's launches and launches by route."""
    from pytorch_toolbelt_tpu_torch.inference import tiled_apply_d4_tta
    from pytorch_toolbelt_tpu_torch.ops import grid_merge

    check = torch.rand(3, size, size, device=gen.device, generator=gen)
    runs = (("distributed", DIST_BATCH), ("full", FULL_BATCH))
    torch.cuda.synchronize()
    _reset_merge_counts()
    outs = {mode: tiled_apply_d4_tta(forward, check, TILE, STEP, weight="pyramid", batch_size=batch, mode=mode)
            for mode, batch in runs}
    torch.cuda.synchronize()
    launches = {"grid_merge": grid_merge.launches, "grid_merge_by_route": dict(grid_merge.launches_by_route)}
    log(f"{tag} {name} main path launches at {size}^2: {launches}")
    _check_merge_routes(f"{tag} {size}^2 runs", len(runs))
    for mode, batch in runs:
        got = outs.pop(mode).float()
        ref = plain_tiled_d4(model, check, mode)
        err, tol = float((got - ref).abs().max()), PATH_TOL * float(ref.abs().max())
        ok = got.shape == (CLASSES, size, size) and bool(torch.isfinite(got).all()) and err <= tol
        log(f"{tag} {name} tiled_apply_d4_tta {size}^2 mode={mode} batch={batch}, bf16 vs the plain path on the fp32 "
            f"model (TF32 off): max|err| {err:.3e} <= {tol:.3e} (5e-2 * max|ref| {float(ref.abs().max()):.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the {name} tiled d4 path mode={mode} disagrees with the plain path")
        del got, ref
    return launches


@torch.no_grad()
def _tiled_d4_at_size(tag: str, name: str, forward, size: int, gen, smi, launches: dict):
    """K1 alone at the ``size``^2 K = 19 shape (``_k1_at``); then one
    ``size``^2 distributed run of ``forward`` after a warm-up one (cuDNN and
    cuBLAS pick their algorithms): its wall time, MP/s, peak memory and K1's
    one launch, on the cell route, which join ``launches``.  Returns the
    run, for the phase's profile, and its wall time in s."""
    from pytorch_toolbelt_tpu_torch.inference import ImageSlicer, tiled_apply_d4_tta
    from pytorch_toolbelt_tpu_torch.ops import grid_merge

    slicer = ImageSlicer((size, size), TILE, STEP, weight="pyramid")
    ty, tx = ((t - TILE) // STEP + 1 for t in slicer.target_shape)
    stack = torch.randn(ty * tx, CLASSES, TILE, TILE, device=gen.device, generator=gen)
    weight = torch.as_tensor(slicer.weight.astype(np.float32), device=gen.device)
    _k1_at(stack, weight, (ty, tx, STEP, STEP), (size, size), (slicer.margin_top, slicer.margin_left), smi,
           phase=tag)
    del stack
    torch.cuda.empty_cache()

    image = torch.rand(3, size, size, device=gen.device, generator=gen)
    run = lambda: tiled_apply_d4_tta(forward, image, TILE, STEP, weight="pyramid", batch_size=DIST_BATCH,  # noqa: E731
                                     mode="distributed")
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_merge_counts()
    t1 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2**30
    if out.shape != (CLASSES, size, size) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"the {name} {size}^2 run gave a wrong shape or non-finite values")
    del out
    by_route = dict(grid_merge.launches_by_route)
    log(f"{tag} {name} tiled_apply_d4_tta {size}^2 distributed batch={DIST_BATCH} bf16: {wall:.3f} s, "
        f"{size**2 / 1e6 / wall:.2f} MP/s, peak {peak:.2f} GiB allocated; K1 launches by route {by_route} at "
        f"K = {CLASSES} ({smi})")
    _check_merge_routes(f"{tag} {size}^2 distributed", 1)
    launches["grid_merge"] += grid_merge.launches
    for route, n in by_route.items():
        launches["grid_merge_by_route"][route] += n
    return run, wall


def deeplab_r50(dev):
    """DeepLabV3+ on a ResNet-50: ``resnet50_encoder(layers=(1, 4))`` (the
    stride-4 and stride-32 maps), ``DeeplabV3PlusDecoder(**DEEPLAB_DECODER)``,
    ResizeHead(19); seeded weights.  As in resnet34_unet, every Bottleneck's
    last BN and its shortcut BN get their scales cut by RESIDUAL_BN_SCALE, so
    that activations stay of order one.  Returns the fp32 and the bf16 model,
    both channels_last."""
    import copy

    from pytorch_toolbelt_tpu_torch.zoo import DeeplabV3PlusDecoder, EncoderDecoderModel, ResizeHead, resnet50_encoder
    from pytorch_toolbelt_tpu_torch.zoo.encoders.resnet import Bottleneck

    encoder = resnet50_encoder(layers=(1, 4))
    decoder = DeeplabV3PlusDecoder(encoder.get_output_spec(), **DEEPLAB_DECODER)
    model = seed_weights(EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(),
                                                                            num_classes=CLASSES)), SEED + 18)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.mul_(RESIDUAL_BN_SCALE)
                if m.downsample is not None:
                    m.downsample[-1].weight.mul_(RESIDUAL_BN_SCALE)
    model = model.eval().to(dev, memory_format=torch.channels_last)
    return model, copy.deepcopy(model).to(torch.bfloat16)


@torch.no_grad()
def phase_deeplab(dev, smi):
    """DeepLabV3+ on a ResNet-50 through tiled d4 inference: at 2048^2 in
    both modes against the plain path on the fp32 model; K1 alone at the
    5000^2 K = 19 shape; one 5000^2 distributed run for its wall time, peak
    memory and K1's route; under torch.profiler the idle share, device time
    by kind and top kernels; the ASPP alone.  Returns K1's launches and
    launches by route in the main path's runs."""
    t0 = time.perf_counter()
    model, model_bf16 = deeplab_r50(dev)
    forward = image_forward(model_bf16, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    launches = _tiled_d4_check("[18]", "DeepLabV3+-R50", model, forward, DEEPLAB_CHECK_SIZE, gen)
    del model
    run, _ = _tiled_d4_at_size("[18]", "DeepLabV3+-R50", forward, DEEPLAB_SIZE, gen, smi, launches)

    coarse = []  # every batch's coarse map, kept by a hook during the profiled run (after the peak was read)
    hook = model_bf16.decoder.aspp.register_forward_pre_hook(lambda m, args: coarse.append(args[0]))
    _log_profile_by_kind(f"[18] profiled {DEEPLAB_SIZE}^2 distributed run", run, DEEPLAB_KINDS, smi, top=12)
    hook.remove()
    aspp = model_bf16.decoder.aspp
    aspp_ms = cuda_ms(lambda: [aspp(x) for x in coarse], reps=2)
    log(f"[18] the ASPP alone (dilated 3x3 depthwise + 1x1 branches, pooling, projection) on the run's "
        f"{len(coarse)} coarse maps ({sum(x.shape[0] for x in coarse)} views of {list(coarse[0].shape[1:])} bf16, "
        f"batches of {sorted({x.shape[0] for x in coarse})}): {aspp_ms} per run ({smi})")
    del coarse, model_bf16, run
    torch.cuda.empty_cache()
    log(f"[18] phase 18: {time.perf_counter() - t0:.1f} s")
    return launches


def seed_linear_weights(model, seed: int):
    """``seed_weights`` for a model with ``nn.Linear`` layers: convs, norms
    and biases as there, then every Linear weight LeCun-normal (std
    fan_in^-1/2), so that attention logits and the residual stream stay of
    order one."""
    seed_weights(model, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * m.weight.shape[1] ** -0.5)
    return model


def segformer_b2(dev):
    """SegFormer-B2 at its published width: ``mit_b2_encoder()``, no decoder
    (``Identity``), ``SegFormerHead(spec, 19, embedding_dim=768)``; seeded
    weights (``seed_linear_weights``).  Returns the fp32 and the bf16 model,
    both channels_last."""
    import copy

    from pytorch_toolbelt_tpu_torch.nn import Identity
    from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, SegFormerHead, mit_b2_encoder

    encoder = mit_b2_encoder()
    head = SegFormerHead(encoder.get_output_spec(), CLASSES, embedding_dim=SEGFORMER_EMBED)
    model = seed_linear_weights(EncoderDecoderModel(encoder, Identity(), head), SEED + 19)
    model = model.eval().to(dev, memory_format=torch.channels_last)
    return model, copy.deepcopy(model).to(torch.bfloat16)


def _segformer_labels(model) -> dict:
    """{module: kind} of the modules whose GEMM and conv kernels phase 19's
    profile tells apart: the projections, the attention (its matmuls and
    softmax, outside its child modules), the spatial-reduction convs, the
    depthwise 3x3 convs and the patch embeddings."""
    from pytorch_toolbelt_tpu_torch.zoo import EfficientSelfAttention, MixFFN, OverlapPatchEmbed

    gemm = "GEMMs / 1x1 convs"
    labels = {}
    for m in model.modules():
        if isinstance(m, EfficientSelfAttention):
            labels[m] = "attention matmuls and softmax"
            labels.update({lin: gemm for lin in (m.q, m.k, m.v, m.proj)})
            if m.sr is not None:
                labels[m.sr] = "sr convs"
        elif isinstance(m, MixFFN):
            labels.update({m.fc1: gemm, m.fc2: gemm, m.dwconv: "depthwise 3x3"})
        elif isinstance(m, OverlapPatchEmbed):
            labels[m.proj] = "patch-embedding convs"
    head = model.head
    labels.update({conv: gemm for conv in (*head.project, head.fuse_conv, head.final)})
    return labels


def _scale_block_outputs(model):
    """As config3_model does for its residual branches: the last BatchNorm
    of every MBConv, FusedMBConv, MixBlock and InvertedResidual gets its
    scale cut, by RESIDUAL_BN_SCALE where the block adds its input and by
    PROJECTION_BN_SCALE where it does not, so that the activations of a deep
    seeded encoder stay of order one (without, EfficientNetV2-S's grow to
    ~1e5, and MobileNetV2's bf16 error reaches ~5.5% of max on the CPU)."""
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "use_residual"):
                if hasattr(m, "project_bn"):
                    last = m.project_bn
                else:  # FusedMBConv: the projection's BN, or the one BN at expand ratio 1
                    last = m.bn if m.project is None else m.project[-1]
                last.weight.mul_(RESIDUAL_BN_SCALE if m.use_residual else PROJECTION_BN_SCALE)
    return model


def _scale_residual_branches(model):
    """As config3_model does: in the ResNet-family blocks of slice I (the
    ResNet BasicBlock and Bottleneck that HRNet builds on, Res2Net, the SK
    blocks, XResNet) the last BatchNorm of the residual branch and of the
    projection shortcut gets its scale cut by RESIDUAL_BN_SCALE; in the
    pre-activation blocks (WiderResNet's, DPN's), whose branches end in a
    conv, that conv's weight is; and in HRNet's fuse layers every BatchNorm's
    scale is cut by FUSE_BN_SCALE.  So a deep seeded encoder's activations
    stay of order one where branches add up (HRNetV2-W48's logits reach
    ~7e9 without, ~80 with, on a 128^2 CPU run)."""
    from pytorch_toolbelt_tpu_torch.zoo import (DualPathBlock, IdentityResidualBlock, Res2NetBottleneck, SKBasicBlock,
                                               SKBottleneck, XResNetBlock)
    from pytorch_toolbelt_tpu_torch.zoo.encoders.hrnet import _FuseLayer
    from pytorch_toolbelt_tpu_torch.zoo.encoders.resnet import BasicBlock, Bottleneck

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BasicBlock, SKBasicBlock)):
                last = [m.bn2]
            elif isinstance(m, (Bottleneck, Res2NetBottleneck, SKBottleneck)):
                last = [m.bn3]
            elif isinstance(m, XResNetBlock):
                last = [m.convs[-1].bn] + ([] if m.shortcut is None else [m.shortcut.bn])
            elif isinstance(m, (IdentityResidualBlock, DualPathBlock)):
                convs = ([m.conv2 if m.conv3 is None else m.conv3] if isinstance(m, IdentityResidualBlock)
                         else [c for c in (m.conv_c, m.conv_dense) if c is not None])
                for conv in convs:
                    conv.weight.mul_(RESIDUAL_BN_SCALE)
                continue
            elif isinstance(m, _FuseLayer):
                for bn in m.modules():
                    if isinstance(bn, torch.nn.BatchNorm2d):
                        bn.weight.mul_(FUSE_BN_SCALE)
                continue
            else:
                continue
            if getattr(m, "downsample", None) is not None:
                last.append(m.downsample[-1])
            for bn in last:
                bn.weight.mul_(RESIDUAL_BN_SCALE)
    return model


def _forward_times(fn) -> tuple:
    """Times of one call of ``fn``, a forward of a few hundred kernels: (its
    device time between CUDA events, a Timing over ENCODER_WINDOWS windows of
    ENCODER_REPS calls; the host's median ms to launch one call, from a
    synchronized card, with no wait for the card; the card's busy ms per
    call under torch.profiler).  Where the card idles for HOST_BOUND_IDLE or
    more of the event time, the call is bound by the host's launch rate."""
    events = cuda_ms(fn, reps=ENCODER_REPS, warmup=ENCODER_WARMUP, windows=ENCODER_WINDOWS)
    launch = []
    for _ in range(ENCODER_HOST_FORWARDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        launch.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    _, prof = _profiled(lambda: [fn() for _ in range(ENCODER_PROFILED)])
    return events, statistics.median(launch), _device_busy_ms(prof) / ENCODER_PROFILED


@torch.no_grad()
def _encoders_at_width(dev, smi, tag: str, names, seed: int, scale) -> None:
    """Each encoder factory of ``names`` at its published width (seeded
    weights, block outputs cut by ``scale``): one [8, 3, 512, 512] bf16
    forward against the fp32 forward (5e-2 * max|ref| on every feature map);
    then the bf16 forward's device time, the host's time to launch it and
    the card's busy share (``_forward_times``)."""
    import copy

    from pytorch_toolbelt_tpu_torch import zoo

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(ENCODER_BATCH, 3, TILE, TILE, device=dev, generator=gen).contiguous(
        memory_format=torch.channels_last)
    for i, name in enumerate(names):
        model = scale(seed_linear_weights(getattr(zoo, name)(), seed + 1 + i)).eval()
        model = model.to(dev, memory_format=torch.channels_last)
        refs = model(x)
        model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
        del model
        xb = x.to(torch.bfloat16)
        outs = model_bf16(xb)
        errs = []
        for got, ref in zip(outs, refs):
            err, tol = float((got.float() - ref).abs().max()), PATH_TOL * float(ref.abs().max())
            if got.shape != ref.shape or not bool(torch.isfinite(got).all()) or not err <= tol:
                raise AssertionError(f"{name}: a bf16 feature map {tuple(got.shape)} disagrees with fp32: "
                                     f"{err:.3e} > {tol:.3e}")
            errs.append(f"{err / float(ref.abs().max()):.2e}")
        ms, launch_ms, busy_ms = _forward_times(lambda: model_bf16(xb))
        log(f"{tag} {name} [{ENCODER_BATCH}, 3, {TILE}, {TILE}] bf16 vs fp32 (TF32 off): max|err| / max|ref| per map "
            f"{', '.join(errs)} <= {PATH_TOL:.0e} ok; maps {[tuple(o.shape[1:]) for o in outs]}; per forward: {ms} "
            f"between CUDA events ({ENCODER_WINDOWS} windows of {ENCODER_REPS}), host {launch_ms:.3f} ms to launch "
            f"it ({launch_ms / ms:.0%} of the event time), device busy {busy_ms:.3f} ms under torch.profiler (idle "
            f"{1 - busy_ms / ms:.1%} of the event time; bound by the "
            f"{'host' if 1 - busy_ms / ms >= HOST_BOUND_IDLE else 'card'}) ({smi})")
        del model_bf16, outs, refs
        torch.cuda.empty_cache()


@torch.no_grad()
def phase_segformer(dev, smi):
    """SegFormer-B2 through tiled d4 inference: at 2048^2 in both modes
    against the plain path on the fp32 model; K1 alone at the 5000^2 K = 19
    shape; one 5000^2 distributed run for its wall time, peak memory and
    K1's route; under torch.profiler the idle share, device time by kind and
    top kernels; then the other transformer and mobile encoders at their
    published widths.  Returns K1's launches and launches by route in the
    main path's runs."""
    t0 = time.perf_counter()
    model, model_bf16 = segformer_b2(dev)
    forward = image_forward(model_bf16, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    launches = _tiled_d4_check("[19]", "SegFormer-B2", model, forward, SEGFORMER_CHECK_SIZE, gen)
    del model
    run, _ = _tiled_d4_at_size("[19]", "SegFormer-B2", forward, SEGFORMER_SIZE, gen, smi, launches)

    _log_profile_by_kind(f"[19] profiled {SEGFORMER_SIZE}^2 distributed run", run, SEGFORMER_KINDS, smi, top=12,
                         labels=_segformer_labels(model_bf16))
    del model_bf16, run
    torch.cuda.empty_cache()
    _encoders_at_width(dev, smi, "[19]", ENCODERS_19, SEED + 191, _scale_block_outputs)
    log(f"[19] phase 19: {time.perf_counter() - t0:.1f} s")
    return launches


def hrnet_w48(dev):
    """HRNetV2-W48 at its published width: ``hrnet48_encoder()``, no decoder
    (``Identity``), ``HypercolumnHead(spec, 19, mid_channels=720)``; seeded
    weights, residual branches and fuse layers cut by
    ``_scale_residual_branches``.  Returns the fp32 and the bf16 model, both
    channels_last."""
    import copy

    from pytorch_toolbelt_tpu_torch.nn import Identity
    from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, HypercolumnHead, hrnet48_encoder

    encoder = hrnet48_encoder()
    head = HypercolumnHead(encoder.get_output_spec(), CLASSES, mid_channels=HRNET_MID)
    model = _scale_residual_branches(seed_weights(EncoderDecoderModel(encoder, Identity(), head), SEED + 20))
    model = model.eval().to(dev, memory_format=torch.channels_last)
    return model, copy.deepcopy(model).to(torch.bfloat16)


def _hrnet_labels(model) -> dict:
    """{module: kind} of the modules whose convs phase 20's profile tells
    apart: the stem, the stage-1 Bottlenecks, the BasicBlocks of every
    branch, the transitions, the fuse layers and the head."""
    encoder = model.encoder
    labels = {m: "stem" for m in (encoder.conv1, encoder.bn1, encoder.conv2, encoder.bn2)}
    labels[encoder.layer1] = "stage-1 Bottlenecks"
    for step in encoder.transitions:
        labels.update({t: "transitions" for t in step if not isinstance(t, torch.nn.Identity)})
    for stage in encoder.stages:
        for module in stage:
            labels.update({blocks: "BasicBlocks" for blocks in module.branches})
            labels[module.fuse] = "fuse layers"
    labels[model.head] = "head"
    return labels


@torch.no_grad()
def phase_hrnet(dev, smi):
    """HRNetV2-W48 through tiled d4 inference: at 2048^2 in both modes
    against the plain path on the fp32 model; K1 alone at the 5000^2 K = 19
    shape; one 5000^2 distributed run for its wall time, peak memory and
    K1's route; its multiply-adds (FlopCounterMode on one view); under
    torch.profiler the idle share, device time by kind and top kernels; then
    the other CNN encoders of slice I at their published widths.  Returns
    K1's launches and launches by route in the main path's runs."""
    from torch.utils.flop_counter import FlopCounterMode

    from pytorch_toolbelt_tpu_torch.inference import ImageSlicer

    t0 = time.perf_counter()
    model, model_bf16 = hrnet_w48(dev)
    forward = image_forward(model_bf16, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    launches = _tiled_d4_check("[20]", "HRNetV2-W48", model, forward, HRNET_CHECK_SIZE, gen)
    del model
    run, wall = _tiled_d4_at_size("[20]", "HRNetV2-W48", forward, HRNET_SIZE, gen, smi, launches)

    counter = FlopCounterMode(display=False)
    with counter:
        forward(torch.zeros(1, 3, TILE, TILE, device=dev))
    macs = counter.get_total_flops() / 2
    slicer = ImageSlicer((HRNET_SIZE, HRNET_SIZE), TILE, STEP, weight="pyramid")
    views = 2 * len(slicer.crops)  # distributed mode: two views of each tile
    log(f"[20] HRNetV2-W48 multiply-adds (FlopCounterMode, convs): {macs / 1e9:.1f} G per {TILE}^2 view, "
        f"{views} views per {HRNET_SIZE}^2 distributed run = {macs * views / 1e12:.1f} T, "
        f"{2 * macs * views / wall / 1e12:.1f} TFLOP/s over the run's wall ({2 * macs * views / wall / BF16_PEAK:.1%} "
        f"of the bf16 peak) ({smi})")
    _log_profile_by_kind(f"[20] profiled {HRNET_SIZE}^2 distributed run", run, HRNET_KINDS, smi, top=12,
                         labels=_hrnet_labels(model_bf16))
    del model_bf16, run
    torch.cuda.empty_cache()
    _encoders_at_width(dev, smi, "[20]", ENCODERS_20, SEED + 201, _scale_residual_branches)
    log(f"[20] phase 20: {time.perf_counter() - t0:.1f} s")
    return launches


def _scale_slice_j(model):
    """Seeding for the encoders of slice J, so that a deep seeded encoder's
    activations stay within a few hundred: MBConv's last BN as
    ``_scale_block_outputs`` cuts it and the transformer blocks' attention
    and MLP output projections cut by RESIDUAL_BN_SCALE (MaxViT; MaxViT-B +
    FPN's logits reach ~430 on a 128^2 CPU run without the latter, and its
    bf16 error 4.7% of max); NFNet's ``gain`` near one and ``skip_gain`` of
    0.5 + 0.1 N(0, 1), where ``seed_weights`` leaves both at 0.1 N(0, 1)
    (flax initializes them to one and zero, which would leave the residual
    branches out); TResNet's last BN of each residual branch and the
    Hourglass blocks' last conv cut by RESIDUAL_BN_SCALE; and, since each
    hourglass level adds its skip branch to its upsampled branch (x2 a
    level), each stack's feature BN cut by 2^-depth and the merge convs by
    RESIDUAL_BN_SCALE (the Stacked Hourglass's last map reaches ~6e8
    without)."""
    from pytorch_toolbelt_tpu_torch.zoo import (HGBlock, HGResidualBlock, MaxViTBlock, NFBlock, StackedHGEncoder,
                                               TResNetBasicBlock, TResNetBottleneck, WSConv)

    _scale_block_outputs(model)
    gen = torch.Generator().manual_seed(SEED + 210)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaxViTBlock):
                for t in (m.block_attention, m.grid_attention):
                    t.attn.proj.weight.mul_(RESIDUAL_BN_SCALE)
                    t.fc2.weight.mul_(RESIDUAL_BN_SCALE)
            elif isinstance(m, StackedHGEncoder):
                depth, hourglass = 1, m.hourglasses[0]
                while isinstance(hourglass.low2, HGBlock):
                    depth, hourglass = depth + 1, hourglass.low2
                for head in m.heads:
                    head.bn.weight.mul_(2.0**-depth)
                for merge in m.merges:
                    merge.weight.mul_(RESIDUAL_BN_SCALE)
            elif isinstance(m, WSConv):
                m.gain.copy_(1.0 + 0.1 * torch.randn(m.gain.shape, generator=gen))
            elif isinstance(m, NFBlock):
                m.skip_gain.copy_(0.5 + 0.1 * torch.randn((), generator=gen))
            elif isinstance(m, TResNetBasicBlock):
                m.bn2.weight.mul_(RESIDUAL_BN_SCALE)
            elif isinstance(m, TResNetBottleneck):
                m.bn3.weight.mul_(RESIDUAL_BN_SCALE)
            elif isinstance(m, HGResidualBlock):
                m.conv3.weight.mul_(RESIDUAL_BN_SCALE)
    return model


def maxvit_b_fpn(dev):
    """MaxViT-B at its published width on its four stages
    (``maxvit_base_encoder(layers=(1, 2, 3, 4))``), ``FPNDecoder(spec, 256)``,
    ``ResizeHead(19)``; seeded weights (``seed_linear_weights``, then
    ``_scale_slice_j``).  Returns the fp32 and the bf16 model, both
    channels_last."""
    import copy

    from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, maxvit_base_encoder

    encoder = maxvit_base_encoder(layers=(1, 2, 3, 4))
    decoder = FPNDecoder(encoder.get_output_spec(), MAXVIT_FPN)
    model = EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(), num_classes=CLASSES))
    model = _scale_slice_j(seed_linear_weights(model, SEED + 21))
    model = model.eval().to(dev, memory_format=torch.channels_last)
    return model, copy.deepcopy(model).to(torch.bfloat16)


def _maxvit_labels(model) -> dict:
    """{module: kind} of the modules whose kernels phase 21's profile tells
    apart: the stem, each MBConv (its depthwise 3x3 apart), the attention
    (SDPA, outside its projections), its qkv and output projections, the
    MLPs' GEMMs, the window partition and padding copies (in the block
    itself), the FPN and the head."""
    from pytorch_toolbelt_tpu_torch.zoo import MaxViTBlock

    encoder = model.encoder
    labels = {encoder.stem: "stem", encoder.stem_conv: "stem"}
    for m in encoder.modules():
        if isinstance(m, MaxViTBlock):
            labels[m] = "window partition, padding and residual copies"
            labels[m.mbconv] = "MBConv 1x1 convs, SE and BN"
            labels[m.mbconv.depthwise] = "MBConv depthwise 3x3"
            if m.shortcut is not None:
                labels[m.shortcut] = "MBConv 1x1 convs, SE and BN"
            for t in (m.block_attention, m.grid_attention):
                labels[t.attn] = "attention (SDPA)"
                labels.update({t.attn.qkv: "attention projections", t.attn.proj: "attention projections",
                               t.fc1: "MLP GEMMs", t.fc2: "MLP GEMMs"})
    labels[model.decoder] = "FPN"
    labels[model.head] = "head"
    return labels


@torch.no_grad()
def phase_maxvit(dev, smi):
    """MaxViT-B + FPN through tiled d4 inference: at 2048^2 in both modes
    against the plain path on the fp32 model; K1 alone at the 5000^2 K = 19
    shape; one 5000^2 distributed run for its wall time, peak memory and
    K1's route; its multiply-adds (FlopCounterMode on one view); under
    torch.profiler the idle share, device time by kind and top kernels; then
    the encoders of slice J at their published widths.  Returns K1's
    launches and launches by route in the main path's runs."""
    from torch.utils.flop_counter import FlopCounterMode

    from pytorch_toolbelt_tpu_torch.inference import ImageSlicer

    t0 = time.perf_counter()
    model, model_bf16 = maxvit_b_fpn(dev)
    forward = image_forward(model_bf16, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    launches = _tiled_d4_check("[21]", "MaxViT-B + FPN", model, forward, MAXVIT_CHECK_SIZE, gen)
    del model
    run, wall = _tiled_d4_at_size("[21]", "MaxViT-B + FPN", forward, MAXVIT_SIZE, gen, smi, launches)

    counter = FlopCounterMode(display=False)
    with counter:
        forward(torch.zeros(1, 3, TILE, TILE, device=dev))
    macs = counter.get_total_flops() / 2
    slicer = ImageSlicer((MAXVIT_SIZE, MAXVIT_SIZE), TILE, STEP, weight="pyramid")
    views = 2 * len(slicer.crops)  # distributed mode: two views of each tile
    log(f"[21] MaxViT-B + FPN multiply-adds (FlopCounterMode: convs, GEMMs, attention): {macs / 1e9:.1f} G per "
        f"{TILE}^2 view, {views} views per {MAXVIT_SIZE}^2 distributed run = {macs * views / 1e12:.1f} T, "
        f"{2 * macs * views / wall / 1e12:.1f} TFLOP/s over the run's wall ({2 * macs * views / wall / BF16_PEAK:.1%} "
        f"of the bf16 peak) ({smi})")
    _log_profile_by_kind(f"[21] profiled {MAXVIT_SIZE}^2 distributed run", run, MAXVIT_KINDS, smi, top=12,
                         labels=_maxvit_labels(model_bf16))
    del model_bf16, run
    torch.cuda.empty_cache()
    _encoders_at_width(dev, smi, "[21]", ENCODERS_21, SEED + 211, _scale_slice_j)
    log(f"[21] phase 21: {time.perf_counter() - t0:.1f} s")
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
    conv = phase_conv(dev, smi)
    merge = phase_merge(dev, smi)
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
    del model3, model3_bf16
    model34, model34_bf16 = resnet34_unet(dev)
    unet34 = phase_resnet34_unet(dev, smi, model34, model34_bf16)
    launches["grid_merge"] += unet34["grid_merge"]
    for route, n in unet34["grid_merge_by_route"].items():
        launches["grid_merge_by_route"][route] += n
    phase_pad_d2(dev, smi, model34, model34_bf16)
    del model34, model34_bf16
    torch.cuda.empty_cache()
    config5 = phase_config5(dev, smi, fused)
    launches["conv3x3"] += config5["conv3x3"]
    for route, n in config5["conv3x3_by_route"].items():
        launches["conv3x3_by_route"][route] += n
    launches["grid_merge"] += config5["grid_merge"]
    for route, n in config5["grid_merge_by_route"].items():
        launches["grid_merge_by_route"][route] += n
    scatter_launches += config5["scatter_merge"]
    phase_ensemble_3d(dev, smi, model, fused)
    int8_kernels, int8_merges, int8_merges_by_route = phase_int8(dev, smi, model, fused, t_start)
    launches["grid_merge"] += int8_merges
    for route, n in int8_merges_by_route.items():
        launches["grid_merge_by_route"][route] += n
    del model, fused
    torch.cuda.empty_cache()
    train_sorts, example_merges, example_merges_by_route = phase_training(dev, smi)
    sort_launches["radix_sort"] += train_sorts
    launches["grid_merge"] += example_merges
    for route, n in example_merges_by_route.items():
        launches["grid_merge_by_route"][route] += n
    torch.cuda.empty_cache()
    deeplab = phase_deeplab(dev, smi)
    launches["grid_merge"] += deeplab["grid_merge"]
    for route, n in deeplab["grid_merge_by_route"].items():
        launches["grid_merge_by_route"][route] += n
    torch.cuda.empty_cache()
    segformer = phase_segformer(dev, smi)
    launches["grid_merge"] += segformer["grid_merge"]
    for route, n in segformer["grid_merge_by_route"].items():
        launches["grid_merge_by_route"][route] += n
    torch.cuda.empty_cache()
    hrnet = phase_hrnet(dev, smi)
    launches["grid_merge"] += hrnet["grid_merge"]
    for route, n in hrnet["grid_merge_by_route"].items():
        launches["grid_merge_by_route"][route] += n
    torch.cuda.empty_cache()
    maxvit = phase_maxvit(dev, smi)
    launches["grid_merge"] += maxvit["grid_merge"]
    for route, n in maxvit["grid_merge_by_route"].items():
        launches["grid_merge_by_route"][route] += n

    kernels = [
        {"name": "conv3x3", "route": "cuda", "source": "pytorch_toolbelt_tpu_torch/csrc/conv3x3_wgmma.cuh",
         "replaces": "pytorch_toolbelt_tpu/ops/conv_kernels.py:153", "launches": launches["conv3x3"], **conv,
         "launches_by_route": launches["conv3x3_by_route"]},
        {"name": "grid_merge", "route": "cuda", "source": "pytorch_toolbelt_tpu_torch/csrc/tile_merge.cu",
         "replaces": "pytorch_toolbelt_tpu/ops/tile_merge.py:358", "launches": launches["grid_merge"], **merge,
         "launches_by_route": launches["grid_merge_by_route"]},
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
    kernels += int8_kernels
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
