#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (H100): kernels, the
StreetHazards open-set eval, DML embedding training and the Cityscapes NPM
few-shot eval, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel of the path from ``csrc/`` with nvcc, one nvcc per
   source, all started together (timed set-up);
3. kernel phase: each kernel's wrapper against its plain PyTorch version on
   the card at the eval path's shapes, then timed with CUDA events beside
   its plain version, its bound and, where one exists, a library yardstick:
   knn_cosine on raw bf16 and float32 features (atol 2e-5; constant maps
   against the exact neighbour counts, scattered zero pixels, neighbor_size
   1), timed in both, the dtype the knn run hands it reported as the
   path's; its generic path (C above 32 or neighbor_size above 9) at C 64
   with neighbor_size 11, at the 4096-d PPM concat of 90x160 and at the
   eval's map with neighbor_size 11, constant maps against the counts,
   timed at 90x160x4096; fused_bottleneck at the seven block
   geometries of resnet50dilated at the largest pyramid level, the six of
   the DeepLab ResNet-101 (7x7 stem, OS16) at 1024x2048, at ragged small
   shapes and at batch 2, dilation 8 and Cmid 1024, in bf16 (tolerance
   5e-2) and float32 with TF32 off (1e-4), timed in bf16 at both
   backbones' geometries beside the cuDNN chain of the unfused block, with
   its three launches (conv1, conv2, conv3 + skip) also timed apart;
4. slice phase: a synthetic StreetHazards tree of 720x1280 images, a
   full-width resnet50dilated + ppm_deepsup_embedding with seeded random
   weights; the dtype after each decoder module and after the averaging
   under bf16 autocast (scores and ft must stay bf16, as in the JAX
   package); ``cli.eval_ood.main`` on cuda in bf16: OOD.ood dissum, knn,
   dissum with ``fused_blocks=True`` and dissum with
   ``device_metrics=True``; launch counts are zeroed just before each run
   and read just after (knn_cosine once per image in the knn run,
   fused_bottleneck once per routed block per pyramid level per batch in
   the fused run, neither elsewhere); every metric must be finite; the
   device metrics must lie within 2e-5 of the host sweep's; each run's wall
   time per image is split into the device batch, the metric sweep and
   loader waits; then the 5-scale forward of one image, unfused and
   fused, timed alternately six times each, and the routed bottleneck
   modules of both models timed the same way on their inputs at every
   level (medians and every round printed);
5. train phase: a synthetic training tree of 96 720x1280 images;
   ``cli.train_embedding.main`` on cuda in bf16 for 12 steps of the
   full-width model with configs/train_embedding.yaml (batch 8, short
   sides 300-600, long side up to 1000), from the slice phase's seeded
   checkpoint, in epochs of 6 (checkpoints written); every loss finite, no
   step skipped, no kernel launched; s/step (median after 2 warm-up
   steps), imgs/s, loader wait s/step, peak memory and each step's shape
   and time printed; then the epoch-1 checkpoint through
   ``cli.eval_ood.main`` on 2 images, with finite metrics;
6. device check: one small image through the full-width model in fp32 with
   TF32 off, on cuda and on the CPU, unfused and fused; the score maps must
   agree; and the fused route against the unfused one on cuda in bf16;
   then one train step of a narrow twin in fp32 with TF32 off, cuda
   against the CPU: loss, updated parameters and BN statistics;
7. deeplab phase: a synthetic Cityscapes tree of 1024x2048 images (8
   support images, 6 with car over 11 %; 16 val images with car, truck and
   bus); the full-width deeplabv3plus_embedding_resnet101 (OS16, 16
   classes, ASPP rates 6, 12, 18) with seeded random weights and a
   data-dependent start, 31 of its 33 bottlenecks on the fused route;
   ``cli.extract_prototypes.main`` (5 shots), then ``cli.eval_embedding.main``
   in bf16 on the 16 val images, unfused and with ``fused_blocks=True``:
   launch counts (fused_bottleneck 31 per image in the fused run, 0 in the
   other; knn_cosine 0), finite metrics, the NPM override on some pixels
   and not all, wall time per image split into the device batch, loader
   waits and the host confusion matrix, imgs/s and peak memory; the
   1024x2048 forward, unfused and fused, alternately six rounds each;
   ``cli.test_deeplab.main`` with deeplabv3plus_resnet101 (19 classes,
   unknowns scored) on 4 images; and a 64x128 crop through the embedding
   model in fp32 with TF32 off, cuda (unfused and fused) against the CPU.

The last two lines of standard output are the ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12        # bf16 tensor cores
PEAK_BYTES = 3.35e12            # HBM3
KNN_ATOL = 2e-5                 # as tests/test_pallas.py holds the TPU kernel
# fused_bottleneck vs its plain version, as tests/test_pallas_block.py
# holds the TPU kernel: float32 (TF32 off) differs by summation order only;
# bf16 rounds y1, y2 and the output to 8 bits of mantissa, and a sum taken
# in another order can put a value on the other side of a rounding step
BLOCK_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DEVICE_CHECK_RTOL = 1e-3        # of the largest |score|: fp32, TF32 off,
#                                 cuDNN vs CPU conv summation orders
# the fused route in bf16: both routes round to bf16, at different places
# (cuDNN after each conv, BN and residual add, with bf16 conv weights and
# BN in float32; the kernel after y1, y2 and the block, with the BN scale
# folded into bf16 weights), over 15 blocks of a random-weight network. How
# far bf16 carries that network from float32 is measured on the same
# input, as the unfused route's distance from the fp32 CPU forward and its
# argmax agreement with it. The fused route may be twice as far (plus the
# fp32 allowance above) and agree with the argmax 0.05 less often.
BF16_ROUTE_FACTOR = 2.0
BF16_ROUTE_ARGMAX_SLACK = 0.05
METRIC_ATOL = 2e-5              # device vs host sweep (test_metrics_device)
# resnet50dilated OS8 bottlenecks at the largest pyramid level (568x1000
# input): (name, h, w, Cin, Cmid, Cout, dilation, downsample, blocks of
# this geometry in one forward); layer2.0 has stride 2 and is not fused
BLOCK_GEOMETRIES = (
    ("layer1.0", 142, 250, 128, 64, 256, 1, True, 1),
    ("layer1.1-2", 142, 250, 256, 64, 256, 1, False, 2),
    ("layer2.1-3", 71, 125, 512, 128, 512, 1, False, 3),
    ("layer3.0", 71, 125, 512, 256, 1024, 1, True, 1),
    ("layer3.1-5", 71, 125, 1024, 256, 1024, 2, False, 5),
    ("layer4.0", 71, 125, 1024, 512, 2048, 2, True, 1),
    ("layer4.1-2", 71, 125, 2048, 512, 2048, 4, False, 2),
)
# deeplabv3plus_embedding_resnet101 (7x7 stem, OS16) bottlenecks at the
# Cityscapes eval's 1024x2048 input, same fields; layer2.0 and layer3.0
# have stride 2 and are not fused: 31 of the 33 blocks are
DEEPLAB_BLOCK_GEOMETRIES = (
    ("layer1.0", 256, 512, 64, 64, 256, 1, True, 1),
    ("layer1.1-2", 256, 512, 256, 64, 256, 1, False, 2),
    ("layer2.1-3", 128, 256, 512, 128, 512, 1, False, 3),
    ("layer3.1-22", 64, 128, 1024, 256, 1024, 1, False, 22),
    ("layer4.0", 64, 128, 1024, 512, 2048, 1, True, 1),
    ("layer4.1-2", 64, 128, 2048, 512, 2048, 2, False, 2),
)
# ragged small shapes: odd sizes, maps smaller than a patch or the
# dilation; then layer4 at the smallest pyramid level (304x536) at batch
# 2, dilation 8 and Cmid 1024, which a one-pass tile with a y1 halo and
# the conv2 sum in shared memory cannot hold
# (n, h, w, Cin, Cmid, Cout, dilation, downsample)
BLOCK_RAGGED = (
    (2, 9, 13, 128, 64, 256, 1, True),
    (1, 5, 7, 512, 128, 512, 1, False),
    (2, 11, 3, 1024, 256, 1024, 2, False),
    (1, 6, 11, 2048, 512, 2048, 4, False),
    (1, 3, 3, 1024, 512, 2048, 2, True),
    (2, 38, 67, 2048, 512, 2048, 4, False),
    (1, 23, 37, 2048, 512, 2048, 8, False),
    (1, 19, 29, 1024, 1024, 2048, 2, True),
)
N_IMAGES = 16
FULL_SIZE = (720, 1280)
# the PPMDeepsup 4096-d concat at feature resolution (the largest level,
# 720x1280 / 8), which the knn kernel's generic path takes
GENERIC_KNN_SHAPE = (90, 160, 4096)
# training: configs/train_embedding.yaml's batch of 8, 12 steps, epochs of 6
# (one ends and writes its checkpoint), on 96 images (each read once)
TRAIN_STEPS = 12
TRAIN_EPOCH_ITERS = 6
N_TRAIN_IMAGES = 96
TRAIN_WARMUP = 2
# the fp32 train-step check, cuda against the CPU on the narrow twin
# (TF32 off): the loss rtol 1e-4 (convs summed in another order); every
# parameter after the SGD step rtol 1e-5 plus lr x 2e-2 of its gradient's
# largest magnitude (float32 rounding of this twin's gradients reaches
# 1.6e-2 of a tensor's largest magnitude, float32 against float64 on the
# CPU, where a ReLU input lies within rounding of 0); BN running statistics
# 1e-4 of the tensor's largest magnitude plus 1e-6 (a running mean is 0.1
# times a batch mean of activations that cuDNN sums in another order, so
# its error scales with the activations, not with the mean)
TRAIN_CHECK_LOSS_RTOL = 1e-4
TRAIN_CHECK_GRAD_FRAC = 2e-2
TRAIN_CHECK_BN_TOL = (1e-4, 1e-6)
# the Cityscapes NPM eval (deeplabv3plus_embedding_resnet101, OS16, 16
# classes, 5 shots) at full resolution: 8 support images, 6 of them with
# car over 11 % of the image; 16 val images with car, truck and bus; the
# closed-set eval (deeplabv3plus_resnet101, 19 classes) on 4 of them
CITYSCAPES_SIZE = (1024, 2048)
N_SUPPORT_IMAGES = 8
N_VAL_IMAGES = 16
N_CLOSED_SET_IMAGES = 4
DEEPLAB_ROUTED_BLOCKS = 31
# the raw label ids of the 19 Cityscapes train classes; car, truck, bus
CITYSCAPES_TRAIN_RAW_IDS = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24,
                            25, 26, 27, 28, 31, 32, 33)
CAR, TRUCK, BUS = 26, 27, 28
SEED = 0
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def knn_cosine_bound_ms(h, w, c, itemsize=4):
    """(operations ms, bytes ms): the least time for the knn map of an
    (h, w, c) feature map of ``itemsize``-byte floats, from its minimal
    work.

    The map is linear in the neighbours, out[p] = f_p . S_p with S_p the
    sum of the normalised neighbours, and S_p is two offset k x k box sums
    per channel (k = neighbor_size - 1), whatever k is. Per pixel and
    channel: normalisation 3 flops (square, add, scale), a separable sliding
    box sum 4 (add and subtract along W, then along H), the two boxes
    combined 1, the dot product 2; per pixel 3 more (sqrt, max,
    reciprocal). Bytes: the features read once and the float32 map written
    once.
    """
    ops = h * w * (10 * c + 3)
    nbytes = itemsize * h * w * c + 4 * h * w
    return ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def fused_bottleneck_bound_ms(h, w, cin, cmid, cout, down, itemsize=2,
                              peak_flops=PEAK_BF16_FLOPS):
    """(operations ms, bytes ms): the least time for one fused block on an
    (h, w) map, from its minimal work: the four products once (2 flops a
    multiply-add), x read once, the output written once, the weights (in
    x's type) and float32 biases read once."""
    macs = cin * cmid + 9 * cmid * cmid + cmid * cout + (cin * cout
                                                         if down else 0)
    ops = 2 * h * w * macs
    nbiases = 2 * cmid + cout + (cout if down else 0)
    nbytes = itemsize * (h * w * (cin + cout) + macs) + 4 * nbiases
    return ops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3


# ---------------------------------------------------------------------------
def build_kernels():
    """Build every kernel of the path, one nvcc per source, all at once."""
    from concurrent.futures import ThreadPoolExecutor

    from open_world_semantic_segmentation_tpu_torch.ops import _build

    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    tic = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    log(f"build: {', '.join(sources)} in {time.perf_counter() - tic:.1f} s")


def kernel_phase():
    """knn_cosine (the CUDA kernel) vs knn_cosine_plain on the card, on raw
    float32 and bf16 features; then timed at the eval shape in both."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.ops import knn

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    max_err = 0.0

    def check(name, got, want):
        nonlocal max_err
        err = (got - want).abs().max().item()
        log(f"knn_cosine {name}: max |err| {err:.3g}")
        if not err <= KNN_ATOL or not torch.isfinite(got).all():
            raise AssertionError(f"knn_cosine disagrees: {name}: {err}")
        max_err = max(max_err, err)

    for dname, dtype in dtypes.items():
        for shape, ns in (((720, 1280, 13), 9), ((45, 80, 13), 9),
                          ((9, 17, 4), 9), ((64, 128, 19), 3),
                          ((65, 95, 13), 9), ((40, 50, 13), 1)):
            ft = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            got = knn.knn_cosine(ft, ns)
            torch.cuda.synchronize()
            check(f"{dname} {shape} neighbor_size {ns}", got,
                  knn.knn_cosine_plain(ft, ns))
        # every pixel the same vector: the exact answer is the count of
        # in-image neighbours
        for shape, ns in (((720, 1280, 13), 9), ((20, 30, 13), 9),
                          ((12, 17, 7), 3)):
            v = torch.randn(shape[-1], generator=gen, device="cuda") * 3
            got = knn.knn_cosine(v.to(dtype).expand(shape), ns)
            check(f"{dname} constant map {shape} neighbor_size {ns} vs the "
                  f"neighbour counts", got.cpu(),
                  knn.knn_neighbour_counts(shape[0], shape[1], ns))
        # zero pixels scattered among non-zero ones score 0 and add nothing
        ft = torch.randn((720, 1280, 13), generator=gen, device="cuda")
        ft[torch.rand((720, 1280), generator=gen, device="cuda") < 0.05] = 0
        ft = ft.to(dtype)
        got = knn.knn_cosine(ft)
        check(f"{dname} 5% zero pixels (720, 1280, 13)", got,
              knn.knn_cosine_plain(ft))
        if torch.count_nonzero(got[(ft == 0).all(-1)]).item() != 0:
            raise AssertionError("knn_cosine of a zero pixel is not 0")
        zero = knn.knn_cosine(torch.zeros((720, 1280, 13), device="cuda",
                                          dtype=dtype))
        if torch.count_nonzero(zero).item() != 0:
            raise AssertionError("knn_cosine of zero features is not 0")

    # the generic path (C above 32 or neighbor_size above 9): the 4096-d
    # PPM concat at feature resolution, C 64 with neighbor_size 11, the
    # eval's map with neighbor_size 11; constant maps against the counts
    for dname, dtype in dtypes.items():
        for shape, ns in (((40, 56, 64), 11), ((90, 160, 4096), 9),
                          ((33, 70, 13), 11)):
            ft = torch.randn(shape, generator=gen, device="cuda")
            ft[torch.rand(shape[:2], generator=gen, device="cuda") < 0.05] = 0
            ft = ft.to(dtype)
            got = knn.knn_cosine(ft, ns)
            torch.cuda.synchronize()
            check(f"generic {dname} {shape} neighbor_size {ns}", got,
                  knn.knn_cosine_plain(ft, ns))
        for shape, ns in (((30, 40, 64), 11), ((12, 9, 4096), 9)):
            v = torch.randn(shape[-1], generator=gen, device="cuda") * 3
            got = knn.knn_cosine(v.to(dtype).expand(shape), ns)
            check(f"generic {dname} constant map {shape} neighbor_size {ns} "
                  f"vs the neighbour counts", got.cpu(),
                  knn.knn_neighbour_counts(shape[0], shape[1], ns))
    generic = {"shape": list(GENERIC_KNN_SHAPE), "neighbor_size": 9}
    for dname, dtype in dtypes.items():
        ft = torch.randn(GENERIC_KNN_SHAPE, generator=gen,
                         device="cuda").to(dtype)
        t_ops, t_bytes = knn_cosine_bound_ms(*GENERIC_KNN_SHAPE,
                                             ft.element_size())
        generic[dname] = {
            "ms": cuda_time_ms(lambda ft=ft: knn.knn_cosine(ft), iters=10),
            "plain_ms": cuda_time_ms(lambda ft=ft: knn.knn_cosine_plain(ft),
                                     iters=3),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        log(f"knn_cosine generic {dname} {list(GENERIC_KNN_SHAPE)}: "
            + json.dumps(generic[dname]))

    # timing at the eval path's shape: the wrapper and the raw launch
    h, w, c = 720, 1280, 13
    halo = 8
    lib = knn._library()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((h, w), device="cuda")
    times = {}
    for dname, dtype in dtypes.items():
        ft = torch.randn((h, w, c), generator=gen, device="cuda").to(dtype)
        size = ft.element_size()

        def raw(ft=ft, size=size):
            if lib.knn_cosine(ft.data_ptr(), size, out.data_ptr(), h, w, c,
                              halo, 1e-8, stream) != 0:
                raise RuntimeError("knn_cosine launch failed")

        raw()
        t_ops, t_bytes = knn_cosine_bound_ms(h, w, c, size)
        times[dname] = {
            "ms": cuda_time_ms(lambda ft=ft: knn.knn_cosine(ft)),
            "kernel_ms": cuda_time_ms(raw),
            "plain_ms": cuda_time_ms(lambda ft=ft: knn.knn_cosine_plain(ft),
                                     iters=5),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        log(f"knn_cosine {dname} {[h, w, c]}: " + json.dumps(times[dname]))
    # ms, kernel_ms, plain_ms and the bound are filled in from the dtype
    # that the knn run hands the kernel (``path_dtype``)
    return {"name": "knn_cosine",
            "route": "cuda",
            "source": "open_world_semantic_segmentation_tpu_torch/csrc/"
                      "knn_cosine.cu",
            "replaces": "open_world_semantic_segmentation_tpu/ops/"
                        "pallas_knn.py:87",
            "launches": None,                     # filled from the main path
            "max_abs_err": max_err,
            "library_ms": None,  # no single PyTorch call computes this map
            "shape": [h, w, c],
            "by_dtype": times,
            "generic": generic}


def set_path_dtype(row, dtype):
    """The knn row's times and bound at the dtype the eval path uses."""
    row.update(row["by_dtype"][dtype], path_dtype=dtype)


def _block_inputs(gen, n, h, w, cin, cmid, cout, down, dtype):
    """NHWC input of unit scale and folded weights of std sqrt(1/fan_in),
    so each product keeps the scale of a trained network's activations;
    biases small."""
    import torch

    def mk(*shape, fan_in=1):
        t = torch.randn(shape, generator=gen, device="cuda")
        return t / fan_in ** 0.5

    ws = [mk(cin, cmid, fan_in=cin), 0.1 * mk(cmid),
          mk(3, 3, cmid, cmid, fan_in=9 * cmid), 0.1 * mk(cmid),
          mk(cmid, cout, fan_in=cmid), 0.1 * mk(cout)]
    ws += ([mk(cin, cout, fan_in=cin), 0.1 * mk(cout)] if down
           else [None, None])
    # the kernel's operand types: weights in x's dtype, biases float32
    ws = [None if t is None else t.to(dtype) if t.dim() > 1 else t
          for t in ws]
    return torch.relu(mk(n, h, w, cin)).to(dtype), ws


def _cudnn_chain(x, ws, d):
    """The unfused block as cuDNN runs it: conv1x1, conv3x3_d, conv1x1, the
    downsample, add, relu, on channels_last bf16 (``tools/bench_block.py``'s
    yardstick). Only timed here: the port never calls it on the route."""
    import torch
    import torch.nn.functional as F

    w1, b1, w2, b2, w3, b3, wd, bd = ws
    cl = torch.channels_last
    xc = x.permute(0, 3, 1, 2)                   # NHWC -> channels_last NCHW
    w1c = w1.t()[:, :, None, None].contiguous(memory_format=cl)
    w2c = w2.permute(3, 2, 0, 1).contiguous(memory_format=cl)
    w3c = w3.t()[:, :, None, None].contiguous(memory_format=cl)
    bias = [b.to(x.dtype) for b in (b1, b2, b3)]
    args = None
    if wd is not None:
        args = (wd.t()[:, :, None, None].contiguous(memory_format=cl),
                bd.to(x.dtype))

    def run():
        y = F.relu(F.conv2d(xc, w1c, bias[0]))
        y = F.relu(F.conv2d(y, w2c, bias[1], padding=d, dilation=d))
        y = F.conv2d(y, w3c, bias[2])
        skip = xc if args is None else F.conv2d(xc, *args)
        return F.relu(y + skip)

    return run


def fused_kernel_phase():
    """fused_bottleneck (the CUDA kernel) vs fused_bottleneck_plain on the
    card at the geometries of both backbones and ragged shapes, bf16 and
    float32; then timed at both backbones' geometries."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.ops.fused_block import (
        fused_bottleneck, fused_bottleneck_plain)

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = [(1, *g[1:8]) for g in BLOCK_GEOMETRIES
              + DEEPLAB_BLOCK_GEOMETRIES] + list(BLOCK_RAGGED)
    max_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        tol = BLOCK_TOL[name]
        for n, h, w, cin, cmid, cout, d, down in shapes:
            x, ws = _block_inputs(gen, n, h, w, cin, cmid, cout, down, dtype)
            got = fused_bottleneck(x, *ws, dilation=d).float()
            torch.cuda.synchronize()
            want = fused_bottleneck_plain(x, *ws, dilation=d).float()
            err = (got - want).abs()
            bad = (err > tol + tol * want.abs()).sum().item()
            log(f"fused_bottleneck {name} {(n, h, w, cin, cmid, cout)} "
                f"d {d} down {down}: max |err| {err.max().item():.3g} "
                f"(max |plain| {want.abs().max().item():.3g}), {bad} over "
                f"rtol = atol = {tol}")
            if bad or not torch.isfinite(got).all():
                raise AssertionError(f"fused_bottleneck disagrees at "
                                     f"{(n, h, w, cin, cmid, cout, d)}")
            max_err[name] = max(max_err.get(name, 0.0),
                                err.max().item())
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32

    per_geometry, totals = time_block_geometries(BLOCK_GEOMETRIES, gen)
    deeplab_rows, deeplab_totals = time_block_geometries(
        DEEPLAB_BLOCK_GEOMETRIES, gen)
    return {
        "name": "fused_bottleneck",
        "route": "cuda",
        "source": "open_world_semantic_segmentation_tpu_torch/csrc/"
                  "fused_bottleneck.cu",
        "replaces": "open_world_semantic_segmentation_tpu/ops/"
                    "pallas_block.py:211",
        "launches": None,                       # filled from the main path
        "max_abs_err": max_err["bfloat16"],
        "max_abs_err_float32": max_err["float32"],
        # sums over the 15 fused blocks of one forward at 568x1000, bf16
        "ms": totals["ms"],
        "kernel_ms": totals["kernel_ms"],
        "conv1_ms": totals["conv1_ms"],
        "conv2_ms": totals["conv2_ms"],
        "conv3_ms": totals["conv3_ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": totals["bound_by"],
        "library_ms": totals["library_ms"],     # the cuDNN chain
        "per_geometry": per_geometry,
        # the 31 fused blocks of one deeplabv3plus_embedding_resnet101
        # forward at 1024x2048 (the NPM eval), bf16; launches on that path
        # are filled in from its fused run
        "deeplab": {**deeplab_totals, "launches": None,
                    "per_geometry": deeplab_rows},
    }


def time_block_geometries(geometries, gen):
    """Time fused_bottleneck in bf16 at ``geometries``, one image each: the
    wrapper, the three launches alone (``kernel_ms``) and each launch
    apart, the plain version, the cuDNN chain and the bound. Returns the
    rows and their sums over the blocks of one forward."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.ops import fused_block
    from open_world_semantic_segmentation_tpu_torch.ops.fused_block import (
        fused_bottleneck, fused_bottleneck_plain)

    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    totals = dict.fromkeys(("ms", "kernel_ms", "conv1_ms", "conv2_ms",
                            "conv3_ms", "plain_ms", "library_ms", "ops_ms",
                            "bytes_ms", "bound_ms"), 0.0)
    for name, h, w, cin, cmid, cout, d, down, count in geometries:
        x, ws = _block_inputs(gen, 1, h, w, cin, cmid, cout, down,
                              torch.bfloat16)
        launch, _ = fused_block.fused_bottleneck_launcher(x, *ws,
                                                          dilation=d)
        row = {"block": name, "shape": [h, w, cin, cmid, cout, d],
               "downsample": down, "per_forward": count,
               "ms": cuda_time_ms(
                   lambda: fused_bottleneck(x, *ws, dilation=d)),
               "kernel_ms": cuda_time_ms(launch),
               # conv2 and conv3 read what the earlier launches left in
               # the scratch y1 and y2
               "conv1_ms": cuda_time_ms(lambda: launch(1)),
               "conv2_ms": cuda_time_ms(lambda: launch(2)),
               "conv3_ms": cuda_time_ms(lambda: launch(4)),
               "plain_ms": cuda_time_ms(
                   lambda: fused_bottleneck_plain(x, *ws, dilation=d),
                   iters=5),
               "library_ms": cuda_time_ms(_cudnn_chain(x, ws, d)),
               "plan": fused_block.launch_plan(1, h, w, cmid, cout, sms)}
        t_ops, t_bytes = fused_bottleneck_bound_ms(h, w, cin, cmid, cout,
                                                   down)
        row.update(ops_ms=t_ops, bytes_ms=t_bytes,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        log(f"fused_bottleneck {name} {[h, w]}: " + json.dumps(row))
        rows.append(row)
        for key in totals:
            totals[key] += count * row[key]
    totals["bound_by"] = ("operations" if totals["ops_ms"]
                          >= totals["bytes_ms"] else "bytes")
    return rows, totals


# ---------------------------------------------------------------------------
def write_street_tree(root, n, size, seed, split="test"):
    """StreetHazards-format tree: blocky class-coloured RGB images with
    noise, L-mode labels 1..13 and an anomaly blob (raw 14) in the test
    split; ``<split>.odgt`` lists them."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    palette = rng.integers(0, 255, (15, 3))
    records = []
    # the images are drawn in order here; PNG encoding releases the GIL,
    # so the files are written by a pool of threads
    with ThreadPoolExecutor(8) as pool:
        saves = []
        for i in range(n):
            lab = np.full((h, w), 1 + i % 13, np.uint8)
            for _ in range(12):
                r0 = rng.integers(0, h - h // 10)
                c0 = rng.integers(0, w - w // 10)
                lab[r0:r0 + rng.integers(h // 15, h // 2),
                    c0:c0 + rng.integers(w // 15, w // 2)] = \
                    rng.integers(1, 14)
            if split == "test":
                bh, bw = h // 4, w // 5
                r0, c0 = rng.integers(0, h - bh), rng.integers(0, w - bw)
                lab[r0:r0 + bh, c0:c0 + bw] = 14
            img = palette[lab] + rng.normal(0, 20, (h, w, 3))
            img = np.clip(img, 0, 255).astype(np.uint8)
            ip = f"images/{split}/t1/{i}.png"
            ap = f"annotations/{split}/t1/{i}.png"
            for p, arr, mode in ((ip, img, "RGB"), (ap, lab, "L")):
                path = os.path.join(root, p)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                saves.append(pool.submit(Image.fromarray(arr, mode).save,
                                         path, compress_level=1))
            records.append({"fpath_img": ip, "fpath_segm": ap, "height": h,
                            "width": w})
        for save in saves:
            save.result()
    odgt = os.path.join(root, f"{split}.odgt")
    with open(odgt, "w") as f:
        f.write(json.dumps(records) + "\n")
    return odgt


def write_random_checkpoint(cfg, root, seed):
    """Seeded random weights for the full-width model, saved as the
    reference's encoder/decoder .pth pair, with a data-dependent start:
    BN running statistics are taken from one forward over the first two
    eval images, so every BN normalises its input as a trained one would,
    and the last 1x1 conv is scaled to an embedding std of 0.8, the scale
    of the one-hot centers (magnitude 3). Without that the 50-layer residual
    stream grows until every dissum value clips at 400 and the min-max
    normalised map is 0/0."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.data.odgt import (
        ValPipeline)

    model = build_anomaly_model(cfg, DEVICE)
    init_or_load_variables(cfg, model, seed=seed)
    # two images: BN over the 1x1 pooled PPM branch needs a batch of 2
    items = list(ValPipeline(cfg.DATASET.root_dataset, cfg.DATASET.list_val,
                             img_sizes=cfg.DATASET.imgSizes[:1],
                             max_sample=2))
    img = torch.from_numpy(
        np.concatenate([it["img_data"][0] for it in items])).to(DEVICE)
    seg_size = items[0]["seg_label"].shape[1:3]
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None          # running stats = this batch's
    with torch.no_grad():
        model.train()(img, seg_size=seg_size)
        emb_std = model.eval()(img, seg_size=seg_size)["ft"].std().item()
        head = model.decoder.conv_last[4]
        head.weight.mul_(0.8 / emb_std)
        head.bias.mul_(0.8 / emb_std)
    paths = []
    for part in ("encoder", "decoder"):
        path = os.path.join(root, f"{part}_epoch_0.pth")
        torch.save(getattr(model, part).state_dict(), path)
        paths.append(path)
    return paths


def slice_phase(root):
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import eval_ood
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.ops.fused_block import (
        fused_bottleneck)
    from open_world_semantic_segmentation_tpu_torch.ops.knn import knn_cosine
    from open_world_semantic_segmentation_tpu_torch.openset import scoring

    odgt = write_street_tree(root, N_IMAGES, FULL_SIZE, SEED)
    cfg = load_config("configs/test_ood_street.yaml", [
        "DATASET.root_dataset", root, "DATASET.list_val", odgt])
    enc, dec = write_random_checkpoint(cfg, root, SEED)
    cfg.MODEL.weights_encoder, cfg.MODEL.weights_decoder = enc, dec
    dtype_flow(cfg)
    routed = fused_route_verdicts(cfg)

    # warm-up (CUDA context, cuDNN heuristics, lazy module loading): the
    # first images of a process otherwise take seconds, not milliseconds
    cfg.OOD.ood = "dissum"
    eval_ood.main(cfg, torch.bfloat16, max_images=2, batch_images=2,
                  device=DEVICE)

    batch = 2
    n_levels = len(cfg.DATASET.imgSizes)
    n_batches = -(-N_IMAGES // batch)
    # run name -> (OOD.ood, eval_ood.main keywords, expected launches)
    runs = {
        "dissum": ("dissum", {}, {"knn_cosine": 0, "fused_bottleneck": 0}),
        "knn": ("knn", {}, {"knn_cosine": N_IMAGES, "fused_bottleneck": 0}),
        "dissum_fused": ("dissum", {"fused_blocks": True},
                         {"knn_cosine": 0,
                          "fused_bottleneck": n_batches * n_levels * routed}),
        "dissum_device_metrics": ("dissum", {"device_metrics": True},
                                  {"knn_cosine": 0, "fused_bottleneck": 0}),
    }
    kernels = {"knn_cosine": knn_cosine, "fused_bottleneck": fused_bottleneck}
    summaries = {}
    launches = {}
    # the dtypes of the features the eval hands the knn kernel
    knn_dtypes = set()

    def knn_spy(ft, *args, **kwargs):
        knn_dtypes.add(str(ft.dtype).split(".")[-1])
        return knn_cosine(ft, *args, **kwargs)

    for run, (method, kw, want) in runs.items():
        cfg.OOD.ood = method
        for fn in kernels.values():
            fn.launches = 0
        scoring.knn_cosine = knn_spy
        try:
            result = eval_ood.main(cfg, torch.bfloat16, batch_images=batch,
                                   device=DEVICE, **kw)
        finally:
            scoring.knn_cosine = knn_cosine
        launches[run] = {k: fn.launches for k, fn in kernels.items()}
        n = result["images"]
        summary = {k: result[k] for k in ("mean_iou", "accuracy", "auroc",
                                          "aupr", "fpr")}
        # the loop's wall time per image, split: device batch, metric
        # sweep (host, or the readback of the device metrics), waits on
        # the prefetch thread, and the rest
        split = {"forward_s_per_img": result["inference_time"],
                 "metric_s_per_img": result["metric_time"],
                 "wait_s_per_img": result["wait_time"]}
        split["other_s_per_img"] = result["seconds"] / n - sum(split.values())
        summary.update(images=n, seconds=result["seconds"],
                       imgs_per_s=n / result["seconds"], **split)
        log(f"eval_ood {run}: " + json.dumps(summary) + " launches "
            + json.dumps(launches[run]))
        if n != N_IMAGES:
            raise AssertionError(f"{run}: evaluated {n} images")
        for key, value in summary.items():
            if value is None or not np.isfinite(value):
                raise AssertionError(f"{run}: {key} = {value}")
        if launches[run] != want:
            raise AssertionError(f"{run}: launches {launches[run]}, want "
                                 f"{want}")
        summaries[run] = summary
    log(f"knn_cosine input dtypes on the eval path: {sorted(knn_dtypes)}")
    if knn_dtypes != {"bfloat16"}:
        raise AssertionError(f"knn input dtypes {knn_dtypes}, want bf16 "
                             "(the model dtype, as in the JAX package)")
    summaries["knn_input_dtype"] = knn_dtypes.pop()
    log(f"forward s/img: default {summaries['dissum']['forward_s_per_img']}"
        f", fused_blocks {summaries['dissum_fused']['forward_s_per_img']}")
    for key in ("auroc", "aupr", "fpr"):
        host = summaries["dissum"][key]
        dev = summaries["dissum_device_metrics"][key]
        log(f"device metrics {key}: {dev} vs host sweep {host}, "
            f"|diff| {abs(dev - host):.3g}")
        if not abs(dev - host) <= METRIC_ATOL:
            raise AssertionError(f"device {key} {dev} vs host {host}")
    summaries["forward_comparison"] = forward_comparison(cfg)
    return summaries, launches, cfg


def dtype_flow(cfg):
    """Under bf16 autocast on the card: the dtype after each module and
    functional op of the decoder and of scores and ft after the averaging
    of two scales, for the full-width model on small inputs, and what
    autocast itself makes of a bf16 sum and a bf16 bilinear interpolation.
    scores and ft must be bf16, the model dtype, as in the JAX package at
    dtype=bf16."""
    import torch

    import torch.nn.functional as F

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.models import decoders
    from open_world_semantic_segmentation_tpu_torch.openset.evaluator import (
        multi_scale_forward)

    model = init_or_load_variables(cfg, build_anomaly_model(cfg, DEVICE))
    flow = {}

    def record(name):
        def hook(_, args, out):
            outs = out if isinstance(out, (list, tuple)) else [out]
            flow[name] = sorted({str(o.dtype).split(".")[-1] for o in outs})
        return hook

    hooks = [m.register_forward_hook(record(name))
             for name, m in model.decoder.named_modules() if name]
    # the decoder's functional ops, wrapped where the decoder calls them
    wrapped = {name: getattr(decoders, name)
               for name in ("one_hot_center_logits", "bilinear_resize")}

    def spy(name, fn):
        def run(*args, **kwargs):
            y = fn(*args, **kwargs)
            flow.setdefault(name, set()).add(str(y.dtype).split(".")[-1])
            return y
        return run

    for name, fn in wrapped.items():
        setattr(decoders, name, spy(name, fn))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    pyramid = [torch.randn((1, h, w, 3), generator=gen, device=DEVICE)
               for h, w in ((64, 96), (96, 144))]
    try:
        with torch.no_grad(), torch.autocast(DEVICE, dtype=torch.bfloat16):
            out = model(pyramid[0], seg_size=(96, 144))
            scores, ft = multi_scale_forward(model, pyramid, (96, 144))
            # what autocast makes of the two ops the port used to leave to
            # it: a bf16 sum, and a bf16 bilinear interpolation
            x = torch.randn((1, 13, 8, 8), generator=gen, device=DEVICE,
                            dtype=torch.bfloat16)
            flow["autocast (x * x).sum(-1)"] = str(
                (x * x).sum(-1).dtype).split(".")[-1]
            flow["autocast F.interpolate bilinear"] = str(F.interpolate(
                x, size=(16, 16), mode="bilinear",
                align_corners=False).dtype).split(".")[-1]
    finally:
        for hook in hooks:
            hook.remove()
        for name, fn in wrapped.items():
            setattr(decoders, name, fn)
    flow.update({k: sorted(v) for k, v in flow.items() if isinstance(v, set)})
    flow.update({f"decoder out {k}": str(v.dtype).split(".")[-1]
                 for k, v in out.items()})
    flow["averaged scores"] = str(scores.dtype).split(".")[-1]
    flow["averaged ft"] = str(ft.dtype).split(".")[-1]
    log("bf16 dtype flow: " + json.dumps(flow))
    want = torch.bfloat16
    if not (out["scores"].dtype == out["ft"].dtype == scores.dtype
            == ft.dtype == want):
        raise AssertionError("scores / ft do not keep the model dtype")
    return flow


def fused_route_verdicts(cfg):
    """Print which bottlenecks of the full-width model take the fused
    route; return how many do."""
    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model)
    from open_world_semantic_segmentation_tpu_torch.models.resnet import (
        Bottleneck)

    model = build_anomaly_model(cfg, DEVICE, fused_blocks=True)
    verdicts = {name: m.fused_tile is not None
                for name, m in model.encoder.named_modules()
                if isinstance(m, Bottleneck)}
    log("fused route per block: " + json.dumps(verdicts))
    return sum(verdicts.values())


def forward_comparison(cfg, rounds=6):
    """The 5-scale forward of one image (bf16, CUDA events, no data
    movement, scoring or metrics) of the unfused model and of the one with
    ``fused_blocks=True``, timed alternately (unfused, fused, fused,
    unfused, ...) ``rounds`` times each; then the routed bottleneck
    modules of both models, each on the input it gets at every pyramid
    level, timed the same way and summed over the blocks of a level and
    of the forward. Returns every round's times and their medians."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.data.odgt import (
        ValPipeline)
    from open_world_semantic_segmentation_tpu_torch.models.resnet import (
        Bottleneck)
    from open_world_semantic_segmentation_tpu_torch.openset.evaluator import (
        multi_scale_forward)

    models = {fused: init_or_load_variables(
        cfg, build_anomaly_model(cfg, DEVICE, fused_blocks=fused))
        for fused in (False, True)}
    item = ValPipeline(cfg.DATASET.root_dataset, cfg.DATASET.list_val,
                       img_sizes=cfg.DATASET.imgSizes)[0]
    pyramid = [torch.from_numpy(p).to(DEVICE) for p in item["img_data"]]
    seg_size = item["seg_label"].shape[1:3]

    def under_autocast(fn):
        def run():
            with torch.inference_mode(), torch.autocast(
                    DEVICE, dtype=torch.bfloat16):
                fn()
        return run

    forwards = {fused: under_autocast(
        lambda m=model: multi_scale_forward(m, pyramid, seg_size))
        for fused, model in models.items()}
    # the routed blocks' inputs, level by level, from one fused forward
    modules = {fused: dict(model.encoder.named_modules())
               for fused, model in models.items()}
    routed = [name for name, m in modules[True].items()
              if isinstance(m, Bottleneck) and m.fused_tile is not None]
    inputs = []
    hooks = [modules[True][name].register_forward_pre_hook(
        lambda _, args, name=name: inputs.append((name, args[0])))
        for name in routed]
    forwards[True]()
    for hook in hooks:
        hook.remove()
    n_levels = len(pyramid)
    if len(inputs) != n_levels * len(routed):
        raise AssertionError(f"captured {len(inputs)} block inputs")

    order = [False, True, True, False] * (rounds // 2)
    forward_ms = {False: [], True: []}
    level_ms = {False: [], True: []}          # per round: ms per level
    for fused in order:
        forward_ms[fused].append(cuda_time_ms(forwards[fused], iters=10))
    for fused in order:
        levels = [0.0] * n_levels
        for k, (name, x) in enumerate(inputs):
            block = modules[fused][name]
            levels[k // len(routed)] += cuda_time_ms(
                under_autocast(lambda b=block, x=x: b(x)), iters=10)
        level_ms[fused].append(levels)
    result = {}
    for fused in (False, True):
        key = "fused" if fused else "unfused"
        blocks = [sum(levels) for levels in level_ms[fused]]
        result[key] = {
            "forward_ms": forward_ms[fused],
            "forward_ms_median": float(np.median(forward_ms[fused])),
            "routed_blocks_ms": blocks,
            "routed_blocks_ms_median": float(np.median(blocks)),
            "routed_blocks_ms_median_per_level": [
                float(v) for v in np.median(level_ms[fused], axis=0)],
        }
    for what in ("forward_ms", "routed_blocks_ms"):
        result[f"{what}_gain_median"] = (result["unfused"][f"{what}_median"]
                                         - result["fused"][f"{what}_median"])
    log("forward comparison, 5 scales, batch 1, "
        f"{len(routed)} routed blocks per level: " + json.dumps(result))
    return result


# ---------------------------------------------------------------------------
def train_phase(root, weights):
    """``cli.train_embedding.main`` on cuda in bf16 at full width with
    configs/train_embedding.yaml as it stands (batch 8, short sides
    300-600, long side up to 1000), from ``weights`` (the seeded
    checkpoint with BN statistics from the data), for TRAIN_STEPS steps
    in epochs of TRAIN_EPOCH_ITERS, every step logged; then the epoch-1
    checkpoint it wrote through ``cli.eval_ood.main`` on 2 images. Returns
    the timing and the checks' numbers."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import (
        eval_ood, train_embedding)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.ops.fused_block import (
        fused_bottleneck)
    from open_world_semantic_segmentation_tpu_torch.ops.knn import knn_cosine

    tree = os.path.join(root, "train")
    tic = time.perf_counter()
    odgt = write_street_tree(tree, N_TRAIN_IMAGES, FULL_SIZE, SEED + 1,
                             split="training")
    log(f"train tree: {N_TRAIN_IMAGES} images of {FULL_SIZE} in "
        f"{time.perf_counter() - tic:.1f} s")
    ckpt = os.path.join(root, "ckpt")
    cfg = load_config("configs/train_embedding.yaml", [
        "DATASET.root_dataset", tree, "DATASET.list_train", odgt,
        "TRAIN.epoch_iters", str(TRAIN_EPOCH_ITERS), "TRAIN.disp_iter", "1",
        "MODEL.weights_encoder", weights[0],
        "MODEL.weights_decoder", weights[1], "DIR", ckpt])
    kernels = {"knn_cosine": knn_cosine, "fused_bottleneck": fused_bottleneck}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    tic = time.perf_counter()
    result = train_embedding.main(cfg, torch.bfloat16, max_steps=TRAIN_STEPS,
                                  device=DEVICE)
    seconds = time.perf_counter() - tic
    launches = {k: fn.launches for k, fn in kernels.items()}
    steps = result["log"]
    times = [e["seconds"] - (steps[i - 1]["seconds"] if i else 0.0)
             for i, e in enumerate(steps)]
    waits = [e["wait"] - (steps[i - 1]["wait"] if i else 0.0)
             for i, e in enumerate(steps)]
    seen = set()
    first_of_shape = []
    for e in steps:
        first_of_shape.append(tuple(e["shape"]) not in seen)
        seen.add(tuple(e["shape"]))
    steady = times[TRAIN_WARMUP:]
    batch = cfg.TRAIN.batch_size_per_gpu
    s_per_step = float(np.median(steady))
    summary = {
        "steps": result["steps"], "skipped": result["skipped"],
        "batch": batch, "seconds": seconds,
        "s_per_step_median": s_per_step,
        "imgs_per_s": batch / s_per_step,
        "loader_wait_s_per_step": float(np.mean(waits[TRAIN_WARMUP:])),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "per_step": [{"step": e["step"], "shape": e["shape"],
                      "first_of_shape": f, "s": t, "wait_s": w,
                      "loss": e["loss"]}
                     for e, t, f, w in zip(steps, times, first_of_shape,
                                           waits)],
    }
    repeat = [t for t, f in zip(times, first_of_shape) if not f]
    summary["s_per_step_median_repeated_shape"] = (
        float(np.median(repeat)) if repeat else None)
    log("train phase: " + json.dumps(summary))
    if result["steps"] != TRAIN_STEPS or len(steps) != TRAIN_STEPS:
        raise AssertionError(f"trained {result['steps']} steps")
    if result["skipped"]:
        raise AssertionError(f"{result['skipped']} steps skipped")
    if not all(np.isfinite(e["loss"]) for e in steps):
        raise AssertionError("a train loss is not finite")
    if any(launches.values()):
        raise AssertionError(f"the train path launched {launches}")

    # the epoch-1 checkpoint through the eval
    pair = [os.path.join(ckpt, f"{part}_epoch_1.pth")
            for part in ("encoder", "decoder")]
    ecfg = load_config("configs/test_ood_street.yaml", [
        "DATASET.root_dataset", root,
        "DATASET.list_val", os.path.join(root, "test.odgt"),
        "MODEL.weights_encoder", pair[0], "MODEL.weights_decoder", pair[1]])
    res = eval_ood.main(ecfg, torch.bfloat16, max_images=2, batch_images=2,
                        device=DEVICE)
    metrics = {k: res[k] for k in ("mean_iou", "accuracy", "auroc", "aupr",
                                   "fpr")}
    log("eval of the epoch-1 checkpoint: " + json.dumps(metrics))
    for key, value in metrics.items():
        if value is None or not np.isfinite(value):
            raise AssertionError(f"epoch-1 checkpoint: {key} = {value}")
    summary["eval_epoch_1"] = metrics
    return summary


def train_step_check():
    """One train step of the narrow twin (deep-stem Bottleneck ResNet,
    layers (1, 1, 1, 1), planes 8..64, fc_dim 256, 13 classes) on a batch
    of two 64x64 images, in fp32 with TF32 off, dropout held out, on cuda
    and on the CPU from the same weights: the loss, every parameter after
    the SGD step and the BN running statistics must agree
    (TRAIN_CHECK_* tolerances)."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.models.builder import (
        SegmentationModel, init_weights)
    from open_world_semantic_segmentation_tpu_torch.models.decoders import (
        PPMDeepsupEmbedding)
    from open_world_semantic_segmentation_tpu_torch.models.resnet import (
        Bottleneck, ResNet)
    from open_world_semantic_segmentation_tpu_torch.train.optim import (
        poly_schedule, two_group_optimizer)
    from open_world_semantic_segmentation_tpu_torch.train.state import (
        AnomalyTrainStep)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lr = 0.02
    rng = np.random.default_rng(SEED)
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    label = rng.integers(0, 13, (2, 8, 8)).astype(np.int32)
    label[rng.random((2, 8, 8)) < 0.15] = -1
    runs = {}
    for device in ("cpu", DEVICE):
        model = SegmentationModel(
            ResNet(block=Bottleneck, layers=(1, 1, 1, 1),
                   planes=(8, 16, 32, 64), stem="deep", output_stride=8),
            PPMDeepsupEmbedding(num_class=13, fc_dim=256))
        init_weights(model, torch.Generator().manual_seed(SEED))
        model = model.train().to(device)
        if device != "cpu":
            model = model.to(memory_format=torch.channels_last)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()
        opt = two_group_optimizer(model, lr_encoder=poly_schedule(lr, 10),
                                  lr_decoder=poly_schedule(lr, 10))
        step = AnomalyTrainStep(model, opt, guard=True, dtype=torch.float32)
        metrics = step({"img_data": torch.from_numpy(img).to(device),
                        "seg_label": torch.from_numpy(label).to(device)})
        runs[device] = (float(metrics["loss"]), bool(metrics["skipped"]),
                        {k: v.detach().cpu()
                         for k, v in model.state_dict().items()},
                        {k: p.grad.detach().cpu()
                         for k, p in model.named_parameters()})
    (loss_c, skip_c, state_c, grad_c) = runs["cpu"]
    (loss_g, skip_g, state_g, _) = runs[DEVICE]
    log(f"train step check: loss cuda {loss_g} cpu {loss_c}")
    if skip_c or skip_g or not abs(loss_g - loss_c) <= (
            TRAIN_CHECK_LOSS_RTOL * abs(loss_c)):
        raise AssertionError(f"train step loss {loss_g} vs {loss_c}")
    worst = {"param": 0.0, "bn": 0.0}
    for key, want in state_c.items():
        got = state_g[key]
        if key.endswith("num_batches_tracked"):
            if not torch.equal(got, want):
                raise AssertionError(f"{key}: {got} vs {want}")
            continue
        if key in grad_c:
            kind = "param"
            bound = 1e-5 * want.abs() + lr * TRAIN_CHECK_GRAD_FRAC * float(
                grad_c[key].abs().max())
        else:
            kind = "bn"
            frac, atol = TRAIN_CHECK_BN_TOL
            bound = frac * float(want.abs().max()) + atol
        excess = float(((got - want).abs() / bound).max())
        worst[kind] = max(worst[kind], excess)
        if excess > 1.0:
            raise AssertionError(
                f"train step check: {key} off by "
                f"{float((got - want).abs().max())} (largest |value| "
                f"{float(want.abs().max())})")
    log("train step check: largest |difference| / bound: "
        + json.dumps(worst))
    return {"loss_cuda": loss_g, "loss_cpu": loss_c, **worst}


# ---------------------------------------------------------------------------
def device_check(cfg):
    """The full-width model of ``cfg`` over a 64x96 crop of the first eval
    image: in fp32, TF32 off, on cuda (unfused and fused) against the CPU;
    then the fused route against the unfused one on cuda in bf16."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.data.odgt import (
        ValPipeline)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    item = ValPipeline(cfg.DATASET.root_dataset, cfg.DATASET.list_val,
                       img_sizes=cfg.DATASET.imgSizes[:1])[0]
    x = np.ascontiguousarray(item["img_data"][0][:, :64, :96])

    def forward(device, fused, dtype=torch.float32):
        model = init_or_load_variables(
            cfg, build_anomaly_model(cfg, device, fused_blocks=fused))
        with torch.no_grad(), torch.autocast(
                "cuda", dtype=dtype, enabled=dtype != torch.float32):
            out = model(torch.from_numpy(x).to(device), seg_size=(64, 96))
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def compare(name, got, want, bounds, min_argmax):
        """Largest |difference| per output within ``bounds`` and argmax
        agreement of the scores at least ``min_argmax``; the agreement."""
        for key in ("scores", "ft"):
            err = float(np.abs(got[key] - want[key]).max())
            log(f"device check {name} {key}: max |diff| {err:.4g} (max "
                f"|reference| {np.abs(want[key]).max():.4g}, bound "
                f"{bounds[key]:.4g})")
            if not err <= bounds[key]:
                raise AssertionError(f"{name} {key} disagree: {err}")
        same = float((got["scores"].argmax(-1)
                      == want["scores"].argmax(-1)).mean())
        log(f"device check {name} argmax agreement {same:.5f} (bound "
            f"{min_argmax:.5f})")
        if same < min_argmax:
            raise AssertionError(f"{name} argmax agreement {same}")
        return same

    cpu = forward("cpu", False)
    fp32_bounds = {k: DEVICE_CHECK_RTOL * float(np.abs(v).max())
                   for k, v in cpu.items()}
    compare("fp32 cuda vs cpu", forward(DEVICE, False), cpu, fp32_bounds,
            0.99)
    compare("fp32 fused cuda vs cpu", forward(DEVICE, True), cpu,
            fp32_bounds, 0.99)

    torch.backends.cudnn.allow_tf32 = True
    unfused = forward(DEVICE, False, torch.bfloat16)
    fused = forward(DEVICE, True, torch.bfloat16)
    noise = {k: float(np.abs(unfused[k] - cpu[k]).max()) for k in cpu}
    agree_u = compare("bf16 unfused cuda vs fp32 cpu", unfused, cpu,
                      dict.fromkeys(cpu, float("inf")), 0.0)
    bounds = {k: BF16_ROUTE_FACTOR * noise[k] + fp32_bounds[k] for k in cpu}
    agree_f = compare("bf16 fused cuda vs fp32 cpu", fused, cpu, bounds,
                      agree_u - BF16_ROUTE_ARGMAX_SLACK)
    # fused against unfused: within the sum of the two bounds above
    compare("bf16 fused vs unfused cuda", fused, unfused,
            {k: bounds[k] + noise[k] for k in cpu},
            agree_f + agree_u - 1 - 1e-9)


# ---------------------------------------------------------------------------
def write_cityscapes_tree(root, counts, size, seed):
    """Cityscapes-format tree (``leftImg8bit/<split>/synth/*_leftImg8bit.png``
    and ``gtFine/<split>/synth/*_gtFine_labelIds.png``) with ``counts[split]``
    images per split: raw-id labels, blocks of the 19 train classes over
    road, then the featured blocks on top: in ``train`` car over h/3 x w/3
    in all but every fourth image, in ``val`` a car, a truck and a bus block
    in every image. Images: one colour per raw id plus noise."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    palette = rng.integers(0, 255, (34, 3))
    ids = np.array(CITYSCAPES_TRAIN_RAW_IDS)
    with ThreadPoolExecutor(8) as pool:
        saves = []
        for split, n in counts.items():
            for i in range(n):
                lab = np.full((h, w), 7, np.uint8)
                for _ in range(12):
                    r0 = rng.integers(0, h - h // 10)
                    c0 = rng.integers(0, w - w // 10)
                    lab[r0:r0 + rng.integers(h // 15, h // 3),
                        c0:c0 + rng.integers(w // 15, w // 3)] = \
                        rng.choice(ids)
                if split == "train":
                    featured = [(CAR, h // 3, w // 3)] if i % 4 != 3 else []
                else:
                    featured = [(CAR, h // 4, w // 4), (TRUCK, h // 5, w // 6),
                                (BUS, h // 5, w // 6)]
                for raw, bh, bw in featured:
                    r0, c0 = rng.integers(0, h - bh), rng.integers(0, w - bw)
                    lab[r0:r0 + bh, c0:c0 + bw] = raw
                img = palette[lab] + rng.normal(0, 20, (h, w, 3))
                img = np.clip(img, 0, 255).astype(np.uint8)
                stem = f"synth_{i:06d}_000019"
                for kind, suffix, arr, mode in (
                        ("leftImg8bit", "leftImg8bit", img, "RGB"),
                        ("gtFine", "gtFine_labelIds", lab, "L")):
                    path = os.path.join(root, kind, split, "synth",
                                        f"{stem}_{suffix}.png")
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    saves.append(pool.submit(Image.fromarray(arr, mode).save,
                                             path, compress_level=1))
        for save in saves:
            save.result()
    return root


def write_deeplab_checkpoint(cfg, path, seed):
    """Seeded random weights for ``cfg``'s DeepLab model, saved as the
    reference's ``{"model_state": ...}`` .pth, with the data-dependent start
    of ``write_random_checkpoint``: BN running statistics from one forward
    over the first eight val images, and the last 1x1 conv shifted and
    scaled so that each output channel has mean 0 and std 0.8 over them
    (the scale of the one-hot centers)."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        build_deeplab_model, get_transforms, get_val_dataset,
        init_or_load_deeplab)

    model, _ = build_deeplab_model(cfg, DEVICE)
    init_or_load_deeplab(model, seed=seed)
    ds = get_val_dataset(cfg, get_transforms(cfg.DEEPLAB.crop_size)[1])
    # BN over the 1x1 image-pool branch sees one value per image: 8 images,
    # so its variance is not that of two
    img = torch.from_numpy(np.stack([ds[i][0] for i in range(
        min(8, len(ds)))])).to(DEVICE)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None          # running stats = this batch's
    with torch.no_grad():
        model.train()(img)
        out = model.eval()(img)
        out = (out[2] if isinstance(out, tuple) else out).flatten(0, 2)
        mean, std = out.mean(0), out.std(0)
        last = model.classifier.classifier[-1]
        last.weight.mul_((0.8 / std)[:, None, None, None])
        last.bias.sub_(mean).mul_(0.8 / std)
    torch.save({"model_state": model.state_dict()}, path)
    return path


def deeplab_phase(root):
    """The Cityscapes NPM few-shot eval and the closed-set DeepLab eval at
    full width and resolution; see the module note. Returns the summaries
    and the fused run's fused_bottleneck launches."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import (
        eval_embedding, extract_prototypes, test_deeplab)
    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        build_deeplab_model)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.models.resnet import (
        Bottleneck)
    from open_world_semantic_segmentation_tpu_torch.ops.fused_block import (
        fused_bottleneck)
    from open_world_semantic_segmentation_tpu_torch.ops.knn import knn_cosine

    tree = os.path.join(root, "cityscapes")
    tic = time.perf_counter()
    write_cityscapes_tree(tree, {"train": N_SUPPORT_IMAGES,
                                 "val": N_VAL_IMAGES}, CITYSCAPES_SIZE,
                          SEED + 2)
    log(f"cityscapes tree: {N_SUPPORT_IMAGES} + {N_VAL_IMAGES} images of "
        f"{CITYSCAPES_SIZE} in {time.perf_counter() - tic:.1f} s")
    cfg = load_config("configs/cityscapes_embedding.yaml", [
        "DATASET.root_dataset", tree, "FEWSHOT.prototype_file",
        os.path.join(root, "prototype_car_5_shot.json")])
    model, _ = build_deeplab_model(cfg, DEVICE, fused_blocks=True)
    verdicts = {name: m.fused_tile is not None
                for name, m in model.backbone.named_modules()
                if isinstance(m, Bottleneck)}
    del model
    log("deeplab fused route per block: " + json.dumps(verdicts))
    if sum(verdicts.values()) != DEEPLAB_ROUTED_BLOCKS:
        raise AssertionError(f"{sum(verdicts.values())} blocks routed")
    cfg.MODEL.weights_encoder = write_deeplab_checkpoint(
        cfg, os.path.join(root, "deeplab_embedding.pth"), SEED)

    kernels = {"knn_cosine": knn_cosine, "fused_bottleneck": fused_bottleneck}
    tic = time.perf_counter()
    protos = extract_prototypes.main(cfg, torch.bfloat16, device=DEVICE)
    log(f"extract_prototypes: {len(protos)} shots in "
        f"{time.perf_counter() - tic:.2f} s, norms "
        f"{[float(np.linalg.norm(p)) for p in protos]}")
    if len(protos) != cfg.FEWSHOT.shots or not np.isfinite(protos).all():
        raise AssertionError(f"extracted {len(protos)} prototypes")

    # warm-up of both routes (cuDNN heuristics, the first fused calls)
    for fused in (False, True):
        eval_embedding.main(cfg, torch.bfloat16, max_images=2, device=DEVICE,
                            fused_blocks=fused)
    runs = {"npm": (False, 0), "npm_fused": (
        True, DEEPLAB_ROUTED_BLOCKS * N_VAL_IMAGES)}
    summaries, launches = {}, {}
    for run, (fused, want) in runs.items():
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        result = eval_embedding.main(cfg, torch.bfloat16, device=DEVICE,
                                     fused_blocks=fused)
        launches[run] = {k: fn.launches for k, fn in kernels.items()}
        n = result["images"]
        summary = {k: float(result[k]) for k in (
            "Overall Acc", "Mean Acc", "FreqW Acc", "Mean IoU")}
        split = {k: result[k] for k in ("device_s_per_img", "wait_s_per_img",
                                        "metric_s_per_img")}
        split["other_s_per_img"] = result["seconds"] / n - sum(split.values())
        summary.update(images=n, seconds=result["seconds"],
                       imgs_per_s=n / result["seconds"], **split,
                       novel_pixels=result["novel_pixels"],
                       pixels=result["pixels"],
                       peak_memory_bytes=torch.cuda.max_memory_allocated())
        log(f"eval_embedding {run}: " + json.dumps(summary) + " launches "
            + json.dumps(launches[run]))
        if n != N_VAL_IMAGES:
            raise AssertionError(f"{run}: evaluated {n} images")
        for key, value in summary.items():
            if not np.isfinite(value):
                raise AssertionError(f"{run}: {key} = {value}")
        if not 0 < summary["novel_pixels"] < summary["pixels"]:
            raise AssertionError(f"{run}: the NPM override took "
                                 f"{summary['novel_pixels']} pixels")
        if launches[run] != {"knn_cosine": 0, "fused_bottleneck": want}:
            raise AssertionError(f"{run}: launches {launches[run]}, want "
                                 f"fused_bottleneck {want}")
        summaries[run] = summary
    log(f"npm fused run: fused_bottleneck launches "
        f"{launches['npm_fused']['fused_bottleneck']} "
        f"({DEEPLAB_ROUTED_BLOCKS} per image, {N_VAL_IMAGES} images)")
    summaries["forward_comparison"] = deeplab_forward_comparison(cfg)

    # the closed-set eval of deeplabv3plus_resnet101, unknowns scored
    ccfg = load_config("configs/cityscapes_closed.yaml", [
        "DATASET.root_dataset", tree, "DEEPLAB.unknown_scores", "True"])
    ccfg.DEEPLAB.ckpt = write_deeplab_checkpoint(
        ccfg, os.path.join(root, "deeplab_closed.pth"), SEED + 1)
    score, ood = test_deeplab.main(ccfg, torch.bfloat16,
                                   max_images=N_CLOSED_SET_IMAGES,
                                   device=DEVICE)
    closed = {k: float(score[k]) for k in ("Overall Acc", "Mean Acc",
                                           "FreqW Acc", "Mean IoU")}
    closed.update(ood or {}, images=score["images"],
                  seconds=score["seconds"])
    log("test_deeplab deeplabv3plus_resnet101: " + json.dumps(closed))
    if score["images"] != N_CLOSED_SET_IMAGES or ood is None or not all(
            np.isfinite(v) for v in closed.values()):
        raise AssertionError(f"test_deeplab: {closed}")
    summaries["closed_set"] = closed
    deeplab_device_check(cfg)
    return summaries, launches["npm_fused"]["fused_bottleneck"]


def deeplab_forward_comparison(cfg, rounds=6):
    """The 1024x2048 forward of one image (bf16, CUDA events, no data
    movement, NPM or metrics), unfused and with ``fused_blocks=True``,
    timed alternately ``rounds`` times each; every round and the medians."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        build_deeplab_model, get_transforms, get_val_dataset,
        init_or_load_deeplab)

    models = {}
    for fused in (False, True):
        model, _ = build_deeplab_model(cfg, DEVICE, fused_blocks=fused)
        models[fused] = init_or_load_deeplab(model,
                                             cfg.MODEL.weights_encoder)
    ds = get_val_dataset(cfg, get_transforms(cfg.DEEPLAB.crop_size)[1])
    x = torch.from_numpy(ds[0][0][None]).to(DEVICE)

    def forward(model):
        def run():
            with torch.inference_mode(), torch.autocast(
                    DEVICE, dtype=torch.bfloat16):
                model(x)
        return run

    times = {False: [], True: []}
    for fused in [False, True, True, False] * (rounds // 2):
        times[fused].append(cuda_time_ms(forward(models[fused]), iters=5))
    result = {("fused" if fused else "unfused"): {
        "forward_ms": t, "forward_ms_median": float(np.median(t))}
        for fused, t in times.items()}
    result["forward_ms_gain_median"] = (
        result["unfused"]["forward_ms_median"]
        - result["fused"]["forward_ms_median"])
    log(f"deeplab forward comparison, {list(CITYSCAPES_SIZE)}, batch 1: "
        + json.dumps(result))
    return result


def deeplab_device_check(cfg):
    """The full-width embedding model over a 64x128 crop of the first val
    image in fp32, TF32 off, on cuda (unfused and fused) against the CPU:
    logits and features within DEVICE_CHECK_RTOL of their largest
    magnitude, the argmax agreeing on 99 % of the pixels. Then the NPM
    stage on the CPU forward's outputs, on cuda against the CPU
    (``deeplab_npm_check``)."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        build_deeplab_model, get_transforms, get_val_dataset,
        init_or_load_deeplab)

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = get_val_dataset(cfg, get_transforms(cfg.DEEPLAB.crop_size)[1])
    x = np.ascontiguousarray(ds[0][0][None, :64, :128])
    labels = np.ascontiguousarray(ds[0][1][:64, :128]).astype(np.int32)

    def forward(device, fused):
        model, _ = build_deeplab_model(cfg, device, fused_blocks=fused)
        init_or_load_deeplab(model, cfg.MODEL.weights_encoder)
        with torch.no_grad():
            logits, _, features = model(torch.from_numpy(x).to(device))
        return {"logits": logits.cpu().numpy(),
                "features": features.cpu().numpy()}

    cpu = forward("cpu", False)
    for fused in (False, True):
        got = forward(DEVICE, fused)
        name = "fused" if fused else "unfused"
        for key in ("logits", "features"):
            err = float(np.abs(got[key] - cpu[key]).max())
            bound = DEVICE_CHECK_RTOL * float(np.abs(cpu[key]).max())
            log(f"deeplab device check fp32 {name} cuda vs cpu {key}: max "
                f"|diff| {err:.4g} (bound {bound:.4g})")
            if not err <= bound:
                raise AssertionError(f"deeplab {name} {key}: {err}")
        same = float((got["logits"].argmax(-1)
                      == cpu["logits"].argmax(-1)).mean())
        log(f"deeplab device check fp32 {name} argmax agreement {same:.5f}")
        if same < 0.99:
            raise AssertionError(f"deeplab {name} argmax agreement {same}")
    deeplab_npm_check(cfg, cpu, labels)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def deeplab_npm_check(cfg, outputs, labels):
    """The eval's NPM stage (``npm_override`` after the argmax,
    ``npm_label_remap``, the uint8 readback, ``StreamSegMetrics``) on the
    same inputs, on cuda against the CPU: ``outputs`` (the CPU forward's
    logits and features of one image), ``labels`` (its train ids), for the
    5-shot prototype and for one that fires (the CPU features at the
    pixel of the lowest base logit), with the features and logits in
    float32 and cast to bf16 (the eval's dtype). Remapped labels and
    metrics must be equal; predictions too, except at pixels where the
    CPU's distance lies within DEVICE_CHECK_RTOL of its largest magnitude
    of the threshold or of the largest base logit (a rounding apart)."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        to_host_async)
    from open_world_semantic_segmentation_tpu_torch.fewshot.prototypes import (
        load_prototypes, npm_label_remap, npm_override)
    from open_world_semantic_segmentation_tpu_torch.metrics.segmentation \
        import StreamSegMetrics

    novel_id = outputs["logits"].shape[-1]       # 16
    threshold = cfg.FEWSHOT.npm_dis_threshold
    logits, features = outputs["logits"][0], outputs["features"][0]
    low = np.unravel_index(logits.max(-1).argmin(), logits.shape[:2])
    prototypes = {"5-shot": load_prototypes(cfg.FEWSHOT.prototype_file),
                  "firing": np.ascontiguousarray(features[low])}

    def npm(device, dtype, prototype):
        f = torch.from_numpy(features).to(device, dtype)
        lg = torch.from_numpy(logits).to(device, dtype)
        preds, dis = npm_override(
            lg.argmax(-1), f, lg, torch.from_numpy(prototype).to(device),
            novel_id=novel_id, dis_threshold=threshold)
        remapped = npm_label_remap(torch.from_numpy(labels).to(device),
                                   novel_id=novel_id)
        host = to_host_async([preds.to(torch.uint8),
                              remapped.to(torch.uint8)])()
        metrics = StreamSegMetrics(novel_id + 1)
        metrics.update(host[1][None].astype(np.int64), host[0][None])
        return (host[0], host[1], metrics.get_results(),
                dis.float().cpu().numpy(), lg.float().max(-1).values.cpu())

    for dtype in (torch.float32, torch.bfloat16):
        for name, prototype in prototypes.items():
            cpu = npm("cpu", dtype, prototype)
            got = npm(DEVICE, dtype, prototype)
            dis, maxlogit = cpu[3], cpu[4].numpy()
            margin = DEVICE_CHECK_RTOL * float(np.abs(dis).max())
            near = ((np.abs(dis - threshold) <= margin)
                    | (np.abs(dis - maxlogit) <= margin))
            differ = got[0] != cpu[0]
            fired = int((cpu[0] == novel_id).sum())
            log(f"deeplab npm check {name} {str(dtype)[6:]}: override "
                f"{fired} of {cpu[0].size} pixels on the cpu, "
                f"{int((got[0] == novel_id).sum())} on cuda, predictions "
                f"differ at {int(differ.sum())} ({int(near.sum())} within "
                f"{margin:.4g} of a bound)")
            if (differ & ~near).any():
                raise AssertionError(f"npm {name} {dtype}: predictions differ")
            if not np.array_equal(got[1], cpu[1]):
                raise AssertionError(f"npm {name} {dtype}: remapped labels")
            if not differ.any() and repr(got[2]) != repr(cpu[2]):
                raise AssertionError(f"npm {name} {dtype}: metrics differ")
            if name == "firing" and not 0 < fired < cpu[0].size:
                raise AssertionError(f"npm {name} {dtype}: override took "
                                     f"{fired} pixels")


# ---------------------------------------------------------------------------
def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    import open_world_semantic_segmentation_tpu_torch  # noqa: F401

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    gpu = gpu_name_and_power()
    log(gpu)
    tic = time.perf_counter()
    build_kernels()
    kernels = [kernel_phase(), fused_kernel_phase()]
    for kernel in kernels:
        log("kernel phase: " + json.dumps(kernel))
    with tempfile.TemporaryDirectory() as root:
        summaries, launches, cfg = slice_phase(root)
        train = train_phase(root, (cfg.MODEL.weights_encoder,
                                   cfg.MODEL.weights_decoder))
        device_check(cfg)
        train_check = train_step_check()
        deeplab, deeplab_launches = deeplab_phase(root)
    # launches on the main path: knn_cosine in the knn run, fused_bottleneck
    # in the fused run (the runs that take each kernel's path)
    kernels[0]["launches"] = launches["knn"]["knn_cosine"]
    set_path_dtype(kernels[0], summaries.pop("knn_input_dtype"))
    kernels[1]["launches"] = launches["dissum_fused"]["fused_bottleneck"]
    kernels[1]["deeplab"]["launches"] = deeplab_launches
    log(f"gpu: {gpu}; eval summaries: " + json.dumps(summaries))
    log(f"gpu: {gpu}; train: s/step {train['s_per_step_median']}, imgs/s "
        f"{train['imgs_per_s']}, loader wait s/step "
        f"{train['loader_wait_s_per_step']}, peak memory "
        f"{train['peak_memory_bytes']} bytes, skipped {train['skipped']}, "
        f"losses {[e['loss'] for e in train['per_step']]}; train step check "
        + json.dumps(train_check))
    log(f"gpu: {gpu}; deeplab: " + json.dumps(deeplab))
    log(f"total {time.perf_counter() - tic:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
