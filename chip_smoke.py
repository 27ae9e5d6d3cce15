#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (H100): kernels, the
StreetHazards open-set eval (PIL and device pyramids, every scoring
method, visualisation, the closed-set and reconstruction evals), the HTTP
segmentation server and its exported artifact, DML embedding training,
the Cityscapes NPM few-shot eval (with score calibration, result PNGs and
Fishyscapes Lost&Found), the live video demo, DeepLab training and the
incremental few-shot fine-tuning (FT / PLM self-distillation,
teacher-student distillation), a golden convergence run, every other
encoder and decoder of the CSAIL model zoo, the int8 PTQ surface,
DeepLab training on PASCAL VOC, and data-parallel training over ranks with
the profiler hooks, end to end.

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
   geometries of resnet50dilated at the largest pyramid level and at the
   server's single 720x1280 input, the six of the DeepLab ResNet-101 (7x7
   stem, OS16) at 1024x2048 and at the distillation teacher's batch of 5
   crops of 768x768, at ragged small
   shapes and at batch 2, dilation 8 and Cmid 1024, in bf16 (tolerance
   5e-2) and float32 with TF32 off (1e-4), timed in bf16 at the four
   sets of geometries beside the cuDNN chain of the unfused block, with
   its three launches (conv1, conv2, conv3 + skip) also timed apart; then
   checked both ways and timed at the zoo's geometries at the largest
   pyramid level (568x1000): resnet101dilated's 32 routed blocks,
   resnet50's 13 and resnet101's 30 at output stride 32 (layers 3 and 4 at
   dilation 1 on maps of 1/16 and 1/32) and HRNetV2's 4 layer1 blocks;
3a. golden phase, run right after the kernels (later, the earlier phases'
   threads slow its host-bound training loop 1.5x; ``tools/golden_run.py``
   of the port): the JAX package's flagship recipe at full width,
   resnet50dilated + ppm_deepsup_embedding
   trained by ``cli.train_embedding.main`` in bf16 for 2000 steps (batch
   8, 128-pixel images of the learnable synthetic StreetHazards tree, lr
   0.05), then scored by ``cli.eval_ood.main`` on its 13 val images:
   dissum, msp and knn in fp32 (TF32 off), dissum with ``fused_blocks``,
   dissum and msp in bf16. Gates (the JAX CPU test's) on the fp32 dissum
   eval: mIoU >= 0.55, accuracy >= 0.70, AUROC >= 0.85 and >= msp's; the
   flagship criteria (mIoU >= 0.8, AUROC >= 0.9; JAX v5e 0.821 / 0.912)
   and the bf16 drift printed; the fused eval's AUROC within 1e-3 of the
   unfused one and its labels equal on 99 % of pixels; knn_cosine launched
   once per image and fused_bottleneck 15 block calls per image, counted.
   Then the Cityscapes NPM shape in fp32 (TF32 off):
   deeplabv3plus_embedding_resnet101 base-trained by
   ``cli.main_deeplab.main`` (crop 128, batch 4, 400 steps) under
   ``torch.use_deterministic_algorithms(True)`` (one seed, one set of
   weights; ``CUBLAS_WORKSPACE_CONFIG`` is set at the top), 5-shot car
   prototypes, the NPM eval on 19 val images and the no-override eval
   (prototypes >= 1, no-override novel IoU 0, NPM novel IoU > 0.1 and
   above it, base mIoU >= 0.3 and >= 0.9 x the no-override mIoU);
4. slice phase: a synthetic StreetHazards tree of 720x1280 images, a
   full-width resnet50dilated + ppm_deepsup_embedding with seeded random
   weights and a data-dependent start taken on the eval's own 16 images
   at all 5 pyramid levels (``eval_start``: BN statistics their mean, the
   embedding scaled until 99 % of its pixels lie within the one-hot
   centres' magnitude), so that the first
   image's dis_sum clips on under 5 % of its pixels (the share is
   printed); the dtype after each decoder module and after the averaging
   under bf16 autocast (scores and ft must stay bf16, as in the JAX
   package); ``cli.eval_ood.main`` on cuda in bf16: OOD.ood dissum, knn,
   dissum with ``fused_blocks=True`` and dissum with
   ``device_metrics=True``; launch counts are zeroed just before each run
   and read just after (knn_cosine once per image in the knn run,
   fused_bottleneck once per routed block per pyramid level per batch in
   the fused run, neither elsewhere); every metric must be finite; every
   dissum map of the host-sweep and device-metrics runs finite and not
   constant, and the device metrics within 2e-5 of the host sweep's on
   them; each run's wall
   time per image is split into the device batch, the metric sweep and
   loader waits; then the 5-scale forward of one image, unfused and
   fused, timed alternately six times each, and the routed bottleneck
   modules of both models timed the same way on their inputs at every
   level (medians and every round printed);
4b. the rest of the StreetHazards eval, each run with every kernel's
   launch count zeroed just before and read just after (none launched):
   dissum with device metrics and ``device_pyramid=True`` on the 16 images
   (imgs/s, loader wait and device s/img printed beside the PIL pyramid's
   run; one image's pyramid on cuda against the CPU within 1e-5); the
   device pyramid's batched device-metrics chain against its per-image
   host-sweep twin on 2 images (maxlogit, float32, TF32 off: metrics
   within 1e-3, every conf map finite and not constant); one
   image's scores through ``crf-gauss`` and ``crf``: ms per image (CUDA
   events) and the peak memory each adds, and the CRF on cuda against the
   CPU in float32 with TF32 off (Q within 1e-4; crf-gauss on the whole
   map, crf on a 64x128 crop); ``cli.eval_ood.main`` with each CRF on 2
   images (every conf map float32, finite, in [0, 1], checked after the
   timed run); ``VAL.visualize``
   on 2 images (two 720x3840 grids); a seeded ppm_deepsup checkpoint with
   a data-started BN, ``cli.test_closed.main`` on 4 images (4 prediction
   PNGs of 720x1280, values 1..13) and ``cli.eval_ood_rec.main`` in
   float32 on 4 images against a reconstructed tree (the same images with
   seeded noise): imgs/s, peak memory, finite metrics;
4c. serve phase: ``cli/serve.py``'s HTTP server on 127.0.0.1 (port 0) for
   the slice phase's model at 720x1280 in bf16, its images as request
   bodies; the checkpoint's data-dependent start is taken again on the
   16 served frames, so that dis_sum does not clip everywhere: 8
   sequential ``/segment`` requests (every second one with
   ``?scores=dissum``) and a 16-frame ``/stream``; 16 requests from 4
   client threads with ``max_batch=4`` (after the 1-2-4 warm ladder); 4
   requests with ``--device-input``; 4 requests and a 4-frame stream with
   ``fused_blocks=True`` (15 block calls and 45 kernel launches per
   forward, both counted by the wrapper), then the fused kernel against its
   plain version on the inputs each routed block gets in a served forward
   (bf16, 5e-2); a bf16 and an fp32 (TF32 off) artifact exported with the
   maxlogit conf, the bf16 one served for 4 requests. Every answer is held
   to a direct forward of the padded batch its image went in: labels equal
   on 99 % of pixels, conf maps float16, not all NaN, with their NaNs where
   the direct forward's are and within 2e-3 of its largest magnitude (at
   least of 1) elsewhere; the fp32 artifact within 1e-3 of the direct
   forward's largest maxlogit, the served bf16 one within twice the direct
   bf16 forward's distance from fp32 (plus 1e-3). Printed: /segment ms p50
   and p99, the micro-batched requests/s, /stream frames/s, the startup and
   warm-ladder seconds, peak memory, where one request's time goes (decode,
   dispatch, forward, encode), the same on the fused route and from the
   artifact;
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
   unknowns scored) on 4 images; a 64x128 crop through the embedding
   model in fp32 with TF32 off, cuda (unfused and fused) against the CPU;
   and ``dilated_conv_ways``: the ASPP's dilated conv at rates 6, 12, 18,
   the shift form (``ops/dilated.py``, the port's default) against cuDNN's
   conv in bf16 channels_last, forward at 1x2048x64x128 and forward plus
   backward at 8x2048x48x48 (within 5e-2 of the largest magnitude), then
   the 1024x2048 forward with each, alternately;
7a. live demo: ``cli/demo_video.py live_mode`` on 4 ``demo_video`` frames
   of 1024x2048 with the deeplab phase's checkpoint, unfused and fused (31
   block calls per frame), after one warm-up frame: frames/s, and the
   first frame's written blend against one made here from a direct
   forward (99 % of pixels);
7b. the rest of the Cityscapes eval, launches zeroed and read around each
   run (none launched): ``cli.eval_embedding.main`` with
   FEWSHOT.calibrate_scores on 4 val images (the GMM/ECDF fit on 4, its
   state saved and reloaded; a finite calibrated AUROC / AUPR / FPR95);
   ``cli.test_deeplab.main`` with DEEPLAB.save_val_results on 2 images (10
   PNGs of 1024x2048); ``cli.eval_fishyscapes.main`` (native) on 2
   synthetic Lost&Found images of 1024x2048, for entropy, msp and dissum
   (finite AP / AUROC / FPR95);
8. deeplab train phase: a synthetic Cityscapes tree of 1024x2048 images
   (16 train, 5 in ``test_car_5_shot``, 2 val); ``cli.main_deeplab.main``
   trains deeplabv3plus_embedding_resnet101 (configs/cityscapes_embedding
   .yaml: crop 768, batch 8) from the deeplab phase's data-started
   checkpoint (``DEEPLAB.ckpt``) at DEEPLAB_SMOKE_LR (1e-4, where the
   config has 0.1) for 6 steps, validating and writing ``latest.pth`` and
   ``best.pth`` at the last; how far bf16 carries the start and the trained
   weights from fp32, beside the fp32 forward of the input rounded once
   (printed only); ``cli.self_distillation.main`` trains the 16+1 two-head
   model from ``best.pth`` (partial load; configs/self_distillation.yaml:
   crop 768, batch 5, lr 0.01) for 6 steps, then evaluates ``plm_all`` on 4
   of the NPM tree's val images unfused and fused (31 launches per image);
   the backbone, ``classifier`` and every BN statistic must stay
   bit-identical to the checkpoint and ``classifier_1`` must move; the
   fused two-head model against the unfused one on the first val image:
   in fp32 (TF32 off) each head's logits within 1e-3 of the largest, each
   argmax and the merged prediction agreeing on 99 %, and in bf16 each of
   the 31 routed blocks on its unfused twin's input within 5e-2 of the
   largest magnitude; ``cli.main_distillation.main`` for 6 steps with the
   teacher unfused and then fused (31 launches per step): the student's
   backbone equals the teacher's before step 1, the fused teacher on the
   first batch holds against the unfused teacher as above, the two runs'
   first losses agree within 5e-2; every loss finite, no step skipped,
   s/step (median after 2 warm-up steps), imgs/s, loader wait s/step, peak
   memory and launches printed; and the two-head model on a 64x128 crop in
   fp32 with TF32 off, cuda (unfused and fused) against the CPU;
9. zoo phase: ``cli.eval_ood.main`` (bf16, 5-scale pyramid; dissum on
   the PPM deep-supervision decoders, msp on the softmax ones) on 2
   of the slice tree's 720x1280 images for each pair of ``ZOO_RUNS``, each
   with seeded random weights started on those images at every level:
   resnet101dilated + ppm_deepsup_embedding unfused and fused (32 block
   calls per level per batch, counted; the kernel against its plain
   version on the inputs each routed block gets), resnet50 and resnet101
   (OS32) + upernet fused (13 and 30), hrnetv2 + c1 both ways (4), and
   resnet18dilated + c1_deepsup, resnet34dilated + ppm_deepsup,
   mobilenetv2dilated + c1_deepsup, resnext101 + upernet_lite and
   resnet101dilated + ppm unfused: finite metrics, the 5-scale forward's
   ms per image (CUDA events), peak memory, and the fp32 (TF32 off) card
   forward of a 96x128 crop against the CPU's (unfused, and fused where
   the pair runs fused) within 1e-3 of the largest score; then the three
   MobileNet DeepLab factories: one 1024x2048 bf16 forward each (finite,
   ms, peak memory) and the fp32 card forward of a 96x128 image against
   the CPU's.
10. quant phase (``ops/quant.py``, after the Cityscapes eval): the exact
   int8 conv (one ``torch._int_mm`` per tap) against its plain version (a
   float64 conv of the integers on the card), int32 results equal, at
   every quantized conv geometry of resnet50dilated +
   ppm_deepsup_embedding at the eval's largest level and at the DeepLab
   ASPP's 1x1 and rate 6, 12, 18 convs, each timed beside cuDNN's bf16
   conv; the golden StreetHazards weights through ``cli.eval_ood.main``
   (fp32 with TF32 off, dissum, 5 scales around their 128-pixel scale, 13
   images) with
   quant off and in int8, int8-3x3, int8-hybrid and w4a8 (scales from the
   first 4 val images): imgs/s, AUROC, AUPR, FPR95 and mIoU, the drift
   against the float run within the JAX package's bounds (AUROC 0.05,
   AUPR 0.08, mIoU 0.05) in int8 and int8-hybrid (int8-3x3's and w4a8's
   printed: their dissum drift leaves the bounds on these weights, and
   the port's forward in both is the JAX package's; each of their
   quantized convs on one image, given the card's input on the CPU,
   equals the card's output bit for bit), int8 convs counted on the card
   in every quantized run; ``OOD.ood knn`` under int8-hybrid (knn_cosine once per
   image, every map finite); deeplabv3plus_embedding_resnet101 at OS16 on
   a 1024x2048 image, bf16 against int8-hybrid (its backbone calibrated
   on 2 val images): ms, peak memory, argmax agreement; ``cli/serve``
   with ``--quant int8-hybrid --calib-glob`` answering 4 ``/segment``
   requests (held to a direct forward of the served model; p50); an
   int8-hybrid artifact from ``cli/export_model`` (its header's quant,
   ``aten._int_mm`` and int8 constants in its program) against the live
   model on two frames;
11. VOC phase: ``cli.main_deeplab.main`` with DEEPLAB.dataset voc on a
   synthetic VOCdevkit (16 train_aug images and 4 val of 375x500,
   500x375, 333x500, 500x333): deeplabv3plus_mobilenet, 21 classes, crop
   513, batch 8, bf16, 6 steps, then the val pass one image per batch:
   s/step, loader wait s/step, finite losses and mIoU;
12. ddp phase (``parallel/``, data-parallel training; one card, so two
   ranks share device 0 over gloo, which takes CUDA tensors through host
   copies, and NCCL runs as a one-rank group): this script's own 2-rank
   job (``--ddp-worker``, a ``file://`` store, each rank writing its
   results before any teardown; the job is killed after 300 s) beside the
   same work in this process on the whole batch: three AnomalyTrainSteps
   of the full-width resnet50dilated + ppm_deepsup_embedding from the
   slice phase's weights on a fixed global batch of 4 320x384 images
   (labels at 1/8, each rank ignoring another share), dropout held out,
   in float64 (losses within 1e-7; the distance from one process, over
   the change the steps made, at most 4 times that of one process on the
   batch in reverse order) and in fp32 with TF32 off (the 2-rank run's
   distance from float64 at most 4 times the one-process run's), every
   rank bit-identical; a BN of a bf16 input over the ranks under bf16
   autocast returns bf16 within 5e-2 of one process's; the car
   prototype of 2 support images a rank (their shards of the deeplab
   phase's tree) through the DeepLab embedding model with
   ``fused_blocks=True`` in fp32, summed over the ranks, within 1e-4 of
   one process's on the 4 (valid alike; 31 block calls and 93 kernel
   launches a rank, counted); then ``cli.train_embedding`` under ``python
   -m torch.distributed.run``: 2 ranks over gloo at the config's batch of
   8 a rank (short sides cut to 300 and 375, long side to 600), timed
   alone, and one rank over NCCL (run beside the rank job above), 4 fp32
   steps each, only rank 0 printing and writing ``metrics.jsonl`` and the
   checkpoint, the ranks' weights checked bit-identical by the entry
   point, the 2-rank s/step beside two plain runs in this process (timed
   alone), the NCCL run's first loss equal to the plain run's and its
   weights within 4 times the plain runs' own distance;
   ``cli.main_deeplab`` under ``torch.distributed.run`` with 2 ranks
   (gloo, bf16, batch 4 a rank at crop 768, the config's 8 in all; run
   beside the rank job) for 2 steps from the deeplab phase's checkpoint, rank 0 alone validating and writing ``latest.pth``
   and ``best.pth``; and ``utils/observability.py profile_trace`` around
   one fused 568x1000 StreetHazards forward (bf16): the trace names the
   fused kernel (``phase_kernel`` of ``csrc/fused_bottleneck.cu``) 45
   times, 3 per routed block, and the ``annotate`` region.

The last two lines of standard output are the ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import faulthandler
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# cuBLAS reads it at its first call: the golden Cityscapes training runs
# under torch.use_deterministic_algorithms(True) (tools/golden_run.py)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
# the same at the server's single 720x1280 input (cli/serve.py, FULL_SIZE)
SERVE_BLOCK_GEOMETRIES = (
    ("layer1.0", 180, 320, 128, 64, 256, 1, True, 1),
    ("layer1.1-2", 180, 320, 256, 64, 256, 1, False, 2),
    ("layer2.1-3", 90, 160, 512, 128, 512, 1, False, 3),
    ("layer3.0", 90, 160, 512, 256, 1024, 1, True, 1),
    ("layer3.1-5", 90, 160, 1024, 256, 1024, 2, False, 5),
    ("layer4.0", 90, 160, 1024, 512, 2048, 2, True, 1),
    ("layer4.1-2", 90, 160, 2048, 512, 2048, 4, False, 2),
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
# the zoo phase's new geometries at the eval's largest pyramid level
# (568x1000), same fields: resnet101dilated (OS8; 32 of 33 blocks, all but
# layer2.0's stride 2); resnet50 and resnet101 at OS32 (13 of 16 and 30 of
# 33: the strided first blocks of layers 2-4 are not fused), layers 3 and
# 4 at dilation 1 on maps of 1/16 and 1/32; HRNetV2's layer1 (two stride-2
# convs to 1/4, then 64 -> 256)
ZOO_BLOCK_GEOMETRIES = {
    "resnet101dilated": (
        ("layer1.0", 142, 250, 128, 64, 256, 1, True, 1),
        ("layer1.1-2", 142, 250, 256, 64, 256, 1, False, 2),
        ("layer2.1-3", 71, 125, 512, 128, 512, 1, False, 3),
        ("layer3.0", 71, 125, 512, 256, 1024, 1, True, 1),
        ("layer3.1-22", 71, 125, 1024, 256, 1024, 2, False, 22),
        ("layer4.0", 71, 125, 1024, 512, 2048, 2, True, 1),
        ("layer4.1-2", 71, 125, 2048, 512, 2048, 4, False, 2)),
    "resnet50": (
        ("layer1.0", 142, 250, 128, 64, 256, 1, True, 1),
        ("layer1.1-2", 142, 250, 256, 64, 256, 1, False, 2),
        ("layer2.1-3", 71, 125, 512, 128, 512, 1, False, 3),
        ("layer3.1-5", 36, 63, 1024, 256, 1024, 1, False, 5),
        ("layer4.1-2", 18, 32, 2048, 512, 2048, 1, False, 2)),
    "resnet101": (
        ("layer1.0", 142, 250, 128, 64, 256, 1, True, 1),
        ("layer1.1-2", 142, 250, 256, 64, 256, 1, False, 2),
        ("layer2.1-3", 71, 125, 512, 128, 512, 1, False, 3),
        ("layer3.1-22", 36, 63, 1024, 256, 1024, 1, False, 22),
        ("layer4.1-2", 18, 32, 2048, 512, 2048, 1, False, 2)),
    "hrnetv2": (
        ("layer1.0", 142, 250, 64, 64, 256, 1, True, 1),
        ("layer1.1-3", 142, 250, 256, 64, 256, 1, False, 3)),
}
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
# the teacher of cli/main_distillation (deeplabv3plus_embedding_resnet101,
# OS16) on configs/self_distillation.yaml's batch of 5 crops of 768x768,
# same fields as DEEPLAB_BLOCK_GEOMETRIES: its blocks' geometries at
# batch TEACHER_BATCH
TEACHER_BATCH = 5
TEACHER_BLOCK_GEOMETRIES = (
    ("layer1.0", 192, 192, 64, 64, 256, 1, True, 1),
    ("layer1.1-2", 192, 192, 256, 64, 256, 1, False, 2),
    ("layer2.1-3", 96, 96, 512, 128, 512, 1, False, 3),
    ("layer3.1-22", 48, 48, 1024, 256, 1024, 1, False, 22),
    ("layer4.0", 48, 48, 1024, 512, 2048, 1, True, 1),
    ("layer4.1-2", 48, 48, 2048, 512, 2048, 2, False, 2),
)
# DeepLab training at full width and depth on a synthetic tree of 1024x2048
# images: 16 train images (every batch a fresh random crop of 768x768,
# epochs reshuffled), the 5-shot split and 2 val images for the trainer's
# validation. cli/main_deeplab: configs/cityscapes_embedding.yaml (batch 8)
# at DEEPLAB_SMOKE_LR from the deeplab phase's data-started checkpoint, for
# 2 warm-up and 8 timed steps, validating and saving at the last; then
# configs/self_distillation.yaml (batch 5, lr 0.01) for cli/self_distillation
# and cli/main_distillation, 8 steps each; the PLM eval on 4 of the NPM
# tree's val images
DEEPLAB_TRAIN_COUNTS = {"train": 16, "test_car_5_shot": 5, "val": 2}
# cli/main_deeplab's learning rate here, cut from the config's 0.1 (the
# rate does not change a step's work): from random weights at 0.1 the
# first steps move the backbone so far that its BN running statistics
# (momentum 0.01) no longer fit, and the eval-mode forward, which the
# validation, the PLM eval and the distillation teacher run on these
# weights, grows without bound (on the CPU at batch 8 of 192x192 crops:
# the embedding's largest magnitude 4.0 before, 1.6e5 after one step,
# 1.0e6 after two; at 1e-3, 375 after six; at 1e-4, 3.3-4.1 for six)
DEEPLAB_SMOKE_LR = 1e-4
# the training runs' depth, cut (from 10 and 8) to keep the smoke well
# inside its time limit since the golden and zoo phases
DEEPLAB_TRAIN_STEPS = 6
FEWSHOT_TRAIN_STEPS = 6
PLM_EVAL_IMAGES = 4
# the fused route on the PLM eval (the two-head model, first val image at
# 1024x2048) and on the distillation teacher (first batch, 5 crops of
# 768x768), against the unfused route on the same input: in fp32 (TF32 off)
# the logits within DEVICE_CHECK_RTOL of the largest and the argmax (and the
# merged PLM prediction) agreeing on 99 %; in bf16 each routed block on the
# input its unfused twin gets in the unfused forward, within
# BLOCK_TOL["bfloat16"] of the largest magnitude. The two bf16 forwards are
# not held to each other: on these random weights any perturbation of one
# bf16 rounding grows through the 33 blocks to the size of the logits (the
# fp32 forward of the input rounded once moves the argmax as far as bf16
# does; both are printed, see bf16_drift and PERF.md). The first
# distillation loss with the fused teacher lies within 5e-2 of the unfused
# teacher's (its pseudo-labels come from the teacher's argmax at the ignored
# pixels only).
FUSED_LOSS_RTOL = 5e-2
# the ASPP's dilated 3x3 conv (2048 -> 256), shift form against cuDNN, bf16
# channels_last: the eval's layer4 map (1024x2048 / 16) forward, the
# training's (768 / 16, batch 8) forward and backward; within 5e-2 of the
# largest magnitude (each tap's product rounded to bf16 before the float32
# sum, where cuDNN rounds its one float32 sum once)
DILATED_RATES = (6, 12, 18)
DILATED_EVAL_SHAPE = (1, 2048, 64, 128)
DILATED_TRAIN_SHAPE = (8, 2048, 48, 48)
DILATED_TOL = 5e-2
# the raw label ids of the 19 Cityscapes train classes; car, truck, bus
CITYSCAPES_TRAIN_RAW_IDS = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24,
                            25, 26, 27, 28, 31, 32, 33)
CAR, TRUCK, BUS = 26, 27, 28
# the rest of the eval surface (device pyramid, CRF, visualisation,
# test_closed, eval_ood_rec; calibration, save_val_results, Fishyscapes)
PYRAMID_TOL = 1e-5              # the device pyramid, cuda against the CPU
# the device pyramid's chain (uint8 image -> pyramid on the card -> batched
# forward -> device metrics) against the same pyramid through the per-image
# forward and the host float64 sweep, maxlogit, float32 with TF32 off: the
# two differ only by the batch-size-dependent conv rounding (about 1e-6 of
# the logits), which moves the rank of a few of the 921600 pixels and the
# argmax of fewer; a wrong image, level or batch order moves them by 1e-2
# and more
PYRAMID_METRIC_ATOL = 1e-3
N_PYRAMID_CHAIN_IMAGES = 4      # two batches of 2: the batch order counts
N_CRF_IMAGES = 2                # cut from 4, as the training runs
CRF_TOL = 1e-4                  # of Q, cuda against the CPU, float32
CRF_CROP = (64, 128)            # the bilateral CRF's CPU check
N_REST_IMAGES = 4               # test_closed and eval_ood_rec
N_CALIB_IMAGES = 4              # calibration fit and calibrated eval
N_LAF_IMAGES = 2                # synthetic Lost&Found, 1024x2048 (from 4)
# the serve phase (cli/serve.py at FULL_SIZE, bf16): 8 sequential
# requests, a 16-frame stream, 4 clients of 4 requests each at max_batch 4,
# 4 requests each for --device-input, the fused route (and a 4-frame
# stream there) and a served artifact; labels held to the direct forward
# of the same padded batch on 99 % of pixels
N_SERVE_FRAMES = 16
N_SERVE_REQUESTS = 8
N_SERVE_SMALL = 4
SERVE_MAX_BATCH = 4
SERVE_CLIENTS = 4
SERVE_CLIENT_REQUESTS = 4
SERVE_LABEL_AGREEMENT = 0.99
# conf maps against the direct forward: 2e-3 of the largest magnitude, at
# least of 1 (dissum lies in [0, 1])
SERVE_CONF_TOL = 2e-3
SERVE_ROUTED_BLOCKS = 15        # resnet50dilated's blocks on the fused route
N_DEMO_FRAMES = 4               # the live demo, 1024x2048
# the slice phase's eval weights are started again on its own images at
# every pyramid level (eval_start); the first image's dis_sum must then
# clip on less than this share of its pixels
MAX_CLIPPED_SHARE = 0.05
# data_start scales a random embedding until this share of its pixels lies
# within the one-hot centres' magnitude of the origin
CENTRE_MAGNITUDE = 3.0
EMBEDDING_NORM_QUANTILE = 0.99
# golden phase: the JAX package's flagship recipe (docs/DESIGN.md, its v5e
# run), resnet50dilated + ppm_deepsup_embedding, trained in bf16, the main
# scoring in fp32 (TF32 off); the gates of its CPU test
# (tests/test_golden_convergence.py) and, reported only, the flagship's
GOLDEN_RECIPE = dict(steps=2000, lr=0.05, img_size=128, noise=10.0,
                     n_val=13, n_train=64, n_blobs=5, min_block=40)
GOLDEN_GATES = {"mean_iou": 0.55, "accuracy": 0.70, "auroc": 0.85}
GOLDEN_FLAGSHIP = {"mean_iou": 0.8, "auroc": 0.9}
GOLDEN_JAX_V5E = {"dissum": {"auroc": 0.912, "aupr": 0.450, "fpr": 0.202,
                             "mean_iou": 0.821},
                  "msp": {"auroc": 0.901, "aupr": 0.380, "fpr": 0.213}}
GOLDEN_ROUTED = 15              # resnet50dilated's stride-1 bottlenecks
GOLDEN_FUSED_AUROC_TOL = 1e-3   # the fused dissum eval against the unfused
GOLDEN_FUSED_LABELS = 0.99      # labels equal on this share of pixels
# the Cityscapes NPM golden shape with the repo's NPM model, in float32
# (TF32 off) as the JAX package's CPU test runs it. 19 val images where
# that test has 4: at 4 the val car is only the 8-pixel presence strip,
# and while the novel IoU passes its gate in both packages, the base mIoU
# of the 400-step model falls under the 0.3 gate for some seeds in both
# (the JAX package on the CPU 0.277 and 0.412 for seeds 0 and 1; the port
# on the card 0.41, 0.43, 0.24 and 0.38 for seeds 0-3; PERF.md §6); the
# generator's featured block cycles through the 19 classes, so at 19 one
# val image has a car block
GOLDEN_CITYSCAPES = dict(model="deeplabv3plus_embedding_resnet101",
                         steps=400, bs=4, crop=128, h=128, w=256, n_val=19)
# zoo phase: cli.eval_ood on the slice phase's 720x1280 tree, 5-scale
# pyramid, bf16, N_ZOO_IMAGES images in one batch; (encoder, decoder, the
# routes run: False unfused, True fused, method). The inference CLIs
# build C1, C1DeepSup, PPM and UPerNet with their softmax, as the JAX
# package's do; over those probabilities dissum's negative sum is -1 up to
# rounding (in bf16 often exactly, and its min-max normalised map 0/0), so
# these pairs are scored by msp and the PPM deep-supervision ones by dissum
ZOO_RUNS = (
    ("resnet101dilated", "ppm_deepsup_embedding", (False, True), "dissum"),
    ("resnet50", "upernet", (True,), "msp"),
    ("resnet101", "upernet", (True,), "msp"),
    ("hrnetv2", "c1", (False, True), "msp"),
    ("resnet18dilated", "c1_deepsup", (False,), "msp"),
    ("resnet34dilated", "ppm_deepsup", (False,), "dissum"),
    ("mobilenetv2dilated", "c1_deepsup", (False,), "msp"),
    ("resnext101", "upernet_lite", (False,), "msp"),
    ("resnet101dilated", "ppm", (False,), "msp"),
)
ZOO_ROUTED = {"resnet101dilated": 32, "resnet50": 13, "resnet101": 30,
              "hrnetv2": 4}
N_ZOO_IMAGES = 2
ZOO_CHECK_SIZE = (96, 128)      # the fp32 card-against-CPU forward
ZOO_DEEPLAB = ("deeplabv3plus_mobilenet", "deeplabv3_mobilenet",
               "deeplabv3plus_embedding_mobilenet")
# quant phase (ops/quant.py): the golden weights evaluated int8 in every
# eval mode beside the same run's bf16 eval, with the drift bounds of the
# JAX package's tests/test_quant_drift.py; a 5-scale pyramid around the
# golden images' 128-pixel training scale (their short side), as the eval
# config's spans 300-600 around 720x1280's
QUANT_EVAL_MODES = ("int8", "int8-3x3", "int8-hybrid", "w4a8")
QUANT_DRIFT = {"auroc": 0.05, "aupr": 0.08, "mean_iou": 0.05}
# the modes that test gates; int8-3x3 and w4a8 are printed: on the golden
# weights their dissum drift leaves the bounds (AUPR -0.169 and -0.217,
# PERF.md §6), where the port's forward in both is the JAX package's (the
# Bottleneck twin of tests/test_torch_quant_model.py), and
# quant_conv_device_check holds their convs on the card to the CPU
QUANT_GATED_MODES = ("int8", "int8-hybrid")
QUANT_PYRAMID = (96, 112, 128, 144, 160)
QUANT_MAX_SIZE = 400
QUANT_CALIB_IMAGES = 4          # the JAX eval's default calib_images
QUANT_DEEPLAB_CALIB = 2         # Cityscapes val images calibrating DeepLab
ASPP_QUANT_SHAPE = (1, 2048, 64, 128)   # the OS16 ASPP input at 1024x2048
# VOC: deeplabv3plus_mobilenet, 21 classes, crop 513 (the reference's
# VOC recipe), a synthetic VOCdevkit of differing image sizes
VOC_SIZES = ((375, 500), (500, 375), (333, 500), (500, 333))
VOC_TRAIN_IMAGES = 16
VOC_VAL_IMAGES = 4
VOC_STEPS = 6
VOC_BATCH = 8
VOC_CROP = 513
# the ddp phase: data-parallel training over ranks of one card (gloo on
# CUDA tensors; NCCL refuses two ranks on one device) and one-rank NCCL
DDP_WORLD = 2
DDP_PARITY_BATCH = 2            # per rank; one process takes the 4
DDP_PARITY_SIZE = (320, 384)    # the step parity's images (labels at 1/8)
DDP_PARITY_STEPS = 3
DDP_IGNORE_SHARE = (0.1, 0.6)   # ignored labels per rank: uneven
# 2 ranks against 1 process in float64: the losses within this; and the
# norm of the difference of all the tensors over the norm of the change
# the 3 steps made, held to a noise floor, as fp32 is below: at most
# DDP_F64_NOISE_RATIO times that of one process on the same batch in
# reverse order (the same sums in another order) plus DDP_F64_FLOOR. The
# network amplifies rounding: on the slice phase's data-started weights a
# fixed bound of 1e-5 of each tensor's change failed (1.3e-3, norm
# 2.7e-6), where random weights gave 4.1e-8 on the card (my chip runs)
DDP_F64_LOSS_RTOL = 1e-7
DDP_F64_NOISE_RATIO = 4.0
DDP_F64_FLOOR = 1e-8
# in fp32 (TF32 off) the network amplifies rounding until a small tensor's
# difference passes its change (one process, fp32 against float64, on the
# CPU at random weights), so an fp32 run is held to a noise floor: the
# norm of the difference of all its tensors over the norm of the change,
# at most this many times the floor plus DDP_F32_FLOOR
DDP_F32_NOISE_RATIO = 4.0
DDP_F32_FLOOR = 1e-6
# the one-rank NCCL run against the plain one (fp32, the same weights and
# batches): the first loss, before any update, equal within this; the
# weights held as above to the floor of two plain runs (cuDNN's backward
# sums in a varying order)
DDP_NCCL_LOSS_RTOL = 1e-6
DDP_BN_DTYPE_ATOL = 5e-2        # a bf16 BN output against one process's
DDP_CLI_STEPS = 4               # train_embedding under torch.distributed.run
DDP_CLI_SIZES = "(300, 375)"    # short sides, cut from the config's 300-600
DDP_CLI_MAX_SIZE = "600"        # long side, cut from 1000
DDP_DEEPLAB_STEPS = 2           # main_deeplab under torch.distributed.run,
DDP_DEEPLAB_BATCH = 4           # a rank: the config's 8 over the 2 ranks
DDP_SUPPORT_PER_RANK = 2        # support images a rank extracts from
DDP_PROTO_RTOL = 1e-4           # the prototype, 2 ranks against 1 process
DDP_RANK_TIMEOUT_S = 300        # a rank job that has not ended fails the run
DDP_PROFILED_SIZE = (568, 1000)  # the pyramid's largest level
DDP_PROFILED_BLOCKS = 15        # resnet50dilated's routed blocks
# a served request or stream that has not answered in this many seconds
# fails the run instead of holding it to the chip's time limit
SERVE_TIMEOUT_S = 120
# past this many seconds the run prints every thread's stack and exits
# non-zero, inside the 1200 s its callers allow
WATCHDOG_S = 1150
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


def _tf32_off():
    """Turns TF32 off; returns the flags to restore with ``_tf32_set``."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _tf32_set((False, False))
    return saved


def _tf32_set(flags):
    import torch

    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


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

    tf32 = _tf32_off()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    zoo_geometries = sorted({g[1:8] for rows in ZOO_BLOCK_GEOMETRIES.values()
                             for g in rows})
    shapes = ([(1, *g[1:8]) for g in BLOCK_GEOMETRIES
               + SERVE_BLOCK_GEOMETRIES + DEEPLAB_BLOCK_GEOMETRIES]
              + [(1, *g) for g in zoo_geometries]
              + [(TEACHER_BATCH, *g[1:8]) for g in TEACHER_BLOCK_GEOMETRIES]
              + list(BLOCK_RAGGED))
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
    _tf32_set(tf32)

    per_geometry, totals = time_block_geometries(BLOCK_GEOMETRIES, gen)
    deeplab_rows, deeplab_totals = time_block_geometries(
        DEEPLAB_BLOCK_GEOMETRIES, gen)
    teacher_rows, teacher_totals = time_block_geometries(
        TEACHER_BLOCK_GEOMETRIES, gen, n=TEACHER_BATCH)
    serve_rows, serve_totals = time_block_geometries(SERVE_BLOCK_GEOMETRIES,
                                                     gen)
    # the zoo's encoders on the fused route, one forward at the largest
    # pyramid level; launches from the zoo phase's fused runs
    zoo = {}
    for encoder, geometries in ZOO_BLOCK_GEOMETRIES.items():
        zoo_rows, zoo_totals = time_block_geometries(geometries, gen)
        zoo[encoder] = {**zoo_totals, "launches": None,
                        "per_geometry": zoo_rows}
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
                    "plm_eval_launches": None,
                    "per_geometry": deeplab_rows},
        # the 31 fused blocks of the distillation teacher's forward, batch
        # 5 of 768x768 crops; launches from the fused-teacher run
        "distillation_teacher": {**teacher_totals, "launches": None,
                                 "batch": TEACHER_BATCH,
                                 "per_geometry": teacher_rows},
        # the 15 fused blocks of one served forward at 720x1280; launches
        # (block calls) and kernel launches from the server's fused run
        "serve": {**serve_totals, "launches": None,
                  "per_geometry": serve_rows},
        "zoo": zoo,
        # the golden run's fused dissum eval on trained weights (128x192)
        "golden_launches": None,
    }


def time_block_geometries(geometries, gen, n=1):
    """Time fused_bottleneck in bf16 at ``geometries``, batches of ``n``:
    the wrapper, the three launches alone (``kernel_ms``) and each launch
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
        x, ws = _block_inputs(gen, n, h, w, cin, cmid, cout, down,
                              torch.bfloat16)
        launch, _ = fused_block.fused_bottleneck_launcher(x, *ws,
                                                          dilation=d)
        row = {"block": name, "shape": [n, h, w, cin, cmid, cout, d],
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
               "plan": fused_block.launch_plan(n, h, w, cmid, cout, sms)}
        # the work of n images: n times the pixels, the weights read once
        t_ops, t_bytes = fused_bottleneck_bound_ms(n * h, w, cin, cmid, cout,
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
    reference's encoder/decoder .pth pair in ``root``, with a
    data-dependent start: BN running statistics are taken from one forward
    over the first two eval images, so every BN normalises its input as a
    trained one would, and the last 1x1 conv is scaled so that the
    embedding lies within the one-hot centers' magnitude (3) on 99 % of
    its pixels, or for a plain decoder (ppm_deepsup) to a logit std of 1.
    Without that the 50-layer residual stream grows until every dissum
    value clips at 400 and the min-max normalised map is 0/0."""
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
    data_start(model, img, items[0]["seg_label"].shape[1:3],
               cfg.MODEL.arch_decoder.endswith("embedding"))
    return save_pair(model, root, "_epoch_0")


def data_start(model, img, seg_size, embedding, dtype=None):
    """BN running statistics from train-mode forwards over ``img`` (a
    batch of at least 2, or a list of such batches, one per pyramid
    level: their mean), then the last 1x1 conv scaled, over the eval
    forwards (of up to 4 images of each batch) under autocast to ``dtype``
    where one is given: an embedding until 99 % of its pixels lie within
    the one-hot centres' magnitude (3) of the origin, where a trained
    embedding sits (random weights give heavy tails, which a scale by the
    spread alone leaves beyond dis_sum's clip at 400 on 5-20 % of a
    level's pixels); a plain decoder's logits to a std of 1. See
    ``write_random_checkpoint``."""
    import torch

    batches = [img] if torch.is_tensor(img) else list(img)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None          # running stats: the batches' mean
            m.num_batches_tracked.zero_()
    with torch.no_grad():
        for x in batches:
            model.train()(x, seg_size=seg_size)
        outs = []
        with torch.autocast(batches[0].device.type, dtype=dtype,
                            enabled=dtype is not None):
            for x in batches:
                out = model.eval()(x[:4], seg_size=seg_size)
                outs.append((out["ft"] if embedding
                             else out["scores"]).float())
        out = torch.cat(outs)
        if embedding:
            norms = out.reshape(-1, out.shape[-1]).norm(dim=1)
            # torch.quantile takes up to 2**24 values: a strided sample
            norms = norms[::-(-norms.numel() // 2 ** 20)]
            scale = CENTRE_MAGNITUDE / torch.quantile(
                norms, EMBEDDING_NORM_QUANTILE).item()
        else:
            scale = 1.0 / out.std().item()
        head = last_conv(model.decoder)
        head.weight.mul_(scale)
        head.bias.mul_(scale)


def last_conv(decoder):
    """The decoder's last 1x1 conv: the classifier, or the embedding."""
    from open_world_semantic_segmentation_tpu_torch.models import decoders

    if isinstance(decoder, decoders.UPerNet):
        return decoder.conv_last[1]
    if isinstance(decoder, decoders.C1):
        return decoder.conv_last
    return decoder.conv_last[4]          # the PPM family


def pyramid_batches(cfg, max_images=None):
    """The eval's pyramid of the first ``max_images`` images of ``cfg``'s
    val list, one batch per level on the card, and the label size."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.data.odgt import (
        ValPipeline)

    items = list(ValPipeline(cfg.DATASET.root_dataset, cfg.DATASET.list_val,
                             img_sizes=cfg.DATASET.imgSizes,
                             img_max_size=cfg.DATASET.imgMaxSize,
                             padding_constant=cfg.DATASET.padding_constant,
                             max_sample=max_images or -1))
    levels = [torch.from_numpy(np.concatenate(
        [it["img_data"][lvl] for it in items])).to(DEVICE)
        for lvl in range(len(items[0]["img_data"]))]
    return levels, tuple(items[0]["seg_label"].shape[1:3])


def dissum_clipped_share(model, levels, seg_size, dtype):
    """The share of the first image's pixels whose dis_sum (the negative
    sum of the 5-scale averaged scores) clips at 400, in ``dtype``."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.openset.evaluator import (
        multi_scale_forward)

    with torch.no_grad(), torch.autocast(DEVICE, dtype=dtype,
                                         enabled=dtype != torch.float32):
        scores, _ = multi_scale_forward(model.eval(),
                                        [x[:1] for x in levels], seg_size,
                                        want_ft=False)
    return float((-scores.float().sum(-1) >= 400).float().mean())


def eval_start(root, cfg):
    """The slice phase's eval weights: its checkpoint with the
    data-dependent start taken again on all the eval's images at every
    pyramid level (the BN statistics their mean), the embedding's scale
    from the bf16 eval forward, as ``serve_start`` does for the served
    frames. A start on two images at one level leaves the other images and
    levels' residual stream free to grow until dis_sum clips at 400 on
    99-100 % of the pixels. Returns a copy of ``cfg`` naming the new .pth
    pair and the first image's clipped share (bf16)."""
    import copy

    import torch

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)

    model = init_or_load_variables(cfg, build_anomaly_model(cfg, DEVICE))
    levels, seg_size = pyramid_batches(cfg)
    data_start(model, levels, seg_size, embedding=True, dtype=torch.bfloat16)
    clipped = dissum_clipped_share(model, levels, seg_size, torch.bfloat16)
    out = copy.deepcopy(cfg)
    out.MODEL.weights_encoder, out.MODEL.weights_decoder = save_pair(
        model, os.path.join(root, "eval_start"), "")
    log(f"slice: data-dependent start on the eval's {levels[0].shape[0]} "
        f"images at {len(levels)} levels; dis_sum clipped on {clipped} of "
        "the first image's pixels")
    if not clipped < MAX_CLIPPED_SHARE:
        raise AssertionError(f"eval start: dis_sum clips on {clipped}")
    return out, clipped


def save_pair(model, root, suffix):
    """The model as the reference's encoder/decoder .pth pair in ``root``;
    returns the two paths."""
    import torch

    os.makedirs(root, exist_ok=True)
    paths = []
    for part in ("encoder", "decoder"):
        path = os.path.join(root, f"{part}{suffix}.pth")
        torch.save(getattr(model, part).state_dict(), path)
        paths.append(path)
    return paths


def slice_phase(root):
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import eval_ood
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.ops.knn import knn_cosine
    from open_world_semantic_segmentation_tpu_torch.openset import scoring

    odgt = write_street_tree(root, N_IMAGES, FULL_SIZE, SEED)
    cfg = load_config("configs/test_ood_street.yaml", [
        "DATASET.root_dataset", root, "DATASET.list_val", odgt])
    enc, dec = write_random_checkpoint(cfg, root, SEED)
    cfg.MODEL.weights_encoder, cfg.MODEL.weights_decoder = enc, dec
    cfg, clipped = eval_start(root, cfg)
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
        "dissum": ("dissum", {}, {}),
        "knn": ("knn", {}, {"knn_cosine": N_IMAGES}),
        "dissum_fused": ("dissum", {"fused_blocks": True},
                         {"fused_bottleneck": n_batches * n_levels * routed}),
        "dissum_device_metrics": ("dissum", {"device_metrics": True}, {}),
    }
    summaries = {}
    launches = {}
    # the dtypes of the features the eval hands the knn kernel
    knn_dtypes = set()

    def knn_spy(ft, *args, **kwargs):
        knn_dtypes.add(str(ft.dtype).split(".")[-1])
        return knn_cosine(ft, *args, **kwargs)

    # the dissum maps of the host-sweep and device-metrics runs, kept on
    # the card and checked after each run: finite and not constant
    dissum_maps = {}
    for run, (method, kw, want) in runs.items():
        cfg.OOD.ood = method
        scoring.knn_cosine = knn_spy
        try:
            with kept_confs() as confs:
                result, launches[run] = counted(
                    run, lambda kw=kw: eval_ood.main(
                        cfg, torch.bfloat16, batch_images=batch,
                        device=DEVICE, **kw), want)
        finally:
            scoring.knn_cosine = knn_cosine
        if run in ("dissum", "dissum_device_metrics"):
            dissum_maps[run] = [(float(c.min()), float(c.max()),
                                 bool(torch.isfinite(c).all()))
                                for c in confs]
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
        summaries[run] = summary
    log(f"knn_cosine input dtypes on the eval path: {sorted(knn_dtypes)}")
    if knn_dtypes != {"bfloat16"}:
        raise AssertionError(f"knn input dtypes {knn_dtypes}, want bf16 "
                             "(the model dtype, as in the JAX package)")
    summaries["knn_input_dtype"] = knn_dtypes.pop()
    log(f"forward s/img: default {summaries['dissum']['forward_s_per_img']}"
        f", fused_blocks {summaries['dissum_fused']['forward_s_per_img']}")
    summaries["dissum_clipped_share"] = clipped
    for run, ranges in dissum_maps.items():
        log(f"{run} conf maps (min, max, finite): " + json.dumps(ranges))
        if len(ranges) != N_IMAGES or not all(
                finite and lo < hi for lo, hi, finite in ranges):
            raise AssertionError(f"{run}: dissum maps not all finite and "
                                 "varied")
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
def path_kernels():
    """Every kernel wrapper of the port, by name."""
    from open_world_semantic_segmentation_tpu_torch.ops.fused_block import (
        fused_bottleneck)
    from open_world_semantic_segmentation_tpu_torch.ops.knn import knn_cosine

    return {"knn_cosine": knn_cosine, "fused_bottleneck": fused_bottleneck}


def counted(name, run, want=None):
    """``run()`` with every kernel's launch count set to 0 just before and
    read just after; fails unless the counts are ``want`` (a kernel that
    ``want`` does not name: no launch). fused_bottleneck counts block
    calls, and beside them the kernel launches its wrapper enqueued, which
    must be three per block call; they come back as
    ``fused_bottleneck_kernels``. Returns ``run``'s result and the
    counts."""
    kernels = path_kernels()
    for fn in kernels.values():
        fn.launches = 0
    fused = kernels["fused_bottleneck"]
    fused.kernel_launches = 0
    out = run()
    launches = {k: fn.launches for k, fn in kernels.items()}
    phases = fused.kernel_launches
    want = {**dict.fromkeys(kernels, 0), **(want or {})}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    if phases != 3 * launches["fused_bottleneck"]:
        raise AssertionError(f"{name}: {phases} fused_bottleneck kernel "
                             f"launches for {launches['fused_bottleneck']} "
                             "block calls")
    return out, {**launches, "fused_bottleneck_kernels": phases}


def _finite(name, values):
    """Fails unless every number in ``values`` is finite (strings pass)."""
    for key, value in values.items():
        if isinstance(value, str):
            continue
        if value is None or not np.isfinite(value):
            raise AssertionError(f"{name}: {key} = {value}")


def write_rec_tree(root, odgt, rec_root, seed):
    """The reconstructed tree of ``cli.eval_ood_rec``: each image of
    ``odgt`` with seeded Gaussian noise (std 12), under
    ``rec_root/<folder>/<name>`` as the reference matches them."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.default_rng(seed)
    with open(odgt) as f:
        records = json.loads(f.readline())
    with ThreadPoolExecutor(8) as pool:
        saves = []
        for rec in records:
            img = np.asarray(Image.open(os.path.join(root,
                                                     rec["fpath_img"])))
            noisy = np.clip(img + rng.normal(0, 12, img.shape), 0,
                            255).astype(np.uint8)
            folder, name = rec["fpath_img"].split("/")[-2:]
            os.makedirs(os.path.join(rec_root, folder), exist_ok=True)
            saves.append(pool.submit(Image.fromarray(noisy).save,
                                     os.path.join(rec_root, folder, name),
                                     compress_level=1))
        for save in saves:
            save.result()
    return rec_root


def crf_check(cfg):
    """One image's averaged 5-scale scores (bf16 model) through both CRF
    branches on the card: ms per image (CUDA events, 3 calls after 1) and
    the peak memory the CRF adds; then the CRF on cuda against the CPU in
    float32 with TF32 off: Q within CRF_TOL, crf-gauss on the whole
    720x1280 map, the bilateral crf on a CRF_CROP crop of it (its 170
    channels of 71-tap blurs take minutes per image on the CPU)."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.data.odgt import (
        ValPipeline)
    from open_world_semantic_segmentation_tpu_torch.openset import crf
    from open_world_semantic_segmentation_tpu_torch.openset.evaluator import (
        multi_scale_forward)
    from open_world_semantic_segmentation_tpu_torch.openset.scoring import (
        compute_conf)

    model = init_or_load_variables(cfg, build_anomaly_model(cfg, DEVICE))
    item = ValPipeline(cfg.DATASET.root_dataset, cfg.DATASET.list_val,
                       img_sizes=cfg.DATASET.imgSizes)[0]
    pyramid = [torch.from_numpy(p).to(DEVICE) for p in item["img_data"]]
    with torch.inference_mode(), torch.autocast(DEVICE,
                                                dtype=torch.bfloat16):
        scores = multi_scale_forward(model, pyramid,
                                     item["seg_label"].shape[1:3],
                                     want_ft=False)[0][0]
    del model
    out = {"scores_dtype": str(scores.dtype).split(".")[-1],
           "map": list(scores.shape)}
    for method in ("crf-gauss", "crf"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda m=method: compute_conf(scores, m),
                          iters=3, warmup=1)
        out[method] = {"ms_per_image": ms,
                       "peak_memory_added_bytes":
                       torch.cuda.max_memory_allocated() - base}
    saved = _tf32_off()
    try:
        probs = torch.softmax(scores.float(), dim=-1)
        h, w = CRF_CROP
        for method, fn, p in (
                ("crf-gauss", crf.gaussian_crf, probs),
                ("crf", crf.bilateral_crf, probs[:h, :w].contiguous())):
            got = fn(p).cpu()
            want = fn(p.cpu())
            err = float((got - want).abs().max())
            out[method].update(cuda_vs_cpu_max_abs_q=err,
                               checked_map=list(p.shape[:2]))
            if not err <= CRF_TOL:
                raise AssertionError(f"{method}: cuda vs cpu Q {err}")
    finally:
        _tf32_set(saved)
    log("crf: " + json.dumps(out))
    return out


@contextlib.contextmanager
def kept_confs():
    """Yields a list that collects every conf map the evaluator computes
    inside the block, kept on the card (no host sync in a timed loop)."""
    from open_world_semantic_segmentation_tpu_torch.openset import evaluator

    confs = []
    compute_conf = evaluator.compute_conf

    def kept(*args, **kwargs):
        conf = compute_conf(*args, **kwargs)
        confs.append(conf)
        return conf

    evaluator.compute_conf = kept
    try:
        yield confs
    finally:
        evaluator.compute_conf = compute_conf


def device_pyramid_chain_check(cfg):
    """The device pyramid's batched, device-metrics chain held against its
    per-image, host-sweep twin on the first N_PYRAMID_CHAIN_IMAGES images
    (maxlogit, float32, TF32 off; metrics within PYRAMID_METRIC_ATOL).
    Every conf map of the batched run must be finite and not constant."""
    import copy

    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import eval_ood

    cfg = copy.deepcopy(cfg)
    cfg.OOD.ood = "maxlogit"
    keys = ("auroc", "aupr", "fpr", "mean_iou", "accuracy")
    saved = _tf32_off()
    try:
        with kept_confs() as confs:
            batched, _ = counted("device pyramid chain", lambda: eval_ood.main(
                cfg, torch.float32, max_images=N_PYRAMID_CHAIN_IMAGES,
                batch_images=2, device=DEVICE, device_metrics=True,
                device_pyramid=True))
        ranges = [(float(c.min()), float(c.max()),
                   bool(torch.isfinite(c).all())) for c in confs]
        single, _ = counted("device pyramid per image", lambda: eval_ood.main(
            cfg, torch.float32, max_images=N_PYRAMID_CHAIN_IMAGES,
            batch_images=1, device=DEVICE, device_pyramid=True))
    finally:
        _tf32_set(saved)
    out = {"batched_device_metrics": {k: batched[k] for k in keys},
           "per_image_host_sweep": {k: single[k] for k in keys},
           "conf_min_max_finite": ranges}
    out["max_abs_diff"] = max(abs(batched[k] - single[k]) for k in keys)
    log("device pyramid chain, maxlogit, float32: " + json.dumps(out))
    if not batched["images"] == len(ranges) == N_PYRAMID_CHAIN_IMAGES:
        raise AssertionError(f"device pyramid chain: {batched['images']} "
                             f"images, {len(ranges)} conf maps")
    for lo, hi, finite in ranges:
        if not (finite and lo < hi):
            raise AssertionError(f"device pyramid chain: conf {lo}..{hi}")
    _finite("device pyramid chain", out["batched_device_metrics"])
    if not 0.0 < batched["auroc"] < 1.0:
        raise AssertionError(f"device pyramid chain: auroc "
                             f"{batched['auroc']}")
    if not out["max_abs_diff"] <= PYRAMID_METRIC_ATOL:
        raise AssertionError("device pyramid chain: batched device metrics "
                             f"vs per-image host sweep {out['max_abs_diff']}")
    return out


def street_rest_phase(root, cfg, device_metrics_run):
    """The rest of the StreetHazards eval surface at full width: the
    device pyramid, the two CRFs, VAL.visualize, ``cli.test_closed`` and
    ``cli.eval_ood_rec`` with a seeded ppm_deepsup checkpoint; see the
    module note. ``device_metrics_run``: the slice phase's summary of the
    PIL-pyramid run with device metrics, printed beside the new one."""
    import copy

    import torch
    from PIL import Image

    from open_world_semantic_segmentation_tpu_torch.cli import (
        eval_ood, eval_ood_rec, test_closed)
    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.data.odgt import (
        ValPipeline)
    from open_world_semantic_segmentation_tpu_torch.openset import evaluator

    out = {}
    # the device pyramid, beside the PIL pyramid's device-metrics run
    cfg = copy.deepcopy(cfg)
    cfg.OOD.ood = "dissum"
    result, _ = counted("device pyramid", lambda: eval_ood.main(
        cfg, torch.bfloat16, batch_images=2, device=DEVICE,
        device_metrics=True, device_pyramid=True))
    n = result["images"]
    run = {"images": n, "imgs_per_s": n / result["seconds"],
           "forward_s_per_img": result["inference_time"],
           "wait_s_per_img": result["wait_time"],
           "metric_s_per_img": result["metric_time"]}
    run.update({k: result[k] for k in ("mean_iou", "accuracy", "auroc",
                                       "aupr", "fpr")})
    log("eval_ood dissum, device metrics, device pyramid: "
        + json.dumps(run) + "; PIL pyramid: " + json.dumps(
            {k: device_metrics_run[k] for k in (
                "imgs_per_s", "forward_s_per_img", "wait_s_per_img",
                "metric_s_per_img")}))
    if n != N_IMAGES:
        raise AssertionError(f"device pyramid: evaluated {n} images")
    _finite("device pyramid", run)
    item = ValPipeline(cfg.DATASET.root_dataset, cfg.DATASET.list_val,
                       img_sizes=cfg.DATASET.imgSizes,
                       device_pyramid=True)[0]
    raw = torch.from_numpy(item["img_raw"])
    got = evaluator.device_pyramid(raw.to(DEVICE), item["pyramid_shapes"])
    want = evaluator.device_pyramid(raw, item["pyramid_shapes"])
    err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    run["pyramid_cuda_vs_cpu_max_abs"] = err
    log(f"device pyramid, cuda vs cpu, {len(got)} levels: max |diff| {err}")
    if not err <= PYRAMID_TOL:
        raise AssertionError(f"device pyramid: cuda vs cpu {err}")
    run["chain_check"] = device_pyramid_chain_check(cfg)
    # printed only: the share of the first image's pixels whose dis_sum
    # clips at 400 (the min-max normalised map is 0/0 where all do), with
    # the PIL pyramid the checkpoint's start was taken on and with the
    # device pyramid (no antialiasing filter when it shrinks the image)
    model = init_or_load_variables(cfg, build_anomaly_model(cfg, DEVICE))
    pil = ValPipeline(cfg.DATASET.root_dataset, cfg.DATASET.list_val,
                      img_sizes=cfg.DATASET.imgSizes)[0]
    for name, pyramid in (("pil", [torch.from_numpy(p).to(DEVICE)
                                   for p in pil["img_data"]]),
                          ("device", got)):
        with torch.inference_mode(), torch.autocast(DEVICE,
                                                    dtype=torch.bfloat16):
            scores = evaluator.multi_scale_forward(
                model, pyramid, pil["seg_label"].shape[1:3],
                want_ft=False)[0]
        dissum = -scores[0].float().sum(-1)
        run[f"dissum_clipped_share_{name}"] = float(
            (dissum >= 400).float().mean())
    del model
    log("dissum clipped at 400, first image: " + json.dumps(
        {k: v for k, v in run.items() if k.startswith("dissum_clipped")}))
    out["device_pyramid"] = run

    # the CRFs: 4 images each through the eval, every conf map kept on the
    # card (4 x 3.7 MB within the peak) and checked after the run

    out["crf"] = crf_check(cfg)
    for method in ("crf-gauss", "crf"):
        cfg.OOD.ood = method
        torch.cuda.reset_peak_memory_stats()
        with kept_confs() as confs:
            result, _ = counted(method, lambda: eval_ood.main(
                cfg, torch.bfloat16, max_images=N_CRF_IMAGES,
                batch_images=2, device=DEVICE))
        run = {"images": result["images"],
               "s_per_img": result["seconds"] / result["images"],
               "forward_s_per_img": result["inference_time"],
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        run.update({k: result[k] for k in ("auroc", "aupr", "fpr",
                                           "mean_iou")})
        conf_range = [(float(c.min()), float(c.max()),
                       bool(torch.isfinite(c).all()), str(c.dtype))
                      for c in confs]
        log(f"eval_ood {method}: " + json.dumps(run) + " conf maps (min, "
            "max, finite, dtype) " + json.dumps(conf_range))
        if result["images"] != N_CRF_IMAGES or len(conf_range) != \
                N_CRF_IMAGES:
            raise AssertionError(f"{method}: {result['images']} images")
        _finite(method, run)
        for lo, hi, finite, dtype in conf_range:
            if not (finite and 0.0 <= lo and hi <= 1.0
                    and dtype == "torch.float32"):
                raise AssertionError(f"{method}: conf {lo}..{hi} {dtype}")
        out["crf"][method].update(run)

    # VAL.visualize: the [image | gt | pred] grids of 2 images
    cfg.OOD.ood = "dissum"
    cfg.VAL.visualize = True
    cfg.DIR = os.path.join(root, "visualize")
    counted("visualize", lambda: eval_ood.main(
        cfg, torch.bfloat16, max_images=2, batch_images=2, device=DEVICE))
    grids = sorted(os.listdir(os.path.join(cfg.DIR, "result")))
    shapes = [np.asarray(Image.open(os.path.join(cfg.DIR, "result", g))).shape
              for g in grids]
    log(f"VAL.visualize: {grids} {shapes}")
    h, w = FULL_SIZE
    if grids != ["0.png", "1.png"] or shapes != [(h, 3 * w, 3)] * 2:
        raise AssertionError(f"VAL.visualize wrote {grids} {shapes}")
    out["visualize"] = {"grids": grids, "shapes": shapes}

    # ppm_deepsup: the closed-set test and reconstruction scoring
    opts = ["DATASET.root_dataset", cfg.DATASET.root_dataset,
            "DATASET.list_val", cfg.DATASET.list_val]
    ccfg = load_config("configs/test_test.yaml", opts + [
        "TEST.result", os.path.join(root, "closed")])
    enc, dec = write_random_checkpoint(ccfg, os.path.join(root, "deepsup"),
                                       SEED + 4)
    weights = ["MODEL.weights_encoder", enc, "MODEL.weights_decoder", dec]
    ccfg = load_config("configs/test_test.yaml", opts + weights + [
        "TEST.result", os.path.join(root, "closed")])
    torch.cuda.reset_peak_memory_stats()
    result, _ = counted("test_closed", lambda: test_closed.main(
        ccfg, torch.bfloat16, max_images=N_REST_IMAGES, device=DEVICE))
    pngs = sorted(os.listdir(os.path.join(root, "closed", "t1")))
    preds = [np.asarray(Image.open(os.path.join(root, "closed", "t1", p)))
             for p in pngs]
    run = {"images": result["images"],
           "imgs_per_s": result["images"] / result["seconds"],
           "forward_s_per_img": result["inference_time"],
           "pngs": len(pngs), "png_values": [int(min(p.min() for p in preds)),
                                             int(max(p.max() for p in preds))],
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    run.update({k: result[k] for k in ("mean_iou", "accuracy", "auroc")})
    log("test_closed ppm_deepsup: " + json.dumps(run))
    if len(pngs) != N_REST_IMAGES or result["images"] != N_REST_IMAGES or \
            any(p.shape != FULL_SIZE for p in preds) or \
            not 1 <= run["png_values"][0] <= run["png_values"][1] <= 13:
        raise AssertionError(f"test_closed: {run}")
    _finite("test_closed", {k: run[k] for k in ("mean_iou", "accuracy")})
    out["test_closed"] = run

    rec_root = write_rec_tree(cfg.DATASET.root_dataset, cfg.DATASET.list_val,
                              os.path.join(root, "test_rec"), SEED + 5)
    rcfg = load_config("configs/test_ood_rec.yaml", opts + weights + [
        "DATASET.rec_dataset", rec_root])
    torch.cuda.reset_peak_memory_stats()
    result, _ = counted("eval_ood_rec", lambda: eval_ood_rec.main(
        rcfg, torch.float32, max_images=N_REST_IMAGES, device=DEVICE))
    run = {"precision": "float32", "images": result["images"],
           "imgs_per_s": result["images"] / result["seconds"],
           "forward_s_per_img": result["inference_time"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    run.update({k: result[k] for k in ("auroc", "aupr", "fpr", "mean_iou",
                                       "accuracy")})
    log("eval_ood_rec: " + json.dumps(run))
    if result["images"] != N_REST_IMAGES:
        raise AssertionError(f"eval_ood_rec: {result['images']} images")
    _finite("eval_ood_rec", run)
    out["eval_ood_rec"] = run
    return out


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
class _Served:
    """One served model's HTTP server on 127.0.0.1 (port 0), with every
    batch its Segmenter dispatches recorded, so that each answer can be
    held to a direct forward of the same padded batch."""

    def __init__(self, cfg, dtype, **kw):
        from open_world_semantic_segmentation_tpu_torch.cli import serve

        tic = time.perf_counter()
        self.server = serve.serve(cfg, dtype, port=0, height=FULL_SIZE[0],
                                  width=FULL_SIZE[1], device=DEVICE, **kw)
        self.startup_s = time.perf_counter() - tic
        self.seg = self.server.segmenter
        self.batches = []
        dispatch = self.seg._dispatch

        def spy(arrs, count=True):
            if count:
                self.batches.append(list(arrs))
            return dispatch(arrs, count)

        self.seg._dispatch = spy
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.answers = []       # (image bytes, pred, conf or None)

    def segment(self, data, scores=False):
        """POST /segment; returns (ms, label map or conf map)."""
        import urllib.request

        from PIL import Image

        tic = time.perf_counter()
        req = urllib.request.Request(
            self.url + ("/segment?scores=dissum" if scores else "/segment"),
            data=data, method="POST")
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
            body = r.read()
        ms = (time.perf_counter() - tic) * 1e3
        out = (np.load(io.BytesIO(body)) if scores
               else np.array(Image.open(io.BytesIO(body))))
        self.answers.append((data, None if scores else out,
                             out if scores else None))
        return ms, out

    def stream(self, frames, scores=False):
        """POST /stream of ``frames``; returns (seconds, results). The
        server answers each frame while it still reads the next ones, so
        the body goes out from a thread while this one reads: a client
        that sends it all before reading deadlocks once both sides' socket
        buffers fill (as they do with label maps of a few hundred KB)."""
        import http.client
        import struct

        from PIL import Image

        body = b"".join(struct.pack(">I", len(f)) + f for f in frames)
        body += struct.pack(">I", 0)
        tic = time.perf_counter()
        conn = http.client.HTTPConnection(
            "127.0.0.1", self.server.server_address[1],
            timeout=SERVE_TIMEOUT_S)
        try:
            conn.putrequest("POST", "/stream?scores=dissum" if scores
                            else "/stream")
            conn.putheader("Content-Length", str(len(body)))
            conn.endheaders()
            sender = threading.Thread(target=conn.send, args=(body,),
                                      daemon=True)
            sender.start()
            out = conn.getresponse().read()
            sender.join(SERVE_TIMEOUT_S)
        finally:
            conn.close()
        seconds = time.perf_counter() - tic
        results, pos = [], 0
        while pos < len(out):
            (n,) = struct.unpack(">I", out[pos:pos + 4])
            payload = io.BytesIO(out[pos + 4:pos + 4 + n])
            results.append(np.load(payload) if scores
                           else np.array(Image.open(payload)))
            pos += 4 + n
        if len(results) != len(frames):
            raise AssertionError(f"/stream: {len(results)} results for "
                                 f"{len(frames)} frames")
        for f, res in zip(frames, results):
            self.answers.append((f, None if scores else res,
                                 res if scores else None))
        return seconds, results

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()

    def check(self, name, direct):
        """Every answer against ``direct(batch)`` (-> per-image labels and
        conf maps on the host) of the padded batch its image went in:
        labels equal on SERVE_LABEL_AGREEMENT of pixels; conf maps float16,
        not all NaN, with their NaNs where the direct forward's are and
        within SERVE_CONF_TOL of its largest magnitude (at least of 1)
        elsewhere. A map normalised over the padded batch instead of per
        image fails the last. Returns the worst label agreement and the
        largest conf difference."""
        seg = self.seg
        cache = {}
        worst, conf_err = 1.0, 0.0
        for data, pred, conf in self.answers:
            arr = seg._decode(data)
            k, i = next((k, i) for k, arrs in enumerate(self.batches)
                        for i, a in enumerate(arrs)
                        if np.array_equal(a, arr))
            if k not in cache:
                cache[k] = direct(padded_batch(seg, self.batches[k]))
            want_pred, want_conf = (t[i] for t in cache[k])
            if pred is not None:
                agree = float((pred == want_pred).mean())
                worst = min(worst, agree)
                if pred.shape != want_pred.shape or \
                        agree < SERVE_LABEL_AGREEMENT:
                    raise AssertionError(f"{name}: served labels agree "
                                         f"with the direct forward on "
                                         f"{agree}")
            if conf is not None:
                nan = np.isnan(want_conf)
                if conf.dtype != np.float16 or nan.all() or \
                        not np.array_equal(np.isnan(conf), nan):
                    raise AssertionError(
                        f"{name}: conf map {conf.dtype} with "
                        f"{int(np.isnan(conf).sum())} NaNs, the direct "
                        f"forward's {int(nan.sum())} of {nan.size}")
                want = want_conf[~nan].astype(np.float32)
                err = float(np.abs(conf[~nan].astype(np.float32)
                                   - want).max())
                if not err <= SERVE_CONF_TOL * max(1.0, np.abs(want).max()):
                    raise AssertionError(f"{name}: conf map {err} from the "
                                         "direct forward's")
                conf_err = max(conf_err, err)
        log(f"serve {name}: {len(self.answers)} answers, {len(cache)} "
            f"batches; label agreement >= {worst}, conf |diff| <= "
            f"{conf_err}")
        return {"answers": len(self.answers), "label_agreement_min": worst,
                "conf_max_abs_diff": conf_err}


def direct_forward(model, dtype, method="dissum", device_input=False):
    """The served computation, written out: the model on a padded batch
    (normalised here when it comes as uint8), the argmax and each image's
    conf map. Returns per-image (labels, conf) on the host."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.data.odgt import (
        IMAGENET_MEAN, IMAGENET_STD)
    from open_world_semantic_segmentation_tpu_torch.openset import scoring

    conf_fn = {"dissum": scoring.dissum_conf,
               "maxlogit": scoring.maxlogit_conf}[method]
    mean = torch.tensor(IMAGENET_MEAN, device=DEVICE)
    std = torch.tensor(IMAGENET_STD, device=DEVICE)

    def run(batch):
        x = torch.from_numpy(batch).to(DEVICE)
        if device_input:
            x = (x.float() / 255.0 - mean) / std
        with torch.inference_mode(), torch.autocast(
                DEVICE, dtype=dtype, enabled=dtype != torch.float32):
            scores = model(x, seg_size=FULL_SIZE)["scores"]
        if method == "maxlogit":          # as the artifact: float32 first
            scores = scores.float()
        conf = torch.stack([conf_fn(s) for s in scores])
        return (scores.argmax(-1).to(torch.uint8).cpu().numpy(),
                conf.half().cpu().numpy())
    return run


def _latency(ms):
    return {"n": len(ms), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(np.mean(ms)), "all_ms": ms}


def serve_phase(root, cfg):
    """The HTTP server of cli/serve.py at 720x1280 in bf16; see the module
    note. Returns the summary and the fused run's counts: block calls,
    kernel launches and forwards."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import export_model
    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.core.export import (
        load_exported)

    bf16 = torch.bfloat16
    images = sorted(os.listdir(os.path.join(root, "images/test/t1")),
                    key=lambda n: int(n.split(".")[0]))
    frames = []
    for name in images[:N_SERVE_FRAMES]:
        with open(os.path.join(root, "images/test/t1", name), "rb") as f:
            frames.append(f.read())
    summary = {}
    cfg, summary["dissum_clipped_share"] = serve_start(root, cfg, frames)
    model = init_or_load_variables(cfg, build_anomaly_model(cfg, DEVICE))
    direct = direct_forward(model, bf16)

    # unfused, batch 1: sequential requests, half with ?scores=dissum, then
    # a stream; peak memory over the server's life
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served = _Served(cfg, bf16)
    try:
        def sequential():
            return [served.segment(frames[i], scores=i % 2 == 1)[0]
                    for i in range(N_SERVE_REQUESTS)]
        ms, _ = counted("serve /segment", sequential)
        (seconds, _), _ = counted("serve /stream",
                                  lambda: served.stream(frames))
        summary["segment"] = _latency(ms)
        summary["stream"] = {"frames": len(frames), "seconds": seconds,
                             "frames_per_s": len(frames) / seconds}
        summary["startup_s"] = served.startup_s
        summary["metrics"] = served.seg.metrics()
        summary["layers"] = serve_layers(served.seg, frames[0])
    finally:
        served.close()
    summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    summary["segment"]["check"] = served.check("batch 1", direct)

    # micro-batched: 4 client threads, 4 requests each, max_batch 4
    served = _Served(cfg, bf16, max_batch=SERVE_MAX_BATCH)
    try:
        tic = time.perf_counter()
        while served.seg.warmed != [1, 2, 4]:
            time.sleep(0.01)
        warm_ladder_s = served.startup_s + time.perf_counter() - tic
        ms = []

        def client(k):
            for j in range(SERVE_CLIENT_REQUESTS):
                i = (k * SERVE_CLIENT_REQUESTS + j) % len(frames)
                ms.append(served.segment(frames[i], scores=j % 2 == 1)[0])

        def concurrent():
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(SERVE_CLIENTS)]
            tic = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return time.perf_counter() - tic
        seconds, _ = counted("serve micro-batched", concurrent)
        n = SERVE_CLIENTS * SERVE_CLIENT_REQUESTS
        if len(ms) != n:
            raise AssertionError(f"micro-batched: {len(ms)} of {n} answered")
        summary["micro_batched"] = {
            **_latency(ms), "clients": SERVE_CLIENTS,
            "max_batch": SERVE_MAX_BATCH, "seconds": seconds,
            "requests_per_s": n / seconds,
            "batches": served.seg.metrics()["batches"],
            "startup_s": served.startup_s,
            "warm_ladder_s": warm_ladder_s}
    finally:
        served.close()
    summary["micro_batched"]["check"] = served.check("micro-batched", direct)

    # --device-input: uint8 shipped, normalised on the card
    served = _Served(cfg, bf16, device_input=True)
    try:
        ms, _ = counted("serve --device-input", lambda: [
            served.segment(frames[i], scores=i % 2 == 1)[0]
            for i in range(N_SERVE_SMALL)])
        summary["device_input"] = {**_latency(ms),
                                   "startup_s": served.startup_s}
    finally:
        served.close()
    summary["device_input"]["check"] = served.check(
        "--device-input", direct_forward(model, bf16, device_input=True))

    # the fused route: 15 block calls per forward, each enqueueing three
    # kernel launches (counted by the wrapper as it enqueues them)
    served = _Served(cfg, bf16, fused_blocks=True)
    routed = sum(m.fused_tile is not None
                 for m in served.seg.model.modules()
                 if hasattr(m, "fused_tile"))
    if routed != SERVE_ROUTED_BLOCKS:
        raise AssertionError(f"serve fused: {routed} routed blocks, want "
                             f"{SERVE_ROUTED_BLOCKS}")
    try:
        def fused_requests():
            out = [served.segment(frames[i], scores=i % 2 == 1)[0]
                   for i in range(N_SERVE_SMALL)]
            return out, served.stream(frames[:N_SERVE_SMALL])[0]
        forwards = 2 * N_SERVE_SMALL
        (ms, stream_s), launches = counted(
            "serve fused", fused_requests,
            {"fused_bottleneck": forwards * SERVE_ROUTED_BLOCKS})
        kernel_launches = launches["fused_bottleneck_kernels"]
        if kernel_launches != forwards * 3 * SERVE_ROUTED_BLOCKS:
            raise AssertionError(f"serve fused: {kernel_launches} kernel "
                                 f"launches in {forwards} forwards")
        summary["fused"] = {
            **_latency(ms), "startup_s": served.startup_s,
            "stream_frames_per_s": N_SERVE_SMALL / stream_s,
            "layers": serve_layers(served.seg, frames[0]),
            "routed_blocks": routed, "forwards": forwards,
            "launches": launches["fused_bottleneck"],
            "kernel_launches": kernel_launches}
    finally:
        served.close()
    fused_model = served.seg.model
    summary["fused"]["check"] = served.check(
        "fused", direct_forward(fused_model, bf16))
    summary["fused"]["kernel_check"] = serve_fused_kernel_check(
        fused_model, served.seg._decode(frames[0]))
    del fused_model, served

    # a bf16 artifact served; the fp32 and bf16 artifacts held to the
    # direct forward (maxlogit, whose map does not clip)
    summary["artifact"] = serve_artifact_run(root, cfg, model, frames,
                                             export_model, load_exported)
    log("serve phase: " + json.dumps(summary))
    return summary, {k: summary["fused"][k]
                     for k in ("launches", "kernel_launches", "forwards")}


def serve_start(root, cfg, frames):
    """The serve phase's weights: the slice phase's checkpoint with its
    data-dependent start taken again on all the served frames, preprocessed
    as the server does at FULL_SIZE, the embedding's scale set from the
    bf16 forward that the server runs. The slice phase's start normalises
    the two tree images it was taken on; on the other images the random
    50-layer residual stream grows (embedding std up to 8 on a CPU
    rehearsal at 64x96), dis_sum clips at 400 on 99-100 % of a served
    frame's pixels, the min-max normalised map is 0/0 and the conf check
    would compare NaNs only. Returns a copy of ``cfg`` naming the new .pth
    pair, and the share of the first frame's pixels whose dis_sum still
    clips (bf16)."""
    import copy

    import torch

    from PIL import Image

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.data.native import (
        resize_normalize)

    model = init_or_load_variables(cfg, build_anomaly_model(cfg, DEVICE))
    img = torch.from_numpy(np.stack([resize_normalize(np.asarray(
        Image.open(io.BytesIO(f)).convert("RGB")), FULL_SIZE)
        for f in frames])).to(DEVICE)
    data_start(model, img, FULL_SIZE, embedding=True, dtype=torch.bfloat16)
    with torch.inference_mode(), torch.autocast(DEVICE,
                                                dtype=torch.bfloat16):
        scores = model(img[:1], seg_size=FULL_SIZE)["scores"]
    clipped = float((-scores.float().sum(-1) >= 400).float().mean())
    out = copy.deepcopy(cfg)
    out.MODEL.weights_encoder, out.MODEL.weights_decoder = save_pair(
        model, os.path.join(root, "serve_start"), "")
    log(f"serve: data-dependent start on the served frames; dis_sum "
        f"clipped on {clipped} of the first frame's pixels")
    return out, clipped


def serve_layers(seg, frame, rounds=5):
    """Where a /segment request's time goes, layer by layer, on one frame:
    the PIL decode and resample (host ms), the dispatch (pad, copy up,
    forward, copy back; host ms until the results are on the host), the
    forward alone (CUDA events, 10 back to back on a resident batch) and
    the PNG or npy encode (host ms); medians over ``rounds``."""
    import torch

    from PIL import Image

    def host_ms(fn):
        out = []
        for _ in range(rounds):
            tic = time.perf_counter()
            fn()
            out.append((time.perf_counter() - tic) * 1e3)
        return float(np.median(out))

    arr = seg._decode(frame)
    pred, conf = seg._run_batch([arr])
    x = torch.from_numpy(padded_batch(seg, [arr])).to(seg.device)

    def encode_png():
        Image.fromarray(pred[0], "L").save(io.BytesIO(), format="PNG")

    return {"decode_ms": host_ms(lambda: seg._decode(frame)),
            "dispatch_ms": host_ms(lambda: seg._run_batch([arr])),
            "forward_ms": cuda_time_ms(lambda: seg._fwd(x), iters=10),
            "encode_png_ms": host_ms(encode_png),
            "encode_npy_ms": host_ms(lambda: np.save(io.BytesIO(), conf[0]))}


def padded_batch(seg, arrs):
    """``arrs`` padded with zeros to the batch size ``seg`` dispatches."""
    size = next(b for b in seg._batch_sizes if b >= len(arrs))
    batch = np.zeros((size, *seg.size, 3), arrs[0].dtype)
    batch[:len(arrs)] = arrs
    return batch


def serve_fused_kernel_check(model, arr):
    """fused_bottleneck against its plain version on the inputs each
    routed block gets in a served forward at 720x1280 (bf16, the folded
    weights the route uses). These launches are outside any count."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.ops.fused_block import (
        fused_bottleneck, fused_bottleneck_plain)

    blocks = {name: m for name, m in model.encoder.named_modules()
              if getattr(m, "fused_tile", None) is not None}
    inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda _, args, name=name: inputs.append((name, args[0])))
        for name, m in blocks.items()]
    x = torch.from_numpy(arr[None]).to(DEVICE)
    with torch.inference_mode(), torch.autocast(DEVICE,
                                                dtype=torch.bfloat16):
        model(x, seg_size=FULL_SIZE)
    for hook in hooks:
        hook.remove()
    tol = BLOCK_TOL["bfloat16"]
    max_err, shapes = 0.0, {}
    with torch.inference_mode():
        for name, xin in inputs:
            block = blocks[name]
            ws = block._folded[(torch.bfloat16, xin.device)]
            xh = xin.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
            d = block.conv2.dilation[0]
            got = fused_bottleneck(xh, *ws, dilation=d).float()
            torch.cuda.synchronize()
            want = fused_bottleneck_plain(xh, *ws, dilation=d).float()
            err = (got - want).abs()
            bad = int((err > tol + tol * want.abs()).sum())
            if bad or not torch.isfinite(got).all():
                raise AssertionError(f"fused_bottleneck disagrees in the "
                                     f"served forward at {name}: {bad}")
            max_err = max(max_err, err.max().item())
            shapes[name] = list(xh.shape)
    log(f"serve fused_bottleneck vs plain on the served inputs: max |err| "
        f"{max_err:.3g} over {len(inputs)} blocks " + json.dumps(shapes))
    return {"blocks": len(inputs), "max_abs_err": max_err,
            "shapes": shapes}


def serve_artifact_run(root, cfg, model, frames, export_model,
                       load_exported):
    """Export the model in bf16 and in fp32 (TF32 off) with the maxlogit
    conf, serve the bf16 artifact for N_SERVE_SMALL requests, and hold the
    artifacts to the direct forward: fp32 within DEVICE_CHECK_RTOL of the
    largest |maxlogit|, bf16 (served) within BF16_ROUTE_FACTOR times the
    direct bf16 forward's distance from fp32."""
    import torch

    paths, export_s = {}, {}
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        tf32 = _tf32_off() if dtype == torch.float32 else None
        tic = time.perf_counter()
        paths[name] = export_model.main(
            cfg, dtype, *FULL_SIZE, method="maxlogit",
            out=os.path.join(root, f"serve_{name}.owss"), device=DEVICE)
        export_s[name] = time.perf_counter() - tic
        if tf32 is not None:
            _tf32_set(tf32)
    served = _Served(None, torch.bfloat16, artifact=paths["bfloat16"])
    try:
        ms, _ = counted("serve artifact", lambda: [
            served.segment(frames[i], scores=i % 2 == 1)[0]
            for i in range(N_SERVE_SMALL)])
    finally:
        served.close()
    result = {**_latency(ms), "startup_s": served.startup_s,
              "export_s": export_s,
              "bytes": os.path.getsize(paths["bfloat16"]),
              "check": served.check("artifact", direct_forward(
                  model, torch.bfloat16, "maxlogit"))}

    # the artifacts' maxlogit maps against the direct forward's, on the
    # frames the artifact served
    tf32 = _tf32_off()
    try:
        fp32_fn, _ = load_exported(paths["float32"])
        arrs = [served.seg._decode(f) for f in frames[:N_SERVE_SMALL]]
        want = [direct_forward(model, torch.float32, "maxlogit")(a[None])[1]
                for a in arrs]
        got = [fp32_fn(torch.from_numpy(a[None]).to(DEVICE))[1].cpu()
               .numpy() for a in arrs]
    finally:
        _tf32_set(tf32)
    bf16_direct = [direct_forward(model, torch.bfloat16, "maxlogit")(
        a[None])[1] for a in arrs]
    served_conf = [c for _, _, c in served.answers if c is not None]
    served_arrs = [served.seg._decode(d) for d, _, c in served.answers
                   if c is not None]

    def rel(a, b):
        a, b = np.float64(a), np.float64(b)
        return float(np.abs(a - b).max() / np.abs(b).max())
    fp32_err = max(rel(g, w) for g, w in zip(got, want))
    by_frame = {i: w for i, w in enumerate(want)}
    served_err = max(rel(c, by_frame[next(i for i, a in enumerate(arrs)
                                          if np.array_equal(a, sa))][0])
                     for c, sa in zip(served_conf, served_arrs))
    direct_err = max(rel(b, w) for b, w in zip(bf16_direct, want))
    bound = BF16_ROUTE_FACTOR * direct_err + DEVICE_CHECK_RTOL
    result.update(fp32_max_rel=fp32_err, bf16_served_max_rel=served_err,
                  bf16_direct_max_rel=direct_err, bf16_bound=bound)
    log(f"serve artifact: fp32 within {fp32_err:.3g} of the direct "
        f"forward (bound {DEVICE_CHECK_RTOL}); bf16 served {served_err:.3g}"
        f" from fp32, direct bf16 {direct_err:.3g} (bound {bound:.3g})")
    if not fp32_err <= DEVICE_CHECK_RTOL:
        raise AssertionError(f"fp32 artifact {fp32_err} from the direct "
                             "forward")
    if not served_err <= bound:
        raise AssertionError(f"bf16 artifact {served_err} from fp32, bound "
                             f"{bound}")
    return result


def demo_phase(root):
    """The live video demo (cli/demo_video.py live_mode) of the Cityscapes
    DeepLab embedding model at 1024x2048, unfused and fused, on the deeplab
    phase's data-started checkpoint; see the module note. Returns the
    summary and the fused run's launches."""
    import torch

    from PIL import Image

    from open_world_semantic_segmentation_tpu_torch.cli import demo_video
    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        build_deeplab_model, init_or_load_deeplab)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.data.cityscapes import (
        decode_target)
    from open_world_semantic_segmentation_tpu_torch.data.odgt import (
        img_transform)

    tree = os.path.join(root, "cityscapes")
    write_cityscapes_tree(tree, {"demo_video": N_DEMO_FRAMES},
                          CITYSCAPES_SIZE, SEED + 5)
    weights = os.path.join(root, "deeplab_embedding.pth")
    cfg = load_config("configs/cityscapes_embedding.yaml", [
        "DATASET.root_dataset", tree, "MODEL.weights_encoder", weights])
    frames = demo_video._frames(cfg).images
    summary, launches = {}, 0
    for fused in (False, True):
        name = "fused" if fused else "unfused"
        model, _ = build_deeplab_model(cfg, DEVICE, fused_blocks=fused)
        init_or_load_deeplab(model, weights)
        routed = sum(getattr(m, "fused_tile", None) is not None
                     for m in model.modules())
        out = os.path.join(root, f"demo_{name}")
        # the first frame of a process picks cuDNN's algorithms
        demo_video.live_mode(cfg, out, torch.bfloat16, max_frames=1,
                             model=model)
        tic = time.perf_counter()
        seq_dir, counts = counted(
            f"demo {name}", lambda: demo_video.live_mode(
                cfg, out, torch.bfloat16, model=model),
            {"fused_bottleneck": routed * len(frames)} if fused else {})
        seconds = time.perf_counter() - tic
        # the first frame again, forwarded here, blended and compared
        frame = np.array(Image.open(frames[0]).convert("RGB"))
        x = torch.from_numpy(img_transform(frame)[None]).to(DEVICE)
        with torch.inference_mode(), torch.autocast(DEVICE,
                                                    dtype=torch.bfloat16):
            pred = model(x)[0].argmax(-1)[0].cpu().numpy()
        blend = (0.5 * frame + 0.5 * decode_target(pred).astype(np.uint8)
                 ).astype(np.uint8)
        written = [np.array(Image.open(os.path.join(
            seq_dir, os.path.basename(f)))) for f in frames]
        agree = float((written[0] == blend).all(-1).mean())
        summary[name] = {"frames": len(frames), "seconds": seconds,
                         "frames_per_s": len(frames) / seconds,
                         "routed_blocks": routed,
                         "launches": counts["fused_bottleneck"],
                         "blend_agreement": agree}
        log(f"demo {name}: " + json.dumps(summary[name]))
        if any(w.shape != (*CITYSCAPES_SIZE, 3) for w in written):
            raise AssertionError(f"demo {name}: frames of "
                                 f"{[w.shape for w in written]}")
        if agree < SERVE_LABEL_AGREEMENT:
            raise AssertionError(f"demo {name}: the first frame's blend "
                                 f"agrees with the direct forward on "
                                 f"{agree}")
        if fused:
            launches = counts["fused_bottleneck"]
        del model
    return summary, launches


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
    torch.cuda.reset_peak_memory_stats()
    tic = time.perf_counter()
    result, launches = counted("the train path", lambda: train_embedding.main(
        cfg, torch.bfloat16, max_steps=TRAIN_STEPS, device=DEVICE))
    seconds = time.perf_counter() - tic
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
@contextlib.contextmanager
def kept_predictions():
    """Yields a list that collects the argmax of every score map the
    evaluator's forward returns inside the block, kept on the card."""
    from open_world_semantic_segmentation_tpu_torch.openset import evaluator

    preds = []
    forward = evaluator.multi_scale_forward

    def kept(*args, **kwargs):
        scores, ft = forward(*args, **kwargs)
        preds.append(scores.argmax(-1))
        return scores, ft

    evaluator.multi_scale_forward = kept
    try:
        yield preds
    finally:
        evaluator.multi_scale_forward = forward


def golden_phase(root):
    """The port's golden convergence run at full width (see the module
    note): the StreetHazards flagship recipe through ``tools/golden_run.py
    run`` with its gates, then the Cityscapes NPM shape
    (``run_cityscapes``) with its gates. Returns the summary and the
    StreetHazards run's launches."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.tools import golden_run

    n_val = GOLDEN_RECIPE["n_val"]
    preds = {}
    evaluate = golden_run._eval

    def recorded(cfg, method, dtype, device, **kw):
        with kept_predictions() as kept:
            out = evaluate(cfg, method, dtype, device, **kw)
        key = (method, str(dtype).split(".")[-1],
               "fused" if kw.get("fused_blocks") else "unfused")
        preds[key] = torch.cat([p.flatten() for p in kept])
        return out

    golden_run._eval = recorded
    tic = time.perf_counter()
    try:
        report, launches = counted("golden", lambda: golden_run.run(
            **GOLDEN_RECIPE, workdir=os.path.join(root, "golden"),
            device=DEVICE), {"knn_cosine": n_val,
                             "fused_bottleneck": n_val * GOLDEN_ROUTED})
    finally:
        golden_run._eval = evaluate
    seconds = time.perf_counter() - tic
    dissum, msp, fused = (report["dissum"], report["msp"],
                          report["dissum_fused"])
    unfused_pred = preds[("dissum", "float32", "unfused")]
    fused_pred = preds[("dissum", "float32", "fused")]
    summary = {"seconds": seconds, "report": report,
               "flagship_criteria": {
                   "mean_iou_ge_0.8": dissum["mean_iou"]
                   >= GOLDEN_FLAGSHIP["mean_iou"],
                   "dissum_auroc_ge_0.9": dissum["auroc"]
                   >= GOLDEN_FLAGSHIP["auroc"]},
               "jax_v5e": GOLDEN_JAX_V5E,
               "fused_auroc_diff": abs(fused["auroc"] - dissum["auroc"]),
               "fused_label_agreement": float(
                   (fused_pred == unfused_pred).float().mean())}
    log("golden: " + json.dumps(summary, default=float) + " launches "
        + json.dumps(launches))
    for name in ("dissum", "msp", "knn", "dissum_fused", "dissum_bf16",
                 "msp_bf16"):
        _finite(f"golden {name}", report[name])
    if report["train"]["skipped"]:
        raise AssertionError(f"golden: {report['train']['skipped']} "
                             "train steps skipped")
    for key, floor in GOLDEN_GATES.items():
        if not dissum[key] >= floor:
            raise AssertionError(f"golden gate: dissum {key} "
                                 f"{dissum[key]} < {floor}")
    if not dissum["auroc"] >= msp["auroc"]:
        raise AssertionError(f"golden gate: dissum auroc {dissum['auroc']}"
                             f" < msp auroc {msp['auroc']}")
    if not summary["fused_auroc_diff"] <= GOLDEN_FUSED_AUROC_TOL:
        raise AssertionError(f"golden: fused dissum auroc {fused['auroc']} "
                             f"vs unfused {dissum['auroc']}")
    if not summary["fused_label_agreement"] >= GOLDEN_FUSED_LABELS:
        raise AssertionError("golden: fused labels agree on "
                             f"{summary['fused_label_agreement']}")

    tic = time.perf_counter()
    cs, _ = counted("golden cityscapes", lambda: golden_run.run_cityscapes(
        **GOLDEN_CITYSCAPES, workdir=os.path.join(root, "golden_cs"),
        precision=torch.float32, device=DEVICE))
    summary["cityscapes"] = {"seconds": time.perf_counter() - tic,
                             "report": cs}
    log("golden cityscapes: " + json.dumps(summary["cityscapes"],
                                           default=float))
    npm, base = cs["npm"], cs["no_override"]
    if not (cs["prototypes"] >= 1 and base["novel_iou"] == 0.0
            and npm["novel_iou"] > 0.1
            and npm["novel_iou"] > base["novel_iou"]
            and npm["base_miou"] >= 0.9 * base["miou"]
            and npm["base_miou"] >= 0.3):
        raise AssertionError("golden cityscapes gates: " + json.dumps(cs))
    return summary, launches


def write_zoo_checkpoint(cfg, root, seed):
    """Seeded random weights for ``cfg``'s pair with the data-dependent
    start of ``eval_start`` on its N_ZOO_IMAGES eval images at every
    pyramid level (bf16 scale), saved as a .pth pair; returns a copy of
    ``cfg`` naming it."""
    import copy

    import torch

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)

    cfg = copy.deepcopy(cfg)
    cfg.MODEL.weights_encoder = cfg.MODEL.weights_decoder = ""
    model = init_or_load_variables(cfg, build_anomaly_model(cfg, DEVICE),
                                   seed=seed)
    levels, seg_size = pyramid_batches(cfg, N_ZOO_IMAGES)
    data_start(model, levels, seg_size,
               cfg.MODEL.arch_decoder.endswith("embedding"), torch.bfloat16)
    name = f"{cfg.MODEL.arch_encoder}_{cfg.MODEL.arch_decoder}"
    cfg.MODEL.weights_encoder, cfg.MODEL.weights_decoder = save_pair(
        model, os.path.join(root, "zoo", name), "")
    return cfg, model, levels, seg_size


def zoo_device_check(cfg, fused):
    """The pair's forward on a 96x128 crop of the first eval image in fp32
    with TF32 off, on cuda (unfused, and fused where asked) against the
    CPU: scores within DEVICE_CHECK_RTOL of the largest."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.data.odgt import (
        ValPipeline)

    h, w = ZOO_CHECK_SIZE
    item = ValPipeline(cfg.DATASET.root_dataset, cfg.DATASET.list_val,
                       img_sizes=cfg.DATASET.imgSizes[:1])[0]
    x = torch.from_numpy(np.ascontiguousarray(
        item["img_data"][0][:, :h, :w]))

    def scores(device, fused_blocks):
        model = init_or_load_variables(cfg, build_anomaly_model(
            cfg, device, fused_blocks=fused_blocks))
        with torch.no_grad():
            return model(x.to(device), seg_size=(h, w))["scores"].cpu()

    saved = _tf32_off()
    try:
        want = scores("cpu", False)
        errs = {"unfused": float((scores(DEVICE, False) - want).abs().max())}
        if fused:
            errs["fused"] = float((scores(DEVICE, True) - want).abs().max())
    finally:
        _tf32_set(saved)
    bound = DEVICE_CHECK_RTOL * float(want.abs().max())
    if not (torch.isfinite(want).all() and all(e <= bound
                                               for e in errs.values())):
        raise AssertionError(f"zoo device check {cfg.MODEL.arch_encoder}: "
                             f"{errs}, bound {bound}")
    return {"max_abs_diff": errs, "bound": bound}


def fused_kernel_check(model, levels, seg_size, name):
    """fused_bottleneck against its plain version on the inputs each
    routed block gets in one bf16 forward of ``levels`` (the path's
    inputs); these launches are outside any count."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.ops.fused_block import (
        fused_bottleneck, fused_bottleneck_plain)

    blocks = {n: m for n, m in model.encoder.named_modules()
              if getattr(m, "fused_tile", None) is not None}
    inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda _, args, n=n: inputs.append((n, args[0])))
        for n, m in blocks.items()]
    try:
        with torch.inference_mode(), torch.autocast(DEVICE,
                                                    dtype=torch.bfloat16):
            for x in levels:
                model(x[:1], seg_size=seg_size)
    finally:
        for hook in hooks:
            hook.remove()
    tol = BLOCK_TOL["bfloat16"]
    max_err = 0.0
    with torch.inference_mode():
        for n, xin in inputs:
            block = blocks[n]
            ws = block._folded[(torch.bfloat16, xin.device)]
            xh = xin.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
            d = block.conv2.dilation[0]
            got = fused_bottleneck(xh, *ws, dilation=d).float()
            torch.cuda.synchronize()
            want = fused_bottleneck_plain(xh, *ws, dilation=d).float()
            err = (got - want).abs()
            bad = int((err > tol + tol * want.abs()).sum())
            if bad or not torch.isfinite(got).all():
                raise AssertionError(f"fused_bottleneck disagrees in the "
                                     f"{name} forward at {n}: {bad}")
            max_err = max(max_err, err.max().item())
    log(f"zoo {name}: fused_bottleneck vs plain on the path's inputs, max "
        f"|err| {max_err:.3g} over {len(inputs)} block calls")
    return {"block_calls": len(inputs), "max_abs_err": max_err}


def zoo_phase(root, cfg):
    """Every other CSAIL encoder and decoder at full width on the slice
    phase's 720x1280 tree (see the module note), then the MobileNet DeepLab
    factories at 1024x2048. Returns the summary and the fused runs'
    block calls per encoder."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import eval_ood
    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.openset.evaluator import (
        multi_scale_forward)

    summary, launches = {}, {}
    n_levels = len(cfg.DATASET.imgSizes)
    for i, (encoder, decoder, ways, method) in enumerate(ZOO_RUNS):
        name = f"{encoder}+{decoder}"
        c = cfg.clone()
        c.MODEL.arch_encoder, c.MODEL.arch_decoder = encoder, decoder
        c.OOD.ood = method
        c, model, levels, seg_size = write_zoo_checkpoint(c, root, SEED + i)
        del model
        out = {"clipped_share": None}
        if c.MODEL.arch_decoder.endswith("embedding"):
            started = init_or_load_variables(c, build_anomaly_model(c,
                                                                    DEVICE))
            out["clipped_share"] = dissum_clipped_share(
                started, levels, seg_size, torch.bfloat16)
            del started
        for fused in ways:
            route = "fused" if fused else "unfused"
            routed = ZOO_ROUTED[encoder] if fused else 0
            model = init_or_load_variables(c, build_anomaly_model(
                c, DEVICE, fused_blocks=fused, use_softmax=True))
            n_routed = sum(getattr(m, "fused_tile", None) is not None
                           for m in model.encoder.modules())
            if n_routed != routed:
                raise AssertionError(f"{name} {route}: {n_routed} blocks "
                                     f"on the fused route, want {routed}")
            x = [lvl[:1] for lvl in levels]

            def forward(model=model, x=x):
                with torch.inference_mode(), torch.autocast(
                        DEVICE, dtype=torch.bfloat16):
                    multi_scale_forward(model, x, seg_size, want_ft=False)

            forward_ms = cuda_time_ms(forward, iters=3, warmup=1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            want = {"fused_bottleneck": routed * n_levels} if fused else {}
            result, counts = counted(f"zoo {name} {route}",
                                     lambda fused=fused: eval_ood.main(
                                         c, torch.bfloat16,
                                         max_images=N_ZOO_IMAGES,
                                         batch_images=N_ZOO_IMAGES,
                                         device=DEVICE, fused_blocks=fused),
                                     want)
            run = {k: result[k] for k in ("mean_iou", "accuracy", "auroc",
                                          "aupr", "fpr")}
            run.update(images=result["images"],
                       forward_ms_per_img=forward_ms,
                       device_s_per_img=result["inference_time"],
                       peak_memory_bytes=torch.cuda.max_memory_allocated(),
                       launches=counts)
            if result["images"] != N_ZOO_IMAGES:
                raise AssertionError(f"zoo {name}: {result['images']} "
                                     "images")
            _finite(f"zoo {name} {route}", {k: v for k, v in run.items()
                                            if k != "launches"})
            if fused:
                launches[encoder] = counts["fused_bottleneck"]
                if encoder == "resnet101dilated":
                    run["kernel_check"] = fused_kernel_check(
                        model, x, seg_size, name)
            out[route] = run
            del model
        out["device_check"] = zoo_device_check(c, fused=True in ways)
        log(f"zoo {name}: " + json.dumps(out))
        summary[name] = out
    summary["deeplab_mobilenet"] = zoo_deeplab_mobilenet()
    return summary, launches


def zoo_deeplab_mobilenet():
    """The three MobileNet DeepLab factories (OS16, torchvision-style
    MobileNetV2, seeded random weights): one 1024x2048 forward each on the
    card in bf16 (finite, ms by CUDA events, peak memory), and the fp32
    (TF32 off) card forward of a 96x128 image against the CPU's."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        MODEL_MAP)
    from open_world_semantic_segmentation_tpu_torch.models.deeplab import (
        init_deeplab_weights)

    out = {}
    rng = np.random.default_rng(SEED)
    big = torch.from_numpy(rng.standard_normal(
        (1, *CITYSCAPES_SIZE, 3)).astype(np.float32)).to(DEVICE)
    small = torch.from_numpy(rng.standard_normal(
        (1, *ZOO_CHECK_SIZE, 3)).astype(np.float32))
    for i, name in enumerate(ZOO_DEEPLAB):
        num_classes = 16 if "embedding" in name else 19
        model = init_deeplab_weights(MODEL_MAP[name](num_classes),
                                     torch.Generator().manual_seed(SEED + i))
        model = model.eval()
        cuda_model = model.to(DEVICE).to(memory_format=torch.channels_last)

        def first(y):
            return y[0] if isinstance(y, tuple) else y

        def forward():
            with torch.inference_mode(), torch.autocast(
                    DEVICE, dtype=torch.bfloat16):
                return first(cuda_model(big))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        y = forward()
        row = {"finite": bool(torch.isfinite(y).all()),
               "shape": list(y.shape),
               "forward_ms": cuda_time_ms(forward, iters=5, warmup=1),
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        saved = _tf32_off()
        try:
            with torch.no_grad():
                got = first(cuda_model(small.to(DEVICE))).cpu()
                want = first(model.cpu()(small))
        finally:
            _tf32_set(saved)
        row["max_abs_diff"] = float((got - want).abs().max())
        row["bound"] = DEVICE_CHECK_RTOL * float(want.abs().max())
        log(f"zoo {name}: " + json.dumps(row))
        if not (row["finite"] and row["max_abs_diff"] <= row["bound"]):
            raise AssertionError(f"zoo {name}: {row}")
        out[name] = row
    return out


# ---------------------------------------------------------------------------
def write_cityscapes_tree(root, counts, size, seed):
    """Cityscapes-format tree (``leftImg8bit/<split>/synth/*_leftImg8bit.png``
    and ``gtFine/<split>/synth/*_gtFine_labelIds.png``) with ``counts[split]``
    images per split: raw-id labels, blocks of the 19 train classes over
    road, then the featured blocks on top: in every split but ``val`` car
    over h/3 x w/3 in all but every fourth image, in ``val`` a car, a truck
    and a bus block in every image. Images: one colour per raw id plus noise."""
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
                if split != "val":
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
        torch.cuda.reset_peak_memory_stats()
        result, launches[run] = counted(
            run, lambda fused=fused: eval_embedding.main(
                cfg, torch.bfloat16, device=DEVICE, fused_blocks=fused),
            {"fused_bottleneck": want})
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
        summaries[run] = summary
    log(f"npm fused run: fused_bottleneck launches "
        f"{launches['npm_fused']['fused_bottleneck']} "
        f"({DEEPLAB_ROUTED_BLOCKS} per image, {N_VAL_IMAGES} images)")
    summaries["forward_comparison"] = deeplab_forward_comparison(cfg)
    summaries["dilated_conv_ways"] = dilated_conv_ways(cfg)

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


def write_laf_tree(root, n, size, seed):
    """A Lost&Found-format tree of ``n`` images and its odgt list: labels
    raw 0 (void, the top rows), 1 (road) and 2 (lost cargo: two blocks per
    image); images one colour per raw id, the cargo in its own, plus
    noise."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    palette = np.array([[0, 0, 0], [128, 64, 128], [230, 180, 40]])
    records = []
    with ThreadPoolExecutor(8) as pool:
        saves = []
        for i in range(n):
            lab = np.ones((h, w), np.uint8)
            lab[:h // 8] = 0
            for _ in range(2):
                bh, bw = h // 10, w // 12
                r0 = rng.integers(h // 2, h - bh)
                c0 = rng.integers(0, w - bw)
                lab[r0:r0 + bh, c0:c0 + bw] = 2
            img = palette[lab] + rng.normal(0, 20, (h, w, 3))
            img = np.clip(img, 0, 255).astype(np.uint8)
            ip, lp = f"leftImg8bit/laf/{i}.png", f"gtCoarse/laf/{i}.png"
            for p, arr, mode in ((ip, img, "RGB"), (lp, lab, "L")):
                path = os.path.join(root, p)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                saves.append(pool.submit(Image.fromarray(arr, mode).save,
                                         path, compress_level=1))
            records.append({"fpath_img": ip, "fpath_segm": lp, "height": h,
                            "width": w})
        for save in saves:
            save.result()
    odgt = os.path.join(root, "laf.odgt")
    with open(odgt, "w") as f:
        f.write(json.dumps(records) + "\n")
    return odgt


def cityscapes_rest_phase(root):
    """The rest of the Cityscapes eval surface at 1024x2048, on the deeplab
    phase's tree and checkpoints: ``cli.eval_embedding`` with
    FEWSHOT.calibrate_scores, ``cli.test_deeplab`` with
    DEEPLAB.save_val_results, ``cli.eval_fishyscapes`` (native) for each
    method on a synthetic Lost&Found tree; see the module note."""
    import torch
    from PIL import Image

    from open_world_semantic_segmentation_tpu_torch.cli import (
        eval_embedding, eval_fishyscapes, test_deeplab)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.openset.calibration \
        import ScoreCalibration

    tree = os.path.join(root, "cityscapes")
    embedding = os.path.join(root, "deeplab_embedding.pth")
    out = {}
    state = os.path.join(root, "calibration.npz")
    cfg = load_config("configs/cityscapes_embedding.yaml", [
        "DATASET.root_dataset", tree, "FEWSHOT.prototype_file",
        os.path.join(root, "prototype_car_5_shot.json"),
        "MODEL.weights_encoder", embedding,
        "FEWSHOT.calibrate_scores", "True",
        "FEWSHOT.calib_images", str(N_CALIB_IMAGES),
        "FEWSHOT.calib_save", state])
    torch.cuda.reset_peak_memory_stats()
    tic = time.perf_counter()
    result, _ = counted("calibrated eval_embedding", lambda:
                        eval_embedding.main(cfg, torch.bfloat16,
                                            max_images=N_CALIB_IMAGES,
                                            device=DEVICE))
    run = {k: result.get(k) for k in ("calib_auroc", "calib_aupr",
                                      "calib_fpr95", "Mean IoU")}
    calib = ScoreCalibration.load(state)
    run.update(images=result["images"],
               seconds_with_fit=time.perf_counter() - tic,
               loop_seconds=result["seconds"],
               device_s_per_img=result["device_s_per_img"],
               host_s_per_img=result["metric_s_per_img"],
               wait_s_per_img=result["wait_s_per_img"],
               fitted_classes=sum(s.size > 0 for s in calib.sorted_samples),
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    log("eval_embedding, calibrated scores: " + json.dumps(run))
    if result["images"] != N_CALIB_IMAGES or not run["fitted_classes"]:
        raise AssertionError(f"calibrated eval_embedding: {run}")
    _finite("calibrated eval_embedding", run)
    out["calibrated_eval_embedding"] = run

    results_dir = os.path.join(root, "deeplab_results")
    ccfg = load_config("configs/cityscapes_closed.yaml", [
        "DATASET.root_dataset", tree, "DEEPLAB.unknown_scores", "True",
        "DEEPLAB.save_val_results", "True", "DIR", results_dir])
    ccfg.DEEPLAB.ckpt = os.path.join(root, "deeplab_closed.pth")
    (score, ood), _ = counted("test_deeplab save_val_results", lambda:
                              test_deeplab.main(ccfg, torch.bfloat16,
                                                max_images=2,
                                                device=DEVICE))
    pngs = sorted(os.listdir(os.path.join(results_dir, "results")))
    shapes = {p: np.asarray(Image.open(os.path.join(
        results_dir, "results", p))).shape for p in pngs}
    run = {"images": score["images"], "seconds": score["seconds"],
           "pngs": pngs, "shapes": sorted(set(shapes.values()))}
    log("test_deeplab, save_val_results: " + json.dumps(run))
    h, w = CITYSCAPES_SIZE
    want = sorted(f"{i}_{k}.png" for i in range(2) for k in (
        "image", "target", "pred", "scores", "overlay"))
    if pngs != want or any(s[:2] != (h, w) for s in shapes.values()):
        raise AssertionError(f"test_deeplab wrote {run}")
    out["save_val_results"] = run

    laf = os.path.join(root, "laf")
    odgt = write_laf_tree(laf, N_LAF_IMAGES, CITYSCAPES_SIZE, SEED + 6)
    fcfg = load_config("configs/cityscapes_embedding.yaml", [
        "DATASET.root_dataset", laf, "DATASET.list_val", odgt])
    fcfg.DEEPLAB.ckpt = embedding
    out["fishyscapes"] = {}
    for method in ("entropy", "msp", "dissum"):
        tic = time.perf_counter()
        res, _ = counted(f"eval_fishyscapes {method}", lambda m=method:
                         eval_fishyscapes.main(fcfg, torch.bfloat16,
                                               method=m, device=DEVICE))
        res["seconds"] = time.perf_counter() - tic
        log(f"eval_fishyscapes {method}: " + json.dumps(res))
        if res["n_images"] != N_LAF_IMAGES:
            raise AssertionError(f"fishyscapes {method}: {res}")
        _finite(f"fishyscapes {method}", res)
        out["fishyscapes"][method] = res
    return out


def deeplab_forward_comparison(cfg, ways=None, rounds=6, iters=5):
    """The 1024x2048 forward of one image (bf16, CUDA events, no data
    movement, NPM or metrics) two ways, each a dict of keywords of
    ``build_deeplab_model`` (by default unfused and ``fused_blocks=True``),
    timed alternately ``rounds`` times each; every round and the medians,
    and the first way's median less the second's."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        build_deeplab_model, get_transforms, get_val_dataset,
        init_or_load_deeplab)

    ways = ways or {"unfused": {}, "fused": {"fused_blocks": True}}
    models = {}
    for name, kw in ways.items():
        model, _ = build_deeplab_model(cfg, DEVICE, **kw)
        models[name] = init_or_load_deeplab(model,
                                            cfg.MODEL.weights_encoder)
    ds = get_val_dataset(cfg, get_transforms(cfg.DEEPLAB.crop_size)[1])
    x = torch.from_numpy(ds[0][0][None]).to(DEVICE)

    def forward(model):
        def run():
            with torch.inference_mode(), torch.autocast(
                    DEVICE, dtype=torch.bfloat16):
                model(x)
        return run

    first, second = ways
    times = {name: [] for name in ways}
    for name in [first, second, second, first] * (rounds // 2):
        times[name].append(cuda_time_ms(forward(models[name]), iters=iters))
    result = {name: {"forward_ms": t, "forward_ms_median": float(
        np.median(t))} for name, t in times.items()}
    result["forward_ms_gain_median"] = (
        result[first]["forward_ms_median"]
        - result[second]["forward_ms_median"])
    log(f"deeplab forward comparison {first} vs {second}, "
        f"{list(CITYSCAPES_SIZE)}, batch 1: " + json.dumps(result))
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

    tf32 = _tf32_off()
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
    _tf32_set(tf32)


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

    from open_world_semantic_segmentation_tpu_torch.core.device import (
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


def _trainer_summary(result, batch, warmup):
    """Timing of a trainer's run logged every step (``log_every=1``, one
    sync per step): s/step (median after ``warmup`` steps), imgs/s, loader
    wait per step, each step's time and loss."""
    steps = result["log"]
    times = [e["seconds"] - (steps[i - 1]["seconds"] if i else 0.0)
             for i, e in enumerate(steps)]
    waits = [e["wait"] - (steps[i - 1]["wait"] if i else 0.0)
             for i, e in enumerate(steps)]
    s_per_step = float(np.median(times[warmup:]))
    return {"steps": len(steps), "batch": batch,
            "s_per_step_median": s_per_step,
            "imgs_per_s": batch / s_per_step,
            "loader_wait_s_per_step": float(np.mean(waits[warmup:])),
            "per_step_s": times, "losses": [e["loss"] for e in steps]}


def deeplab_train_phase(root):
    """DeepLab training and the incremental few-shot fine-tuning at full
    width and depth, bf16 autocast over float32 parameters; see the module
    note. Returns the summaries and the fused_bottleneck launches of the
    fused PLM eval and of the fused-teacher distillation run."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import (
        main_deeplab, main_distillation, self_distillation)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)

    tree = os.path.join(root, "cityscapes_train")
    tic = time.perf_counter()
    write_cityscapes_tree(tree, DEEPLAB_TRAIN_COUNTS, CITYSCAPES_SIZE,
                          SEED + 3)
    log(f"cityscapes training tree: {DEEPLAB_TRAIN_COUNTS} images of "
        f"{CITYSCAPES_SIZE} in {time.perf_counter() - tic:.1f} s")
    summaries = {}

    def run(name, fn, want_fused=0):
        """``fn()`` with the launch counts zeroed just before and read just
        after, and the peak memory; returns its result and its summary."""
        torch.cuda.reset_peak_memory_stats()
        tic = time.perf_counter()
        result, launches = counted(name, fn,
                                   {"fused_bottleneck": want_fused})
        summary = {"seconds": time.perf_counter() - tic,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                   "launches": launches}
        summaries[name] = summary
        return result, summary

    def trained(name, result, summary, batch, steps):
        summary.update(_trainer_summary(result, batch, TRAIN_WARMUP))
        log(f"{name}: " + json.dumps(summary))
        if result["steps"] != steps or summary["steps"] != steps:
            raise AssertionError(f"{name}: {result['steps']} steps")
        if not all(np.isfinite(summary["losses"])):
            raise AssertionError(f"{name}: a loss is not finite")

    # 1. cli/main_deeplab: the base 16-class embedding model
    base_dir = os.path.join(root, "deeplab_train")
    # from the deeplab phase's seeded checkpoint (BN statistics from the
    # data) at DEEPLAB_SMOKE_LR: see its note
    cfg = load_config("configs/cityscapes_embedding.yaml", [
        "DATASET.root_dataset", tree,
        "DEEPLAB.ckpt", os.path.join(root, "deeplab_embedding.pth"),
        "DEEPLAB.lr", str(DEEPLAB_SMOKE_LR),
        "DEEPLAB.val_interval", str(DEEPLAB_TRAIN_STEPS), "DIR", base_dir])
    result, summary = run("main_deeplab", lambda: main_deeplab.main(
        cfg, torch.bfloat16, max_steps=DEEPLAB_TRAIN_STEPS, device=DEVICE,
        log_every=1))
    summary.update(skipped=result["skipped"],
                   validations=result["validations"])
    trained("main_deeplab", result, summary, cfg.DEEPLAB.batch_size,
            DEEPLAB_TRAIN_STEPS)
    base = os.path.join(base_dir, "best.pth")
    # how far bf16 carries the start and the trained weights from fp32 on
    # the first val image of the NPM tree (reported, not checked)
    ncfg = load_config("configs/cityscapes_embedding.yaml", [
        "DATASET.root_dataset", os.path.join(root, "cityscapes")])
    val = main_deeplab.get_val_dataset(
        ncfg, main_deeplab.get_transforms(ncfg.DEEPLAB.crop_size)[1])
    x = torch.from_numpy(val[0][0][None]).to(DEVICE)
    summaries["bf16_drift"] = {
        name: bf16_drift(name, ncfg, path, x) for name, path in (
            ("data-started checkpoint", cfg.DEEPLAB.ckpt),
            ("main_deeplab best.pth", base))}
    if result["skipped"] or len(result["validations"]) != 1 or not all(
            os.path.exists(os.path.join(base_dir, f))
            for f in ("latest.pth", "best.pth")):
        raise AssertionError(f"main_deeplab: {result['skipped']} skipped, "
                             f"validations {result['validations']}, "
                             f"{os.listdir(base_dir)}")

    # 2. cli/self_distillation --mode train from that checkpoint
    sd_dir = os.path.join(root, "self_distillation")
    scfg = load_config("configs/self_distillation.yaml", [
        "DATASET.root_dataset", tree, "MODEL.weights_encoder", base,
        "DIR", sd_dir])
    result, summary = run("self_distillation_train",
                          lambda: self_distillation.main(
                              scfg, torch.bfloat16, mode="train",
                              max_steps=FEWSHOT_TRAIN_STEPS, device=DEVICE,
                              log_every=1))
    trained("self_distillation_train", result, summary,
            scfg.DEEPLAB.batch_size, FEWSHOT_TRAIN_STEPS)
    summary["frozen"] = self_distillation_frozen_check(scfg, base,
                                                       result["path"])

    # 3. --mode eval (plm_all) on the NPM tree's val images, both routes
    ecfg = load_config("configs/self_distillation.yaml", [
        "DATASET.root_dataset", os.path.join(root, "cityscapes"),
        "MODEL.weights_encoder", result["path"]])
    plm_launches = DEEPLAB_ROUTED_BLOCKS * PLM_EVAL_IMAGES
    for fused in (False, True):
        name = "plm_eval_fused" if fused else "plm_eval"
        score, summary = run(name, lambda: self_distillation.main(
            ecfg, torch.bfloat16, mode="eval", max_images=PLM_EVAL_IMAGES,
            device=DEVICE, fused_blocks=fused),
            want_fused=plm_launches if fused else 0)
        summary.update({k: float(score[k]) for k in (
            "Overall Acc", "Mean Acc", "FreqW Acc", "Mean IoU")},
            images=score["images"],
            imgs_per_s=score["images"] / score["seconds"])
        log(f"{name}: " + json.dumps(summary))
        if score["images"] != PLM_EVAL_IMAGES or not all(
                np.isfinite(v) for v in summary.values()
                if isinstance(v, float)):
            raise AssertionError(f"{name}: {summary}")
    summaries["plm_fused_route"] = plm_fused_check(ecfg)

    # 4. cli/main_distillation, the teacher unfused and then fused
    dcfg = load_config("configs/self_distillation.yaml", [
        "DATASET.root_dataset", tree, "MODEL.weights_encoder", base,
        "DIR", os.path.join(root, "distillation")])
    summaries["teacher_fused_route"] = distillation_check(dcfg)
    first = {}
    for fused in (False, True):
        name = "main_distillation_fused" if fused else "main_distillation"
        result, summary = run(name, lambda: main_distillation.main(
            dcfg, torch.bfloat16, max_steps=FEWSHOT_TRAIN_STEPS,
            device=DEVICE, fused_blocks=fused, log_every=1),
            want_fused=(DEEPLAB_ROUTED_BLOCKS * FEWSHOT_TRAIN_STEPS
                        if fused else 0))
        trained(name, result, summary, dcfg.DEEPLAB.batch_size,
                FEWSHOT_TRAIN_STEPS)
        first[fused] = summary["losses"][0]
    diff = abs(first[True] - first[False])
    log(f"distillation first loss: unfused teacher {first[False]}, fused "
        f"{first[True]}, |diff| {diff:.4g} (bound "
        f"{FUSED_LOSS_RTOL * abs(first[False]):.4g})")
    if not diff <= FUSED_LOSS_RTOL * abs(first[False]):
        raise AssertionError(f"distillation first losses {first}")

    # 5. the two-head model in fp32 on cuda against the CPU
    summaries["device_check"] = self_distillation_device_check(ecfg)
    return summaries, (summaries["plm_eval_fused"]["launches"]
                       ["fused_bottleneck"],
                       summaries["main_distillation_fused"]["launches"]
                       ["fused_bottleneck"])


def self_distillation_frozen_check(cfg, base_path, trained_path):
    """After the self-distillation steps: every entry of the base
    checkpoint (backbone, ``classifier``, their BN statistics) bit-identical
    in the trained model, ``classifier_1``'s BN statistics still at their
    init and its parameters moved from it."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import (
        self_distillation)

    base = torch.load(base_path, map_location="cpu")["model_state"]
    got = torch.load(trained_path, map_location="cpu")["model_state"]
    init_cfg = cfg.clone()
    init_cfg.MODEL.weights_encoder = ""
    model, _ = self_distillation.build_self_distillation_model(init_cfg,
                                                               "cpu")
    init = model.state_dict()
    params = {k for k, _ in model.named_parameters()}
    same = sum(torch.equal(got[k], v) for k, v in base.items())
    novel = [k for k in got if k.startswith("classifier_1.")]
    moved = [k for k in novel if k in params
             and not torch.equal(got[k], init[k])]
    stats_kept = all(torch.equal(got[k], init[k]) for k in novel
                     if k not in params)
    result = {"base_entries": len(base), "bit_identical": same,
              "classifier_1_params": len([k for k in novel if k in params]),
              "classifier_1_moved": len(moved),
              "classifier_1_bn_statistics_kept": stats_kept}
    log("self-distillation frozen check: " + json.dumps(result))
    if same != len(base) or not moved or not stats_kept:
        raise AssertionError(f"self-distillation frozen check: {result}")
    return result


def distance(got, want, argmax=True):
    """Largest |difference| over the largest |want|, root-mean-square
    difference over the root-mean-square of ``want``, and, with
    ``argmax``, the argmax agreement over the last axis."""
    got, want = got.double(), want.double()
    diff = got - want
    row = {"max_rel": float(diff.abs().max() / want.abs().max()),
           "rms_rel": float(diff.square().mean().sqrt()
                            / want.square().mean().sqrt())}
    if argmax:
        row["argmax"] = float((got.argmax(-1) == want.argmax(-1))
                              .double().mean())
    return row


def _route_ways(name, build, run, x):
    """The fused route of ``build(fused)`` against the unfused one on the
    input ``x``, where ``run(model, x)`` gives a list of logits (NHWK):

    - fp32, TF32 off: the fused logits within DEVICE_CHECK_RTOL of the
      unfused ones' largest magnitude, the argmax agreeing on 99 % of the
      pixels (fails the run);
    - bf16 autocast: each routed bottleneck of the fused model on the input
      its unfused twin receives in the unfused bf16 forward, against that
      block's output, within BLOCK_TOL["bfloat16"] of its largest
      magnitude (fails the run);
    - reported only: the whole bf16 forwards, unfused against fp32 and
      fused against unfused (``bf16_drift`` says why they part).

    Returns (fp32 unfused logits, fp32 fused logits, the summary)."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.models.resnet import (
        Bottleneck)

    models = {fused: build(fused) for fused in (False, True)}
    saved = _tf32_off()
    with torch.no_grad():
        fp32 = {fused: [t.float() for t in run(m, x)]
                for fused, m in models.items()}
    _tf32_set(saved)
    summary = {"fp32_fused_vs_unfused": [], "bf16_unfused_vs_fp32": [],
               "bf16_fused_vs_unfused": []}
    for i, (u, f) in enumerate(zip(fp32[False], fp32[True])):
        row = distance(f, u)
        row["bound"] = DEVICE_CHECK_RTOL
        summary["fp32_fused_vs_unfused"].append(row)
        if not (row["max_rel"] <= DEVICE_CHECK_RTOL
                and row["argmax"] >= 0.99):
            raise AssertionError(f"{name} fp32 fused route, output {i}: "
                                 f"{row}")

    # bf16: the unfused forward with every routed block's input and output
    blocks = {b: m for b, m in models[True].named_modules()
              if isinstance(m, Bottleneck) and m.fused_tile is not None}
    seen = []
    unfused_modules = dict(models[False].named_modules())
    hooks = [unfused_modules[b].register_forward_hook(
        lambda _, args, out, b=b: seen.append((b, args[0], out)))
        for b in blocks]
    bf16 = {}
    with torch.no_grad(), torch.autocast(DEVICE, dtype=torch.bfloat16):
        bf16[False] = run(models[False], x)
        for hook in hooks:
            hook.remove()
        bf16[True] = run(models[True], x)
        worst = 0.0
        for b, inp, want in seen:
            got = blocks[b](inp).float()
            rel = float((got - want.float()).abs().max()
                        / want.float().abs().max())
            worst = max(worst, rel)
            if not rel <= BLOCK_TOL["bfloat16"]:
                raise AssertionError(f"{name} bf16 block {b}: {rel}")
    if len(seen) != DEEPLAB_ROUTED_BLOCKS:
        raise AssertionError(f"{name}: {len(seen)} routed blocks seen")
    summary["bf16_blocks"] = {"blocks": len(seen), "worst_max_rel": worst,
                              "bound": BLOCK_TOL["bfloat16"]}
    for i, ref in enumerate(fp32[False]):
        summary["bf16_unfused_vs_fp32"].append(distance(bf16[False][i], ref))
        summary["bf16_fused_vs_unfused"].append(
            distance(bf16[True][i], bf16[False][i]))
    log(f"{name}: " + json.dumps(summary))
    del models, seen
    return fp32[False], fp32[True], summary


def plm_fused_check(cfg):
    """The two-head model's forward of the first val image (1024x2048),
    with ``fused_blocks=True`` against unfused (``_route_ways``): each
    head's logits, and in fp32 the merged ``plm_all`` prediction agreeing
    on 99 % of the pixels."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import (
        self_distillation)
    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        get_transforms, get_val_dataset)
    from open_world_semantic_segmentation_tpu_torch.fewshot.\
        self_distillation import merge_head_predictions

    ds = get_val_dataset(cfg, get_transforms(cfg.DEEPLAB.crop_size)[1])
    x = torch.from_numpy(ds[0][0][None]).to(DEVICE)
    unfused, fused, result = _route_ways(
        "plm fused route, first val image",
        lambda f: self_distillation.build_self_distillation_model(
            cfg, DEVICE, fused_blocks=f)[0],
        lambda model, x: model(x)[0], x)
    merged = [merge_head_predictions(t, variant=cfg.FEWSHOT.variant,
                                     base_classes=unfused[0].shape[-1])
              for t in (unfused, fused)]
    agree = float((merged[0] == merged[1]).float().mean())
    log(f"plm fp32 merged prediction, fused vs unfused: agreement {agree}")
    if agree < 0.99:
        raise AssertionError(f"plm merged prediction agreement {agree}")
    result["fp32_merged_agreement"] = agree
    return result


def distillation_check(cfg):
    """The student's backbone equals the teacher's before step 1; the
    teacher's logits on the first training batch (5 crops of 768x768),
    fused against unfused (``_route_ways``)."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import (
        main_distillation)
    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        train_batches)
    from open_world_semantic_segmentation_tpu_torch.cli.self_distillation \
        import training_split

    batches = train_batches(training_split(cfg), cfg.DEEPLAB.batch_size,
                            cfg.DEEPLAB.random_seed, DEVICE)
    batch = next(batches)
    batches.close()

    def build(fused):
        teacher, student = main_distillation.build_models(
            cfg, torch.device(DEVICE), fused_blocks=fused)
        if not fused:
            t_state = teacher.backbone.state_dict()
            differ = [k for k, v in student.backbone.state_dict().items()
                      if not torch.equal(v, t_state[k])]
            log(f"distillation: student backbone equals the teacher's in "
                f"{len(t_state) - len(differ)} of {len(t_state)} entries")
            if differ:
                raise AssertionError(f"student backbone differs: {differ}")
        return teacher

    return _route_ways("distillation teacher fused route, first batch",
                       build, lambda model, x: [model(x)[0]],
                       batch["image"])[2]


def bf16_drift(name, cfg, weights, x):
    """Reported only: how far the single-head embedding model with
    ``weights`` moves on ``x`` when its forward runs in bf16, and when one
    bf16 rounding (2^-9 n relative, n standard normal) perturbs its fp32
    input; logits and features against the fp32 forward (TF32 off)."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        build_deeplab_model, init_or_load_deeplab)

    model, _ = build_deeplab_model(cfg, DEVICE)
    init_or_load_deeplab(model, weights)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    noise = torch.randn(x.shape, generator=gen, device=DEVICE)
    saved = _tf32_off()
    with torch.no_grad():
        ref = model(x)
        perturbed = model(x * (1 + 2.0 ** -9 * noise))
        with torch.autocast(DEVICE, dtype=torch.bfloat16):
            low = model(x)
    _tf32_set(saved)
    result = {"bf16_vs_fp32": {"logits": distance(low[0], ref[0]),
                               "features": distance(low[2], ref[2])},
              "fp32_input_rounded_vs_fp32": {
                  "logits": distance(perturbed[0], ref[0]),
                  "features": distance(perturbed[2], ref[2])},
              "max_abs_logit": float(ref[0].abs().max())}
    log(f"bf16 drift, {name}: " + json.dumps(result))
    return result


def self_distillation_device_check(cfg):
    """The two-head model over a 64x128 crop of the first val image in
    fp32, TF32 off, on cuda (unfused and fused) against the CPU: every
    head's logits and features within DEVICE_CHECK_RTOL of their largest
    magnitude, each head's argmax agreeing on 99 % of the pixels."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import (
        self_distillation)
    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        get_transforms, get_val_dataset)

    tf32 = _tf32_off()
    ds = get_val_dataset(cfg, get_transforms(cfg.DEEPLAB.crop_size)[1])
    x = np.ascontiguousarray(ds[0][0][None, :64, :128])

    def forward(device, fused):
        model, _ = self_distillation.build_self_distillation_model(
            cfg, device, fused_blocks=fused)
        with torch.no_grad():
            logits, _, features = model(torch.from_numpy(x).to(device))
        return {"logits": [t.cpu().numpy() for t in logits],
                "features": [t.cpu().numpy() for t in features]}

    cpu = forward("cpu", False)
    worst = {}
    for fused in (False, True):
        got = forward(DEVICE, fused)
        name = "fused" if fused else "unfused"
        for key in ("logits", "features"):
            for i, (g, w) in enumerate(zip(got[key], cpu[key])):
                err = float(np.abs(g - w).max())
                bound = DEVICE_CHECK_RTOL * float(np.abs(w).max())
                log(f"self-distillation device check fp32 {name} head {i} "
                    f"{key}: max |diff| {err:.4g} (bound {bound:.4g})")
                if not err <= bound:
                    raise AssertionError(f"two-head {name} {key} {i}: {err}")
                worst[f"{name}_{key}_{i}"] = err / bound
        for i, (g, w) in enumerate(zip(got["logits"], cpu["logits"])):
            same = float((g.argmax(-1) == w.argmax(-1)).mean())
            log(f"self-distillation device check fp32 {name} head {i} "
                f"argmax agreement {same:.5f}")
            if same < 0.99:
                raise AssertionError(f"two-head {name} argmax {same}")
    _tf32_set(tf32)
    return worst


def dilated_conv_ways(cfg):
    """The ASPP's dilated 3x3 conv (2048 -> 256) at rates 6, 12 and 18,
    bf16 channels_last: the shift form (``ops/dilated.py``) against
    cuDNN's conv, forward at the eval's map and forward plus backward at
    the training's, checked (DILATED_TOL) and timed with CUDA events; the
    bound is the larger of the products' operations at the bf16 peak and
    the input, weights and output read or written once. Then the
    1024x2048 NPM forward with ``dilated_impl="shift"`` and ``"native"``,
    alternately."""
    import torch
    import torch.nn.functional as F

    from open_world_semantic_segmentation_tpu_torch.ops.dilated import (
        dilated_conv3x3_shift)

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cl = torch.channels_last
    rows = []

    def close(name, got, want):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        if not err <= DILATED_TOL * scale:
            raise AssertionError(f"dilated {name}: |diff| {err} of {scale}")
        return err / scale

    for rate in DILATED_RATES:
        row = {"rate": rate}
        for phase, shape in (("eval", DILATED_EVAL_SHAPE),
                             ("train", DILATED_TRAIN_SHAPE)):
            n, cin, h, w = shape
            x = torch.randn(shape, generator=gen, device=DEVICE).to(
                torch.bfloat16).contiguous(memory_format=cl)
            wt = (torch.randn((256, cin, 3, 3), generator=gen,
                              device=DEVICE) / (9 * cin) ** 0.5).to(
                torch.bfloat16)
            ways = {"shift": lambda a, b: dilated_conv3x3_shift(a, b, rate),
                    "native": lambda a, b: F.conv2d(a, b, padding=rate,
                                                    dilation=rate)}
            flops = 2 * n * h * w * cin * 256 * 9
            nbytes = 2 * (x.numel() + wt.numel() + n * h * w * 256)
            if phase == "eval":
                with torch.no_grad():
                    out = {k: f(x, wt) for k, f in ways.items()}
                    row["eval_rel_err"] = close(f"rate {rate} forward",
                                                out["shift"], out["native"])
                    for k, f in ways.items():
                        row[f"eval_{k}_ms"] = cuda_time_ms(
                            lambda f=f: f(x, wt), iters=5 if k == "native"
                            else 20)
            else:
                # forward plus the gradients of x and the weights: the
                # products three times, the activations and the gradients
                # moved
                flops, nbytes = 3 * flops, 3 * nbytes
                grad_out = torch.randn((n, 256, h, w), generator=gen,
                                       device=DEVICE).to(torch.bfloat16)
                grad_out = grad_out.contiguous(memory_format=cl)

                def step(f):
                    a = x.detach().requires_grad_()
                    b = wt.detach().requires_grad_()
                    f(a, b).backward(grad_out)
                    return a.grad, b.grad

                grads = {k: step(f) for k, f in ways.items()}
                row["train_rel_err"] = max(
                    close(f"rate {rate} grad {i}", g, w)
                    for i, (g, w) in enumerate(zip(grads["shift"],
                                                   grads["native"])))
                for k, f in ways.items():
                    row[f"train_{k}_ms"] = cuda_time_ms(
                        lambda f=f: step(f), iters=3 if k == "native"
                        else 10, warmup=1)
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            row[f"{phase}_bound_ms"] = max(t_ops, t_bytes)
            row[f"{phase}_bound_by"] = ("operations" if t_ops >= t_bytes
                                        else "bytes")
        log("dilated conv ways: " + json.dumps(row))
        rows.append(row)
    forward = deeplab_forward_comparison(
        cfg, {"native": {"dilated_impl": "native"},
              "shift": {"dilated_impl": "shift"}}, rounds=2, iters=3)
    return {"per_rate": rows, "npm_forward": forward}


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
def int8_conv_geometries(cfg):
    """Every quantized conv's geometry on ``cfg``'s model (resnet50dilated
    + ppm_deepsup_embedding) at the eval's largest pyramid level: one
    ``calib`` forward of a random image with a hook on each quantized
    conv. Returns (N, Cin, H, W, Cout, k, stride, padding, dilation,
    groups) tuples, each once, in forward order."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model)
    from open_world_semantic_segmentation_tpu_torch.data.odgt import (
        eval_pyramid_shapes)
    from open_world_semantic_segmentation_tpu_torch.models.layers import (
        QuantConv2d)

    h, w = eval_pyramid_shapes(*FULL_SIZE, cfg.DATASET.imgSizes,
                               cfg.DATASET.imgMaxSize,
                               cfg.DATASET.padding_constant)[-1]
    model = build_anomaly_model(cfg, DEVICE, quant="calib")
    geoms = []

    def hook(m, args):
        g = (*args[0].shape, m.out_channels, m.kernel_size[0], m.stride[0],
             m.padding[0], m.dilation[0], m.groups)
        if g not in geoms:
            geoms.append(g)

    for m in model.modules():
        if isinstance(m, QuantConv2d):
            m.register_forward_pre_hook(hook)
    x = torch.randn(1, h, w, 3, device=DEVICE)
    with torch.inference_mode(), torch.autocast(DEVICE, dtype=torch.bfloat16):
        model(x, seg_size=FULL_SIZE)
    del model
    return geoms, (h, w)


def int8_conv_check(cfg):
    """Part 1 of the quant phase: the int8 conv's tap form
    (``torch._int_mm``) against its plain version (a float64 conv of the
    integers, on the card) at every quantized conv geometry of the eval
    model at its largest level, at the DeepLab ASPP's 1x1 and dilated
    convs (rates 6, 12, 18 at 1024x2048, OS16), at a 3-channel stem conv
    and at a 32-group 3x3; int32 results equal. Each
    timed with CUDA events beside the bf16 cuDNN conv (channels_last) of
    the same shapes."""
    import torch
    import torch.nn.functional as F

    from open_world_semantic_segmentation_tpu_torch.ops import quant

    geoms, level = int8_conv_geometries(cfg)
    n, c, h, w = ASPP_QUANT_SHAPE
    geoms += [(n, c, h, w, 256, 1, 1, 0, 1, 1)] + [
        (n, c, h, w, 256, 3, 1, r, r, 1) for r in DILATED_RATES]
    # the K padding (a 3-channel input) and the block-diagonal grouped form
    # (resnext101's first 3x3, 32 groups, at 1/4 of the level)
    geoms += [(1, 3, *level, 64, 3, 2, 1, 1, 1),
              (1, 128, level[0] // 4, level[1] // 4, 128, 3, 1, 1, 1, 32)]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = []
    for geom in geoms:
        n, cin, h, w, cout, k, st, pad, dil, g = geom
        x = torch.randint(-127, 128, (n, cin, h, w), dtype=torch.int8,
                          device=DEVICE, generator=gen).contiguous(
            memory_format=torch.channels_last)
        wq = torch.randint(-127, 128, (cout, cin // g, k, k),
                           dtype=torch.int8, device=DEVICE, generator=gen)
        args = (st, pad, dil, g)
        calls = quant.int8_conv2d.calls
        got = quant.int8_conv2d(x, wq, *args)
        if quant.int8_conv2d.calls != calls + 1:
            raise AssertionError("int8_conv2d took no CUDA path")
        want = quant.int8_conv2d_plain(x, wq, *args)
        if not torch.equal(got, want):
            raise AssertionError(f"int8 conv {geom}: {int((got != want).sum())}"
                                 " int32 values differ from the plain version")
        xb = x.to(torch.bfloat16)
        wb = wq.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        row = {"geometry": list(geom),
               "int8_ms": cuda_time_ms(lambda: quant.int8_conv2d(x, wq, *args),
                                       iters=10),
               "bf16_cudnn_ms": cuda_time_ms(
                   lambda: F.conv2d(xb, wb, None, st, pad, dil, g), iters=10)}
        rows.append(row)
        log("int8 conv " + json.dumps(row))
    return {"eval_level": list(level), "geometries": len(rows),
            "equal": True, "rows": rows}


def golden_quant_cfg(root, weights):
    """The golden StreetHazards run's tree and trained weights, scored by
    dissum on the 5-scale QUANT_PYRAMID (``tools/quant_drift.py
    eval_cfg``)."""
    from open_world_semantic_segmentation_tpu_torch.tools.quant_drift import (
        eval_cfg)

    cfg = eval_cfg(os.path.join(root, "golden", "sh"), weights,
                   img_sizes=QUANT_PYRAMID, max_size=QUANT_MAX_SIZE)
    cfg.DIR = os.path.join(root, "golden_quant")
    return cfg


def quant_golden_evals(cfg):
    """Part 2: ``cli.eval_ood.main`` (dissum) on the golden weights
    without quant and in each QUANT_EVAL_MODES mode (calibrated on the
    first QUANT_CALIB_IMAGES val images); imgs/s and the metrics beside the
    float run's, the drift of QUANT_GATED_MODES gated by QUANT_DRIFT. In
    float32 with TF32 off,
    as the golden run scores and the JAX package's drift test evaluates: a
    bf16 float baseline adds bf16's own drift on the 5-scale average. Part
    3: knn under int8-hybrid, knn_cosine launched once per image, every
    map finite."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import eval_ood
    from open_world_semantic_segmentation_tpu_torch.ops import quant
    from open_world_semantic_segmentation_tpu_torch.tools.golden_run import (
        exact_fp32)

    def evaluate(c, mode):
        with exact_fp32():
            return eval_ood.main(c, torch.float32, device=DEVICE, quant=mode,
                                 calib_images=QUANT_CALIB_IMAGES)

    metrics = ("auroc", "aupr", "fpr", "mean_iou", "accuracy")
    runs = {}
    for mode in ("off",) + QUANT_EVAL_MODES:
        calls = quant.int8_conv2d.calls
        result, _ = counted(f"quant eval {mode}",
                            lambda mode=mode: evaluate(cfg, mode))
        ran = quant.int8_conv2d.calls - calls
        if (ran > 0) != (mode != "off"):
            raise AssertionError(f"quant eval {mode}: {ran} int8 convs")
        run = {k: result[k] for k in metrics}
        _finite(f"quant eval {mode}", run)
        run.update(images=result["images"],
                   imgs_per_s=result["images"] / result["seconds"],
                   int8_convs=ran)
        if mode != "off":
            run["drift"] = {k: run[k] - runs["off"][k] for k in metrics}
        runs[mode] = run
        log(f"quant golden eval {mode}: " + json.dumps(run))
    for mode in QUANT_GATED_MODES:
        for key, bound in QUANT_DRIFT.items():
            if not abs(runs[mode]["drift"][key]) < bound:
                raise AssertionError(f"quant {mode}: {key} drift "
                                     f"{runs[mode]['drift'][key]} >= {bound}")

    n_val = GOLDEN_RECIPE["n_val"]
    c = cfg.clone()
    c.OOD.ood = "knn"
    with kept_confs() as confs:
        result, launches = counted(
            "quant knn int8-hybrid", lambda: evaluate(c, "int8-hybrid"),
            {"knn_cosine": n_val})
        finite = all(bool(torch.isfinite(m).all()) for m in confs)
    knn = {k: result[k] for k in metrics}
    knn.update(images=result["images"], maps=len(confs),
               launches=launches["knn_cosine"])
    log("quant knn int8-hybrid: " + json.dumps(knn))
    if not finite or len(confs) != n_val:
        raise AssertionError(f"quant knn: {len(confs)} maps, finite {finite}")
    _finite("quant knn", {k: knn[k] for k in metrics})
    runs["knn_int8_hybrid"] = knn
    return runs


def quant_conv_device_check(cfg, mode):
    """Every quantized conv of the golden model's ``mode`` forward on the
    card (one val image at the largest pyramid level, the scales
    calibrated on it), given on the CPU the input it saw on the card,
    gives the card's output bit for bit: the drift of a mode outside
    QUANT_GATED_MODES is then the host's too, not a fault of the card."""
    import copy

    import torch

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, calibrate_quant_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.data.odgt import (
        ValPipeline)
    from open_world_semantic_segmentation_tpu_torch.models.layers import (
        QuantConv2d)
    from open_world_semantic_segmentation_tpu_torch.tools.golden_run import (
        exact_fp32)

    item = next(iter(ValPipeline(
        cfg.DATASET.root_dataset, cfg.DATASET.list_val,
        img_sizes=cfg.DATASET.imgSizes, img_max_size=cfg.DATASET.imgMaxSize,
        padding_constant=cfg.DATASET.padding_constant, max_sample=1)))
    img = item["img_data"][-1]
    seg_size = tuple(item["seg_label"].shape[1:3])
    model = build_anomaly_model(cfg, DEVICE, use_softmax=True, quant=mode)
    init_or_load_variables(cfg, model)
    with exact_fp32():
        calibrate_quant_model(cfg, model, [([img], seg_size)], quant=mode)
    on_cpu = copy.deepcopy(model).cpu()
    seen = []

    def record(name):
        def hook(_, args, out):
            seen.append((name, args[0].detach().cpu(), out.detach().cpu()))
        return hook

    hooks = [m.register_forward_hook(record(name))
             for name, m in model.named_modules()
             if isinstance(m, QuantConv2d) and m.mode != "off"]
    with torch.no_grad(), exact_fp32():
        model(torch.from_numpy(img).to(DEVICE), seg_size=seg_size)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        unequal = [name for name, x, y in seen
                   if not torch.equal(on_cpu.get_submodule(name)(x), y)]
    out = {"mode": mode, "shape": list(img.shape), "convs": len(seen),
           "unequal": unequal}
    log("quant conv device check: " + json.dumps(out))
    if unequal or not seen:
        raise AssertionError(f"quant {mode}: {len(unequal)} of {len(seen)} "
                             "convs differ between the card and the CPU")
    return out


def quant_deeplab_forward(root):
    """Part 4: deeplabv3plus_embedding_resnet101 (OS16) on one 1024x2048
    Cityscapes val image with the deeplab phase's checkpoint, bf16 against
    int8-hybrid (the backbone int8, calibrated by its calib-hybrid twin on
    QUANT_DEEPLAB_CALIB val images): ms per image (CUDA events), peak
    memory, and the argmax agreement of the two."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        get_transforms, get_val_dataset)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.models import deeplab
    from open_world_semantic_segmentation_tpu_torch.ops import quant
    from open_world_semantic_segmentation_tpu_torch.train.checkpoint import (
        load_deeplab_state)

    cfg = load_config("configs/cityscapes_embedding.yaml", [
        "DATASET.root_dataset", os.path.join(root, "cityscapes")])
    state = load_deeplab_state(os.path.join(root, "deeplab_embedding.pth"))

    def build(mode):
        model = deeplab.deeplabv3plus_embedding_resnet101(quant=mode)
        model.load_state_dict(state)
        return model.eval().to(DEVICE, memory_format=torch.channels_last)

    ds = get_val_dataset(cfg, get_transforms(cfg.DEEPLAB.crop_size)[1])
    images = [ds[i][0][None] for i in range(QUANT_DEEPLAB_CALIB)]
    models = {"bf16": build("off"), "int8-hybrid": build("int8-hybrid")}
    quant.calibrate_and_prequantize(build("calib-hybrid"),
                                    models["int8-hybrid"], images,
                                    mode="int8-hybrid", dtype=torch.bfloat16)
    x = torch.from_numpy(images[0]).to(DEVICE)
    out, preds = {}, {}
    for name, model in models.items():
        def run(model=model):
            with torch.inference_mode(), torch.autocast(
                    DEVICE, dtype=torch.bfloat16):
                return model(x)[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls = quant.int8_conv2d.calls
        preds[name] = run().argmax(-1)
        out[name] = {"ms": cuda_time_ms(run, iters=5),
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "int8_convs": quant.int8_conv2d.calls - calls}
    if out["int8-hybrid"]["int8_convs"] == 0 or out["bf16"]["int8_convs"]:
        raise AssertionError(f"deeplab quant forward: {out}")
    out["argmax_agreement"] = float(
        (preds["bf16"] == preds["int8-hybrid"]).float().mean())
    log("quant deeplab forward 1024x2048: " + json.dumps(out))
    return out


def quant_serve_export(root, cfg):
    """Parts 5 and 6: ``cli/serve`` with ``--quant int8-hybrid
    --calib-glob`` (the slice tree's images) answering N_SERVE_SMALL
    ``/segment`` requests, each held to a direct forward of the served
    model (labels on SERVE_LABEL_AGREEMENT of pixels); the p50 latency.
    Then an int8-hybrid artifact from ``cli/export_model`` (bf16, maxlogit,
    the same glob): its header's quant, ``aten._int_mm`` in its program, and
    its forward on two frames against the live quantized model's (labels
    on SERVE_LABEL_AGREEMENT, maxlogit within SERVE_CONF_TOL of the
    largest)."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import export_model
    from open_world_semantic_segmentation_tpu_torch.core.export import (
        load_exported, read_program)
    from open_world_semantic_segmentation_tpu_torch.ops import quant

    bf16 = torch.bfloat16
    images = os.path.join(root, "images/test/t1")
    calib_glob = os.path.join(images, "*.png")
    names = sorted(os.listdir(images), key=lambda n: int(n.split(".")[0]))
    frames = []
    for name in names[:N_SERVE_SMALL]:
        with open(os.path.join(images, name), "rb") as f:
            frames.append(f.read())
    calls = quant.int8_conv2d.calls
    served = _Served(cfg, bf16, quant="int8-hybrid", calib_glob=calib_glob)
    try:
        ms, _ = counted("serve int8-hybrid", lambda: [
            served.segment(f)[0] for f in frames])
    finally:
        served.close()
    live = served.seg.model
    summary = {"serve": {**_latency(ms), "startup_s": served.startup_s,
                         "int8_convs": quant.int8_conv2d.calls - calls,
                         "check": served.check("int8-hybrid",
                                               direct_forward(live, bf16))}}
    if summary["serve"]["int8_convs"] == 0:
        raise AssertionError("the int8-hybrid server ran no int8 conv")

    tic = time.perf_counter()
    path = export_model.main(cfg, bf16, *FULL_SIZE, method="maxlogit",
                             quant="int8-hybrid", calib_glob=calib_glob,
                             out=os.path.join(root, "quant.owss"),
                             device=DEVICE)
    export_s = time.perf_counter() - tic
    program, meta = read_program(path)
    # the bf16 forward sits in an autocast region: a nested graph
    targets = {str(n.target) for gm in program.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule)
               for n in gm.graph.nodes if n.op == "call_function"}
    int8_consts = sum(t.dtype == torch.int8 for t in
                      {**program.state_dict, **program.constants}.values())
    del program
    fn, _ = load_exported(path)
    agree, err = 1.0, 0.0
    direct = direct_forward(live, bf16, "maxlogit")
    for f in frames[:2]:
        arr = served.seg._decode(f)[None]
        pred, conf = (t.cpu().numpy() for t in fn(
            torch.from_numpy(arr).to(DEVICE)))
        want_pred, want_conf = direct(arr)
        agree = min(agree, float((pred == want_pred).mean()))
        want = want_conf.astype(np.float32)
        err = max(err, float(np.abs(conf.astype(np.float32) - want).max()
                             / np.abs(want).max()))
    summary["export"] = {"export_s": export_s, "bytes": os.path.getsize(path),
                         "quant": meta.get("quant"),
                         "int_mm_in_program": "aten._int_mm.default" in targets,
                         "int8_constants": int8_consts,
                         "label_agreement": agree, "maxlogit_max_rel": err}
    log("quant serve and export: " + json.dumps(summary))
    if not (meta.get("quant") == "int8-hybrid"
            and summary["export"]["int_mm_in_program"] and int8_consts > 0
            and agree >= SERVE_LABEL_AGREEMENT and err <= SERVE_CONF_TOL):
        raise AssertionError(f"int8 artifact: {summary['export']}")
    return summary


def quant_phase(root, cfg, golden_weights):
    """The int8 PTQ surface (``ops/quant.py``) on the card at full width;
    see the module note. Returns the summary and the knn launches of the
    int8-hybrid knn eval."""
    summary = {"int8_conv": int8_conv_check(cfg)}
    golden_cfg = golden_quant_cfg(root, golden_weights)
    summary["golden"] = quant_golden_evals(golden_cfg)
    summary["conv_device_checks"] = [
        quant_conv_device_check(golden_cfg, mode) for mode in QUANT_EVAL_MODES
        if mode not in QUANT_GATED_MODES]
    summary["deeplab"] = quant_deeplab_forward(root)
    summary.update(quant_serve_export(root, cfg))
    return summary, summary["golden"]["knn_int8_hybrid"]["launches"]


def write_voc_tree(root, n_train, n_val, seed):
    """A VOCdevkit tree of VOC_SIZES photos (JPEG) with labels of VOC's 21
    classes and 255 object borders (PNG); ``train_aug`` and ``val``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = os.path.join(root, "VOCdevkit", "VOC2012")
    palette = rng.integers(0, 255, (21, 3))
    for split, n, labels in (("train_aug", n_train, "SegmentationClassAug"),
                             ("val", n_val, "SegmentationClass")):
        names = [f"{split}_{i:06d}" for i in range(n)]
        for i, name in enumerate(names):
            h, w = VOC_SIZES[i % len(VOC_SIZES)]
            lab = np.zeros((h, w), np.uint8)
            for _ in range(4):
                r0, c0 = rng.integers(0, h - h // 4), rng.integers(0, w - w // 4)
                lab[r0:r0 + rng.integers(h // 8, h // 2),
                    c0:c0 + rng.integers(w // 8, w // 2)] = rng.integers(1, 21)
            img = np.clip(palette[lab] + rng.normal(0, 20, (h, w, 3)), 0,
                          255).astype(np.uint8)
            lab[np.roll(lab, 1, 0) != lab] = 255
            for sub, arr, ext in (("JPEGImages", img, ".jpg"),
                                  (labels, lab, ".png")):
                os.makedirs(os.path.join(base, sub), exist_ok=True)
                Image.fromarray(arr).save(os.path.join(base, sub, name + ext))
        lists = os.path.join(base, "ImageSets", "Segmentation")
        os.makedirs(lists, exist_ok=True)
        with open(os.path.join(lists, split + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


def voc_phase(root):
    """``cli.main_deeplab.main`` with DEEPLAB.dataset voc on a synthetic
    VOC tree: deeplabv3plus_mobilenet, 21 classes, VOC's train transform
    (random scale, pad-if-needed crop 513, flip), batch VOC_BATCH, bf16, for
    VOC_STEPS steps, then its val pass over VOC_VAL_IMAGES images of
    differing sizes (one per batch); s/step (median after 2 warm-ups) and
    loader wait s/step, every loss and the mIoU finite."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import main_deeplab
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)

    tree = write_voc_tree(os.path.join(root, "voc"), VOC_TRAIN_IMAGES,
                          VOC_VAL_IMAGES, SEED + 5)
    cfg = load_config(None, [
        "DATASET.root_dataset", tree, "DEEPLAB.dataset", "voc",
        "DEEPLAB.model", "deeplabv3plus_mobilenet",
        "DEEPLAB.num_classes", "21", "DEEPLAB.crop_size", str(VOC_CROP),
        "DEEPLAB.batch_size", str(VOC_BATCH),
        "DEEPLAB.total_itrs", str(VOC_STEPS),
        "DEEPLAB.val_interval", str(VOC_STEPS), "DEEPLAB.lr", "0.01",
        "DIR", os.path.join(root, "voc_ckpt")])
    torch.cuda.reset_peak_memory_stats()
    out, _ = counted("voc train", lambda: main_deeplab.main(
        cfg, torch.bfloat16, device=DEVICE, log_every=1))
    log_ = out["log"]
    seconds = np.diff([0.0] + [e["seconds"] for e in log_])
    waits = np.diff([0.0] + [e["wait"] for e in log_])
    summary = {"steps": out["steps"], "skipped": out["skipped"],
               "losses": [e["loss"] for e in log_],
               "s_per_step_median": float(np.median(seconds[TRAIN_WARMUP:])),
               "loader_wait_s_per_step": float(np.mean(waits[TRAIN_WARMUP:])),
               "val_miou": out["validations"],
               "val_sizes": [list(s) for s in VOC_SIZES[:VOC_VAL_IMAGES]],
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    log("voc: " + json.dumps(summary))
    if out["steps"] != VOC_STEPS or out["skipped"] or len(
            out["validations"]) != 1 or not np.isfinite(
            summary["losses"] + out["validations"]).all():
        raise AssertionError(f"voc: {summary}")
    return summary


# ---------------------------------------------------------------------------
def _ddp_parity_inputs():
    """The fixed global batch of the step parity: seeded images and labels
    at 1/8, each rank's share ignoring DDP_IGNORE_SHARE of its labels."""
    rng = np.random.default_rng(SEED + 13)
    n = DDP_WORLD * DDP_PARITY_BATCH
    h, w = DDP_PARITY_SIZE
    img = rng.standard_normal((n, h, w, 3)).astype(np.float32)
    labels = rng.integers(0, 13, (n, h // 8, w // 8))
    for r, share in enumerate(DDP_IGNORE_SHARE):
        part = labels[r * DDP_PARITY_BATCH:(r + 1) * DDP_PARITY_BATCH]
        part[rng.random(part.shape) < share] = -1
    return img, labels


def _ddp_parity_run(weights, rank, world, group, dtype, reverse=False):
    """DDP_PARITY_STEPS AnomalyTrainSteps (in ``dtype``, float64 or fp32
    with TF32 off, guard on, dropout held out) of the full-width model from
    ``weights`` on rank ``rank``'s share of the fixed global batch (all of
    it for one process; ``reverse``: its images in reverse order, the same
    sums taken in another order). Returns the losses and the state dict,
    before and after."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.parallel import replicate
    from open_world_semantic_segmentation_tpu_torch.train.optim import (
        poly_schedule, two_group_optimizer)
    from open_world_semantic_segmentation_tpu_torch.train.state import (
        AnomalyTrainStep)

    cfg = load_config("configs/train_embedding.yaml", [
        "MODEL.weights_encoder", weights[0],
        "MODEL.weights_decoder", weights[1]])
    model = build_anomaly_model(cfg, DEVICE, train=True)
    init_or_load_variables(cfg, model, seed=SEED)
    model.to(dtype)
    replicate(model, group)
    start = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    t = cfg.TRAIN
    optimizer = two_group_optimizer(
        model, lr_encoder=poly_schedule(t.lr_encoder, 100, t.lr_pow),
        lr_decoder=poly_schedule(t.lr_decoder, 100, t.lr_pow),
        momentum=t.beta1, weight_decay=t.weight_decay)
    step = AnomalyTrainStep(model, optimizer, alpha=0.01, guard=True,
                            dtype=dtype, group=group)
    img, labels = _ddp_parity_inputs()
    if reverse:
        img, labels = img[::-1].copy(), labels[::-1].copy()
    part = slice(rank * len(img) // world, (rank + 1) * len(img) // world)
    batch = {"img_data": torch.from_numpy(img[part]).to(DEVICE, dtype),
             "seg_label": torch.from_numpy(labels[part]).to(DEVICE)}
    losses, skipped = [], []
    for _ in range(DDP_PARITY_STEPS):
        m = step(batch)
        losses.append(float(m["loss"]))
        skipped.append(bool(m["skipped"]))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return {"losses": losses, "skipped": skipped, "state": state,
            "start": start}


def _ddp_bn_input():
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    return (torch.randn(DDP_WORLD * DDP_PARITY_BATCH, 64, 32, 32,
                        generator=gen, device=DEVICE) * 2 + 1).to(
        torch.bfloat16)


def _ddp_bn_forward(x, group):
    """Train-mode BN of a bf16 input under bf16 autocast (over ``group``
    when given): the output and its dtype."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.models.layers import (
        BatchNorm2d)

    bn = BatchNorm2d(x.shape[1]).to(DEVICE).train()
    bn.group = group
    with torch.autocast(DEVICE, dtype=torch.bfloat16):
        y = bn(x)
    return y.detach().float().cpu(), str(y.dtype), bn.running_var.cpu()


def _ddp_support(rank, world):
    """Rank ``rank``'s first DDP_SUPPORT_PER_RANK support images of the
    deeplab phase's tree (its shard of the split, as ``batch_iterator``
    deals it), with their labels."""
    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        get_transforms)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.data.cityscapes import (
        Cityscapes)
    from open_world_semantic_segmentation_tpu_torch.data.loader import (
        batch_iterator)

    cfg = load_config("configs/cityscapes_embedding.yaml")
    ds = Cityscapes(DDP_ROOT["cityscapes"], split="train",
                    transform=get_transforms(cfg.DEEPLAB.crop_size)[1],
                    unknown_target=tuple(cfg.DEEPLAB.unknown_target))
    image, _, target = next(batch_iterator(
        ds, DDP_SUPPORT_PER_RANK, shuffle=False, epochs=1, num_workers=2,
        num_hosts=world, host_id=rank))
    return image, target


def _ddp_prototype(images, targets, group):
    """The car prototype of ``images`` (fp32, TF32 off) through the DeepLab
    embedding model with ``fused_blocks=True`` from the deeplab phase's
    checkpoint, over ``group``; with the fused_bottleneck block calls and
    kernel launches of the forward."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
        build_deeplab_model, init_or_load_deeplab)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.fewshot.prototypes import (
        extract_prototype)
    from open_world_semantic_segmentation_tpu_torch.ops.fused_block import (
        fused_bottleneck)

    cfg = load_config("configs/cityscapes_embedding.yaml")
    model, _ = build_deeplab_model(cfg, DEVICE, fused_blocks=True)
    init_or_load_deeplab(model, DDP_ROOT["deeplab_ckpt"])
    fused_bottleneck.launches = fused_bottleneck.kernel_launches = 0
    with torch.inference_mode():
        _, _, features = model(torch.from_numpy(images).to(DEVICE))
        proto, valid = extract_prototype(
            features, torch.from_numpy(targets).to(DEVICE), 13, group=group)
    return {"proto": proto.cpu(), "valid": bool(valid),
            "launches": fused_bottleneck.launches,
            "kernel_launches": fused_bottleneck.kernel_launches}


# the deeplab phase's tree and checkpoint, for the workers too
DDP_ROOT = {}


def ddp_worker(out_dir):
    """One rank of the ddp phase's own job (``chip_smoke.py --ddp-worker
    DIR``, RANK / WORLD_SIZE / LOCAL_RANK in the environment): joins a gloo
    group on cuda over ``DIR/store``, runs the step parity, the bf16 BN
    dtype check and the distributed prototype, writes ``DIR/rank<r>.pt``
    and leaves without tearing the group down."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.parallel import (
        data_group, init_distributed)

    global DEVICE, DDP_PARITY_SIZE
    with open(os.path.join(out_dir, "inputs.json")) as f:
        inputs = json.load(f)
    DDP_ROOT.update(inputs["root"])
    DEVICE = inputs["device"]
    DDP_PARITY_SIZE = tuple(inputs["parity_size"])
    rank, world, device = init_distributed(
        DEVICE, backend="gloo", init_method="file://" + os.path.join(
            out_dir, "store"), timeout_s=DDP_RANK_TIMEOUT_S)
    group = data_group()
    _tf32_off()
    tic = time.perf_counter()
    res = {"rank": rank, "backend": torch.distributed.get_backend()}
    res["parity"] = {
        name: _ddp_parity_run(inputs["weights"], rank, world, group, dtype)
        for name, dtype in (("float64", torch.float64),
                            ("fp32", torch.float32))}
    x = _ddp_bn_input()
    part = slice(rank * len(x) // world, (rank + 1) * len(x) // world)
    res["bn"] = _ddp_bn_forward(x[part], group)
    images, targets = _ddp_support(rank, world)
    res["prototype"] = _ddp_prototype(images, targets, group)
    res["seconds"] = time.perf_counter() - tic
    path = os.path.join(out_dir, f"rank{rank}.pt")
    torch.save(res, path + ".part")
    os.replace(path + ".part", path)
    sys.stdout.flush()
    os._exit(0)


def _ddp_job(out_dir, world):
    """Start ``world`` worker ranks of this script; returns their
    processes and log files."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT")}
    env["WORLD_SIZE"] = str(world)
    procs = []
    for rank in range(world):
        log_file = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ddp-worker",
             out_dir],
            env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)},
            stdout=log_file, stderr=subprocess.STDOUT), log_file))
    return procs


def _ddp_wait(out_dir, procs):
    """Each rank's results; fails with the ranks' log tails unless every
    rank wrote them within DDP_RANK_TIMEOUT_S; kills what is left."""
    import torch

    paths = [os.path.join(out_dir, f"rank{r}.pt") for r in range(len(procs))]
    deadline = time.monotonic() + DDP_RANK_TIMEOUT_S
    try:
        while time.monotonic() < deadline:
            if all(os.path.exists(p) for p in paths) or any(
                    proc.poll() not in (None, 0) for proc, _ in procs):
                break
            time.sleep(0.2)
    finally:
        _ddp_stop(procs)
    if not all(os.path.exists(p) for p in paths):
        tails = []
        for r, (proc, _) in enumerate(procs):
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} (rc {proc.returncode}):\n"
                             + f.read()[-4000:])
        raise AssertionError("ddp job: not every rank finished\n"
                             + "\n".join(tails))
    return [torch.load(p, weights_only=False) for p in paths]


def _ddp_stop(procs):
    """Give each rank 10 s to end, then kill it; close the logs."""
    for proc, log_file in procs:
        if proc.poll() is None:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        log_file.close()


def _update_distance(got, want, start):
    """How far state dict ``got`` is from ``want``, as fractions of the
    change from ``start`` to ``want``: ``max_frac``, the largest of any
    float tensor's largest |difference| over its largest change (a tensor
    that did not change must be equal); ``norm_frac``, the norm of all the
    differences over the norm of all the changes; and ``ints_equal``,
    whether every other tensor is equal; ``worst``, the tensor of
    ``max_frac``."""
    worst, diff2, moved2, exact = (0.0, ""), 0.0, 0.0, True
    for key, value in want.items():
        if value.is_floating_point():
            diff = got[key].double() - value.double()
            moved = value.double() - start[key].double()
            d, m = float(diff.abs().max()), float(moved.abs().max())
            worst = max(worst, (d / m if m else
                                (0.0 if d == 0 else float("inf")), key))
            diff2 += float(diff.square().sum())
            moved2 += float(moved.square().sum())
        else:
            exact = exact and bool((got[key] == value).all())
    return {"max_frac": worst[0], "worst": worst[1],
            "norm_frac": (diff2 / moved2) ** 0.5, "ints_equal": exact}


def _bit_identical(states):
    return all(all(bool((s[k] == states[0][k]).all()) for k in states[0])
               for s in states[1:])


def _torchrun(args, world, log_dir, timeout):
    """``python -m torch.distributed.run`` with ``world`` ranks, output of
    each rank prefixed ``[default<rank>]:``, OMP_NUM_THREADS 8 / world
    (the launcher's default is 1). Returns (rc, output, s, stamps):
    ``stamps`` the seconds after the launch at which rank 0 said it joined
    the group and printed its first step (train_embedding)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), "--log-dir", log_dir, "--tee",
           "3", "-m", *args]
    env = {**os.environ, "OMP_NUM_THREADS": str(max(8 // world, 1))}
    tic = time.perf_counter()
    # a session of its own, so that a timeout kills the ranks with it
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    timer = threading.Timer(timeout, os.killpg, (proc.pid, signal.SIGKILL))
    timer.start()
    lines, stamps = [], {}
    try:
        for line in proc.stdout:
            lines.append(line)
            for key, marker in (("joined", "data parallel:"),
                                ("first_step", "Epoch: [1][1/")):
                if line.startswith("[default0]:") and marker in line:
                    stamps.setdefault(key, time.perf_counter() - tic)
        rc = proc.wait()
    finally:
        timer.cancel()
    return rc, "".join(lines), time.perf_counter() - tic, stamps


def _metrics_s_per_step(path):
    """Median seconds between the logged steps of a metrics.jsonl, after
    the first; and the steps it holds."""
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    times = [r["time"] for r in rows]
    return float(np.median(np.diff(times)[1:])), [r["step"] for r in rows]


def _rank_lines(output, rank, marker):
    return [line for line in output.splitlines()
            if line.startswith(f"[default{rank}]:") and marker in line]


def _pair_state(ckpt):
    import torch

    return {f"{part}.{k}": v for part in ("encoder", "decoder")
            for k, v in torch.load(os.path.join(
                ckpt, f"{part}_epoch_1.pth"), map_location="cpu").items()}


def ddp_phase(root, cfg):
    """Data-parallel training on the card; see the module note. Returns
    the summary."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import (
        train_embedding)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.utils.observability import (
        TRACE_FILE, annotate, profile_trace)

    summary = {}
    phase_tic = time.perf_counter()
    laps = {}                            # seconds of each part, in order
    if DEVICE == "cuda":
        # the earlier phases' cached blocks, for the ranks started below
        torch.cuda.empty_cache()

    def lap(name):
        laps[name] = time.perf_counter() - phase_tic - sum(laps.values())

    weights = [cfg.MODEL.weights_encoder, cfg.MODEL.weights_decoder]
    DDP_ROOT.update(cityscapes=os.path.join(root, "cityscapes"),
                    deeplab_ckpt=os.path.join(root, "deeplab_embedding.pth"))
    job_dir = os.path.join(root, "ddp_job")
    os.makedirs(job_dir)
    with open(os.path.join(job_dir, "inputs.json"), "w") as f:
        json.dump({"weights": weights, "root": DDP_ROOT, "device": DEVICE,
                   "parity_size": DDP_PARITY_SIZE}, f)
    # train_embedding's arguments (fp32, TF32 off): DDP_CLI_STEPS steps of
    # the config's batch a rank on the train phase's tree
    tree = os.path.join(root, "train")
    base = ["DATASET.root_dataset", tree,
            "DATASET.list_train", os.path.join(tree, "training.odgt"),
            "DATASET.imgSizes", DDP_CLI_SIZES,
            "DATASET.imgMaxSize", DDP_CLI_MAX_SIZE,
            "TRAIN.epoch_iters", str(DDP_CLI_STEPS), "TRAIN.num_epoch", "1",
            "TRAIN.disp_iter", "1", "MODEL.weights_encoder", weights[0],
            "MODEL.weights_decoder", weights[1]]

    def train_embedding_launch(name, world, extra):
        return _torchrun(
            ["open_world_semantic_segmentation_tpu_torch.cli.train_embedding",
             "--device", DEVICE, "--precision", "fp32",
             "--max-steps", str(DDP_CLI_STEPS), *extra,
             "--cfg", "configs/train_embedding.yaml", *base,
             "DIR", os.path.join(root, f"ddp_{name}")], world,
            os.path.join(root, f"ddp_{name}_logs"), DDP_RANK_TIMEOUT_S)

    # main_deeplab (2 ranks, bf16) and the one-rank NCCL train_embedding,
    # both under torch.distributed.run, run beside the rank job and this
    # process's side of it: none of them is timed against another run
    deeplab_dir = os.path.join(root, "ddp_deeplab")
    launches = ThreadPoolExecutor(2)
    nccl_launch = launches.submit(train_embedding_launch, "1_rank_nccl", 1,
                                  [])
    deeplab_launch = launches.submit(_torchrun, [
        "open_world_semantic_segmentation_tpu_torch.cli.main_deeplab",
        "--device", DEVICE,
        "--max-steps", str(DDP_DEEPLAB_STEPS),
        "--cfg", "configs/cityscapes_embedding.yaml",
        "DATASET.root_dataset", os.path.join(root, "cityscapes_train"),
        "DEEPLAB.ckpt", DDP_ROOT["deeplab_ckpt"],
        "DEEPLAB.lr", str(DEEPLAB_SMOKE_LR),
        "DEEPLAB.val_interval", str(DDP_DEEPLAB_STEPS),
        "DEEPLAB.batch_size", str(DDP_DEEPLAB_BATCH),
        "DIR", deeplab_dir], DDP_WORLD,
        os.path.join(root, "ddp_deeplab_logs"), DDP_RANK_TIMEOUT_S)
    launches.shutdown(wait=False)
    # the 2-rank job runs while this process takes the one-process side
    procs = _ddp_job(job_dir, DDP_WORLD)
    saved = _tf32_off()
    try:
        want = {name: _ddp_parity_run(weights, 0, 1, None, dtype)
                for name, dtype in (("float64", torch.float64),
                                    ("fp32", torch.float32))}
        reversed64 = _ddp_parity_run(weights, 0, 1, None, torch.float64,
                                     reverse=True)
        x = _ddp_bn_input()
        want_bn = _ddp_bn_forward(x, None)
        parts = [_ddp_support(r, DDP_WORLD) for r in range(DDP_WORLD)]
        want_proto = _ddp_prototype(
            np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]), None)
        lap("one_process_side")
        ranks = _ddp_wait(job_dir, procs)
        lap("rank_job_wait")
    finally:
        _tf32_set(saved)
        _ddp_stop(procs)

    # 1. full-width step parity, 2 ranks x 2 against 1 process x 4
    parity = {"backend": ranks[0]["backend"],
              "job_seconds": max(r["seconds"] for r in ranks)}
    for name in ("float64", "fp32"):
        got, ref = ranks[0]["parity"][name], want[name]
        parity[name] = {
            "losses_2_ranks": got["losses"], "losses_1_process": ref["losses"],
            "loss_max_rel": max(abs(a - b) / abs(b) for a, b in
                                zip(got["losses"], ref["losses"])),
            "ranks_bit_identical": _bit_identical(
                [r["parity"][name]["state"] for r in ranks]),
            "vs_1_process": _update_distance(got["state"], ref["state"],
                                             ref["start"])}
        if any(any(r["parity"][name]["skipped"]) for r in ranks) or any(
                ref["skipped"]):
            raise AssertionError(f"ddp step parity {name}: a step skipped")
    f64, f32 = want["float64"], want["fp32"]
    parity["float64"]["reversed_vs_1_process"] = _update_distance(
        reversed64["state"], f64["state"], f64["start"])
    parity["fp32"]["2_ranks_vs_float64"] = _update_distance(
        ranks[0]["parity"]["fp32"]["state"], f64["state"], f64["start"])
    parity["fp32"]["1_process_vs_float64"] = _update_distance(
        f32["state"], f64["state"], f64["start"])
    summary["step_parity"] = parity
    log("ddp step parity: " + json.dumps(parity))
    p64, p32 = parity["float64"], parity["fp32"]
    bound64 = (DDP_F64_NOISE_RATIO
               * p64["reversed_vs_1_process"]["norm_frac"] + DDP_F64_FLOOR)
    bound = (DDP_F32_NOISE_RATIO * p32["1_process_vs_float64"]["norm_frac"]
             + DDP_F32_FLOOR)
    if not (parity["backend"] == "gloo"
            and p64["loss_max_rel"] <= DDP_F64_LOSS_RTOL
            and p64["vs_1_process"]["norm_frac"] <= bound64
            and p32["2_ranks_vs_float64"]["norm_frac"] <= bound
            and all(p["ranks_bit_identical"] and p["vs_1_process"][
                "ints_equal"] for p in (p64, p32))):
        raise AssertionError("ddp step parity: " + json.dumps(parity))
    # the bf16 BN over ranks: bf16 out, within bf16 rounding of one process
    got_bn = torch.cat([r["bn"][0] for r in ranks])
    bn_err = float((got_bn - want_bn[0]).abs().max())
    summary["bn_bf16"] = {"dtype": [r["bn"][1] for r in ranks],
                          "one_process_dtype": want_bn[1],
                          "max_abs_err": bn_err,
                          "running_var_max_abs_err": float(
                              (ranks[0]["bn"][2] - want_bn[2]).abs().max())}
    log("ddp bf16 batch norm: " + json.dumps(summary["bn_bf16"]))
    if set(summary["bn_bf16"]["dtype"]) != {"torch.bfloat16"} or \
            bn_err > DDP_BN_DTYPE_ATOL:
        raise AssertionError("ddp bf16 batch norm: "
                             + json.dumps(summary["bn_bf16"]))

    # 4. the prototype of 2 ranks' support images against one process's
    got = ranks[0]["prototype"]
    rel = float((got["proto"] - want_proto["proto"]).abs().max()
                / want_proto["proto"].abs().max())
    summary["prototype"] = {
        "valid": [r["prototype"]["valid"] for r in ranks],
        "one_process_valid": want_proto["valid"], "max_rel": rel,
        "ranks_equal": all(bool((r["prototype"]["proto"]
                                 == got["proto"]).all()) for r in ranks),
        "launches": [r["prototype"]["launches"] for r in ranks],
        "kernel_launches": [r["prototype"]["kernel_launches"]
                            for r in ranks],
        "one_process_launches": want_proto["launches"]}
    log("ddp prototype: " + json.dumps(summary["prototype"]))
    if not (want_proto["valid"] and all(summary["prototype"]["valid"])
            and rel <= DDP_PROTO_RTOL and summary["prototype"]["ranks_equal"]
            and summary["prototype"]["launches"] == [DEEPLAB_ROUTED_BLOCKS]
            * DDP_WORLD and summary["prototype"]["kernel_launches"]
            == [3 * DEEPLAB_ROUTED_BLOCKS] * DDP_WORLD):
        raise AssertionError("ddp prototype: "
                             + json.dumps(summary["prototype"]))

    rc, output, seconds, stamps = deeplab_launch.result()
    lap("main_deeplab_2_ranks_wait")
    with open(os.path.join(root, "ddp_deeplab.log"), "w") as f:
        f.write(output)
    summary["main_deeplab"] = {
        "rc": rc, "seconds": seconds, "launch_stamps": stamps,
        "validation_lines": [len(_rank_lines(output, r, "validation..."))
                             for r in range(DDP_WORLD)],
        "replicas_line": bool(_rank_lines(output, 0, "replicas:")),
        "files": sorted(os.listdir(deeplab_dir)) if os.path.isdir(
            deeplab_dir) else []}
    log("ddp main_deeplab: " + json.dumps(summary["main_deeplab"]))
    if rc or summary["main_deeplab"]["validation_lines"] != [1, 0] or \
            not summary["main_deeplab"]["replicas_line"] or \
            summary["main_deeplab"]["files"] != ["best.pth", "latest.pth"]:
        raise AssertionError("main_deeplab over 2 ranks: "
                             + json.dumps(summary["main_deeplab"])
                             + "\n" + output[-4000:])

    # 2-3. train_embedding under torch.distributed.run: 2 ranks (gloo,
    # timed alone) and 1 rank (NCCL, above), then the plain run twice in
    # this process (timed alone, fp32, TF32 off)
    runs = {}
    nccl_result = nccl_launch.result()   # ended before the timed launch
    for name, world, result in (
            ("2_ranks_gloo", DDP_WORLD, train_embedding_launch(
                "2_ranks_gloo", DDP_WORLD, [])),
            ("1_rank_nccl", 1, nccl_result)):
        rc, output, seconds, stamps = result
        with open(os.path.join(root, f"ddp_{name}.log"), "w") as f:
            f.write(output)
        lap(f"train_embedding_{name}")
        if rc:
            raise AssertionError(f"train_embedding {name}: rc {rc}\n"
                                 + output[-4000:])
        s_per_step, steps = _metrics_s_per_step(
            os.path.join(root, f"ddp_{name}", "metrics.jsonl"))
        batch = world * load_config("configs/train_embedding.yaml") \
            .TRAIN.batch_size_per_gpu
        runs[name] = {
            "s_per_step": s_per_step, "imgs_per_s": batch / s_per_step,
            "global_batch": batch, "seconds": seconds,
            "launch_stamps": stamps, "metrics_steps": steps,
            "announced": _rank_lines(output, 0, "data parallel:"),
            "progress_lines": [len(_rank_lines(output, r, "Epoch:"))
                               for r in range(world)],
            "replicas_line": bool(_rank_lines(output, 0, "replicas:"))}
        if steps != list(range(1, DDP_CLI_STEPS + 1)) or \
                runs[name]["progress_lines"][1:] != [0] * (world - 1) or \
                runs[name]["progress_lines"][0] != DDP_CLI_STEPS or \
                (world > 1 and not runs[name]["replicas_line"]):
            raise AssertionError(f"train_embedding {name}: "
                                 + json.dumps(runs[name]))
    runs["1_rank_nccl"]["timed_beside_other_work"] = True
    backend = runs["1_rank_nccl"]["announced"]
    one_rank = "nccl" if DEVICE == "cuda" else "gloo"
    if not backend or f"backend {one_rank}" not in backend[0] or \
            "backend gloo" not in runs["2_ranks_gloo"]["announced"][0]:
        raise AssertionError(f"backends: {runs}")
    plain = {}
    saved = _tf32_off()
    try:
        for name in ("plain", "plain_again"):
            pcfg = load_config("configs/train_embedding.yaml", base + [
                "DIR", os.path.join(root, f"ddp_{name}")])
            plain[name], _ = counted(f"the {name} train run",
                                     lambda: train_embedding.main(
                                         pcfg, torch.float32,
                                         max_steps=DDP_CLI_STEPS,
                                         device=DEVICE))
    finally:
        _tf32_set(saved)
    lap("train_embedding_plain_twice")
    seconds = [e["seconds"] for e in plain["plain"]["log"]]
    runs["plain"] = {"s_per_step": float(np.median(np.diff(seconds)[1:])),
                     "global_batch": pcfg.TRAIN.batch_size_per_gpu}
    runs["plain"]["imgs_per_s"] = (runs["plain"]["global_batch"]
                                   / runs["plain"]["s_per_step"])
    start = {f"{part}.{k}": v for part in ("encoder", "decoder")
             for k, v in torch.load(weights[part == "decoder"],
                                    map_location="cpu").items()}
    ref = _pair_state(os.path.join(root, "ddp_plain"))
    with open(os.path.join(root, "ddp_1_rank_nccl", "metrics.jsonl")) as f:
        nccl_losses = [json.loads(line)["loss"] for line in f]
    plain_losses = [e["loss"] for e in plain["plain"]["log"]]
    runs["1_rank_nccl"].update(
        vs_plain=_update_distance(_pair_state(os.path.join(
            root, "ddp_1_rank_nccl")), ref, start),
        plain_again_vs_plain=_update_distance(_pair_state(os.path.join(
            root, "ddp_plain_again")), ref, start),
        losses=nccl_losses, plain_losses=plain_losses,
        first_loss_rel=abs(nccl_losses[0] - plain_losses[0])
        / abs(plain_losses[0]))
    summary["train_embedding"] = runs
    log("ddp train_embedding: " + json.dumps(runs))
    nccl = runs["1_rank_nccl"]
    bound = (DDP_F32_NOISE_RATIO * nccl["plain_again_vs_plain"]["norm_frac"]
             + DDP_F32_FLOOR)
    if nccl["vs_plain"]["norm_frac"] > bound or \
            not nccl["vs_plain"]["ints_equal"] or \
            nccl["first_loss_rel"] > DDP_NCCL_LOSS_RTOL:
        raise AssertionError("the one-rank NCCL run against the plain one: "
                             + json.dumps(nccl))

    # 5. the profiler around one fused StreetHazards forward
    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)

    model = build_anomaly_model(cfg, DEVICE, fused_blocks=True)
    init_or_load_variables(cfg, model)
    h, w = DDP_PROFILED_SIZE
    x = torch.randn(1, h, w, 3, device=DEVICE)
    trace_dir = os.path.join(root, "ddp_trace")
    with torch.inference_mode(), torch.autocast(DEVICE,
                                                dtype=torch.bfloat16):
        model(x, seg_size=(h, w))        # warm

        def traced():
            with profile_trace(trace_dir):
                with annotate("fused_forward"):
                    model(x, seg_size=(h, w))
        _, launches = counted("the profiled fused forward", traced,
                              {"fused_bottleneck": DDP_PROFILED_BLOCKS})
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    fused = [e for e in kernels if "phase_kernel" in e.get("name", "")]
    summary["profiler"] = {
        "kernel_events": len(kernels), "fused_kernel_events": len(fused),
        "fused_kernel_name": fused[0]["name"] if fused else None,
        "fused_kernel_us": sum(e.get("dur", 0) for e in fused),
        "annotated": any(e.get("name") == "fused_forward" for e in events),
        "launches": launches}
    log("ddp profiler: " + json.dumps(summary["profiler"]))
    if len(fused) != 3 * DDP_PROFILED_BLOCKS or \
            not summary["profiler"]["annotated"]:
        raise AssertionError("profiler: " + json.dumps(summary["profiler"]))
    lap("profiler")
    summary["part_seconds"] = laps
    summary["seconds"] = time.perf_counter() - phase_tic
    return summary


def main():
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    if sys.argv[1:2] == ["--ddp-worker"]:      # a rank of the ddp phase
        os.chdir(here)
        sys.path.insert(0, here)
        return ddp_worker(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    os.chdir(here)
    sys.path.insert(0, here)
    import open_world_semantic_segmentation_tpu_torch  # noqa: F401

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    gpu = gpu_name_and_power()
    log(gpu)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    tic = time.perf_counter()

    def phase(name, fn, *args):
        out = fn(*args)
        log(f"phase {name} done at {time.perf_counter() - tic:.1f} s")
        return out

    phase("build", build_kernels)
    kernels = [phase("knn kernel", kernel_phase),
               phase("fused kernel", fused_kernel_phase)]
    for kernel in kernels:
        log("kernel phase: " + json.dumps(kernel))
    with tempfile.TemporaryDirectory() as root:
        # first: its host-bound training loop runs 1.5x slower once the
        # other phases have run in this process
        golden, golden_launches = phase("golden", golden_phase, root)
        summaries, launches, cfg = phase("slice", slice_phase, root)
        street_rest = phase("street rest", street_rest_phase, root, cfg,
                            summaries["dissum_device_metrics"])
        serving, serve_launches = phase("serve", serve_phase, root, cfg)
        train = phase("train", train_phase, root,
                      (cfg.MODEL.weights_encoder, cfg.MODEL.weights_decoder))
        phase("device check", device_check, cfg)
        train_check = phase("train step check", train_step_check)
        deeplab, deeplab_launches = phase("deeplab", deeplab_phase, root)
        demo, demo_launches = phase("demo", demo_phase, root)
        cityscapes_rest = phase("cityscapes rest", cityscapes_rest_phase,
                                root)
        quantized, quant_knn_launches = phase(
            "quant", quant_phase, root, cfg,
            [os.path.join(root, "golden", "ckpt", f"{part}_epoch_1.pth")
             for part in ("encoder", "decoder")])
        training, (plm_launches, teacher_launches) = phase(
            "deeplab train", deeplab_train_phase, root)
        voc = phase("voc", voc_phase, root)
        ddp = phase("ddp", ddp_phase, root, cfg)
        zoo, zoo_launches = phase("zoo", zoo_phase, root, cfg)
    faulthandler.cancel_dump_traceback_later()
    # launches on the main path: knn_cosine in the knn run, fused_bottleneck
    # in the fused run (the runs that take each kernel's path)
    kernels[0]["launches"] = launches["knn"]["knn_cosine"]
    set_path_dtype(kernels[0], summaries.pop("knn_input_dtype"))
    kernels[1]["launches"] = launches["dissum_fused"]["fused_bottleneck"]
    kernels[1]["deeplab"]["launches"] = deeplab_launches
    kernels[1]["deeplab"]["demo_launches"] = demo_launches
    # the server's fused run: block calls and the kernel launches they
    # enqueued, both counted, and the kernel against its plain version on
    # the served forward's inputs
    kernels[1]["serve"].update(
        **serve_launches,
        max_abs_err=serving["fused"]["kernel_check"]["max_abs_err"])
    kernels[1]["deeplab"]["plm_eval_launches"] = plm_launches
    kernels[1]["distillation_teacher"]["launches"] = teacher_launches
    # the golden run: knn_cosine and fused_bottleneck on trained weights;
    # the zoo's fused runs, block calls per encoder
    kernels[0]["golden_launches"] = golden_launches["knn_cosine"]
    # the int8-hybrid knn eval on the golden weights
    kernels[0]["quant_launches"] = quant_knn_launches
    kernels[1]["golden_launches"] = golden_launches["fused_bottleneck"]
    for encoder, count in zoo_launches.items():
        kernels[1]["zoo"][encoder]["launches"] = count
    log(f"gpu: {gpu}; eval summaries: " + json.dumps(summaries))
    log(f"gpu: {gpu}; train: s/step {train['s_per_step_median']}, imgs/s "
        f"{train['imgs_per_s']}, loader wait s/step "
        f"{train['loader_wait_s_per_step']}, peak memory "
        f"{train['peak_memory_bytes']} bytes, skipped {train['skipped']}, "
        f"losses {[e['loss'] for e in train['per_step']]}; train step check "
        + json.dumps(train_check))
    log(f"gpu: {gpu}; the rest of the StreetHazards eval: "
        + json.dumps(street_rest))
    log(f"gpu: {gpu}; serve: " + json.dumps(serving))
    log(f"gpu: {gpu}; deeplab: " + json.dumps(deeplab))
    log(f"gpu: {gpu}; live demo: " + json.dumps(demo))
    log(f"gpu: {gpu}; the rest of the Cityscapes eval: "
        + json.dumps(cityscapes_rest))
    log(f"gpu: {gpu}; deeplab training: " + json.dumps(training))
    log(f"gpu: {gpu}; golden: " + json.dumps(golden, default=float))
    log(f"gpu: {gpu}; zoo: " + json.dumps(zoo))
    log(f"gpu: {gpu}; quant: " + json.dumps(quantized))
    log(f"gpu: {gpu}; voc: " + json.dumps(voc))
    log(f"gpu: {gpu}; ddp: " + json.dumps(ddp))
    log(f"total {time.perf_counter() - tic:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
