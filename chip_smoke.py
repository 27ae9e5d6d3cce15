#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (H100): kernels and the
StreetHazards open-set eval, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel of the path from ``csrc/`` with nvcc (timed set-up);
3. kernel phase: each kernel's wrapper against its plain PyTorch version on
   the card at the eval path's shapes (float32, atol 2e-5), then timed with
   CUDA events beside its plain version and its bound;
4. slice phase: a synthetic StreetHazards tree of 720x1280 images, a
   full-width resnet50dilated + ppm_deepsup_embedding with seeded random
   weights, ``cli.eval_ood.main`` on cuda in bf16 with OOD.ood dissum and
   then knn; launch counts are zeroed just before each run and read just
   after; every metric must be finite; each run's wall time per image is
   split into the device batch, the host metric sweep and loader waits;
5. device check: one small image through the full-width model in fp32 with
   TF32 off, on cuda and on the CPU; the score maps must agree.

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
PEAK_BYTES = 3.35e12            # HBM3
KNN_ATOL = 2e-5                 # as tests/test_pallas.py holds the TPU kernel
DEVICE_CHECK_RTOL = 1e-3        # of the largest |score|: fp32, TF32 off,
#                                 cuDNN vs CPU conv summation orders
N_IMAGES = 16
FULL_SIZE = (720, 1280)
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


def knn_cosine_bound_ms(h, w, c):
    """(operations ms, bytes ms): the least time for the knn map of an
    (h, w, c) float32 feature map, from its minimal work.

    The map is linear in the neighbours, out[p] = f_p . S_p with S_p the
    sum of the normalised neighbours, and S_p is two offset k x k box sums
    per channel (k = neighbor_size - 1), whatever k is. Per pixel and
    channel: normalisation 3 flops (square, add, scale), a separable sliding
    box sum 4 (add and subtract along W, then along H), the two boxes
    combined 1, the dot product 2; per pixel 3 more (sqrt, max,
    reciprocal). Bytes: the features read once and the map written once.
    """
    ops = h * w * (10 * c + 3)
    nbytes = 4 * h * w * c + 4 * h * w
    return ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


# ---------------------------------------------------------------------------
def kernel_phase():
    """knn_cosine (the CUDA kernel) vs knn_cosine_plain on the card."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.ops import _build, knn

    tic = time.perf_counter()
    _build.build("knn_cosine.cu")
    log(f"build: knn_cosine.cu in {time.perf_counter() - tic:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = 0.0
    for shape, ns in (((720, 1280, 13), 9), ((45, 80, 13), 9),
                      ((9, 17, 4), 9), ((64, 128, 19), 3)):
        ft = torch.randn(shape, generator=gen, device="cuda")
        got = knn.knn_cosine(ft, ns)
        torch.cuda.synchronize()
        want = knn.knn_cosine_plain(ft, ns)
        err = (got - want).abs().max().item()
        log(f"knn_cosine {shape} neighbor_size {ns}: max |err| {err:.3g}")
        if not err <= KNN_ATOL:
            raise AssertionError(f"knn_cosine disagrees at {shape}: {err}")
        max_err = max(max_err, err)
    zero = knn.knn_cosine(torch.zeros((720, 1280, 13), device="cuda"))
    if torch.count_nonzero(zero).item() != 0:
        raise AssertionError("knn_cosine of zero features is not 0")

    # timing at the eval path's shape
    h, w, c = 720, 1280, 13
    halo = 8
    ft = torch.randn((h, w, c), generator=gen, device="cuda")
    fn = knn.normalize_features(ft).contiguous()
    out = torch.empty((h, w), device="cuda")
    lib = knn._library()
    stream = torch.cuda.current_stream().cuda_stream
    if lib.knn_cosine_f32(fn.data_ptr(), out.data_ptr(), h, w, c, halo,
                          stream) != 0:
        raise RuntimeError("knn_cosine_f32 launch failed")
    ms = cuda_time_ms(lambda: knn.knn_cosine(ft))
    kernel_ms = cuda_time_ms(lambda: lib.knn_cosine_f32(
        fn.data_ptr(), out.data_ptr(), h, w, c, halo, stream))
    plain_ms = cuda_time_ms(lambda: knn.knn_cosine_plain(ft), iters=5)
    t_ops, t_bytes = knn_cosine_bound_ms(h, w, c)
    return {
        "name": "knn_cosine",
        "route": "cuda",
        "source": "open_world_semantic_segmentation_tpu_torch/csrc/"
                  "knn_cosine.cu",
        "replaces": "open_world_semantic_segmentation_tpu/ops/"
                    "pallas_knn.py:87",
        "launches": None,                       # filled from the main path
        "max_abs_err": max_err,
        "ms": ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,   # no single PyTorch call computes this map
        "shape": [h, w, c],
    }


# ---------------------------------------------------------------------------
def write_street_tree(root, n, size, seed):
    """StreetHazards-format tree: blocky class-coloured RGB images with
    noise, L-mode labels 1..13 and an anomaly blob (raw 14)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    palette = rng.integers(0, 255, (15, 3))
    records = []
    for i in range(n):
        lab = np.full((h, w), 1 + i % 13, np.uint8)
        for _ in range(12):
            r0, c0 = rng.integers(0, h - h // 10), rng.integers(0, w - w // 10)
            lab[r0:r0 + rng.integers(h // 15, h // 2),
                c0:c0 + rng.integers(w // 15, w // 2)] = rng.integers(1, 14)
        bh, bw = h // 4, w // 5
        r0, c0 = rng.integers(0, h - bh), rng.integers(0, w - bw)
        lab[r0:r0 + bh, c0:c0 + bw] = 14
        img = palette[lab] + rng.normal(0, 20, (h, w, 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        ip, ap = f"images/test/t1/{i}.png", f"annotations/test/t1/{i}.png"
        for p, arr, mode in ((ip, img, "RGB"), (ap, lab, "L")):
            os.makedirs(os.path.dirname(os.path.join(root, p)),
                        exist_ok=True)
            Image.fromarray(arr, mode).save(os.path.join(root, p))
        records.append({"fpath_img": ip, "fpath_segm": ap, "height": h,
                        "width": w})
    odgt = os.path.join(root, "test.odgt")
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
    from open_world_semantic_segmentation_tpu_torch.ops.knn import knn_cosine

    odgt = write_street_tree(root, N_IMAGES, FULL_SIZE, SEED)
    cfg = load_config("configs/test_ood_street.yaml", [
        "DATASET.root_dataset", root, "DATASET.list_val", odgt])
    enc, dec = write_random_checkpoint(cfg, root, SEED)
    cfg.MODEL.weights_encoder, cfg.MODEL.weights_decoder = enc, dec

    # warm-up (CUDA context, cuDNN heuristics, lazy module loading): the
    # first images of a process otherwise take seconds, not milliseconds
    cfg.OOD.ood = "dissum"
    eval_ood.main(cfg, torch.bfloat16, max_images=2, batch_images=2,
                  device=DEVICE)

    summaries = {}
    launches = {}
    for method in ("dissum", "knn"):
        cfg.OOD.ood = method
        knn_cosine.launches = 0
        result = eval_ood.main(cfg, torch.bfloat16, batch_images=2,
                               device=DEVICE)
        launches[method] = knn_cosine.launches
        n = result["images"]
        summary = {k: result[k] for k in ("mean_iou", "accuracy", "auroc",
                                          "aupr", "fpr")}
        # the loop's wall time per image, split: device batch, host metric
        # sweep, waits on the prefetch thread, and the rest
        split = {"forward_s_per_img": result["inference_time"],
                 "metric_s_per_img": result["metric_time"],
                 "wait_s_per_img": result["wait_time"]}
        split["other_s_per_img"] = result["seconds"] / n - sum(split.values())
        summary.update(images=n, seconds=result["seconds"],
                       imgs_per_s=n / result["seconds"], **split,
                       knn_launches=launches[method])
        log(f"eval_ood {method}: " + json.dumps(summary))
        if n != N_IMAGES:
            raise AssertionError(f"{method}: evaluated {n} images")
        for key, value in summary.items():
            if value is None or not np.isfinite(value):
                raise AssertionError(f"{method}: {key} = {value}")
        summaries[method] = summary
    if launches["knn"] != N_IMAGES or launches["dissum"] != 0:
        raise AssertionError(f"knn_cosine launches {launches}, want "
                             f"{N_IMAGES} on knn and 0 on dissum")
    summaries["device_forward_ms_per_img"] = device_forward_ms(cfg)
    log(f"device forward, 5 scales, batch 1: "
        f"{summaries['device_forward_ms_per_img']:.2f} ms/img")
    return summaries, launches["knn"], cfg


def device_forward_ms(cfg):
    """CUDA-event time of the model's 5-scale forward of one image (bf16),
    without data movement, scoring or metrics."""
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.data.odgt import (
        ValPipeline)
    from open_world_semantic_segmentation_tpu_torch.openset.evaluator import (
        multi_scale_forward)

    model = init_or_load_variables(cfg, build_anomaly_model(cfg, DEVICE))
    item = ValPipeline(cfg.DATASET.root_dataset, cfg.DATASET.list_val,
                       img_sizes=cfg.DATASET.imgSizes)[0]
    pyramid = [torch.from_numpy(p).to(DEVICE) for p in item["img_data"]]
    seg_size = item["seg_label"].shape[1:3]

    def forward():
        with torch.inference_mode(), torch.autocast(DEVICE,
                                                    dtype=torch.bfloat16):
            multi_scale_forward(model, pyramid, seg_size)

    return cuda_time_ms(forward, iters=10)


# ---------------------------------------------------------------------------
def device_check(cfg):
    """The full-width model of ``cfg`` in fp32, TF32 off, on cuda and on the
    CPU, over a 64x96 crop of the first eval image."""
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
    outs = {}
    for device in (DEVICE, "cpu"):
        model = init_or_load_variables(cfg, build_anomaly_model(cfg, device))
        with torch.no_grad():
            out = model(torch.from_numpy(x).to(device), seg_size=(64, 96))
        outs[device] = {k: v.float().cpu().numpy() for k, v in out.items()}
    for key in ("scores", "ft"):
        a, b = outs[DEVICE][key], outs["cpu"][key]
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        log(f"device check {key}: max |cuda - cpu| {err:.3g} "
            f"(max |cpu| {scale:.3g})")
        if not err <= DEVICE_CHECK_RTOL * scale:
            raise AssertionError(f"cuda and cpu {key} disagree: {err}")
    same = float((outs[DEVICE]["scores"].argmax(-1)
                  == outs["cpu"]["scores"].argmax(-1)).mean())
    log(f"device check argmax agreement {same:.5f}")
    if same < 0.99:
        raise AssertionError(f"argmax agreement {same}")


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
    kernel = kernel_phase()
    log("kernel phase: " + json.dumps(kernel))
    with tempfile.TemporaryDirectory() as root:
        summaries, knn_launches, cfg = slice_phase(root)
        device_check(cfg)
    kernel["launches"] = knn_launches
    log(f"gpu: {gpu}; eval summaries: " + json.dumps(summaries))
    log(f"total {time.perf_counter() - tic:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
