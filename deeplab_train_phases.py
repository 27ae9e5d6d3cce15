#!/usr/bin/env python3
"""Where the device time of the DeepLab training steps goes, on one CUDA
GPU.

    python3 deeplab_train_phases.py

The three train steps of the DeepLab slice at their configs' shapes, bf16
autocast over float32 parameters, channels_last, seeded random weights and
a random batch already on the card (no loader, no checkpoint):

- ``main_deeplab``: ``train/state.py DeepLabTrainStep`` (with the guard,
  as ``cli/main_deeplab.py`` runs it) on deeplabv3plus_embedding_resnet101,
  batch 8 of 768x768 (configs/cityscapes_embedding.yaml);
- ``self_distillation``: ``cli/self_distillation.py SelfDistillationStep``
  on the 16+1 two-head model, backbone and base head frozen, batch 5
  (configs/self_distillation.yaml);
- ``distillation``: ``cli/main_distillation.py DistillationStep``, the
  16-class teacher in eval mode and the 17-class student, batch 5.

For each: the device time of a step (CUDA events around 5 steps after 3
warm-ups) against the host's wall time of the same steps, with the ASPP's
dilated convs in the shift form (the port's default) and in cuDNN's
(``dilated_impl="native"``); then, for the default, torch.profiler's
kernels by device time over 2 steps and their sum. Prints one JSON object
per line, the card's name and power limit first.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import gpu_name_and_power  # noqa: E402
from open_world_semantic_segmentation_tpu_torch.cli import (  # noqa: E402
    main_distillation, self_distillation)
from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (  # noqa: E402,E501
    build_deeplab_model, frozen_heads, init_or_load_deeplab)
from open_world_semantic_segmentation_tpu_torch.core.config import (  # noqa: E402,E501
    load_config)
from open_world_semantic_segmentation_tpu_torch.train.optim import (  # noqa: E402,E501
    backbone_classifier_optimizer, poly_schedule)
from open_world_semantic_segmentation_tpu_torch.train.state import (  # noqa: E402,E501
    DeepLabTrainStep)

CROP = 768


def batch(n, gen, classes=16):
    """A random NHWC image batch and labels with 10 % ignored pixels and
    10 % support pixels (label 0), on the card."""
    image = torch.randn((n, CROP, CROP, 3), generator=gen, device="cuda")
    label = torch.randint(1, classes, (n, CROP, CROP), generator=gen,
                          device="cuda", dtype=torch.int32)
    u = torch.rand((n, CROP, CROP), generator=gen, device="cuda")
    label = torch.where(u < 0.1, 255, torch.where(u < 0.2, 0, label))
    return {"image": image.contiguous(), "label": label}


def model_for(cfg, dilated_impl, train=True):
    model, _ = build_deeplab_model(cfg, "cuda", dilated_impl=dilated_impl,
                                   train=train)
    return init_or_load_deeplab(model, seed=0)


def steps(name, dilated_impl):
    """The train step object of ``name`` and its batch."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    if name == "main_deeplab":
        cfg = load_config("configs/cityscapes_embedding.yaml")
        model = model_for(cfg, dilated_impl)
        opt = backbone_classifier_optimizer(
            model, lr=poly_schedule(0.1, cfg.DEEPLAB.total_itrs, 0.9,
                                    min_lr=1e-6), weight_decay=1e-4)
        return (DeepLabTrainStep(model, opt, guard=True),
                batch(cfg.DEEPLAB.batch_size, gen))
    cfg = load_config("configs/self_distillation.yaml")
    n = cfg.DEEPLAB.batch_size
    if name == "self_distillation":
        cfg.DEEPLAB.model = self_distillation.MODEL
        model = model_for(cfg, dilated_impl)
        opt = backbone_classifier_optimizer(
            model, lr=0.01, frozen_keys=frozen_heads(cfg))
        return (self_distillation.SelfDistillationStep(
            model, opt, novel_cls=1, base_classes=16), batch(n, gen))
    cfg.DEEPLAB.model = "deeplabv3plus_embedding_resnet101"
    teacher = model_for(cfg, dilated_impl, train=False).requires_grad_(False)
    cfg.DEEPLAB.num_classes = 17
    student = model_for(cfg, dilated_impl)
    opt = backbone_classifier_optimizer(student, lr=0.01)
    return (main_distillation.DistillationStep(student, teacher, opt,
                                               novel_id=16), batch(n, gen))


def device_time(step, data, iters=5, warmup=3):
    """(device ms, host wall ms) per step."""
    for _ in range(warmup):
        step(data)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    tic = time.perf_counter()
    start.record()
    for _ in range(iters):
        step(data)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - tic) * 1e3 / iters
    return start.elapsed_time(end) / iters, wall


def top_kernels(step, data, n=25, iters=2):
    """torch.profiler's kernels by device time over ``iters`` steps, per
    step, and the sum over all kernels; None where it records no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step(data)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted(events, key=device_us, reverse=True)
    total = sum(device_us(e) for e in rows) / 1e3 / iters
    if not rows or total == 0:
        return None
    return {"kernel_ms_per_step": total, "top": [
        {"name": e.key[:110], "calls_per_step": e.count / iters,
         "ms_per_step": device_us(e) / 1e3 / iters} for e in rows[:n]]}


def main():
    if not torch.cuda.is_available():
        print("deeplab_train_phases: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"gpu": gpu_name_and_power(),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    for name in ("main_deeplab", "self_distillation", "distillation"):
        for impl in ("shift", "native"):
            step, data = steps(name, impl)
            torch.cuda.reset_peak_memory_stats()
            ms, wall = device_time(step, data)
            row = {"step": name, "dilated_impl": impl,
                   "batch": int(data["image"].shape[0]),
                   "device_ms_per_step": ms, "wall_ms_per_step": wall,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated()}
            if impl == "shift":
                row["profile"] = top_kernels(step, data)
            print(json.dumps(row), flush=True)
            del step, data
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
