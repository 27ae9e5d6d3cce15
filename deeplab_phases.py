#!/usr/bin/env python3
"""Split the 1024x2048 forward of the NPM eval's model by module, on one
CUDA GPU.

    python3 deeplab_phases.py

Builds deeplabv3plus_embedding_resnet101 (OS16, 16 classes, seeded random
weights: the times do not depend on them), channels_last on the card, and
runs its forward on one 1024x2048 image under bf16 autocast, as
``cli/eval_embedding.py`` does. CUDA events recorded by module hooks split
the device time into segments in forward order: the stem (7x7 conv, BN,
ReLU, max pool), layer1-4, the low-level projection, the ASPP's five
branches (1x1, rates 6, 12, 18, the image pool with the concat), its 1x1
projection, the upsample and concat before the decoder, the decoder (3x3
fuse and classifier), and the wrapper's upsample to 1024x2048 with the
distance head. Each timed forward is queued behind an untimed one, so the
segments are device time (the ASPP's slow convs, 0.25 s, give the host
the lead). Medians of 5 forwards after 2 warm-ups, for four variants:
``torch.backends.cudnn.benchmark`` off (the port's setting) and on, each
unfused and with ``fused_blocks=True``. Then ``torch.profiler``'s top
kernels by device time for the first variant, where it sees the device.
Last, the ASPP's dilated 3x3 conv (2048 -> 256 on the 64x128 layer4 map)
at each rate, in channels_last (the port's layout) and NCHW-contiguous,
each in bf16, float32 with TF32 off and float32 with TF32 on, timed three
ways: cuDNN's dilated conv with ``cudnn.benchmark`` off and on, and the
same function as nine shifted 1x1 products summed in float32 (the
formulation of the JAX package's ``ops/dilated.py``), with the largest
difference between them.
Prints one JSON object per line, the card's name and power limit first,
then the forward's conv TFLOP by part (counted from the conv shapes).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import (  # noqa: E402
    build_kernels, cuda_time_ms, gpu_name_and_power)
from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (  # noqa: E402,E501
    build_deeplab_model, build_model, init_or_load_deeplab)
from open_world_semantic_segmentation_tpu_torch.core.config import (  # noqa: E402,E501
    load_config)

SIZE = (1024, 2048)
# (segment, module whose pre-hook starts it); each segment ends where the
# next starts, the last at the end of the forward
STARTS = (
    ("stem", "backbone", "pre"),
    ("layer1", "backbone.layer1", "pre"),
    ("layer2", "backbone.layer2", "pre"),
    ("layer3", "backbone.layer3", "pre"),
    ("layer4", "backbone.layer4", "pre"),
    ("low-level project", "classifier.project", "pre"),
    ("aspp 1x1", "classifier.aspp.convs.0", "pre"),
    ("aspp rate 6", "classifier.aspp.convs.1", "pre"),
    ("aspp rate 12", "classifier.aspp.convs.2", "pre"),
    ("aspp rate 18", "classifier.aspp.convs.3", "pre"),
    ("aspp pool + concat", "classifier.aspp.convs.4", "pre"),
    ("aspp project", "classifier.aspp.project", "pre"),
    ("upsample + concat", "classifier.aspp.project", "post"),
    ("decoder fuse + classifier", "classifier.classifier", "pre"),
    ("upsample to input + distance head", "classifier.classifier", "post"),
)


def segment_times(model, x, iters=5, warmup=2):
    """Median device ms of each segment over ``iters`` forwards. Each timed
    forward is queued right behind an untimed one, so that the host has
    queued its work before the device reaches it: the segments are device
    time, not the host's dispatch."""
    modules = dict(model.named_modules())
    marks = []
    hooks = []
    timing = [False]
    for name, module, when in STARTS:
        def mark(*_, name=name):
            if not timing[0]:
                return
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        m = modules[module]
        hooks.append(m.register_forward_pre_hook(mark) if when == "pre"
                     else m.register_forward_hook(mark))
    rows = []
    try:
        for i in range(warmup + iters):
            marks.clear()
            with torch.inference_mode(), torch.autocast(
                    "cuda", dtype=torch.bfloat16):
                timing[0] = False
                model(x)
                timing[0] = True
                model(x)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            if i < warmup:
                continue
            names = [n for n, _ in marks]
            if names != [n for n, _, _ in STARTS]:
                raise AssertionError(f"segments out of order: {names}")
            evs = [e for _, e in marks] + [end]
            rows.append([a.elapsed_time(b) for a, b in zip(evs, evs[1:])])
    finally:
        for h in hooks:
            h.remove()
    med = np.median(np.asarray(rows), axis=0)
    out = {n: float(v) for (n, _, _), v in zip(STARTS, med)}
    out["total"] = float(np.median(np.asarray(rows).sum(1)))
    return out


def top_kernels(model, x, n=15):
    """torch.profiler's kernels by device time over one forward, or None
    where it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode(), torch.autocast(
                "cuda", dtype=torch.bfloat16):
            model(x)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted(events, key=device_us, reverse=True)[:n]
    if not rows or device_us(rows[0]) == 0:
        return None
    return [{"name": e.key[:90], "calls": e.count,
             "device_ms": device_us(e) / 1e3} for e in rows]


def conv_tflops(size=SIZE):
    """TFLOP of the forward's convolutions at ``size`` (2 per
    multiply-add), by part, from the model's conv shapes on the meta
    device."""
    cfg = load_config("configs/cityscapes_embedding.yaml")
    with torch.device("meta"):
        model, _ = build_model(cfg)
    flops = {}

    def count(part):
        def hook(conv, _, out):
            k = conv.kernel_size[0] * conv.kernel_size[1]
            flops[part] = flops.get(part, 0.0) + (
                2.0 * out.numel() * k * conv.in_channels // conv.groups)
        return hook
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            part = ("backbone" if name.startswith("backbone.") else
                    "aspp" if ".aspp." in name else
                    "decoder fuse" if name == "classifier.classifier.0"
                    else "head, other")
            m.register_forward_hook(count(part))
    with torch.no_grad():
        model.eval()(torch.zeros((1, *size, 3), device="meta"))
    out = {k: v / 1e12 for k, v in flops.items()}
    out["total"] = sum(flops.values()) / 1e12
    return out


# (layout, precision) of the dilated conv probe: the port's channels_last
# bf16 and the NCHW-contiguous layout, each in bf16, float32 with TF32 off
# and float32 with TF32 on
CONV_WAYS = tuple((layout, precision)
                  for layout in ("channels_last", "nchw")
                  for precision in ("bf16", "fp32", "tf32"))


def dilated_conv_ways(rates=(6, 12, 18), shape=(1, 2048, 64, 128),
                      cout=256):
    """ms of the ASPP's 3x3 conv at each rate, for each of ``CONV_WAYS``:
    cuDNN (benchmark off, on) and as nine shifted 1x1 products."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    x32 = torch.randn(shape, generator=gen, device="cuda")
    w32 = (torch.randn((cout, shape[1], 3, 3), generator=gen, device="cuda")
           / (9 * shape[1]) ** 0.5)
    h, wd = shape[2:]
    rows = []
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    for layout, precision in CONV_WAYS:
        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        fmt = (torch.channels_last if layout == "channels_last"
               else torch.contiguous_format)
        x = x32.to(dtype).contiguous(memory_format=fmt)
        w = w32.to(dtype).contiguous(memory_format=fmt)
        taps = [w[:, :, i, j].t().contiguous() for i in range(3)
                for j in range(3)]                   # (Cin, Cout) each
        tf32 = precision == "tf32"
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for r in rates:
            def cudnn():
                return F.conv2d(x, w, padding=r, dilation=r)

            xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, r, r, r, r))   # NHWC

            def shifted():
                acc = None
                for k, tap in enumerate(taps):
                    i, j = divmod(k, 3)
                    t = torch.matmul(
                        xp[:, i * r:i * r + h, j * r:j * r + wd], tap).float()
                    acc = t if acc is None else acc + t
                return acc.to(dtype)
            want = cudnn().float().permute(0, 2, 3, 1)
            err = float((shifted().float() - want).abs().max())
            row = {"layout": layout, "precision": precision, "rate": r,
                   "max_abs_diff": err, "max_abs": float(want.abs().max())}
            for benchmark in (False, True):
                torch.backends.cudnn.benchmark = benchmark
                row[f"cudnn_ms_benchmark_{benchmark}".lower()] = \
                    cuda_time_ms(cudnn, iters=5)
            torch.backends.cudnn.benchmark = False
            row["shifted_1x1_ms"] = cuda_time_ms(shifted, iters=10)
            rows.append(row)
            print(json.dumps({"aspp_dilated_conv": row}), flush=True)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags
    return rows


def main():
    if not torch.cuda.is_available():
        print("deeplab_phases: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"gpu": gpu_name_and_power(),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    print(json.dumps({"conv_tflops": conv_tflops()}), flush=True)
    build_kernels()
    cfg = load_config("configs/cityscapes_embedding.yaml")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, *SIZE, 3), generator=gen, device="cuda")
    first = None
    for benchmark in (False, True):
        torch.backends.cudnn.benchmark = benchmark
        for fused in (False, True):
            model, _ = build_deeplab_model(cfg, "cuda", fused_blocks=fused)
            init_or_load_deeplab(model, seed=0)
            times = segment_times(model, x)
            print(json.dumps({"cudnn_benchmark": benchmark,
                              "fused_blocks": fused, "ms": times}),
                  flush=True)
            if first is None:
                first = model
    torch.backends.cudnn.benchmark = False
    print(json.dumps({"top_kernels_unfused_benchmark_off":
                      top_kernels(first, x)}), flush=True)
    dilated_conv_ways()
    return 0


if __name__ == "__main__":
    sys.exit(main())
