#!/usr/bin/env python3
"""How far bf16 carries the DeepLab embedding model from fp32, stage by
stage, beside how far one rounding of its input carries it.

    python3 deeplab_bf16_drift.py                 # on the card, 1024x2048
    python3 deeplab_bf16_drift.py --device cpu --size 256 512

Builds ``chip_smoke.py``'s synthetic Cityscapes tree and its data-started
checkpoint of deeplabv3plus_embedding_resnet101 (seeded random weights, BN
statistics from eight val images, the last conv scaled so that each
embedding channel has std 0.8). Then runs the first val image through the
model three ways: fp32 with TF32 off (the reference), under bf16
autocast, and fp32 on the input times
(1 + 2^-9 n), n standard normal (about one bf16 rounding of the input and
nothing else). For the stem, every bottleneck, the ASPP, the head's
embedding and the outputs (upsampled features and distance logits) it
prints one JSON line per stage: each way's largest |difference| over the
largest |reference| (``max_rel``), root-mean-square difference over the
reference's (``rms_rel``), and for the outputs the argmax agreement.
Where the perturbed fp32 forward moves as far as the bf16 one, the
distance comes from the weights' sensitivity, not from bf16 arithmetic.
The card's name and power limit come first on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402
from chip_smoke import distance  # noqa: E402
from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (  # noqa: E402,E501
    build_deeplab_model, get_transforms, get_val_dataset,
    init_or_load_deeplab)
from open_world_semantic_segmentation_tpu_torch.core.config import (  # noqa: E402,E501
    load_config)
from open_world_semantic_segmentation_tpu_torch.models.resnet import (  # noqa: E402,E501
    Bottleneck)


def stages(model):
    """(name, module) of the stages whose outputs are compared, in forward
    order."""
    named = dict(model.named_modules())
    out = [("stem", named["backbone.relu"])]
    out += [(name, m) for name, m in model.backbone.named_modules()
            if isinstance(m, Bottleneck)]
    out += [("aspp", named["classifier.aspp"]),
            ("embedding", named["classifier"])]
    return out


def forward_with_stages(model, x, autocast):
    """The model's (logits, centers, features) on ``x`` and each stage's
    output (a copy, in float32)."""
    seen = {}
    hooks = [m.register_forward_hook(
        lambda _, __, out, name=name: seen.__setitem__(
            name, out.detach().float().clone()))
        for name, m in stages(model)]
    with torch.no_grad(), torch.autocast(x.device.type, dtype=torch.bfloat16,
                                         enabled=autocast):
        out = model(x)
    for hook in hooks:
        hook.remove()
    return out, seen


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", type=int, nargs=2,
                   default=list(chip_smoke.CITYSCAPES_SIZE))
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("deeplab_bf16_drift: no CUDA device", file=sys.stderr)
            return 1
        print(json.dumps({"gpu": chip_smoke.gpu_name_and_power()}))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    chip_smoke.DEVICE = args.device
    os.chdir(Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory() as root:
        tree = os.path.join(root, "cityscapes")
        # the deeplab phase's tree and checkpoint
        chip_smoke.write_cityscapes_tree(
            tree, {"train": chip_smoke.N_SUPPORT_IMAGES,
                   "val": chip_smoke.N_VAL_IMAGES}, tuple(args.size),
            chip_smoke.SEED + 2)
        cfg = load_config("configs/cityscapes_embedding.yaml",
                          ["DATASET.root_dataset", tree])
        weights = chip_smoke.write_deeplab_checkpoint(
            cfg, os.path.join(root, "deeplab_embedding.pth"),
            chip_smoke.SEED)
        model, _ = build_deeplab_model(cfg, args.device)
        init_or_load_deeplab(model, weights)
        ds = get_val_dataset(cfg, get_transforms(cfg.DEEPLAB.crop_size)[1])
        x = torch.from_numpy(ds[0][0][None]).to(args.device)
        gen = torch.Generator(device=args.device).manual_seed(chip_smoke.SEED)
        noise = torch.randn(x.shape, generator=gen, device=args.device)
        ref, ref_st = forward_with_stages(model, x, False)
        low, low_st = forward_with_stages(model, x, True)
        per, per_st = forward_with_stages(model, x * (1 + 2.0 ** -9 * noise),
                                          False)
        for name, _ in stages(model):
            print(json.dumps({
                "stage": name, "max_abs": float(ref_st[name].abs().max()),
                "bf16": distance(low_st[name], ref_st[name], argmax=False),
                "fp32_input_rounded": distance(per_st[name], ref_st[name],
                                               argmax=False)}))
        for name, i in (("features", 2), ("logits", 0)):
            print(json.dumps({
                "stage": name, "max_abs": float(ref[i].abs().max()),
                "bf16": distance(low[i], ref[i]),
                "fp32_input_rounded": distance(per[i], ref[i])}))
        print(json.dumps({"size": args.size, "device": args.device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
