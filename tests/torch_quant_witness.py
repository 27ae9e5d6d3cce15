#!/usr/bin/env python
"""The int8 PTQ drift of the JAX package and of the port on the same
trained weights, on the CPU.

Trains the golden run's small CPU probe with the port
(``tools/golden_run.py run``: resnet18dilated + ppm_deepsup_embedding on
the learnable synthetic StreetHazards tree, fp32), then scores dissum on
its val split with the JAX package's ``cli/eval_ood.main`` and with the
port's (``tools/quant_drift.py drift``), without quant and in each mode,
each package calibrating its own scales on the same images. Prints each
package's runs and, as its last line, one JSON object with both and the
port-minus-JAX difference of every metric. The tree and the ``.pth`` pair
stay in ``--out``, for the same drift on the card:

    python tests/torch_quant_witness.py --out DIR [--steps 200]
    python -m open_world_semantic_segmentation_tpu_torch.tools.quant_drift \\
        --tree DIR/sh --weights DIR/ckpt/encoder_epoch_1.pth \\
        DIR/ckpt/decoder_epoch_1.pth --encoder resnet18dilated \\
        --img-sizes 64 72 80 88 96 --max-size 240 \\
        --modes int8 int8-3x3 int8-hybrid w4a8 --devices cuda cpu
"""

import argparse
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from open_world_semantic_segmentation_tpu.cli import (  # noqa: E402
    eval_ood as jax_eval_ood)
from open_world_semantic_segmentation_tpu.core.config import (  # noqa: E402
    Config as JaxConfig)
from open_world_semantic_segmentation_tpu_torch.tools import (  # noqa: E402
    golden_run, quant_drift)

ENCODER, FC_DIM = "resnet18dilated", 512
IMG_SIZES = (64, 72, 80, 88, 96)
MAX_SIZE = 240
MODES = ("int8", "int8-3x3", "int8-hybrid", "w4a8")


def jax_drift(tree, weights, calib_images, workdir):
    """``quant_drift.drift`` through the JAX package's eval main."""
    cfg = JaxConfig()
    cfg.DIR = workdir
    cfg.DATASET.root_dataset = tree
    cfg.DATASET.list_val = os.path.join(tree, "val.odgt")
    cfg.DATASET.num_class = 13
    cfg.DATASET.imgSizes = IMG_SIZES
    cfg.DATASET.imgMaxSize = MAX_SIZE
    cfg.MODEL.arch_encoder = ENCODER
    cfg.MODEL.arch_decoder = "ppm_deepsup_embedding"
    cfg.MODEL.fc_dim = FC_DIM
    cfg.MODEL.weights_encoder, cfg.MODEL.weights_decoder = weights
    cfg.OOD.ood = "dissum"
    runs = {}
    for mode in ("off",) + MODES:
        r = jax_eval_ood.main(cfg, jnp.float32, quant=mode,
                              calib_images=calib_images)
        run = {k: r[k] for k in quant_drift.METRICS}
        if mode != "off":
            run["drift"] = {k: run[k] - runs["off"][k]
                            for k in quant_drift.METRICS}
        runs[mode] = run
        print(f"[quant-witness] jax {mode}: {json.dumps(run)}", flush=True)
    return runs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--calib-images", type=int,
                    default=quant_drift.CALIB_IMAGES)
    args = ap.parse_args()
    torch.manual_seed(0)
    golden_run.run(encoder=ENCODER, steps=args.steps, img_size=80, h=96,
                   w=144, precision=torch.float32, methods=("dissum",),
                   workdir=args.out, device="cpu")
    tree = os.path.join(args.out, "sh")
    weights = [os.path.join(args.out, "ckpt", f"{part}_epoch_1.pth")
               for part in ("encoder", "decoder")]
    cfg = quant_drift.eval_cfg(tree, weights, encoder=ENCODER,
                               img_sizes=IMG_SIZES, max_size=MAX_SIZE)
    cfg.MODEL.fc_dim = FC_DIM
    cfg.DIR = os.path.join(args.out, "eval_port")
    port = quant_drift.drift(cfg, "cpu", MODES, args.calib_images)
    jax_runs = jax_drift(tree, weights, args.calib_images,
                         os.path.join(args.out, "eval_jax"))
    print(json.dumps({
        "port": port, "jax": jax_runs,
        "port_minus_jax": {m: {k: port[m][k] - jax_runs[m][k]
                               for k in quant_drift.METRICS}
                           for m in port}}))


if __name__ == "__main__":
    main()
