#!/usr/bin/env python3
"""Is the DeepLab train step reproducible on the card? The Cityscapes golden
recipe's model and data (deeplabv3plus_embedding_resnet101, crop 128,
batch 4, fp32 with TF32 off, the learnable synthetic tree of
``tools/make_synthetic_data.py``) trained for ``--steps`` steps twice from
one seed, first as ``cli/main_deeplab.py`` trains by default, then under
``tools/golden_run.py deterministic`` (``torch.use_deterministic_algorithms
(True)``); for each way it prints how many of the state dict's tensors
differ between the two runs, the largest difference, and each run's
s/step (the median step after the first ``WARMUP``, one sync a step), so
that the two ways are timed in one process on one card.

    python3 deeplab_determinism.py [--steps 20]

Needs a CUDA device; exits non-zero without one.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile

# cuBLAS reads it at its first call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# steps left out of the s/step median: the first compiles and warms up
WARMUP = 2


def train(root, workdir, steps, strict):
    """The state dict after ``steps`` steps, and the median s/step."""
    import numpy as np
    import torch

    from open_world_semantic_segmentation_tpu_torch.cli import main_deeplab
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        default_config)
    from open_world_semantic_segmentation_tpu_torch.tools import golden_run

    cfg = default_config()
    cfg.DIR = workdir
    cfg.DATASET.root_dataset = root
    cfg.DEEPLAB.model = "deeplabv3plus_embedding_resnet101"
    cfg.DEEPLAB.num_classes = 16
    cfg.DEEPLAB.crop_size = 128
    cfg.DEEPLAB.batch_size = 4
    cfg.DEEPLAB.lr = 0.05
    cfg.DEEPLAB.total_itrs = steps
    cfg.DEEPLAB.val_interval = steps
    cfg.DEEPLAB.random_seed = 0
    mode = golden_run.deterministic() if strict else contextlib.nullcontext()
    with golden_run.exact_fp32(), mode:
        log = main_deeplab.main(cfg, torch.float32, device="cuda",
                                log_every=1)["log"]
    ends = [e["seconds"] for e in log]
    s_per_step = float(np.median(np.diff(ends)[WARMUP - 1:]))
    return torch.load(os.path.join(workdir, "latest.pth"),
                      map_location="cpu")["model_state"], s_per_step


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("deeplab_determinism: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from open_world_semantic_segmentation_tpu_torch.tools import golden_run

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "cs")
        golden_run._synthetic_data().make_cityscapes_learnable(
            root, splits=("train", "val"), n=19, h=128, w=256, seed=0,
            noise=10.0)
        for strict in (False, True):
            (a, ta), (b, tb) = (
                train(root, os.path.join(tmp, f"{strict}{run}"), args.steps,
                      strict) for run in range(2))
            diff = [k for k in a if not torch.equal(a[k], b[k])]
            worst = max((float((a[k].double() - b[k].double()).abs().max())
                         for k in diff), default=0.0)
            print(json.dumps({"deterministic": strict, "steps": args.steps,
                              "tensors": len(a), "differ": len(diff),
                              "max_abs_diff": worst,
                              "s_per_step": [ta, tb],
                              "gpu": torch.cuda.get_device_name(0)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
