"""The port's golden convergence tool's Cityscapes NPM shape, end to end
on the CPU, as plumbing: 3 base-train steps of the MobileNet embedding
model (the cheapest 16-class embedding model) on a 48x160 learnable tree,
the k-shot car prototypes, the NPM eval and the no-override eval. It
checks the report's keys, that its numbers are finite, that a prototype
was extracted and that the base head alone predicts no car. The
convergence gates are a card run (``chip_smoke.py``'s golden phase).
"""

import numpy as np
import torch

from open_world_semantic_segmentation_tpu_torch.tools import golden_run


def test_golden_cityscapes_plumbing_on_cpu(tmp_path):
    report = golden_run.run_cityscapes(
        model="deeplabv3plus_embedding_mobilenet", steps=3, bs=2, lr=0.01,
        crop=48, h=48, w=160, n_train=6, n_val=2, workdir=str(tmp_path),
        precision=torch.float32, device="cpu")
    assert set(report) == {"train", "prototypes", "npm", "no_override",
                           "criteria"}
    assert report["train"]["steps"] == 3
    assert report["prototypes"] >= 1
    assert np.isfinite([*report["npm"].values(),
                        *report["no_override"].values()]).all()
    # the base head alone has no class 16
    assert report["no_override"]["novel_iou"] == 0.0


