"""The port's ``cli/eval_ood`` main with ``quant="int8-hybrid"`` against
the JAX package's main, on the synthetic StreetHazards tree of
``test_torch_eval.py`` (3 images, a 2-level pyramid of 32 and 48 pixels),
full-width resnet18dilated + ppm_deepsup_embedding, fp32 on the CPU.

The port's seeded weights get a data-dependent start on the tree (BN
statistics from a train-mode forward of both levels, the embedding scaled
to a std of 0.8) and go to a ``.pth`` pair that both mains load, the JAX
one through its own reader of the reference's checkpoints. Each main
calibrates its int8 scales on the smallest and largest level of the first
2 val images and prequantizes its weights, then evaluates dissum.

Tolerance: AUROC, AUPR and mIoU within 0.02 of the JAX main's (each
package rounds its activations to the int8 grid after float layers that
sum in another order, so a value on a rounding boundary may land one step
apart); every metric finite.
"""

import numpy as np
import torch

from open_world_semantic_segmentation_tpu.cli import eval_ood as jax_eval_ood
from open_world_semantic_segmentation_tpu.core.config import (
    load_config as jax_load_config)
from open_world_semantic_segmentation_tpu_torch.cli import eval_ood
from open_world_semantic_segmentation_tpu_torch.cli._common import (
    build_anomaly_model, init_or_load_variables)
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.data.odgt import ValPipeline
from open_world_semantic_segmentation_tpu_torch.ops.quant import int8_conv2d
from test_torch_eval import IMG_SIZES, METRICS, street_tree  # noqa: F401

N_IMAGES, N_CALIB = 3, 2
TOL = 0.02


def _opts(root, odgt, enc_path="", dec_path=""):
    return ["DATASET.root_dataset", root, "DATASET.list_val", odgt,
            "DATASET.imgSizes", str(IMG_SIZES), "MODEL.arch_encoder",
            "resnet18dilated", "MODEL.arch_decoder",
            "ppm_deepsup_embedding", "MODEL.fc_dim", "512",
            "MODEL.weights_encoder", enc_path,
            "MODEL.weights_decoder", dec_path, "OOD.ood", "dissum"]


def _started_pair(root, odgt, tmp_path):
    cfg = load_config("configs/test_ood_street.yaml", _opts(root, odgt))
    model = init_or_load_variables(cfg, build_anomaly_model(cfg, "cpu"),
                                   seed=3)
    items = list(ValPipeline(root, odgt, img_sizes=IMG_SIZES))
    seg_size = items[0]["seg_label"].shape[1:3]
    levels = [torch.from_numpy(np.concatenate([it["img_data"][lvl]
                                               for it in items]))
              for lvl in range(len(IMG_SIZES))]
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
    with torch.no_grad():
        for img in levels:
            model.train()(img, seg_size=seg_size)
        std = torch.cat([model.eval()(img, seg_size=seg_size)["ft"]
                         for img in levels]).std().item()
        head = model.decoder.conv_last[4]
        head.weight.mul_(0.8 / std)
        head.bias.mul_(0.8 / std)
    paths = str(tmp_path / "enc.pth"), str(tmp_path / "dec.pth")
    torch.save(model.encoder.state_dict(), paths[0])
    torch.save(model.decoder.state_dict(), paths[1])
    return paths


def test_eval_ood_int8_hybrid_matches_jax(street_tree, tmp_path):
    root, odgt = street_tree
    opts = _opts(root, odgt, *_started_pair(root, odgt, tmp_path))
    # on the CPU the int8 conv is its plain version: no CUDA call counted
    calls = int8_conv2d.calls
    got = eval_ood.main(load_config("configs/test_ood_street.yaml", opts),
                        max_images=N_IMAGES, device="cpu",
                        quant="int8-hybrid", calib_images=N_CALIB)
    assert int8_conv2d.calls == calls
    want = jax_eval_ood.main(
        jax_load_config("configs/test_ood_street.yaml", opts),
        max_images=N_IMAGES, quant="int8-hybrid", calib_images=N_CALIB)
    for key in METRICS:
        assert np.isfinite(got[key]), key
    for key in ("auroc", "aupr", "mean_iou"):
        assert abs(got[key] - want[key]) <= TOL, (key, got[key], want[key])
