"""The port's golden convergence tool, end to end on the CPU, as plumbing:
3 train steps on a 48x64 learnable StreetHazards tree (resnet50dilated +
ppm_deepsup_embedding, the flagship pair, so that the fused route has
Bottleneck blocks to take) and every scoring run of the report
(``test_torch_golden_cityscapes.py`` runs the Cityscapes NPM shape). It
checks the report's keys, that its numbers are finite, and that the knn
run and the fused run reach their kernels' code (on the CPU, the plain
versions). The convergence itself is a card run (``chip_smoke.py``'s
golden phase: 2000 steps, the JAX package's gates).
"""

import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu_torch.ops import fused_block
from open_world_semantic_segmentation_tpu_torch.openset import scoring
from open_world_semantic_segmentation_tpu_torch.tools import golden_run

KEYS = ("auroc", "aupr", "fpr", "mean_iou", "accuracy")


def _finite(values):
    return all(v is not None and np.isfinite(v) for v in values)


def test_golden_run_plumbing_on_cpu(tmp_path, monkeypatch):
    calls = {"knn": 0, "fused": 0}
    knn, plain = scoring.knn_cosine, fused_block.fused_bottleneck_plain

    def knn_spy(*args, **kwargs):
        calls["knn"] += 1
        return knn(*args, **kwargs)

    def plain_spy(*args, **kwargs):
        calls["fused"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(scoring, "knn_cosine", knn_spy)
    monkeypatch.setattr(fused_block, "fused_bottleneck_plain", plain_spy)
    report = golden_run.run(
        steps=3, bs=2, lr=0.01, img_size=48, h=48, w=64, n_train=4,
        n_val=2, workdir=str(tmp_path), precision=torch.float32,
        device="cpu")
    names = ("dissum", "msp", "knn", "dissum_fused", "dissum_bf16",
             "msp_bf16")
    assert set(report) == {"train", *names, "bf16_drift", "criteria"}
    assert report["train"]["steps"] == 3
    assert report["train"]["skipped"] == 0
    for name in names:
        assert set(report[name]) == set(KEYS), name
        assert _finite(report[name].values()), (name, report[name])
    assert set(report["bf16_drift"]) == {"dissum", "msp"}
    assert set(report["criteria"]) == {"closed_miou_ge_0.8",
                                       "dissum_auroc_ge_0.9",
                                       "dissum_ge_msp"}
    # knn once per val image (the knn run only); the fused route: 15 block
    # calls (resnet50dilated's stride-1 Bottlenecks) per image
    assert calls == {"knn": 2, "fused": 2 * 15}


def test_golden_run_refuses_cuda_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA is a valid choice here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden_run.run(steps=1, h=48, w=64, n_train=1, n_val=1,
                       workdir=str(tmp_path))
