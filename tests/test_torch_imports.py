"""The port stands alone: importing every module of
``open_world_semantic_segmentation_tpu_torch`` pulls in neither JAX nor the
JAX package, and its entry points refuse CUDA where there is no GPU instead
of falling back to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from open_world_semantic_segmentation_tpu_torch.cli import _common
from open_world_semantic_segmentation_tpu_torch.cli import demo_video
from open_world_semantic_segmentation_tpu_torch.cli import eval_embedding
from open_world_semantic_segmentation_tpu_torch.cli import eval_fishyscapes
from open_world_semantic_segmentation_tpu_torch.cli import eval_ood
from open_world_semantic_segmentation_tpu_torch.cli import eval_ood_rec
from open_world_semantic_segmentation_tpu_torch.cli import export_model
from open_world_semantic_segmentation_tpu_torch.cli import extract_prototypes
from open_world_semantic_segmentation_tpu_torch.cli import main_deeplab
from open_world_semantic_segmentation_tpu_torch.cli import main_distillation
from open_world_semantic_segmentation_tpu_torch.cli import self_distillation
from open_world_semantic_segmentation_tpu_torch.cli import serve
from open_world_semantic_segmentation_tpu_torch.cli import test_closed
from open_world_semantic_segmentation_tpu_torch.cli import test_deeplab
from open_world_semantic_segmentation_tpu_torch.cli import train_embedding
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.core.device import (
    resolve_device)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import open_world_semantic_segmentation_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "open_world_semantic_segmentation_tpu")
             or m.startswith(("jax.", "flax.",
                              "open_world_semantic_segmentation_tpu.")))
print(len(names), bad)
for name in ("cli.train_embedding", "cli.train", "data.native",
             "train.losses", "train.optim", "train.guard", "train.state",
             "train.checkpoint", "utils.observability", "models.deeplab",
             "data.transforms", "data.cityscapes", "data.loader",
             "fewshot", "fewshot.prototypes", "cli.main_deeplab",
             "cli.extract_prototypes", "cli.eval_embedding",
             "cli.test_deeplab", "ops.dilated", "fewshot.self_distillation",
             "cli.self_distillation", "cli.main_distillation",
             "openset.crf", "openset.calibration", "openset.fishyscapes",
             "utils.colors", "utils.visualize", "cli.eval_ood_rec",
             "cli.test_closed", "cli.eval_fishyscapes", "cli.serve",
             "cli.export_model", "cli.artifacts", "cli.demo_video",
             "cli.make_odgt", "cli.pick_images", "core.export",
             "models.resnext", "models.hrnet", "models.mobilenet",
             "tools", "tools.golden_run", "tools.quant_drift", "ops.quant",
             "data.voc", "parallel", "parallel.mesh"):
    assert port.__name__ + "." + name in names, name
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(maxsplit=1)
    assert int(n) >= 78 and bad.strip() == "[]", out.stdout


def test_entry_points_refuse_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA is a valid choice here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    cfg = load_config("configs/test_ood_street.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _common.build_anomaly_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_ood.main(cfg)
    for cli, preset in ((test_closed, "test_test"),
                        (eval_ood_rec, "test_ood_rec")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(load_config(f"configs/{preset}.yaml"))
    assert resolve_device("cpu") == torch.device("cpu")


def test_train_entry_point_refuses_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA is a valid choice here")
    cfg = load_config("configs/train_embedding.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_embedding.main(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _common.build_anomaly_model(cfg, train=True)


def test_deeplab_entry_points_refuse_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA is a valid choice here")
    cfg = load_config("configs/cityscapes_embedding.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_deeplab.build_deeplab_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_prototypes.main(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_embedding.main(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_fishyscapes.main(cfg)
    cfg.DEEPLAB.ckpt = "configs/cityscapes_closed.yaml"  # any file
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_deeplab.main(cfg)


def test_deeplab_training_entry_points_refuse_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA is a valid choice here")
    cfg = load_config("configs/self_distillation.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_deeplab.main(load_config("configs/cityscapes_embedding.yaml"))
    for mode in ("train", "eval"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            self_distillation.main(cfg, mode=mode)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_distillation.main(cfg)


def test_deeplab_entry_points_raise_for_what_is_not_ported(tmp_path):
    """The options whose modules wait in ROADMAP.md raise, naming it.
    (FEWSHOT.calibrate_scores and DEEPLAB.save_val_results are ported:
    ``tests/test_torch_calibration.py`` runs them.)"""
    cfg = load_config("configs/cityscapes_closed.yaml",
                      ["DEEPLAB.save_val_results", "True"])
    # VOC is ported (tests/test_torch_voc.py); a dataset of neither
    # package raises, naming the known ones
    cfg.DEEPLAB.dataset = "ade20k"
    with pytest.raises(ValueError, match="cityscapes.*voc"):
        main_deeplab.main(cfg, device="cpu")
    # every DeepLab model of the JAX package is ported now (the MobileNet
    # factories: tests/test_torch_deeplab_mobilenet.py); a name of neither
    # package raises, listing the known ones
    cfg.DEEPLAB.dataset = "cityscapes"
    cfg.DEEPLAB.model = "deeplabv3plus_xception"
    with pytest.raises(ValueError, match="deeplabv3plus_mobilenet"):
        main_deeplab.build_model(cfg)


def test_serving_entry_points_refuse_cuda_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA is a valid choice here")
    cfg = load_config("configs/test_ood_street.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Segmenter(cfg, torch.float32, 32, 48)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.main(cfg, out=str(tmp_path / "m.owss"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_video.live_mode(load_config("configs/cityscapes_embedding.yaml"),
                             str(tmp_path / "demo"), torch.float32)
