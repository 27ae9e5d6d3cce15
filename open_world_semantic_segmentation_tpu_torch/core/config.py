"""Typed configuration tree with yacs-compatible field names.

Mirrors ``anomaly/config/defaults.py`` (the ``_C`` tree) so the reference's
YAML presets load unchanged: same section names (DIR, DATASET, MODEL, TRAIN,
VAL, TEST, OOD), same field names and defaults, same merge semantics
(``merge_from_file`` + trailing CLI ``opts`` pairs, train.py:238-241).

The DeepLab stack's ~25 argparse flags per driver (main.py:25-96) are folded
into the same tree under DEEPLAB, and every comment-toggled code path of the
reference is an explicit enum field (e.g. ``FEWSHOT.variant``).
"""

from __future__ import annotations

import ast
import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass
class DatasetConfig:
    root_dataset: str = "./data/"
    rec_dataset: str = "./data"
    list_train: str = "./data/training.odgt"
    list_val: str = "./data/validation.odgt"
    num_class: int = 150
    imgSizes: Tuple[int, ...] = (300, 375, 450, 525, 600)
    imgMaxSize: int = 1000
    padding_constant: int = 8
    segm_downsampling_rate: int = 8
    random_flip: bool = True


@dataclass
class ModelConfig:
    arch_encoder: str = "resnet50dilated"
    arch_decoder: str = "ppm_deepsup"
    weights_encoder: str = ""
    weights_decoder: str = ""
    fc_dim: int = 2048


@dataclass
class TrainConfig:
    batch_size_per_gpu: int = 2
    num_epoch: int = 20
    start_epoch: int = 0
    epoch_iters: int = 5000
    optim: str = "SGD"
    lr_encoder: float = 0.02
    lr_decoder: float = 0.02
    lr_pow: float = 0.9
    beta1: float = 0.9
    weight_decay: float = 1e-4
    deep_sup_scale: float = 0.4
    fix_bn: bool = False
    workers: int = 16
    disp_iter: int = 20
    seed: int = 304


@dataclass
class ValConfig:
    batch_size: int = 1
    visualize: bool = False
    checkpoint: str = "epoch_20.pth"


@dataclass
class TestConfig:
    batch_size: int = 1
    checkpoint: str = "epoch_20.pth"
    result: str = "./"
    prob_result: str = "./"


@dataclass
class OODConfig:
    exclude_back: bool = False
    ood: str = "msp"  # msp | maxlogit | dissum | background | crf | crf-gauss | knn
    out_labels: Tuple[int, ...] = (13,)


@dataclass
class DeepLabConfig:
    """Flags of the DeepLab drivers (main.py:25-96 and variants)."""

    model: str = "deeplabv3plus_resnet101"
    dataset: str = "cityscapes"
    num_classes: Optional[int] = None
    output_stride: int = 16
    crop_size: int = 768
    batch_size: int = 8
    val_batch_size: int = 1
    lr: float = 0.1
    lr_policy: str = "poly"
    step_size: int = 10000
    total_itrs: int = 30000
    weight_decay: float = 1e-4
    loss_type: str = "cross_entropy"
    crop_val: bool = False
    val_interval: int = 100
    continue_training: bool = False
    separable_conv: bool = False
    random_seed: int = 1
    unknown_target: Tuple[int, ...] = (14, 15)
    # eval-only surface (main.py --test_only/--ckpt/--save_val_results,
    # main.py:156-240 and test.py)
    test_only: bool = False
    ckpt: str = ""
    save_val_results: bool = False
    # test.py's per-image open-set AUROC/FPR95/AUPR on the MSP map
    # (test.py:205-249); auto-enabled for embedding models
    unknown_scores: bool = False


@dataclass
class FewshotConfig:
    """Incremental few-shot settings, incl. the reference's comment toggles
    (README.md:65-117) made explicit."""

    novel_cls: int = 1
    shots: int = 5
    prototype_file: str = "prototype_car_5_shot.json"
    # eval merge variant: plm_all uses outputs[0] overridden by novel heads,
    # plm_latest uses outputs[-1] (test_self_distillation.py:292-297)
    variant: str = "plm_all"  # plm_all | plm_latest | npm | all17 | first16
    npm_dis_threshold: float = -1.5  # test_embedding.py:445
    novel_label_from_zero: bool = True  # labels==0 -> 16+i (train, :558)
    # GMM/ECDF score calibration (the reference's dormant design,
    # main_embedding.py:175-226, implemented in openset/calibration.py)
    calibrate_scores: bool = False
    calib_images: int = 20       # collection-pass image budget
    calib_mode: str = "step"     # step (active line) | sigmoid (commented)
    calib_rate: int = 500        # per-class 1/rate pixel subsampling
    calib_save: str = ""         # optional .npz path for the fitted state


@dataclass
class Config:
    DIR: str = "ckpt/ade20k-resnet50dilated-ppm_deepsup"
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    VAL: ValConfig = field(default_factory=ValConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    OOD: OODConfig = field(default_factory=OODConfig)
    DEEPLAB: DeepLabConfig = field(default_factory=DeepLabConfig)
    FEWSHOT: FewshotConfig = field(default_factory=FewshotConfig)

    # ------------------------------------------------------------------
    def merge_from_dict(self, tree: dict):
        for section, values in tree.items():
            if not hasattr(self, section):
                raise KeyError(f"unknown config section {section}")
            target = getattr(self, section)
            if dataclasses.is_dataclass(target) and isinstance(values, dict):
                for k, v in values.items():
                    if not hasattr(target, k):
                        raise KeyError(f"unknown key {section}.{k}")
                    setattr(target, k, _coerce(getattr(target, k), v))
            else:
                setattr(self, section, values)
        return self

    def merge_from_file(self, path: str):
        import yaml

        with open(path) as f:
            tree = yaml.safe_load(f)
        return self.merge_from_dict(tree or {})

    def merge_from_list(self, opts: Sequence):
        """yacs-style trailing CLI pairs: SECTION.key value ..."""
        assert len(opts) % 2 == 0, "opts must be key/value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            section, _, leaf = key.partition(".")
            target = getattr(self, section)
            if leaf:
                cur = getattr(target, leaf)
                setattr(target, leaf, _coerce(cur, value))
            else:
                setattr(self, section, value)
        return self

    def clone(self):
        return copy.deepcopy(self)


def _coerce(current, value):
    """Coerce a YAML/CLI value to the type of the existing field (yacs
    tolerates tuple-syntax strings like \"(300, 375)\")."""
    if isinstance(value, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    if isinstance(current, tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    if isinstance(current, bool) and isinstance(value, str):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, float) and isinstance(value, (int, str)):
        return float(value)
    if isinstance(current, int) and not isinstance(current, bool) \
            and isinstance(value, (float, str)):
        return int(value)
    return value


def default_config() -> Config:
    return Config()


def load_config(path: Optional[str] = None, opts: Sequence = ()) -> Config:
    cfg = Config()
    if path:
        cfg.merge_from_file(path)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg
