"""FT / PLM incremental few-shot training and eval: the JAX package's
``cli/self_distillation.py`` (the reference's test_self_distillation.py and
main_self_distillation.py).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.self_distillation \
      --mode train --cfg configs/self_distillation.yaml \
      MODEL.weights_encoder ckpt/cityscapes-embedding/best.pth
  python -m open_world_semantic_segmentation_tpu_torch.cli.self_distillation \
      --mode eval --cfg configs/self_distillation.yaml \
      MODEL.weights_encoder ckpt/self-distillation/self_distillation_latest.pth

Runs on CUDA unless ``--device cpu`` is given; ``--precision bf16`` (the
default) runs under bf16 autocast over float32 parameters. The model is the
16 + FEWSHOT.novel_cls two-head embedding model
(deeplabv3plus_embedding_self_distillation_resnet101), initialised from a
seed and then loaded partially from MODEL.weights_encoder (a base
``.pth`` of ``cli/main_deeplab.py``, the reference's, or a JAX pickle): the
keys it shares with the checkpoint at equal shapes, so a fresh
``classifier_1`` keeps its init (test_self_distillation.py:511-518).

Train (``--mode train``): on ``test_car_{shots}_shot`` (``train`` where that
split is missing or FEWSHOT.shots is not 1 or 5), with the train
transforms; labels 0 become the novel id, ignored pixels take the frozen
base head's argmax (``fewshot/self_distillation.py pseudo_label``), CE on
the newest head only, which alone trains (SGD, momentum 0.9, poly LR). BN
normalises with batch statistics and keeps its running statistics
(``fix_bn``, main_self_distillation.py:433-435), as the JAX package does.
Writes ``DIR/self_distillation_latest.pth`` (``{"model_state",
"cur_itrs"}``; the JAX CLI writes a pickle).

Eval (``--mode eval``): the merged open-world prediction of FEWSHOT.variant
(``plm_all``: the base head's argmax; ``plm_latest``: the last head's;
each novel head overrides with its novel class), the NPM label remap, the
streaming confusion matrix, as ``cli/eval_embedding.py`` runs NPM.
``fused_blocks`` (a keyword of ``main``, no flag) routes the backbone's
eligible bottlenecks through the fused kernel in eval.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ._common import compute_dtype, config_parser, parse_config
from .main_deeplab import (autocast, build_deeplab_model, double_buffered,
                           frozen_heads, get_train_dataset, get_transforms,
                           init_or_load_deeplab, train_batches, train_loop)
from ..core.device import resolve_device, to_host_async
from ..data.cityscapes import Cityscapes
from ..data.loader import batch_iterator
from ..data.prefetch import prefetch_to_device
from ..fewshot.self_distillation import (merge_head_predictions,
                                         pseudo_label,
                                         self_distillation_eval_remap)
from ..metrics.segmentation import StreamSegMetrics
from ..train.checkpoint import (load_deeplab_state, load_partial,
                                save_model_checkpoint)
from ..train.losses import deeplab_cross_entropy
from ..train.optim import backbone_classifier_optimizer, poly_schedule
from ..train.state import TrainStep

MODEL = "deeplabv3plus_embedding_self_distillation_resnet101"
MODES = ("train", "eval")


class SelfDistillationStep(TrainStep):
    """The JAX package's ``make_self_distillation_step``: pseudo-labels
    from the heads' outputs of this forward, CE / n on the last head.
    BN statistics are kept by default (``fix_bn``)."""

    def __init__(self, model, optimizer, *, novel_cls: int,
                 base_classes: int, fix_bn: bool = True,
                 dtype=torch.bfloat16):
        super().__init__(model, optimizer, fix_bn=fix_bn, dtype=dtype)
        self.novel_cls = novel_cls
        self.base_classes = base_classes

    def loss(self, batch):
        img = batch["image"]
        with self.autocast(img.device):
            logits, _, _ = self.model(img)
        labels = pseudo_label(batch["label"], logits,
                              novel_cls=self.novel_cls,
                              base_classes=self.base_classes)
        return deeplab_cross_entropy(logits[-1], labels, ignore_index=255,
                                     group=self.group), {}


def evaluate(cfg, model, num_classes: int, precision_dtype=torch.bfloat16,
             max_images=None, split: str = "val"):
    """The merged prediction's ``StreamSegMetrics`` over ``split``, with
    ``images`` and ``seconds`` (the loop's wall time)."""
    _, val_tf = get_transforms(cfg.DEEPLAB.crop_size)
    val_ds = Cityscapes(cfg.DATASET.root_dataset, split=split,
                        transform=val_tf,
                        unknown_target=tuple(cfg.DEEPLAB.unknown_target))
    dev = next(model.parameters()).device
    variant = cfg.FEWSHOT.variant
    metrics = StreamSegMetrics(num_classes + cfg.FEWSHOT.novel_cls)
    metrics.reset()

    @torch.inference_mode()
    def dispatch(batch):
        with autocast(dev, precision_dtype):
            logits, _, _ = model(batch["image"])
        preds = merge_head_predictions(logits, variant=variant,
                                       base_classes=num_classes)
        remapped = self_distillation_eval_remap(batch["label"])
        return 1, to_host_async([preds[0].to(torch.uint8),
                                 remapped[0].to(torch.uint8)]), None

    def resolve(arrays, _):
        preds, labels = arrays
        metrics.update(labels[None].astype(np.int64), preds[None])

    batches = ({"image": image, "label": target.astype(np.int32)}
               for image, target, _ in batch_iterator(
                   val_ds, 1, shuffle=False, drop_last=False, epochs=1))
    n, clock = double_buffered(prefetch_to_device(batches, dev), dispatch,
                               resolve, max_images=max_images)
    score = metrics.get_results()
    print(StreamSegMetrics.to_str(score))
    score.update(images=n, seconds=clock["total"])
    return score


def build_self_distillation_model(cfg, device, fused_blocks: bool = False,
                                  train: bool = False):
    """(model, num_classes): the two-head model on ``device``, from the
    seed DEEPLAB.random_seed, then MODEL.weights_encoder (or
    weights_decoder) loaded partially."""
    cfg = cfg.clone()
    cfg.DEEPLAB.model = MODEL
    model, num_classes = build_deeplab_model(
        cfg, device, fused_blocks=fused_blocks, train=train)
    init_or_load_deeplab(model, seed=cfg.DEEPLAB.random_seed)
    weights = cfg.MODEL.weights_encoder or cfg.MODEL.weights_decoder
    if weights:
        load_partial(model, load_deeplab_state(weights))
    return model, num_classes


def training_split(cfg):
    """``test_car_{shots}_shot`` for 1 or 5 shots, else ``train``; ``train``
    too where the few-shot split is missing from the tree."""
    shots = cfg.FEWSHOT.shots
    split = f"test_car_{shots}_shot" if shots in (1, 5) else "train"
    train_tf, _ = get_transforms(cfg.DEEPLAB.crop_size)
    try:
        return get_train_dataset(cfg, train_tf, split)
    except RuntimeError:
        return get_train_dataset(cfg, train_tf, "train")


def main(cfg, precision_dtype=torch.bfloat16, mode: str = "eval",
         max_steps=None, max_images=None, device=None,
         fused_blocks: bool = False, log_every: int = 10):
    """Train (returns ``steps``, ``log``: the loss and the loop's wall
    ``seconds`` and loader ``wait`` so far at each logged step, and the
    checkpoint's ``path``) or evaluate (returns the metrics)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    cfg = cfg.clone()
    cfg.DEEPLAB.model = MODEL
    d = cfg.DEEPLAB
    device = resolve_device(device)
    torch.manual_seed(d.random_seed)            # dropout's generator
    model, num_classes = build_self_distillation_model(
        cfg, device, fused_blocks=fused_blocks, train=mode == "train")
    if mode == "eval":
        return evaluate(cfg, model, num_classes, precision_dtype,
                        max_images=max_images)

    train_ds = training_split(cfg)
    optimizer = backbone_classifier_optimizer(
        model, lr=poly_schedule(d.lr, d.total_itrs, 0.9, min_lr=1e-6),
        momentum=0.9, weight_decay=d.weight_decay,
        frozen_keys=frozen_heads(cfg))
    step_fn = SelfDistillationStep(model, optimizer,
                                   novel_cls=cfg.FEWSHOT.novel_cls,
                                   base_classes=num_classes,
                                   dtype=precision_dtype)
    cur, log = train_loop(
        step_fn, train_batches(train_ds, d.batch_size, d.random_seed, device),
        cur_itrs=0, total_itrs=d.total_itrs, max_steps=max_steps,
        log_every=log_every)
    path = os.path.join(cfg.DIR, "self_distillation_latest.pth")
    save_model_checkpoint(path, model, cur_itrs=cur)
    return {"steps": cur, "log": log, "path": path}


def _entry():
    parser = config_parser(__doc__)
    parser.add_argument("--mode", choices=MODES, default="eval")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="train: stop after this many steps")
    parser.add_argument("--max-images", type=int, default=None,
                        help="eval: only the first N images")
    args = parser.parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), mode=args.mode, max_steps=args.max_steps,
         max_images=args.max_images, device=args.device)


if __name__ == "__main__":
    _entry()
