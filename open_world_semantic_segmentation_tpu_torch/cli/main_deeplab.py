"""DeepLab on Cityscapes: the JAX package's ``cli/main_deeplab.py`` (the
reference's main.py / main_embedding.py), training and eval.

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.main_deeplab \
      --cfg configs/cityscapes_embedding.yaml [DEEPLAB.total_itrs 30000 ...]
  (eval only: DEEPLAB.test_only True DEEPLAB.ckpt best.pth, which runs
  ``cli/test_deeplab.py``)
  over N ranks: python -m torch.distributed.run --nproc_per_node N \
      -m open_world_semantic_segmentation_tpu_torch.cli.main_deeplab ...

Runs on CUDA unless ``--device cpu`` is given; ``--precision bf16`` (the
default) runs under bf16 autocast over float32 parameters. The closed-set
recipe (main.py:243-419): crop 768, ColorJitter(.5, .5, .5), horizontal
flip, SGD (momentum 0.9, the backbone at 0.1x the heads' rate), poly LR
over ``total_itrs`` (min 1e-6), ``CE / n`` (or the focal loss), the
non-finite guard, and every ``val_interval`` steps the ``latest.pth``
checkpoint, a validation and, on a better mIoU, ``best.pth``
(``train/checkpoint.py save_deeplab_checkpoint``; the JAX trainer writes
``.pkl``). ``DEEPLAB.continue_training`` resumes from ``DIR/latest.pth``
(step, model, momentum and the best score, as the reference does; the JAX
trainer restores the step and resets the best score). DEEPLAB.ckpt, where
given, is the model's start, as in the reference's main.py (the JAX
trainer starts from its seed alone). Embedding models
train with 16 classes and the open-world unknown remap
(main_embedding.py:336, 401); the self-distillation model trains its
newest head only. Under ``torch.distributed.run`` each rank trains on
``cuda:LOCAL_RANK`` on its own shard of every epoch (``batch_iterator``'s
``num_hosts`` / ``host_id``), DEEPLAB.batch_size images a step, with batch
norm, the loss and the gradients reduced over the ranks, as
``cli/train_embedding.py`` does; rank 0's weights start every rank, each
rank seeds dropout with DEEPLAB.random_seed plus its rank, and only rank 0
prints, writes checkpoints and validates.
``DEEPLAB.dataset voc`` trains on PASCAL VOC's ``train_aug`` split
(``data/voc.py``) with the reference's VOC transform (random scale 0.5-2,
a pad-if-needed crop, a flip; main.py:103-110) and validates on ``val``,
one image per batch at the default DEEPLAB.val_batch_size 1 (VOC's val
images differ in size, and batches stack, as in the JAX package); VOC has
21 classes (DEEPLAB.num_classes 21).

``MODEL_MAP`` names the ported factories; ``build_deeplab_model`` gives the
config's model on a device, channels_last on CUDA, in eval mode unless
``train``; the CLIs run it under bf16 autocast with ``--precision bf16``
(``autocast``). Checkpoints: the reference's ``.pth`` loads natively, the
JAX package's pickle through the weight bridge (``train/checkpoint.py
load_deeplab_state``). ``double_buffered`` is the eval loop the CLIs share.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ._common import (announce_ranks, check_replicas, compute_dtype,
                      config_parser, leave_ranks, parse_config)
from ..core.device import resolve_device
from ..data import transforms as et
from ..data.cityscapes import Cityscapes
from ..data.loader import batch_iterator
from ..data.voc import VOCSegmentation
from ..data.prefetch import prefetch_to_device
from ..metrics.segmentation import StreamSegMetrics
from ..models import deeplab as deeplab_models
from ..parallel.mesh import init_distributed, replicate
from ..train.checkpoint import (load_deeplab_checkpoint,
                                save_deeplab_checkpoint)
from ..train.optim import backbone_classifier_optimizer, poly_schedule
from ..train.state import DeepLabTrainStep

MODEL_MAP = {
    "deeplabv3plus_resnet101": deeplab_models.deeplabv3plus_resnet101,
    "deeplabv3plus_resnet50": deeplab_models.deeplabv3plus_resnet50,
    "deeplabv3_resnet101": deeplab_models.deeplabv3_resnet101,
    "deeplabv3plus_embedding_resnet101":
        deeplab_models.deeplabv3plus_embedding_resnet101,
    "deeplabv3plus_embedding_resnet50":
        deeplab_models.deeplabv3plus_embedding_resnet50,
    "deeplabv3plus_embedding_self_distillation_resnet101":
        deeplab_models.deeplabv3plus_embedding_self_distillation_resnet101,
    "deeplabv3plus_mobilenet": deeplab_models.deeplabv3plus_mobilenet,
    "deeplabv3_mobilenet": deeplab_models.deeplabv3_mobilenet,
    "deeplabv3plus_embedding_mobilenet":
        deeplab_models.deeplabv3plus_embedding_mobilenet,
}


DATASETS = ("cityscapes", "voc")


def _check_dataset(dataset: str) -> str:
    if dataset not in DATASETS:
        raise ValueError(f"DEEPLAB.dataset {dataset!r}: one of {DATASETS}")
    return dataset


def get_transforms(crop_size: int, dataset: str = "cityscapes"):
    """(train transform, val transform), main.py:103-147: VOC's random
    scale, pad-if-needed crop and flip, or Cityscapes' crop, colour jitter
    and flip. The train transforms draw from the ``random.Random`` they are
    called with."""
    if _check_dataset(dataset) == "voc":
        train_tf = et.ExtCompose([
            et.ExtRandomScale((0.5, 2.0)),
            et.ExtRandomCrop(size=(crop_size, crop_size),
                             pad_if_needed=True),
            et.ExtRandomHorizontalFlip(),
            et.ExtToTensor(),
            et.ExtNormalize(),
        ])
    else:
        train_tf = et.ExtCompose([
            et.ExtRandomCrop(size=(crop_size, crop_size)),
            et.ExtColorJitter(brightness=0.5, contrast=0.5, saturation=0.5),
            et.ExtRandomHorizontalFlip(),
            et.ExtToTensor(),
            et.ExtNormalize(),
        ])
    return train_tf, et.ExtCompose([et.ExtToTensor(), et.ExtNormalize()])


def _unknown_target(cfg):
    """Embedding models always evaluate open-world; DEEPLAB.unknown_scores
    turns the remap on for plain models too."""
    d = cfg.DEEPLAB
    if "embedding" in d.model or d.unknown_scores:
        return tuple(d.unknown_target)
    return None


def get_val_dataset(cfg, val_tf):
    """The val split only: an eval must not need the train tree."""
    if _check_dataset(cfg.DEEPLAB.dataset) == "voc":
        return VOCSegmentation(cfg.DATASET.root_dataset, image_set="val",
                               transform=val_tf)
    return Cityscapes(cfg.DATASET.root_dataset, split="val",
                      transform=val_tf, unknown_target=_unknown_target(cfg))


def get_train_dataset(cfg, train_tf, split: str = "train"):
    """``split`` of Cityscapes (VOC: ``train_aug`` for ``train``; the
    few-shot splits are Cityscapes') with the train transform, each
    sample's draws seeded from DEEPLAB.random_seed, the epoch and its
    index."""
    if _check_dataset(cfg.DEEPLAB.dataset) == "voc":
        if split != "train":
            raise ValueError(f"split {split!r}: VOC trains on train_aug")
        return VOCSegmentation(cfg.DATASET.root_dataset,
                               image_set="train_aug", transform=train_tf,
                               seed=cfg.DEEPLAB.random_seed)
    return Cityscapes(cfg.DATASET.root_dataset, split=split,
                      transform=train_tf, unknown_target=_unknown_target(cfg),
                      seed=cfg.DEEPLAB.random_seed)


def build_model(cfg, *, fused_blocks: bool = False,
                dilated_impl: str = "shift"):
    """(model, num_classes) for ``DEEPLAB.model``: 16 classes for the
    embedding models, 19 otherwise, unless DEEPLAB.num_classes is set; the
    self-distillation model adds FEWSHOT.novel_cls heads."""
    d = cfg.DEEPLAB
    if d.model not in MODEL_MAP:
        raise ValueError(f"DEEPLAB.model {d.model!r}: one of "
                         f"{sorted(MODEL_MAP)}")
    num_classes = d.num_classes or (16 if "embedding" in d.model else 19)
    extra = ({"cls_novel": cfg.FEWSHOT.novel_cls}
             if "self_distillation" in d.model else {})
    model = MODEL_MAP[d.model](num_classes=num_classes,
                               output_stride=d.output_stride,
                               fused_blocks=fused_blocks,
                               dilated_impl=dilated_impl, **extra)
    return model, num_classes


def build_deeplab_model(cfg, device=None, fused_blocks: bool = False, *,
                        dilated_impl: str = "shift", train: bool = False):
    """(model, num_classes): the config's model on ``device``, in training
    mode if ``train`` else in eval mode, channels_last on CUDA.
    ``fused_blocks`` routes the backbone's eligible bottlenecks through the
    fused kernel (eval mode only); ``dilated_impl`` picks the ASPP's
    dilated convs' form."""
    device = resolve_device(device)
    model, num_classes = build_model(cfg, fused_blocks=fused_blocks,
                                     dilated_impl=dilated_impl)
    model = model.train(train).to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model, num_classes


def frozen_heads(cfg):
    """What the self-distillation model does not train: the backbone, the
    base head and every novel head but the newest
    (test_self_distillation.py:476)."""
    return tuple(["backbone", "classifier"] +
                 [f"classifier_{i}"
                  for i in range(1, cfg.FEWSHOT.novel_cls)])


def init_or_load_deeplab(model, path: str = "", *, seed: int = 0):
    """Seeded random weights (the JAX package's schemes), or the checkpoint
    at ``path``: a reference ``.pth`` or a JAX pickle."""
    if not path:
        return deeplab_models.init_deeplab_weights(
            model, torch.Generator().manual_seed(seed))
    from ..train.checkpoint import load_deeplab_state

    model.load_state_dict(load_deeplab_state(path))
    return model


def autocast(device: torch.device, dtype):
    """bf16 autocast over the float32 parameters, or nothing for float32."""
    return torch.autocast(device.type, dtype=dtype,
                          enabled=dtype != torch.float32)


def double_buffered(batches, dispatch, resolve, max_images=None):
    """The eval loop: ``dispatch(batch)`` queues one batch on the device
    and returns ``(n_images, wait_fn, context)``, ``wait_fn`` as
    ``to_host_async`` returns it; ``resolve(arrays, context)`` consumes it
    on the host. Batch k is dispatched before batch k-1 is resolved, so
    the host's work on k-1 overlaps the device's work on k.

    Returns the image count and the loop's seconds: ``wait`` blocked on
    the loader, ``device`` in dispatch and waiting for the copies,
    ``host`` in resolve, and ``total``."""
    clock = dict.fromkeys(("wait", "device", "host"), 0.0)
    start = time.perf_counter()

    def finish(entry):
        wait_fn, context = entry
        tic = time.perf_counter()
        arrays = wait_fn()
        mid = time.perf_counter()
        resolve(arrays, context)
        clock["device"] += mid - tic
        clock["host"] += time.perf_counter() - mid

    inflight = None
    count = 0
    it = iter(batches)
    while max_images is None or count < max_images:
        tic = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        mid = time.perf_counter()
        n, wait_fn, context = dispatch(batch)
        clock["wait"] += mid - tic
        clock["device"] += time.perf_counter() - mid
        if inflight is not None:
            finish(inflight)
        inflight = (wait_fn, context)
        count += n
    if inflight is not None:
        finish(inflight)
    clock["total"] = time.perf_counter() - start
    return count, clock


def train_batches(dataset, batch_size: int, seed: int, device, *,
                  num_hosts: int = 1, host_id: int = 0):
    """Shuffled batches of ``dataset`` for ever, as dicts of ``image``
    (NHWC float32) and ``label`` (int32) on ``device``, two in flight;
    host ``host_id``'s shard of each epoch with ``num_hosts`` > 1."""
    return prefetch_to_device(
        ({"image": image, "label": target.astype(np.int32)}
         for image, target, _ in batch_iterator(
             dataset, batch_size, seed=seed, num_hosts=num_hosts,
             host_id=host_id)), device)


def train_loop(step_fn, batches, *, cur_itrs: int, total_itrs: int,
               max_steps=None, log_every: int = 10, after_step=None,
               verbose: bool = True):
    """The trainers' loop: ``step_fn`` over ``batches`` from step
    ``cur_itrs`` until ``total_itrs`` (or ``max_steps``), calling
    ``after_step(cur_itrs, metrics)`` after each step. Every ``log_every``
    steps the mean loss since the last log is read back (a sync point) and,
    if ``verbose``, printed as the reference prints it. Closes ``batches``.
    Returns
    ``(cur_itrs, log)``, ``log`` one entry per logged step with its
    ``loss``, the loop's wall ``seconds`` and the ``wait`` for the loader
    so far."""
    losses, log, wait = [], [], 0.0
    start = time.perf_counter()
    try:
        while cur_itrs < total_itrs and (max_steps is None
                                         or cur_itrs < max_steps):
            tic = time.perf_counter()
            batch = next(batches)
            wait += time.perf_counter() - tic
            metrics = step_fn(batch)
            cur_itrs += 1
            losses.append(metrics["loss"])
            if cur_itrs % log_every == 0:
                loss = float(torch.stack(losses).mean())
                losses = []
                if verbose:
                    print("Itrs %d/%d, Loss=%f" % (cur_itrs, total_itrs,
                                                   loss), flush=True)
                log.append({"step": cur_itrs, "loss": loss,
                            "seconds": time.perf_counter() - start,
                            "wait": wait})
            if after_step is not None:
                after_step(cur_itrs, metrics)
    finally:
        batches.close()
    return cur_itrs, log


def main(cfg, precision_dtype=torch.bfloat16, max_steps=None, device=None,
         log_every: int = 10, max_images=None):
    """Train as ``cfg`` says (or, with DEEPLAB.test_only, evaluate: see
    ``cli/test_deeplab.py``; ``max_images`` applies there). Stops after
    DEEPLAB.total_itrs steps, or at step ``max_steps``. Returns a summary:
    ``steps`` taken, ``cur_itrs``, ``skipped``, ``best_score``,
    ``validations`` (the mIoU of each; rank 0 validates), ``rank``,
    ``world`` and ``train_loop``'s ``log``. Under
    ``torch.distributed.run`` it trains over the ranks."""
    d = cfg.DEEPLAB
    if d.test_only:
        from . import test_deeplab

        return test_deeplab.main(cfg, precision_dtype,
                                 max_images=max_images, device=device)
    rank, world, device = init_distributed(device)
    lead = rank == 0
    announce_ranks(rank, world)
    train_tf, val_tf = get_transforms(d.crop_size, d.dataset)
    train_ds = get_train_dataset(cfg, train_tf)
    val_ds = get_val_dataset(cfg, val_tf)
    torch.manual_seed(d.random_seed + rank)     # dropout's generator
    model, num_classes = build_deeplab_model(cfg, device, train=True)
    init_or_load_deeplab(model, d.ckpt, seed=d.random_seed)
    replicate(model)
    frozen = frozen_heads(cfg) if "self_distillation" in d.model else ()
    optimizer = backbone_classifier_optimizer(
        model, lr=poly_schedule(d.lr, d.total_itrs, 0.9, min_lr=1e-6),
        momentum=0.9, weight_decay=d.weight_decay,
        backbone_scale=0.0 if "backbone" in frozen else 0.1,
        frozen_keys=frozen)
    step_fn = DeepLabTrainStep(model, optimizer, loss_kind=d.loss_type,
                               guard=True, dtype=precision_dtype)

    first, best_score = 0, 0.0
    latest = os.path.join(cfg.DIR, "latest.pth")
    if d.continue_training and os.path.exists(latest):
        first, best_score = load_deeplab_checkpoint(latest, model, optimizer)
        step_fn.step = first
        if lead:
            print(f"resumed from {latest} at step {first}")

    from .test_deeplab import validate

    metrics = StreamSegMetrics(num_classes)
    skipped = torch.zeros((), dtype=torch.int64, device=device)
    validations = []

    def after_step(cur_itrs, m):
        nonlocal skipped, best_score
        skipped += m["skipped"]
        if cur_itrs % d.val_interval or not lead:
            return
        save_deeplab_checkpoint(latest, model, optimizer, cur_itrs=cur_itrs,
                                best_score=best_score)
        print("validation...")
        score, _, _ = validate(model.eval(), val_ds, metrics,
                               dtype=precision_dtype,
                               batch_size=d.val_batch_size)
        model.train()
        print(StreamSegMetrics.to_str(score))
        miou = float(score["Mean IoU"])
        validations.append(miou)
        if miou > best_score:
            best_score = miou
            save_deeplab_checkpoint(os.path.join(cfg.DIR, "best.pth"), model,
                                    optimizer, cur_itrs=cur_itrs,
                                    best_score=best_score)

    cur_itrs, log = train_loop(
        step_fn, train_batches(train_ds, d.batch_size, d.random_seed, device,
                               num_hosts=world, host_id=rank),
        cur_itrs=first, total_itrs=d.total_itrs, max_steps=max_steps,
        log_every=log_every, after_step=after_step, verbose=lead)
    check_replicas(model, world, lead)
    return {"steps": cur_itrs - first, "cur_itrs": cur_itrs,
            "skipped": int(skipped), "best_score": best_score,
            "validations": validations, "rank": rank, "world": world,
            "log": log}


def _entry():
    parser = config_parser(__doc__)
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop at this train step")
    args = parser.parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), max_steps=args.max_steps,
         device=args.device)
    leave_ranks()


if __name__ == "__main__":
    _entry()
