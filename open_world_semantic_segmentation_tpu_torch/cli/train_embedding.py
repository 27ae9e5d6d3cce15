"""DML embedding training on StreetHazards (anomaly/train_embedding.py).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.train_embedding \
      --cfg configs/train_embedding.yaml [TRAIN.num_epoch 20 ...]

Runs on CUDA unless ``--device cpu`` is given; ``--precision bf16`` (the
default) runs the forward under bf16 autocast over float32 parameters. The
loop is the JAX package's ``cli/train_embedding.py``: the epoch/iteration
structure, poly LR on the encoder and decoder SGD groups, loss = CE/n +
0.01*VAR/n, the printed progress line, the non-finite guard and the
``metrics.jsonl`` stream. Each epoch writes the reference's checkpoint pair
``encoder_epoch_N.pth`` / ``decoder_epoch_N.pth`` into ``DIR`` (the JAX
trainer writes ``model_epoch_N.pkl``).

``torch.backends.cudnn.benchmark`` stays off: batches come in up to ten
shapes (five short sides, two aspect buckets), and with cuDNN's heuristics
alone the first step of a shape costs a few tenths of a second more than
the next one (``PERF.md``), where autotuning would time every convolution
of every new shape.
"""

from __future__ import annotations

import os
import time

import torch

from ._common import (
    build_anomaly_model,
    compute_dtype,
    config_parser,
    epoch_checkpoint_path,
    init_or_load_variables,
    parse_config,
)
from ..core.device import resolve_device
from ..data.odgt import TrainPipeline
from ..data.prefetch import prefetch_to_device
from ..metrics.meters import AverageMeter
from ..train.checkpoint import save_epoch_checkpoint
from ..train.optim import poly_schedule, two_group_optimizer
from ..train.state import AnomalyTrainStep
from ..utils.observability import MetricsWriter


def main(cfg, precision_dtype=torch.bfloat16, max_steps=None, device=None):
    """Train as ``cfg`` says; return a summary: ``steps``, ``skipped`` and
    ``log``, one entry per logged step with its ``loss``, ``acc``, the
    loop's wall ``seconds`` and the ``wait`` for the loader so far, and the
    batch's ``shape``."""
    device = resolve_device(device)
    torch.manual_seed(cfg.TRAIN.seed)            # dropout's generator
    model = build_anomaly_model(cfg, device, train=True)
    init_or_load_variables(cfg, model, seed=cfg.TRAIN.seed)

    max_iters = cfg.TRAIN.epoch_iters * cfg.TRAIN.num_epoch
    optimizer = two_group_optimizer(
        model,
        lr_encoder=poly_schedule(cfg.TRAIN.lr_encoder, max_iters,
                                 cfg.TRAIN.lr_pow),
        lr_decoder=poly_schedule(cfg.TRAIN.lr_decoder, max_iters,
                                 cfg.TRAIN.lr_pow),
        momentum=cfg.TRAIN.beta1,
        weight_decay=cfg.TRAIN.weight_decay)
    step_fn = AnomalyTrainStep(
        model, optimizer, alpha=0.01, fix_bn=cfg.TRAIN.fix_bn, guard=True,
        log_softmax_scores=not cfg.MODEL.arch_decoder.endswith("embedding"),
        dtype=precision_dtype)

    pipeline = TrainPipeline(
        cfg.DATASET.root_dataset, cfg.DATASET.list_train,
        batch_per_gpu=cfg.TRAIN.batch_size_per_gpu,
        img_sizes=cfg.DATASET.imgSizes,
        img_max_size=cfg.DATASET.imgMaxSize,
        padding_constant=cfg.DATASET.padding_constant,
        segm_downsampling_rate=cfg.DATASET.segm_downsampling_rate,
        random_flip=cfg.DATASET.random_flip,
        seed=cfg.TRAIN.seed)

    writer = MetricsWriter(os.path.join(cfg.DIR, "metrics.jsonl"))
    ave_loss = AverageMeter()
    ave_acc = AverageMeter()
    batches = prefetch_to_device(pipeline, device, size=2)
    skipped = torch.zeros((), dtype=torch.int64, device=device)
    log = []
    total = 0
    wait = 0.0
    start = time.perf_counter()
    try:
        for epoch in range(cfg.TRAIN.start_epoch, cfg.TRAIN.num_epoch):
            tic = time.perf_counter()
            for it in range(cfg.TRAIN.epoch_iters):
                t0 = time.perf_counter()
                batch = next(batches)
                wait += time.perf_counter() - t0
                metrics = step_fn(batch)
                skipped += metrics["skipped"]
                total += 1
                if (it + 1) % cfg.TRAIN.disp_iter == 0:
                    loss = float(metrics["loss"])      # sync point
                    acc = float(metrics["acc"])
                    ave_loss.update(loss)
                    ave_acc.update(acc * 100)
                    writer.write(total, loss=loss, acc=acc, epoch=epoch + 1)
                    log.append({"step": total, "loss": loss, "acc": acc,
                                "seconds": time.perf_counter() - start,
                                "wait": wait,
                                "shape": list(batch["img_data"].shape)})
                    dt = (time.perf_counter() - tic) / (it + 1)
                    frac = 1.0 - total / max_iters
                    lr_e = (cfg.TRAIN.lr_encoder
                            * max(frac, 0.0) ** cfg.TRAIN.lr_pow)
                    print("Epoch: [{}][{}/{}], Time: {:.2f}, "
                          "lr_encoder: {:.6f}, lr_decoder: {:.6f}, "
                          "Accuracy: {:4.2f}, Loss: {:.6f}".format(
                              epoch + 1, it + 1, cfg.TRAIN.epoch_iters, dt,
                              lr_e, lr_e, ave_acc.average(),
                              ave_loss.average()), flush=True)
                if max_steps is not None and total >= max_steps:
                    break
            save_epoch_checkpoint(
                model, epoch_checkpoint_path(cfg, "encoder", epoch + 1),
                epoch_checkpoint_path(cfg, "decoder", epoch + 1))
            if max_steps is not None and total >= max_steps:
                break
    finally:
        writer.close()
        batches.close()
    print("Training Done!")
    return {"steps": total, "skipped": int(skipped), "log": log}


def _entry():
    parser = config_parser(__doc__)
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after this many train steps")
    args = parser.parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), max_steps=args.max_steps,
         device=args.device)


if __name__ == "__main__":
    _entry()
