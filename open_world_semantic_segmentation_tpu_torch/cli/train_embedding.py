"""DML embedding training on StreetHazards (anomaly/train_embedding.py).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.train_embedding \
      --cfg configs/train_embedding.yaml [TRAIN.num_epoch 20 ...]

Over N ranks (data parallel, one process and one device per rank):
  python -m torch.distributed.run --nproc_per_node N \
      -m open_world_semantic_segmentation_tpu_torch.cli.train_embedding \
      --cfg configs/train_embedding.yaml

Under ``torch.distributed.run`` (``WORLD_SIZE`` set) each rank runs on
``cuda:LOCAL_RANK`` with its own shard of the records
(``TrainPipeline(num_hosts=world, host_id=rank)``), TRAIN.batch_size_per_gpu
images a step, so the global batch is N times that; batch norm, the loss
and the gradients reduce over the ranks (``train/state.py``), so N ranks
train as one process would on the global batch. Every rank starts from
rank 0's weights and draws dropout from the seed plus its rank. Only rank
0 prints, writes ``metrics.jsonl`` and the checkpoints; at the end the
ranks' parameters and buffers are checked to be bit-identical. NCCL is the
backend where each rank has a card of its own, gloo where ranks share a
card (NCCL refuses two ranks on one device) and on the CPU.

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
    announce_ranks,
    build_anomaly_model,
    check_replicas,
    compute_dtype,
    config_parser,
    epoch_checkpoint_path,
    init_or_load_variables,
    leave_ranks,
    parse_config,
)
from ..data.odgt import TrainPipeline
from ..data.prefetch import prefetch_to_device
from ..metrics.meters import AverageMeter
from ..parallel.mesh import init_distributed, replicate
from ..train.checkpoint import save_epoch_checkpoint
from ..train.optim import poly_schedule, two_group_optimizer
from ..train.state import AnomalyTrainStep
from ..utils.observability import MetricsWriter


def main(cfg, precision_dtype=torch.bfloat16, max_steps=None, device=None):
    """Train as ``cfg`` says; return a summary: ``steps``, ``skipped``,
    ``rank`` and ``world``, and ``log``, one entry per logged step with its
    ``loss``, ``acc``, the loop's wall ``seconds`` and the ``wait`` for the
    loader so far, and the batch's ``shape``. Under
    ``torch.distributed.run`` it trains over the ranks (``parallel/mesh.py
    init_distributed``)."""
    rank, world, device = init_distributed(device)
    lead = rank == 0
    announce_ranks(rank, world)
    torch.manual_seed(cfg.TRAIN.seed + rank)     # dropout's generator
    model = build_anomaly_model(cfg, device, train=True)
    init_or_load_variables(cfg, model, seed=cfg.TRAIN.seed)
    replicate(model)

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
        seed=cfg.TRAIN.seed, num_hosts=world, host_id=rank)

    writer = (MetricsWriter(os.path.join(cfg.DIR, "metrics.jsonl"))
              if lead else None)
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
                    log.append({"step": total, "loss": loss, "acc": acc,
                                "seconds": time.perf_counter() - start,
                                "wait": wait,
                                "shape": list(batch["img_data"].shape)})
                    if lead:
                        writer.write(total, loss=loss, acc=acc,
                                     epoch=epoch + 1)
                        _progress(cfg, epoch, it, total, max_iters,
                                  (time.perf_counter() - tic) / (it + 1),
                                  ave_acc, ave_loss)
                if max_steps is not None and total >= max_steps:
                    break
            if lead:
                save_epoch_checkpoint(
                    model, epoch_checkpoint_path(cfg, "encoder", epoch + 1),
                    epoch_checkpoint_path(cfg, "decoder", epoch + 1))
            if max_steps is not None and total >= max_steps:
                break
    finally:
        if writer is not None:
            writer.close()
        batches.close()
    check_replicas(model, world, lead)
    if lead:
        print("Training Done!")
    return {"steps": total, "skipped": int(skipped), "rank": rank,
            "world": world, "log": log}


def _progress(cfg, epoch, it, total, max_iters, dt, ave_acc, ave_loss):
    frac = 1.0 - total / max_iters
    lr_e = cfg.TRAIN.lr_encoder * max(frac, 0.0) ** cfg.TRAIN.lr_pow
    print("Epoch: [{}][{}/{}], Time: {:.2f}, "
          "lr_encoder: {:.6f}, lr_decoder: {:.6f}, "
          "Accuracy: {:4.2f}, Loss: {:.6f}".format(
              epoch + 1, it + 1, cfg.TRAIN.epoch_iters, dt, lr_e, lr_e,
              ave_acc.average(), ave_loss.average()), flush=True)


def _entry():
    parser = config_parser(__doc__)
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after this many train steps")
    args = parser.parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), max_steps=args.max_steps,
         device=args.device)
    leave_ranks()


if __name__ == "__main__":
    _entry()
