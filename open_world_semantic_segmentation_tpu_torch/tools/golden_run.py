#!/usr/bin/env python
"""Golden convergence run of the port: its training stack learns open-set
behaviour, through its own entry points.

``run`` builds the learnable synthetic StreetHazards tree with the repo's
``tools/make_synthetic_data.py make_streethazards_learnable`` (numpy and
PIL only, the same data as the JAX package's ``tools/golden_run.py``:
colour-coded classes, a held-out anomaly colour that appears only in val),
trains with ``cli/train_embedding.main`` and scores with
``cli/eval_ood.main``: ``dissum``, ``msp`` and ``knn`` in ``eval_precision``
(fp32 by default, TF32 off), ``dissum`` again with ``fused_blocks=True``
(the fused bottleneck kernel on trained weights), and ``dissum`` and
``msp`` in bf16 as well, with each metric's bf16-minus-fp32 drift. The
report has the JAX run's keys: ``train``, one entry per method with
``auroc``, ``aupr``, ``fpr``, ``mean_iou`` and ``accuracy``, and
``criteria`` (the flagship's: closed-set mIoU >= 0.8, dissum AUROC >= 0.9,
dissum AUROC >= msp AUROC); then ``dissum_fused``, ``<method>_bf16`` and
``bf16_drift``.

``run_cityscapes`` builds the learnable Cityscapes tree
(``make_cityscapes_learnable``), base-trains the 16-class embedding model
with ``cli/main_deeplab.main``, extracts k-shot car prototypes with
``cli/extract_prototypes.main`` and runs the NPM eval with
``cli/eval_embedding.main``, then again with no override
(``FEWSHOT.npm_dis_threshold`` 1e9): the novel class (car, id 16) IoU with
the prototype override against the base head alone, which cannot predict
16. In float32 both run with TF32 off. Its training runs under
``torch.use_deterministic_algorithms(True)`` (``deterministic``): every op
of the DeepLab train step then has a deterministic CUDA form (the
interpolation-matrix resize of ``ops/resize.py``, cuDNN's deterministic
convolution algorithms), so a seed gives the same weights on every run.
cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG`` set before its first call for
that: ``main`` sets it, and a caller that imports this module sets it
itself (``chip_smoke.py`` does, at its top).

Every run is on ``device`` (cuda unless the caller asks for the CPU). The
repo's ``tools/`` directory must sit beside the package (a checkout).

Usage (the flagship recipe of the JAX package's v5e run, on the card):
    python -m open_world_semantic_segmentation_tpu_torch.tools.golden_run \\
        --steps 2000 --lr 0.05 --img-size 128 --noise 10 --n-val 13 \\
        --n-train 64 --n-blobs 5 --min-block 40
    ... --task cityscapes --steps 400 --bs 4 --img-size 128 --h 128 \\
        --w 256 --n-val 19 --precision fp32      # the NPM golden shape
    ... --device cpu --encoder resnet18dilated --steps 200 --img-size 80 \\
        --h 96 --w 144 --precision fp32          # small CPU probe
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..cli import (eval_embedding, eval_ood, extract_prototypes, main_deeplab,
                   train_embedding)
from ..core.config import default_config
from ..models.builder import ModelBuilder

METRICS = ("auroc", "aupr", "fpr", "mean_iou", "accuracy")
# scored in bf16 as well as in eval_precision, for the drift
BF16_METHODS = ("dissum", "msp")


def _synthetic_data():
    """The repo's ``tools/make_synthetic_data.py``, imported from the
    checkout the package sits in."""
    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tools")
    if not os.path.isfile(os.path.join(tools, "make_synthetic_data.py")):
        raise FileNotFoundError(f"{tools}/make_synthetic_data.py: the golden "
                                "run needs the repo's tools/ directory")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import make_synthetic_data

    return make_synthetic_data


@contextlib.contextmanager
def exact_fp32():
    """fp32 with TF32 off for cuDNN convs and CUDA matmuls, restored
    after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)``, restored after. An op
    without a deterministic CUDA form raises inside."""
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved)


def _eval(cfg, method, dtype, device, **kw):
    c = cfg.clone()
    c.OOD.ood = method
    with exact_fp32() if dtype == torch.float32 else contextlib.nullcontext():
        r = eval_ood.main(c, dtype, device=device, **kw)
    return {k: r.get(k) for k in METRICS}


def run(encoder="resnet50dilated", decoder="ppm_deepsup_embedding",
        steps=300, bs=8, lr=0.02, img_size=96, h=128, w=192,
        n_train=48, n_val=13, seed=0, workdir=None,
        methods=("dissum", "msp", "knn"), precision=torch.bfloat16,
        eval_precision=torch.float32, num_epoch=1, noise=18.0, n_blobs=10,
        min_block=16, device=None):
    """Train with the port's recipe, evaluate with its eval CLI; returns the
    report (see the module note). Dissum is scored on the fused route
    too where the encoder has ResNet Bottleneck blocks
    (``ModelBuilder.FUSED_ENCODERS``); ``BF16_METHODS`` are scored in bf16
    too."""
    workdir = workdir or tempfile.mkdtemp(prefix="owss_torch_golden_")
    root = _synthetic_data().make_streethazards_learnable(
        os.path.join(workdir, "sh"), n_train=n_train, n_val=n_val,
        h=h, w=w, seed=seed, noise=noise, n_blobs=n_blobs,
        min_block=min_block)

    cfg = default_config()
    cfg.DIR = os.path.join(workdir, "ckpt")
    cfg.DATASET.root_dataset = root
    cfg.DATASET.list_train = os.path.join(root, "train.odgt")
    cfg.DATASET.list_val = os.path.join(root, "val.odgt")
    cfg.DATASET.num_class = 13
    cfg.DATASET.imgSizes = (img_size,)
    cfg.DATASET.imgMaxSize = int(img_size * 2.5)
    cfg.MODEL.arch_encoder = encoder
    cfg.MODEL.arch_decoder = decoder
    cfg.TRAIN.batch_size_per_gpu = bs
    cfg.TRAIN.num_epoch = num_epoch
    cfg.TRAIN.epoch_iters = (steps + num_epoch - 1) // num_epoch
    cfg.TRAIN.disp_iter = max(steps // 10, 1)
    cfg.TRAIN.lr_encoder = lr
    cfg.TRAIN.lr_decoder = lr
    cfg.TRAIN.seed = seed

    print(f"[golden] training {encoder}+{decoder} for {steps} steps "
          f"(bs={bs}, lr={lr}, img_size={img_size}) ...", flush=True)
    tic = time.perf_counter()
    trained = train_embedding.main(cfg, precision, max_steps=steps,
                                   device=device)
    seconds = time.perf_counter() - tic
    last = trained["log"][-1] if trained["log"] else {}
    report = {"train": {"steps": trained["steps"], "encoder": encoder,
                        "decoder": decoder, "skipped": trained["skipped"],
                        "seconds": seconds,
                        "s_per_step": seconds / max(trained["steps"], 1),
                        "loss": last.get("loss"), "acc": last.get("acc")}}
    cfg.MODEL.weights_encoder = os.path.join(
        cfg.DIR, f"encoder_epoch_{num_epoch}.pth")
    cfg.MODEL.weights_decoder = os.path.join(
        cfg.DIR, f"decoder_epoch_{num_epoch}.pth")

    runs = [(m, m, eval_precision, {}) for m in methods]
    if encoder in ModelBuilder.FUSED_ENCODERS:
        runs.append(("dissum_fused", "dissum", eval_precision,
                     {"fused_blocks": True}))
    runs += [(f"{m}_bf16", m, torch.bfloat16, {}) for m in BF16_METHODS]
    for name, method, dtype, kw in runs:
        report[name] = _eval(cfg, method, dtype, device, **kw)
        print(f"[golden] {name}: " + json.dumps(report[name]), flush=True)
    report["bf16_drift"] = {
        m: {k: _diff(report[f"{m}_bf16"][k], report[m][k]) for k in METRICS}
        for m in BF16_METHODS if m in report}

    miou = report.get("dissum", report[methods[0]])["mean_iou"]
    d_auroc = report.get("dissum", {}).get("auroc")
    m_auroc = report.get("msp", {}).get("auroc")
    report["criteria"] = {
        "closed_miou_ge_0.8": miou is not None and miou >= 0.8,
        "dissum_auroc_ge_0.9": d_auroc is not None and d_auroc >= 0.9,
        "dissum_ge_msp": (d_auroc is not None and m_auroc is not None
                          and d_auroc >= m_auroc),
    }
    print(json.dumps(report, indent=2, default=float))
    return report


def _diff(a, b):
    return None if a is None or b is None else a - b


def run_cityscapes(model="deeplabv3plus_embedding_resnet50", steps=400,
                   bs=4, lr=0.05, crop=96, h=96, w=192, n_train=19, n_val=4,
                   seed=0, workdir=None, precision=torch.bfloat16,
                   noise=10.0, shots=5, device=None):
    """The Cityscapes 16+1 NPM golden shape (see the module note); returns
    the report: ``train``, ``prototypes`` (how many), ``npm`` (novel IoU,
    base mIoU, mIoU), ``no_override`` and ``criteria``."""
    synthetic = _synthetic_data()
    workdir = workdir or tempfile.mkdtemp(prefix="owss_torch_golden_cs_")
    root = os.path.join(workdir, "cs")
    synthetic.make_cityscapes_learnable(root, splits=("train",), n=n_train,
                                        h=h, w=w, seed=seed, noise=noise)
    synthetic.make_cityscapes_learnable(root, splits=("val",), n=n_val, h=h,
                                        w=w, seed=seed + 1, noise=noise)

    cfg = default_config()
    cfg.DIR = os.path.join(workdir, "ckpt")
    cfg.DATASET.root_dataset = root
    cfg.DEEPLAB.model = model
    cfg.DEEPLAB.num_classes = 16
    cfg.DEEPLAB.crop_size = crop
    cfg.DEEPLAB.batch_size = bs
    cfg.DEEPLAB.lr = lr
    cfg.DEEPLAB.total_itrs = steps
    cfg.DEEPLAB.val_interval = steps  # one validation+best-save at the end
    cfg.DEEPLAB.random_seed = seed
    cfg.FEWSHOT.prototype_file = os.path.join(workdir, "proto_car.json")
    cfg.FEWSHOT.shots = shots

    print(f"[golden-cs] training {model} for {steps} steps ...", flush=True)
    with (exact_fp32() if precision == torch.float32
          else contextlib.nullcontext()):
        tic = time.perf_counter()
        with deterministic():
            trained = main_deeplab.main(cfg, precision, max_steps=steps,
                                        device=device)
        seconds = time.perf_counter() - tic
        cfg.MODEL.weights_encoder = os.path.join(cfg.DIR, "best.pth")
        protos = extract_prototypes.main(cfg, precision, split="train",
                                         device=device)
        score = eval_embedding.main(cfg, precision, device=device)
        # no-override baseline: a threshold no pixel can beat leaves the
        # base head alone, which has no class 16
        c0 = cfg.clone()
        c0.FEWSHOT.npm_dis_threshold = 1e9
        score0 = eval_embedding.main(c0, precision, device=device)
    report = {"train": {"model": model, "steps": trained["steps"],
                        "skipped": trained["skipped"], "seconds": seconds,
                        "s_per_step": seconds / max(trained["steps"], 1)},
              "prototypes": len(protos)}
    novel_iou = float(score["Class IoU"][16])
    base_miou = float(np.mean([score["Class IoU"][i] for i in range(16)]))
    novel_iou0 = float(score0["Class IoU"][16])

    report.update({
        "npm": {"novel_iou": novel_iou, "base_miou": base_miou,
                "miou": float(score["Mean IoU"])},
        "no_override": {"novel_iou": novel_iou0,
                        "miou": float(score0["Mean IoU"])},
        "criteria": {"npm_beats_no_override": novel_iou > novel_iou0,
                     "novel_iou_positive": novel_iou > 0.1},
    })
    print(json.dumps(report, indent=2, default=float))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", default="resnet50dilated")
    ap.add_argument("--decoder", default="ppm_deepsup_embedding")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--img-size", type=int, default=96)
    ap.add_argument("--h", type=int, default=128)
    ap.add_argument("--w", type=int, default=192)
    # default 48 and 13 (StreetHazards), 19 and 4 (Cityscapes). n_val >=
    # n_class: the presence guarantee (each class dominates one val image)
    # only holds when the val split cycles through all classes (19 for
    # Cityscapes, so that a val image has a block of the novel car)
    ap.add_argument("--n-train", type=int, default=None)
    ap.add_argument("--n-val", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise", type=float, default=18.0)
    ap.add_argument("--n-blobs", type=int, default=10)
    ap.add_argument("--min-block", type=int, default=16)
    ap.add_argument("--precision", default="bf16", choices=["bf16", "fp32"],
                    help="training dtype")
    ap.add_argument("--eval-precision", default="fp32",
                    choices=["bf16", "fp32"],
                    help="dtype of the main scoring runs (fp32: TF32 off); "
                         "dissum and msp are scored in bf16 too")
    ap.add_argument("--task", default="streethazards",
                    choices=["streethazards", "cityscapes"])
    ap.add_argument("--deeplab-model",
                    default="deeplabv3plus_embedding_resnet101")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked "
                         "for)")
    args = ap.parse_args(argv)
    # cuBLAS reads it at its first call: the deterministic DeepLab training
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    if args.task == "cityscapes":
        return run_cityscapes(
            model=args.deeplab_model, steps=args.steps, bs=args.bs,
            lr=args.lr, h=args.h, w=args.w, crop=args.img_size,
            n_train=args.n_train or 19, n_val=args.n_val or 4,
            seed=args.seed, noise=args.noise,
            precision=dtypes[args.precision],
            device=args.device)
    return run(encoder=args.encoder, decoder=args.decoder, steps=args.steps,
               bs=args.bs, lr=args.lr, img_size=args.img_size, h=args.h,
               w=args.w, n_train=args.n_train or 48, n_val=args.n_val or 13,
               seed=args.seed, noise=args.noise,
               precision=dtypes[args.precision],
               eval_precision=dtypes[args.eval_precision],
               n_blobs=args.n_blobs, min_block=args.min_block,
               device=args.device)


if __name__ == "__main__":
    main()
