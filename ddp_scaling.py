#!/usr/bin/env python3
"""Data-parallel training on the cards of one host: does the step keep its
time as ranks are added? ``cli/train_embedding`` with
``configs/train_embedding.yaml`` (resnet50dilated + ppm_deepsup_embedding,
batch 8 a rank, bf16 autocast) under ``python -m torch.distributed.run``
with 1, 2, 4, ... ranks up to ``--nproc``, a card each (so NCCL), on a
synthetic 720x1280 StreetHazards tree (short sides 300-600, as the
config), ``--steps`` steps each from one seed's weights. For each rank
count it prints the median s/step after the first (rank 0's
``metrics.jsonl``), imgs/s at the global batch, and the weak-scaling
efficiency: imgs/s over the rank count times one rank's. It fails unless
every run ends, only rank 0 prints progress, and each run over more than
one rank used NCCL and ended with the ranks' weights bit-identical (the
entry point's check).

    python3 ddp_scaling.py [--nproc 4] [--steps 8]

``--device cpu`` runs the same at a tiny size over gloo (resnet18dilated,
48-pixel images, 2 a rank, fp32): a check that the launch works.
"""

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
TREE_IMAGES = 64
RANK_TIMEOUT_S = 600


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=None,
                   help="the most ranks (default: the device count)")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args()
    os.chdir(HERE)
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("ddp_scaling: no CUDA device", file=sys.stderr)
        return 1
    most = args.nproc or (torch.cuda.device_count() if cuda else 2)
    if cuda and most > torch.cuda.device_count():
        print(f"ddp_scaling: {most} ranks need a card each", file=sys.stderr)
        return 1
    worlds = [w for w in (1, 2, 4, 8, 16) if w < most] + [most]
    if cuda:
        print(cs.gpu_name_and_power(), flush=True)
    size = (720, 1280) if cuda else (64, 96)
    extra = [] if cuda else [
        "--precision", "fp32", "DATASET.imgSizes", "(48,)",
        "DATASET.imgMaxSize", "96", "MODEL.arch_encoder", "resnet18dilated",
        "MODEL.fc_dim", "512", "TRAIN.batch_size_per_gpu", "2"]
    results = {}
    with tempfile.TemporaryDirectory() as root:
        tree = os.path.join(root, "train")
        odgt = cs.write_street_tree(tree, TREE_IMAGES if cuda else 8, size,
                                    cs.SEED, split="training")
        for world in worlds:
            out = os.path.join(root, f"ranks_{world}")
            rc, output, seconds, _ = cs._torchrun(
                ["open_world_semantic_segmentation_tpu_torch.cli."
                 "train_embedding", "--device", args.device,
                 "--max-steps", str(args.steps), *extra[:2],
                 "--cfg", "configs/train_embedding.yaml", *extra[2:],
                 "DATASET.root_dataset", tree, "DATASET.list_train", odgt,
                 "TRAIN.epoch_iters", str(args.steps), "TRAIN.num_epoch",
                 "1", "TRAIN.disp_iter", "1", "DIR", out], world,
                os.path.join(root, f"logs_{world}"), RANK_TIMEOUT_S)
            if rc:
                print(output[-6000:], file=sys.stderr)
                raise SystemExit(f"ddp_scaling: {world} ranks: rc {rc}")
            s_per_step, steps = cs._metrics_s_per_step(
                os.path.join(out, "metrics.jsonl"))
            batch = world * (8 if cuda else 2)
            run = {"s_per_step": s_per_step, "global_batch": batch,
                   "imgs_per_s": batch / s_per_step, "seconds": seconds,
                   "steps": steps,
                   "announced": cs._rank_lines(output, 0, "data parallel:"),
                   "progress_lines": [len(cs._rank_lines(output, r, "Epoch:"))
                                      for r in range(world)],
                   "replicas": bool(cs._rank_lines(output, 0, "replicas:"))}
            run["efficiency"] = run["imgs_per_s"] / (
                world * results[1]["imgs_per_s"]) if world > 1 else 1.0
            results[world] = run
            print(f"{world} rank(s): " + json.dumps(run), flush=True)
            backend = "nccl" if cuda else "gloo"
            if steps != list(range(1, args.steps + 1)) or \
                    run["progress_lines"] != [args.steps] + [0] * (world - 1) \
                    or (world > 1 and not (run["replicas"] and any(
                        f"backend {backend}" in line
                        for line in run["announced"]))):
                raise SystemExit(f"ddp_scaling: {world} ranks: "
                                 + json.dumps(run))
    print(json.dumps({"ddp_scaling": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
