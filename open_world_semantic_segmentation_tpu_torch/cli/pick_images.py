"""Sample image subsets into new Cityscapes splits (pick_images.py parity).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.pick_images \
      --root ./data/cityscapes --src train --dst car_100 --n 100 [--seed 1]

Creates leftImg8bit/<dst>/<city> + gtFine/<dst>/<city> with symlinks (or
copies with --copy) to n randomly sampled images of the source split —
the mechanism behind the reference's ``car_100`` / ``car_1000`` splits
(pick_images.py:25-41).
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--src", default="train")
    ap.add_argument("--dst", required=True)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--copy", action="store_true")
    args = ap.parse_args(argv)

    img_src = os.path.join(args.root, "leftImg8bit", args.src)
    gt_src = os.path.join(args.root, "gtFine", args.src)
    pairs = []
    for city in sorted(os.listdir(img_src)):
        for f in sorted(os.listdir(os.path.join(img_src, city))):
            base = f.split("_leftImg8bit")[0]
            gt = os.path.join(gt_src, city, f"{base}_gtFine_labelIds.png")
            if os.path.exists(gt):
                pairs.append((city, os.path.join(img_src, city, f), gt))
    rng = np.random.default_rng(args.seed)
    chosen = [pairs[i] for i in
              rng.choice(len(pairs), min(args.n, len(pairs)), replace=False)]

    place = shutil.copy2 if args.copy else os.symlink
    for city, img, gt in chosen:
        for src, kind in ((img, "leftImg8bit"), (gt, "gtFine")):
            dst_dir = os.path.join(args.root, kind, args.dst, city)
            os.makedirs(dst_dir, exist_ok=True)
            dst = os.path.join(dst_dir, os.path.basename(src))
            if not os.path.exists(dst):
                place(src, dst)
    print(f"created split {args.dst} with {len(chosen)} images")


if __name__ == "__main__":
    main()
