"""Dataset tooling: odgt list creation + BDD label conversion
(anomaly/create_dataset.py).

Subcommands:
  streethazards  — walk images/<split>/tX vs annotations/<split>/tX
                   (create_dataset.py:26-56 generic walker)
  laf            — Lost&Found: leftImg8bit/test vs gtCoarse/test, skipping
                   single-class label images (create_dataset.py:202-273)
  roadanomaly    — frames/*.jpg with <name>.labels/labels_semantic.png
                   (create_dataset.py:163-195)
  convert-bdd    — in-place BDD100K label remap: 255->-1(->0 after +1),
                   16<->18 swap via 19, then +1 (create_dataset.py:131-154)

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.make_odgt laf \
      --root /data/lost_found --img-dir leftImg8bit/test \
      --ann-dir gtCoarse/test --out anom_all.odgt
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from PIL import Image


def _entry(file_dir, ann_dir_rel, img, ann_file, height=720, width=1280):
    return {
        "dbName": "BDD-anonymous",
        "width": width,
        "height": height,
        "fpath_img": os.path.join(file_dir, img),
        "fpath_segm": os.path.join(ann_dir_rel, ann_file),
    }


def make_streethazards(root, img_dir, ann_dir, out, db_name="StreetHazards"):
    files = []
    for sub in sorted(os.listdir(os.path.join(root, img_dir))):
        sub_img = os.path.join(root, img_dir, sub)
        if not os.path.isdir(sub_img):
            continue
        for img in sorted(os.listdir(sub_img)):
            ann = os.path.join(root, ann_dir, sub, img)
            if not os.path.exists(ann):
                continue
            with Image.open(os.path.join(sub_img, img)) as im:
                w, h = im.size
            files.append({
                "fpath_img": os.path.join(img_dir, sub, img),
                "fpath_segm": os.path.join(ann_dir, sub, img),
                "height": h, "width": w, "dbName": db_name,
            })
    _write(files, os.path.join(root, out))


def make_laf(root, img_dir, ann_dir, out):
    files = []
    for city in sorted(os.listdir(os.path.join(root, img_dir))):
        for img in sorted(os.listdir(os.path.join(root, img_dir, city))):
            if not img.endswith("png"):
                continue
            ann_file = img.replace("leftImg8bit", "gtCoarse_labelIds")
            ann_path = os.path.join(root, ann_dir, city, ann_file)
            if not os.path.exists(ann_path):
                continue
            label = np.array(Image.open(ann_path))
            if len(np.unique(label)) == 1:  # empty-label filter (:253-257)
                continue
            files.append({
                "dbName": "BDD-anonymous", "width": 1280, "height": 720,
                "fpath_img": os.path.join(img_dir, city, img),
                "fpath_segm": os.path.join(ann_dir, city, ann_file),
            })
    _write(files, os.path.join(root, out))


def make_roadanomaly(root, img_dir, out):
    files = []
    for img in sorted(os.listdir(os.path.join(root, img_dir))):
        if not img.endswith("jpg"):
            continue
        ann_file = img.replace(".jpg", ".labels")
        ann_path = os.path.join(root, img_dir, ann_file,
                                "labels_semantic.png")
        if not os.path.exists(ann_path):
            continue
        files.append({
            "dbName": "BDD-anonymous", "width": 1280, "height": 720,
            "fpath_img": os.path.join(img_dir, img),
            "fpath_segm": os.path.join(img_dir, ann_file,
                                       "labels_semantic.png"),
        })
    _write(files, os.path.join(root, out))


def convert_bdd(root, ann_dir):
    """In-place remap: 255->-1, 16->19, 18->16, 19->18, then +1 — the
    16/18 swap aligns BDD's train/motorcycle/bicycle ids with the model's
    class order (create_dataset.py:131-154)."""
    ann = os.path.join(root, ann_dir)
    for name in sorted(os.listdir(ann)):
        path = os.path.join(ann, name)
        img = np.array(Image.open(path)).astype(np.int16)
        if img.ndim <= 1:
            continue
        img[img == 255] = -1
        img[img == 16] = 19
        img[img == 18] = 16
        img[img == 19] = 18
        img += 1
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "L").save(path)


def _write(files, out_path):
    print("total images in = {}".format(len(files)))
    with open(out_path, "w") as f:
        json.dump(files, f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("command", choices=["streethazards", "laf",
                                        "roadanomaly", "convert-bdd"])
    ap.add_argument("--root", required=True)
    ap.add_argument("--img-dir", default="images/test")
    ap.add_argument("--ann-dir", default="annotations/test")
    ap.add_argument("--out", default="list.odgt")
    args = ap.parse_args(argv)
    if args.command == "streethazards":
        make_streethazards(args.root, args.img_dir, args.ann_dir, args.out)
    elif args.command == "laf":
        make_laf(args.root, args.img_dir, args.ann_dir, args.out)
    elif args.command == "roadanomaly":
        make_roadanomaly(args.root, args.img_dir, args.out)
    else:
        convert_bdd(args.root, args.ann_dir)


if __name__ == "__main__":
    main()
