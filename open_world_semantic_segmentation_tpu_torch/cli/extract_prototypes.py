"""Extract k-shot novel-class prototypes from support images (the JAX
package's ``cli/extract_prototypes.py``).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.extract_prototypes \
      MODEL.weights_encoder best.pth \
      FEWSHOT.prototype_file prototype_car_5_shot.json FEWSHOT.shots 5

Runs on CUDA unless ``--device cpu`` is given. Walks the support split in
order; per image, the masked-mean embedding of the novel-class pixels,
taken on the device in the forward's pass, where the class covers more
than 5% of the image; stops after ``FEWSHOT.shots`` prototypes and writes
the reference's JSON list of vectors.
"""

from __future__ import annotations

import torch

from ._common import compute_dtype, config_parser, parse_config
from .main_deeplab import (autocast, build_deeplab_model, get_transforms,
                           init_or_load_deeplab)
from ..data.cityscapes import Cityscapes
from ..data.loader import batch_iterator
from ..data.prefetch import iter_prefetch
from ..fewshot.prototypes import extract_prototype, save_prototypes


@torch.inference_mode()
def main(cfg, precision_dtype=torch.float32, device=None,
         novel_true_id: int = 13, split: str = "train"):
    """Write ``FEWSHOT.prototype_file``; return the prototypes (numpy
    float32). Without weights in MODEL.weights_encoder (or
    weights_decoder) the model takes seeded random weights."""
    model, _ = build_deeplab_model(cfg, device)
    init_or_load_deeplab(
        model, cfg.MODEL.weights_encoder or cfg.MODEL.weights_decoder)
    dev = next(model.parameters()).device
    _, val_tf = get_transforms(cfg.DEEPLAB.crop_size)
    ds = Cityscapes(cfg.DATASET.root_dataset, split=split, transform=val_tf,
                    unknown_target=tuple(cfg.DEEPLAB.unknown_target))

    protos = []
    batches = batch_iterator(ds, 1, shuffle=False, drop_last=False,
                             epochs=1)
    # the next support image decodes while the device works on this one
    for image, _, target_true in iter_prefetch(batches, depth=2):
        with autocast(dev, precision_dtype):
            _, _, features = model(torch.from_numpy(image).to(dev))
        proto, valid = extract_prototype(
            features, torch.from_numpy(target_true).to(dev), novel_true_id)
        if bool(valid):
            protos.append(proto.cpu().numpy())
            print(f"prototype {len(protos)}/{cfg.FEWSHOT.shots}")
            if len(protos) >= cfg.FEWSHOT.shots:
                break
    save_prototypes(cfg.FEWSHOT.prototype_file, protos)
    print("wrote", cfg.FEWSHOT.prototype_file)
    return protos


def _entry():
    args = config_parser(__doc__).parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), device=args.device)


if __name__ == "__main__":
    _entry()
