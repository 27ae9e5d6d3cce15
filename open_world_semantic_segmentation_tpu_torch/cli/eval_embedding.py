"""NPM 16+1 evaluation on Cityscapes (the JAX package's
``cli/eval_embedding.py``; the reference's test_embedding.py --test_only).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.eval_embedding \
      FEWSHOT.prototype_file prototype_car_5_shot.json \
      MODEL.weights_encoder best.pth

Runs on CUDA unless ``--device cpu`` is given. Per image, on the device in
one pass: the embedding model's forward, the base head's argmax, the
distance of every pixel to the k-shot averaged prototype, the novel id
where that distance beats the threshold and the largest base logit, and
the ground truth's remap (car -> 16, the ids above it shift down); then on
the host the streaming 19-class confusion matrix. Image k is dispatched
before image k-1's confusion matrix is taken (``double_buffered``).
``FEWSHOT.calibrate_scores`` needs ``openset/calibration.py``, which is
not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import compute_dtype, config_parser, parse_config
from .main_deeplab import (autocast, build_deeplab_model, double_buffered,
                           get_transforms, init_or_load_deeplab,
                           to_host_async)
from ..data.cityscapes import Cityscapes
from ..data.loader import batch_iterator
from ..data.prefetch import prefetch_to_device
from ..fewshot.prototypes import (load_prototypes, npm_label_remap,
                                  npm_override)
from ..metrics.segmentation import StreamSegMetrics


def main(cfg, precision_dtype=torch.float32, max_images=None, device=None,
         split: str = "val", fused_blocks: bool = False):
    """Evaluate and return ``StreamSegMetrics``' results, with ``images``,
    ``seconds`` (the loop's wall time), its split per image
    (``device_s_per_img``: dispatch and waiting for the outputs;
    ``wait_s_per_img``: blocked on the loader; ``metric_s_per_img``: the
    host confusion matrix), and ``novel_pixels`` / ``pixels``: how many
    pixels the NPM override relabelled, of how many.

    ``fused_blocks`` (no CLI flag, as ``cli/eval_ood.main``): the
    backbone's eligible bottlenecks run through the fused kernel."""
    if cfg.FEWSHOT.calibrate_scores:
        raise NotImplementedError(
            "FEWSHOT.calibrate_scores needs openset/calibration.py, which "
            "is not ported yet; ROADMAP.md queues it")
    model, num_classes = build_deeplab_model(cfg, device,
                                             fused_blocks=fused_blocks)
    init_or_load_deeplab(
        model, cfg.MODEL.weights_encoder or cfg.MODEL.weights_decoder)
    dev = next(model.parameters()).device
    _, val_tf = get_transforms(cfg.DEEPLAB.crop_size)
    val_ds = Cityscapes(cfg.DATASET.root_dataset, split=split,
                        transform=val_tf,
                        unknown_target=tuple(cfg.DEEPLAB.unknown_target))

    prototype = torch.from_numpy(
        load_prototypes(cfg.FEWSHOT.prototype_file)).to(dev)
    novel_id = num_classes  # 16
    threshold = cfg.FEWSHOT.npm_dis_threshold
    metrics = StreamSegMetrics(num_classes + 1)
    metrics.reset()
    novel = torch.zeros((), dtype=torch.int64, device=dev)
    pixels = 0

    @torch.inference_mode()
    def dispatch(batch):
        nonlocal novel, pixels
        with autocast(dev, precision_dtype):
            logits, _, features = model(batch["image"])
        preds = logits.argmax(-1)
        new_preds, _ = npm_override(preds[0], features[0], logits[0],
                                    prototype, novel_id=novel_id,
                                    dis_threshold=threshold)
        remapped = npm_label_remap(batch["label"][0], novel_id=novel_id)
        novel = novel + (new_preds == novel_id).sum()
        pixels += new_preds.numel()
        # labels and predictions lie in 0..255: one byte each to the host
        return 1, to_host_async([new_preds.to(torch.uint8),
                                 remapped.to(torch.uint8)]), None

    def resolve(arrays, _):
        preds, labels = arrays
        metrics.update(labels[None].astype(np.int64), preds[None])

    batches = ({"image": image, "label": target.astype(np.int32)}
               for image, target, _ in batch_iterator(
                   val_ds, 1, shuffle=False, drop_last=False, epochs=1))
    # decode in a thread, pinned copies with two images in flight
    n, clock = double_buffered(prefetch_to_device(batches, dev), dispatch,
                               resolve, max_images=max_images)
    score = metrics.get_results()
    print(StreamSegMetrics.to_str(score))
    score.update(
        images=n, seconds=clock["total"],
        device_s_per_img=clock["device"] / max(n, 1),
        wait_s_per_img=clock["wait"] / max(n, 1),
        metric_s_per_img=clock["host"] / max(n, 1),
        novel_pixels=int(novel), pixels=pixels)
    return score


def _entry():
    parser = config_parser(__doc__)
    parser.add_argument("--max-images", type=int, default=None,
                        help="evaluate only the first N images")
    args = parser.parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), max_images=args.max_images,
         device=args.device)


if __name__ == "__main__":
    _entry()
