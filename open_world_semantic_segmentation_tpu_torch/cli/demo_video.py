"""Streaming video segmentation demo (the reference's demo_video.py, plus a
live mode).

Two modes, as in the JAX package's ``cli/demo_video.py``:
- ``overlay`` (demo_video.py:48-74): blend saved per-frame prediction PNGs
  with the Cityscapes ``demo_video`` split's frames and write a video (cv2
  when it is installed, else an image-sequence directory);
- ``live``: run the DeepLab model of ``DEEPLAB.model`` frame by frame on
  the device (the frame normalised there, the argmax taken there) and
  write the blended frames into ``<out>.frames``. It runs on ``cuda``
  unless ``--device cpu`` is given; ``fused_blocks`` (a Python keyword, no
  CLI flag) routes the backbone's eligible bottlenecks through the fused
  kernel.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from ._common import compute_dtype, config_parser, parse_config
from ..data.cityscapes import Cityscapes, decode_target


def _frames(cfg, split="demo_video"):
    return Cityscapes(cfg.DATASET.root_dataset, split=split, transform=None,
                      unknown_target=None)


def overlay_mode(cfg, preds_dir, out_path, alpha=0.5, max_frames=None):
    ds = _frames(cfg)
    writer = None
    seq_dir = None
    try:
        import cv2
    except ImportError:
        cv2 = None
        seq_dir = out_path + ".frames"
        os.makedirs(seq_dir, exist_ok=True)

    n = len(ds.images) if max_frames is None else min(max_frames,
                                                      len(ds.images))
    for i in range(n):
        frame = np.array(Image.open(ds.images[i]).convert("RGB"))
        name = os.path.basename(ds.images[i])
        pred_path = os.path.join(preds_dir, name)
        if not os.path.exists(pred_path):
            continue
        pred = np.array(Image.open(pred_path))
        color = decode_target(pred.astype(np.int64)).astype(np.uint8)
        blend = (alpha * frame + (1 - alpha) * color).astype(np.uint8)
        if cv2 is not None:
            if writer is None:
                h, w = blend.shape[:2]
                writer = cv2.VideoWriter(
                    out_path, cv2.VideoWriter_fourcc(*"MJPG"), 17, (w, h))
            writer.write(blend[:, :, ::-1])
        else:
            Image.fromarray(blend).save(os.path.join(seq_dir, name))
    if writer is not None:
        writer.release()
    print("wrote", out_path if cv2 is not None else seq_dir)


def live_mode(cfg, out_path, precision_dtype, max_frames=None, model=None,
              device=None, fused_blocks: bool = False):
    """Segment the ``demo_video`` frames with ``model`` (else the config's
    DeepLab model, with the weights of MODEL.weights_encoder or
    weights_decoder, or seeded random ones) and write each frame blended
    with its colour-coded prediction. Returns the frames' directory."""
    from .main_deeplab import (autocast, build_deeplab_model,
                               init_or_load_deeplab)
    from ..data.odgt import device_normalize

    if model is None:
        model, _ = build_deeplab_model(cfg, device,
                                       fused_blocks=fused_blocks)
        init_or_load_deeplab(model, cfg.MODEL.weights_encoder
                             or cfg.MODEL.weights_decoder)
    dev = next(model.parameters()).device
    ds = _frames(cfg)
    seq_dir = out_path + ".frames"
    os.makedirs(seq_dir, exist_ok=True)
    n = len(ds.images) if max_frames is None else min(max_frames,
                                                      len(ds.images))
    for i in range(n):
        frame = np.array(Image.open(ds.images[i]).convert("RGB"))
        with torch.inference_mode(), autocast(dev, precision_dtype):
            x = device_normalize(torch.from_numpy(frame[None]).to(dev))
            out = model(x)
            logits = out[0] if isinstance(out, tuple) else out
            if isinstance(logits, (list, tuple)):
                logits = logits[0]
            pred = logits.argmax(-1)[0].cpu().numpy()
        color = decode_target(pred.astype(np.int64)).astype(np.uint8)
        blend = (0.5 * frame + 0.5 * color).astype(np.uint8)
        Image.fromarray(blend).save(
            os.path.join(seq_dir, os.path.basename(ds.images[i])))
    print("wrote", seq_dir)
    return seq_dir


def main(argv=None):
    parser = config_parser(__doc__)
    parser.add_argument("--mode", choices=["overlay", "live"],
                        default="overlay")
    parser.add_argument("--preds-dir", default="./test_results/demo_video")
    parser.add_argument("--out", default="./video_demo.avi")
    parser.add_argument("--max-frames", type=int, default=None)
    args = parser.parse_args(argv)
    cfg = parse_config(args)
    if args.mode == "overlay":
        overlay_mode(cfg, args.preds_dir, args.out,
                     max_frames=args.max_frames)
    else:
        live_mode(cfg, args.out, compute_dtype(args),
                  max_frames=args.max_frames, device=args.device)


if __name__ == "__main__":
    main()
