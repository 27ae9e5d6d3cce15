"""Export the eval model as a self-contained AOT artifact (torch.export).

The artifact holds the weights and the whole eval computation (forward,
score upsample, OOD confidence and argmax) as a ``torch.export`` program;
it loads with ``core.export.load_exported`` and runs with no model code, on
the device it was exported on (``--device``, recorded as ``platforms``).
Export always builds the unfused backbone: the fused route launches its
kernel through ctypes, which ``torch.export`` cannot trace, and
``core/export.py`` refuses a model on it. ``--quant`` (int8, int8-hybrid,
int8-3x3; ``ops/quant.py``) exports the int8 PTQ model: its activation
scales calibrated at the export size on the images ``--calib-glob``
matches (or on white noise), its weights prequantized, so the artifact
holds int8 weight constants, the scales, and the int8 convs as
``aten._int_mm`` on CUDA (a float64 conv of the integer values on the
CPU); the header's ``quant`` names the mode.

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.export_model \
      --cfg configs/test_ood_street.yaml --height 720 --width 1280 \
      --out model.owss [--method dissum] [--pyramid | --npm]
"""

from __future__ import annotations

import torch

from ._common import (
    build_anomaly_model,
    calibrate_for_quant,
    compute_dtype,
    config_parser,
    init_or_load_variables,
    parse_config,
)
from .serve import QUANT_MODES, check_quant
from ..core.export import (
    export_eval_fn,
    export_npm_eval_fn,
    export_pyramid_eval_fn,
    save_exported,
)


def _export_npm(cfg, precision_dtype, height, width, batch, device, out):
    """--npm: the few-shot NPM 16+1 inference (cli/eval_embedding.py)
    with the prototype as a runtime input of the artifact."""
    from .main_deeplab import build_deeplab_model, init_or_load_deeplab

    model, num_classes = build_deeplab_model(cfg, device)
    init_or_load_deeplab(model, cfg.MODEL.weights_encoder
                         or cfg.MODEL.weights_decoder)
    blob, feat_dim = export_npm_eval_fn(
        model, (height, width), batch=batch, novel_id=num_classes,
        dis_threshold=cfg.FEWSHOT.npm_dis_threshold, dtype=precision_dtype)
    meta = {
        "model": cfg.DEEPLAB.model,
        "input": [batch, height, width, 3],
        "npm": True,
        "prototype_dim": feat_dim,
        "novel_id": num_classes,
        "dis_threshold": float(cfg.FEWSHOT.npm_dis_threshold),
        "platforms": [next(model.parameters()).device.type],
    }
    save_exported(out, blob, meta)
    print(f"exported NPM {meta['model']} ({len(blob) / 1e6:.1f} MB) -> {out}")
    return out


def main(cfg, precision_dtype=torch.bfloat16, height=720, width=1280,
         batch=1, method="dissum", out="model.owss", quant="off",
         pyramid=False, npm=False, device=None, calib_glob=None):
    """``pyramid=True`` exports the multi-scale eval (one forward per
    cfg.DATASET.imgSizes scale, scores averaged at (height, width), conf +
    argmax) as one artifact; otherwise a single-scale forward at (height,
    width). ``npm=True`` exports the few-shot NPM pipeline instead (the
    prototype a runtime input). ``quant``: an int8 PTQ mode, calibrated
    at (height, width) on the images ``calib_glob`` matches."""
    check_quant(quant)
    if npm:
        if quant != "off":
            raise ValueError("--npm exports the DeepLab NPM pipeline, "
                             "which has no --quant")
        return _export_npm(cfg, precision_dtype, height, width, batch,
                           device, out)
    model = build_anomaly_model(cfg, device, use_softmax=True, quant=quant)
    init_or_load_variables(cfg, model)
    if quant != "off":
        calibrate_for_quant(cfg, model, (height, width),
                            dtype=precision_dtype, use_softmax=True,
                            calib_glob=calib_glob, quant=quant)
    if pyramid:
        from ..data.odgt import eval_pyramid_shapes

        shapes = eval_pyramid_shapes(
            height, width, cfg.DATASET.imgSizes, cfg.DATASET.imgMaxSize,
            cfg.DATASET.padding_constant)
        blob = export_pyramid_eval_fn(
            model, shapes, (height, width), batch=batch, method=method,
            dtype=precision_dtype)
        input_spec = [[batch, h, w, 3] for h, w in shapes]
    else:
        blob = export_eval_fn(model, (height, width), batch=batch,
                              method=method, dtype=precision_dtype)
        input_spec = [batch, height, width, 3]
    meta = {
        "model": f"{cfg.MODEL.arch_encoder}+{cfg.MODEL.arch_decoder}",
        "input": input_spec,
        "full_size": [height, width],
        "pyramid": bool(pyramid),
        "method": method,
        "quant": quant,
        "platforms": [next(model.parameters()).device.type],
    }
    save_exported(out, blob, meta)
    print(f"exported {meta['model']} ({len(blob) / 1e6:.1f} MB) -> {out}")
    return out


def _entry(argv=None):
    parser = config_parser(__doc__)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--method", default="dissum",
                        choices=["dissum", "msp", "maxlogit", "none"])
    parser.add_argument("--out", default="model.owss")
    parser.add_argument("--quant", choices=QUANT_MODES, default="off",
                        help="export the int8 PTQ model (ops/quant.py)")
    parser.add_argument("--calib-glob", default=None,
                        help="glob of representative images for the int8 "
                             "activation calibration")
    parser.add_argument("--pyramid", action="store_true",
                        help="export the full multi-scale eval pipeline "
                             "(one input per DATASET.imgSizes scale)")
    parser.add_argument("--npm", action="store_true",
                        help="export the few-shot NPM override pipeline "
                             "(DEEPLAB.model embedding net; prototype is a "
                             "runtime input)")
    args = parser.parse_args(argv)
    cfg = parse_config(args)
    return main(cfg, compute_dtype(args), args.height, args.width,
                args.batch, args.method, args.out, quant=args.quant,
                pyramid=args.pyramid, npm=args.npm, device=args.device,
                calib_glob=args.calib_glob)


if __name__ == "__main__":
    _entry()
