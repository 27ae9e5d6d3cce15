"""AOT export of the eval computation with ``torch.export``.

The port's counterpart of the JAX package's ``core/export.py``: the whole
eval computation (forward, score upsample, OOD confidence and argmax) is
traced once and saved WITH the weights. The artifact loads and runs with
``torch`` alone, no model-building code.

File format: the JAX package's framing, a magic line, one JSON line of
metadata, then the payload, with a magic line of the port's own. The payload
is ``torch.export.save`` of the program into bytes. A JAX StableHLO artifact
cannot run here, and reading one raises ``ValueError`` saying what it is.

A program runs on the device it was traced on: the metadata's
``platforms`` names it (``cuda`` or ``cpu``; ``cli/export_model.py`` writes
it), and ``load_exported`` puts the program there. A bf16 artifact holds its
forward inside ``torch.autocast``, as the eval runs it. The fused backbone
route launches its kernel through ctypes, which ``torch.export`` cannot
trace: export refuses a model with routed blocks. A prequantized int8
model (``ops/quant.py``) exports as it is: its int8 weights become int8
constants of the program, its ``amax`` / ``w_scale`` constants too, and
its convs ``aten._int_mm`` on CUDA (a float64 conv of the integers on the
CPU).

Usage:
    blob = export_eval_fn(model, (720, 1280), dtype=torch.bfloat16)
    save_exported("model.owss", blob, {"platforms": ["cuda"]})
    fn, meta = load_exported("model.owss")   # callable(img[B,H,W,3]) ->
    pred, conf = fn(img)                     #   (uint8 labels, f16 conf)
"""

from __future__ import annotations

import io
import json
import os
from typing import Optional, Sequence, Tuple

import torch

MAGIC = b"OWSS-TORCH-EXPORT-v1\n"
# the JAX package's magic line: its StableHLO artifacts
JAX_MAGIC = b"OWSS-EXPORT-v1\n"


def _conf_fn(method: str):
    """method name -> per-image confidence function (None = labels only)."""
    from ..openset import scoring

    return {
        "dissum": scoring.dissum_conf,
        "msp": scoring.msp_conf,
        "maxlogit": scoring.maxlogit_conf,
        "none": None,
    }[method]


def _model_device(model) -> torch.device:
    """The device of ``model``'s parameters; refuses the fused route."""
    if any(getattr(m, "fused_tile", None) is not None
           for m in model.modules()):
        raise ValueError(
            "the fused backbone route launches its kernel through ctypes, "
            "which torch.export cannot trace: export the unfused model "
            "(fused_blocks=False)")
    return next(model.parameters()).device


def _autocast(device: torch.device, dtype):
    return torch.autocast(device.type, dtype=dtype,
                          enabled=dtype != torch.float32)


def _export(module, args) -> bytes:
    with torch.no_grad():
        program = torch.export.export(module.eval(), tuple(args))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


class _PyramidEval(torch.nn.Module):
    """One forward per scale, the scores summed in the model dtype and
    divided once in float32, then argmax and the per-image confidence."""

    def __init__(self, model, full_size, method, dtype, device):
        super().__init__()
        self.model = model
        self.full_size = tuple(full_size)
        self.conf_fn = _conf_fn(method)
        self.dtype = dtype
        self.device = device

    def forward(self, *pyramid):
        with _autocast(self.device, self.dtype):
            scores = None
            for img in pyramid:
                s = self.model(img, seg_size=self.full_size)["scores"]
                # the sum in the model dtype (the JAX package's bench.py
                # convention), not the evaluator's divide-then-sum
                scores = s if scores is None else scores + s
        scores = scores.float() / len(pyramid)
        pred = scores.argmax(-1).to(torch.uint8)
        if self.conf_fn is None:
            return pred
        conf = torch.stack([self.conf_fn(s) for s in scores.unbind(0)])
        return pred, conf.to(torch.float16)


def export_eval_fn(model, input_size: Tuple[int, int], batch: int = 1,
                   method: str = "dissum", dtype=torch.float32) -> bytes:
    """Serialize the eval computation of ``model`` (on its device) at one
    input size: the single-scale case of :func:`export_pyramid_eval_fn`.

    ``method``: the OOD confidence baked in, "dissum", "msp", "maxlogit" or
    "none" (labels only). ``dtype``: bfloat16 runs the forward under
    autocast over the float32 parameters."""
    return export_pyramid_eval_fn(model, [input_size], input_size,
                                  batch=batch, method=method, dtype=dtype)


def export_pyramid_eval_fn(model, pyramid_shapes: Sequence[Tuple[int, int]],
                           full_size: Tuple[int, int], batch: int = 1,
                           method: str = "dissum",
                           dtype=torch.float32) -> bytes:
    """Serialize the multi-scale eval as ONE program: one float32
    ``(batch, h_i, w_i, 3)`` input per scale, in ``pyramid_shapes`` order,
    scores averaged at ``full_size``; returns ``(uint8 labels, f16 conf)``
    (labels only for method "none")."""
    device = _model_device(model)
    module = _PyramidEval(model, full_size, method, dtype, device)
    args = [torch.zeros((batch, h, w, 3), device=device)
            for h, w in pyramid_shapes]
    return _export(module, args)


class _NPMEval(torch.nn.Module):
    def __init__(self, model, novel_id, dis_threshold, dtype, device):
        super().__init__()
        self.model = model
        self.novel_id = novel_id
        self.dis_threshold = dis_threshold
        self.dtype = dtype
        self.device = device

    def forward(self, image, prototype):
        from ..fewshot.prototypes import npm_override

        with _autocast(self.device, self.dtype):
            logits, _, features = self.model(image)
        preds = logits.argmax(-1)
        outs = [npm_override(p, f, lg, prototype, novel_id=self.novel_id,
                             dis_threshold=self.dis_threshold)
                for p, f, lg in zip(preds.unbind(0), features.unbind(0),
                                    logits.unbind(0))]
        return (torch.stack([o[0] for o in outs]).to(torch.uint8),
                torch.stack([o[1] for o in outs]).to(torch.float16))


def export_npm_eval_fn(model, input_size: Tuple[int, int], batch: int = 1,
                       novel_id: int = 16, dis_threshold: float = -1.5,
                       dtype=torch.float32):
    """Serialize the NPM (novel-prototype matching) 16+1 inference of a
    DeepLab embedding model with the PROTOTYPE as a runtime input, so one
    artifact serves every few-shot class and shot count.

    Calling convention: ``fn(image (B,H,W,3) f32, prototype (C,) f32) ->
    (uint8 preds (B,H,W), f16 distance map (B,H,W))``. Returns
    ``(blob, feat_dim)``."""
    device = _model_device(model)
    with torch.no_grad():
        _, _, features = model.eval()(torch.zeros((1, 64, 64, 3),
                                                  device=device))
    feat_dim = int(features.shape[-1])
    module = _NPMEval(model, novel_id, dis_threshold, dtype, device)
    h, w = input_size
    args = [torch.zeros((batch, h, w, 3), device=device),
            torch.zeros((feat_dim,), device=device)]
    return _export(module, args), feat_dim


def save_exported(path: str, blob: bytes, meta: Optional[dict] = None):
    """Write MAGIC + JSON metadata line + the serialized program, stamped
    with the artifact ``format`` and the package and torch versions;
    caller-provided keys win."""
    from .. import __version__

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    stamped = {"format": 1, "owss_version": __version__,
               "torch_version": torch.__version__}
    stamped.update(meta or {})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(json.dumps(stamped).encode() + b"\n")
        f.write(blob)
    os.replace(tmp, path)


def _read_header(f, path: str) -> dict:
    magic = f.read(len(MAGIC))
    if magic.startswith(JAX_MAGIC):
        raise ValueError(
            f"{path} is a JAX StableHLO artifact (written by the JAX "
            "package's core/export.py), which the port cannot run: export "
            "it again with the port's cli/export_model")
    if magic != MAGIC:
        raise ValueError(f"{path} is not an OWSS export artifact")
    return json.loads(f.readline())


def read_meta(path: str) -> dict:
    """Read ONLY the metadata header: the payload is never read."""
    with open(path, "rb") as f:
        return _read_header(f, path)


def read_program(path: str):
    """``(ExportedProgram, meta)`` of an artifact, on the devices it was
    saved from."""
    with open(path, "rb") as f:
        meta = _read_header(f, path)
        blob = f.read()
    return torch.export.load(io.BytesIO(blob)), meta


def artifact_device(meta: dict, device=None) -> torch.device:
    """The device an artifact runs on: that of its metadata's
    ``platforms``, which ``device``, if given, must name. An artifact
    without ``platforms`` is refused: the exporter always writes it."""
    from .device import resolve_device

    platforms = meta.get("platforms")
    if not platforms:
        raise ValueError("the artifact's metadata names no 'platforms': "
                         "the device its program was traced on is unknown")
    device = resolve_device(platforms[0] if device is None else device)
    if device.type not in platforms:
        raise ValueError(
            f"the artifact was exported for {platforms}; a torch.export "
            f"program runs on the device it was traced on, not on "
            f"{device.type}")
    return device


def load_exported(path: str, device=None):
    """Load an artifact; returns ``(callable, meta)``. The program goes to
    ``artifact_device``; the callable runs it under
    ``torch.inference_mode``."""
    device = artifact_device(read_meta(path), device)
    program, meta = read_program(path)
    module = program.module().to(device)

    def run(*args):
        with torch.inference_mode():
            return module(*args)
    return run, meta
