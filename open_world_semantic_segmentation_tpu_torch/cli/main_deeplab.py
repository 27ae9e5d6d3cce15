"""DeepLab on Cityscapes: the eval surface of the JAX package's
``cli/main_deeplab.py`` (the reference's main.py / main_embedding.py).

Usage (eval only; ``DEEPLAB.test_only True`` runs ``cli/test_deeplab.py``):
  python -m open_world_semantic_segmentation_tpu_torch.cli.main_deeplab \
      DEEPLAB.test_only True DEEPLAB.ckpt best.pth ...

``MODEL_MAP`` names the ported factories; ``build_deeplab_model`` gives the
config's model on a device (cuda unless asked otherwise), in eval mode and
channels_last on CUDA; the CLIs run it under bf16 autocast with
``--precision bf16`` (``autocast``). Checkpoints: the reference's ``.pth``
loads natively, the JAX package's pickle through the weight bridge
(``train/checkpoint.py load_deeplab_state``). ``double_buffered`` is the
eval loop the CLIs share. The training loop, the train transforms, the
MobileNet and self-distillation models wait for DeepLab training
(``ROADMAP.md``).
"""

from __future__ import annotations

import time

import torch

from ._common import compute_dtype, config_parser, parse_config
from ..core.device import resolve_device
from ..data import transforms as et
from ..data.cityscapes import Cityscapes
from ..models import deeplab as deeplab_models

MODEL_MAP = {
    "deeplabv3plus_resnet101": deeplab_models.deeplabv3plus_resnet101,
    "deeplabv3plus_resnet50": deeplab_models.deeplabv3plus_resnet50,
    "deeplabv3_resnet101": deeplab_models.deeplabv3_resnet101,
    "deeplabv3plus_embedding_resnet101":
        deeplab_models.deeplabv3plus_embedding_resnet101,
    "deeplabv3plus_embedding_resnet50":
        deeplab_models.deeplabv3plus_embedding_resnet50,
}


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet; ROADMAP.md "
                               "queues it")


def get_transforms(crop_size: int, dataset: str = "cityscapes"):
    """(train transform, val transform). The train transform is None until
    DeepLab training is ported; the val transform is ExtToTensor then
    ExtNormalize."""
    if dataset != "cityscapes":
        raise _not_ported(f"dataset {dataset!r}")
    return None, et.ExtCompose([et.ExtToTensor(), et.ExtNormalize()])


def _unknown_target(cfg):
    """Embedding models always evaluate open-world; DEEPLAB.unknown_scores
    turns the remap on for plain models too."""
    d = cfg.DEEPLAB
    if "embedding" in d.model or d.unknown_scores:
        return tuple(d.unknown_target)
    return None


def get_val_dataset(cfg, val_tf):
    """The val split only: an eval must not need the train tree."""
    if cfg.DEEPLAB.dataset != "cityscapes":
        raise _not_ported(f"dataset {cfg.DEEPLAB.dataset!r}")
    return Cityscapes(cfg.DATASET.root_dataset, split="val",
                      transform=val_tf, unknown_target=_unknown_target(cfg))


def build_model(cfg, *, fused_blocks: bool = False):
    """(model, num_classes) for ``DEEPLAB.model``: 16 classes for the
    embedding models, 19 otherwise, unless DEEPLAB.num_classes is set."""
    d = cfg.DEEPLAB
    if d.model not in MODEL_MAP:
        raise _not_ported(f"DEEPLAB.model {d.model!r}")
    num_classes = d.num_classes or (16 if "embedding" in d.model else 19)
    model = MODEL_MAP[d.model](num_classes=num_classes,
                               output_stride=d.output_stride,
                               fused_blocks=fused_blocks)
    return model, num_classes


def build_deeplab_model(cfg, device=None, fused_blocks: bool = False):
    """(model, num_classes): the config's model on ``device`` in eval mode,
    channels_last on CUDA. ``fused_blocks`` routes the backbone's eligible
    bottlenecks through the fused kernel."""
    device = resolve_device(device)
    model, num_classes = build_model(cfg, fused_blocks=fused_blocks)
    model = model.eval().to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model, num_classes


def init_or_load_deeplab(model, path: str = "", *, seed: int = 0):
    """Seeded random weights (the JAX package's schemes), or the checkpoint
    at ``path``: a reference ``.pth`` or a JAX pickle."""
    if not path:
        return deeplab_models.init_deeplab_weights(
            model, torch.Generator().manual_seed(seed))
    from ..train.checkpoint import load_deeplab_state

    model.load_state_dict(load_deeplab_state(path))
    return model


def autocast(device: torch.device, dtype):
    """bf16 autocast over the float32 parameters, or nothing for float32."""
    return torch.autocast(device.type, dtype=dtype,
                          enabled=dtype != torch.float32)


def to_host_async(tensors):
    """Start copying ``tensors`` to the host; returns a function that
    waits for the copies and returns numpy arrays. On CUDA the copies go
    to pinned memory behind the work already queued, so waiting for them
    does not wait for work queued later."""
    if tensors[0].device.type != "cuda":
        return lambda: [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return [h.numpy() for h in host]
    return wait


def double_buffered(batches, dispatch, resolve, max_images=None):
    """The eval loop: ``dispatch(batch)`` queues one batch on the device
    and returns ``(n_images, wait_fn, context)``, ``wait_fn`` as
    ``to_host_async`` returns it; ``resolve(arrays, context)`` consumes it
    on the host. Batch k is dispatched before batch k-1 is resolved, so
    the host's work on k-1 overlaps the device's work on k.

    Returns the image count and the loop's seconds: ``wait`` blocked on
    the loader, ``device`` in dispatch and waiting for the copies,
    ``host`` in resolve, and ``total``."""
    clock = dict.fromkeys(("wait", "device", "host"), 0.0)
    start = time.perf_counter()

    def finish(entry):
        wait_fn, context = entry
        tic = time.perf_counter()
        arrays = wait_fn()
        mid = time.perf_counter()
        resolve(arrays, context)
        clock["device"] += mid - tic
        clock["host"] += time.perf_counter() - mid

    inflight = None
    count = 0
    it = iter(batches)
    while max_images is None or count < max_images:
        tic = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        mid = time.perf_counter()
        n, wait_fn, context = dispatch(batch)
        clock["wait"] += mid - tic
        clock["device"] += time.perf_counter() - mid
        if inflight is not None:
            finish(inflight)
        inflight = (wait_fn, context)
        count += n
    if inflight is not None:
        finish(inflight)
    clock["total"] = time.perf_counter() - start
    return count, clock


def main(cfg, precision_dtype=torch.bfloat16, max_images=None, device=None):
    """DEEPLAB.test_only: the eval-only surface (``cli/test_deeplab.py``).
    Training is not ported yet."""
    if not cfg.DEEPLAB.test_only:
        raise _not_ported("DeepLab training")
    from . import test_deeplab

    return test_deeplab.main(cfg, precision_dtype, max_images=max_images,
                             device=device)


def _entry():
    args = config_parser(__doc__).parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), device=args.device)


if __name__ == "__main__":
    _entry()
