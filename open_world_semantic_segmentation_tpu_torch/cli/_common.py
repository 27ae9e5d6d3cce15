"""Shared CLI plumbing for the driver scripts."""

from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist

from ..core.config import Config, load_config
from ..core.device import resolve_device
from ..parallel.mesh import replicas_agree


def config_parser(description: str) -> argparse.ArgumentParser:
    """yacs-style CLI: --cfg preset.yaml plus trailing KEY VALUE pairs."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", metavar="FILE", default=None,
                   help="path to a YAML config preset")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="bf16",
                   help="compute dtype (parameters stay fp32)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu must be "
                        "asked for)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                   help="config overrides: SECTION.key value ...")
    return p


def announce_ranks(rank: int, world: int):
    """Rank 0 of a process group says how many ranks train, over which
    backend."""
    if rank == 0 and dist.is_initialized():
        print(f"data parallel: {world} rank{'s' if world > 1 else ''}, "
              f"backend {dist.get_backend()}", flush=True)


def check_replicas(model, world: int, lead: bool):
    """Over more than one rank: raise unless every rank holds the same
    bits in every parameter and buffer of ``model``."""
    if world == 1:
        return
    if not replicas_agree(list(model.parameters())
                          + list(model.buffers())):
        raise RuntimeError("the ranks' parameters or buffers differ")
    if lead:
        print(f"replicas: {world} ranks bit-identical", flush=True)


def leave_ranks():
    """End a rank's process after its entry point returned: with a process
    group alive, flush the output and leave with ``os._exit(0)``, neither
    tearing the group down (``destroy_process_group`` can hang after the
    last collective) nor finalising the interpreter with it alive (gloo's
    threads can abort it then: "terminate called without an active
    exception" after a 2-rank ``main_deeplab`` on an H100). Every file the
    entry point wrote is closed by then. Without a group, nothing."""
    if dist.is_initialized():
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)


def parse_config(args) -> Config:
    return load_config(args.cfg, args.opts or ())


def compute_dtype(args):
    """bf16: autocast compute over fp32 parameters. fp32: true fp32, so TF32
    is switched off for cuDNN convs and CUDA matmuls alike."""
    if args.precision == "bf16":
        return torch.bfloat16
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.float32


def build_anomaly_model(cfg: Config, device=None, fused_blocks: bool = False,
                        train: bool = False, use_softmax: bool = False,
                        quant: str = "off"):
    """The config's encoder + decoder on ``device`` (channels last on CUDA,
    the layout cuDNN's convs prefer), in training mode if ``train`` else in
    eval mode. ``fused_blocks`` routes the backbone's eligible bottlenecks
    through the fused kernel (eval mode only). ``use_softmax``: the
    decoders that take it (C1, C1DeepSup, PPM, UPerNet) return softmax
    probabilities at inference; the inference CLIs ask for it, as the
    JAX package's do, so a multi-scale eval averages probabilities.
    ``quant``: an int8 PTQ mode (``ops/quant.py``; ``calibrate_for_quant``
    prepares the model)."""
    from ..models.builder import ModelBuilder

    device = resolve_device(device)
    model = ModelBuilder.build_segmentation_model(
        cfg.MODEL.arch_encoder, cfg.MODEL.arch_decoder,
        num_class=cfg.DATASET.num_class, fc_dim=cfg.MODEL.fc_dim,
        use_softmax=use_softmax, fused_blocks=fused_blocks, train=train,
        quant=quant)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def _load_pth(path: str):
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    # DataParallel prefixes; the reference's decoder may also carry its
    # one-hot ``centers``, which the port rebuilds from the class count
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items() if k != "centers"}


def init_or_load_variables(cfg: Config, model, *, seed: int = 0):
    """Initialise ``model`` from a seeded generator; if MODEL.weights_encoder
    and weights_decoder name the reference's ``.pth`` pair, load them; if
    either names a JAX ``*.pkl`` checkpoint, load that."""
    from ..models.builder import init_weights

    enc_w, dec_w = cfg.MODEL.weights_encoder, cfg.MODEL.weights_decoder
    if enc_w.endswith(".pkl") or dec_w.endswith(".pkl"):
        from ..train.checkpoint import load_jax_checkpoint

        enc, dec = load_jax_checkpoint(enc_w if enc_w.endswith(".pkl")
                                       else dec_w)
    elif enc_w or dec_w:
        if not (enc_w.endswith(".pth") and dec_w.endswith(".pth")):
            raise ValueError(
                "MODEL.weights_encoder / weights_decoder: give the "
                "encoder/decoder .pth pair or a JAX .pkl checkpoint")
        enc, dec = _load_pth(enc_w), _load_pth(dec_w)
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
        return model
    model.encoder.load_state_dict(enc)
    model.decoder.load_state_dict(dec)
    return model


def calibrate_quant_model(cfg: Config, model, groups, *, quant: str,
                          dtype=torch.float32, use_softmax: bool = False):
    """Prepare ``model`` (built with ``quant``, its weights loaded) for the
    int8 eval: a ``calib`` twin with the same weights records the
    activation scales over ``groups``, ``(images, seg_size)`` pairs (NHWC
    arrays, one forward each), then ``ops.quant.apply_quant_state``
    prequantizes ``model`` or, under ``w4a8``, gives it the scales alone.
    Returns ``model``."""
    from ..ops.quant import apply_quant_state, calibrate

    device = next(model.parameters()).device
    calib = build_anomaly_model(cfg, device, use_softmax=use_softmax,
                                quant="calib")
    calib.load_state_dict(model.state_dict())
    state = {}
    for images, seg_size in groups:
        state = calibrate(calib, images, seg_size=seg_size, dtype=dtype)
    del calib
    return apply_quant_state(model, state, quant)


def calibrate_for_quant(cfg: Config, model, size, *, dtype=torch.float32,
                        use_softmax: bool, calib_glob: str = None,
                        n_noise: int = 4, quant: str = "int8"):
    """Calibrate the int8 activation scales of ``model`` at ``size`` (H, W)
    and prequantize its weights (``calibrate_quant_model``): on the images
    ``calib_glob`` matches (the first 16, sorted; resized and normalised
    as the server does), or, without a glob, on ``n_noise`` images of
    seeded white noise in the normalised range. A glob that matches
    nothing raises rather than calibrate on noise. Returns ``model``."""
    import glob as globmod

    import numpy as np

    from ..data.native import resize_normalize

    imgs = []
    if calib_glob:
        from PIL import Image

        matched = sorted(globmod.glob(calib_glob))
        if not matched:
            raise FileNotFoundError(
                f"--calib-glob {calib_glob!r} matched no files: refusing "
                "to calibrate on white noise instead")
        for p in matched[:16]:
            with Image.open(p) as im:
                rgb = np.asarray(im.convert("RGB"))
            imgs.append(resize_normalize(rgb, tuple(size))[None])
        print(f"int8 calibration: {len(imgs)} image(s) used "
              f"({len(matched)} matched {calib_glob!r}, cap 16)")
    if not imgs:
        rng = np.random.default_rng(0)
        imgs = [rng.standard_normal((1, *size, 3)).astype(np.float32)
                for _ in range(n_noise)]
    return calibrate_quant_model(cfg, model, [(imgs, tuple(size))],
                                 quant=quant, dtype=dtype,
                                 use_softmax=use_softmax)


def epoch_checkpoint_path(cfg: Config, kind: str, epoch: int) -> str:
    """``cfg.DIR/<kind>_epoch_<epoch>.pth`` (kind: encoder or decoder), the
    reference's checkpoint names."""
    os.makedirs(cfg.DIR, exist_ok=True)
    return os.path.join(cfg.DIR, f"{kind}_epoch_{epoch}.pth")
