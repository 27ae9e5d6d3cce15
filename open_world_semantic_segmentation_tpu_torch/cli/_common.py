"""Shared CLI plumbing for the driver scripts."""

from __future__ import annotations

import argparse
import os

import torch

from ..core.config import Config, load_config
from ..core.device import resolve_device


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
                        train: bool = False, use_softmax: bool = False):
    """The config's encoder + decoder on ``device`` (channels last on CUDA,
    the layout cuDNN's convs prefer), in training mode if ``train`` else in
    eval mode. ``fused_blocks`` routes the backbone's eligible bottlenecks
    through the fused kernel (eval mode only). ``use_softmax``: the
    decoders that take it (C1, C1DeepSup, PPM, UPerNet) return softmax
    probabilities at inference; the inference CLIs ask for it, as the
    JAX package's do, so a multi-scale eval averages probabilities."""
    from ..models.builder import ModelBuilder

    device = resolve_device(device)
    model = ModelBuilder.build_segmentation_model(
        cfg.MODEL.arch_encoder, cfg.MODEL.arch_decoder,
        num_class=cfg.DATASET.num_class, fc_dim=cfg.MODEL.fc_dim,
        use_softmax=use_softmax, fused_blocks=fused_blocks)
    model = model.train(train).to(device)
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


def epoch_checkpoint_path(cfg: Config, kind: str, epoch: int) -> str:
    """``cfg.DIR/<kind>_epoch_<epoch>.pth`` (kind: encoder or decoder), the
    reference's checkpoint names."""
    os.makedirs(cfg.DIR, exist_ok=True)
    return os.path.join(cfg.DIR, f"{kind}_epoch_{epoch}.pth")
