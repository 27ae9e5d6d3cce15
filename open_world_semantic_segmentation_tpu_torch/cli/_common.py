"""Shared CLI plumbing for the driver scripts."""

from __future__ import annotations

import argparse

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


def build_anomaly_model(cfg: Config, device=None, fused_blocks: bool = False):
    """The config's encoder + decoder, in eval mode on ``device`` (channels
    last on CUDA, the layout cuDNN's convs prefer). ``fused_blocks`` routes
    the backbone's eligible bottlenecks through the fused kernel."""
    from ..models.builder import ModelBuilder

    device = resolve_device(device)
    model = ModelBuilder.build_segmentation_model(
        cfg.MODEL.arch_encoder, cfg.MODEL.arch_decoder,
        num_class=cfg.DATASET.num_class, fc_dim=cfg.MODEL.fc_dim,
        fused_blocks=fused_blocks)
    model = model.eval().to(device)
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
    and weights_decoder name the reference's ``.pth`` files, load them."""
    from ..models.builder import init_weights

    enc_w, dec_w = cfg.MODEL.weights_encoder, cfg.MODEL.weights_decoder
    if enc_w or dec_w:
        if not (enc_w.endswith(".pth") and dec_w.endswith(".pth")):
            raise NotImplementedError(
                "the port loads the reference's encoder/decoder .pth pair; "
                "other checkpoint formats are queued in ROADMAP.md")
        model.encoder.load_state_dict(_load_pth(enc_w))
        model.decoder.load_state_dict(_load_pth(dec_w))
        return model
    init_weights(model, torch.Generator().manual_seed(seed))
    return model
