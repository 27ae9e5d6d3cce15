"""Epoch checkpoints of the anomaly stack.

- ``save_epoch_checkpoint`` writes the reference's pair
  ``encoder_epoch_N.pth`` / ``decoder_epoch_N.pth`` (anomaly/train.py's
  format: one torch state dict each, the reference's key names). The
  port's ``cli/_common.init_or_load_variables`` loads it, and so does the
  JAX package's, through its torch converter. The JAX trainer writes one
  ``model_epoch_N.pkl`` instead; the port writes the reference's format on
  purpose, so that its checkpoints serve both packages and the reference.
- ``load_jax_checkpoint`` reads such a JAX ``*_epoch_N.pkl`` (a pickle of
  ``{"tree": {"params", "batch_stats"}, "metadata"}`` holding plain dicts of
  numpy arrays, which needs no flax) and maps it into the port's encoder
  and decoder state dicts with ``train/convert.py``. Unpickling can run
  code: load only files this project wrote.
- ``load_deeplab_state`` reads a DeepLab checkpoint into the port's state
  dict: the reference's ``.pth`` (``{"model_state": ..., ...}`` or a bare
  state dict) as it is, or the JAX package's pickle (its ``"tree"`` holds
  the variables, or a train state with ``params`` and ``batch_stats``)
  through ``train/convert.py deeplab_state_dict_from_jax``.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import torch

from .convert import deeplab_state_dict_from_jax, state_dict_from_jax


def save_epoch_checkpoint(model, encoder_path: str, decoder_path: str):
    """Write ``model``'s encoder and decoder state dicts. Each file is
    written under a temporary name and renamed, so a reader never sees half
    a checkpoint."""
    for part, path in (("encoder", encoder_path), ("decoder", decoder_path)):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        state = {k: v.detach().cpu()
                 for k, v in getattr(model, part).state_dict().items()}
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)


def load_jax_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor],
                                             Dict[str, torch.Tensor]]:
    """A JAX ``*_epoch_N.pkl`` -> (encoder, decoder) port state dicts."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    tree = payload["tree"]
    return state_dict_from_jax({"params": tree["params"],
                                "batch_stats": tree.get("batch_stats", {})})


def load_deeplab_state(path: str) -> Dict[str, torch.Tensor]:
    """A DeepLab checkpoint (reference ``.pth`` or JAX pickle) -> the
    port's DeepLab state dict."""
    if path.endswith(".pth"):
        ckpt = torch.load(path, map_location="cpu")
        state = ckpt.get("model_state", ckpt)
        # DataParallel prefixes; the embedding wrapper's one-hot centers
        # are rebuilt from the class count
        state = {k[len("module."):] if k.startswith("module.") else k: v
                 for k, v in state.items()}
        state.pop("centers", None)
        return state
    with open(path, "rb") as f:
        tree = pickle.load(f)["tree"]
    return deeplab_state_dict_from_jax({
        "params": tree["params"],
        "batch_stats": tree.get("batch_stats", {})})
