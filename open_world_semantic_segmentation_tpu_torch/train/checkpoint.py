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
- ``load_partial`` loads the keys a state dict shares with a model, of
  equal shapes, and leaves the rest at their initial values: the
  reference's ``strict=False`` transfer (test_self_distillation.py:511-518)
  and the JAX package's ``load_checkpoint(partial=True)``. A fresh
  ``classifier_1``, or a 17-class student's classifier, keeps its init.
- ``save_model_checkpoint``: ``{"model_state", ...}``, what the
  self-distillation and distillation CLIs write.
- ``save_deeplab_checkpoint`` / ``load_deeplab_checkpoint``: the DeepLab
  trainer's ``latest.pth`` and ``best.pth``, the reference's dict
  (main.py:315-325) ``{"cur_itrs", "model_state", "optimizer_state",
  "best_score"}``; ``load_deeplab_state`` and the reference's tools read
  its ``model_state``. The reference's ``scheduler_state`` is not written:
  the port's schedule is a function of the step count (``cur_itrs``). The
  JAX trainer writes ``latest.pkl`` / ``best.pkl`` instead.
- ``save_checkpoint_distributed`` / ``load_checkpoint_distributed``: the
  JAX package's ``save_checkpoint_orbax`` / ``load_checkpoint_orbax``
  (sharded, multi-host) on ``torch.distributed.checkpoint``: a directory
  that every rank of the default process group writes together (a tensor
  held alike by every rank is written once) and reads back, or one
  process alone where there is no group.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import torch

from .convert import deeplab_state_dict_from_jax, state_dict_from_jax
from .optim import load_optimizer_state, optimizer_state


def save_epoch_checkpoint(model, encoder_path: str, decoder_path: str):
    """Write ``model``'s encoder and decoder state dicts. Each file is
    written under a temporary name and renamed, so a reader never sees half
    a checkpoint."""
    for part, path in (("encoder", encoder_path), ("decoder", decoder_path)):
        _atomic_save({k: v.detach().cpu()
                      for k, v in getattr(model, part).state_dict().items()},
                     path)


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


def _atomic_save(obj, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_partial(model: torch.nn.Module,
                 state: Dict[str, torch.Tensor]) -> List[str]:
    """Load into ``model`` every entry of ``state`` whose key it has with
    the same shape; return the model's keys left as they were."""
    own = model.state_dict()
    kept = [k for k, v in own.items()
            if k not in state or tuple(state[k].shape) != tuple(v.shape)]
    model.load_state_dict({k: own[k] if k in kept else state[k]
                           for k in own})
    return kept


def save_model_checkpoint(path: str, model, **metadata):
    """``{"model_state": ..., **metadata}`` on the CPU, the reference's
    DeepLab layout: what ``load_deeplab_state`` reads."""
    _atomic_save({"model_state": {k: v.detach().cpu()
                                  for k, v in model.state_dict().items()},
                  **metadata}, path)


def save_deeplab_checkpoint(path: str, model, optimizer, *, cur_itrs: int,
                            best_score: float):
    """The DeepLab train state in the reference's dict."""
    save_model_checkpoint(path, model, cur_itrs=int(cur_itrs),
                          optimizer_state=optimizer_state(optimizer),
                          best_score=float(best_score))


def load_deeplab_checkpoint(path: str, model, optimizer) -> Tuple[int,
                                                                  float]:
    """Restore ``save_deeplab_checkpoint``'s model and optimizer state (the
    optimizer's schedules stay); return ``(cur_itrs, best_score)``."""
    ckpt = torch.load(path, map_location="cpu")
    model.load_state_dict(ckpt["model_state"])
    load_optimizer_state(optimizer, ckpt["optimizer_state"])
    return int(ckpt["cur_itrs"]), float(ckpt["best_score"])


def save_checkpoint_distributed(path: str, state):
    """Write ``state`` (a nested dict of tensors, such as a model's and an
    optimizer's state dicts, and plain values) into the directory
    ``path`` with ``torch.distributed.checkpoint``. Under a process group
    every rank calls it with its own ``state``; one process calls it
    alone."""
    import torch.distributed.checkpoint as dcp

    dcp.save(state, checkpoint_id=os.path.abspath(path))


def load_checkpoint_distributed(path: str, target):
    """Read the directory ``path`` into ``target``, a nested dict of the
    saved structure: its tensors are filled in place, on their devices and
    in their dtypes, its plain values replaced. Returns ``target``."""
    import torch.distributed.checkpoint as dcp

    dcp.load(target, checkpoint_id=os.path.abspath(path))
    return target
