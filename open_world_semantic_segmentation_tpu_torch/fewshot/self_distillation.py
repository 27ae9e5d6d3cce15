"""FT / PLM incremental learning: pseudo-labels and multi-head merging.

Counterpart of the JAX package's ``fewshot/self_distillation.py`` (after
the reference's test_self_distillation.py and main_self_distillation.py).

Training (:549-617):
- support pixels labelled 0 take the new class id ``16 + novel_cls - 1``
  (:558);
- ignored pixels (255) take the frozen base head's argmax (:565-567);
- earlier novel heads' pixels of their own novel class keep that label
  (:568-570);
- the loss is CE on the LAST head only (:572-574) and only
  ``classifier_N`` trains (:476-478: ``train/optim.py
  backbone_classifier_optimizer(frozen_keys=...)``).

Eval (:292-297, README.md:76-89):
- ``plm_all``: the base head's argmax, overridden wherever novel head i
  predicts its novel class 16 + i;
- ``plm_latest``: the last head's argmax instead (the commented line
  :293);
- the label remap is NPM's (:351-354).

All of it runs on the tensors' device.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .prototypes import npm_label_remap

self_distillation_eval_remap = npm_label_remap  # same remap (:351-354)

VARIANTS = ("plm_all", "plm_latest")


def pseudo_label(labels: torch.Tensor, head_logits: Sequence[torch.Tensor],
                 *, novel_cls: int = 1, base_classes: int = 16,
                 ignore_index: int = 255,
                 support_zero_to_novel: bool = True) -> torch.Tensor:
    """The training target from the raw labels (B, H, W) and the heads'
    logits (B, H, W, K_i), base head first."""
    if support_zero_to_novel:
        labels = torch.where(labels == 0, base_classes + novel_cls - 1,
                             labels)
    labels = torch.where(labels == ignore_index,
                         head_logits[0].argmax(-1).to(labels.dtype), labels)
    for i in range(novel_cls - 1):
        prev = head_logits[i + 1].argmax(-1).to(labels.dtype)
        labels = torch.where(prev == base_classes + i, prev, labels)
    return labels


def merge_head_predictions(head_logits: Sequence[torch.Tensor], *,
                           variant: str = "plm_all",
                           base_classes: int = 16) -> torch.Tensor:
    """The merged open-world prediction (B, H, W) from the heads' logits
    (B, H, W, K_i), base head first."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    preds = head_logits[-1 if variant == "plm_latest" else 0].argmax(-1)
    for i, logits in enumerate(head_logits[1:]):
        novel_id = base_classes + i
        preds = torch.where(logits.argmax(-1) == novel_id, novel_id, preds)
    return preds
