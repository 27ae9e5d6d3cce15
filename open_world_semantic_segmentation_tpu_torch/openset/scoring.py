"""Per-pixel anomaly (OOD) confidence maps, on the device.

Parity target: the JAX package's ``openset/scoring.py`` (the scoring
branches of the reference's ``eval_ood_traditional.py:276-530``). Score maps
are (H, W, K), the averaged multi-scale scores at label resolution.

Sign convention (inherited): *lower* conf = more anomalous; the metric layer
negates (``metrics/anom.py eval_ood_measure``).

- ``dissum`` (the paper's DML score): negative sum of distance logits,
  clipped at 400, min-max normalised. The reference computes a sigmoid
  fusion with the MSP map and then overrides it with ``conf = dis_sum``;
  ``dissum`` keeps the override, ``dissum_fused`` exposes the fusion.
- ``knn``: sum of cosine similarities between each pixel's feature and its
  diagonal-shifted neighbours over a 9x9 window (``ops/knn.py``): the CUDA
  kernel for a CUDA tensor, the plain version for a CPU one.
- ``crf`` / ``crf-gauss`` are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.knn import knn_cosine
from ..ops.resize import bilinear_resize


def normalize_01(x):
    """(x - min) / (max - min)."""
    mn = x.min()
    mx = x.max()
    return (x - mn) / (mx - mn)


def coefficient_map(x, thre, lamda: float = 50.0):
    """1 / (1 + exp(lamda * (x - thre)))."""
    return 1.0 / (1.0 + torch.exp(lamda * (x - thre)))


def _exclude_back(scores, exclude_back: bool):
    return scores[..., 1:] if exclude_back else scores


def msp_conf(scores, exclude_back: bool = False):
    """Max softmax probability."""
    s = _exclude_back(scores, exclude_back)
    return torch.softmax(s, dim=-1).amax(dim=-1)


def maxlogit_conf(scores, exclude_back: bool = False):
    """Max raw logit."""
    return _exclude_back(scores, exclude_back).amax(dim=-1)


def dissum_conf(scores, exclude_back: bool = False, clip: float = 400.0,
                fused: bool = False):
    """Clipped and min-max-normalised negative logit sum."""
    s = _exclude_back(scores, exclude_back)
    dis_sum = -s.sum(dim=-1)
    dis_sum = torch.clamp(dis_sum, max=clip)
    dis_sum = normalize_01(dis_sum)
    if not fused:
        return dis_sum
    prob_map = normalize_01(torch.softmax(s, dim=-1).amax(dim=-1))
    coeff = coefficient_map(dis_sum, 0.2)
    return coeff * dis_sum + (1 - coeff) * prob_map


def background_conf(scores, exclude_back: bool = False):
    """Class-0 score as confidence."""
    return scores[..., 0]


def knn_cosine_conf(ft, seg_size=None, neighbor_size: int = 9,
                    eps: float = 1e-8):
    """Neighbourhood cosine-similarity map of (H, W, C) features, upsampled
    to ``seg_size`` when given. Float32 out."""
    out = knn_cosine(ft, neighbor_size=neighbor_size, eps=eps)
    if seg_size is not None:
        out = bilinear_resize(out[None, :, :, None], seg_size)[0, :, :, 0]
    return out


def compute_conf(scores, method: str, *, ft=None, exclude_back: bool = False,
                 seg_size=None):
    """Dispatch on the OOD.ood config value. ``scores``: (H, W, K) averaged
    multi-scale scores at label resolution; ``ft``: feature map for knn."""
    if method == "msp":
        return msp_conf(scores, exclude_back)
    if method == "maxlogit":
        return maxlogit_conf(scores, exclude_back)
    if method == "dissum":
        return dissum_conf(scores, exclude_back)
    if method == "dissum_fused":
        return dissum_conf(scores, exclude_back, fused=True)
    if method == "background":
        return background_conf(scores, exclude_back)
    if method == "knn":
        if ft is None:
            raise ValueError("knn scoring needs the feature map")
        return knn_cosine_conf(ft, seg_size=seg_size)
    if method in ("crf", "crf-gauss"):
        raise NotImplementedError(
            f"OOD method {method!r} is not ported yet; ROADMAP.md queues "
            "openset/crf.py")
    raise ValueError(f"unknown OOD method {method}")
