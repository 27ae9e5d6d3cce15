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
- ``crf`` / ``crf-gauss``: mean-field CRF refinement on the device
  (``openset/crf.py``) of the softmax of the (optionally back-excluded)
  scores; conf = max_k Q. The softmax and the CRF run in float32 whatever
  the scores' dtype (the JAX package's CRF takes float32 maps only), and
  the map is float32.
- ``rec_cosine_map`` / ``rec_cosine_conf``: reconstruction scoring
  (``cli/eval_ood_rec.py``).
"""

from __future__ import annotations

import torch

from ..ops.knn import knn_cosine
from ..ops.resize import bilinear_resize
from .crf import bilateral_crf_conf, gaussian_crf_conf


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


def rec_cosine_map(ft_orig, ft_rec, eps: float = 1e-8):
    """Cosine similarity of the original and the reconstructed feature maps
    over their trailing channel axis, at feature resolution (the reference
    normalises both 4096-d maps, then takes ``cosine_similarity(dim=1)``).
    The caller upsamples it: the reference interpolates the cosine map,
    not the selected conf."""
    dot = (ft_orig * ft_rec).sum(dim=-1)
    n1 = torch.sqrt((ft_orig * ft_orig).sum(dim=-1))
    n2 = torch.sqrt((ft_rec * ft_rec).sum(dim=-1))
    return dot / torch.clamp(n1 * n2, min=eps)


def rec_cosine_conf(msp, cos, msp_threshold: float = 0.999):
    """``conf = msp*(msp>t) + cos*(msp<=t)``, both maps at full (label)
    resolution: the select is made against the full-size MSP."""
    return torch.where(msp > msp_threshold, msp, cos)


SCORING_METHODS = ("msp", "maxlogit", "dissum", "dissum_fused", "background",
                   "knn", "crf", "crf-gauss")


def compute_conf(scores, method: str, *, ft=None, exclude_back: bool = False,
                 seg_size=None):
    """Dispatch on the OOD.ood config value. ``scores``: (H, W, K) averaged
    multi-scale scores at label resolution; ``ft``: feature map for knn.
    ``crf`` and ``crf-gauss`` return float32 maps."""
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
        # the reference softmaxes the (optionally back-excluded) scores as
        # the CRF's unary; for ``crf`` they are also its bilateral "image"
        probs = torch.softmax(
            _exclude_back(scores, exclude_back).float(), dim=-1)
        crf_conf = (gaussian_crf_conf if method == "crf-gauss"
                    else bilateral_crf_conf)
        return crf_conf(probs)[0]
    raise ValueError(f"unknown OOD method {method}")
