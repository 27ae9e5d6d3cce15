"""Distance-to-prototype heads (the DML classification rule).

Per-pixel logits are the negative squared L2 distance to K class centers.
Algebraically ``-||x - c_k||^2 = -(||x||^2 - 2 x.c_k + ||c_k||^2)``, so the
head is one ``HW x C @ C x K`` product plus two rank-1 terms, and for the
reference's one-hot centers ``c_k = m * e_k`` it collapses to

    logits_k = 2m * x_k - m^2 - ||x||^2,

an elementwise op and one reduction. ``prototype_distance`` is the NPM score:
the negative squared distance of each pixel embedding to a prototype.
"""

from __future__ import annotations

import torch


def distance_logits(x: torch.Tensor, centers: torch.Tensor):
    """Logits ``-||x - c_k||^2``: x (..., C), centers (K, C) -> (..., K)."""
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (centers * centers).sum(-1)
    return 2.0 * torch.matmul(x, centers.t()) - x2 - c2


def one_hot_center_logits(x: torch.Tensor, magnitude: float = 3.0):
    """Distance logits for the fixed one-hot centers ``m * e_k`` (K == C),
    over the last axis, in x's dtype, as the JAX package computes them
    (CUDA autocast would otherwise return the sum, and so the logits, in
    float32)."""
    x2 = (x * x).sum(-1, keepdim=True).to(x.dtype)
    return 2.0 * magnitude * x - magnitude * magnitude - x2


def prototype_distance(features: torch.Tensor, prototype):
    """NPM score ``-||f_p - proto||^2``: prototype (C,) -> (...,), or
    (P, C) -> (..., P). Computed in the wider of the two dtypes, as the JAX
    package promotes them: bf16 features against a float32 prototype give
    a float32 score."""
    prototype = torch.as_tensor(prototype, device=features.device)
    dtype = torch.promote_types(features.dtype, prototype.dtype)
    features, prototype = features.to(dtype), prototype.to(dtype)
    if prototype.dim() == 1:
        d = features - prototype
        return -(d * d).sum(-1)
    return distance_logits(features, prototype)
