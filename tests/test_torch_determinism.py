"""The deterministic forms of the DeepLab train step against the ops they
replace, in float64 on the CPU (values and gradients within 1e-12 of the
largest magnitude: each form sums the same products in another order).

- the class sums and counts of ``train/losses.py``'s center term as
  one-hot products, against the ``scatter_add_`` / ``gather`` form they
  replace (CUDA adds those with atomics, in an order that changes from
  run to run);
- ``ops/resize.py bilinear_resize_matmul`` (two interpolation-matrix
  products, the JAX package's ``bilinear_resize_mxu``) against
  ``F.interpolate``'s bilinear, forward and backward, up and down, NHWC
  and NCHW; ``bilinear_resize`` takes it for a tensor that requires grad
  under ``torch.use_deterministic_algorithms(True)``;
- ``train/losses.py cross_entropy`` (log-sum-exp, the label's logit, a
  masked mean over the valid pixels) against ``F.cross_entropy`` with
  ``ignore_index``.

``tests/test_torch_cuda.py`` runs the DeepLab train step twice on the card
under ``torch.use_deterministic_algorithms(True)`` and asks for identical
weights.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from open_world_semantic_segmentation_tpu_torch.ops.resize import (
    bilinear_resize, bilinear_resize_matmul)
from open_world_semantic_segmentation_tpu_torch.train.losses import (
    cross_entropy, deeplab_cross_entropy)

TOL = 1e-12


def _close(got, want):
    scale = max(1.0, float(want.detach().abs().max()))
    assert float((got - want).detach().abs().max()) <= TOL * scale


def _center_scatter(f, labels, valid, k):
    """The center term as ``train/losses.py`` computed it with
    ``scatter_add_`` and ``gather``."""
    b, c = f.shape[0], f.shape[-1]
    hw = f.shape[1] * f.shape[2]
    member = (valid & (labels >= 0) & (labels < k)).reshape(b, -1)
    idx = torch.where(member, labels.reshape(b, -1), 0).long()
    w = member.to(f.dtype)
    flat = f.reshape(b, -1, c)
    sums = torch.zeros(b, k, c, dtype=f.dtype)
    sums.scatter_add_(1, idx[..., None].expand(-1, -1, c),
                      flat * w[..., None])
    counts = torch.zeros(b, k, dtype=f.dtype)
    counts.scatter_add_(1, idx, w)
    means = sums / counts.clamp(min=1.0)[..., None]
    own = means.gather(1, idx[..., None].expand(-1, -1, c))
    return ((((flat - own) ** 2).sum(-1) * w).sum(1) / hw).sum()


def test_center_term_one_hot_matches_scatter():
    rng = np.random.default_rng(0)
    b, h, w, k, c = 2, 6, 7, 5, 4
    logits = torch.from_numpy(rng.standard_normal((b, h, w, k)))
    labels = torch.from_numpy(rng.integers(0, k + 2, (b, h, w)))
    labels[0, :2] = 255                              # ignored pixels
    feats = torch.from_numpy(rng.standard_normal((b, h, w, c)))
    n = b
    for gamma in (0.0, 0.7):
        f1 = feats.clone().requires_grad_()
        got = deeplab_cross_entropy(logits, labels, f1, gamma=gamma,
                                    use_metric_terms=True, num_classes=k)
        f2 = feats.clone().requires_grad_()
        valid = labels != 255
        ce = cross_entropy(logits, labels, 255)
        hw = h * w
        picked = logits.gather(-1, labels.clamp(0, k - 1)[..., None])[..., 0]
        var = (torch.where(valid, -picked, 0.0).sum((1, 2)) / hw).sum()
        want = (ce + 0.0 * var + gamma * _center_scatter(f2, labels, valid,
                                                         k)) / n
        _close(got, want)
        if gamma:
            g1, = torch.autograd.grad(got, f1)
            g2, = torch.autograd.grad(want, f2)
            _close(g1, g2)


@pytest.mark.parametrize("shape,size", [
    ((2, 5, 7, 3), (11, 13)), ((1, 16, 12, 4), (5, 9)),
    ((1, 8, 8, 2), (8, 32)), ((2, 6, 6, 3), (6, 6))])
@pytest.mark.parametrize("channel_last", [True, False])
def test_matrix_resize_matches_interpolate(shape, size, channel_last):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(shape))
    if not channel_last:
        x = x.permute(0, 3, 1, 2).contiguous()
    g = torch.from_numpy(rng.standard_normal(
        (shape[0], *size, shape[3]) if channel_last
        else (shape[0], shape[3], *size)))
    x1 = x.clone().requires_grad_()
    got = bilinear_resize_matmul(x1, size, channel_last=channel_last)
    x2 = x.clone().requires_grad_()
    nchw = x2.permute(0, 3, 1, 2) if channel_last else x2
    want = F.interpolate(nchw, size=size, mode="bilinear",
                         align_corners=False)
    if channel_last:
        want = want.permute(0, 2, 3, 1)
    _close(got, want)
    gx1, = torch.autograd.grad(got, x1, g)
    gx2, = torch.autograd.grad(want, x2, g)
    _close(gx1, gx2)
    # bilinear_resize takes the matrix form for a tensor that needs grad
    # under torch.use_deterministic_algorithms, the native op otherwise
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        assert torch.equal(
            bilinear_resize(x1, size, channel_last=channel_last), got)
    finally:
        torch.use_deterministic_algorithms(saved)
    assert torch.equal(
        bilinear_resize(x1, size, channel_last=channel_last), want)
    with torch.no_grad():
        _close(bilinear_resize(x, size, channel_last=channel_last), want)


def test_matrix_resize_float32_and_bf16_dtypes():
    x = torch.randn(1, 4, 6, 3, dtype=torch.bfloat16, requires_grad=True)
    y = bilinear_resize_matmul(x, (9, 10))
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16


def test_cross_entropy_matches_torch():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 6, 7)))
    labels = torch.from_numpy(rng.integers(0, 7, (2, 5, 6)))
    labels[1, 1:3] = 255
    l1 = logits.clone().requires_grad_()
    got = cross_entropy(l1, labels, ignore_index=255)
    l2 = logits.clone().requires_grad_()
    want = F.cross_entropy(l2.permute(0, 3, 1, 2), labels, ignore_index=255)
    _close(got, want)
    g1, = torch.autograd.grad(got, l1)
    g2, = torch.autograd.grad(want, l2)
    _close(g1, g2)
