"""Dense-CRF mean-field refinement for OOD scoring, on the device.

The JAX package's ``openset/crf.py``: the reference's ``crf`` /
``crf-gauss`` branches (eval_ood_traditional.py:471-510) run pydensecrf on
the host for 100 iterations and take ``max_k Q`` as the confidence map;
here every iteration is separable Gaussian blurs (depthwise convolutions)
and a softmax on the device.

- ``gaussian_crf`` (``crf-gauss``, addPairwiseGaussian(sxy=3, compat=3)):
  mean field with a pure spatial Gaussian kernel is a per-class blur.
- ``bilateral_crf`` (``crf``, create_pairwise_bilateral(sdims=(10, 10),
  schan=13) on the softmax score map, compat 10): the range part of the
  kernel, ``exp(-||s_i||^2/2) exp(-||s_j||^2/2) exp(s_i . s_j)`` with
  ``||s|| <= 1/13``, is expanded as ``1 + s_i . s_j`` (exact to 2e-5),
  which turns the bilateral filter into K + 1 blurs of a (K·C)-channel
  outer product.

Update rule (Krähenbühl & Koltun 2011, Potts, symmetric normalisation):
``Q <- softmax(log p + compat * norm(G * (norm * Q)))`` with
``norm = 1 / sqrt(G * 1)``.

Layout: NCHW, contiguous, inside (the public maps are (H, W, K) as in the
JAX package). Each blur pass is one depthwise ``F.conv2d``
(``groups=channels``) over an (H, W) plane per channel; in NCHW a plane is
contiguous, so each output reads a run of one row (W pass) or a strided
column (H pass) of its own plane, where channels_last would interleave the
170 channels of the bilateral outer product at every pixel. cuDNN's
depthwise convs are slow in channels_last, and the float32 ones PyTorch
runs with its own depthwise kernel in either layout.

float32 only: the CRF branches of ``openset/scoring.py compute_conf`` take
the softmax in float32 whatever the scores' dtype. The JAX package's CRF
raises on bf16 maps (its taps are float32 arrays), so it has no bf16
result to follow; the port upcasts, and rounds no iterate to bf16.

``densecrf_conf`` is the optional host cross-check against pydensecrf,
which raises ``RuntimeError`` where that package is absent.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gauss_kernel(sigma: float, truncate: float = 3.5):
    """The normalised 1-D Gaussian taps (built in float64, stored as
    float32) and their radius ``int(truncate * sigma + 0.5)``."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32), radius


def _taps(sigma: float, device) -> torch.Tensor:
    """The taps of :func:`_gauss_kernel` on ``device``, copied once per CRF
    call (a copy from pageable host memory waits for the device)."""
    return torch.from_numpy(_gauss_kernel(sigma)[0]).to(device)


def _blur(q: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur over H, W of (1, C, H, W): a depthwise pass
    along H (zero padding on H only), then one along W (padding on W only).
    The taps are symmetric, so correlation is convolution."""
    c = q.shape[1]
    radius = taps.shape[0] // 2
    along_h = taps.view(1, 1, -1, 1).expand(c, 1, -1, 1).contiguous()
    along_w = taps.view(1, 1, 1, -1).expand(c, 1, 1, -1).contiguous()
    x = F.conv2d(q, along_h, padding=(radius, 0), groups=c)
    return F.conv2d(x, along_w, padding=(0, radius), groups=c)


def _nchw(probs: torch.Tensor) -> torch.Tensor:
    return probs.permute(2, 0, 1).unsqueeze(0).contiguous()


def _hwk(q: torch.Tensor) -> torch.Tensor:
    return q[0].permute(1, 2, 0)


def gaussian_crf(probs: torch.Tensor, sxy: float = 3.0, compat: float = 3.0,
                 iters: int = 100) -> torch.Tensor:
    """Mean-field refined distribution Q (H, W, K) from the unary softmax
    ``probs`` (H, W, K).

    Messages use DenseCRF's symmetric normalisation (msg = blur(q /
    sqrt(m)) / sqrt(m), m = blur(ones)): the zero-padded blur loses mass at
    the borders, and without it edge pixels flip. Potts agreement raises
    the class score, with no self-subtraction (the self weight is about
    k(0)/m; subtracting q makes sharp pixels oscillate)."""
    p = _nchw(probs)
    taps = _taps(sxy, p.device)
    log_unary = torch.log(torch.clamp(p, min=1e-20))
    ones = torch.ones_like(p[:, :1])
    inv_sqrt_m = 1.0 / torch.sqrt(torch.clamp(_blur(ones, taps), min=1e-12))
    q = p
    for _ in range(iters):
        msg = _blur(q * inv_sqrt_m, taps) * inv_sqrt_m
        q = torch.softmax(log_unary + compat * msg, dim=1)
    return _hwk(q)


def gaussian_crf_conf(probs, sxy: float = 3.0, compat: float = 3.0,
                      iters: int = 100):
    """(conf, pred) = (max_k Q, argmax_k Q) (eval_ood_traditional.py:505)."""
    q = gaussian_crf(probs, sxy, compat, iters)
    conf, pred = q.max(dim=-1)
    return conf, pred


def bilateral_crf(probs: torch.Tensor, sxy: float = 10.0,
                  schan: float = 13.0, compat: float = 10.0,
                  iters: int = 100) -> torch.Tensor:
    """Mean-field refined Q (H, W, K) with the reference's bilateral kernel
    on the score map itself (``img=tmp_scores, chdim=0``), fixed across the
    iterations: with ``s = probs / schan`` and ``phi = exp(-||s||^2/2)``,

        k(i, j) = g(i - j) phi_i phi_j (1 + s_i . s_j) + O(2e-5),

    so one kernel application is a blur of ``phi x`` plus a blur of the
    (K·C)-channel outer product ``s_d phi x_c`` contracted against ``s_i``.
    Symmetric normalisation as in :func:`gaussian_crf`."""
    p = _nchw(probs)
    taps = _taps(sxy, p.device)
    s = p / schan
    phi = torch.exp(-0.5 * (s * s).sum(dim=1, keepdim=True))
    log_unary = torch.log(torch.clamp(p, min=1e-20))
    _, k, h, w = s.shape

    def kfilter(x):
        px = phi * x
        c = x.shape[1]
        # outer[k * C + c] = s_k * px_c, the JAX package's channel order
        outer = (s[:, :, None] * px[:, None]).reshape(1, k * c, h, w)
        blurred = _blur(outer, taps).view(1, k, c, h, w)
        second = (s[:, :, None] * blurred).sum(dim=1)
        return phi * (_blur(px, taps) + second)

    ones = torch.ones_like(p[:, :1])
    inv_sqrt_m = 1.0 / torch.sqrt(torch.clamp(kfilter(ones), min=1e-12))
    q = p
    for _ in range(iters):
        msg = kfilter(q * inv_sqrt_m) * inv_sqrt_m
        q = torch.softmax(log_unary + compat * msg, dim=1)
    return _hwk(q)


def bilateral_crf_conf(probs, sxy: float = 10.0, schan: float = 13.0,
                       compat: float = 10.0, iters: int = 100):
    """(conf, pred) = (max_k Q, argmax_k Q) (eval_ood_traditional.py:486)."""
    q = bilateral_crf(probs, sxy, schan, compat, iters)
    conf, pred = q.max(dim=-1)
    return conf, pred


def densecrf_conf(probs_hwk, img_hwc=None, *, mode: str = "gauss",
                  iters: int = 100):
    """pydensecrf on the host: 'gauss' is addPairwiseGaussian(3, 3);
    'bilateral' is create_pairwise_bilateral(sdims=(10, 10), schan=13) on
    the score map, compat 10 (eval_ood_traditional.py:471-510). Returns
    numpy (conf, pred)."""
    try:
        import pydensecrf.densecrf as dcrf
        from pydensecrf.utils import (
            unary_from_softmax, create_pairwise_bilateral)
    except ImportError as e:
        raise RuntimeError(
            "densecrf_conf needs the external pydensecrf package; the "
            "device path covers both variants (openset.crf.gaussian_crf_conf"
            ", bilateral_crf_conf)") from e

    probs = np.asarray(torch.as_tensor(probs_hwk).cpu()).transpose(2, 0, 1)
    ch, h, w = probs.shape
    d = dcrf.DenseCRF2D(h, w, ch)
    d.setUnaryEnergy(unary_from_softmax(probs))
    if mode == "gauss":
        d.addPairwiseGaussian(sxy=3, compat=3)
    else:
        pe = create_pairwise_bilateral(sdims=(10, 10), schan=13,
                                       img=probs, chdim=0)
        d.addPairwiseEnergy(pe, compat=10)
    q = np.array(d.inference(iters)).reshape(ch, h, w)
    return q.max(0), q.argmax(0)
