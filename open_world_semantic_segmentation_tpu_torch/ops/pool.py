"""Pooling ops with PyTorch bin edges, NHWC at the public surface.

``adaptive_avg_pool`` is ``nn.AdaptiveAvgPool2d``: output bin i over an axis
of size N with S bins averages input rows [floor(i*N/S), ceil((i+1)*N/S)).
The PPM decoder pools conv5 (H/8 x W/8, any size) to scales (1, 2, 3, 6), so
bins are uneven whenever 8 does not divide H. ``global_avg_pool`` is the
DeepLab ASPP's image-pool branch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _as_nchw(x, channel_last):
    return x.permute(0, 3, 1, 2) if channel_last else x


def _from_nchw(x, channel_last):
    return x.permute(0, 2, 3, 1) if channel_last else x


def adaptive_avg_pool(x: torch.Tensor, output_size, *,
                      channel_last: bool = True):
    """Adaptive average pool of NHWC (or NCHW) ``x`` to (S_h, S_w)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    y = F.adaptive_avg_pool2d(_as_nchw(x, channel_last),
                              (int(output_size[0]), int(output_size[1])))
    return _from_nchw(y, channel_last)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True, *,
                    channel_last: bool = True):
    """Mean over the spatial axes of NHWC (or NCHW) ``x``."""
    dims = (x.dim() - 3, x.dim() - 2) if channel_last else (x.dim() - 2,
                                                              x.dim() - 1)
    return x.mean(dim=dims, keepdim=keepdims)


def max_pool_3x3_s2_p1(x: torch.Tensor, *, channel_last: bool = True):
    """3x3/stride-2 max pool with padding 1 (the ResNet stem pool); the
    padding contributes nothing to the max, as in torch."""
    y = F.max_pool2d(_as_nchw(x, channel_last), 3, stride=2, padding=1)
    return _from_nchw(y, channel_last)
