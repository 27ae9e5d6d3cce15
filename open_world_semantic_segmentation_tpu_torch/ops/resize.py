"""Bilinear resize with PyTorch ``align_corners=False`` semantics.

The reference resizes logits and features with
``F.interpolate(mode="bilinear", align_corners=False)``; argmax boundaries,
and therefore mIoU and every OOD metric, depend on that sampling grid. Here
it is the native op. The public layout is NHWC (or HWC), as in the JAX
package; the tensor is viewed as NCHW for the call, which for a contiguous
NHWC tensor is a channels_last view and costs no copy.

Torch's source grid for align_corners=False:
    src = max(0, (dst + 0.5) * (in_size / out_size) - 0.5)
    lo  = floor(src); hi = min(lo + 1, in_size - 1); w_hi = src - lo

``_interp_matrix`` writes the same grid as a dense matrix; ``ops/ppm_fuse.py``
folds it into the PPM fuse conv.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _axis_weights(in_size: int, out_size: int):
    """(lo_idx, hi_idx, hi_weight) numpy arrays for one axis."""
    if in_size == out_size:
        return None
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * (in_size / out_size) - 0.5
    src = np.maximum(src, 0.0)
    lo = np.floor(src).astype(np.int32)
    lo = np.minimum(lo, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(np.float32)
    return lo, hi, w_hi


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int):
    """Dense (out, in) interpolation matrix for one axis (2 nonzeros/row)."""
    aw = _axis_weights(in_size, out_size)
    m = np.zeros((out_size, in_size), np.float32)
    if aw is None:
        np.fill_diagonal(m, 1.0)
        return m
    lo, hi, w_hi = aw
    rows = np.arange(out_size)
    # hi may equal lo at the border; add into place
    np.add.at(m, (rows, lo), 1.0 - w_hi)
    np.add.at(m, (rows, hi), w_hi)
    return m


def bilinear_resize(x: torch.Tensor, size, *, channel_last: bool = True):
    """Resize ``x`` (NHWC or HWC if channel_last, else NCHW/CHW) to ``size``.

    ``size`` is (H_out, W_out). Returns the input's layout and dtype, as
    the JAX package does. The interpolation runs in float32 at least, as
    CUDA autocast runs it, whether autocast is on or not: a program traced
    by ``torch.export`` replays the dtypes it saw.
    """
    h_out, w_out = int(size[0]), int(size[1])
    dtype = x.dtype
    unbatched = x.dim() == 3
    if unbatched:
        x = x.unsqueeze(0)
    if channel_last:
        x = x.permute(0, 3, 1, 2)
    if tuple(x.shape[-2:]) != (h_out, w_out):
        wide = torch.promote_types(dtype, torch.float32)
        x = F.interpolate(x.to(wide), size=(h_out, w_out), mode="bilinear",
                          align_corners=False).to(dtype)
    if channel_last:
        x = x.permute(0, 2, 3, 1)
    return x[0] if unbatched else x


def resize_like_torch(x: torch.Tensor, size):
    """NHWC bilinear resize, the JAX package's name for the same call."""
    return bilinear_resize(x, size, channel_last=True)
