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
folds it into the PPM fuse conv, and ``bilinear_resize_matmul`` (the JAX
package's ``bilinear_resize_mxu``) resizes with it: two products with the
(out, in) matrices of the two axes. Its backward is two products too,
where CUDA's ``F.interpolate`` backward adds into the input gradient with
atomics, in an order that changes from run to run, and raises under
``torch.use_deterministic_algorithms(True)``. ``bilinear_resize``
therefore takes the matrix form for a tensor that requires grad while
that mode is on (the golden run's DeepLab training), and the native op
otherwise: outside the mode cuDNN's convolution algorithms vary from run
to run as well, so the matrix form would make no run reproducible.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _axis_weights(in_size: int, out_size: int, dtype=np.float32):
    """(lo_idx, hi_idx, hi_weight) numpy arrays for one axis, the weight
    in ``dtype``."""
    if in_size == out_size:
        return None
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * (in_size / out_size) - 0.5
    src = np.maximum(src, 0.0)
    lo = np.floor(src).astype(np.int32)
    lo = np.minimum(lo, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(dtype)
    return lo, hi, w_hi


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, dtype=np.float32):
    """Dense (out, in) interpolation matrix for one axis (2 nonzeros/row),
    in ``dtype`` (float32, or float64 as torch weights a float64 resize)."""
    aw = _axis_weights(in_size, out_size, dtype)
    m = np.zeros((out_size, in_size), dtype)
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
    if (x.requires_grad and torch.is_grad_enabled()
            and torch.are_deterministic_algorithms_enabled()):
        return bilinear_resize_matmul(x, size, channel_last=channel_last)
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


def bilinear_resize_matmul(x: torch.Tensor, size, *,
                           channel_last: bool = True):
    """``bilinear_resize`` as two interpolation-matrix products on the same
    grid: ``W_h @ x @ W_w^T``, in float32 at least and outside autocast
    (at most two non-zeros a row, so each output is the lerp's two products
    and one sum; the backward is two products as well, deterministic).
    Same layouts and dtype as ``bilinear_resize``."""
    h_out, w_out = int(size[0]), int(size[1])
    dtype = x.dtype
    h_ax, w_ax = (x.dim() - 3, x.dim() - 2) if channel_last else (
        x.dim() - 2, x.dim() - 1)
    h_in, w_in = x.shape[h_ax], x.shape[w_ax]
    if (h_in, w_in) == (h_out, w_out):
        return x
    wide = torch.promote_types(dtype, torch.float32)
    npdt = np.float64 if wide == torch.float64 else np.float32
    wh = torch.from_numpy(_interp_matrix(h_in, h_out, npdt)).to(x.device)
    ww = torch.from_numpy(_interp_matrix(w_in, w_out, npdt)).to(x.device)
    with torch.autocast(x.device.type, enabled=False):
        y = torch.movedim(x.to(wide), h_ax, -1) @ wh.t()   # H -> last
        y = torch.movedim(y, -1, h_ax)
        y = torch.movedim(y, w_ax, -1) @ ww.t()
        y = torch.movedim(y, -1, w_ax)
    return y.to(dtype)


def resize_like_torch(x: torch.Tensor, size):
    """NHWC bilinear resize, the JAX package's name for the same call."""
    return bilinear_resize(x, size, channel_last=True)
