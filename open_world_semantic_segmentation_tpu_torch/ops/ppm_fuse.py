"""PPM fuse conv without materializing the 4096-channel concat.

The reference's PPM head concatenates conv5 with four bilinearly upsampled
pooled branches and runs one 3x3 conv over the result. Conv, bilinear
upsample and concat are linear, so the fuse conv splits exactly:

    conv3x3(cat(c5, U p_1, ..., U p_S)) =
        conv3x3(c5, W[:, :C5]) + sum_s T_s(p_s, W[:, slice_s])

and each pooled term T_s is computed at pooled resolution. With U_h/U_w the
(H x k)/(W x k) interpolation matrices of ``ops/resize.py``'s grid:

    T_s[i, j] = sum_{di, dj} (U p_s)[i + di - 1, j + dj - 1] @ W[:, :, di, dj]
              = sum_{dj} ( sum_{di} S(U_h) @ (p_s @ W[:, :, di, dj]) )
                         @ S(U_w)^T

where S shifts U's rows and zeroes rows that fall outside the image, which
is the conv's zero padding, so borders are exact.

Weights here are torch's OIHW, where the JAX package indexes HWIO. Tap
(di, dj) of a torch conv reads input pixel (i + di - 1, j + dj - 1).
``_shifted_interp`` orders its shifts d = +1, 0, -1, so shift index t reads
tap di = 2 - t: the tap flip is ``weight.flip(2, 3)`` (the HWIO version
flips axes 0 and 1 instead).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .resize import _interp_matrix


@functools.lru_cache(maxsize=None)
def _shifted_interp(in_size: int, out_size: int):
    """(3, out, in) f32: interpolation matrix with rows shifted by
    d in (+1, 0, -1); out-of-range rows are zero (conv zero padding)."""
    base = _interp_matrix(in_size, out_size)
    out = np.zeros((3, out_size, in_size), np.float32)
    out[1] = base
    out[0, : out_size - 1] = base[1:]   # d=+1: row i reads base row i+1
    out[2, 1:] = base[: out_size - 1]   # d=-1: row i reads base row i-1
    return out


def upsampled_conv3x3(p: torch.Tensor, weight: torch.Tensor, out_size, *,
                      dtype=None):
    """conv3x3(bilinear_resize(p, out_size), weight), computed at pooled
    resolution.

    p: (N, kh, kw, C) or (kh, kw, C) pooled map; weight: (Cout, C, 3, 3).
    Returns (N, H, W, Cout) in float32, or float64 for float64 (unbatched
    in, unbatched out).
    """
    h, w = int(out_size[0]), int(out_size[1])
    unbatched = p.dim() == 3
    if unbatched:
        p = p.unsqueeze(0)
    kh, kw = p.shape[1], p.shape[2]
    cdt = dtype or p.dtype
    uh = torch.from_numpy(_shifted_interp(kh, h)).to(p.device, cdt)
    uw = torch.from_numpy(_shifted_interp(kw, w)).to(p.device, cdt)
    wf = weight.flip(2, 3).to(cdt)              # shift index -> tap
    # r[n, t, u, a, b, o] = p[n, a, b, :] @ wf[o, :, t, u]
    r = torch.einsum("nabc,octu->ntuabo", p.to(cdt), wf)
    # rows: z[n, u, h, b, o] = sum_{t, a} uh[t, h, a] r[n, t, u, a, b, o]
    z = torch.einsum("tha,ntuabo->nuhbo", uh, r)
    # cols: out[n, h, w, o] = sum_{u, b} uw[u, w, b] z[n, u, h, b, o]
    out = torch.einsum("uwb,nuhbo->nhwo", uw, z)
    out = out.to(torch.promote_types(out.dtype, torch.float32))
    return out[0] if unbatched else out


def ppm_fuse_conv(conv5: torch.Tensor, pools, weight: torch.Tensor, *,
                  dtype=None):
    """3x3 same-padding conv of cat([conv5] + upsampled pools) without the
    concat.

    conv5: (N, H, W, C5); pools: list of (N, kh, kw, Cp) pooled maps at their
    pyramid resolutions; weight: (Cout, C5 + sum Cp, 3, 3), the unchanged
    conv parameter, sliced per branch. Returns (N, H, W, Cout) in float32,
    or float64 for float64.
    """
    h, w, c5 = conv5.shape[1:]
    cdt = dtype or conv5.dtype
    y = F.conv2d(conv5.permute(0, 3, 1, 2).to(cdt), weight[:, :c5].to(cdt),
                 padding=1).permute(0, 2, 3, 1)
    y = y.to(torch.promote_types(y.dtype, torch.float32))
    off = c5
    for p in pools:
        cp = p.shape[-1]
        y = y + upsampled_conv3x3(p, weight[:, off:off + cp], (h, w),
                                  dtype=cdt)
        off += cp
    return y
