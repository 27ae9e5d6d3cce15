"""Neighbourhood cosine-similarity map (the ``knn`` OOD score).

Counterpart of the JAX package's ``ops/pallas_knn.py``. For (H, W, C)
features, each pixel L2-normalised with ``max(||f||, eps)``:

    out[p] = sum_{dh, dw in [1, k)} cos(f_p, f_{p + (dh, dw)})
                                   + cos(f_p, f_{p - (dh, dw)})

with out-of-image neighbours counting as zero (k = ``neighbor_size``).

- ``knn_cosine_plain``: plain PyTorch, the arithmetic repeated with shifted
  slices (one pass over the map per shift and direction).
- ``knn_cosine``: the wrapper. A CPU tensor goes to the plain version; a
  CUDA tensor goes to the hand-written kernels of ``csrc/knn_cosine.cu`` or
  raises. They read the raw float32 or bf16 features and normalise them
  themselves: the tiled kernel for C <= 32 and neighbor_size <= 9 (the
  eval's map), the generic path (three simple kernels over channel chunks,
  any C and neighbor_size) for every other map. ``knn_cosine.launches``
  counts calls that launched either.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_SOURCE = "knn_cosine.cu"
# per-block shared memory an H100 grants with the opt-in attribute
_MAX_SMEM = 232448
# values (double) of one of the generic path's two horizontal-sum planes
_GENERIC_PLANE = 1 << 22


def normalize_features(ft: torch.Tensor, eps: float = 1e-8):
    """(H, W, C) -> float32 features divided by ``max(||f||, eps)``."""
    ft = ft.float()
    norm = torch.sqrt((ft * ft).sum(-1, keepdim=True))
    return ft / torch.clamp(norm, min=eps)


def knn_cosine_plain(ft: torch.Tensor, neighbor_size: int = 9,
                     eps: float = 1e-8):
    """(H, W, C) float -> (H, W) float32 cosine-sum map, in plain PyTorch."""
    h, w, _ = ft.shape
    fn = normalize_features(ft, eps)
    out = torch.zeros((h, w), dtype=torch.float32, device=ft.device)
    for dh in range(1, neighbor_size):
        for dw in range(1, neighbor_size):
            if dh >= h or dw >= w:
                continue
            dot = (fn[: h - dh, : w - dw] * fn[dh:, dw:]).sum(-1)
            out[: h - dh, : w - dw] += dot   # neighbour p + (dh, dw)
            out[dh:, dw:] += dot             # neighbour p - (dh, dw)
    return out


def knn_neighbour_counts(h: int, w: int, neighbor_size: int = 9):
    """(h, w) float32: how many of each pixel's 2 (k - 1)^2 diagonal
    neighbours lie in the image, which is the map of a constant feature
    map."""
    halo = neighbor_size - 1
    y = torch.arange(h)[:, None]
    x = torch.arange(w)[None, :]
    fwd = (halo - (y + halo - h + 1).clamp(min=0)).clamp(min=0) * (
        halo - (x + halo - w + 1).clamp(min=0)).clamp(min=0)
    bwd = y.clamp(max=halo) * x.clamp(max=halo)
    return (fwd + bwd).float()


@functools.cache
def _library():
    from ._build import load

    lib = load(_SOURCE)
    lib.knn_cosine.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.knn_cosine.restype = ctypes.c_int
    lib.knn_cosine_generic.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    lib.knn_cosine_generic.restype = ctypes.c_int
    for name in ("knn_cosine_max_channels", "knn_cosine_max_halo"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.knn_cosine_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.knn_cosine_smem_bytes.restype = ctypes.c_size_t
    return lib


def generic_chunk(h: int, w: int, c: int) -> int:
    """Channels per pass of the generic path: as many as keep each
    horizontal-sum plane (h * w * chunk doubles) within 32 MB."""
    return max(1, min(c, _GENERIC_PLANE // (h * w)))


def knn_cosine(ft: torch.Tensor, neighbor_size: int = 9, eps: float = 1e-8):
    """(H, W, C) float -> (H, W) float32 cosine-sum map.

    CPU tensors take ``knn_cosine_plain``; CUDA tensors launch the kernels
    on the raw features (float32 or bf16 as given, any other float type
    cast to float32), which normalise them themselves: the tiled kernel
    where it takes the map, else the generic path.
    """
    if ft.dim() != 3:
        raise ValueError(f"knn_cosine takes (H, W, C) features, got shape "
                         f"{tuple(ft.shape)}")
    if not ft.is_floating_point():
        raise TypeError(f"knn_cosine takes float features, got {ft.dtype}")
    if neighbor_size < 1:
        raise ValueError(f"neighbor_size must be >= 1, got {neighbor_size}")
    if ft.device.type == "cpu":
        return knn_cosine_plain(ft, neighbor_size, eps)
    if ft.device.type != "cuda":
        raise RuntimeError(f"knn_cosine runs on cpu or cuda, not "
                           f"{ft.device}")
    h, w, c = ft.shape
    halo = neighbor_size - 1
    lib = _library()
    if ft.dtype not in (torch.float32, torch.bfloat16):
        ft = ft.float()
    ft = ft.contiguous()
    tiled = (c <= lib.knn_cosine_max_channels()
             and halo <= lib.knn_cosine_max_halo()
             and lib.knn_cosine_smem_bytes(c, halo, ft.element_size())
             <= _MAX_SMEM)
    with torch.cuda.device(ft.device):
        out = torch.empty((h, w), dtype=torch.float32, device=ft.device)
        stream = torch.cuda.current_stream(ft.device).cuda_stream
        if tiled:
            err = lib.knn_cosine(ft.data_ptr(), ft.element_size(),
                                 out.data_ptr(), h, w, c, halo, eps, stream)
        else:
            chunk = generic_chunk(h, w, c)
            norm = torch.empty((h, w), dtype=torch.float64, device=ft.device)
            hsum = torch.empty((2, h, w, chunk), dtype=torch.float64,
                               device=ft.device)
            acc = torch.empty((h, w), dtype=torch.float64, device=ft.device)
            err = lib.knn_cosine_generic(
                ft.data_ptr(), ft.element_size(), out.data_ptr(),
                norm.data_ptr(), hsum.data_ptr(), acc.data_ptr(), h, w, c,
                halo, chunk, eps, stream)
    if err != 0:
        raise RuntimeError(f"knn_cosine kernel launch failed: CUDA error "
                           f"{err}")
    knn_cosine.launches += 1
    return out


knn_cosine.launches = 0
