"""Fused inference ResNet bottleneck (the opt-in backbone route).

Counterpart of the JAX package's ``ops/pallas_block.py``. For an NHWC input
x (N, H, W, Cin) and BN-folded weights in the kernel's layout:

    y1  = relu(x . w1 + b1)                    (Cin -> Cmid, 1x1)
    y2  = relu(conv3x3_d(y1, w2) + b2)         (Cmid -> Cmid, dilation d,
                                                zero padding of y1)
    out = relu(y2 . w3 + b3 + skip)            (Cmid -> Cout, 1x1)

with skip = x (Cin == Cout) or ``x . wd + bd``; stride 1. Weights: w1
(Cin, Cmid), w2 (3, 3, Cmid, Cmid) indexed by (dh, dw) in (-d, 0, d), w3
(Cmid, Cout), wd (Cin, Cout), all cast to x's dtype before each product;
biases float32. Products accumulate in float32; y1 and y2 are stored in
x's dtype, and the skip is added in float32, where the JAX kernel rounds.

- ``fold_convbn``: an OIHW conv and its inference BatchNorm folded into a
  (kh, kw, I, O) float32 weight and a bias.
- ``fused_block_tile``: whether the kernels take a block's geometry (the
  H100 shared-memory budget); the tile, or None.
- ``fused_bottleneck_plain``: plain PyTorch, the JAX kernel's rounding.
- ``fused_bottleneck``: the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor goes to the hand-written kernel of
  ``csrc/fused_bottleneck.cu`` or raises. ``fused_bottleneck.launches``
  counts kernel launches.

The JAX kernel's padded width and slack columns are TPU tiling artefacts
and have no counterpart here: the width is the image's.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_SOURCE = "fused_bottleneck.cu"

# must agree with csrc/fused_bottleneck.cu
TILE = 8              # a block computes TILE x TILE output pixels
KC = 32               # conv1-output / conv2-input channels per chunk
NC = 64               # output channels of conv2 and conv3 per chunk
KK = 32               # reduction depth staged in shared memory
MAX_HALO_PIXELS = 256  # (TILE + 2 d)^2, so d <= 4
MAX_SMEM = 232448     # per-block shared memory of an H100 (opt-in)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fold_convbn(weight, bn_weight, bn_bias, bn_mean, bn_var,
                eps: float = 1e-5):
    """OIHW conv weight + inference BN -> ((kh, kw, I, O) weight, (O,)
    bias), both float32: g = scale / sqrt(var + eps), w = k * g,
    b = beta - mean * g (the JAX ``fold_convbn`` after the (O, I, kh, kw)
    -> (kh, kw, I, O) transpose of ``train/convert.py``)."""
    g = bn_weight.float() / torch.sqrt(bn_var.float() + eps)
    w = weight.float().permute(2, 3, 1, 0) * g
    b = bn_bias.float() - bn_mean.float() * g
    return w.contiguous(), b


def fused_block_smem_bytes(cmid: int, dilation: int) -> int:
    """Shared memory of one kernel block, the larger of the two kernels'
    (``csrc/fused_bottleneck.cu`` says what each holds).

    float32 (scalar FMAs): the float32 conv2 accumulator of the tile
    (rows padded by one word), a KC-channel chunk of y1 over the halo'd
    window, the staged input and the staged weights, all float32.
    bfloat16 (tensor cores): the float32 accumulator (rows padded by 8), a
    bf16 y1 chunk over the halo'd window rounded up to 16 pixels, and one
    region that the conv1 staging, the conv1 epilogue, the nine staged
    conv2 taps and the conv3 staging take in turn.
    """
    halo = (TILE + 2 * dilation) ** 2
    cmid_pad = -(-cmid // NC) * NC
    f32 = 4 * (TILE * TILE * (cmid_pad + 1) + halo * (KC + 1)
               + max(halo, TILE * TILE) * (KK + 1) + KK * NC)
    # bf16 rows padded to 32 bytes for WMMA: 64 + 16, 32 + 16 elements
    halo16, px = -(-halo // 16) * 16, TILE * TILE
    shared = max(halo16 * 80 * 2 + 64 * 48 * 2,      # conv1 staging
                 halo16 * 40 * 4,                    # conv1 epilogue
                 9 * KC * 80 * 2,                    # conv2 taps
                 2 * px * 80 * 2 + px * 72 * 4)      # conv3 staging
    bf16 = 4 * px * (cmid_pad + 8) + halo16 * 48 * 2 + shared
    return max(f32, bf16)


def fused_block_tile(cin: int, cmid: int, cout: int,
                     dilation: int) -> Optional[Tuple[int, int]]:
    """The output tile the kernels use for this block geometry, or None if
    they cannot take it (dilation outside 1..4, or over the shared memory
    of one H100 block). The same verdict for float32 and bfloat16."""
    if min(cin, cmid, cout) < 1 or not 1 <= dilation:
        return None
    if (TILE + 2 * dilation) ** 2 > MAX_HALO_PIXELS:
        return None
    if fused_block_smem_bytes(cmid, dilation) > MAX_SMEM:
        return None
    return TILE, TILE


def fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None, *,
                           dilation: int = 1):
    """(N, H, W, Cin) -> (N, H, W, Cout) in x's dtype, in plain PyTorch.
    The 3x3 is nine shifted float32 matrix products over the zero-padded
    y1 (in the JAX kernel's tap order), so no cuDNN convolution and no
    TF32 takes part."""
    n, h, w, _ = x.shape
    d = int(dilation)
    cdt = x.dtype

    def cast(t):                      # weights rounded to the compute dtype
        return t.to(cdt).float()

    xf = x.float()
    y1 = torch.relu(xf @ cast(w1) + b1.float()).to(cdt).float()
    y1p = F.pad(y1, (0, 0, d, d, d, d))         # zero padding of y1
    w2c = cast(w2)
    acc = b2.float().expand(n, h, w, -1)
    for jdx in range(3):
        for idx in range(3):
            tap = y1p[:, idx * d:idx * d + h, jdx * d:jdx * d + w]
            acc = acc + tap @ w2c[idx, jdx]
    y2 = torch.relu(acc).to(cdt).float()
    out = y2 @ cast(w3) + b3.float()
    skip = xf if wd is None else xf @ cast(wd) + bd.float()
    return torch.relu(out + skip).to(cdt)


def _library():
    from ._build import load

    lib = load(_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_bottleneck.argtypes = [i32] + [ptr] * 10 + [i32] * 7 + [ptr]
    lib.fused_bottleneck.restype = i32
    return lib


def _check_shapes(x, w1, b1, w2, b2, w3, b3, wd, bd):
    if x.dim() != 4:
        raise ValueError(f"fused_bottleneck takes NHWC input, got shape "
                         f"{tuple(x.shape)}")
    cin = x.shape[3]
    cmid, cout = w1.shape[1], w3.shape[1]
    want = {"w1": (w1, (cin, cmid)), "b1": (b1, (cmid,)),
            "w2": (w2, (3, 3, cmid, cmid)), "b2": (b2, (cmid,)),
            "w3": (w3, (cmid, cout)), "b3": (b3, (cout,))}
    if (wd is None) != (bd is None):
        raise ValueError("wd and bd go together")
    if wd is None:
        if cout != cin:
            raise ValueError(f"identity skip needs Cout == Cin, got "
                             f"{cout} != {cin}")
    else:
        want.update(wd=(wd, (cin, cout)), bd=(bd, (cout,)))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape}")
    return cin, cmid, cout


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None, *,
                     dilation: int = 1):
    """Fused inference bottleneck on an NHWC batch; see the module note.

    CPU tensors take ``fused_bottleneck_plain``. CUDA tensors launch the
    kernel (float32 or bfloat16, contiguous input, one launch for the
    whole batch), or raise where the kernel cannot take them.
    """
    cin, cmid, cout = _check_shapes(x, w1, b1, w2, b2, w3, b3, wd, bd)
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wd, bd,
                                      dilation=dilation)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_bottleneck runs on cpu or cuda, not "
                           f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_bottleneck kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_bottleneck kernel takes a contiguous NHWC "
                         "input")
    d = int(dilation)
    if fused_block_tile(cin, cmid, cout, d) is None:
        raise ValueError(f"fused_bottleneck kernel cannot take Cin={cin}, "
                         f"Cmid={cmid}, Cout={cout}, dilation={d}")
    weights = [w1, w2, w3] + ([wd] if wd is not None else [])
    biases = [b1, b2, b3] + ([bd] if bd is not None else [])
    for t in weights + biases:
        if t.device != x.device:
            raise RuntimeError(f"fused_bottleneck: a weight lies on "
                               f"{t.device}, the input on {x.device}")
    weights = [t.to(x.dtype).contiguous() for t in weights]
    biases = [t.float().contiguous() for t in biases]
    if wd is None:
        weights.append(None)
        biases.append(None)
    w1c, w2c, w3c, wdc = weights
    b1c, b2c, b3c, bdc = biases
    n, h, w, _ = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [None if t is None else t.data_ptr()
                for t in (x, w1c, b1c, w2c, b2c, w3c, b3c, wdc, bdc, out)]
        err = lib.fused_bottleneck(_DTYPES[x.dtype], *ptrs, n, h, w, cin,
                                   cmid, cout, d, stream)
    if err != 0:
        raise RuntimeError(f"fused_bottleneck kernel launch failed: CUDA "
                           f"error {err}")
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
