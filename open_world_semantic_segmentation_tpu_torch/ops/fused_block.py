"""Inference ResNet bottleneck (the opt-in backbone route).

Counterpart of the JAX package's ``ops/pallas_block.py``. For an NHWC input
x (N, H, W, Cin) and BN-folded weights in the JAX layouts:

    y1  = relu(x . w1 + b1)                    (Cin -> Cmid, 1x1)
    y2  = relu(conv3x3_d(y1, w2) + b2)         (Cmid -> Cmid, dilation d,
                                                zero padding of y1)
    out = relu(y2 . w3 + b3 + skip)            (Cmid -> Cout, 1x1)

with skip = x (Cin == Cout) or ``x . wd + bd``; stride 1. Weights: w1
(Cin, Cmid), w2 (3, 3, Cmid, Cmid) indexed by (dh, dw) in (-d, 0, d), w3
(Cmid, Cout), wd (Cin, Cout), all cast to x's dtype before each product;
biases float32. Products accumulate in float32; y1 and y2 are stored in
x's dtype, and the skip is added in float32, where the JAX kernel rounds.

On the card one block call is three launches of the kernel template of
``csrc/fused_bottleneck.cu`` (its note says why three and not one): conv1
into a scratch y1, conv2 as nine taps read from y1 into a scratch y2,
conv3 with the skip (the downsample as a second K segment) into the
output. Each launch tiles its output into 8 x 16 pixel patches of one
image times ``bn`` output channels.

- ``fold_convbn``: an OIHW conv and its inference BatchNorm folded into a
  (kh, kw, I, O) float32 weight and a bias.
- ``fused_block_tile``: whether the kernel takes a block's geometry
  (dilation >= 1, channel rows 16-byte aligned, which TMA needs); the
  patch, or None.
- ``launch_plan``: each phase's ``bn``, output-channel tiles and grid,
  for a card of ``sms`` streaming multiprocessors.
- ``fused_bottleneck_plain``: plain PyTorch, the JAX kernel's rounding.
- ``fused_bottleneck``: the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor goes to the kernel or raises.
  ``fused_bottleneck.launches`` counts block calls that reach the kernel,
  ``fused_bottleneck.kernel_launches`` the kernel launches they enqueue
  (one per phase, three per block call).

The JAX kernel's padded width and slack columns are TPU tiling artefacts
and have no counterpart here: the width is the image's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_SOURCE = "fused_bottleneck.cu"

# must agree with csrc/fused_bottleneck.cu
PATCH_H, PATCH_W = 8, 16        # a tile's output pixels, of one image
BN_CHOICES = (128, 64)          # a tile's output channels
CTAS_PER_SM = 2
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


def fused_block_tile(cin: int, cmid: int, cout: int, dilation: int,
                     itemsize: int = 2) -> Optional[Tuple[int, int]]:
    """The output patch the kernel uses for this block geometry, or None
    if it cannot take it: dilation below 1, or a channel count whose rows
    are not 16-byte aligned in elements of ``itemsize`` bytes (TMA's
    stride rule: multiples of 8 in bf16, the default, and 4 in float32)."""
    align = 16 // itemsize
    if dilation < 1 or min(cin, cmid, cout) < 1:
        return None
    if cin % align or cmid % align or cout % align:
        return None
    return PATCH_H, PATCH_W


def launch_plan(n: int, h: int, w: int, cmid: int, cout: int,
                sms: int) -> Tuple[Tuple[int, int, int], ...]:
    """(bn, output-channel tiles, grid) for conv1, conv2 and conv3 + skip
    on a card of ``sms`` streaming multiprocessors.

    A phase's tiles are the N x ceil(H / 8) x ceil(W / 16) patches times
    its channel tiles; tile t is channel tile t % tiles of patch t // tiles,
    patches in image, row, column order. The kernel is persistent: CTA b
    of the grid takes tiles b, b + grid, ... A tile is 128 channels wide (64
    where the phase has at most 64), and the grid is two CTAs per SM or
    the number of tiles, whichever is smaller.
    """
    patches = n * -(-h // PATCH_H) * -(-w // PATCH_W)
    plan = []
    for channels in (cmid, cmid, cout):
        bn = BN_CHOICES[-1] if channels <= BN_CHOICES[-1] else BN_CHOICES[0]
        tiles = -(-channels // bn)
        plan.append((bn, tiles, min(patches * tiles, sms * CTAS_PER_SM)))
    return tuple(plan)


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


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load

    lib = load(_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_bottleneck.argtypes = ([i32] + [ptr] * 12 + [i32] * 7
                                     + [ctypes.POINTER(i32), i32, ptr])
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


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (132 on an H100
    SXM, 114 on an H100 PCIe)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _plan_c(n: int, h: int, w: int, cmid: int, cout: int, sms: int):
    """``launch_plan`` as the C array the kernel's entry point takes."""
    plan = launch_plan(n, h, w, cmid, cout, sms)
    return (ctypes.c_int * 9)(*[v for phase in plan for v in phase])


def _aligned(t):
    """t, or a copy of it if its data does not start on 16 bytes (TMA)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _prepare(x, w1, b1, w2, b2, w3, b3, wd, bd, dilation):
    """Check a CUDA call and allocate its output and the scratch y1 and y2.
    Returns ``(fn, args, held, out)``: the C entry point, its arguments but
    the phase mask and the stream, and every tensor whose raw pointer is
    in ``args`` (the scratch, the output and any aligned or cast copies),
    which must stay allocated until the launches are enqueued."""
    cin, cmid, cout = _check_shapes(x, w1, b1, w2, b2, w3, b3, wd, bd)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_bottleneck kernel runs on cuda, not "
                           f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_bottleneck kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_bottleneck kernel takes a contiguous NHWC "
                         "input")
    d = int(dilation)
    if fused_block_tile(cin, cmid, cout, d, x.element_size()) is None:
        raise ValueError(f"fused_bottleneck kernel cannot take Cin={cin}, "
                         f"Cmid={cmid}, Cout={cout}, dilation={d} in "
                         f"{x.dtype}")
    weights = [w1, w2, w3] + ([wd] if wd is not None else [])
    biases = [b1, b2, b3] + ([bd] if bd is not None else [])
    for t in weights + biases:
        if t.device != x.device:
            raise RuntimeError(f"fused_bottleneck: a weight lies on "
                               f"{t.device}, the input on {x.device}")
    weights = [_aligned(t.to(x.dtype).contiguous()) for t in weights]
    biases = [_aligned(t.float().contiguous()) for t in biases]
    if wd is None:
        weights.append(None)
        biases.append(None)
    w1c, w2c, w3c, wdc = weights
    b1c, b2c, b3c, bdc = biases
    x = _aligned(x)
    n, h, w, _ = x.shape
    dev = x.device
    y1 = torch.empty((n, h, w, cmid), dtype=x.dtype, device=dev)
    y2 = torch.empty_like(y1)
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=dev)
    args = [_DTYPES[x.dtype]]
    args += [None if t is None else t.data_ptr() for t in
             (x, w1c, b1c, w2c, b2c, w3c, b3c, wdc, bdc, y1, y2, out)]
    args += [n, h, w, cin, cmid, cout, d,
             _plan_c(n, h, w, cmid, cout, _sms(dev.index))]
    held = [t for t in (x, *weights, *biases, y1, y2, out) if t is not None]
    return _library().fused_bottleneck, args, held, out


def _launch(fn, args, dev, phases, stream):
    """Launch the phases of the bit mask on ``stream`` (a cudaStream_t)."""
    if dev.index == torch.cuda.current_device():
        err = fn(*args, phases, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, phases, stream)
    if err != 0:
        raise RuntimeError(f"fused_bottleneck kernel launch failed: "
                           f"CUDA error {err}")


def fused_bottleneck_launcher(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None,
                              *, dilation: int = 1):
    """Check a CUDA call, allocate its output and the scratch y1 and y2,
    and return ``(launch, out)``: ``launch(phases=7)`` launches the phases
    of the bit mask (1 conv1, 2 conv2, 4 conv3 + skip) on the current
    stream and raises if one fails. A timing harness may launch one phase
    at a time, at any later point: the kernel gets raw pointers, so
    ``launch`` holds every tensor they point into for as long as it lives,
    and marks them used on a stream other than the one they were
    allocated on."""
    fn, args, held, out = _prepare(x, w1, b1, w2, b2, w3, b3, wd, bd,
                                   dilation)
    dev = out.device
    home = torch.cuda.current_stream(dev)

    def launch(phases: int = 7):
        stream = torch.cuda.current_stream(dev)
        if stream != home:
            for t in held:
                t.record_stream(stream)
        _launch(fn, args, dev, phases, stream.cuda_stream)

    return launch, out


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None, *,
                     dilation: int = 1):
    """Inference bottleneck on an NHWC batch; see the module note.

    CPU tensors take ``fused_bottleneck_plain``. CUDA tensors launch the
    kernel's three phases (float32 or bfloat16, contiguous input, the whole
    batch in each launch), or raise where the kernel cannot take them.
    """
    if x.device.type == "cpu":
        _check_shapes(x, w1, b1, w2, b2, w3, b3, wd, bd)
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wd, bd,
                                      dilation=dilation)
    fn, args, held, out = _prepare(x, w1, b1, w2, b2, w3, b3, wd, bd,
                                   dilation)
    # ``held`` is freed on return, after the launches are enqueued on the
    # stream it was allocated on, so only later work there can reuse it
    stream = torch.cuda.current_stream(out.device).cuda_stream
    for phase in (1, 2, 4):            # conv1, conv2, conv3 + skip
        _launch(fn, args, out.device, phase, stream)
        fused_bottleneck.kernel_launches += 1
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
fused_bottleneck.kernel_launches = 0
