"""Large-dilation 3x3 convolutions as one product and nine shifted adds.

Counterpart of the JAX package's ``ops/dilated.py``
(``dilated_conv3x3_shift``). A 3x3 conv, stride 1, with zero padding equal
to its dilation d, is exactly a sum of nine shifted 1x1 convs:

    y[h, w] = sum_{i, j in {0, 1, 2}} x[h + (i-1) d, w + (j-1) d] @ W[i, j]

The JAX package shifts the inputs and takes nine products. Here the
products come first and the outputs are shifted: one product ``x @ W``
with the nine taps' matrices side by side (Cin -> 9 * Cout), then each
tap's Cout-wide slice is added, shifted, into the sum. The shifted
operands are the 256-channel outputs, not the 2048-channel inputs of the
ASPP, and the product is one GEMM over all pixels. A tap whose shift lies
outside the map in either direction adds nothing and is left out of the
product.

The product is PyTorch's (``torch.matmul`` on the NHWC view: a channels_last
NCHW tensor is a contiguous NHWC one); the JAX package leaves it to XLA, no
Pallas kernel. The nine terms are summed in at least float32 and the result
is returned in ``x``'s dtype, as the JAX function does (under bf16 autocast
each tap's product is rounded to bf16 before the sum, where XLA keeps it in
float32). Autograd gives the backward.

On an H100 in bf16 channels_last, cuDNN runs the ASPP's rate-12 and rate-18
convs of the 1024x2048 eval with a direct kernel at about 120-135 ms each
(``PERF.md`` §5); ``chip_smoke.py dilated_conv_ways`` times this form
against it.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch


def _taps(h: int, w: int, dy: int, dx: int) -> List[Tuple[int, int, int,
                                                           int]]:
    """(i, j, sy, sx) for each tap whose offset (sy, sx) = ((i-1) dy,
    (j-1) dx) keeps part of an h x w map in view; the centre tap first."""
    taps = [(1, 1, 0, 0)]
    taps += [(i, j, (i - 1) * dy, (j - 1) * dx)
             for i in range(3) for j in range(3)
             if (i, j) != (1, 1) and abs(i - 1) * dy < h
             and abs(j - 1) * dx < w]
    return taps


def dilated_conv3x3_shift(x: torch.Tensor, weight: torch.Tensor,
                          dilation: Union[int, Tuple[int, int]]):
    """3x3 conv, stride 1, zero padding equal to ``dilation``.

    x: (N, Cin, H, W), any memory format; weight: (Cout, Cin, 3, 3), the
    layout of ``nn.Conv2d``. Returns (N, Cout, H, W) in ``x``'s dtype,
    channels_last (the NCHW view of an NHWC result)."""
    dy, dx = (dilation, dilation) if isinstance(dilation, int) else dilation
    n, _, h, w = x.shape
    cout = weight.shape[0]
    taps = _taps(h, w, dy, dx)
    # (Cin, T * Cout): tap t's (Cin, Cout) matrix in columns t*Cout..
    wt = torch.cat([weight[:, :, i, j].t() for i, j, _, _ in taps], 1)
    z = torch.matmul(x.permute(0, 2, 3, 1), wt)
    terms = z.view(n, h, w, len(taps), cout).unbind(3)
    acc = torch.promote_types(z.dtype, torch.float32)
    out = terms[0].to(acc, copy=True)
    for term, (_, _, sy, sx) in zip(terms[1:], taps[1:]):
        # out[h, w] += term[h + sy, w + sx] where both lie in the map
        out[:, max(0, -sy):h - max(0, sy), max(0, -sx):w - max(0, sx)] += \
            term[:, max(0, sy):h - max(0, -sy), max(0, sx):w - max(0, -sx)]
    return out.to(x.dtype).permute(0, 3, 1, 2)
