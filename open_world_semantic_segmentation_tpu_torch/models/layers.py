"""Shared building blocks: conv + batch-norm + activation.

Modules keep the reference's torch ``state_dict`` key names, so its
checkpoints load with plain ``load_state_dict``: ``ConvBN`` is a
``Sequential`` (conv at index 0, BN at 1), which gives the reference's
``downsample.0`` / ``downsample.1`` and ``cbr_deepsup.0`` / ``.1`` keys.

``ConvBN`` routes a 3x3, stride-1, ungrouped conv with dilation of 6 or
more and padding equal to its dilation (the ASPP's atrous branches)
through ``ops/dilated.py`` by default, as the JAX package's
``ConvBN._use_shift_dilated`` does; ``dilated_impl="native"`` keeps the
plain conv (the JAX package's ``OWSS_DILATED_IMPL=native``). Either way
the conv is an ``nn.Conv2d`` with the same ``weight``.

``quant`` (the JAX package's ``ConvBN`` modes, ``ops/quant.py``): ``off``
(the float conv); ``calib`` records ``max|x|`` into the conv's ``amax``;
``int8`` and ``w4a8`` run the exact ``s8 x s8 -> s32`` conv
(``QuantConv2d``); ``int8-3x3`` is ``int8`` for every conv but the 1x1
ones, which stay in float; ``int8-hybrid`` is ``int8`` here (the PPM
decoder and the DeepLab factories resolve it further). A quantized conv is
an ``nn.Conv2d`` with the same ``weight`` parameter, so the state dict's
keys are the same in every mode; ``amax`` and ``w_scale`` are buffers the
state dict leaves out. Under quant the shift-form dilated conv gives way
to the int8 conv, as in the JAX package.

Batch norm in training mode follows the JAX package (flax ``BatchNorm``),
not ``torch.nn.BatchNorm2d``, where the two differ: the running variance
takes in the biased batch variance (torch takes the unbiased one, n/(n-1)
times larger). Across ranks (``group``, which ``train/state.py TrainStep``
sets) it normalises with the statistics of the global batch, as the JAX
package's BN does under pjit.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dilated import dilated_conv3x3_shift
from ..ops.quant import (check_quant, int8_conv2d, quantize_act,
                         quantize_weight, quantize_weight_int4)

DILATED_IMPLS = ("shift", "native")


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-variance update in training:
    running_var = (1 - m) * running_var + m * biased batch variance.

    torch's own update is kept and corrected afterwards, on the C running
    values alone: from torch's r' = (1 - m) r + m v n / (n - 1), flax's
    value is r' (n - 1) / n + (1 - m) r / n. No extra pass over the
    activations; two element-wise ops on C values and a copy of r per call.

    ``update_stats = False`` (the trainer's ``fix_bn``) normalises with the
    batch statistics and leaves the running ones as they were.

    ``group``: a process group of more than one rank makes the batch the
    global one (``_GlobalBatchNorm``): mean and biased variance over every
    rank's samples, the running statistics updated with them (n the global
    count), the gradient through the same sums. In eval mode no collective
    runs: the running statistics normalise, as in one process.
    ``nn.SyncBatchNorm`` would not do: it refuses CPU tensors and folds the
    unbiased variance into the running one.
    """

    update_stats = True
    group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._global_forward(x)
        if not self.update_stats:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        n = x.numel() // x.shape[1]
        # torch's factor: momentum, or 1 / batches seen when it is None
        m = (self.momentum if self.momentum is not None
             else 1.0 / (float(self.num_batches_tracked) + 1.0))
        old = self.running_var.clone()
        y = super().forward(x)
        # through .data: autograd saved running_var with the batch norm (its
        # training backward does not read it) and would refuse a new version
        self.running_var.data.mul_((n - 1) / n).add_(old, alpha=(1 - m) / n)
        return y

    def _global_forward(self, x):
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                              self.eps, self.group)
        if self.update_stats and self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = (self.momentum if self.momentum is not None
                     else 1.0 / float(self.num_batches_tracked))
                self.running_mean.mul_(1 - m).add_(
                    mean.to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1 - m).add_(
                    var.to(self.running_var.dtype), alpha=m)
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch norm over the samples of every rank of ``group``: (y, mean,
    biased variance). The sums are taken in at least float32 (under bf16
    autocast too), each as one all-reduce; y has x's dtype. The backward
    is batch norm's, its two per-channel sums all-reduced: of ``g`` and of
    ``g * x_hat``. Only x and the statistics are kept for it, as the native
    batch norm keeps them. The weight and bias gradients are this rank's
    sums; the train step averages them over the ranks with the rest."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        acc = torch.promote_types(x.dtype, torch.float32)
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, c] + [1] * (x.dim() - 2)
        xf = x.to(acc)
        sums = torch.cat([xf.sum(dims),
                          torch.full((1,), x.numel() // c, dtype=acc,
                                     device=x.device)])
        dist.all_reduce(sums, group=group)
        n = sums[c]
        mean = sums[:c] / n
        centred = xf - mean.view(shape)
        var = (centred * centred).sum(dims)
        dist.all_reduce(var, group=group)
        var = var / n
        invstd = torch.rsqrt(var + eps)
        y = centred * invstd.view(shape)
        if weight is not None:
            y = y * weight.to(acc).view(shape) + bias.to(acc).view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, grad, _grad_mean, _grad_var):
        x, weight, mean, invstd, n = ctx.saved_tensors
        acc = mean.dtype
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, c] + [1] * (x.dim() - 2)
        x_hat = (x.to(acc) - mean.view(shape)) * invstd.view(shape)
        g = grad.to(acc)
        sum_g = g.sum(dims)
        sum_gx = (g * x_hat).sum(dims)
        sums = torch.cat([sum_g, sum_gx])
        dist.all_reduce(sums, group=ctx.group)
        scale = invstd if weight is None else invstd * weight.to(acc)
        grad_x = ((g - (sums[:c] / n).view(shape)
                   - x_hat * (sums[c:] / n).view(shape))
                  * scale.view(shape))
        grad_w = grad_b = None
        if weight is not None:
            grad_w = sum_gx.to(weight.dtype)
            grad_b = sum_g.to(weight.dtype)
        return grad_x.to(x.dtype), grad_w, grad_b, None, None


@dataclasses.dataclass(frozen=True)
class BNConfig:
    """Batch-norm settings shared across a model (torch momentum convention:
    new = (1 - m) * running + m * batch)."""

    momentum: float = 0.1
    epsilon: float = 1e-5

    def make(self, num_features: int) -> BatchNorm2d:
        return BatchNorm2d(num_features, eps=self.epsilon,
                           momentum=self.momentum)


class ShiftDilatedConv2d(nn.Conv2d):
    """An ``nn.Conv2d`` (3x3, stride 1, padding = dilation) computed as
    ``ops.dilated.dilated_conv3x3_shift``."""

    def forward(self, x):
        return dilated_conv3x3_shift(x, self.weight, self.dilation)


class QuantConv2d(nn.Conv2d):
    """An ``nn.Conv2d`` (no bias) in one of the quantized modes ``calib``,
    ``int8``, ``w4a8`` or ``off`` (the PPM fuse conv under ``int8-hybrid``,
    which keeps its float dataflow but may hold an int8 weight).

    ``calib`` runs the float conv and records ``max|x|`` (float32) into
    ``amax`` (initially 0, so a conv no image reached stays visibly
    uncalibrated). ``int8`` quantizes ``x`` with the static scale ``amax /
    127`` and the weight per output channel, unless the weight is already
    int8 (``ops.quant.prequantize``; its scale is ``w_scale``), runs the
    exact int8 conv and dequantizes in float32: the result carries the
    compute dtype (the autocast dtype under autocast, else ``x``'s).
    ``w4a8`` quantizes the float weight to int4 values inline.

    Loading a state dict whose weight is int8 (a prequantized checkpoint,
    or the JAX package's tree through ``train/convert.py``) keeps it int8.
    """

    def __init__(self, *args, mode: str = "int8", **kwargs):
        super().__init__(*args, **kwargs)
        if mode not in ("off", "calib", "int8", "w4a8"):
            raise ValueError(f"QuantConv2d mode {mode!r}")
        self.mode = mode
        self.register_buffer("amax", torch.zeros(()), persistent=False)
        self.register_buffer("w_scale", None, persistent=False)

    def forward(self, x):
        if self.mode == "calib":
            with torch.no_grad():
                self.amax = torch.maximum(
                    self.amax, x.detach().float().abs().amax())
        if self.mode in ("calib", "off"):
            return super().forward(x)
        if self.training:
            raise RuntimeError("int8 PTQ is an inference-only mode")
        out_dtype = x.dtype
        if torch.is_autocast_enabled(x.device.type):
            out_dtype = torch.get_autocast_dtype(x.device.type)
        x_q, s_x = quantize_act(x, self.amax)
        if self.weight.dtype == torch.int8:
            w_q, s_w = self.weight, self.w_scale
        elif self.mode == "w4a8":
            w_q, s_w = quantize_weight_int4(self.weight)
        else:
            w_q, s_w = quantize_weight(self.weight)
        y = int8_conv2d(x_q, w_q, self.stride, self.padding, self.dilation,
                        self.groups)
        return (y.float() * (s_x * s_w)[:, None, None]).to(out_dtype)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        w = state_dict.get(prefix + "weight")
        if w is not None and w.dtype == torch.int8:
            self.weight = nn.Parameter(torch.empty_like(
                w, device=self.weight.device), requires_grad=False)
        return super()._load_from_state_dict(state_dict, prefix, *args,
                                             **kwargs)


def resolve_quant(quant: str, kernel_size: int) -> str:
    """A conv's own mode under a model's ``quant``: ``int8-3x3`` leaves the
    1x1 convs in float, ``int8-hybrid`` is ``int8`` at the conv."""
    check_quant(quant)
    if quant == "int8-3x3":
        return "int8" if kernel_size != 1 else "off"
    if quant == "int8-hybrid":
        return "int8"
    return quant


def make_conv(in_channels: int, out_channels: int, kernel_size: int,
              stride: int = 1, padding: int = 0, dilation: int = 1,
              groups: int = 1, quant: str = "off",
              dilated_impl: str = "shift") -> nn.Conv2d:
    """The conv of a ``ConvBN`` (no bias): a ``QuantConv2d`` where the
    conv's mode is quantized, else the shift form for an eligible dilated
    conv, else ``nn.Conv2d``."""
    mode = resolve_quant(quant, kernel_size)
    if mode != "off":
        return QuantConv2d(in_channels, out_channels, kernel_size, stride,
                           padding, dilation, groups, bias=False, mode=mode)
    conv = (ShiftDilatedConv2d if use_shift_dilated(
        kernel_size, stride, padding, dilation, groups, dilated_impl)
        else nn.Conv2d)
    return conv(in_channels, out_channels, kernel_size, stride, padding,
                dilation, groups, bias=False)


def use_shift_dilated(kernel_size: int, stride: int, padding: int,
                      dilation: int, groups: int,
                      dilated_impl: str = "shift") -> bool:
    """The JAX package's ``ConvBN._use_shift_dilated``: 3x3, stride 1,
    ungrouped, dilation at least 6, padding equal to the dilation."""
    if dilated_impl not in DILATED_IMPLS:
        raise ValueError(f"dilated_impl {dilated_impl!r}: one of "
                         f"{DILATED_IMPLS}")
    return (dilated_impl == "shift" and kernel_size == 3 and stride == 1
            and groups == 1 and dilation >= 6 and padding == dilation)


class ConvBN(nn.Sequential):
    """Conv2d (no bias) + BatchNorm2d + optional ReLU, NCHW. An eligible
    dilated conv takes the shift form unless ``dilated_impl="native"``;
    ``quant`` as in the module note (``make_conv``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 dilation: int = 1, groups: int = 1, relu: bool = True,
                 bn: BNConfig = BNConfig(), dilated_impl: str = "shift",
                 quant: str = "off"):
        layers = [make_conv(in_channels, out_channels, kernel_size, stride,
                            padding, dilation, groups, quant, dilated_impl),
                  bn.make(out_channels)]
        if relu:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


def Conv(in_channels: int, out_channels: int, kernel_size: int = 1,
         stride: int = 1, padding: int = 0, dilation: int = 1,
         groups: int = 1, use_bias: bool = True) -> nn.Conv2d:
    """Plain torch Conv2d (bias optional), the JAX ``Conv`` wrapper's
    counterpart."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding,
                     dilation, groups, bias=use_bias)


@torch.no_grad()
def init_module(module: nn.Module, generator: torch.Generator, *,
                fan_out: bool, bn_bias: float = 0.0):
    """Random initialisation of the JAX package's schemes, drawn from
    ``generator`` in module order: convs normal(0, sqrt(2 / fan)) with fan
    kh * kw * out_channels (``fan_out``) or kh * kw * in_channels / groups,
    conv biases zero; BN weight 1, bias ``bn_bias``, running mean 0 and
    var 1."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            fan = kh * kw * (m.out_channels if fan_out
                             else m.in_channels // m.groups)
            w = torch.empty(m.weight.shape).normal_(
                0.0, math.sqrt(2.0 / fan), generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.fill_(bn_bias)
            m.reset_running_stats()
    return module
