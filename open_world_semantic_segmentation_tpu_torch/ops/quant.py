"""Post-training int8 quantization of the conv trunk (opt-in).

Counterpart of the JAX package's ``ops/quant.py``; the model side is
``models/layers.py QuantConv2d`` (the ``quant`` modes of ``ConvBN``).

Scheme (symmetric PTQ, as in the JAX package):

- weights: per output channel, ``s_w[o] = max|w[o]| / 127`` (int4:
  ``/ 7``), quantized inline from the float32 parameter or once, offline,
  by :func:`prequantize`;
- activations: per tensor, with a static scale ``amax / 127`` where
  ``amax`` is the largest ``|x|`` a conv saw over the calibration images
  (:func:`calibrate`, the ``calib`` mode).

The quantized state lives beside the parameters: each quantized conv keeps
its ``amax`` and, once prequantized, its ``w_scale`` as buffers that
``state_dict`` leaves out, so a float checkpoint loads unchanged into every
mode. :func:`quant_state` and :func:`load_quant_state` carry them between
the calibration model and the eval model (the JAX package's ``quant``
variable collection).

The conv itself is exact integer arithmetic, ``s8 x s8 -> s32``, what the
JAX package's ``lax.conv_general_dilated(..., preferred_element_type=
jnp.int32)`` computes. :func:`int8_conv2d` takes, on a CUDA tensor, one
``torch._int_mm`` per tap of the kernel on the NHWC activations
(:func:`int8_conv2d_taps`), the taps summed in int32; on a CPU tensor, the
plain version (:func:`int8_conv2d_plain`, a float64 conv of the integer
values, exact: every partial sum stays below 2^53). The JAX package computes
no quantized op in a Pallas kernel, so neither is a kernel of this
repository; a hand-written int8 implicit-GEMM kernel for Hopper is later
work (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.nn.functional as F

# the modes a model takes (``calib`` records the activation scales)
QUANT_MODES = ("off", "calib", "int8", "int8-3x3", "int8-hybrid", "w4a8")
# the modes an eval runs (what ``--quant`` takes)
EVAL_QUANT_MODES = ("off", "int8", "int8-hybrid", "int8-3x3", "w4a8")
# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8
_MM_MIN_ROWS = 17
_MM_MULTIPLE = 8


def check_quant(quant: str, modes=QUANT_MODES) -> str:
    if quant not in modes:
        raise ValueError(f"quant {quant!r}: one of {modes}")
    return quant


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d``, rounded as a true division on every device: CUDA divides
    a tensor by a Python number as a product with its reciprocal, which
    rounds differently (the scales must be the JAX package's
    ``amax / 127``, and a CPU's and a card's must agree)."""
    return a / torch.full_like(a, d)


def quantize_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8 quantization of an OIHW kernel.

    Returns ``(w_q int8, scale float32 (O,))`` with ``w ~= w_q * scale``.
    """
    w = w.float()
    scale = _div(torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12), 127.0)
    w_q = torch.clamp(torch.round(w / scale[:, None, None, None]),
                      -127, 127).to(torch.int8)
    return w_q, scale


def quantize_weight_int4(w: torch.Tensor):
    """Per-output-channel symmetric int4 quantization of an OIHW kernel.

    Returns ``(w_q, scale float32 (O,))``: the int4 values (-7..7) in an
    int8 tensor (PyTorch has no int4 compute; the conv runs s8 x s8 as in
    the JAX package, whose int4 tensor is upcast before the conv)."""
    w = w.float()
    scale = _div(torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12), 7.0)
    w_q = torch.clamp(torch.round(w / scale[:, None, None, None]),
                      -7, 7).to(torch.int8)
    return w_q, scale


def quantize_act(x: torch.Tensor, amax: torch.Tensor):
    """Per-tensor symmetric int8 with the static scale ``amax / 127``.

    Returns ``(x_q int8, scale float32 scalar)``. An uncalibrated ``amax``
    (0, its initial value) gives a NaN scale, so the layer's output is NaN
    rather than every activation saturated at +-127; :func:`prequantize`
    refuses such a state outright. The scale divides ``x`` (as in the JAX
    package; multiplying by ``127 / amax`` rounds differently)."""
    amax = amax.float()
    scale = _div(torch.where(amax > 0, amax,
                             torch.full_like(amax, float("nan"))), 127.0)
    x_q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)
    return x_q, scale


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def int8_conv2d_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride=1,
                      padding=0, dilation=1, groups: int = 1):
    """The exact int8 conv in plain PyTorch: NCHW int8 ``x_q``, OIHW int8
    ``w_q`` -> NCHW int32, as a float64 conv of the integer values (exact:
    |partial sums| <= 127^2 * Cin * kh * kw, far below 2^53), rounded."""
    y = F.conv2d(x_q.double(), w_q.double(), None, _pair(stride),
                 _pair(padding), _pair(dilation), groups)
    return torch.round(y).to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_tap_weights(w_q: torch.Tensor, groups: int, kp: int, np_: int):
    """(kh * kw, kp, np_) int8: tap (i, j)'s (Cin, Cout) matrix, zero-padded
    to kp rows and np_ columns, each stored column-major (a transposed view
    of (Cout, Cin)): with a row-major one cuBLASLt refuses ``_int_mm``
    (CUBLAS_STATUS_NOT_SUPPORTED) for some shapes of a small K on an H100,
    such as a 3-channel input padded to 8. A grouped conv's matrix is block
    diagonal (zeros between the groups: exact, one GEMM per tap)."""
    cout, cin_g, kh, kw = w_q.shape
    cout_g = cout // groups
    taps = w_q.new_zeros((kh * kw, np_, kp))
    wt = w_q.permute(2, 3, 0, 1).reshape(kh * kw, cout, cin_g)
    for g in range(groups):
        taps[:, g * cout_g:(g + 1) * cout_g, g * cin_g:(g + 1) * cin_g] = \
            wt[:, g * cout_g:(g + 1) * cout_g]
    return taps.transpose(1, 2)


def int8_conv2d_taps(x_q: torch.Tensor, w_q: torch.Tensor, stride=1,
                     padding=0, dilation=1, groups: int = 1):
    """The exact int8 conv as one ``torch._int_mm`` per tap, any device.

    The activations go NHWC (a channels_last NCHW tensor already is), zero
    padded by ``padding`` and to a channel count that is a multiple of 8;
    tap (i, j) takes the strided window it reads, (N * Ho * Wo, K), times
    its (K, Cout) matrix, and the taps are summed in int32. A tap whose
    window lies wholly in the padding adds nothing and is skipped. Rows are
    padded to 17 and columns to a multiple of 8 where CUDA's ``_int_mm``
    needs it (zeros: exact), and the weights go column-major
    (``int8_tap_weights``). Returns NCHW int32, channels_last."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    n, cin, h, w = x_q.shape
    cout, _, kh, kw = w_q.shape
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    kp = _round_up(cin, _MM_MULTIPLE)
    np_ = _round_up(cout, _MM_MULTIPLE)
    m = n * ho * wo
    mp = max(m, _MM_MIN_ROWS)
    xp = x_q.new_zeros((n, h + 2 * ph, w + 2 * pw, kp))
    xp[:, ph:ph + h, pw:pw + w, :cin] = x_q.permute(0, 2, 3, 1)
    taps = int8_tap_weights(w_q, groups, kp, np_)
    acc = None
    for i in range(kh):
        r0 = i * dh
        rows = range(r0, r0 + (ho - 1) * sh + 1, sh)
        if not any(ph <= r < ph + h for r in rows):
            continue
        for j in range(kw):
            c0 = j * dw
            cols = range(c0, c0 + (wo - 1) * sw + 1, sw)
            if not any(pw <= c < pw + w for c in cols):
                continue
            win = xp[:, r0:r0 + (ho - 1) * sh + 1:sh,
                     c0:c0 + (wo - 1) * sw + 1:sw]
            a = win.reshape(m, kp)
            if mp != m:
                a = torch.cat([a, a.new_zeros((mp - m, kp))])
            y = torch._int_mm(a, taps[i * kw + j])
            acc = y if acc is None else acc.add_(y)
    if acc is None:
        acc = torch.zeros((mp, np_), dtype=torch.int32, device=x_q.device)
    out = acc[:m, :cout].reshape(n, ho, wo, cout)
    return out.permute(0, 3, 1, 2)


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor, stride=1, padding=0,
                dilation=1, groups: int = 1):
    """``s8 x s8 -> s32`` conv, NCHW int8 ``x_q`` and OIHW int8 ``w_q``:
    the tap form on a CUDA tensor (``int8_conv2d.calls`` counts those
    calls), the plain version on a CPU one."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 operands, got {x_q.dtype} "
                        f"and {w_q.dtype}")
    if x_q.device.type == "cpu":
        return int8_conv2d_plain(x_q, w_q, stride, padding, dilation, groups)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_conv2d: no form for {x_q.device}")
    int8_conv2d.calls += 1
    return int8_conv2d_taps(x_q, w_q, stride, padding, dilation, groups)


int8_conv2d.calls = 0


# ---------------------------------------------------------------------------
# the quantized state of a model: ``amax`` and ``w_scale`` per conv
def _quant_modules(model: torch.nn.Module):
    """(name, module) of every conv that carries an ``amax`` buffer."""
    return [(name, m) for name, m in model.named_modules()
            if "amax" in m._buffers]


def quant_state(model: torch.nn.Module
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{module name: {"amax": ..., "w_scale": ...}}`` of ``model``'s
    quantized convs (the JAX package's ``quant`` collection); of a
    calibration model, the scales it recorded, which :func:`prequantize`
    takes."""
    state = {}
    for name, m in _quant_modules(model):
        entry = {"amax": m.amax.detach().clone()}
        if m.w_scale is not None:
            entry["w_scale"] = m.w_scale.detach().clone()
        state[name] = entry
    return state


def load_quant_state(model: torch.nn.Module, state) -> torch.nn.Module:
    """Copy ``amax`` / ``w_scale`` of ``state`` into ``model``'s quantized
    convs of the same names. A name the model lacks raises; a conv of the
    model that runs in float (the 1x1 convs under ``int8-3x3``) takes
    nothing, as the JAX package's float conv reads nothing of its
    ``quant`` entry."""
    for name, entry in state.items():
        m = model.get_submodule(name)
        if "amax" not in m._buffers:
            continue
        dev = m.weight.device
        if "amax" in entry:
            m.amax = entry["amax"].detach().to(dev, torch.float32).clone()
        if "w_scale" in entry:
            m.w_scale = entry["w_scale"].detach().to(
                dev, torch.float32).clone()
    return model


@torch.no_grad()
def prequantize(model: torch.nn.Module, state, mode: str = "int8"):
    """Quantize the weights of the calibrated convs once, offline, in
    place: each conv named in the calibration ``state`` gets its ``amax``,
    its weight becomes the int8 tensor and its per-channel scale its
    ``w_scale``; the quantized forward then skips the inline quantization.

    ``mode`` is the eval model's: under ``int8-3x3`` the 1x1 convs run in
    float and keep their float weights; ``w4a8`` stores int4 values (in
    int8); ``int8-hybrid`` quantizes the same convs as ``int8`` (the PPM
    fuse conv applies its ``w_scale`` after the concat-free conv). A state
    that is missing or holds an ``amax`` of 0 (a conv no calibration image
    reached) raises. Returns ``model``."""
    check_quant(mode, EVAL_QUANT_MODES)
    if not state:
        raise ValueError("prequantize needs a calibrated quant state (run "
                         "calibrate first)")
    bad = [name for name, entry in state.items()
           if not float(entry["amax"]) > 0.0]
    if bad:
        raise ValueError(f"uncalibrated quant state: amax is 0 at {bad[0]} "
                         f"(and {len(bad) - 1} more); run calibrate on at "
                         "least one image first")
    load_quant_state(model, state)
    quantizer = quantize_weight_int4 if mode == "w4a8" else quantize_weight
    for name in state:
        m = model.get_submodule(name)
        if m.weight.dtype == torch.int8:        # already done: no-op
            continue
        if mode == "int8-3x3" and tuple(m.kernel_size) == (1, 1):
            continue
        if "w_scale" not in m._buffers:
            raise ValueError(f"{name}: a float conv in the {mode} model; "
                             "build it with the mode it was calibrated for")
        w_q, s_w = quantizer(m.weight)
        m.weight = torch.nn.Parameter(w_q, requires_grad=False)
        m.w_scale = s_w
    return model


@torch.no_grad()
def calibrate(model: torch.nn.Module, images: Iterable, seg_size=None,
              dtype=torch.float32):
    """Record each ``calib``-mode conv's largest ``|input|`` over
    ``images`` (NHWC arrays or tensors, batched or not) into its ``amax``;
    calls accumulate. ``dtype``: bfloat16 runs the forwards under autocast,
    as the eval does. Returns :func:`quant_state`."""
    dev = next(model.parameters()).device
    kw = {} if seg_size is None else {"seg_size": tuple(seg_size)}
    model.eval()
    for img in images:
        img = torch.as_tensor(img, dtype=torch.float32)
        if img.dim() == 3:
            img = img[None]
        with torch.autocast(dev.type, dtype=dtype,
                            enabled=dtype != torch.float32):
            model(img.to(dev), **kw)
    return quant_state(model)


def calibrate_and_prequantize(calib_model, model, images, seg_size=None,
                              mode: str = "int8", dtype=torch.float32):
    """One call of the PTQ preparation: the scales recorded by
    ``calib_model`` (built with ``quant="calib"``, the weights of
    ``model``) over ``images``, then ``model`` (built with ``quant=mode``)
    prequantized (:func:`apply_quant_state`). Returns ``model``."""
    state = calibrate(calib_model, images, seg_size=seg_size, dtype=dtype)
    return apply_quant_state(model, state, mode)


def apply_quant_state(model: torch.nn.Module, state, mode: str):
    """``model`` (built with ``quant=mode``) ready for the int8 eval from
    the scales ``state`` that :func:`calibrate` recorded: prequantized, or
    under ``w4a8`` given the scales alone (its weights quantize inline, as
    in the JAX package). Returns ``model``."""
    if mode == "w4a8":
        return load_quant_state(model, state)
    return prequantize(model, state, mode=mode)
