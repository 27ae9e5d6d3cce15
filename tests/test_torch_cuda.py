"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``; without a GPU each test skips. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: atol 2e-5 for the knn map (a sum of 128 float32 cosines), as
``tests/test_pallas.py`` holds the TPU kernel; for the fused bottleneck
1e-4 in float32 (summation order; TF32 off) and 5e-2 in bfloat16 (y1 and
y2 rounded to 8 bits of mantissa), as ``tests/test_pallas_block.py``
holds the TPU kernel; 1e-5 for the device OOD metrics, as
``tests/test_metrics_device.py`` holds the JAX module. The shift form of
the ASPP's dilated convs (``ops/dilated.py``, PyTorch ops, no kernel of
its own) against cuDNN's conv, forward and backward, channels_last: in
float32 (TF32 off) within 1e-4 of the largest magnitude (summation
order), in bf16 within 5e-2 (each tap's product rounded to bf16 before the
float32 sum, cuDNN's one float32 sum rounded once). The CRF scoring
branches (depthwise blurs, PyTorch ops) on cuda against the CPU in float32
with TF32 off: conf within 1e-4. The server (``cli/serve.py``) on cuda,
unfused and on the fused route, and an exported artifact against the
direct forward of the same model at the same batch size, fp32 with TF32
off: labels equal on 99 % of pixels, float16 conf maps within 2e-3 of
their largest magnitude (at least of 1) with their NaNs in the same
places. The int8 conv's tap form (``torch._int_mm``) on cuda equals its
plain version (a float64 conv of the integers) exactly, and so does one
quantized conv (int8 and w4a8, inline and prequantized) on cuda and on
the CPU, given the same input. A prequantized int8 model's forward on
cuda holds to the same model on the CPU (fp32, TF32 off): argmax equal on
99 % of pixels, scores within 5e-2 of the largest. The int8 convs are
exact on both; the float layers between them sum in another order, and an
activation that lands within that rounding of a step of the int8 grid
rounds the other way, one step of ``amax / 127``, which the layers after
carry (1.75e-2 of the largest score seen on an H100 for int8). Two runs of 10 DeepLab train
steps at one seed under ``torch.use_deterministic_algorithms(True)`` give
bit-identical weights (cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG``, set below
before its first call).
"""

import os

import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu_torch.metrics.anom_device import (
    ood_measures_from_maps)
from open_world_semantic_segmentation_tpu_torch.models.builder import (
    SegmentationModel, init_weights)
from open_world_semantic_segmentation_tpu_torch.models.decoders import (
    PPMDeepsupEmbedding)
from open_world_semantic_segmentation_tpu_torch.models.resnet import (
    Bottleneck, ResNet)
from open_world_semantic_segmentation_tpu_torch.openset import scoring
from open_world_semantic_segmentation_tpu_torch.openset.evaluator import (
    multi_scale_forward)
from open_world_semantic_segmentation_tpu_torch.train.optim import (
    poly_schedule, two_group_optimizer)
from open_world_semantic_segmentation_tpu_torch.train.state import (
    AnomalyTrainStep)
from open_world_semantic_segmentation_tpu_torch.ops.dilated import (
    dilated_conv3x3_shift)
from open_world_semantic_segmentation_tpu_torch.ops.fused_block import (
    fused_bottleneck, fused_bottleneck_launcher, fused_bottleneck_plain)
from open_world_semantic_segmentation_tpu_torch.ops.knn import (
    knn_cosine, knn_cosine_plain, knn_neighbour_counts)

# before cuBLAS's first call (importing torch makes none): the
# deterministic DeepLab training below
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ATOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the kernel's tiles are 32 x 32 pixels in bf16 and 16 x 32 in float32:
# (65, 95) and (63, 97) put H and W one past and one short of a multiple
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,neighbor_size", [
    ((45, 80, 13), 9), ((9, 17, 4), 9), ((64, 128, 19), 3),
    ((720, 1280, 13), 9), ((33, 70, 32), 9), ((5, 3, 1), 2),
    ((65, 95, 13), 9), ((63, 97, 13), 9), ((40, 50, 13), 1),
])
def test_knn_kernel_matches_plain(cuda, dtype, shape, neighbor_size):
    rng = np.random.default_rng(0)
    ft = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ft[torch.from_numpy(rng.random(shape[:2]) < 0.05)] = 0.0
    ft = ft.to(cuda, dtype)
    before = knn_cosine.launches
    got = knn_cosine(ft, neighbor_size)
    torch.cuda.synchronize()
    assert knn_cosine.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == shape[:2]
    want = knn_cosine_plain(ft, neighbor_size)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,neighbor_size", [
    ((720, 1280, 13), 9), ((9, 13, 13), 9), ((65, 95, 32), 9),
    ((12, 17, 7), 3), ((20, 30, 5), 5), ((20, 30, 5), 1)])
def test_knn_kernel_constant_map_gives_neighbour_counts(cuda, dtype, shape,
                                                        neighbor_size):
    v = np.random.default_rng(1).standard_normal(shape[-1]) * 3.0
    ft = torch.from_numpy(v.astype(np.float32)).to(cuda, dtype)
    got = knn_cosine(ft.expand(shape), neighbor_size)
    want = knn_neighbour_counts(shape[0], shape[1], neighbor_size)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.cuda
def test_knn_kernel_zero_and_bf16_input(cuda):
    zero = knn_cosine(torch.zeros((16, 24, 5), device=cuda))
    assert torch.count_nonzero(zero).item() == 0
    ft = torch.randn((40, 50, 13), device=cuda).bfloat16()
    np.testing.assert_allclose(knn_cosine(ft).cpu().numpy(),
                               knn_cosine_plain(ft).cpu().numpy(), atol=ATOL)
    # a zero pixel contributes nothing and scores 0
    ft[7, 9] = 0
    got = knn_cosine(ft)
    assert got[7, 9].item() == 0.0
    np.testing.assert_allclose(got.cpu().numpy(),
                               knn_cosine_plain(ft).cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
def test_knn_kernel_rejects_what_it_cannot_take(cuda):
    """Every C and neighbor_size >= 1 has a kernel (the tiled one or the
    generic path); what is left to refuse is the wrong rank or type."""
    before = knn_cosine.launches
    with pytest.raises(ValueError, match="takes \\(H, W, C\\)"):
        knn_cosine(torch.zeros((8, 8), device=cuda))
    with pytest.raises(TypeError, match="float features"):
        knn_cosine(torch.zeros((8, 8, 4), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="neighbor_size must be >= 1"):
        knn_cosine(torch.zeros((8, 8, 33), device=cuda), neighbor_size=0)
    assert knn_cosine.launches == before


# the generic path: C above 32 (the 4096-d PPM concat at feature resolution
# among them) or neighbor_size above 9
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,neighbor_size", [
    ((40, 56, 64), 11), ((90, 160, 4096), 9), ((33, 70, 13), 11),
    ((20, 30, 33), 9), ((5, 3, 40), 12), ((9, 7, 64), 1)])
def test_knn_generic_path_matches_plain(cuda, dtype, shape, neighbor_size):
    rng = np.random.default_rng(2)
    ft = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ft[torch.from_numpy(rng.random(shape[:2]) < 0.05)] = 0.0
    ft = ft.to(cuda, dtype)
    before = knn_cosine.launches
    got = knn_cosine(ft, neighbor_size)
    torch.cuda.synchronize()
    assert knn_cosine.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == shape[:2]
    np.testing.assert_allclose(got.cpu().numpy(),
                               knn_cosine_plain(ft, neighbor_size).cpu()
                               .numpy(), atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,neighbor_size", [
    ((30, 40, 64), 11), ((20, 25, 13), 12), ((12, 9, 4096), 9)])
def test_knn_generic_path_constant_map_gives_neighbour_counts(
        cuda, shape, neighbor_size):
    v = np.random.default_rng(3).standard_normal(shape[-1]) * 3.0
    ft = torch.from_numpy(v.astype(np.float32)).to(cuda)
    got = knn_cosine(ft.expand(shape), neighbor_size)
    want = knn_neighbour_counts(shape[0], shape[1], neighbor_size)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=ATOL)


def _block_inputs(n, h, w, cin, cmid, cout, d, down, seed=0):
    """Inputs and weights of std 0.3 (``tests/test_pallas_block.py``'s
    scale) up to 256 input channels. Past that, weights of std
    sqrt(1 / fan_in), as ``chip_smoke.py`` makes them: at std 0.3 a
    2048-channel block's sums reach |100|, where the float32 tolerance of
    1e-4 (stated for values of order 1) would hold the summation order of
    4608-term sums to 1e-6 of their size."""
    rng = np.random.default_rng(seed)
    deep = max(cin, cmid) > 256
    scale = lambda fan: fan ** -0.5 if deep else 0.3
    mk = lambda *s, fan=1 / 0.09: torch.from_numpy(
        (rng.standard_normal(s) * scale(fan)).astype(np.float32))
    ws = [mk(cin, cmid, fan=cin), mk(cmid),
          mk(3, 3, cmid, cmid, fan=9 * cmid) * (1 if deep else 0.2),
          mk(cmid), mk(cmid, cout, fan=cmid), mk(cout)]
    ws += [mk(cin, cout, fan=cin), mk(cout)] if down else [None, None]
    return mk(n, h, w, cin), ws


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (n, h, w, cin, cmid, cout, d, down)
    (2, 13, 21, 32, 16, 32, 1, False),     # ragged tiles, identity
    (1, 25, 33, 64, 32, 64, 2, False),     # dilation 2
    (2, 16, 24, 24, 16, 48, 1, True),      # downsample, Cin not 32k
    (1, 17, 19, 16, 40, 16, 4, False),     # dilation 4, Cmid not 32k
    (1, 5, 3, 96, 64, 128, 4, True),       # map smaller than the halo
    (1, 20, 30, 256, 64, 256, 1, False),   # layer1 channels
    (1, 21, 35, 64, 64, 256, 1, True),     # 7x7-stem layer1.0: Cin 64
    (2, 38, 67, 2048, 512, 2048, 4, False),  # layer4, 304x536, batch 2
    (1, 23, 37, 2048, 512, 2048, 8, False),  # dilation 8
    (1, 19, 29, 1024, 1024, 2048, 2, True),  # Cmid 1024, downsample
])
def test_fused_kernel_matches_plain(cuda, no_tf32, dtype, shape):
    n, h, w, cin, cmid, cout, d, down = shape
    x, ws = _block_inputs(n, h, w, cin, cmid, cout, d, down)
    x = x.to(cuda, dtype)
    ws = [None if t is None else t.to(cuda) for t in ws]
    before = fused_bottleneck.launches, fused_bottleneck.kernel_launches
    got = fused_bottleneck(x, *ws, dilation=d)
    torch.cuda.synchronize()
    assert (fused_bottleneck.launches, fused_bottleneck.kernel_launches) \
        == (before[0] + 1, before[1] + 3)   # one block call, three phases
    assert got.dtype == dtype and got.shape == (n, h, w, cout)
    assert torch.isfinite(got).all()
    want = fused_bottleneck_plain(x, *ws, dilation=d)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_fused_kernel_rejects_what_it_cannot_take(cuda):
    x, ws = _block_inputs(1, 8, 8, 32, 16, 32, 1, False)
    x = x.to(cuda)
    ws = [None if t is None else t.to(cuda) for t in ws]
    before = fused_bottleneck.launches, fused_bottleneck.kernel_launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_bottleneck(x.half(), *ws)
    with pytest.raises(ValueError, match="contiguous"):
        fused_bottleneck(x.transpose(1, 2), *ws)
    with pytest.raises(ValueError, match="cannot take"):
        fused_bottleneck(x, *ws, dilation=0)
    xo, wo = _block_inputs(1, 8, 8, 36, 16, 36, 1, False)   # 72-byte rows
    with pytest.raises(ValueError, match="cannot take"):
        fused_bottleneck(xo.to(cuda, torch.bfloat16),
                         *[None if t is None else t.to(cuda) for t in wo])
    with pytest.raises(RuntimeError, match="lies on cpu"):
        fused_bottleneck(x, ws[0].cpu(), *ws[1:])
    assert (fused_bottleneck.launches,
            fused_bottleneck.kernel_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("side_stream", [False, True])
def test_fused_launcher_holds_its_tensors(cuda, side_stream):
    """``launch`` may run long after the launcher returned: the scratch y1
    and y2 and the launcher's bf16 copies of float32 weights stay
    allocated until then, so tensors of their sizes allocated in between
    are left alone, on the allocating stream or another."""
    n, h, w, cin, cmid, cout, d = 1, 19, 29, 64, 32, 128, 2
    x, ws = _block_inputs(n, h, w, cin, cmid, cout, d, True)
    x = x.to(cuda, torch.bfloat16)
    ws = [t.to(cuda) for t in ws]          # float32: the launcher casts
    launch, out = fused_bottleneck_launcher(x, *ws, dilation=d)
    shapes = [(n, h, w, cmid)] * 2 + [t.shape for t in ws if t.dim() > 1]
    others = [torch.full(s, 3.0, dtype=torch.bfloat16, device=cuda)
              for s in shapes for _ in range(4)]
    stream = (torch.cuda.Stream(cuda) if side_stream
              else torch.cuda.current_stream(cuda))
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        launch()
    del launch
    torch.cuda.synchronize()
    assert all(bool((t == 3).all()) for t in others)
    want = fused_bottleneck_plain(x, *ws, dilation=d)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.cuda
def test_device_metrics_on_cuda_match_cpu(cuda):
    rng = np.random.default_rng(0)
    conf = (rng.integers(0, 50, (120, 160)) / 50.0).astype(np.float32)
    seg = rng.integers(0, 14, (120, 160)).astype(np.int32)
    want = ood_measures_from_maps(torch.from_numpy(conf),
                                  torch.from_numpy(seg))
    got = ood_measures_from_maps(torch.from_numpy(conf).to(cuda),
                                 torch.from_numpy(seg).to(cuda))
    assert bool(got[3]) and bool(want[3])
    np.testing.assert_allclose([float(v) for v in got[:3]],
                               [float(v) for v in want[:3]], atol=1e-5)


def _twin(device, train=False):
    """The narrow twin of tests/test_torch_model.py, random weights, on
    ``device`` in channels_last."""
    model = SegmentationModel(
        ResNet(block=Bottleneck, layers=(1, 1, 1, 1), planes=(8, 16, 32, 64),
               stem="deep", output_stride=8),
        PPMDeepsupEmbedding(num_class=13, fc_dim=256))
    init_weights(model, torch.Generator().manual_seed(0))
    return model.train(train).to(device).to(memory_format=torch.channels_last)


@pytest.mark.cuda
def test_bf16_eval_keeps_the_model_dtype(cuda):
    """Under bf16 autocast, scores and ft leave the decoder and the scale
    averaging in bf16, as in the JAX package at dtype=bf16; in float32 they
    stay float32."""
    model = _twin(cuda)
    rng = np.random.default_rng(4)
    pyramid = [torch.from_numpy(rng.standard_normal((1, h, w, 3)).astype(
        np.float32)).to(cuda) for h, w in ((48, 64), (64, 96))]
    for dtype in (torch.bfloat16, torch.float32):
        with torch.no_grad(), torch.autocast(
                "cuda", dtype=torch.bfloat16,
                enabled=dtype == torch.bfloat16):
            out = model(pyramid[0], seg_size=(64, 96))
            scores, ft = multi_scale_forward(model, pyramid, (64, 96))
        assert out["scores"].dtype == out["ft"].dtype == dtype
        assert scores.dtype == ft.dtype == dtype
        assert scores.shape == (1, 64, 96, 13) and ft.shape == scores.shape


@pytest.mark.cuda
def test_bf16_train_step_on_cuda(cuda):
    model = _twin(cuda, train=True)
    opt = two_group_optimizer(model, lr_encoder=poly_schedule(0.02, 10),
                              lr_decoder=poly_schedule(0.02, 10))
    step = AnomalyTrainStep(model, opt, guard=True, dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    batch = {"img_data": torch.from_numpy(rng.standard_normal(
                 (2, 64, 64, 3)).astype(np.float32)).to(cuda),
             "seg_label": torch.from_numpy(rng.integers(
                 -1, 13, (2, 8, 8)).astype(np.int32)).to(cuda)}
    before = [p.detach().clone() for p in model.parameters()]
    metrics = step(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"]).item()
    assert not metrics["skipped"].item()
    assert any(not torch.equal(p, b)
               for p, b in zip(model.parameters(), before))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [6, 12, 18])
def test_dilated_shift_matches_native_conv(cuda, no_tf32, dtype, rate):
    """Forward and the gradients of x and the weight, at the training map
    of the ASPP (48x48, cut to 64 channels in and 32 out)."""
    rng = np.random.default_rng(rate)
    x = torch.from_numpy(rng.standard_normal((2, 64, 48, 48)).astype(
        np.float32)).to(cuda, dtype).to(memory_format=torch.channels_last)
    w = torch.from_numpy((rng.standard_normal((32, 64, 3, 3)) / 24).astype(
        np.float32)).to(cuda, dtype)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    outs = []
    for fn in (lambda a, b: dilated_conv3x3_shift(a, b, rate),
               lambda a, b: torch.nn.functional.conv2d(
                   a, b, padding=rate, dilation=rate)):
        a, b = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(a, b)
        assert y.dtype == dtype
        y.float().square().sum().backward()
        outs.append([t.float().cpu() for t in (y, a.grad, b.grad)])
    for got, want in zip(*outs):
        err = float((got - want).abs().max())
        assert err <= tol * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["crf", "crf-gauss"])
@pytest.mark.parametrize("exclude_back", [False, True])
def test_crf_on_cuda_matches_cpu(cuda, no_tf32, method, exclude_back):
    """The CRF branches of compute_conf (100 mean-field iterations of
    depthwise blurs, no kernel of the port's own) on cuda against the CPU,
    float32 with TF32 off, on a 48x80 map of 13 classes: conf within 1e-4
    (summation order in the blurs), in [0, 1]; bf16 scores are upcast."""
    scores = torch.from_numpy((np.random.default_rng(3).standard_normal(
        (48, 80, 13)) * 3).astype(np.float32))
    want = scoring.compute_conf(scores, method, exclude_back=exclude_back)
    got = scoring.compute_conf(scores.to(cuda), method,
                               exclude_back=exclude_back)
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-4, err
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    bf16 = scoring.compute_conf(scores.to(cuda).bfloat16(), method,
                                exclude_back=exclude_back)
    up = scoring.compute_conf(scores.bfloat16().float().to(cuda), method,
                              exclude_back=exclude_back)
    assert bf16.dtype == torch.float32
    assert torch.equal(bf16, up)


# -- the server (cli/serve.py) and its artifacts on the card ---------------
SERVE_SIZE = (64, 96)


def _started_serve_weights(root, device):
    """The eval model's seeded weights with a data-dependent start (BN
    statistics from a batch of the served kind of image, the embedding
    scaled to std 0.8) as the reference's .pth pair."""
    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)
    from open_world_semantic_segmentation_tpu_torch.data.native import (
        resize_normalize)

    cfg = load_config("configs/test_ood_street.yaml")
    with torch.random.fork_rng(devices=[device]):
        torch.manual_seed(0)
        model = build_anomaly_model(cfg, device)
    x = torch.from_numpy(np.stack([resize_normalize(
        _serve_image(i), SERVE_SIZE) for i in range(8)])).to(device)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
    with torch.no_grad():
        model.train()(x, seg_size=SERVE_SIZE)
        std = model.eval()(x, seg_size=SERVE_SIZE)["ft"].std().item()
        head = model.decoder.conv_last[4]
        head.weight.mul_(0.8 / std)
        head.bias.mul_(0.8 / std)
    paths = [str(root / f"{part}.pth") for part in ("encoder", "decoder")]
    torch.save(model.encoder.state_dict(), paths[0])
    torch.save(model.decoder.state_dict(), paths[1])
    return load_config("configs/test_ood_street.yaml", [
        "MODEL.weights_encoder", paths[0],
        "MODEL.weights_decoder", paths[1]])


def _serve_image(seed):
    return np.random.default_rng(seed).integers(0, 255, (80, 120, 3),
                                                dtype=np.uint8)


def _png(arr):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _direct_served(model, arrs, conf_fn=scoring.dissum_conf):
    """The served computation on a batch, in fp32: labels and per-image
    conf maps (dissum) as float16."""
    x = torch.from_numpy(np.stack(arrs)).to("cuda")
    with torch.inference_mode():
        scores = model(x, seg_size=SERVE_SIZE)["scores"]
        conf = torch.stack([conf_fn(s) for s in scores])
    return (scores.argmax(-1).to(torch.uint8).cpu().numpy(),
            conf.half().cpu().numpy())


def _assert_served(pred, conf, want_pred, want_conf):
    if pred is not None:
        assert pred.dtype == np.uint8 and (pred == want_pred).mean() >= 0.99
    assert conf.dtype == np.float16
    nan = np.isnan(want_conf)
    np.testing.assert_array_equal(np.isnan(conf), nan)
    assert not nan.all()
    want = want_conf[~nan].astype(np.float32)
    # 2e-3 of the largest magnitude, at least of 1 (dissum lies in [0, 1])
    np.testing.assert_allclose(conf[~nan].astype(np.float32), want,
                               atol=2e-3 * max(1.0, np.abs(want).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_server_on_cuda_matches_direct_forward(cuda, no_tf32, tmp_path,
                                               fused):
    """/segment (labels and ?scores=dissum) and /stream of the server on
    cuda, fp32 with TF32 off, against the direct forward of its model at
    the same batch size; the fused route launches its kernel."""
    import io
    import struct
    import threading
    import urllib.request

    from PIL import Image

    from open_world_semantic_segmentation_tpu_torch.cli import serve

    cfg = _started_serve_weights(tmp_path, cuda)
    fused_bottleneck.launches = fused_bottleneck.kernel_launches = 0
    srv = serve.serve(cfg, torch.float32, port=0, height=SERVE_SIZE[0],
                      width=SERVE_SIZE[1], fused_blocks=fused)
    seg = srv.segmenter
    assert seg.device.type == "cuda"
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        frames = [_serve_image(10 + i) for i in range(3)]
        for arr in frames:
            want = _direct_served(seg.model, [seg._decode(_png(arr))])
            got = []
            for q in ("", "?scores=dissum"):
                req = urllib.request.Request(url + "/segment" + q,
                                             data=_png(arr), method="POST")
                with urllib.request.urlopen(req) as r:
                    body = io.BytesIO(r.read())
                got.append(np.load(body) if q else np.array(
                    Image.open(body)))
            _assert_served(got[0], got[1], want[0][0], want[1][0])
        body = b"".join(struct.pack(">I", len(_png(a))) + _png(a)
                        for a in frames) + struct.pack(">I", 0)
        req = urllib.request.Request(url + "/stream?scores=dissum",
                                     data=body, method="POST")
        with urllib.request.urlopen(req) as r:
            out = r.read()
        pos, confs = 0, []
        while pos < len(out):
            (n,) = struct.unpack(">I", out[pos:pos + 4])
            confs.append(np.load(io.BytesIO(out[pos + 4:pos + 4 + n])))
            pos += 4 + n
        assert len(confs) == 3
        for arr, conf in zip(frames, confs):
            want = _direct_served(seg.model, [seg._decode(_png(arr))])
            _assert_served(None, conf, None, want[1][0])
    finally:
        srv.shutdown()
        srv.server_close()
    routed = sum(getattr(m, "fused_tile", None) is not None
                 for m in seg.model.modules())
    assert routed == (15 if fused else 0)
    assert fused_bottleneck.launches >= routed * 9    # 9 served forwards
    assert fused_bottleneck.kernel_launches == 3 * fused_bottleneck.launches


@pytest.mark.cuda
def test_artifact_loads_and_runs_on_cuda(cuda, no_tf32, tmp_path):
    """An fp32 artifact exported on cuda (the maxlogit conf): its
    metadata names cuda, it loads there, answers what the direct forward
    does, and ``cli/artifacts.py check`` reads it."""
    from open_world_semantic_segmentation_tpu_torch.cli import (
        artifacts, export_model)
    from open_world_semantic_segmentation_tpu_torch.cli._common import (
        build_anomaly_model, init_or_load_variables)
    from open_world_semantic_segmentation_tpu_torch.core.export import (
        load_exported)
    from open_world_semantic_segmentation_tpu_torch.data.native import (
        resize_normalize)

    cfg = _started_serve_weights(tmp_path, cuda)
    path = export_model.main(cfg, torch.float32, *SERVE_SIZE, batch=2,
                             method="maxlogit", out=str(tmp_path / "m.owss"))
    fn, meta = load_exported(path)
    assert meta["platforms"] == ["cuda"]
    model = init_or_load_variables(cfg, build_anomaly_model(cfg))
    arrs = [resize_normalize(_serve_image(20 + i), SERVE_SIZE)
            for i in range(2)]
    pred, conf = (t.cpu().numpy() for t in fn(
        torch.from_numpy(np.stack(arrs)).to("cuda")))
    want_pred, want_conf = _direct_served(model, arrs,
                                          scoring.maxlogit_conf)
    for i in range(2):
        _assert_served(pred[i], conf[i], want_pred[i], want_conf[i])
    # ``check`` without ``--run``: on a zero image these weights' maxlogit
    # overflows float16, so the labels-only artifact below takes the run
    report = artifacts.check_artifact(path)
    assert report["runs_here"] and report["valid"], report["problems"]
    assert report["in_avals"] == ["float32[2, 64, 96, 3]"]
    labels = export_model.main(cfg, torch.float32, *SERVE_SIZE, batch=2,
                               method="none",
                               out=str(tmp_path / "labels.owss"))
    report = artifacts.check_artifact(labels, run=True)
    assert report["ran_on_zeros"] and report["valid"], report["problems"]
    assert report["out_avals"] == ["uint8[2, 64, 96]"]


# --------------------------------------------------------------------------
# the rest of the CSAIL zoo on cuda (fp32, TF32 off) against the CPU: every
# encoder name of ModelBuilder under a decoder of its width, full width,
# seeded random weights; scores within 1e-3 of their largest magnitude
ZOO_PAIRS = [("resnet18", "c1"), ("resnet18dilated", "c1_deepsup"),
             ("resnet34", "ppm"), ("resnet34dilated", "ppm_deepsup"),
             ("resnet50", "upernet"), ("resnet101", "upernet_lite"),
             ("resnet101dilated", "ppm_deepsup_embedding"),
             ("resnext101", "upernet_lite"), ("hrnetv2", "c1"),
             ("mobilenetv2dilated", "c1_deepsup")]


def _zoo_scores(encoder, decoder, device, x, fused_blocks=False):
    from open_world_semantic_segmentation_tpu_torch.models.builder import (
        ModelBuilder)

    torch.manual_seed(0)
    model = ModelBuilder.build_segmentation_model(
        encoder, decoder, num_class=13, fused_blocks=fused_blocks)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.eval().to(device)
    with torch.no_grad():
        return model(x.to(device), seg_size=x.shape[1:3])["scores"].cpu()


def _close(got, want, rtol=1e-3):
    scale = float(want.abs().max())
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= rtol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("encoder,decoder", ZOO_PAIRS,
                         ids=[f"{e}+{d}" for e, d in ZOO_PAIRS])
def test_zoo_forward_on_cuda_matches_cpu(cuda, no_tf32, encoder, decoder):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 96, 128, 3)).astype(np.float32))
    _close(_zoo_scores(encoder, decoder, "cuda", x),
           _zoo_scores(encoder, decoder, "cpu", x))


@pytest.mark.cuda
@pytest.mark.parametrize("encoder,decoder,routed", [
    ("resnet101dilated", "ppm_deepsup_embedding", 32),
    ("resnet50", "upernet", 13), ("resnet101", "upernet", 30),
    ("hrnetv2", "c1", 4)])
def test_zoo_fused_route_on_cuda_matches_unfused(cuda, no_tf32, encoder,
                                                 decoder, routed):
    """The fused route (its kernel, in float32) against the unfused
    forward on cuda, fp32 with TF32 off, at 96x128: resnet101dilated at
    dilations 2 and 4, the OS32 ResNets' layers 3 and 4 at dilation 1 on
    maps of 1/16 and 1/32, HRNet's layer1."""
    from open_world_semantic_segmentation_tpu_torch.models.builder import (
        ModelBuilder)

    enc = ModelBuilder.build_encoder(encoder, fused_blocks=True)
    assert sum(getattr(m, "fused_tile", None) is not None
               for m in enc.modules()) == routed
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 96, 128, 3)).astype(np.float32))
    fused_bottleneck.launches = 0
    got = _zoo_scores(encoder, decoder, "cuda", x, fused_blocks=True)
    assert fused_bottleneck.launches == routed
    _close(got, _zoo_scores(encoder, decoder, "cuda", x))


# (N, Cin, H, W, Cout, kernel, stride, padding, dilation, groups): the
# eval's shapes are in chip_smoke.py; these take every branch of the tap
# form (K and N padded to 8, rows to 17, taps wholly in the padding)
INT8_CONVS = [(1, 3, 33, 47, 64, 3, 2, 1, 1, 1),
              (2, 64, 20, 24, 64, 3, 1, 1, 1, 32),
              (1, 8, 9, 9, 32, 1, 1, 0, 1, 1),
              (1, 24, 5, 5, 100, 3, 1, 1, 1, 1),
              (1, 512, 1, 1, 512, 1, 1, 0, 1, 1),
              (1, 256, 9, 14, 100, 3, 1, 12, 12, 1),
              (2, 128, 31, 29, 256, 3, 2, 1, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", INT8_CONVS)
def test_int8_conv_taps_match_plain_on_cuda(cuda, geom):
    from open_world_semantic_segmentation_tpu_torch.ops import quant

    n, cin, h, w, cout, k, s, p, d, g = geom
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(-127, 128, (n, cin, h, w), dtype=torch.int8,
                      device=cuda, generator=gen).contiguous(
        memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (cout, cin // g, k, k), dtype=torch.int8,
                       device=cuda, generator=gen)
    before = quant.int8_conv2d.calls
    got = quant.int8_conv2d(x, wq, s, p, d, g)
    assert quant.int8_conv2d.calls == before + 1
    want = quant.int8_conv2d_plain(x, wq, s, p, d, g)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("prequantized", [False, True])
@pytest.mark.parametrize("mode", ["int8", "w4a8"])
def test_quant_conv_on_cuda_equals_cpu(cuda, mode, prequantized):
    """One quantized conv on the same float32 input and scale: the int8
    activations, the int32 sums and the float32 dequantization are the
    same operations on both devices, so the outputs are bit-equal."""
    from open_world_semantic_segmentation_tpu_torch.models.layers import (
        QuantConv2d)
    from open_world_semantic_segmentation_tpu_torch.ops import quant

    torch.manual_seed(0)
    conv = QuantConv2d(64, 96, 3, 2, 2, 2, bias=False, mode=mode).eval()
    x = torch.randn(2, 64, 21, 30)
    conv.amax = x.abs().amax() * 0.9          # some activations saturate
    if prequantized:
        quant.prequantize(conv, {"": {"amax": conv.amax}},
                          mode="w4a8" if mode == "w4a8" else "int8")
    with torch.no_grad():
        want = conv(x)
        got = conv.to(cuda)(x.to(cuda)).cpu()
    assert torch.equal(got, want)


def _quant_twin(mode):
    """resnet18dilated + ppm_deepsup_embedding in ``mode``, seeded, and
    the scales its ``calib`` twin records on two images on the CPU."""
    from open_world_semantic_segmentation_tpu_torch.models.builder import (
        ModelBuilder)
    from open_world_semantic_segmentation_tpu_torch.ops import quant

    def build(q):
        m = ModelBuilder.build_segmentation_model(
            "resnet18dilated", "ppm_deepsup_embedding", 13, quant=q)
        init_weights(m, torch.Generator().manual_seed(0))
        return m

    imgs = [np.random.default_rng(i).standard_normal(
        (1, 64, 96, 3)).astype(np.float32) for i in range(2)]
    state = quant.calibrate(build("calib"), imgs, seg_size=(64, 96))
    return build, state, torch.from_numpy(imgs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int8-hybrid", "w4a8"])
def test_quantized_model_on_cuda_matches_cpu(cuda, no_tf32, mode):
    """The model prepared as the eval prepares it (prequantized; ``w4a8``
    given its scales alone, its weights quantized inline) on cuda against
    the CPU: argmax on 99 % of pixels, scores within 5e-2 (an activation
    on a rounding boundary of the int8 grid may round the other way after
    the float layers, which sum in another order on each device)."""
    from open_world_semantic_segmentation_tpu_torch.ops import quant

    build, state, x = _quant_twin(mode)
    scores = {}
    for device in ("cpu", "cuda"):
        model = quant.apply_quant_state(build(mode).to(device), state, mode)
        before = quant.int8_conv2d.calls
        with torch.no_grad():
            scores[device] = model(x.to(device), seg_size=(64, 96))[
                "scores"].cpu()
        assert (quant.int8_conv2d.calls > before) == (device == "cuda")
    agree = (scores["cuda"].argmax(-1) == scores["cpu"].argmax(-1)).float()
    assert float(agree.mean()) >= 0.99
    _close(scores["cuda"], scores["cpu"], rtol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int8-hybrid", "w4a8"])
def test_quantized_convs_on_cuda_equal_cpu(cuda, no_tf32, mode):
    """Every quantized conv of the whole model's forward on cuda, given on
    the CPU the input it saw on the card, gives the card's output bit for
    bit: where the two devices' forwards differ, the float layers between
    the quantized convs made the difference."""
    from open_world_semantic_segmentation_tpu_torch.models.layers import (
        QuantConv2d)
    from open_world_semantic_segmentation_tpu_torch.ops import quant

    build, state, x = _quant_twin(mode)
    on_cpu = quant.apply_quant_state(build(mode), state, mode)
    on_cuda = quant.apply_quant_state(build(mode).to(cuda), state, mode)
    seen = []

    def record(name):
        def hook(_, args, out):
            seen.append((name, args[0].detach().cpu(), out.detach().cpu()))
        return hook

    for name, m in on_cuda.named_modules():
        if isinstance(m, QuantConv2d) and m.mode != "off":
            m.register_forward_hook(record(name))
    with torch.no_grad():
        on_cuda(x.to(cuda), seg_size=(64, 96))
        assert len(seen) > 10
        for name, inp, out in seen:
            assert torch.equal(on_cpu.get_submodule(name)(inp), out), name


@pytest.mark.cuda
def test_deeplab_training_is_deterministic(cuda, no_tf32, tmp_path):
    """The Cityscapes golden recipe's model and data (crop 128, batch 4,
    fp32), 10 steps twice from one seed under the golden run's
    ``deterministic``: every parameter and BN statistic bit-identical."""
    from open_world_semantic_segmentation_tpu_torch.cli import main_deeplab
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        default_config)
    from open_world_semantic_segmentation_tpu_torch.tools import golden_run

    root = str(tmp_path / "cs")
    golden_run._synthetic_data().make_cityscapes_learnable(
        root, splits=("train", "val"), n=8, h=128, w=256, seed=0)
    states = []
    for run in range(2):
        cfg = default_config()
        cfg.DIR = str(tmp_path / f"ckpt{run}")
        cfg.DATASET.root_dataset = root
        cfg.DEEPLAB.model = "deeplabv3plus_embedding_resnet101"
        cfg.DEEPLAB.num_classes = 16
        cfg.DEEPLAB.crop_size = 128
        cfg.DEEPLAB.batch_size = 4
        cfg.DEEPLAB.lr = 0.05
        cfg.DEEPLAB.total_itrs = 10
        cfg.DEEPLAB.val_interval = 10
        cfg.DEEPLAB.random_seed = 0
        with golden_run.deterministic():
            main_deeplab.main(cfg, torch.float32, device="cuda")
        states.append(torch.load(os.path.join(cfg.DIR, "latest.pth"),
                                 map_location="cpu")["model_state"])
    assert states[0].keys() == states[1].keys()
    for key in states[0]:
        assert torch.equal(states[0][key], states[1][key]), key
