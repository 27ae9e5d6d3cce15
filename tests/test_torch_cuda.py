"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``; without a GPU each test skips. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: atol 2e-5 for the knn map (a sum of 128 float32 cosines), as
``tests/test_pallas.py`` holds the TPU kernel; for the fused bottleneck
1e-4 in float32 (summation order; TF32 off) and 5e-2 in bfloat16 (y1 and
y2 rounded to 8 bits of mantissa), as ``tests/test_pallas_block.py``
holds the TPU kernel; 1e-5 for the device OOD metrics, as
``tests/test_metrics_device.py`` holds the JAX module.
"""

import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu_torch.metrics.anom_device import (
    ood_measures_from_maps)
from open_world_semantic_segmentation_tpu_torch.ops import fused_block
from open_world_semantic_segmentation_tpu_torch.ops.fused_block import (
    fused_bottleneck, fused_bottleneck_plain)
from open_world_semantic_segmentation_tpu_torch.ops.knn import (
    knn_cosine, knn_cosine_plain)

ATOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,neighbor_size", [
    ((45, 80, 13), 9), ((9, 17, 4), 9), ((64, 128, 19), 3),
    ((720, 1280, 13), 9), ((33, 70, 32), 9), ((5, 3, 1), 2),
])
def test_knn_kernel_matches_plain(cuda, shape, neighbor_size):
    ft = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32)).to(cuda)
    before = knn_cosine.launches
    got = knn_cosine(ft, neighbor_size)
    torch.cuda.synchronize()
    assert knn_cosine.launches == before + 1
    want = knn_cosine_plain(ft, neighbor_size)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL)


@pytest.mark.cuda
def test_knn_kernel_zero_and_bf16_input(cuda):
    zero = knn_cosine(torch.zeros((16, 24, 5), device=cuda))
    assert torch.count_nonzero(zero).item() == 0
    ft = torch.randn((40, 50, 13), device=cuda).bfloat16()
    np.testing.assert_allclose(knn_cosine(ft).cpu().numpy(),
                               knn_cosine_plain(ft).cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
def test_knn_kernel_rejects_what_it_cannot_take(cuda):
    with pytest.raises(ValueError, match="at most"):
        knn_cosine(torch.zeros((8, 8, 33), device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        knn_cosine(torch.zeros((8, 8, 32), device=cuda), neighbor_size=12)


def _block_inputs(n, h, w, cin, cmid, cout, d, down, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) * 0.3).astype(np.float32))
    ws = [mk(cin, cmid), mk(cmid), mk(3, 3, cmid, cmid) * 0.2, mk(cmid),
          mk(cmid, cout), mk(cout)]
    ws += [mk(cin, cout), mk(cout)] if down else [None, None]
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
])
def test_fused_kernel_matches_plain(cuda, no_tf32, dtype, shape):
    n, h, w, cin, cmid, cout, d, down = shape
    x, ws = _block_inputs(n, h, w, cin, cmid, cout, d, down)
    x = x.to(cuda, dtype)
    ws = [None if t is None else t.to(cuda) for t in ws]
    before = fused_bottleneck.launches
    got = fused_bottleneck(x, *ws, dilation=d)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, h, w, cout)
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
    before = fused_bottleneck.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_bottleneck(x.half(), *ws)
    with pytest.raises(ValueError, match="contiguous"):
        fused_bottleneck(x.transpose(1, 2), *ws)
    with pytest.raises(ValueError, match="cannot take"):
        fused_bottleneck(x, *ws, dilation=5)
    with pytest.raises(RuntimeError, match="lies on cpu"):
        fused_bottleneck(x, ws[0].cpu(), *ws[1:])
    assert fused_bottleneck.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("cmid,dilation", [(64, 1), (128, 1), (256, 2),
                                           (512, 2), (512, 4), (40, 3)])
def test_shared_memory_mirror_matches_kernel(cuda, cmid, dilation):
    """The predicate's shared-memory count is the kernel's own."""
    import ctypes

    lib = fused_block._library()
    lib.fused_bottleneck_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_bottleneck_smem_bytes.restype = ctypes.c_size_t
    assert (lib.fused_bottleneck_smem_bytes(cmid, dilation)
            == fused_block.fused_block_smem_bytes(cmid, dilation))


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
