"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``; without a GPU each test skips. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: atol 2e-5 for the knn map (a sum of 128 float32 cosines), as
``tests/test_pallas.py`` holds the TPU kernel.
"""

import numpy as np
import pytest
import torch

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
