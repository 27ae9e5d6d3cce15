"""knn-cosine score and the other OOD scoring methods of the port vs the
JAX package, on the same numpy inputs, float32 on the CPU.

On the CPU the port's ``knn_cosine`` wrapper runs ``knn_cosine_plain``; the
CUDA kernel is held against it on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``). Tolerance: atol 2e-5, as ``tests/test_pallas.py`` holds
the Pallas kernel (a sum of 128 cosines, each rounded in float32).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from open_world_semantic_segmentation_tpu.openset import scoring as jscoring
from open_world_semantic_segmentation_tpu.ops import resize as jresize
from open_world_semantic_segmentation_tpu.ops.pallas_knn import (
    knn_cosine_pallas)
from open_world_semantic_segmentation_tpu_torch.ops.knn import (
    generic_chunk, knn_cosine, knn_cosine_plain, knn_neighbour_counts)
from open_world_semantic_segmentation_tpu_torch.openset import scoring

ATOL = 2e-5

# jitted: eager, each of the 128 shifted slices compiles on its own
_jax_knn = jax.jit(jscoring.knn_cosine_conf,
                   static_argnames=("seg_size", "neighbor_size"))


def _ft(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _knn_brute_force(ft, neighbor_size):
    """numpy oracle: every pixel pair of every shift, one at a time."""
    h, w, _ = ft.shape
    fn = ft / np.maximum(np.linalg.norm(ft, axis=-1, keepdims=True), 1e-8)
    out = np.zeros((h, w))
    for y in range(h):
        for x in range(w):
            for dh in range(1, neighbor_size):
                for dw in range(1, neighbor_size):
                    for yy, xx in ((y + dh, x + dw), (y - dh, x - dw)):
                        if 0 <= yy < h and 0 <= xx < w:
                            out[y, x] += fn[y, x] @ fn[yy, xx]
    return out


# At the 9x9 window the JAX reference compiles a ~10 s program (one core)
# per shape, so it is held here at 3x3 windows; at 9x9 the plain version
# meets it through the eval (tests/test_torch_eval.py, knn) and the
# brute-force oracle below
@pytest.mark.parametrize("shape,neighbor_size", [((64, 128, 19), 3),
                                                 ((20, 30, 8), 3)])
def test_knn_plain_matches_jax_reference(shape, neighbor_size):
    ft = _ft(shape, 0)
    want = _jax_knn(jnp.asarray(ft), neighbor_size=neighbor_size)
    got = knn_cosine_plain(torch.from_numpy(ft), neighbor_size)
    assert got.dtype == torch.float32 and got.shape == shape[:2]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape,neighbor_size", [((20, 30, 8), 9),
                                                 ((9, 17, 4), 9),
                                                 ((5, 3, 1), 2)])
def test_knn_plain_matches_brute_force(shape, neighbor_size):
    ft = _ft(shape, 8)
    got = knn_cosine_plain(torch.from_numpy(ft), neighbor_size)
    np.testing.assert_allclose(got.numpy(),
                               _knn_brute_force(ft, neighbor_size),
                               atol=ATOL)


# the Pallas kernel in interpret mode costs ~40 s at the 9x9 window
# (tests/test_pallas.py), so it is held at neighbor_size 3 only
@pytest.mark.parametrize("shape", [(20, 30, 8), (9, 17, 4)])
def test_knn_plain_matches_pallas_interpret(shape):
    ft = _ft(shape, 1)
    want = knn_cosine_pallas(jnp.asarray(ft), neighbor_size=3,
                             interpret=True)
    got = knn_cosine_plain(torch.from_numpy(ft), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _counts_brute_force(h, w, neighbor_size):
    """numpy: the in-image offsets among the 2 (k - 1)^2 of each pixel."""
    out = np.zeros((h, w), np.float32)
    for y in range(h):
        for x in range(w):
            for dh in range(1, neighbor_size):
                for dw in range(1, neighbor_size):
                    out[y, x] += (y + dh < h and x + dw < w) + (
                        y - dh >= 0 and x - dw >= 0)
    return out


def _constant_map(shape, seed):
    """Every pixel the same random vector: each cosine is 1, so the map is
    the count of in-image neighbours."""
    v = np.random.default_rng(seed).standard_normal(shape[-1]) * 3.0
    return np.broadcast_to(v.astype(np.float32), shape).copy()


# maps smaller and larger than the 2 (k - 1) rows and columns a pixel
# needs to have every neighbour inside: corners, edges and interior
@pytest.mark.parametrize("shape,neighbor_size", [
    ((9, 13, 13), 9), ((20, 40, 13), 9), ((17, 5, 4), 9),
    ((3, 3, 7), 3), ((12, 17, 7), 3)])
def test_knn_plain_gives_neighbour_counts_on_constant_map(shape,
                                                         neighbor_size):
    counts = _counts_brute_force(shape[0], shape[1], neighbor_size)
    np.testing.assert_array_equal(
        knn_neighbour_counts(shape[0], shape[1], neighbor_size).numpy(),
        counts)
    got = knn_cosine_plain(torch.from_numpy(_constant_map(shape, 9)),
                           neighbor_size)
    np.testing.assert_allclose(got.numpy(), counts, rtol=0, atol=ATOL)


def test_knn_pallas_interpret_gives_neighbour_counts_on_constant_map():
    ft = _constant_map((9, 17, 4), 10)
    got = knn_cosine_pallas(jnp.asarray(ft), neighbor_size=3,
                            interpret=True)
    np.testing.assert_allclose(np.asarray(got), _counts_brute_force(9, 17, 3),
                               rtol=0, atol=ATOL)


def _knn_generic_emulation(ft, neighbor_size, chunk, eps=1e-8):
    """The generic CUDA path's arithmetic, pass for pass, in float64 torch:
    norms; per chunk of channels the horizontal halo sums of fn to the left
    (hm) and right (hp); then per pixel fn times the vertical sums of hm
    above and hp below, accumulated over the chunks and rounded to float32
    once."""
    h, w, c = ft.shape
    halo = neighbor_size - 1
    norm = ft.double().pow(2).sum(-1).sqrt().clamp(min=eps)
    fn = ft.double() / norm[..., None]
    acc = torch.zeros((h, w), dtype=torch.float64)
    for c0 in range(0, c, chunk):
        f = fn[..., c0:c0 + chunk]
        hm = torch.zeros_like(f)
        hp = torch.zeros_like(f)
        for d in range(1, min(halo, w - 1) + 1):
            hm[:, d:] += f[:, :-d]
            hp[:, :-d] += f[:, d:]
        b = torch.zeros_like(f)
        for d in range(1, min(halo, h - 1) + 1):
            b[d:] += hm[:-d]
            b[:-d] += hp[d:]
        acc += (f * b).sum(-1)
    return acc.float()


@pytest.mark.parametrize("shape,neighbor_size,chunk", [
    ((20, 27, 64), 11, 64), ((20, 27, 64), 11, 7), ((9, 12, 33), 9, 33),
    ((6, 9, 4096), 9, 1000), ((5, 3, 40), 12, 40), ((7, 8, 13), 1, 13)])
def test_knn_generic_path_arithmetic_matches_plain(shape, neighbor_size,
                                                   chunk):
    """The box-sum decomposition the generic kernels take (any C, any
    halo, channel chunks) against the plain version."""
    ft = torch.from_numpy(_ft(shape, 7))
    ft[2, 1] = 0.0
    np.testing.assert_allclose(
        _knn_generic_emulation(ft, neighbor_size, chunk).numpy(),
        knn_cosine_plain(ft, neighbor_size).numpy(), atol=ATOL)


def test_knn_generic_chunk_bounds_the_scratch():
    assert generic_chunk(90, 160, 4096) == (1 << 22) // (90 * 160)
    assert generic_chunk(20, 30, 64) == 64
    assert generic_chunk(4000, 4000, 64) == 1


def test_knn_zero_features_are_zero_cos():
    ft = torch.zeros((16, 24, 5))
    np.testing.assert_array_equal(knn_cosine(ft).numpy(), 0.0)
    # a zero pixel among others contributes nothing either way
    ft = torch.from_numpy(_ft((12, 14, 5), 2))
    ft[5, 6] = 0.0
    np.testing.assert_allclose(knn_cosine(ft).numpy(),
                               _knn_brute_force(ft.numpy(), 9), atol=ATOL)
    assert knn_cosine(ft)[5, 6] == 0.0


def test_knn_wrapper_on_cpu_takes_plain_version_without_launch():
    ft = torch.from_numpy(_ft((10, 12, 6), 3))
    before = knn_cosine.launches
    np.testing.assert_array_equal(knn_cosine(ft, 5).numpy(),
                                  knn_cosine_plain(ft, 5).numpy())
    assert knn_cosine.launches == before


def test_knn_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        knn_cosine(torch.zeros((4, 5)))
    with pytest.raises(TypeError):
        knn_cosine(torch.zeros((4, 5, 3), dtype=torch.int32))
    with pytest.raises(RuntimeError):
        knn_cosine(torch.zeros((4, 5, 3), device="meta"))


def test_compute_conf_knn_upsamples_the_plain_map():
    """compute_conf("knn") on a CPU tensor: the plain map, upsampled to the
    label size as the JAX package's CPU branch does (knn_cosine_conf, then
    its bilinear_resize)."""
    ft = _ft((12, 20, 13), 4)
    scores = _ft((24, 40, 13), 5)
    want = jresize.bilinear_resize(
        jnp.asarray(_knn_brute_force(ft, 9), jnp.float32)[None, :, :, None],
        (24, 40))[0, :, :, 0]
    got = scoring.compute_conf(torch.from_numpy(scores), "knn",
                               ft=torch.from_numpy(ft), seg_size=(24, 40))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("method", ["msp", "maxlogit", "dissum",
                                    "dissum_fused", "background"])
@pytest.mark.parametrize("exclude_back", [False, True])
def test_compute_conf_matches_jax(method, exclude_back):
    # distance logits are <= 0; scale so dissum's 400 clip is exercised
    scores = -np.abs(_ft((16, 24, 13), 6)) * 40.0
    want = jscoring.compute_conf(jnp.asarray(scores), method,
                                 exclude_back=exclude_back)
    got = scoring.compute_conf(torch.from_numpy(scores), method,
                               exclude_back=exclude_back)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("method", ["crf", "crf-gauss"])
def test_compute_conf_unported_methods_raise(method):
    """The CRF methods, once unported, now return a float32 map in [0, 1]
    (``tests/test_torch_crf.py`` holds them against the JAX package); a
    method no package knows raises."""
    conf = scoring.compute_conf(torch.zeros((4, 4, 3)), method)
    assert conf.dtype == torch.float32 and conf.shape == (4, 4)
    assert bool(((conf >= 0) & (conf <= 1)).all())
    with pytest.raises(ValueError, match="unknown OOD method"):
        scoring.compute_conf(torch.zeros((4, 4, 3)), method + "-x")
