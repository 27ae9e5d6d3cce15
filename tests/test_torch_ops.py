"""Port ops (open_world_semantic_segmentation_tpu_torch.ops) vs the JAX
package's ops, on the same numpy inputs, fp32 on the CPU.

Tolerances: elementwise ops and resize/pool are compared at atol 1e-5
(float32 rounding of a handful of terms); the fuse conv sums 9 taps x ~100
channels in another order in each framework, so it gets 1e-4 relative.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from open_world_semantic_segmentation_tpu.ops import distance as jdist
from open_world_semantic_segmentation_tpu.ops import pool as jpool
from open_world_semantic_segmentation_tpu.ops import ppm_fuse as jfuse
from open_world_semantic_segmentation_tpu.ops import resize as jresize
from open_world_semantic_segmentation_tpu_torch.models.decoders import (
    _ppm_concat)
from open_world_semantic_segmentation_tpu_torch.ops import distance
from open_world_semantic_segmentation_tpu_torch.ops import pool
from open_world_semantic_segmentation_tpu_torch.ops import ppm_fuse
from open_world_semantic_segmentation_tpu_torch.ops import resize

ATOL = 1e-5


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((5, 7), (13, 17)),    # up, ragged ratio
    ((13, 17), (5, 7)),    # down, ragged ratio
    ((8, 8), (8, 8)),      # identity
    ((9, 16), (72, 128)),  # the decoder's 8x logit upsample
])
def test_bilinear_resize_matches_jax(in_hw, out_hw):
    rng = np.random.default_rng(sum(in_hw) + sum(out_hw))
    x = rng.standard_normal((2, *in_hw, 3)).astype(np.float32)
    want = jresize.bilinear_resize(jnp.asarray(x), out_hw)
    got = resize.bilinear_resize(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    # unbatched HWC and NCHW give the same map
    got_hwc = resize.bilinear_resize(torch.from_numpy(x[0]), out_hw)
    np.testing.assert_allclose(_np(got_hwc), _np(want)[0], atol=ATOL)
    got_nchw = resize.bilinear_resize(
        torch.from_numpy(x).permute(0, 3, 1, 2), out_hw, channel_last=False)
    np.testing.assert_allclose(_np(got_nchw.permute(0, 2, 3, 1)),
                               _np(want), atol=ATOL)


@pytest.mark.parametrize("in_size,out_size", [(5, 13), (13, 5), (9, 72),
                                              (7, 7)])
def test_interp_matrix_is_the_jax_matrix(in_size, out_size):
    np.testing.assert_array_equal(
        resize._interp_matrix(in_size, out_size),
        jresize._interp_matrix(in_size, out_size))


@pytest.mark.parametrize("scale", [1, 2, 3, 6])
@pytest.mark.parametrize("in_hw", [(13, 17), (9, 16)])
def test_adaptive_avg_pool_matches_jax(in_hw, scale):
    rng = np.random.default_rng(scale * 7 + in_hw[0])
    x = rng.standard_normal((2, *in_hw, 5)).astype(np.float32)
    want = jpool.adaptive_avg_pool(jnp.asarray(x), scale)
    got = pool.adaptive_avg_pool(torch.from_numpy(x), scale)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


@pytest.mark.parametrize("in_hw", [(16, 16), (13, 17)])
def test_max_pool_matches_jax(in_hw):
    rng = np.random.default_rng(in_hw[1])
    x = rng.standard_normal((2, *in_hw, 4)).astype(np.float32)
    want = jpool.max_pool_3x3_s2_p1(jnp.asarray(x))
    got = pool.max_pool_3x3_s2_p1(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_distance_heads_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 7, 13)).astype(np.float32)
    centers = rng.standard_normal((5, 13)).astype(np.float32)
    proto = rng.standard_normal((13,)).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        _np(distance.one_hot_center_logits(xt, 3.0)),
        _np(jdist.one_hot_center_logits(jnp.asarray(x), 3.0)), atol=ATOL)
    np.testing.assert_allclose(
        _np(distance.distance_logits(xt, torch.from_numpy(centers))),
        _np(jdist.distance_logits(jnp.asarray(x), jnp.asarray(centers))),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        _np(distance.prototype_distance(xt, torch.from_numpy(proto))),
        _np(jdist.prototype_distance(jnp.asarray(x), proto)), atol=1e-4)


def _fuse_inputs(seed=0):
    rng = np.random.default_rng(seed)
    n, h, w, c5, cp, cout = 2, 10, 14, 40, 24, 16
    conv5 = rng.standard_normal((n, h, w, c5)).astype(np.float32)
    pools = [rng.standard_normal((n, s, s, cp)).astype(np.float32)
             for s in (1, 2, 3, 6)]
    ctot = c5 + cp * len(pools)
    kernel = (rng.standard_normal((3, 3, ctot, cout)) * 0.1).astype(
        np.float32)                                   # HWIO, as in JAX
    weight = np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))  # OIHW
    return conv5, pools, kernel, weight


def test_ppm_fuse_conv_matches_jax():
    conv5, pools, kernel, weight = _fuse_inputs()
    want = jfuse.ppm_fuse_conv(jnp.asarray(conv5),
                               [jnp.asarray(p) for p in pools],
                               jnp.asarray(kernel))
    got = ppm_fuse.ppm_fuse_conv(torch.from_numpy(conv5),
                                 [torch.from_numpy(p) for p in pools],
                                 torch.from_numpy(weight))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_ppm_fuse_conv_matches_port_concat_path():
    conv5, pools, _, weight = _fuse_inputs(1)
    c5 = torch.from_numpy(conv5).permute(0, 3, 1, 2)
    ps = [torch.from_numpy(p).permute(0, 3, 1, 2) for p in pools]
    want = torch.nn.functional.conv2d(_ppm_concat(c5, ps),
                                      torch.from_numpy(weight), padding=1)
    got = ppm_fuse.ppm_fuse_conv(torch.from_numpy(conv5),
                                 [torch.from_numpy(p) for p in pools],
                                 torch.from_numpy(weight))
    np.testing.assert_allclose(_np(got), _np(want.permute(0, 2, 3, 1)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,out", [(1, (7, 9)), (6, (13, 17)), (6, (4, 3))])
def test_upsampled_conv3x3_unbatched_matches_jax(k, out):
    rng = np.random.default_rng(k + out[0])
    p = rng.standard_normal((k, k, 8)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 8, 4)) * 0.1).astype(np.float32)
    want = jfuse.upsampled_conv3x3(jnp.asarray(p), jnp.asarray(kernel), out)
    got = ppm_fuse.upsampled_conv3x3(
        torch.from_numpy(p),
        torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
        out)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)
