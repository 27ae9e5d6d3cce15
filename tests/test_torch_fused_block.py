"""The port's fused bottleneck (``ops/fused_block.py``) vs the JAX package's.

On the CPU the wrapper runs its plain PyTorch version. The same inputs,
made from a numpy seed as ``tests/test_pallas_block.py`` makes them, go
through the JAX Pallas kernel in interpret mode (three cases: ragged
identity, dilation 2 with a partial last tile, downsample; one bf16 case)
and through the jnp ``ref_block`` (the other cases). The JAX kernel takes
a padded width; its input is padded here and its output sliced, since the
port has no padded width.

Tolerances are those of ``tests/test_pallas_block.py``: 1e-4 in float32
(summation order), 5e-2 in bfloat16 (y1 and y2 rounded to 8 bits of
mantissa, where a rounding boundary may fall differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.ops import pallas_block
from open_world_semantic_segmentation_tpu_torch.ops.fused_block import (
    BN_CHOICES, CTAS_PER_SM, PATCH_H, PATCH_W, fold_convbn,
    fused_block_tile, fused_bottleneck, fused_bottleneck_plain, launch_plan)
from test_pallas_block import ref_block

CASES = {
    # (h, w, cin, cmid, cout, d, tile_h, down), as test_pallas_block.py
    "ragged_identity": (13, 21, 32, 16, 32, 1, 8, False),
    "d2_partial_tile": (25, 33, 32, 16, 32, 2, 8, False),
    "downsample": (16, 24, 24, 16, 48, 1, 8, True),
    "single_tile": (5, 11, 16, 8, 16, 2, 8, False),
    "d4_tiny_tiles": (17, 19, 16, 8, 16, 4, 4, False),
    "wide": (9, 130, 16, 8, 16, 1, 8, False),
}
INTERPRET = ("ragged_identity", "d2_partial_tile", "downsample")


def _inputs(h, w, cin, cmid, cout, d, down):
    """float32 numpy inputs in test_pallas_block.py's order and scale."""
    rng = np.random.default_rng(h * 100 + w + d)
    mk = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    x = mk(h, w, cin)
    w1, b1 = mk(cin, cmid), mk(cmid)
    w2, b2 = mk(3, 3, cmid, cmid) * np.float32(0.2), mk(cmid)
    w3, b3 = mk(cmid, cout), mk(cout)
    wd = bd = None
    if down:
        wd, bd = mk(cin, cout), mk(cout)
    return x, [w1, b1, w2, b2, w3, b3, wd, bd]


def _port(x, weights, d, dtype=torch.float32):
    t = [None if a is None else torch.from_numpy(a) for a in weights]
    xt = torch.from_numpy(x)[None].to(dtype)
    before = fused_bottleneck.launches, fused_bottleneck.kernel_launches
    out = fused_bottleneck(xt, *t, dilation=d)
    assert (fused_bottleneck.launches,               # the CPU runs no kernel
            fused_bottleneck.kernel_launches) == before
    assert out.dtype == dtype and out.shape[:3] == (1,) + x.shape[:2]
    return out[0].float().numpy()


def _jax_kernel(x, weights, d, tile_h, dtype=jnp.float32):
    h, w, cin = x.shape
    sub = pallas_block.sublane(dtype)
    wp = -(-(w + d) // sub) * sub
    xp = jnp.zeros((h, wp, cin), dtype).at[:, :w].set(
        jnp.asarray(x).astype(dtype))
    jw = [None if a is None else jnp.asarray(a) for a in weights]
    got = pallas_block.fused_bottleneck(xp, *jw, dilation=d, width=w,
                                        tile_h=tile_h, interpret=True)
    return np.asarray(got[:, :w], np.float32)


@pytest.mark.parametrize("name", INTERPRET)
def test_matches_pallas_kernel_interpret(name):
    h, w, cin, cmid, cout, d, tile_h, down = CASES[name]
    x, weights = _inputs(h, w, cin, cmid, cout, d, down)
    np.testing.assert_allclose(_port(x, weights, d),
                               _jax_kernel(x, weights, d, tile_h),
                               rtol=1e-4, atol=1e-4)


def test_bf16_matches_pallas_kernel_interpret():
    h, w, cin, cmid, cout, d = 14, 22, 32, 16, 32, 2
    x, weights = _inputs(h, w, cin, cmid, cout, d, False)
    got = _port(x, weights, d, torch.bfloat16)
    want = _jax_kernel(x, weights, d, 8, jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("name", [n for n in CASES if n not in INTERPRET])
def test_matches_jnp_reference(name):
    h, w, cin, cmid, cout, d, _, down = CASES[name]
    x, weights = _inputs(h, w, cin, cmid, cout, d, down)
    jw = [None if a is None else jnp.asarray(a) for a in weights]
    want = np.asarray(ref_block(jnp.asarray(x), *jw, d=d))
    np.testing.assert_allclose(_port(x, weights, d), want,
                               rtol=1e-4, atol=1e-4)


def test_batch_is_per_image():
    """The port's batch dimension: each image as if it ran alone."""
    x0, weights = _inputs(11, 9, 16, 8, 24, 2, True)
    x1 = np.ascontiguousarray(x0[::-1])
    t = [torch.from_numpy(a) for a in weights]
    both = fused_bottleneck_plain(torch.from_numpy(np.stack([x0, x1])), *t,
                                  dilation=2)
    for i, x in enumerate((x0, x1)):
        np.testing.assert_array_equal(both[i].numpy(), _port(x, weights, 2))


def test_fold_convbn_matches_jax():
    """OIHW conv + BN folded by the port equals the JAX fold of the HWIO
    kernel (train/convert.py's transpose), for a 1x1 and a 3x3."""
    rng = np.random.default_rng(0)
    for kh in (1, 3):
        k = (rng.standard_normal((6, 5, kh, kh)) * 0.3).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
        bias, mean = (rng.standard_normal((2, 6)) * 0.1).astype(np.float32)
        var = rng.uniform(0.5, 1.5, 6).astype(np.float32)
        w, b = fold_convbn(*(torch.from_numpy(a)
                             for a in (k, scale, bias, mean, var)))
        jw, jb = pallas_block.fold_convbn(
            jnp.asarray(k.transpose(2, 3, 1, 0)), jnp.asarray(scale),
            jnp.asarray(bias), jnp.asarray(mean), jnp.asarray(var))
        assert w.shape == (kh, kh, 5, 6) and w.dtype == torch.float32
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("geometry,accepted", [
    # resnet50dilated OS8 blocks (Cin, Cmid, Cout, dilation)
    ((128, 64, 256, 1), True),      # layer1.0
    ((256, 64, 256, 1), True),      # layer1.1-2
    ((512, 128, 512, 1), True),     # layer2.1-3
    ((512, 256, 1024, 1), True),    # layer3.0
    ((1024, 256, 1024, 2), True),   # layer3.1-5
    ((1024, 512, 2048, 2), True),   # layer4.0
    ((2048, 512, 2048, 4), True),   # layer4.1-2
    ((2048, 512, 2048, 8), True),   # layer4 at output stride 4
    ((2048, 1024, 2048, 2), True),  # a wider bottleneck
    ((2048, 500, 2048, 4), False),  # Cmid rows of 1000 bytes in bf16
    ((1024, 256, 1024, 0), False),  # no dilation below 1
])
def test_predicate_at_flagship_geometries(geometry, accepted):
    assert (fused_block_tile(*geometry) is not None) == accepted


@pytest.mark.parametrize("channels,itemsize,accepted", [
    (500, 4, True), (500, 2, False), (42, 4, False), (40, 2, True),
])
def test_predicate_row_alignment_per_dtype(channels, itemsize, accepted):
    """Rows must be 16-byte aligned: 4 float32 or 8 bf16 channels."""
    got = fused_block_tile(channels, channels, channels, 1, itemsize)
    assert (got is not None) == accepted


@pytest.mark.parametrize("n,h,w,cmid,cout,sms", [
    (1, 71, 125, 512, 2048, 132),   # layer4 at 568x1000: more tiles than CTAs
    (1, 71, 125, 512, 2048, 114),   # the same on an H100 PCIe's 114 SMs
    (2, 38, 67, 256, 1024, 132),    # layer3 at 304x536, batch 2
    (2, 11, 3, 40, 24, 132),        # ragged, channels past one tile
    (1, 5, 7, 64, 256, 132),        # a map smaller than one patch
    (3, 1, 1, 8, 8, 132),           # single pixels
])
def test_launch_plan_covers_every_output_once(n, h, w, cmid, cout, sms):
    """Walk each phase's grid as the persistent kernel does (CTA b takes
    tiles b, b + grid, ...; tile t is channel tile t % tiles of patch
    t // tiles, patches in image, row, column order; 8 x 16 pixels by bn
    channels, clipped to the map and to the channels) and count how often
    every output element is written."""
    patches_x = -(-w // PATCH_W)
    patches_img = -(-h // PATCH_H) * patches_x
    plan = launch_plan(n, h, w, cmid, cout, sms)
    for (bn, tiles, grid), channels in zip(plan, (cmid, cmid, cout)):
        assert bn in BN_CHOICES and bn <= -(-channels // 64) * 64
        assert tiles * bn >= channels > (tiles - 1) * bn
        total = n * patches_img * tiles
        assert grid == min(total, sms * CTAS_PER_SM)
        hits = np.zeros((n, h, w, channels), np.int32)
        for b in range(grid):
            for t in range(b, total, grid):
                patch, nt = divmod(t, tiles)
                img, p = divmod(patch, patches_img)
                y0, x0 = p // patches_x * PATCH_H, p % patches_x * PATCH_W
                hits[img, y0:y0 + PATCH_H, x0:x0 + PATCH_W,
                     nt * bn:(nt + 1) * bn] += 1
        assert (hits == 1).all()


def test_wrapper_rejects_bad_shapes():
    x, weights = _inputs(6, 7, 16, 8, 16, 1, False)
    t = [None if a is None else torch.from_numpy(a) for a in weights]
    with pytest.raises(ValueError, match="NHWC"):
        fused_bottleneck(torch.from_numpy(x), *t)
    with pytest.raises(ValueError, match="w3"):
        fused_bottleneck(torch.from_numpy(x)[None], *t[:4], t[4][:4],
                         t[5])
    with pytest.raises(ValueError, match="together"):
        fused_bottleneck(torch.from_numpy(x)[None], *t[:6], t[0], None)
