"""The port's dense-CRF scoring (``openset/crf.py`` and the ``crf`` /
``crf-gauss`` branches of ``openset/scoring.py compute_conf``) against the
JAX package's, on seeded numpy maps, in float32 on the CPU.

Tolerance: 1e-5 absolute on Q and on the conf maps (values in [0, 1]; the
two frameworks sum the depthwise taps in another order, and 100 mean-field
iterations keep that rounding near 1e-6).

bf16: the JAX package's CRF raises on bf16 scores (its taps are float32),
so the port takes the CRF branches' softmax in float32 whatever the
scores' dtype; on bf16 scores it equals the JAX float32 CRF on the same
scores upcast.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.openset import crf as jcrf
from open_world_semantic_segmentation_tpu.openset import scoring as jscoring
from open_world_semantic_segmentation_tpu_torch.openset import crf, scoring

ATOL = 1e-5
SCORES_SHAPE = (16, 24, 6)


def _probs(seed, shape=(24, 32, 5)):
    logits = np.random.default_rng(seed).standard_normal(shape) * 2
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _scores(seed):
    return (np.random.default_rng(seed).standard_normal(SCORES_SHAPE)
            * 3).astype(np.float32)


@pytest.mark.parametrize("sigma", [3.0, 10.0])
def test_gauss_taps_match_jax(sigma):
    taps, radius = crf._gauss_kernel(sigma)
    jtaps, jradius = jcrf._gauss_kernel(sigma)
    assert radius == jradius == int(3.5 * sigma + 0.5)
    assert taps.dtype == np.float32
    np.testing.assert_array_equal(taps, jtaps)


@pytest.mark.parametrize("iters", [1, 5])
@pytest.mark.parametrize("name", ["gaussian_crf", "bilateral_crf"])
def test_crf_matches_jax(name, iters):
    probs = _probs(iters)
    want = getattr(jcrf, name)(jnp.asarray(probs), iters=iters)
    got = getattr(crf, name)(torch.from_numpy(probs), iters=iters)
    assert got.shape == probs.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # a distribution per pixel
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("name", ["gaussian_crf_conf", "bilateral_crf_conf"])
def test_crf_conf_is_max_and_argmax_of_q(name):
    probs = _probs(7)
    conf, pred = getattr(crf, name)(torch.from_numpy(probs), iters=3)
    q = getattr(crf, name.replace("_conf", ""))(torch.from_numpy(probs),
                                                 iters=3)
    np.testing.assert_array_equal(conf.numpy(), q.amax(-1).numpy())
    np.testing.assert_array_equal(pred.numpy(), q.argmax(-1).numpy())


@pytest.mark.parametrize("exclude_back", [False, True])
@pytest.mark.parametrize("method", ["crf", "crf-gauss"])
def test_compute_conf_crf_matches_jax(method, exclude_back):
    """The full 100 iterations, on the softmax of the (optionally
    back-excluded) scores."""
    scores = _scores(0)
    want = jscoring.compute_conf(jnp.asarray(scores), method,
                                 exclude_back=exclude_back)
    got = scoring.compute_conf(torch.from_numpy(scores), method,
                               exclude_back=exclude_back)
    assert got.shape == SCORES_SHAPE[:2] and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


@pytest.mark.parametrize("method", ["crf", "crf-gauss"])
def test_compute_conf_crf_on_bf16_scores_upcasts(method):
    """bf16 scores: the port's float32 CRF equals the JAX float32 CRF on
    the scores upcast; the JAX CRF itself refuses bf16."""
    scores = torch.from_numpy(_scores(0)).bfloat16()
    upcast = scores.float().numpy()
    got = scoring.compute_conf(scores, method)
    want = jscoring.compute_conf(jnp.asarray(upcast), method)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(TypeError, match="same dtypes"):
        jscoring.compute_conf(jnp.asarray(upcast, jnp.bfloat16), method)


def test_densecrf_conf_raises_without_pydensecrf(monkeypatch):
    """pydensecrf is an optional package; where it cannot be imported the
    host cross-check raises, as the JAX package's does."""
    monkeypatch.setitem(sys.modules, "pydensecrf", None)
    monkeypatch.setitem(sys.modules, "pydensecrf.densecrf", None)
    probs = torch.from_numpy(_probs(1))
    with pytest.raises(RuntimeError, match="pydensecrf"):
        crf.densecrf_conf(probs)
    with pytest.raises(RuntimeError, match="pydensecrf"):
        jcrf.densecrf_conf(probs.numpy())


def test_scoring_methods_match_jax():
    assert scoring.SCORING_METHODS == jscoring.SCORING_METHODS
