"""The port's device-side OOD metrics (``metrics/anom_device.py``) vs the
JAX package's ``ood_measures_from_maps`` and the port's host float64 sweep
(``metrics/anom.py eval_ood_measure``), on the CPU.

Tolerance atol 1e-5, as ``tests/test_metrics_device.py`` holds the JAX
module: float32 counts are exact, the AUROC numerator is a difference of
large float32 sums (~1e-6 relative). The evaluator with
``device_metrics=True`` must give the host path's summary within 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.metrics.anom_device import (
    ood_measures_from_maps as jax_ood_measures_from_maps)
from open_world_semantic_segmentation_tpu_torch.metrics.anom import (
    eval_ood_measure)
from open_world_semantic_segmentation_tpu_torch.metrics.anom_device import (
    ood_measures_from_maps)
from open_world_semantic_segmentation_tpu_torch.openset.evaluator import (
    OODEvaluator)
from test_torch_eval import items, street_tree, variables  # noqa: F401
from test_torch_model import port_twin_from

ATOL = 1e-5


def _compare(conf, seg, out_labels=(13,)):
    got = ood_measures_from_maps(torch.from_numpy(conf),
                                 torch.from_numpy(seg), out_labels=out_labels)
    want_jax = jax_ood_measures_from_maps(jnp.asarray(conf), jnp.asarray(seg),
                                          out_labels=out_labels)
    want_host = eval_ood_measure(conf, seg, out_labels=out_labels)
    assert bool(got[3]) == bool(want_jax[3]) == (want_host is not None)
    np.testing.assert_allclose([float(v) for v in got[:3]],
                               [float(v) for v in want_jax[:3]], atol=ATOL)
    if want_host is not None:
        np.testing.assert_allclose([float(v) for v in got[:3]],
                                   list(want_host), atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_maps(seed):
    rng = np.random.default_rng(seed)
    conf = rng.random((60, 80)).astype(np.float32)
    seg = rng.integers(0, 14, (60, 80)).astype(np.int32)
    _compare(conf, seg)


def test_tie_heavy_maps():
    """Quantised maps (a clipped dissum) make large tie blocks."""
    rng = np.random.default_rng(1)
    seg = rng.integers(0, 14, (48, 64)).astype(np.int32)
    _compare((rng.integers(0, 7, (48, 64)) / 7.0).astype(np.float32), seg)
    conf = np.full((48, 64), 0.5, np.float32)
    conf[:4] = 0.25
    _compare(conf, seg)


def test_informative_scores():
    rng = np.random.default_rng(2)
    seg = rng.integers(0, 14, (40, 50)).astype(np.int32)
    conf = rng.random((40, 50)).astype(np.float32) * 0.5
    conf[seg == 13] -= 0.3
    _compare(conf, seg)


@pytest.mark.parametrize("label", [0, 13])
def test_single_class_is_invalid(label):
    conf = np.random.default_rng(3).random((16, 16)).astype(np.float32)
    seg = np.full((16, 16), label, np.int32)
    _compare(conf, seg)
    assert not bool(ood_measures_from_maps(torch.from_numpy(conf),
                                           torch.from_numpy(seg))[3])


@pytest.mark.parametrize("nan_rows", [48, 5])
def test_nan_maps_follow_host(nan_rows):
    """A min-max normalised map of a constant is 0/0: all NaN. The host
    takes each NaN as its own threshold, anomalous pixels listed first;
    the port follows it (the JAX module does not, so only the host is the
    oracle here)."""
    rng = np.random.default_rng(5)
    conf = rng.random((48, 64)).astype(np.float32)
    conf[:nan_rows] = np.nan
    seg = rng.integers(0, 14, (48, 64)).astype(np.int32)
    got = ood_measures_from_maps(torch.from_numpy(conf),
                                 torch.from_numpy(seg))
    np.testing.assert_allclose([float(v) for v in got[:3]],
                               list(eval_ood_measure(conf, seg)), atol=ATOL)


def test_multi_out_labels():
    rng = np.random.default_rng(4)
    conf = rng.random((30, 40)).astype(np.float32)
    seg = rng.integers(0, 20, (30, 40)).astype(np.int32)
    _compare(conf, seg, out_labels=(13, 19))


@pytest.mark.parametrize("batched", [False, True])
def test_evaluator_device_metrics_matches_host(items, variables, batched):
    """OODEvaluator(device_metrics=True) gives the host sweep's summary on
    the same images, per image and in batches. knn scoring: the narrow
    twin's dissum map is 0/0 after its min-max normalisation (all NaN), so
    it would compare nothing."""
    model = port_twin_from(variables)
    host = OODEvaluator(model, num_class=13, method="knn")
    dev = OODEvaluator(model, num_class=13, method="knn",
                       device_metrics=True)
    want = host.evaluate(items, progress=False)
    got = (dev.evaluate_batched(items, batch_size=2) if batched
           else dev.evaluate(items, progress=False))
    assert got["images"] == want["images"] == 3
    assert got["metric_time"] > 0
    for key in ("auroc", "aupr", "fpr", "mean_iou", "accuracy"):
        np.testing.assert_allclose(got[key], want[key], atol=2e-5,
                                   err_msg=key)


def test_evaluator_device_metrics_keeps_maps_on_device(items, variables):
    dev = OODEvaluator(port_twin_from(variables), num_class=13,
                       method="knn", device_metrics=True)
    out = dev.evaluate_item(items[0])
    assert out["conf"] is None and out["pred"] is None
    assert out["ood"] == (dev.aurocs[0], dev.auprs[0], dev.fprs[0])
