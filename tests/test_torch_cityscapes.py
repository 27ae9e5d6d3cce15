"""The port's Cityscapes data path and segmentation metrics against the JAX
package's: ``encode_target`` / ``decode_target`` and the ``Cityscapes``
dataset with the val transform (a tree from
``tools/make_synthetic_data.make_cityscapes``), ``batch_iterator``'s order,
``StreamSegMetrics`` (its 19-class quirk included), ``pixel_accuracy`` and
``confusion_matrix_update``. Labels and counts must be equal; images
within 1e-6.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from open_world_semantic_segmentation_tpu.cli.main_deeplab import (
    get_transforms as jax_get_transforms)
from open_world_semantic_segmentation_tpu.data import cityscapes as jcs
from open_world_semantic_segmentation_tpu.data import loader as jloader
from open_world_semantic_segmentation_tpu.metrics import segmentation as jseg
from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (
    get_transforms)
from open_world_semantic_segmentation_tpu_torch.data import cityscapes
from open_world_semantic_segmentation_tpu_torch.data import loader
from open_world_semantic_segmentation_tpu_torch.metrics import segmentation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_synthetic_data import make_cityscapes  # noqa: E402


@pytest.fixture(scope="module")
def cs_tree(tmp_path_factory):
    return make_cityscapes(str(tmp_path_factory.mktemp("cityscapes")),
                           n=2)


def _raw_labels(seed, shape=(37, 53)):
    """Raw Cityscapes ids 0..33 and the license plate's -1."""
    return np.random.default_rng(seed).integers(-1, 34, shape)


@pytest.mark.parametrize("unknown", [(14, 15), None, (13,), (3, 9, 17)],
                         ids=["truck-bus", "none", "car", "three"])
def test_encode_decode_target_match_jax(unknown):
    raw = _raw_labels(0)
    got = cityscapes.encode_target(raw, unknown)
    want = jcs.encode_target(raw, unknown)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(cityscapes.decode_target(got[0]),
                                  jcs.decode_target(want[0]))


def test_cityscapes_val_transform_matches_jax(cs_tree):
    port = cityscapes.Cityscapes(cs_tree, split="val",
                                 transform=get_transforms(768)[1])
    ref = jcs.Cityscapes(cs_tree, split="val",
                         transform=jax_get_transforms(768)[1])
    assert len(port) == len(ref) == 2
    assert port.images == ref.images and port.targets == ref.targets
    for i in range(len(port)):
        (img, tgt, true), (jimg, jtgt, jtrue) = port[i], ref[i]
        assert img.shape == (96, 192, 3) and img.dtype == np.float32
        np.testing.assert_allclose(img, jimg, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tgt, jtgt)
        np.testing.assert_array_equal(true, jtrue)
    with pytest.raises(ValueError, match="Invalid split"):
        cityscapes.Cityscapes(cs_tree, split="nope")


class _Range:
    """A dataset of (i, 2i, -i) samples."""

    def __len__(self):
        return 7

    def __getitem__(self, i):
        return (np.array(i), np.array(2 * i), np.array(-i))


@pytest.mark.parametrize("shuffle,drop_last,workers",
                         [(False, False, 8), (True, True, 0),
                          (True, False, 2)])
def test_batch_iterator_order_matches_jax(shuffle, drop_last, workers):
    kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last, epochs=2,
              num_workers=workers)
    got = list(loader.batch_iterator(_Range(), 3, **kw))
    want = list(jloader.batch_iterator(_Range(), 3, **kw))
    assert len(got) == len(want) == (4 if drop_last else 6)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_batch_iterator_refuses_multi_host():
    """Multi-host shards are ported now (each host's batches are the JAX
    package's, as ``tests/test_torch_parallel.py`` holds at 4 hosts); what
    the loader refuses is a host id outside ``range(num_hosts)``."""
    for num_hosts, host_id in ((2, 2), (2, -1), (0, 0)):
        with pytest.raises(ValueError, match="host_id"):
            next(loader.batch_iterator(_Range(), 2, num_hosts=num_hosts,
                                       host_id=host_id))
    kw = dict(num_hosts=2, host_id=1, epochs=2, seed=3, num_workers=0)
    got = list(loader.batch_iterator(_Range(), 2, **kw))
    want = list(jloader.batch_iterator(_Range(), 2, **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def _seg_batch(seed, n_classes, shape=(2, 23, 31)):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes + 3, shape)
    labels[rng.random(shape) < 0.1] = 255
    preds = rng.integers(0, n_classes, shape)
    return labels, preds


@pytest.mark.parametrize("n_classes", [17, 19, 21])
def test_stream_seg_metrics_match_jax(n_classes):
    """The running confusion matrix and every result, over two updates
    and one merged device histogram; 17 classes keep the 19x19 quirk."""
    port = segmentation.StreamSegMetrics(n_classes)
    ref = jseg.StreamSegMetrics(n_classes)
    assert port.n_classes == ref.n_classes == max(n_classes, 19)
    for m in (port, ref):
        m.reset()
    for seed in (0, 1):
        labels, preds = _seg_batch(seed, n_classes)
        port.update(labels, preds)
        ref.update(labels, preds)
    hist = np.random.default_rng(2).integers(
        0, 50, (port.n_classes,) * 2).astype(np.float64)
    port.update_hist(hist)
    ref.update_hist(hist)
    np.testing.assert_array_equal(port.confusion_matrix,
                                  ref.confusion_matrix)
    got, want = port.get_results(), ref.get_results()
    assert set(got) == set(want)
    for key in ("Overall Acc", "Mean Acc", "FreqW Acc", "Mean IoU"):
        assert got[key] == want[key] or (np.isnan(got[key])
                                         and np.isnan(want[key]))
    np.testing.assert_array_equal(list(got["Class IoU"].values()),
                                  list(want["Class IoU"].values()))
    assert port.to_str(got) == ref.to_str(want)


def test_stream_seg_metrics_empty_matrix_matches_jax():
    port, ref = segmentation.StreamSegMetrics(17), jseg.StreamSegMetrics(17)
    got, want = port.get_results(), ref.get_results()
    for key in ("Overall Acc", "Mean Acc", "Mean IoU"):
        assert np.isnan(got[key]) and np.isnan(want[key])


@pytest.mark.parametrize("n_classes", [17, 19])
def test_confusion_matrix_update_matches_jax(n_classes):
    """The device histogram against the JAX one and against
    StreamSegMetrics' host matrix, on labels with 255 and predictions
    beyond the classes (clipped)."""
    labels, preds = _seg_batch(4, n_classes)
    preds[0, 0, :5] = n_classes + 2
    hist0 = np.random.default_rng(5).integers(
        0, 9, (n_classes, n_classes)).astype(np.int64)
    got = segmentation.confusion_matrix_update(
        torch.from_numpy(hist0), torch.from_numpy(labels),
        torch.from_numpy(preds), n_classes)
    want = jseg.confusion_matrix_update(
        jnp.asarray(hist0, jnp.int32), jnp.asarray(labels),
        jnp.asarray(preds), n_classes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    host = segmentation.StreamSegMetrics(n_classes, hist_classes=n_classes)
    host.update(labels, np.clip(preds, 0, n_classes - 1))
    np.testing.assert_array_equal(got.numpy() - hist0,
                                  host.confusion_matrix)


def test_pixel_accuracy_matches_jax():
    rng = np.random.default_rng(6)
    labels = rng.integers(-1, 13, (40, 50))
    preds = rng.integers(0, 13, (40, 50))
    got = segmentation.pixel_accuracy(preds, labels)
    want = jseg.pixel_accuracy(preds, labels)
    assert got[0] == want[0] and got[1] == want[1]
