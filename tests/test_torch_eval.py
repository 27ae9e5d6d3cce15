"""The port's StreetHazards open-set eval vs the JAX package's, end to end.

Both packages read the same synthetic odgt tree (made here from a numpy
seed, labels include the anomaly id), build the same 2-scale pyramid and
evaluate the narrow twin of ``test_torch_model.py`` with the same weights,
fp32 on the CPU, with ``dissum`` and with ``knn``.

Tolerances: per-image conf maps atol 1e-4 (they are min-max normalised or
cosine sums of scores that agree to ~1e-5 relative); mIoU, accuracy, AUROC,
AUPR and FPR95 within 1e-3. The twin's random logits can tie, so a few
argmax flips between the frameworks are allowed (>= 99.9 % equal).
"""

import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

from open_world_semantic_segmentation_tpu.data.odgt import (
    ValPipeline as JaxValPipeline)
from open_world_semantic_segmentation_tpu.metrics.segmentation import (
    intersection_and_union_jax)
from open_world_semantic_segmentation_tpu.openset.evaluator import (
    OODEvaluator as JaxOODEvaluator, device_pyramid as jax_device_pyramid)
from open_world_semantic_segmentation_tpu.train.convert import (
    convert_segmentation_model)
from open_world_semantic_segmentation_tpu_torch.cli import eval_ood
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.data.odgt import ValPipeline
from open_world_semantic_segmentation_tpu_torch.metrics.segmentation import (
    intersection_and_union, intersection_and_union_torch)
from open_world_semantic_segmentation_tpu_torch.openset.evaluator import (
    OODEvaluator, device_pyramid)
from test_torch_model import jax_twin, jax_twin_variables, port_twin_from

IMG_SIZES = (32, 48)
METRICS = ("mean_iou", "accuracy", "auroc", "aupr", "fpr")


@pytest.fixture(scope="module")
def street_tree(tmp_path_factory):
    """A StreetHazards-format tree: RGB images and L-mode labels 1..13 with
    an anomaly blob (raw 14 -> label 13, the default out_label)."""
    root = str(tmp_path_factory.mktemp("streethazards"))
    rng = np.random.default_rng(0)
    h, w = 48, 64
    records = []
    for i in range(3):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        lab = np.full((h, w), 8, np.uint8)
        for _ in range(5):
            r0, c0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            lab[r0:r0 + rng.integers(4, h // 2),
                c0:c0 + rng.integers(4, w // 2)] = rng.integers(1, 14)
        lab[10:20, 20:34] = 14
        lab[0:2, 0:3] = 0   # unlabeled
        ip, ap = f"images/test/t1/{i}.png", f"annotations/test/t1/{i}.png"
        for p, arr, mode in ((ip, img, "RGB"), (ap, lab, "L")):
            os.makedirs(os.path.dirname(os.path.join(root, p)),
                        exist_ok=True)
            Image.fromarray(arr, mode).save(os.path.join(root, p))
        records.append({"fpath_img": ip, "fpath_segm": ap, "height": h,
                        "width": w})
    odgt = os.path.join(root, "test.odgt")
    with open(odgt, "w") as f:
        f.write(json.dumps(records) + "\n")
    return root, odgt


@pytest.fixture(scope="module")
def items(street_tree):
    root, odgt = street_tree
    got = list(ValPipeline(root, odgt, img_sizes=IMG_SIZES))
    want = list(JaxValPipeline(root, odgt, img_sizes=IMG_SIZES))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["seg_label"], w["seg_label"])
        assert [p.shape for p in g["img_data"]] == \
            [p.shape for p in w["img_data"]]
        for gp, wp in zip(g["img_data"], w["img_data"]):
            np.testing.assert_array_equal(gp, wp)
    return got


@pytest.fixture(scope="module")
def variables():
    return jax_twin_variables(5)


@pytest.fixture(scope="module")
def started_variables(items, variables):
    """The twin's weights with a data-dependent start, as ``chip_smoke.py
    data_start`` gives the card's: BN running statistics from train-mode
    forwards over the items, one batch per pyramid level (their mean: a
    start on one level leaves the other's distance sums in the
    thousands), then the embedding's last 1x1 conv scaled to a std of 0.8
    over both levels, the one-hot centres' scale. At the seeded weights
    every distance sum clips at 400 and the min-max normalised dissum map
    is 0/0; after the start it has values. The started port twin's state
    dicts go back to flax through the JAX package's reader, so both sides
    load the same weights."""
    model = port_twin_from(variables)
    levels = [torch.from_numpy(np.concatenate([it["img_data"][level]
                                               for it in items]))
              for level in range(len(IMG_SIZES))]
    seg_size = items[0]["seg_label"].shape[1:3]
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None          # running stats: the batches' mean
    with torch.no_grad():
        for img in levels:
            model.train()(img, seg_size=seg_size)
        std = torch.cat([model.eval()(img, seg_size=seg_size)["ft"]
                         for img in levels]).std().item()
        head = model.decoder.conv_last[4]
        head.weight.mul_(0.8 / std)
        head.bias.mul_(0.8 / std)
    return convert_segmentation_model(
        {k: v.numpy() for k, v in model.encoder.state_dict().items()},
        {k: v.numpy() for k, v in model.decoder.state_dict().items()})


@pytest.mark.parametrize("method", ["dissum", "knn"])
def test_eval_matches_jax(items, started_variables, method):
    """Per-image conf maps and the summary metrics. The dissum maps must
    be finite wherever the JAX package's are, and not all constant: a
    check of NaN against NaN would pass whatever the port computed."""
    variables = started_variables
    jax_ev = JaxOODEvaluator(jax_twin(), variables, num_class=13,
                             method=method)
    port_ev = OODEvaluator(port_twin_from(variables), num_class=13,
                           method=method)
    varied = 0
    for item in items:
        want = jax_ev.evaluate_item(item)
        got = port_ev.evaluate_item(item)
        conf, want_conf = np.asarray(got["conf"]), np.asarray(want["conf"])
        np.testing.assert_allclose(conf, want_conf, atol=1e-4)
        assert np.isfinite(conf[np.isfinite(want_conf)]).all()
        finite = conf[np.isfinite(conf)]
        varied += finite.size > 0 and finite.min() < finite.max()
        assert (got["pred"] == np.asarray(want["pred"])).mean() >= 0.999
    assert varied >= 1, "every conf map is constant or NaN"
    want, got = jax_ev.summary(verbose=False), port_ev.summary(verbose=False)
    assert got["images"] == 3
    for key in METRICS:
        assert np.isfinite(got[key]), key
        assert abs(got[key] - want[key]) <= 1e-3, key


def test_evaluate_batched_equals_evaluate(items, variables):
    model = port_twin_from(variables)
    one = OODEvaluator(model, num_class=13, method="dissum")
    batched = OODEvaluator(model, num_class=13, method="dissum")
    a = one.evaluate(items, progress=False)
    b = batched.evaluate_batched(items, batch_size=2)
    assert a["images"] == b["images"] == 3
    for r in (a, b):      # the host split: metric sweep and loader waits
        assert r["metric_time"] > 0 and r["wait_time"] >= 0
    for key in METRICS:
        assert abs(a[key] - b[key]) <= 1e-6, key
    np.testing.assert_array_equal(one.intersection_meter.sum,
                                  batched.intersection_meter.sum)


@pytest.mark.parametrize("num_class", [13, 4])
def test_iou_histograms_match_numpy_and_jax(num_class):
    rng = np.random.default_rng(num_class)
    pred = rng.integers(0, num_class, (40, 50))
    label = rng.integers(-1, num_class + 1, (40, 50))   # incl. out of range
    want = intersection_and_union(pred, label, num_class)
    got = intersection_and_union_torch(torch.from_numpy(pred),
                                       torch.from_numpy(label), num_class)
    jax_got = intersection_and_union_jax(jnp.asarray(pred),
                                         jnp.asarray(label), num_class)
    for g, w, j in zip(got, want, jax_got):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("shapes", [((24, 32), (40, 56)),    # down
                                    ((57, 91), (13, 17))])   # up, ragged
def test_device_pyramid_matches_jax(shapes):
    raw = np.random.default_rng(1).integers(0, 255, (1, 48, 64, 3),
                                            dtype=np.uint8)
    want = jax_device_pyramid(jnp.asarray(raw), shapes)
    got = device_pyramid(torch.from_numpy(raw), shapes)
    # F.interpolate computes its source grid in float32 (error ~1e-7 per
    # output index), the JAX package in float64; neighbouring normalised
    # pixels differ by up to ~4.7, so the two lerps part by up to ~3e-5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5)


def test_cli_main_runs_full_width_model_on_cpu(street_tree):
    """The CLI path (config, seeded init of the full-width resnet50dilated +
    ppm_deepsup_embedding, pipeline, prefetch, batched eval) on the CPU."""
    root, odgt = street_tree
    cfg = load_config("configs/test_ood_street.yaml", [
        "DATASET.root_dataset", root, "DATASET.list_val", odgt,
        "DATASET.imgSizes", "(32,)", "OOD.ood", "knn"])
    result = eval_ood.main(cfg, max_images=2, batch_images=2, device="cpu")
    assert result["images"] == 2
    for key in METRICS:
        assert np.isfinite(result[key]), key
