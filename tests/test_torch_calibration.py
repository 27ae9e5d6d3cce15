"""The port's Cityscapes eval surface against the JAX package's, on the CPU
in float32: the GMM/ECDF score calibration (``openset/calibration.py``,
``cli/eval_embedding.py fit_calibration`` and the calibrated eval),
``cli/test_deeplab.py``'s result PNGs, and Fishyscapes Lost&Found
(``openset/fishyscapes.py``, ``cli/eval_fishyscapes.py``).

The numpy functions take the same inputs and the same
``np.random.default_rng`` seed on both sides, so samples and fitted state
must be equal. The CLIs run the narrow DeepLab twin of
``tests/test_torch_deeplab.py`` with the same variables, swapped in for
``build_model`` by ``monkeypatch`` (no file is edited; the port reads the
variables from the JAX package's pickle), on a ``make_cityscapes`` tree of
96x192 images.

Tolerances: dis_sum samples and fitted thresholds within 1e-4 of their
largest magnitude (fp32 convs summed in another order); calibrated and
Fishyscapes metrics within 1e-3; estimator maps within 1e-4 of their
largest magnitude. PNGs are compared as decoded arrays.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from open_world_semantic_segmentation_tpu.cli import (
    eval_embedding as jax_eval_embedding,
    eval_fishyscapes as jax_eval_fishyscapes,
    main_deeplab as jax_main_deeplab)
from open_world_semantic_segmentation_tpu.cli import (
    test_deeplab as jax_test_deeplab)
from open_world_semantic_segmentation_tpu.core.config import (
    load_config as jax_load_config)
from open_world_semantic_segmentation_tpu.data.cityscapes import (
    Cityscapes as JaxCityscapes)
from open_world_semantic_segmentation_tpu.openset import (
    calibration as jcal, fishyscapes as jfishy)
from open_world_semantic_segmentation_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from open_world_semantic_segmentation_tpu_torch.cli import (
    eval_embedding, eval_fishyscapes, main_deeplab, test_deeplab)
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.data.cityscapes import (
    Cityscapes)
from open_world_semantic_segmentation_tpu_torch.openset import (
    calibration as cal, fishyscapes as fishy)
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    deeplab_state_dict_from_jax)
from test_torch_deeplab import jax_twin, port_twin, twin_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_synthetic_data import make_cityscapes  # noqa: E402

CALIB = ("calib_auroc", "calib_aupr", "calib_fpr95")


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(float(np.abs(want).max()), 1))


# --------------------------------------------------------------------------
# openset/calibration.py, the numpy copy

def _dissum_maps(seed, n=3, shape=(40, 50), classes=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, classes, shape)
        labels[rng.random(shape) < 0.1] = 255
        preds = np.where(rng.random(shape) < 0.8, labels % classes,
                         rng.integers(0, classes, shape))
        dissum = rng.gamma(2.0, 100.0, shape) + 50 * (labels == 255)
        out.append((dissum.astype(np.float32), preds, labels))
    return out


def test_calibration_functions_match_jax():
    x = np.random.default_rng(1).normal(3, 2, 500)
    for got, want in zip(cal.fit_gmm2_1d(x), jcal.fit_gmm2_1d(x)):
        np.testing.assert_array_equal(got, want)
    s = np.sort(x)
    q = np.linspace(-3, 9, 37)
    np.testing.assert_array_equal(cal.ecdf_eval(s, q), jcal.ecdf_eval(s, q))
    for mode in ("step", "sigmoid"):
        np.testing.assert_array_equal(
            cal.certainty(q, s, thre=2.0, mode=mode),
            jcal.certainty(q, s, thre=2.0, mode=mode))


def test_collected_samples_and_fitted_state_match_jax(tmp_path):
    maps = _dissum_maps(2)
    lists = []
    for module in (cal, jcal):
        rng = np.random.default_rng(0)
        data_list = [[] for _ in range(5)]
        for dis, prd, lab in maps:
            module.collect_dissum_samples(dis, prd, lab, 4, data_list, rng,
                                          rate=50)
        lists.append(data_list)
    assert lists[0] == lists[1] and all(len(v) for v in lists[0])
    got = cal.ScoreCalibration.fit(lists[0], mode="sigmoid")
    want = jcal.ScoreCalibration.fit(lists[1], mode="sigmoid")
    np.testing.assert_array_equal(got.thresholds, want.thresholds)
    for a, b in zip(got.sorted_samples, want.sorted_samples):
        np.testing.assert_array_equal(a, b)
    probs = np.random.default_rng(3).dirichlet(np.ones(4), (40, 50))
    for g, w in zip(got.apply(probs, maps[0][0]),
                    want.apply(probs, maps[0][0])):
        np.testing.assert_array_equal(g, w)
    # state written by one package loads into the other
    got.save(str(tmp_path / "port.npz"))
    want.save(str(tmp_path / "jax.npz"))
    for a, b in ((cal, tmp_path / "jax.npz"), (jcal, tmp_path / "port.npz")):
        back = a.ScoreCalibration.load(str(b))
        assert back.mode == "sigmoid" and back.clip == 1000.0
        np.testing.assert_array_equal(back.thresholds, got.thresholds)


# --------------------------------------------------------------------------
# the CLIs with the twin

def _swap_in_twins(mp):
    mp.setattr(main_deeplab, "build_model",
               lambda cfg, fused_blocks=False, **_: (port_twin(fused_blocks),
                                                     16))
    # the JAX eval_fishyscapes imports build_model from main_deeplab
    for module in (jax_main_deeplab, jax_eval_embedding):
        mp.setattr(module, "build_model",
                   lambda cfg, train, dtype: (jax_twin(), 16))


@pytest.fixture(scope="module")
def cs_setup(tmp_path_factory):
    """A 96x192 tree (3 val images, truck and bus blocks: the unknowns,
    label 255) and the twin's variables, as the JAX package's pickle for
    the port."""
    root = str(tmp_path_factory.mktemp("calib"))
    tree = make_cityscapes(os.path.join(root, "cs"), splits=("val",), n=3)
    variables = twin_variables(1)
    weights = os.path.join(root, "twin.pkl")
    jax_save_checkpoint(weights, variables)
    opts = ["DATASET.root_dataset", tree,
            "DEEPLAB.model", "deeplabv3plus_embedding_resnet101",
            "MODEL.weights_encoder", weights, "DEEPLAB.ckpt", weights,
            "FEWSHOT.calibrate_scores", "True", "FEWSHOT.calib_images", "2",
            "FEWSHOT.calib_rate", "20"]
    return {"tree": tree, "variables": variables, "weights": weights,
            "opts": opts}


def test_fit_calibration_matches_jax(cs_setup, monkeypatch):
    _swap_in_twins(monkeypatch)
    cfg = load_config(None, cs_setup["opts"])
    tf = main_deeplab.get_transforms(768)[1]
    model = main_deeplab.init_or_load_deeplab(port_twin(),
                                              cs_setup["weights"])
    got = eval_embedding.fit_calibration(
        model, Cityscapes(cs_setup["tree"], "val", transform=tf), 16, cfg)
    want = jax_eval_embedding.fit_calibration(
        jax_twin(), cs_setup["variables"],
        JaxCityscapes(cs_setup["tree"], "val",
                      transform=jax_main_deeplab.get_transforms(768)[1]),
        16, jax_load_config(None, cs_setup["opts"]))
    assert got.num_classes == want.num_classes == 16
    n_fitted = 0
    for a, b in zip(got.sorted_samples, want.sorted_samples):
        assert a.shape == b.shape
        if a.size:
            _close(a, b)
            n_fitted += 1
    assert n_fitted > 0
    _close(got.thresholds, want.thresholds)


def test_calibrated_eval_embedding_matches_jax(cs_setup, monkeypatch,
                                               tmp_path):
    """The calibrated eval: the same calibrated AUROC / AUPR / FPR95, and
    the fitted state written to FEWSHOT.calib_save."""
    _swap_in_twins(monkeypatch)
    protos = tmp_path / "proto.json"
    protos.write_text(json.dumps([[0.1] * 16]))
    opts = cs_setup["opts"] + ["FEWSHOT.prototype_file", str(protos),
                               "FEWSHOT.calib_save",
                               str(tmp_path / "state.npz")]
    want = jax_eval_embedding.main(jax_load_config(None, opts),
                                   variables=cs_setup["variables"])
    got = eval_embedding.main(load_config(None, opts), device="cpu")
    assert got["images"] == 3
    for key in CALIB:
        assert np.isfinite(got[key]), key
        assert abs(got[key] - want[key]) <= 1e-3, key
    state = cal.ScoreCalibration.load(str(tmp_path / "state.npz"))
    assert state.num_classes == 16


def test_save_val_result_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    image = rng.standard_normal((20, 30, 3)).astype(np.float32)
    target = rng.integers(0, 19, (20, 30))
    target[0, :5] = 255
    pred = rng.integers(0, 19, (20, 30))
    scores = rng.random((20, 30)).astype(np.float32)
    test_deeplab.save_val_result(image, target, pred, scores,
                                 Cityscapes.decode_target,
                                 str(tmp_path / "port"), 3)
    jax_test_deeplab.save_val_result(image, target, pred, scores,
                                     JaxCityscapes.decode_target,
                                     str(tmp_path / "jax"), 3)
    kinds = ("image", "target", "pred", "scores", "overlay")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        f"3_{k}.png" for k in kinds)
    for kind in kinds:
        got = np.asarray(Image.open(tmp_path / "port" / f"3_{kind}.png"))
        want = np.asarray(Image.open(tmp_path / "jax" / f"3_{kind}.png"))
        np.testing.assert_array_equal(got, want)
        assert got.shape[:2] == (20, 30)


def test_test_deeplab_save_val_results(cs_setup, monkeypatch, tmp_path):
    """DEEPLAB.save_val_results: five PNGs per image in DIR/results; the
    image PNG is the denormalised input, the target PNG its colours."""
    _swap_in_twins(monkeypatch)
    cfg = load_config(None, cs_setup["opts"] + [
        "DEEPLAB.save_val_results", "True", "DIR", str(tmp_path)])
    score, ood = test_deeplab.main(cfg, torch.float32, max_images=2,
                                   device="cpu")
    assert score["images"] == 2 and ood is not None
    out = tmp_path / "results"
    assert len(os.listdir(out)) == 10
    ds = main_deeplab.get_val_dataset(cfg,
                                      main_deeplab.get_transforms(768)[1])
    for i in range(2):
        image, target, _ = ds[i]
        raw = np.asarray(Image.open(ds.images[i]).convert("RGB"))
        got = np.asarray(Image.open(out / f"{i}_image.png"))
        assert np.abs(got.astype(int) - raw).max() <= 1   # rounding
        np.testing.assert_array_equal(
            np.asarray(Image.open(out / f"{i}_target.png")),
            Cityscapes.decode_target(target))


# --------------------------------------------------------------------------
# Fishyscapes Lost&Found

@pytest.fixture(scope="module")
def laf_tree(tmp_path_factory):
    """Three 64x128 images with Lost&Found labels (raw 0 void, 1 road, 2
    lost cargo) and their odgt list."""
    root = str(tmp_path_factory.mktemp("laf"))
    rng = np.random.default_rng(5)
    records = []
    for i in range(3):
        img = rng.integers(0, 255, (64, 128, 3), dtype=np.uint8)
        lab = np.ones((64, 128), np.uint8)
        lab[:6] = 0
        lab[20 + i:34 + i, 40:70] = 2
        img[lab == 2] = 250
        ip, lp = f"img/{i}.png", f"lab/{i}.png"
        for p, arr in ((ip, img), (lp, lab)):
            os.makedirs(os.path.dirname(os.path.join(root, p)),
                        exist_ok=True)
            Image.fromarray(arr).save(os.path.join(root, p))
        records.append({"fpath_img": ip, "fpath_segm": lp, "height": 64,
                        "width": 128})
    odgt = os.path.join(root, "laf.odgt")
    with open(odgt, "w") as f:
        f.write(json.dumps(records) + "\n")
    return root, odgt


@pytest.mark.parametrize("method", ["entropy", "msp", "dissum"])
def test_make_estimator_matches_jax(method, laf_tree):
    variables = twin_variables(1)
    model = port_twin()
    model.load_state_dict(deeplab_state_dict_from_jax(variables))
    img = np.asarray(Image.open(os.path.join(laf_tree[0], "img/0.png")))
    got = fishy.make_estimator(model, method=method)(img)
    want = jfishy.make_estimator(jax_twin(), variables, method=method)(img)
    assert got.shape == want.shape == (64, 128) and got.dtype == np.float32
    _close(got, want)


def test_run_native_and_cli_match_jax(cs_setup, laf_tree, monkeypatch):
    """``run_native`` through ``cli.eval_fishyscapes.main``: pooled AP /
    AUROC / FPR95 over the three images, against the JAX CLI."""
    _swap_in_twins(monkeypatch)
    root, odgt = laf_tree
    opts = cs_setup["opts"] + ["DATASET.root_dataset", root,
                               "DATASET.list_val", odgt]
    want = jax_eval_fishyscapes.main(jax_load_config(None, opts),
                                     jnp.float32, method="msp",
                                     variables=cs_setup["variables"])
    got = eval_fishyscapes.main(load_config(None, opts), torch.float32,
                                method="msp", device="cpu")
    assert got["n_images"] == want["n_images"] == 3
    for key in ("AP", "AUROC", "FPR95"):
        assert np.isfinite(got[key])
        assert abs(got[key] - want[key]) <= 1e-3, key
    two = eval_fishyscapes.main(load_config(None, opts), torch.float32,
                                method="msp", max_images=2, device="cpu")
    assert two["n_images"] == 2


def test_run_bdlb_raises_without_bdlb(monkeypatch):
    monkeypatch.setitem(sys.modules, "bdlb", None)
    with pytest.raises(RuntimeError, match="bdlb"):
        fishy.run_bdlb(lambda image: image)
    with pytest.raises(RuntimeError, match="bdlb"):
        jfishy.run_bdlb(lambda image: image)
