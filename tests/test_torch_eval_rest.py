"""The rest of the port's StreetHazards eval surface against the JAX
package's, on the CPU in float32: the device-pyramid input, the
reconstructed-image input, the ``ppm_deepsup`` decoder, reconstruction
scoring, ``cli/eval_ood_rec`` and ``cli/test_closed``, the colour tables,
the result grids and ``VAL.visualize``.

The narrow twins of ``test_torch_model.py`` (the embedding decoder, and
the same backbone with ``PPMDeepsup``) take the JAX package's variables,
filled from a numpy seed, through ``train/convert.py``. The JAX CLIs get
the JAX twin by ``monkeypatch`` of their model builders (no file is
edited), the port's CLIs the port twin.

Tolerances: scores and features within 1e-4 of their largest magnitude
(fp32 convs summed in another order); conf maps atol 1e-5 (reconstruction
scoring), except the device-pyramid path's MSP map, atol 2e-4: its
F.interpolate grid is float32 and the JAX package's float64, which moves
the pyramid by up to 3e-5 (``test_torch_eval.py``) and the MSP map by up
to 8.2e-5 here; metrics within 1e-3; argmax agreement >= 99.9 % (random
logits can tie). PNGs are compared as decoded arrays, not bytes. The
embedding twin's dissum map is 0/0 at these weights (every distance sum
clips at 400), so the device-pyramid path is held on its MSP map.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from open_world_semantic_segmentation_tpu.cli import (
    eval_ood_rec as jax_eval_ood_rec, test_closed as jax_test_closed)
from open_world_semantic_segmentation_tpu.core.config import (
    load_config as jax_load_config)
from open_world_semantic_segmentation_tpu.data.odgt import (
    ValPipeline as JaxValPipeline)
from open_world_semantic_segmentation_tpu.models.builder import (
    SegmentationModel as JaxSegmentationModel)
from open_world_semantic_segmentation_tpu.models.decoders import (
    PPMDeepsup as JaxPPMDeepsup)
from open_world_semantic_segmentation_tpu.models.resnet import (
    Bottleneck as JaxBottleneck, ResNet as JaxResNet)
from open_world_semantic_segmentation_tpu.openset import scoring as jscoring
from open_world_semantic_segmentation_tpu.openset.evaluator import (
    OODEvaluator as JaxOODEvaluator)
from open_world_semantic_segmentation_tpu.ops import resize as jresize
from open_world_semantic_segmentation_tpu.utils import colors as jcolors
from open_world_semantic_segmentation_tpu.utils import (
    visualize as jvisualize)
from open_world_semantic_segmentation_tpu_torch.cli import (
    eval_ood, eval_ood_rec, test_closed)
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.data.odgt import ValPipeline
from open_world_semantic_segmentation_tpu_torch.models.builder import (
    ModelBuilder, SegmentationModel)
from open_world_semantic_segmentation_tpu_torch.models.decoders import (
    PPMDeepsup)
from open_world_semantic_segmentation_tpu_torch.models.resnet import (
    Bottleneck, ResNet)
from open_world_semantic_segmentation_tpu_torch.openset import scoring
from open_world_semantic_segmentation_tpu_torch.openset.evaluator import (
    OODEvaluator)
from open_world_semantic_segmentation_tpu_torch.ops import resize
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    state_dict_from_jax)
from open_world_semantic_segmentation_tpu_torch.utils import (
    colors, visualize)
from test_torch_eval import street_tree  # noqa: F401  (fixture)
from test_torch_model import (FC_DIM, NUM_CLASS, TWIN, fill_jax_variables,
                              jax_twin, jax_twin_variables, port_twin_from)

IMG_SIZES = (32, 48)
METRICS = ("mean_iou", "accuracy", "auroc", "aupr", "fpr")


def jax_deepsup_twin():
    return JaxSegmentationModel(
        encoder=JaxResNet(block=JaxBottleneck, **TWIN),
        decoder=JaxPPMDeepsup(num_class=NUM_CLASS, fc_dim=FC_DIM))


def port_deepsup_twin(variables):
    model = SegmentationModel(ResNet(block=Bottleneck, **TWIN),
                              PPMDeepsup(num_class=NUM_CLASS, fc_dim=FC_DIM))
    enc, dec = state_dict_from_jax(variables)
    model.encoder.load_state_dict(enc)
    model.decoder.load_state_dict(dec)
    return model.eval()


@pytest.fixture(scope="module")
def deepsup_variables():
    return fill_jax_variables(jax_deepsup_twin(), (1, 64, 64, 3), 11)


@pytest.fixture(scope="module")
def rec_tree(street_tree, tmp_path_factory):  # noqa: F811
    """Reconstructions of the street tree's images: the same folder and
    names, seeded noise, and half the size (the pipeline resizes them to
    the label's size, nearest)."""
    root, odgt = street_tree
    rec = str(tmp_path_factory.mktemp("rec"))
    rng = np.random.default_rng(3)
    with open(odgt) as f:
        records = json.loads(f.readline())
    for r in records:
        img = np.asarray(Image.open(os.path.join(root, r["fpath_img"])))
        half = img[::2, ::2]
        noisy = np.clip(half + rng.normal(0, 25, half.shape), 0,
                        255).astype(np.uint8)
        folder, name = r["fpath_img"].split("/")[-2:]
        os.makedirs(os.path.join(rec, folder), exist_ok=True)
        Image.fromarray(noisy).save(os.path.join(rec, folder, name))
    return rec


def _scale(want):
    return float(np.abs(want).max())


# --------------------------------------------------------------------------
# inputs: the device pyramid and the reconstructed tree

@pytest.fixture(scope="module")
def raw_items(street_tree):  # noqa: F811
    root, odgt = street_tree
    got = list(ValPipeline(root, odgt, img_sizes=IMG_SIZES,
                           device_pyramid=True))
    want = list(JaxValPipeline(root, odgt, img_sizes=IMG_SIZES,
                               device_pyramid=True))
    for g, w in zip(got, want):
        assert "img_data" not in g
        np.testing.assert_array_equal(g["img_raw"], w["img_raw"])
        np.testing.assert_array_equal(g["img_ori"], w["img_ori"])
        np.testing.assert_array_equal(g["seg_label"], w["seg_label"])
        assert g["pyramid_shapes"] == w["pyramid_shapes"]
        assert g["img_raw"].dtype == np.uint8
    return got


def test_device_pyramid_eval_matches_jax_raw_input_path(raw_items):
    """The uint8 items through both evaluators: the pyramid is built on
    the device on both sides."""
    variables = jax_twin_variables(5)
    jax_ev = JaxOODEvaluator(jax_twin(), variables, num_class=13,
                             method="msp")
    port_ev = OODEvaluator(port_twin_from(variables), num_class=13,
                           method="msp")
    for item in raw_items:
        want = jax_ev.evaluate_item(item)
        got = port_ev.evaluate_item(item)
        assert np.isfinite(got["conf"]).all()
        np.testing.assert_allclose(got["conf"], np.asarray(want["conf"]),
                                   atol=2e-4)
        assert (got["pred"] == np.asarray(want["pred"])).mean() >= 0.999
    want, got = jax_ev.summary(verbose=False), port_ev.summary(verbose=False)
    for key in METRICS:
        assert abs(got[key] - want[key]) <= 1e-3, key
    # batched: one forward per level for a batch of uint8 images
    batched = OODEvaluator(port_twin_from(variables), num_class=13,
                           method="msp")
    b = batched.evaluate_batched(raw_items, batch_size=2)
    assert b["images"] == len(raw_items)
    for key in METRICS:
        assert abs(b[key] - got[key]) <= 1e-6, key


def test_rec_dataset_items_match_jax(street_tree, rec_tree):  # noqa: F811
    root, odgt = street_tree
    got = list(ValPipeline(root, odgt, img_sizes=IMG_SIZES,
                           rec_dataset=rec_tree))
    want = list(JaxValPipeline(root, odgt, img_sizes=IMG_SIZES,
                               rec_dataset=rec_tree))
    plain = ValPipeline(root, odgt, img_sizes=IMG_SIZES)[0]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["img_ori"], w["img_ori"])
        np.testing.assert_array_equal(g["seg_label"], w["seg_label"])
        for gp, wp in zip(g["img_data"], w["img_data"]):
            np.testing.assert_array_equal(gp, wp)
    # the reconstruction, resized to the label's size, not the original
    assert got[0]["img_ori"].shape == plain["img_ori"].shape
    assert not np.array_equal(got[0]["img_ori"], plain["img_ori"])


def test_resize_like_torch_matches_jax():
    x = np.random.default_rng(2).standard_normal((1, 9, 13, 4)).astype(
        np.float32)
    got = resize.resize_like_torch(torch.from_numpy(x), (20, 7))
    want = jresize.resize_like_torch(jnp.asarray(x), (20, 7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


# --------------------------------------------------------------------------
# the ppm_deepsup model and reconstruction scoring

def test_ppm_deepsup_matches_jax(deepsup_variables):
    """Inference: raw logits at seg_size (no softmax) and the 4096-d-style
    PPM concat at feature resolution, through the weight bridge."""
    x = np.random.default_rng(4).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(jax_deepsup_twin().apply, static_argnames="seg_size")(
        deepsup_variables, jnp.asarray(x), seg_size=(64, 64))
    model = port_deepsup_twin(deepsup_variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x), seg_size=(64, 64), want_ft=True)
        plain = model(torch.from_numpy(x), seg_size=(64, 64))
    assert set(got) == set(want) == {"scores", "ft"}
    # the concat is built only when asked: test_closed and eval_ood skip it
    assert set(plain) == {"scores"}
    np.testing.assert_array_equal(plain["scores"].numpy(),
                                  got["scores"].numpy())
    assert got["ft"].shape == want["ft"].shape == (1, 8, 8, FC_DIM + 4 * 512)
    for key in ("scores", "ft"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * _scale(w))
    # not a distribution: no softmax at inference
    assert not np.allclose(got["scores"].sum(-1).numpy(), 1.0)
    # training (a batch of 2: BN over the 1x1 pooled branch): scores and
    # deep supervision at feature resolution, no concat
    model.train()
    x2 = torch.from_numpy(np.concatenate([x, -x]))
    out = model(x2)
    assert set(out) == {"scores", "deepsup"}
    assert out["scores"].shape == out["deepsup"].shape == (2, 8, 8,
                                                           NUM_CLASS)


def test_model_builder_builds_ppm_deepsup():
    dec = ModelBuilder.build_decoder("ppm_deepsup", fc_dim=FC_DIM,
                                     num_class=NUM_CLASS)
    assert isinstance(dec, PPMDeepsup)
    keys = set(dec.state_dict())
    assert {"ppm.0.1.weight", "conv_last.0.weight", "conv_last.4.bias",
            "cbr_deepsup.0.weight", "conv_last_deepsup.weight"} <= keys
    # upernet is ported now (tests/test_torch_zoo_decoders.py); an unknown
    # name raises as in the JAX ModelBuilder
    with pytest.raises(ValueError, match="Architecture undefined"):
        ModelBuilder.build_decoder("upernet_xl")


def test_rec_cosine_matches_jax():
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal((2, 6, 9, 32)).astype(np.float32)
            for _ in range(2))
    a[0, 0, 0] = 0.0         # a zero vector: cos 0, not nan
    got = scoring.rec_cosine_map(torch.from_numpy(a), torch.from_numpy(b))
    want = jscoring.rec_cosine_map(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    msp = rng.uniform(0.99, 1.0, (6, 9)).astype(np.float32)
    cos = rng.uniform(-1, 1, (6, 9)).astype(np.float32)
    got = scoring.rec_cosine_conf(torch.from_numpy(msp),
                                  torch.from_numpy(cos))
    want = jscoring.rec_cosine_conf(jnp.asarray(msp), jnp.asarray(cos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("exclude_back", [False, True])
def test_rec_combine_matches_jax(exclude_back):
    rng = np.random.default_rng(6)
    seg_size = (40, 56)
    scores = [rng.standard_normal((1, *seg_size, 5)).astype(np.float32)
              for _ in range(2)]
    # one logit large enough that msp > 0.999 selects it somewhere
    scores[0][0, :10] += 3.0
    fto = [rng.standard_normal((1, h, w, 16)).astype(np.float32)
           for h, w in ((5, 7), (8, 9))]
    ftr = [f + 0.5 * rng.standard_normal(f.shape).astype(np.float32)
           for f in fto]
    t = [[torch.from_numpy(v) for v in vs] for vs in (scores, fto, ftr)]
    j = [[jnp.asarray(v) for v in vs] for vs in (scores, fto, ftr)]
    conf, pred = eval_ood_rec.rec_combine(*t, seg_size, exclude_back)
    jconf, jpred = jax_eval_ood_rec.rec_combine(*j, seg_size, exclude_back)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), atol=1e-5)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    selected = conf.numpy() > 0.999
    assert 0 < selected.sum() < selected.size


# --------------------------------------------------------------------------
# the CLIs against the JAX ones, with the twins swapped in

def _swap_in_deepsup_twins(mp, variables, *modules):
    """Each JAX CLI module builds the JAX twin and takes ``variables``;
    each port CLI module builds the port twin from them."""
    for jax_module, port_module in modules:
        mp.setattr(jax_module, "build_anomaly_model",
                   lambda cfg, **kw: jax_deepsup_twin())
        mp.setattr(jax_module, "init_or_load_variables",
                   lambda cfg, model, example, **kw: variables)
        mp.setattr(port_module, "build_anomaly_model",
                   lambda cfg, device=None, **kw:
                   port_deepsup_twin(variables))
        mp.setattr(port_module, "init_or_load_variables",
                   lambda cfg, model, **kw: model)


def test_eval_ood_rec_main_matches_jax(street_tree, rec_tree,  # noqa: F811
                                       deepsup_variables, monkeypatch):
    root, odgt = street_tree
    opts = ["DATASET.root_dataset", root, "DATASET.list_val", odgt,
            "DATASET.rec_dataset", rec_tree, "DATASET.imgSizes", "(32, 48)"]
    _swap_in_deepsup_twins(monkeypatch, deepsup_variables,
                           (jax_eval_ood_rec, eval_ood_rec))
    want = jax_eval_ood_rec.main(jax_load_config(
        "configs/test_ood_rec.yaml", opts), jnp.float32)
    got = eval_ood_rec.main(load_config("configs/test_ood_rec.yaml", opts),
                            torch.float32, device="cpu")
    assert got["images"] == 3 and got["seconds"] > 0
    for key in METRICS:
        assert np.isfinite(got[key]), key
        assert abs(got[key] - want[key]) <= 1e-3, key


def test_test_closed_main_matches_jax(street_tree,  # noqa: F811
                                      deepsup_variables, monkeypatch,
                                      tmp_path):
    """The same summaries, and the prediction PNGs (pred + 1, per folder)
    equal as decoded arrays."""
    root, odgt = street_tree
    _swap_in_deepsup_twins(monkeypatch, deepsup_variables,
                           (jax_test_closed, test_closed))
    results = {}
    for side, module, load in (("jax", jax_test_closed, jax_load_config),
                               ("port", test_closed, load_config)):
        out = str(tmp_path / side)
        cfg = load("configs/test_test.yaml", [
            "DATASET.root_dataset", root, "DATASET.list_val", odgt,
            "DATASET.imgSizes", "(32, 48)", "TEST.result", out])
        kw = {"device": "cpu"} if side == "port" else {}
        results[side] = (module.main(cfg, **kw), out)
    (want, jout), (got, pout) = results["jax"], results["port"]
    for key in METRICS:
        assert abs(got[key] - want[key]) <= 1e-3, key
    names = sorted(os.listdir(os.path.join(pout, "t1")))
    assert names == sorted(os.listdir(os.path.join(jout, "t1"))) == [
        "0.png", "1.png", "2.png"]
    for name in names:
        g = np.asarray(Image.open(os.path.join(pout, "t1", name)))
        w = np.asarray(Image.open(os.path.join(jout, "t1", name)))
        assert g.shape == w.shape == (48, 64) and g.dtype == np.uint8
        assert (g == w).mean() >= 0.999
        assert 1 <= g.min() and g.max() <= NUM_CLASS


# --------------------------------------------------------------------------
# colours and result grids

def test_colors_match_jax():
    np.testing.assert_array_equal(colors.STREETHAZARDS_COLORS,
                                  jcolors.STREETHAZARDS_COLORS)
    np.testing.assert_array_equal(colors.CITYSCAPES_TRAIN_COLORS,
                                  jcolors.CITYSCAPES_TRAIN_COLORS)
    lab = np.random.default_rng(7).integers(-1, 20, (9, 11))
    for palette in (colors.STREETHAZARDS_COLORS,
                    colors.CITYSCAPES_TRAIN_COLORS):
        for mode in ("RGB", "BGR"):
            np.testing.assert_array_equal(
                colors.color_encode(lab, palette, mode),
                jcolors.color_encode(lab, palette, mode))


def test_denormalize_matches_jax():
    x = np.random.default_rng(8).standard_normal((3, 5, 7)).astype(
        np.float32)
    for arr in (x, x.transpose(1, 2, 0)):
        np.testing.assert_array_equal(visualize.Denormalize()(arr),
                                      jvisualize.Denormalize()(arr))


def test_save_result_grid_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    img = rng.integers(0, 255, (12, 16, 3), dtype=np.uint8)
    seg = rng.integers(-1, 14, (12, 16))
    pred = rng.integers(0, 13, (12, 16))
    visualize.save_result_grid(img, seg, pred, "images/t1/a.jpg",
                               str(tmp_path / "port"))
    jvisualize.save_result_grid(img, seg, pred, "images/t1/a.jpg",
                                str(tmp_path / "jax"))
    got = np.asarray(Image.open(tmp_path / "port" / "a.png"))
    want = np.asarray(Image.open(tmp_path / "jax" / "a.png"))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (12, 48, 3)
    np.testing.assert_array_equal(got[:, :16], img)


@pytest.mark.parametrize("device_metrics", [False, True])
def test_val_visualize_writes_grids(street_tree, monkeypatch,  # noqa: F811
                                    tmp_path, device_metrics):
    """``VAL.visualize``: one [image | gt | pred] grid per image in
    ``DIR/result``, batched and with the device metrics too; the grid is
    the one the JAX package's ``save_result_grid`` draws of the item and
    the port's prediction."""
    root, odgt = street_tree
    variables = jax_twin_variables(5)
    monkeypatch.setattr(eval_ood, "build_anomaly_model",
                        lambda cfg, device=None, **kw:
                        port_twin_from(variables))
    monkeypatch.setattr(eval_ood, "init_or_load_variables",
                        lambda cfg, model, **kw: model)
    cfg = load_config("configs/test_ood_street.yaml", [
        "DATASET.root_dataset", root, "DATASET.list_val", odgt,
        "DATASET.imgSizes", "(32, 48)", "VAL.visualize", "True",
        "DIR", str(tmp_path)])
    result = eval_ood.main(cfg, max_images=2, batch_images=2, device="cpu",
                           device_metrics=device_metrics)
    assert result["images"] == 2
    out = tmp_path / "result"
    assert sorted(os.listdir(out)) == ["0.png", "1.png"]
    items = ValPipeline(root, odgt, img_sizes=IMG_SIZES)
    ev = OODEvaluator(port_twin_from(variables), num_class=13)
    for i in range(2):
        pred = ev.evaluate_item(items[i])["pred"]
        jvisualize.save_result_grid(items[i]["img_ori"],
                                    items[i]["seg_label"][0], pred,
                                    items[i]["info"], str(tmp_path / "jax"))
        got = np.asarray(Image.open(out / f"{i}.png"))
        want = np.asarray(Image.open(tmp_path / "jax" / f"{i}.png"))
        assert got.shape == (48, 192, 3)
        np.testing.assert_array_equal(got, want)
