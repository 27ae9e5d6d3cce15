"""Novel-prototype matching (NPM) of the port against the JAX package's:
``extract_prototype``, ``npm_override`` and ``npm_label_remap`` on seeded
numpy inputs (labels exact, vectors within 1e-6), the prototype JSON, and
the slice as a whole: ``cli.extract_prototypes.main`` and
``cli.eval_embedding.main`` of both packages on the same tiny Cityscapes
tree (96x192, 2 images per split), with the narrow DeepLab twin of
``tests/test_torch_deeplab.py`` swapped in for ``build_model`` by
``monkeypatch`` (no file is edited) and the same variables (the port reads
them from the JAX package's pickle). Prototypes within 1e-4 of their
largest magnitude (fp32 convs summed in another order); the same
per-image predictions, the NPM override firing on some pixels, and equal
``StreamSegMetrics`` results.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.cli import (
    eval_embedding as jax_eval_embedding,
    extract_prototypes as jax_extract_prototypes,
    main_deeplab as jax_main_deeplab)
from open_world_semantic_segmentation_tpu.core.config import (
    load_config as jax_load_config)
from open_world_semantic_segmentation_tpu.fewshot import prototypes as jproto
from open_world_semantic_segmentation_tpu.metrics import segmentation as jseg
from open_world_semantic_segmentation_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from open_world_semantic_segmentation_tpu_torch.cli import (
    eval_embedding, extract_prototypes, main_deeplab)
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.fewshot import prototypes
from open_world_semantic_segmentation_tpu_torch.metrics import segmentation
from test_torch_deeplab import jax_twin, port_twin, twin_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_synthetic_data import make_cityscapes  # noqa: E402


def _features(seed, shape=(2, 11, 13, 6)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("share", [0.3, 0.02], ids=["valid", "too-small"])
def test_extract_prototype_matches_jax(share):
    feats = _features(0)
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 12, feats.shape[:3])
    labels[rng.random(labels.shape) < share] = 13
    got, valid = prototypes.extract_prototype(
        torch.from_numpy(feats), torch.from_numpy(labels), 13)
    want, jvalid = jproto.extract_prototype(jnp.asarray(feats),
                                            jnp.asarray(labels), 13)
    assert bool(valid) == bool(jvalid) == (share > 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_npm_override_matches_jax():
    feats = _features(2, (15, 17, 16))
    logits = _features(3, (15, 17, 16)) * 4 - 12
    logits[10:] += 12          # rows where the base head's logit wins
    preds = np.random.default_rng(4).integers(0, 16, (15, 17))
    # a prototype near pixel (3, 4) and (12, 5): both beat the threshold,
    # only the first beats its largest logit
    feats[12, 5] = feats[3, 4]
    proto = feats[3, 4] + 0.2
    got, dis = prototypes.npm_override(
        torch.from_numpy(preds), torch.from_numpy(feats),
        torch.from_numpy(logits), torch.from_numpy(proto), novel_id=16)
    want, jdis = jproto.npm_override(
        jnp.asarray(preds), jnp.asarray(feats), jnp.asarray(logits), proto,
        novel_id=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(dis.numpy(), np.asarray(jdis), rtol=1e-6,
                               atol=1e-6)
    assert got[3, 4] == 16 and got[12, 5] == preds[12, 5]


def test_npm_override_bf16_features_score_in_float32():
    """bf16 features against a float32 prototype: the distance is taken
    in float32, as the JAX package promotes them."""
    feats = torch.from_numpy(_features(5, (9, 10, 16))).bfloat16()
    logits = torch.from_numpy(_features(6, (9, 10, 16))).bfloat16()
    proto = _features(7, (16,))
    preds = logits.argmax(-1)
    got, dis = prototypes.npm_override(preds, feats, logits,
                                       torch.from_numpy(proto), novel_id=16,
                                       dis_threshold=-40.0)
    want, jdis = jproto.npm_override(
        jnp.asarray(preds.numpy()), jnp.asarray(feats.float().numpy(),
                                                jnp.bfloat16),
        jnp.asarray(logits.float().numpy(), jnp.bfloat16), proto,
        novel_id=16, dis_threshold=-40.0)
    assert dis.dtype == torch.float32 and jdis.dtype == jnp.float32
    np.testing.assert_allclose(dis.numpy(), np.asarray(jdis), rtol=1e-6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_npm_label_remap_matches_jax():
    labels = np.random.default_rng(8).integers(0, 19, (21, 23))
    labels[0, :4] = [254, 255, 13, 14]
    got = prototypes.npm_label_remap(torch.from_numpy(labels))
    want = jproto.npm_label_remap(jnp.asarray(labels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # 255 shifts to 254 and back: the ignore id survives
    assert got[0, :4].tolist() == [253, 255, 16, 13]


def test_prototype_json_roundtrip(tmp_path):
    """Written by either package, read by both: the same average."""
    protos = [_features(9 + i, (16,)) for i in range(5)]
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    prototypes.save_prototypes(ours, protos)
    jproto.save_prototypes(theirs, protos)
    with open(ours) as a, open(theirs) as b:
        assert a.read() == b.read()
    want = jproto.average_prototypes(protos)
    np.testing.assert_array_equal(prototypes.average_prototypes(protos),
                                  want)
    for path in (ours, theirs):
        np.testing.assert_array_equal(prototypes.load_prototypes(path),
                                      want)
        np.testing.assert_array_equal(jproto.load_prototypes(path), want)


# --------------------------------------------------------------------------
# the slice as a whole

def _swap_in_twins(mp):
    mp.setattr(main_deeplab, "build_model",
               lambda cfg, fused_blocks=False, **_: (port_twin(fused_blocks),
                                                     16))
    for module in (jax_main_deeplab, jax_eval_embedding,
                   jax_extract_prototypes):
        mp.setattr(module, "build_model",
                   lambda cfg, train, dtype: (jax_twin(), 16))


def _spy_updates(mp, cls, seen):
    """Record what reaches ``cls.update`` (labels, predictions)."""
    update = cls.update

    def record(self, label_trues, label_preds):
        seen.append((np.array(label_trues), np.array(label_preds)))
        return update(self, label_trues, label_preds)
    mp.setattr(cls, "update", record)


@pytest.fixture(scope="module")
def npm_setup(tmp_path_factory):
    """A ``make_cityscapes`` tree at 96x192 (2 support and 2 val images)
    with a car block over 17 % of every image, the twin's variables (as
    the JAX package's pickle for the port), a prototype JSON (the twin's
    embedding at a car pixel of the first val image, so that the override
    fires there), and the JAX package's runs of both CLIs on it:
    its prototypes, and its eval's results and StreamSegMetrics updates.
    The JAX CLIs take the variables directly (no flax init)."""
    from PIL import Image

    root = str(tmp_path_factory.mktemp("npm"))
    tree = make_cityscapes(os.path.join(root, "cs"), n=2)
    for split in ("train", "val"):
        gt = os.path.join(tree, "gtFine", split, "synthcity")
        for name in os.listdir(gt):
            lab = np.array(Image.open(os.path.join(gt, name)))
            lab[20:60, 40:120] = 26
            Image.fromarray(lab, "L").save(os.path.join(gt, name))
    variables = twin_variables(0)
    weights = os.path.join(root, "twin.pkl")
    jax_save_checkpoint(weights, variables)
    extract_json = os.path.join(root, "extracted.json")
    eval_json = os.path.join(root, "prototype.json")
    opts = ["DATASET.root_dataset", tree,
            "DEEPLAB.model", "deeplabv3plus_embedding_resnet101",
            "MODEL.weights_encoder", weights, "FEWSHOT.shots", "2"]

    cfg = load_config(None, opts)
    model = main_deeplab.init_or_load_deeplab(port_twin(), weights)
    image, _, target_true = main_deeplab.get_val_dataset(
        cfg, main_deeplab.get_transforms(768)[1])[0]
    assert target_true[40, 80] == 13
    with torch.no_grad():
        _, _, feats = model(torch.from_numpy(image[None]))
    prototypes.save_prototypes(eval_json, [feats[0, 40, 80].numpy()])

    seen = []
    with pytest.MonkeyPatch.context() as mp:
        _swap_in_twins(mp)
        _spy_updates(mp, jseg.StreamSegMetrics, seen)
        protos = jax_extract_prototypes.main(jax_load_config(
            None, opts + ["FEWSHOT.prototype_file", extract_json]),
            variables=variables)
        score = jax_eval_embedding.main(jax_load_config(
            None, opts + ["FEWSHOT.prototype_file", eval_json]),
            variables=variables)
    return {"opts": opts, "extract_json": extract_json,
            "eval_json": eval_json, "protos": protos, "score": score,
            "seen": seen}


def test_extract_prototypes_cli_matches_jax(npm_setup, monkeypatch,
                                            tmp_path):
    _swap_in_twins(monkeypatch)
    path = str(tmp_path / "port.json")
    got = extract_prototypes.main(
        load_config(None, npm_setup["opts"] + [
            "FEWSHOT.prototype_file", path]), device="cpu")
    want = npm_setup["protos"]
    assert len(got) == len(want) == 2
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(
        prototypes.load_prototypes(path),
        jproto.load_prototypes(npm_setup["extract_json"]), rtol=1e-4,
        atol=1e-4 * scale)


@pytest.mark.parametrize("fused_blocks", [False, True],
                         ids=["unfused", "fused"])
def test_eval_embedding_cli_matches_jax(npm_setup, monkeypatch,
                                        fused_blocks):
    """The port's NPM eval on the 2 val images with the JAX run's
    prototype JSON: equal per-image labels and predictions as they reach
    StreamSegMetrics, the override firing on some pixels and not all, and
    equal results."""
    _swap_in_twins(monkeypatch)
    seen = []
    _spy_updates(monkeypatch, segmentation.StreamSegMetrics, seen)
    got = eval_embedding.main(
        load_config(None, npm_setup["opts"] + [
            "FEWSHOT.prototype_file", npm_setup["eval_json"]]),
        device="cpu", fused_blocks=fused_blocks)
    want = npm_setup["score"]
    assert got["images"] == len(seen) == len(npm_setup["seen"]) == 2
    for (lt, lp), (jlt, jlp) in zip(seen, npm_setup["seen"]):
        np.testing.assert_array_equal(lt, jlt)
        np.testing.assert_array_equal(lp.astype(np.int64), jlp)
    preds = np.concatenate([lp.ravel() for _, lp in seen])
    assert 0 < (preds == 16).sum() == got["novel_pixels"] < preds.size
    assert got["pixels"] == preds.size
    for key in ("Overall Acc", "Mean Acc", "FreqW Acc", "Mean IoU"):
        assert got[key] == want[key]
    assert got["Class IoU"].keys() == want["Class IoU"].keys()
    np.testing.assert_array_equal(list(got["Class IoU"].values()),
                                  list(want["Class IoU"].values()))
