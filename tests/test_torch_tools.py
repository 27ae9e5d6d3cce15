"""The port's live video demo and dataset tools against the JAX package's.

- ``cli/demo_video.py``: ``overlay_mode`` and ``live_mode`` of both
  packages on the same tiny ``demo_video`` split (96x192, 3 frames). The
  live mode runs the narrow DeepLab twin of ``test_torch_deeplab.py``
  (swapped in for ``build_model`` by ``monkeypatch``) with the same
  variables, which the port reads from the JAX package's pickle, float32
  on the CPU. Written frames: equal on >= 99 % of pixels (a pixel differs
  only where the two argmaxes do); the overlay's, byte for byte.
- ``cli/make_odgt.py`` (every subcommand) and ``cli/pick_images.py`` on
  synthetic trees: the same files byte for byte, the same remapped labels,
  the same picked images for a seed.
"""

import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from open_world_semantic_segmentation_tpu.cli import (
    demo_video as jax_demo_video, main_deeplab as jax_main_deeplab,
    make_odgt as jax_make_odgt, pick_images as jax_pick_images)
from open_world_semantic_segmentation_tpu.core.config import (
    load_config as jax_load_config)
from open_world_semantic_segmentation_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from open_world_semantic_segmentation_tpu_torch.cli import (
    demo_video, main_deeplab, make_odgt, pick_images)
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.ops import fused_block
from test_torch_deeplab import jax_twin, port_twin, twin_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_synthetic_data import make_cityscapes  # noqa: E402

PIXEL_AGREEMENT = 0.99


def _frames(seq_dir):
    return {name: np.array(Image.open(os.path.join(seq_dir, name)))
            for name in sorted(os.listdir(seq_dir))}


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """A demo_video split, the twin's variables as the JAX package's
    pickle, and the JAX live mode's frames."""
    root = tmp_path_factory.mktemp("demo")
    tree = make_cityscapes(str(root / "cs"), splits=("demo_video",), n=3)
    variables = twin_variables(0)
    weights = str(root / "twin.pkl")
    jax_save_checkpoint(weights, variables)
    opts = ["DATASET.root_dataset", tree,
            "DEEPLAB.model", "deeplabv3plus_embedding_resnet101",
            "MODEL.weights_encoder", weights]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_main_deeplab, "build_model",
                   lambda cfg, train, dtype: (jax_twin(), 16))
        seq_dir = jax_demo_video.live_mode(
            jax_load_config(None, opts), str(root / "jax"), jnp.float32,
            variables=variables)
    return {"root": root, "tree": tree, "opts": opts,
            "frames": _frames(seq_dir)}


@pytest.mark.parametrize("fused_blocks", [False, True],
                         ids=["unfused", "fused"])
def test_live_mode_matches_jax(demo, monkeypatch, fused_blocks):
    monkeypatch.setattr(main_deeplab, "build_model",
                        lambda cfg, fused_blocks=False, **_: (
                            port_twin(fused_blocks), 16))
    calls = []
    plain = fused_block.fused_bottleneck_plain
    monkeypatch.setattr(fused_block, "fused_bottleneck_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = str(demo["root"] / f"port_{fused_blocks}")
    seq_dir = demo_video.live_mode(load_config(None, demo["opts"]), out,
                                   torch.float32, device="cpu",
                                   fused_blocks=fused_blocks, max_frames=2)
    got, want = _frames(seq_dir), demo["frames"]
    assert list(got) == list(want)[:2]
    for name, frame in got.items():
        assert frame.shape == want[name].shape == (96, 192, 3)
        assert (frame == want[name]).all(-1).mean() >= PIXEL_AGREEMENT
    # the twin's routed blocks (all but layer2.0 and layer3.0), per frame
    assert len(calls) == (2 * 3 if fused_blocks else 0)


def test_overlay_mode_matches_jax(demo, tmp_path):
    names = sorted(os.listdir(os.path.join(
        demo["tree"], "leftImg8bit", "demo_video", "synthcity")))
    preds = tmp_path / "preds"
    preds.mkdir()
    rng = np.random.default_rng(0)
    for name in names[:2]:          # the third frame has no prediction
        lab = rng.integers(0, 19, (96, 192)).astype(np.uint8)
        lab[:4] = 255
        Image.fromarray(lab, "L").save(preds / name)
    cfg = load_config(None, demo["opts"])
    demo_video.overlay_mode(cfg, str(preds), str(tmp_path / "port.avi"))
    jax_demo_video.overlay_mode(jax_load_config(None, demo["opts"]),
                                str(preds), str(tmp_path / "jax.avi"))
    try:
        import cv2  # noqa: F401
        outputs = ["port.avi", "jax.avi"]
    except ImportError:
        outputs = ["port.avi.frames", "jax.avi.frames"]
        assert sorted(os.listdir(tmp_path / outputs[0])) == names[:2]
    _assert_same_tree(tmp_path / outputs[0], tmp_path / outputs[1])


def _assert_same_tree(a, b):
    a, b = str(a), str(b)
    if os.path.isfile(a):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
        return
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        _assert_same_tree(os.path.join(a, name), os.path.join(b, name))


def _save(path, arr, mode):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr, mode).save(path)


@pytest.fixture(scope="module")
def odgt_trees(tmp_path_factory):
    """Synthetic StreetHazards, Lost&Found, RoadAnomaly and BDD trees."""
    root = tmp_path_factory.mktemp("odgt")
    rng = np.random.default_rng(0)

    def img(h=12, w=20):
        return rng.integers(0, 255, (h, w, 3), dtype=np.uint8)

    def lab(h=12, w=20, hi=20):
        return rng.integers(0, hi, (h, w)).astype(np.uint8)

    sh = root / "streethazards"
    for town in ("t1", "t2"):
        for i in range(3):
            _save(str(sh / "images/test" / town / f"{i}.png"),
                  img(12 + i, 20), "RGB")
            if (town, i) != ("t2", 1):          # one without annotation
                _save(str(sh / "annotations/test" / town / f"{i}.png"),
                      lab(12 + i, 20), "L")
    (sh / "images/test/readme.txt").write_text("not a town")
    laf = root / "laf"
    for city in ("01_city", "02_city"):
        for i in range(3):
            stem = f"{city}_{i:06d}_000010"
            _save(str(laf / "leftImg8bit/test" / city
                      / f"{stem}_leftImg8bit.png"), img(), "RGB")
            label = lab() if i != 2 else np.full((12, 20), 1, np.uint8)
            _save(str(laf / "gtCoarse/test" / city
                      / f"{stem}_gtCoarse_labelIds.png"), label, "L")
    ra = root / "roadanomaly"
    for i in range(3):
        _save(str(ra / "frames" / f"f{i}.jpg"), img(), "RGB")
        if i != 1:
            _save(str(ra / "frames" / f"f{i}.labels"
                      / "labels_semantic.png"), lab(hi=2), "L")
    bdd = root / "bdd"
    for i in range(3):
        label = lab(hi=20)
        label[0, :4] = [255, 16, 18, 19]
        _save(str(bdd / "labels" / f"{i}.png"), label, "L")
    return root


@pytest.mark.parametrize("command,root,args", [
    ("streethazards", "streethazards", []),
    ("laf", "laf", ["--img-dir", "leftImg8bit/test",
                    "--ann-dir", "gtCoarse/test"]),
    ("roadanomaly", "roadanomaly", ["--img-dir", "frames"]),
])
def test_make_odgt_matches_jax(odgt_trees, command, root, args):
    root = str(odgt_trees / root)
    make_odgt.main([command, "--root", root, "--out", "port.odgt"] + args)
    jax_make_odgt.main([command, "--root", root, "--out", "jax.odgt"]
                       + args)
    with open(os.path.join(root, "port.odgt"), "rb") as a, \
            open(os.path.join(root, "jax.odgt"), "rb") as b:
        got, want = a.read(), b.read()
    assert got == want
    records = json.loads(got)
    assert len(records) == {"streethazards": 5, "laf": 4,
                            "roadanomaly": 2}[command]


def test_convert_bdd_matches_jax(odgt_trees, tmp_path):
    for name in ("port", "jax"):
        shutil.copytree(odgt_trees / "bdd", tmp_path / name)
    make_odgt.main(["convert-bdd", "--root", str(tmp_path / "port"),
                    "--ann-dir", "labels"])
    jax_make_odgt.main(["convert-bdd", "--root", str(tmp_path / "jax"),
                        "--ann-dir", "labels"])
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    before = np.array(Image.open(odgt_trees / "bdd/labels/0.png"))
    after = np.array(Image.open(tmp_path / "port/labels/0.png"))
    # 255 -> 0, 16 -> 19, 18 -> 17, 19 -> 19 (through 18, +1)
    assert after[0, :4].tolist() == [0, 19, 17, 19]
    assert before.shape == after.shape


@pytest.mark.parametrize("copy", [False, True], ids=["symlink", "copy"])
def test_pick_images_matches_jax(tmp_path, copy):
    root = make_cityscapes(str(tmp_path / "cs"), splits=("train",), n=6,
                           h=24, w=48)
    extra = ["--copy"] if copy else []
    pick_images.main(["--root", root, "--dst", "port", "--n", "3",
                      "--seed", "5"] + extra)
    jax_pick_images.main(["--root", root, "--dst", "jax", "--n", "3",
                          "--seed", "5"] + extra)
    for kind in ("leftImg8bit", "gtFine"):
        got = sorted(os.listdir(os.path.join(root, kind, "port",
                                             "synthcity")))
        want = sorted(os.listdir(os.path.join(root, kind, "jax",
                                              "synthcity")))
        assert got == want and len(got) == 3
        path = os.path.join(root, kind, "port", "synthcity", got[0])
        assert os.path.islink(path) != copy
