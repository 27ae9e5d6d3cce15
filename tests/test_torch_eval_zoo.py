"""The port's ``cli/eval_ood`` and ``cli/test_closed`` against the JAX
package's on zoo pairs whose decoder takes ``use_softmax``:
resnet18dilated (full width, it is small) under C1 here and in
``test_torch_eval_zoo_closed.py`` (``test_closed``, which scores msp), and
under ``upernet_lite`` in ``test_torch_eval_zoo_upernet.py``: one case per
file keeps each file's JAX compiles within a few seconds.

Both CLIs build their models from the config, so both ask for the
softmax at inference (the JAX package's inference CLIs build with
``use_softmax=True``) and the 2-level pyramid averages probabilities. The
port's seeded weights go to a ``.pth`` pair that both CLIs load, the
JAX one through its own reader of the reference's checkpoints. Each
image's conf map and prediction is recorded from both evaluators, and the
summaries are compared. The tolerances are ``test_torch_eval.py``'s: conf
maps atol 1e-4, predictions equal on 99.9 % of pixels, metrics within
1e-3.
"""

import numpy as np
import torch

from open_world_semantic_segmentation_tpu.cli import eval_ood as jax_eval_ood
from open_world_semantic_segmentation_tpu.cli import (
    test_closed as jax_test_closed)
from open_world_semantic_segmentation_tpu.core.config import (
    load_config as jax_load_config)
from open_world_semantic_segmentation_tpu.openset.evaluator import (
    OODEvaluator as JaxOODEvaluator)
from open_world_semantic_segmentation_tpu_torch.cli import (
    eval_ood, test_closed)
from open_world_semantic_segmentation_tpu_torch.cli._common import (
    build_anomaly_model, init_or_load_variables)
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.openset.evaluator import (
    OODEvaluator)
from test_torch_eval import METRICS, street_tree  # noqa: F401

N_IMAGES = 2
CLIS = {"eval_ood": (eval_ood, jax_eval_ood),
           "test_closed": (test_closed, jax_test_closed)}
# Dissum is not compared: on a softmax decoder the negative sum of the
# probabilities is -1 up to rounding, in both packages, and its min-max
# normalised map holds only that rounding

def _opts(root, odgt, decoder, method, enc_path="", dec_path=""):
    return ["DATASET.root_dataset", root, "DATASET.list_val", odgt,
            "DATASET.imgSizes", "(32, 48)", "MODEL.arch_encoder",
            "resnet18dilated", "MODEL.arch_decoder", decoder,
            "MODEL.fc_dim", "512", "MODEL.weights_encoder", enc_path,
            "MODEL.weights_decoder", dec_path, "OOD.ood", method]


def _recording(monkeypatch, cls):
    """Every ``evaluate_item`` result of ``cls``, in order."""
    seen, evaluate_item = [], cls.evaluate_item

    def record(self, item):
        out = evaluate_item(self, item)
        seen.append({"conf": np.asarray(out["conf"]),
                     "pred": np.asarray(out["pred"])})
        return out

    monkeypatch.setattr(cls, "evaluate_item", record)
    return seen


def check_cli_case(street_tree, tmp_path, monkeypatch, cli, decoder,
                   method):
    """``cli``'s main in both packages on the same weights and tree:
    every image's conf map and prediction, and the summary's metrics."""
    root, odgt = street_tree
    cfg = load_config("configs/test_ood_street.yaml",
                      _opts(root, odgt, decoder, method))
    model = init_or_load_variables(cfg, build_anomaly_model(cfg, "cpu"),
                                   seed=3)
    enc_path, dec_path = str(tmp_path / "enc.pth"), str(tmp_path / "dec.pth")
    torch.save(model.encoder.state_dict(), enc_path)
    torch.save(model.decoder.state_dict(), dec_path)
    # test_closed writes its prediction PNGs under TEST.result
    opts = _opts(root, odgt, decoder, method, enc_path, dec_path) + [
        "TEST.result", str(tmp_path / "result")]

    port_main, jax_main = CLIS[cli]
    got_items = _recording(monkeypatch, OODEvaluator)
    want_items = _recording(monkeypatch, JaxOODEvaluator)
    got = port_main.main(load_config("configs/test_ood_street.yaml", opts),
                         max_images=N_IMAGES, device="cpu")
    want = jax_main.main(jax_load_config("configs/test_ood_street.yaml",
                                         opts), max_images=N_IMAGES)

    assert got["images"] == len(got_items) == len(want_items) == N_IMAGES
    for g, w in zip(got_items, want_items):
        assert np.isfinite(g["conf"]).all() and np.isfinite(w["conf"]).all()
        np.testing.assert_allclose(g["conf"], w["conf"], atol=1e-4)
        assert g["conf"].min() < g["conf"].max()
        assert (g["pred"] == w["pred"]).mean() >= 0.999
    for key in METRICS:
        assert np.isfinite(got[key]), key
        assert abs(got[key] - want[key]) <= 1e-3, key


def test_eval_ood_c1_matches_jax(street_tree, tmp_path, monkeypatch):
    check_cli_case(street_tree, tmp_path, monkeypatch, "eval_ood", "c1",
                   "msp")
