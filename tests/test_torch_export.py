"""The port's AOT export (``core/export.py``, ``cli/export_model.py``,
``cli/artifacts.py``) against the JAX package's.

A narrow twin of the StreetHazards eval model (``test_torch_model.py``'s
backbone; the PPM embedding decoder with one pool scale, which keeps the
artifacts small) carries the same weights in both packages, float32 on the
CPU at 32x48: seeded in the port and converted by the JAX package's own
converter, so no flax init runs. The embedding head is scaled so that
dis_sum does not clip everywhere. Each port artifact goes through a save
and load round trip and is held to the port's direct forward and to the
JAX artifact of the same weights (``jax.export``, run on the CPU).

Tolerances: labels equal on >= 99 % of pixels; float16 conf maps within
2e-3 (NaN where the other's is NaN). The bf16 artifact is held to the
port's direct bf16 forward under autocast. The pyramid artifact is held in
``test_torch_export_pyramid.py``, the NPM artifact in
``test_torch_export_npm.py``, the artifact zoo's CLI in
``test_torch_artifacts.py``: each file stays within 20 s on one worker.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.core import export as jax_export
from open_world_semantic_segmentation_tpu.models.builder import (
    SegmentationModel as JaxSegmentationModel)
from open_world_semantic_segmentation_tpu.models.decoders import (
    PPMDeepsupEmbedding as JaxPPMDeepsupEmbedding)
from open_world_semantic_segmentation_tpu.models.resnet import (
    Bottleneck as JaxBottleneck, ResNet as JaxResNet)
from open_world_semantic_segmentation_tpu.train import convert as jax_convert
from open_world_semantic_segmentation_tpu_torch.cli import (
    artifacts, export_model)
from open_world_semantic_segmentation_tpu_torch.core import export
from open_world_semantic_segmentation_tpu_torch.models.builder import (
    SegmentationModel)
from open_world_semantic_segmentation_tpu_torch.models.decoders import (
    PPMDeepsupEmbedding)
from open_world_semantic_segmentation_tpu_torch.models.resnet import (
    Bottleneck, ResNet)
from open_world_semantic_segmentation_tpu_torch.openset.scoring import (
    dissum_conf)
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    state_dict_from_jax)
from test_torch_model import TWIN
from test_torch_serve import assert_conf_close, assert_labels_agree

SIZE = (32, 48)
DECODER = dict(num_class=13, fc_dim=256, pool_scales=(1,))


def jax_twin():
    return JaxSegmentationModel(
        encoder=JaxResNet(block=JaxBottleneck, **TWIN),
        decoder=JaxPPMDeepsupEmbedding(**DECODER))


def _port_module(fused_blocks=False):
    return SegmentationModel(
        ResNet(block=Bottleneck, fused_blocks=fused_blocks, **TWIN),
        PPMDeepsupEmbedding(**DECODER)).eval()


def port_twin(variables, fused_blocks=False):
    model = _port_module(fused_blocks)
    enc, dec = state_dict_from_jax(variables)
    model.encoder.load_state_dict(enc)
    model.decoder.load_state_dict(dec)
    return model


def seed_weights(model, seed):
    """Fill ``model``'s parameters and BN statistics from a numpy seed as
    ``test_torch_model.fill_jax_variables`` fills a JAX tree: conv weights
    he-normal over fan_in, BN weight and running variance uniform in
    [0.5, 1.5), biases and running means normal times 0.1."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "num_batches_tracked":
                continue
            if t.dim() > 1:
                v = rng.standard_normal(t.shape) * np.sqrt(
                    2.0 / np.prod(t.shape[1:]))
            elif leaf in ("weight", "running_var"):
                v = rng.uniform(0.5, 1.5, t.shape)
            else:
                v = rng.standard_normal(t.shape) * 0.1
            t.copy_(torch.from_numpy(v.astype(np.float32)))


@pytest.fixture(scope="module")
def variables():
    """The twin's seeded weights, the embedding scaled to std 0.8 (the
    one-hot centers' scale) on the test images, as the JAX variables the
    JAX package's converter makes of the port's state dicts."""
    model = _port_module()
    seed_weights(model, 7)
    with torch.no_grad():
        ft = model(torch.from_numpy(_images([SIZE])[0]), seg_size=SIZE)["ft"]
        scale = 0.8 / ft.std().item()
        model.decoder.conv_last[4].weight.mul_(scale)
        model.decoder.conv_last[4].bias.mul_(scale)

    def arrays(module):
        return {k: v.numpy() for k, v in module.state_dict().items()}
    return jax_convert.convert_segmentation_model(arrays(model.encoder),
                                                  arrays(model.decoder))


@pytest.fixture(scope="module")
def model(variables):
    return port_twin(variables)


def cli_export(root, model, name, *opts):
    """``cli/export_model`` at 32x48, batch 2, float32 on the CPU, with the
    twin in place of the config's model (it carries its weights); returns
    the artifact's path."""
    argv = ["--cfg", "configs/test_ood_street.yaml", "--device", "cpu",
            "--precision", "fp32", "--height", str(SIZE[0]),
            "--width", str(SIZE[1]), "--batch", "2",
            "--out", str(root / name), *opts]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(export_model, "build_anomaly_model",
                   lambda cfg, device, **kw: model)
        mp.setattr(export_model, "init_or_load_variables",
                   lambda cfg, m: m)
        return export_model._entry(argv)


def _images(shapes, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, h, w, 3)).astype(np.float32)
            for h, w in shapes]


def _roundtrip(tmp_path, blob, meta=None):
    path = str(tmp_path / "m.owss")
    export.save_exported(path, blob, {"platforms": ["cpu"], **(meta or {})})
    fn, meta = export.load_exported(path)
    return fn, meta, path


def _jax_roundtrip(tmp_path, blob):
    path = str(tmp_path / "j.owss")
    jax_export.save_exported(path, blob)
    return jax_export.load_exported(path)[0]


def _direct(model, pyramid, dtype=torch.float32):
    """The exported computation, written out: scores summed in the model
    dtype and divided once in float32, per-image dissum."""
    with torch.no_grad(), torch.autocast(
            "cpu", dtype=dtype, enabled=dtype != torch.float32):
        scores = None
        for x in pyramid:
            s = model(torch.from_numpy(x), seg_size=SIZE)["scores"]
            scores = s if scores is None else scores + s
    scores = scores.float() / len(pyramid)
    conf = torch.stack([dissum_conf(s) for s in scores])
    return scores.argmax(-1).numpy().astype(np.uint8), \
        conf.half().numpy()


def check_against_direct_and_jax(tmp_path, fn, model, variables, shapes):
    """The loaded artifact ``fn`` on a batch of 2 at each pyramid shape,
    against the direct forward and the JAX artifact of the same weights;
    returns the labels."""
    pyramid = _images(shapes)
    pred, conf = (t.numpy() for t in fn(*map(torch.from_numpy, pyramid)))
    want_pred, want_conf = _direct(model, pyramid)
    assert_labels_agree(pred, want_pred)
    assert_conf_close(conf, want_conf)

    jax_fn = _jax_roundtrip(tmp_path, jax_export.export_pyramid_eval_fn(
        jax_twin(), variables, shapes, SIZE, batch=2))
    jpred, jconf = jax_fn(*map(jnp.asarray, pyramid))
    assert_labels_agree(pred, np.asarray(jpred))
    assert_conf_close(conf, np.asarray(jconf))
    return pred, pyramid


@pytest.mark.parametrize("kind", ["plain"])
def test_artifact_matches_direct_forward_and_jax(tmp_path, model,
                                                 variables, kind):
    fn, meta = export.load_exported(cli_export(tmp_path, model,
                                               f"{kind}.owss"))
    assert meta["input"] == [2, *SIZE, 3] and not meta["pyramid"]
    check_against_direct_and_jax(tmp_path, fn, model, variables, [SIZE])


def test_bf16_artifact_runs_under_autocast(tmp_path, model):
    blob = export.export_eval_fn(model, SIZE, method="dissum",
                                 dtype=torch.bfloat16)
    fn, _, _ = _roundtrip(tmp_path, blob)
    (x,) = _images([SIZE], seed=1, batch=1)
    pred, conf = (t.numpy() for t in fn(torch.from_numpy(x)))
    want_pred, want_conf = _direct(model, [x], torch.bfloat16)
    assert_labels_agree(pred, want_pred)
    assert_conf_close(conf, want_conf)


def test_read_meta_reads_only_the_header(tmp_path, monkeypatch):
    path = str(tmp_path / "h.owss")
    export.save_exported(path, b"\x00not a program", {"model": "m"})
    monkeypatch.setattr(torch.export, "load", None)    # never reached
    meta = export.read_meta(path)
    assert meta["model"] == "m" and meta["format"] == 1
    assert meta["owss_version"] == "0.1.0"
    assert meta["torch_version"] == torch.__version__
    assert artifacts.list_artifacts(path)[0]["model"] == "m"


def test_jax_artifact_is_refused(tmp_path):
    path = str(tmp_path / "j.owss")
    jax_export.save_exported(path, b"stablehlo", {"model": "m"})
    for read in (export.read_meta, export.load_exported,
                 export.read_program):
        with pytest.raises(ValueError, match="JAX StableHLO artifact"):
            read(path)
    other = str(tmp_path / "x.owss")
    with open(other, "wb") as f:
        f.write(b"something else\n")
    with pytest.raises(ValueError, match="not an OWSS export artifact"):
        export.read_meta(other)


def test_validate_meta_problems():
    assert artifacts.validate_meta({"format": 2, "npm": True}) == [
        "unknown format 2", "missing meta key 'owss_version'",
        "missing meta key 'torch_version'", "missing meta key 'model'",
        "missing meta key 'input'", "missing meta key 'platforms'",
        "npm artifact missing 'prototype_dim'",
        "npm artifact missing 'novel_id'",
        "npm artifact missing 'dis_threshold'"]
    assert artifacts.validate_meta({
        "format": 1, "owss_version": "0", "torch_version": "0", "model": "m",
        "input": [1, 2, 3, 3], "platforms": ["cpu"], "pyramid": True}) == [
        "missing meta key 'method'",
        "pyramid 'input' must be a list of shapes"]
