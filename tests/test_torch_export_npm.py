"""The port's NPM artifact (``core/export.py``) and what the exporter
refuses, against the JAX package.

The NPM export (the prototype a runtime input) of the DeepLab twin of
``test_torch_deeplab.py`` is held to the JAX package's
``export_npm_eval_fn`` on the same weights, float32 on the CPU at 32x48.
The fused route, ``--quant`` other than ``off`` and an artifact that names
no device are refused.

Tolerances: labels equal on >= 99 % of pixels; the NPM distance map within
2e-3 of its largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.core import export as jax_export
from open_world_semantic_segmentation_tpu_torch.cli import (artifacts,
                                                            export_model)
from open_world_semantic_segmentation_tpu_torch.core import export
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
import test_torch_deeplab as deeplab_twin
# variables: test_torch_export.py's module fixture
from test_torch_export import (SIZE, _images, _jax_roundtrip, _roundtrip,
                               port_twin, variables)


def test_npm_artifact_matches_jax(tmp_path):
    """The prototype is a runtime input: two prototypes through one
    artifact, each against the JAX artifact."""
    variables = deeplab_twin.twin_variables(3)
    model = deeplab_twin.port_twin_from(variables)
    blob, feat_dim = export.export_npm_eval_fn(model, SIZE, batch=1)
    jblob, jfeat_dim = jax_export.export_npm_eval_fn(
        deeplab_twin.jax_twin(), variables, SIZE, batch=1)
    assert feat_dim == jfeat_dim
    fn, _, _ = _roundtrip(tmp_path, blob, {"npm": True})
    jax_fn = _jax_roundtrip(tmp_path, jblob)
    (x,) = _images([SIZE], seed=3, batch=1)
    with torch.no_grad():
        _, _, feats = model(torch.from_numpy(x))
    overrides = 0
    for proto in (feats[0, 5, 7].numpy() + 0.05,
                  np.random.default_rng(4).standard_normal(
                      feat_dim).astype(np.float32)):
        pred, dis = (t.numpy() for t in fn(torch.from_numpy(x),
                                           torch.from_numpy(proto)))
        jpred, jdis = (np.asarray(t) for t in jax_fn(jnp.asarray(x),
                                                      jnp.asarray(proto)))
        assert pred.dtype == np.uint8 and dis.dtype == np.float16
        assert (pred == jpred).mean() >= 0.99
        scale = float(np.abs(jdis.astype(np.float32)).max())
        np.testing.assert_allclose(dis.astype(np.float32),
                                   jdis.astype(np.float32),
                                   atol=2e-3 * scale)
        overrides += int((pred == 16).sum())
    assert overrides > 0


def test_fused_route_cannot_be_exported(variables):
    fused = port_twin(variables, fused_blocks=True)
    with pytest.raises(ValueError, match="torch.export cannot trace"):
        export.export_eval_fn(fused, SIZE)


@pytest.mark.parametrize("kw", [{"quant": "int8"}], ids=["quant"])
def test_export_refuses(kw, tmp_path):
    """The NPM pipeline has no int8 mode (the JAX exporter's --quant
    applies to the StreetHazards model); the quantized StreetHazards export
    is held in ``test_torch_quant_serve.py``."""
    cfg = load_config("configs/test_ood_street.yaml")
    with pytest.raises(ValueError, match="no --quant"):
        export_model.main(cfg, torch.float32, *SIZE, device="cpu",
                          out=str(tmp_path / "x.owss"), npm=True, **kw)


def test_artifact_without_platforms_is_refused(tmp_path):
    """No silent CPU default: an artifact whose metadata names no device
    is neither loaded nor run, and ``check`` reports it invalid."""
    path = str(tmp_path / "p.owss")
    export.save_exported(path, b"payload", {"model": "m", "input": [1]})
    meta = export.read_meta(path)
    for call in (lambda: export.artifact_device(meta),
                 lambda: export.artifact_device(meta, "cpu"),
                 lambda: export.load_exported(path)):
        with pytest.raises(ValueError, match="names no 'platforms'"):
            call()
    report = artifacts.check_artifact(path, run=True)
    assert not report["runs_here"] and "ran_on_zeros" not in report
    assert "missing meta key 'platforms'" in report["problems"]
    assert not report["valid"]
