"""``--quant`` on the port's server and exporter (``cli/serve.py``,
``cli/export_model.py``), float32 on the CPU at 32x48.

The config's model is replaced by the narrow twin of
``test_torch_quant_model.py`` (resnet18dilated-like BasicBlock body at
output stride 8, PPM embedding decoder at fc_dim 64) with seeded weights
whose embedding is scaled to a std of 0.8, so that dissum has values;
``calibrate_for_quant`` builds its ``calib`` twin through the same hook.
Calibration reads the PNG files ``--calib-glob`` matches:

- the server under ``int8-hybrid`` holds a prequantized model (int8
  weights in layers 2-4, the PPM branches and the fuse conv) and answers
  as a direct forward of that model does: labels equal on 99 % of
  pixels, float16 dissum maps within 2e-3;
- a glob that matches nothing raises instead of calibrating on noise;
- the exporter's ``--quant int8`` artifact says ``quant: int8`` in its
  header, carries int8 weight constants and the calibrated scales, and
  after a save and load runs as the live quantized model calibrated on the
  same files: labels on 99 %, dissum within 2e-3.
"""

import glob
import os

import numpy as np
import pytest
import torch
from PIL import Image

from open_world_semantic_segmentation_tpu_torch.cli import (
    _common, export_model, serve)
from open_world_semantic_segmentation_tpu_torch.core import export
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.openset.scoring import (
    dissum_conf)
from test_torch_quant_model import port_twin

SIZE = (32, 48)
PRESET = "configs/test_ood_street.yaml"


def _seeded_state():
    model = port_twin()
    torch.manual_seed(0)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            torch.nn.init.kaiming_normal_(m.weight)
    x = torch.randn(2, *SIZE, 3)
    with torch.no_grad():
        std = model(x, seg_size=SIZE)["ft"].std().item()
        head = model.decoder.conv_last[4]
        head.weight.mul_(0.8 / std)
        head.bias.mul_(0.8 / std)
    return model.state_dict()


@pytest.fixture(scope="module")
def state():
    return _seeded_state()


@pytest.fixture
def twin(state, monkeypatch):
    """The twin in place of the config's model, in every module that
    builds one; its seeded weights in place of the config's."""
    def build(cfg, device=None, fused_blocks=False, train=False,
              use_softmax=False, quant="off"):
        return port_twin(quant)

    def load(cfg, model, **kw):
        model.load_state_dict(state)
        return model

    for mod in (_common, serve, export_model):
        monkeypatch.setattr(mod, "build_anomaly_model", build)
    for mod in (serve, export_model):
        monkeypatch.setattr(mod, "init_or_load_variables", load)
    return build, load


@pytest.fixture(scope="module")
def calib_glob(tmp_path_factory):
    root = tmp_path_factory.mktemp("calib")
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (40, 60, 3), dtype=np.uint8)
                        ).save(str(root / f"cal_{i}.png"))
    return str(root / "cal_*.png")


def _frames(n=2, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (*SIZE, 3), dtype=np.uint8)
            for _ in range(n)]


def _direct(model, arrs):
    """labels and dissum of ``model`` on the server's decoded inputs."""
    x = torch.from_numpy(np.stack(arrs))
    with torch.no_grad():
        scores = model(x, seg_size=SIZE)["scores"]
    conf = torch.stack([dissum_conf(s) for s in scores]).half().numpy()
    return scores.argmax(-1).numpy(), conf


def _assert_agree(pred, conf, want_pred, want_conf):
    assert (pred == want_pred).mean() >= 0.99
    assert np.isfinite(conf).all() and conf.min() < conf.max()
    assert np.abs(conf.astype(np.float32)
                  - want_conf.astype(np.float32)).max() <= 2e-3


def test_server_int8_hybrid(twin, calib_glob):
    cfg = load_config(PRESET)
    seg = serve.Segmenter(cfg, torch.float32, *SIZE, quant="int8-hybrid",
                          device="cpu", calib_glob=calib_glob)
    int8 = [n for n, p in seg.model.named_parameters()
            if p.dtype == torch.int8]
    assert any(n.startswith("encoder.layer4") for n in int8)
    assert "decoder.conv_last.0.weight" in int8
    assert not any(n.startswith(("encoder.layer1", "encoder.conv"))
                   for n in int8)
    for frame in _frames():
        arr = seg.resize_normalize(frame, SIZE)     # as the server decodes
        pred, conf = seg._run_batch([arr])
        _assert_agree(pred, conf, *_direct(seg.model, [arr]))


def test_server_refuses_empty_calib_glob(twin, tmp_path):
    with pytest.raises(FileNotFoundError, match="matched no files"):
        serve.Segmenter(load_config(PRESET), torch.float32, *SIZE,
                        quant="int8", device="cpu",
                        calib_glob=str(tmp_path / "none_*.png"))


def test_int8_artifact_runs_as_the_live_model(twin, calib_glob, tmp_path,
                                              state):
    build, load = twin
    path = export_model._entry([
        "--cfg", PRESET, "--device", "cpu", "--precision", "fp32",
        "--height", str(SIZE[0]), "--width", str(SIZE[1]),
        "--quant", "int8", "--calib-glob", calib_glob,
        "--out", str(tmp_path / "q.owss")])
    assert export.read_meta(path)["quant"] == "int8"
    program, _ = export.read_program(path)
    tensors = {**program.state_dict, **program.constants}
    assert any(t.dtype == torch.int8 for t in tensors.values())
    assert any(k.endswith("amax") for k in tensors)
    fn, _ = export.load_exported(path)

    live = load(None, build(None, quant="int8"))
    _common.calibrate_for_quant(load_config(PRESET), live, SIZE,
                                use_softmax=True, calib_glob=calib_glob,
                                quant="int8")
    x = np.stack([np.random.default_rng(9).standard_normal(
        (*SIZE, 3)).astype(np.float32)])
    pred, conf = (t.numpy() for t in fn(torch.from_numpy(x)))
    with torch.no_grad():
        scores = live(torch.from_numpy(x), seg_size=SIZE)["scores"]
    want_conf = torch.stack([dissum_conf(s) for s in scores]).half().numpy()
    _assert_agree(pred, conf, scores.argmax(-1).numpy(), want_conf)
    assert sorted(glob.glob(calib_glob)) and os.path.exists(path)
