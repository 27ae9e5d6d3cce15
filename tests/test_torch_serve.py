"""The port's HTTP segmentation server against the JAX package's.

Both servers serve the StreetHazards eval model (resnet50dilated +
ppm_deepsup_embedding, 13 classes) at 32x48 in float32 on the CPU, with the
same weights: the port model's seeded weights with a data-dependent start
(BN statistics from one batch, the embedding scaled to the one-hot centers'
scale, so dis_sum does not clip everywhere), written as the reference's
encoder/decoder ``.pth`` pair, which the JAX server loads. One JAX server
for the module.

Tolerances: labels equal on >= 99 % of pixels (fp32 convs summed in
another order can flip near-ties); float16 conf maps within 2e-3, NaN
where the other's is NaN.
"""

import io
import json
import struct
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from open_world_semantic_segmentation_tpu.cli import serve as jax_serve
from open_world_semantic_segmentation_tpu.core.config import (
    load_config as jax_load_config)
from open_world_semantic_segmentation_tpu.data.odgt import (
    device_normalize as jax_device_normalize)
from open_world_semantic_segmentation_tpu.train import convert as jax_convert
from open_world_semantic_segmentation_tpu_torch.cli import serve
from open_world_semantic_segmentation_tpu_torch.cli._common import (
    build_anomaly_model)
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.core.export import (
    MAGIC, save_exported)
from open_world_semantic_segmentation_tpu_torch.data.native import (
    resize_normalize)
from open_world_semantic_segmentation_tpu_torch.data.odgt import (
    device_normalize, img_transform)

SIZE = (32, 48)
PRESET = "configs/test_ood_street.yaml"
LABEL_AGREEMENT = 0.99
CONF_ATOL = 2e-3


def write_started_weights(root, seed=0):
    """The eval model's seeded weights (PyTorch's default initialisation)
    with a data-dependent start, saved as the reference's .pth pair;
    returns the two paths."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        model = build_anomaly_model(load_config(PRESET), "cpu")
    # a batch of what the tests serve, decoded as the server does
    x = torch.from_numpy(np.stack([
        resize_normalize(np.random.default_rng(seed + i).integers(
            0, 255, (60, 90, 3), dtype=np.uint8), SIZE) for i in range(8)]))
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None          # running stats = this batch's
    with torch.no_grad():
        model.train()(x, seg_size=SIZE)
        std = model.eval()(x, seg_size=SIZE)["ft"].std().item()
        head = model.decoder.conv_last[4]
        head.weight.mul_(0.8 / std)
        head.bias.mul_(0.8 / std)
    paths = [str(root / f"{part}.pth") for part in ("encoder", "decoder")]
    torch.save(model.encoder.state_dict(), paths[0])
    torch.save(model.decoder.state_dict(), paths[1])
    return paths


def _weights_opts(weights):
    return ["MODEL.weights_encoder", weights[0],
            "MODEL.weights_decoder", weights[1]]


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_started_weights(tmp_path_factory.mktemp("weights"))


@pytest.fixture(scope="module")
def cfg(weights):
    return load_config(PRESET, _weights_opts(weights))


@pytest.fixture(scope="module")
def jax_server(weights):
    """The JAX server on the .pth pair, converted by the JAX package's own
    converter as its ``init_or_load_variables`` does, without the flax
    init that it runs first (seconds of compilation here)."""
    def load(cfg, model, example_img, **kw):
        conv = jax_convert.convert_segmentation_model(
            *map(jax_convert.load_torch_checkpoint, weights))
        return {"params": conv["params"],
                "batch_stats": conv["batch_stats"]}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_serve, "init_or_load_variables", load)
        srv = jax_serve.serve(
            jax_load_config(PRESET, _weights_opts(weights)), jnp.float32,
            port=0, height=SIZE[0], width=SIZE[1])
    yield _start(srv), srv
    srv.shutdown()


def _port_server(cfg, **kw):
    return serve.serve(cfg, torch.float32, port=0, height=SIZE[0],
                       width=SIZE[1], device="cpu", **kw)


@pytest.fixture(scope="module")
def port_server(cfg):
    srv = _port_server(cfg)
    yield _start(srv), srv
    srv.shutdown()


def _image_bytes(seed, size=(60, 90), fmt="PNG"):
    arr = np.random.default_rng(seed).integers(0, 255, (*size, 3),
                                               dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def _post(url, data, path="/segment"):
    req = urllib.request.Request(url + path, data=data, method="POST")
    with urllib.request.urlopen(req) as r:
        return r.headers["Content-Type"], r.read()


def _segment(url, data, scores=False):
    ctype, body = _post(url, data,
                        "/segment?scores=dissum" if scores else "/segment")
    if scores:
        assert ctype == "application/octet-stream"
        return np.load(io.BytesIO(body))
    assert ctype == "image/png"
    return np.array(Image.open(io.BytesIO(body)))


def assert_labels_agree(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    assert (got == want).mean() >= LABEL_AGREEMENT


def assert_conf_close(got, want):
    assert got.shape == want.shape
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert not np.isnan(got).all()
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=CONF_ATOL)


def test_healthz_and_metrics(port_server):
    url, _ = port_server
    with urllib.request.urlopen(url + "/healthz") as r:
        body = json.loads(r.read())
    assert body == {"status": "ok",
                    "model": "resnet50dilated+ppm_deepsup_embedding",
                    "input": list(SIZE)}
    with urllib.request.urlopen(url + "/metrics") as r:
        metrics = json.loads(r.read())
    assert metrics["warmed_batch_sizes"] == [1]
    for key in ("requests", "errors", "batches", "latency_ms_avg",
                "latency_ms_max"):
        assert key in metrics


@pytest.mark.parametrize("scores", [False, True], ids=["png", "dissum"])
def test_segment_matches_jax(port_server, jax_server, scores):
    for seed, fmt in ((0, "PNG"), (1, "JPEG")):
        data = _image_bytes(seed, fmt=fmt)
        got = _segment(port_server[0], data, scores)
        want = _segment(jax_server[0], data, scores)
        if scores:
            assert_conf_close(got, want)
        else:
            assert_labels_agree(got, want)


def test_device_input_matches_jax(cfg, jax_server):
    """--device-input: the uint8 resize shipped and normalised on the
    device; the JAX side runs the same uint8 image through its
    device_normalize and its served forward."""
    srv = _port_server(cfg, device_input=True)
    url = _start(srv)
    try:
        data = _image_bytes(2)
        img = Image.open(io.BytesIO(data)).convert("RGB")
        u8 = np.asarray(img.resize((SIZE[1], SIZE[0]), Image.BILINEAR),
                        np.uint8)
        # the normalisation is img_transform's, bit for bit
        np.testing.assert_array_equal(
            device_normalize(torch.from_numpy(u8.copy())).numpy(),
            img_transform(Image.fromarray(u8)))
        np.testing.assert_array_equal(
            device_normalize(torch.from_numpy(u8.copy())).numpy(),
            np.asarray(jax_device_normalize(jnp.asarray(u8))))
        preds, confs = _jax_segmenter(jax_server)._run_batch(
            [np.asarray(jax_device_normalize(jnp.asarray(u8)))])
        assert_labels_agree(_segment(url, data), preds[0])
        assert_conf_close(_segment(url, data, scores=True), confs[0])
    finally:
        srv.shutdown()


def _jax_segmenter(jax_server):
    """The JAX server's Segmenter, from its handler's closure."""
    _, srv = jax_server
    handler = srv.RequestHandlerClass
    cell = next(c for c in handler.do_POST.__closure__
                if isinstance(c.cell_contents, jax_serve.Segmenter))
    return cell.cell_contents


def test_stream_equals_single_requests(port_server):
    url, _ = port_server
    frames = [_image_bytes(10 + i) for i in range(3)]
    for scores in (False, True):
        body = b"".join(struct.pack(">I", len(f)) + f for f in frames)
        _, out = _post(url, body + struct.pack(">I", 0),
                       "/stream?scores=dissum" if scores else "/stream")
        results, pos = [], 0
        while pos < len(out):
            (n,) = struct.unpack(">I", out[pos:pos + 4])
            results.append(out[pos + 4:pos + 4 + n])
            pos += 4 + n
        assert len(results) == 3
        for frame, res in zip(frames, results):
            single = _segment(url, frame, scores)
            if scores:
                np.testing.assert_array_equal(np.load(io.BytesIO(res)),
                                              single)
            else:
                np.testing.assert_array_equal(
                    np.array(Image.open(io.BytesIO(res))), single)


def test_microbatched_equals_batch_one(cfg, port_server):
    """max_batch=4 under 4 concurrent clients answers what batch 1 does;
    a padded image's conf does not move with what else is in its batch
    (min and max are taken per image)."""
    srv = _port_server(cfg, max_batch=4, batch_wait_ms=200.0)
    url = _start(srv)
    seg = srv.segmenter
    try:
        frames = [_image_bytes(20 + i) for i in range(4)]
        want = [(_segment(port_server[0], f),
                 _segment(port_server[0], f, True)) for f in frames]
        got = [None] * 4

        def client(i):
            got[i] = (_segment(url, frames[i]),
                      _segment(url, frames[i], True))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for (gl, gc), (wl, wc) in zip(got, want):
            assert_labels_agree(gl, wl)
            assert_conf_close(gc, wc)
        metrics = seg.metrics()
        assert metrics["requests"] == 8 and metrics["batches"] < 8
        arrs = [seg._decode(f) for f in frames[:3]]
        _, alone = seg._run_batch(arrs[:1])
        _, padded = seg._run_batch(arrs)        # 3 images padded to 4
        assert_conf_close(padded[0], alone[0])
        assert seg._batch_sizes == [1, 2, 4]
    finally:
        srv.shutdown()


def test_forward_off_the_main_thread_keeps_dtype_and_no_grad(cfg):
    """Autocast and grad mode are per thread: the warm-up thread and the
    micro-batch collector must run the model in its dtype (bf16 here)
    without grad, as the main thread does."""
    seen = []
    seg = serve.Segmenter(cfg, torch.bfloat16, *SIZE, max_batch=2,
                          device="cpu")
    while seg.warmed != [1, 2]:     # the server's own warm-up thread
        time.sleep(0.01)
    seg.model.decoder.register_forward_hook(
        lambda m, args, out: seen.append(
            (threading.current_thread().name, out["scores"].dtype,
             torch.is_grad_enabled(), out["scores"].requires_grad)))
    # batch 2 warmed again on a thread of its own, as the warm-up thread
    # does; a request through the collector; one forward on this thread
    warm = threading.Thread(target=seg._warm, args=(2,), name="warm-up")
    warm.start()
    warm.join()
    _, conf = seg.segment(_image_bytes(31))
    seg._run_batch([seg._decode(_image_bytes(30))])
    assert [s[0] for s in seen] == ["warm-up", "owss-collector",
                                    "MainThread"]
    for _, dtype, grad, requires_grad in seen:
        assert dtype == torch.bfloat16 and not grad and not requires_grad
    assert conf.dtype == np.float16


def test_malformed_image_is_a_400_and_counted(port_server):
    url, srv = port_server
    before = srv.segmenter.metrics()["errors"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, b"not an image")
    assert e.value.code == 400
    with urllib.request.urlopen(url + "/metrics") as r:
        assert json.loads(r.read())["errors"] == before + 1


@pytest.mark.parametrize("quant", ["int8", "int8-hybrid", "int8-3x3"])
def test_quant_raises(cfg, quant, tmp_path):
    """Every int8 mode serves (``test_torch_quant_serve.py``), but refuses
    to calibrate on white noise when --calib-glob matches no file; an
    unknown mode raises, as the JAX server's argument parser does."""
    with pytest.raises(FileNotFoundError, match="matched no files"):
        serve.Segmenter(cfg, torch.float32, *SIZE, quant=quant,
                        device="cpu", calib_glob=str(tmp_path / "x*.png"))
    with pytest.raises(ValueError, match="choose from"):
        serve.Segmenter(cfg, torch.float32, *SIZE, quant=quant + "x",
                        device="cpu")


@pytest.mark.parametrize("meta", [{"pyramid": True}, {"method": "none"},
                                  {"npm": True}],
                         ids=["pyramid", "method-none", "npm"])
def test_artifact_meta_checks_raise_as_in_jax(tmp_path, meta):
    """The header is checked before the payload is read: the payload here
    is not a program at all."""
    from open_world_semantic_segmentation_tpu.core.export import (
        save_exported as jax_save_exported)

    port_path, jax_path = str(tmp_path / "p.owss"), str(tmp_path / "j.owss")
    save_exported(port_path, b"no payload", meta)
    jax_save_exported(jax_path, b"no payload", meta)
    with pytest.raises(ValueError) as want:
        jax_serve.Segmenter(None, jnp.float32, *SIZE, artifact=jax_path)
    with pytest.raises(ValueError) as got:
        serve.Segmenter(None, torch.float32, *SIZE, artifact=port_path,
                        device="cpu")
    assert str(got.value) == str(want.value)
    with open(port_path, "rb") as f:
        assert f.read(len(MAGIC)) == MAGIC


def test_device_input_with_artifact_raises_as_in_jax(tmp_path):
    with pytest.raises(ValueError) as want:
        jax_serve.Segmenter(None, jnp.float32, *SIZE, device_input=True,
                            artifact="x.owss")
    with pytest.raises(ValueError) as got:
        serve.Segmenter(None, torch.float32, *SIZE, device_input=True,
                        artifact="x.owss", device="cpu")
    assert str(got.value) == str(want.value)
