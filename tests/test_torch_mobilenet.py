"""MobileNetV2 in the port against the JAX package's: the CSAIL
``mobilenetv2dilated`` encoder under ``c1_deepsup`` at inference (the
method and tolerances of ``test_torch_zoo.py``), and one training step of
the same pair in train mode (batch statistics in every BN): the training
forward's scores and deep-supervision output within 1e-4 of their largest
magnitude, the port's
``AnomalyTrainStep`` loss (CE/n + 0.01 VAR/n on the log-softmax scores,
no deep-supervision term, as the CLIs run it) against the JAX package's
on the same weights and batch, within 1e-4; the BN running statistics it
leaves (flax's update) likewise.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from open_world_semantic_segmentation_tpu.models.builder import (
    SegmentationModel as JaxSegmentationModel)
from open_world_semantic_segmentation_tpu.models.decoders import (
    C1DeepSup as JaxC1DeepSup)
from open_world_semantic_segmentation_tpu.models.mobilenet import (
    MobileNetV2Dilated as JaxMobileNetV2Dilated)
from open_world_semantic_segmentation_tpu.train import losses as jax_losses
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    state_dict_from_jax)
from open_world_semantic_segmentation_tpu_torch.train.optim import (
    poly_schedule, two_group_optimizer)
from open_world_semantic_segmentation_tpu_torch.train.state import (
    AnomalyTrainStep)
from test_torch_model import fill_jax_variables
from test_torch_zoo import NUM_CLASS, _pair, check_zoo_case


def test_mobilenetv2dilated_matches_jax():
    check_zoo_case("mobilenetv2dilated", "c1_deepsup", False, 40)


def test_mobilenetv2dilated_train_step_matches_jax():
    _, port = _pair("mobilenetv2dilated", "c1_deepsup", False)
    jax_model = JaxSegmentationModel(
        encoder=JaxMobileNetV2Dilated(output_stride=8, train=True),
        decoder=JaxC1DeepSup(num_class=NUM_CLASS, fc_dim=320, train=True))
    rng = np.random.default_rng(41)
    img = rng.standard_normal((2, 48, 64, 3)).astype(np.float32)
    label = rng.integers(0, NUM_CLASS, (2, 6, 8)).astype(np.int32)
    label[rng.random((2, 6, 8)) < 0.15] = -1
    variables = fill_jax_variables(jax_model, img.shape, 42)

    def loss_fn(variables):
        out, mutated = jax_model.apply(variables, jnp.asarray(img),
                                       mutable=["batch_stats"])
        loss, _ = jax_losses.dml_segmentation_loss(
            jax.nn.log_softmax(out["scores"], axis=-1), jnp.asarray(label),
            alpha=0.01)
        return loss, (out, mutated["batch_stats"])

    want, (outs, new_stats) = jax.jit(loss_fn)(variables)

    enc, dec = state_dict_from_jax(variables)
    port.encoder.load_state_dict(enc)
    port.decoder.load_state_dict(dec)
    # the training forward (batch statistics) on a copy: the scores and
    # C1DeepSup's deep-supervision branch off conv4
    with torch.no_grad():
        got = copy.deepcopy(port).train()(torch.from_numpy(img))
    assert set(got) == {"scores", "deepsup"}
    for key in ("scores", "deepsup"):
        w = np.asarray(outs[key])
        assert got[key].shape == w.shape == (2, 6, 8, NUM_CLASS)
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))
    port.train()
    opt = two_group_optimizer(port, lr_encoder=poly_schedule(0.02, 10),
                              lr_decoder=poly_schedule(0.02, 10),
                              momentum=0.9, weight_decay=1e-4)
    step = AnomalyTrainStep(port, opt, alpha=0.01, log_softmax_scores=True,
                            dtype=torch.float32)
    metrics = step({"img_data": torch.from_numpy(img),
                    "seg_label": torch.from_numpy(label).long()})
    np.testing.assert_allclose(float(metrics["loss"]), float(want),
                               rtol=1e-4)
    want_enc, _ = state_dict_from_jax({
        "params": variables["params"],
        "batch_stats": {**variables["batch_stats"], **jax.tree_util.tree_map(
            np.asarray, new_stats)}})
    got = port.encoder.state_dict()
    for key, value in want_enc.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=key)
