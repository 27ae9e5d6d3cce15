"""Data-parallel training over 4 gloo ranks on the CPU, against the JAX
package and against one process on the global batch.

One job of 4 ranks (``tests/torch_ddp_worker.py core``, subprocesses
joined over a ``file://`` store in the test's temporary directory, so
parallel test workers never race for a port) runs every check once and
writes each rank's results before any teardown; ``Ranks`` (there) waits for them
with a hard timeout, kills what is left and fails with each rank's log
tail. The job starts with the module and runs while the tests build
their references; the ones that take longest come first. They check:

- the port's ``BatchNorm2d`` on 4 x 4 samples against flax ``BatchNorm``
  on the 16 (outputs, running mean and variance; float32, rtol 1e-5, atol
  1e-6), and its input, weight and bias gradients against one process's
  (rtol 1e-5, atol 1e-6); ``fix_bn`` normalises globally too, and eval mode
  runs no collective;
- the anomaly and DeepLab losses with uneven ignored pixels per rank
  against the JAX losses on the global batch (float32 sums in another
  order: rtol 1e-6, atol 1e-6); the gradient of the replicated loss on a
  rank is the rank count times its share of the one-process gradient;
- three ``AnomalyTrainStep``s over 4 ranks x 2 against one process x 8 on
  a tiny resnet18dilated + ppm_deepsup_embedding in float64, dropout held
  out (losses rtol 1e-10; every parameter and buffer within 1e-9 of its
  largest magnitude), every rank bit-identical; one ``DeepLabTrainStep``
  on a two-rank subgroup against one process x 4, likewise;
- a non-finite loss on one rank skips the step on every rank;
- ``extract_prototype(group=)`` against the JAX function on the whole
  batch, where ``valid`` flips if the count is per rank;
- the distributed checkpoint, written by the 4 ranks, read back by each
  and by one process, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from open_world_semantic_segmentation_tpu.fewshot.prototypes import (
    extract_prototype as jax_extract_prototype)
from open_world_semantic_segmentation_tpu.train import losses as jax_losses
from open_world_semantic_segmentation_tpu_torch.models.layers import (
    BatchNorm2d)
from open_world_semantic_segmentation_tpu_torch.train.checkpoint import (
    load_checkpoint_distributed)

import torch_ddp_worker as W


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    job = W.Ranks("core", tmp_path_factory.mktemp("ddp"))
    yield job
    job.stop()


def _cat(results, key, field):
    return torch.cat([r[key][field] for r in results]).numpy()


def test_losses_equal_jax_on_the_global_batch(ranks):
    tol = dict(rtol=1e-6, atol=1e-6)
    logits, labels, _ = W.loss_case(-1)
    # the shares differ, so a per-rank mean would not pass
    valid = (labels != -1).reshape(W.WORLD, -1).sum(1)
    assert len(set(valid.tolist())) == W.WORLD

    def dml(lg):
        return jax_losses.dml_segmentation_loss(
            lg, jnp.asarray(labels), alpha=0.5, beta=0.25)

    (want, aux), grad = jax.value_and_grad(dml, has_aux=True)(
        jnp.asarray(logits))
    logits, labels, feats = W.loss_case(255)
    lg, lb = jnp.asarray(logits), jnp.asarray(labels)
    want_deeplab = {
        "deeplab_ce": jax_losses.deeplab_cross_entropy(lg, lb),
        "deeplab_terms": jax_losses.deeplab_cross_entropy(
            lg, lb, jnp.asarray(feats), alpha=0.3, beta=0.2, gamma=0.1,
            use_metric_terms=True),
        "focal": jax_losses.focal_loss(lg, lb, gamma=2.0),
        "pixel_acc": jax_losses.pixel_acc(lg, jnp.where(lb == 255, -1, lb)),
    }
    results = ranks.results()
    for r in results:
        np.testing.assert_allclose(r["dml"]["loss"], float(want), **tol)
        np.testing.assert_allclose(r["dml"]["aux"],
                                   [float(a) for a in aux], **tol)
    # each rank's gradient: the rank count times its share of the
    # one-process gradient (train/state.py averages over the ranks)
    np.testing.assert_allclose(_cat(results, "dml", "grad") / W.WORLD,
                               np.asarray(grad), rtol=1e-5, atol=1e-9)
    for r in results:
        for key, value in want_deeplab.items():
            np.testing.assert_allclose(r[key], float(value), **tol,
                                       err_msg=key)


def _assert_states_close(got, want, frac=1e-9):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if value.is_floating_point():
            scale = float(value.abs().max()) or 1.0
            np.testing.assert_allclose(got[key], value, rtol=0,
                                       atol=frac * scale, err_msg=key)
        else:
            assert torch.equal(got[key], value), key


def _assert_bit_identical(states):
    for state in states[1:]:
        for key, value in states[0].items():
            assert torch.equal(state[key], value), key


def test_anomaly_steps_over_ranks_equal_one_process(ranks):
    model = W.twin(seed=10)                # rank 0's weights
    want = W.run_steps(W.anomaly_step(model),
                       W.anomaly_batches(0, 1))
    results = ranks.results()
    for r in results:
        got = r["anomaly"]["metrics"]
        for g, w in zip(got, want):
            assert not g["skipped"] and not w["skipped"]
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-10)
            np.testing.assert_allclose(g["acc"], w["acc"], rtol=1e-12)
    _assert_states_close(results[0]["anomaly"]["state"], model.state_dict())
    _assert_bit_identical([r["anomaly"]["state"] for r in results])


def test_nonfinite_loss_on_one_rank_skips_the_step_everywhere(ranks):
    for r in ranks.results():
        assert r["nonfinite"]["skipped"] and r["nonfinite"]["kept"]
        assert not np.isfinite(r["nonfinite"]["loss"])


def test_deeplab_step_over_two_ranks_equals_one_process(ranks):
    model = W.deeplab(seed=20)
    want = W.run_steps(W.deeplab_step(model), W.deeplab_batches(0, 1))
    results = ranks.results()
    assert "deeplab" not in results[2] and "deeplab" not in results[3]
    for r in results[:2]:
        for g, w in zip(r["deeplab"]["metrics"], want):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-10)
            np.testing.assert_allclose(g["acc"], w["acc"], rtol=1e-12)
    _assert_states_close(results[0]["deeplab"]["state"], model.state_dict())
    _assert_bit_identical([r["deeplab"]["state"] for r in results[:2]])


def test_batch_norm_equals_flax_on_the_global_batch(ranks):
    x, w = W.bn_case()

    class TinyBN(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.BatchNorm(use_running_average=False,
                                 momentum=1 - W.BN_MOMENTUM, name="bn")(x)

    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    model = TinyBN()
    variables = model.init(jax.random.PRNGKey(0), nhwc)
    y, mut = model.apply(variables, nhwc, mutable=["batch_stats"])
    stats = mut["batch_stats"]["bn"]
    results = ranks.results()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_cat(results, "bn", "y"),
                               np.asarray(y).transpose(0, 3, 1, 2), **tol)
    np.testing.assert_allclose(_cat(results, "bn", "y_fix"),
                               np.asarray(y).transpose(0, 3, 1, 2), **tol)
    for r in results:
        np.testing.assert_allclose(r["bn"]["mean"], stats["mean"], **tol)
        np.testing.assert_allclose(r["bn"]["var"], stats["var"], **tol)
        assert r["bn"]["tracked"] == 1
    # the gradients against one process on the 16 samples
    bn = BatchNorm2d(3, momentum=W.BN_MOMENTUM).train()
    xt = torch.from_numpy(x).requires_grad_(True)
    (bn(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_cat(results, "bn", "grad"), xt.grad, **tol)
    for name, want in (("grad_weight", bn.weight.grad),
                       ("grad_bias", bn.bias.grad)):
        got = sum(r["bn"][name] for r in results)
        np.testing.assert_allclose(got, want, **tol)
    # eval mode: the running statistics, as in one process
    bn.eval()
    np.testing.assert_allclose(_cat(results, "bn", "y_eval"),
                               bn(torch.from_numpy(x)).detach(), **tol)


def test_prototype_over_ranks_equals_jax_on_the_whole_batch(ranks):
    results = ranks.results()
    for case, (feats, labels) in enumerate(W.prototype_cases()):
        proto, valid = jax_extract_prototype(
            jnp.asarray(feats), jnp.asarray(labels), W.NOVEL)
        for r in results:
            got, got_valid = r["prototypes"][case]
            assert got_valid == bool(valid)
            np.testing.assert_allclose(got, np.asarray(proto), rtol=1e-6,
                                       atol=1e-7)
    # the first case: rank 0 alone would call its prototype valid
    local = (W.prototype_cases()[0][1][:W.LOCAL_BATCH] == W.NOVEL).mean()
    assert local > 0.05 and not results[0]["prototypes"][0][1]


def test_distributed_checkpoint_round_trips_across_ranks(ranks):
    want = W.checkpoint_state()
    for r in ranks.results():
        assert r["checkpoint"]["step"] == want["step"]
        for key, value in want["model"].items():
            assert torch.equal(r["checkpoint"]["model"][key], value), key
    # one process reads what the 4 ranks wrote
    target = {"model": {k: torch.zeros_like(v)
                        for k, v in want["model"].items()}, "step": 0}
    load_checkpoint_distributed(str(ranks.out / "ckpt"), target)
    assert target["step"] == want["step"]
    for key, value in want["model"].items():
        assert torch.equal(target["model"][key], value), key
