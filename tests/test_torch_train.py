"""The port's training stack against the JAX package's, on the CPU.

The twin of ``tests/test_torch_model.py`` (deep-stem Bottleneck ResNet,
layers (1, 1, 1, 1), planes 8..64, PPM embedding decoder, fc_dim 256),
64x64 images, batch 2, in training mode. Dropout is held out on both
sides: flax ``nn.intercept_methods`` makes ``nn.Dropout`` the identity in
the JAX run, and the port's dropout modules are in eval mode; the port's
dropout is checked on its own.

Everything runs in float32 except the one-step parity and the training
forward, which run in float64 on both sides (the JAX package under
``jax.enable_x64``, through its concat PPM dataflow, whose output follows
the model dtype; the default concat-free fuse returns float32): in float32
the twin's gradients carry rounding of a few 1e-4 of a tensor's largest
magnitude (the port's float32 against its float64 gradients; up to 1.6e-2
where a ReLU input lies within rounding of 0), more than the tolerance.

Tolerances: the losses rtol 1e-6 (float32 sums over a few hundred pixels,
taken in another order), and for the sums of signed logits (VAR, Inter
and the loss) atol 1e-6 of the sum of the terms' magnitudes; one train
step: loss rtol 1e-5, every gradient within 1e-4 of its largest magnitude
(the interpolation weights of the PPM fuse are float32 on the port's
side), parameters after the SGD step rtol 1e-5 plus the gradient
tolerance carried through the step (lr x 1e-4 of the gradient's largest
magnitude), the BN running statistics rtol 1e-5 (atol 1e-7); the training
forward's outputs 1e-4 of their largest magnitude; the optimizer on a
tiny tree rtol 1e-6; the pipelines bit-equal.
"""

import functools
import os
import pickle

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from open_world_semantic_segmentation_tpu.data.odgt import (
    TrainPipeline as JaxTrainPipeline)
from open_world_semantic_segmentation_tpu.models.builder import (
    SegmentationModel as JaxSegmentationModel)
from open_world_semantic_segmentation_tpu.models.decoders import (
    PPMDeepsupEmbedding as JaxPPMDeepsupEmbedding)
from open_world_semantic_segmentation_tpu.models.resnet import (
    Bottleneck as JaxBottleneck, ResNet as JaxResNet)
from open_world_semantic_segmentation_tpu.train import (
    losses as jax_losses, optim as jax_optim)
from open_world_semantic_segmentation_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from open_world_semantic_segmentation_tpu.train.convert import (
    convert_segmentation_model, load_torch_checkpoint)
from open_world_semantic_segmentation_tpu.train.state import TrainState
from open_world_semantic_segmentation_tpu_torch.cli import (
    train as train_cli, train_embedding)
from open_world_semantic_segmentation_tpu_torch.cli._common import (
    init_or_load_variables)
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.data.odgt import (
    TrainPipeline)
from open_world_semantic_segmentation_tpu_torch.models.layers import (
    BatchNorm2d)
from open_world_semantic_segmentation_tpu_torch.train import losses
from open_world_semantic_segmentation_tpu_torch.train.checkpoint import (
    save_epoch_checkpoint)
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    state_dict_from_jax)
from open_world_semantic_segmentation_tpu_torch.train.optim import (
    poly_schedule, set_learning_rates, two_group_optimizer)
from open_world_semantic_segmentation_tpu_torch.train.state import (
    AnomalyTrainStep)
from test_torch_model import (
    FC_DIM, NUM_CLASS, TWIN, fill_jax_variables, port_twin_from)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, MAX_ITERS, MOMENTUM, WD = 0.02, 10, 0.9, 1e-4


def _logits_and_labels(seed, shape=(2, 16, 16, NUM_CLASS)):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:3]).astype(np.int32)
    labels[rng.random(shape[:3]) < 0.2] = -1
    return logits, labels


@pytest.mark.parametrize("alpha,beta", [(0.01, 0.0), (0.5, 0.25)])
def test_dml_loss_matches_jax(alpha, beta):
    logits, labels = _logits_and_labels(0)
    want_loss, want_aux = jax_losses.dml_segmentation_loss(
        jnp.asarray(logits), jnp.asarray(labels), alpha=alpha, beta=beta)
    got_loss, got_aux = losses.dml_segmentation_loss(
        torch.from_numpy(logits), torch.from_numpy(labels), alpha=alpha,
        beta=beta)
    # VAR and Inter are sums of signed logits: float32 rounds a sum to a
    # fraction of the sum of its terms' magnitudes, which the same loss of
    # |logits| gives, so each value is held to 1e-6 of that as well
    abs_loss, abs_aux = jax_losses.dml_segmentation_loss(
        jnp.abs(jnp.asarray(logits)), jnp.asarray(labels), alpha=alpha,
        beta=beta)
    for got, want, mag in zip((got_loss, *got_aux), (want_loss, *want_aux),
                              (abs_loss, *abs_aux)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6 * abs(float(mag)))
    np.testing.assert_allclose(
        float(losses.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels))),
        float(jax_losses.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels))), rtol=1e-6)
    assert float(losses.pixel_acc(torch.from_numpy(logits),
                                  torch.from_numpy(labels))) == float(
        jax_losses.pixel_acc(jnp.asarray(logits), jnp.asarray(labels)))


# --------------------------------------------------------------------------
def _jax_train_twin(dtype=jnp.float32):
    return JaxSegmentationModel(
        encoder=JaxResNet(block=JaxBottleneck, train=True, dtype=dtype,
                          **TWIN),
        decoder=JaxPPMDeepsupEmbedding(num_class=NUM_CLASS, fc_dim=FC_DIM,
                                       train=True, dtype=dtype))


@functools.cache
def _twin_variables(seed):
    """The JAX twin's variable tree filled from ``seed`` (shared by the
    tests, which do not change it)."""
    return fill_jax_variables(_jax_train_twin(), (2, 64, 64, 3), seed)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _batch(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((2, 64, 64, 3)).astype(dtype)
    label = rng.integers(0, NUM_CLASS, (2, 8, 8)).astype(np.int32)
    label[rng.random((2, 8, 8)) < 0.15] = -1
    return img, label


@pytest.fixture(scope="module")
def jax_step64():
    """The JAX package's anomaly train step (make_anomaly_train_step's loss
    and update, dropout intercepted) on the twin in float64: the outputs,
    the loss, the gradients and the new state. float64 through its concat
    dataflow (OWSS_PPM_FUSE=concat), since the default concat-free fuse
    returns float32; both compute the same function."""
    variables = _twin_variables(0)
    img, label = _batch(1, np.float64)
    saved = os.environ.get("OWSS_PPM_FUSE")
    os.environ["OWSS_PPM_FUSE"] = "concat"
    try:
        with jax.enable_x64(True):
            model = _jax_train_twin(jnp.float64)
            v64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), variables)

            def loss_fn(params, batch_stats):
                out, mutated = model.apply(
                    {"params": params, "batch_stats": batch_stats},
                    jnp.asarray(img), mutable=["batch_stats"])
                loss, _ = jax_losses.dml_segmentation_loss(
                    out["scores"], jnp.asarray(label), alpha=0.01)
                return loss, (out, mutated["batch_stats"])

            with fnn.intercept_methods(_no_dropout):
                (loss, (out, new_bs)), grads = jax.jit(jax.value_and_grad(
                    loss_fn, has_aux=True))(v64["params"],
                                            v64["batch_stats"])
            tx = jax_optim.two_group_optimizer(
                v64["params"],
                lr_encoder=jax_optim.poly_schedule(LR, MAX_ITERS),
                lr_decoder=jax_optim.poly_schedule(LR, MAX_ITERS),
                momentum=MOMENTUM, weight_decay=WD)
            state = TrainState.create(params=v64["params"],
                                      batch_stats=v64["batch_stats"], tx=tx)
            state = state.apply_gradients(grads).replace(batch_stats=new_bs)
            as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
            return dict(variables=variables, img=img, label=label,
                        out=as_np(out), loss=float(loss),
                        grads=as_np(grads), params=as_np(state.params),
                        batch_stats=as_np(state.batch_stats))
    finally:
        if saved is None:
            del os.environ["OWSS_PPM_FUSE"]
        else:
            os.environ["OWSS_PPM_FUSE"] = saved


def _port_train_twin(variables, dtype=torch.float32):
    model = port_twin_from(variables).train().to(dtype)
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.eval()
    return model


def _port_step(model, batches, dtype=torch.float32, guard=False):
    opt = two_group_optimizer(model, lr_encoder=poly_schedule(LR, MAX_ITERS),
                              lr_decoder=poly_schedule(LR, MAX_ITERS),
                              momentum=MOMENTUM, weight_decay=WD)
    step = AnomalyTrainStep(model, opt, alpha=0.01, guard=guard,
                            dtype=dtype)
    return step, [step({"img_data": torch.from_numpy(img),
                        "seg_label": torch.from_numpy(label)})
                  for img, label in batches]


def test_one_train_step_matches_jax(jax_step64):
    """float64 on both sides: in float32 this twin's gradients carry
    rounding of several 1e-4 of a tensor's largest magnitude (the port's
    own float32 gradients against its float64 ones), and the JAX package's
    more (flax computes the batch variance as E[x^2] - E[x]^2), so a
    float32 comparison at 1e-4 would measure rounding, not the function."""
    ref = jax_step64
    model = _port_train_twin(ref["variables"], torch.float64)
    _, (metrics,) = _port_step(model, [(ref["img"], ref["label"])],
                               torch.float64, guard=True)
    assert not bool(metrics["skipped"])
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               rtol=1e-5)

    # gradients, by key, through the same converter as the weights
    g_enc, g_dec = state_dict_from_jax({"params": ref["grads"],
                                        "batch_stats": {}})
    for part, want in (("encoder", g_enc), ("decoder", g_dec)):
        params = dict(getattr(model, part).named_parameters())
        assert set(params) == set(want)
        for key, p in params.items():
            w = want[key].numpy()
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                       atol=1e-4 * scale, err_msg=key)

    # parameters after SGD (the deep-supervision branch, which the loss
    # does not reach, decays too): rtol 1e-5, plus the gradient tolerance
    # carried through the step (lr x 1e-4 of the gradient's largest
    # magnitude); BN running statistics (flax: biased variance)
    enc, dec = state_dict_from_jax({"params": ref["params"],
                                    "batch_stats": ref["batch_stats"]})
    for part, want, grads in (("encoder", enc, g_enc),
                              ("decoder", dec, g_dec)):
        got = getattr(model, part).state_dict()
        for key in want:
            if key.endswith("num_batches_tracked"):
                continue
            atol = (LR * 1e-4 * float(grads[key].abs().max()) if key in grads
                    else 1e-7)
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       rtol=1e-5, atol=atol, err_msg=key)
        assert any(k.endswith("running_var") for k in want)
    assert not np.array_equal(dec["cbr_deepsup.0.weight"].numpy(),
                              ref["variables"]["params"]["decoder"]["deepsup"]
                              ["cbr_deepsup"]["conv"]["kernel"].transpose(
                                  3, 2, 0, 1))


def test_training_forward_matches_jax(jax_step64):
    """The training forward's outputs at feature resolution, ``ft`` (the
    concat) built only when asked."""
    ref = jax_step64
    model = _port_train_twin(ref["variables"], torch.float64)
    img = torch.from_numpy(ref["img"])
    with torch.no_grad():
        out = model(img)
        full = model(img, concat_ft=True)
    assert set(out) == {"scores", "deepsup", "embedding"}
    assert full["ft"].shape == (2, 8, 8, FC_DIM + 4 * 512)
    for key in ("scores", "deepsup", "embedding", "ft"):
        w = ref["out"][key]
        assert full[key].shape == w.shape
        np.testing.assert_allclose(full[key].numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=key)


def test_batchnorm_running_var_takes_biased_batch_variance():
    torch.manual_seed(0)
    x = torch.randn(2, 3, 2, 2)
    bn = BatchNorm2d(3, momentum=0.1).train()
    bn.running_var.fill_(2.0)
    ref = nn.BatchNorm2d(3, momentum=0.1).train()
    out = bn(x)
    torch.testing.assert_close(out, ref(x), rtol=0, atol=0)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 * 2.0 + 0.1 * biased,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(bn.running_mean, ref.running_mean)
    # fix_bn: batch statistics normalise, running statistics stay
    bn.update_stats = False
    before = (bn.running_mean.clone(), bn.running_var.clone())
    torch.testing.assert_close(bn(x), ref(x))
    assert torch.equal(bn.running_mean, before[0])
    assert torch.equal(bn.running_var, before[1])


def test_port_dropout_is_elementwise():
    variables = _twin_variables(0)
    dec = port_twin_from(variables).train().decoder
    drops = [dec.conv_last[3], dec.dropout_deepsup]
    assert all(type(d) is nn.Dropout and d.p == 0.1 for d in drops)
    torch.manual_seed(0)
    y = drops[0](torch.ones(4, 64, 16, 16))
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert abs(1 - kept.float().mean().item() - 0.1) < 0.01
    # element-wise: a channel's map is partly dropped, not all or nothing
    per_channel = kept.float().mean((2, 3))
    assert ((per_channel > 0) & (per_channel < 1)).all()


# --------------------------------------------------------------------------
class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = nn.Sequential(nn.Conv2d(2, 4, 3, bias=False),
                                     BatchNorm2d(4))
        self.decoder = nn.Conv2d(4, 3, 1)


def test_optimizer_five_steps_match_jax():
    """Poly LR, the two groups and the decay mask against the JAX
    two_group_optimizer, five steps of given gradients."""
    rng = np.random.default_rng(0)
    model = _Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape)
                                     .astype(np.float32)))

    def to_jax(tree):   # port tensors -> the flax tree layout
        e, d = tree["encoder"], tree["decoder"]
        return {"encoder": {"conv": {"kernel": e["0.weight"].transpose(
                                2, 3, 1, 0)},
                            "bn": {"scale": e["1.weight"],
                                   "bias": e["1.bias"]}},
                "decoder": {"out": {"kernel": d["weight"].transpose(
                    2, 3, 1, 0), "bias": d["bias"]}}}

    def port_tree(values):
        return {"encoder": {k: values[f"encoder.{k}"]
                            for k in ("0.weight", "1.weight", "1.bias")},
                "decoder": {k: values[f"decoder.{k}"]
                            for k in ("weight", "bias")}}

    params = {k: v.detach().numpy().copy()
              for k, v in model.named_parameters()}
    jparams = jax.tree_util.tree_map(jnp.asarray, to_jax(port_tree(params)))
    assert jax.tree_util.tree_map(bool, jax_optim.decay_mask(jparams)) == {
        "encoder": {"conv": {"kernel": True},
                    "bn": {"scale": False, "bias": False}},
        "decoder": {"out": {"kernel": True, "bias": False}}}
    tx = jax_optim.two_group_optimizer(
        jparams, lr_encoder=jax_optim.poly_schedule(0.1, 8),
        lr_decoder=jax_optim.poly_schedule(0.05, 8), momentum=0.9,
        weight_decay=0.1)
    opt_state = tx.init(jparams)
    opt = two_group_optimizer(model, lr_encoder=poly_schedule(0.1, 8),
                              lr_decoder=poly_schedule(0.05, 8),
                              momentum=0.9, weight_decay=0.1)
    decayed = {id(p) for g in opt.param_groups if g["weight_decay"]
               for p in g["params"]}
    assert decayed == {id(model.encoder[0].weight),
                       id(model.decoder.weight)}
    for step in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        jgrads = jax.tree_util.tree_map(jnp.asarray,
                                        to_jax(port_tree(grads)))
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[name])
        set_learning_rates(opt, step)
        lrs = {g["part"]: g["lr"] for g in opt.param_groups}
        np.testing.assert_allclose(
            [lrs["encoder"], lrs["decoder"]],
            [float(jax_optim.poly_schedule(0.1, 8)(step)),
             float(jax_optim.poly_schedule(0.05, 8)(step))], rtol=1e-6)
        opt.step()
        got = to_jax(port_tree({k: v.detach().numpy()
                                for k, v in model.named_parameters()}))
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(g, np.asarray(w),
                                                    rtol=1e-6, atol=1e-7),
            got, jparams)


def test_guard_skips_nonfinite_batch_and_keeps_state():
    variables = _twin_variables(0)
    img, label = _batch(3)
    bad = img.copy()
    bad[0, 5, 5, 0] = np.nan
    model = _port_train_twin(variables)
    opt = two_group_optimizer(model, lr_encoder=LR, lr_decoder=LR)
    step = AnomalyTrainStep(model, opt, guard=True, dtype=torch.float32)
    batch = lambda x: {"img_data": torch.from_numpy(x),
                       "seg_label": torch.from_numpy(label)}
    step(batch(img))                  # momentum buffers no longer zero
    before = [t.clone() for t in step._state()]
    metrics = step(batch(bad))
    assert bool(metrics["skipped"]) and not np.isfinite(
        float(metrics["loss"]))
    after = step._state()
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    metrics = step(batch(img))
    assert not bool(metrics["skipped"])
    assert not all(torch.equal(a, b) for a, b in zip(step._state(), before))


def test_fix_bn_step_keeps_running_statistics():
    """TRAIN.fix_bn: the step normalises with batch statistics and leaves
    every BN buffer as it was, while the parameters move."""
    img, label = _batch(3)
    model = _port_train_twin(_twin_variables(0))
    opt = two_group_optimizer(model, lr_encoder=LR, lr_decoder=LR)
    step = AnomalyTrainStep(model, opt, fix_bn=True, dtype=torch.float32)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    params = [p.detach().clone() for p in model.parameters()]
    step({"img_data": torch.from_numpy(img),
          "seg_label": torch.from_numpy(label)})
    assert all(torch.equal(v, buffers[k]) for k, v in model.named_buffers())
    assert not all(torch.equal(p, q)
                   for p, q in zip(model.parameters(), params))


# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def street_tree(tmp_path_factory):
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_synthetic_data import make_streethazards

    return make_streethazards(str(tmp_path_factory.mktemp("sh")),
                              n_train=5, n_val=2)


@pytest.mark.parametrize("use_native", [False, True])
def test_train_pipeline_matches_jax(street_tree, use_native):
    kw = dict(batch_per_gpu=2, img_sizes=(40, 56, 64), img_max_size=100,
              padding_constant=8, segm_downsampling_rate=8, seed=7,
              use_native=use_native)
    odgt = os.path.join(street_tree, "train.odgt")
    mine = TrainPipeline(street_tree, odgt, **kw)
    theirs = JaxTrainPipeline(street_tree, odgt, **kw)
    assert (theirs.native is not None) == use_native
    for _ in range(6):          # past two reshuffles of the 5 records
        got, want = mine.next_batch(), theirs.next_batch()
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_native_library_raises_instead_of_falling_back(street_tree,
                                                        monkeypatch,
                                                        tmp_path):
    from open_world_semantic_segmentation_tpu_torch.data import native

    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="missing.cpp not found"):
            TrainPipeline(street_tree, os.path.join(street_tree,
                                                    "train.odgt"))
    finally:
        native.load.cache_clear()


# --------------------------------------------------------------------------
def test_pth_checkpoint_roundtrip(tmp_path):
    variables = _twin_variables(0)
    model = port_twin_from(variables)
    paths = (str(tmp_path / "encoder_epoch_1.pth"),
             str(tmp_path / "decoder_epoch_1.pth"))
    save_epoch_checkpoint(model, *paths)
    cfg = load_config(None, ["MODEL.weights_encoder", paths[0],
                             "MODEL.weights_decoder", paths[1]])
    loaded = init_or_load_variables(cfg, port_twin_from(
        _twin_variables(1)))
    for part in ("encoder", "decoder"):
        want = getattr(model, part).state_dict()
        got = getattr(loaded, part).state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    # the JAX package reads the same pair through its torch converter
    jvars = convert_segmentation_model(load_torch_checkpoint(paths[0]),
                                       load_torch_checkpoint(paths[1]))
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_array_equal(np.asarray(g),
                                                   np.asarray(w)),
        jvars, jax.tree_util.tree_map(np.asarray, variables))


def test_jax_pkl_checkpoint_loads_into_port(tmp_path):
    variables = _twin_variables(1)
    path = str(tmp_path / "model_epoch_3.pkl")
    jax_save_checkpoint(path, variables, {"epoch": 3})
    with open(path, "rb") as f:
        assert set(pickle.load(f)) == {"tree", "metadata"}
    cfg = load_config(None, ["MODEL.weights_encoder", path])
    model = init_or_load_variables(cfg, port_twin_from(
        _twin_variables(0)))
    enc, dec = state_dict_from_jax(variables)
    for part, want in (("encoder", enc), ("decoder", dec)):
        got = getattr(model, part).state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)


# --------------------------------------------------------------------------
def test_train_embedding_cli_on_cpu(street_tree, tmp_path, capsys):
    cfg = load_config(os.path.join(REPO, "configs/train_embedding.yaml"), [
        "DATASET.root_dataset", street_tree,
        "DATASET.list_train", os.path.join(street_tree, "train.odgt"),
        "DATASET.imgSizes", "(32,)", "TRAIN.batch_size_per_gpu", "2",
        "TRAIN.epoch_iters", "1", "TRAIN.disp_iter", "1",
        "DIR", str(tmp_path)])
    result = train_embedding.main(cfg, torch.float32, max_steps=2,
                                  device="cpu")
    out = capsys.readouterr().out
    assert result["steps"] == 2 and result["skipped"] == 0
    assert [e["step"] for e in result["log"]] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in result["log"])
    assert out.count("Epoch: [") == 2 and "Training Done!" in out
    for epoch in (1, 2):
        for part in ("encoder", "decoder"):
            assert (tmp_path / f"{part}_epoch_{epoch}.pth").exists()
    with open(tmp_path / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2


def test_train_cli_raises_for_unported_decoder(street_tree, tmp_path):
    # every decoder of the JAX package is ported now (upernet too:
    # tests/test_torch_zoo_decoders.py); a name the JAX ModelBuilder does
    # not know raises as it does there
    cfg = load_config(os.path.join(REPO, "configs/train_embedding.yaml"), [
        "MODEL.arch_decoder", "upernet_xl", "DIR", str(tmp_path)])
    with pytest.raises(ValueError, match="Architecture undefined: upernet_xl"):
        train_cli.main(cfg, torch.float32, max_steps=1, device="cpu")
