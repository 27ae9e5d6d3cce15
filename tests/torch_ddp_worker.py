"""One rank of the port's data-parallel checks (``tests/test_torch_ddp.py``).

    RANK=r WORLD_SIZE=n LOCAL_RANK=r python tests/torch_ddp_worker.py \
        <scenario> <file store> <out dir>

``Ranks`` starts such a job from a test. Each rank joins a gloo group
through ``parallel/mesh.py init_distributed`` over a
``file://`` store, runs ``scenario`` (``core``: batch norm, the losses,
three anomaly train steps, one DeepLab step on a two-rank subgroup, a
non-finite step, prototypes and the distributed checkpoint; ``cli``: the
two training entry points) on the CPU, writes ``<out dir>/rank<r>.pt``,
and leaves without tearing the group down (``destroy_process_group`` can
hang after the last collective); ``Ranks`` waits with a hard timeout and
kills what is left.

The inputs come from numpy seeds through the ``*_case`` functions, which
the test imports to build the one-process reference. Imports torch and the
port only.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

WORLD = 4
LOCAL_BATCH = 2
GLOBAL_BATCH = WORLD * LOCAL_BATCH
NUM_CLASS = 5
IMAGE = 48                       # the twin's input; labels at 1/8
STEPS = 3
LR, MOMENTUM, WD = 0.05, 0.9, 1e-4
# ignored label share per rank: ranks must differ, so that a per-rank mean
# of the cross entropy differs from the global one
IGNORE_SHARE = (0.0, 0.5, 0.9, 0.2)
BN_SHAPE = (16, 3, 4, 4)         # 4 samples a rank, NCHW
BN_MOMENTUM = 0.1
DEEPLAB_CROP = 32
PPM_CHANNELS_TWIN = 32
NOVEL = 3                        # the prototype's class


def bn_case():
    """(x (16, 3, 4, 4) float32, the output weights of the loss)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(BN_SHAPE) * 2 + 0.5).astype(np.float32)
    w = rng.standard_normal(BN_SHAPE).astype(np.float32)
    return x, w


def _uneven_labels(rng, shape, ignore_value, n_class):
    """Labels of GLOBAL_BATCH images, rank r's ignoring IGNORE_SHARE[r]."""
    labels = rng.integers(0, n_class, shape)
    for r, share in enumerate(IGNORE_SHARE):
        part = labels[r * LOCAL_BATCH:(r + 1) * LOCAL_BATCH]
        part[rng.random(part.shape) < share] = ignore_value
    return labels.astype(np.int32)


def loss_case(ignore_value):
    """(logits (8, 12, 12, K) float32, labels, features (8, 12, 12, 6))."""
    rng = np.random.default_rng(1 if ignore_value < 0 else 2)
    shape = (GLOBAL_BATCH, 12, 12)
    logits = (rng.standard_normal(shape + (NUM_CLASS,)) * 3).astype(
        np.float32)
    feats = rng.standard_normal(shape + (6,)).astype(np.float32)
    return logits, _uneven_labels(rng, shape, ignore_value, NUM_CLASS), feats


def train_case(seed=3):
    """(images (8, 48, 48, 3), labels (8, 6, 6) with -1 ignored)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((GLOBAL_BATCH, IMAGE, IMAGE, 3))
    labels = _uneven_labels(rng, (GLOBAL_BATCH, IMAGE // 8, IMAGE // 8), -1,
                            NUM_CLASS)
    return img, labels


def deeplab_case():
    """(images (4, 32, 32, 3), labels with 255 ignored), for 2 ranks."""
    rng = np.random.default_rng(4)
    img = rng.standard_normal((4, DEEPLAB_CROP, DEEPLAB_CROP, 3))
    labels = rng.integers(0, NUM_CLASS, (4, DEEPLAB_CROP, DEEPLAB_CROP))
    labels[:2][rng.random((2, DEEPLAB_CROP, DEEPLAB_CROP)) < 0.7] = 255
    return img, labels.astype(np.int32)


def prototype_cases():
    """Two (features (8, 8, 8, 6), labels) cases. In the first only rank
    0's images hold the novel class, on 20 of its 128 pixels: over 5 % of
    its own batch, under 5 % of the global one (valid flips if the count
    is taken per rank). In the second every rank holds some."""
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((GLOBAL_BATCH, 8, 8, 6)).astype(np.float32)
    sparse = np.zeros((GLOBAL_BATCH, 8, 8), np.int32)
    sparse[0, :2, :8] = NOVEL
    sparse[1, :1, :4] = NOVEL
    spread = rng.integers(0, NOVEL + 1, (GLOBAL_BATCH, 8, 8)).astype(np.int32)
    return [(feats, sparse), (feats, spread)]


def checkpoint_state(seed=6):
    gen = torch.Generator().manual_seed(seed)
    return {"model": {"w": torch.randn(7, 3, generator=gen),
                      "b": torch.randn(3, dtype=torch.float64,
                                       generator=gen),
                      "n": torch.arange(4)},
            "step": 41}


def twin(seed):
    """A tiny resnet18dilated + ppm_deepsup_embedding in float64 with its
    dropout held out (eval mode), in training mode elsewhere: BasicBlock
    layers (1, 1, 1, 1) of 8-64 planes at output stride 8, and PPM branches
    of PPM_CHANNELS_TWIN channels (the decoders' width constant, 512, is
    set for the construction only; the forward reads widths off the
    weights)."""
    from open_world_semantic_segmentation_tpu_torch.models import decoders
    from open_world_semantic_segmentation_tpu_torch.models.builder import (
        SegmentationModel, init_weights)
    from open_world_semantic_segmentation_tpu_torch.models.resnet import (
        BasicBlock, ResNet)

    width, decoders.PPM_CHANNELS = decoders.PPM_CHANNELS, PPM_CHANNELS_TWIN
    try:
        model = SegmentationModel(
            ResNet(block=BasicBlock, layers=(1, 1, 1, 1),
                   planes=(8, 16, 32, 64), stem="deep", output_stride=8),
            decoders.PPMDeepsupEmbedding(num_class=NUM_CLASS, fc_dim=64))
    finally:
        decoders.PPM_CHANNELS = width
    init_weights(model, torch.Generator().manual_seed(seed))
    return hold_out_dropout(model.double().train())


def deeplab(seed):
    """deeplabv3plus_mobilenet in float64, dropout held out. Its BN weights
    and biases are drawn from the seed too: at the init's bias 0 the
    zero-padded borders of MobileNet's blocks normalise to 0 up to
    rounding, right on ReLU6's kink, where the two ways of summing round
    to either side of it."""
    from open_world_semantic_segmentation_tpu_torch.models.deeplab import (
        deeplabv3plus_mobilenet, init_deeplab_weights)
    from open_world_semantic_segmentation_tpu_torch.models.layers import (
        BatchNorm2d)

    model = deeplabv3plus_mobilenet(num_classes=NUM_CLASS, output_stride=16)
    gen = torch.Generator().manual_seed(seed)
    init_deeplab_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.5, 0.5, generator=gen)
    return hold_out_dropout(model.double().train())


def hold_out_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    return model


def anomaly_step(model, group=None):
    from open_world_semantic_segmentation_tpu_torch.train.optim import (
        poly_schedule, two_group_optimizer)
    from open_world_semantic_segmentation_tpu_torch.train.state import (
        AnomalyTrainStep)

    opt = two_group_optimizer(model, lr_encoder=poly_schedule(LR, 10),
                              lr_decoder=poly_schedule(LR, 10),
                              momentum=MOMENTUM, weight_decay=WD)
    return AnomalyTrainStep(model, opt, alpha=0.01, guard=True,
                            dtype=torch.float64, group=group)


def deeplab_step(model, group=None):
    from open_world_semantic_segmentation_tpu_torch.train.optim import (
        backbone_classifier_optimizer, poly_schedule)
    from open_world_semantic_segmentation_tpu_torch.train.state import (
        DeepLabTrainStep)

    opt = backbone_classifier_optimizer(model, lr=poly_schedule(LR, 10),
                                        momentum=MOMENTUM, weight_decay=WD)
    return DeepLabTrainStep(model, opt, guard=True, dtype=torch.float64,
                            group=group)


def run_steps(step, batches):
    out = []
    for batch in batches:
        m = step(batch)
        out.append({k: v.item() for k, v in m.items()})
    return out


def anomaly_batches(rank, world):
    img, labels = train_case()
    part = slice(rank * GLOBAL_BATCH // world,
                 (rank + 1) * GLOBAL_BATCH // world)
    return [{"img_data": torch.from_numpy(img[part]),
             "seg_label": torch.from_numpy(labels[part]).long()}] * STEPS


def deeplab_batches(rank, world):
    img, labels = deeplab_case()
    n = 4 // world
    part = slice(rank * n, (rank + 1) * n)
    return [{"image": torch.from_numpy(img[part]),
             "label": torch.from_numpy(labels[part]).long()}]


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# --------------------------------------------------------------------------
def core(rank, world, out_dir):
    import torch.distributed as dist

    from open_world_semantic_segmentation_tpu_torch.fewshot.prototypes import (
        extract_prototype)
    from open_world_semantic_segmentation_tpu_torch.models.layers import (
        BatchNorm2d)
    from open_world_semantic_segmentation_tpu_torch.parallel import (
        data_group, replicate)
    from open_world_semantic_segmentation_tpu_torch.train import losses
    from open_world_semantic_segmentation_tpu_torch.train.checkpoint import (
        load_checkpoint_distributed, save_checkpoint_distributed)

    group = data_group()
    res = {}

    # batch norm over the global batch, and its input gradient
    x, w = bn_case()
    part = slice(rank * 4, (rank + 1) * 4)
    bn = BatchNorm2d(3, momentum=BN_MOMENTUM).train()
    bn.group = group
    xr = torch.from_numpy(x[part]).requires_grad_(True)
    y = bn(xr)
    (y * torch.from_numpy(w[part])).sum().backward()
    res["bn"] = {"y": y.detach(), "mean": bn.running_mean.clone(),
                 "var": bn.running_var.clone(), "grad": xr.grad,
                 "grad_weight": bn.weight.grad, "grad_bias": bn.bias.grad,
                 "tracked": int(bn.num_batches_tracked)}
    bn.update_stats = False
    before = bn.running_var.clone()
    res["bn"]["y_fix"] = bn(torch.from_numpy(x[part])).detach()
    assert torch.equal(bn.running_var, before)
    # eval mode normalises with the running statistics, with no collective
    real = dist.all_reduce

    def refuse(*args, **kwargs):
        raise AssertionError("a collective ran in eval mode")

    dist.all_reduce = refuse
    try:
        res["bn"]["y_eval"] = bn.eval()(torch.from_numpy(x[part])).detach()
    finally:
        dist.all_reduce = real

    # the losses of the global batch, each rank ignoring its own share
    logits, labels, feats = loss_case(-1)
    part = slice(rank * LOCAL_BATCH, (rank + 1) * LOCAL_BATCH)
    lg = torch.from_numpy(logits[part]).requires_grad_(True)
    loss, aux = losses.dml_segmentation_loss(
        lg, torch.from_numpy(labels[part]), alpha=0.5, beta=0.25,
        group=group)
    loss.backward()
    res["dml"] = {"loss": loss.item(), "aux": [a.item() for a in aux],
                  "grad": lg.grad}
    logits, labels, feats = loss_case(255)
    lg, lb = torch.from_numpy(logits[part]), torch.from_numpy(labels[part])
    res["deeplab_ce"] = losses.deeplab_cross_entropy(
        lg, lb, group=group).item()
    res["deeplab_terms"] = losses.deeplab_cross_entropy(
        lg, lb, torch.from_numpy(feats[part]), alpha=0.3, beta=0.2,
        gamma=0.1, use_metric_terms=True, group=group).item()
    res["focal"] = losses.focal_loss(lg, lb, gamma=2.0, group=group).item()
    res["pixel_acc"] = losses.pixel_acc(
        lg, torch.where(lb == 255, -1, lb), group).item()

    # three anomaly train steps; every rank starts from its own seed and
    # takes rank 0's weights from ``replicate``
    model = replicate(twin(seed=10 + rank))
    step = anomaly_step(model)
    res["anomaly"] = {"metrics": run_steps(step, anomaly_batches(rank,
                                                                 world)),
                      "state": _state(model)}

    # a non-finite loss on rank 2 only skips the step on every rank
    before = _state(model)
    hook = None
    if rank == 2:
        def poison(module, args, out):
            return out.index_fill(0, torch.tensor([0]), float("nan"))
        hook = model.decoder.conv_last.register_forward_hook(poison)
    m = step(anomaly_batches(rank, world)[0])
    if hook is not None:
        hook.remove()
    res["nonfinite"] = {"skipped": bool(m["skipped"]),
                        "loss": m["loss"].item(),
                        "kept": all(torch.equal(v, before[k])
                                    for k, v in model.state_dict().items())}

    # one DeepLab step on the subgroup of ranks 0 and 1
    pair = dist.new_group([0, 1])
    if rank < 2:
        model = replicate(deeplab(seed=20 + rank), pair)
        step = deeplab_step(model, group=pair)
        res["deeplab"] = {"metrics": run_steps(step, deeplab_batches(rank,
                                                                     2)),
                          "state": _state(model)}

    # prototypes over every rank's support images
    res["prototypes"] = []
    for feats, labels in prototype_cases():
        proto, valid = extract_prototype(torch.from_numpy(feats[part]),
                                         torch.from_numpy(labels[part]),
                                         NOVEL, group=group)
        res["prototypes"].append((proto, bool(valid)))

    # the distributed checkpoint, written by every rank and read back
    ckpt = os.path.join(out_dir, "ckpt")
    save_checkpoint_distributed(ckpt, checkpoint_state())
    dist.barrier()
    target = {"model": {k: torch.zeros_like(v)
                        for k, v in checkpoint_state()["model"].items()},
              "step": 0}
    load_checkpoint_distributed(ckpt, target)
    res["checkpoint"] = target
    return res


def cli(rank, world, out_dir):
    """The two training entry points over the group, at tiny sizes."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_synthetic_data import make_cityscapes, make_streethazards

    from open_world_semantic_segmentation_tpu_torch.cli import (
        main_deeplab, train_embedding)
    from open_world_semantic_segmentation_tpu_torch.core.config import (
        load_config)

    import torch.distributed as dist

    # count the checkpoint writes of this rank
    writes = {"embedding": 0, "deeplab": 0}

    def counting(module, name, key):
        real = getattr(module, name)

        def write(*args, **kwargs):
            writes[key] += 1
            return real(*args, **kwargs)
        setattr(module, name, write)

    counting(train_embedding, "save_epoch_checkpoint", "embedding")
    counting(main_deeplab, "save_deeplab_checkpoint", "deeplab")
    data = os.path.join(out_dir, "data")
    if rank == 0:
        make_streethazards(os.path.join(data, "sh"), n_train=6, n_val=1,
                           h=40, w=56, seed=0)
        make_cityscapes(os.path.join(data, "cs"), splits=("train", "val"),
                        n=4)
    dist.barrier()
    res = {}
    sh = os.path.join(data, "sh")
    cfg = load_config(os.path.join(REPO, "configs/train_embedding.yaml"), [
        "DATASET.root_dataset", sh,
        "DATASET.list_train", os.path.join(sh, "train.odgt"),
        "DATASET.imgSizes", "(32,)", "DATASET.imgMaxSize", "64",
        "MODEL.arch_encoder", "resnet18dilated", "MODEL.fc_dim", "512",
        "TRAIN.batch_size_per_gpu", "2", "TRAIN.epoch_iters", "2",
        "TRAIN.num_epoch", "1", "TRAIN.disp_iter", "1",
        "DIR", os.path.join(out_dir, "embedding")])
    summary = train_embedding.main(cfg, torch.float32, device="cpu")
    res["embedding"] = {k: summary[k] for k in ("steps", "rank", "world",
                                                "skipped")}
    res["embedding"]["losses"] = [e["loss"] for e in summary["log"]]
    cs = os.path.join(data, "cs")
    cfg = load_config(os.path.join(REPO, "configs/cityscapes_closed.yaml"), [
        "DATASET.root_dataset", cs, "DEEPLAB.model", "deeplabv3plus_mobilenet",
        "DEEPLAB.crop_size", "32", "DEEPLAB.batch_size", "2",
        "DEEPLAB.total_itrs", "2", "DEEPLAB.val_interval", "2",
        "DIR", os.path.join(out_dir, "deeplab")])
    summary = main_deeplab.main(cfg, torch.float32, device="cpu",
                                log_every=1)
    res["deeplab"] = {k: summary[k] for k in ("steps", "rank", "world",
                                              "skipped", "validations")}
    res["deeplab"]["losses"] = [e["loss"] for e in summary["log"]]
    res["writes"] = writes
    return res


SCENARIOS = {"core": core, "cli": cli}
RANK_TIMEOUT_S = 240


class Ranks:
    """``world`` worker ranks of ``scenario``, started at once; ``results()``
    waits for them (so the tests build their references meanwhile) and
    returns each rank's results. It fails with every rank's log tail if
    one does not write them in time or exits non-zero, and kills whatever
    is still running."""

    def __init__(self, scenario, tmp_path, world=WORLD,
                 timeout=RANK_TIMEOUT_S):
        self.out = tmp_path / scenario
        self.out.mkdir()
        self.scenario = scenario
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT")}
        env.update(WORLD_SIZE=str(world), OMP_NUM_THREADS="2",
                   PYTHONPATH=os.path.dirname(HERE))
        self.procs, self.logs = [], []
        for rank in range(world):
            log = open(self.out / f"rank{rank}.log", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_ddp_worker.py"),
                 scenario, str(tmp_path / f"{scenario}.store"),
                 str(self.out)],
                env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)},
                stdout=log, stderr=subprocess.STDOUT))
        self.paths = [self.out / f"rank{rank}.pt" for rank in range(world)]
        self.deadline = time.monotonic() + timeout
        self._results = None

    def results(self):
        if self._results is None:
            self._results = self._wait()
        return self._results

    def _wait(self):
        try:
            while time.monotonic() < self.deadline:
                if all(p.exists() for p in self.paths) or any(
                        proc.poll() not in (None, 0) for proc in self.procs):
                    break
                time.sleep(0.1)
        finally:
            self.stop()
        if not all(p.exists() for p in self.paths):
            tails = "\n".join(
                f"--- rank {rank} (rc {proc.returncode}):\n"
                + (self.out / f"rank{rank}.log").read_text()[-3000:]
                for rank, proc in enumerate(self.procs))
            import pytest

            pytest.fail(f"{self.scenario}: not every rank finished\n{tails}")
        return [torch.load(p, weights_only=False) for p in self.paths]

    def stop(self):
        for proc in self.procs:
            if proc.poll() is None:
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        for log in self.logs:
            log.close()


def main():
    scenario, store, out_dir = sys.argv[1:4]
    torch.set_num_threads(2)
    from open_world_semantic_segmentation_tpu_torch.parallel import (
        init_distributed)

    rank, world, _ = init_distributed("cpu", init_method="file://" + store,
                                      timeout_s=120)
    res = SCENARIOS[scenario](rank, world, out_dir)
    path = os.path.join(out_dir, f"rank{rank}.pt")
    torch.save(res, path + ".part")
    os.replace(path + ".part", path)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
