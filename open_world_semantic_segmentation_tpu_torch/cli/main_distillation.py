"""Teacher-student incremental distillation: the JAX package's
``cli/main_distillation.py`` (the reference's main_distillation.py).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.main_distillation \
      --cfg configs/self_distillation.yaml \
      MODEL.weights_encoder ckpt/cityscapes-embedding/best.pth DEEPLAB.lr 0.01

Runs on CUDA unless ``--device cpu`` is given; ``--precision bf16`` (the
default) runs under bf16 autocast over float32 parameters. Two embedding
models (main_distillation.py:276-477; deeplabv3plus_embedding_resnet101,
or DEEPLAB.model where it names another embedding composition): a frozen
16-class teacher in eval mode and a 17-class student in training mode,
both initialised from a seed and loaded partially from
MODEL.weights_encoder, so the student's backbone and head start as the
teacher's and only its 17-class classifier keeps its init (:380-383).
Per step: ignored pixels take the teacher's argmax, support pixels
labelled 0 become the novel class 16 (:423, 430), then
``CrossEntropyLoss_dis`` on the student (``CE / n``; the feature term
under FEWSHOT.variant ``distillation_feature``). SGD with the backbone at
0.1x, poly LR. The training split is ``test_car_{shots}_shot`` or
``train``, as in ``cli/self_distillation.py``. Writes
``DIR/distillation_student.pth`` (the JAX CLI writes a pickle).

``fused_blocks`` (a keyword of ``main``, no flag) routes the teacher's
eligible bottlenecks through the fused kernel; the student trains unfused.
"""

from __future__ import annotations

import os

import torch

from ._common import compute_dtype, config_parser, parse_config
from .main_deeplab import (build_deeplab_model, init_or_load_deeplab,
                           train_batches, train_loop)
from .self_distillation import training_split
from ..core.device import resolve_device
from ..train.checkpoint import (load_deeplab_state, load_partial,
                                save_model_checkpoint)
from ..train.losses import distillation_loss
from ..train.optim import backbone_classifier_optimizer, poly_schedule
from ..train.state import TrainStep


class DistillationStep(TrainStep):
    """One student step against the frozen ``teacher`` (eval mode, no
    gradient): pseudo-labels from the teacher's argmax, then
    ``distillation_loss``. BN statistics update; no guard (as the JAX
    step)."""

    def __init__(self, student, teacher, optimizer, *, novel_id: int,
                 use_distillation_term: bool = False, dtype=torch.bfloat16):
        super().__init__(student, optimizer, dtype=dtype)
        self.teacher = teacher
        self.novel_id = novel_id
        self.use_distillation_term = use_distillation_term

    def loss(self, batch):
        img, labels = batch["image"], batch["label"]
        with self.autocast(img.device):
            with torch.no_grad():
                t_logits, _, t_feats = self.teacher(img)
            s_logits, _, s_feats = self.model(img)
        labels = torch.where(labels == 0, self.novel_id, labels)
        labels = torch.where(labels == 255,
                             t_logits.argmax(-1).to(labels.dtype), labels)
        loss = distillation_loss(
            s_logits, labels, t_feats, s_feats, novel_class=self.novel_id,
            use_distillation_term=self.use_distillation_term,
            group=self.group)
        return loss, {}


def build_models(cfg, device, fused_blocks: bool = False):
    """(teacher, student) on ``device`` (channels_last on CUDA): the
    teacher in eval mode, the student in training mode, each from its seed
    (0, 1) and then MODEL.weights_encoder, loaded partially."""
    mcfg = cfg.clone()
    d = mcfg.DEEPLAB
    if "embedding" not in d.model or "self_distillation" in d.model:
        d.model = "deeplabv3plus_embedding_resnet101"
    base = d.num_classes or 16
    state = (load_deeplab_state(cfg.MODEL.weights_encoder)
             if cfg.MODEL.weights_encoder else None)
    models = []
    for seed, classes, fused, train in ((0, base, fused_blocks, False),
                                        (1, base + 1, False, True)):
        d.num_classes = classes
        model, _ = build_deeplab_model(mcfg, device, fused, train=train)
        init_or_load_deeplab(model, seed=seed)
        if state is not None:
            load_partial(model, state)
        models.append(model)
    models[0].requires_grad_(False)
    return tuple(models)


def main(cfg, precision_dtype=torch.bfloat16, max_steps=None, device=None,
         fused_blocks: bool = False, log_every: int = 10):
    """Train the student; return ``steps``, ``log`` (the loss, the loop's
    wall ``seconds`` and loader ``wait`` so far at each logged step) and
    the checkpoint's ``path``."""
    d = cfg.DEEPLAB
    device = resolve_device(device)
    train_ds = training_split(cfg)
    torch.manual_seed(d.random_seed)            # dropout's generator
    teacher, student = build_models(cfg, device, fused_blocks)
    novel_id = d.num_classes or 16
    optimizer = backbone_classifier_optimizer(
        student, lr=poly_schedule(d.lr, d.total_itrs, 0.9, min_lr=1e-6),
        momentum=0.9, weight_decay=d.weight_decay)
    step_fn = DistillationStep(
        student, teacher, optimizer, novel_id=novel_id,
        use_distillation_term=(cfg.FEWSHOT.variant
                               == "distillation_feature"),
        dtype=precision_dtype)
    cur, log = train_loop(
        step_fn, train_batches(train_ds, d.batch_size, d.random_seed, device),
        cur_itrs=0, total_itrs=d.total_itrs, max_steps=max_steps,
        log_every=log_every)
    path = os.path.join(cfg.DIR, "distillation_student.pth")
    save_model_checkpoint(path, student, cur_itrs=cur)
    return {"steps": cur, "log": log, "path": path}


def _entry():
    parser = config_parser(__doc__)
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after this many steps")
    args = parser.parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), max_steps=args.max_steps,
         device=args.device)


if __name__ == "__main__":
    _entry()
