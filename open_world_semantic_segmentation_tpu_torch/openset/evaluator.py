"""OOD evaluation driver core (the StreetHazards open-set eval).

Reproduces the JAX package's ``openset/evaluator.py`` (itself the
reference's ``anomaly/eval_ood_traditional.py:151-653``): the multi-scale
forward, score averaging, anomaly map, argmax and the IoU/accuracy
histograms run on the device; the conf map goes to the host for the f64
AUROC/AUPR/FPR95 sweep (``metrics/anom.py``), together with a handful of
counters. With ``device_metrics`` the sweep runs on the device too
(``metrics/anom_device.py``) and the conf map stays there. Items from
``ValPipeline(device_pyramid=True)`` carry one uint8 image, whose pyramid
is built on the device (``device_pyramid``). With ``visualize_dir`` each
image's [image | gt | pred] grid is written there
(``utils/visualize.py``); the JAX package writes it from its per-image
path only, the port from both.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.odgt import device_normalize
from ..metrics.anom import eval_ood_measure
from ..metrics.anom_device import ood_measures_from_maps
from ..metrics.meters import AverageMeter
from ..metrics.segmentation import intersection_and_union_torch
from ..ops.resize import bilinear_resize
from ..utils.visualize import save_result_grid
from .scoring import compute_conf


def multi_scale_forward(model, pyramid, seg_size, want_ft: bool = True):
    """Average model scores (and features) over the resized pyramid.

    Each level is forwarded with ``seg_size`` so the decoder upsamples to
    label resolution before averaging. Each level is divided by n and the
    levels are summed, in the model's output dtype.
    """
    n = len(pyramid)
    scores = None
    ft = None
    for img in pyramid:
        out = model(img, seg_size=seg_size)
        s = out["scores"]
        scores = s / n if scores is None else scores + s / n
        if want_ft and "ft" in out:
            f = out["ft"]
            ft = f / n if ft is None else ft + f / n
    return scores, ft


def device_pyramid(img_raw: torch.Tensor, shapes):
    """Build the eval pyramid on the device from uint8 NHWC images:
    normalise with the ImageNet stats, then resize to each shape with the
    torch-grid bilinear. Scores deviate from the PIL host path within
    resampling tolerance."""
    x = device_normalize(img_raw)
    return [bilinear_resize(x, s) for s in shapes]


class OODEvaluator:
    """Streaming evaluator with reference-format summaries.

    ``model`` is a ``SegmentationModel`` in eval mode on its device;
    ``dtype`` bfloat16 runs it under autocast (float32 parameters, bf16
    compute), float32 runs it as it is. ``device_metrics`` computes AUROC /
    AUPR / FPR95 on the device: only they and their ``valid`` flag reach
    the host, and ``metric_time`` times their readback. The host float64
    sweep is the default.
    """

    def __init__(self, model, *, num_class: int, method: str = "dissum",
                 out_labels: Sequence[int] = (13,),
                 exclude_back: bool = False, dtype=torch.float32,
                 device_metrics: bool = False,
                 visualize_dir: Optional[str] = None):
        self.model = model
        self.device = next(model.parameters()).device
        self.num_class = num_class
        self.method = method
        self.out_labels = tuple(out_labels)
        self.exclude_back = exclude_back
        self.dtype = dtype
        self.device_metrics = device_metrics
        self.visualize_dir = visualize_dir

        self.acc_meter = AverageMeter()
        self.intersection_meter = AverageMeter()
        self.union_meter = AverageMeter()
        self.time_meter = AverageMeter()     # device batch, per image
        self.metric_meter = AverageMeter()   # AUROC/AUPR/FPR on the host
        self.wait_meter = AverageMeter()     # blocked on the loader
        self.aurocs, self.auprs, self.fprs = [], [], []

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _device_batch(self, items):
        """Run one batch of same-shape items on the device; return the
        per-image conf maps, predictions and counters on the host, or,
        with device metrics, the counters on the host and the (auroc,
        aupr, fpr, valid) tensor still on the device."""
        dev = self.device
        seg = torch.from_numpy(
            np.concatenate([it["seg_label"] for it in items])).to(dev)
        if "img_raw" in items[0]:
            raw = torch.from_numpy(
                np.concatenate([it["img_raw"] for it in items])).to(dev)
            pyramid = device_pyramid(raw, items[0]["pyramid_shapes"])
        else:
            pyramid = [
                torch.from_numpy(np.concatenate(
                    [it["img_data"][lvl] for it in items])).to(dev)
                for lvl in range(len(items[0]["img_data"]))]
        seg_size = tuple(seg.shape[1:3])
        with torch.autocast(dev.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            scores, ft = multi_scale_forward(
                self.model, pyramid, seg_size,
                want_ft=self.method == "knn")
        outs = []
        for i in range(scores.shape[0]):
            conf = compute_conf(scores[i], self.method,
                                ft=None if ft is None else ft[i],
                                exclude_back=self.exclude_back,
                                seg_size=seg_size)
            pred = scores[i].argmax(-1)
            label = seg[i].long()
            valid = label >= 0
            inter, union = intersection_and_union_torch(pred, label,
                                                        self.num_class)
            counts = torch.stack([(valid & (pred == label)).sum(),
                                  valid.sum()])
            out = {"inter": inter, "union": union, "counts": counts}
            if self.device_metrics:
                out["ood"] = torch.stack(ood_measures_from_maps(
                    conf, label, out_labels=self.out_labels)).float()
            else:
                out["conf"] = conf.float()
            if self.visualize_dir or not self.device_metrics:
                out["pred"] = pred
            outs.append(out)
        # one device -> host copy per tensor; blocks until the batch is
        # done (the device metrics are read back in _record)
        return [{k: v if k == "ood" else v.cpu().numpy()
                 for k, v in o.items()} for o in outs]

    def _timed(self, loader):
        """Iterate ``loader``, timing each wait for the next item."""
        it = iter(loader)
        while True:
            tic = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.wait_meter.update(time.perf_counter() - tic)
            yield item

    def _record(self, item, out):
        tic = time.perf_counter()
        if self.device_metrics:
            auroc, aupr, fpr, valid = out["ood"].tolist()
            res = (auroc, aupr, fpr) if valid else None
        else:
            res = eval_ood_measure(out["conf"], item["seg_label"][0],
                                   out_labels=self.out_labels)
        self.metric_meter.update(time.perf_counter() - tic)
        if res is not None:
            self.aurocs.append(res[0])
            self.auprs.append(res[1])
            self.fprs.append(res[2])
        acc_sum, valid_sum = (int(v) for v in out["counts"])
        acc = acc_sum / (valid_sum + 1e-10)
        self.acc_meter.update(acc, valid_sum)
        self.intersection_meter.update(out["inter"])
        self.union_meter.update(out["union"])
        if self.visualize_dir:
            save_result_grid(item["img_ori"], item["seg_label"][0],
                             out["pred"], item["info"], self.visualize_dir)
        # with device metrics the conf map (and the prediction, unless
        # visualised) stay on the device: None here
        return {"conf": out.get("conf"), "pred": out.get("pred"), "acc": acc,
                "ood": res}

    def _run(self, items):
        tic = time.perf_counter()
        outs = self._device_batch(items)
        dt = (time.perf_counter() - tic) / len(items)
        results = []
        for item, out in zip(items, outs):
            self.time_meter.update(dt)
            results.append(self._record(item, out))
        return results

    # ------------------------------------------------------------------
    def evaluate_item(self, item: dict):
        return self._run([item])[0]

    def evaluate(self, loader, progress: bool = True):
        for i, item in enumerate(self._timed(loader)):
            self.evaluate_item(item)
            if progress and (i + 1) % 10 == 0:
                print(f"[{i + 1}] avg inference time: "
                      f"{self.time_meter.average():.4f}s, "
                      f"running accuracy: "
                      f"{self.acc_meter.average() * 100:.2f}%", flush=True)
        return self.summary()

    def evaluate_batched(self, loader, batch_size: int = 8,
                         progress: bool = False):
        """Stream the eval in batches of up to ``batch_size`` images, one
        forward per pyramid level per batch. Items are grouped by shape
        signature (pyramid shapes and label shape), so a mixed-size tree
        batches per group. The same numbers as :meth:`evaluate` up to the
        conv algorithms' batch-size-dependent rounding."""
        pending: dict = {}
        for item in self._timed(loader):
            if "img_raw" in item:
                sig = ("raw", item["img_raw"].shape,
                       tuple(item["pyramid_shapes"]), item["seg_label"].shape)
            else:
                sig = (tuple(p.shape for p in item["img_data"]),
                       item["seg_label"].shape)
            group = pending.setdefault(sig, [])
            group.append(item)
            if len(group) >= batch_size:
                self._run(pending.pop(sig))
        for group in pending.values():
            self._run(group)
        return self.summary(verbose=progress)

    def summary(self, verbose: bool = True) -> dict:
        iou = self.intersection_meter.sum / (self.union_meter.sum + 1e-10)
        result = {
            "class_iou": iou,
            "mean_iou": float(iou.mean()),
            "accuracy": float(self.acc_meter.average()),
            "inference_time": float(self.time_meter.average()),
            "metric_time": float(self.metric_meter.average()),
            # None when items were fed one by one, without a loader
            "wait_time": (float(self.wait_meter.average())
                          if self.wait_meter.initialized else None),
            "images": int(self.time_meter.count),
            "auroc": float(np.mean(self.aurocs)) if self.aurocs else None,
            "aupr": float(np.mean(self.auprs)) if self.auprs else None,
            "fpr": float(np.mean(self.fprs)) if self.fprs else None,
        }
        if verbose:
            for i, v in enumerate(iou):
                print("class [{}], IoU: {:.4f}".format(i, v))
            print("[Eval Summary]:")
            print("Mean IoU: {:.4f}, Accuracy: {:.2f}%, Inference Time: "
                  "{:.4f}s".format(result["mean_iou"],
                                   result["accuracy"] * 100,
                                   result["inference_time"]))
            print("mean auroc = ", result["auroc"],
                  "mean aupr = ", result["aupr"],
                  " mean fpr = ", result["fpr"])
        return result
