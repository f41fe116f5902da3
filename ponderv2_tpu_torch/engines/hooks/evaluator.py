"""Per-epoch evaluator (counterpart of ``SemSegEvaluator`` in
``ponderv2_tpu/engines/hooks/evaluator.py``).

``SemSegEvaluator`` runs the val loader through eval-mode forwards, computes
per-class IoU on the host, and puts the metric scalars into EventStorage and
``comm_info["current_metric_value"]`` for CheckpointSaver. Not ported yet:
the nearest-neighbour projection of voxel predictions onto raw points (val
batches that carry ``origin_coord``; it needs ``ops/pointops.knn_query``) and
the ScanNet200 head/common/tail split report.
"""

from __future__ import annotations

import numpy as np

from ...utils import comm
from ...utils.misc import intersection_and_union
from .builder import HOOKS
from .default import HookBase


@HOOKS.register_module()
class SemSegEvaluator(HookBase):
    def __init__(self, write_cls_iou: bool = False):
        self.write_cls_iou = write_cls_iou

    def after_epoch(self):
        if self.trainer.cfg.get("evaluate", True) and self.trainer.val_loader is not None:
            self.eval()

    def eval(self):
        trainer = self.trainer
        logger = trainer.logger
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        num_classes = trainer.cfg.data.num_classes
        ignore_index = trainer.cfg.data.get("ignore_index", -1)
        inter_sum = np.zeros(num_classes)
        union_sum = np.zeros(num_classes)
        target_sum = np.zeros(num_classes)
        losses = []
        for i, input_dict in enumerate(trainer.val_loader):
            if "origin_coord" in input_dict:
                raise NotImplementedError(
                    "SemSegEvaluator: projecting onto origin_coord needs "
                    "knn_query, not ported yet")
            out = trainer.eval_step(input_dict)
            seg_logits = out["seg_logits"].float().cpu().numpy()
            if "loss" in out:
                losses.append(float(out["loss"]))
            pred = seg_logits.argmax(-1)
            segment = np.asarray(input_dict["segment"])
            valid = np.asarray(input_dict["batch"]) >= 0
            pred = np.where(valid, pred, ignore_index)
            segment = np.where(valid, segment, ignore_index)
            inter, union, target = intersection_and_union(
                pred, segment, num_classes, ignore_index
            )
            inter_sum += inter
            union_sum += union
            target_sum += target
            mask = union != 0
            batch_iou = (inter[mask] / np.maximum(union[mask], 1)).mean() if mask.any() else 0.0
            logger.info(
                f"Test: [{i + 1}/{len(trainer.val_loader)}] iou {batch_iou:.4f}"
            )

        # cross-process reduction of the histogram counters
        reduced = comm.reduce_dict(
            {
                **{f"i{c}": inter_sum[c] for c in range(num_classes)},
                **{f"u{c}": union_sum[c] for c in range(num_classes)},
                **{f"t{c}": target_sum[c] for c in range(num_classes)},
            },
            average=False,
        )
        inter_sum = np.array([reduced[f"i{c}"] for c in range(num_classes)])
        union_sum = np.array([reduced[f"u{c}"] for c in range(num_classes)])
        target_sum = np.array([reduced[f"t{c}"] for c in range(num_classes)])

        iou_class = inter_sum / (union_sum + 1e-10)
        acc_class = inter_sum / (target_sum + 1e-10)
        m_iou = float(np.mean(iou_class))
        m_acc = float(np.mean(acc_class))
        all_acc = float(inter_sum.sum() / (target_sum.sum() + 1e-10))
        logger.info(
            f"Val result: mIoU/mAcc/allAcc {m_iou:.4f}/{m_acc:.4f}/{all_acc:.4f}"
        )
        names = self.trainer.cfg.data.get("names", list(range(num_classes)))
        if self.write_cls_iou:
            for c in range(num_classes):
                logger.info(
                    f"Class_{c}-{names[c]} Result: iou/accuracy "
                    f"{iou_class[c]:.4f}/{acc_class[c]:.4f}"
                )
        storage = trainer.storage
        storage.put_scalar("val/mIoU", m_iou, smoothing_hint=False)
        storage.put_scalar("val/mAcc", m_acc, smoothing_hint=False)
        storage.put_scalar("val/allAcc", all_acc, smoothing_hint=False)
        if losses:
            storage.put_scalar("val/loss", float(np.mean(losses)), smoothing_hint=False)
        trainer.comm_info["current_metric_value"] = m_iou
        trainer.comm_info["current_metric_name"] = "mIoU"
        logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
