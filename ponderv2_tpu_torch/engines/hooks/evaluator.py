"""Per-epoch evaluators (counterparts of ``SemSegEvaluator``,
``ClsEvaluator`` and ``InsSegEvaluator`` in
``ponderv2_tpu/engines/hooks/evaluator.py``).

``SemSegEvaluator`` runs the val loader through eval-mode forwards, computes
per-class IoU on the host, and puts the metric scalars into EventStorage and
``comm_info["current_metric_value"]`` for CheckpointSaver; where the class
names fall in ScanNet200's head/common/tail tables
(``datasets/preprocessing/scannet200_splits.py``) it also stores each
split's mIoU as ``val/mIoU_{head,common,tail}``.
``ClsEvaluator`` scores a classifier's ``cls_logits`` by overall accuracy.
``InsSegEvaluator`` clusters each val scene's shifted points into instance
proposals on the host and scores them by the ScanNet AP protocol
(``_associate_scene``, ``_scannet_ap`` and ``evaluate_instance_ap`` are
copies of the JAX functions, numpy only). On val batches that carry the
original points (``origin_coord``, ``origin_segment``, ``origin_batch``:
a ``Copy`` before ``GridSample``), ``SemSegEvaluator`` projects each
voxel's prediction onto the points nearest to it (``ops/pointops.knn_query``
in f32 on the trainer's device) and scores the original points, as the JAX
evaluator would; its input pipeline cannot give it those keys (F14).
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.pointops import knn_query
from ...utils import comm
from ...utils.misc import intersection_and_union
from .builder import HOOKS
from .default import HookBase


def _category_split_masks(names):
    """Boolean masks over ``names`` for the ScanNet200 head/common/tail splits
    (benchmark-defined frequency split; see
    datasets/preprocessing/scannet200_splits.py). Returns () unless every
    split has a name among ``names`` — e.g. for 20-class ScanNet or numeric
    placeholder names. (The JAX function returns () only when no name falls
    in any split, so on ScanNet's 20 names, 18 of which are head
    categories, it reports a "head" mIoU: ROADMAP Queue 3 F13.)"""
    from ...datasets.preprocessing.scannet200_splits import (
        COMMON_CATS_SCANNET_200, HEAD_CATS_SCANNET_200, TAIL_CATS_SCANNET_200,
    )

    names = [str(n) for n in names]
    masks = []
    for split, cats in (
        ("head", HEAD_CATS_SCANNET_200),
        ("common", COMMON_CATS_SCANNET_200),
        ("tail", TAIL_CATS_SCANNET_200),
    ):
        cat_set = set(cats)
        masks.append((split, np.asarray([n in cat_set for n in names])))
    if not all(m.any() for _, m in masks):
        return ()
    return tuple(masks)


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
            out = trainer.eval_step(input_dict)
            seg_logits = out["seg_logits"].float().cpu().numpy()
            if "loss" in out:
                losses.append(float(out["loss"]))
            pred = seg_logits.argmax(-1)
            segment = np.asarray(input_dict["segment"])
            valid = np.asarray(input_dict["batch"]) >= 0
            if "origin_coord" in input_dict:
                # project voxel predictions back to raw points by nearest
                # neighbor among the live voxel rows, in f32 as the JAX
                # evaluator (CenterShift hands over float64), by the direct
                # distance form: the expanded one's ~1e-5 m^2 error at
                # ScanNet's |x| ~ 5 m picks another voxel at near-ties and
                # changes labels there
                live = np.flatnonzero(valid)
                dev = trainer.device
                coord, batch = (torch.as_tensor(np.asarray(input_dict[k])[live]).to(dev)
                                for k in ("coord", "batch"))
                origin, origin_batch = (torch.as_tensor(np.asarray(input_dict[k])).to(dev)
                                        for k in ("origin_coord", "origin_batch"))
                idx, _ = knn_query(1, coord.float(), batch, origin.float(), origin_batch,
                                   direct=True)
                pred = pred[live[idx[:, 0].cpu().numpy()]]
                segment = np.asarray(input_dict["origin_segment"])
                valid = np.asarray(input_dict["origin_batch"]) >= 0
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
        # ScanNet200 protocol: report per-frequency-split mIoU when the class
        # list matches the head/common/tail tables (no-op for other datasets)
        split_metrics = {}
        if len(names) == num_classes:
            for split, mask in _category_split_masks(names):
                if mask.any():
                    split_metrics[split] = float(np.mean(iou_class[mask]))
        for split, v in split_metrics.items():
            logger.info(f"Val result ({split}): mIoU {v:.4f}")
        storage = trainer.storage
        storage.put_scalar("val/mIoU", m_iou, smoothing_hint=False)
        storage.put_scalar("val/mAcc", m_acc, smoothing_hint=False)
        storage.put_scalar("val/allAcc", all_acc, smoothing_hint=False)
        for split, v in split_metrics.items():
            storage.put_scalar(f"val/mIoU_{split}", v, smoothing_hint=False)
        losses = [x for part in comm.all_gather(losses) for x in part]  # every rank's
        if losses:
            storage.put_scalar("val/loss", float(np.mean(losses)), smoothing_hint=False)
        trainer.comm_info["current_metric_value"] = m_iou
        trainer.comm_info["current_metric_name"] = "mIoU"
        logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")


@HOOKS.register_module()
class ClsEvaluator(HookBase):
    """Overall accuracy of a classifier's ``cls_logits`` over the val loader,
    stored as ``val/allAcc`` and handed to CheckpointSaver."""

    def after_epoch(self):
        if self.trainer.cfg.get("evaluate", True) and self.trainer.val_loader is not None:
            self.eval()

    def eval(self):
        trainer = self.trainer
        num_classes = trainer.cfg.data.num_classes
        inter_sum = np.zeros(num_classes)
        union_sum = np.zeros(num_classes)
        target_sum = np.zeros(num_classes)
        for input_dict in trainer.val_loader:
            out = trainer.eval_step(input_dict)
            pred = out["cls_logits"].float().cpu().numpy().argmax(-1)
            target = np.asarray(input_dict["category"]).reshape(-1)
            inter, union, t = intersection_and_union(pred, target, num_classes)
            inter_sum += inter
            union_sum += union
            target_sum += t
        # the counters over the ranks, each of which scored its share of the
        # val objects (the JAX evaluator scores every object on every process)
        reduced = comm.reduce_dict({"i": inter_sum.sum(), "t": target_sum.sum()},
                                   average=False)
        acc = float(reduced["i"] / (reduced["t"] + 1e-10))
        trainer.logger.info(f"Val result: allAcc {acc:.4f}")
        trainer.storage.put_scalar("val/allAcc", acc, smoothing_hint=False)
        trainer.comm_info["current_metric_value"] = acc
        trainer.comm_info["current_metric_name"] = "allAcc"


def _associate_scene(preds, gt, valid_classes, segment_ignore_index,
                     min_region_size):
    """Associate one scene's predictions with its gt instances.

    Mirrors reference ``associate_instances`` (hooks/evaluator.py:233-306):
    gt instances take the segment id at their first occurrence; predictions
    below ``min_region_size`` are dropped; each prediction records its
    ``void_intersection`` (overlap with ignored-segment points) and the pair
    intersections with every gt instance of its class.
    """
    inst = np.asarray(gt["instance"])
    seg = np.asarray(gt["segment"])
    void_mask = np.isin(seg, list(segment_ignore_index))

    gt_instances = {c: [] for c in valid_classes}
    ids, first, counts = np.unique(inst, return_index=True, return_counts=True)
    for iid, fi, cnt in zip(ids, first, counts):
        if iid < 0:
            continue
        cls = int(seg[fi])
        if cls in segment_ignore_index or cls not in gt_instances:
            continue
        gt_instances[cls].append(dict(
            instance_id=int(iid), segment_id=cls, vert_count=int(cnt),
            matched_pred=[],
        ))

    pred_instances = {c: [] for c in valid_classes}
    uid = 0
    for p in preds:
        cls = int(p["cls"])
        if cls in segment_ignore_index or cls not in pred_instances:
            continue
        mask = np.asarray(p["mask"], bool)
        vert_count = int(np.count_nonzero(mask))
        if vert_count < min_region_size:
            continue  # reference: skip tiny proposals entirely
        pred_inst = dict(
            uuid=uid, confidence=float(p["score"]), vert_count=vert_count,
            void_intersection=int(np.count_nonzero(void_mask & mask)),
            matched_gt=[],
        )
        uid += 1
        for gt_inst in gt_instances[cls]:
            intersection = int(np.count_nonzero(
                (inst == gt_inst["instance_id"]) & mask
            ))
            if intersection > 0:
                pred_inst["matched_gt"].append(
                    dict(gt_inst, intersection=intersection)
                )
                gt_inst["matched_pred"].append(
                    dict(pred_inst, intersection=intersection,
                         matched_gt=None)
                )
        pred_instances[cls].append(pred_inst)
    return gt_instances, pred_instances


def _scannet_ap(y_true, y_score, hard_false_negatives):
    """ScanNet-protocol AP from matched flags + confidences
    (reference hooks/evaluator.py:429-480, incl. ScanNet PR #26 fix)."""
    order = np.argsort(y_score)
    y_score_sorted = y_score[order]
    y_true_sorted = y_true[order]
    y_true_cumsum = np.cumsum(y_true_sorted)
    thresholds, unique_idx = np.unique(y_score_sorted, return_index=True)
    num_prec_recall = len(unique_idx) + 1
    num_examples = len(y_score_sorted)
    num_true = y_true_cumsum[-1] if len(y_true_cumsum) > 0 else 0
    precision = np.zeros(num_prec_recall)
    recall = np.zeros(num_prec_recall)
    y_true_cumsum = np.append(y_true_cumsum, 0)
    for res_i, score_i in enumerate(unique_idx):
        cumsum = y_true_cumsum[score_i - 1]
        tp = num_true - cumsum
        fp = num_examples - score_i - tp
        fn = cumsum + hard_false_negatives
        precision[res_i] = float(tp) / (tp + fp)
        recall[res_i] = float(tp) / (tp + fn)
    precision[-1] = 1.0
    recall[-1] = 0.0
    recall_conv = np.append(np.append(recall[0], recall), 0.0)
    step_widths = np.convolve(recall_conv, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


def evaluate_instance_ap(
    scene_preds,
    scene_gts,
    num_classes,
    segment_ignore_index=(-1, 0, 1),
    min_region_size=100,
):
    """ScanNet-protocol instance AP (reference hooks/evaluator.py:233-510).

    Full protocol: greedy per-threshold matching with global pred_visited,
    duplicate matches demoted to false positives at the lower confidence,
    unmatched gts as hard false negatives, unmatched predictions discounted
    when mostly covered by void/ignored/small-gt points
    (``proportion_ignore > overlap_th``), and the ScanNet step-width PR
    integration.

    scene_preds: per scene, list of dicts {mask (N,), cls, score}.
    scene_gts: per scene, dict {instance (N,), segment (N,)}.
    Returns dict(mAP, mAP25, mAP50, ap_table (T+... x num_classes)).
    """
    overlaps = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
    valid_classes = [
        c for c in range(num_classes) if c not in segment_ignore_index
    ]
    scenes = [
        _associate_scene(p, g, valid_classes, segment_ignore_index,
                         min_region_size)
        for p, g in zip(scene_preds, scene_gts)
    ]

    ap_table = np.full((len(overlaps), num_classes), np.nan)
    for oi, overlap_th in enumerate(overlaps):
        for c in valid_classes:
            pred_visited = {
                (si, p["uuid"]): False
                for si, (_, pi) in enumerate(scenes)
                for p in pi[c]
            }
            y_true = np.empty(0)
            y_score = np.empty(0)
            hard_false_negatives = 0
            has_gt = has_pred = False
            for si, (gt_instances, pred_instances) in enumerate(scenes):
                gts = [g for g in gt_instances[c]
                       if g["vert_count"] >= min_region_size]
                if gts:
                    has_gt = True
                if pred_instances[c]:
                    has_pred = True
                cur_true = np.ones(len(gts))
                cur_score = np.full(len(gts), -np.inf)
                cur_match = np.zeros(len(gts), bool)
                for gi, g in enumerate(gts):
                    found_match = False
                    for p in g["matched_pred"]:
                        if pred_visited[(si, p["uuid"])]:
                            continue
                        overlap = p["intersection"] / (
                            g["vert_count"] + p["vert_count"]
                            - p["intersection"]
                        )
                        if overlap > overlap_th:
                            confidence = p["confidence"]
                            if cur_match[gi]:
                                # duplicate: lower-confidence match is an FP
                                max_s = max(cur_score[gi], confidence)
                                min_s = min(cur_score[gi], confidence)
                                cur_score[gi] = max_s
                                cur_true = np.append(cur_true, 0)
                                cur_score = np.append(cur_score, min_s)
                                cur_match = np.append(cur_match, True)
                            else:
                                found_match = True
                                cur_match[gi] = True
                                cur_score[gi] = confidence
                                pred_visited[(si, p["uuid"])] = True
                    if not found_match:
                        hard_false_negatives += 1
                cur_true = cur_true[cur_match]
                cur_score = cur_score[cur_match]
                # unmatched predictions -> FP unless mostly void/ignored
                for p in pred_instances[c]:
                    found_gt = False
                    for g in p["matched_gt"]:
                        overlap = g["intersection"] / (
                            g["vert_count"] + p["vert_count"]
                            - g["intersection"]
                        )
                        if overlap > overlap_th:
                            found_gt = True
                            break
                    if not found_gt:
                        num_ignore = p["void_intersection"]
                        for g in p["matched_gt"]:
                            if (g["segment_id"] in segment_ignore_index
                                    or g["vert_count"] < min_region_size):
                                num_ignore += g["intersection"]
                        if num_ignore / p["vert_count"] <= overlap_th:
                            cur_true = np.append(cur_true, 0)
                            cur_score = np.append(cur_score, p["confidence"])
                y_true = np.append(y_true, cur_true)
                y_score = np.append(y_score, cur_score)

            if has_gt and has_pred:
                ap = _scannet_ap(y_true, y_score, hard_false_negatives)
            elif has_gt:
                ap = 0.0
            else:
                ap = float("nan")
            ap_table[oi, c] = ap

    o25 = np.isclose(overlaps, 0.25)
    o50 = np.isclose(overlaps, 0.5)

    def _mean(sel):
        vals = ap_table[np.ix_(sel, valid_classes)]
        return float(np.nanmean(vals)) if np.isfinite(vals).any() else 0.0

    return dict(
        mAP25=_mean(o25),
        mAP50=_mean(o50),
        mAP=_mean(~o25),
        ap_table=ap_table,
    )


def split_scenes(input_dict, proposals):
    """Per scene of a collated val batch: its proposals' masks over its
    rows, and its ground truth ``instance`` and ``segment``, as
    ``evaluate_instance_ap`` takes them. Padding rows (batch -1) belong to
    no scene."""
    batch = np.asarray(input_dict["batch"])
    preds, gts = [], []
    for b in np.unique(batch[batch >= 0]):
        sel = batch == b
        preds.append([dict(mask=p["mask"][sel], cls=p["cls"], score=p["score"])
                      for p in proposals if p["batch"] == b])
        gts.append(dict(instance=np.asarray(input_dict["instance"])[sel],
                        segment=np.asarray(input_dict["segment"])[sel]))
    return preds, gts


@HOOKS.register_module()
class InsSegEvaluator(HookBase):
    """Instance segmentation evaluator: eval-mode forwards for the semantic
    logits and offsets (moved to the host once per batch), host clustering
    (``model.propose_instances``), ScanNet AP matching
    (``evaluate_instance_ap``). Puts ``val/mAP``, ``val/mAP50`` and
    ``val/mAP25`` into storage; ``mAP50`` is the checkpoint metric. Each
    batch's ``condition`` reaches the model (``Trainer.eval_step``), which
    the JAX evaluator drops (ROADMAP Queue 3)."""

    def __init__(self, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1):
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index

    def after_epoch(self):
        if self.trainer.cfg.get("evaluate", True) and self.trainer.val_loader is not None:
            self.eval()

    def eval(self):
        trainer = self.trainer
        logger = trainer.logger
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        num_classes = trainer.cfg.data.num_classes
        model = trainer.model
        scene_preds, scene_gts = [], []
        for input_dict in trainer.val_loader:
            out = trainer.eval_step(input_dict)
            seg_logits = out["seg_logits"].float().cpu().numpy()
            bias_pred = out["bias_pred"].float().cpu().numpy()
            proposals = model.propose_instances(
                np.asarray(input_dict["coord"]), seg_logits, bias_pred,
                np.asarray(input_dict["batch"]))
            preds, gts = split_scenes(input_dict, proposals)
            scene_preds += preds
            scene_gts += gts
        all_preds = [p for r in comm.all_gather(scene_preds) for p in r]
        all_gts = [g for r in comm.all_gather(scene_gts) for g in r]
        result = evaluate_instance_ap(
            all_preds, all_gts, num_classes, self.segment_ignore_index)
        logger.info(
            f"Val result: mAP/mAP50/mAP25 {result['mAP']:.4f}/"
            f"{result['mAP50']:.4f}/{result['mAP25']:.4f}")
        storage = trainer.storage
        storage.put_scalar("val/mAP", result["mAP"], smoothing_hint=False)
        storage.put_scalar("val/mAP50", result["mAP50"], smoothing_hint=False)
        storage.put_scalar("val/mAP25", result["mAP25"], smoothing_hint=False)
        trainer.comm_info["current_metric_value"] = result["mAP50"]
        trainer.comm_info["current_metric_name"] = "mAP50"
        logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
