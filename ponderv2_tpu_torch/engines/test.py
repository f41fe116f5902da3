"""Testers: inference with TTA/fragment voting, classification and part
segmentation.

Counterpart of ``ponderv2_tpu/engines/test.py`` (``TesterBase``,
``SemSegTester``, ``ClsTester``, ``PartSegTester``). Per scene the dataset
emits aug x fragment variants; each fragment is collated, run through the
model under ``torch.inference_mode()`` on the tester's device, and its
softmax probabilities are added into the full-resolution cloud by fragment
index; the argmax is scored against the labels and, with ``submit``,
written as the dataset's submission file (``write_submission``).
``ClsTester`` scores ``cls_logits`` by overall accuracy; ``PartSegTester``
scores each sample's parts within its category (``category2part``). Each
``test`` logs as the JAX one does and returns its metrics as a dict.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict

import numpy as np
import torch

from ..datasets import build_dataset
from ..datasets.utils import collate_fn
from ..models import build_model
from ..utils import comm
from ..utils.logger import get_root_logger
from ..utils.misc import AverageMeter, intersection_and_union
from ..utils.registry import Registry
from .common import resolve_device, split_batch, with_condition

TESTERS = Registry("testers")


class TesterBase:
    """Runs on ``cfg.device``, else on CUDA (raising without it). Weights come from
    ``cfg.weight``: a file holding the port's ``state_dict`` (or a dict with
    it under ``state_dict``), e.g. written from a JAX checkpoint through
    ``utils.convert.state_dict_from_jax_spunet``."""

    def __init__(self, cfg):
        self.logger = get_root_logger(
            log_file=os.path.join(cfg.save_path, "test.log")
            if cfg.get("save_path") else None
        )
        self.cfg = cfg
        self.device = resolve_device(cfg)
        self.model = self.build_model().to(self.device).eval()
        self.test_dataset = self.build_test_dataset()
        self.static_ctx = dict(
            spatial_shape=tuple(cfg.get("sparse_shape", (1024, 1024, 1024))),
            batch_size=1,
        )
        # per-forward records: wall seconds (host to logits on the host) and
        # the model's contract flag
        self.fragment_seconds = []
        self.contract_ok = []

    def build_model(self):
        model = build_model(dict(self.cfg.model))
        self.load_weights(model)
        return model

    def load_weights(self, model: torch.nn.Module) -> None:
        weight = self.cfg.get("weight")
        if not weight or not os.path.isfile(weight):
            raise FileNotFoundError(f"checkpoint not found: {weight}")
        state = torch.load(weight, map_location="cpu", weights_only=True)
        state = state.get("state_dict", state)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        self.logger.info(f"Loaded weight from {weight}")

    def build_test_dataset(self):
        return build_dataset(dict(self.cfg.data.test))

    def eval_fragment(self, arrays: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """One fragment's forward: its arrays (and its ``condition``, a str)
        to the device, the outputs back on the host."""
        t0 = time.perf_counter()
        inputs = {k: torch.as_tensor(v, device=self.device) if k != "condition" else v
                  for k, v in arrays.items()}
        with torch.inference_mode():
            out = self.model({**inputs, **self.static_ctx})
        out = {k: v.cpu().numpy() for k, v in out.items()}
        self.fragment_seconds.append(time.perf_counter() - t0)
        self.contract_ok.append(bool(out.get("contract_ok", True)))
        return out

    def test(self):
        raise NotImplementedError


@TESTERS.register_module()
class SemSegTester(TesterBase):
    def test(self):
        logger = self.logger
        cfg = self.cfg
        dataset = self.test_dataset
        num_classes = cfg.data.num_classes
        ignore_index = cfg.data.get("ignore_index", -1)
        point_budget = cfg.get("point_budget_test", cfg.get("point_budget"))
        save_path = cfg.get("save_path", ".")
        submit = cfg.get("submit", False)

        os.makedirs(os.path.join(save_path, "result"), exist_ok=True)
        if submit:
            os.makedirs(os.path.join(save_path, "submit"), exist_ok=True)
        logger.info(">>>>>>>>>>>>>>>> Start Testing >>>>>>>>>>>>>>>>")
        inter_sum = np.zeros(num_classes)
        union_sum = np.zeros(num_classes)
        target_sum = np.zeros(num_classes)
        batch_meter = AverageMeter()

        indices = list(range(len(dataset)))
        indices = indices[comm.get_rank():: comm.get_world_size()]
        records = {}
        for n, idx in enumerate(indices):
            t0 = time.perf_counter()
            data_dict = dataset[idx]
            name = data_dict["name"]
            segment = np.asarray(data_dict.get("segment"))
            pred_save_path = os.path.join(save_path, "result", f"{name}_pred.npy")
            if os.path.isfile(pred_save_path):
                # per-scene resume: reuse the cached prediction
                logger.info(f"{name}: loaded cached prediction")
                final = np.load(pred_save_path)
                if segment is not None and segment.ndim > 0:
                    inter, union, target = intersection_and_union(
                        final, segment, num_classes, ignore_index)
                    inter_sum += inter
                    union_sum += union
                    target_sum += target
                    records[name] = dict(intersection=inter, union=union,
                                         target=target)
                if submit:
                    self.write_submission(name, final, save_path)
                continue
            fragments = data_dict["fragment_list"]
            num_points = (
                segment.shape[0] if segment is not None and segment.ndim > 0
                else max(int(f["index"].max()) + 1 for f in fragments)
            )
            pred = np.zeros((num_points, num_classes), np.float32)
            for frag in fragments:
                # "index" rides through collation so the vote scatter stays
                # aligned under collate's row sort; padding rows carry -1
                batch = collate_fn([dict(frag)], point_budget=point_budget,
                                   scene_budget=1)
                out = self.eval_fragment(with_condition(*split_batch(batch)))
                valid = np.asarray(batch["batch"]) >= 0
                index = np.asarray(batch["index"])[valid]
                logits = out["seg_logits"][valid]
                probs = np.exp(logits - logits.max(-1, keepdims=True))
                probs /= probs.sum(-1, keepdims=True)
                pred[index] += probs
            final = pred.argmax(-1)
            batch_meter.update(time.perf_counter() - t0)

            if segment is not None and segment.ndim > 0:
                inter, union, target = intersection_and_union(
                    final, segment, num_classes, ignore_index)
                inter_sum += inter
                union_sum += union
                target_sum += target
                mask = union != 0
                iou = (inter[mask] / np.maximum(union[mask], 1)).mean() if mask.any() else 0
                acc = inter.sum() / max(target.sum(), 1)
                records[name] = dict(intersection=inter, union=union, target=target)
                logger.info(
                    f"Test: {name} [{n + 1}/{len(indices)}]-{num_points} "
                    f"Batch {batch_meter.val:.3f} ({batch_meter.avg:.3f}) "
                    f"Accuracy {acc:.4f} mIoU {iou:.4f}"
                )
            np.save(pred_save_path, final)
            if submit:
                self.write_submission(name, final, save_path)

        gathered = comm.gather(records, dst=0)
        metrics = None
        if comm.is_main_process():
            merged = {}
            for r in gathered:
                merged.update(r)
            if merged:
                inter_sum = sum(v["intersection"] for v in merged.values())
                union_sum = sum(v["union"] for v in merged.values())
                target_sum = sum(v["target"] for v in merged.values())
            iou_class = inter_sum / (union_sum + 1e-10)
            acc_class = inter_sum / (target_sum + 1e-10)
            m_iou = float(np.mean(iou_class))
            m_acc = float(np.mean(acc_class))
            all_acc = float(inter_sum.sum() / (target_sum.sum() + 1e-10))
            logger.info(
                f"Syncing ... Val result: mIoU/mAcc/allAcc "
                f"{m_iou:.4f}/{m_acc:.4f}/{all_acc:.4f}"
            )
            names = cfg.data.get("names", [str(i) for i in range(num_classes)])
            for c in range(num_classes):
                logger.info(
                    f"Class_{c} - {names[c]} Result: iou/accuracy "
                    f"{iou_class[c]:.4f}/{acc_class[c]:.4f}"
                )
            metrics = dict(m_iou=m_iou, m_acc=m_acc, all_acc=all_acc,
                           iou_class=iou_class)
        logger.info("<<<<<<<<<<<<<<<<< End Testing <<<<<<<<<<<<<<<<<")
        return metrics

    def write_submission(self, name: str, pred: np.ndarray, save_path: str):
        """Per-dataset submission writers (JAX ``test.py:221-241``):
        ScanNet's class ids ``VALID_CLASS_IDS_20[pred]`` to ``{name}.txt``;
        nuScenes' lidarseg ``uint8(pred + 1)`` to ``{name}_lidarseg.bin``;
        otherwise ``pred`` to ``{name}.txt``."""
        data_cfg = dict(self.cfg.data.test)
        ds_type = data_cfg.get("type", "")
        submit_dir = os.path.join(save_path, "submit")
        if "ScanNet" in ds_type:
            from ..datasets.scannet import VALID_CLASS_IDS_20

            remapped = np.asarray(VALID_CLASS_IDS_20)[pred]
            np.savetxt(os.path.join(submit_dir, f"{name}.txt"), remapped, fmt="%d")
        elif "NuScenes" in ds_type:
            np.asarray(pred + 1, np.uint8).tofile(
                os.path.join(submit_dir, f"{name}_lidarseg.bin"))
        else:
            np.savetxt(os.path.join(submit_dir, f"{name}.txt"), pred, fmt="%d")


def _one_sample(tester, data):
    """One test sample collated alone, through ``eval_fragment``: (the
    collated batch, the model's outputs on the host)."""
    batch = collate_fn([data], point_budget=tester.cfg.get("point_budget"))
    return batch, tester.eval_fragment(with_condition(*split_batch(batch)))


@TESTERS.register_module()
class ClsTester(TesterBase):
    """Overall accuracy of ``cls_logits``' argmax against ``category``."""

    def test(self):
        num_classes = self.cfg.data.num_classes
        inter_sum = np.zeros(num_classes)
        union_sum = np.zeros(num_classes)
        target_sum = np.zeros(num_classes)
        for i in range(len(self.test_dataset)):
            batch, out = _one_sample(self, self.test_dataset[i])
            pred = np.asarray(out["cls_logits"]).argmax(-1)
            target = np.asarray(batch["category"]).reshape(-1)
            inter, union, t = intersection_and_union(pred, target, num_classes)
            inter_sum += inter
            union_sum += union
            target_sum += t
        acc = inter_sum.sum() / (target_sum.sum() + 1e-10)
        self.logger.info(f"Test result: allAcc {acc:.4f}")
        return dict(all_acc=float(acc))


@TESTERS.register_module()
class PartSegTester(TesterBase):
    """Part segmentation (JAX ``test.py:269-323``): per sample, the IoU of
    each part of its category (``category2part``), 1.0 for a part absent
    from both the labels and the prediction; ins.mIoU over samples and
    cat.mIoU over categories."""

    def test(self):
        logger = self.logger
        num_classes = self.cfg.data.num_classes
        ds = self.test_dataset
        categories = list(getattr(ds, "categories", ()) or
                          self.cfg.data.get("categories", ())) or ["all"]
        category2part = getattr(ds, "category2part", None) or self.cfg.data.get(
            "category2part", {"all": list(range(num_classes))})
        num_categories = len(categories)
        iou_category = np.zeros(num_categories)
        iou_count = np.zeros(num_categories)
        for i in range(len(ds)):
            batch, out = _one_sample(self, ds[i])
            valid = np.asarray(batch["batch"]) >= 0
            pred = np.asarray(out["seg_logits"]).argmax(-1)[valid]
            label = np.asarray(batch["segment"])[valid]
            ci = 0
            if "category" in batch:
                ci = int(np.asarray(batch["category"]).reshape(-1)[0])
            elif "cls_token" in batch:
                ci = int(np.asarray(batch["cls_token"]).reshape(-1)[0])
            ci = min(max(ci, 0), num_categories - 1)
            parts = category2part.get(categories[ci], list(range(num_classes)))
            parts_iou = np.zeros(len(parts))
            for j, part in enumerate(parts):
                if (label == part).sum() == 0 and (pred == part).sum() == 0:
                    parts_iou[j] = 1.0  # part absent in both: perfect
                else:
                    inter = np.sum((label == part) & (pred == part))
                    union = np.sum((label == part) | (pred == part))
                    parts_iou[j] = inter / (union + 1e-10)
            iou_category[ci] += parts_iou.mean()
            iou_count[ci] += 1
        ins_miou = iou_category.sum() / (iou_count.sum() + 1e-10)
        cat_miou = float((iou_category / (iou_count + 1e-10)).mean())
        logger.info(f"Test result: ins.mIoU/cat.mIoU {ins_miou:.4f}/{cat_miou:.4f}")
        for ci in range(num_categories):
            logger.info(
                f"Class_{ci}-{categories[ci]} Result: iou_cat/num_sample "
                f"{iou_category[ci] / (iou_count[ci] + 1e-10):.4f}/"
                f"{int(iou_count[ci])}")
        return dict(ins_miou=float(ins_miou), cat_miou=cat_miou,
                    iou_category=iou_category, iou_count=iou_count)
