"""GROVE training losses, masked static-shape formulation.

Counterpart of `grove_tpu/ops/losses.py` (reference `model/GROVE.py:
339-408` and the shifted CE of `llava_llama.py:114-125`). Fixed-shape
tensors and masks instead of the reference's ragged lists:

  pred_boxes        (B, T, P, 4)  cxcywh in [0, 1]
  pred_obj_logits   (B, T, P)
  gt_boxes          (B, T, P, 4)  cxcywh, zero-padded
  gt_objectness     (B, T, P)     1 where the phrase's object is visible
  phrase_mask       (B, P)        1 for the sample's real phrases

Normalization as the reference: GIoU and L1 summed over the (frame, phrase)
entries with a GT box and divided by their count (+1e-8); the objectness
BCE over every valid (frame, phrase) entry, divided by that count; the L1
term weighted by `giou_weight`, a reference quirk kept on purpose
(`model/GROVE.py:375`). Everything in fp32.

`count_reduce` (data parallelism): a function that sums a count over the
data-parallel ranks. Each count (CE targets, boxes, objectness entries)
then is the global batch's, as in JAX's one SPMD loss over the global
batch (`losses.py:47-48, 83-98`), and each rank's terms are its share:
their sum over the ranks is the global loss, and so are the gradients.
"""

from __future__ import annotations

from typing import Dict

import torch

from .boxes import box_cxcywh_to_xyxy, generalized_box_iou_loss


def _count(c, count_reduce):
    return c if count_reduce is None else count_reduce(c)


def cross_entropy_lm_loss(logits, labels, ignore_index: int = -100,
                          count_reduce=None):
    """Shifted next-token CE, mean over the targets that are not
    `ignore_index`. logits (B, L, V); labels (B, L) int."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != ignore_index
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / _count(valid.sum(), count_reduce).clamp_min(1)


def bce_with_logits(logits, targets):
    """Elementwise binary cross entropy on logits, in the stable
    max(x, 0) - x t + log1p(exp(-|x|)) form, fp32."""
    x, t = logits.float(), targets.float()
    return x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def grove_box_losses(pred_boxes, pred_obj_logits, gt_boxes, gt_objectness,
                     phrase_mask, *, giou_weight: float = 1.0,
                     objectness_weight: float = 1.0,
                     use_temp_objectness: bool = True,
                     eps: float = 1e-8,
                     count_reduce=None) -> Dict[str, torch.Tensor]:
    """Masked GIoU + L1 + objectness BCE with the reference's
    normalization."""
    pred_boxes, gt_boxes = pred_boxes.float(), gt_boxes.float()
    frame_phrase_mask = phrase_mask.float()[:, None, :]        # (B, 1, P)
    box_mask = frame_phrase_mask * gt_objectness.float()       # (B, T, P)

    giou_elem = generalized_box_iou_loss(box_cxcywh_to_xyxy(pred_boxes),
                                         box_cxcywh_to_xyxy(gt_boxes))
    giou_sum = (giou_elem * box_mask).sum()
    l1_sum = ((pred_boxes - gt_boxes).abs().sum(-1) * box_mask).sum()
    num_bboxes = _count(box_mask.sum(), count_reduce)
    out = {"giou_loss": giou_weight * giou_sum / (num_bboxes + eps),
           "l1_loss": giou_weight * l1_sum / (num_bboxes + eps),
           "num_bboxes": num_bboxes}
    if use_temp_objectness:
        obj_elem = bce_with_logits(pred_obj_logits, gt_objectness)
        obj_mask = frame_phrase_mask.expand(obj_elem.shape)
        num_max_bboxes = _count(obj_mask.sum(), count_reduce)
        out["temp_objectness_loss"] = (
            objectness_weight * (obj_elem * obj_mask).sum()
            / (num_max_bboxes + eps))
        out["num_max_bboxes"] = num_max_bboxes
    return out


def grove_total_loss(lm_logits, labels, pred_boxes, pred_obj_logits,
                     gt_boxes, gt_objectness, phrase_mask, *,
                     ce_weight: float = 1.0, giou_weight: float = 1.0,
                     objectness_weight: float = 1.0,
                     use_temp_objectness: bool = True,
                     ignore_index: int = -100,
                     count_reduce=None) -> Dict[str, torch.Tensor]:
    """The loss dict: `loss` = CE + GIoU + L1 (+ objectness BCE), and each
    term under its own `*_loss` key."""
    ce = ce_weight * cross_entropy_lm_loss(lm_logits, labels, ignore_index,
                                           count_reduce)
    parts = grove_box_losses(
        pred_boxes, pred_obj_logits, gt_boxes, gt_objectness, phrase_mask,
        giou_weight=giou_weight, objectness_weight=objectness_weight,
        use_temp_objectness=use_temp_objectness, count_reduce=count_reduce)
    total = ce + parts["giou_loss"] + parts["l1_loss"]
    if use_temp_objectness:
        total = total + parts["temp_objectness_loss"]
    return {"loss": total, "ce_loss": ce,
            **{k: v for k, v in parts.items() if k.endswith("loss")}}
