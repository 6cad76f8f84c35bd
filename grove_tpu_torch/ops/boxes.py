"""Box coordinate math on tensors whose last dimension is 4.

Counterpart of `grove_tpu/ops/boxes.py` (reference `utils/bbox_utils.py:
4-80` and torchvision's `generalized_box_iou_loss`, `model/GROVE.py:361`),
elementwise over aligned boxes as the losses use them.
"""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(boxes):
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(boxes):
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def box_area(boxes_xyxy):
    return ((boxes_xyxy[..., 2] - boxes_xyxy[..., 0])
            * (boxes_xyxy[..., 3] - boxes_xyxy[..., 1]))


def _inter(a, b):
    wh = (torch.minimum(a[..., 2:], b[..., 2:])
          - torch.maximum(a[..., :2], b[..., :2])).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def box_iou_pairwise(boxes1_xyxy, boxes2_xyxy, eps: float = 1e-7):
    """Elementwise IoU of aligned box tensors (same leading shape)."""
    inter = _inter(boxes1_xyxy, boxes2_xyxy)
    union = box_area(boxes1_xyxy) + box_area(boxes2_xyxy) - inter
    return inter / (union + eps)


def generalized_box_iou(boxes1_xyxy, boxes2_xyxy, eps: float = 1e-7):
    """Elementwise GIoU = IoU - (area(C) - union) / area(C), C the smallest
    enclosing box (degenerate-safe)."""
    inter = _inter(boxes1_xyxy, boxes2_xyxy)
    union = box_area(boxes1_xyxy) + box_area(boxes2_xyxy) - inter
    iou = inter / (union + eps)
    wh = (torch.maximum(boxes1_xyxy[..., 2:], boxes2_xyxy[..., 2:])
          - torch.minimum(boxes1_xyxy[..., :2], boxes2_xyxy[..., :2])
          ).clamp_min(0.0)
    enclose = wh[..., 0] * wh[..., 1]
    return iou - (enclose - union) / (enclose + eps)


def generalized_box_iou_loss(boxes1_xyxy, boxes2_xyxy, eps: float = 1e-7):
    """Elementwise GIoU loss = 1 - GIoU (the caller reduces)."""
    return 1.0 - generalized_box_iou(boxes1_xyxy, boxes2_xyxy, eps)
