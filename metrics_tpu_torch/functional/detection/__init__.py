"""Functional detection: box operations and the COCO mAP kernels."""
from metrics_tpu_torch.functional.detection.box_ops import box_area, box_convert, box_iou  # noqa: F401

__all__ = ["box_area", "box_convert", "box_iou"]
