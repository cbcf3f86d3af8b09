"""Box operations on ``[..., 4]`` tensors (torchvision.ops equivalents).

Counterpart of ``metrics_tpu/functional/detection/box_ops.py``: plain
PyTorch, batched over any leading dims. :func:`box_iou` is the plain
broadcast that the card's IoU kernels hold to
(:func:`metrics_tpu_torch.ops.box_iou.box_iou_broadcast`): the JAX
package's operation order, equal to its jnp broadcast bit for bit.
"""
import torch

from metrics_tpu_torch.ops.box_iou import box_iou_broadcast as box_iou  # noqa: F401

Tensor = torch.Tensor

_ALLOWED_FMTS = ("xyxy", "xywh", "cxcywh")


def box_convert(boxes: Tensor, in_fmt: str, out_fmt: str) -> Tensor:
    """Convert ``[..., 4]`` boxes between the xyxy, xywh and cxcywh formats."""
    if in_fmt not in _ALLOWED_FMTS or out_fmt not in _ALLOWED_FMTS:
        raise ValueError(f"Unsupported Bounding Box Conversions for given in_fmt {in_fmt} and out_fmt {out_fmt}")
    if in_fmt == out_fmt:
        return boxes

    a, b, c, d = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    if in_fmt == "xywh":  # -> xyxy
        x1, y1, x2, y2 = a, b, a + c, b + d
    elif in_fmt == "cxcywh":  # -> xyxy
        x1, y1, x2, y2 = a - c / 2, b - d / 2, a + c / 2, b + d / 2
    else:
        x1, y1, x2, y2 = a, b, c, d

    if out_fmt == "xyxy":
        out = (x1, y1, x2, y2)
    elif out_fmt == "xywh":
        out = (x1, y1, x2 - x1, y2 - y1)
    else:
        out = ((x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1)
    return torch.stack(out, dim=-1)


def box_area(boxes: Tensor) -> Tensor:
    """Area of ``[..., 4]`` xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
