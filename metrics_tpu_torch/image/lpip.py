"""Learned Perceptual Image Patch Similarity (LPIPS).

Counterpart of ``metrics_tpu/image/lpip.py``: sum and count states,
[-1, 1] NCHW input validation, mean or sum reduction. ``net`` is any
callable ``(img1, img2) -> [N]`` scorer, or the bundled AlexNet/VGG LPIPS
(``models/lpips.py``) on the metric's device, from a weights file.

The value-range check reads the two images' extremes from the card in one
host read per update; under the capture rule of ``utils/checks.py`` it
reads nothing and checks the shapes alone, as the JAX package skips it on
tracers. So a fused collection update captures the metric.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.models.lpips import build_lpips
from metrics_tpu_torch.utils.checks import checks_read_nothing

Tensor = torch.Tensor


def _valid_img(img: Tensor, lo_hi: Optional[Tuple[float, float]]) -> bool:
    """``[N, 3, H, W]`` with values in [-1, 1]; ``lo_hi`` is its
    ``(min, max)`` as read, None where nothing is read (the capture rule)."""
    if not (img.ndim == 4 and img.shape[1] == 3):
        return False
    return lo_hi is None or (lo_hi[0] >= -1.0 and lo_hi[1] <= 1.0)


def _read_ranges(img1: Tensor, img2: Tensor) -> Tuple[Optional[Tuple[float, float]], ...]:
    """``(min, max)`` of each image, read from the card in one host copy;
    ``(None, None)`` under the capture rule of ``utils/checks.py`` or when
    an image is empty or misshapen (its shape fails the check first)."""
    if checks_read_nothing() or not all(img.ndim == 4 and img.numel() for img in (img1, img2)):
        return None, None
    values = torch.stack([v.to(torch.float64) for img in (img1, img2) for v in torch.aminmax(img.detach())]).tolist()
    return (values[0], values[1]), (values[2], values[3])


class LearnedPerceptualImagePatchSimilarity(Metric):
    """Average LPIPS between image batches (lower = perceptually closer).

    Args:
        net_type: 'alex' or 'vgg' for the bundled net (requires
            ``net_weights_path``), ignored when ``net`` is given.
        net: a callable ``(img1, img2) -> [N]`` LPIPS scorer.
        reduction: 'mean' or 'sum' over all accumulated image pairs.
        net_weights_path: the JAX package's LPIPS ``.npz``
            (``metrics_tpu.models.lpips.convert_lpips_weights``, or
            ``metrics_tpu_torch.convert.lpips_to_flax``), or an ``lpips``
            state dict or its ``.pth`` file (``build_lpips``).
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(
        self,
        net_type: str = "alex",
        reduction: str = "mean",
        net: Optional[Callable] = None,
        net_weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        if net is not None:
            if not callable(net):
                raise TypeError("Argument `net` must be callable")
            self.net = net
        else:
            self.net = build_lpips(net_type, net_weights_path, device=self.device)

        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction

        self.add_state("sum_scores", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def to_device(self, device: Union[str, torch.device]) -> Metric:
        out = super().to_device(device)
        if hasattr(self.net, "to"):
            self.net.to(self.device)
        return out

    def _update(self, img1: Tensor, img2: Tensor) -> None:
        range1, range2 = _read_ranges(img1, img2)
        if not (_valid_img(img1, range1) and _valid_img(img2, range2)):
            raise ValueError(
                "Expected both input arguments to be normalized tensors (all values in range [-1,1])"
                f" and to have shape [N, 3, H, W] but `img1` have shape {img1.shape} with values in"
                f" range {[float(img1.min()), float(img1.max())]} and `img2` have shape {img2.shape}"
                f" with value in range {[float(img2.min()), float(img2.max())]}"
            )
        loss = torch.squeeze(self.net(img1, img2))
        self.sum_scores = self.sum_scores + torch.sum(loss)
        self.total = self.total + img1.shape[0]

    def _compute(self) -> Tensor:
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores
