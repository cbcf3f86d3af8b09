"""The FID InceptionV3 feature extractor of FID, KID and IS.

Counterpart of ``metrics_tpu/models/inception.py``: the TF-slim
"inception-v3-compat" topology of torch-fidelity's
``FeatureExtractorInceptionV3``, with the four FID feature depths (64, 192,
768, 2048), the 1008-way logits and the unbiased logits (no bias term).
The submodules carry torch-fidelity's names (``Conv2d_1a_3x3`` ...
``Mixed_7c``, the branch names of ``_BLOCK_LAYOUT``, ``fc``), so a
torch-fidelity state dict loads with ``load_state_dict``.

``BasicConv2d`` is a convolution, a ``BatchNorm2d(eps=1e-3)`` in eval mode
and a ReLU, kept apart (folding the norm into the convolution would change
the rounding). The layouts translate from Flax's NHWC/HWIO: ``"SAME"`` at
stride 1 is the symmetric ``(k - 1) // 2`` pad, ``nn.max_pool`` is VALID,
the SAME average pool excludes its pad, and the last block's SAME max pool
pads with ``-inf`` (``F.max_pool2d``'s own pad). The input is resized to
299 x 299 as ``jax.image.resize(..., "bilinear")`` does: antialiased where
an axis shrinks, plain bilinear where none does, untouched at 299 x 299;
then scaled to [-1, 1]. The logits' product is taken in float64 and rounded
once, and the convolutions run at full float32 on the card
(:func:`metrics_tpu_torch.models.full_float32_convs`).

Weights are not bundled: :func:`build_fid_inception` reads the same
``.npz`` the JAX package's ``build_fid_inception`` reads (its Flax variable
tree, carried across by :func:`metrics_tpu_torch.convert.inception_from_flax`),
and raises without one.
"""
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metrics_tpu_torch.convert import inception_from_flax
from metrics_tpu_torch.functional.pairwise.helpers import _matmul_t
from metrics_tpu_torch.models import full_float32_convs
from metrics_tpu_torch.utils.checks import checks_read_nothing
from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor

FID_FEATURE_DEPTHS = (64, 192, 768, 2048)

#: the extractor's input side
INPUT_SIZE = 299


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm(eps=1e-3, running statistics) + ReLU."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Tuple[int, int]],
        stride: int = 1,
        padding: Union[int, Tuple[int, int]] = 0,
    ) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x: Tensor) -> Tensor:
    return F.avg_pool2d(x, kernel_size=3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x: Tensor) -> Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b2 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        b4 = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch3x3(x)
        b2 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b1, b2, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int) -> None:
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b2 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        b3 = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            b3 = conv(b3)
        b4 = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch3x3_2(self.branch3x3_1(x))
        b2 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b1, b2, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    """The last blocks; ``pool`` is ``"avg"`` (Mixed_7b) or ``"max"``
    (Mixed_7c, the FID-compat quirk)."""

    def __init__(self, in_channels: int, pool: str = "avg") -> None:
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b2 = self.branch3x3_1(x)
        b2 = torch.cat([self.branch3x3_2a(b2), self.branch3x3_2b(b2)], dim=1)
        b3 = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        b3 = torch.cat([self.branch3x3dbl_3a(b3), self.branch3x3dbl_3b(b3)], dim=1)
        if self.pool == "avg":
            b4 = _avg_pool3(x)
        else:
            b4 = F.max_pool2d(x, kernel_size=3, stride=1, padding=1)
        b4 = self.branch_pool(b4)
        return torch.cat([b1, b2, b3, b4], dim=1)


def resize_and_scale(x: Tensor) -> Tensor:
    """``[N, 3, H, W]`` images to float32 299 x 299 in [-1, 1]: resized as
    ``jax.image.resize(..., "bilinear")`` (antialiased where an axis
    shrinks), then integer images scaled from [0, 255] and float images
    from [0, 1]. The range follows the dtype, as in the JAX package."""
    is_int = not x.is_floating_point()
    x = x.to(torch.float32)
    h, w = x.shape[-2:]
    if (h, w) != (INPUT_SIZE, INPUT_SIZE):
        shrinks = h > INPUT_SIZE or w > INPUT_SIZE
        x = F.interpolate(x, size=(INPUT_SIZE, INPUT_SIZE), mode="bilinear", align_corners=False, antialias=shrinks)
    return x / 127.5 - 1.0 if is_int else x * 2.0 - 1.0


class InceptionV3FID(nn.Module):
    """FID-compat InceptionV3 returning the requested feature depth.

    Input: uint8 or float images ``[N, 3, H, W]``, resized to 299 x 299 and
    scaled to [-1, 1] inside. ``feature`` is a depth of
    ``FID_FEATURE_DEPTHS``, ``"logits_unbiased"``, or anything else for the
    logits.
    """

    def __init__(self, num_classes: int = 1008) -> None:
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, pool_features=32)
        self.Mixed_5c = InceptionA(256, pool_features=64)
        self.Mixed_5d = InceptionA(288, pool_features=64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, channels_7x7=128)
        self.Mixed_6c = InceptionC(768, channels_7x7=160)
        self.Mixed_6d = InceptionC(768, channels_7x7=160)
        self.Mixed_6e = InceptionC(768, channels_7x7=192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="avg")
        self.Mixed_7c = InceptionE(2048, pool="max")
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: Tensor, feature: Union[int, str] = 2048) -> Tensor:
        x = resize_and_scale(x)
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = _max_pool(x)
        if feature == 64:
            return x.mean(dim=(2, 3))

        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = _max_pool(x)
        if feature == 192:
            return x.mean(dim=(2, 3))

        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a):
            x = block(x)
        for block in (self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        if feature == 768:
            return x.mean(dim=(2, 3))

        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        x = x.mean(dim=(2, 3))  # [N, 2048]
        if feature == 2048:
            return x

        # torch-fidelity's unbiased logits drop the bias term
        unbiased = _matmul_t(x, self.fc.weight)
        return unbiased if feature == "logits_unbiased" else unbiased + self.fc.bias


# torch-fidelity / pytorch-fid module names for each Flax submodule, in the
# order the Flax `@nn.compact` bodies create them (creation order defines the
# auto-generated ``BasicConv2d_<i>`` names).
_STEM_CONVS = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1", "Conv2d_4a_3x3")
_A_BRANCHES = ("branch1x1", "branch5x5_1", "branch5x5_2",
               "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool")
_B_BRANCHES = ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3")
_C_BRANCHES = ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
               "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
               "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool")
_D_BRANCHES = ("branch3x3_1", "branch3x3_2", "branch7x7x3_1",
               "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4")
_E_BRANCHES = ("branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
               "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
               "branch3x3dbl_3b", "branch_pool")
_BLOCK_LAYOUT = (
    # (flax submodule name, torch module name, torch branch-conv order)
    ("InceptionA_0", "Mixed_5b", _A_BRANCHES),
    ("InceptionA_1", "Mixed_5c", _A_BRANCHES),
    ("InceptionA_2", "Mixed_5d", _A_BRANCHES),
    ("InceptionB_0", "Mixed_6a", _B_BRANCHES),
    ("InceptionC_0", "Mixed_6b", _C_BRANCHES),
    ("InceptionC_1", "Mixed_6c", _C_BRANCHES),
    ("InceptionC_2", "Mixed_6d", _C_BRANCHES),
    ("InceptionC_3", "Mixed_6e", _C_BRANCHES),
    ("InceptionD_0", "Mixed_7a", _D_BRANCHES),
    ("InceptionE_0", "Mixed_7b", _E_BRANCHES),
    ("InceptionE_1", "Mixed_7c", _E_BRANCHES),
)


def _validate_max(mx: float) -> None:
    if mx > 1.5:
        raise ValueError(
            "Float images must be in [0, 1] (got max value"
            f" {mx:.3g}). Pass uint8 images for the [0, 255] range."
        )


class FIDInceptionExtractor:
    """``imgs -> [N, d]`` features of one depth of :class:`InceptionV3FID`
    (what :func:`build_fid_inception` returns).

    Float inputs are range-checked: a float image holding [0, 255] values
    would be mis-scaled by the dtype-keyed normalisation. Host inputs
    (numpy, CPU tensors) are checked at once; card tensors one batch late:
    the max is taken on the card and read at the next call, when it has
    long finished, so no call waits for the card. :meth:`finalize` reads
    the last batch's (FID, KID and IS call it in ``compute``). Under the
    capture rule of ``utils/checks.py`` (a fused update's probe and
    capture) the check reads and takes nothing, as the JAX package skips
    it on tracers.
    """

    def __init__(self, model: InceptionV3FID, feature: Union[int, str]) -> None:
        self.model = model
        self.feature = feature
        self._pending_max: Optional[Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.model.fc.weight.device

    def to(self, device: Any) -> "FIDInceptionExtractor":
        self.model.to(_resolve_device(device))
        return self

    def __call__(self, imgs: Any) -> Tensor:
        if not isinstance(imgs, Tensor):
            imgs = torch.as_tensor(np.asarray(imgs), device=self.device)
        if imgs.is_floating_point() and not checks_read_nothing():
            if imgs.device.type == "cpu":
                _validate_max(float(imgs.max()))
            else:
                if self._pending_max is not None:
                    pending, self._pending_max = self._pending_max, None
                    _validate_max(float(pending))
                self._pending_max = torch.amax(imgs)
        with torch.no_grad(), full_float32_convs(imgs.device):
            return self.model(imgs, self.feature)

    def finalize(self) -> None:
        """Read the pending range check of the last card batch."""
        if self._pending_max is not None:
            pending, self._pending_max = self._pending_max, None
            _validate_max(float(pending))


def build_fid_inception(
    feature: Union[int, str] = 2048, weights_path: Optional[str] = None, device: Optional[Any] = None
) -> FIDInceptionExtractor:
    """An ``imgs -> [N, d]`` extractor of the InceptionV3 on ``device``
    (the card unless ``device="cpu"``), its weights read from the JAX
    package's ``.npz``.

    Raises when no weights are given: FID/KID/IS values from a randomly
    initialised network are meaningless. Pass a callable ``feature`` to the
    metrics to use another extractor.
    """
    if weights_path is None:
        raise ValueError(
            "The bundled InceptionV3 needs pretrained weights for meaningful FID/KID/IS values"
            " and none are bundled (no network access). Provide"
            " `feature_extractor_weights_path` (an .npz produced by"
            " `metrics_tpu.models.inception.convert_torch_fidelity_weights`, or by"
            " `metrics_tpu_torch.convert.inception_to_flax` and `np.savez`),"
            " or pass a callable `feature` extractor."
        )
    variables = np.load(weights_path, allow_pickle=True)["variables"].item()
    state = inception_from_flax(variables)
    model = InceptionV3FID()
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or set(missing) - {"fc.weight", "fc.bias"}:
        raise KeyError(f"weights do not fit the InceptionV3: missing {missing}, unexpected {unexpected}")
    if missing and feature not in FID_FEATURE_DEPTHS:
        raise KeyError(f"feature {feature!r} needs the logits layer, which the weights file lacks (`Dense_0`)")
    model.eval().requires_grad_(False)
    model.to(_resolve_device(device))
    return FIDInceptionExtractor(model, feature)
