"""The LPIPS nets: AlexNet / VGG16 feature stages and their linear heads.

Counterpart of ``metrics_tpu/models/lpips.py``: the fixed input scaling
layer, the backbone's feature stages, the channel-unit-normalised squared
differences, the 1 x 1 heads and the spatial average, summed over the
stages. The modules carry the ``lpips`` package's names
(``scaling_layer.shift``/``.scale``, ``net.sliceK.I`` with the global
torchvision ``features`` index ``I``, ``linK.model.1``), so its state dict
loads with ``load_state_dict``. The convolutions run at full float32 on
the card (:func:`metrics_tpu_torch.models.full_float32_convs`).

Weights are not bundled: :func:`build_lpips` reads the same ``.npz`` the
JAX package's ``build_lpips`` reads (carried across by
:func:`metrics_tpu_torch.convert.lpips_from_flax`), and raises without one.
"""
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from metrics_tpu_torch.convert import lpips_from_flax
from metrics_tpu_torch.models import full_float32_convs
from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor

# fixed normalization constants from the LPIPS scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# backbone stage layouts: (out_channels, kernel, stride, padding, pool_before)
_ALEX_STAGES = (
    ((64, 11, 4, 2, False),),
    ((192, 5, 1, 2, True),),
    ((384, 3, 1, 1, True),),
    ((256, 3, 1, 1, False),),
    ((256, 3, 1, 1, False),),
)
_VGG_STAGES = (
    ((64, 3, 1, 1, False), (64, 3, 1, 1, False)),
    ((128, 3, 1, 1, True), (128, 3, 1, 1, False)),
    ((256, 3, 1, 1, True), (256, 3, 1, 1, False), (256, 3, 1, 1, False)),
    ((512, 3, 1, 1, True), (512, 3, 1, 1, False), (512, 3, 1, 1, False)),
    ((512, 3, 1, 1, True), (512, 3, 1, 1, False), (512, 3, 1, 1, False)),
)
_NET_STAGES = {"alex": _ALEX_STAGES, "vgg": _VGG_STAGES}
#: max-pool window before a stage: 3 for AlexNet, 2 for VGG (stride 2)
_POOL_WINDOW = {"alex": 3, "vgg": 2}


class ScalingLayer(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT, dtype=torch.float32).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE, dtype=torch.float32).view(1, 3, 1, 1))

    def forward(self, x: Tensor) -> Tensor:
        return (x - self.shift) / self.scale


class NetLinLayer(nn.Module):
    """A 1 x 1 head without bias, behind the ``lpips`` package's dropout
    (an identity in eval mode), so its weight is ``model.1.weight``."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x: Tensor) -> Tensor:
        return self.model(x)


def _backbone_layers(net_type: str) -> List[Tuple[int, int, nn.Module]]:
    """``(stage, global index, layer)`` of the torchvision ``features``
    stack that the ``lpips`` package slices: per conv an optional max pool,
    the conv and its ReLU."""
    layers = []
    in_ch = 3
    pool = _POOL_WINDOW[net_type]
    for k, stage in enumerate(_NET_STAGES[net_type]):
        for out_ch, kernel, stride, pad, pool_before in stage:
            if pool_before:
                layers.append((k, nn.MaxPool2d(pool, 2)))
            layers.append((k, nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=pad)))
            layers.append((k, nn.ReLU()))
            in_ch = out_ch
    return [(k, i, layer) for i, (k, layer) in enumerate(layers)]


class _Slices(nn.Module):
    """``slice1`` ... ``slice5``, each a ``Sequential`` whose submodules are
    named by their global index in ``features``."""

    def __init__(self, net_type: str) -> None:
        super().__init__()
        self.n_slices = len(_NET_STAGES[net_type])
        slices = [nn.Sequential() for _ in range(self.n_slices)]
        for k, i, layer in _backbone_layers(net_type):
            slices[k].add_module(str(i), layer)
        for k, seq in enumerate(slices):
            setattr(self, f"slice{k + 1}", seq)

    def forward(self, x: Tensor) -> List[Tensor]:
        outputs = []
        for k in range(self.n_slices):
            x = getattr(self, f"slice{k + 1}")(x)
            outputs.append(x)
        return outputs


def _unit_normalize(feat: Tensor) -> Tensor:
    norm = torch.sqrt(torch.sum(feat * feat, dim=1, keepdim=True))
    return feat / (norm + 1e-10)


class LPIPSNet(nn.Module):
    """Full LPIPS: scaling -> backbone stages -> normalised difference ->
    heads -> spatial mean, summed over stages. Inputs are NCHW in [-1, 1];
    the output is ``[N]``."""

    def __init__(self, net_type: str = "alex") -> None:
        super().__init__()
        if net_type not in _NET_STAGES:
            raise ValueError(f"Argument `net_type` must be one of {tuple(_NET_STAGES)}, but got {net_type}.")
        self.net_type = net_type
        self.scaling_layer = ScalingLayer()
        self.net = _Slices(net_type)
        channels = [stage[-1][0] for stage in _NET_STAGES[net_type]]
        for k, c in enumerate(channels):
            setattr(self, f"lin{k}", NetLinLayer(c))

    def forward(self, img1: Tensor, img2: Tensor) -> Tensor:
        feats1 = self.net(self.scaling_layer(img1.to(torch.float32)))
        feats2 = self.net(self.scaling_layer(img2.to(torch.float32)))
        total = 0.0
        for k, (f1, f2) in enumerate(zip(feats1, feats2)):
            diff = (_unit_normalize(f1) - _unit_normalize(f2)) ** 2
            head = getattr(self, f"lin{k}")(diff)
            total = total + head.mean(dim=(2, 3))  # spatial average
        return total[:, 0]


class LPIPSScorer:
    """``(img1, img2) -> [N]`` LPIPS scores of an :class:`LPIPSNet` (what
    :func:`build_lpips` returns): no autograd, full float32 convolutions."""

    def __init__(self, model: LPIPSNet) -> None:
        self.model = model

    def to(self, device: Any) -> "LPIPSScorer":
        self.model.to(_resolve_device(device))
        return self

    def __call__(self, img1: Tensor, img2: Tensor) -> Tensor:
        with torch.no_grad(), full_float32_convs(img1.device):
            return self.model(img1, img2)


def build_lpips(net_type: str = "alex", weights_path: Optional[str] = None, device: Optional[Any] = None) -> LPIPSScorer:
    """An ``(img1, img2) -> [N]`` LPIPS scorer on ``device`` (the card
    unless ``device="cpu"``), its weights read from the JAX package's
    ``.npz``."""
    if net_type not in _NET_STAGES:
        raise ValueError(f"Argument `net_type` must be one of {tuple(_NET_STAGES)}, but got {net_type}.")
    if weights_path is None:
        raise ValueError(
            "The bundled LPIPS net needs pretrained weights for meaningful values and none"
            " are bundled (no network access). Provide `weights_path` (an .npz produced by"
            " `metrics_tpu.models.lpips.convert_lpips_weights`, or by"
            " `metrics_tpu_torch.convert.lpips_to_flax` and `np.savez`), or pass a callable `net`."
        )
    variables = np.load(weights_path, allow_pickle=True)["variables"].item()
    model = LPIPSNet(net_type)
    model.load_state_dict(lpips_from_flax(variables, net_type))
    model.eval().requires_grad_(False)
    model.to(_resolve_device(device))
    return LPIPSScorer(model)
