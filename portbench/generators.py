"""Seeded input generators of the benchmark, frozen here so that a change to
the program cannot move the inputs.

Every input is made on the run's device from one ``torch.Generator`` seeded
with the run's ``--seed``, in a few large calls, in the dtype the program is
handed (float32 scores, int64 labels). The same seed on the same kind of
device gives the same inputs; a seed may be any integer below 2**63.

* :func:`softmax_classes` -- ImageNet-shaped softmax rows: Gaussian logits
  with the true class lifted by ``margin``, so that the top-1 rate is what
  the configuration assumes (76.1% at margin 3.99 over 1000 classes: the
  true logit beats 999 standard normals with that probability) and the
  confusion matrix piles on its diagonal as a real model's does.
* :func:`click_stream` -- a display-ads click log: a click with probability
  ``positive_rate``, the model's score ``sigmoid(randn + lift * click)``
  (the stream of the repository's bring-up script, ``make_ctr_stream``).
"""
from typing import List, Tuple

import torch

Tensor = torch.Tensor


def generator(seed: int, device: torch.device) -> torch.Generator:
    """The run's generator on ``device``, seeded with ``seed`` (taken
    modulo 2**63, so any whole number the driver draws is accepted)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g


def softmax_classes(g: torch.Generator, rows: int, classes: int, margin: float, device: torch.device) -> Tuple[Tensor, Tensor]:
    """``(preds [rows, classes] float32 softmax rows, target [rows] int64)``."""
    target = torch.randint(0, classes, (rows,), generator=g, device=device, dtype=torch.int64)
    logits = torch.randn((rows, classes), generator=g, device=device, dtype=torch.float32)
    logits[torch.arange(rows, device=device), target] += margin
    return torch.softmax(logits, dim=1), target


def click_stream(g: torch.Generator, rows: int, positive_rate: float, lift: float, device: torch.device) -> Tuple[Tensor, Tensor]:
    """``(score [rows] float32, clicked [rows] int64)``."""
    clicked = torch.rand((rows,), generator=g, device=device) < positive_rate
    noise = torch.randn((rows,), generator=g, device=device, dtype=torch.float32)
    score = torch.sigmoid(noise + lift * clicked.to(torch.float32))
    return score, clicked.to(torch.int64)


def batches(tensors: Tuple[Tensor, ...], batch: int, lo: int = 0, hi: int = -1) -> List[Tuple[Tensor, ...]]:
    """Rows ``[lo, hi)`` of ``tensors`` cut into consecutive batches of
    ``batch`` rows (the last one ragged), as views."""
    hi = tensors[0].shape[0] if hi < 0 else hi
    return [tuple(t[start : min(start + batch, hi)] for t in tensors) for start in range(lo, hi, batch)]
