"""Kernel Inception Distance (polynomial MMD over feature subsets).

Counterpart of ``metrics_tpu/image/kid.py``. By default the features
stream into two fixed-size Gumbel-key reservoirs (``sketches/reservoir.py``)
of ``reservoir_size`` rows each, with a ``"merge"``-reduced leaf that unions
across ranks. While a stream fits its reservoir the rows are the exact
features in arrival order, so the subset draws (host ``RandomState``, the
same indices as the JAX package's) give ``exact=True``'s value bit for bit;
beyond it, subsets come from a uniform sample of the stream. ``exact=True``
keeps the feature lists.

The reservoirs' width is the extractor's: known at construction for the
bundled InceptionV3, learnt at the first update for a callable, which
keeps the instance on a fused update's eager leg until then (the states do
not exist before). After that the update reads nothing from the card and
captures. The per-rank key seed takes the ``torch.distributed`` rank (0
outside a process group). The kernel products are taken in float64 and
rounded once to float32 (no TF32 flag changes them).
"""
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.pairwise.helpers import _matmul_t
from metrics_tpu_torch.image.fid import _ExtractorMixin
from metrics_tpu_torch.models.inception import build_fid_inception
from metrics_tpu_torch.parallel.distributed import process_index
from metrics_tpu_torch.sketches.compat import register_exact_list_states, warn_exact_buffer
from metrics_tpu_torch.sketches.reservoir import (
    reservoir_fill,
    reservoir_init,
    reservoir_insert,
    reservoir_merge_fx,
    reservoir_rows,
)
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


def maximum_mean_discrepancy(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor) -> Tensor:
    """Unbiased MMD^2 estimate from kernel matrices."""
    m = k_xx.shape[0]

    kt_xx_sum = torch.sum(k_xx) - torch.sum(torch.diagonal(k_xx))
    kt_yy_sum = torch.sum(k_yy) - torch.sum(torch.diagonal(k_yy))
    k_xy_sum = torch.sum(k_xy)

    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    return value - 2 * k_xy_sum / (m**2)


def poly_kernel(
    f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> Tensor:
    """Polynomial kernel."""
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    return (_matmul_t(f1, f2) * gamma + coef) ** degree


def poly_mmd(
    f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> Tensor:
    """Polynomial-kernel MMD."""
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


class KernelInceptionDistance(_ExtractorMixin, Metric):
    """Computes KID (mean and std of polynomial MMD over random subsets)."""

    __exact_mode_attr__ = "_exact"
    #: ``self.inception(imgs)`` is a fixed-shape tensor program (the static
    #: analysis models it as a torch op; a user extractor that is not is
    #: caught by the fused update's stale-manifest retry)
    __traced_callable_attrs__ = ("inception",)
    is_differentiable = False
    higher_is_better = False

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        seed: Optional[int] = None,
        feature_extractor_weights_path: Optional[str] = None,
        exact: bool = False,
        reservoir_size: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        feature_dim: Optional[int] = None
        if isinstance(feature, int):
            valid_int_input = (64, 192, 768, 2048)
            if feature not in valid_int_input:
                raise ValueError(
                    f"Integer input to argument `feature` must be one of {valid_int_input}, but got {feature}."
                )
            self.inception = build_fid_inception(feature, feature_extractor_weights_path, self.device)
            feature_dim = feature  # the bundled heads emit [N, depth] features
        elif callable(feature):
            self.inception = feature
        else:
            raise TypeError("Got unknown input to argument `feature`")

        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        self._rng = np.random.RandomState(seed)

        self._exact = bool(exact)
        if reservoir_size is None:
            reservoir_size = max(2 * subset_size, 2048)
        if not (isinstance(reservoir_size, int) and reservoir_size >= subset_size):
            raise ValueError(
                "Argument `reservoir_size` expected to be an int >= `subset_size`,"
                f" got {reservoir_size}"
            )
        self._reservoir_size = reservoir_size
        # per-rank key stream: identical seeds across ranks would draw
        # identical priorities and bias the cross-rank reservoir union
        self._key_seed = (0 if seed is None else int(seed)) * 1_000_003 + process_index()

        if self._exact:
            register_exact_list_states(self, ("real_features", "fake_features"), dist_reduce_fx=None)
            warn_exact_buffer("KernelInceptionDistance", "extracted features")
        elif feature_dim is not None:
            self._init_reservoirs(feature_dim)
        else:
            # a callable's width is learnt at the first update, which adds
            # the states: that update runs eagerly
            self.__dict__["__jit_unsafe__"] = True

    _feature_dim: Optional[int] = None

    def _init_reservoirs(self, feature_dim: int) -> None:
        self._feature_dim = feature_dim
        for side in ("real", "fake"):
            self.add_state(
                f"{side}_features",
                default=reservoir_init(self._reservoir_size, feature_dim, self.device),
                dist_reduce_fx=reservoir_merge_fx(),
            )
        for side in ("real", "fake"):
            self.add_state(f"n_seen_{side}", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.__dict__.pop("__jit_unsafe__", None)

    def load_state_dict(self, state_dict: Any, prefix: str = "") -> None:
        """A checkpoint restores before the first update even for callable
        extractors (whose width is otherwise learnt then): the reservoir
        layout comes from the saved leaf's column count, then the ordinary
        restore applies."""
        if not self._exact and self._feature_dim is None:
            saved = state_dict.get(prefix + "real_features")
            if saved is not None and getattr(saved, "ndim", 0) == 2:
                self._init_reservoirs(int(saved.shape[1]) - 1)
        super().load_state_dict(state_dict, prefix=prefix)

    def _update(self, imgs: Tensor, real: bool) -> None:
        features = self.inception(imgs)
        if self._exact:
            (self.real_features if real else self.fake_features).append(features)
            return
        features = torch.as_tensor(features, device=self.device)
        if self._feature_dim is None:
            self._init_reservoirs(int(features.shape[-1]))
        if real:
            self.real_features = reservoir_insert(self.real_features, features, self.n_seen_real, seed=self._key_seed)
            self.n_seen_real = self.n_seen_real + features.shape[0]
        else:
            self.fake_features = reservoir_insert(
                self.fake_features, features, self.n_seen_fake, seed=self._key_seed + 1
            )
            self.n_seen_fake = self.n_seen_fake + features.shape[0]

    def _pool(self, real: bool) -> Tensor:
        """The sampled feature pool: the exact stream (arrival order) inside
        the lossless window, a uniform ``k``-row sample beyond it."""
        leaf = self.real_features if real else self.fake_features
        n = int(reservoir_fill(leaf))
        return reservoir_rows(leaf)[:n]

    def _compute(self) -> Tuple[Tensor, Tensor]:
        getattr(self.inception, "finalize", lambda: None)()  # the last batch's range check
        if self._exact:
            real_features = dim_zero_cat(self.real_features)
            fake_features = dim_zero_cat(self.fake_features)
        else:
            if self._feature_dim is None:
                raise ValueError("Argument `subset_size` should be smaller than the number of samples")
            real_features = self._pool(real=True)
            fake_features = self._pool(real=False)

        n_samples_real = real_features.shape[0]
        if n_samples_real < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        n_samples_fake = fake_features.shape[0]
        if n_samples_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        # every subset's indices drawn first (the same host draws, in the same
        # order, as the JAX package), then sent to the device in one copy
        draws = []
        for _ in range(self.subsets):
            draws.append(self._rng.permutation(n_samples_real)[: self.subset_size])
            draws.append(self._rng.permutation(n_samples_fake)[: self.subset_size])
        index = torch.from_numpy(np.stack(draws)).to(real_features.device)
        kid_scores = torch.stack(
            [
                poly_mmd(real_features[index[2 * i]], fake_features[index[2 * i + 1]], self.degree, self.gamma, self.coef)
                for i in range(self.subsets)
            ]
        )
        # ddof=1: the reference returns torch.std (unbiased) over subsets
        return torch.mean(kid_scores), torch.std(kid_scores)
