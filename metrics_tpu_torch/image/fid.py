"""Frechet Inception Distance.

Counterpart of ``metrics_tpu/image/fid.py``. By default the features
stream into exact moment leaves per distribution (``sketches/moments.py``:
``sum x [d]``, ``sum x x^T [d, d]``, a count, all ``"sum"``-reduced): the
Gaussian fit depends on the features only through them, so the state is
exact for any stream length. ``compute()`` stays on the device: the
covariance identity feeds the Newton-Schulz ``trace_sqrtm``
(``ops/sqrtm.py``), with the reference's singular-product retry (a host
read of the value, on ``compute`` only). ``exact=True`` keeps the feature
lists and the host float64 statistics, and gives the large-memory warning.

``feature`` is an int depth (64, 192, 768, 2048) for the bundled
InceptionV3, built on the metric's device from a weights file, or any
callable ``imgs -> [N, d]``, whose width ``feature_dim`` declares (default
2048). The outer product of a batch is taken in float64 and rounded once
(no TF32 flag changes it). The update reads nothing from the card (the
extractor's range check follows the capture rule), so a fused collection
update captures it; ``real`` is a static argument that keys the graphs.
"""
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.pairwise.helpers import _matmul_t
from metrics_tpu_torch.models.inception import build_fid_inception
from metrics_tpu_torch.ops.sqrtm import trace_sqrtm
from metrics_tpu_torch.sketches.compat import register_exact_list_states, warn_exact_buffer
from metrics_tpu_torch.sketches.moments import mean_cov_from_moments
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_info

Tensor = torch.Tensor


def _sqrtm_eigh(mat: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root via eigendecomposition (float64 host)."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def _trace_sqrtm_product(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
    """Tr[(sigma1 @ sigma2)^(1/2)] for symmetric PSD sigma1, sigma2."""
    s1_half = _sqrtm_eigh(sigma1)
    m = s1_half @ sigma2 @ s1_half
    vals = np.linalg.eigvalsh((m + m.T) / 2)
    return float(np.sqrt(np.clip(vals, 0.0, None)).sum())


def _compute_fid(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray, eps: float = 1e-6
) -> float:
    """d^2 = ||mu1 - mu2||^2 + Tr(s1 + s2 - 2 sqrtm(s1 s2)), in float64 on the host."""
    diff = mu1 - mu2

    # eigvalsh raises LinAlgError (rather than returning NaN the way scipy's
    # sqrtm does) when the product is numerically degenerate: both failure
    # shapes go to the reference's add-eps-and-retry path
    try:
        tr_covmean = _trace_sqrtm_product(sigma1, sigma2)
    except np.linalg.LinAlgError:
        tr_covmean = float("nan")
    if not np.isfinite(tr_covmean):
        rank_zero_info(f"FID calculation produces singular product; adding {eps} to diagonal of covariance estimates")
        offset = np.eye(sigma1.shape[0]) * eps
        try:
            tr_covmean = _trace_sqrtm_product(sigma1 + offset, sigma2 + offset)
        except np.linalg.LinAlgError as err:
            raise ValueError(
                "FID covariance square root failed even after adding eps to the diagonals —"
                " the feature matrices likely contain NaN/Inf (broken or overflowing extractor)."
            ) from err

    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


class _ExtractorMixin:
    """``to_device`` moves a bundled extractor with the states."""

    def to_device(self, device: Union[str, torch.device]) -> Metric:
        out = super().to_device(device)
        if hasattr(self.inception, "to"):
            self.inception.to(self.device)
        return out


class FrechetInceptionDistance(_ExtractorMixin, Metric):
    """Computes the FID between real and generated image distributions.

    Args:
        feature: a callable mapping an image batch to ``[N, d]`` features, or
            an int in (64, 192, 768, 2048) selecting the bundled
            InceptionV3 depth (requires local weights).
        feature_extractor_weights_path: npz checkpoint for the bundled
            InceptionV3 (int ``feature`` only), or a torch-fidelity state
            dict or its ``.pth`` file (``build_fid_inception``).
        feature_dim: feature width ``d`` for callable extractors (ignored
            for int ``feature``, whose depth fixes it); default 2048.
        exact: keep the feature lists and compute the statistics in float64
            on the host.
    """

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
        feature_extractor_weights_path: Optional[str] = None,
        feature_dim: Optional[int] = None,
        exact: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

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
            feature_dim = 2048 if feature_dim is None else feature_dim
        else:
            raise TypeError("Got unknown input to argument `feature`")
        if not (isinstance(feature_dim, int) and feature_dim > 0):
            raise ValueError(f"Argument `feature_dim` expected to be a positive int, got {feature_dim}")
        self._feature_dim = feature_dim

        self._exact = bool(exact)
        if self._exact:
            register_exact_list_states(self, ("real_features", "fake_features"), dist_reduce_fx=None)
            warn_exact_buffer("FrechetInceptionDistance", "extracted features")
        else:
            d = feature_dim
            for side in ("real", "fake"):
                self.add_state(f"{side}_feat_sum", default=torch.zeros((d,)), dist_reduce_fx="sum")
                self.add_state(f"{side}_outer_sum", default=torch.zeros((d, d)), dist_reduce_fx="sum")
                self.add_state(f"{side}_count", default=torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, imgs: Tensor, real: bool) -> None:
        features = self.inception(imgs)
        if self._exact:
            (self.real_features if real else self.fake_features).append(features)
            return
        features = torch.as_tensor(features, device=self.device).to(torch.float32)
        if features.shape[-1] != self._feature_dim:
            raise ValueError(
                f"Extractor emitted features of width {features.shape[-1]} but the streaming"
                f" moment state was sized for feature_dim={self._feature_dim} — pass the"
                " extractor's true width via `feature_dim` (or use `exact=True`)."
            )
        outer = _matmul_t(features.T, features.T)
        side = "real" if real else "fake"
        setattr(self, f"{side}_feat_sum", getattr(self, f"{side}_feat_sum") + torch.sum(features, dim=0))
        setattr(self, f"{side}_outer_sum", getattr(self, f"{side}_outer_sum") + outer)
        setattr(self, f"{side}_count", getattr(self, f"{side}_count") + features.shape[0])

    def _compute_exact(self) -> Tensor:
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        orig_dtype = real_features.dtype

        # float64 statistics on host: the computation is extremely sensitive
        real = real_features.detach().to(torch.float64).cpu().numpy()
        fake = fake_features.detach().to(torch.float64).cpu().numpy()

        n = real.shape[0]
        mean1 = real.mean(axis=0)
        mean2 = fake.mean(axis=0)
        diff1 = real - mean1
        diff2 = fake - mean2
        cov1 = diff1.T @ diff1 / (n - 1)
        cov2 = diff2.T @ diff2 / (fake.shape[0] - 1)

        fid = _compute_fid(mean1, cov1, mean2, cov2)
        return torch.as_tensor(np.asarray(fid, dtype=np.float64)).to(device=real_features.device, dtype=orig_dtype)

    def _compute(self) -> Tensor:
        getattr(self.inception, "finalize", lambda: None)()  # the last batch's range check
        if self._exact:
            return self._compute_exact()

        mean1, cov1 = mean_cov_from_moments(self.real_feat_sum, self.real_outer_sum, self.real_count)
        mean2, cov2 = mean_cov_from_moments(self.fake_feat_sum, self.fake_outer_sum, self.fake_count)
        diff = mean1 - mean2
        base = torch.dot(diff, diff) + torch.trace(cov1) + torch.trace(cov2)
        fid = base - 2.0 * trace_sqrtm(cov1, cov2)
        if not bool(torch.isfinite(fid)):
            # the reference's singular-product retry: offset the diagonals and
            # take the square root again (a host read, on compute only)
            eps = 1e-6
            rank_zero_info(
                f"FID calculation produces singular product; adding {eps} to diagonal of covariance estimates"
            )
            offset = torch.eye(cov1.shape[0], dtype=torch.float32, device=cov1.device) * eps
            fid = base - 2.0 * trace_sqrtm(cov1 + offset, cov2 + offset)
        return fid
