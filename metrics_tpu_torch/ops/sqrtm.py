"""``trace(sqrtm(S1 S2))`` by the coupled Newton-Schulz iteration.

Counterpart of ``metrics_tpu/ops/sqrtm.py``. FID's cross term
``tr((S1 S2)^{1/2})`` needs no decomposition: with

    ``Y0 = A / ||A||_F``, ``Z0 = I``;  ``T = (3I - Z Y) / 2``;  ``Y <- Y T``;  ``Z <- T Z``

``Y`` converges quadratically to ``A^{1/2} / ||A||_F^{1/2}`` for
``A = S1 S2``, a product of PSD matrices (a real non-negative spectrum,
which the normalisation puts in ``(0, 1]``). Each step is two ``[d, d]``
products, so ``compute()`` stays on the device with no host round trip.

This is not a kernel (the JAX package computes it with ``jnp`` products
outside any Pallas kernel): it counts no launches. Each product is taken
in float64 and rounded once to float32, as ``functional/pairwise/
helpers.py:_matmul_t`` does, so the result depends on no TF32 flag; the
iterate stays float32, as in the JAX package. Callers that need float64
semantics use the metrics' ``exact=True``, which takes the host path.
"""
import torch

Tensor = torch.Tensor

#: Newton-Schulz step count: quadratic convergence makes 20 steps ample for
#: float32 on Inception-scale (2048 x 2048) covariance products
NEWTON_SCHULZ_ITERS = 20


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` in float64, rounded once to float32."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.float32)


def trace_sqrtm(sigma1: Tensor, sigma2: Tensor, iters: int = NEWTON_SCHULZ_ITERS) -> Tensor:
    """``tr((S1 S2)^{1/2})`` for PSD ``S1``, ``S2``; a float32 scalar on their device."""
    a = _mm(sigma1, sigma2)
    d = a.shape[0]
    norm = torch.sqrt(torch.sum(a * a))
    norm = torch.clamp(norm, min=torch.finfo(torch.float32).tiny)
    eye = torch.eye(d, dtype=torch.float32, device=a.device)
    y, z = a / norm, eye
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - _mm(z, y))
        y, z = _mm(y, t), _mm(t, z)
    return torch.trace(y) * torch.sqrt(norm)
