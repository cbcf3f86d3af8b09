"""FID, KID, IS and the InceptionV3 extractor: the port against the JAX package.

The extractor: seeded random weights are made with the JAX package's own
``convert_torch_fidelity_weights`` from the seeded torch mirror of
``tests/image/test_fid_kid_is.py`` (torch-fidelity's module names) and
saved to one ``.npz``, which both packages' ``build_fid_inception`` load.
Features agree at depths 64/192/768/2048 and on both logits within the
tolerance the JAX package holds its own mirror to (rtol 1e-3, atol 5e-3),
on 299 x 299 input, on a 64 x 64 upsample, on a 512 x 512 downsample (the
antialiased resize) and on a 256 x 512 mixed resize. The weights cross
bit for bit both ways (``convert.inception_from_flax``/``inception_to_flax``).

The metrics run on identity extractors (the features are the inputs), as
the JAX package's tests do: FID streaming (float32 moments, the
Newton-Schulz square root) within rtol 1e-5 of the JAX package and 1e-3 of
scipy's ``sqrtm`` (the JAX package's device tolerance), ``exact=True``
(float64 on the host) within 1e-6 of the JAX package and 1e-4 of scipy;
KID's subsets from the same seed, so its value within rtol 1e-5 of the JAX
package in both modes, bit-equal to ``exact=True`` inside the reservoir's
window, the same sampled rows past it; IS's round-robin splits and
``exact=True``'s shuffle within rtol 1e-5; the states, ``merge_states``,
``state_from_jax``, ``load_state_dict`` before the first update and the
fused update (states bit-equal to the eager update). ``trace_sqrtm`` is
held to scipy. Every argument error raises as in the JAX package.
"""
import contextlib
import sys
import threading

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

import metrics_tpu.image as jax_image
from metrics_tpu.models.inception import build_fid_inception as jax_build_fid_inception
from metrics_tpu.models.inception import convert_torch_fidelity_weights
from metrics_tpu.ops.sqrtm import trace_sqrtm_dispatch as jax_trace_sqrtm
import metrics_tpu_torch
from metrics_tpu_torch import MetricCollection
from metrics_tpu_torch.convert import inception_from_flax, inception_to_flax, state_from_jax
from metrics_tpu_torch.models import full_float32_convs
from metrics_tpu_torch.models.inception import InceptionV3FID, build_fid_inception, resize_and_scale
from metrics_tpu_torch.ops.sqrtm import NEWTON_SCHULZ_ITERS, trace_sqrtm
from metrics_tpu_torch.utils.checks import capturing_checks
from tests.image.test_fid_kid_is import TorchFIDInception

torch.set_num_threads(4)

FEATURE_RTOL, FEATURE_ATOL = 1e-3, 5e-3


def _identity(x):
    return x


def _scipy_fid(real: np.ndarray, fake: np.ndarray) -> float:
    mu1, mu2 = real.mean(0), fake.mean(0)
    cov1 = np.cov(real, rowvar=False)
    cov2 = np.cov(fake, rowvar=False)
    covmean = scipy.linalg.sqrtm(cov1 @ cov2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * np.trace(covmean))


# ---------------------------------------------------------------------------
# the InceptionV3 extractor from one shared .npz
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inception_npz(tmp_path_factory):
    torch.manual_seed(0)
    net = TorchFIDInception().eval()
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.5)
                mod.running_var.uniform_(0.5, 1.5)
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.normal_(0.0, 0.1)
    variables = convert_torch_fidelity_weights(net.state_dict())
    path = tmp_path_factory.mktemp("inception") / "inception.npz"
    np.savez(path, variables=np.asarray(variables, dtype=object))
    return net, variables, str(path)


@pytest.mark.parametrize("feature", [64, 192, 768, 2048, "logits_unbiased", "logits"])
def test_inception_features_vs_jax(inception_npz, feature):
    _, _, path = inception_npz
    imgs = np.random.RandomState(7).rand(2, 3, 299, 299).astype(np.float32)
    jax_feature = 9999 if feature == "logits" else feature  # any other value gives the logits
    want = np.asarray(jax_build_fid_inception(jax_feature, path)(jnp.asarray(imgs)))
    got = build_fid_inception(feature, path, device="cpu")(torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=FEATURE_RTOL, atol=FEATURE_ATOL)


RESIZE_CASES = [
    ("float", (64, 64)),  # upsampling
    ("float", (512, 512)),  # downsampling: antialiased
    ("float", (256, 512)),  # one axis up, one down
    ("uint8", (299, 299)),
    ("uint8", (160, 331)),
]


@pytest.mark.parametrize("kind,size", RESIZE_CASES, ids=[f"{k}-{s}" for k, s in RESIZE_CASES])
def test_inception_resize_vs_jax(inception_npz, kind, size):
    """The resize happens before the first convolution, so the depth-64
    head holds it: the JAX package's ``jax.image.resize`` (antialiased where
    an axis shrinks) against the port's ``F.interpolate``."""
    _, _, path = inception_npz
    rng = np.random.RandomState(11)
    imgs = rng.rand(2, 3, *size).astype(np.float32)
    if kind == "uint8":
        imgs = (imgs * 255).astype(np.uint8)
    want = np.asarray(jax_build_fid_inception(64, path)(jnp.asarray(imgs)))
    got = build_fid_inception(64, path, device="cpu")(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=FEATURE_RTOL, atol=FEATURE_ATOL)


@pytest.mark.parametrize("size", [(64, 64), (512, 512), (256, 512), (299, 299)])
def test_resize_matches_jax_image_resize(size):
    """The resized and scaled input itself, against ``jax.image.resize``
    (bilinear, antialiased) then ``x * 2 - 1``: within 1e-5 (float32
    interpolation weights); 299 x 299 passes through bit for bit."""
    x = np.random.RandomState(3).rand(2, 3, *size).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x).transpose(0, 2, 3, 1), (2, 299, 299, 3), method="bilinear")
    want = np.asarray(want * 2.0 - 1.0).transpose(0, 3, 1, 2)
    got = resize_and_scale(torch.from_numpy(x)).numpy()
    if size == (299, 299):
        np.testing.assert_array_equal(got, x * np.float32(2.0) - np.float32(1.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_inception_weights_round_trip(inception_npz):
    """``inception_from_flax`` of the JAX package's tree gives the mirror's
    own state dict bit for bit, so the model built from the ``.npz`` and the
    model loaded from the mirror's ``state_dict`` give the same bits; and
    ``inception_to_flax`` writes the JAX package's tree leaf for leaf."""
    net, variables, path = inception_npz
    from_flax = inception_from_flax(variables)
    mirror = net.state_dict()
    assert set(from_flax) == set(mirror)
    for key, value in mirror.items():
        assert torch.equal(from_flax[key], value), key
    back = inception_to_flax(mirror)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.array_equal, back, variables)))

    loaded = InceptionV3FID().eval()
    loaded.load_state_dict(mirror)
    imgs = torch.from_numpy(np.random.RandomState(5).rand(1, 3, 299, 299).astype(np.float32))
    extractor = build_fid_inception("logits", path, device="cpu")
    with torch.no_grad():
        for feature in (2048, "logits"):
            extractor.feature = feature
            assert torch.equal(extractor(imgs), loaded(imgs, feature))


def test_extractor_range_check(inception_npz):
    """A float batch holding [0, 255] values raises (host tensors at once,
    as the JAX package's numpy inputs); under the capture rule nothing is
    read; uint8 is never checked; ``finalize`` with nothing pending is a
    no-op."""
    _, _, path = inception_npz
    bad = np.random.RandomState(0).rand(1, 3, 64, 64).astype(np.float32) * 255.0
    extractor = build_fid_inception(64, path, device="cpu")
    with pytest.raises(ValueError, match="must be in") as got:
        extractor(torch.from_numpy(bad))
    with pytest.raises(ValueError, match="must be in") as want:
        jax_build_fid_inception(64, path)(bad)
    assert str(got.value) == str(want.value)
    with capturing_checks():
        assert extractor(torch.from_numpy(bad)).shape == (1, 64)
    assert extractor(torch.from_numpy(bad.astype(np.uint8))).shape == (1, 64)
    extractor.finalize()


def test_bundled_fid_vs_jax(inception_npz):
    """FID(64) on the bundled extractor from the shared ``.npz``, real
    images against darker fakes: states within rtol 1e-4 of the JAX
    package's, the value within 1e-3."""
    _, _, path = inception_npz
    rng = np.random.RandomState(9)
    batches = [
        ((rng.rand(4, 3, 75, 75) * (1.0 if real else 0.6)).astype(np.float32), real)
        for real in (True, False, True, False)
    ]
    jm = jax_image.FrechetInceptionDistance(64, feature_extractor_weights_path=path)
    tm = metrics_tpu_torch.FrechetInceptionDistance(64, feature_extractor_weights_path=path, device="cpu")
    for imgs, real in batches:
        jm.update(jnp.asarray(imgs), real=real)
        tm.update(torch.from_numpy(imgs), real=real)
    for name in ("real_feat_sum", "fake_outer_sum", "real_count"):
        np.testing.assert_allclose(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=1e-3)


@pytest.mark.parametrize(
    "cls,kwargs",
    [
        ("FrechetInceptionDistance", {"feature": 100}),
        ("FrechetInceptionDistance", {"feature": [1, 2]}),
        ("FrechetInceptionDistance", {"feature": 2048}),  # the bundled net without weights
        ("FrechetInceptionDistance", {"feature": _identity, "feature_dim": 0}),
        ("KernelInceptionDistance", {"feature": 100}),
        ("KernelInceptionDistance", {"feature": [1, 2]}),
        ("KernelInceptionDistance", {"feature": _identity, "subsets": 0}),
        ("KernelInceptionDistance", {"feature": _identity, "subset_size": -1}),
        ("KernelInceptionDistance", {"feature": _identity, "degree": 0}),
        ("KernelInceptionDistance", {"feature": _identity, "gamma": 1}),
        ("KernelInceptionDistance", {"feature": _identity, "coef": 1}),
        ("KernelInceptionDistance", {"feature": _identity, "subset_size": 50, "reservoir_size": 10}),
        ("InceptionScore", {"feature": "logits"}),
        ("InceptionScore", {"feature": 1.5}),
        ("InceptionScore", {"feature": _identity, "splits": 0}),
        ("InceptionScore", {"feature": _identity, "num_classes": -2}),
    ],
)
def test_argument_errors_match(cls, kwargs):
    with pytest.raises(Exception) as want:
        getattr(jax_image, cls)(**kwargs)
    with pytest.raises(Exception) as got:
        getattr(metrics_tpu_torch, cls)(device="cpu", **kwargs)
    assert got.type is want.type
    if "weights" not in str(want.value):  # the port's message names its own converter too
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the metrics on identity extractors
# ---------------------------------------------------------------------------


def _fid_pair(seed, d=16, n_real=200, n_fake=180):
    rng = np.random.RandomState(seed)
    real = (rng.randn(n_real, d) + 0.5).astype(np.float32)
    fake = (rng.randn(n_fake, d) * 1.3 - 0.2).astype(np.float32)
    return real, fake


def _feed(metric, chunks, to):
    for x, real in chunks:
        if real is None:
            metric.update(to(x))
        else:
            metric.update(to(x), real=real)


def _chunks(real, fake, n_real=4, n_fake=3):
    return [(c, True) for c in np.array_split(real, n_real)] + [(c, False) for c in np.array_split(fake, n_fake)]


def _jax(x):
    return jnp.asarray(x)


def _torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("d", [8, 16, 64])
def test_trace_sqrtm_vs_scipy(d):
    """``tr((S1 S2)^{1/2})`` of two seeded covariance matrices: within 1e-4
    (relative) of scipy's ``sqrtm`` and 1e-5 of the JAX package's
    Newton-Schulz."""
    rng = np.random.RandomState(d)
    a = rng.randn(4 * d, d)
    b = rng.randn(4 * d, d) * 1.5 + 0.3
    s1, s2 = np.cov(a, rowvar=False), np.cov(b, rowvar=False)
    want = float(np.trace(scipy.linalg.sqrtm(s1 @ s2)).real)
    got = float(trace_sqrtm(torch.from_numpy(s1.astype(np.float32)), torch.from_numpy(s2.astype(np.float32))))
    jax_value = float(jax_trace_sqrtm(jnp.asarray(s1, jnp.float32), jnp.asarray(s2, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, jax_value, rtol=1e-5)
    assert NEWTON_SCHULZ_ITERS == 20


@pytest.mark.parametrize("exact", [False, True])
def test_fid_vs_jax_and_scipy(exact):
    real, fake = _fid_pair(0)
    kw = {"exact": True} if exact else {"feature_dim": 16}
    with pytest.warns(UserWarning, match="memory") if exact else contextlib.nullcontext():
        tm = metrics_tpu_torch.FrechetInceptionDistance(feature=_identity, device="cpu", **kw)
        jm = jax_image.FrechetInceptionDistance(feature=_identity, **kw)
    _feed(tm, _chunks(real, fake), _torch)
    _feed(jm, _chunks(real, fake), _jax)
    got, want = float(tm.compute()), float(jm.compute())
    np.testing.assert_allclose(got, want, rtol=1e-6 if exact else 1e-5)
    np.testing.assert_allclose(got, _scipy_fid(real.astype(np.float64), fake.astype(np.float64)), rtol=1e-4 if exact else 1e-3)
    if not exact:
        for name in tm._defaults:
            np.testing.assert_allclose(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)), rtol=1e-6, atol=1e-4)


def test_fid_same_distribution_and_batching():
    rng = np.random.RandomState(1)
    feats = rng.randn(300, 8).astype(np.float32)
    streaming = metrics_tpu_torch.FrechetInceptionDistance(feature=_identity, feature_dim=8, device="cpu")
    streaming.update(_torch(feats), real=True)
    streaming.update(_torch(feats), real=False)
    assert abs(float(streaming.compute())) < 1e-2  # the Newton-Schulz residue alone

    one = metrics_tpu_torch.FrechetInceptionDistance(feature=_identity, feature_dim=8, device="cpu")
    real, fake = _fid_pair(2, d=8, n_real=120, n_fake=120)
    _feed(one, [(real, True), (fake, False)], _torch)
    many = metrics_tpu_torch.FrechetInceptionDistance(feature=_identity, feature_dim=8, device="cpu")
    _feed(many, _chunks(real, fake), _torch)
    np.testing.assert_allclose(float(many.compute()), float(one.compute()), rtol=1e-6)


def test_fid_dyadic_moments_exact():
    """On dyadic features with a power-of-two count every moment leaf is
    exactly the float64 moment (the JAX package's contract), and equal to
    the JAX package's leaves bit for bit."""
    rng = np.random.RandomState(21)
    n, d = 64, 8
    feats = rng.randint(0, 16, (n, d)).astype(np.float64) / 2.0
    tm = metrics_tpu_torch.FrechetInceptionDistance(feature=_identity, feature_dim=d, device="cpu")
    jm = jax_image.FrechetInceptionDistance(feature=_identity, feature_dim=d)
    for chunk in np.array_split(feats.astype(np.float32), 5):
        tm.update(_torch(chunk), real=True)
        jm.update(_jax(chunk), real=True)
    np.testing.assert_array_equal(tm.real_feat_sum.numpy(), feats.sum(0).astype(np.float32))
    np.testing.assert_array_equal(tm.real_outer_sum.numpy(), (feats.T @ feats).astype(np.float32))
    for name in ("real_feat_sum", "real_outer_sum", "real_count"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))


def test_fid_merge_states_and_state_from_jax():
    real, fake = _fid_pair(3, d=8)
    jm = jax_image.FrechetInceptionDistance(feature=_identity, feature_dim=8)
    _feed(jm, _chunks(real, fake), _jax)
    tm = metrics_tpu_torch.FrechetInceptionDistance(feature=_identity, feature_dim=8, device="cpu")
    carried = state_from_jax({k: np.asarray(getattr(jm, k)) for k in jm._defaults}, tm)
    np.testing.assert_allclose(float(tm.compute_state(carried)), float(jm.compute()), rtol=1e-5)

    half = real.shape[0] // 2
    a = tm.update_state(tm.init_state(), _torch(real[:half]), real=True)
    b = tm.update_state(tm.init_state(), _torch(real[half:]), real=True)
    b = tm.update_state(b, _torch(fake), real=False)
    merged = tm.merge_states(a, b)
    np.testing.assert_allclose(float(tm.compute_state(merged)), float(jm.compute()), rtol=1e-5)


def test_fid_width_mismatch_raises():
    tm = metrics_tpu_torch.FrechetInceptionDistance(feature=_identity, feature_dim=8, device="cpu")
    with pytest.raises(ValueError, match="feature_dim"):
        tm.update(torch.zeros(4, 16), real=True)
    ts = metrics_tpu_torch.InceptionScore(feature=_identity, num_classes=8, device="cpu")
    with pytest.raises(ValueError, match="num_classes"):
        ts.update(torch.zeros(4, 16))


def _kid_streams(seed, rounds=3, n_real=15, n_fake=12, d=6):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(rounds):
        out.append((rng.randn(n_real, d).astype(np.float32), True))
        out.append((rng.randn(n_fake, d).astype(np.float32) + 0.3, False))
    return out


@pytest.mark.parametrize("exact", [False, True])
def test_kid_vs_jax(exact):
    """Same seed, same subsets: the value within rtol 1e-5 of the JAX
    package (the poly kernel's product in float64 here, HIGHEST float32
    there)."""
    kw = dict(feature=_identity, subsets=5, subset_size=20, seed=42, exact=exact)
    with pytest.warns(UserWarning, match="memory") if exact else contextlib.nullcontext():
        tm = metrics_tpu_torch.KernelInceptionDistance(device="cpu", **kw)
        jm = jax_image.KernelInceptionDistance(**kw)
    stream = _kid_streams(0)
    _feed(tm, stream, _torch)
    _feed(jm, stream, _jax)
    for got, want in zip(tm.compute(), jm.compute()):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_kid_in_window_bit_equal_to_exact():
    kw = dict(feature=_identity, subsets=4, subset_size=10, seed=123)
    a = metrics_tpu_torch.KernelInceptionDistance(device="cpu", **kw)
    with pytest.warns(UserWarning, match="memory"):
        b = metrics_tpu_torch.KernelInceptionDistance(exact=True, device="cpu", **kw)
    stream = _kid_streams(23)
    _feed(a, stream, _torch)
    _feed(b, stream, _torch)
    for x, y in zip(a.compute(), b.compute()):
        assert torch.equal(x, y)


def test_kid_past_window_samples_the_jax_rows():
    """Past its reservoir (8 rows of 36 seen) the sample is the JAX
    package's: the Gumbel keys from the same per-rank seed keep the same
    rows in the same order, and the value follows within 1e-5. The keys
    themselves agree within 2 ulp at ``max(|g|, 1)`` (the port takes the
    Gumbel's logs correctly rounded, XLA's float32 ``log`` is an ulp off
    now and then: ROADMAP.md C, "Gumbel log")."""
    kw = dict(feature=_identity, subsets=3, subset_size=6, seed=7, reservoir_size=8)
    tm = metrics_tpu_torch.KernelInceptionDistance(device="cpu", **kw)
    jm = jax_image.KernelInceptionDistance(**kw)
    stream = _kid_streams(5, rounds=3, n_real=12, n_fake=12)
    _feed(tm, stream, _torch)
    _feed(jm, stream, _jax)
    for side in (True, False):
        np.testing.assert_array_equal(tm._pool(real=side).numpy(), np.asarray(jm._pool(real=side)))
    for name in ("real_features", "fake_features"):
        got, want = getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
        ulp = np.spacing(np.maximum(np.abs(want[:, 0]), 1.0).astype(np.float32))
        assert np.all(np.abs(got[:, 0] - want[:, 0]) <= 2 * ulp)
    for name in ("n_seen_real", "n_seen_fake"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
    for got, want in zip(tm.compute(), jm.compute()):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_kid_load_state_dict_before_first_update():
    kw = dict(feature=_identity, subsets=3, subset_size=10, seed=1)
    src = metrics_tpu_torch.KernelInceptionDistance(device="cpu", **kw)
    _feed(src, _kid_streams(2), _torch)
    dst = metrics_tpu_torch.KernelInceptionDistance(device="cpu", **kw)
    assert dst.__dict__.get("__jit_unsafe__") is True  # width unknown: eager until the states exist
    dst.load_state_dict(src.state_dict())
    assert "__jit_unsafe__" not in dst.__dict__
    for x, y in zip(src.compute(), dst.compute()):
        assert torch.equal(x, y)


def test_kid_raises_on_small_subset():
    tm = metrics_tpu_torch.KernelInceptionDistance(feature=_identity, subset_size=50, device="cpu")
    tm.update(torch.randn(10, 4), real=True)
    tm.update(torch.randn(10, 4), real=False)
    with pytest.raises(ValueError, match="subset_size"):
        tm.compute()


def _logits(seed, n=60, c=6, scale=1.0):
    return (np.random.RandomState(seed).randn(n, c) * scale).astype(np.float32)


@pytest.mark.parametrize("batch", [60, 7])
def test_is_streaming_vs_jax(batch):
    logits = _logits(22)
    tm = metrics_tpu_torch.InceptionScore(feature=_identity, num_classes=6, splits=3, device="cpu")
    jm = jax_image.InceptionScore(feature=_identity, num_classes=6, splits=3)
    for lo in range(0, 60, batch):
        tm.update(_torch(logits[lo : lo + batch]))
        jm.update(_jax(logits[lo : lo + batch]))
    np.testing.assert_array_equal(tm.split_count.numpy(), np.asarray(jm.split_count))
    for name in ("prob_sum", "plogp_sum"):
        np.testing.assert_allclose(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)), rtol=1e-6, atol=1e-6)
    for got, want in zip(tm.compute(), jm.compute()):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_is_exact_vs_jax():
    logits = _logits(0, n=100, c=10, scale=2.0)
    with pytest.warns(UserWarning, match="memory"):
        tm = metrics_tpu_torch.InceptionScore(feature=_identity, splits=4, seed=11, exact=True, device="cpu")
        jm = jax_image.InceptionScore(feature=_identity, splits=4, seed=11, exact=True)
    tm.update(_torch(logits))
    jm.update(_jax(logits))
    for got, want in zip(tm.compute(), jm.compute()):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_is_n_valid_masks_pad_rows():
    """Rows past ``n_valid`` land nowhere and leave the cursor, as in the
    JAX package."""
    logits = _logits(4, n=10)
    tm = metrics_tpu_torch.InceptionScore(feature=_identity, num_classes=6, splits=3, device="cpu")
    jm = jax_image.InceptionScore(feature=_identity, num_classes=6, splits=3)
    tm.update(_torch(logits), n_valid=torch.tensor(7, dtype=torch.int32))
    jm.update(_jax(logits), n_valid=jnp.asarray(7, jnp.int32))
    np.testing.assert_array_equal(tm.split_count.numpy(), np.asarray(jm.split_count))
    np.testing.assert_allclose(tm.prob_sum.numpy(), np.asarray(jm.prob_sum), rtol=1e-6, atol=1e-7)


def test_is_merge_states():
    logits = _logits(5)
    tm = metrics_tpu_torch.InceptionScore(feature=_identity, num_classes=6, splits=3, device="cpu")
    a = tm.update_state(tm.init_state(), _torch(logits[:30]))
    b = tm.update_state(tm.init_state(), _torch(logits[30:]))
    merged = tm.merge_states(a, b)
    one = tm.update_state(tm.init_state(), _torch(logits))
    for name in ("prob_sum", "plogp_sum", "split_count"):
        assert torch.equal(merged[name], a[name] + b[name]), name
    for got, want in zip(tm.compute_state(merged), tm.compute_state(one)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _int_batches(rng, sizes, d):
    """Integer-valued features: every moment sum is exact, so fused and
    eager states agree bit for bit."""
    return [torch.from_numpy(rng.randint(0, 8, (n, d)).astype(np.float32)) for n in sizes]


def test_fused_update_bit_equal_to_eager():
    """FID, KID and IS in one collection through ``compile_update`` (on the
    CPU the fused function runs without a graph, under the capture rule):
    nothing declined once KID's reservoirs exist, states bit-equal to the
    eager collection's, and FID/IS bucketed into one entry per ``real``."""
    d = 8

    def make():
        return MetricCollection(
            [
                metrics_tpu_torch.FrechetInceptionDistance(feature=_identity, feature_dim=d, device="cpu"),
                metrics_tpu_torch.KernelInceptionDistance(feature=_identity, subsets=3, subset_size=5, seed=0, device="cpu"),
                metrics_tpu_torch.InceptionScore(feature=_identity, num_classes=d, splits=3, device="cpu"),
            ]
        )

    fused, eager = make(), make()
    rng = np.random.RandomState(24)
    first = _int_batches(rng, (4,), d)[0]
    for c in (fused, eager):  # KID learns its width here
        c.update(first, real=True)
    handle = fused.compile_update()
    for real, sizes in ((True, (3, 5, 3)), (False, (4, 6, 4))):
        for x in _int_batches(rng, sizes, d):
            fused.update(x, real=real)
            eager.update(x, real=real)
    assert not handle.declined and not handle._eager_names
    for name in eager.keys():
        for s in eager[name]._defaults:
            assert torch.equal(getattr(fused[name], s), getattr(eager[name], s)), (name, s)
    values_f, values_e = fused.compute(), eager.compute()
    for key, value in values_e.items():
        for x, y in zip(value if isinstance(value, tuple) else (value,), values_f[key] if isinstance(value, tuple) else (values_f[key],)):
            assert torch.equal(x, y), key


def test_full_float32_convs_threads_never_lose_the_callers_flags():
    """The cuDNN flags are process-wide: 16 threads (more than the cores)
    enter and leave ``full_float32_convs`` 200 times each with a shortened
    switch interval. Inside, TF32 is always off; afterwards the caller's
    flags are back, which a lost restore (a thread restoring another's
    "off" as the caller's) would break. ``torch.device("cuda")`` is built
    without CUDA; only the flags are touched."""
    cudnn = torch.backends.cudnn
    before = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32)
    seen_on, errors = [], []
    device = torch.device("cuda")

    def worker():
        try:
            for _ in range(200):
                with full_float32_convs(device):
                    if cudnn.allow_tf32 or not cudnn.deterministic:
                        seen_on.append(True)
        except Exception as e:  # recorded and asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        cudnn.allow_tf32 = True
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        after = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32)
    finally:
        sys.setswitchinterval(interval)
        cudnn.allow_tf32 = before[3]
    assert not errors and not seen_on
    assert after == (before[0], before[1], before[2], True)
    with full_float32_convs(torch.device("cpu")):  # the CPU: nothing changes
        assert cudnn.allow_tf32 == before[3]


@pytest.mark.parametrize("route", ["state_dict", "prefixed", "pth"])
def test_torch_weights_load_directly(inception_npz, route, tmp_path):
    """A torch-fidelity state dict, as it is, with a key prefix, or saved to
    a ``.pth`` file (read with ``torch.load(weights_only=True)``), gives the
    features of the ``.npz`` route bit for bit; the port's
    ``convert_torch_fidelity_weights`` returns the JAX package's tree, which
    ``convert.inception_to_flax`` also writes."""
    from metrics_tpu_torch.models.inception import convert_torch_fidelity_weights as port_convert

    net, variables, path = inception_npz
    state = net.state_dict()
    weights = {"state_dict": state, "prefixed": {f"model.{k}": v for k, v in state.items()}, "pth": str(tmp_path / "w.pth")}[route]
    if route == "pth":
        torch.save(state, weights)
    imgs = torch.from_numpy(np.random.RandomState(5).rand(2, 3, 96, 96).astype(np.float32))
    for feature in (64, 2048, "logits"):
        direct = build_fid_inception(feature, weights, device="cpu")(imgs)
        assert torch.equal(direct, build_fid_inception(feature, path, device="cpu")(imgs))
    tree = port_convert(state)
    for other in (variables, inception_to_flax(state)):
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(other)
        assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.array_equal, tree, other)))
    fid = metrics_tpu_torch.FrechetInceptionDistance(64, feature_extractor_weights_path=weights, device="cpu")
    assert torch.equal(fid.inception(imgs), build_fid_inception(64, path, device="cpu")(imgs))
