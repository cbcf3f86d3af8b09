"""LPIPS: the port against the JAX package through one ``.npz``.

Seeded random weights of the torch mirror of the ``lpips`` package in
``tests/image/test_lpips.py`` (its exact state-dict layout) go through the
JAX package's own ``convert_lpips_weights`` into one ``.npz``, which both
packages' ``build_lpips`` load, for ``alex`` and ``vgg``. The scores agree
within rtol 1e-5 (atol 1e-7): the same float32 convolutions in two
libraries' orders. The weights cross bit for bit both ways
(``convert.lpips_from_flax``/``lpips_to_flax``): the net built from the
``.npz`` gives the same bits as the net loaded from the mirror's
``state_dict``. The metric's mean and sum, its zero on identical images,
its argument and value checks (skipped under the capture rule, as the JAX
package skips them on tracers) and the fused update (states bit-equal to
the eager update) are held too.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metrics_tpu.image.lpip import LearnedPerceptualImagePatchSimilarity as JaxLPIPS
from metrics_tpu.models.lpips import build_lpips as jax_build_lpips
from metrics_tpu.models.lpips import convert_lpips_weights
from metrics_tpu_torch import LearnedPerceptualImagePatchSimilarity, MetricCollection
from metrics_tpu_torch.convert import lpips_from_flax, lpips_to_flax
from metrics_tpu_torch.models.lpips import LPIPSNet, build_lpips
from metrics_tpu_torch.utils.checks import capturing_checks
from tests.image.test_lpips import TorchLPIPS


def _jax_shapes(message):
    """``message`` with torch's shapes in the JAX package's spelling."""
    return re.sub(r"torch\.Size\(\[([^\]]*)\]\)", r"(\1)", message)


torch.set_num_threads(4)

RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module", params=["alex", "vgg"])
def lpips_npz(request, tmp_path_factory):
    net_type = request.param
    torch.manual_seed(1)
    net = TorchLPIPS(net_type).eval()
    with torch.no_grad():  # random but reasonable head weights
        for k in range(5):
            getattr(net, f"lin{k}").model[1].weight.uniform_(0.0, 0.2)
    variables = convert_lpips_weights(net.state_dict(), net_type)
    path = tmp_path_factory.mktemp("lpips") / f"{net_type}.npz"
    np.savez(path, variables=np.asarray(variables, dtype=object))
    return net_type, net, variables, str(path)


def _images(seed, n=2, size=64):
    rng = np.random.RandomState(seed)
    return tuple((rng.rand(n, 3, size, size) * 2 - 1).astype(np.float32) for _ in range(2))


def test_scores_vs_jax(lpips_npz):
    net_type, _, _, path = lpips_npz
    img1, img2 = _images(0)
    want = np.asarray(jax_build_lpips(net_type, path)(jnp.asarray(img1), jnp.asarray(img2)))
    got = build_lpips(net_type, path, device="cpu")(torch.from_numpy(img1), torch.from_numpy(img2)).numpy()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_weights_round_trip(lpips_npz):
    """The mirror's state dict (its scaling constants under the ``lpips``
    package's ``scaling_layer.`` names) loads into the port's net, which
    then scores bit for bit as the net built from the ``.npz``; and
    ``lpips_to_flax`` writes the JAX package's tree leaf for leaf."""
    net_type, mirror, variables, path = lpips_npz
    state = {(f"scaling_layer.{k}" if k in ("shift", "scale") else k): v for k, v in mirror.state_dict().items()}
    from_flax = lpips_from_flax(variables, net_type)
    assert set(from_flax) == set(state)
    for key, value in state.items():
        assert torch.equal(from_flax[key], value), key
    back = lpips_to_flax(state, net_type)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.array_equal, back, variables)))

    loaded = LPIPSNet(net_type).eval()
    loaded.load_state_dict(state)
    img1, img2 = (torch.from_numpy(x) for x in _images(1))
    with torch.no_grad():
        assert torch.equal(build_lpips(net_type, path, device="cpu")(img1, img2), loaded(img1, img2))
        np.testing.assert_allclose(loaded(img1, img2).numpy(), mirror(img1, img2).numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_metric_vs_jax(lpips_npz, reduction):
    net_type, _, _, path = lpips_npz
    img1, img2 = _images(2, n=4)
    jm = JaxLPIPS(net_type=net_type, net_weights_path=path, reduction=reduction)
    tm = LearnedPerceptualImagePatchSimilarity(net_type=net_type, net_weights_path=path, reduction=reduction, device="cpu")
    for lo, hi in ((0, 2), (2, 4)):
        jm.update(jnp.asarray(img1[lo:hi]), jnp.asarray(img2[lo:hi]))
        tm.update(torch.from_numpy(img1[lo:hi]), torch.from_numpy(img2[lo:hi]))
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=RTOL, atol=ATOL)
    assert float(tm.total) == float(jm.total) == 4.0


def test_identical_images_zero(lpips_npz):
    net_type, _, _, path = lpips_npz
    img, _ = _images(3)
    tm = LearnedPerceptualImagePatchSimilarity(net_type=net_type, net_weights_path=path, device="cpu")
    tm.update(torch.from_numpy(img), torch.from_numpy(img))
    assert float(tm.compute()) == 0.0


def _zeros_net(a, b):
    return torch.zeros(a.shape[0])


@pytest.mark.parametrize("bad", ["range", "channels", "ndim"])
def test_input_errors_match(bad):
    shape = {"range": (2, 3, 8, 8), "channels": (2, 1, 8, 8), "ndim": (3, 8, 8)}[bad]
    x = np.ones(shape, np.float32) * (2.0 if bad == "range" else 1.0)
    y = np.ones(shape, np.float32)
    jm = JaxLPIPS(net=lambda a, b: jnp.zeros(a.shape[0]))
    tm = LearnedPerceptualImagePatchSimilarity(net=_zeros_net, device="cpu")
    with pytest.raises(ValueError) as want:
        jm.update(jnp.asarray(x), jnp.asarray(y))
    with pytest.raises(ValueError) as got:
        tm.update(torch.from_numpy(x), torch.from_numpy(y))
    assert _jax_shapes(str(got.value)) == str(want.value)


def test_value_check_follows_the_capture_rule():
    tm = LearnedPerceptualImagePatchSimilarity(net=_zeros_net, device="cpu")
    with capturing_checks():
        tm.update(torch.full((2, 3, 8, 8), 2.0), torch.ones(2, 3, 8, 8))  # values unread
        with pytest.raises(ValueError, match="normalized"):
            tm.update(torch.ones(2, 1, 8, 8), torch.ones(2, 1, 8, 8))  # the shape still checked
    assert float(tm.total) == 2.0


@pytest.mark.parametrize(
    "kwargs,match",
    [({"net": _zeros_net, "reduction": "max"}, "reduction"), ({"net_type": "squeeze", "net_weights_path": "x.npz"}, "net_type"), ({"net_type": "alex"}, "weights"), ({"net": 3}, "callable")],
)
def test_argument_errors_match(kwargs, match):
    jax_kwargs = {**kwargs, "net": (lambda a, b: None)} if callable(kwargs.get("net")) else kwargs
    with pytest.raises(Exception, match=match) as want:
        JaxLPIPS(**jax_kwargs)
    with pytest.raises(Exception, match=match) as got:
        LearnedPerceptualImagePatchSimilarity(device="cpu", **kwargs)
    assert got.type is want.type
    if match != "weights":  # the port's message names its own converter too
        assert str(got.value) == str(want.value)


def test_fused_update_bit_equal_to_eager(lpips_npz):
    """LPIPS in a collection through ``compile_update`` (on the CPU the
    fused function runs without a graph, under the capture rule): not
    declined, states bit-equal to the eager update's."""
    net_type, _, _, path = lpips_npz

    def make():
        return MetricCollection([LearnedPerceptualImagePatchSimilarity(net_type=net_type, net_weights_path=path, device="cpu")])

    fused, eager = make(), make()
    batches = [_images(10 + i, n=2, size=48) for i in range(3)]
    fused.update(*(torch.from_numpy(x) for x in batches[0]))
    eager.update(*(torch.from_numpy(x) for x in batches[0]))
    handle = fused.compile_update()
    for b in batches[1:]:
        fused.update(*(torch.from_numpy(x) for x in b))
        eager.update(*(torch.from_numpy(x) for x in b))
    assert not handle.declined and not handle._eager_names and handle.cache_size == 1
    f, e = fused["LearnedPerceptualImagePatchSimilarity"], eager["LearnedPerceptualImagePatchSimilarity"]
    for name in e._defaults:
        assert torch.equal(getattr(f, name), getattr(e, name)), name
