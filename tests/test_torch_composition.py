"""CompositionalMetric and the operator algebra: the port against the JAX package.

Every binary operator, forward and reflected, with a metric, an int, a
float and a tensor as the other operand; the unary operators with the JAX
package's quirks (``-m`` is ``-|m|``, ``+m`` is ``|m|``), ``__getitem__``
and chains. Each value is held to the JAX package's, bit for bit and with
its dtype (the x64-off dtypes: an int constant is int32, a float float32).
Also: update fan-out with per-child keyword filtering, ``forward``,
``reset``, ``repr``, hashing and pickling, a ``MetricCollection`` with
compute groups holding a composition (values equal to the JAX package's,
the composition in a group of its own), and ``_equal_values`` on two
distinct metrics (identity: ``==`` between metrics builds a composition).
"""
import operator
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
from metrics_tpu.core.metric import CompositionalMetric as JaxCompositional
from metrics_tpu.core.metric import Metric as JaxMetric
import metrics_tpu_torch
from metrics_tpu_torch import CompositionalMetric, Metric, MetricCollection
from metrics_tpu_torch.collections import _equal_values

torch.set_num_threads(2)


class JaxDummy(JaxMetric):
    def __init__(self, val):
        super().__init__()
        self.add_state("_num_updates", jnp.asarray(0), dist_reduce_fx="sum")
        self._val_to_return = val

    def _update(self, *args, **kwargs):
        self._num_updates = self._num_updates + 1

    def _compute(self):
        return jnp.asarray(self._val_to_return)


class TorchDummy(Metric):
    def __init__(self, val):
        super().__init__(device="cpu")
        self.add_state("_num_updates", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self._val_to_return = val

    def _update(self, *args, **kwargs):
        self._num_updates = self._num_updates + 1

    def _compute(self):
        arr = np.asarray(self._val_to_return)
        return torch.from_numpy(arr.astype(np.int32 if arr.dtype.kind == "i" else np.float32))


def _operands(kind, val):
    """The other operand in each package."""
    if kind == "metric":
        return JaxDummy(val), TorchDummy(val)
    if kind == "int":
        return int(val), int(val)
    if kind == "float":
        return float(val), float(val)
    if kind == "tensor":
        arr = np.asarray(val, np.float32)
        return jnp.asarray(arr), torch.from_numpy(arr)
    if kind == "int_tensor":
        arr = np.asarray(val, np.int32)
        return jnp.asarray(arr), torch.from_numpy(arr)
    raise ValueError(kind)


def _value(composed):
    composed.update()
    out = composed.compute()
    return np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)


def _same(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


BINARY = [
    ("add", operator.add, 5, 3, ("metric", "int", "float", "tensor")),
    ("sub", operator.sub, 5, 3, ("metric", "int", "float", "tensor")),
    ("mul", operator.mul, 5, 3, ("metric", "int", "float", "tensor")),
    ("truediv", operator.truediv, 6, 3, ("metric", "int", "float", "tensor")),
    ("floordiv", operator.floordiv, 7, 3, ("metric", "int", "float", "tensor")),
    ("mod", operator.mod, 7, 3, ("metric", "int", "float", "tensor")),
    ("pow", operator.pow, 3, 2, ("metric", "int", "float", "tensor")),
    ("and", operator.and_, 3, 2, ("metric", "int_tensor")),
    ("or", operator.or_, 3, 2, ("metric", "int_tensor")),
    ("xor", operator.xor, 3, 2, ("metric", "int_tensor")),
    ("eq", operator.eq, 5, 3, ("metric", "int", "float", "tensor")),
    ("ne", operator.ne, 5, 3, ("metric", "int", "float", "tensor")),
    ("lt", operator.lt, 5, 3, ("metric", "int", "float", "tensor")),
    ("le", operator.le, 5, 3, ("metric", "int", "float", "tensor")),
    ("gt", operator.gt, 5, 3, ("metric", "int", "float", "tensor")),
    ("ge", operator.ge, 5, 3, ("metric", "int", "float", "tensor")),
    ("matmul", operator.matmul, [1.0, 2.0], [2.0, 2.0], ("metric", "tensor")),
]
CASES = [
    pytest.param(fn, first, second, kind, reflected, id=f"{name}-{kind}-{'reflected' if reflected else 'forward'}")
    for name, fn, first, second, kinds in BINARY
    for kind in kinds
    for reflected in (False, True)
    # a reflected comparison with a constant is the mirrored comparison
    if not (reflected and name in ("eq", "ne", "lt", "le", "gt", "ge") and kind != "metric")
]


@pytest.mark.parametrize("fn, first, second, kind, reflected", CASES)
def test_binary_operator_matches_jax(fn, first, second, kind, reflected):
    jax_other, torch_other = _operands(kind, second)
    jax_first, torch_first = JaxDummy(first), TorchDummy(first)
    if reflected:
        jax_c, torch_c = fn(jax_other, jax_first), fn(torch_other, torch_first)
    else:
        jax_c, torch_c = fn(jax_first, jax_other), fn(torch_first, torch_other)
    assert isinstance(jax_c, JaxCompositional) and isinstance(torch_c, CompositionalMetric)
    _same(_value(torch_c), _value(jax_c))


@pytest.mark.parametrize(
    "build",
    [
        lambda d: abs(d(-5)),
        lambda d: -d(2),
        lambda d: -d(-2),
        lambda d: +d(-2),
        lambda d: +d(2),
        lambda d: ~d(1),
        lambda d: d([1.0, 2.0, 3.0])[1],
        lambda d: (d(2) + d(3)) * 4 - 1,
        lambda d: 1 - d(0.25) / 2.0,
        lambda d: -(d(2) ** 0.5) + abs(d(-1)),
    ],
    ids=["abs", "neg", "neg-of-negative", "pos-of-negative", "pos", "invert", "getitem", "chain", "chain-float", "chain-unary"],
)
def test_unary_quirks_getitem_and_chains_match_jax(build):
    _same(_value(build(TorchDummy)), _value(build(JaxDummy)))


def test_neg_and_pos_quirks():
    assert float(_value(-TorchDummy(-2))) == -2.0
    assert float(_value(+TorchDummy(-2))) == 2.0


def test_constants_take_the_x64_off_dtypes_on_the_metric_device():
    composed = TorchDummy(5) + 3
    assert composed.metric_b.dtype == torch.int32 and composed.metric_b.device.type == "cpu"
    assert (TorchDummy(5) * 2.5).metric_b.dtype == torch.float32
    assert composed.device.type == "cpu"
    assert set(composed._children) == {"metric_a"}


def test_update_fans_out_and_filters_kwargs():
    class A(Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("a", 0.0, dist_reduce_fx="sum")

        def _update(self, x):
            self.a = self.a + x

        def _compute(self):
            return self.a

    class B(Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("b", 0.0, dist_reduce_fx="sum")

        def _update(self, y):
            self.b = self.b + 2 * y

        def _compute(self):
            return self.b

    composed = A() + B()
    composed.update(x=torch.tensor(1.0), y=torch.tensor(10.0))
    assert float(composed.compute()) == 21.0
    out = composed(x=torch.tensor(2.0), y=torch.tensor(1.0))
    assert float(out) == 4.0 and float(composed.compute()) == 25.0
    first, second = TorchDummy(1), TorchDummy(2)
    both = first + second
    both.update()
    both.update()
    assert int(first._num_updates) == 2 and int(second._num_updates) == 2


def test_forward_reset_repr_hash_and_pickle():
    first, second = TorchDummy(4), TorchDummy(5)
    composed = first + second
    assert float(composed(torch.tensor(0.0))) == 9 and composed._forward_cache is not None
    assert int(first._num_updates) == 1
    composed.reset()
    assert int(first._num_updates) == 0 and int(second._num_updates) == 0 and composed._computed is None
    rep = repr(TorchDummy(5) + 2)
    assert rep.startswith("CompositionalMetric(\n  add(\n    TorchDummy(),\n") and rep.endswith("\n  )\n)")
    assert repr(JaxDummy(5) + JaxDummy(2)).replace("JaxDummy", "D") == repr(TorchDummy(5) + TorchDummy(2)).replace("TorchDummy", "D")
    assert isinstance(hash(composed), int) and hash(composed) != hash(TorchDummy(4) + TorchDummy(5))
    assert isinstance(hash(first), int) and {first: 1, second: 2}[second] == 2
    composed.update()
    clone = pickle.loads(pickle.dumps(composed))
    assert float(clone.compute()) == 9
    with pytest.raises(TypeError, match="not iterable"):
        iter(first)


def test_collection_with_compute_groups_holds_a_composition():
    rng = np.random.RandomState(3)
    batches = [(rng.randint(0, 4, 64).astype(np.int64), rng.randint(0, 4, 64).astype(np.int64)) for _ in range(3)]

    def members(pkg, **kw):
        return {
            "acc": pkg.Accuracy(num_classes=4, **kw),
            "err": 1 - pkg.Accuracy(num_classes=4, **kw),
            "prec": pkg.Precision(num_classes=4, average="macro", **kw),
        }

    jc = metrics_tpu.MetricCollection(members(metrics_tpu))
    tc = MetricCollection(members(metrics_tpu_torch, device="cpu"))
    for p, t in batches:
        jc.update(jnp.asarray(p), jnp.asarray(t))
        tc.update(torch.from_numpy(p), torch.from_numpy(t))
    jv, tv = jc.compute(), tc.compute()
    assert jv.keys() == tv.keys()
    for key in jv:
        _same(tv[key].numpy(), np.asarray(jv[key]))
    assert ["err"] in tc.compute_groups.values()
    assert sorted(map(sorted, tc.compute_groups.values())) == sorted(map(sorted, jc.compute_groups.values()))
    forward = tc(torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]))
    assert float(forward["err"]) == 1 - float(forward["acc"])


def test_equal_values_compares_metrics_by_identity():
    a, b = metrics_tpu_torch.Accuracy(device="cpu"), metrics_tpu_torch.Accuracy(device="cpu")
    assert isinstance(a == b, CompositionalMetric)  # truthy, which bool(v1 == v2) trusted
    assert not _equal_values(a, b)
    assert _equal_values(a, a)
    assert not _equal_values(a, 1)
    one, two = metrics_tpu_torch.ClasswiseWrapper(a), metrics_tpu_torch.ClasswiseWrapper(b)
    assert not MetricCollection._equal_update_attrs(one, two)
    assert not MetricCollection._equal_metric_states(1 - a, 1 - b)
