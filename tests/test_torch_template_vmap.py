"""Template updates under vmap: the confusion-matrix family on label inputs
and R2Score inside the port's SlicedMetric against the JAX package's, the
vmap rules of the kernels' custom ops, and ``device=`` on the wrappers.

Seeded numpy inputs go to both packages on the CPU (a few rows, 4 classes).
Counts are held bit for bit; float values within 1e-6 (R2Score's inputs are
dyadic, so every sum is exact in float32 whichever order adds it), NaN where
the other is NaN. The vmap rules are held on the CPU, where no card runs
them: ``torch.func.vmap`` over each ``metrics_tpu_torch::`` op (the plain
version under the rule's flattening and offsets) equals the plain version
stacked row by row, out-of-range and negative ids included; each rule
asks its op for one launch marked ``batched``, which the launch counters
keep apart (``ops.batched_launch_counts()``).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from metrics_tpu import CohenKappa as JaxCohenKappa
from metrics_tpu import ConfusionMatrix as JaxConfusionMatrix
from metrics_tpu import JaccardIndex as JaxJaccardIndex
from metrics_tpu import MatthewsCorrCoef as JaxMatthewsCorrCoef
from metrics_tpu import R2Score as JaxR2Score
from metrics_tpu.sliced import SlicedMetric as JaxSliced
from metrics_tpu_torch import (
    CohenKappa,
    ConfusionMatrix,
    JaccardIndex,
    MatthewsCorrCoef,
    MeanSquaredError,
    R2Score,
    SlicedMetric,
    WindowedMetric,
)
from metrics_tpu_torch import ops
from metrics_tpu_torch.utils.exceptions import MetricsUserError

torch.set_num_threads(2)

SLICES = 3
ROWS = 12

#: the confusion-matrix family: (JAX class, port class, constructor kwargs)
FAMILY = {
    "ConfusionMatrix": (JaxConfusionMatrix, ConfusionMatrix, {}),
    "ConfusionMatrix-normalize": (JaxConfusionMatrix, ConfusionMatrix, {"normalize": "true"}),
    "CohenKappa": (JaxCohenKappa, CohenKappa, {}),
    "CohenKappa-quadratic": (JaxCohenKappa, CohenKappa, {"weights": "quadratic"}),
    "JaccardIndex": (JaxJaccardIndex, JaccardIndex, {}),
    "JaccardIndex-ignore": (JaxJaccardIndex, JaccardIndex, {"ignore_index": 0}),
    "MatthewsCorrCoef": (JaxMatthewsCorrCoef, MatthewsCorrCoef, {}),
}


def label_batch(rng: np.random.Generator, case: str):
    """``(num_classes, preds, target)`` integer labels: binary ints, [N]
    multiclass labels over 4 classes, or [N, 3] multidim labels."""
    if case == "binary":
        return 2, rng.integers(0, 2, ROWS), rng.integers(0, 2, ROWS)
    if case == "multiclass":
        return 4, rng.integers(0, 4, ROWS), rng.integers(0, 4, ROWS)
    return 4, rng.integers(0, 4, (ROWS, 3)), rng.integers(0, 4, (ROWS, 3))


def slice_ids(rng: np.random.Generator) -> np.ndarray:
    """Ids over [-1, SLICES + 1): some drop."""
    return rng.integers(-1, SLICES + 1, ROWS).astype(np.int32)


def feed(jax_metric, metric, batches):
    for ids, preds, target in batches:
        jax_metric.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
        metric.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))


def assert_values(got, want, rtol=1e-6):
    got, want = got.numpy().astype(np.float64), np.asarray(want).astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol, equal_nan=True)


# ---------------------------------------------------------------------------
# the confusion-matrix family inside SlicedMetric, on label inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["binary", "multiclass", "multidim"])
@pytest.mark.parametrize("which", sorted(FAMILY))
def test_sliced_confusion_family_on_labels_equals_jax(which, case):
    jax_cls, port_cls, kwargs = FAMILY[which]
    rng = np.random.default_rng(sorted(FAMILY).index(which) * 10 + len(case))
    num_classes = label_batch(np.random.default_rng(0), case)[0]
    batches = []
    for _ in range(3):
        _, preds, target = label_batch(rng, case)
        batches.append((slice_ids(rng), preds, target))
    jax_metric = JaxSliced(jax_cls(num_classes=num_classes, **kwargs), num_slices=SLICES)
    metric = SlicedMetric(port_cls(num_classes=num_classes, device="cpu", **kwargs), SLICES)
    feed(jax_metric, metric, batches)
    got = metric.confmat.numpy()
    want = np.asarray(jax_metric.confmat)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert_values(metric.compute(), jax_metric.compute())
    subset = [2, 0]
    assert_values(metric.compute(slice_ids=subset), jax_metric.compute(slice_ids=jnp.asarray(subset)))


@pytest.mark.parametrize("case", ["binary", "multiclass", "multidim"])
def test_sliced_confusion_counts_equal_numpy(case):
    """Per-slice counts on labels against numpy's bincount of (slice, target,
    pred), with dropped ids left out."""
    rng = np.random.default_rng(5)
    num_classes, preds, target = label_batch(rng, case)
    ids = slice_ids(rng)
    metric = SlicedMetric(ConfusionMatrix(num_classes=num_classes, device="cpu"), SLICES)
    metric.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
    rows = np.broadcast_to(ids.reshape(-1, *([1] * (preds.ndim - 1))), preds.shape)
    keep = (rows >= 0) & (rows < SLICES)
    flat = (rows * num_classes + target) * num_classes + preds
    want = np.bincount(flat[keep], minlength=SLICES * num_classes**2).reshape(SLICES, num_classes, num_classes)
    np.testing.assert_array_equal(metric.confmat.numpy(), want)


# ---------------------------------------------------------------------------
# R2Score inside SlicedMetric: the vmapped compute under the capture rule
# ---------------------------------------------------------------------------


def dyadic(rng: np.random.Generator, shape) -> np.ndarray:
    """Multiples of 1/8 in [-2, 2): every sum and square below is exact."""
    return (rng.integers(-16, 16, shape) / 8).astype(np.float32)


@pytest.mark.parametrize("multioutput", ["raw_values", "uniform_average", "variance_weighted"])
@pytest.mark.parametrize("adjusted", [0, 1])
def test_sliced_r2_equals_jax(adjusted, multioutput):
    rng = np.random.default_rng(adjusted * 7 + len(multioutput))
    # two outputs; slice 2 gets a single row, so its adjusted R2 falls back
    batches = []
    for _ in range(2):
        ids = rng.integers(0, SLICES - 1, ROWS).astype(np.int32)
        ids[0] = SLICES - 1 if not batches else 0
        batches.append((ids, dyadic(rng, (ROWS, 2)), dyadic(rng, (ROWS, 2))))
    jax_metric = JaxSliced(JaxR2Score(num_outputs=2, adjusted=adjusted, multioutput=multioutput), num_slices=SLICES)
    metric = SlicedMetric(R2Score(num_outputs=2, adjusted=adjusted, multioutput=multioutput, device="cpu"), SLICES)
    feed(jax_metric, metric, batches)
    assert_values(metric.compute(), jax_metric.compute())
    assert_values(metric.compute(slice_ids=[1]), jax_metric.compute(slice_ids=jnp.asarray([1])))
    # the pure-state read vmaps the same compute
    states = {name: getattr(metric, name) for name in metric._defaults}
    assert_values(metric.compute_state(states), jax_metric.compute())


@pytest.mark.parametrize("adjusted", [0, 1])
def test_sliced_r2_one_output_equals_jax(adjusted):
    rng = np.random.default_rng(40 + adjusted)
    ids = rng.integers(0, SLICES, ROWS).astype(np.int32)
    batch = (ids, dyadic(rng, ROWS), dyadic(rng, ROWS))
    jax_metric = JaxSliced(JaxR2Score(adjusted=adjusted), num_slices=SLICES)
    metric = SlicedMetric(R2Score(adjusted=adjusted, device="cpu"), SLICES)
    feed(jax_metric, metric, [batch])
    assert_values(metric.compute(), jax_metric.compute())


# ---------------------------------------------------------------------------
# the custom ops' vmap rules
# ---------------------------------------------------------------------------

BINS = 5


def _plain(name: str):
    return {
        "bincount_i32": lambda i: ops.bincount_reference(i, BINS),
        "segment_sum_f32": lambda v, i: ops.segment_sum_reference(v, i, BINS),
        "segment_sum_i32": lambda v, i: ops.segment_sum_reference(v, i, BINS),
        "segment_max_f32": lambda v, i: ops.segment_extremum_reference(v, i, BINS, True),
        "segment_min_f32": lambda v, i: ops.segment_extremum_reference(v, i, BINS, False),
    }[name]


def _op(name: str):
    op = getattr(torch.ops.metrics_tpu_torch, name)
    if name == "bincount_i32":
        return lambda i: op(i, BINS)
    return lambda v, i: op(v, i, BINS)


def _inputs(name: str, v: int, b: int, d: int, id_dtype):
    rng = np.random.default_rng(v * 100 + b * 10 + d)
    # ids past either end of [0, BINS): a row's -1 and BINS + 1 must not reach its neighbours
    ids = torch.from_numpy(rng.integers(-3, BINS + 3, (v, b))).to(id_dtype)
    if name == "bincount_i32":
        return (ids,)
    shape = (v, b) if d == 0 else (v, b, d)
    if name == "segment_sum_i32":
        vals = torch.from_numpy(rng.integers(-(2**31), 2**31, shape)).to(torch.int32)
    else:
        vals = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if name != "segment_sum_f32":
            vals.view(-1)[::7] = -0.0
    return vals, ids


#: (op, value columns: 0 for [B] rows; bincount takes ids only)
RULE_CASES = [("bincount_i32", 0)] + [
    (name, d) for name in ("segment_sum_f32", "segment_sum_i32", "segment_max_f32", "segment_min_f32") for d in (0, 3)
]


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64], ids=["ids32", "ids64"])
@pytest.mark.parametrize("name,d", RULE_CASES)
def test_vmap_rule_equals_rows_of_the_plain_version(name, d, id_dtype):
    args = _inputs(name, 6, 9, d, id_dtype)
    got = torch.func.vmap(_op(name))(*args)
    want = torch.stack([_plain(name)(*row) for row in zip(*args)])
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int32) if got.is_floating_point() else got, want.view(torch.int32) if want.is_floating_point() else want)


@pytest.mark.parametrize("batched", ["vals", "ids", "dim1"])
@pytest.mark.parametrize("name", ["segment_sum_f32", "segment_sum_i32", "segment_max_f32", "segment_min_f32"])
def test_fold_vmap_rule_with_one_batched_argument(name, batched):
    vals, ids = _inputs(name, 4, 7, 2, torch.int64)
    fn = _op(name)
    if batched == "vals":
        got = torch.func.vmap(fn, in_dims=(0, None))(vals, ids[0])
        want = torch.stack([_plain(name)(v, ids[0]) for v in vals])
    elif batched == "ids":
        got = torch.func.vmap(fn, in_dims=(None, 0))(vals[0], ids)
        want = torch.stack([_plain(name)(vals[0], i) for i in ids])
    else:  # the vmapped axis second
        got = torch.func.vmap(fn, in_dims=(1, 1))(vals.transpose(0, 1), ids.transpose(0, 1))
        want = torch.stack([_plain(name)(v, i) for v, i in zip(vals, ids)])
    bits = (lambda x: x.view(torch.int32)) if vals.is_floating_point() else (lambda x: x)
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("ids_case", ["in-range", "all-dropped", "empty-rows"])
def test_bincount_vmap_rule_edges(ids_case):
    if ids_case == "in-range":
        ids = torch.arange(12).reshape(3, 4) % BINS
    elif ids_case == "all-dropped":
        ids = torch.tensor([[-1, BINS, BINS + 100], [-(2**40), 2**40, -7], [BINS, BINS, BINS]])
    else:
        ids = torch.zeros(3, 0, dtype=torch.int64)
    got = torch.func.vmap(_op("bincount_i32"))(ids)
    want = torch.stack([ops.bincount_reference(row, BINS) for row in ids])
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_nested_vmap_rule():
    vals, ids = _inputs("segment_sum_f32", 6, 5, 0, torch.int64)
    vals, ids = vals.reshape(2, 3, 5), ids.reshape(2, 3, 5)
    got = torch.func.vmap(torch.func.vmap(_op("segment_sum_f32")))(vals, ids)
    want = torch.stack([torch.stack([ops.segment_sum_reference(v, i, BINS) for v, i in zip(vr, ir)]) for vr, ir in zip(vals, ids)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


class _OpCalls(TorchDispatchMode):
    """Records each ``metrics_tpu_torch::`` op call that reaches an
    implementation: its name and its ``batched`` argument."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "metrics_tpu_torch":
            batched = args[-1] if isinstance(args[-1], bool) else False
            self.calls.append((func.__name__.split(".")[0], batched))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("nested", [False, True], ids=["vmap", "vmap-of-vmap"])
@pytest.mark.parametrize("name,d", RULE_CASES)
def test_vmap_rule_asks_for_one_batched_launch(name, d, nested):
    """Under vmap (nested too) the op reaches its implementation once, over
    the flattened batch, marked ``batched``; a plain call is not marked."""
    args = _inputs(name, 6, 9, d, torch.int64)
    fn = torch.func.vmap(_op(name))
    if nested:
        args = tuple(a.reshape((2, 3) + tuple(a.shape[1:])) for a in args)
        fn = torch.func.vmap(fn)
    with _OpCalls() as seen:
        fn(*args)
        _op(name)(*(a.reshape((-1,) + tuple(a.shape[2 if nested else 1 :]))[0] for a in args))
    assert seen.calls == [(name, True), (name, False)]


@pytest.mark.parametrize("name", ["bincount_i32", "segment_sum_f32", "segment_sum_i32", "segment_max_f32", "segment_min_f32"])
def test_batched_launches_count_apart_and_replay(name):
    """A batched launch counts as a launch of its kernel and, apart, as a
    batched one; a recorded capture's batched launches replay with it."""
    ops.reset_launch_counts()
    ops.count_launch(name)
    ops.count_launch(name, batched=True)
    assert ops.launch_counts()[name] == 2 and ops.batched_launch_counts()[name] == 1
    assert not any(k.endswith(ops.BATCHED) for k in ops.launch_counts())
    ops.reset_launch_counts()
    with ops.recording_launches() as recorded:
        ops.count_launch(name, batched=True)
    assert recorded == {name: 1, name + ops.BATCHED: 1} and not ops.launch_counts()[name]
    for _ in range(3):
        ops.dispatch.add_launches(recorded)
    assert ops.launch_counts()[name] == 3 and ops.batched_launch_counts()[name] == 3
    ops.reset_launch_counts()
    assert not any(ops.batched_launch_counts().values())


@pytest.mark.parametrize("name", ["segment_sum_f32", "segment_sum_i32", "segment_max_f32", "segment_min_f32"])
def test_fold_op_refuses_the_wrong_value_dtype(name):
    wrong = torch.ones(3, dtype=torch.int32 if name.endswith("f32") else torch.float32)
    with pytest.raises(TypeError, match=name):
        getattr(torch.ops.metrics_tpu_torch, name)(wrong, torch.tensor([0, 1, 2]), 4)


@pytest.mark.parametrize("name", ["bincount_i32", "segment_sum_f32", "segment_sum_i32", "segment_max_f32", "segment_min_f32"])
def test_op_fake_gives_the_static_shape(name):
    with torch.device("meta"):
        if name == "bincount_i32":
            out = torch.ops.metrics_tpu_torch.bincount_i32(torch.zeros(9, dtype=torch.int64), 7)
            assert out.shape == (7,) and out.dtype == torch.int32
        else:
            dtype = torch.int32 if name == "segment_sum_i32" else torch.float32
            out = getattr(torch.ops.metrics_tpu_torch, name)(torch.zeros(9, 4, dtype=dtype), torch.zeros(9, dtype=torch.int64), 7)
            assert out.shape == (7, 4) and out.dtype == dtype


@pytest.mark.parametrize("name", ["bincount_i32", "segment_sum_f32", "segment_sum_i32", "segment_max_f32", "segment_min_f32"])
def test_wrapper_refuses_batched_cpu_tensors(name):
    """Under vmap the wrappers still take CUDA tensors only: a batched CPU
    tensor raises, and nothing is counted."""
    args = _inputs(name, 2, 3, 0, torch.int64)
    wrapper = getattr(ops, name)
    fn = (lambda i: wrapper(i, BINS)) if name == "bincount_i32" else (lambda v, i: wrapper(v, i, BINS))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA kernel"):
        torch.func.vmap(fn)(*args)
    assert not any(ops.launch_counts().values())


# ---------------------------------------------------------------------------
# device= on the wrappers
# ---------------------------------------------------------------------------

WRAPPERS = {
    "sliced": lambda m, **kw: SlicedMetric(m, 3, **kw),
    "windowed": lambda m, **kw: WindowedMetric(m, window=4, **kw),
}


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")], ids=["str", "device"])
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_wrapper_takes_its_templates_device(wrapper, device):
    metric = WRAPPERS[wrapper](MeanSquaredError(device="cpu"), device=device)
    assert metric.device == torch.device("cpu")
    metric.update(*([torch.tensor([0, 1, 2])] if wrapper == "sliced" else []), torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 0.0, 3.0]))
    assert torch.isfinite(metric.compute()).all()


@pytest.mark.parametrize("device", ["meta", "cuda", "cuda:1"])
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_wrapper_refuses_another_device(wrapper, device):
    with pytest.raises(MetricsUserError, match=rf"(?s)device cpu.*device='{device}'"):
        WRAPPERS[wrapper](MeanSquaredError(device="cpu"), device=device)
